"""The port's featurization, regression and pipeline against the reference.

Slice stacks are made once by the reference's generators and handed to
both stacks as numpy arrays.  ``PredictorConfig.use_kernels`` picks the
q-ent route as in the reference: the default is the exact sort route,
held to the reference's default route (its entropies and log q-ent
bit for bit, the SVD feature within 1e-5); ``use_kernels=True`` hashes codes
into ``qent_bins`` bins like the reference's kernel route, held to it
within 1e-5.  The two routes agree where the code range fits the bins.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import pipeline as JPL  # noqa: E402
from repro.core import predictors as JP  # noqa: E402
from repro.core import regression as JR  # noqa: E402
from repro.data import scientific as JS  # noqa: E402
from repro_torch.core import pipeline as TPL  # noqa: E402
from repro_torch.core import predictors as TP  # noqa: E402
from repro_torch.core import regression as TR  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_KERNEL_CFG = JP.PredictorConfig(use_kernels=True, qent_bins=4096)
PORT_CFG = TP.PredictorConfig(qent_bins=4096, use_kernels=True)
# the chip smoke's eb grid on cesm-cloud (its eps 1e-5): 3.16e-6 ... 1e-3
CESM_EBS = 1e-5 * 10.0 ** np.linspace(-0.5, 2.0, 6)


@pytest.fixture(scope="module")
def stacks():
    s2 = np.array(JS.field_slices("miranda-vx", count=3, n=72))
    s4 = np.array(JS.volume("hurricane-u", shape=(6, 20, 24)))
    s4 = np.stack([s4, s4[::-1] * 0.5 + 0.1])           # (2, 6, 20, 24)
    rng2 = float(np.ptp(s2))
    rng4 = float(np.ptp(s4))
    return {3: (s2, np.array([1e-3, 1e-2, 5e-2]) * rng2),
            4: (s4, np.array([1e-3, 1e-2, 5e-2]) * rng4)}


@pytest.mark.parametrize("rank", [3, 4])
@pytest.mark.parametrize("mode", ["features", "quality", "both"])
def test_features_sweep_matches_kernel_route(stacks, rank, mode):
    x, ebs = stacks[rank]
    want = np.asarray(JP._features_sweep_traced(
        jnp.asarray(x), jnp.asarray(ebs, jnp.float32),
        vf=JP.variance_fraction_for(JAX_KERNEL_CFG, x.ndim), bins=4096,
        use_kernels=True, tune=JAX_KERNEL_CFG.tune, mode=mode))
    got = TP._sweep(torch.from_numpy(x), ebs, PORT_CFG, mode).numpy()
    assert got.shape == want.shape == (x.shape[0], 3,
                                       TP.SWEEP_MODE_WIDTHS[mode])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if mode != "features":                 # the quality half is bit-equal
        np.testing.assert_array_equal(got[..., -2:].view(np.int32),
                                      want[..., -2:].view(np.int32))


@pytest.mark.parametrize("rank", [3, 4])
def test_features_sweep_matches_default_route(stacks, rank):
    x, ebs = stacks[rank]
    want = np.asarray(JP.features_sweep(jnp.asarray(x), ebs, sharded=False))
    got = TP.features_sweep(torch.from_numpy(x), ebs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    f, q = TP.features_sweep(torch.from_numpy(x), ebs, quality=True)
    jf, jq = JP.features_sweep(jnp.asarray(x), ebs, sharded=False,
                               quality=True)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(q.numpy().view(np.int32),
                                  np.asarray(jq).view(np.int32))
    np.testing.assert_array_equal(q.numpy(),
                                  TP.quality_sweep(torch.from_numpy(x), ebs))


@pytest.fixture(scope="module")
def cesm():
    return np.array(JS.field_slices("cesm-cloud", count=3, n=64))


def test_default_route_matches_reference_on_cesm_cloud(cesm):
    """At 3.16e-6 and 1e-5 cesm-cloud's code range (1 / eps) outgrows the
    65536 bins: only the exact sort route matches the reference there."""
    want = np.asarray(JP.features_sweep(jnp.asarray(cesm), CESM_EBS,
                                        sharded=False))
    got = TP.features_sweep(torch.from_numpy(cesm), CESM_EBS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[..., 0].view(np.int32),
                                  want[..., 0].view(np.int32))
    hashed = TP.features_sweep(torch.from_numpy(cesm), CESM_EBS,
                               TP.PredictorConfig(use_kernels=True)).numpy()
    miss = np.abs(hashed - want).max(axis=(0, 2))
    assert np.all(miss[:2] > 1e-4) and np.all(miss[2:] < 1e-5), miss


@pytest.mark.parametrize("use_kernel", [False, True])
def test_qent_sweep_matches_reference_routes(cesm, use_kernel):
    ebs = np.concatenate([CESM_EBS, [3e-2]])
    want = np.asarray(JP.quantized_entropy_sweep(
        jnp.asarray(cesm), jnp.asarray(ebs, jnp.float32),
        use_kernel=use_kernel))
    got = TP.quantized_entropy_sweep(torch.from_numpy(cesm), ebs,
                                     use_kernel=use_kernel).numpy()
    assert got.shape == want.shape == (3, 7)
    if use_kernel:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:                                  # the exact route: bit for bit
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # a constant slice has entropy 0; a stack of one value per code, log2(n)
    flat = torch.arange(64, dtype=torch.float32).reshape(1, 8, 8)
    ent = TP.quantized_entropy_sweep(torch.cat([flat * 0, flat]), [1.0],
                                     use_kernel=use_kernel)
    np.testing.assert_allclose(ent.numpy()[:, 0], [0.0, 6.0], atol=1e-6)


@pytest.mark.parametrize("case", ["volumes", "ragged"])
def test_sort_route_bit_equal_to_reference(case):
    """The sort route's q-ent, and the log q-ent column of a default
    sweep, are the reference's bits on a (2, d, m, n) volume stack and
    on slices whose length (45 x 45) is no multiple of XLA's 32-wide
    sum window."""
    if case == "volumes":
        v = np.array(JS.volume("hurricane-u", shape=(6, 20, 24)))
        x = np.stack([v, v[::-1] * 0.5 + 0.1])
    else:
        x = np.array(JS.field_slices("miranda-vx", count=3, n=45))
    ebs = np.array([1e-4, 1e-3, 1e-2, 5e-2]) * float(np.ptp(x))
    want = np.asarray(JP.quantized_entropy_sweep(
        jnp.asarray(x), jnp.asarray(ebs, jnp.float32)))
    got = TP.quantized_entropy_sweep(torch.from_numpy(x), ebs).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want = np.asarray(JP.features_sweep(jnp.asarray(x), ebs, sharded=False))
    got = TP.features_sweep(torch.from_numpy(x), ebs).numpy()
    np.testing.assert_array_equal(got[..., 0].view(np.int32),
                                  want[..., 0].view(np.int32))


def test_rank_terms_bit_equal_to_jnp():
    """g(j) = j log2 j - (j-1) log2(j-1) of the port equals the
    reference's jitted expression at every rank in [1, 2^22], which
    covers every run length of a 1800 x 1800 slice, and the table the
    sort route gathers from holds the same values."""
    import jax
    n = 1 << 22
    j = np.arange(1, n + 1, dtype=np.float32)

    def terms(one):                          # as in the reference's lax.map
        jj = jnp.asarray(j) * one
        return jj * jnp.log2(jj) - (jj - 1) * jnp.log2(jnp.maximum(jj - 1, 1))

    want = np.asarray(jax.lax.map(terms, jnp.ones((1,), jnp.float32)))[0]
    got = TP.rank_terms(torch.from_numpy(j)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    table = TP._rank_term_table(n, "cpu")
    assert table.shape[0] > n
    np.testing.assert_array_equal(table[1:n + 1].numpy().view(np.int32),
                                  want.view(np.int32))


def test_convert_keeps_use_kernels():
    from repro_torch import convert
    for flag in (False, True):
        jcfg = JP.PredictorConfig(use_kernels=flag, qent_bins=4096)
        cfg = convert.predictor_config(
            {k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__})
        assert cfg == TP.PredictorConfig(qent_bins=4096, use_kernels=flag)
    assert convert.predictor_config(None) == TP.PredictorConfig()
    assert TP.PredictorConfig().use_kernels is False


def test_slice_cache_follows_the_route(cesm):
    for cfg in (TP.PredictorConfig(), TP.PredictorConfig(use_kernels=True)):
        x = torch.from_numpy(cesm)
        sweep = TP.features_sweep(x, CESM_EBS, cfg)
        cache = TP.get_engine(cfg).cached(x[1])
        for i in (0, 3):
            np.testing.assert_allclose(cache(CESM_EBS[i]).numpy(),
                                       sweep[1, i].numpy(), atol=1e-6)


def test_trunc_predictors_match(stacks):
    x2, _ = stacks[3]
    x4, _ = stacks[4]
    np.testing.assert_allclose(
        TP.svd_trunc_batch(torch.from_numpy(x2)).numpy(),
        np.asarray(JP.svd_trunc_batch(jnp.asarray(x2), use_kernel=True)),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        TP.hosvd_trunc_batch(torch.from_numpy(x4)).numpy(),
        np.asarray(JP.hosvd_trunc_batch(jnp.asarray(x4), use_kernel=True)),
        rtol=0, atol=1e-6)
    assert float(TP.svd_trunc(torch.from_numpy(x2[1]))) == \
        float(TP.svd_trunc_batch(torch.from_numpy(x2))[1])
    assert float(TP.hosvd_trunc(torch.from_numpy(x4[0]))) == \
        float(TP.hosvd_trunc_batch(torch.from_numpy(x4))[0])


def test_slice_cache_and_engine(stacks):
    x, ebs = stacks[3]
    xt = torch.from_numpy(x)
    sweep = TP.features_sweep(xt, ebs)
    engine = TP.get_engine()
    assert engine is TP.get_engine(TP.PredictorConfig())
    np.testing.assert_array_equal(engine.features(xt, ebs[1]).numpy(),
                                  sweep[:, 1].numpy())
    cache = engine.cached(xt[2])
    fresh = cache(ebs[0])                      # SVD once + one q-ent
    np.testing.assert_allclose(fresh.numpy(), sweep[2, 0].numpy(), atol=1e-6)
    cache.prefetch(ebs)
    for i, e in enumerate(ebs):
        np.testing.assert_array_equal(cache(e).numpy(), sweep[2, i].numpy())
    with pytest.raises(ValueError):
        cache.seed(ebs, sweep[2, :2])


def test_sweep_rejects_bad_inputs():
    with pytest.raises(ValueError):
        TP.features_sweep(torch.zeros(4, 4), [1e-3])
    with pytest.raises(ValueError):
        TP.features_sweep(torch.zeros(2, 4, 4), [1e-3, -1.0])
    with pytest.raises(ValueError):
        TP._features_sweep_impl(torch.zeros(2, 4, 4), torch.ones(1),
                                vf=0.99, bins=16, mode="nope")


def test_constant_slices_stay_finite():
    x = torch.ones((2, 32, 32))
    f, q = TP.features_sweep(x, [1e-3, 1e-2], quality=True)
    assert torch.isfinite(f).all() and torch.isfinite(q).all()


# ---------------------------------------------------------------- regression
def _training_set(seed=0, n=40):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, 2)).astype(np.float32)
    logcr = 1.5 + 0.8 * feats[:, 0] - 0.3 * feats[:, 1] \
        + 0.1 * feats[:, 0] * feats[:, 1] + 0.05 * rng.standard_normal(n)
    return feats, np.exp(logcr).astype(np.float32)


@pytest.mark.parametrize("kind", ["spline", "linear"])
def test_model_prediction_independent_of_batch(kind):
    """A row's predicted CR is the same bits predicted alone, in any
    slice of rows and in the whole set (an advisor chunk against the
    whole variable)."""
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((120, 2)).astype(np.float32))
    cr = torch.from_numpy(np.exp(rng.standard_normal(120)).astype(np.float32))
    model = TR.MODEL_REGISTRY[kind](feats, cr)
    whole = model.predict(feats)
    for lo, k in ((0, 1), (7, 1), (0, 2), (5, 3), (41, 14), (3, 41),
                  (10, 64), (0, 96)):
        assert torch.equal(model.predict(feats[lo:lo + k]),
                           whole[lo:lo + k]), (lo, k)


@pytest.mark.parametrize("kind", ["spline", "linear"])
def test_regression_fit_matches(kind):
    feats, cr = _training_set()
    jm = JR.MODEL_REGISTRY[kind](jnp.asarray(feats), jnp.asarray(cr))
    tm = TR.MODEL_REGISTRY[kind](torch.from_numpy(feats), torch.from_numpy(cr))
    probe = _training_set(1, 16)[0]
    np.testing.assert_allclose(tm.predict(torch.from_numpy(probe)).numpy(),
                               np.asarray(jm.predict(jnp.asarray(probe))),
                               rtol=1e-3)
    np.testing.assert_allclose(tm.std.mean.numpy(), np.asarray(jm.std.mean),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(TR.predict_fast(tm, probe).numpy(),
                                  tm.predict(torch.from_numpy(probe)).numpy())


def test_spline_basis_and_knots_match():
    z = np.linspace(-2.0, 2.5, 41).astype(np.float32)
    jk = np.array(JR._quantile_knots(jnp.asarray(z), 3))
    tk = TR._quantile_knots(torch.from_numpy(z), 3).numpy()
    np.testing.assert_allclose(tk, jk, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        TR.ncs_basis(torch.from_numpy(z), torch.from_numpy(jk)).numpy(),
        np.asarray(JR.ncs_basis(jnp.asarray(z), jnp.asarray(jk))),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ pipeline
def test_kfold_evaluate_matches():
    feats, cr = _training_set(2, 48)
    j = JPL.kfold_evaluate(feats, cr, "spline", k=6, seed=3)
    t = TPL.kfold_evaluate(feats, cr, "spline", k=6, seed=3)
    np.testing.assert_array_equal(t.true_cr, j.true_cr)
    np.testing.assert_allclose(t.pred_cr, j.pred_cr, rtol=1e-3)
    assert abs(t.medape - j.medape) < 0.05
    np.testing.assert_allclose(TPL.ape(np.array([2.0]), np.array([1.0])),
                               [50.0])


def test_crpredictor_train_predict_matches(stacks):
    x, ebs = stacks[3]
    x = np.concatenate([x, x[::-1] * 1.5, x * 0.25 + 1.0])     # k = 9
    cr = np.linspace(3.0, 9.0, len(x))
    jp = JPL.CRPredictor.train(jnp.asarray(x), jnp.asarray(cr), float(ebs[1]),
                               "linear")
    tp = TPL.CRPredictor.train(torch.from_numpy(x), cr, float(ebs[1]),
                               "linear")
    np.testing.assert_allclose(tp.predict(torch.from_numpy(x)).numpy(),
                               np.asarray(jp.predict(jnp.asarray(x))),
                               rtol=1e-3)
    np.testing.assert_allclose(
        TPL.featurize_sweep(torch.from_numpy(x), ebs).numpy(),
        np.asarray(JPL.featurize_sweep(jnp.asarray(x), ebs, sharded=False)),
        rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        tp.predict(torch.from_numpy(x[0]))


# ------------------------------------------------ the looped predictors
@pytest.mark.parametrize("use_kernel", [False, True])
def test_quantized_entropy_and_codes_match(stacks, use_kernel):
    x, ebs = stacks[3]
    for eps in ebs:
        np.testing.assert_array_equal(
            TP.quantized_codes(torch.from_numpy(x[0]), eps).numpy(),
            np.asarray(JP.quantized_codes(jnp.asarray(x[0]), eps)))
        want = float(JP.quantized_entropy(jnp.asarray(x[0]), eps, 4096,
                                          use_kernel=use_kernel))
        got = float(TP.quantized_entropy(torch.from_numpy(x[0]), eps, 4096,
                                         use_kernel=use_kernel))
        assert abs(got - want) <= 1e-4, (eps, got, want)
    with pytest.raises(ValueError):
        TP.quantized_codes(torch.from_numpy(x[0]), 0.0)


def test_raw_entropy_matches(stacks):
    x, _ = stacks[3]
    for bins in (65536, 3000):
        want = float(JP.entropy(jnp.asarray(x[1]), bins))
        got = float(TP.entropy(torch.from_numpy(x[1]), bins))
        assert abs(got - want) <= 1e-4, (bins, got, want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_looped_features_match(stacks, use_kernels):
    jcfg = JP.PredictorConfig(use_kernels=use_kernels, qent_bins=4096)
    tcfg = TP.PredictorConfig(use_kernels=use_kernels, qent_bins=4096)
    x2, ebs2 = stacks[3]
    x4, ebs4 = stacks[4]
    eps = float(ebs2[1])
    np.testing.assert_allclose(
        TP.features_batch(torch.from_numpy(x2), eps, tcfg).numpy(),
        np.asarray(JP.features_batch(jnp.asarray(x2), eps, jcfg)),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        TP.features_2d(torch.from_numpy(x2[0]), eps, tcfg).numpy(),
        np.asarray(JP.features_2d(jnp.asarray(x2[0]), eps, jcfg)),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        TP.features_3d(torch.from_numpy(x4[0]), float(ebs4[1]), tcfg).numpy(),
        np.asarray(JP.features_3d(jnp.asarray(x4[0]), float(ebs4[1]), jcfg)),
        rtol=0, atol=1e-5)


def test_features_2d_cached_matches(stacks):
    x, ebs = stacks[3]
    jc = JP.features_2d_cached(jnp.asarray(x[2]))
    tc = TP.features_2d_cached(torch.from_numpy(x[2]))
    for eps in ebs:
        np.testing.assert_allclose(tc(eps).numpy(), np.asarray(jc(eps)),
                                   rtol=0, atol=1e-5)


# ------------------------------------------------- batch independence
@pytest.mark.parametrize("rank", [3, 4])
def test_tiny_slice_matches_reference(rank):
    """A slice (or volume) whose centred values all lie below 2^-63: its
    products and squares are subnormal, so XLA's CPU reads a zero Gram
    and sigma 0; the port's trunc, sigma and sweep row agree."""
    rng = np.random.default_rng(5)
    shape = (2, 40, 48) if rank == 3 else (2, 6, 12, 10)
    x = (rng.standard_normal(shape) * 2.0 ** -66).astype(np.float32)
    x[1] = rng.standard_normal(shape[1:]).astype(np.float32)
    ebs = [1e-3, 1e-2]
    jtrunc = (JP.svd_trunc_batch if rank == 3 else JP.hosvd_trunc_batch)
    ttrunc = (TP.svd_trunc_batch if rank == 3 else TP.hosvd_trunc_batch)
    want = np.asarray(jtrunc(jnp.asarray(x)))
    got = ttrunc(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert float(TP._sigma(torch.from_numpy(x))[0]) == 0.0 == float(
        jnp.std(jnp.asarray(x[0])))
    np.testing.assert_allclose(
        TP._sigma(torch.from_numpy(x)).numpy()[1], np.std(x[1]), rtol=1e-5)
    want = np.asarray(JP.features_sweep(jnp.asarray(x), ebs, sharded=False))
    got = TP.features_sweep(torch.from_numpy(x), ebs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    sv, sigma = TP._svd_sigma(torch.from_numpy(x[0]),
                              TP.variance_fraction_for(TP.PredictorConfig(),
                                                       rank))
    assert float(sigma) == 0.0
    assert float(sv) == float(jtrunc(jnp.asarray(x[:1]))[0])


@pytest.mark.parametrize("rank", [3, 4])
@pytest.mark.parametrize("mode", ["features", "quality", "both"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_row_alone_equals_row_in_batch(stacks, rank, mode, use_kernels):
    """A slice swept alone, inside a batch of 5 and inside a padded
    bucket gives the same bits (the reference's row independence, which
    streaming relies on)."""
    from repro_torch.dist import sweep as TDS
    x, ebs = stacks[rank]
    x = torch.from_numpy(np.concatenate([x, x[::-1] * 0.5 + 0.25, x[:1]])[:5])
    cfg = TP.PredictorConfig(use_kernels=use_kernels, qent_bins=4096)
    batch = TP._sweep(x, ebs, cfg, mode)
    bucket = TDS.sweep_padded(x[1:4], ebs, cfg, k_pad=8, mode=mode)
    for i in range(5):
        alone = TP._sweep(x[i:i + 1], ebs, cfg, mode)[0]
        assert torch.equal(alone, batch[i]), i
        if 1 <= i < 4:
            assert torch.equal(alone, bucket[i - 1]), i


# --------------------------------------------------------------- boundaries
def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


# ----------------------------------------------------- eb-grid independence
@pytest.mark.parametrize("rank", [3, 4])
@pytest.mark.parametrize("mode", ["features", "quality", "qent"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_row_at_one_eb_independent_of_eb_grid(stacks, rank, mode,
                                              use_kernels):
    """A row's value at one eb is the same bits swept at that eb alone,
    in the 6-eb grid, in an 8-eb bucket padded with the grid's last eb
    and in a 12-eb union with other ebs before and after it: what the
    sweep service's eb unions and eb buckets rely on.  The default 65536
    bins make the kernel route's entropy sum long enough for a library
    sum to split it by the number of ebs.  ``qent`` also holds each
    row's q-ent alone == in the batch at every grid."""
    x, _ = stacks[rank]
    x = torch.from_numpy(x)
    rng = float(x.max() - x.min())
    grid = list(rng * 10.0 ** np.linspace(-4.0, -1.5, 6))
    others = list(rng * 10.0 ** np.linspace(-4.3, -1.2, 6))
    union = sorted(grid + others)
    cfg = TP.PredictorConfig(use_kernels=use_kernels)
    sweep = {"features": TP.features_sweep, "quality": TP.quality_sweep,
             "qent": lambda x, e, c: TP.quantized_entropy_sweep(
                 x, e, use_kernel=c.use_kernels)}[mode]
    in_grid = sweep(x, grid, cfg)
    bucket = sweep(x, grid + [grid[-1]] * 2, cfg)
    in_union = sweep(x, union, cfg)
    for j, eps in enumerate(grid):
        alone = sweep(x, [eps], cfg)[:, 0]
        assert torch.equal(alone, in_grid[:, j]), j
        assert torch.equal(alone, bucket[:, j]), j
        assert torch.equal(alone, in_union[:, union.index(eps)]), j
    if mode == "qent":
        for ebs, batch in ((grid, in_grid), (union, in_union)):
            for i in range(x.shape[0]):
                assert torch.equal(sweep(x[i:i + 1], ebs, cfg)[0], batch[i])

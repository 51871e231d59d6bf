"""The port's study modules against the reference's, on the CPU.

The paper's remaining experiments: the Gaussian random fields (Fig 5),
the ``scale-*`` fields and 3-D volumes, TTHRESH and the 3-D study
(Table 4), LASSO importances (Table 3) and the prior-method baselines
(Table 5); and the reference's reading of subnormals (XLA on the CPU
flushes them to zero) on a slice with planted ones.  Random draws are
made by ``jax.random`` and fed to both packages.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compressors as JC  # noqa: E402
from repro.core import baselines as JB  # noqa: E402
from repro.core import pipeline as JPL  # noqa: E402
from repro.core import predictors as JP  # noqa: E402
from repro.core import regression as JR  # noqa: E402
from repro.data import gaussian as JG  # noqa: E402
from repro.data import scientific as JS  # noqa: E402
from repro_torch import compressors as TC  # noqa: E402
from repro_torch.core import baselines as TB  # noqa: E402
from repro_torch.core import pipeline as TPL  # noqa: E402
from repro_torch.core import predictors as TP  # noqa: E402
from repro_torch.core import regression as TR  # noqa: E402
from repro_torch.data import gaussian as TG  # noqa: E402
from repro_torch.data import scientific as TS  # noqa: E402


def _bits(a):
    return np.asarray(a).view(np.int32)


# ------------------------------------------------------ the reference's draws
def _grf_draws(key, n):
    kr, ki = jax.random.split(key)
    return [np.array(jax.random.normal(kr, (n, n))),
            np.array(jax.random.normal(ki, (n, n)))]


def _weight_draws(key, n):
    return [np.array(jax.random.uniform(key, (2,), minval=0.2 * n,
                                        maxval=0.8 * n))]


def _sample_draws(stype, key, n):
    """The arrays ``JG.SAMPLERS[stype](key, n)`` draws, in its order."""
    if stype == 1:
        return _grf_draws(key, n)
    if stype == 2:
        return [a for k in jax.random.split(key, 3) for a in _grf_draws(k, n)]
    out = []
    if stype == 4:
        k0, key = jax.random.split(key)
        out.append(np.array(jax.random.uniform(k0, (3,))))
    keys = jax.random.split(key, 6)
    for i in range(3):
        out += _grf_draws(keys[2 * i], n) + _weight_draws(keys[2 * i + 1], n)
    return out


def _scale_draws(key, n):
    k1, k2, k3 = jax.random.split(key, 3)
    return _grf_draws(k1, n) + _grf_draws(k2, n) + _weight_draws(k3, n)


# fields are shaped from the same draws; the FFTs differ in rounding
FIELD_ATOL = 2e-5       # times the field's largest magnitude


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FIELD_ATOL * float(np.abs(want).max()))


@pytest.mark.parametrize("stype", [1, 2, 3, 4])
def test_gaussian_samplers_match_on_the_reference_draws(stype):
    n, count, seed = 96, 3, 4
    keys = jax.random.split(jax.random.PRNGKey(seed), count)
    want = np.asarray(JG.sample_batch(stype, count, n, seed=seed))
    draws = TG.ArrayDraws([a for k in keys for a in _sample_draws(stype, k, n)])
    got = TG.sample_batch(stype, count, n, device="cpu", draws=draws).numpy()
    assert got.shape == want.shape == (count, n, n) and got.dtype == np.float32
    _close(got, want)
    own = TG.sample_batch(stype, 2, 64, seed=1, device="cpu")
    assert torch.equal(own, TG.sample_batch(stype, 2, 64, seed=1, device="cpu"))
    assert TG.DEFAULT_SIZE == JG.DEFAULT_SIZE == 1028


def test_scale_letkf_like_matches_on_the_reference_draws():
    key = jax.random.PRNGKey(5)
    for z in (0.0, 1.3, float(np.pi)):
        want = np.asarray(JS.scale_letkf_like(key, 80, z))
        got = TS.scale_letkf_like(TG.ArrayDraws(_scale_draws(key, 80)), 80, z,
                                  device="cpu").numpy()
        _close(got, want)
    for name in ("scale-u", "scale-pressure"):
        assert TS.FIELDS[name] == TS.FieldSpec(
            name, TS.scale_letkf_like, 600, 1200, 48, 1e-3)


@pytest.mark.parametrize("name, shape", [
    ("miranda-vx", (6, 32, 32)), ("miranda-vx", (4, 32, 64)),
    ("qmcpack", (5, 48, 24)), ("scale-u", (4, 40, 40))])
def test_volume_matches_and_repeats_its_draws(name, shape):
    """Every slab from the same draws (the reference's ``keys[0]``),
    cropped from slabs made at max(shape[1:])."""
    seed, n = 2, max(shape[1:])
    want = np.asarray(JS.volume(name, shape, seed=seed))
    key = jax.random.split(jax.random.PRNGKey(
        zlib.crc32(name.encode()) % (2 ** 31) + 7 + seed), 1)[0]
    slab = (_scale_draws(key, n) if name.startswith("scale")
            else _grf_draws(jax.random.split(key)[0], n))
    got = TS.volume(name, shape, seed=seed, device="cpu",
                    draws=lambda: TG.ArrayDraws(slab)).numpy()
    assert got.shape == want.shape == shape
    _close(got, want)
    # the default draws repeat per slab too: a smooth stack along d
    own = TS.volume(name, shape, seed=seed, device="cpu")
    assert own.shape == shape
    again = TS.volume(name, (2,) + shape[1:], seed=seed, device="cpu")
    assert torch.equal(own[0], again[0])


# ------------------------------------------------------------------ TTHRESH
def _volumes():
    return [np.array(JS.volume(name, shape, seed=1)) for name, shape in (
        ("miranda-vx", (8, 32, 32)), ("qmcpack", (8, 24, 40)),
        ("miranda-vx", (6, 48, 48)))]


TTHRESH_CR_RTOL = 1e-3


def test_tthresh_cr_and_rmse_match():
    jt, tt = JC.get("tthresh"), TC.get("tthresh")
    worst = 0.0
    for v in _volumes():
        for rel in (1e-3, 1e-2):
            eps = rel * float(np.ptp(v))
            want = jt.cr(jnp.asarray(v), eps)
            got = tt.cr(torch.from_numpy(v), eps)
            worst = max(worst, abs(got / want - 1.0))
            assert tt.roundtrip_error(torch.from_numpy(v), eps) <= 1.05 * eps
    assert worst <= TTHRESH_CR_RTOL, worst
    assert TC.STUDY_3D == JC.STUDY_3D


def test_tthresh_decode_of_the_reference_codes():
    """Given the reference's codes and factors, decode is the reference's
    up to the float32 rounding of the mode products (exp2 of non-integer
    exponents is bit-equal, test_torch_compressors)."""
    v = _volumes()[0]
    eps = 1e-2 * float(np.ptp(v))
    codes, aux = JC.get("tthresh").encode(jnp.asarray(v), eps)
    want = np.asarray(JC.get("tthresh").decode(codes, aux, eps))
    taux = {"us": [torch.from_numpy(np.array(u)) for u in aux["us"]],
            "amax": torch.tensor(float(aux["amax"])), "shape": v.shape}
    tcodes = tuple(torch.from_numpy(np.array(c)) for c in codes)
    got = TC.get("tthresh").decode(tcodes, taux, eps).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_study_3d_end_to_end():
    """Table 4 at 8 small volumes: one rank-4 featurization, the five
    STUDY_3D CRs and the k-fold MedAPE per compressor."""
    vols = np.stack([np.array(JS.volume("qmcpack", (8, 24, 24), seed=s))
                     for s in range(8)])
    eps = 1e-2 * float(np.ptp(vols))
    jf = np.asarray(JPL.featurize_slices(jnp.asarray(vols), eps))
    tf = TPL.featurize_slices(torch.from_numpy(vols), eps).numpy()
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-5)
    for name in JC.STUDY_3D:
        jcr = np.array([JC.get(name).cr(jnp.asarray(v), eps) for v in vols])
        tcr = np.array([TC.get(name).cr(torch.from_numpy(v), eps) for v in vols])
        if name == "tthresh":
            # a few log-quantized core values round the other way (the
            # core's float32 bits are the library's): 3.8e-3 at most here
            np.testing.assert_allclose(tcr, jcr, rtol=5e-3)
        else:
            np.testing.assert_array_equal(tcr, jcr)
        want = JPL.kfold_evaluate(jf, jcr, model="spline", k=8).medape
        got = TPL.kfold_evaluate(tf, tcr, model="spline", k=8).medape
        assert np.isfinite(got) and abs(got - want) <= 0.05, (name, got, want)


# -------------------------------------------------------------------- LASSO
def test_lasso_importance_matches_with_the_reference_folds():
    rng = np.random.default_rng(0)
    n, k, seed = 40, 6, 3
    feats = rng.standard_normal((n, 2)).astype(np.float32)
    cr = np.exp(1.0 + 0.8 * feats[:, 0] - 0.5 * feats[:, 1]
                + 0.1 * feats[:, 0] * feats[:, 1]
                + 0.2 * rng.standard_normal(n)).astype(np.float32)
    want = np.asarray(JR.lasso_importance(jnp.asarray(feats), jnp.asarray(cr),
                                          k=k, seed=seed))
    perm = np.array(jax.random.permutation(jax.random.PRNGKey(seed), n))
    got = TR.lasso_importance(torch.from_numpy(feats), torch.from_numpy(cr),
                              k=k, perm=torch.from_numpy(perm)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the same lambda: the reference's CV errors, recomputed fold by fold
    std = JR.Standardizer.fit(jnp.asarray(feats))
    x = JR._linear_design(std(jnp.asarray(feats)))
    y = jnp.log(jnp.asarray(cr))
    yz = (y - jnp.mean(y)) / jnp.maximum(jnp.std(y), 1e-8)
    lams = jnp.logspace(-4, 0, 20)
    errs = []
    for lam in lams:
        e = []
        for f in np.array_split(perm, k):
            mask = np.zeros(n, bool)
            mask[f] = True
            w = jnp.asarray(~mask, jnp.float32)
            b = JR.lasso_fit(x * w[:, None], yz * w, lam)
            e.append(float(jnp.sum(((x @ b - yz) * mask) ** 2)) / mask.sum())
        errs.append(np.mean(e))
    best = float(lams[int(np.argmin(errs))])
    coef = TR.lasso_fit(torch.from_numpy(np.array(x)),
                        torch.from_numpy(np.array(yz)), best).abs()[1:]
    np.testing.assert_allclose(coef.numpy(), got, rtol=0, atol=1e-6)
    # batched penalties: the same iteration per penalty
    lam = np.array([1e-3, 1e-1], np.float32)
    batched = TR.lasso_fit(torch.from_numpy(np.array(x)),
                           torch.from_numpy(np.array(yz)), torch.from_numpy(lam))
    for i, v in enumerate(lam):
        np.testing.assert_allclose(
            batched[i].numpy(),
            np.asarray(JR.lasso_fit(x, yz, jnp.float32(v))), rtol=0, atol=1e-4)


# ---------------------------------------------------------------- baselines
@pytest.mark.parametrize("field, n", [("cesm-cloud", 96), ("miranda-vx", 100)])
def test_baselines_bit_equal(field, n):
    s = np.array(JS.field_slices(field, count=2, n=n, seed=1))
    eps = 1e-3 * float(np.ptp(s))
    x0, x1 = torch.from_numpy(s[0]), torch.from_numpy(s[1])
    assert (TB.block_sampling(x0, eps, frac=0.3)
            == JB.block_sampling(jnp.asarray(s[0]), eps, frac=0.3))
    assert TB.lu_model(x0, eps) == JB.lu_model(jnp.asarray(s[0]), eps)
    assert (TB.optzconfig_probe(x1, eps)
            == JB.optzconfig_probe(jnp.asarray(s[1]), eps))


# ------------------------------------------------------- planted subnormals
def planted_slices():
    """A cesm-cloud slice with planted +-subnormals, +-values in
    [1e-22, 1e-19] (squares subnormal) and values just above the
    smallest normal (quotients by eps >= 128 subnormal), and a slice of
    zeros holding a few of each."""
    x = np.array(JS.field_slices("cesm-cloud", count=1, n=64, seed=1)[0])
    rng = np.random.default_rng(0)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, 900, replace=False)

    def signs(k):
        return np.where(rng.random(k) < 0.5, -1.0, 1.0).astype(np.float32)

    sub = rng.integers(1, 2 ** 23, 300).astype(np.uint32).view(np.float32)
    flat[idx[:300]] = sub * signs(300)
    flat[idx[300:600]] = (10.0 ** rng.uniform(-22, -19, 300)).astype(
        np.float32) * signs(300)
    flat[idx[600:]] = (2.0 ** rng.uniform(-126, -119, 300)).astype(
        np.float32) * signs(300)
    z = np.zeros_like(x)
    zf = z.reshape(-1)
    zf[idx[:60]] = flat[idx[:60]]
    zf[idx[300:360]] = np.abs(flat[idx[300:360]])
    zf[idx[600:660]] = flat[idx[600:660]]
    return np.stack([x, z])


PLANTED_EBS = np.array([1e-5, 1e-3, 256.0], np.float32)


def entry_flushed(x):
    """The data as the port's entry points hand it to the kernels and
    their plain versions: subnormals read as zeros of their sign."""
    from repro_torch.quant import flush_subnormals
    return flush_subnormals(torch.from_numpy(x))


def test_planted_subnormals_quality_bit_equal():
    from repro.kernels.quality import ops as jq
    from repro_torch.kernels.quality import ops as tq
    x = planted_slices()
    for use_kernel in (False, True):
        want = np.asarray(jq.quality_sweep(jnp.asarray(x), PLANTED_EBS,
                                           use_kernel=use_kernel))
        got = tq.quality_sweep(entry_flushed(x), PLANTED_EBS).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        # the entry point flushes the raw slice itself
        got = TP.quality_sweep(torch.from_numpy(x), PLANTED_EBS).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_planted_subnormals_qent_bit_equal():
    from repro.kernels.qent import qent as jqent
    from repro_torch.kernels.qent import ops as tqent
    x = planted_slices()
    flat = x.reshape(2, -1)
    want = np.asarray(jqent.qent_histogram_sweep(
        jnp.asarray(flat), jnp.asarray(PLANTED_EBS), tile=2048, bins=4096))
    got = tqent.qent_histogram_sweep(entry_flushed(flat),
                                     torch.from_numpy(PLANTED_EBS), 4096).numpy()
    np.testing.assert_array_equal(got, want)
    for i in range(2):
        for eps in PLANTED_EBS:
            np.testing.assert_array_equal(
                TP.quantized_codes(torch.from_numpy(x[i]), float(eps)).numpy(),
                np.asarray(JP.quantized_codes(jnp.asarray(x[i]), float(eps))))
    for cfg in (JP.PredictorConfig(), JP.PredictorConfig(use_kernels=True,
                                                         qent_bins=4096)):
        tcfg = TP.PredictorConfig(use_kernels=cfg.use_kernels,
                                  qent_bins=cfg.qent_bins)
        want = np.asarray(JP.features_sweep(jnp.asarray(x), PLANTED_EBS, cfg))
        got = TP.features_sweep(torch.from_numpy(x), PLANTED_EBS, tcfg).numpy()
        # q-ent (1e-4, the reference's tolerance); the trunc column of a
        # slice whose Gram is all subnormal products differs (XLA flushes
        # them inside the dot)
        np.testing.assert_allclose(np.exp(got[..., 0]), np.exp(want[..., 0]),
                                   rtol=0, atol=1e-4)


def test_planted_subnormals_lorenzo_and_zfp_bit_equal():
    from repro.compressors import sz as JSZ
    from repro.kernels.lorenzo import ops as jlor
    from repro.kernels.zfp_block import ops as jzfp
    from repro_torch.compressors import sz as TSZ
    from repro_torch.kernels.lorenzo import ops as tlor
    from repro_torch.kernels.zfp_block import ops as tzfp
    for x in planted_slices():
        for eps in (1e-5, 1e-3):
            want = np.asarray(jlor.lorenzo2d(jnp.asarray(x), eps))
            np.testing.assert_array_equal(
                tlor.lorenzo2d(torch.from_numpy(x), eps).numpy(), want)
            np.testing.assert_array_equal(
                TSZ.lorenzo_encode(torch.from_numpy(x), eps).numpy(),
                np.asarray(JSZ.lorenzo_encode(jnp.asarray(x), eps)))
        jc, je = jzfp.zfp_forward2d(jnp.asarray(x))
        tc, te = tzfp.zfp_forward2d(entry_flushed(x))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("name", ["sz2", "sz3-lorenzo", "zfp", "bitgrooming",
                                  "digitrounding"])
def test_planted_subnormals_cr_equal(name):
    for x in planted_slices():
        for eps in (1e-5, 1e-3):
            want = JC.get(name).cr(jnp.asarray(x), eps)
            assert TC.get(name).cr(torch.from_numpy(x), eps) == want, (name, eps)

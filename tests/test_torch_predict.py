"""CR and PSNR predictions held to the reference's jitted bits.

The reference's use cases evaluate a CR model through
``jax.jit(model.predict)`` (``predict_fast``), whose bits do not depend
on the batch; the port's ``predict`` / ``predict_log`` must give the same
bits alone and in any batch (``repro_torch.core.regression``).  Models
are fitted by the reference and carried across with
``repro_torch.convert``; features come from the reference too, so a
difference here is the prediction's alone.  ``refmath.exp_f32`` is held
to ``jax.jit(jnp.exp)`` over the whole float32 range.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import predictors as JP  # noqa: E402
from repro.core import regression as JR  # noqa: E402
from repro.core import usecases as JUC  # noqa: E402
from repro.data import scientific as JS  # noqa: E402
from repro_torch import convert, refmath  # noqa: E402
from repro_torch.core import usecases as TUC  # noqa: E402

from test_torch_usecases import export_cr_model, export_grid  # noqa: E402

JIT = {fn: jax.jit(lambda m, x, fn=fn: getattr(m, fn)(x))
       for fn in ("predict", "predict_log")}


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def study():
    """sz2 grids fitted by the reference on 6 scale-u 64^2 slices at
    1e-4, 1e-3 and 1e-2 of the range (spline and linear), 8 held-out
    slices, and the reference's (k, e, 2) features of all 14."""
    slices = np.asarray(JS.field_slices("scale-u", count=14, n=64))
    rng = float(np.ptp(slices))
    ebs = [1e-4 * rng, 1e-3 * rng, 1e-2 * rng]
    grids = {kind: JUC.EbGridModel.train(jnp.asarray(slices[:6]), "sz2",
                                         ebs, model=kind)
             for kind in ("spline", "linear")}
    feats = np.asarray(JP.features_sweep(jnp.asarray(slices), ebs))
    return slices, ebs, grids, feats


def _rows(feats: np.ndarray) -> np.ndarray:
    """400 feature rows: the 24 rows of the 8 held-out slices x 3 ebs,
    jittered by N(0, 0.05)."""
    base = feats[6:].reshape(-1, 2)
    rng = np.random.default_rng(0)
    rows = base[rng.integers(0, base.shape[0], 400)]
    return (rows + rng.normal(0, 0.05, rows.shape)).astype(np.float32)


@pytest.mark.parametrize("fn", ["predict", "predict_log"])
@pytest.mark.parametrize("kind", ["spline", "linear"])
def test_prediction_bits_alone_and_in_batches(study, kind, fn):
    _, ebs, grids, feats = study
    rows = _rows(feats)
    for ei in range(len(ebs)):
        jm = grids[kind].models[ei].model
        tm = convert.cr_model(export_cr_model(jm, ebs[ei], 2), device="cpu")
        want = _bits(JIT[fn](jm, jnp.asarray(rows)))
        for b in (1, 7, 16, 400):
            got = np.concatenate([
                getattr(tm, fn)(torch.from_numpy(rows[i:i + b])).numpy()
                for i in range(0, 400, b)])
            assert np.array_equal(_bits(got), want), (kind, fn, ei, b)


@pytest.mark.parametrize("kind", ["spline", "linear"])
def test_prediction_with_subnormal_design_entries(kind):
    """Knots and features placed so that the cubes, their differences and
    the tensor-product columns fall below 2^-126: XLA's CPU reads and
    writes them as zero, and so must the port.  Each unit coefficient
    vector makes one design column the prediction itself."""
    knots = np.asarray([1e-12, 0.5, 1.0], np.float32)
    p = 9 if kind == "spline" else 4
    coefs = [np.linspace(-1.5, 2.0, p, dtype=np.float32)] + list(
        np.eye(p, dtype=np.float32))
    d = np.asarray([1e-13, 2e-13, 2.2e-13, 3e-13, 2e-7, 2.3e-7, 3e-7, 1e-20],
                   np.float32)
    x = np.stack(np.meshgrid(knots[0] + d, knots[0] + d), -1).reshape(-1, 2)
    x = np.concatenate([x, [[1e-40, 1e-40], [-1e-40, 2e-20],
                            [3e-20, 2e-20]]]).astype(np.float32)
    std = JR.Standardizer(jnp.zeros(2, jnp.float32), jnp.ones(2, jnp.float32))
    for coef in coefs:
        jm = (JR.SplineCRModel(std, jnp.asarray(knots), jnp.asarray(knots),
                               jnp.asarray(coef)) if kind == "spline"
              else JR.LinearCRModel(std, jnp.asarray(coef)))
        tm = convert.cr_model(export_cr_model(jm, 1.0, 2), device="cpu")
        for fn in ("predict", "predict_log"):
            want = _bits(JIT[fn](jm, jnp.asarray(x)))
            got = _bits(getattr(tm, fn)(torch.from_numpy(x)).numpy())
            assert np.array_equal(got, want), (kind, fn, coef)


def test_exp_f32_over_the_float32_range():
    """Every 4999th finite float32 of either sign, plus 20 000 consecutive
    values around each edge of XLA's polynomial (the clamps, the
    overflow to inf, the flush of subnormal results)."""
    pos = np.arange(0, 0x7F800000, 4999, dtype=np.int64).astype(np.uint32)
    parts = [pos.view(np.float32), (pos | 0x80000000).view(np.float32)]
    for c in (88.72283, 88.8, -87.33654, -87.8, -103.97, -87.33655 - 0.69,
              0.0):
        b = int(np.float32(c).view(np.int32))
        parts.append((np.arange(-10000, 10000) + b).astype(np.int32)
                     .view(np.float32))
    parts.append(np.asarray([np.inf, -np.inf, 3.4e38, -3.4e38], np.float32))
    x = np.concatenate(parts)
    want = _bits(jax.jit(jnp.exp)(x))
    got = _bits(refmath.exp_f32(torch.from_numpy(x)).numpy())
    assert np.array_equal(got, want)
    nan = refmath.exp_f32(torch.tensor([float("nan")]))
    assert torch.isnan(nan).all()


def _caches(feats, ebs, i):
    """The reference's features of slice ``i`` as each package's
    feat_cache (eb -> (2,) features)."""
    def lookup(e):
        return feats[i, int(np.argmin(np.abs(np.asarray(ebs) - e)))]
    return (lambda e: jnp.asarray(lookup(e)),
            lambda e: torch.from_numpy(lookup(e).copy()))


@pytest.mark.parametrize("kind", ["spline", "linear"])
def test_grid_predict_and_psnr_at_72_probes(study, kind):
    """``EbGridModel.predict`` and ``predict_psnr``: 8 held-out slices x
    9 ebs (grid points, between them and outside the grid)."""
    slices, ebs, grids, feats = study
    jm = grids[kind]
    tm = convert.eb_grid_model(export_grid(jm), device="cpu")
    probes = [ebs[0] * 0.5, ebs[0], np.sqrt(ebs[0] * ebs[1]), ebs[1],
              ebs[1] * 1.7, np.sqrt(ebs[1] * ebs[2]), ebs[2] * 0.9, ebs[2],
              ebs[2] * 3]
    for i in range(6, 14):
        cj, ct = _caches(feats, ebs, i)
        x_j, x_t = jnp.asarray(slices[i]), torch.tensor(slices[i])
        for e in probes:
            assert tm.predict(x_t, e, ct) == jm.predict(x_j, e, cj)
            assert tm.predict_psnr(x_t, e, ct) == jm.predict_psnr(x_j, e, cj)


def test_uc1_uc2_uc3_answers_bit_equal(study):
    """UC1's eb and CR, UC2's predictions and pick, and UC3's whole
    setting, from the same features."""
    slices, ebs, grids, feats = study
    jgrids = dict(grids)
    tgrids = {k: convert.eb_grid_model(export_grid(g), device="cpu")
              for k, g in grids.items()}
    for i in range(6, 14):
        cj, ct = _caches(feats, ebs, i)
        x_j, x_t = jnp.asarray(slices[i]), torch.tensor(slices[i])
        for kind in jgrids:
            mid = jgrids[kind].predict(x_j, ebs[1], cj)
            for target in (mid * 0.7, mid * 1.3):
                for iters in (0, 1, 3, 32):
                    want = JUC.find_error_bound_for_cr(
                        jgrids[kind], x_j, target, max_iters=iters,
                        feat_cache=cj)
                    got = TUC.find_error_bound_for_cr(
                        tgrids[kind], x_t, target, max_iters=iters,
                        feat_cache=ct)
                    assert tuple(got) == tuple(want)
        f = feats[i, 1][None]
        want = JUC.best_compressor(
            {k: g.models[1] for k, g in jgrids.items()}, x_j, ebs[1],
            feats=jnp.asarray(f))
        got = TUC.best_compressor(
            {k: g.models[1] for k, g in tgrids.items()}, x_t, ebs[1],
            feats=torch.from_numpy(f.copy()))
        assert got == want
        psnr = jgrids["spline"].predict_psnr(x_j, ebs[1], cj)
        for cr_floor in (1.5, 1e6):
            want = JUC.find_setting(jgrids, x_j, cr_floor=cr_floor,
                                    psnr_floor=psnr, feat_cache=cj)
            got = TUC.find_setting(tgrids, x_t, cr_floor=cr_floor,
                                   psnr_floor=psnr, feat_cache=ct)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)

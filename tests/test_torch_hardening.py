"""The reference's hardening and property tests, held against the port.

Each case names the reference test it ports (``tests/test_hardening.py``
or ``tests/test_properties.py``), runs the JAX function and the port's
on the same numpy input, and asserts both the reference's claim and the
port's agreement with it.  Models are the reference's, carried across
with ``repro_torch.convert``.
"""
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import pipeline as JPL  # noqa: E402
from repro.core import predictors as JP  # noqa: E402
from repro.core import usecases as JUC  # noqa: E402
from repro.data import scientific as JS  # noqa: E402
from repro.dist import sweep as JDS  # noqa: E402
from repro.kernels.qent import ref as JQR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pipeline as TPL  # noqa: E402
from repro_torch.core import predictors as TP  # noqa: E402
from repro_torch.core import usecases as TUC  # noqa: E402
from repro_torch.dist import sweep as TDS  # noqa: E402
from repro_torch.kernels.qent import ops as TQO  # noqa: E402

from test_torch_usecases import export_grid  # noqa: E402

_EPSS = np.asarray([3e-3, 1e-2, 1e-1], np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _stack(seed: int, k: int, m: int = 16, n: int = 24) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(k, m, n)).astype(
        np.float32)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    """test_hardening.py::setup: sz2 on 6 scale-u 64^2 slices."""
    slices = np.asarray(JS.field_slices("scale-u", count=8, n=64))
    rng = float(slices.max() - slices.min())
    ebs = [1e-4 * rng, 1e-3 * rng, 1e-2 * rng]
    jm = JUC.EbGridModel.train(jnp.asarray(slices[:6]), "sz2", ebs)
    tm = convert.eb_grid_model(export_grid(jm), device="cpu")
    return slices, ebs, jm, tm


# ------------------------------------------------- UC1 zero-iteration search
def test_find_error_bound_zero_iters_returns_finite(setup):
    """test_hardening.py::test_find_error_bound_zero_iters_returns_finite"""
    slices, ebs, jm, tm = setup
    want = JUC.find_error_bound_for_cr(jm, jnp.asarray(slices[7]), 6.0,
                                       max_iters=0)
    eps, cr = TUC.find_error_bound_for_cr(tm, _t(slices[7]), 6.0, max_iters=0)
    assert np.isfinite(eps) and np.isfinite(cr)
    assert ebs[0] <= eps <= ebs[-1]
    assert (eps, cr) == tuple(want)


def test_find_error_bound_zero_iters_matches_exhaustive_convention(setup):
    """test_hardening.py::
    test_find_error_bound_zero_iters_matches_exhaustive_convention"""
    slices, ebs, jm, tm = setup
    x = _t(slices[7])
    cache = TP.get_engine(tm.cfg).cached(x)
    cr_lo = tm.predict(x, ebs[0], cache)
    cr_hi = tm.predict(x, ebs[-1], cache)
    assert cr_lo < 6.0 < cr_hi, "fixture drifted: pick a bracketed target"
    eps, cr = TUC.find_error_bound_for_cr(tm, x, 6.0, max_iters=0)
    assert eps == ebs[-1] and cr == cr_hi
    assert cr_hi == jm.predict(jnp.asarray(slices[7]), ebs[-1])


# ------------------------------------------------ non-positive model outputs
class _JConst(NamedTuple):
    level: jnp.ndarray

    def predict(self, feats):
        return jnp.broadcast_to(self.level, (feats.shape[0],))


class _TConst(NamedTuple):
    level: torch.Tensor

    def predict(self, feats):
        return self.level.expand(feats.shape[0])


def _degenerate(levels, ebs):
    """The reference's and the port's grid of constant models."""
    jg = JUC.EbGridModel(np.asarray(ebs, np.float64), [
        JPL.CRPredictor(_JConst(jnp.float32(v)), float(e))
        for v, e in zip(levels, ebs)], "degenerate")
    tg = TUC.EbGridModel(np.asarray(ebs, np.float64), [
        TPL.CRPredictor(_TConst(torch.tensor(float(v), dtype=torch.float32)),
                        float(e)) for v, e in zip(levels, ebs)], "degenerate")
    return jg, tg


def _noise(seed):
    return np.random.default_rng(seed).normal(size=(32, 32)).astype(
        np.float32)


def test_predict_clamps_nonpositive_model_output():
    """test_hardening.py::test_predict_clamps_nonpositive_model_output"""
    x = _noise(0)
    jg, tg = _degenerate([-2.0, 0.0], [1e-3, 1e-1])
    mid = float(np.exp(0.5 * (np.log(1e-3) + np.log(1e-1))))
    for eps in (1e-3, mid, 1e-1):
        cr = tg.predict(_t(x), eps)
        assert np.isfinite(cr) and cr > 0, (eps, cr)
        assert cr == jg.predict(jnp.asarray(x), eps)


def test_bisection_never_compares_nan():
    """test_hardening.py::test_bisection_never_compares_nan"""
    x = _noise(1)
    jg, tg = _degenerate([-1.0, np.nan], [1e-3, 1e-1])
    got = TUC.find_error_bound_for_cr(tg, _t(x), 5.0, max_iters=8)
    assert np.all(np.isfinite(got))
    assert tuple(got) == tuple(JUC.find_error_bound_for_cr(
        jg, jnp.asarray(x), 5.0, max_iters=8))


def test_clamp_keeps_inf_above_any_target():
    """test_hardening.py::test_clamp_keeps_inf_above_any_target"""
    for v in (float("inf"), float("nan"), -3.0, 0.0, 2.5, 1e-12, 1e12):
        assert TUC._clamp_cr(v) == JUC._clamp_cr(v)
    assert TUC._clamp_cr(float("inf")) == TUC._CR_CEIL
    assert TUC._clamp_cr(float("nan")) == TUC._CR_FLOOR
    assert TUC._clamp_cr(-3.0) == TUC._CR_FLOOR
    x = _noise(3)
    jg, tg = _degenerate([2.0, np.inf], [1e-3, 1e-1])
    eps, cr = TUC.find_error_bound_for_cr(tg, _t(x), 5.0, max_iters=4)
    assert np.isfinite(cr) and 1e-3 <= eps <= 1e-1
    assert (eps, cr) == tuple(JUC.find_error_bound_for_cr(
        jg, jnp.asarray(x), 5.0, max_iters=4))


# ----------------------------------------------------------- eps validation
@pytest.mark.parametrize("call", [
    lambda P, x: P.quantized_codes(x(np.ones(8)), 0.0),
    lambda P, x: P.quantized_codes(x(np.ones(8)), -1e-3),
    lambda P, x: P.quantized_entropy(x(np.ones(8)), 0.0),
    lambda P, x: P.quantized_entropy_sweep(x(np.ones((2, 64))), [1e-3, 0.0]),
    lambda P, x: P.features_sweep(x(np.ones((2, 16, 16))), [-1.0]),
    lambda P, x: P.features_2d_cached(x(np.ones((16, 16))))(0.0),
])
def test_nonpositive_eps_rejected(call):
    """test_hardening.py::test_quantized_codes_rejects_nonpositive_eps,
    ::test_quantized_entropy_sweep_rejects_nonpositive_eps and
    ::test_slice_cache_rejects_nonpositive_eps"""
    for P, x in ((JP, lambda a: jnp.asarray(a, jnp.float32)),
                 (TP, lambda a: torch.tensor(a, dtype=torch.float32))):
        with pytest.raises(ValueError, match="positive"):
            call(P, x)
    with pytest.raises(ValueError, match="positive"):
        TQO.quantized_entropy_sweep(torch.ones(2, 64), [0.0])


# ------------------------------------------------------ int32 code overflow
def test_quantized_codes_saturate_instead_of_wrapping():
    """test_hardening.py::test_quantized_codes_saturate_instead_of_wrapping"""
    x = np.asarray([1e30, -1e30, 1.0], np.float32)
    codes = TP.quantized_codes(_t(x), 1e-6).numpy()
    assert codes[0] == 2147483520 and codes[1] == -2147483648
    assert codes[0] > codes[2] > codes[1]
    assert np.array_equal(codes, np.asarray(JP.quantized_codes(
        jnp.asarray(x), 1e-6)))


def test_qent_sweep_extreme_values_match_saturating_oracle():
    """test_hardening.py::
    test_qent_sweep_extreme_values_match_saturating_oracle"""
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(size=62), [1e30, -1e30]])
    x = x[None].astype(np.float32)
    eps = 1e-6
    got = float(TP.quantized_entropy_sweep(_t(x), [eps])[0, 0])
    codes = np.clip(np.floor(x[0].astype(np.float64) / eps),
                    -2147483648.0, 2147483520.0).astype(np.int64)
    counts = np.bincount(codes - codes.min())
    p = counts[counts > 0] / counts.sum()
    want = float(-(p * np.log2(p)).sum())
    assert np.isfinite(got) and abs(got - want) < 1e-3, (got, want)
    ref = float(JP.quantized_entropy_sweep(jnp.asarray(x),
                                           jnp.asarray([eps]))[0, 0])
    assert got == ref


def test_best_compressor_empty_models_raises():
    """test_hardening.py::test_best_compressor_empty_models_raises"""
    with pytest.raises(ValueError, match="at least one trained model"):
        TUC.best_compressor({}, torch.ones(16, 16), 1e-3)


# ------------------------------------------------- q-ent boundary-eps oracle
@pytest.mark.parametrize("rel_eb", [1.0, 2.0, 1.0 / 65535.0])
def test_qent_oracle_at_boundary_eps(rel_eb):
    """test_hardening.py::test_qent_oracle_at_boundary_eps"""
    slices = np.asarray(JS.field_slices("miranda-vx", count=2, n=64))
    eps = rel_eb * float(slices.max() - slices.min())
    got_sweep = TP.quantized_entropy_sweep(
        _t(slices), torch.tensor([eps], dtype=torch.float32)).numpy()
    ref_sweep = np.asarray(JP.quantized_entropy_sweep(
        jnp.asarray(slices), jnp.asarray([eps], jnp.float32)))
    assert np.array_equal(_bits(got_sweep), _bits(ref_sweep))
    for s in range(slices.shape[0]):
        flat = slices[s].astype(np.float64).reshape(-1)
        codes = np.floor(flat / np.float32(eps)).astype(np.int64)
        counts = np.bincount(codes - codes.min())
        p = counts[counts > 0] / counts.sum()
        want = float(-(p * np.log2(p)).sum())
        got_one = float(TP.quantized_entropy(_t(slices[s]), eps))
        assert abs(got_one - want) < 1e-3, (s, got_one, want)
        assert abs(got_sweep[s, 0] - want) < 1e-3, (s, got_sweep[s, 0], want)
        assert got_one == float(JP.quantized_entropy(jnp.asarray(slices[s]),
                                                     eps))


def test_qent_huge_eps_zero_entropy():
    """test_hardening.py::test_qent_huge_eps_zero_entropy"""
    slices = np.asarray(JS.field_slices("miranda-vx", count=2, n=64))
    slices = (slices - slices.min() + 1.0).astype(np.float32)
    eps = torch.tensor([1e12], dtype=torch.float32)
    got = TP.quantized_entropy_sweep(_t(slices), eps).numpy()
    np.testing.assert_allclose(got, 0.0, atol=1e-4)
    assert np.array_equal(_bits(got), _bits(JP.quantized_entropy_sweep(
        jnp.asarray(slices), jnp.asarray([1e12], jnp.float32))))


# -------------------------------------------------------------- properties
@pytest.mark.parametrize("seed,k", [(0, 2), (3, 3), (7, 5)])
def test_slice_permutation_equivariance(seed, k):
    """test_properties.py::test_slice_permutation_equivariance"""
    x = _stack(seed, k)
    perm = np.random.default_rng(seed + 1).permutation(k)
    base = TP.features_sweep(_t(x), _EPSS).numpy()
    permuted = TP.features_sweep(_t(x[perm]), _EPSS).numpy()
    assert np.array_equal(_bits(permuted), _bits(base[perm]))
    ref = np.asarray(JP.features_sweep(jnp.asarray(x), _EPSS))
    # the q-ent column is the reference's bits; the trunc column rides
    # the Gram, held to the feature tolerance of tests/test_dist_sweep.py
    assert np.array_equal(_bits(base[..., 0]), _bits(ref[..., 0]))
    np.testing.assert_allclose(base, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,k", [(0, 2), (5, 4)])
def test_eps_permutation_equivariance(seed, k):
    """test_properties.py::test_eps_permutation_equivariance"""
    x = _stack(seed, k)
    perm = np.random.default_rng(seed + 2).permutation(len(_EPSS))
    base = TP.quality_sweep(_t(x), _EPSS).numpy()
    permuted = TP.quality_sweep(_t(x), _EPSS[perm]).numpy()
    assert np.array_equal(_bits(permuted), _bits(base[:, perm]))
    ref = np.asarray(JP.quality_sweep(jnp.asarray(x), _EPSS))
    assert np.array_equal(_bits(base), _bits(ref))


@pytest.mark.parametrize("seed,pad,mode", [(0, 1, "features"),
                                           (4, 3, "quality"),
                                           (8, 5, "features")])
def test_pad_row_invariance(seed, pad, mode):
    """test_properties.py::test_pad_row_invariance"""
    k = 3
    x = _stack(seed, k)
    fn = TP.features_sweep if mode == "features" else TP.quality_sweep
    base = fn(_t(x), _EPSS).numpy()
    padded = TDS.gather_rows(TDS.sweep_padded(
        _t(x), _EPSS, TP.PredictorConfig(), k_pad=k + pad, mode=mode))
    assert padded.shape[0] == k + pad
    assert np.array_equal(_bits(padded[:k]), _bits(base))
    ref = np.asarray(JDS.gather_rows(JDS.sweep_padded(
        jnp.asarray(x), _EPSS, JP.PredictorConfig(), k_pad=k + pad,
        mode=mode)))
    if mode == "quality":
        assert np.array_equal(_bits(padded), _bits(ref))
    else:
        np.testing.assert_allclose(padded, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (2, 0.37), (5, 1e3)])
def test_variance_fraction_scale_invariance(seed, scale):
    """test_properties.py::test_variance_fraction_scale_invariance"""
    scale = float(np.float32(scale))
    cfg = TP.PredictorConfig()
    x = _stack(seed, 3)
    assert TP.variance_fraction_for(cfg, x.ndim) == cfg.variance_fraction_2d
    assert TP.variance_fraction_for(cfg, 4) == cfg.variance_fraction_3d
    assert TP.variance_fraction_for(cfg, 3) == JP.variance_fraction_for(
        JP.PredictorConfig(), 3)
    for s in range(x.shape[0]):
        t0 = float(TP.svd_trunc(_t(x[s])))
        t1 = float(TP.svd_trunc(_t(np.float32(scale) * x[s])))
        assert t1 == pytest.approx(t0, abs=1.0 / x.shape[2] + 1e-6)
        assert t0 == pytest.approx(float(JP.svd_trunc(jnp.asarray(x[s]))),
                                   rel=1e-5)


@pytest.mark.parametrize("seed,eps0", [(0, 1e-3), (4, 4e-3), (9, 1.5e-2)])
def test_qent_monotone_vs_sort_oracle(seed, eps0):
    """test_properties.py::test_qent_monotone_vs_sort_oracle (the hashed
    route, 4096 bins, against the exact oracle and the reference's)"""
    x = np.clip(_stack(seed, 2), -1.0, 1.0)
    epss = np.asarray([eps0, 2 * eps0, 4 * eps0], np.float32)
    ent = TQO.quantized_entropy_sweep(_t(x), epss, 4096).numpy()
    ref = np.asarray(JQR.quantized_entropy_sweep(jnp.asarray(x), epss))
    # the hashed route's entropy sum is held to the q-ent tolerance of
    # tests/test_kernels.py (its order is fixed, not the reference's)
    np.testing.assert_allclose(ent, ref, rtol=0, atol=1e-4)
    for s in range(x.shape[0]):
        flat = x[s].reshape(-1)
        for ei, eps in enumerate(epss):
            codes = np.floor(flat / np.float32(eps)).astype(np.int64)
            _, counts = np.unique(codes, return_counts=True)
            p = counts.astype(np.float64) / counts.sum()
            oracle = float(-(p * np.log2(p)).sum())
            assert ent[s, ei] == pytest.approx(oracle, abs=1e-4)
        assert ent[s, 0] + 1e-5 >= ent[s, 1] >= ent[s, 2] - 1e-5

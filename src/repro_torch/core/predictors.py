"""Compressor-agnostic statistical predictors of lossy compressibility.

The paper's section 3.1, as the batched sweep engine of
``repro.core.predictors``:

* ``svd_trunc_batch``   -- fraction of singular values needed to recover
                           99% of the variance of each mean-corrected 2-D
                           slice, from ``eigvalsh`` of its Gram matrix;
* ``hosvd_trunc_batch`` -- the 3-D extension, per-mode unfolding Grams at
                           90% of the squared singular mass;
* ``quantized_entropy_sweep`` -- entropy of ``floor(d / eps)`` at every
                           error bound of a grid, codes hashed into
                           ``qent_bins`` bins (the kernel route's semantics).

The Gram products run through ``kernels.gram`` and the histograms
through ``kernels.qent``: the CUDA kernels for tensors on the card, the
plain versions for tensors on the CPU.  ``eigvalsh`` stays the library
call, as the reference also calls it outside any kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.qent import ops as qent_ops
from repro_torch.kernels.quality import ops as quality_ops
from repro_torch.quant import validate_eps_positive as _validate_eps_positive

DEFAULT_VARIANCE_FRACTION_2D = 0.99
DEFAULT_VARIANCE_FRACTION_3D = 0.90


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    variance_fraction_2d: float = DEFAULT_VARIANCE_FRACTION_2D
    variance_fraction_3d: float = DEFAULT_VARIANCE_FRACTION_3D
    qent_bins: int = 65536


def _trunc_fraction(g: torch.Tensor, variance_fraction: float) -> torch.Tensor:
    """(k, p, p) Gram stack -> (k,) fraction of eigenvalues (descending)
    needed to reach ``variance_fraction`` of the total; a zero-variance
    matrix yields 1/p."""
    ev = torch.clamp(torch.linalg.eigvalsh(g), min=0.0).flip(-1)
    total = ev.sum(dim=1, keepdim=True)
    cum = torch.cumsum(ev, dim=1)
    frac = torch.where(total > 0, cum / torch.clamp(total, min=1e-30),
                       torch.ones_like(cum))
    needed = 1 + (frac < variance_fraction).sum(dim=1)
    return needed.to(torch.float32) / ev.shape[1]


def svd_trunc_batch(slices: torch.Tensor,
                    variance_fraction: float = DEFAULT_VARIANCE_FRACTION_2D
                    ) -> torch.Tensor:
    """svd_trunc for a (k, m, n) stack in one batched Gram + eigvalsh."""
    if slices.ndim != 3:
        raise ValueError(f"svd_trunc_batch expects (k, m, n), got "
                         f"{tuple(slices.shape)}")
    x = slices.to(torch.float32)
    x = x - x.mean(dim=1, keepdim=True)          # mean-corrected columns
    _, m, n = x.shape
    return _trunc_fraction(gram_ops.gram_batched(x, transpose=m >= n),
                           variance_fraction)


def svd_trunc(x: torch.Tensor,
              variance_fraction: float = DEFAULT_VARIANCE_FRACTION_2D
              ) -> torch.Tensor:
    """The k = 1 case of :func:`svd_trunc_batch`."""
    if x.ndim != 2:
        raise ValueError(f"svd_trunc expects a 2-D slice, got {tuple(x.shape)}")
    return svd_trunc_batch(x[None], variance_fraction)[0]


def _unfold_batch(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-``mode`` unfolding of every tensor in a (k, ...) stack."""
    return torch.movedim(x, 1 + mode, 1).reshape(x.shape[0],
                                                 x.shape[1 + mode], -1)


def hosvd_trunc_batch(vols: torch.Tensor,
                      variance_fraction: float = DEFAULT_VARIANCE_FRACTION_3D
                      ) -> torch.Tensor:
    """``hosvd_trunc`` for a (k, d, m, n) stack (rank >= 4): one batched
    Gram + batched ``eigvalsh`` per mode; each volume is corrected by its
    own global mean.  Returns the (k,) mean fraction across modes."""
    if vols.ndim < 4:
        raise ValueError(
            f"hosvd_trunc_batch expects a (k, d, m, n) volume stack "
            f"(rank >= 4), got {tuple(vols.shape)}; wrap one volume as x[None]")
    x = vols.to(torch.float32)
    x = x - x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)
    fracs = []
    for mode in range(x.ndim - 1):
        u = _unfold_batch(x, mode)
        _, p, q = u.shape
        g = gram_ops.gram_batched(u, transpose=p >= q)
        fracs.append(_trunc_fraction(g, variance_fraction))
    return torch.stack(fracs).mean(dim=0)


def hosvd_trunc(x: torch.Tensor,
                variance_fraction: float = DEFAULT_VARIANCE_FRACTION_3D
                ) -> torch.Tensor:
    """The k = 1 case of :func:`hosvd_trunc_batch`."""
    if x.ndim < 3:
        raise ValueError(f"hosvd_trunc expects >=3-D tensor, got {tuple(x.shape)}")
    return hosvd_trunc_batch(x[None], variance_fraction)[0]


def quantized_entropy_sweep(slices: torch.Tensor, epss,
                            num_bins: int = 65536) -> torch.Tensor:
    """q-ent of a (k, ...) stack at an (e,) eb vector -> (k, e), the codes
    saturated to int32 and hashed into ``num_bins`` bins (exact whenever
    the code range fits the bins)."""
    _validate_eps_positive(epss)
    k = slices.shape[0]
    flat = slices.to(torch.float32).reshape(k, -1)
    return qent_ops.quantized_entropy_sweep(flat, _eps_tensor(epss, flat),
                                            num_bins)


def variance_fraction_for(cfg: PredictorConfig, stack_ndim: int) -> float:
    """2-D slices (rank-3 stacks) use ``variance_fraction_2d``, volumes
    (rank >= 4) the HOSVD ``variance_fraction_3d``."""
    return (cfg.variance_fraction_2d if stack_ndim == 3
            else cfg.variance_fraction_3d)


# Trailing-axis width of the sweep tensor per mode: "features" is the
# (log q-ent, log trunc-ratio) pair, "quality" the (PSNR, NRMSE) pair,
# "both" their concatenation from one read of the data.
SWEEP_MODE_WIDTHS = {"features": 2, "quality": 2, "both": 4}


def _eps_tensor(epss, like: torch.Tensor) -> torch.Tensor:
    if isinstance(epss, torch.Tensor):
        return epss.to(device=like.device, dtype=torch.float32).reshape(-1)
    return torch.as_tensor(np.asarray(epss, np.float64).reshape(-1),
                           dtype=torch.float32, device=like.device)


def _log_ratio(sv: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(sv, min=1e-6) / torch.clamp(sigma, min=1e-12))


def _features_sweep_impl(slices: torch.Tensor, epss: torch.Tensor, *,
                         vf: float, bins: int, mode: str = "features"
                         ) -> torch.Tensor:
    """(k, m, n) | (k, d, m, n) x (e,) -> (k, e, w), ``w`` per
    ``SWEEP_MODE_WIDTHS[mode]``."""
    if mode not in SWEEP_MODE_WIDTHS:
        raise ValueError(f"unknown sweep mode {mode!r}; expected one of "
                         f"{sorted(SWEEP_MODE_WIDTHS)}")
    x = slices.to(torch.float32)
    outs = []
    if mode in ("features", "both"):
        sigma = torch.std(x, dim=tuple(range(1, x.ndim)), correction=0)
        sv = (svd_trunc_batch(x, vf) if x.ndim == 3
              else hosvd_trunc_batch(x, vf))
        log_ratio = _log_ratio(sv, sigma)
        qe = quantized_entropy_sweep(x, epss, bins)
        log_qe = torch.log(torch.clamp(qe, min=1e-3))            # (k, e)
        outs.append(torch.stack(
            [log_qe, log_ratio[:, None].expand_as(log_qe)], dim=-1))
    if mode in ("quality", "both"):
        outs.append(quality_ops.quality_sweep(x, epss))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def _sweep(slices, epss, cfg: PredictorConfig, mode: str) -> torch.Tensor:
    if slices.ndim not in (3, 4):
        raise ValueError(
            f"features_sweep expects a (k, m, n) slice stack or a "
            f"(k, d, m, n) volume stack, got {tuple(slices.shape)}; wrap a "
            f"single slice/volume as x[None]")
    _validate_eps_positive(epss)
    return _features_sweep_impl(
        slices, _eps_tensor(epss, slices),
        vf=variance_fraction_for(cfg, slices.ndim), bins=cfg.qent_bins,
        mode=mode)


def features_sweep(slices: torch.Tensor, epss,
                   cfg: PredictorConfig = PredictorConfig(), *,
                   quality: bool = False):
    """The full predictor tensor in one pass: (k, m, n) x (e,) -> (k, e, 2).

    Column [..., 0] is log(q-ent) (eb-dependent, fused multi-eps
    histogram); column [..., 1] is log(svd_trunc / sigma) (for volumes
    log(hosvd_trunc / sigma); eb-independent, broadcast).

    ``quality=True`` makes the same pass also emit the (k, e, 2)
    [PSNR, NRMSE] tensor of the quantization proxy and returns the pair
    ``(features, quality)``."""
    out = _sweep(slices, epss, cfg, "both" if quality else "features")
    if quality:
        return out[..., :2], out[..., 2:]
    return out


def quality_sweep(slices: torch.Tensor, epss,
                  cfg: PredictorConfig = PredictorConfig()) -> torch.Tensor:
    """The quality half of the frontier: (k, ...) x (e,) -> (k, e, 2)."""
    return _sweep(slices, epss, cfg, "quality")


def _svd_sigma(x: torch.Tensor, vf: float):
    xf = x.to(torch.float32)
    sv = (svd_trunc_batch(xf[None], vf) if x.ndim == 2
          else hosvd_trunc_batch(xf[None], vf))[0]
    return sv, torch.std(xf, correction=0)


class SliceCache:
    """Featurization cache for ONE slice or volume (the UC1/UC2 cost
    structure): the eps-independent SVD-or-HOSVD/sigma part is computed
    at most once, q-ent is memoized per error bound, and ``prefetch``
    fills the memo for a whole eb grid with one fused sweep."""

    def __init__(self, x: torch.Tensor, cfg: PredictorConfig):
        self._x = x
        self._cfg = cfg
        self._memo: dict = {}
        self._log_ratio = None

    @staticmethod
    def _key(eps) -> float:
        # features are computed in f32, so memoize at f32 resolution
        return float(np.float32(eps))

    def _ratio(self) -> torch.Tensor:
        if self._log_ratio is None:
            sv, sigma = _svd_sigma(
                self._x, variance_fraction_for(self._cfg, self._x.ndim + 1))
            self._log_ratio = _log_ratio(sv, sigma)
        return self._log_ratio

    def prefetch(self, epss) -> torch.Tensor:
        """Featurize the whole eb grid in one sweep; returns (e, 2)."""
        feats = features_sweep(self._x[None], epss, self._cfg)[0]
        return self.seed(epss, feats)

    def seed(self, epss, feats) -> torch.Tensor:
        """Preload externally computed features: ``feats[i]`` is the (2,)
        feature vector of this slice at ``epss[i]``."""
        epss = np.asarray(epss, np.float64).reshape(-1)
        if len(epss) != len(feats):
            raise ValueError(
                f"seed needs one feature row per eb: {len(epss)} ebs vs "
                f"{len(feats)} rows")
        for i, eps in enumerate(epss):
            self._memo[self._key(eps)] = feats[i]
        if len(feats):
            self._log_ratio = feats[0][1]
        return feats

    def __call__(self, eps) -> torch.Tensor:
        _validate_eps_positive(eps)
        key = self._key(eps)
        if key not in self._memo:
            qe = quantized_entropy_sweep(self._x[None], [key],
                                         self._cfg.qent_bins)[0, 0]
            self._memo[key] = torch.stack(
                [torch.log(torch.clamp(qe, min=1e-3)), self._ratio()])
        return self._memo[key]


class FeaturizationEngine:
    """Batched, sweep-native featurizer -- the single entry point the
    pipeline and use cases route through.

    * ``sweep(slices, epss)``  -- (k, m, n) x (e,) -> (k, e, 2), one pass.
    * ``features(slices, eps)`` -- (k, 2): the e=1 column of the sweep.
    * ``quality(slices, epss)`` -- (k, e, 2) PSNR/NRMSE.
    * ``cached(x)``            -- per-slice :class:`SliceCache`.

    Volumes are first-class: every entry point also accepts a (k, d, m, n)
    stack (``cached``: one (d, m, n) volume)."""

    def __init__(self, cfg: PredictorConfig = PredictorConfig()):
        self.cfg = cfg

    def sweep(self, slices: torch.Tensor, epss, *, quality: bool = False):
        return features_sweep(slices, epss, self.cfg, quality=quality)

    def quality(self, slices: torch.Tensor, epss) -> torch.Tensor:
        return quality_sweep(slices, epss, self.cfg)

    def features(self, slices: torch.Tensor, eps: float) -> torch.Tensor:
        return self.sweep(slices, [eps])[:, 0, :]

    def cached(self, x: torch.Tensor, *, features=None, epss=None) -> SliceCache:
        c = SliceCache(x, self.cfg)
        if features is not None:
            c.seed(epss, features)
        return c


_DEFAULT_ENGINE = FeaturizationEngine()


def get_engine(cfg: PredictorConfig = None) -> FeaturizationEngine:
    """The shared default engine (or a fresh one for a custom config)."""
    if cfg is None or cfg == _DEFAULT_ENGINE.cfg:
        return _DEFAULT_ENGINE
    return FeaturizationEngine(cfg)

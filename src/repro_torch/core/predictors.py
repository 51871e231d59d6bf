"""Compressor-agnostic statistical predictors of lossy compressibility.

The paper's section 3.1, as the batched sweep engine of
``repro.core.predictors``:

* ``svd_trunc_batch``   -- fraction of singular values needed to recover
                           99% of the variance of each mean-corrected 2-D
                           slice, from ``eigvalsh`` of its Gram matrix;
* ``hosvd_trunc_batch`` -- the 3-D extension, per-mode unfolding Grams at
                           90% of the squared singular mass;
* ``quantized_entropy_sweep`` -- entropy of ``floor(d / eps)`` at every
                           error bound of a grid: exact from one sort per
                           slice (the default), or from codes hashed into
                           ``qent_bins`` bins by the fused histogram kernel
                           (``use_kernels=True``).

and the reference's looped entry points, one slice at a time:
``features_2d``/``features_3d``/``features_batch`` and the scalar
``quantized_codes``, ``quantized_entropy`` and ``entropy``.

``PredictorConfig.use_kernels`` keeps the reference's meaning for
results: it chooses between the two q-ent routes, which differ once the
code range outgrows the bins.  The Gram products (``kernels.gram``) and
the quality SSE (``kernels.quality``) compute the same function either
way, so they take their kernels under both values.  A kernel runs for a
tensor on the card, its plain version for a tensor on the CPU.
``eigvalsh`` and the sort stay library calls, as the reference also
makes them outside any kernel.  Every entry point reads a subnormal
value as a zero of its sign, as the reference does
(``quant.flush_subnormals``), but ``entropy``, which codes bit patterns.

A row's features do not depend on the batch it is swept in: the Gram
kernel fixes its numerics from the slice's shape, ``eigvalsh`` solves
each matrix alone, and every library reduction whose batched form adds
a row in another order (the means, sigma, the trunc-fraction sums)
runs on each row alone (``quant.per_row``).  Nor does a row's value at
an eb depend on the eb grid: both q-ent routes add each (row, eb)
entropy in XLA's fixed order (``refmath.sum_rows_f32``), the sort route
one eb at a time.  So a slice gets the
same bits alone, in its batch, in a padded bucket, in any eb grid and
on any shard, which streaming, serving and sharded sweeps rely on.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch import refmath
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.qent import ops as qent_ops
from repro_torch.kernels.quality import ops as quality_ops
from repro_torch.kernels.quality.ref import fma32
from repro_torch.quant import INT32_CODE_MAX, INT32_CODE_MIN, flush_subnormals
from repro_torch.quant import SQRT_MIN_NORMAL, per_row
from repro_torch.quant import scalar as _scalar
from repro_torch.quant import validate_eps_positive as _validate_eps_positive

DEFAULT_VARIANCE_FRACTION_2D = 0.99
DEFAULT_VARIANCE_FRACTION_3D = 0.90


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    variance_fraction_2d: float = DEFAULT_VARIANCE_FRACTION_2D
    variance_fraction_3d: float = DEFAULT_VARIANCE_FRACTION_3D
    qent_bins: int = 65536
    # q-ent route: False = exact sort route, True = hashed-bin histogram
    # kernel (the reference's Pallas route); Gram and quality take their
    # kernels on the card under either value
    use_kernels: bool = False


def _trunc_fraction(g: torch.Tensor, variance_fraction: float) -> torch.Tensor:
    """(k, p, p) Gram stack -> (k,) fraction of eigenvalues (descending)
    needed to reach ``variance_fraction`` of the total; a zero-variance
    matrix yields 1/p.  ``eigvalsh`` solves each matrix of the batch on
    its own (one LAPACK / cuSOLVER call per matrix, bit-equal alone and
    in any batch at the sweep's sizes); the total and the ``cumsum``
    are summed row by row, since their batched forms add a row in an
    order that depends on the batch."""
    ev = torch.clamp(torch.linalg.eigvalsh(g), min=0.0).flip(-1)
    total = per_row(lambda r: r.sum(dim=1, keepdim=True), ev)
    cum = per_row(lambda r: torch.cumsum(r, dim=1), ev)
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
    x = slices.to(torch.float32).contiguous()
    # mean-corrected columns
    x = x - per_row(lambda r: r.mean(dim=1, keepdim=True), x)
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
    x = vols.to(torch.float32).contiguous()
    mean = per_row(lambda r: r.mean().reshape(1), x)
    x = x - mean.reshape((-1,) + (1,) * (x.ndim - 1))
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


# g(j) by rank j, grown to the longest run seen: {device: (len,) table}
_RANK_TERMS: dict = {}
_RANK_TERMS_LOCK = threading.Lock()
_RANK_TERMS_CHUNK = 1 << 22


def rank_terms(j: torch.Tensor) -> torch.Tensor:
    """``g(j) = j*log2(j) - (j-1)*log2(max(j-1, 1))`` of float32 ranks
    ``j >= 1``, bit-equal to the reference's jitted expression: ``log2``
    by XLA's Cephes polynomial (``refmath.log2_f32``) and the difference
    contracted as XLA's CPU fusion contracts it, into
    ``fma(j, log2(j), -((j-1)*log2(j-1)))``.  Both products are large
    and close (g is about log2(j) + 1.44), so the one rounding the FMA
    saves decides most of g's bits."""
    lj = refmath.log2_f32(j)
    lj1 = refmath.log2_f32(torch.clamp(j - 1, min=1))
    return fma32(j, lj, -((j - 1) * lj1))


def _rank_term_table(jmax: int, device) -> torch.Tensor:
    """float32 ``g(j)`` at index ``j`` for ``j = 1..jmax`` at least (index
    0 unused) on ``device``: built once per device, in chunks, and
    extended to the next power of two when a longer run comes.  An entry
    depends on its rank alone, so the table's length never changes a
    result."""
    device = torch.device(device)
    with _RANK_TERMS_LOCK:
        table = _RANK_TERMS.get(device)
        if table is None:
            table = torch.zeros(1, dtype=torch.float32, device=device)
        if table.shape[0] <= jmax:
            size = 1 << jmax.bit_length()
            parts = [table]
            for lo in range(table.shape[0], size, _RANK_TERMS_CHUNK):
                parts.append(rank_terms(torch.arange(
                    lo, min(lo + _RANK_TERMS_CHUNK, size),
                    dtype=torch.float32, device=device)))
            table = _RANK_TERMS[device] = torch.cat(parts)
        return table


def _entropy_last_step(s: torch.Tensor, n: int) -> torch.Tensor:
    """``log2(n) - s / n`` of float32 run-term sums, as the reference's
    jitted ``jnp.log2(float(n)) - s / n`` gives it: XLA folds the
    constant ``log(f32(n)) / log(2)`` (each correctly rounded), turns the
    division into a product by ``f32(1 / f32(n))`` and contracts the
    difference into one FMA.  ``n`` is rounded to float32 first, as JAX
    rounds it (a volume may hold more than 2^24 values)."""
    nf = np.float32(n)
    log2n = np.float32(np.float32(np.log(np.float64(nf)))
                       / np.float32(np.log(2.0)))
    return fma32(-s, float(np.float32(1.0) / nf), float(log2n))


def _sorted_entropy(xs: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Entropy (bits) of ``floor(xs / eps)`` for each row of an
    ascending-sorted (k, n) stack from the exact run lengths of the
    sorted codes, in the reference's float32 arithmetic, bit for bit.

    H = log2(n) - (1/n) sum_runs L*log2(L); telescoping over the rank
    j = 1..L inside each run, L*log2(L) = sum_j g(j) with
    g(j) = j*log2(j) - (j-1)*log2(j-1), so one forward cummax (the rank)
    replaces any per-run reduction.  g depends on the rank alone, so it
    is gathered from a table of the reference's float32 values
    (:func:`rank_terms`); each row's terms add in XLA's CPU order
    (``refmath.sum_rows_f32``, elementwise adds over all rows, so a row
    has the same bits in any batch) and the last step is the
    reference's (:func:`_entropy_last_step`)."""
    k, n = xs.shape
    codes = torch.clamp(torch.floor(flush_subnormals(xs / eps)), INT32_CODE_MIN,
                        INT32_CODE_MAX).to(torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=xs.device)
    start = torch.ones((k, n), dtype=torch.bool, device=xs.device)
    start[:, 1:] = codes[:, 1:] != codes[:, :-1]
    del codes
    run_start = torch.cummax(torch.where(start, iota, 0), dim=1).values
    del start
    j = (iota - run_start + 1).reshape(-1)
    del run_start
    table = _rank_term_table(int(j.max()), xs.device)
    g = torch.index_select(table, 0, j).reshape(k, n)
    del j
    return _entropy_last_step(refmath.sum_rows_f32(g), n)


def quantized_entropy_sweep(slices: torch.Tensor, epss,
                            num_bins: int = 65536,
                            use_kernel: bool = False) -> torch.Tensor:
    """q-ent of a (k, ...) stack at an (e,) eb vector -> (k, e).

    ``use_kernel=False``: sort each slice once (``floor(x/eps)`` is
    monotone in x, so every eb shares the sort), then run lengths per
    eb: the exact counts, the reference's float32 entropy bit for bit.
    ``use_kernel=True``: the fused multi-eps histogram of
    ``kernels.qent``, codes saturated to int32 and hashed into
    ``num_bins`` bins -- equal to the exact route (to float32 rounding)
    whenever the code range fits the bins."""
    _validate_eps_positive(epss)
    k = slices.shape[0]
    flat = flush_subnormals(slices.to(torch.float32).reshape(k, -1))
    return _qent_sweep(flat, _eps_tensor(epss, flat), num_bins, use_kernel)


def _qent_sweep(flat: torch.Tensor, eps_t: torch.Tensor, num_bins: int,
                use_kernel: bool) -> torch.Tensor:
    """``quantized_entropy_sweep`` of a flushed (k, n) stack."""
    if use_kernel:
        return qent_ops.quantized_entropy_sweep(flat, eps_t, num_bins)
    # -0.0 and +0.0 give the same code, so their order does not matter
    xs = torch.sort(flat, dim=1).values
    return torch.stack([_sorted_entropy(xs, eps_t[i])
                        for i in range(eps_t.shape[0])], dim=1)


def _entropy_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """Entropy (bits/symbol) of a histogram, float32 as in the reference."""
    n = torch.clamp(counts.sum(), min=1).to(torch.float32)
    p = counts.to(torch.float32) / n
    return -torch.where(p > 0, p * torch.log2(torch.clamp(p, min=1e-30)),
                        torch.zeros_like(p)).sum()


def quantized_codes(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Linear quantization codes ``floor(d / eps)`` as int32, clamped to
    the int32 range before the cast (paper section 3.1.5).  Raises
    ``ValueError`` for a non-positive or non-finite eps."""
    _validate_eps_positive(eps)
    return _codes(flush_subnormals(x.to(torch.float32)), eps)


def _codes(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``quantized_codes`` of flushed data."""
    scaled = torch.floor(flush_subnormals(x / _scalar(eps, x)))
    return torch.clamp(scaled, INT32_CODE_MIN, INT32_CODE_MAX).to(torch.int32)


def quantized_entropy(x: torch.Tensor, eps: float, num_bins: int = 65536,
                      use_kernel: bool = False) -> torch.Tensor:
    """Shannon entropy (bits/symbol) of the linearly quantized data.

    ``use_kernel=False``: the codes shifted by their minimum and hashed
    (mod) into ``num_bins`` bins, the reference's jnp route;
    ``use_kernel=True``: the q-ent kernel's histogram of the codes mod
    ``num_bins``.  Both are exact while the code range fits the bins."""
    _validate_eps_positive(eps)
    return _quantized_entropy(flush_subnormals(x.to(torch.float32)), eps,
                              num_bins, use_kernel)


def _quantized_entropy(x: torch.Tensor, eps: float, num_bins: int,
                       use_kernel: bool) -> torch.Tensor:
    """``quantized_entropy`` of flushed data."""
    x = x.reshape(-1)
    if use_kernel:
        return _qent_sweep(x[None], _eps_tensor([eps], x), num_bins, True)[0, 0]
    codes = _codes(x, eps)
    shifted = torch.remainder(codes - codes.min(), num_bins)
    return _entropy_from_counts(torch.bincount(shifted.to(torch.int64),
                                               minlength=num_bins))


def entropy(x: torch.Tensor, num_bins: int = 65536) -> torch.Tensor:
    """Entropy of the raw float32 bit patterns, binned mod ``num_bins``
    (lossless-style entropy); a subnormal keeps its bits here."""
    bits = x.to(torch.float32).reshape(-1).contiguous().view(torch.int32)
    idx = torch.remainder(bits.to(torch.int64) & 0xFFFFFFFF, num_bins)
    return _entropy_from_counts(torch.bincount(idx, minlength=num_bins))


def _sigma(x: torch.Tensor) -> torch.Tensor:
    """(k, ...) stack -> (k,) population standard deviations, each row
    alone.  XLA's CPU reads a subnormal square or variance as zero, so
    the reference's sigma is 0 wherever the variance is below 2^-126
    (a row whose centred values all lie below 2^-63); elsewhere the
    squares it flushes move the variance by less than its rounding."""
    s = per_row(lambda r: torch.std(r, correction=0).reshape(1),
                x.contiguous())
    return torch.where(s < SQRT_MIN_NORMAL, 0.0, s)


def _looped_features(x: torch.Tensor, eps: float, cfg: "PredictorConfig",
                     trunc) -> torch.Tensor:
    _validate_eps_positive(eps)
    x = flush_subnormals(x.to(torch.float32))
    sigma = _sigma(x[None])[0]
    qe = _quantized_entropy(x, eps, cfg.qent_bins, cfg.use_kernels)
    return torch.stack([refmath.log_f32(torch.clamp(qe, min=1e-3)),
                        _log_ratio(trunc(x), sigma)])


def features_2d(x: torch.Tensor, eps: float,
                cfg: "PredictorConfig" = None) -> torch.Tensor:
    """The paper's predictor vector for one 2-D slice at error bound
    ``eps``: ``[log(q-ent), log(svd_trunc / sigma)]``."""
    cfg = cfg or PredictorConfig()
    return _looped_features(
        x, eps, cfg, lambda v: svd_trunc(v, cfg.variance_fraction_2d))


def features_3d(x: torch.Tensor, eps: float,
                cfg: "PredictorConfig" = None) -> torch.Tensor:
    """``features_2d`` for one volume, with ``hosvd_trunc``."""
    cfg = cfg or PredictorConfig()
    return _looped_features(
        x, eps, cfg, lambda v: hosvd_trunc(v, cfg.variance_fraction_3d))


def features_batch(slices: torch.Tensor, eps: float,
                   cfg: "PredictorConfig" = None) -> torch.Tensor:
    """``features_2d`` over a (k, m, n) stack, slice by slice -> (k, 2)."""
    return torch.stack([features_2d(s, eps, cfg) for s in slices])


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
                         vf: float, bins: int, use_kernels: bool = False,
                         mode: str = "features") -> torch.Tensor:
    """(k, m, n) | (k, d, m, n) x (e,) -> (k, e, w), ``w`` per
    ``SWEEP_MODE_WIDTHS[mode]``."""
    if mode not in SWEEP_MODE_WIDTHS:
        raise ValueError(f"unknown sweep mode {mode!r}; expected one of "
                         f"{sorted(SWEEP_MODE_WIDTHS)}")
    x = slices.to(torch.float32).contiguous()
    outs = []
    if mode in ("features", "both"):
        sigma = _sigma(x)
        sv = (svd_trunc_batch(x, vf) if x.ndim == 3
              else hosvd_trunc_batch(x, vf))
        log_ratio = _log_ratio(sv, sigma)
        qe = _qent_sweep(x.reshape(x.shape[0], -1), epss, bins, use_kernels)
        log_qe = refmath.log_f32(torch.clamp(qe, min=1e-3))  # (k, e)
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
    slices = flush_subnormals(slices.to(torch.float32))
    return _features_sweep_impl(
        slices, _eps_tensor(epss, slices),
        vf=variance_fraction_for(cfg, slices.ndim), bins=cfg.qent_bins,
        use_kernels=cfg.use_kernels, mode=mode)


def features_sweep(slices: torch.Tensor, epss,
                   cfg: PredictorConfig = PredictorConfig(), *,
                   sharded: bool | None = None, mesh=None,
                   gather: bool = True, quality: bool = False):
    """The full predictor tensor in one pass: (k, m, n) x (e,) -> (k, e, 2).

    Column [..., 0] is log(q-ent) (eb-dependent, fused multi-eps
    histogram); column [..., 1] is log(svd_trunc / sigma) (for volumes
    log(hosvd_trunc / sigma); eb-independent, broadcast).

    Distribution, as in the reference: with ``sharded=None`` a stack of
    more than one row is sharded over its slice axis whenever a mesh of
    extent above 1 is active (``dist.sharding.use_mesh``) or passed as
    ``mesh``; ``sharded=False`` forces one device and ``sharded=True``
    raises without a usable mesh.  ``gather=False`` returns the padded
    result left on its shards (``dist.sweep.ShardedRows``).  Sharded
    rows are the single-device rows bit for bit.

    ``quality=True`` makes the same pass also emit the (k, e, 2)
    [PSNR, NRMSE] tensor of the quantization proxy and returns the pair
    ``(features, quality)``."""
    out = _sweep_dispatch(slices, epss, cfg, sharded=sharded, mesh=mesh,
                          gather=gather,
                          mode="both" if quality else "features")
    if not quality:
        return out
    if isinstance(out, torch.Tensor):
        return out[..., :2], out[..., 2:]
    return out.cols(slice(0, 2)), out.cols(slice(2, None))


def quality_sweep(slices: torch.Tensor, epss,
                  cfg: PredictorConfig = PredictorConfig(), *,
                  sharded: bool | None = None, mesh=None,
                  gather: bool = True):
    """The quality half of the frontier: (k, ...) x (e,) -> (k, e, 2);
    sharding routes as in :func:`features_sweep`."""
    return _sweep_dispatch(slices, epss, cfg, sharded=sharded, mesh=mesh,
                           gather=gather, mode="quality")


def _sweep_dispatch(slices, epss, cfg, *, sharded, mesh, gather, mode):
    """Routing shared by the sweeps: sharded under a usable mesh, else
    one device.  A single row is never sharded automatically: it has no
    parallelism to split (the UC queries featurize one slice at a time)."""
    if sharded or (sharded is None and slices.ndim in (3, 4)
                   and slices.shape[0] > 1):
        from repro_torch.dist import sweep as DS
        use = DS.active_sweep_mesh(mesh)
        if sharded and use is None:
            raise ValueError(
                "features_sweep(sharded=True) needs a mesh of extent > 1 "
                "(pass mesh= or activate one with dist.sharding.use_mesh)")
        if use is not None:
            return DS.features_sweep_sharded(slices, epss, cfg, mesh=use,
                                             gather=gather, mode=mode)
    return _sweep(slices, epss, cfg, mode)


def _svd_sigma(x: torch.Tensor, vf: float):
    xf = x.to(torch.float32)
    sv = (svd_trunc_batch(xf[None], vf) if x.ndim == 2
          else hosvd_trunc_batch(xf[None], vf))[0]
    return sv, _sigma(xf[None])[0]


class SliceCache:
    """Featurization cache for ONE slice or volume (the UC1/UC2 cost
    structure): the eps-independent SVD-or-HOSVD/sigma part is computed
    at most once, q-ent is memoized per error bound, and ``prefetch``
    fills the memo for a whole eb grid with one fused sweep."""

    def __init__(self, x: torch.Tensor, cfg: PredictorConfig):
        self._x = flush_subnormals(x.to(torch.float32))
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
        _validate_eps_positive(epss)
        feats = _features_sweep_impl(
            self._x[None], _eps_tensor(epss, self._x),
            vf=variance_fraction_for(self._cfg, self._x.ndim + 1),
            bins=self._cfg.qent_bins, use_kernels=self._cfg.use_kernels)[0]
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
            qe = _qent_sweep(self._x.reshape(1, -1),
                             _eps_tensor([key], self._x),
                             self._cfg.qent_bins, self._cfg.use_kernels)[0, 0]
            self._memo[key] = torch.stack(
                [refmath.log_f32(torch.clamp(qe, min=1e-3)), self._ratio()])
        return self._memo[key]


class FeaturizationEngine:
    """Batched, sweep-native featurizer -- the single entry point the
    pipeline and use cases route through.

    * ``sweep(slices, epss)``  -- (k, m, n) x (e,) -> (k, e, 2), one pass.
    * ``features(slices, eps)`` -- (k, 2): the e=1 column of the sweep.
    * ``quality(slices, epss)`` -- (k, e, 2) PSNR/NRMSE.
    * ``stream(source, name, epss)`` -- the sweep of a dataset variable,
                                  chunk by chunk (``core.stream``).
    * ``cached(x)``            -- per-slice :class:`SliceCache`.

    Volumes are first-class: every entry point also accepts a (k, d, m, n)
    stack (``cached``: one (d, m, n) volume).  ``sweep``, ``quality``
    and ``features`` shard the slice axis under an active or passed mesh
    (``repro_torch.dist.sweep``), as :func:`features_sweep` does."""

    def __init__(self, cfg: PredictorConfig = PredictorConfig()):
        self.cfg = cfg

    def sweep(self, slices: torch.Tensor, epss, *,
              sharded: bool | None = None, mesh=None, gather: bool = True,
              quality: bool = False):
        return features_sweep(slices, epss, self.cfg, sharded=sharded,
                              mesh=mesh, gather=gather, quality=quality)

    def quality(self, slices: torch.Tensor, epss, *,
                sharded: bool | None = None, mesh=None, gather: bool = True):
        return quality_sweep(slices, epss, self.cfg, sharded=sharded,
                             mesh=mesh, gather=gather)

    def features(self, slices: torch.Tensor, eps: float, *,
                 sharded: bool | None = None, mesh=None) -> torch.Tensor:
        return self.sweep(slices, [eps], sharded=sharded, mesh=mesh)[:, 0, :]

    def stream(self, source, name: str, epss, *, stream=None, mesh=None,
               digest=None, quality: bool = False, device="cuda"):
        """Out-of-core sweep of one ``data.source.DatasetSource``
        variable: chunked, staged ahead, bit-equal to
        ``sweep(source.read(name), epss)`` on ``device`` with at most a
        few budgeted chunks resident (``core.stream.stream_features``;
        collective under a process-spanning ``mesh``).
        ``quality=True`` returns the streamed ``(features, quality)``
        pair from the same chunk launches."""
        from repro_torch.core import stream as ST
        return ST.stream_features(source, name, epss, self.cfg,
                                  stream=stream, mesh=mesh, digest=digest,
                                  quality=quality, device=device)

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


def features_2d_cached(x: torch.Tensor) -> SliceCache:
    """Per-slice cache from the default engine: a callable giving the
    feature vector at any error bound, the eps-independent part once."""
    return _DEFAULT_ENGINE.cached(x)

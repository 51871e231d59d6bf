"""SZ-family error-bounded lossy compressors (prediction-based decorrelation).

Three compressor-prediction schemes (paper section 4.2):
  * Lorenzo (SZ1/SZ3-lorenzo)      -- immediate-neighbour stencil predictor
  * Regression (SZ2/SZ3-regression)-- per 6x6(x6) block hyperplane fit
  * Interpolation (SZ3-interp)     -- multilevel cubic interpolation
plus SZ2's *dynamic* per-block selection between Lorenzo and regression.

Classic SZ predicts from *reconstructed* neighbours, a sequential data
dependence.  As in the reference, Lorenzo uses the cuSZ
dual-quantization form -- pre-quantize every value, then difference the
integer codes -- which keeps the absolute error bound exactly and is
fully parallel.  The bounded quantizer and the plain Lorenzo codes live
in ``kernels.lorenzo.ref``; a 2-D slice's codes go through
``kernels.lorenzo`` (the CUDA kernel for a tensor on the card).

Every float32 step is the reference's own operation in its order; the
error-bound scalars (``2 eps``, ``eps / BLOCK``) are float64 values
rounded once to float32, as the reference's Python scalars are.  The
regression fit takes the reference's float32 pseudo-inverse
(``_sz_design``) and forms ``y @ pinv.T`` in the order of XLA's CPU
dot, so the codes and CRs of sz2 and sz3-regression are the
reference's bit for bit.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.compressors import _sz_design, base, lossless
from repro_torch.kernels.lorenzo import ops as lorenzo_ops
from repro_torch.kernels.lorenzo.ref import (  # noqa: F401  (also sz's API)
    lorenzo_encode, quantize_bounded)
from repro_torch.kernels.quality.ref import fma32
from repro_torch.quant import pad_to_multiple

BLOCK = 6  # SZ2 block size


# ---------------------------------------------------------------------------
# Dual-quantization Lorenzo (N-D)
# ---------------------------------------------------------------------------

def _dequantize(codes: torch.Tensor, eps: float) -> torch.Tensor:
    return codes.to(torch.float32) * base.scalar(2.0 * eps, codes)


def lorenzo_decode(codes: torch.Tensor, eps: float) -> torch.Tensor:
    q = codes
    for axis in range(codes.ndim):
        q = torch.cumsum(q, dim=axis, dtype=torch.int32)
    return _dequantize(q, eps)


# ---------------------------------------------------------------------------
# Blockwise helpers
# ---------------------------------------------------------------------------

def _to_blocks(x: torch.Tensor, b: int) -> torch.Tensor:
    """2-D (M,N) -> (nb, b, b); 3-D (M,N,K) -> (nb, b, b, b)."""
    if x.ndim == 2:
        m, n = x.shape
        return x.reshape(m // b, b, n // b, b).permute(0, 2, 1, 3).reshape(-1, b, b)
    m, n, k = x.shape
    x = x.reshape(m // b, b, n // b, b, k // b, b).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, b, b, b)


def _from_blocks(blocks: torch.Tensor, padded_shape: Tuple[int, ...],
                 b: int) -> torch.Tensor:
    if len(padded_shape) == 2:
        m, n = padded_shape
        x = blocks.reshape(m // b, n // b, b, b).permute(0, 2, 1, 3)
        return x.reshape(m, n)
    m, n, k = padded_shape
    x = blocks.reshape(m // b, n // b, k // b, b, b, b).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(m, n, k)


def _block_coords(b: int, ndim: int, device=None) -> torch.Tensor:
    """Design matrix [1, i, j(, k)] for hyperplane regression: (b^ndim, ndim+1)."""
    axes = [torch.arange(b, dtype=torch.float32, device=device)] * ndim
    grids = torch.meshgrid(*axes, indexing="ij")
    cols = [torch.ones((b,) * ndim, dtype=torch.float32, device=device), *grids]
    return torch.stack([c.reshape(-1) for c in cols], dim=1)


@functools.lru_cache(maxsize=None)
def _design_pinv(b: int, ndim: int, device: torch.device) -> torch.Tensor:
    """The reference's float32 pseudo-inverse of the fixed design matrix,
    (ndim + 1, b^ndim), from the committed bits of ``_sz_design``."""
    return torch.from_numpy(_sz_design.TABLES[(b, ndim)].copy()).to(device)


# XLA's CPU dot takes a plain FMA chain below these block counts (per
# block rank) and four interleaved accumulators from them on; both
# orders, and the thresholds, were found by search against ``jnp``.
DOT_CHAIN_MAX_BLOCKS = {2: 3, 3: 1}
DOT_ACCUMULATORS = 4


def _fit_planes(blocks: torch.Tensor) -> torch.Tensor:
    """Least-squares hyperplane per block, (nb, b..b) -> (nb, ndim+1):
    ``y @ pinv.T`` in XLA's CPU order, each term one exact float32 FMA.
    Up to ``DOT_CHAIN_MAX_BLOCKS`` blocks, ``acc = fma(y_t, pinv_t, acc)``
    over the terms t in order; above, term t goes to accumulator t % 4
    and the result is ``(a0 + a1) + (a2 + a3)``."""
    nb, ndim = blocks.shape[0], blocks.ndim - 1
    pinv_t = _design_pinv(blocks.shape[1], ndim, blocks.device).T  # (p, c)
    y = blocks.reshape(nb, -1)                               # (nb, p)
    p, c = pinv_t.shape
    lanes = 1 if nb <= DOT_CHAIN_MAX_BLOCKS.get(ndim, 0) else DOT_ACCUMULATORS
    acc = torch.zeros((nb, lanes, c), dtype=torch.float32, device=y.device)
    for t in range(0, p, lanes):
        r = min(lanes, p - t)
        acc[:, :r] = fma32(y[:, t:t + r, None].expand(-1, -1, c),
                           pinv_t[None, t:t + r], acc[:, :r])
    if lanes == 1:
        return acc[:, 0]
    return (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])


def _plane_values(coefs: torch.Tensor, b: int, ndim: int) -> torch.Tensor:
    """``coefs @ coords.T`` as the reference's small dot computes it:
    ``acc = c0 * 1``, then ``acc = fma(c_r, coord_r, acc)`` per term."""
    x = _block_coords(b, ndim, coefs.device)                # (p, ndim+1)
    acc = coefs[:, :1].expand(-1, x.shape[0])
    for r in range(1, ndim + 1):
        acc = fma32(coefs[:, r:r + 1].expand_as(acc), x[None, :, r], acc)
    return acc.reshape(coefs.shape[0], *([b] * ndim))


def _quantized_planes(blocks: torch.Tensor, eps: float):
    """Fit, quantize (bin eps / BLOCK) and evaluate the block planes:
    returns (coefficient codes, plane values)."""
    step = base.scalar(eps / BLOCK, blocks)
    cq = torch.round(_fit_planes(blocks) / step).to(torch.int32)
    planes = _plane_values(cq.to(torch.float32) * step, BLOCK, blocks.ndim - 1)
    return cq, planes


# ---------------------------------------------------------------------------
# Per-block Lorenzo (parallel across blocks; used by SZ2's dynamic mode)
# ---------------------------------------------------------------------------

def _block_lorenzo_codes(qblocks: torch.Tensor) -> torch.Tensor:
    """Integer Lorenzo difference within each block (halo-free blocks)."""
    q = qblocks
    for axis in range(1, q.ndim):
        q = torch.diff(q, dim=axis, prepend=torch.zeros_like(
            q.narrow(axis, 0, 1)))
    return q


def _block_lorenzo_decode(codes: torch.Tensor) -> torch.Tensor:
    q = codes
    for axis in range(1, q.ndim):
        q = torch.cumsum(q, dim=axis, dtype=torch.int32)
    return q


def _crop(full: torch.Tensor, shape) -> torch.Tensor:
    return full[tuple(slice(0, s) for s in shape)]


def _expand_flags(flags: torch.Tensor, ndim: int) -> torch.Tensor:
    return flags[(...,) + (None,) * ndim]


# ---------------------------------------------------------------------------
# Compressors
# ---------------------------------------------------------------------------

class SZLorenzo(base.Compressor):
    """SZ3 with the exclusive Lorenzo scheme (dual-quantization form)."""
    name = "sz3-lorenzo"

    def _encode(self, data, eps):
        codes = (lorenzo_ops.lorenzo2d(data, eps) if data.ndim == 2
                 else lorenzo_encode(data, eps))
        return codes, {"shape": tuple(data.shape)}

    def decode(self, codes, aux, eps):
        return lorenzo_decode(codes, eps)

    def size_bytes(self, codes, aux, eps):
        return lossless.coded_size_bytes(codes)


class SZRegression(base.Compressor):
    """SZ3 with the exclusive regression scheme (per-block hyperplane)."""
    name = "sz3-regression"

    def _encode(self, data, eps):
        padded, shape = pad_to_multiple(data, BLOCK)
        blocks = _to_blocks(padded, BLOCK)
        # SZ2 quantizes regression coefficients; they are stored with a
        # fine bin (eps/BLOCK keeps the plane-evaluation error within eps/2)
        cq, planes = _quantized_planes(blocks, eps)
        codes = quantize_bounded(blocks - planes, eps)
        return codes, {"shape": shape, "padded": tuple(padded.shape),
                       "coef_codes": cq}

    def decode(self, codes, aux, eps):
        cq = aux["coef_codes"]
        step = base.scalar(eps / BLOCK, codes)
        planes = _plane_values(cq.to(torch.float32) * step, BLOCK,
                               len(aux["shape"]))
        blocks = planes + _dequantize(codes, eps)
        return _crop(_from_blocks(blocks, aux["padded"], BLOCK), aux["shape"])

    def size_bytes(self, codes, aux, eps):
        return (lossless.coded_size_bytes(codes)
                + lossless.coded_size_bytes(aux["coef_codes"]))


class SZInterp(base.Compressor):
    """SZ3 with the multilevel cubic-interpolation scheme (2-D)."""
    name = "sz3-interp"
    supports_3d = False
    levels = 3

    @staticmethod
    def _interp_odd(even: torch.Tensor, n_odd: int, axis: int) -> torch.Tensor:
        """Predict values at odd indices from the even-index samples along
        ``axis`` with a 4-point cubic (clamped neighbours at the edges)."""
        e = torch.movedim(even, axis, 0)
        em1 = torch.cat([e[:1], e[:-1]], dim=0)
        ep1 = torch.cat([e[1:], e[-1:]], dim=0)
        ep2 = torch.cat([e[2:], e[-1:], e[-1:]], dim=0)
        cubic = (-em1 + 9.0 * e + 9.0 * ep1 - ep2) / 16.0
        return torch.movedim(cubic[:n_odd], 0, axis)

    def _encode_rec(self, data, eps, levels_left: int):
        """Recursive multilevel encode; predictions are made from
        *reconstructed* values so the bound holds exactly at every level.

        Returns (codes_tree, recon).
        """
        m, n = data.shape
        if levels_left == 0 or min(m, n) < 8:
            root = quantize_bounded(data, eps)
            return ("root", root), _dequantize(root, eps)
        half = data[:, 0::2]                 # even columns (original)
        coarse = half[0::2, :]               # even rows of even cols
        sub_codes, recon_coarse = self._encode_rec(coarse, eps, levels_left - 1)
        # rows: predict odd rows of `half` from the reconstructed coarse grid
        pred_r = self._interp_odd(recon_coarse, half[1::2, :].shape[0], axis=0)
        codes_r = quantize_bounded(half[1::2, :] - pred_r, eps)
        recon_half = torch.zeros_like(half)
        recon_half[0::2, :] = recon_coarse
        recon_half[1::2, :] = pred_r + _dequantize(codes_r, eps)
        # cols: predict odd columns of `data` from the reconstructed half
        pred_c = self._interp_odd(recon_half, data[:, 1::2].shape[1], axis=1)
        codes_c = quantize_bounded(data[:, 1::2] - pred_c, eps)
        recon = torch.zeros_like(data)
        recon[:, 0::2] = recon_half
        recon[:, 1::2] = pred_c + _dequantize(codes_c, eps)
        return ("level", sub_codes, codes_c, codes_r, (m, n)), recon

    def _encode(self, data, eps):
        codes, _ = self._encode_rec(data, eps, self.levels)
        return codes, {"shape": tuple(data.shape)}

    def _decode_rec(self, codes, eps):
        if codes[0] == "root":
            return _dequantize(codes[1], eps)
        _, sub_codes, codes_c, codes_r, (m, n) = codes
        recon_coarse = self._decode_rec(sub_codes, eps)
        half = torch.zeros((m, (n + 1) // 2), dtype=torch.float32,
                           device=recon_coarse.device)
        half[0::2, :] = recon_coarse
        pred_r = self._interp_odd(recon_coarse, codes_r.shape[0], axis=0)
        half[1::2, :] = pred_r + _dequantize(codes_r, eps)
        out = torch.zeros((m, n), dtype=torch.float32, device=half.device)
        out[:, 0::2] = half
        pred_c = self._interp_odd(half, codes_c.shape[1], axis=1)
        out[:, 1::2] = pred_c + _dequantize(codes_c, eps)
        return out

    def decode(self, codes, aux, eps):
        return self._decode_rec(codes, eps)

    def size_bytes(self, codes, aux, eps):
        if codes[0] == "root":
            return lossless.coded_size_bytes(codes[1])
        _, sub_codes, codes_c, codes_r, _ = codes
        return (self.size_bytes(sub_codes, aux, eps)
                + lossless.coded_size_bytes(codes_c)
                + lossless.coded_size_bytes(codes_r))


class SZ2(base.Compressor):
    """SZ2: dynamic per-block selection between Lorenzo and regression.

    Mirrors SZ2's sampling-based scheme choice: per block, both predictors
    are evaluated and the one with the smaller absolute residual mass (a
    monotone proxy for the coded entropy) wins.  One flag bit per block.
    """
    name = "sz2"

    def _encode(self, data, eps):
        padded, shape = pad_to_multiple(data, BLOCK)
        blocks = _to_blocks(padded, BLOCK)
        ndim = data.ndim
        lor_codes = _block_lorenzo_codes(quantize_bounded(blocks, eps))
        cq, planes = _quantized_planes(blocks, eps)
        reg_codes = quantize_bounded(blocks - planes, eps)
        # choice: smaller |codes| mass (entropy proxy); regression also pays
        # for its coefficients (~ (ndim+1)*2 bytes -> ~ 8 code units)
        axes = tuple(range(1, ndim + 1))
        lor_cost = torch.clamp(lor_codes.abs(), max=255).sum(dim=axes)
        reg_cost = (torch.clamp(reg_codes.abs(), max=255).sum(dim=axes)
                    + 4 * (ndim + 1))
        use_reg = reg_cost < lor_cost
        sel = torch.where(_expand_flags(use_reg, ndim), reg_codes, lor_codes)
        return sel, {"shape": shape, "padded": tuple(padded.shape),
                     "use_reg": use_reg, "coef_codes": cq}

    def decode(self, codes, aux, eps):
        ndim = len(aux["shape"])
        step = base.scalar(eps / BLOCK, codes)
        planes = _plane_values(aux["coef_codes"].to(torch.float32) * step,
                               BLOCK, ndim)
        reg_blocks = planes + _dequantize(codes, eps)
        lor_blocks = _dequantize(_block_lorenzo_decode(codes), eps)
        blocks = torch.where(_expand_flags(aux["use_reg"], ndim),
                             reg_blocks, lor_blocks)
        return _crop(_from_blocks(blocks, aux["padded"], BLOCK), aux["shape"])

    def size_bytes(self, codes, aux, eps):
        total = lossless.coded_size_bytes(codes)
        use_reg = aux["use_reg"]
        total += -(-use_reg.numel() // 8)          # 1 flag bit / block
        cq = lossless.host(aux["coef_codes"])[lossless.host(use_reg)]
        if cq.size:                                 # coded only when chosen
            total += lossless.coded_size_bytes(cq)
        return total

    def regression_fraction(self, data, eps) -> float:
        """Fraction of blocks choosing regression (paper section 4.2 stat)."""
        _, aux = self.encode(data, eps)
        return float(aux["use_reg"].to(torch.float32).mean())


base.register(SZLorenzo())
base.register(SZRegression())
base.register(SZInterp())
base.register(SZ2())

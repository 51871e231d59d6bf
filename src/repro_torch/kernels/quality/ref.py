"""Plain PyTorch version of the quality sweep, bit-equal to the reference.

The reference's float32 bits come from XLA's multiply-add contraction on
the CPU, so this module spells out every fused operation with
:func:`fma32`, an exactly rounded float32 ``a * b + c``:

- error: ``fma(-code, eps, x)``;
- a column of 8 sublanes:
  ``(fma(e0, e0, e1*e1) + fma(e2, e2, e3*e3)) + (fma(e4, e4, e5*e5) +
  fma(e6, e6, e7*e7))``, then the 256 columns of a 2048-element tile
  halve pairwise (``v[0::2] + v[1::2]``) and tiles add in order from 0;
- ``det_log10``: Horner steps ``fma(p, s, q)``, then
  ``fma(2/ln2, t*p, e)``, then a plain multiply by log10(2);
- ``quality_from_stats``: ``sse * f32(1/n)``, no contraction in
  ``20a - 10b``, and a correctly rounded square root (taken in float64).

Subnormals follow XLA's CPU rule (``quant.flush_subnormals``).  The
data holds none: the entry points flush it.  The quotient ``x / eps``,
each error, square and multiply-add of the tree, the mean square and
range fed to ``det_log10`` and the NRMSE quotient are flushed to a
signed zero where they are subnormal, as the kernel flushes them
(``csrc/flush.cuh``).
"""
from __future__ import annotations

import torch

from repro_torch.quant import INT32_CODE_MAX, INT32_CODE_MIN
from repro_torch.quant import flush_subnormals as _ftz

# The tile is part of the numerical spec: the reduction tree and the
# accumulation boundaries follow it (8 sublanes x 256 lanes).
DEFAULT_TILE = 2048
PSNR_CAP = 300.0
NRMSE_CAP = 1e30

_INV_LN2 = 1.4426950408889634
_LOG10_2 = 0.30102999566398120
_LOW29 = (1 << 29) - 1          # float64 mantissa bits below float32's
_HALF29 = 1 << 28


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """Exactly rounded float32 ``a * b + c`` (what ``fmaf`` returns).

    The product of two float32 values is exact in float64; TwoSum gives
    the exact error of the float64 sum.  Rounding that sum to float32
    once more is correct unless it sits exactly halfway between two
    float32 values, where the error's sign decides; the sum is then
    nudged one float64 ulp toward the exact value.  Valid for results
    in the normal float32 range."""
    a = torch.as_tensor(a, dtype=torch.float32)
    a64 = a.to(torch.float64)
    b64 = torch.as_tensor(b, dtype=torch.float32, device=a.device).to(torch.float64)
    c64 = torch.as_tensor(c, dtype=torch.float32, device=a.device).to(torch.float64)
    p = a64 * b64
    r = p + c64
    tie = (r.view(torch.int64) & _LOW29) == _HALF29
    if r.device.type == "cpu":
        # ties are rare: on the host, nudge only them
        if bool(tie.any()):
            p, c64 = p.expand_as(r), c64.expand_as(r)
            r[tie] = _nudge(p[tie], c64[tie], r[tie])
        return r.to(torch.float32)
    return torch.where(tie, _nudge(p, c64, r), r).to(torch.float32)


def _nudge(p: torch.Tensor, c: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``r = p + c`` (float64) moved one ulp toward the exact sum where
    the TwoSum error is not zero."""
    bv = r - p
    err = (p - (r - bv)) + (c - bv)
    toward = torch.where(err > 0, torch.full_like(r, float("inf")),
                         torch.full_like(r, float("-inf")))
    return torch.where(err != 0, torch.nextafter(r, toward), r)


def qdq_err(x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize error ``x - code * eps`` (one rounding), with
    the saturating int32 quantizer of the q-ent predictor.  ``eps`` is a
    tensor that broadcasts against ``x``; ``x`` holds no subnormal."""
    codes = torch.clamp(torch.floor(_ftz(x / eps)), INT32_CODE_MIN,
                        INT32_CODE_MAX).to(torch.int32).to(torch.float32)
    return _ftz(fma32(-codes, eps, x))


def tile_sse(err: torch.Tensor) -> torch.Tensor:
    """(..., c, 8) errors of a tile (column-major: 8 sublanes per column,
    c a power of two) -> (...) SSE by the fixed balanced tree."""
    sq = _ftz(err * err)
    p01, p23, p45, p67 = (_ftz(fma32(err[..., i], err[..., i], sq[..., i + 1]))
                          for i in (0, 2, 4, 6))
    v = (p01 + p23) + (p45 + p67)      # sums of non-negative normals
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def sse_sweep(flat: torch.Tensor, epss: torch.Tensor,
              tile: int = DEFAULT_TILE) -> torch.Tensor:
    """(k, n) float32 x (e,) float32 -> (k, e) float32 SSE.

    Zero-pads each slice to a tile multiple (the QDQ error of 0.0 is
    exactly +0, a no-op in the sums), sums each tile by the tree, then
    adds the tiles in order starting from 0.0."""
    k, n = flat.shape
    pad = (-n) % tile
    if pad:
        flat = torch.cat([flat, flat.new_zeros((k, pad))], dim=1)
    tiles = flat.shape[1] // tile
    xt = flat.reshape(k, tiles, tile // 8, 8)
    per_tile = torch.stack([tile_sse(qdq_err(xt, eps)) for eps in epss],
                           dim=1)                      # (k, e, tiles)
    acc = torch.zeros(per_tile.shape[:2], dtype=torch.float32,
                      device=flat.device)
    for t in range(tiles):
        acc = acc + per_tile[:, :, t]
    return acc


def det_log10(x: torch.Tensor) -> torch.Tensor:
    """Deterministic elementwise log10 of float32 inputs, the reference's
    bitcast + atanh-series construction with its contraction pattern;
    x <= 0 (a subnormal reads as zero) maps to -1e4."""
    x = _ftz(x.to(torch.float32))
    small = x < 2.0 ** -100
    xs = torch.where(small, x * 2.0 ** 64, x)
    bits = xs.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | (127 << 23)).view(torch.float32)
    t = (m - 1.0) / (m + 1.0)
    s = t * t
    p = torch.full_like(t, 1.0 / 13.0)
    for q in (1.0 / 11.0, 1.0 / 9.0, 1.0 / 7.0, 1.0 / 5.0, 1.0 / 3.0, 1.0):
        p = fma32(p, s, torch.full_like(t, q))
    log2x = fma32(torch.full_like(t, 2.0 * _INV_LN2), t * p,
                  e.to(torch.float32))
    log2x = log2x - torch.where(small, torch.full_like(t, 64.0),
                                torch.zeros_like(t))
    return torch.where(x > 0.0, torch.full_like(t, _LOG10_2) * log2x,
                       torch.full_like(t, -1e4))


def quality_from_stats(sse: torch.Tensor, n: int, vmin: torch.Tensor,
                       vmax: torch.Tensor) -> torch.Tensor:
    """(k, e) SSE + per-slice stats -> (k, e, 2) [PSNR dB, NRMSE].

    ``n`` is the unpadded element count; ``abs`` on the range kills the
    -0.0 hazard of mixed-sign-zero slices."""
    f32 = dict(dtype=torch.float32, device=sse.device)
    rng = _ftz(vmax - vmin).abs()[:, None]
    inv_n = torch.tensor(1.0, **f32) / torch.tensor(float(n), **f32)
    mse = _ftz(sse * inv_n)
    exact = sse == 0.0
    cap = torch.tensor(PSNR_CAP, **f32)
    psnr = torch.where(
        exact, cap,
        torch.clamp(20.0 * det_log10(rng) - 10.0 * det_log10(mse),
                    -PSNR_CAP, PSNR_CAP))
    root = torch.sqrt(mse.to(torch.float64)).to(torch.float32)
    nrmse = torch.where(
        exact, torch.zeros_like(mse),
        torch.minimum(torch.clamp(_ftz(root / rng), min=0.0),
                      torch.tensor(NRMSE_CAP, **f32)))
    return torch.stack([psnr, nrmse], dim=-1)

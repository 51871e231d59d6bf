"""ZFP-like transform compressor (fixed 4^n blocks, near-orthogonal lifting).

Pipeline per 4x4(x4) block (Lindstrom 2014):
  1. block-floating-point: align all values to the block's max exponent,
  2. integer forward lifting transform along each dimension,
  3. embedded bit-plane coding down to an eps-determined cutoff plane.

The integer lifting pair is the exact fwd/inv lift of the zfp codebase
(arithmetic shifts on int32).  The size follows analytically from the
bit-plane cutoff: zfp's output is already entropy-packed, so there is no
lossless stage.  The block exponent, the scale and the size model's bit
length use the reference's float32 ``log2``/``exp2`` bits
(``repro_torch.refmath``).  A 2-D slice's forward transform goes
through ``kernels.zfp_block`` (the CUDA kernel for a tensor on the
card); volumes stay plain PyTorch.
"""
from __future__ import annotations

import math
import torch

from repro_torch import refmath
from repro_torch.compressors import base
from repro_torch.kernels.zfp_block import ops as zfp_ops
from repro_torch.kernels.zfp_block.ref import (  # noqa: F401  (also zfp's API)
    EXP_FLOOR, INTPREC, block_exponent, from_blocks4, fwd_lift4, to_blocks4,
    zfp_transform)


def _guard_bits(ndim: int) -> int:
    """Transform-gain guard: the inverse lifting amplifies per-coefficient
    truncation error by < 2^(1+ndim) in the worst case."""
    return 1 + ndim


# ---------------------------------------------------------------------------
# Exact zfp integer lifting (the forward lift is in kernels.zfp_block.ref)
# ---------------------------------------------------------------------------

def inv_lift4(v: torch.Tensor, axis: int) -> torch.Tensor:
    x, y, z, w = torch.movedim(v, axis, 0).unbind(0)
    y = y + (w >> 1); w = w - (y >> 1)
    y = y + w; w = w << 1; w = w - y
    z = z + x; x = x << 1; x = x - z
    y = y + z; z = z << 1; z = z - y
    w = w + x; x = x << 1; x = x - w
    return torch.movedim(torch.stack([x, y, z, w]), 0, axis)


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------

def zfp_untransform(q: torch.Tensor, e: torch.Tensor, padded_shape,
                    shape) -> torch.Tensor:
    ndim = q.ndim - 1
    for axis in range(ndim, 0, -1):
        q = inv_lift4(q, axis)
    scale = refmath.exp2_f32(e - (INTPREC - 2))
    blocks = q.to(torch.float32) * scale[(...,) + (None,) * ndim]
    full = from_blocks4(blocks, padded_shape)
    return full[tuple(slice(0, s) for s in shape)]


def floor_log2_eps(eps: float) -> int:
    """``floor(log2(eps))`` of the float32 eps, a host scalar."""
    v = refmath.log2_f32(torch.tensor([eps], dtype=torch.float32))
    return int(math.floor(float(v[0])))


def _cutoff_plane(e: torch.Tensor, eps: float, ndim: int) -> torch.Tensor:
    """Integer bit-plane below which coefficients are dropped.

    The LSB of the fixed-point representation is worth 2^(e - (INTPREC-2));
    dropping planes < k introduces error <= 2^k * lsb * transform gain.
    """
    lsb_log2 = e - (INTPREC - 2)
    return floor_log2_eps(eps) - lsb_log2 - _guard_bits(ndim)  # may be < 0


def zfp_truncate(q: torch.Tensor, e: torch.Tensor, eps: float) -> torch.Tensor:
    """Round every coefficient to a multiple of 2^k, k its block's cutoff
    plane.  A cutoff of 32 or more shifts ``1`` out of the int32 (as
    the reference's ``<<`` does), so such a block is kept whole."""
    ndim = q.ndim - 1
    k = torch.clamp(_cutoff_plane(e, eps, ndim), min=0)[(...,) + (None,) * ndim]
    step = torch.ones_like(k) << k
    half = step >> 1
    return torch.where(step > 1,
                       torch.sign(q) * (((torch.abs(q) + half) >> k) << k), q)


def zfp_size_bits(q: torch.Tensor, e: torch.Tensor, eps: float) -> int:
    """Embedded-coding size model: per coefficient, bits above the cutoff
    plane + sign, plus a per-block header (exponent + group tests).

    The per-block counts and the header are small integers, exact in
    float32; their total is the reference's float32 ``jnp.sum``
    (:func:`refmath.sum_f32`, on the host), which rounds above 2^24 bits."""
    ndim = q.ndim - 1
    k = torch.clamp(_cutoff_plane(e, eps, ndim), min=0)[(...,) + (None,) * ndim]
    mag = torch.abs(q)
    bitlen = torch.where(mag > 0,
                         torch.ceil(refmath.log2_f32(mag.to(torch.float32) + 1.0)),
                         torch.zeros_like(mag, dtype=torch.float32))
    kept = torch.clamp(bitlen - k.to(torch.float32), min=0.0)
    per_block = (kept + (kept > 0).to(torch.float32)).sum(
        dim=tuple(range(1, ndim + 1)))
    header = 8.0 + 2.0 * (4 ** ndim) / 4.0    # exponent + group-test bits
    return int(refmath.sum_f32(per_block + header))


class ZFP(base.Compressor):
    name = "zfp"

    def _encode(self, data, eps):
        if data.ndim == 2:
            coef, exps = zfp_ops.zfp_forward2d(data)
            padded = tuple(coef.shape)
            q, e = to_blocks4(coef), exps.reshape(-1)
        else:
            q, e, padded = zfp_transform(data)
        qt = zfp_truncate(q, e, eps)
        return qt, {"e": e, "padded": padded, "shape": tuple(data.shape)}

    def decode(self, codes, aux, eps):
        return zfp_untransform(codes, aux["e"], aux["padded"], aux["shape"])

    def size_bytes(self, codes, aux, eps):
        return -(-zfp_size_bits(codes, aux["e"], eps) // 8)


base.register(ZFP())

"""Plain PyTorch version of the zfp_block kernel: the forward zfp
transform (block exponent, block-floating-point scale, exact integer
lifting) that ``compressors.zfp`` builds on, and that transform laid
out as the kernel's (m, n) coefficients plus (m/4, n/4) exponents."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import refmath
from repro_torch.quant import pad_to_multiple, to_int32

INTPREC = 26          # fixed-point precision for fp32 inputs
EXP_FLOOR = 1e-38     # the reference's guard inside log2(max(amax, .))


# ---------------------------------------------------------------------------
# Exact zfp integer lifting (4-vectors)
# ---------------------------------------------------------------------------

def fwd_lift4(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Forward lift along ``axis`` (length 4), int32 arithmetic shifts."""
    x, y, z, w = torch.movedim(v, axis, 0).unbind(0)
    x = x + w; x = x >> 1; w = w - x
    z = z + y; z = z >> 1; y = y - z
    x = x + z; x = x >> 1; z = z - x
    w = w + y; w = w >> 1; y = y - w
    w = w + (y >> 1); y = y - (w >> 1)
    return torch.movedim(torch.stack([x, y, z, w]), 0, axis)


# ---------------------------------------------------------------------------
# Blocking
# ---------------------------------------------------------------------------

def to_blocks4(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 2:
        m, n = x.shape
        return x.reshape(m // 4, 4, n // 4, 4).permute(0, 2, 1, 3).reshape(-1, 4, 4)
    m, n, k = x.shape
    return (x.reshape(m // 4, 4, n // 4, 4, k // 4, 4)
             .permute(0, 2, 4, 1, 3, 5).reshape(-1, 4, 4, 4))


def from_blocks4(blocks: torch.Tensor, padded_shape) -> torch.Tensor:
    if len(padded_shape) == 2:
        m, n = padded_shape
        return (blocks.reshape(m // 4, n // 4, 4, 4)
                .permute(0, 2, 1, 3).reshape(m, n))
    m, n, k = padded_shape
    return (blocks.reshape(m // 4, n // 4, k // 4, 4, 4, 4)
            .permute(0, 3, 1, 4, 2, 5).reshape(m, n, k))


# ---------------------------------------------------------------------------
# Forward transform
# ---------------------------------------------------------------------------

def block_exponent(amax: torch.Tensor) -> torch.Tensor:
    """Per-block exponent e with 2^e >= amax (0 for an all-zero block):
    ``ceil(log2(max(amax, 1e-38)))`` with the reference's ``log2``."""
    e = refmath.ceil_log2(torch.clamp(amax, min=EXP_FLOOR))
    return torch.where(amax > 0, e, torch.zeros_like(e))


def zfp_transform(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Tuple]:
    """Blocked block-floating-point + forward lifting, in plain PyTorch.

    Returns (coeff int32 blocks, per-block exponent, padded_shape).
    ``data`` holds no subnormal: ``Compressor.encode`` flushes it.
    """
    padded, _ = pad_to_multiple(data.to(torch.float32), 4)
    blocks = to_blocks4(padded.to(torch.float32))
    ndim = blocks.ndim - 1
    amax = torch.amax(torch.abs(blocks), dim=tuple(range(1, ndim + 1)))
    e = block_exponent(amax)
    scale = refmath.exp2_f32(INTPREC - 2 - e)
    # a block of tiny normals overflows its scale to inf: the conversion
    # saturates (NaN -> 0) as in the reference and on the card
    q = to_int32(torch.round(blocks * scale[(...,) + (None,) * ndim]))
    for axis in range(1, ndim + 1):
        q = fwd_lift4(q, axis)
    return q, e, tuple(padded.shape)


def zfp_forward2d(x: torch.Tensor):
    """(m, n) float32, m and n multiples of 4 -> (coefficients (m, n)
    int32, exponents (m/4, n/4) int32)."""
    q_blocks, e, padded_shape = zfp_transform(x.to(torch.float32))
    m, n = padded_shape
    return from_blocks4(q_blocks, padded_shape), e.reshape(m // 4, n // 4)

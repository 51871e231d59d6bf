"""Shared quantization plumbing: code-range saturation, eps validation,
the float32 error-bound scalars, edge padding to whole blocks, the
reference's reading of subnormals and per-row reductions.

The constants and helpers every quantizing route (the q-ent histogram,
the quality SSE, the compressors, the kernels' plain versions) must
agree on exactly.  Leaf module.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# floor(x/eps) is clamped to this f32-representable sub-range of int32
# before any cast: the largest float32 not exceeding 2^31 - 1 is
# 2147483520.0, so casting the clamped value can never wrap.
INT32_CODE_MIN = -2147483648.0
INT32_CODE_MAX = 2147483520.0

MIN_NORMAL = 2.0 ** -126     # the smallest normal float32
SQRT_MIN_NORMAL = 2.0 ** -63  # below it a square or product is subnormal


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every float32 subnormal replaced by a zero of its sign.

    XLA on the CPU computes with denormals-are-zero and flush-to-zero:
    every float32 operation of the reference reads a subnormal operand
    as a signed zero and writes a subnormal result as one.  The port's
    entry points apply this once to the data they take, so the kernels
    and their plain versions are never handed a subnormal; both flush
    each intermediate where the reference can make one (the kernels with
    ``csrc/flush.cuh``).  One elementwise pass; infinities and NaNs pass
    through."""
    return torch.where(x.abs() < MIN_NORMAL, x * 0.0, x)


def per_row(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of each row ``x[i:i + 1]`` alone, concatenated along dim 0.

    PyTorch's reductions choose how to split a sum from the number of
    outputs and from the address's alignment, so a reduction over a
    batch can add a row in another order when the batch changes.  A row
    reduced alone, at a 16-byte aligned address, has the same shape,
    strides and alignment in any batch, so its result is the same bits
    alone, in its batch or in a padded bucket, as the reference's sweep
    body is.  Streaming and serving rely on this."""
    if x.shape[0] == 0:
        return fn(x)
    outs = []
    for i in range(x.shape[0]):
        row = x[i:i + 1]
        outs.append(fn(row if row.data_ptr() % 16 == 0 else row.clone()))
    return torch.cat(outs)


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA and the card convert: toward zero,
    saturating at the int32 range, NaN -> 0 (a plain cast on the CPU
    gives INT32_MIN for every value out of range)."""
    big = x >= 2.0 ** 31
    small = x < -2.0 ** 31
    out = torch.where(big | small | torch.isnan(x), torch.zeros_like(x),
                      x).to(torch.int32)
    out = torch.where(big, torch.full_like(out, 2 ** 31 - 1), out)
    return torch.where(small, torch.full_like(out, -2 ** 31), out)


def validate_eps_positive(epss) -> None:
    """Reject non-positive / non-finite error bounds.

    Accepts a number, a sequence, a numpy array or a tensor (a CUDA
    tensor is copied to the host for the check)."""
    if isinstance(epss, torch.Tensor):
        arr = epss.detach().to("cpu", torch.float64).numpy()
    else:
        arr = np.asarray(epss, np.float64)
    if arr.size and not bool(np.all(np.isfinite(arr) & (arr > 0))):
        raise ValueError(
            f"error bounds must be positive and finite, got {arr}; "
            "an eps <= 0 makes floor(x/eps) ill-defined")


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim float32 tensor on ``like``'s device.  Arithmetic with it is
    the plain IEEE operation on every device (a Python scalar divisor on
    a CUDA tensor is turned into a multiply by its reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def pad_to_multiple(data: torch.Tensor, b: int
                    ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Edge-pad every axis up to a multiple of ``b`` (the last row,
    column, ... repeated).  Returns (padded, original shape)."""
    out = data
    for axis, s in enumerate(data.shape):
        r = (-s) % b
        if r:
            idx = torch.clamp(torch.arange(s + r, device=data.device), max=s - 1)
            out = out.index_select(axis, idx)
    return out, tuple(data.shape)


def spans(n: int, chunk: int):
    """[lo, hi) ranges covering ``n`` elements ``chunk`` at a time."""
    return [(lo, min(n, lo + chunk)) for lo in range(0, n, chunk)]

"""Block-wise int8 quantization and its predicted compression ratio.

The reference gates error-feedback gradient compression and KV-cache
blocks on the paper's quantized-entropy size model: int8 codes of
256-value blocks, each block scaled by its largest magnitude, and a
predicted CR of ``4 N / (N H(codes) / 8 + 4 n_blocks)``.  The serving
layer's ``kv_gate`` method scores leaves with :func:`predicted_cr_rows`.
The error-feedback loop itself (``compress_tree``) belongs to training
and is not ported yet.

Bits follow the reference's float32 operations: the scale is
``max(amax, 1e-12) * f32(1/127)`` (the reference multiplies by the
reciprocal explicitly), ``round`` is half to even in both packages,
``p = counts / n`` divides by a tensor, ``log2`` is the reference's
(``refmath.log2_f32``) and the 4096-term entropy sum adds in XLA's
order (``refmath.sum_rows_f32``).  Every step is elementwise, a max or
an integer count, and that sum runs row by row in a fixed order, so a
row's CR is the same bits alone and in any batch.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import refmath
from repro_torch.quant import scalar

BLOCK = 256  # quantization block (per-block scale)
DEFAULT_BINS = 4096
INV_127 = float(np.float32(1.0 / 127.0))


def _blockify(rows: torch.Tensor) -> torch.Tensor:
    """(k, n) -> (k, n_blocks, BLOCK), the last block zero-padded."""
    pad = (-rows.shape[1]) % BLOCK
    return torch.nn.functional.pad(rows, (0, pad)).reshape(
        rows.shape[0], -1, BLOCK)


def _quantize_blocks(blocks: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., BLOCK) float32 blocks -> (int8 codes, (...) float32 scales)."""
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) * scalar(INV_127, blocks)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127)
    return codes.to(torch.int8), scale[..., 0]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8: (codes (n_blocks, BLOCK) int8, scales)."""
    blocks = _blockify(x.reshape(1, -1).to(torch.float32))[0]
    return _quantize_blocks(blocks)


def dequantize_int8(codes: torch.Tensor, scales: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    n = int(np.prod(shape, dtype=np.int64))
    blocks = codes.to(torch.float32) * scales[:, None]
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def predicted_cr_rows(rows: torch.Tensor,
                      bins: int = DEFAULT_BINS) -> torch.Tensor:
    """(k, n) float32 rows -> (k,) predicted int8+entropy CRs against raw
    float32, each row :func:`predicted_cr_int8` of that row alone."""
    blocks = _blockify(rows.to(torch.float32))
    k, nb, _ = blocks.shape
    codes, _ = _quantize_blocks(blocks)
    n = nb * BLOCK                       # codes, the padded block included
    idx = torch.remainder(codes.reshape(k, n).to(torch.int64) + 128, bins)
    idx = idx + (torch.arange(k, device=rows.device) * bins)[:, None]
    counts = torch.bincount(idx.reshape(-1), minlength=k * bins
                            ).reshape(k, bins)
    p = counts.to(torch.float32) / scalar(float(n), rows)
    terms = torch.where(p > 0, p * refmath.log2_f32(torch.clamp(p, min=1e-30)),
                        torch.zeros_like(p))
    h = -refmath.sum_rows_f32(terms)
    size = (scalar(float(n), rows) * h / scalar(8.0, rows)
            + scalar(nb * 4.0, rows))
    return scalar(4.0 * n, rows) / torch.clamp(size, min=1.0)


def predicted_cr_int8(g: torch.Tensor, bins: int = DEFAULT_BINS
                      ) -> torch.Tensor:
    """Predicted CR of the int8+entropy-coded ``g`` against raw float32:
    size ~ N H(codes) / 8 + 4 bytes per block scale, CR = 4 N / size
    (a 0-dim float32 tensor)."""
    return predicted_cr_rows(g.reshape(1, -1), bins)[0]

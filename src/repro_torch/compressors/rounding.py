"""Rounding-based compressors: Bit Grooming and Digit Rounding.

Both operate on IEEE-754 mantissas and rely on a downstream lossless coder;
they have no spatial decorrelation step, which is why the paper finds the
quantized entropy dominates their CR prediction.  The number of mantissa
bits kept follows the paper's OptZConfig absolute-bound mapping.  Its
``log2`` and ``exp2`` are the reference's float32 ones
(``repro_torch.refmath``): XLA's ``exp2(k)`` is not ``2^k``, so Digit
Rounding's grid step is not a power of two there either.
"""
from __future__ import annotations

import torch

from repro_torch import refmath
from repro_torch.compressors import base, lossless


class BitGrooming(base.Compressor):
    """Zender 2016: alternately shave (to 0) and set (to 1) insignificant
    mantissa bits; the number of kept bits is global, derived from eps and
    the field's max exponent."""
    name = "bitgrooming"
    reads_bits = True

    def _mask_bits(self, data: torch.Tensor, eps: float) -> torch.Tensor:
        amax = torch.max(torch.abs(data))
        emax = torch.floor(refmath.log2_f32(torch.clamp(amax, min=1e-38)))
        # masking k low mantissa bits of a value with exponent e gives
        # error < 2^(e-23+k); bound by worst-case exponent emax
        return torch.clamp(
            23 + torch.floor(refmath.log2_f32(base.scalar(eps, data))) - emax,
            0, 23).to(torch.int32)

    def _encode(self, data, eps):
        k = self._mask_bits(data, eps)
        b = data.contiguous().view(torch.int32)
        mask = torch.bitwise_left_shift(
            torch.tensor(-1, dtype=torch.int32, device=data.device), k)
        flat_idx = torch.arange(data.numel(), device=data.device
                                ).reshape(data.shape)
        groomed = torch.where(flat_idx % 2 == 0, b & mask, b | ~mask)
        # keep exact zeros exact (grooming convention)
        groomed = torch.where(b == 0, b, groomed)
        return groomed.view(torch.float32), {"shape": tuple(data.shape),
                                             "keepbits": k}

    def decode(self, codes, aux, eps):
        return codes

    def size_bytes(self, codes, aux, eps):
        return lossless.raw_zstd_size_bytes(codes)


class DigitRounding(base.Compressor):
    """Delaunay et al. 2018: round (not truncate) to the eps-determined
    binary digit: a grid of step exp2(floor(log2(eps)))."""
    name = "digitrounding"

    def _encode(self, data, eps):
        step = refmath.exp2_f32(
            torch.floor(refmath.log2_f32(base.scalar(eps, data))))
        rounded = torch.round(data / step) * step
        return rounded, {"shape": tuple(data.shape)}

    def decode(self, codes, aux, eps):
        return codes

    def size_bytes(self, codes, aux, eps):
        return lossless.raw_zstd_size_bytes(codes)


base.register(BitGrooming())
base.register(DigitRounding())

"""MGARD-like multilevel (multigrid) compressor.

Hierarchical decomposition (Ainsworth et al.): the data is recursively
restricted to a coarse grid; fine-grid points are predicted by multilinear
interpolation of the *reconstructed* coarse grid and the multilevel
coefficients (prediction residuals) are uniformly quantized and entropy
coded.  Predicting from reconstructed values keeps the absolute error
bound exact at every point, mirroring MGARD's s=0 uniform-quantizer mode.
"""
from __future__ import annotations

import torch

from repro_torch.compressors import base, lossless
from repro_torch.compressors.sz import _dequantize, quantize_bounded


def _interp_even_to_full(coarse: torch.Tensor, full_shape, axis: int) -> torch.Tensor:
    """Linear interpolation from even-index samples to the full grid along
    ``axis`` (odd points = average of neighbours, edge clamped)."""
    c = torch.movedim(coarse, axis, 0)
    n_full = full_shape[axis]
    nxt = torch.cat([c[1:], c[-1:]], dim=0)
    odd = 0.5 * (c + nxt)
    out = torch.zeros((n_full,) + tuple(c.shape[1:]), dtype=c.dtype,
                      device=c.device)
    out[0::2] = c[: (n_full + 1) // 2]
    out[1::2] = odd[: n_full // 2]
    return torch.movedim(out, 0, axis)


def _predict_fine(coarse: torch.Tensor, fine_shape) -> torch.Tensor:
    """Multilinear prolongation from the [::2,::2(,::2)] grid to fine_shape."""
    cur = coarse
    for axis in range(len(fine_shape)):
        cur = _interp_even_to_full(cur, fine_shape, axis)
    return cur


def _restrict(data: torch.Tensor) -> torch.Tensor:
    return data[tuple(slice(None, None, 2) for _ in data.shape)]


class MGARD(base.Compressor):
    name = "mgard"
    levels = 4

    def _encode(self, data, eps):
        fines, shapes = [], []
        cur = data
        for _ in range(self.levels):
            if min(cur.shape) < 4:
                break
            fines.append(cur)
            shapes.append(tuple(cur.shape))
            cur = _restrict(cur)
        # quantize from the coarsest level outward so that predictions use
        # reconstructed values (exact error-bound preservation)
        root_codes = quantize_bounded(cur, eps)
        recon = _dequantize(root_codes, eps)
        level_codes = []
        for fine, shape in zip(reversed(fines), reversed(shapes)):
            pred = _predict_fine(recon, shape)
            c = quantize_bounded(fine - pred, eps)
            level_codes.append(c)
            recon = pred + _dequantize(c, eps)
        return (root_codes, level_codes), {"shape": tuple(data.shape),
                                           "shapes": shapes}

    def decode(self, codes, aux, eps):
        root_codes, level_codes = codes
        recon = _dequantize(root_codes, eps)
        for c, shape in zip(level_codes, reversed(aux["shapes"])):
            recon = _predict_fine(recon, shape) + _dequantize(c, eps)
        return recon

    def size_bytes(self, codes, aux, eps):
        root_codes, level_codes = codes
        return (lossless.coded_size_bytes(root_codes)
                + sum(lossless.coded_size_bytes(c) for c in level_codes))


base.register(MGARD())

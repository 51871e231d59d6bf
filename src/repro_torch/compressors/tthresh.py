"""TTHRESH-like HOSVD (Tucker) compressor for 3-D tensors.

Ballester-Ripoll et al. 2020: whole-tensor HOSVD, then thresholding and
quantization of the core.  TTHRESH bounds the *RMSE*, not the pointwise
max error -- the paper singles it out as the hardest CR to predict
(Table 4).

Factor matrices come from ``eigh`` of the mode Gram matrices, as in the
reference; the Grams and the mode products are plain float32 library
products (no TF32).  The eigenvectors' signs and the core's float32
rounding are the library's, so the threshold can move by a few
coefficients against the reference; the energy prefix sum
(``refmath.cumsum_f32``), ``log2`` and ``exp2`` follow the reference's
float32 order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import refmath
from repro_torch.compressors import base, lossless
from repro_torch.quant import flush_subnormals


def _unfold(x: torch.Tensor, mode: int) -> torch.Tensor:
    return torch.movedim(x, mode, 0).reshape(x.shape[mode], -1)


def hosvd(x: torch.Tensor):
    """Full Tucker decomposition: returns (core, [U1, U2, U3]), each U's
    columns in descending eigenvalue order."""
    us = []
    for mode in range(x.ndim):
        u = _unfold(x, mode)
        _, vecs = torch.linalg.eigh(u @ u.T)         # ascending
        us.append(vecs.flip(-1))
    core = x
    for mode, u in enumerate(us):
        core = torch.movedim(torch.tensordot(core, u, dims=([mode], [0])),
                             -1, mode)
    return core, us


def tucker_reconstruct(core: torch.Tensor, us) -> torch.Tensor:
    x = core
    for mode, u in enumerate(us):
        x = torch.movedim(torch.tensordot(x, u.T, dims=([mode], [0])),
                          -1, mode)
    return x


class TTHRESH(base.Compressor):
    """Core thresholding to meet an RMSE budget of eps, log-quantized core."""
    name = "tthresh"
    supports_3d = True
    QBITS = 12

    def _encode(self, data, eps):
        core, us = hosvd(data)
        # orthogonal factors => dropping core energy E adds RMSE sqrt(E/N);
        # the budget is a Python float the reference compares as float32
        budget = base.scalar((eps ** 2) * data.numel(), data)
        energy = flush_subnormals(core * core)
        c2 = torch.sort(energy.reshape(-1)).values
        cum = refmath.cumsum_f32(c2)
        # largest threshold index whose cumulative energy stays in budget
        idx = int((cum <= budget).sum())
        tau2 = c2[idx - 1] if idx > 0 else torch.zeros_like(c2[0])
        keep = energy > tau2
        kept = torch.where(keep, core, torch.zeros_like(core))
        amax = torch.clamp(kept.abs().max(), min=1e-30)
        # log-magnitude quantization of the surviving coefficients
        rel = flush_subnormals(torch.clamp(kept.abs(), min=1e-30) / amax)
        octaves = base.scalar(40.0, core)       # a tensor divisor: IEEE
        logq = torch.where(
            keep, torch.round((refmath.log2_f32(rel) + 40.0) / octaves
                              * (2 ** self.QBITS - 1)),
            torch.zeros_like(core)).to(torch.int32)
        signs = (core < 0).to(torch.int8)
        return (logq, signs, keep), {"us": us, "amax": amax,
                                     "shape": tuple(data.shape)}

    def decode(self, codes, aux, eps):
        logq, signs, keep = codes
        levels = base.scalar(2 ** self.QBITS - 1, logq)
        expo = logq.to(torch.float32) / levels * 40.0 - 40.0
        mag = refmath.exp2_f32(expo) * aux["amax"]
        core = torch.where(keep, mag * torch.where(signs == 1, -1.0, 1.0),
                           torch.zeros_like(mag))
        return tucker_reconstruct(core, aux["us"])

    def size_bytes(self, codes, aux, eps):
        logq, signs, keep = codes
        keep_np = lossless.host(keep).reshape(-1)
        nnz = int(keep_np.sum())
        # significance bitmap (RLE + lossless), quantized magnitudes, signs
        total = lossless.zstd_bytes(np.packbits(keep_np).tobytes())
        if nnz:
            vals = lossless.host(logq).reshape(-1)[keep_np]
            total += lossless.coded_size_bytes(vals.astype(np.int32))
            total += -(-nnz // 8)                       # signs
        # factor matrices, stored as fp16 (full storage, as the reference)
        total += sum(u.numel() * 2 for u in aux["us"])
        return total + 64

    def roundtrip_error(self, data, eps):
        """RMSE, not max error (subnormals read as zeros)."""
        codes, aux = self.encode(data, eps)
        recon = self.decode(codes, aux, eps)
        diff = recon - flush_subnormals(data.to(torch.float32))
        return float(torch.sqrt(torch.mean(diff * diff)))


base.register(TTHRESH())

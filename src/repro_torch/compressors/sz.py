"""SZ-family Lorenzo compressor (prediction-based decorrelation).

Classic SZ predicts from *reconstructed* neighbours, a sequential data
dependence.  As in the reference this uses the cuSZ dual-quantization
form of Lorenzo -- pre-quantize every value, then difference the
integer codes -- which keeps the absolute error bound exactly and is
fully parallel.  Ported so far: ``quantize_bounded``, the N-D
``lorenzo_encode``/``lorenzo_decode`` and ``SZLorenzo`` (sz3-lorenzo).
"""
from __future__ import annotations

import torch

from repro_torch.compressors import base, lossless


def quantize_bounded(vals: torch.Tensor, eps: float) -> torch.Tensor:
    """Integer codes q with |vals - 2*eps*q| <= eps *exactly*.

    ``round(vals / (2 eps))`` alone can flip a boundary by one ulp of the
    scaled value; the code is nudged by +-1 where the bound is violated,
    twice (the nudge itself re-rounds the product).  The reconstruction
    is a separate float32 multiply, exactly what the decoder computes.
    """
    two_eps = base.scalar(2.0 * eps, vals)
    eps_t = base.scalar(eps, vals)
    q = torch.round(vals / two_eps).to(torch.int32)
    for _ in range(2):
        err = vals - q.to(torch.float32) * two_eps
        q = q + (err > eps_t).to(torch.int32) - (err < -eps_t).to(torch.int32)
    return q


def lorenzo_encode(data: torch.Tensor, eps: float) -> torch.Tensor:
    """codes = prod_axis (1 - S_axis) q  (N-D integer Lorenzo difference)."""
    q = quantize_bounded(data.to(torch.float32), eps)
    for axis in range(data.ndim):
        q = torch.diff(q, dim=axis, prepend=torch.zeros_like(
            q.narrow(axis, 0, 1)))
    return q


def lorenzo_decode(codes: torch.Tensor, eps: float) -> torch.Tensor:
    q = codes
    for axis in range(codes.ndim):
        q = torch.cumsum(q, dim=axis, dtype=torch.int32)
    return q.to(torch.float32) * base.scalar(2.0 * eps, codes)


class SZLorenzo(base.Compressor):
    """SZ3 with the exclusive Lorenzo scheme (dual-quantization form)."""
    name = "sz3-lorenzo"

    def encode(self, data, eps):
        return lorenzo_encode(data, eps), {"shape": tuple(data.shape)}

    def decode(self, codes, aux, eps):
        return lorenzo_decode(codes, eps)

    def size_bytes(self, codes, aux, eps):
        return lossless.coded_size_bytes(codes)


base.register(SZLorenzo())

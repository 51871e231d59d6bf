"""Plain PyTorch version of the Lorenzo kernel, and the bounded
quantizer and N-D Lorenzo codes that the SZ-family compressors
(``compressors.sz``, ``compressors.mgard``) build on."""
import torch

from repro_torch.kernels.quality.ref import fma32
from repro_torch.quant import flush_subnormals as _ftz
from repro_torch.quant import scalar


def quantize_bounded(vals: torch.Tensor, eps: float, *,
                     fused: bool = False) -> torch.Tensor:
    """Integer codes q with |vals - 2*eps*q| <= eps *exactly*.

    ``round(vals / (2 eps))`` alone can flip a boundary by one ulp of the
    scaled value; the code is nudged by +-1 where the bound is violated,
    twice (the nudge itself re-rounds the product).

    ``fused=False`` takes the error as a float32 multiply, then a
    subtract: the reference's op-by-op (eager) calls.  ``fused=True``
    takes it as one ``fma(-q, 2 eps, vals)``: inside the reference's
    jitted ``_prequant`` XLA drops the ``optimization_barrier`` before
    code generation and the CPU contracts the pair into an FMA.

    Subnormal quotients and residuals read as signed zeros, as in the
    reference (``quant.flush_subnormals``).  A subnormal value needs no
    flush: its quotient rounds to code 0 and its residual meets only the
    comparisons with +-eps, which see it as they see its zero.
    """
    two_eps = scalar(2.0 * eps, vals)
    eps_t = scalar(eps, vals)
    q = torch.round(_ftz(vals / two_eps)).to(torch.int32)
    for _ in range(2):
        qf = q.to(torch.float32)
        err = _ftz(fma32(-qf, two_eps, vals) if fused
                   else vals - qf * two_eps)
        q = q + (err > eps_t).to(torch.int32) - (err < -eps_t).to(torch.int32)
    return q


def lorenzo_encode(data: torch.Tensor, eps: float) -> torch.Tensor:
    """codes = prod_axis (1 - S_axis) q  (N-D integer Lorenzo difference),
    q the pre-quantization with the error fused, as the reference's
    jitted ``_prequant`` computes it."""
    q = quantize_bounded(data.to(torch.float32), eps, fused=True)
    for axis in range(data.ndim):
        q = torch.diff(q, dim=axis, prepend=torch.zeros_like(
            q.narrow(axis, 0, 1)))
    return q


def lorenzo2d(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(m, n) float32 -> (m, n) int32 Lorenzo codes at error bound eps."""
    return lorenzo_encode(x.to(torch.float32), eps)

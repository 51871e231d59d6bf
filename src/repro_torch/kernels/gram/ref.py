"""Plain PyTorch version of the Gram kernel.

Accumulates in float64 and rounds once to float32: the exactly rounded
Gram, which the CUDA kernel's float32 sums are held against (rtol 2e-5,
atol 2e-3, the tolerance of the reference's own kernel tests).

Subnormals follow XLA's CPU dot, which reads and writes them as zeros:
a subnormal input counts as zero, and the products of two values below
2^-63 (each below 2^-126, so subnormal) are left out.  A slice whose
values all lie below 2^-63 so has a zero Gram, as in the reference and
the kernel.  A product of such a value with a larger one is kept, as a
normal product is there.
"""
import torch

from repro_torch.quant import SQRT_MIN_NORMAL, flush_subnormals


def _gram64(a: torch.Tensor) -> torch.Tensor:
    """(k, T, N) float32 -> (k, N, N) float32 of A^T A, summed in float64."""
    a = flush_subnormals(a).to(torch.float64)
    small = a.abs() < SQRT_MIN_NORMAL
    hi = torch.where(small, 0.0, a)
    g = torch.matmul(hi.transpose(1, 2), hi)
    if bool((small & (a != 0)).any()):
        cross = torch.matmul(hi.transpose(1, 2), a - hi)
        g = g + cross + cross.transpose(1, 2)
    return g.to(torch.float32)


def gram_xtx_batched(x: torch.Tensor) -> torch.Tensor:
    """(k, m, n) -> (k, n, n) stack of X^T X."""
    return _gram64(x)


def gram_xxt_batched(x: torch.Tensor) -> torch.Tensor:
    """(k, m, n) -> (k, m, m) stack of X X^T."""
    return _gram64(x.transpose(1, 2))

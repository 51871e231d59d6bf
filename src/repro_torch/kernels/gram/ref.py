"""Plain PyTorch version of the Gram kernel.

Accumulates in float64 and rounds once to float32: the exactly rounded
Gram, which the CUDA kernel's float32 sums are held against (rtol 2e-5,
atol 2e-3, the tolerance of the reference's own kernel tests).
"""
import torch


def gram_xtx_batched(x: torch.Tensor) -> torch.Tensor:
    """(k, m, n) -> (k, n, n) stack of X^T X."""
    xd = x.to(torch.float64)
    return torch.matmul(xd.transpose(1, 2), xd).to(torch.float32)


def gram_xxt_batched(x: torch.Tensor) -> torch.Tensor:
    """(k, m, n) -> (k, m, m) stack of X X^T."""
    xd = x.to(torch.float64)
    return torch.matmul(xd, xd.transpose(1, 2)).to(torch.float32)


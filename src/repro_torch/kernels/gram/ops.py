"""Public wrapper for the Gram kernel (``csrc/gram.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
in ``ref``.  The kernel masks the ragged edge and reads the X X^T
orientation in place, so there is no padding and no transposed copy.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gram import ref as _ref


def _launch(x: torch.Tensor, transpose: bool) -> torch.Tensor:
    _build.require_cuda(x, "gram_batched")
    k, m, n = x.shape
    out_n = n if transpose else m
    tiles = -(-out_n // 128)              # gram.cu: 128 x 128 output tiles
    if max(k, m, n) >= 2 ** 31 or k > 65535 or tiles * (tiles + 1) // 2 > 65535:
        raise ValueError(f"gram_batched: shape {tuple(x.shape)} too large")
    g = torch.empty((k, out_n, out_n), dtype=torch.float32, device=x.device)
    fn = _build.load("gram").repro_gram_batched
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(g), k, m, n, int(transpose),
                  _build.stream(x))
    _build.check(code, "gram_batched")
    gram_batched.launches += 1
    gram_batched.by_shape[(k, m, n, transpose)] += 1
    return g


def gram_batched(x: torch.Tensor, transpose: bool = True) -> torch.Tensor:
    """Batched Gram over a (k, m, n) stack of slices in one launch.

    transpose=True  -> X^T X per slice: (k, n, n)
    transpose=False -> X X^T per slice: (k, m, m)
    """
    if x.ndim != 3:
        raise ValueError(f"gram_batched expects (k, m, n), got {tuple(x.shape)}")
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return (_ref.gram_xtx_batched(x) if transpose
                else _ref.gram_xxt_batched(x))
    return _launch(x.contiguous(), transpose)


gram_batched.launches = 0
gram_batched.by_shape = Counter()     # (k, m, n, transpose) -> launches


def gram(x: torch.Tensor, transpose: bool = True) -> torch.Tensor:
    """Unbatched Gram: the k = 1 case of :func:`gram_batched`."""
    if x.ndim != 2:
        raise ValueError(f"gram expects (m, n), got {tuple(x.shape)}")
    return gram_batched(x[None], transpose)[0]

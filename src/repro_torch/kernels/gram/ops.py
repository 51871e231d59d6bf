"""Public wrapper for the Gram kernel (``csrc/gram.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
in ``ref``.  The kernel masks the ragged edge and reads the X X^T
orientation in place, so there is no padding and no transposed copy.

The wrapper also fixes the kernel's numerics for a shape:
:func:`launch_plan` cuts the contraction into ``CHUNK_T``-long chunks
by the slice's own (N, T), so a slice's Gram is the same bits alone, in
its batch or in a padded bucket (streaming and serving rely on it).
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gram import ref as _ref


TILE = 128        # gram.cu: 128 x 128 output tiles
CHUNK_T = 4096    # contraction a chunk sums; a multiple of gram.cu's stage


def contraction_chunks(t: int) -> int:
    """How many ``CHUNK_T``-long chunks a contraction of length ``t`` is
    cut into; each Gram entry is the in-order sum of its chunks' partial
    sums.  Every slice edge up to ``CHUNK_T`` (the paper's fields go to
    1800) is one chunk; a volume's mode unfolding (t ~ 10^5) is 24-36."""
    return max(1, -(-t // CHUNK_T))


def launch_plan(shape, transpose: bool) -> tuple[int, int, int]:
    """(N, T, chunks) of the kernel for a (k, m, n) stack: output edge,
    contraction length and its chunks.  A function of the slice's shape
    alone, never of k or the card, so a slice's Gram bits do not depend
    on the batch it is launched in."""
    _, m, n = shape
    big_n, t = (n, m) if transpose else (m, n)
    return big_n, t, contraction_chunks(t)


def _launch(x: torch.Tensor, transpose: bool) -> torch.Tensor:
    _build.require_cuda(x, "gram_batched")
    k, m, n = x.shape
    out_n, _, chunks = launch_plan(x.shape, transpose)
    tiles = -(-out_n // TILE)
    upper = tiles * (tiles + 1) // 2
    if max(k, m, n) >= 2 ** 31 or k > 65535 or upper > 65535:
        raise ValueError(f"gram_batched: shape {tuple(x.shape)} too large")
    g = torch.empty((k, out_n, out_n), dtype=torch.float32, device=x.device)
    partial = (torch.empty((k, upper, chunks, TILE * TILE),
                           dtype=torch.float32, device=x.device)
               if chunks > 1 else None)
    fn = _build.load("gram").repro_gram_batched
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(g),
                  None if partial is None else _build.ptr(partial), k, m, n,
                  int(transpose), chunks, CHUNK_T, _build.stream(x))
    _build.check(code, "gram_batched")
    _build.count(gram_batched, (k, m, n, transpose))
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

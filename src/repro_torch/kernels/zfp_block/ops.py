"""Public wrapper for the zfp_block kernel (``csrc/zfp_block.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
in ``ref``.  Both see the slice edge-padded to a multiple of 4, as the
reference's wrapper pads it; the kernel needs no further tile padding.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.zfp_block import ref as _ref
from repro_torch.quant import pad_to_multiple


def _launch(x: torch.Tensor):
    _build.require_cuda(x, "zfp_forward2d")
    m, n = x.shape
    if m % 4 or n % 4 or m >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"zfp_forward2d: unsupported shape {tuple(x.shape)}")
    if x.data_ptr() % 16:
        x = x.clone()                       # the kernel loads float4 rows
    coef = torch.empty((m, n), dtype=torch.int32, device=x.device)
    exps = torch.empty((m // 4, n // 4), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return coef, exps
    fn = _build.load("zfp_block").repro_zfp_forward2d
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(coef), _build.ptr(exps), m, n,
                  _build.stream(x))
    _build.check(code, "zfp_forward2d")
    _build.count(zfp_forward2d, (m, n))
    return coef, exps


def zfp_forward2d(x: torch.Tensor):
    """Forward zfp transform of an arbitrary (m, n) slice.

    Returns (coefficients (m4, n4) int32, exponents (m4/4, n4/4) int32)
    of the slice edge-padded to (m4, n4), the next multiples of 4 (the
    compressor consumes whole 4x4 blocks)."""
    if x.ndim != 2:
        raise ValueError(f"zfp_forward2d expects (m, n), got {tuple(x.shape)}")
    xp, _ = pad_to_multiple(x.to(torch.float32), 4)
    if xp.device.type == "cpu":
        return _ref.zfp_forward2d(xp)
    return _launch(xp.contiguous())


zfp_forward2d.launches = 0
zfp_forward2d.by_shape = Counter()     # (m, n) -> launches

"""Public wrapper for the Lorenzo kernel (``csrc/lorenzo.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
in ``ref``.  The kernel masks the ragged edge and reads the zero halo
itself, so unlike the TPU route nothing is padded or cropped.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lorenzo import ref as _ref


def _launch(x: torch.Tensor, eps: float) -> torch.Tensor:
    _build.require_cuda(x, "lorenzo2d")
    m, n = x.shape
    if m >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"lorenzo2d: shape {tuple(x.shape)} too large")
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.load("lorenzo").repro_lorenzo2d
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # the plain version's float32 scalars: f32(2 * eps) and f32(eps)
    two_eps, eps32 = float(np.float32(2.0 * eps)), float(np.float32(eps))
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(out), m, n, two_eps, eps32,
                  _build.stream(x))
    _build.check(code, "lorenzo2d")
    _build.count(lorenzo2d, (m, n))
    return out


def lorenzo2d(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(m, n) slice -> (m, n) int32 codes
    Q(x[i,j]) - Q(x[i-1,j]) - Q(x[i,j-1]) + Q(x[i-1,j-1]), with Q the
    bounded quantizer of ``ref.quantize_bounded`` and Q = 0
    outside the slice."""
    if x.ndim != 2:
        raise ValueError(f"lorenzo2d expects (m, n), got {tuple(x.shape)}")
    eps = float(eps)
    if not np.isfinite(eps) or eps <= 0:
        raise ValueError(f"lorenzo2d: eps must be positive and finite, got {eps}")
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return _ref.lorenzo2d(x, eps)
    return _launch(x.contiguous(), eps)


lorenzo2d.launches = 0
lorenzo2d.by_shape = Counter()     # (m, n) -> launches

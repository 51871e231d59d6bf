"""Public entry point for the fused quality sweep (``csrc/quality.cu``).

``quality_sweep`` owns what both routes share -- flattening, per-slice
extrema on the unpadded data, the PSNR/NRMSE finalization -- and hands
the SSE reduction to the kernel (CUDA tensor) or the plain version
(CPU tensor).  The two SSE routes run the same float32 operations in
the same order, so the (k, e, 2) tensor is bitwise the same on both.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quality import ref as _ref
from repro_torch.quant import validate_eps_positive as _check_eps


def _launch(flat: torch.Tensor, epss: torch.Tensor) -> torch.Tensor:
    _build.require_cuda(flat, "qdq_sse_sweep")
    _build.require_cuda(epss, "qdq_sse_sweep eps")
    k, n = flat.shape
    e = epss.shape[0]
    tiles = -(-n // _ref.DEFAULT_TILE)
    if k > 65535 or tiles >= 2 ** 31 or k * e >= 2 ** 31:
        raise ValueError(f"qdq_sse_sweep: unsupported k={k}, n={n}, e={e}")
    partial = torch.empty((tiles, k * e), dtype=torch.float32,
                          device=flat.device)
    sse = torch.empty((k, e), dtype=torch.float32, device=flat.device)
    fn = _build.load("quality").repro_quality_sse
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(flat.device):
        code = fn(_build.ptr(flat), _build.ptr(epss), _build.ptr(partial),
                  _build.ptr(sse), k, n, e, _build.stream(flat))
    _build.check(code, "qdq_sse_sweep")
    _build.count(qdq_sse_sweep, (k, n, e))
    return sse


def qdq_sse_sweep(flat: torch.Tensor, epss: torch.Tensor) -> torch.Tensor:
    """(k, n) float32 slices x (e,) error bounds -> (k, e) float32 SSE of
    the quantize-dequantize error, in the fixed 2048-element-tile order."""
    epss = epss.to(device=flat.device, dtype=torch.float32).reshape(-1)
    if flat.device.type == "cpu":
        return _ref.sse_sweep(flat, epss)
    return _launch(flat.contiguous(), epss.contiguous())


qdq_sse_sweep.launches = 0
qdq_sse_sweep.by_shape = Counter()     # (k, n, e) -> launches


def quotient_mismatches(divisors: torch.Tensor) -> torch.Tensor:
    """(d,) float32 divisors on the card -> (d,) int64 counts of the finite
    float32 v whose quotient v / d, as the quality and Lorenzo kernels
    compute it (``csrc/quotient.cuh``), differs from ``__fdiv_rn``."""
    _build.require_cuda(divisors, "quotient check")
    bad = torch.zeros(divisors.shape[0], dtype=torch.int64,
                      device=divisors.device)
    fn = _build.load("quality").repro_quotient_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(divisors.device):
        code = fn(_build.ptr(divisors), divisors.shape[0], _build.ptr(bad),
                  _build.stream(divisors))
    _build.check(code, "quotient check")
    return bad


def quality_sweep(x: torch.Tensor, epss) -> torch.Tensor:
    """(k, ...) stack x (e,) error bounds -> (k, e, 2) [PSNR dB, NRMSE].

    PSNR and NRMSE of the quantization proxy: quantize-dequantize each
    slice at every error bound and score it against the original.
    Exactly representable slices report ``PSNR_CAP``; zero-range slices
    with nonzero error report ``-PSNR_CAP`` and an ``NRMSE_CAP``-clipped
    NRMSE, so every value is finite.  ``x`` holds no subnormal: the
    entry points (``core.predictors``) flush it, as XLA reads it."""
    _check_eps(epss)
    k = x.shape[0]
    flat = x.to(torch.float32).reshape(k, -1)
    epss = torch.as_tensor(epss, dtype=torch.float32).reshape(-1)
    n = flat.shape[1]
    vmin = torch.amin(flat, dim=1)
    vmax = torch.amax(flat, dim=1)
    sse = qdq_sse_sweep(flat, epss)
    return _ref.quality_from_stats(sse, n, vmin, vmax)

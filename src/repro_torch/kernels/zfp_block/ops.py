"""Public wrapper for the zfp_block kernel (``csrc/zfp_block.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
in ``ref``.  Both see the slice edge-padded to a multiple of 4, as the
reference's wrapper pads it; the kernel needs no further tile padding.

:func:`launch_plan` sizes the kernel's grid from the card's SM count,
at most one full wave; thread t of the grid takes blocks t, t + T,
t + 2T, ... (T the grid's threads) of the band-major order, block b
being the 4x4 block at rows 4 (b // (n/4)), columns 4 (b % (n/4)).
The plan moves data only: a block's bits depend on its 16 values alone.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.zfp_block import ref as _ref
from repro_torch.quant import pad_to_multiple

THREADS = 256       # zfp_block.cu: threads a CTA, one 4x4 block each
CTAS_PER_SM = 8     # a full wave: 2048 threads an SM at 32 registers


def launch_plan(m: int, n: int, sms: int) -> tuple[int, int]:
    """(ctas, steps) for an (m, n) slice, m and n multiples of 4, on a
    card of ``sms`` SMs: ``ctas`` CTAs of ``THREADS`` threads, at most
    ``CTAS_PER_SM`` an SM and no CTA without a block, and the most
    blocks a thread takes (1 up to ~4.3 M values on 132 SMs)."""
    nblocks = (m // 4) * (n // 4)
    if nblocks == 0:
        return 0, 0
    ctas = min(-(-nblocks // THREADS), sms * CTAS_PER_SM)
    return ctas, -(-nblocks // (ctas * THREADS))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x: torch.Tensor):
    _build.require_cuda(x, "zfp_forward2d")
    m, n = x.shape
    if m % 4 or n % 4 or (m // 4) * (n // 4) >= 2 ** 30:
        raise ValueError(f"zfp_forward2d: unsupported shape {tuple(x.shape)}")
    if x.data_ptr() % 16:
        x = x.clone()                       # the kernel loads float4 rows
    coef = torch.empty((m, n), dtype=torch.int32, device=x.device)
    exps = torch.empty((m // 4, n // 4), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return coef, exps
    ctas, _ = launch_plan(m, n, _sm_count(x.device.index))
    fn = _build.load("zfp_block").repro_zfp_forward2d
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(coef), _build.ptr(exps), m, n,
                  ctas, _build.stream(x))
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

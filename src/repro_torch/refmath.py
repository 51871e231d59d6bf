"""float32 ``log2``, ``exp2`` and ``sum`` with the reference's bits.

The reference computes ZFP's block exponent as ``ceil(log2(amax))``, its
scale as ``exp2(24 - e)`` and the size model's bit length as
``ceil(log2(mag + 1))``, and a CR model's prediction as ``exp`` of its
log.  XLA on the CPU evaluates ``log2(x)`` as ``log(x) * f32(1/ln 2)``
and ``exp2(k)`` as ``exp(k * f32(ln 2))``, each
with a Cephes-style float32 polynomial whose multiply-adds the CPU
contracts into FMAs.  Neither is exact: ``ceil(log2(2^k))`` comes out
``k + 1`` for some ``k`` and ``exp2(k)`` misses ``2^k`` by up to ~30 ulp.
So a bit-equal port spells out the same sequence of float32 operations
here, with :func:`fma32` where XLA fuses, and the CUDA kernel of
``csrc/zfp_block.cu`` repeats it with ``__f*_rn`` intrinsics.

Domain: non-negative inputs for :func:`log2_f32`, a zero or subnormal
giving ``-inf`` as XLA on the CPU (which reads a subnormal as zero)
gives it; any float32 for :func:`exp_f32` and :func:`exp2_f32` (integer
exponents for ZFP's scale, real ones for TTHRESH's decode), whose
subnormal results are flushed to zero as XLA flushes them.

The reference totals ZFP's per-block bit counts with a float32
``jnp.sum``, which rounds once the total passes 2^24 (an 1800 x 1800
slice reaches 4.5e7 bits): :func:`sum_f32` adds in XLA's CPU order, as
:func:`sum_rows_f32` adds each row of a stack (the q-ent kernel route's
entropy sums, the int8 gate's).
TTHRESH's energy threshold runs a float32 ``jnp.cumsum`` over every core
coefficient: :func:`cumsum_f32` adds in XLA's CPU order too.

AdamW's bias corrections raise a float32 constant to the step: XLA on
the CPU calls the C library's ``powf`` for a scalar ``pow`` and flushes
a subnormal result; :func:`powf` does the same on the host.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

from repro_torch.kernels.quality.ref import fma32


def _f32(bits: int) -> float:
    """The float32 whose float64 bit pattern is ``bits`` (XLA's IR
    spells its float32 constants as float64 hex)."""
    return float(np.array([bits], np.uint64).view(np.float64)[0])


# log: Cephes polynomial on the mantissa in [sqrt(1/2), sqrt(2)) - 1
LOG_P = tuple(float(np.float32(v)) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
SQRTHF = _f32(0x3FE6A09E60000000)          # f32(sqrt(1/2))
LN2_HI = 0.693359375                        # ln 2 split in two parts
LN2_LO = float(np.float32(-2.12194440e-4))
INV_LN2 = float(np.float32(1.44269502))     # f32(1 / f32(ln 2)), log2's factor
MIN_NORMAL = 2.0 ** -126

# exp: Cephes polynomial on the reduced argument
LN2 = float(np.float32(0.693147182))        # exp2's factor, f32(ln 2)
LOG2E = _f32(0x3FF7154760000000)
EXP_LO = _f32(0xC055F33340000000)           # -87.8, XLA's input clamp
EXP_HI = _f32(0x4056333340000000)           # 88.8
EXP_P = tuple(float(np.float32(v)) for v in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 0.5))


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of non-negative float32 values, bit-equal to XLA's CPU
    ``log``; ``-inf`` at a zero or subnormal.  Every ``*`` and ``+``
    below is one float32 operation."""
    x = x.to(torch.float32)
    zero = x < MIN_NORMAL
    x = torch.clamp(x, min=MIN_NORMAL)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    small = m < SQRTHF
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(torch.float32)
    t2 = t * t
    t3 = t2 * t
    p = LOG_P
    y = fma32(fma32(t, p[0], p[1]), t, p[2])
    y1 = fma32(fma32(t, p[3], p[4]), t, p[5])
    y2 = fma32(fma32(t, p[6], p[7]), t, p[8])
    y = fma32(y, t3, y1)
    y = fma32(y, t3, y2)
    y = fma32(y, t3, e * LN2_LO)
    r = fma32(t2, -0.5, t) + y
    out = fma32(e, LN2_HI, r)
    return torch.where(zero, torch.full_like(out, float("-inf")), out)


def log2_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2`` of positive float32 values on the CPU, bit for bit."""
    return log_f32(x) * INV_LN2


def ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """``ceil(log2(x))`` as the reference computes it, as int32."""
    return torch.ceil(log2_f32(x)).to(torch.int32)


class TorchOps:
    """The steps :func:`exp_f32` takes, on torch tensors: exactly rounded
    FMAs (``fma32``) and a flush of subnormal results."""

    fma = staticmethod(fma32)
    clip = staticmethod(torch.clamp)
    floor = staticmethod(torch.floor)

    @staticmethod
    def f32(x):
        return x.to(torch.float32)

    @staticmethod
    def pow2(k):
        """2^k of integer-valued float32 ``k`` in [-127, 127] (0 at -127)."""
        return ((k.to(torch.int32) + 127) << 23).view(torch.float32)

    @staticmethod
    def ftz(x):
        return torch.where(x.abs() < MIN_NORMAL, torch.zeros_like(x), x)


def exp_f32(a, ops=TorchOps):
    """``jnp.exp`` of float32 values on the CPU, bit for bit: XLA's
    Cephes polynomial, its multiply-adds contracted into FMAs.  The
    argument is clamped to [-87.8, 88.8] (so ``+inf`` gives ``+inf`` by
    overflow and a NaN stays NaN); subnormal results are flushed to zero
    as XLA flushes them.  Held to ``jax.jit(jnp.exp)`` over the whole
    finite float32 range.  ``ops`` supplies the steps (``TorchOps``; the
    CR models' checked host form passes numpy ones)."""
    a = ops.clip(ops.f32(a), EXP_LO, EXP_HI)
    fx = ops.clip(ops.floor(ops.fma(a, LOG2E, 0.5)), -127.0, 127.0)
    r = ops.fma(-fx, LN2_HI, a)
    r = ops.fma(-fx, LN2_LO, r)
    y = ops.fma(r, EXP_P[0], EXP_P[1])
    for c in EXP_P[2:]:
        y = ops.fma(y, r, c)
    t = ops.fma(y, r * r, r) + 1.0
    return ops.ftz(t * ops.pow2(fx))


def exp2_f32(k: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` of float32 exponents on the CPU, bit for bit:
    ``exp(k * f32(ln 2))`` (:func:`exp_f32`).  Held to ``jnp.exp2`` at
    every integer exponent and on sampled reals."""
    return exp_f32(k.to(torch.float32) * LN2)


XLA_WINDOW = 32     # the window of XLA's CPU tree-reduction rewrite


def sum_rows_f32(v: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(v, axis=-1)`` of a float32 stack on the CPU, bit for bit,
    on ``v``'s device: (..., n) -> (...).

    While more than 32 values remain, XLA rewrites the reduction into a
    reduce-window of 32, stride 32, over the values padded to a multiple
    of 32 with zeros split evenly at both ends (the odd one at the
    end); each window adds its values in order from 0.0.  The last 32
    or fewer add in order from 0.0 as well.  The running sums start at
    +0.0, so none is ever -0.0 and a +0.0 pad leaves it as it is.  XLA
    sums every row of a stack this way, whatever the stack's shape.
    Here every step is an elementwise add over all rows at once, so a
    row's sum is the same bits in any stack, of any length of the
    leading axes, on the CPU and on the card."""
    v = v.to(torch.float32)
    lead = tuple(v.shape[:-1])
    while True:
        n = v.shape[-1]
        if n == 0:
            return torch.zeros(lead, dtype=torch.float32, device=v.device)
        cols = min(n, XLA_WINDOW)
        pad = (-n) % cols
        if pad:
            v = torch.nn.functional.pad(v, (pad // 2, pad - pad // 2))
        cols_first = v.reshape(lead + (-1, cols)).movedim(-1, 0).contiguous()
        acc = torch.zeros(cols_first.shape[1:], dtype=torch.float32,
                          device=v.device)
        for j in range(cols):
            acc = acc + cols_first[j]
        if n <= XLA_WINDOW:
            return acc[..., 0]
        v = acc


def sum_f32(v: torch.Tensor) -> np.float32:
    """``jnp.sum`` of a 1-D float32 tensor on the CPU, bit for bit
    (:func:`sum_rows_f32` of one row).  The values are read to the host
    once and added there: ~100 elementwise adds of a few thousand values
    cost less on the host than as kernel launches."""
    v = v.detach().to("cpu", torch.float32).reshape(1, -1)
    return np.float32(sum_rows_f32(v)[0].item())


CUMSUM_BASE = 16    # the row of XLA's CPU rewrite of a long prefix sum


def cumsum_f32(v: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` of a 1-D float32 tensor on the CPU, bit for bit, on
    the tensor's device.

    XLA rewrites a prefix sum longer than 16 into rows of 16 (the input
    zero-padded at its end): each row's prefix sums are added in order
    from 0.0, the rows' totals are prefix-summed the same way
    (recursively), and the total of the rows before a row is added to
    each of its prefix sums.  Found by search against ``jnp.cumsum`` and
    held to it in the tests at lengths 0-19, 31-33, 255-257, 4097,
    100000 and 1000003."""
    v = v.to(torch.float32).reshape(-1)
    n = v.numel()
    pad = (-n) % CUMSUM_BASE if n > CUMSUM_BASE else 0
    rows = torch.nn.functional.pad(v, (0, pad)).reshape(-1, min(n, CUMSUM_BASE)
                                                      if n else 1)
    out = torch.empty_like(rows)
    acc = torch.zeros(rows.shape[0], dtype=torch.float32, device=v.device)
    for j in range(rows.shape[1]):
        acc = acc + rows[:, j]
        out[:, j] = acc
    if rows.shape[0] > 1:
        carry = cumsum_f32(acc)[:-1]
        out[1:] = out[1:] + carry[:, None]
    return out.reshape(-1)[:n]


@functools.cache
def _libm_powf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    return fn


def powf(x: float, y: float) -> np.float32:
    """``jnp.power`` of two float32 scalars as a jitted reference computes
    it on the CPU: the C library's ``powf`` (glibc's, held to
    ``jax.jit`` at steps 1-3000), a subnormal result flushed to zero."""
    r = np.float32(_libm_powf()(float(np.float32(x)), float(np.float32(y))))
    return np.float32(0.0) if abs(r) < MIN_NORMAL else r

"""Compressed cross-pod collectives (the reference's
``dist.collectives``), over ``torch.distributed`` process groups.

Cross-pod links are the scarcest bandwidth in a multi-pod job, so the pod
gradient sync ships int8 rows (amax-scaled along the last axis) instead
of float32: a 4x wire-byte reduction for <1% relative error on
gradient-scale tensors.  Every process of a pod group calls
:func:`compressed_pod_allreduce` with its own tensor and gets the mean.

The bits are those of the reference's functions inside its jitted step
(``jax.jit``; its eager calls round differently):

* ``scale = max(amax, 1e-12) * f32(1/127)`` -- XLA turns the division by
  the constant 127 into a product by its reciprocal; ``x / scale`` stays
  a true division, rounded half to even (``jnp.round`` and
  ``torch.round`` both are);
* the mean over the gathered pods runs in pod order with XLA's
  contraction: ``acc = q_0 s_0``, then ``acc = fma(q_p, s_p, acc)``, then
  ``acc * f32(1/P)``, so every rank gets the same bits whatever its rank;
* the error-feedback residual against a rank's own contribution is
  ``fma(-q, scale, x)`` (:func:`residual`).

The payload crosses as bytes: on a ``nccl`` group from the tensor's
device; on ``gloo`` through host memory, a CUDA tensor staged explicitly
through pinned host buffers (gloo moves host memory).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.kernels.quality.ref import fma32

CHUNK = 1 << 24     # values of a leaf combined at a time (float64 temporaries)
_INV127 = float(np.float32(1.0) / np.float32(127.0))


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]) if x.dim() else x.reshape(1, 1)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization along the last axis: (codes
    int8 of ``x``'s shape, float32 scales of shape ``x.shape[:-1] + (1,)``)."""
    xf = _rows(x)
    q = torch.empty(xf.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((xf.shape[0], 1), dtype=torch.float32, device=x.device)
    inv = torch.tensor(_INV127, dtype=torch.float32)
    step = max(1, CHUNK // max(1, xf.shape[1]))
    for lo in range(0, xf.shape[0], step):
        part = xf[lo:lo + step].to(torch.float32)
        s = torch.clamp(part.abs().amax(dim=-1, keepdim=True), min=1e-12) * inv
        q[lo:lo + step] = torch.clamp(torch.round(part / s), -127, 127).to(
            torch.int8)
        scale[lo:lo + step] = s
    return (q.reshape(x.shape),
            scale.reshape(tuple(x.shape[:-1]) + (1,)) if x.dim() else
            scale.reshape(()))


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def residual(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
             ) -> torch.Tensor:
    """``x - dequantize_int8(q, scale)`` as the jitted step computes it,
    ``fma(-q, scale, x)`` exactly rounded (float32)."""
    xf = _rows(x.to(torch.float32))
    qf, sf = _rows(q), scale.reshape(-1, 1)
    out = torch.empty(xf.shape, dtype=torch.float32, device=x.device)
    step = max(1, CHUNK // max(1, xf.shape[1]))
    for lo in range(0, xf.shape[0], step):
        sl = slice(lo, lo + step)
        out[sl] = fma32(-qf[sl].to(torch.float32), sf[sl], xf[sl])
    return out.reshape(x.shape)


def pod_mean(qs: List[torch.Tensor], scales: List[torch.Tensor]
             ) -> torch.Tensor:
    """The float32 mean of the pods' dequantized rows, in pod order:
    ``q_0 s_0``, then one exactly rounded ``fma(q_p, s_p, acc)`` a pod,
    then the product by ``f32(1/P)``."""
    shape = qs[0].shape
    rows = [_rows(q) for q in qs]
    srows = [s.reshape(-1, 1) for s in scales]
    out = torch.empty(rows[0].shape, dtype=torch.float32,
                      device=rows[0].device)
    inv = torch.tensor(float(np.float32(1.0) / np.float32(len(qs))),
                       dtype=torch.float32)
    step = max(1, CHUNK // max(1, rows[0].shape[1]))
    for lo in range(0, rows[0].shape[0], step):
        sl = slice(lo, lo + step)
        acc = dequantize_int8(rows[0][sl], srows[0][sl])
        for q, s in zip(rows[1:], srows[1:]):
            acc = fma32(q[sl].to(torch.float32), s[sl], acc)
        out[sl] = acc * inv
    return out.reshape(shape)


def _group_size(group) -> int:
    """Members of ``group``; None is this process alone (an axis of 1)."""
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every member's ``x`` (same shape and dtype on every member), in
    the group's rank order, on ``x``'s device (``group`` None: ``[x]``).
    The tensor crosses as bytes; on a ``gloo`` group a CUDA tensor goes
    through pinned host buffers."""
    import torch.distributed as dist
    n = _group_size(group)
    if n == 1:
        return [x]
    src = x.detach().contiguous().reshape(-1).view(torch.uint8)
    staged = dist.get_backend(group) != "nccl" and src.device.type != "cpu"
    if staged:
        buf = torch.empty(src.shape, dtype=torch.uint8, pin_memory=True)
        buf.copy_(src)
        src = buf
    outs = [torch.empty(src.shape, dtype=torch.uint8, device=src.device,
                        pin_memory=staged) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    return [o.to(x.device).view(x.dtype).reshape(x.shape) for o in outs]


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of every member's ``x`` in ``x``'s dtype: summed in rank
    order, then the product by ``1/P`` (``jax.lax.pmean`` in a jitted
    program; every rank gets the same bits)."""
    parts = all_gather(x, group)
    if len(parts) == 1:
        return x
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc * torch.tensor(float(np.float32(1.0) / np.float32(len(parts))),
                              dtype=x.dtype)


def compressed_pod_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """Mean of ``x`` across ``group`` (the pods) via an int8 all-gather:
    quantize locally, all-gather the int8 payload and the float32 scales
    (the only cross-pod transfer), dequantize and average on the
    receiver; returned in ``x``'s dtype."""
    q, scale = quantize_int8(x)
    qs = all_gather(q, group)
    ss = all_gather(scale, group)
    return pod_mean(qs, ss).to(x.dtype)

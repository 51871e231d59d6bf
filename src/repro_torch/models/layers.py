"""Shared model layers: RMSNorm, RoPE, chunked GQA attention, SwiGLU.

Plain functions on tensors, in the reference's forms and dtypes
(``repro/models/layers.py``): norms and softmax in float32, products in
the activation dtype.  Two PyTorch habits would move the reference's
numbers, so they are avoided here:

- a Python float meeting a bfloat16 tensor stays a float32 scalar in
  PyTorch, while JAX first rounds it to bfloat16 (a weak type): the
  attention scale is a 0-dim tensor of the query's dtype;
- ``torch.matmul`` refuses mixed dtypes where JAX promotes: ``dot``
  casts both operands to the promoted dtype.

Attention is the reference's form (float32 scores, ``-1e30`` masking,
softmax, weights cast to the activation dtype, then V), not
``scaled_dot_product_attention``, which normalizes in another order.
``rms_norm`` carries the reference's custom backward for training;
``apply_mrope`` is Qwen2-VL's multimodal RoPE (the vlm family);
``layer_norm`` and ``gelu_mlp`` are whisper's (the encdec family).
``gelu`` is ``jax.nn.gelu``'s default, the tanh approximation, written
out in its order (``F.gelu`` defaults to the erf form).

``tp_ar_out`` marks the two products the reference names ``"tp_ar_out"``
(``swiglu``'s down-projection here, attention's output projection in
``causal_lm``): ``REPRO_REMAT=tp_outs`` keeps exactly those.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a``'s last axis contracted with ``b``'s first (``einsum("...d,
    df->...f")``), in the promoted dtype of the two."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


_MARK = threading.local()


@contextlib.contextmanager
def tp_ar_out():
    """Marks the products run inside it as the reference's
    ``checkpoint_name(..., "tp_ar_out")`` outputs (:func:`in_tp_ar_out`)."""
    prev = getattr(_MARK, "on", False)
    _MARK.on = True
    try:
        yield
    finally:
        _MARK.on = prev


def in_tp_ar_out() -> bool:
    return getattr(_MARK, "on", False)


def _rms_norm_fwd(x, gamma, eps):
    xf = x.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r * gamma.to(torch.float32)).to(x.dtype), r


class _RMSNorm(torch.autograd.Function):
    """The reference's custom VJP (``_rms_norm_bwd``): the backward in
    float32, ``dx`` in ``x``'s dtype and ``dgamma`` in ``gamma``'s.
    ``r ** 3`` is ``r * (r * r)`` (JAX's ``integer_pow``) and ``s / d``
    a product by ``f32(1 / d)`` (XLA's division by a constant)."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        y, r = _rms_norm_fwd(x, gamma, eps)
        ctx.save_for_backward(x, gamma, r)
        return y

    @staticmethod
    def backward(ctx, g):
        x, gamma, r = ctx.saved_tensors
        inv_d = torch.tensor(float(np.float32(1.0) / np.float32(x.shape[-1])),
                             dtype=torch.float32)
        xf = x.to(torch.float32)
        gf = g.to(torch.float32) * gamma.to(torch.float32)
        s = torch.sum(gf * xf, dim=-1, keepdim=True)
        dx = r * gf - xf * (r * (r * r)) * (s * inv_d)
        dgamma = torch.sum(g.to(torch.float32) * xf * r,
                           dim=tuple(range(x.ndim - 1)))
        return dx.to(x.dtype), dgamma.to(gamma.dtype), None


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 internals, returned in ``x``'s dtype; under
    autograd, with the reference's backward (``_RMSNorm``)."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad):
        return _RMSNorm.apply(x, gamma, eps)
    return _rms_norm_fwd(x, gamma, eps)[0]


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32, two passes as the reference's: the mean,
    then the mean of ``(x - mu) ** 2``, then ``rsqrt(var + eps)``;
    returned in ``x``'s dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    xc = xf - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * gamma.to(torch.float32) + beta.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(rot_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (arange(0, rot_dim, 2) / rot_dim)`` as the jitted
    reference gets it: XLA folds this function of constants in float64
    and rounds once (the exponents are float32 quotients).  A float32
    ``pow`` then reciprocal differs in the last bit of some frequencies,
    which positions near 1000 magnify past float32 parity."""
    e = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device)
    e = (e / rot_dim).to(torch.float64)
    return (1.0 / torch.pow(theta, e)).to(torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               partial: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    first ``int(hd * partial)`` (even) dims rotate, the rest pass."""
    hd = x.shape[-1]
    rot = int(hd * partial)
    rot -= rot % 2
    freqs = rope_freqs(rot, theta, x.device)               # (rot/2,)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), xp], dim=-1)


def mrope_section_ids(sections, half: int) -> list:
    """The position stream (0: t, 1: h, 2: w) of each of ``half``
    frequency pairs: stream i repeated ``sections[i]`` times, cut or
    padded with the last stream to ``half`` (``jnp.repeat`` with
    ``total_repeat_length``)."""
    ids = [i for i, n in enumerate(sections) for _ in range(int(n))]
    ids = ids[:half]
    return ids + [len(sections) - 1] * (half - len(ids))


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL M-RoPE.  x: (..., S, H, hd); positions3: (3, ..., S), the
    (t, h, w) position streams.  Frequency pair j rotates by stream
    ``mrope_section_ids(sections, hd / 2)[j]``; every dim rotates.  The
    frequencies are ``rope_freqs`` (XLA's float64 fold)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    sec = torch.tensor(mrope_section_ids(sections, hd // 2),
                       device=positions3.device)
    pos = torch.movedim(positions3.index_select(0, sec), 0, -1)  # (..., S, hd/2)
    ang = pos.to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


# ---------------------------------------------------------------------------
# Attention (chunked over query blocks)
# ---------------------------------------------------------------------------

def _gqa_scores(q, k):
    """q: (B,S,Hq,hd), k: (B,T,Hkv,hd) -> (B,Hq,S,T) with GQA grouping."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, s, hkv, hq // hkv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k)
    return scores.reshape(b, hq, s, k.shape[1])


def _gqa_out(w, v):
    """w: (B,Hq,S,T), v: (B,T,Hkv,hd) -> (B,S,Hq,hd)."""
    b, hq, s, t = w.shape
    hkv = v.shape[2]
    w = w.reshape(b, hkv, hq // hkv, s, t)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, hq, v.shape[-1])


def scaled_query(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q * scale`` as JAX computes it for a Python float: the scale
    rounded to ``q``'s dtype first.  The 0-dim tensor stays on the host,
    where a CUDA op reads it as a scalar: a copy to the card would wait
    for the card at every layer."""
    return q * torch.tensor(scale, dtype=q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0, window: int = 0,
              chunk: int = 1024, kv_positions: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-query GQA attention.

    q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd).  Queries go in chunks of
    ``chunk`` (the last zero-padded, as the reference's loop pads it), so
    a (chunk, T) score block is materialized, never (S, T).
    q_offset: absolute position of q[0] (decode: pos; prefill: 0).
    window > 0 adds a sliding-window constraint.
    kv_positions: (B, T) absolute positions of cache slots (ring buffers).
    """
    b, s, hq, hd = q.shape
    t = k.shape[1]
    qf = scaled_query(q, scale if scale is not None else hd ** -0.5)
    if kv_positions is None:
        kv_pos = torch.arange(t, device=q.device)[None, :]      # (1, T)
    else:
        kv_pos = kv_positions                                   # (B, T)
    kv_pos = kv_pos[:, None, None, :]

    def block(qc, qpos):
        # qc: (B, C, Hq, hd); qpos: (C,) absolute positions
        scores = _gqa_scores(qc, k).to(torch.float32)           # (B,Hq,C,T)
        qpos = qpos[None, None, :, None]
        mask = torch.ones((1, 1, qc.shape[1], t), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (kv_pos <= qpos)
        if window:
            mask = mask & (kv_pos > (qpos - window))
        scores = torch.where(mask, scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        return _gqa_out(w, v)

    pos = torch.arange(max(s, chunk), device=q.device)
    if s <= chunk:
        return block(qf, q_offset + pos[:s])

    vd = v.shape[-1]                  # value head dim (MLA: != query hd)
    pad = (-s) % chunk
    if pad:                           # ragged tail
        qf = torch.cat([qf, qf.new_zeros((b, pad, hq, hd))], dim=1)
    nc = (s + pad) // chunk
    qcs = qf.reshape(b, nc, chunk, hq, hd)
    out = torch.stack([block(qcs[:, i], q_offset + i * chunk + pos[:chunk])
                       for i in range(nc)], dim=1)
    return out.reshape(b, s + pad, hq, vd)[:, :s]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (``approximate=True``) in ``x``'s dtype:
    ``x * (0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 * x ** 3))))``,
    the cube ``x * (x * x)`` as JAX's ``integer_pow`` takes it."""
    x3 = x * (x * x)
    inner = torch.tensor(_SQRT_2_OVER_PI, dtype=x.dtype) * (
        x + torch.tensor(0.044715, dtype=x.dtype) * x3)
    return x * (torch.tensor(0.5, dtype=x.dtype) * (1.0 + torch.tanh(inner)))


def gelu_mlp(x, w1, b1, w2, b2):
    """Whisper's MLP: x (B,S,D); w1 (D,F), b1 (F,); w2 (F,D), b2 (D,).
    The GELU in float32, cast back to ``x``'s dtype."""
    h = dot(x, w1) + b1
    h = gelu(h.to(torch.float32)).to(x.dtype)
    return dot(h, w2) + b2


def swiglu(x, wg, wu, wd):
    """SwiGLU MLP: x (B,S,D); wg/wu (D,F); wd (F,D); the down-projection
    is a ``tp_ar_out`` product."""
    g = dot(x, wg)
    u = dot(x, wu)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    with tp_ar_out():
        return dot(h, wd)

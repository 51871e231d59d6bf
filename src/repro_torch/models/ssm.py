"""Mamba2's mixer (``repro/models/ssm.py``): the chunked SSD scan for a
sequence, one recurrent step for decode.

Layout: x (B, S, H, P) heads; B/C (B, S, G, N) groups; A a scalar per
head; dt per head per step.  ``a_log``, ``d_skip`` and ``dt_bias`` are
float32 leaves in a bfloat16 model and the recurrent state is float32,
so several products meet a bfloat16 tensor and a float32 one.  They
follow JAX's promotion, as the reference's jitted form computes them:

* ``dx = x * dt`` is float32, and so are the intra-chunk output
  (bfloat16 scores times float32 ``dx``), the chunk end-states and the
  decode step's state update;
* the scores, their decay (``exp`` of the segment sums cast to the
  scores' dtype) and the inter-chunk output are products in the
  activation dtype, each rounded once; the inter-chunk output's three
  operands contract in the order ``jnp.einsum``'s path takes at the
  configs' shapes: ``C * decay`` first when ``N <= P`` (a tie takes
  the elementwise product first), else ``C . h`` over N first;
* ``ssd_forward`` and ``ssm_step`` therefore return a float32 output in
  a bfloat16 model; ``mamba_mixer``'s gated norm runs on it and casts
  to the activation dtype before ``out_proj``.

The inter-chunk ``lax.scan`` is a loop over the chunks carrying the
float32 state.  ``mamba_mixer`` with a cache and one token is a decode
step; with a cache and a sequence it is a prefill, which returns the
conv window's last inputs and the final state for the decode steps.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    return d_inner, heads


def ssm_param_table(layers: int, cfg):
    d_inner, heads = ssm_dims(cfg)
    g, n = cfg.ssm_groups, cfg.ssm_state
    conv_dim = d_inner + 2 * g * n
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "in_proj": ParamDef(
            (layers, cfg.d_model, 2 * d_inner + 2 * g * n + heads),
            ("layers", "fsdp", "model")),
        "conv_w": ParamDef((layers, cfg.ssm_conv, conv_dim),
                           ("layers", None, "model")),
        "conv_b": ParamDef((layers, conv_dim), ("layers", "model"),
                           init="zeros"),
        "a_log": ParamDef((layers, heads), ("layers", "model"), init="zeros",
                          dtype=torch.float32),
        "d_skip": ParamDef((layers, heads), ("layers", "model"), init="ones",
                           dtype=torch.float32),
        "dt_bias": ParamDef((layers, heads), ("layers", "model"),
                            init="zeros", dtype=torch.float32),
        "norm_g": ParamDef((layers, d_inner), ("layers", "model"),
                           init="ones"),
        "out_proj": ParamDef((layers, d_inner, cfg.d_model),
                             ("layers", "model", "fsdp")),
    }


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, K-1, conv_dim) last inputs for the short conv
    state: torch.Tensor  # (B, H, P, N) recurrent state, float32


def init_ssm_cache(batch: int, cfg, dtype=torch.bfloat16,
                   device="cuda") -> SSMCache:
    d_inner, heads = ssm_dims(cfg)
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, heads, cfg.ssm_head_dim, cfg.ssm_state),
                          dtype=torch.float32, device=device),
    )


def _split_proj(xz: torch.Tensor, cfg):
    d_inner, _ = ssm_dims(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state
    return torch.split(xz, [d_inner, d_inner + 2 * gn,
                            xz.shape[-1] - 2 * d_inner - 2 * gn], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, window K: (B, S, C) -> (B, S, C), the taps
    added in order in ``xbc``'s dtype, then SiLU in float32 and a cast
    back.  ``history``: (B, K-1, C) values preceding position 0 (the
    decode cache)."""
    k, s = w.shape[0], xbc.shape[1]
    if history is None:
        history = xbc.new_zeros((xbc.shape[0], k - 1) + tuple(xbc.shape[2:]))
    xp = torch.cat([history.to(xbc.dtype), xbc], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return F.silu((out + b).to(torch.float32)).to(xbc.dtype)


def _segsum(da: torch.Tensor) -> torch.Tensor:
    """da: (..., Q) -> (..., Q, Q) lower-triangular cumulative sums
    L[i, j] = sum_{j < m <= i} da[m] (-inf above the diagonal)."""
    q = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(q, device=da.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, float("-inf"))


def ssd_forward(x: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
                dt: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                chunk: int, init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    x (B, S, H, P), b_in / c_in (B, S, G, N), dt (B, S, H) float32
    (post-softplus), a (H,) negative.  Returns (y (B, S, H, P) in the
    promoted dtype of x and dt, final_state (B, H, P, N) float32)."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is no multiple of the chunk {chunk}")
    nc = s // chunk
    rep = h // g

    xc = x.reshape(bsz, nc, chunk, h, p)
    bc = torch.repeat_interleave(b_in.reshape(bsz, nc, chunk, g, n), rep,
                                 dim=3)
    cc = torch.repeat_interleave(c_in.reshape(bsz, nc, chunk, g, n), rep,
                                 dim=3)
    dtc = dt.reshape(bsz, nc, chunk, h)
    da = torch.movedim(dtc * a, -1, 2)                      # (B,nc,H,Q)

    # intra-chunk (quadratic within a chunk)
    lmat = torch.exp(_segsum(da))                           # (B,nc,H,Q,Q)
    scores = torch.einsum("bnqhx,bnkhx->bnhqk", cc, bc)     # (B,nc,H,Q,Q)
    scores = scores * lmat.to(scores.dtype)
    dx = xc * dtc[..., None]                                # (B,nc,Q,H,P)
    ft = torch.promote_types(scores.dtype, dx.dtype)
    y_intra = torch.einsum("bnhqk,bnkhp->bnqhp", scores.to(ft), dx.to(ft))

    # chunk end-states: item k decays by exp(sum_{m>k} da_m), the
    # exclusive tail sum of the recurrence h_t = e^{da_t} h_{t-1} + ...
    cs = torch.cumsum(da, dim=-1)
    decay_to_end = torch.exp(cs[..., -1:] - cs).to(dx.dtype)
    st = torch.promote_types(dx.dtype, bc.dtype)
    states = torch.einsum("bnhk,bnkhx,bnkhp->bnhpx", decay_to_end.to(st),
                          bc.to(st), dx.to(st))             # (B,nc,H,P,N)

    # inter-chunk recurrence over the chunks, the state in float32
    chunk_decay = torch.exp(torch.sum(da, dim=-1))          # (B,nc,H)
    hs = (init_state if init_state is not None else
          torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    prevs = []
    for i in range(nc):
        prevs.append(hs)
        hs = hs * chunk_decay[:, i, :, None, None] + states[:, i].to(
            torch.float32)
    h_prevs = torch.stack(prevs, dim=1).to(cc.dtype)        # (B,nc,H,P,N)

    # inter-chunk contribution: y += C_q * decay(q <- start) * h_prev
    decay_in = torch.exp(torch.cumsum(da, dim=-1)).to(cc.dtype)  # (B,nc,H,Q)
    if n <= p:
        cd = cc * torch.movedim(decay_in, 2, 3)[..., None]  # (B,nc,Q,H,N)
        y_inter = torch.einsum("bnqhx,bnhpx->bnqhp", cd, h_prevs)
    else:
        ch = torch.einsum("bnqhx,bnhpx->bnqhp", cc, h_prevs)
        y_inter = ch * torch.movedim(decay_in, 2, 3)[..., None]
    y = y_intra + y_inter + dx * d_skip[:, None].to(dx.dtype)
    return y.reshape(bsz, s, h, p), hs


def ssm_step(x: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
             dt: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
             state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence: x (B, H, P), b / c (B, G, N), dt (B, H)
    float32, state (B, H, P, N) float32 -> (y (B, H, P), state)."""
    rep = x.shape[1] // b_in.shape[1]
    bb = torch.repeat_interleave(b_in, rep, dim=1)          # (B,H,N)
    ccd = torch.repeat_interleave(c_in, rep, dim=1)
    decay = torch.exp(dt * a)                               # (B,H)
    dx = x * dt[..., None]
    st = torch.promote_types(bb.dtype, dx.dtype)
    state = (state * decay[..., None, None]
             + (dx.to(st)[..., None] * bb.to(st)[:, :, None, :]
                ).to(torch.float32))
    y = torch.einsum("bhpn,bhn->bhp", state.to(ccd.dtype), ccd)
    return y + dx * d_skip[:, None].to(dx.dtype), state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def ssd_chunk(s: int, chunk: int) -> int:
    """The largest chunk, halving from ``cfg.ssm_chunk``, that divides
    ``s`` (the reference's loop: 1 when none does)."""
    while s % chunk:
        chunk //= 2
        if chunk <= 1:
            return 1
    return chunk


def mamba_mixer(x: torch.Tensor, p, cfg,
                cache: Optional[SSMCache] = None
                ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """in_proj -> conv -> SSD or a step -> gated norm -> out_proj.

    x: (B, S, D); ``p`` holds this layer's leaves as attributes.  With a
    cache and S == 1 a decode step; with a cache and S > 1 a prefill.
    Returns (out, the new cache or None); the cache given is not
    written."""
    bsz, s, _ = x.shape
    d_inner, heads = ssm_dims(cfg)
    g, n = cfg.ssm_groups, cfg.ssm_state
    xz = L.dot(x, p.in_proj)
    z, xbc, dt_raw = _split_proj(xz, cfg)
    dt = softplus(dt_raw.to(torch.float32) + p.dt_bias)
    a = -torch.exp(p.a_log)

    decode = cache is not None and s == 1
    if decode:
        hist = cache.conv
        new_conv = torch.cat([hist, xbc.to(hist.dtype)], dim=1)[:, 1:]
        xbc_c = _causal_conv(xbc, p.conv_w, p.conv_b, hist)
    else:
        xbc_c = _causal_conv(xbc, p.conv_w, p.conv_b)
    xs, b_in, c_in = torch.split(xbc_c, [d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, s, heads, cfg.ssm_head_dim)
    b_in = b_in.reshape(bsz, s, g, n)
    c_in = c_in.reshape(bsz, s, g, n)

    if decode:
        y, new_state = ssm_step(xs[:, 0], b_in[:, 0], c_in[:, 0], dt[:, 0],
                                a, p.d_skip, cache.state)
        y = y[:, None]
        new_cache = SSMCache(conv=new_conv, state=new_state)
    else:
        init = cache.state if cache is not None else None
        y, final = ssd_forward(xs, b_in, c_in, dt, a, p.d_skip,
                               ssd_chunk(s, cfg.ssm_chunk), init)
        # prefill: stash the conv window's last inputs for decode steps
        new_cache = (SSMCache(conv=xbc[:, -(cfg.ssm_conv - 1):].to(
            cache.conv.dtype), state=final) if cache is not None else None)

    y = y.reshape(bsz, s, d_inner)
    # gated RMSNorm (mamba2's norm before out_proj, gated by z)
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    y = L.rms_norm(y, p.norm_g).to(x.dtype)
    return L.dot(y, p.out_proj).to(x.dtype), new_cache

"""Decoder-only causal LM (``repro/models/causal_lm.py``), three families:

  dense -- stablelm-3b, codeqwen1.5-7b, granite-8b, granite-3-2b
  moe   -- phi3.5-moe (16 experts, top-2; ``models/moe``)
  vlm   -- qwen2-vl's backbone (the dense layers with QKV biases and
           M-RoPE; the patch frontend is stubbed, as in the reference)

The parameter table is the reference's, stacked over layers
(``seg0.attn.wq`` is (n, d, hq * hd)); ``CausalLM`` holds it as an
``nn.Module`` with one module per layer, each parameter a view of its
layer's slice, so ``layers.3.attn.wq`` is ``seg0.attn.wq[3]``.  Weights
keep the reference's (d_in, d_out) layout: ``x @ W`` is its einsum.

The KV cache is the reference's too: one stacked ``AttnCache`` per
segment, k and v (n, B, T, Hkv, hd) and pos (n, B, T) int32 with
unwritten slots at 10**9.  Layer i reads and writes slice i in place,
so ``prefill`` and ``decode_step`` return the cache they were given,
written.  The KV gate scores whole leaves, so per-layer caches would
change its decisions and byte counts.

Training reads the same table as a tree of tensors (``{"embed": ...,
"seg0": {"attn": {"wq": (n, d, hq * hd), ...}}}``, the reference's
stacked leaves): ``forward`` and ``loss_fn`` take either a ``CausalLM``
or such a tree, and on a tree layer i reads slice i of each leaf
through one ``unbind`` per leaf, so a gradient comes back stacked, one
leaf per reference leaf.  With ``remat`` each layer runs under
``torch.utils.checkpoint`` (the reference's default ``full`` policy:
only layer boundaries are kept).  ``xent_loss`` chunks the sequence by
512 as the reference's scan does.

A moe layer carries a ``moe`` group (a float32 router and the
experts' stacks) where a dense one carries ``mlp``.  A vlm model's
attention rotates by M-RoPE over three position streams
(``mrope_positions``, (3, B, S): t, h, w), which ``forward``,
``loss_fn`` (the batch's ``mrope_positions``) and ``decode_step``
take; without them each stream is the token's position, and M-RoPE is
plain RoPE.  ``prefill`` takes none, as the reference's does, so a
served prompt rotates by its broadcast positions.

The other families (mla_moe, ssm, hybrid, encdec) are ROADMAP Queue 1
items 2-5; the ``REPRO_REMAT=dots|tp_outs`` policies come with training
across cards (item 7).
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.params import ParamDef, tree_flatten

_FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported: the port "
            "builds the dense, moe and vlm families; mla_moe, ssm, hybrid "
            "and encdec are ROADMAP Queue 1 items 2-5")


def is_moe(cfg: ModelConfig) -> bool:
    """Every layer of the family routes through experts."""
    return cfg.family in ("moe", "mla_moe")


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ===========================================================================
# Parameter tables
# ===========================================================================

def _attn_table(n: int, cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    t = {
        "wq": ParamDef((n, d, hq * hd), ("layers", "fsdp", "model")),
        "wk": ParamDef((n, d, hkv * hd), ("layers", "fsdp", "model")),
        "wv": ParamDef((n, d, hkv * hd), ("layers", "fsdp", "model")),
        "wo": ParamDef((n, hq * hd, d), ("layers", "model", "fsdp")),
    }
    if cfg.qkv_bias:
        t["bq"] = ParamDef((n, hq * hd), ("layers", "model"), init="zeros")
        t["bk"] = ParamDef((n, hkv * hd), ("layers", "model"), init="zeros")
        t["bv"] = ParamDef((n, hkv * hd), ("layers", "model"), init="zeros")
    return t


def _mlp_table(n: int, cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wg": ParamDef((n, d, f), ("layers", "fsdp", "model")),
        "wu": ParamDef((n, d, f), ("layers", "fsdp", "model")),
        "wd": ParamDef((n, f, d), ("layers", "model", "fsdp")),
    }


def _norms_table(n: int, cfg: ModelConfig, names) -> Dict[str, ParamDef]:
    return {k: ParamDef((n, cfg.d_model), ("layers", None), init="ones")
            for k in names}


def _layer_table(n: int, cfg: ModelConfig, moe_layer: bool) -> dict:
    """Table for a stack of ``n`` homogeneous layers: attention, then a
    ``moe`` group (the reference keeps shared experts in it, sized
    ``moe_d_ff * max(num_shared, 1)``) or an ``mlp`` one."""
    t = {"attn": _attn_table(n, cfg)}
    if moe_layer:
        ff = cfg.moe_d_ff or cfg.d_ff
        t["moe"] = MOE.moe_param_table(
            n, cfg.d_model, ff, cfg.num_experts, cfg.num_shared_experts,
            shared_d_ff=ff * max(cfg.num_shared_experts, 1))
    else:
        t["mlp"] = _mlp_table(n, cfg)
    t.update(_norms_table(n, cfg, ["norm1", "norm2"]))
    return t


def segments(cfg: ModelConfig):
    """Layer segmentation: one ("scan", num_layers) segment (the ported
    families have no unrolled layers)."""
    check_family(cfg)
    return [("scan", cfg.num_layers)]


def param_table(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab
    t = {
        "embed": ParamDef((v, cfg.d_model), (None, "model"), init="embed"),
        "final_norm": ParamDef((cfg.d_model,), (None,), init="ones"),
        "lm_head": ParamDef((cfg.d_model, v), ("fsdp", "model")),
    }
    for i, (_, n) in enumerate(segments(cfg)):
        t[f"seg{i}"] = _layer_table(n, cfg, moe_layer=is_moe(cfg))
    return t


# ===========================================================================
# The model: parameters as modules
# ===========================================================================

def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


class _Params(nn.Module):
    """A flat group of parameters (``attn``, ``mlp``, ``moe``) of one
    layer."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for k, x in tensors.items():
            setattr(self, k, _param(x))


def _ffn_group(seg: dict) -> str:
    """A segment's feed-forward group, as ``param_table`` chose it."""
    return "moe" if "moe" in seg else "mlp"


class DecoderLayer(nn.Module):
    def __init__(self, seg: dict, i: int):
        super().__init__()
        self.attn = _Params({k: x[i] for k, x in seg["attn"].items()})
        ffn = _ffn_group(seg)
        setattr(self, ffn, _Params({k: x[i] for k, x in seg[ffn].items()}))
        self.norm1 = _param(seg["norm1"][i])
        self.norm2 = _param(seg["norm2"][i])


class CausalLM(nn.Module):
    """The model from a parameter tree shaped as ``param_table(cfg)``
    (stacked layers; any float dtype).  Raises ``ValueError`` on a
    missing, extra or mis-shaped leaf."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        want = dict(tree_flatten(param_table(cfg),
                                 lambda x: isinstance(x, ParamDef)))
        got = dict(tree_flatten(tree))
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        if missing or extra:
            raise ValueError(f"{cfg.name}: parameter tree misses {missing} "
                             f"and has extra {extra}")
        bad = [f"{k}: {tuple(got[k].shape)} != {want[k].shape}"
               for k in want if tuple(got[k].shape) != want[k].shape]
        if bad:
            raise ValueError(f"{cfg.name}: mis-shaped parameters {bad}")
        self.cfg = cfg
        self.embed = _param(tree["embed"])
        self.final_norm = _param(tree["final_norm"])
        self.lm_head = _param(tree["lm_head"])
        self.layers = nn.ModuleList(DecoderLayer(tree["seg0"], i)
                                    for i in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, caches=None, pos_offset: int = 0,
                mrope_positions=None):
        return forward(self, tokens, self.cfg, caches=caches,
                       pos_offset=pos_offset, mrope_positions=mrope_positions)


# ===========================================================================
# KV caches
# ===========================================================================

class AttnCache(NamedTuple):
    k: torch.Tensor         # (n, B, T, Hkv, hd)   [stacked over layers]
    v: torch.Tensor
    pos: torch.Tensor       # (n, B, T) absolute positions of slots


def _attn_cache(n: int, b: int, t: int, cfg: ModelConfig, dtype,
                device) -> AttnCache:
    shape = (n, b, t, cfg.num_kv_heads, cfg.hd)
    return AttnCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((n, b, t), 10 ** 9, dtype=torch.int32, device=device),
    )


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict[str, AttnCache]:
    """Cache tree keyed by segment, in the activation dtype."""
    dtype = act_dtype(cfg)
    return {f"seg{i}": _attn_cache(n, batch, max_len, cfg, dtype, device)
            for i, (_, n) in enumerate(segments(cfg))}


# ===========================================================================
# Blocks
# ===========================================================================

def _project_qkv(x, p, cfg: ModelConfig):
    b, s, _ = x.shape
    q, k, v = L.dot(x, p.wq), L.dot(x, p.wk), L.dot(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.num_heads, cfg.hd)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.hd)
    return q, k, v


def _rope_qk(q, k, positions, cfg: ModelConfig, mrope_positions=None):
    """RoPE, or M-RoPE for the vlm family: ``mrope_positions`` (3, B, S),
    else ``positions`` broadcast to the three streams."""
    if cfg.family == "vlm" and cfg.mrope_sections:
        pos3 = (mrope_positions if mrope_positions is not None
                else positions.expand((3,) + tuple(positions.shape)))
        return (L.apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections),
                L.apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections))
    return (L.apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary),
            L.apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary))


def attn_block(x, p, cfg: ModelConfig, *,
               cache: Optional[AttnCache] = None, pos_offset: int = 0,
               mrope_positions=None):
    """Causal GQA attention; with a cache, the decode (S == 1) or prefill
    write into this layer's (B, T, ...) slices, in place.  (Windowed
    layers belong to the hybrid family.)"""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    positions = pos_offset + torch.arange(s, device=x.device)[None, :]
    q, k = _rope_qk(q, k, positions, cfg, mrope_positions)

    if cache is None:
        out = L.attention(q, k, v, causal=True, q_offset=0)
    elif s == 1:  # decode: ring-buffer or linear cache write
        ck, cv, cpos = cache
        slot = pos_offset % ck.shape[1]
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        cpos[:, slot] = pos_offset
        out = L.attention(q, ck, cv, causal=True, q_offset=pos_offset,
                          kv_positions=cpos)
    else:  # prefill: attend over the full local K/V, cache stores the tail
        ck, cv, cpos = cache
        t = ck.shape[1]
        k_tail, v_tail = k[:, -t:], v[:, -t:]
        pos_tail = positions[:, -t:].to(torch.int32).expand(b, min(s, t))
        if t < s:  # ring buffer: place position p at slot p % t
            shift = s % t
            k_tail = torch.roll(k_tail, shift, dims=1)
            v_tail = torch.roll(v_tail, shift, dims=1)
            pos_tail = torch.roll(pos_tail, shift, dims=1)
        n = min(s, t)
        ck[:, :n] = k_tail
        cv[:, :n] = v_tail
        cpos[:, :n] = pos_tail
        out = L.attention(q, k, v, causal=True, q_offset=0)
    out = out.reshape(b, s, cfg.num_heads * cfg.hd)
    return L.dot(out, p.wo)


def mlp_or_moe(x, lp, cfg: ModelConfig):
    """The layer's feed-forward: its experts, where its table gave it a
    ``moe`` group, else its SwiGLU."""
    if hasattr(lp, "moe"):
        return MOE.moe_ffn(x, lp.moe, num_experts=cfg.num_experts,
                           top_k=cfg.experts_per_token,
                           capacity_factor=cfg.capacity_factor)
    m = lp.mlp
    return L.swiglu(x, m.wg, m.wu, m.wd)


def layer_fwd(x, lp: DecoderLayer, cfg: ModelConfig, *,
              cache: Optional[AttnCache] = None, pos_offset: int = 0,
              mrope_positions=None):
    """One transformer layer.  cache: this layer's entry."""
    x = x + attn_block(L.rms_norm(x, lp.norm1), lp.attn, cfg, cache=cache,
                       pos_offset=pos_offset,
                       mrope_positions=mrope_positions)
    return x + mlp_or_moe(L.rms_norm(x, lp.norm2), lp, cfg)


# ===========================================================================
# Model forward: embed -> layers -> norm -> head
# ===========================================================================

def _stacked_layers(seg: dict):
    """Per-layer views of a stacked segment tree: layer i reads slice i
    of every leaf.  One ``unbind`` per leaf, so autograd stacks the
    layers' gradients once per leaf."""
    groups = {g: {k: x.unbind(0) for k, x in seg[g].items()}
              for g in ("attn", _ffn_group(seg))}
    n1, n2 = seg["norm1"].unbind(0), seg["norm2"].unbind(0)
    return [SimpleNamespace(
        **{g: SimpleNamespace(**{k: v[i] for k, v in grp.items()})
           for g, grp in groups.items()},
        norm1=n1[i], norm2=n2[i]) for i in range(len(n1))]


def _parts(params):
    """(embed, final_norm, layers) of a ``CausalLM`` or a tree."""
    if isinstance(params, CausalLM):
        return params.embed, params.final_norm, params.layers
    return (params["embed"], params["final_norm"],
            _stacked_layers(params["seg0"]))


def _head(params) -> torch.Tensor:
    return params.lm_head if isinstance(params, CausalLM) else params["lm_head"]


def forward(model, tokens: torch.Tensor, cfg: ModelConfig, *,
            caches=None, pos_offset: int = 0, mrope_positions=None,
            remat: bool = False):
    """tokens: (B, S) int -> final-normed hidden (B, S, D); with ``caches``
    (dict per segment, written in place) also returns them.  ``model``
    is a ``CausalLM`` or a parameter tree; ``mrope_positions`` (3, B, S)
    the vlm family's position streams; ``remat`` checkpoints each layer
    when autograd records (no cache)."""
    embed, final_norm, layers = _parts(model)
    x = embed[tokens.long()].to(act_dtype(cfg))
    seg = caches["seg0"] if caches is not None else None
    remat = remat and seg is None and torch.is_grad_enabled()
    for i, lp in enumerate(layers):
        if remat:
            x = checkpoint(functools.partial(
                layer_fwd, lp=lp, cfg=cfg, pos_offset=pos_offset,
                mrope_positions=mrope_positions), x, use_reentrant=False)
            continue
        lc = (AttnCache(seg.k[i], seg.v[i], seg.pos[i])
              if seg is not None else None)
        x = layer_fwd(x, lp, cfg, cache=lc, pos_offset=pos_offset,
                      mrope_positions=mrope_positions)
    x = L.rms_norm(x, final_norm)
    return (x, caches) if caches is not None else x


def logits_fn(model, hidden: torch.Tensor) -> torch.Tensor:
    return torch.matmul(hidden, _head(model).to(hidden.dtype))


def xent_loss(params, hidden: torch.Tensor, labels: torch.Tensor,
              vocab: int, chunk: int = 512) -> torch.Tensor:
    """Chunked softmax cross-entropy over the (padded) vocab, as the
    reference's scan computes it: chunks of ``chunk`` positions, each
    chunk's logits the activation-dtype product cast to float32, then
    ``logsumexp - gold`` summed chunk after chunk from 0.0, and the total
    times ``f32(1 / (b s))`` (XLA's form of the division by a constant).
    The (B, S, V) logits are never materialized."""
    b, s, d = hidden.shape
    if s % chunk and s > chunk:
        raise ValueError(f"sequence {s} is no multiple of the chunk {chunk}")
    chunk = min(chunk, s)
    nc = s // chunk
    h = hidden.reshape(b, nc, chunk, d)
    y = labels.reshape(b, nc, chunk).long()
    w = _head(params).to(hidden.dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nc):
        logit = torch.matmul(h[:, i], w).to(torch.float32)
        lse = torch.logsumexp(logit, dim=-1)
        gold = torch.gather(logit, -1, y[:, i][..., None])[..., 0]
        total = total + torch.sum(lse - gold)
    inv = torch.tensor(float(np.float32(1.0) / np.float32(b * s)),
                       dtype=torch.float32)
    return total * inv


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = True) -> torch.Tensor:
    hidden = forward(params, batch["tokens"], cfg, remat=remat,
                     mrope_positions=batch.get("mrope_positions"))
    return xent_loss(params, hidden, batch["labels"], cfg.padded_vocab)


def prefill(model: CausalLM, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int):
    """Returns (last-token logits (B, V), populated cache).  Takes no
    ``mrope_positions``, as the reference's prefill takes none: a vlm
    prompt rotates by its broadcast positions."""
    caches = init_cache(cfg, tokens.shape[0], max_len, model.device)
    hidden, caches = forward(model, tokens, cfg, caches=caches)
    return logits_fn(model, hidden[:, -1:])[:, 0], caches


def decode_step(model: CausalLM, caches, token: torch.Tensor, pos,
                cfg: ModelConfig, mrope_positions=None):
    """token: (B, 1) int; pos: the absolute position (an int);
    ``mrope_positions`` (3, B, 1) the vlm family's streams.  Writes the
    token's K/V into ``caches`` and returns (logits (B, V), caches)."""
    hidden, caches = forward(model, token, cfg, caches=caches,
                             pos_offset=int(pos),
                             mrope_positions=mrope_positions)
    return logits_fn(model, hidden)[:, 0], caches

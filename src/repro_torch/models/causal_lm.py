"""Decoder-only causal LM (``repro/models/causal_lm.py``), six families:

  dense   -- stablelm-3b, codeqwen1.5-7b, granite-8b, granite-3-2b
  moe     -- phi3.5-moe (16 experts, top-2; ``models/moe``)
  mla_moe -- deepseek-v2 (multi-head latent attention; 2 shared and 160
             routed experts, top-6; a dense first layer)
  vlm     -- qwen2-vl's backbone (the dense layers with QKV biases and
             M-RoPE; the patch frontend is stubbed, as in the reference)
  ssm     -- mamba2 (attention-free; ``models/ssm``)
  hybrid  -- hymba (attention and mamba2 heads in parallel on the same
             normed input, sliding-window attention but in 3 global
             layers, 128 learned meta tokens before the prompt)

(whisper, the encdec family, is ``models/whisper``.)  The parameter
table is the reference's, stacked over the layers of each segment
(``seg0.attn.wq`` is (n, d, hq * hd)).  A model has one ("scan",
num_layers) segment, but deepseek-v2, whose first layer is dense:
``seg0`` holds that layer (MLA and an MLP of d_ff 12288) and ``seg1``
the other num_layers - 1; and hymba, whose global layers are ("global",
1) segments at the start, the middle and the end, with windowed
("scan", n) segments between them (``segments``).  ``CausalLM`` holds
the table as an ``nn.Module`` with one module per layer, numbered
across the segments, each parameter a view of its layer's slice, so
``layers.3.attn.wq`` is ``seg0.attn.wq[3]`` in a one-segment model.
Weights keep the reference's (d_in, d_out) layout: ``x @ W`` is its
einsum.

The cache is the reference's too, one stacked entry per segment:
``AttnCache`` (k and v (n, B, T, Hkv, hd), pos (n, B, T) int32 with
unwritten slots at 10**9), ``MLACache`` (the latent ckv (n, B, T,
kv_lora), the shared krope (n, B, T, rope_dim) and pos) or, for ssm,
``HybridCache(attn=None, conv (n, B, K-1, conv_dim), state (n, B, H, P,
N) float32)``, whose ``None`` holds no leaf, or, for hybrid, the same
with ``attn`` an ``AttnCache`` of ``min(window, max_len) + meta`` slots
in a windowed segment (a ring buffer, with ``sliding_window_decode``)
and ``max_len + meta`` in a global one.  Layer i reads and writes
slice i in place, so ``prefill`` and ``decode_step`` return the cache
they were given, written.  The KV gate scores whole leaves, so
per-layer caches would change its decisions and byte counts.

MLA (``mla_block``) runs in two forms, as the reference's: for S > 1
the expanded one (per-head K/V decompressed from the latent, then
``layers.attention`` with the scale ``(dn + dr) ** -0.5`` and a V head
dimension of its own); for a decode step the absorbed one, scores taken
against the latent cache in float32 (masked to -1e30, softmax, cast
back), so the cache holds only (ckv, krope).

Training reads the same table as a tree of tensors (``{"embed": ...,
"seg0": {"attn": {"wq": (n, d, hq * hd), ...}}}``, the reference's
stacked leaves): ``forward`` and ``loss_fn`` take either a ``CausalLM``
or such a tree, and on a tree layer i of a segment reads slice i of
each leaf through one ``unbind`` per leaf, so a gradient comes back
stacked, one leaf per reference leaf.  With ``remat`` each layer runs
under ``torch.utils.checkpoint`` with the reference's ``REPRO_REMAT``
policy, read at each forward: ``full`` (the default) keeps only the
layer boundaries; ``dots`` also keeps every matrix product's output
inside a layer, and ``tp_outs`` only the two marked ``tp_ar_out``
(``layers.tp_ar_out``), by ``torch.utils.checkpoint``'s selective
checkpointing.  Each recomputes what it does not keep with the same
operations, so the gradients are the same bits under all three.
``xent_loss`` chunks the sequence by 512 as the reference's scan does.

A moe layer carries a ``moe`` group (a float32 router and the
experts' stacks, shared experts with them) where a dense one carries
``mlp``.  A vlm model's attention rotates by M-RoPE over three
position streams (``mrope_positions``, (3, B, S): t, h, w), which
``forward``, ``loss_fn`` (the batch's ``mrope_positions``) and
``decode_step`` take; without them each stream is the token's
position, and M-RoPE is plain RoPE.  ``prefill`` takes none, as the
reference's does, so a served prompt rotates by its broadcast
positions.

A hybrid layer adds its attention and its mixer's outputs as ``0.5 *
(a * mix_attn + y * mix_ssm)`` in the activation dtype; its model
prepends the ``meta`` tokens to a sequence (not to a decode step's
token) and cuts them off after the final norm, and a decode step's
position counts them (``pos + meta_tokens``).

``cache_logical_axes`` gives a cache's logical axes (batch-sharded,
KV heads on ``model`` where they divide its extent, else the sequence).
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.models import ssm as SSM
from repro_torch.models.params import (ParamDef, tree_flatten, tree_leaves,
                                      tree_unflatten)

FAMILIES = ("dense", "moe", "vlm", "mla_moe", "ssm", "hybrid", "encdec")


def check_family(cfg: ModelConfig) -> None:
    """Raises ``ValueError`` on a family no config of the repo has."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}): "
                         f"the families are {', '.join(FAMILIES)}")


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


def _mla_table(n: int, cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": ParamDef((n, d, qr), ("layers", "fsdp", None)),
        "q_norm": ParamDef((n, qr), ("layers", None), init="ones"),
        "wq_b": ParamDef((n, qr, h * (dn + dr)), ("layers", None, "model")),
        "wkv_a": ParamDef((n, d, kvr + dr), ("layers", "fsdp", None)),
        "kv_norm": ParamDef((n, kvr), ("layers", None), init="ones"),
        "wk_b": ParamDef((n, kvr, h * dn), ("layers", None, "model")),
        "wv_b": ParamDef((n, kvr, h * dv), ("layers", None, "model")),
        "wo": ParamDef((n, h * dv, d), ("layers", "model", "fsdp")),
    }


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
    """Table for a stack of ``n`` homogeneous layers: an ssm layer's
    mixer and norm; else attention (MLA for mla_moe; for hybrid also a
    mixer and the two mixing vectors, ones), then a ``moe`` group (the
    reference keeps shared experts in it, sized ``moe_d_ff *
    max(num_shared, 1)``) or an ``mlp`` one."""
    if cfg.family == "ssm":
        t = {"ssm": SSM.ssm_param_table(n, cfg)}
        t.update(_norms_table(n, cfg, ["norm1"]))
        return t
    t = {"attn": (_mla_table(n, cfg) if cfg.family == "mla_moe"
                  else _attn_table(n, cfg))}
    if cfg.family == "hybrid":
        t["ssm"] = SSM.ssm_param_table(n, cfg)
        t.update(_norms_table(n, cfg, ["mix_attn", "mix_ssm"]))
    if moe_layer:
        ff = cfg.moe_d_ff or cfg.d_ff
        t["moe"] = MOE.moe_param_table(
            n, cfg.d_model, ff, cfg.num_experts, cfg.num_shared_experts,
            shared_d_ff=ff * max(cfg.num_shared_experts, 1))
    else:
        t["mlp"] = _mlp_table(n, cfg)
    t.update(_norms_table(n, cfg, ["norm1", "norm2"]))
    return t


DENSE0_D_FF = 12288     # deepseek-v2's dense first layer's MLP


def segments(cfg: ModelConfig):
    """Layer segmentation, a list of (kind, count): deepseek-v2's dense
    first layer is a ("dense0", 1) segment before ("scan", n - 1);
    hymba's ``num_global_layers`` are ("global", 1) segments, each
    followed by a ("scan", n) one of the windowed layers, ``(layers -
    globals) // globals`` of them, the last taking the rest (the
    reference's arithmetic: fewer layers than globals give negative
    counts); every other family has one ("scan", num_layers)."""
    check_family(cfg)
    if cfg.family == "mla_moe" and cfg.dense_first_layer:
        return [("dense0", 1), ("scan", cfg.num_layers - 1)]
    if cfg.family == "hybrid" and cfg.num_global_layers:
        ng = cfg.num_global_layers
        ns = cfg.num_layers - ng
        per = ns // ng
        segs = []
        for i in range(ng):
            segs.append(("global", 1))
            take = per if i < ng - 1 else ns - per * (ng - 1)
            if take:
                segs.append(("scan", take))
        return segs
    return [("scan", cfg.num_layers)]


def seg_window(cfg: ModelConfig, kind: str) -> int:
    """The attention window of a segment's layers (0: none)."""
    if cfg.family == "hybrid" and kind == "scan" and cfg.window_size:
        return cfg.window_size
    return 0


def param_table(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab
    t = {
        "embed": ParamDef((v, cfg.d_model), (None, "model"), init="embed"),
        "final_norm": ParamDef((cfg.d_model,), (None,), init="ones"),
        "lm_head": ParamDef((cfg.d_model, v), ("fsdp", "model")),
    }
    if cfg.meta_tokens:
        t["meta"] = ParamDef((cfg.meta_tokens, cfg.d_model), (None, "fsdp"))
    for i, (kind, n) in enumerate(segments(cfg)):
        if kind == "dense0":
            t[f"seg{i}"] = _layer_table(n, dataclasses.replace(
                cfg, d_ff=DENSE0_D_FF), moe_layer=False)
        else:
            t[f"seg{i}"] = _layer_table(n, cfg, moe_layer=is_moe(cfg))
    return t


# ===========================================================================
# The model: parameters as modules
# ===========================================================================

def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


class _Params(nn.Module):
    """A flat group of parameters (``attn``, ``mlp``, ``moe``, ``ssm``)
    of one layer."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for k, x in tensors.items():
            setattr(self, k, _param(x))


class DecoderLayer(nn.Module):
    """Layer ``i`` of a stacked segment: a ``_Params`` per group of its
    table (``attn`` and ``mlp`` or ``moe``; ``ssm``) and its norms."""

    def __init__(self, seg: dict, i: int):
        super().__init__()
        for k, x in seg.items():
            setattr(self, k, _Params({n: y[i] for n, y in x.items()})
                    if isinstance(x, dict) else _param(x[i]))


def check_tree(cfg: ModelConfig, table: dict, tree: dict) -> None:
    """Raises ``ValueError`` where ``tree`` misses a leaf of ``table``,
    has one more, or shapes one otherwise."""
    want = dict(tree_flatten(table, lambda x: isinstance(x, ParamDef)))
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


class CausalLM(nn.Module):
    """The model from a parameter tree shaped as ``param_table(cfg)``
    (stacked layers; any float dtype).  Raises ``ValueError`` on a
    missing, extra or mis-shaped leaf."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        check_tree(cfg, param_table(cfg), tree)
        self.cfg = cfg
        self.embed = _param(tree["embed"])
        self.final_norm = _param(tree["final_norm"])
        self.lm_head = _param(tree["lm_head"])
        if cfg.meta_tokens:
            self.meta = _param(tree["meta"])
        self.layer_slots = [(f"seg{i}", j) for i, (_, n)
                            in enumerate(segments(cfg)) for j in range(n)]
        self.layers = nn.ModuleList(DecoderLayer(tree[seg], j)
                                    for seg, j in self.layer_slots)

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


class MLACache(NamedTuple):
    ckv: torch.Tensor       # (n, B, T, kv_lora)
    krope: torch.Tensor     # (n, B, T, rope_dim)
    pos: torch.Tensor


class HybridCache(NamedTuple):
    attn: Optional[AttnCache]   # None for ssm
    conv: torch.Tensor          # (n, B, K-1, conv_dim)
    state: torch.Tensor         # (n, B, H, P, N) float32


def _attn_cache(n: int, b: int, t: int, cfg: ModelConfig, dtype,
                device) -> AttnCache:
    shape = (n, b, t, cfg.num_kv_heads, cfg.hd)
    return AttnCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((n, b, t), 10 ** 9, dtype=torch.int32, device=device),
    )


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Cache tree keyed by segment, in the activation dtype (the ssm
    state float32)."""
    dtype = act_dtype(cfg)
    caches = {}
    for i, (kind, n) in enumerate(segments(cfg)):
        if cfg.family in ("ssm", "hybrid"):
            c = SSM.init_ssm_cache(batch, cfg, dtype, device)
            attn = None
            if cfg.family == "hybrid":
                w = (cfg.window_size if kind == "scan" and cfg.window_size
                     and cfg.sliding_window_decode else max_len)
                attn = _attn_cache(n, batch, min(w, max_len)
                                   + cfg.meta_tokens, cfg, dtype, device)
            caches[f"seg{i}"] = HybridCache(
                attn=attn, conv=c.conv[None].repeat(n, 1, 1, 1),
                state=c.state[None].repeat(n, 1, 1, 1, 1))
        elif cfg.family == "mla_moe":
            caches[f"seg{i}"] = MLACache(
                ckv=torch.zeros((n, batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
                krope=torch.zeros((n, batch, max_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device),
                pos=torch.full((n, batch, max_len), 10 ** 9,
                               dtype=torch.int32, device=device))
        else:
            caches[f"seg{i}"] = _attn_cache(n, batch, max_len, cfg, dtype,
                                            device)
    return caches


def cache_logical_axes(cfg: ModelConfig, cache):
    """Logical axes for cache tensors: batch-sharded everywhere, plus a
    ``model``-axis shard on KV heads when they divide the active mesh's
    ``model`` extent, else on the *sequence* dimension (the reference's
    flash-decoding fallback, ``seq_model``).  A tree of axis tuples of
    ``cache``'s structure."""
    from repro_torch.dist import sharding as S
    mesh = S.current_mesh()
    model_ext = 1
    if mesh is not None:
        model_ext = S._mesh_extent(mesh, S.current_rules().get("model", ()))
    kv_shards = model_ext > 1 and cfg.num_kv_heads % model_ext == 0

    def axes_for(x):
        if x.dim() == 5 and cfg.family != "ssm":      # (n, B, T, Hkv, hd)
            if kv_shards:
                return ("layers", "batch", None, "model", None)
            return ("layers", "batch", "seq_model", None, None)
        if x.dim() == 5:                              # ssm state (n,B,H,P,N)
            return ("layers", "batch", "model", None, None)
        if x.dim() == 4 and cfg.family == "mla_moe":  # (n, B, T, ckv)
            return ("layers", "batch", "seq_model", None)
        if x.dim() == 4:                              # conv (n, B, K-1, C)
            return ("layers", "batch", None, "model")
        if x.dim() == 3:                              # pos (n, B, T)
            return ("layers", "batch", "seq_model")
        return tuple([None] * x.dim())
    return tree_unflatten(cache, [axes_for(x) for x in tree_leaves(cache)])


def _layer_cache(seg, j: int):
    """Slice ``j`` of a segment's stacked cache entry (views; a nested
    entry sliced through)."""
    return type(seg)(*[None if a is None else _layer_cache(a, j)
                       if isinstance(a, tuple) else a[j] for a in seg])


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


def attn_block(x, p, cfg: ModelConfig, *, window: int = 0,
               cache: Optional[AttnCache] = None, pos_offset: int = 0,
               mrope_positions=None):
    """Causal GQA attention, over the last ``window`` positions when it
    is set; with a cache, the decode (S == 1) or prefill write into this
    layer's (B, T, ...) slices, in place (a cache shorter than the
    sequence is a ring buffer: position p in slot p % T)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    positions = pos_offset + torch.arange(s, device=x.device)[None, :]
    q, k = _rope_qk(q, k, positions, cfg, mrope_positions)

    if cache is None:
        out = L.attention(q, k, v, causal=True, q_offset=0, window=window)
    elif s == 1:  # decode: ring-buffer or linear cache write
        ck, cv, cpos = cache
        slot = pos_offset % ck.shape[1]
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        cpos[:, slot] = pos_offset
        out = L.attention(q, ck, cv, causal=True, q_offset=pos_offset,
                          window=window, kv_positions=cpos)
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
        out = L.attention(q, k, v, causal=True, q_offset=0, window=window)
    out = out.reshape(b, s, cfg.num_heads * cfg.hd)
    with L.tp_ar_out():
        return L.dot(out, p.wo)


def mla_block(x, p, cfg: ModelConfig, *,
              cache: Optional[MLACache] = None, pos_offset: int = 0):
    """DeepSeek-V2 multi-head latent attention; with a cache, the decode
    (S == 1) or prefill write of this layer's latent and shared rotary
    key into its (B, T, ...) slices, in place.  S > 1 takes the
    expanded form, a decode step the absorbed one (module docstring)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    kvr = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    positions = pos_offset + torch.arange(s, device=x.device)[None, :]

    cq = L.rms_norm(L.dot(x, p.wq_a), p.q_norm)
    q = L.dot(cq, p.wq_b).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = L.dot(x, p.wkv_a)
    ckv = L.rms_norm(kv_a[..., :kvr], p.kv_norm)
    k_rope = L.apply_rope(kv_a[..., kvr:][:, :, None, :], positions,
                          cfg.rope_theta)[:, :, 0]        # shared by heads

    if cache is not None:
        cckv, ckr, cpos = cache
        t = cckv.shape[1]
        if s == 1:
            slot = pos_offset % t
            cckv[:, slot] = ckv[:, 0]
            ckr[:, slot] = k_rope[:, 0]
            cpos[:, slot] = pos_offset
        else:
            n = min(s, t)
            cckv[:, :n] = ckv[:, -t:]
            ckr[:, :n] = k_rope[:, -t:]
            cpos[:, :n] = positions[:, -t:].to(torch.int32).expand(b, n)

    scale = (dn + dr) ** -0.5
    if s > 1:
        # expanded form: per-head K/V from the latent, chunked attention
        k_nope = L.dot(ckv, p.wk_b).reshape(b, s, h, dn)
        v = L.dot(ckv, p.wv_b).reshape(b, s, h, dv)
        kr = k_rope[:, :, None, :].expand(b, s, h, dr)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        kk = torch.cat([k_nope, kr], dim=-1)
        out = L.attention(qq, kk, v, causal=True, q_offset=0, scale=scale)
    else:
        # absorbed decode: scores against the latent cache directly
        wk_b = p.wk_b.reshape(kvr, h, dn)
        q_eff = torch.einsum("bshn,rhn->bshr", q_nope, wk_b.to(q_nope.dtype))
        scores = (torch.einsum("bshr,btr->bhst", q_eff, cckv)
                  + torch.einsum("bshr,btr->bhst", q_rope, ckr))
        scores = scores.to(torch.float32) * torch.tensor(
            scale, dtype=torch.float32)
        mask = cpos[:, None, None, :] <= pos_offset
        scores = torch.where(mask, scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        lat = torch.einsum("bhst,btr->bshr", w, cckv)       # (B,1,H,kvr)
        wv_b = p.wv_b.reshape(kvr, h, dv)
        out = torch.einsum("bshr,rhv->bshv", lat, wv_b.to(lat.dtype))
    return L.dot(out.reshape(b, s, h * dv), p.wo)


def mlp_or_moe(x, lp, cfg: ModelConfig):
    """The layer's feed-forward: its experts, where its table gave it a
    ``moe`` group, else its SwiGLU."""
    if hasattr(lp, "moe"):
        return MOE.moe_ffn(x, lp.moe, num_experts=cfg.num_experts,
                           top_k=cfg.experts_per_token,
                           capacity_factor=cfg.capacity_factor)
    m = lp.mlp
    return L.swiglu(x, m.wg, m.wu, m.wd)


def _mixer(h, lp, cfg: ModelConfig, cache):
    """The layer's mamba2 mixer on ``h``; with a cache, its new conv
    window and state copied into the cache's slices."""
    sc = SSM.SSMCache(cache.conv, cache.state) if cache is not None else None
    y, new = SSM.mamba_mixer(h, lp.ssm, cfg, sc)
    if cache is not None:
        cache.conv.copy_(new.conv)
        cache.state.copy_(new.state)
    return y


def layer_fwd(x, lp: DecoderLayer, cfg: ModelConfig, *, window: int = 0,
              cache=None, pos_offset: int = 0, mrope_positions=None):
    """One layer of any family of this module.  cache: this layer's
    entry, whose slices are written in place."""
    h = L.rms_norm(x, lp.norm1)
    if cfg.family == "ssm":
        return x + _mixer(h, lp, cfg, cache)
    if cfg.family == "mla_moe":
        a = mla_block(h, lp.attn, cfg, cache=cache, pos_offset=pos_offset)
    elif cfg.family == "hybrid":
        # attention and the mixer read the same normed h
        a = attn_block(h, lp.attn, cfg, window=window,
                       cache=None if cache is None else cache.attn,
                       pos_offset=pos_offset)
        y = _mixer(h, lp, cfg, cache)
        a = torch.tensor(0.5, dtype=a.dtype) * (a * lp.mix_attn
                                                + y * lp.mix_ssm)
    else:
        a = attn_block(h, lp.attn, cfg, cache=cache, pos_offset=pos_offset,
                       mrope_positions=mrope_positions)
    x = x + a
    return x + mlp_or_moe(L.rms_norm(x, lp.norm2), lp, cfg)


# ===========================================================================
# Model forward: embed -> layers -> norm -> head
# ===========================================================================

def _stacked_layers(seg: dict, n: int):
    """Per-layer views of a stacked segment tree of ``n`` layers: layer i
    reads slice i of every leaf.  One ``unbind`` per leaf, so autograd
    stacks the layers' gradients once per leaf."""
    parts = {k: ({g: x.unbind(0) for g, x in v.items()}
                 if isinstance(v, dict) else v.unbind(0))
             for k, v in seg.items()}
    return [SimpleNamespace(**{
        k: (SimpleNamespace(**{g: x[i] for g, x in v.items()})
            if isinstance(v, dict) else v[i]) for k, v in parts.items()})
        for i in range(n)]


def _layers(params, cfg: ModelConfig):
    """[(segment, slot, layer, window)] of a ``CausalLM`` or a tree, the
    layers in order across the segments."""
    window = {f"seg{i}": seg_window(cfg, kind)
              for i, (kind, _) in enumerate(segments(cfg))}
    if isinstance(params, CausalLM):
        return [(seg, j, lp, window[seg]) for (seg, j), lp
                in zip(params.layer_slots, params.layers)]
    layers = []
    for i, (_, n) in enumerate(segments(cfg)):
        seg = f"seg{i}"
        layers += [(seg, j, lp, window[seg]) for j, lp
                   in enumerate(_stacked_layers(params[seg], n))]
    return layers


def _top(params, name: str) -> torch.Tensor:
    """A leaf outside the layers (``embed``, ``meta``, ``lm_head``) of a
    model (a module) or a tree."""
    return (getattr(params, name) if isinstance(params, nn.Module)
            else params[name])


# the matrix products a layer's einsums and matmuls dispatch to
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_tp_outs(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS and L.in_tp_ar_out()
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_kwargs() -> dict:
    """``torch.utils.checkpoint`` arguments of ``REPRO_REMAT``'s policy
    (``full``, the default; ``dots``; ``tp_outs``)."""
    import os
    mode = os.environ.get("REPRO_REMAT", "full")
    policy = {"dots": _save_dots, "tp_outs": _save_tp_outs}.get(mode)
    if policy is None:
        return {"use_reentrant": False}
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return {"use_reentrant": False, "context_fn": functools.partial(
        create_selective_checkpoint_contexts, policy)}


def forward(model, tokens: torch.Tensor, cfg: ModelConfig, *,
            caches=None, pos_offset: int = 0, mrope_positions=None,
            remat: bool = False):
    """tokens: (B, S) int -> final-normed hidden (B, S, D); with ``caches``
    (dict per segment, written in place) also returns them.  ``model``
    is a ``CausalLM`` or a parameter tree; ``mrope_positions`` (3, B, S)
    the vlm family's position streams; ``remat`` checkpoints each layer
    when autograd records (no cache).  The meta tokens (hybrid) go before
    a sequence, or a prefill, and not before a decode step's token."""
    x = _top(model, "embed")[tokens.long()].to(act_dtype(cfg))
    meta = cfg.meta_tokens and (caches is None or tokens.shape[1] > 1)
    if meta:
        m = _top(model, "meta").to(x.dtype)
        x = torch.cat([m[None].expand(x.shape[0], -1, -1), x], dim=1)
    remat = remat and caches is None and torch.is_grad_enabled()
    ckpt = remat_kwargs() if remat else {}
    for seg, j, lp, window in _layers(model, cfg):
        if remat:
            x = checkpoint(functools.partial(
                layer_fwd, lp=lp, cfg=cfg, window=window,
                pos_offset=pos_offset, mrope_positions=mrope_positions), x,
                **ckpt)
            continue
        lc = _layer_cache(caches[seg], j) if caches is not None else None
        x = layer_fwd(x, lp, cfg, window=window, cache=lc,
                      pos_offset=pos_offset, mrope_positions=mrope_positions)
    x = L.rms_norm(x, _top(model, "final_norm"))
    if meta:
        x = x[:, cfg.meta_tokens:]
    return (x, caches) if caches is not None else x


def logits_fn(model, hidden: torch.Tensor) -> torch.Tensor:
    return torch.matmul(hidden, _top(model, "lm_head").to(hidden.dtype))


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
    w = _top(params, "lm_head").to(hidden.dtype)
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
    """token: (B, 1) int; pos: the token's position in the prompt and its
    continuation (an int; the meta tokens come on top of it);
    ``mrope_positions`` (3, B, 1) the vlm family's streams.  Writes the
    token's K/V into ``caches`` and returns (logits (B, V), caches)."""
    hidden, caches = forward(model, token, cfg, caches=caches,
                             pos_offset=int(pos) + cfg.meta_tokens,
                             mrope_positions=mrope_positions)
    return logits_fn(model, hidden)[:, 0], caches

"""Whisper-large-v3's backbone (``repro/models/whisper.py``): an
encoder-decoder transformer, the encdec family.

The conv frontend is a stub, as in the reference: the batch carries its
output, the mel-frame embeddings ``frames`` (B, encoder_frames,
d_model).  The encoder is bidirectional self-attention over the frames
(1500 at full size: the attention's ragged tail of query chunks pads
them); the decoder is causal self-attention, cross-attention to the
encoder's memory and a GELU MLP.  Norms are pre-LayerNorms (float32,
two passes: ``layers.layer_norm``); the projections carry biases but the
key's (``bq``, ``bv``, ``bo``), and the cross-attention's leaves are
the ``x_``-prefixed ones.  Decoder positions come from ``pos_dec``'s
8192 rows at ``pos_offset + arange(s)``; the frames are cast to the
activation dtype before ``pos_enc`` is added.

The table is the reference's, stacked over each stack's layers
(``enc.wq`` is (encoder_layers, d, h * hd)); ``Whisper`` holds it as an
``nn.Module`` with one module per layer in ``enc`` and ``dec``, each
parameter a view of its layer's slice.  ``encode``, ``decode`` and
``loss_fn`` also take the table as a tree of tensors, as training
differentiates it (one ``unbind`` per leaf); with ``remat`` every layer
of the encoder, and of the decoder when there is no cache, runs under
``torch.utils.checkpoint``, as the reference's scans run
``jax.checkpoint``-ed layers.

The cache is one ``WhisperCache`` (not a dict of segments): the
decoder's self-attention ``k``, ``v`` (nd, B, T, H, hd) and ``pos``
(nd, B, T) int32, unwritten slots at 10**9, and the cross-attention's
``xk``, ``xv`` (nd, B, F, H, hd).  ``init_cache`` makes the cross K/V
from the encoder's memory (a prefill's); a decode step writes its K/V
at ``pos % T`` in place and reads the cross K/V from the cache (its
memory is ``None``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import causal_lm as CLM
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef


def _ln(n, cfg, names):
    t = {}
    for k in names:
        t[f"{k}_g"] = ParamDef((n, cfg.d_model), ("layers", None), init="ones")
        t[f"{k}_b"] = ParamDef((n, cfg.d_model), ("layers", None),
                               init="zeros")
    return t


def _attn(n, cfg, prefix=""):
    d, hq, hd = cfg.d_model, cfg.num_heads, cfg.hd
    return {
        f"{prefix}wq": ParamDef((n, d, hq * hd), ("layers", "fsdp", "model")),
        f"{prefix}wk": ParamDef((n, d, hq * hd), ("layers", "fsdp", "model")),
        f"{prefix}wv": ParamDef((n, d, hq * hd), ("layers", "fsdp", "model")),
        f"{prefix}wo": ParamDef((n, hq * hd, d), ("layers", "model", "fsdp")),
        f"{prefix}bq": ParamDef((n, hq * hd), ("layers", "model"),
                                init="zeros"),
        f"{prefix}bv": ParamDef((n, hq * hd), ("layers", "model"),
                                init="zeros"),
        f"{prefix}bo": ParamDef((n, d), ("layers", None), init="zeros"),
    }


def _mlp(n, cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamDef((n, d, f), ("layers", "fsdp", "model")),
        "b1": ParamDef((n, f), ("layers", "model"), init="zeros"),
        "w2": ParamDef((n, f, d), ("layers", "model", "fsdp")),
        "b2": ParamDef((n, d), ("layers", None), init="zeros"),
    }


POS_DEC_ROWS = 8192


def param_table(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab
    ne, nd = cfg.encoder_layers, cfg.num_layers
    return {
        "embed": ParamDef((v, cfg.d_model), (None, "model")),
        "pos_dec": ParamDef((POS_DEC_ROWS, cfg.d_model), (None, "fsdp")),
        "pos_enc": ParamDef((cfg.encoder_frames, cfg.d_model),
                            (None, "fsdp")),
        "enc": {**_attn(ne, cfg), **_mlp(ne, cfg),
                **_ln(ne, cfg, ["ln1", "ln2"])},
        "dec": {**_attn(nd, cfg), **_attn(nd, cfg, "x_"), **_mlp(nd, cfg),
                **_ln(nd, cfg, ["ln1", "lnx", "ln2"])},
        "enc_norm_g": ParamDef((cfg.d_model,), (None,), init="ones"),
        "enc_norm_b": ParamDef((cfg.d_model,), (None,), init="zeros"),
        "final_g": ParamDef((cfg.d_model,), (None,), init="ones"),
        "final_b": ParamDef((cfg.d_model,), (None,), init="zeros"),
        "lm_head": ParamDef((cfg.d_model, v), ("fsdp", "model")),
    }


_TOP = ("embed", "pos_dec", "pos_enc", "enc_norm_g", "enc_norm_b",
        "final_g", "final_b", "lm_head")


class Whisper(nn.Module):
    """The model from a parameter tree shaped as ``param_table(cfg)``;
    raises ``ValueError`` on a missing, extra or mis-shaped leaf."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        CLM.check_tree(cfg, param_table(cfg), tree)
        self.cfg = cfg
        for k in _TOP:
            setattr(self, k, CLM._param(tree[k]))
        self.enc = nn.ModuleList(CLM.DecoderLayer(tree["enc"], j)
                                 for j in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(CLM.DecoderLayer(tree["dec"], j)
                                 for j in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


class WhisperCache(NamedTuple):
    k: torch.Tensor         # (nd, B, T, H, hd) decoder self-attention
    v: torch.Tensor
    pos: torch.Tensor       # (nd, B, T) int32
    xk: torch.Tensor        # (nd, B, F, H, hd) cross-attention (fixed)
    xv: torch.Tensor


def _stack(params, name: str, n: int) -> list:
    """The layers of the ``enc`` or ``dec`` stack of a model or a tree."""
    if isinstance(params, Whisper):
        return list(getattr(params, name))
    return CLM._stacked_layers(params[name], n)


def _mha(x, p, cfg: ModelConfig, prefix: str = "", kv=None,
         causal: bool = True, cache=None, pos_offset: int = 0):
    """Whisper's multi-head attention (no GQA; biased q, v and output).
    ``kv``: the keys' source (cross-attention), ``(memory,)`` or, with
    the cross K/V made, ``(memory, k, v)``.  With ``cache`` (this layer's
    (k, v, pos)) the block's K/V and positions are written at ``pos %
    T`` in place (the start clamped to ``T - s``, as
    ``dynamic_update_slice`` clamps it); a step (S == 1) attends over the
    cache, a prefill within the block."""
    b, s, _ = x.shape
    hq, hd = cfg.num_heads, cfg.hd

    def w(name):
        return getattr(p, prefix + name)

    q = L.dot(x, w("wq")) + w("bq")
    if kv is not None and len(kv) == 3:
        k, v = kv[1], kv[2]
    else:
        src = kv[0] if kv is not None else x
        k = L.dot(src, w("wk")).reshape(b, -1, hq, hd)
        v = (L.dot(src, w("wv")) + w("bv")).reshape(b, -1, hq, hd)
    q = q.reshape(b, s, hq, hd)
    if cache is not None:
        ck, cv, cpos = cache
        slot = min(pos_offset % ck.shape[1], ck.shape[1] - s)
        ck[:, slot:slot + s] = k
        cv[:, slot:slot + s] = v
        cpos[:, slot:slot + s] = (pos_offset + torch.arange(
            s, dtype=torch.int32, device=x.device))[None]
        if s == 1:
            out = L.attention(q, ck, cv, causal=True, q_offset=pos_offset,
                              kv_positions=cpos)
        else:
            out = L.attention(q, k, v, causal=True, q_offset=0)
    else:
        out = L.attention(q, k, v, causal=causal, q_offset=0)
    return L.dot(out.reshape(b, s, hq * hd), w("wo")) + w("bo")


def _enc_layer(h, lp, cfg: ModelConfig):
    h = h + _mha(L.layer_norm(h, lp.ln1_g, lp.ln1_b), lp, cfg, causal=False)
    return h + L.gelu_mlp(L.layer_norm(h, lp.ln2_g, lp.ln2_b),
                          lp.w1, lp.b1, lp.w2, lp.b2)


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, F, D), the stubbed frontend's output -> the encoder's
    memory (B, F, D) in the activation dtype."""
    adt = CLM.act_dtype(cfg)
    x = frames.to(adt) + CLM._top(params, "pos_enc")[None].to(adt)
    remat = remat and torch.is_grad_enabled()
    for lp in _stack(params, "enc", cfg.encoder_layers):
        if remat:
            x = checkpoint(functools.partial(_enc_layer, lp=lp, cfg=cfg), x,
                           use_reentrant=False)
        else:
            x = _enc_layer(x, lp, cfg)
    return L.layer_norm(x, CLM._top(params, "enc_norm_g"),
                        CLM._top(params, "enc_norm_b"))


def _dec_layer(h, lp, cfg: ModelConfig, memory, lc=None, pos_offset=0):
    self_cache = None if lc is None else (lc.k, lc.v, lc.pos)
    h = h + _mha(L.layer_norm(h, lp.ln1_g, lp.ln1_b), lp, cfg,
                 cache=self_cache, pos_offset=pos_offset)
    kv = (memory,) if lc is None else (memory, lc.xk, lc.xv)
    h = h + _mha(L.layer_norm(h, lp.lnx_g, lp.lnx_b), lp, cfg, prefix="x_",
                 kv=kv, causal=False)
    return h + L.gelu_mlp(L.layer_norm(h, lp.ln2_g, lp.ln2_b),
                          lp.w1, lp.b1, lp.w2, lp.b2)


def decode(params, tokens: torch.Tensor, memory: Optional[torch.Tensor],
           cfg: ModelConfig, cache: Optional[WhisperCache] = None,
           pos_offset: int = 0, remat: bool = False):
    """The decoder on ``tokens`` (B, S) at positions ``pos_offset +
    arange(S)``: (final-normed hidden (B, S, D), the cache, written in
    place, or None).  A decode step's ``memory`` is None: it reads the
    cross K/V from the cache."""
    b, s = tokens.shape
    adt = CLM.act_dtype(cfg)
    pos_ids = pos_offset + torch.arange(s, device=tokens.device)
    x = (CLM._top(params, "embed")[tokens.long()].to(adt)
         + CLM._top(params, "pos_dec")[pos_ids].to(adt)[None])
    remat = remat and cache is None and torch.is_grad_enabled()
    for j, lp in enumerate(_stack(params, "dec", cfg.num_layers)):
        if remat:
            x = checkpoint(functools.partial(_dec_layer, lp=lp, cfg=cfg,
                                             memory=memory), x,
                           use_reentrant=False)
            continue
        lc = None if cache is None else WhisperCache(*[a[j] for a in cache])
        x = _dec_layer(x, lp, cfg, memory, lc, pos_offset)
    x = L.layer_norm(x, CLM._top(params, "final_g"),
                     CLM._top(params, "final_b"))
    return x, cache


def _cache_self(cfg: ModelConfig, batch: int, max_len: int, device):
    shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.hd)
    adt = CLM.act_dtype(cfg)
    return (torch.zeros(shape, dtype=adt, device=device),
            torch.zeros(shape, dtype=adt, device=device),
            torch.full(shape[:3], 10 ** 9, dtype=torch.int32, device=device))


def init_cache(params, memory: torch.Tensor, cfg: ModelConfig,
               max_len: int) -> WhisperCache:
    """An empty self-attention cache and the cross K/V of ``memory`` (B,
    F, D), layer by layer, in the activation dtype."""
    b, f, _ = memory.shape
    hq, hd = cfg.num_heads, cfg.hd
    adt = CLM.act_dtype(cfg)
    xk = torch.empty((cfg.num_layers, b, f, hq, hd), dtype=adt,
                     device=memory.device)
    xv = torch.empty_like(xk)
    for j, lp in enumerate(_stack(params, "dec", cfg.num_layers)):
        xk[j] = L.dot(memory, lp.x_wk).reshape(b, f, hq, hd)
        xv[j] = (L.dot(memory, lp.x_wv) + lp.x_bv).reshape(b, f, hq, hd)
    return WhisperCache(*_cache_self(cfg, b, max_len, memory.device), xk, xv)


def empty_cache(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> WhisperCache:
    """``model.init_cache``'s form: zero placeholders for the cross K/V,
    shaped by ``encoder_frames``."""
    k, v, pos = _cache_self(cfg, batch, max_len, device)
    shape = (cfg.num_layers, batch, cfg.encoder_frames, cfg.num_heads,
             cfg.hd)
    return WhisperCache(k, v, pos,
                        torch.zeros(shape, dtype=k.dtype, device=device),
                        torch.zeros(shape, dtype=k.dtype, device=device))


def loss_fn(params, batch, cfg: ModelConfig, remat: bool = True
            ) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder on ``tokens`` given
    the encoder's memory of ``frames``."""
    memory = encode(params, batch["frames"], cfg, remat=remat)
    hidden, _ = decode(params, batch["tokens"], memory, cfg, remat=remat)
    return CLM.xent_loss(params, hidden, batch["labels"], cfg.padded_vocab)

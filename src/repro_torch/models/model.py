"""Model facade (``repro/models/model.py``) for the seven families.

Builds the model of a config, sizes it without allocating, and gives
the serving entry points (``prefill``, ``decode_step``, ``init_cache``)
and training's ``loss_fn``, each dispatching on ``cfg.family ==
"encdec"`` (``models.whisper``) as the reference's does; every other
family is ``models.causal_lm``.  For serving "params" is the model's
module (``CausalLM`` or ``Whisper``); ``init_tree`` gives the same
tensors as the reference's stacked tree, which training differentiates.
``abstract_params`` / ``abstract_cache`` give meta-device trees (nothing
allocated, at any size), ``param_specs`` the parameters' shardings on a
mesh and ``cache_logical_axes`` a cache's logical axes.  The dry run's
``input_specs`` (ROADMAP Queue 1 item 6) is not ported.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import causal_lm as CLM
from repro_torch.models import params as PRM
from repro_torch.models import whisper as WSP


def param_table(cfg: ModelConfig):
    if cfg.family == "encdec":
        return WSP.param_table(cfg)
    return CLM.param_table(cfg)


def build(cfg: ModelConfig, tree: dict):
    """The model's module holding a parameter tree."""
    if cfg.family == "encdec":
        return WSP.Whisper(cfg, tree)
    return CLM.CausalLM(cfg, tree)


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """A randomly initialized model on ``generator``'s device."""
    return build(cfg, PRM.init_params(param_table(cfg), generator))


def init_tree(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters as the reference's stacked tree, on
    ``generator``'s device (``build(cfg, tree)`` serves them)."""
    return PRM.init_params(param_table(cfg), generator)


def abstract_params(cfg: ModelConfig):
    """The parameter tree as meta-device tensors (no allocation)."""
    return PRM.abstract_params(param_table(cfg))


def param_specs(cfg: ModelConfig, mesh=None):
    return PRM.param_specs(param_table(cfg), mesh)


def count_params(cfg: ModelConfig) -> int:
    return PRM.count(param_table(cfg))


def active_params(cfg: ModelConfig) -> int:
    """Per-token active parameters (MoE: only the routed-in experts
    count), as the reference counts them."""
    total = count_params(cfg)
    if cfg.num_experts:
        ff = cfg.moe_d_ff or cfg.d_ff
        per_expert = 3 * cfg.d_model * ff
        moe_layers = cfg.num_layers - (1 if cfg.dense_first_layer else 0)
        inactive = ((cfg.num_experts - cfg.experts_per_token) * per_expert
                    * moe_layers)
        return total - inactive
    return total


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of a batch (encdec: given the
    encoder's memory of its ``frames``); ``params`` a tree or a model."""
    CLM.check_family(cfg)
    if cfg.family == "encdec":
        return WSP.loss_fn(params, batch, cfg, remat=remat)
    return CLM.loss_fn(params, batch, cfg, remat=remat)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: int):
    """(last-token logits, cache) of ``batch["tokens"]``; a batch's
    ``mrope_positions`` are not read (the reference's prefill reads
    none).  encdec encodes the batch's ``frames`` and makes the cross
    K/V from the memory (``whisper.init_cache``); a batch without them
    raises ``KeyError``, as the reference's does."""
    if cfg.family == "encdec":
        if "frames" not in batch:
            raise KeyError(f"frames: {cfg.name}'s prefill encodes the "
                           "batch's frames (B, encoder_frames, d_model), "
                           "and this batch has none")
        memory = WSP.encode(params, batch["frames"], cfg)
        cache = WSP.init_cache(params, memory, cfg, max_len)
        hidden, cache = WSP.decode(params, batch["tokens"], memory, cfg,
                                   cache)
        return CLM.logits_fn(params, hidden[:, -1:])[:, 0], cache
    return CLM.prefill(params, batch["tokens"], cfg, max_len)


def decode_step(params, cache, token: torch.Tensor, pos, cfg: ModelConfig,
                mrope_positions=None):
    """token: (B, 1); pos: the token's position (the hybrid family's meta
    tokens come on top of it; encdec's decoder has none);
    ``mrope_positions`` (3, B, 1) for the vlm family."""
    if cfg.family == "encdec":
        hidden, cache = WSP.decode(params, token, None, cfg, cache,
                                   pos_offset=int(pos))
        return CLM.logits_fn(params, hidden)[:, 0], cache
    return CLM.decode_step(params, cache, token, pos, cfg,
                           mrope_positions=mrope_positions)


def init_cache(cfg: ModelConfig, params, batch: int, max_len: int):
    """The cache tree on ``params``' device (encdec: zero placeholders
    for the cross K/V, as the reference's)."""
    if cfg.family == "encdec":
        return WSP.empty_cache(cfg, batch, max_len, device=params.device)
    return CLM.init_cache(cfg, batch, max_len, device=params.device)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    """``init_cache``'s tree as meta-device tensors (no allocation)."""
    if cfg.family == "encdec":
        return WSP.empty_cache(cfg, batch, max_len, device="meta")
    return CLM.init_cache(cfg, batch, max_len, device="meta")


def cache_logical_axes(cfg: ModelConfig, cache):
    """Logical axes of a cache's tensors; whisper's 5-D K/V leaves shard
    their heads on ``model``, its 3-D positions only their batch."""
    if cfg.family == "encdec":
        def axes_for(x):
            if x.dim() == 5:
                return ("layers", "batch", None, "model", None)
            return ("layers", "batch", None)
        return PRM.tree_unflatten(cache, [axes_for(x) for x in
                                          PRM.tree_leaves(cache)])
    return CLM.cache_logical_axes(cfg, cache)

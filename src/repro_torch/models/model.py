"""Model facade (``repro/models/model.py``) for the ported families.

Builds the model of a config, sizes it without allocating, and gives
the serving entry points (``prefill``, ``decode_step``, ``init_cache``)
and training's ``loss_fn``.  For serving "params" is the
``causal_lm.CausalLM`` module; ``init_tree`` gives the same tensors as
the reference's stacked tree, which training differentiates.  The
dense, moe, mla_moe, vlm and ssm families are built; hybrid and whisper
(``encdec``) raise ``NotImplementedError`` (ROADMAP Queue 1 items 4-5);
the dry-run's ``input_specs`` / ``abstract_*`` and the mesh's
``param_specs`` / ``cache_logical_axes`` are not ported yet (items 6
and 7).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import causal_lm as CLM
from repro_torch.models import params as PRM


def param_table(cfg: ModelConfig):
    return CLM.param_table(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> CLM.CausalLM:
    """A randomly initialized model on ``generator``'s device."""
    return CLM.CausalLM(cfg, PRM.init_params(param_table(cfg), generator))


def init_tree(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters as the reference's stacked tree, on
    ``generator``'s device (``CLM.CausalLM(cfg, tree)`` serves them)."""
    return PRM.init_params(param_table(cfg), generator)


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
    """Mean next-token cross-entropy of a batch; ``params`` a tree or a
    ``CausalLM`` (raises for the families not ported)."""
    CLM.check_family(cfg)
    return CLM.loss_fn(params, batch, cfg, remat=remat)


def prefill(params: CLM.CausalLM, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, max_len: int):
    """(last-token logits, cache) of ``batch["tokens"]``; a batch's
    ``mrope_positions`` are not read (the reference's prefill reads
    none)."""
    return CLM.prefill(params, batch["tokens"], cfg, max_len)


def decode_step(params: CLM.CausalLM, cache, token: torch.Tensor, pos,
                cfg: ModelConfig, mrope_positions=None):
    """token: (B, 1); pos: the current absolute position;
    ``mrope_positions`` (3, B, 1) for the vlm family."""
    return CLM.decode_step(params, cache, token, pos, cfg,
                           mrope_positions=mrope_positions)


def init_cache(cfg: ModelConfig, params: CLM.CausalLM, batch: int,
               max_len: int):
    """The cache tree on ``params``' device."""
    return CLM.init_cache(cfg, batch, max_len, device=params.device)

"""One training step: microbatched gradient accumulation, optional
error-feedback gradient compression (paper-gated), AdamW
(``repro/train/train_step.py``, its ``pjit`` mode on one device).

The gradients are taken with ``torch.autograd.grad`` per microbatch, of
the reference's stacked parameter leaves (``models.causal_lm``).  With
``microbatches > 1`` each microbatch's gradient (in the parameters'
dtype) is added, cast to float32, to a float32 zero tree in order, and
so is its loss to a float32 zero; the sums are then multiplied by
``f32(1 / m)`` (the reference's scan, then ``* inv``).  Autograd never
accumulates into a bfloat16 ``.grad``.

``make_train_step(..., donate=True)`` updates the state's tensors in
place (the port's form of donating the state to a jitted step: at
granite-3-2b's full width a second copy of the parameters and moments
would not fit the card); by default the step returns new tensors and
leaves its input state as it was.

Training across cards (the ``podsync`` mode with ``stack_for_podsync``,
a ``mesh``) is not ported: ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.train import grad_compress as GC
from repro_torch.train import optimizer as OPT

ACROSS_CARDS = ("training across cards (podsync mode, stack_for_podsync, "
                "a mesh) is not ported: ROADMAP Queue 1 item 7")


class TrainState(NamedTuple):
    params: Any
    opt: OPT.OptState
    ef: Optional[GC.EFState]


def init_state(cfg: ModelConfig, generator: torch.Generator,
               compress: bool = False) -> TrainState:
    """Random parameters (the reference's rules, ``generator``'s draws,
    on its device), zero moments and, with ``compress``, zero residuals."""
    params = M.init_tree(cfg, generator)
    opt = OPT.init(params)
    ef = GC.init_ef(params) if compress else None
    return TrainState(params, opt, ef)


def stack_for_podsync(state: TrainState, n_pods: int) -> TrainState:
    raise NotImplementedError(ACROSS_CARDS)


def _microbatch(batch: Dict[str, torch.Tensor], m: int
                ) -> Dict[str, torch.Tensor]:
    """Each (B, ...) input as (m, B/m, ...); ``mrope_positions`` (3, B, S)
    as (m, 3, B/m, S)."""
    def rs(x):
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} does not split into {m} microbatches")
        return x.reshape(m, b // m, *x.shape[1:])
    out = {}
    for k, v in batch.items():
        if k == "mrope_positions":
            out[k] = torch.movedim(rs(torch.movedim(v, 0, 1)), 2, 1)
        else:
            out[k] = rs(v)
    return out


def _value_and_grad(cfg: ModelConfig, leaves, params, batch, remat: bool):
    ps = [p.detach().requires_grad_(True) for p in leaves]
    loss = M.loss_fn(tree_unflatten(params, ps), batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, ps)
    return loss.detach(), list(grads)


def _grads(cfg: ModelConfig, params, batch, microbatches: int,
           remat: bool = True):
    """(loss, grads tree): the parameters' dtype for one microbatch,
    float32 sums times ``f32(1/m)`` for several."""
    leaves = tree_leaves(params)
    if microbatches <= 1:
        loss, grads = _value_and_grad(cfg, leaves, params, batch, remat)
        return loss, tree_unflatten(params, grads)
    mbs = _microbatch(batch, microbatches)
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]
    lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(microbatches):
        loss, grads = _value_and_grad(
            cfg, leaves, params, {k: v[i] for k, v in mbs.items()}, remat)
        for acc, g in zip(gsum, grads):
            acc.add_(g)
        del grads
        lsum = lsum + loss
    inv = torch.tensor(float(np.float32(1.0 / microbatches)),
                       dtype=torch.float32)
    return lsum * inv, tree_unflatten(params, [g.mul_(inv) for g in gsum])


def make_train_step(
    cfg: ModelConfig,
    ocfg: OPT.AdamWConfig = OPT.AdamWConfig(),
    microbatches: int = 1,
    compress: Optional[GC.CompressConfig] = None,
    mode: str = "pjit",
    mesh=None,
    param_specs=None,
    *,
    donate: bool = False,
    remat: bool = True,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    are 0-dim tensors: ``loss``, ``grad_norm`` and, when compressing,
    ``mean_pred_cr``.  Only the single-device ``pjit`` mode is ported."""
    if mode != "pjit" or mesh is not None or param_specs is not None:
        raise NotImplementedError(ACROSS_CARDS)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, grads = _grads(cfg, state.params, batch, microbatches, remat)
        metrics = {"loss": loss}
        ef = state.ef
        if compress is not None and compress.enabled and ef is not None:
            grads, ef, crs = GC.compress_tree(grads, ef, compress,
                                              inplace=donate)
            metrics["mean_pred_cr"] = torch.mean(torch.stack(
                tree_leaves(crs)))
        params, opt, gnorm = OPT.apply(ocfg, state.params, grads, state.opt,
                                       inplace=donate)
        metrics["grad_norm"] = gnorm
        return TrainState(params, opt, ef), metrics

    return step

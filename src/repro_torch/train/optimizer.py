"""AdamW with float32 moments (``repro/train/optimizer.py``).

No optimizer library: the update is a function of parameter trees (the
reference's stacked leaves, in ``jax.tree.flatten``'s order), so the
moments have the parameters' shapes and devices.

Bits: the elementwise update is the reference's jitted form, read off
XLA's optimized IR and object code on the CPU.  XLA rewrites
``(m / b1c) / (sqrt(v / b2c) + eps)`` into ``m / (b1c * (sqrt(v / b2c)
+ eps))`` and contracts three multiply-adds into FMAs::

    m' = fma(m, b1, (g * scale) * (1 - b1))
    v' = fma(v, b2, ((g * scale) * (1 - b2)) * (g * scale))
    d  = fma(p, wd, m' / (b1c * (sqrt(v' / b2c) + eps)))
    p' = fma(-lr, d, p)

Each FMA here is exactly rounded (``fma32``: float64 and a tie fix, on
the CPU and the card), and so is the square root (taken in float64:
the CPU's vectorized float32 ``torch.sqrt`` is not); the leaves go through in chunks of
``CHUNK`` elements, so the float64 temporaries stay small at any leaf
size.  The step's scalars are computed on the host in float32, as XLA
computes them: ``lr = min(step * f32(1 / warmup), 1) * lr``, the bias
corrections ``1 - powf(b, step)`` (``refmath.powf``); so
``OptState.step`` is a 0-dim int32 tensor on the host.  They reach the
card as 0-dim tensors: a division by a host scalar would be a product
by its reciprocal there.  The global norm is a float32 reduction whose
order is the library's (a tolerance, not bits); with the clip inactive
(norm <= ``grad_clip``) the scale is exactly 1 and the update is the
reference's bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import refmath
from repro_torch.kernels.quality.ref import fma32
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.quant import spans

CHUNK = 1 << 24     # elements of a leaf updated at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    step: torch.Tensor      # 0-dim int32, on the host
    mu: Any                 # float32 first moments  (param tree)
    nu: Any                 # float32 second moments (param tree)


def _zeros(params):
    return tree_unflatten(params, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in tree_leaves(params)])


def init(params) -> OptState:
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    mu=_zeros(params), nu=_zeros(params))


def _schedule(cfg: AdamWConfig, step: int) -> np.float32:
    """``lr * min(step / warmup, 1)`` in float32, the division as XLA's
    product by ``f32(1 / warmup)``."""
    inv = np.float32(1.0) / np.float32(max(cfg.warmup_steps, 1))
    warm = min(np.float32(step) * inv, np.float32(1.0))
    return np.float32(cfg.lr) * warm


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    parts = [torch.sum(torch.square(flat[lo:hi].to(torch.float32)))
             for lo, hi in spans(flat.numel(), CHUNK)]
    return parts[0] if len(parts) == 1 else torch.sum(torch.stack(parts))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' float32 squared sums, taken leaf by
    leaf in tree order (a 0-dim float32 tensor on the leaves' device)."""
    leaves = [_sum_squares(x) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _update_leaf(p, g, m, v, k: dict, inplace: bool):
    """One leaf's AdamW update, chunk by chunk; returns (p', m', v')."""
    if inplace:
        if not all(t.is_contiguous() for t in (p, m, v)):
            raise ValueError("an in-place update needs contiguous leaves")
        new_p, new_m, new_v = p, m, v
    else:
        new_p, new_m, new_v = (torch.empty_like(p), torch.empty_like(m),
                               torch.empty_like(v))
    fp, fg, fm, fv = (t.reshape(-1) for t in (p, g, m, v))
    op, om, ov = (t.reshape(-1) for t in (new_p, new_m, new_v))
    for lo, hi in spans(fp.numel(), CHUNK):
        gs = fg[lo:hi].to(torch.float32) * k["scale"]
        mm = fma32(fm[lo:hi], k["b1"], gs * k["c1"])
        vv = fma32(fv[lo:hi], k["b2"], (gs * k["c2"]) * gs)
        root = torch.sqrt((vv / k["b2c"]).to(torch.float64)).to(torch.float32)
        den = k["b1c"] * (root + k["eps"])
        p32 = fp[lo:hi].to(torch.float32)
        delta = fma32(p32, k["wd"], mm / den)
        op[lo:hi] = fma32(delta, k["neg_lr"], p32).to(p.dtype)
        om[lo:hi] = mm
        ov[lo:hi] = vv
    return new_p, new_m, new_v


def apply(cfg: AdamWConfig, params, grads, state: OptState,
          inplace: bool = False) -> Tuple[Any, OptState, torch.Tensor]:
    """One AdamW step; returns (new_params, new_state, grad_norm).  With
    ``inplace`` the new values overwrite ``params`` and the moments (the
    port's form of donating them to a jitted step); otherwise they are
    new tensors and the inputs stay as they were."""
    gnorm = global_norm(grads)
    dev = gnorm.device

    def dev_f32(x) -> torch.Tensor:
        return torch.tensor(float(x), dtype=torch.float32, device=dev)

    scale = torch.clamp(dev_f32(cfg.grad_clip)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = int(state.step) + 1
    b1c = np.float32(1.0) - refmath.powf(cfg.b1, step)
    b2c = np.float32(1.0) - refmath.powf(cfg.b2, step)
    k = {"scale": scale, "b1": dev_f32(np.float32(cfg.b1)),
         "c1": dev_f32(np.float32(1 - cfg.b1)),
         "b2": dev_f32(np.float32(cfg.b2)),
         "c2": dev_f32(np.float32(1 - cfg.b2)),
         "b1c": dev_f32(b1c), "b2c": dev_f32(b2c),
         "eps": dev_f32(np.float32(cfg.eps)),
         "wd": dev_f32(np.float32(cfg.weight_decay)),
         "neg_lr": dev_f32(-_schedule(cfg, step))}
    out = [_update_leaf(p, g, m, v, k, inplace) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
        tree_leaves(state.nu))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return (new_p, OptState(torch.tensor(step, dtype=torch.int32), new_m,
                            new_v), gnorm)

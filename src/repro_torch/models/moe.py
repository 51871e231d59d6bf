"""GShard-style token-dropping MoE (``repro/models/moe.py``).

Tokens go in groups of ``GROUP_SIZE`` (or all of them, when fewer); each
token picks ``top_k`` experts from the softmax of its router logits,
and each expert takes at most ``capacity`` (token, choice) pairs of a
group, in priority order: the pairs in token order, a token's choices
in rank order (the reference's cumsum over its (G, T k, E) one-hots).
A pair past its expert's capacity is dropped.  Shared experts (always
on) are added to the routed output.  Dropping depends on the group, so
a token's output depends on the other tokens of its group: that is the
model's semantics.

The reference builds dense (G, T, E, C) one-hots; here the same
decisions become indices:

* routing (:func:`route`) is integers, the same as the reference's given
  the same logits: top-k by a stable descending sort, so that of equal
  probabilities the lower expert index comes first, as
  ``jax.lax.top_k`` orders them (``torch.topk`` promises no order);
  the queue positions are an integer cumsum of the one-hots;
* dispatch copies each kept token into its (expert, group, slot) row:
  each entry of the reference's dispatch einsum is a sum with exactly
  one nonzero product, ``x * 1``, so the copy is the same values;
* the expert products are ``torch.matmul`` of (E, G C, D) stacks;
* combine gathers each kept pair's expert output and adds the ``k``
  products ``w * y`` (``w`` rounded to the activation dtype, as the
  reference's combine tensor holds it) in float32, rounded once: the
  reference's einsum over (E, C) has the same ``k`` nonzero products,
  exact in float32 for bfloat16 operands, accumulated in float32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import refmath
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef

GROUP_SIZE = 4096  # tokens per dispatch group


def moe_param_table(layers: int, d_model: int, d_ff: int, num_experts: int,
                    num_shared: int, shared_d_ff: int = 0):
    """The reference's table: a float32 router, (E, D, F) / (E, F, D)
    expert stacks and, with ``num_shared``, the shared experts' SwiGLU."""
    t = {
        "router": ParamDef((layers, d_model, num_experts),
                           ("layers", "fsdp", None), dtype=torch.float32),
        "wg": ParamDef((layers, num_experts, d_model, d_ff),
                       ("layers", "model", "fsdp", None)),
        "wu": ParamDef((layers, num_experts, d_model, d_ff),
                       ("layers", "model", "fsdp", None)),
        "wd": ParamDef((layers, num_experts, d_ff, d_model),
                       ("layers", "model", None, "fsdp")),
    }
    if num_shared:
        sff = shared_d_ff or d_ff * num_shared
        t["shared_wg"] = ParamDef((layers, d_model, sff),
                                  ("layers", "fsdp", "model"))
        t["shared_wu"] = ParamDef((layers, d_model, sff),
                                  ("layers", "fsdp", "model"))
        t["shared_wd"] = ParamDef((layers, sff, d_model),
                                  ("layers", "model", "fsdp"))
    return t


def _top_k_gating(logits: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (G, T, E) -> (weights (G, T, k) float32, indices (G, T, k)
    int64): the float32 softmax's ``k`` largest probabilities, ties to
    the lower expert index, normalized by their sum (at least 1e-9;
    the sum in XLA's order)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True
                     ).indices[..., :k]
    w = torch.gather(probs, -1, idx)
    total = refmath.sum_rows_f32(w)[..., None]
    return w / torch.clamp(total, min=1e-9), idx


def capacity_of(g_size: int, top_k: int, num_experts: int,
                capacity_factor: float) -> int:
    """Pairs an expert takes per group: the reference's Python-float
    ``int(max(k, g k / E cf))``, at most the group size."""
    capacity = int(max(top_k, g_size * top_k / num_experts * capacity_factor))
    return min(capacity, g_size)


def queue_positions(idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """idx (G, T, k) -> (G, T, k, E): how many earlier pairs of the group
    chose each expert, the reference's ``cumsum(onehot) - onehot`` over
    the pairs in token order, a token's choices in rank order (its
    ``within_cap`` is this ``< capacity``)."""
    g, t, k = idx.shape
    onehot = F.one_hot(idx, num_experts).reshape(g, t * k, num_experts)
    return (torch.cumsum(onehot, dim=1) - onehot).reshape(g, t, k,
                                                          num_experts)


def route(logits: torch.Tensor, top_k: int, capacity: int):
    """The routing of a group stack, all of it integers but the weights:
    (weights (G, T, k) float32, idx (G, T, k), pos (G, T, k) the pair's
    queue position at its chosen expert, keep (G, T, k) bool: the pair
    is within its expert's capacity)."""
    weights, idx = _top_k_gating(logits, top_k)
    pos = torch.gather(queue_positions(idx, logits.shape[-1]), -1,
                       idx[..., None])[..., 0]
    return weights, idx, pos, pos < capacity


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def moe_ffn(x: torch.Tensor, p, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25,
            group_size: int = GROUP_SIZE) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  ``p`` holds this layer's ``router``,
    ``wg``, ``wu``, ``wd`` (and ``shared_*``) as attributes."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    t_total = tokens.shape[0]
    g_size = min(group_size, t_total)
    if t_total % g_size:
        raise ValueError(f"{t_total} tokens do not split into groups of "
                         f"{g_size}")
    g = t_total // g_size
    xt = tokens.reshape(g, g_size, d)

    logits = L.dot(xt, p.router.to(xt.dtype))                  # (G, T, E)
    capacity = capacity_of(g_size, top_k, num_experts, capacity_factor)
    weights, idx, pos, keep = route(logits, top_k, capacity)

    # dispatch: each kept pair's token into row (e, g, pos) of the expert
    # buffers; dropped pairs go to a spare last row, never read
    rows = num_experts * g * capacity
    gid = torch.arange(g, device=x.device)[:, None, None]
    slot = (idx * g + gid) * capacity + pos
    slot = torch.where(keep, slot, torch.full_like(slot, rows))
    src = xt[:, :, None, :].expand(g, g_size, top_k, d).reshape(-1, d)
    buf = torch.zeros((rows + 1, d), dtype=xt.dtype, device=x.device)
    buf = buf.index_copy(0, slot.reshape(-1), src)
    ex_in = buf[:rows].reshape(num_experts, g * capacity, d)

    h = F.silu(_bmm(ex_in, p.wg).to(torch.float32)).to(xt.dtype)
    h = h * _bmm(ex_in, p.wu)
    ex_out = _bmm(h, p.wd)                                    # (E, G C, D)

    # combine: the k weighted expert outputs of each token, in float32
    flat_out = torch.cat([ex_out.reshape(rows, -1),
                          ex_out.new_zeros((1, ex_out.shape[-1]))])
    picked = flat_out[slot.reshape(-1)].reshape(g, g_size, top_k, -1)
    w = torch.where(keep, weights.to(xt.dtype).to(torch.float32),
                    torch.zeros_like(weights))
    y = torch.sum(picked.to(torch.float32) * w[..., None], dim=2)
    y = y.to(torch.promote_types(xt.dtype, ex_out.dtype))

    if hasattr(p, "shared_wg"):
        y = y + L.swiglu(xt, p.shared_wg, p.shared_wu, p.shared_wd)
    return y.reshape(b, s, d)


def aux_load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss (fraction * probability per expert).
    Nothing in the model's loss calls it, as in the reference."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    lead = tuple(range(idx.ndim - 1))
    frac = torch.mean(F.one_hot(idx[..., 0], num_experts).to(torch.float32),
                      dim=lead)
    pmean = torch.mean(probs, dim=tuple(range(probs.ndim - 1)))
    return num_experts * torch.sum(frac * pmean)

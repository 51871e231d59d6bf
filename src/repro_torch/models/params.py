"""Declarative parameter tables.

A model declares its parameters once as a nested dict of ``ParamDef``
(stacked over layers, as the reference's scans take them);
``init_params`` materializes a table and ``count`` sizes it without
allocating; ``logical_axes`` gives the tree of logical axis names,
``abstract_params`` the tree of meta-device tensors of each def's shape
and dtype (nothing allocated, even at deepseek-v2-236b) and
``param_specs`` the tree of ``dist.sharding.NamedSharding``s on a mesh.  ``tree_flatten`` / ``tree_unflatten`` walk a nested
container in ``jax.tree.flatten``'s order (dict keys sorted; tuples,
NamedTuples and lists in order; ``None`` holds no leaf), which the
engine's KV gate scores and meters leaves in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]        # logical axis names
    init: str = "normal"                   # normal | zeros | ones | embed
    scale: float = 1.0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamDef shape {self.shape} has "
                             f"{len(self.shape)} dims, axes {self.axes}")


def tree_flatten(tree, is_leaf=None) -> List[Tuple[str, Any]]:
    """(dotted path, leaf) pairs in ``jax.tree.flatten``'s order."""
    out: List[Tuple[str, Any]] = []

    def walk(t, path):
        if is_leaf is not None and is_leaf(t):
            out.append((path, t))
        elif t is None:
            return
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}.{k}" if path else str(k))
        elif isinstance(t, (tuple, list)):
            names = getattr(t, "_fields", range(len(t)))
            for k, x in zip(names, t):
                walk(x, f"{path}.{k}" if path else str(k))
        else:
            out.append((path, t))

    walk(tree, "")
    return out


def tree_leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in tree_flatten(tree, is_leaf)]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(x) for x in t])
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def _is_def(x) -> bool:
    return isinstance(x, ParamDef)


SLICED_DRAW_VALUES = 1 << 30    # a larger leaf draws a slice at a time


def init_params(table, generator: torch.Generator) -> dict:
    """The table's tensors on ``generator``'s device: ``zeros``, ``ones``,
    else a float32 normal draw times ``scale / sqrt(fan_in)`` with
    ``fan_in = shape[-2]`` (``shape[-1]`` for a vector), cast to the
    def's dtype -- the reference's rules, not its PRNG's bits.  Leaves
    draw in flatten order from the one generator, each in slices of its
    first axis of at most ``SLICED_DRAW_VALUES`` values (one slice but
    for stacked experts or MLPs, or a large vocabulary's embedding at
    full width), so the float32 draw never holds a whole large leaf."""
    device = generator.device

    def make(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / float(np.sqrt(max(fan_in, 1)))
        out = torch.empty(d.shape, dtype=d.dtype, device=device)
        rows = max(1, SLICED_DRAW_VALUES // max(1, int(np.prod(d.shape[1:]))))
        for part in out.split(rows):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32,
                                   device=device).mul_(std))
        return out

    return tree_unflatten(table, [make(d) for d in tree_leaves(table, _is_def)])


def count(table) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(table, _is_def))


def logical_axes(table):
    return tree_unflatten(table, [d.axes for d in tree_leaves(table, _is_def)])


def abstract_params(table):
    """Meta-device tensors of each def's shape and dtype."""
    return tree_unflatten(table, [
        torch.empty(d.shape, dtype=d.dtype, device="meta")
        for d in tree_leaves(table, _is_def)])


def param_specs(table, mesh=None):
    """Tree of ``NamedSharding``s for the whole parameter table."""
    from repro_torch.dist import sharding as S
    return tree_unflatten(table, [S.named_sharding(d.shape, d.axes, mesh)
                                  for d in tree_leaves(table, _is_def)])

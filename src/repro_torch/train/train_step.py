"""One training step: microbatched gradient accumulation, optional
error-feedback gradient compression (paper-gated), AdamW
(``repro/train/train_step.py``), on one device or across the processes
of a mesh's ``pod`` and ``data`` axes.

The gradients are taken with ``torch.autograd.grad`` per microbatch, of
the reference's stacked parameter leaves (``models.causal_lm``).  With
``microbatches > 1`` each microbatch's gradient (in the parameters'
dtype) is added, cast to float32, to a float32 zero tree in order, and
so is its loss to a float32 zero; the sums are then multiplied by
``f32(1 / m)`` (the reference's scan, then ``* inv``).  Autograd never
accumulates into a bfloat16 ``.grad``.

Modes, as the reference's:

* ``"pjit"`` -- whole-array programming.  On one device, the step.  On
  a mesh (``mesh=``, or the active ``dist.sharding.use_mesh`` training
  mesh) whose ``data`` extent is D > 1, each process runs the step on
  its contiguous block of the batch's rows (its ``data`` coordinate's
  block of D; the microbatches inside it); the loss and the gradients
  are averaged across the ``data`` ranks in rank order
  (``dist.collectives.pmean``), so every rank applies the same update
  and holds the whole state: one valid partition of the reference's
  whole-array program.  The ``pod`` axis, where there is one,
  replicates, as the rules map no logical axis of a batch to it.
* ``"podsync"`` -- one process per (pod, data) place; the state is
  pod-stacked (``stack_for_podsync``).  A pod takes its contiguous
  block of the batch's rows (as ``P("pod")`` splits it), its ``data``
  ranks split that as above, and the gradients are synced across pods
  explicitly: with error feedback, ``gf = g.f32 + r`` goes through the
  int8 collective (``dist.collectives``) and the new residual is ``gf``
  minus the rank's own dequantized contribution; compressed without
  error feedback; or a plain ``pmean``.  Then AdamW on each pod, from
  the same synced gradients, so every rank ends a step with the same
  parameters and moments; the residuals are pod-local.

A mesh whose ``model`` extent is above 1 (tensor-parallel layers, the
``fsdp`` layout of the state) raises ``NotImplementedError``
(``ACROSS_CARDS``): ROADMAP Queue 1 item 7's model-axis half, the next
slice.

``make_train_step(..., donate=True)`` updates the state's tensors in
place (the port's form of donating the state to a jitted step: at
granite-3-2b's full width a second copy of the parameters and moments
would not fit the card); by default the step returns new tensors and
leaves its input state as it was.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as COL
from repro_torch.dist import sharding as S
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.train import grad_compress as GC
from repro_torch.train import optimizer as OPT

ACROSS_CARDS = ("a mesh whose 'model' axis is above 1 (tensor-parallel "
                "layers, the fsdp layout of the training state) is not "
                "ported: ROADMAP Queue 1 item 7's model-axis half, the next "
                "slice")


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


def _map(tree, fn):
    return None if tree is None else tree_unflatten(
        tree, [fn(a) for a in tree_leaves(tree)])


def stack_for_podsync(state: TrainState, n_pods: int) -> TrainState:
    """The podsync layout: every param / moment / residual leaf gains a
    leading pod axis.  Each process holds its own pod's slice of the
    reference's (n_pods, ...) stack, the local (1, ...) view of its
    leaf, so per-device memory equals plain pod-replication."""
    if int(n_pods) < 1:
        raise ValueError(f"stack_for_podsync: {n_pods} pods")

    def st(t):
        return _map(t, lambda a: a[None])
    return TrainState(
        st(state.params), OPT.OptState(state.opt.step, st(state.opt.mu),
                                       st(state.opt.nu)),
        GC.EFState(st(state.ef.residuals)) if state.ef is not None else None)


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


def _rows(batch: Dict[str, torch.Tensor], parts: int, i: int
          ) -> Dict[str, torch.Tensor]:
    """Block ``i`` of ``parts`` contiguous row blocks of a batch
    (``mrope_positions`` (3, B, S) along B)."""
    if parts == 1:
        return batch
    out = {}
    for k, v in batch.items():
        ax = 1 if k == "mrope_positions" else 0
        b = v.shape[ax]
        if b % parts:
            raise ValueError(f"batch {b} does not split into {parts} blocks")
        out[k] = v.narrow(ax, i * (b // parts), b // parts)
    return out


class _Axes(NamedTuple):
    """This process's place on a mesh's ``pod`` and ``data`` axes: their
    extents, its coordinates, and the groups along them (None at 1)."""
    pods: int = 1
    pod: int = 0
    pod_group: Any = None
    data: int = 1
    datum: int = 0
    data_group: Any = None


def _axis(mesh, sizes: dict, name: str) -> tuple:
    """(extent, this process's coordinate, group) of one mesh axis."""
    size = sizes.get(name, 1)
    if size == 1:
        return 1, 0, None
    if not hasattr(mesh, "get_group"):
        raise ValueError(f"a mesh whose {name!r} extent is {size} needs a "
                         "DeviceMesh over the process group: "
                         "repro_torch.launch.mesh.dist_init, then make_mesh")
    return size, mesh.get_local_rank(name), mesh.get_group(name)


def _mesh_axes(mesh) -> _Axes:
    if mesh is None:
        return _Axes()
    sizes = S.axis_sizes(mesh)
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(ACROSS_CARDS)
    return _Axes(*_axis(mesh, sizes, "pod"), *_axis(mesh, sizes, "data"))


def _dp_grads(cfg, params, batch, microbatches, remat, ax: _Axes):
    """(loss, grads) of this process's block of ``batch`` on the
    ``data`` axis, averaged across the ``data`` ranks in rank order."""
    loss, grads = _grads(cfg, params, _rows(batch, ax.data, ax.datum),
                         microbatches, remat)
    if ax.data > 1:
        loss = COL.pmean(loss, ax.data_group)
        grads = _map(grads, lambda g: COL.pmean(g, ax.data_group))
    return loss, grads


def _pod_sync(grads, ef, compress, group, donate: bool):
    """The synced gradients and the new residuals (or ``ef``) of
    podsync's three forms."""
    if compress is None or not compress.enabled:
        return _map(grads, lambda g: COL.pmean(g, group)), ef
    if ef is None:
        return _map(grads, lambda g: COL.compressed_pod_allreduce(g, group)), ef
    out_g, out_r = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(ef)):
        gf = (g.add_(r) if donate and g.dtype == torch.float32
              else g.to(torch.float32) + r)
        q, scale = COL.quantize_int8(gf)
        synced = COL.pod_mean(COL.all_gather(q, group),
                              COL.all_gather(scale, group))
        res = COL.residual(gf, q, scale)
        out_g.append(synced.to(g.dtype))
        out_r.append(r.copy_(res) if donate else res)
        del gf, q, synced, res
    return tree_unflatten(grads, out_g), tree_unflatten(ef, out_r)


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
    are 0-dim tensors: ``loss``, ``grad_norm`` and, when compressing in
    the ``pjit`` mode, ``mean_pred_cr``.  ``batch`` is the whole batch on
    every process; each takes its rows.  ``mesh`` (default: the active
    training mesh) shapes the processes; ``param_specs`` is accepted and
    unused, as each process holds the whole state."""
    if mode not in ("pjit", "podsync"):
        raise ValueError(f"unknown train step mode {mode!r}")
    if mesh is None:
        active = S.current_mesh()
        mesh = active if hasattr(active, "mesh_dim_names") else None
    ax = _mesh_axes(mesh)

    if mode == "pjit":
        def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
            loss, grads = _dp_grads(cfg, state.params, batch, microbatches,
                                    remat, ax)
            metrics = {"loss": loss}
            ef = state.ef
            if compress is not None and compress.enabled and ef is not None:
                grads, ef, crs = GC.compress_tree(grads, ef, compress,
                                                  inplace=donate)
                metrics["mean_pred_cr"] = torch.mean(torch.stack(
                    tree_leaves(crs)))
            params, opt, gnorm = OPT.apply(ocfg, state.params, grads,
                                           state.opt, inplace=donate)
            metrics["grad_norm"] = gnorm
            return TrainState(params, opt, ef), metrics
        return step

    if mesh is None or "pod" not in S.axis_sizes(mesh):
        raise ValueError("the podsync mode needs a mesh with a 'pod' axis")
    use_ef = compress is not None and compress.enabled

    def take(t):
        return _map(t, lambda a: a[0])

    def podsync_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        # the state must be pod-stacked up front: see stack_for_podsync()
        params, mu, nu = (take(state.params), take(state.opt.mu),
                          take(state.opt.nu))
        ef = (take(state.ef.residuals) if use_ef and state.ef is not None
              else None)
        loss, grads = _dp_grads(cfg, params, _rows(batch, ax.pods, ax.pod),
                                microbatches, remat, ax)
        metrics = {"loss": COL.pmean(loss, ax.pod_group)}
        grads, ef = _pod_sync(grads, ef, compress, ax.pod_group, donate)
        params, opt, gnorm = OPT.apply(
            ocfg, params, grads, OPT.OptState(state.opt.step, mu, nu),
            inplace=donate)
        metrics["grad_norm"] = COL.pmean(gnorm, ax.pod_group)

        def put(new, old):
            return old if donate else _map(new, lambda a: a[None])
        new_ef = state.ef
        if ef is not None:
            new_ef = GC.EFState(put(ef, state.ef.residuals))
        return TrainState(put(params, state.params),
                          OPT.OptState(opt.step, put(opt.mu, state.opt.mu),
                                       put(opt.nu, state.opt.nu)),
                          new_ef), metrics

    return podsync_step

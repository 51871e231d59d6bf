"""Carry a fitted model, or a language model's weights, across from the
reference package.

A fitted reference model is exported as plain numpy arrays and Python
values (this package never imports the reference, so the export is the
caller's); these functions rebuild the port's objects from them.  An LM's
parameters, KV cache and training state come as the reference's trees
with numpy leaves (``jax.tree.map(np.asarray, params)``): ``lm_params``
(a serving model), ``lm_tree`` (the stacked tree training
differentiates), ``lm_cache``, ``train_state`` and ``podsync_state``
(one pod's slice of the reference's pod-stacked state).  The other way,
``numpy_tree`` turns the port's trees -- plain tensors or
``dist.fault.remesh_state``'s DTensors (through ``full_tensor()``) --
into numpy leaves the reference takes.

The state of one CR model::

    {"kind": "spline", "mean": (2,), "std": (2,), "knots1": (K,),
     "knots2": (K,), "coef": (p,), "eps": float, "ndim": 2}
    {"kind": "linear", "mean": (2,), "std": (2,), "coef": (4,), ...}

and of an ``EbGridModel``::

    {"ebs": (e,), "name": str, "models": [<CR model state>, ...],
     "cfg": {"variance_fraction_2d": ..., "variance_fraction_3d": ...,
             "qent_bins": ..., "use_kernels": ...},
     "quality": {"coef": (e, 3), "mean_psnr": (e,), "mean_nrmse": (e,)}
                or None}
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import pipeline as PL
from repro_torch.core import predictors as P
from repro_torch.core import regression as R
from repro_torch.core import usecases as UC
from repro_torch.models import causal_lm as CLM
from repro_torch.models import model as M
from repro_torch.models import whisper as WSP
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.train import grad_compress as GC
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def cr_model(state: Dict[str, Any], device="cuda"):
    """A ``SplineCRModel`` or ``LinearCRModel`` from its arrays."""
    std = R.Standardizer(_t(state["mean"], device), _t(state["std"], device))
    if state["kind"] == "spline":
        return R.SplineCRModel(std, _t(state["knots1"], device),
                               _t(state["knots2"], device),
                               _t(state["coef"], device))
    if state["kind"] == "linear":
        return R.LinearCRModel(std, _t(state["coef"], device))
    raise ValueError(f"unknown CR model kind {state['kind']!r}")


def predictor_config(cfg: Dict[str, Any] | None) -> P.PredictorConfig:
    """The port's config from the reference's fields.  ``use_kernels``
    is carried across: it picks the q-ent route the model was fitted on
    (exact sort, or hashed bins).  ``tune`` (the reference's TPU tile
    policy) has no counterpart and is dropped."""
    fields = P.PredictorConfig.__dataclass_fields__
    return P.PredictorConfig(**{k: v for k, v in (cfg or {}).items()
                                if k in fields})


def cr_predictor(state: Dict[str, Any], cfg: Dict[str, Any] | None = None,
                 device="cuda") -> PL.CRPredictor:
    return PL.CRPredictor(cr_model(state, device), float(state["eps"]),
                          predictor_config(cfg), int(state.get("ndim", 2)))


def eb_grid_model(state: Dict[str, Any], device="cuda") -> UC.EbGridModel:
    """An ``EbGridModel`` (with its quality table, if any) from its state."""
    q = state.get("quality")
    quality = None if q is None else UC.QualityTable(
        np.asarray(q["coef"], np.float64),
        np.asarray(q["mean_psnr"], np.float64),
        np.asarray(q["mean_nrmse"], np.float64))
    return UC.EbGridModel(
        np.asarray(state["ebs"], np.float64),
        [cr_predictor(m, state.get("cfg"), device) for m in state["models"]],
        state.get("name", ""), predictor_config(state.get("cfg")), quality)


def array(a, device="cuda") -> torch.Tensor:
    """A numpy array as a tensor of the same dtype and values; bfloat16
    (``ml_dtypes``' numpy type, which torch cannot read) by its bits."""
    a = np.array(a)                      # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def lm_params(tree, cfg, device="cuda"):
    """The port's model (a ``CausalLM``, or a ``Whisper`` for the encdec
    family) holding a reference parameter tree's values in its dtypes;
    raises ``ValueError`` on a missing, extra or mis-shaped leaf."""
    return M.build(cfg, tree_unflatten(
        tree, [array(a, device) for a in tree_leaves(tree)]))


def lm_cache(tree, device="cuda"):
    """The port's cache from a reference cache tree with numpy leaves
    (``{"seg0": AttnCache(k, v, pos)}``, ``MLACache(ckv, krope, pos)``
    per segment, ssm's ``HybridCache(None, conv, state)``, hybrid's
    ``HybridCache(AttnCache(k, v, pos), conv, state)``, or whisper's
    bare ``WhisperCache(k, v, pos, xk, xv)``): each tuple the port's of
    the same name, nested as the reference's."""
    def entry(e):
        if e is None:
            return None
        if isinstance(e, tuple):
            kind = type(e).__name__
            mod = WSP if kind == "WhisperCache" else CLM
            return getattr(mod, kind)(*(entry(a) for a in e))
        return array(e, device)

    if isinstance(tree, dict):
        return {seg: entry(e) for seg, e in tree.items()}
    return entry(tree)


def lm_tree(tree, device="cuda"):
    """A reference tree (parameters, moments, gradients) with numpy
    leaves as the same tree of tensors, dtypes kept."""
    return tree_unflatten(tree, [array(a, device) for a in tree_leaves(tree)])


def train_state(state, device="cuda") -> TS.TrainState:
    """The port's ``TrainState`` from the reference's with numpy leaves
    (``jax.tree.map(np.asarray, state)``): its ``params``, ``opt.step`` /
    ``opt.mu`` / ``opt.nu`` and ``ef.residuals`` (or ``ef`` None).  The
    step stays on the host, as the port's optimizer keeps it."""
    ef = None if state.ef is None else GC.EFState(
        lm_tree(state.ef.residuals, device))
    return TS.TrainState(
        lm_tree(state.params, device),
        OPT.OptState(torch.tensor(int(np.asarray(state.opt.step)),
                                  dtype=torch.int32),
                     lm_tree(state.opt.mu, device),
                     lm_tree(state.opt.nu, device)),
        ef)


def podsync_state(state, pod: int, device="cuda") -> TS.TrainState:
    """Pod ``pod``'s slice of the reference's pod-stacked ``TrainState``
    (``stack_for_podsync``'s (n_pods, ...) leaves, numpy): the port's
    pod-stacked state of that pod's process, each leaf its (1, ...)
    slice."""
    def sl(tree):
        return tree_unflatten(tree, [np.asarray(a)[pod:pod + 1]
                                     for a in tree_leaves(tree)])
    ef = None if state.ef is None else type(state.ef)(sl(state.ef.residuals))
    return train_state(type(state)(
        sl(state.params), type(state.opt)(state.opt.step, sl(state.opt.mu),
                                          sl(state.opt.nu)), ef), device)


def numpy_tree(tree):
    """A port tree (plain tensors or DTensors) as numpy leaves in the same
    structure; a DTensor through ``full_tensor()`` (a collective over its
    mesh: every rank of it calls this), bfloat16 as float32 (exact;
    ``.astype(jnp.bfloat16)`` gives the reference's leaf back)."""
    def host(a):
        if hasattr(a, "full_tensor"):
            a = a.full_tensor()
        a = a.detach().cpu()
        return (a.to(torch.float32) if a.dtype == torch.bfloat16 else a).numpy()
    return tree_unflatten(tree, [host(a) for a in tree_leaves(tree)])

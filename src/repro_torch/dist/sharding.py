"""The active sweep mesh.

The reference's ``dist.sharding`` resolves logical axis names against a
``jax.sharding.Mesh``.  A sweep needs one rule of it: the logical
``"slices"`` axis of a (k, ...) stack maps to the mesh's ``"data"``
axis.  A ``repro_torch.dist.sweep.SweepMesh`` is 1-D, with that one
axis, so the rule is fixed and a sweep shards over the mesh's whole
extent.  This module keeps the thread-local mesh context::

    from repro_torch.dist import sharding as S
    from repro_torch.launch import mesh as M
    with S.use_mesh(M.make_sweep_mesh(devices=["cuda:0", "cuda:1"])):
        feats = predictors.features_sweep(slices, ebs)    # sharded
"""
from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


def current_mesh():
    """The mesh of the innermost :func:`use_mesh` on this thread, or None."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for the block, on this thread; the previous mesh
    comes back on exit."""
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev

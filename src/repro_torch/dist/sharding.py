"""Logical-axis sharding over a ``torch.distributed`` ``DeviceMesh``
(the reference's ``dist.sharding``).

Models annotate tensors with *logical* axis names ("batch", "model",
"fsdp", ...).  A rules table maps each logical name to physical mesh
axes; :func:`spec_for` resolves those rules against a mesh, with a
per-dimension fallback to replication where a size does not divide the
mesh extent (a 25-head tensor on a 4-way model axis replicates instead
of erroring).  :func:`named_sharding` turns the spec into DTensor
placements (``Shard(dim)`` / ``Replicate()`` per mesh dimension).

A mesh is one of:

* a ``torch.distributed.device_mesh.DeviceMesh`` whose
  ``mesh_dim_names`` are the reference's axis names (``("data",
  "model")`` or ``("pod", "data", "model")``), built by
  ``launch.mesh.make_mesh`` over the process group;
* an :class:`AbstractMesh`: axis names and sizes with no process group,
  so the specs of a 16 x 16 or 2 x 16 x 16 mesh can be computed in one
  process;
* a sweep's ``dist.sweep.SweepMesh``: 1-D, its one axis ``"data"`` with
  the mesh's whole extent, so the logical ``"slices"`` axis of a (k, ...)
  stack shards over every shard::

    from repro_torch.dist import sharding as S
    from repro_torch.launch import mesh as M
    with S.use_mesh(M.make_sweep_mesh(devices=["cuda:0", "cuda:1"])):
        feats = predictors.features_sweep(slices, ebs)    # sharded

``shard()`` is the identity: a process already holds its own rows of
the ``batch`` axis, and the ``model`` axis (tensor-parallel layers) is
not ported yet -- ROADMAP Queue 1 item 7, the next slice, with the dry
run (item 6).

The reference's jax version-compat shims (``pvary_manual``, the
``shard_map`` adapter, ``abstract_mesh_or``, ``in_manual_context``) are
not ported: they adapt JAX's tracing of manual mesh axes across its
releases, and a ``torch.distributed`` program has no tracing and no
manual axes -- each process runs its own part and calls the
collectives itself (``dist.collectives``, ``train.train_step``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Tuple

# Logical axis name -> tuple of physical mesh axes.  A logical axis maps to
# nothing ("layers": the stacked layer dimension) or to mesh axes.
DEFAULT_RULES = {
    "batch": ("data",),
    "fsdp": ("data",),
    "model": ("model",),
    "seq_model": ("model",),
    "layers": (),
    # featurization sweeps: the slice axis of a (k, m, n) stack
    "slices": ("data",),
}

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices or process group: enough for
    :func:`spec_for` and ``param_specs`` (what the reference's
    ``spec_for`` reads of a mesh)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names


class PartitionSpec(tuple):
    """Per tensor dimension: None (replicated), a mesh axis name, or a
    tuple of them (``jax.sharding.PartitionSpec``'s entries)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def current_mesh():
    """The mesh of the innermost :func:`use_mesh` on this thread, or None."""
    return getattr(_STATE, "mesh", None)


def current_rules() -> dict:
    return getattr(_STATE, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate ``mesh`` (and optional rule overrides) for the block, on
    this thread; the previous mesh and rules come back on exit."""
    prev = (current_mesh(), current_rules())
    _STATE.mesh = mesh
    _STATE.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield mesh
    finally:
        _STATE.mesh, _STATE.rules = prev


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, an :class:`AbstractMesh` or
    a sweep mesh (its one ``"data"`` axis)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        if hasattr(mesh, "shares"):                   # dist.sweep.SweepMesh
            return {"data": int(mesh.size)}
        raise ValueError(f"{type(mesh).__name__} is not a mesh with named "
                         "axes (build one with launch.mesh.make_mesh)")
    shape = (mesh.shape if isinstance(mesh, AbstractMesh)
             else tuple(mesh.mesh.shape))
    return dict(zip(names, (int(s) for s in shape)))


def _mesh_extent(mesh, axes) -> int:
    """Product of the mesh sizes of ``axes`` (missing axes count as 1)."""
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    ext = 1
    for a in axes:
        ext *= sizes.get(a, 1)
    return ext


def _physical_axes(logical: Optional[str], mesh) -> Tuple[str, ...]:
    if logical is None:
        return ()
    axes = current_rules().get(logical, ())
    if isinstance(axes, str):
        axes = (axes,)
    names = axis_sizes(mesh)
    return tuple(a for a in axes if a in names)


def spec_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
             mesh=None) -> PartitionSpec:
    """PartitionSpec for ``shape`` under the logical->physical rules.

    Any dimension whose size does not divide the mapped mesh extent falls
    back to replication (None) for that dimension only."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return PartitionSpec(*([None] * len(shape)))
    parts = []
    for dim, name in zip(shape, logical_axes):
        axes = _physical_axes(name, mesh)
        ext = _mesh_extent(mesh, axes)
        if axes and ext > 1 and dim % ext == 0:
            parts.append(axes[0] if len(axes) == 1 else axes)
        else:
            parts.append(None)
    return PartitionSpec(*parts)


def _placement_types():
    try:
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:                       # torch before 2.4
        from torch.distributed._tensor import Replicate, Shard
    return Replicate, Shard


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec; ``placements`` are DTensor's, one per mesh
    dimension in mesh order: ``Shard(d)`` where tensor dimension ``d``'s
    entry names that axis, else ``Replicate()``.  A tensor dimension
    split over several axes (``("pod", "data")``) is ``Shard(d)`` on each,
    the first axis outermost, as JAX splits it."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        Replicate, Shard = _placement_types()
        out = []
        for name in axis_sizes(self.mesh):
            dims = [d for d, p in enumerate(self.spec)
                    if p == name or (isinstance(p, tuple) and name in p)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def named_sharding(shape: Sequence[int], logical_axes, mesh=None
                   ) -> NamedSharding:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("named_sharding needs a mesh (arg or use_mesh)")
    return NamedSharding(mesh, spec_for(shape, logical_axes, mesh))


def shard(x, *logical_axes):
    """The identity.  The reference constrains an activation to the
    sharding its logical axes imply.  On the ``batch`` axis a port
    process already holds only its own rows (``train.train_step`` gives
    each ``data`` rank its block), so the constraint moves nothing; the
    ``model`` axis's constraints place tensor-parallel layers, which are
    not ported yet (ROADMAP Queue 1 item 7, the next slice)."""
    return x

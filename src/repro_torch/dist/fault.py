"""Fault tolerance of the multi-process sweep fabric, over the process
group's key-value store (``launch.mesh.coordination_store``).

``serve.sweep_service.SweepService`` on a process-spanning mesh uses:

* the typed :class:`FabricError`;
* the store helpers :func:`kv_set`, :func:`kv_get`, :func:`kv_delete`
  and the chunked :func:`kv_put_bytes` / :func:`kv_get_bytes` /
  :func:`kv_delete_bytes` (the launch transport after a recovery);
* :class:`Heartbeat` and :class:`PeerMonitor`, the liveness signal;
* :func:`fabric_barrier`, a bounded barrier among a subset of ranks;
* :func:`abort_group`, which ends an NCCL group's stuck collectives;
* :func:`surviving_submesh`, the row shares of the survivors.

Three rules of ``torch.distributed``'s stores shape the helpers:

1. A ``TCPStore`` value above 8 MiB makes the server drop the
   connection, which a client cannot tell from a lost peer; every value
   here is at most :data:`KV_CHUNK` (1 MiB) and larger payloads go in
   chunks.
2. One client runs one call at a time: a call that blocks (``get`` or
   ``wait`` on a missing key) stalls every other thread on that client
   until the store's timeout.  So the helpers never block: they poll
   with ``check`` and read a key only once it is there, and a
   :class:`Heartbeat` publishes on a client of its own (``clone()``).
3. ``FileStore.list_keys`` returns the store's internal keys, so no
   helper lists a prefix: callers read the keys they know.

The store keeps working among the survivors after a peer dies as long
as the process that serves it lives: a ``FileStore`` outlives every
process, a ``TCPStore`` served by process 0 dies with it, and one
served by ``launch.mesh.serve_coordinator`` outlives every rank.

Re-meshing (the reference's elastic path) moves a training state onto
another mesh by its logical axes: :func:`shrink_mesh` keeps the first
slices of an axis, :func:`remesh_state` places each leaf as a DTensor
on the target mesh, values unchanged bit for bit.
"""
from __future__ import annotations

import threading
import time
from typing import Iterable, Optional, Sequence

KV_CHUNK = 1 << 20               # the largest value any helper stores
_POLL_S = 0.005                  # first gap of a polling wait


class FabricError(RuntimeError):
    """A failure of the multi-process fabric itself (vs one request).

    ``kind`` classifies the fault:

    * ``"follower_lost"`` -- one or more followers died or wedged; the
      leader shrinks the mesh and retries (``retriable=True``).
    * ``"leader_lost"``   -- the leader (or the store it served) went
      away; followers cannot continue (restart the fabric to recover).
    * ``"evicted"``       -- this (live) process was dropped from the
      recovered fabric; restart it to rejoin.
    * ``"timeout"``       -- a bounded wait expired without an
      identifiable peer fault.
    * ``"failed"``        -- recovery itself is impossible (e.g. the
      store is unreachable).

    ``lost`` names the process ranks believed dead or wedged (may be
    empty when the fault could not be attributed).  ``retriable`` tells
    the leader's launch loop whether shrinking the mesh and relaunching
    can succeed; non-retriable errors reach every pending future with
    restart guidance in the message."""

    def __init__(self, message: str, *, kind: str = "failed",
                 lost: Sequence[int] = (), retriable: bool = False):
        self.kind = kind
        self.lost = tuple(lost)
        self.retriable = retriable
        detail = f" [kind={kind}"
        if self.lost:
            detail += f", lost processes={list(self.lost)}"
        detail += ", retriable]" if retriable else \
            "; restart the affected process(es) to rejoin the fabric]"
        super().__init__(message + detail)


# ---------------------------------------------------------------------------
# Key-value helpers
# ---------------------------------------------------------------------------

def kv_set(store, key: str, value: str) -> bool:
    """Overwrite ``key`` with ``value`` (at most :data:`KV_CHUNK` bytes);
    False when the store is unreachable."""
    data = value.encode() if isinstance(value, str) else bytes(value)
    if len(data) > KV_CHUNK:
        raise ValueError(f"kv_set: {len(data)} bytes under {key!r}; values "
                         f"above {KV_CHUNK} go through kv_put_bytes")
    try:
        store.set(key, data)
        return True
    except Exception:
        return False


def _poll(store, keys: list, timeout_s: float) -> bool:
    """True once every key of ``keys`` is in the store, polling with
    ``check`` (gaps from 5 ms up to 50 ms); False on timeout or a store
    error."""
    deadline = time.monotonic() + max(0.0, timeout_s)
    gap = _POLL_S
    while True:
        try:
            if store.check(keys):
                return True
        except Exception:
            return False
        left = deadline - time.monotonic()
        if left <= 0:
            return False
        time.sleep(min(gap, left))
        gap = min(2 * gap, 0.05)


def _read(store, key: str) -> Optional[bytes]:
    """``key``'s value if it is there now, else None; never waits."""
    try:
        return store.get(key) if store.check([key]) else None
    except Exception:
        return None


def kv_get(store, key: str, timeout_ms: int) -> Optional[str]:
    """``key``'s value once it appears within ``timeout_ms``; None on a
    timeout or a store error."""
    if not _poll(store, [key], timeout_ms / 1e3):
        return None
    raw = _read(store, key)
    return None if raw is None else raw.decode()


def kv_delete(store, key: str) -> None:
    try:
        store.delete_key(key)
    except Exception:
        pass


def kv_put_bytes(store, key: str, data: bytes) -> None:
    """Store ``data`` chunked under ``key`` (``key/<i>`` of at most
    :data:`KV_CHUNK` bytes, then ``key/n``, so a reader that sees
    ``key/n`` finds every chunk).  Raises on a store error."""
    n = max(1, -(-len(data) // KV_CHUNK))
    view = memoryview(data)
    for i in range(n):
        store.set(f"{key}/{i}", bytes(view[i * KV_CHUNK:(i + 1) * KV_CHUNK]))
    store.set(f"{key}/n", str(n))


def kv_get_bytes(store, key: str, timeout_ms: int) -> Optional[bytes]:
    """Read a :func:`kv_put_bytes` payload once it is complete; None on
    a timeout, a store error or a chunk deleted under the reader."""
    n = kv_get(store, f"{key}/n", timeout_ms)
    if n is None:
        return None
    parts = []
    for i in range(int(n)):
        part = _read(store, f"{key}/{i}")
        if part is None:
            return None
        parts.append(part)
    return b"".join(parts)


def kv_delete_bytes(store, key: str) -> None:
    """Remove a :func:`kv_put_bytes` payload (nothing if it is absent)."""
    n = _read(store, f"{key}/n")
    if n is None:
        return
    kv_delete(store, f"{key}/n")
    for i in range(int(n)):
        kv_delete(store, f"{key}/{i}")


# ---------------------------------------------------------------------------
# Heartbeats and staleness
# ---------------------------------------------------------------------------

class Heartbeat:
    """Publishes a counter that rises by one every ``interval_s`` to
    ``{prefix}/hb/{rank}``, from a daemon thread on a client of its own.

    A peer's counter standing still is the liveness signal
    (:class:`PeerMonitor`): tracking changes of value needs no clocks to
    agree.  A store error does not stop it; ten in a row do."""

    def __init__(self, store, prefix: str, rank: int,
                 interval_s: float = 0.5):
        self._store = store.clone()      # no call on another client stalls it
        self._key = f"{prefix}/hb/{rank}"
        self._interval = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="fabric-heartbeat", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        beat, misses = 0, 0
        while not self._stop.is_set():
            beat += 1
            if kv_set(self._store, self._key, str(beat)):
                misses = 0
            else:
                misses += 1
                if misses >= 10:
                    return
            self._stop.wait(self._interval)

    def stop(self) -> None:
        self._stop.set()


class PeerMonitor:
    """The observer's side of the heartbeats: a tracked rank is *stale*
    once its counter has been seen unchanged for ``stale_after``
    seconds (a rank that never published ages from when it was first
    tracked).  Ages are this monitor's own observations, so seeing a
    fresh death takes one ``stale_after`` window."""

    def __init__(self, store, prefix: str):
        self._store = store
        self._prefix = f"{prefix}/hb/"
        self._state: dict = {}       # rank -> (last value, t of last change)

    def poll(self) -> None:
        """Read every tracked rank's counter once."""
        now = time.monotonic()
        for rank in list(self._state):
            val = _read(self._store, f"{self._prefix}{rank}")
            if val is not None and self._state[rank][0] != val:
                self._state[rank] = (val, now)

    def track(self, ranks: Iterable[int]) -> None:
        """Start aging ``ranks`` even if they never publish a beat."""
        now = time.monotonic()
        for rank in ranks:
            self._state.setdefault(rank, (None, now))

    def seen(self, rank: int) -> bool:
        """True once ``rank`` has published at least one beat."""
        ent = self._state.get(rank)
        return ent is not None and ent[0] is not None

    def age(self, rank: int) -> float:
        ent = self._state.get(rank)
        if ent is None:
            self.track([rank])
            return 0.0
        return time.monotonic() - ent[1]

    def stale(self, ranks: Iterable[int], stale_after: float) -> list:
        return [r for r in ranks if self.age(r) > stale_after]

    def observe_stale(self, ranks: Sequence[int], stale_after: float,
                      poll_s: float = 0.1) -> list:
        """Watch ``ranks`` for one whole ``stale_after`` window and return
        those whose counter never moved (the dead or wedged).  Blocks for
        about ``stale_after`` seconds; run right after a fault to
        attribute it."""
        self.track(ranks)
        self.poll()
        deadline = time.monotonic() + stale_after + poll_s
        while time.monotonic() < deadline:
            time.sleep(poll_s)
            self.poll()
        return self.stale(ranks, stale_after * 0.9)


def abort_group(group) -> str:
    """Abort ``group``'s collectives, pending and later, so that a
    collective stuck on a lost peer raises instead of waiting for NCCL's
    watchdog.  Returns the call that did it: ``"_abort_process_group"``
    (``torch.distributed.distributed_c10d``), ``"abort"`` (the
    ``ProcessGroup`` method) or ``""`` when this build has neither."""
    import torch.distributed as dist
    try:
        dist.distributed_c10d._abort_process_group(group)
        return "_abort_process_group"
    except Exception:
        pass
    try:
        group.abort()
        return "abort"
    except Exception:
        return ""


def fabric_barrier(store, name: str, timeout_s: float,
                   ranks: Sequence[int], *, rank: Optional[int] = None
                   ) -> bool:
    """A barrier among ``ranks`` only (the survivors), bounded by
    ``timeout_s``: the caller (``rank``, default this process's rank in
    the process group) counts itself in with ``store.add`` on its own key
    under ``name`` and polls until every member has.  A member that
    arrives twice counts once (unlike one shared counter), so a process
    may retry a barrier it timed out of.  False on a timeout or a store
    error, never a raise, so recovery can shed and retry."""
    if rank is None:
        import torch.distributed as dist
        rank = dist.get_rank()
    try:
        if rank in ranks:
            store.add(f"{name}/{rank}", 1)
    except Exception:
        return False
    return _poll(store, [f"{name}/{r}" for r in ranks], timeout_s)


# ---------------------------------------------------------------------------
# The survivors' shares
# ---------------------------------------------------------------------------

def surviving_submesh(mesh, alive: Iterable[int]):
    """The ``dist.sweep.SweepMesh`` of ``mesh``'s ``alive`` ranks: their
    ranks and shares in the original mesh order, so each rank's block of
    rows stays contiguous, as ``dist.sweep`` requires.  ``devices`` stays
    this process's.  Its group is dropped: no collective runs on a group
    after a fault, so the submesh gives the partition of the store
    transport's rows, not a mesh to launch on.  The port's meshes are
    1-D by construction, so there is no other kind to reject.  Raises
    ``ValueError`` when no rank of the mesh is alive."""
    import dataclasses
    alive = set(alive)
    keep = [(r, s) for r, s in zip(mesh.ranks, mesh.shares)
            if r in alive and s > 0]
    if not keep:
        raise ValueError(f"surviving_submesh: no devices left for processes "
                         f"{sorted(alive)}")
    return dataclasses.replace(mesh, ranks=tuple(r for r, _ in keep),
                               shares=tuple(s for _, s in keep), group=None)


# ---------------------------------------------------------------------------
# Re-meshing
# ---------------------------------------------------------------------------

def _dtensor():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:                       # torch before 2.4
        from torch.distributed._tensor import DTensor
    return DTensor


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def _full(a):
    """A DTensor's whole value on each rank of its mesh, gathered axis by
    axis (innermost first) over the mesh's groups with
    ``dist.collectives.all_gather`` (host-staged on gloo); a plain tensor
    as it is."""
    import torch
    from repro_torch.dist import collectives as COL
    if not isinstance(a, _dtensor()):
        return a
    mesh = a.device_mesh
    if mesh.get_coordinate() is None:
        return None
    x = a.to_local()
    for i in reversed(range(mesh.ndim)):
        p = a.placements[i]
        if p.is_shard():
            x = torch.cat(COL.all_gather(x, mesh.get_group(i)), dim=p.dim)
    return x


def remesh_state(tree, axes, mesh):
    """Place every leaf of ``tree`` on ``mesh`` per its logical ``axes``.

    ``axes`` mirrors ``tree``'s structure with a tuple of logical axis
    names where ``tree`` has a tensor (``params.logical_axes`` output).
    Each leaf becomes a DTensor whose placements are the ones its axes
    imply on ``mesh`` (``dist.sharding.named_sharding``), holding this
    rank's block of the value; a leaf that is already a DTensor on
    another mesh is gathered there first.  Values are unchanged bit for
    bit.  Every rank of the world calls it; a rank outside ``mesh`` holds
    an empty local tensor."""
    import torch
    from repro_torch.dist import sharding as S
    from repro_torch.models.params import tree_leaves, tree_unflatten
    DTensor = _dtensor()
    leaves = tree_leaves(tree)
    ax = tree_leaves(axes, is_leaf=_is_axes)
    if len(ax) != len(leaves):
        raise ValueError(f"remesh_state: {len(leaves)} leaves, {len(ax)} "
                         "axis tuples")
    coord = mesh.get_coordinate()
    out = []
    for a, names in zip(leaves, ax):
        full = _full(a)
        shape = tuple(a.shape)
        placements = S.named_sharding(shape, names, mesh).placements
        if coord is None:
            local = torch.empty(0, dtype=a.dtype, device=a.device)
        elif full is None:
            raise ValueError("remesh_state: this rank is on the target mesh "
                             "but not on the leaf's mesh, so it has no value")
        else:
            local = full
            for i, p in enumerate(placements):
                if p.is_shard():
                    n = mesh.size(i)
                    size = local.shape[p.dim] // n
                    local = local.narrow(p.dim, coord[i] * size, size)
            local = local.contiguous()
        out.append(DTensor.from_local(local, mesh, placements,
                                      run_check=False, shape=torch.Size(shape),
                                      stride=torch.empty(shape,
                                                         device="meta").stride()))
    return tree_unflatten(tree, out)


def shrink_mesh(mesh, axis: str, new_size: int):
    """A mesh with ``axis`` reduced to its first ``new_size`` slices: a
    ``DeviceMesh`` over those ranks (every rank of the world calls it:
    the new mesh builds its groups), or an ``AbstractMesh`` of the new
    sizes."""
    from repro_torch.dist import sharding as S
    names = tuple(mesh.mesh_dim_names)
    if axis not in names:
        raise ValueError(
            f"shrink_mesh: mesh has axes {names}, not {axis!r}")
    i = names.index(axis)
    sizes = list(S.axis_sizes(mesh).values())
    if not 1 <= int(new_size) <= sizes[i]:
        raise ValueError(
            f"shrink_mesh: new_size={new_size} outside [1, "
            f"{sizes[i]}] for axis {axis!r}")
    if isinstance(mesh, S.AbstractMesh):
        sizes[i] = int(new_size)
        return S.AbstractMesh(tuple(sizes), names)
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    ranks = mesh.mesh.index_select(i, torch.arange(int(new_size)))
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=names)

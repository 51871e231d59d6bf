"""Process groups and sweep meshes (the reference's ``launch.mesh``),
over ``torch.distributed``.

    from repro_torch.launch import mesh as M
    M.dist_init("tcp://10.0.0.1:29500", num_processes=2, process_id=rank,
                device="cuda:0")
    mesh = M.make_sweep_mesh()      # one shard per process, on its device

``dist_init`` joins a process group (``nccl`` for a rank on a CUDA
device, ``gloo`` on the CPU, unless ``backend=`` says otherwise; the
backend is never swapped after a failure).  It makes the group's
key-value store itself and keeps a handle to it,
:func:`coordination_store`: the sweep service's followers wait there for
the next launch instead of inside a collective, which the group's
timeout would end, and the fabric's heartbeats, recovery epochs and
post-recovery launches (``dist.fault``) run over it.  Where the store
lives decides which deaths the fabric survives:

* ``tcp://host:port`` -- a ``TCPStore`` that process 0 serves.  It dies
  with process 0, so a follower sees the leader's death as a store
  error (``FabricError(kind="leader_lost")``);
* ``tcp://...`` with ``external_coordinator=True`` -- every rank,
  process 0 included, is a client of a ``TCPStore`` that
  :func:`serve_coordinator` serves in a process of its own, so the
  store outlives any rank and a follower learns of the leader's death
  from its heartbeat;
* ``file://path`` -- a ``FileStore``, which already outlives every
  process.

``make_mesh`` / ``make_production_mesh`` build a training mesh (a
``DeviceMesh`` over the group, or outside one an abstract mesh of names
and sizes, ``dist.sharding``).  ``make_sweep_mesh`` builds a
``dist.sweep.SweepMesh``: inside a process
group it spans every process's devices (each process contributes its
own, and the mesh is collective to build), otherwise it covers this
process's devices.  One device may carry several shards
(``devices=["cuda:0", "cuda:0"]``).
"""
from __future__ import annotations

import datetime
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.dist.sweep import SweepMesh

# This process's device and the group's timeout, as dist_init set them:
# the default shard of a process's meshes and the timeout of the
# subgroups they make.  Set once per process, like the process group.
_RANK_DEVICE: Optional[torch.device] = None
_TIMEOUT: Optional[datetime.timedelta] = None
_STORE = None


def _rank_device(device, process_id: int) -> torch.device:
    """``device`` as a concrete device; a CUDA device without an index
    (or None) is the card ``process_id`` maps to on this host."""
    if device is None:
        if not torch.cuda.is_available():
            raise ValueError("dist_init: no CUDA device for this rank; pass "
                             "device='cpu' to run it on the host")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def dist_init(coordinator_address: Optional[str] = None, *,
              num_processes: int, process_id: int,
              backend: Optional[str] = None, device=None,
              init_timeout_s: float = 60.0,
              external_coordinator: bool = False) -> tuple:
    """Join the process group of a multi-process sweep: call once per
    process, on every process, before building a spanning mesh.

    ``coordinator_address`` is ``tcp://host:port`` (process 0 listens
    there) or ``file://path`` (a file on a file system every process
    sees); None reads ``MASTER_ADDR``/``MASTER_PORT`` from the
    environment.  ``device`` is this rank's device (None: the card
    ``process_id`` maps to); ``backend`` defaults to ``nccl`` for a CUDA
    device and ``gloo`` for the CPU.  ``init_timeout_s`` bounds the join
    and every collective of the group, so a lost process fails the
    others' calls instead of hanging them.  ``external_coordinator=True``
    (on every process) joins the ``TCPStore`` that
    :func:`serve_coordinator` serves at the ``tcp://`` address as a
    client, process 0 included, so the store outlives every rank; it
    needs ``tcp://``, or ``file://``, whose store outlives every process
    anyway.  Returns (rank, world size).
    """
    import torch.distributed as dist
    global _RANK_DEVICE, _TIMEOUT, _STORE
    init = coordinator_address or "env://"
    if not init.startswith(("tcp://", "file://", "env://")):
        raise ValueError(f"dist_init: coordinator address {init!r} is not "
                         "tcp://host:port or file://path")
    dev = _rank_device(device, process_id)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=float(init_timeout_s))
    if external_coordinator and not init.startswith(("tcp://", "file://")):
        raise ValueError("dist_init(external_coordinator=True) needs a "
                         f"tcp:// (or file://) address, got {init!r}")
    store = _make_store(init, int(num_processes), int(process_id), timeout,
                        serve=not external_coordinator)
    dist.init_process_group(backend, store=store,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    _RANK_DEVICE, _TIMEOUT, _STORE = dev, timeout, store
    return dist.get_rank(), dist.get_world_size()


def rank_device() -> Optional[torch.device]:
    """This process's device as :func:`dist_init` set it (None before)."""
    return _RANK_DEVICE


def _tcp_address(init: str) -> tuple:
    """(host, port) of a ``tcp://host:port`` address."""
    host, _, port = init[len("tcp://"):].rpartition(":")
    if not init.startswith("tcp://") or not host or not port.isdigit():
        raise ValueError(f"coordinator address {init!r} is not "
                         "tcp://host:port")
    return host.strip("[]"), int(port)


def _make_store(init: str, world: int, rank: int,
                timeout: datetime.timedelta, serve: bool = True):
    """The group's key-value store for ``init``, as ``init_method``
    would make it: a ``FileStore`` on ``file://path``, else a
    ``TCPStore`` served by process 0 (``env://`` reads its address from
    ``MASTER_ADDR``/``MASTER_PORT``), or by no rank when ``serve`` is
    False (:func:`serve_coordinator` serves it)."""
    import os
    import torch.distributed as dist
    if init.startswith("file://"):
        return dist.FileStore(init[len("file://"):], world)
    if init.startswith("env://"):
        host, port = os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
    else:
        host, port = _tcp_address(init)
    return dist.TCPStore(host, port, world, serve and rank == 0,
                         timeout=timeout)


def serve_coordinator(address: str, num_processes: int, block: bool = True):
    """Serve the process group's ``TCPStore`` at ``address``
    (``tcp://host:port``) in this process, for ``num_processes`` ranks
    that join with ``dist_init(address, ..., external_coordinator=True)``.

    Run it in a process of its own, never a rank of the fabric: the
    point is that every rank's death, the leader's included, leaves the
    store up for the survivors' heartbeats, barriers and launches.
    ``block=True`` serves until SIGINT (or the process is killed);
    ``block=False`` returns the store, which serves while the caller
    keeps it."""
    import torch.distributed as dist
    host, port = _tcp_address(address)
    store = dist.TCPStore(host, port, int(num_processes), True,
                          wait_for_workers=False)
    if not block:
        return store
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    return store


def coordination_store():
    """The key-value store of the process group :func:`dist_init` made,
    or None outside one (shared by every member; keys are global)."""
    return _STORE


def _local_devices(devices: Optional[Sequence], in_group: bool) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    if in_group:
        return [_RANK_DEVICE if _RANK_DEVICE is not None else
                torch.device("cuda", torch.cuda.current_device())]
    if not torch.cuda.is_available():
        raise ValueError("make_sweep_mesh: no CUDA device; pass "
                         "devices=['cpu', ...] to shard on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _gather_counts(n: int, local: list) -> list:
    """Every process's shard count (a collective over the group)."""
    import torch.distributed as dist
    on = (local[0] if dist.get_backend() == "nccl" else torch.device("cpu"))
    mine = torch.tensor([n], dtype=torch.int64, device=on)
    outs = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, mine)
    return [int(o.item()) for o in outs]


def make_sweep_mesh(num_devices: Optional[int] = None, *,
                    devices: Optional[Sequence] = None) -> SweepMesh:
    """1-D ``("data",)`` sweep mesh over ``devices`` (default: this
    process's device from :func:`dist_init` inside a process group, else
    every CUDA device of the process), one shard per entry.

    Inside a process group the mesh spans the group: every process must
    make this call, and ``num_devices`` takes a prefix of the global
    shard list in rank order (so processes may hold unequal shares, and
    a process past the prefix holds none and cannot join its sweeps).
    Asking for more shards than there are raises at once -- outside a
    process group, with the hint to call :func:`dist_init` -- instead of
    hanging in a half-joined collective."""
    import torch.distributed as dist
    in_group = dist.is_available() and dist.is_initialized()
    local = _local_devices(devices, in_group)
    if not in_group:
        n = len(local) if num_devices is None else int(num_devices)
        if n < 1:
            raise ValueError(f"make_sweep_mesh needs >= 1 device, got {n}")
        if n > len(local):
            raise ValueError(
                f"make_sweep_mesh({n}) exceeds the {len(local)} device(s) of "
                "this process -- a mesh spanning more devices needs the "
                "processes that hold them: call repro_torch.launch.mesh."
                "dist_init(...) on every participating process first")
        return SweepMesh(tuple(local[:n]), (n,))
    counts = _gather_counts(len(local), local)
    total = sum(counts)
    n = total if num_devices is None else int(num_devices)
    if n < 1:
        raise ValueError(f"make_sweep_mesh needs >= 1 device, got {n}")
    if n > total:
        raise ValueError(
            f"make_sweep_mesh({n}) exceeds the {total} device(s) of the "
            f"{len(counts)} processes of the process group")
    shares, left = [], n
    for c in counts:
        shares.append(min(c, left))
        left -= shares[-1]
    ranks = tuple(r for r, s in enumerate(shares) if s > 0)
    group = (dist.group.WORLD if len(ranks) == len(counts)
             else dist.new_group(list(ranks), timeout=_TIMEOUT))
    return SweepMesh(tuple(local[:shares[dist.get_rank()]]),
                     tuple(shares[r] for r in ranks), ranks, group)


def make_mesh(shape, axes):
    """A training mesh of ``shape`` over named ``axes`` (the reference's
    ``jax.make_mesh``): inside a process group (:func:`dist_init`) a
    ``torch.distributed`` ``DeviceMesh`` over the group's ranks in rank
    order, on this rank's device type, with ``mesh_dim_names`` ``axes``
    (every rank must make this call: the mesh builds one subgroup per
    slice of each axis); outside one, the
    ``dist.sharding.AbstractMesh`` of those names and sizes, which
    computes specs but runs no step.  Raises ``ValueError`` when the
    group's size is not the product of ``shape``."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import AbstractMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} differ "
                         "in length")
    if not (dist.is_available() and dist.is_initialized()):
        return AbstractMesh(shape, axes)
    size = int(np.prod(shape))
    if size != dist.get_world_size():
        raise ValueError(
            f"make_mesh{shape}: {size} ranks, but the process group that "
            f"repro_torch.launch.mesh.dist_init joined has "
            f"{dist.get_world_size()}; start as many processes as the mesh "
            "has places, each calling dist_init")
    from torch.distributed.device_mesh import init_device_mesh
    kind = _RANK_DEVICE.type if _RANK_DEVICE is not None else "cpu"
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """(data=16, model=16) = 256 places; multi-pod (pod=2, data=16,
    model=16) = 512 (the reference's TPU v5e pod slices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def mesh_from_spec(spec: Optional[str], device: str = "cuda"):
    """A CLI's ``--mesh``: None for ``none`` (or no spec), else a mesh over
    this process's devices (``auto``: all of them; ``N``: the first N,
    raising past their count; a comma list: those devices, where
    ``cuda:0,cuda:0`` puts two shards on one card), spanning the process
    group when there is one.  A mesh of one shard sweeps on one device."""
    if spec is None or spec == "none":
        return None
    if spec == "auto" or spec.isdigit():
        return make_sweep_mesh(None if spec == "auto" else int(spec),
                               devices=["cpu"] if device == "cpu" else None)
    return make_sweep_mesh(devices=spec.split(","))

"""Process groups and sweep meshes (the reference's ``launch.mesh``),
over ``torch.distributed``.

    from repro_torch.launch import mesh as M
    M.dist_init("tcp://10.0.0.1:29500", num_processes=2, process_id=rank,
                device="cuda:0")
    mesh = M.make_sweep_mesh()      # one shard per process, on its device

``dist_init`` joins a process group (``nccl`` for a rank on a CUDA
device, ``gloo`` on the CPU, unless ``backend=`` says otherwise; the
backend is never swapped after a failure).  ``make_sweep_mesh`` builds a
``dist.sweep.SweepMesh``: inside a process group it spans every
process's devices (each process contributes its own, and the mesh is
collective to build), otherwise it covers this process's devices.  One
device may carry several shards (``devices=["cuda:0", "cuda:0"]``).
The reference's external coordinator belongs with the sweep service's
fault-tolerant fabric and is not here.
"""
from __future__ import annotations

import datetime
from typing import Optional, Sequence

import torch

from repro_torch.dist.sweep import SweepMesh

# This process's device and the group's timeout, as dist_init set them:
# the default shard of a process's meshes and the timeout of the
# subgroups they make.  Set once per process, like the process group.
_RANK_DEVICE: Optional[torch.device] = None
_TIMEOUT: Optional[datetime.timedelta] = None


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
              init_timeout_s: float = 60.0) -> tuple:
    """Join the process group of a multi-process sweep: call once per
    process, on every process, before building a spanning mesh.

    ``coordinator_address`` is ``tcp://host:port`` (process 0 listens
    there) or ``file://path`` (a file on a file system every process
    sees); None reads ``MASTER_ADDR``/``MASTER_PORT`` from the
    environment.  ``device`` is this rank's device (None: the card
    ``process_id`` maps to); ``backend`` defaults to ``nccl`` for a CUDA
    device and ``gloo`` for the CPU.  ``init_timeout_s`` bounds the join
    and every collective of the group, so a lost process fails the
    others' calls instead of hanging them.  Returns (rank, world size).
    """
    import torch.distributed as dist
    global _RANK_DEVICE, _TIMEOUT
    init = coordinator_address or "env://"
    if not init.startswith(("tcp://", "file://", "env://")):
        raise ValueError(f"dist_init: coordinator address {init!r} is not "
                         "tcp://host:port or file://path")
    dev = _rank_device(device, process_id)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=float(init_timeout_s))
    dist.init_process_group(backend, init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    _RANK_DEVICE, _TIMEOUT = dev, timeout
    return dist.get_rank(), dist.get_world_size()


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

"""Sharded featurization sweeps, padded sweep launches and the training
partition (the reference's ``dist.sweep``), over ``torch.distributed``.

A sweep shards the slice axis of its (k, m, n) or (k, d, m, n) stack
over a :class:`SweepMesh`: the stack is padded to ``k_pad = ceil(k /
extent) * extent`` rows with copies of its last row, each shard takes a
contiguous block of ``k_pad / extent`` rows, and each shard's device runs
the port's single-device sweep body (``predictors._sweep``: one batched
Gram + ``eigvalsh`` per 2-D block, one per HOSVD mode for volumes, one
multi-eps q-ent pass and, in the "quality" and "both" modes, one
quality pass) on its block.  A row's bits depend on nothing but the row
(``core.predictors``), so every sharded result is BIT-EQUAL to the
single-device sweep of the same rows.

One process may hold several shards, on several devices or on one
(``SweepMesh.devices`` may repeat a device).  A mesh made inside a
process group (``launch.mesh.dist_init`` then ``make_sweep_mesh``)
spans its processes: every member makes each call with the same shapes,
and the result is all-gathered over the mesh's own group.  Two
ingestion contracts, as in the reference:

* **SPMD** (default) -- every process passes the same global stack and
  moves only its own :func:`process_block` rows to its devices;
* **process-local** (``process_local=True, global_k=``) -- every process
  passes ONLY its :func:`process_block` rows.

Real row *i* always sits at global position *i*, so the pad rows trail
and live on the last process(es).  ``gather=True`` returns the (k, e, w)
rows on every process; ``gather=False`` returns the padded
:class:`ShardedRows` still on the shards, pad rows zeroed.

Gathers move raw bytes: every member's rows as a ``uint8`` view of their
float32 (or, for the training table, float64) values, CPU tensors on a
``gloo`` group and CUDA tensors on ``nccl``, so the bits arrive as they
left.  ``training_crs`` splits the compressor runs of a model fit over
the processes of the same mesh and all-gathers the (k, e) table.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist import sharding as S


@dataclasses.dataclass(frozen=True)
class SweepMesh:
    """A 1-D mesh of sweep shards over one or more processes; a stack's
    slice axis shards over all of it.

    ``devices``: this process's shards in mesh order (one device may
    hold several shards); ``shares``: each member process's shard count,
    in mesh order (shares may be unequal); ``ranks``: each member's rank
    in the process group; ``group``: the process group gathers run over,
    None in one process.  The mesh's extent is the total shard count.
    Build one with ``launch.mesh.make_sweep_mesh``."""
    devices: Tuple[torch.device, ...]
    shares: Tuple[int, ...]
    ranks: Tuple[int, ...] = (0,)
    group: object = None

    @property
    def size(self) -> int:
        return sum(self.shares)


@dataclasses.dataclass(frozen=True)
class ShardedRows:
    """A padded (k_pad, e, w) sweep result left on its shards: this
    process's per-shard (k_pad / extent, e, w) blocks in mesh order,
    their rows past ``k`` zeroed or the caller's pad (``sweep_padded``).
    :func:`gather_rows` brings the whole result to every process."""
    blocks: Tuple[torch.Tensor, ...]
    k: int
    k_pad: int
    mesh: SweepMesh

    @property
    def shape(self) -> tuple:
        return (self.k_pad,) + tuple(self.blocks[0].shape[1:])

    def cols(self, sl: slice) -> "ShardedRows":
        """The same rows, trailing axis cut to ``sl`` (a sweep's
        features or quality half)."""
        return dataclasses.replace(
            self, blocks=tuple(b[..., sl] for b in self.blocks))


def active_sweep_mesh(mesh: Optional[SweepMesh] = None) -> Optional[SweepMesh]:
    """``mesh`` (or the active ``use_mesh`` sweep mesh) when its extent
    is above 1, else None (a single-device sweep).  An active training
    mesh (a ``DeviceMesh``) shards no sweep: a lossy checkpoint's sweeps
    run on the one rank that writes it."""
    if mesh is None:
        mesh = S.current_mesh()
        mesh = mesh if isinstance(mesh, SweepMesh) else None
    return mesh if mesh is not None and mesh.size > 1 else None


def mesh_spans_processes(mesh: Optional[SweepMesh]) -> bool:
    """True for a mesh made inside a process group: its sweeps and
    gathers are collective over the group's members, even one."""
    return mesh is not None and mesh.group is not None


def mesh_processes(mesh: SweepMesh) -> list:
    """Ranks of the processes in ``mesh``, in mesh order."""
    return list(mesh.ranks)


def _process_position(mesh: SweepMesh) -> tuple:
    """(this process's position among the mesh's processes, their count).

    Raises when the calling process holds no shard of the mesh: it
    cannot join the mesh's collectives, and going on would hang the
    others."""
    if mesh.group is None:
        return 0, 1
    import torch.distributed as dist
    me = dist.get_rank()
    if me not in mesh.ranks:
        raise ValueError(
            f"process {me} has no devices in the sweep mesh (processes "
            f"{list(mesh.ranks)}); every participating process must build "
            "the mesh over devices it contributes")
    return mesh.ranks.index(me), len(mesh.ranks)


def _device_span(mesh: SweepMesh) -> tuple:
    """(first mesh position, count) of this process's shards."""
    pos, _ = _process_position(mesh)
    return sum(mesh.shares[:pos]), mesh.shares[pos]


def process_block(k: int, mesh: SweepMesh) -> tuple:
    """[lo, hi) rows of a k-row global stack THIS process ingests.

    ``k_pad = ceil(k / extent) * extent`` gives ``k_pad / extent`` rows
    to each shard, so a process's contiguous block is proportional to its
    shards; blocks are clipped to ``k``, which keeps real row *i* at
    global position *i* and every pad row on the last process(es)."""
    ext = mesh.size
    first, ndev = _device_span(mesh)
    rpd = -(-k // ext)                       # rows per shard
    return min(first * rpd, k), min((first + ndev) * rpd, k)


def _gather_device(mesh: SweepMesh) -> torch.device:
    """Where a gather's buffers live: this process's first device on a
    ``nccl`` group (NCCL moves CUDA memory), else the host."""
    if mesh_spans_processes(mesh):
        import torch.distributed as dist
        if dist.get_backend(mesh.group) == "nccl":
            return mesh.devices[0]
    return torch.device("cpu")


def _allgather_bytes(payload: torch.Tensor, mesh: SweepMesh,
                     nbytes: Sequence[int]) -> list:
    """Every member's 1-D ``uint8`` payload (``nbytes[p]`` long for
    member ``p``), all-gathered over the mesh's group: host tensors in
    mesh order.  Each is padded to the longest for the collective."""
    import torch.distributed as dist
    on = _gather_device(mesh)
    buf = torch.zeros(max(max(nbytes), 1), dtype=torch.uint8, device=on)
    buf[:payload.numel()] = payload.to(on)
    outs = [torch.empty_like(buf) for _ in nbytes]
    dist.all_gather(outs, buf, group=mesh.group)
    return [o[:n].cpu() for o, n in zip(outs, nbytes)]


def gather_rows(out) -> np.ndarray:
    """A sweep result as a float32 numpy array on the host: a tensor
    (any device) directly; a :class:`ShardedRows` as its padded (k_pad,
    e, w) rows, all-gathered over the mesh's group when the mesh spans
    processes (every member must make this call)."""
    if not isinstance(out, ShardedRows):
        return out.detach().to("cpu", torch.float32).numpy()
    on = _gather_device(out.mesh)
    local = torch.cat([b.detach().to(on, torch.float32) for b in out.blocks])
    if not mesh_spans_processes(out.mesh):
        return local.numpy()
    tail = tuple(local.shape[1:])
    rpd = out.k_pad // out.mesh.size
    row_bytes = 4 * int(np.prod(tail))
    parts = _allgather_bytes(local.contiguous().view(-1).view(torch.uint8),
                             out.mesh, [rpd * s * row_bytes
                                        for s in out.mesh.shares])
    return torch.cat(parts).view(torch.float32).reshape(
        (out.k_pad,) + tail).numpy()


def replicate_rows(out, mesh: SweepMesh) -> np.ndarray:
    """The rows of ``out`` on every process of ``mesh``.  The port's
    gathers already run over the mesh's own group, never the whole
    process group, so this is :func:`gather_rows` of a result made on
    ``mesh``."""
    if isinstance(out, ShardedRows) and out.mesh.ranks != mesh.ranks:
        raise ValueError(
            f"result sharded over processes {list(out.mesh.ranks)}, "
            f"replicated over {list(mesh.ranks)}")
    return gather_rows(out)


def invalidate_mesh_caches() -> None:
    """Nothing to drop: the port compiles nothing per mesh (the
    reference caches one executable per mesh here).  Kept so that code
    written against the reference runs unchanged."""


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _pad_block(block: torch.Tensor, per: int) -> torch.Tensor:
    """Pad a process's row block to ``per`` rows.  Pad rows repeat the
    block's last real row; a process with no real row (k far below the
    extent) feeds zeros.  Pad rows are dropped or zeroed afterwards, so
    their values never surface."""
    n, tail = block.shape[0], tuple(block.shape[1:])
    if n == per:
        return block
    if n == 0:
        return torch.zeros((per,) + tail, dtype=block.dtype,
                           device=block.device)
    return torch.cat([block, block[-1:].expand((per - n,) + tail)])


def _on(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _sweep_shards(local: torch.Tensor, epss, cfg, mesh: SweepMesh, k: int,
                  k_pad: int, mode: str, zero_pad: bool) -> ShardedRows:
    """This process's padded row block, cut into one block per shard, each
    moved to its shard's device and swept there by the single-device
    body; with ``zero_pad`` the rows at global positions >= k are zeroed.

    Shards on one device run in turn.  Each distinct device runs its
    shards on a thread of its own: a sweep's ``eigvalsh`` waits on the
    host for every row (``quant.per_row``), so one thread driving every
    card would keep all but one of them idle."""
    from repro_torch.core import predictors as P
    first, _ = _device_span(mesh)
    rpd = k_pad // mesh.size

    def run(i: int) -> torch.Tensor:
        dev = torch.device(mesh.devices[i])
        with _on(dev):
            out = P._sweep(local[i * rpd:(i + 1) * rpd].to(dev), epss, cfg,
                           mode)
        real = min(rpd, max(0, k - (first + i) * rpd))
        if zero_pad and real < rpd:
            out[real:] = 0
        return out

    by_device = {}
    for i, dev in enumerate(mesh.devices):
        by_device.setdefault(torch.device(dev), []).append(i)
    if len(by_device) == 1:
        blocks = [run(i) for i in range(len(mesh.devices))]
    else:
        with ThreadPoolExecutor(max_workers=len(by_device)) as pool:
            futures = [pool.submit(lambda idx: [(i, run(i)) for i in idx],
                                   idx) for idx in by_device.values()]
            done = dict(pair for fut in futures for pair in fut.result())
        blocks = [done[i] for i in range(len(mesh.devices))]
    return ShardedRows(tuple(blocks), k, k_pad, mesh)


def features_sweep_sharded(slices, epss, cfg=None, *,
                           mesh: Optional[SweepMesh] = None,
                           gather: bool = True, process_local: bool = False,
                           global_k: Optional[int] = None,
                           mode: str = "features"):
    """``features_sweep`` sharded over the slice axis of ``mesh`` (or the
    active one): (k, m, n) or (k, d, m, n) x (e,) -> the (k, e, w) tensor
    on the mesh's first device of this process (``gather=True``) or the
    padded :class:`ShardedRows` with pad rows zeroed (``gather=False``).
    ``slices`` is a tensor on any device or a numpy array; each shard's
    rows go to its device.

    A process-spanning mesh makes the call collective (see the module
    docstring): every member calls with the same shapes.
    ``process_local=True`` (with ``global_k=``) takes only this
    process's :func:`process_block` rows.  With no usable mesh (none, or
    an extent of 1) the single-device sweep runs, so callers can route
    unconditionally.  ``mode`` is "features", "quality" or "both"."""
    from repro_torch.core import predictors as P
    cfg = cfg if cfg is not None else P.PredictorConfig()
    mesh = active_sweep_mesh(mesh)
    if mesh is None:
        if process_local:
            raise ValueError(
                "process_local=True needs a process-spanning mesh "
                "(dist_init + make_sweep_mesh); no usable mesh is active")
        return P._sweep(_as_tensor(slices), epss, cfg, mode)
    if slices.ndim not in (3, 4):
        raise ValueError(
            f"features_sweep_sharded expects (k, m, n) or (k, d, m, n), "
            f"got {tuple(slices.shape)}")
    P._validate_eps_positive(epss)
    ext = mesh.size
    if mesh_spans_processes(mesh):
        if process_local:
            if global_k is None:
                raise ValueError(
                    "process_local=True needs global_k= (the total row count "
                    "across processes; each process passes only the rows "
                    "process_block(global_k, mesh) assigns it)")
            k = int(global_k)
            lo, hi = process_block(k, mesh)
            if slices.shape[0] != hi - lo:
                import torch.distributed as dist
                raise ValueError(
                    f"process {dist.get_rank()} must ingest rows [{lo}, {hi}) "
                    f"of the {k}-row global stack, got {slices.shape[0]} "
                    "rows (use process_block to split)")
            local = slices
        else:
            k = slices.shape[0]
            lo, hi = process_block(k, mesh)
            local = slices[lo:hi]
    else:
        if process_local:
            raise ValueError(
                "process_local=True is only meaningful on a "
                "process-spanning mesh; this mesh lives in one process")
        k, local = slices.shape[0], slices
    k_pad = -(-k // ext) * ext
    _, ndev = _device_span(mesh)
    out = _sweep_shards(_pad_block(_as_tensor(local), k_pad // ext * ndev),
                        epss, cfg, mesh, k, k_pad, mode, zero_pad=not gather)
    if not gather:
        return out
    return torch.from_numpy(gather_rows(out)[:k]).to(mesh.devices[0])


def sweep_padded(slices: torch.Tensor, epss, cfg=None, *,
                 k_pad: Optional[int] = None,
                 mesh: Optional[SweepMesh] = None, mode: str = "features"):
    """One sweep launch over a (k, m, n) or (k, d, m, n) batch padded to
    ``k_pad`` rows with copies of the last row.

    Returns the PADDED (k_pad, e, w) result (``w`` per
    ``predictors.SWEEP_MODE_WIDTHS[mode]``; ``mode`` is "features",
    "quality" or "both"); rows past ``k`` are the pad's and the caller
    keeps only the real ones (``scatter_requests``, ``gather_rows``).
    Under a mesh (``mesh=`` or the active one) a ``k_pad`` that is a
    multiple of the extent, and at least the extent, launches sharded
    and returns :class:`ShardedRows`; any other bucket runs the
    single-device sweep, identically on every process of a spanning
    mesh, so the branch cannot deadlock.  Every real row is the bits a
    launch of that row alone gives: the sweep body does not depend on
    the batch (``predictors``).  The reference's ``donate`` has no
    meaning here (a caller that no longer needs its stack drops it)."""
    from repro_torch.core import predictors as P
    cfg = cfg if cfg is not None else P.PredictorConfig()
    if slices.ndim not in (3, 4):
        raise ValueError(f"sweep_padded expects (k, m, n) or (k, d, m, n), "
                         f"got {tuple(slices.shape)}")
    k = slices.shape[0]
    k_pad = k if k_pad is None else int(k_pad)
    if k_pad < k:
        raise ValueError(f"k_pad={k_pad} smaller than batch k={k}")
    if k_pad > k:
        if k == 0:
            raise ValueError("sweep_padded cannot pad an empty batch")
        slices = _pad_block(slices, k_pad)
    mesh = active_sweep_mesh(mesh)
    if mesh is not None:
        ext = mesh.size
        if k_pad >= ext and k_pad % ext == 0:
            return features_sweep_sharded(slices, epss, cfg, mesh=mesh,
                                          gather=False, mode=mode)
    return P._sweep(slices, epss, cfg, mode)


def scatter_requests(out, sizes: Sequence[int]) -> list:
    """Split a padded (k_pad, e, w) sweep result into per-request row
    blocks: ``sizes`` are the requests' row counts in stacking order,
    and the trailing pad rows are dropped.  One host transfer (one
    gather of a sharded result, which every process of a spanning mesh
    must reach); returns a list of (sizes[i], e, w) numpy arrays."""
    host = gather_rows(out)
    total = int(np.sum(sizes)) if len(sizes) else 0
    if total > host.shape[0]:
        raise ValueError(f"request sizes sum to {total} but the result has "
                         f"only {host.shape[0]} rows")
    blocks, off = [], 0
    for s in sizes:
        blocks.append(host[off:off + s])
        off += s
    return blocks


def _even_bounds(k: int, parts: int, index: int) -> tuple:
    """Contiguous [lo, hi) block of ``k`` items for part ``index`` of
    ``parts`` (remainder spread over the leading parts)."""
    base, rem = divmod(k, parts)
    lo = index * base + min(index, rem)
    return lo, lo + base + (1 if index < rem else 0)


def training_crs(comp, slices, ebs: Sequence[float], *,
                 mesh: Optional[SweepMesh] = None) -> np.ndarray:
    """The (k, e) float64 compression-ratio table an ``EbGridModel`` fit
    needs: ``comp.cr(slices[i], ebs[j])`` for every pair.

    Under a process-spanning ``mesh`` (the one the training sweep sharded
    over) each process compresses only its :func:`_even_bounds` block of
    slices and the table is all-gathered as raw float64 bytes and summed
    over the processes; each cell has one non-zero addend, so the table
    is the serial loop's bit for bit.  Every member must make the call.
    Without such a mesh every pair runs here.

    The pairs run on a pool of one thread per CPU.  A run's cost is
    mostly its host-side lossless stage, which releases the interpreter
    lock, so the pool overlaps those; each result lands in its own cell."""
    k = len(slices)
    index, parts = (_process_position(mesh) if mesh_spans_processes(mesh)
                    else (0, 1))
    lo, hi = _even_bounds(k, parts, index)
    table = np.zeros((k, len(ebs)), np.float64)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        futures = {(i, j): pool.submit(comp.cr, slices[i], float(eps))
                   for i in range(lo, hi) for j, eps in enumerate(ebs)}
        for (i, j), fut in futures.items():
            table[i, j] = float(fut.result())
    if parts == 1:
        return table
    gathered = _allgather_bytes(torch.from_numpy(table).view(-1).view(
        torch.uint8), mesh, [table.nbytes] * parts)
    return sum(p.view(torch.float64).numpy().reshape(table.shape)
               for p in gathered)

"""Streaming sweep driver: fixed-budget chunks in, the full per-variable
feature tensor out.

``features_sweep`` takes a resident ``(k, ...)`` stack; this module
drives the same sweep over a ``data.source.DatasetSource`` variable
chunk by chunk, so a variable larger than the card (or the host)
featurizes within a bounded footprint:

* **Chunking** -- ``rows_per_chunk`` sizes every chunk to a byte budget
  and every chunk launches through ``dist.sweep.sweep_padded`` padded to
  the full-chunk row count, the ragged last one included.
* **Staging** -- a reader thread reads chunk ``n + 1`` (the memmap read
  and the f64 -> f32 conversion, straight into one of two pinned host
  buffers, and the running content digest) and uploads it with a
  non-blocking copy on a side stream, behind a queue of ``prefetch``
  chunks, while chunk ``n`` computes.  The compute stream waits on the
  upload's event, the device chunk is ``record_stream``-ed to it, and a
  pinned buffer is refilled only after its upload's event has passed.
  Results come back to pinned memory, and at most ``max_in_flight``
  launches stay undrained.  ``prefetch=0`` is the strictly synchronous
  read -> launch -> block loop.
* **Aggregation** -- the per-chunk ``(k_chunk, e, w)`` blocks concatenate
  into the ``(k, e, w)`` tensor.  A row's result does not depend on its
  batch (``core.predictors``), so the streamed tensor is BIT-EQUAL to
  one in-memory ``features_sweep`` of the variable.

On the CPU (``device="cpu"``) the same driver runs without pinned
memory or streams.

Under a mesh (``mesh=`` or ``dist.sharding.use_mesh``) a chunk whose
padded row count divides the extent launches sharded
(``sweep_padded``).  Under a process-spanning mesh the stream is
COLLECTIVE: every process runs the same schedule, reads and uploads only
its ``process_block`` rows of each chunk, and runs one collective sweep
per chunk, so every process returns the whole tensor.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import predictors as PRED
from repro_torch.data.source import DatasetSource, StreamingDigest, rows_per_chunk
from repro_torch.dist import sweep as DS

_STAGING_BUFFERS = 2      # pinned host buffers the reader fills in turn


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Knobs of the streaming driver.

    ``budget_bytes`` caps one chunk's float32 bytes (the host staging and
    the device upload per launch).  ``prefetch`` is how many chunks the
    reader thread stages ahead (0 = fully synchronous, no reader thread).
    ``max_in_flight`` bounds launched but undrained chunks."""
    budget_bytes: int = 64 << 20
    prefetch: int = 2
    max_in_flight: int = 2

    def __post_init__(self):
        if self.budget_bytes <= 0:
            raise ValueError(
                f"budget_bytes must be positive, got {self.budget_bytes}")
        if self.prefetch < 0 or self.max_in_flight < 1:
            raise ValueError(
                f"prefetch must be >= 0 and max_in_flight >= 1, got "
                f"prefetch={self.prefetch} max_in_flight={self.max_in_flight}")


def chunk_schedule(k: int, chunk: int, mesh=None) -> list:
    """The deterministic chunk plan: ``(lo, hi, read_lo, read_hi)`` per
    chunk.  The read range is what THIS process ingests: the whole chunk
    on one process, the chunk's ``dist.sweep.process_block`` rows under
    a process-spanning mesh.  Boundaries depend only on ``(k, chunk)``,
    so every process of a mesh computes the same schedule."""
    sched = []
    for lo in range(0, k, chunk):
        hi = min(lo + chunk, k)
        if DS.mesh_spans_processes(mesh):
            blo, bhi = DS.process_block(hi - lo, mesh)
            sched.append((lo, hi, lo + blo, lo + bhi))
        else:
            sched.append((lo, hi, lo, hi))
    return sched


class _Stager:
    """Reads chunks and brings them to ``device``: a fresh float32 array
    on the CPU; on the card, one of two pinned buffers filled by the
    reader and copied to a fresh device chunk on a side stream."""

    def __init__(self, source: DatasetSource, name: str, chunk: int,
                 device: torch.device, digest: Optional[StreamingDigest]):
        self.source, self.name, self.digest = source, name, digest
        self.device = device
        self.row_shape = source.meta(name).row_shape
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            self.pinned = [torch.empty((chunk,) + self.row_shape,
                                       dtype=torch.float32, pin_memory=True)
                           for _ in range(_STAGING_BUFFERS)]
            self.uploaded = [None] * _STAGING_BUFFERS
        self.count = 0

    def stage(self, rlo: int, rhi: int):
        """Chunk rows [rlo, rhi) on the device -> (tensor, upload event)."""
        rows = rhi - rlo
        if not self.cuda:
            arr = self.source.read_rows(self.name, rlo, rhi)
            if self.digest is not None:
                self.digest.update(arr)
            return torch.from_numpy(arr), None
        slot = self.count % _STAGING_BUFFERS
        self.count += 1
        if self.uploaded[slot] is not None:
            self.uploaded[slot].synchronize()   # its last upload is done
        host = self.pinned[slot][:rows]
        arr = self.source.read_rows_into(self.name, rlo, rhi, host.numpy())
        if self.digest is not None:
            self.digest.update(arr)
        with torch.cuda.device(self.device), torch.cuda.stream(self.copy_stream):
            dev = torch.empty(host.shape, dtype=torch.float32,
                              device=self.device)
            dev.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        self.uploaded[slot] = done
        return dev, done


_DONE = object()


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Put ``item`` unless the consumer has stopped; False if it has."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _reader(stager: _Stager, schedule, q: "queue.Queue",
            stop: threading.Event) -> None:
    """Reader-thread body: stage each chunk into the bounded queue; an
    exception travels through the queue, so the consumer re-raises it
    instead of hanging."""
    try:
        for lo, hi, rlo, rhi in schedule:
            if not _put(q, (lo, hi) + stager.stage(rlo, rhi), stop):
                return
        _put(q, _DONE, stop)
    except BaseException as exc:             # noqa: BLE001 -- re-raised
        _put(q, exc, stop)


def _staged_chunks(stager: _Stager, schedule, prefetch: int):
    """Iterate ``(lo, hi, tensor, event)`` chunks: behind a
    ``prefetch``-deep reader thread, or inline when ``prefetch == 0``."""
    if prefetch <= 0:
        for lo, hi, rlo, rhi in schedule:
            yield (lo, hi) + stager.stage(rlo, rhi)
        return
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    t = threading.Thread(target=_reader, args=(stager, schedule, q, stop),
                         daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=30.0)


def stream_features(
    source: DatasetSource,
    name: str,
    epss,
    cfg: Optional[PRED.PredictorConfig] = None,
    *,
    stream: Optional[StreamConfig] = None,
    mesh=None,
    digest: Optional[StreamingDigest] = None,
    quality: bool = False,
    device="cuda",
):
    """Featurize one variable of ``source`` chunk by chunk on ``device``:
    the full ``(k, e, 2)`` float32 numpy tensor, bit-equal to
    ``features_sweep(source.read(name), epss, cfg)`` on that device,
    with at most ``prefetch + 2`` budgeted chunks on the device.

    ``quality=True`` streams the fused "both" sweep and returns the pair
    ``(features, quality)``, each half bit-equal to its in-memory
    counterpart.  ``digest``: a ``StreamingDigest`` fed every chunk in
    row order; afterwards ``digest.digest()`` equals
    ``serve.method.slice_digest`` of the whole variable.  Under a mesh
    the chunks launch sharded (module docstring); a process-spanning
    mesh makes the call collective, and refuses ``digest`` (no process
    reads every byte)."""
    cfg = cfg if cfg is not None else PRED.PredictorConfig()
    stream = stream if stream is not None else StreamConfig()
    PRED._validate_eps_positive(epss)
    epss_np = np.asarray(epss, np.float32).reshape(-1)
    meta = source.meta(name)
    if len(meta.shape) not in (3, 4):
        raise ValueError(
            f"stream_features expects a (k, m, n) or (k, d, m, n) "
            f"variable, got {name!r} with shape {meta.shape}")
    mode = "both" if quality else "features"
    width = PRED.SWEEP_MODE_WIDTHS[mode]
    k = meta.rows
    if k == 0:
        empty = np.zeros((0, len(epss_np), width), np.float32)
        return (empty[..., :2], empty[..., 2:]) if quality else empty
    mesh = DS.active_sweep_mesh(mesh)
    multiproc = DS.mesh_spans_processes(mesh)
    if multiproc and digest is not None:
        raise ValueError(
            "digest= is single-process only: under a process-spanning "
            "mesh each process reads only its block of every chunk, so "
            "no single process observes the variable's full byte stream")
    device = torch.device(device)
    chunk = rows_per_chunk(meta, stream.budget_bytes)
    schedule = chunk_schedule(k, chunk, mesh)
    stager = _Stager(source, name, chunk, device, digest)
    eps_t = torch.as_tensor(epss_np, device=device)
    compute = torch.cuda.current_stream(device) if stager.cuda else None

    results: list = [None] * len(schedule)
    pending: deque = deque()             # (index, result, event, rows)

    def drain_one() -> None:
        idx, out, done, rows = pending.popleft()
        if done is not None:
            done.synchronize()
        results[idx] = DS.gather_rows(out)[:rows]

    for idx, (lo, hi, rows_t, uploaded) in enumerate(
            _staged_chunks(stager, schedule, stream.prefetch)):
        if uploaded is not None:
            compute.wait_event(uploaded)
            rows_t.record_stream(compute)
        if multiproc:
            # one collective sweep of the chunk; its gather is the
            # processes' synchronization point
            results[idx] = DS.features_sweep_sharded(
                rows_t, eps_t, cfg, mesh=mesh, process_local=True,
                global_k=hi - lo, mode=mode).cpu().numpy()
            continue
        out = DS.sweep_padded(rows_t, eps_t, cfg, k_pad=chunk, mesh=mesh,
                              mode=mode)
        del rows_t
        if stager.cuda and isinstance(out, torch.Tensor):
            host = torch.empty(out.shape, dtype=torch.float32,
                               pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(compute)
        else:
            host, done = out, None
        pending.append((idx, host, done, hi - lo))
        while pending and (stream.prefetch <= 0
                           or len(pending) > stream.max_in_flight):
            drain_one()
    while pending:
        drain_one()
    full = np.concatenate(results, axis=0)
    if quality:
        return full[..., :2], full[..., 2:]
    return full


def stream_dataset(
    source: DatasetSource,
    epss,
    cfg: Optional[PRED.PredictorConfig] = None,
    *,
    stream: Optional[StreamConfig] = None,
    mesh=None,
    digests: Optional[Dict[str, str]] = None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """:func:`stream_features` over every variable of ``source``; returns
    ``{variable: (k, e, 2)}``.  ``digests``, when given and on one
    process, is filled with each variable's streaming content digest."""
    out: Dict[str, np.ndarray] = {}
    multiproc = DS.mesh_spans_processes(DS.active_sweep_mesh(mesh))
    for name in source.variables():
        d = (StreamingDigest() if digests is not None and not multiproc
             else None)
        out[name] = stream_features(source, name, epss, cfg, stream=stream,
                                    mesh=mesh, digest=d, device=device)
        if d is not None:
            digests[name] = d.digest()
    return out

"""Method-agnostic serving core: micro-batching, a feature cache and one
launch per batch group, on one device.

``serve.method`` holds the workloads (featurize, UC1 ``find_eb``, UC2
``best_compressor``, the int8 ``kv_gate``, the advisor, UC3
``find_setting`` and ``quality``) and ``serve.registry`` names them.
``SweepService`` knows nothing about any of them: its queue, cache and
launch path handle only :class:`~repro_torch.serve.method.MethodRequest`
items and launchers.

Every UC1 bisection or UC2 ranking called directly pays a featurization
launch of its own; the paper's speedups assume that cost is amortized
across queries.  The service amortizes it in three layers:

1. **Micro-batching queue** -- concurrent ``submit*`` calls enqueue
   pre-processed requests; one worker thread flushes when the pending
   rows reach ``max_batch_slices`` or the oldest request has waited the
   current window.  Each flushed batch becomes ONE launch per
   (launcher, trailing shape, launch config) group -- methods sharing a
   launcher coalesce -- and the post-processing pool completes the
   requests' futures off the worker thread.
2. **Cross-request feature cache** -- content hash of a row's float32
   bytes + launch config -> per-eb rows, LRU under a byte budget.  A
   repeated UC1 or UC2 on a hot field is served with ZERO launches.
   Within a batch, rows of one digest are launched once, at the union
   of the ebs their requests read.
3. **Buckets** -- a launch is padded to the methods' row buckets
   (powers of two by default, by repeating its last row) and its eb
   union to an eb bucket (by repeating its last eb), so traffic falls
   into a few launch shapes; ``warmup()`` builds the kernels and runs
   each registered method's buckets once.

Every served result is bit-equal to the port's direct call: launches
are row- and eb-independent (``serve.method``), UC1 runs the exact
``usecases`` bisection on a ``SliceCache`` seeded with the served rows,
and UC2/UC3 feed the served rows to the same model evaluations.

Staging and threads
-------------------
The worker packs each group into a pinned host buffer kept per padded
shape, uploads it with a non-blocking copy and records an event after
the copy; the buffer is refilled only after that event has completed,
so a batch never reads the next batch's rows.  The results come back in
one device-to-host copy, which waits for the launch.  The worker and
the post-processing threads set the service's device; rows handed to
futures are host numpy arrays.  A launch that fails fails its batch's
futures with the error; nothing retries elsewhere.

Adaptive window and admission control
-------------------------------------
A flush that found the queue saturated halves the window toward
``min_wait_ms``; an idle deadline flush grows it back toward
``max_wait_ms`` (``adapt_window``).  ``max_queue_rows`` makes ``submit*``
raise :class:`RetryAfter` with a load-proportional backoff hint
instead of queueing without bound, and ``max_live_batches`` bounds the
batches launched but not yet post-processed.

A cached digest is admitted only once ``cache_admit_after`` requests
have sighted it (concurrent requests in one batch count one each), so a
scan over cold fields never evicts the working set.

The reference's leader/follower fabric over a process-spanning mesh
(heartbeats, recovery) comes with the distributed layer.

Usage::

    from repro_torch.serve.sweep_service import SweepService
    with SweepService() as svc:                     # device="cuda"
        f1 = svc.submit_find_eb(grid_model, slice_a, target_cr=8.0)
        f2 = svc.submit_best_compressor(models, slice_b, eps)
        f3 = svc.submit_featurize(stack, ebs)
        eps, cr = f1.result()
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import predictors as P
from repro_torch.dist import sweep as DS
from repro_torch.serve.method import (Item, Launcher, MethodRequest,
                                      _eps_bucket, _f32, _row_bucket,
                                      slice_digest)
from repro_torch.serve.registry import MethodRegistry, default_registry

__all__ = ["FeatureCache", "RetryAfter", "ServiceConfig", "SweepService",
           "_eps_bucket", "_f32", "_row_bucket", "slice_digest"]

_LAT_RING = 512                       # per-method latency samples kept


class RetryAfter(RuntimeError):
    """Backpressure rejection: the queue is full
    (``ServiceConfig.max_queue_rows``).  ``retry_after_s`` is the
    load-proportional backoff hint (pending rows over the recent drain
    rate, floored at the window); nothing was enqueued."""

    def __init__(self, message: str, *, retry_after_s: float,
                 pending_rows: int):
        self.retry_after_s = float(retry_after_s)
        self.pending_rows = int(pending_rows)
        super().__init__(
            f"{message} ({pending_rows} rows pending; retry after "
            f"~{self.retry_after_s:.3f}s)")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    max_batch_slices: int = 64       # flush when this many rows are pending
    max_wait_ms: float = 2.0         # micro-batch window CEILING (idle value)
    min_wait_ms: float = 0.0         # adaptive window floor under load
    adapt_window: bool = True        # load-aware window (module docstring)
    max_live_batches: int = 2        # launched-but-not-post-processed bound
    post_workers: int = 2            # host-side post-processing pool size
    cache_bytes: int = 4 << 20       # cross-request feature-cache budget
    max_eps_per_launch: int = 32     # chunk wider eb unions across launches
    cache_admit_after: int = 2       # sightings before a digest is cached
    max_queue_rows: int = 0          # 0 = unbounded; else RetryAfter beyond
    pcfg: P.PredictorConfig = dataclasses.field(
        default_factory=P.PredictorConfig)


class FeatureCache:
    """Cross-request feature cache: (row digest, launch config) ->
    {float32 eb key -> row}, LRU over digests under a byte budget (each
    row's own ``nbytes`` counts).

    A digest's rows are stored only once it has been *sighted*
    (``record_sighting``, one count per request touching it) at least
    ``admit_after`` times; the sighting ring is a bounded FIFO of bare
    digests."""

    ROW_BYTES = 2 * 4                # a sweep row (sizing docs and tests)
    ENTRY_OVERHEAD = 128             # digest + dict bookkeeping estimate

    def __init__(self, max_bytes: int, admit_after: int = 1,
                 seen_capacity: int = 65536):
        self.max_bytes = int(max_bytes)
        self.admit_after = max(1, int(admit_after))
        self.seen_capacity = int(seen_capacity)
        self._entries: "collections.OrderedDict[tuple, dict]" = \
            collections.OrderedDict()
        self._seen: "collections.OrderedDict[tuple, int]" = \
            collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.admissions_denied = 0
        self._lock = threading.Lock()

    def record_sighting(self, key: tuple, n: int = 1) -> int:
        """Count a request touching ``key``; returns the running total.
        Admitted digests stop counting (their entry is the signal)."""
        with self._lock:
            if key in self._entries:
                return self.admit_after
            seen = self._seen.get(key, 0) + n
            self._seen[key] = seen
            self._seen.move_to_end(key)
            while len(self._seen) > self.seen_capacity:
                self._seen.popitem(last=False)
            return seen

    def get(self, key: tuple, eps_key: float) -> Optional[np.ndarray]:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None or eps_key not in ent:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return ent[eps_key]

    def put(self, key: tuple, eps_key: float, row: np.ndarray) -> bool:
        """Store one (digest, eb) row; False when the admission policy
        rejects the (cold, under-sighted) digest."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                if self.admit_after > 1 and \
                        self._seen.get(key, 0) < self.admit_after:
                    self.admissions_denied += 1
                    return False
                self._seen.pop(key, None)
                ent = self._entries[key] = {}
                self._bytes += self.ENTRY_OVERHEAD
            old = ent.get(eps_key)
            self._bytes += row.nbytes - (0 if old is None else old.nbytes)
            ent[eps_key] = row
            self._entries.move_to_end(key)
            # never evict the digest just written: its batch still reads it
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, dropped = self._entries.popitem(last=False)
                self._bytes -= self.ENTRY_OVERHEAD + sum(
                    r.nbytes for r in dropped.values())
                self.evictions += 1
            return True

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "entries": len(self),
                    "bytes": self._bytes,
                    "admissions_denied": self.admissions_denied,
                    "pending_sightings": len(self._seen)}


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("SweepService(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to serve on the "
                               "host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class SweepService:
    """Coalesces concurrent requests of every registered method into
    batched launches on one device (module docstring)."""

    def __init__(self, scfg: Optional[ServiceConfig] = None, *,
                 registry: Optional[MethodRegistry] = None,
                 device="cuda"):
        self.scfg = scfg if scfg is not None else ServiceConfig()
        self.registry = registry if registry is not None else \
            default_registry()
        self.device = _resolve_device(device)
        self.role = "leader"
        self.cache = FeatureCache(self.scfg.cache_bytes,
                                  admit_after=self.scfg.cache_admit_after)
        self._queue: "collections.deque[MethodRequest]" = collections.deque()
        self._cond = threading.Condition()
        self._stop = False
        self._closed = False
        self._launches = 0
        self._rows_launched = 0
        self._pad_rows = 0
        self._batches = 0
        self._requests = collections.Counter()
        self._executables: set = set()   # launch shapes run so far
        # padded stack shape -> (pinned host buffer, event after its
        # last upload); only the worker thread (and warmup) fill them
        self._staging: Dict[Tuple[int, ...], list] = {}
        self._staging_lock = threading.Lock()
        self._window_ms = float(self.scfg.max_wait_ms)
        self._window_shrinks = 0
        self._window_grows = 0
        self._live = threading.Semaphore(max(1, self.scfg.max_live_batches))
        self._live_now = 0
        self._post = ThreadPoolExecutor(
            max_workers=max(1, self.scfg.post_workers),
            thread_name_prefix="sweep-post", initializer=self._bind_device)
        self._mlock = threading.Lock()
        self._mstats: Dict[str, dict] = {}
        self._rejected = 0
        self._ema_batch_s = 0.0      # drain-time estimate for RetryAfter
        self._ema_rows_per_s = 0.0   # drain-rate estimate for RetryAfter
        self._worker = threading.Thread(target=self._loop,
                                        name="sweep-service", daemon=True)
        self._worker.start()

    def _bind_device(self) -> None:
        """Make the service's card the current device of this thread."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, method: str, *args, **kwargs) -> Future:
        """Submit to any registered method by name.  Its ``pre_process``
        (validation + digesting) runs on the CALLER's thread; the Future
        resolves to its ``post_process`` result."""
        req = self.registry.get(method).pre_process(self, *args, **kwargs)
        return self._submit(req)

    def submit_featurize(self, slices, epss,
                         cfg: Optional[P.PredictorConfig] = None) -> Future:
        """(k, m, n) or (k, d, m, n) stack x (e,) ebs -> Future[(k, e, 2)
        numpy], bit-equal to ``features_sweep(slices, epss, cfg)``."""
        return self.submit("featurize", slices, epss, cfg)

    def submit_find_eb(self, grid_model, data, target_cr: float,
                       tol: float = 0.02, max_iters: int = 32) -> Future:
        """UC1: Future[(eps, predicted_cr)], bit-equal to
        ``usecases.find_error_bound_for_cr``."""
        return self.submit("find_eb", grid_model, data, target_cr,
                           tol=tol, max_iters=max_iters)

    def submit_best_compressor(self, models: Dict[str, object], data,
                               eps: float) -> Future:
        """UC2: Future[(best_name, preds)], bit-equal to
        ``usecases.best_compressor``."""
        return self.submit("best_compressor", models, data, eps)

    def submit_kv_gate(self, leaves) -> Future:
        """Array leaves -> Future[(k,) float32 predicted int8 CRs], equal
        to ``predicted_cr_int8`` of each leaf."""
        return self.submit("kv_gate", leaves)

    def submit_advise(self, models: Dict[str, object], stack) -> Future:
        """Advisor chunk: a (k, m, n) / (k, d, m, n) stack + the
        compressors' ``EbGridModel``s on one eb grid -> Future[{
        "compressors", "ebs", "cr": (k, n_comp, e)}]."""
        return self.submit("advise", models, stack)

    def submit_quality(self, slices, epss,
                       cfg: Optional[P.PredictorConfig] = None) -> Future:
        """(k, m, n) or (k, d, m, n) stack x (e,) ebs -> Future[(k, e, 2)
        [PSNR dB, NRMSE] numpy], bit-equal to ``quality_sweep``."""
        return self.submit("quality", slices, epss, cfg)

    def submit_find_setting(self, models: Dict[str, object], data,
                            cr_floor: float, psnr_floor: float,
                            tol: float = 1e-3,
                            max_iters: int = 48) -> Future:
        """UC3: Future[JointSetting], bit-equal to
        ``usecases.find_setting``."""
        return self.submit("find_setting", models, data, cr_floor,
                           psnr_floor, tol=tol, max_iters=max_iters)

    def featurize(self, slices, epss, cfg=None) -> np.ndarray:
        return self.submit_featurize(slices, epss, cfg).result()

    def find_eb(self, grid_model, data, target_cr, **kw) -> tuple:
        return self.submit_find_eb(grid_model, data, target_cr, **kw).result()

    def best_compressor(self, models, data, eps) -> tuple:
        return self.submit_best_compressor(models, data, eps).result()

    def kv_gate(self, leaves) -> np.ndarray:
        return self.submit_kv_gate(leaves).result()

    def advise(self, models, stack) -> dict:
        return self.submit_advise(models, stack).result()

    def quality(self, slices, epss, cfg=None) -> np.ndarray:
        return self.submit_quality(slices, epss, cfg).result()

    def find_setting(self, models, data, cr_floor, psnr_floor, **kw):
        return self.submit_find_setting(models, data, cr_floor,
                                        psnr_floor, **kw).result()

    def stats(self) -> dict:
        """The reference's counters.  Each method also reports ``post_s``:
        the seconds its requests spent in ``post_process``, so the sum
        over methods is the post-processing pool's busy time."""
        with self._cond:
            queue_rows = sum(r.rows for r in self._queue)
            pending: collections.Counter = collections.Counter()
            for r in self._queue:
                pending[r.kind] += r.rows
        with self._mlock:
            methods = {}
            for name, st in self._mstats.items():
                lat = np.asarray(st["lat"], np.float64)

                def pct(q, lat=lat):
                    return float(np.percentile(lat, q)) if lat.size else 0.0

                methods[name] = {
                    "completed": st["completed"], "failed": st["failed"],
                    "rows": st["rows"],
                    "pending_rows": int(pending.get(name, 0)),
                    "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
                    "mean_ms": float(lat.mean()) if lat.size else 0.0,
                    "post_s": st["post_s"]}
            live = self._live_now
        return {"role": self.role,
                "device": str(self.device),
                "launches": self._launches,
                "rows_launched": self._rows_launched,
                "pad_rows": self._pad_rows,
                "batches": self._batches,
                "executables": len(self._executables),
                "requests": dict(self._requests),
                "methods": methods,
                "queue_rows": queue_rows,
                "window_ms": self._window_ms,
                "window_shrinks": self._window_shrinks,
                "window_grows": self._window_grows,
                "live_batches": live,
                "epoch": 0,
                "transport": "local",
                "recoveries": 0,
                "last_recovery_s": 0.0,
                "rejected": self._rejected,
                "procs": [0],
                "cache": self.cache.stats()}

    @property
    def launches(self) -> int:
        return self._launches

    def warmup(self, shapes: Optional[Sequence[Tuple[int, ...]]] = None,
               grid_sizes: Sequence[int] = (1,),
               row_buckets: Sequence[int] = (1,),
               cfg: Optional[P.PredictorConfig] = None) -> None:
        """Build the kernels (``nvcc`` at first use), allocate the
        staging buffers and run one launch per expected launch shape, so
        first requests pay none of it.

        With explicit ``shapes`` (slice (m, n) / volume (d, m, n) shapes
        x eb-grid sizes x row buckets) this warms the sweep launcher.
        With NO arguments it walks every registered method's
        ``warmup_spec``; methods sharing a launcher launch each shape
        once.  Warmup launches are not counted in ``launches``."""
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build()
        if shapes is None:
            done: set = set()
            for m in self.registry.methods():
                spec = m.warmup_spec(self.scfg)
                wcfg = m.launcher.default_cfg(self.scfg)
                for shape in spec.shapes:
                    for e in spec.grid_sizes:
                        for k in spec.row_buckets:
                            k_pad = self._k_pad((m,), int(k))
                            sig = self._sig(m.launcher, k_pad, tuple(shape),
                                            m.launcher.eps_bucket(int(e)),
                                            wcfg)
                            if sig not in done:
                                done.add(sig)
                                self._warm_one(m.launcher, tuple(shape),
                                               int(e), k_pad, wcfg)
            return
        cfg = cfg if cfg is not None else self.scfg.pcfg
        sweep = self.registry.get("featurize").launcher
        for shape in shapes:
            for e in grid_sizes:
                for k in row_buckets:
                    self._warm_one(sweep, tuple(shape), int(e),
                                   _row_bucket(int(k)), cfg)

    def _warm_one(self, launcher: Launcher, shape: Tuple[int, ...],
                  e: int, k_pad: int, cfg) -> None:
        e_pad = launcher.eps_bucket(e)
        epss = np.full((e_pad,), launcher.warmup_eps, np.float32)
        self._run(launcher, [np.zeros(shape, np.float32)], epss, cfg, k_pad)
        self._executables.add(self._sig(launcher, k_pad, shape, e_pad, cfg))

    def close(self) -> None:
        """Serve what is queued, then stop the worker and the
        post-processing pool.  Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            self._cond.notify_all()
        self._worker.join()
        self._post.shutdown(wait=True)

    def __enter__(self) -> "SweepService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # worker: micro-batching loop
    # ------------------------------------------------------------------

    def _submit(self, req: MethodRequest) -> Future:
        with self._cond:
            if self._stop:
                raise RuntimeError("SweepService is closed")
            limit = self.scfg.max_queue_rows
            pending = sum(r.rows for r in self._queue) if limit else 0
            # never reject into an empty queue: a single over-wide
            # request must still be servable (it flushes alone)
            if limit and pending and pending + req.rows > limit:
                self._rejected += 1
                raise RetryAfter(
                    "sweep-service queue is full",
                    retry_after_s=self._retry_after_estimate(pending),
                    pending_rows=pending)
            self._queue.append(req)
            self._requests[req.kind] += 1
            self._cond.notify_all()
        return req.future

    def _retry_after_estimate(self, pending: int) -> float:
        """Queued rows over the recent drain rate, floored at the current
        window (an idle service clears nothing faster than one window)."""
        window_s = self._window_ms / 1e3
        if self._ema_rows_per_s > 0:
            return max(window_s, pending / self._ema_rows_per_s)
        batches = -(-pending // max(1, self.scfg.max_batch_slices))
        return max(window_s, self._ema_batch_s * batches)

    def _loop(self) -> None:
        self._bind_device()
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            self._live.acquire()
            with self._mlock:
                self._live_now += 1
            t0 = time.perf_counter()
            try:
                self._process(batch)
            except Exception as exc:  # fail this batch's requests only
                self._release_live()
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(exc)
                    self._note_done(req, ok=False)
            else:
                dt = time.perf_counter() - t0
                rows = sum(r.rows for r in batch)
                self._ema_batch_s = (dt if not self._ema_batch_s
                                     else 0.7 * self._ema_batch_s + 0.3 * dt)
                if dt > 0:
                    rps = rows / dt
                    self._ema_rows_per_s = (
                        rps if not self._ema_rows_per_s
                        else 0.7 * self._ema_rows_per_s + 0.3 * rps)

    def _release_live(self) -> None:
        with self._mlock:
            self._live_now -= 1
        self._live.release()

    def _note_done(self, req: MethodRequest, ok: bool = True,
                   post_s: float = 0.0) -> None:
        lat_ms = (time.perf_counter() - req.t_submit) * 1e3
        with self._mlock:
            st = self._mstats.setdefault(req.kind, {
                "completed": 0, "failed": 0, "rows": 0, "post_s": 0.0,
                "lat": collections.deque(maxlen=_LAT_RING)})
            st["completed" if ok else "failed"] += 1
            st["rows"] += req.rows
            st["post_s"] += post_s
            st["lat"].append(lat_ms)

    def _next_batch(self) -> Optional[List[MethodRequest]]:
        """Block until a batch is ready: pending rows reach
        ``max_batch_slices``, the OLDEST pending request has waited the
        current window, or the service is closing (drains the rest)."""
        with self._cond:
            while True:
                if self._queue:
                    rows = sum(r.rows for r in self._queue)
                    deadline = (self._queue[0].t_submit +
                                self._window_ms / 1e3)
                    remaining = deadline - time.perf_counter()
                    if (rows >= self.scfg.max_batch_slices or
                            remaining <= 0 or self._stop):
                        batch, total = [], 0
                        while self._queue and (
                                total < self.scfg.max_batch_slices or
                                not batch):
                            req = self._queue.popleft()
                            batch.append(req)
                            total += req.rows
                        if not self._stop:
                            self._note_flush(
                                total >= self.scfg.max_batch_slices or
                                bool(self._queue))
                        return batch
                    self._cond.wait(timeout=remaining)
                elif self._stop:
                    return None
                else:
                    self._cond.wait()

    def _note_flush(self, loaded: bool) -> None:
        """Adapt the window to the flush that just happened: a saturated
        flush halves it toward ``min_wait_ms``, an idle deadline flush
        grows it back toward ``max_wait_ms``.  Called under
        ``self._cond``."""
        if not self.scfg.adapt_window:
            return
        if loaded:
            self._window_ms = max(float(self.scfg.min_wait_ms),
                                  self._window_ms * 0.5)
            self._window_shrinks += 1
        else:
            if self._window_ms < self.scfg.max_wait_ms:
                self._window_grows += 1
            self._window_ms = min(float(self.scfg.max_wait_ms),
                                  max(self._window_ms * 2.0,
                                      self.scfg.max_wait_ms / 16.0))

    # ------------------------------------------------------------------
    # batch resolution, launch and scatter-back
    # ------------------------------------------------------------------

    @staticmethod
    def _sig(launcher: Launcher, k_pad: int, shape: Tuple[int, ...],
             e_pad: int, cfg) -> tuple:
        return (launcher.name, k_pad, shape, e_pad, cfg)

    def _k_pad(self, methods, k: int) -> int:
        """Padded row count of a launch whose items came from
        ``methods``: the smallest covering bucket of their merged
        ladders, the power-of-two ladder when any method declares none,
        and the power-of-two ladder past the largest declared bucket."""
        ladders = [m.batch_buckets for m in methods]
        if not ladders or any(lad is None for lad in ladders):
            return _row_bucket(k)
        for b in sorted({b for lad in ladders for b in lad}):
            if b >= k:
                return b
        return _row_bucket(k)

    def _process(self, batch: List[MethodRequest]) -> None:
        self._batches += 1
        # 1. resolve the cache; group the misses by (launcher, trailing
        #    shape, launch config), one entry per digest with the union
        #    of the ebs its requests read
        local: Dict[Tuple[tuple, float], np.ndarray] = {}
        need: Dict[tuple, dict] = {}
        for req in batch:
            # one sighting per REQUEST touching a digest
            for key in {it.key for it in req.items}:
                self.cache.record_sighting(key)
        for req in batch:
            for it in req.items:
                for ek in it.eps_keys:
                    if (it.key, ek) in local:
                        continue
                    row = self.cache.get(it.key, ek)
                    if row is not None:
                        local[(it.key, ek)] = row
                    else:
                        group = need.setdefault(
                            (req.method.launcher, it.x.shape, it.key[1]),
                            {"items": {}, "methods": set()})
                        group["methods"].add(req.method)
                        entry = group["items"].setdefault(
                            it.key, (it.x, set()))
                        entry[1].add(ek)
        # 2. ONE launch per group (eb unions wider than
        #    max_eps_per_launch are chunked)
        for (launcher, _, cfg), group in need.items():
            union = sorted({e for _, es in group["items"].values()
                            for e in es})
            step = self.scfg.max_eps_per_launch
            for lo in range(0, len(union), step):
                self._launch(launcher, group, union[lo:lo + step], cfg,
                             local)

        # 3. complete the requests on the post-processing pool, so the
        #    worker moves on to the next batch

        def rows_for(item: Item, _local=local) -> np.ndarray:
            return np.stack([_local[(item.key, ek)]
                             for ek in item.eps_keys])

        def complete():
            try:
                for req in batch:
                    t0 = time.perf_counter()
                    try:
                        out = req.method.post_process(req, rows_for)
                        post_s = time.perf_counter() - t0
                        req.future.set_result(out)
                        self._note_done(req, ok=True, post_s=post_s)
                    except Exception as exc:
                        if not req.future.done():
                            req.future.set_exception(exc)
                        self._note_done(req, ok=False,
                                        post_s=time.perf_counter() - t0)
            finally:
                self._release_live()

        self._post.submit(complete)

    def _upload(self, rows: List[np.ndarray], k_pad: int) -> torch.Tensor:
        """The (k_pad, ...) stack of ``rows`` on the device, pad rows
        repeating the last one.  It is packed into a host buffer kept
        per padded shape (pinned for a card) and copied without
        blocking; an event after the copy is waited on before the buffer
        is filled again.  The lock keeps warmup and the worker from
        filling one buffer at once."""
        k = len(rows)
        shape = (k_pad,) + rows[0].shape
        with self._staging_lock:
            slot = self._staging.get(shape)
            if slot is None:
                slot = self._staging[shape] = [torch.empty(
                    shape, dtype=torch.float32,
                    pin_memory=self.device.type == "cuda"), None]
            buf, done = slot
            if done is not None:
                done.synchronize()
            for i, x in enumerate(rows):
                buf[i].copy_(torch.from_numpy(x))
            buf[k:] = buf[k - 1]
            if self.device.type != "cuda":
                return buf.clone()
            stack = buf.to(self.device, non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record()
            return stack

    def _run(self, launcher: Launcher, rows: List[np.ndarray],
             epss: np.ndarray, cfg, k_pad: int) -> List[np.ndarray]:
        """Upload ``rows``, launch, and bring the k real (e, R) row
        blocks back to the host in one device-to-host copy, which waits
        for the launch (pad rows are dropped)."""
        out = launcher.launch(self._upload(rows, k_pad), epss, cfg, k_pad)
        return [b[0] for b in DS.scatter_requests(out, [1] * len(rows))]

    def _launch(self, launcher: Launcher, group: dict,
                eps_chunk: List[float], cfg,
                local: Dict[Tuple[tuple, float], np.ndarray]) -> None:
        digests = group["items"]
        order = list(digests)
        k = len(order)
        k_pad = self._k_pad(group["methods"], k)
        e_pad = launcher.eps_bucket(len(eps_chunk))
        epss = np.asarray(
            eps_chunk + [eps_chunk[-1]] * (e_pad - len(eps_chunk)),
            np.float32)
        blocks = self._run(launcher, [digests[key][0] for key in order],
                           epss, cfg, k_pad)
        for key, block in zip(order, blocks):
            for j, ek in enumerate(eps_chunk):
                # owned copy: a view would pin the whole batch result
                row = np.array(block[j])
                local[(key, ek)] = row
                self.cache.put(key, ek, row)
        self._launches += 1
        self._rows_launched += k
        self._pad_rows += k_pad - k
        self._executables.add(self._sig(launcher, k_pad,
                                        digests[order[0]][0].shape, e_pad,
                                        cfg))

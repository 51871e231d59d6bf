"""Method-agnostic serving core: micro-batching, a feature cache and one
launch per batch group, on one device, a mesh of shards, or a mesh that
spans processes.

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
futures are host numpy arrays.  In one process a launch that fails
fails its batch's futures with the error; across processes a lost peer
is retried on the survivors (Faults and recovery, below).

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

Meshes
------
``SweepService(mesh=...)`` (or a service made inside
``dist.sharding.use_mesh``) captures the mesh at construction and shards
every sweep launch over it (``dist.sweep.sweep_padded``): each bucket
is rounded up to a multiple of the mesh's extent, the stack is staged on
the host and each shard's block moves to its own device.  Rows are
mesh-independent, so every served result is the same bits as without a
mesh.

Leader/follower on a process-spanning mesh
------------------------------------------
On a mesh made inside a process group (``launch.mesh.dist_init`` +
``make_sweep_mesh``) the mesh's first process is the **leader**: it owns
the queue, the cache and ``submit*``.  Every other process is a
**follower**: its worker joins each of the leader's launches until the
leader closes, and its :meth:`SweepService.serve` blocks until then.
Per launch the leader, holding the launch lock (so followers see one
stream of launches: batches, ``warmup()`` and ``close()``):

1. sets the launch's sequence key in the group's store
   (``launch.mesh.coordination_store``);
2. broadcasts a fixed header over the mesh's group,
   ``[op, k, k_pad, rank, t0, t1, t2, e_pad, launcher id]`` (the id from
   ``registry.launcher_id``), then the k rows and the eb vector as raw
   bytes (CPU tensors on gloo, CUDA tensors on NCCL);
3. feeds the broadcast copies to the launcher, as each follower does
   with the launcher's ``follower_cfg``; the gather is the one
   synchronization point.

A follower waits for the next sequence key in the store, in short
polls, and enters the header broadcast only once it is set: an idle
spell longer than the group's timeout never leaves a follower inside a
collective.  ``close()`` drains the queue and broadcasts the shutdown
header.  Every process must construct its services in the same order,
with the same ``ServiceConfig`` and registry; while a service is live,
its mesh's group carries nothing else.  The leader serves only the
service's own engine config (``_check_cfg``).

Faults and recovery
-------------------
The fabric survives the loss of followers (``dist.fault``).  Every
process of the mesh publishes a heartbeat to the store every
``heartbeat_s`` on a client of its own; the leader watches its
followers', a follower the leader's.  The leader runs each launch on a
sacrificial thread under ``launch_timeout_s`` (keep it below the group's
timeout, and above a first launch's kernel build).  When the launch
raises or its deadline passes, the leader watches the heartbeats for one
staleness window (``6 * heartbeat_s``, at least 1 s):

* a plain error with every heartbeat fresh is the batch's own and fails
  only its futures;
* a failed collective or store call marks the followers whose heartbeat
  stood still as lost (none, if every one beats: the group is left all
  the same);
* an expired deadline with fresh heartbeats evicts every follower (a
  wedged peer cannot be told apart from inside the collective).

It then publishes a new *epoch* with the surviving ranks in the store,
meets them at a bounded barrier (shedding whoever misses it) and runs
the launch again on the survivors: the in-flight batch's futures, and
every later one, complete with the same bits.  No collective runs on the
group after that -- a faulted gloo group keeps broken pair connections,
and on NCCL the survivors abort the group first, so that the watchdog,
which under PyTorch's default ``TORCH_NCCL_ASYNC_ERROR_HANDLING=3`` would
end the process, finds nothing stuck.  Each later launch goes through the
store: the leader writes each survivor's contiguous block of rows
(proportional to its share of the original mesh) under its own key, the
ebs and a JSON header (``{_kvp}/l/{epoch}/{seq}/...``); every survivor
sweeps its block on its own device, without a mesh, and writes its rows
back; the leader deletes the launch's keys once it has read them all.
Left alone, the leader serves on its own device.

A follower waits for each launch in the store while it watches the
shutdown key, the epoch and the leader's heartbeat, and joins the launch
on a sacrificial thread with no deadline of its own: it abandons the join
only on a new epoch, the shutdown key or a stale leader.  It then rejoins
the published epoch at the barrier, or learns it was evicted
(``FabricError(kind="evicted")``) or that the leader is gone
(``kind="leader_lost"``; a leader that served the store itself shows as a
store error), and its ``serve()`` raises that.  On the way out it writes
a goodbye key, which the leader's ``close()`` waits for, within a bound,
before it lets its store go.  A fault the leader cannot recover from
fails every pending and queued future with ``FabricError``, refuses later
``submit*`` calls and marks the store's shutdown key "failed".

A collective abandoned on a faulted group may still wait in a daemon
thread when its process ends; should it return while the interpreter
shuts down, the process aborts.  So a process whose fabric faulted
(``stats()["transport"] == "kv"``, or ``serve()`` raised) leaves with
``os._exit`` once its work is written, as ``launch.sweep_serve`` does.

Usage::

    from repro_torch.serve.sweep_service import SweepService
    with SweepService() as svc:                     # device="cuda"
        f1 = svc.submit_find_eb(grid_model, slice_a, target_cr=8.0)
        f2 = svc.submit_best_compressor(models, slice_b, eps)
        f3 = svc.submit_featurize(stack, ebs)
        eps, cr = f1.result()

    # across processes: every process joins the group, then
    M.dist_init(address, num_processes=n, process_id=rank)
    svc = SweepService(mesh=M.make_sweep_mesh())
    if svc.role == "leader":
        ...                                         # submit*, then close()
    else:
        svc.serve()                                 # until the leader closes
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import predictors as P
from repro_torch.dist import fault as F
from repro_torch.dist import faultinject as FI
from repro_torch.dist import sweep as DS
from repro_torch.dist.fault import FabricError
from repro_torch.serve.method import (Item, Launcher, MethodRequest,
                                      _eps_bucket, _f32, _row_bucket,
                                      slice_digest)
from repro_torch.serve.registry import MethodRegistry, default_registry

__all__ = ["FeatureCache", "RetryAfter", "ServiceConfig", "SweepService",
           "_eps_bucket", "_f32", "_row_bucket", "slice_digest"]

_LAT_RING = 512                       # per-method latency samples kept

# A multi-process service's keys in the group's store are numbered by a
# process-local counter: every process constructs its services in the
# same order, so the numbers agree and a second service never reads the
# first one's keys.
_FABRIC_COUNTER = itertools.count()
_POLL_MAX_S = 0.02                    # a follower's longest store poll gap
_WATCH_S = 0.2                        # how often a waiting follower looks
#                                       at the epoch and the leader's beat


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


class _Boxed:
    """Run ``fn`` on a sacrificial daemon thread (after ``init``, which
    binds the thread's device), so that a collective stuck on a lost peer
    can be abandoned: ``torch.distributed``'s collectives cannot be
    interrupted, so the fabric's bounded waits park them here and walk
    away at their deadline.  The thread ends with the collective's own
    error (the group's timeout, or an abort), or with the process."""

    def __init__(self, fn, name: str, init=None):
        self.value = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()

        def run():
            try:
                if init is not None:
                    init()
                self.value = fn()
            except BaseException as exc:          # noqa: BLE001
                self.error = exc
            finally:
                self.done.set()

        self.thread = threading.Thread(target=run, name=name, daemon=True)
        self.thread.start()

    def wait(self, timeout: float) -> bool:
        return self.done.wait(timeout)


class _CommError(RuntimeError):
    """A collective or store call of a launch failed: a fault of the
    fabric, which the leader attributes by heartbeats, never of the
    request (gloo raises a plain ``RuntimeError`` when a peer's
    connection closes, so the call site, not the type, tells them
    apart)."""


def _comm(fn, *args):
    try:
        return fn(*args)
    except Exception as exc:
        raise _CommError(f"{type(exc).__name__}: {exc}") from exc


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
    launch_timeout_s: float = 60.0   # leader's bound per fabric launch
    #   (must cover a first launch's kernel build; followers have none)
    heartbeat_s: float = 0.5         # fabric liveness publish interval
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
    batched launches (module docstring).

    ``device``: where post-processing runs and, without a mesh, where
    launches run (default: the mesh's first device of this process, else
    ``"cuda"``).  ``mesh``: a ``dist.sweep.SweepMesh``, or None for the
    thread's ``use_mesh`` mesh; captured here and used by every launch."""

    HDR_LEN = 9         # [op, k, k_pad, rank, t0, t1, t2, e_pad, launcher id]
    OP_SHUTDOWN, OP_LAUNCH, OP_WARMUP = 0, 1, 2

    def __init__(self, scfg: Optional[ServiceConfig] = None, *,
                 registry: Optional[MethodRegistry] = None,
                 device=None, mesh=None):
        self.scfg = scfg if scfg is not None else ServiceConfig()
        self.registry = registry if registry is not None else \
            default_registry()
        self.mesh = DS.active_sweep_mesh(mesh)
        if device is None:
            device = self.mesh.devices[0] if self.mesh is not None else "cuda"
        self.device = _resolve_device(device)
        self.role = "leader"
        self._multiproc = DS.mesh_spans_processes(self.mesh)
        self._fabric_error: Optional[FabricError] = None
        self._launch_lock = threading.Lock()
        self._transport = "local"
        self._procs = self._procs0 = [0]
        self._epoch = 0              # bumps on every recovery
        self._recoveries = 0
        self._last_recovery_s = 0.0
        self._last_detect_s = 0.0
        self._fault_window: Optional[tuple] = None   # perf_counter span
        self._kv_bytes = 0           # bytes the store transport moved
        self._hb: Optional[F.Heartbeat] = None
        if self._multiproc:
            self._init_fabric()
        # where a launch's stack is staged: the device itself without a
        # mesh; with one, the host, or this rank's card on NCCL (whose
        # broadcasts move CUDA memory); the sweep moves each shard's block
        self._stage = (self.device if self.mesh is None
                       else DS._gather_device(self.mesh))
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
        loop = (self._follower_loop if self.role == "follower"
                else self._loop)
        self._worker = threading.Thread(target=loop,
                                        name=f"sweep-service-{self.role}",
                                        daemon=True)
        self._worker.start()

    def _init_fabric(self) -> None:
        import torch.distributed as dist
        from repro_torch.launch import mesh as M
        self._store = M.coordination_store()
        if self._store is None:
            raise ValueError(
                "a SweepService on a process-spanning mesh needs the "
                "process group of repro_torch.launch.mesh.dist_init (its "
                "store carries the launch sequence)")
        self._rank = dist.get_rank()
        self._leader = self.mesh.ranks[0]
        self.role = "leader" if self._rank == self._leader else "follower"
        self._kvp = f"repro_torch/sweep_service/{next(_FABRIC_COUNTER)}"
        self._seq = 0
        self._mesh0 = self.mesh
        self._procs = list(self.mesh.ranks)
        self._procs0 = list(self._procs)
        self._shares = dict(zip(self.mesh.ranks, self.mesh.shares))
        self._backend = self._transport = dist.get_backend(self.mesh.group)
        self._aborted = ""
        self._hb = F.Heartbeat(self._store, self._kvp, self._rank,
                               interval_s=self.scfg.heartbeat_s).start()
        # the leader watches its followers, a follower its leader
        self._monitor = F.PeerMonitor(self._store, self._kvp)
        self._monitor.track([p for p in self._procs if p != self._rank]
                            if self.role == "leader" else [self._leader])
        # a follower does not call the leader lost before its first beat
        # could have come
        self._first_beat_deadline = time.monotonic() + max(
            self.scfg.launch_timeout_s, 2 * self._stale_after)

    @property
    def _stale_after(self) -> float:
        """Heartbeat silence that marks a peer dead or wedged: a few
        missed beats, never longer than one launch deadline."""
        return max(1.0, min(self.scfg.launch_timeout_s,
                            6 * self.scfg.heartbeat_s))

    @property
    def _barrier_timeout(self) -> float:
        return min(self.scfg.launch_timeout_s,
                   max(2.0, 2 * self._stale_after))

    def _check_cfg(self, cfg):
        """Leader/follower launches carry no per-request engine config
        (followers launch with the service's), so a multi-process
        service accepts only its own."""
        if self._multiproc and cfg != self.scfg.pcfg:
            raise ValueError(
                "a multi-process SweepService serves only its configured "
                "engine config (ServiceConfig.pcfg); per-request configs "
                "are a single-process feature")
        return cfg

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
                "mesh": None if self.mesh is None else self._mesh_key(),
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
                "epoch": self._epoch,
                "transport": self._transport,
                "recoveries": self._recoveries,
                "last_recovery_s": self._last_recovery_s,
                "last_detect_s": self._last_detect_s,
                "kv_bytes": self._kv_bytes,
                "rejected": self._rejected,
                "procs": list(self._procs),
                "cache": self.cache.stats()}

    @property
    def launches(self) -> int:
        return self._launches

    def _mesh_key(self) -> tuple:
        return (tuple(str(d) for d in self.mesh.devices), self.mesh.shares,
                self.mesh.ranks)

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
        once.  Warmup launches are not counted in ``launches``.  On a
        process-spanning mesh they ride the fabric: the leader warms up,
        and followers join in their worker."""
        if self.role == "follower":
            raise RuntimeError(
                "warmup runs on the leader; a follower joins its warmup "
                "launches in its worker (call serve())")
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build()
        if shapes is None:
            done: set = set()
            for m in self.registry.methods():
                spec = m.warmup_spec(self.scfg)
                wcfg = m.launcher.follower_cfg(self.scfg)
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
        cfg = self._check_cfg(cfg if cfg is not None else self.scfg.pcfg)
        sweep = self.registry.get("featurize").launcher
        for shape in shapes:
            for e in grid_sizes:
                for k in row_buckets:
                    self._warm_one(sweep, tuple(shape), int(e),
                                   self._k_pad((), int(k)), cfg)

    def _warm_one(self, launcher: Launcher, shape: Tuple[int, ...],
                  e: int, k_pad: int, cfg) -> None:
        e_pad = launcher.eps_bucket(e)
        epss = np.full((e_pad,), launcher.warmup_eps, np.float32)
        self._collective_sweep(launcher, [np.zeros(shape, np.float32)], epss,
                               cfg, k_pad, op=self.OP_WARMUP)
        self._executables.add(self._sig(launcher, k_pad, shape, e_pad, cfg))

    def serve(self) -> None:
        """Block until the service stops: on a follower, until the
        leader's ``close()`` (its worker joins every launch until then);
        on a leader, until ``close()`` from another thread.  Raises the
        ``FabricError`` that broke the fabric, if one did (on a
        follower: ``evicted``, ``leader_lost`` or the leader's
        failure)."""
        self._worker.join()
        if self._fabric_error is not None:
            raise self._fabric_error

    def close(self) -> None:
        """Serve what is queued, then stop the worker and the
        post-processing pool; on a process-spanning mesh the leader then
        releases the followers (the shutdown header on an unfaulted
        group, the store's shutdown key in any case) and waits, within a
        bound, for their goodbye keys, so that a store it serves outlives
        their last reads.  Idempotent, also after a fabric failure (no
        collective is tried then).  A follower's ``close()`` waits for
        the leader's."""
        if self.role == "follower":
            self._worker.join()
            self._post.shutdown(wait=True)
            self._stop_heartbeat()
            return
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            self._cond.notify_all()
        self._worker.join()
        self._post.shutdown(wait=True)
        if len(self._procs0) > 1:
            self._release_followers()
        self._stop_heartbeat()

    def _stop_heartbeat(self) -> None:
        if self._hb is not None:
            self._hb.stop()

    def __enter__(self) -> "SweepService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # worker: micro-batching loop
    # ------------------------------------------------------------------

    def _submit(self, req: MethodRequest) -> Future:
        if self.role == "follower":
            raise RuntimeError(
                "a follower process takes no requests: submit to the leader "
                "(the mesh's first process) and call serve() here")
        with self._cond:
            if self._stop:
                raise RuntimeError("SweepService is closed") \
                    from self._fabric_error
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
            except FabricError as exc:  # the fabric is gone: fail them all
                self._release_live()
                self._fail_fabric(exc, batch)
                return
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

    def _fail_fabric(self, exc: FabricError,
                     batch: List[MethodRequest]) -> None:
        """Fail ``batch`` and every queued request with ``exc``, and refuse
        later submissions."""
        with self._cond:
            if self._fabric_error is None:
                self._fabric_error = exc
            self._stop = True
            queued = list(self._queue)
            self._queue.clear()
        for req in list(batch) + queued:
            if not req.future.done():
                req.future.set_exception(exc)
            self._note_done(req, ok=False)
        if len(self._procs0) > 1:
            self._mark_shutdown("failed")

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

    def _sig(self, launcher: Launcher, k_pad: int, shape: Tuple[int, ...],
             e_pad: int, cfg) -> tuple:
        mesh = None if self.mesh is None else self._mesh_key()
        return (launcher.name, k_pad, shape, e_pad, cfg, mesh)

    def _k_pad(self, methods, k: int) -> int:
        """Padded row count of a launch whose items came from
        ``methods``: the smallest covering bucket of their merged
        ladders, the power-of-two ladder when any method declares none,
        and the power-of-two ladder past the largest declared bucket;
        under a mesh, rounded up to a multiple of its extent (so the
        launch shards; pad rows never change a real row)."""
        ladders = [m.batch_buckets for m in methods]
        bucket = _row_bucket(k)
        if ladders and all(lad is not None for lad in ladders):
            bucket = next((b for b in sorted({b for lad in ladders
                                              for b in lad}) if b >= k),
                          bucket)
        if self.mesh is None:
            return bucket
        return -(-bucket // self.mesh.size) * self.mesh.size

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
        """The (k_pad, ...) stack of ``rows`` where launches stage it
        (``self._stage``), pad rows repeating the last one.  It is packed
        into a host buffer kept per padded shape (pinned for a card) and
        copied without blocking; an event after the copy is waited on
        before the buffer is filled again.  The lock keeps warmup and the
        worker from filling one buffer at once."""
        k = len(rows)
        shape = (k_pad,) + rows[0].shape
        on_card = self._stage.type == "cuda"
        with self._staging_lock:
            slot = self._staging.get(shape)
            if slot is None:
                slot = self._staging[shape] = [torch.empty(
                    shape, dtype=torch.float32, pin_memory=on_card), None]
            buf, done = slot
            if done is not None:
                done.synchronize()
            for i, x in enumerate(rows):
                buf[i].copy_(torch.from_numpy(x))
            buf[k:] = buf[k - 1]
            if not on_card:
                return buf.clone()
            stack = buf.to(self._stage, non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record()
            return stack

    def _run(self, launcher: Launcher, rows: List[np.ndarray],
             epss: np.ndarray, cfg, k_pad: int) -> List[np.ndarray]:
        """Launch ``rows`` and return their k real (e, R) row blocks on
        the host (pad rows dropped)."""
        host = self._collective_sweep(launcher, rows, epss, cfg, k_pad)
        return [host[i] for i in range(len(rows))]

    # ------------------------------------------------------------------
    # launches: local, on a mesh, or over the leader/follower fabric
    # ------------------------------------------------------------------

    def _collective_sweep(self, launcher: Launcher, rows: List[np.ndarray],
                          epss: np.ndarray, cfg, k_pad: int,
                          op: int = OP_LAUNCH) -> np.ndarray:
        """One padded launch of ``rows`` -> the host (k_pad, e, R) rows
        (at least the k real ones), brought back in one device-to-host
        copy (or gather) that waits for the launch.  On a
        process-spanning mesh the launch is the leader's half of the
        fabric (module docstring): a retriable :class:`FabricError`
        shrinks the fabric to the survivors (:meth:`_recover`) and the
        launch runs again there, so its rows are the same bits whichever
        fabric made them; a non-retriable one breaks the fabric."""
        stack = self._upload(rows, k_pad)
        if not self._multiproc:
            return self._local_launch(launcher, stack, epss, cfg, k_pad)
        with self._launch_lock:
            if self._fabric_error is not None:
                raise self._fabric_error
            err = None
            for _ in range(len(self._procs0) + 1):
                try:
                    if not self._multiproc:     # shrunk to this process
                        return self._local_launch(launcher, stack, epss,
                                                  cfg, k_pad)
                    if self._transport == "kv":
                        return self._kv_launch(launcher, rows, stack, epss,
                                               cfg, op)
                    return self._group_launch(launcher, len(rows), stack,
                                              epss, cfg, k_pad, op)
                except FabricError as exc:
                    if not exc.retriable:
                        raise self._fabric_failed(exc)
                    err = exc
                    try:
                        self._recover(exc)
                    except FabricError as fatal:
                        raise self._fabric_failed(fatal) from exc
            raise self._fabric_failed(FabricError(
                "a launch kept failing across mesh shrinks")) from err

    def _local_launch(self, launcher: Launcher, stack: torch.Tensor,
                      epss: np.ndarray, cfg, k_pad: int) -> np.ndarray:
        if self.mesh is None:       # also a stack staged for a lost fabric
            stack = stack.to(self.device)
        return launcher.gather(launcher.launch(stack, epss, cfg, k_pad,
                                               self.mesh))

    def _group_launch(self, launcher: Launcher, k: int, stack: torch.Tensor,
                      epss: np.ndarray, cfg, k_pad: int,
                      op: int) -> np.ndarray:
        """A launch over the mesh's group -- the store's sequence key, the
        header, the k rows and the ebs broadcast, the launch, the gather
        -- under the launch deadline (:meth:`_bounded`)."""
        FI.fire("leader_launch")
        t0 = time.perf_counter()
        trailing = tuple(stack.shape[1:])
        hdr = [op, k, k_pad, 1 + len(trailing), 0, 0, 0, len(epss),
               self.registry.launcher_id(launcher)]
        hdr[7 - len(trailing):7] = trailing
        self._seq += 1
        key = f"{self._kvp}/launch/{self._seq}"

        def launch():
            _comm(self._store.set, key, "1")
            _comm(self._bcast, torch.tensor(hdr, dtype=torch.int64,
                                            device=self._stage))
            st = stack[:k].contiguous()
            _comm(self._bcast, st.reshape(-1).view(torch.uint8))
            ep = torch.from_numpy(np.ascontiguousarray(epss, np.float32))
            ep = _comm(self._bcast, ep.to(self._stage).view(torch.uint8))
            out = launcher.launch(st, ep.view(torch.float32).cpu().numpy(),
                                  cfg, k_pad, self.mesh)
            return _comm(launcher.gather, out)

        return self._bounded(launch, t0)

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        """Broadcast ``t`` in place from the leader over the mesh's group
        (fault-injection site ``bcast``)."""
        import torch.distributed as dist
        FI.fire("bcast")
        dist.broadcast(t, src=self._leader, group=self.mesh.group)
        return t

    def _bounded(self, launch, t0: float):
        """Run ``launch`` on a sacrificial thread under
        ``launch_timeout_s`` and attribute a fault by the followers'
        heartbeats.  A plain error with every heartbeat fresh is the
        batch's own and is raised as it is; a failed collective or store
        call, or a lost follower, is a retriable ``follower_lost``; an
        expired deadline with fresh heartbeats evicts every follower (a
        wedged peer cannot be told apart from inside the collective)."""
        box = _Boxed(launch, "sweep-service-launch", self._bind_device)
        if box.wait(self.scfg.launch_timeout_s):
            if box.error is None:
                return box.value
            lost = self._observe_lost()
            if not lost and not isinstance(box.error, _CommError):
                raise box.error
            why = f"a fabric launch failed: {box.error}"
        else:
            lost = (self._observe_lost()
                    or [p for p in self._procs if p != self._rank])
            why = (f"a fabric launch exceeded launch_timeout_s="
                   f"{self.scfg.launch_timeout_s}")
        raise self._fault(why, lost, t0) from box.error

    def _fault(self, why: str, lost, t0: float) -> FabricError:
        """The retriable fault of a launch begun at ``t0``, its detection
        time recorded."""
        self._last_detect_s = time.perf_counter() - t0
        self._fault_window = (t0, None)
        return FabricError(why, kind="follower_lost", lost=lost,
                           retriable=True)

    def _observe_lost(self) -> list:
        """The followers whose heartbeat stood still for one staleness
        window."""
        followers = [p for p in self._procs if p != self._rank]
        return self._monitor.observe_stale(followers, self._stale_after)

    def _kv_launch(self, launcher: Launcher, rows: List[np.ndarray],
                   stack: torch.Tensor, epss: np.ndarray, cfg,
                   op: int) -> np.ndarray:
        """A launch after a recovery, through the store only: each
        survivor's block of rows under its own key, the ebs, then a JSON
        header (op, shape, e, launcher id, every survivor's (lo, hi)
        block); each survivor sweeps its block on its own device and
        writes its rows back.  The leader deletes the launch's keys once
        it has read every block."""
        FI.fire("leader_launch")
        t0 = time.perf_counter()
        seq = self._seq + 1
        base = f"{self._kvp}/l/{self._epoch}/{seq}"
        k, e, width = len(rows), len(epss), launcher.row_width
        parts = self._partition(k)
        payloads = [f"{base}/eps"]
        try:
            for p, (lo, hi) in parts.items():
                if p != self._rank and hi > lo:
                    data = np.ascontiguousarray(np.stack(rows[lo:hi]),
                                                np.float32).tobytes()
                    F.kv_put_bytes(self._store, f"{base}/x/{p}", data)
                    payloads.append(f"{base}/x/{p}")
                    self._kv_bytes += len(data)
            F.kv_put_bytes(self._store, f"{base}/eps",
                           np.ascontiguousarray(epss, np.float32).tobytes())
            self._store.set(f"{base}/hdr", json.dumps({
                "op": op, "shape": [k, *rows[0].shape], "e": e,
                "g": self.registry.launcher_id(launcher),
                "parts": {str(p): list(b) for p, b in parts.items()}}))
        except Exception as exc:
            raise FabricError(f"the coordination store went away: {exc}"
                              ) from exc
        lo, hi = parts[self._rank]
        blocks = {self._rank: self._local_rows(launcher, stack[lo:hi], epss,
                                               cfg, e)}
        deadline = time.monotonic() + self.scfg.launch_timeout_s
        lost = []
        for p in self._procs:
            plo, phi = parts[p]
            if p == self._rank:
                continue
            if phi <= plo:
                blocks[p] = np.zeros((0, e, width), np.float32)
                continue
            data = self._collect_block(f"{base}/out/{p}", p, deadline)
            if data is None or len(data) != (phi - plo) * e * width * 4:
                lost.append(p)
                continue
            self._kv_bytes += len(data)
            payloads.append(f"{base}/out/{p}")
            blocks[p] = np.frombuffer(data, np.float32).reshape(
                phi - plo, e, width)
        if lost:
            raise self._fault("survivor(s) never returned their rows", lost,
                              t0)
        for key in payloads:
            F.kv_delete_bytes(self._store, key)
        F.kv_delete(self._store, f"{base}/hdr")
        self._seq = seq
        return np.concatenate([blocks[p] for p in self._procs])

    def _collect_block(self, key: str, rank: int,
                       deadline: float) -> Optional[bytes]:
        """``rank``'s rows under the launch deadline, given up as soon as
        its heartbeat goes stale (a slow but live peer gets the whole
        deadline)."""
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                return None
            data = F.kv_get_bytes(self._store, key, min(500, left * 1e3))
            if data is not None:
                return data
            self._monitor.poll()
            if self._monitor.age(rank) > self._stale_after:
                return None

    def _partition(self, k: int) -> dict:
        """Contiguous row blocks {rank: (lo, hi)} over the current
        processes, proportional to their shares of the original mesh."""
        total = sum(self._shares[p] for p in self._procs)
        parts, lo, cum = {}, 0, 0
        for p in self._procs:
            cum += self._shares[p]
            hi = (k * cum) // total
            parts[p] = (lo, hi)
            lo = hi
        return parts

    def _local_rows(self, launcher: Launcher, block, epss: np.ndarray, cfg,
                    e: int) -> np.ndarray:
        """Sweep ``block``'s rows on this process's own device, without
        the group (rows are mesh-independent: the same bits)."""
        n = block.shape[0]
        if n == 0:
            return np.zeros((0, e, launcher.row_width), np.float32)
        out = launcher.launch(block.to(self.device), epss, cfg,
                              _row_bucket(n), None)
        return launcher.gather(out)[:n]

    def _recover(self, err: FabricError) -> None:
        """Shrink the fabric to the survivors of ``err`` (the leader's
        side): publish a new epoch with its processes, meet them at a
        bounded barrier, shed whoever misses it (every follower when that
        cannot be attributed) and publish again, then move onto the
        store transport.  Alone, the leader serves on its own device."""
        t0 = time.perf_counter()
        self._abort_group()
        dead = set(err.lost)
        alive = [p for p in self._procs if p == self._rank or p not in dead]
        for _ in range(len(self._procs0) + 2):
            self._epoch += 1
            if not F.kv_set(self._store, f"{self._kvp}/epoch", json.dumps(
                    {"epoch": self._epoch, "procs": alive})):
                raise FabricError("cannot recover: the coordination store "
                                  "is unreachable") from err
            if len(alive) <= 1 or F.fabric_barrier(
                    self._store, f"{self._kvp}-rec-{self._epoch}",
                    self._barrier_timeout, alive, rank=self._rank):
                break
            others = [p for p in alive if p != self._rank]
            shed = set(self._monitor.observe_stale(others,
                                                   self._stale_after))
            alive = [p for p in alive
                     if p == self._rank or p not in (shed or set(others))]
        self._adopt_store_fabric(alive)
        if len(alive) <= 1:
            self._multiproc = False
        self._recoveries += 1
        now = time.perf_counter()
        self._last_recovery_s = now - t0
        self._fault_window = ((self._fault_window or (t0,))[0], now)

    def _adopt_store_fabric(self, alive: Sequence[int]) -> None:
        """Move this process onto the recovered fabric: shares from the
        survivors' submesh, launches through the store, each block swept
        on this process's device without a mesh."""
        sub = F.surviving_submesh(self._mesh0, alive)
        self._shares = dict(zip(sub.ranks, sub.shares))
        self._procs = list(sub.ranks)
        self.mesh = None
        self._stage = self.device
        self._transport = "kv"
        self._seq = 0
        self._executables.clear()

    def _abort_group(self) -> None:
        """On NCCL, abort the mesh's group before its watchdog finds a
        collective stuck on a lost peer (under PyTorch's default
        ``TORCH_NCCL_ASYNC_ERROR_HANDLING=3`` the watchdog ends the
        process).  A gloo group is left alone: no collective runs on it
        again."""
        if self._backend == "nccl" and not self._aborted:
            self._aborted = F.abort_group(self._mesh0.group)

    def _fabric_failed(self, err: FabricError) -> FabricError:
        """Record ``err`` as the fabric's failure and mark the store's
        shutdown key, so that followers waiting there stop."""
        if self._fabric_error is None:
            self._fabric_error = err
        self._mark_shutdown("failed")
        return err

    def _mark_shutdown(self, how: str) -> None:
        F.kv_set(self._store, f"{self._kvp}/shutdown", how)

    def _release_followers(self) -> None:
        """The leader's last act: on an unfaulted group the shutdown
        header (under the launch deadline), then the store's shutdown key
        (which alone releases followers on the store transport or after
        a failure), then a bounded wait for their goodbyes."""
        with self._launch_lock:
            if (self._fabric_error is None and self._transport != "kv"
                    and len(self._procs) > 1):
                self._seq += 1
                key = f"{self._kvp}/launch/{self._seq}"

                def release():
                    _comm(self._store.set, key, "1")
                    _comm(self._bcast, torch.zeros(
                        self.HDR_LEN, dtype=torch.int64, device=self._stage))

                _Boxed(release, "sweep-service-release",
                       self._bind_device).wait(self.scfg.launch_timeout_s)
            self._mark_shutdown("closed" if self._fabric_error is None
                                else "failed")
            self._wait_byes()

    def _wait_byes(self) -> None:
        """Wait, within a bound, for every follower's goodbye key (a
        follower whose heartbeat went stale is excused)."""
        pending = [p for p in self._procs0 if p != self._rank]
        deadline = time.monotonic() + max(2.0, 2 * self._stale_after)
        while pending and time.monotonic() < deadline:
            self._monitor.poll()
            pending = [p for p in pending
                       if F.kv_get(self._store, f"{self._kvp}/bye/{p}", 0)
                       is None and self._monitor.age(p) <= self._stale_after]
            time.sleep(0.05)

    # ------------------------------------------------------------------
    # follower: the launch stream and the epoch state machine
    # ------------------------------------------------------------------

    def _follower_loop(self) -> None:
        """Join every launch of the leader's -- over the group until a
        fault, then through the store -- and follow its epochs, until the
        shutdown (module docstring).  A fault this process cannot
        recover from is recorded for ``serve()``; the goodbye key is
        written on the way out."""
        self._bind_device()
        try:
            while True:
                step = (self._follower_store_step if self._transport == "kv"
                        else self._follower_group_step)
                res = step()
                if res == "shutdown":
                    return
                if res == "fault":
                    self._follower_recover()
        except Exception as exc:        # serve() raises it
            err = exc if isinstance(exc, FabricError) else FabricError(
                f"the follower's worker failed: {type(exc).__name__}: {exc}")
            err.__cause__ = exc if err is not exc else exc.__cause__
            self._fabric_error = err
        finally:
            F.kv_set(self._store, f"{self._kvp}/bye/{self._rank}", "1")
            self._stop_heartbeat()

    def _await(self, key: str) -> str:
        """A follower's wait for ``key`` in the store, in short polls:
        "launch" once it is there, "shutdown" after a clean shutdown,
        "fault" on an epoch advance; raises ``FabricError`` when the
        leader's fabric failed, the store went away or the leader's
        heartbeat went stale (``leader_lost``)."""
        stop = f"{self._kvp}/shutdown"
        gap, watch = 1e-4, time.monotonic() + _WATCH_S
        while True:
            try:
                if self._store.check([key]):
                    return "launch"
                if self._store.check([stop]):
                    if self._store.get(stop) == b"closed":
                        return "shutdown"
                    raise FabricError("the leader's fabric failed",
                                      lost=(self._leader,))
            except FabricError:
                raise
            except Exception as exc:
                raise FabricError(
                    f"the coordination store went away: {exc}",
                    kind="leader_lost", lost=(self._leader,)) from exc
            if time.monotonic() >= watch:
                if self._epoch_advanced():
                    return "fault"
                self._check_leader("the leader stopped heartbeating")
                watch = time.monotonic() + _WATCH_S
            time.sleep(gap)
            gap = min(2 * gap, _POLL_MAX_S)

    def _follower_group_step(self) -> Optional[str]:
        """Join one launch over the group, once its sequence key is in
        the store: the header, the rows and ebs, the launch, the
        gather."""
        self._seq += 1
        res = self._await(f"{self._kvp}/launch/{self._seq}")
        if res != "launch":
            return res

        def join():
            hdr = _comm(self._bcast, torch.zeros(
                self.HDR_LEN, dtype=torch.int64, device=self._stage))
            op, k, k_pad, rank, *rest = hdr.cpu().tolist()
            if op == self.OP_SHUTDOWN:
                return None
            FI.fire("follower_launch")
            trailing = tuple(rest[3 - (rank - 1):3])
            e, gid = rest[3], rest[4]
            launcher = self.registry.launcher(gid)
            st = _comm(self._bcast, torch.empty(
                4 * k * int(np.prod(trailing)), dtype=torch.uint8,
                device=self._stage))
            ep = _comm(self._bcast, torch.empty(4 * e, dtype=torch.uint8,
                                                device=self._stage))
            out = launcher.launch(
                st.view(torch.float32).reshape((k,) + trailing),
                ep.view(torch.float32).cpu().numpy(),
                launcher.follower_cfg(self.scfg), k_pad, self.mesh)
            _comm(launcher.gather, out)
            return op, k, k_pad

        box = self._bounded_join(join)
        if box is None:
            return "fault"
        if box.value is None:
            return "shutdown"
        self._count_launch(*box.value)
        return None

    def _follower_store_step(self) -> Optional[str]:
        """Take part in one launch through the store: read this process's
        block and the ebs, sweep them on its own device, write the rows
        back."""
        base = f"{self._kvp}/l/{self._epoch}/{self._seq + 1}"
        res = self._await(f"{base}/hdr")
        if res != "launch":
            return res
        raw = F.kv_get(self._store, f"{base}/hdr", 0)
        if raw is None:
            raise FabricError("the coordination store went away",
                              kind="leader_lost", lost=(self._leader,))
        hdr = json.loads(raw)
        launcher = self.registry.launcher(int(hdr["g"]))
        lo, hi = hdr["parts"].get(str(self._rank), (0, 0))
        shape, e = tuple(hdr["shape"]), int(hdr["e"])
        wait_ms = self.scfg.launch_timeout_s * 1e3

        def join():
            FI.fire("kv_launch")
            if hi <= lo:
                return True
            st = F.kv_get_bytes(self._store, f"{base}/x/{self._rank}",
                                wait_ms)
            ep = F.kv_get_bytes(self._store, f"{base}/eps", wait_ms)
            if st is None or ep is None:
                raise FabricError("a launch's rows never arrived through "
                                  "the store", kind="timeout")
            block = torch.from_numpy(np.frombuffer(st, np.float32).reshape(
                (hi - lo,) + shape[1:]).copy())
            rows = self._local_rows(launcher, block,
                                    np.frombuffer(ep, np.float32).copy(),
                                    launcher.follower_cfg(self.scfg), e)
            out = np.ascontiguousarray(rows, np.float32).tobytes()
            F.kv_put_bytes(self._store, f"{base}/out/{self._rank}", out)
            self._kv_bytes += len(st) + len(out)
            return True

        if self._bounded_join(join) is None:
            return "fault"
        self._seq += 1
        n = hi - lo
        self._count_launch(int(hdr["op"]), n, _row_bucket(n) if n else 0)
        return None

    def _bounded_join(self, join) -> Optional[_Boxed]:
        """Run a follower's part of a launch on a sacrificial thread, with
        no deadline of its own: abandon it only when the leader publishes
        a new epoch, marks the shutdown or stops heartbeating (a bare
        deadline would misfire on a slow join the leader still waits
        for).  The box on success, None on a fault."""
        box = _Boxed(join, "sweep-service-join", self._bind_device)
        while not box.wait(_WATCH_S):
            if self._epoch_advanced() or self._shutdown_set():
                self._abort_group()
                return None
            if self._leader_stale():
                self._abort_group()
                raise FabricError("the leader stopped heartbeating "
                                  "mid-launch", kind="leader_lost",
                                  lost=(self._leader,))
        return None if box.error is not None else box

    def _count_launch(self, op: int, k: int, k_pad: int) -> None:
        if op == self.OP_LAUNCH:
            self._launches += 1
            self._rows_launched += k
            self._pad_rows += k_pad - k

    def _shutdown_set(self) -> bool:
        return F.kv_get(self._store, f"{self._kvp}/shutdown", 0) is not None

    def _read_epoch(self) -> Optional[dict]:
        raw = F.kv_get(self._store, f"{self._kvp}/epoch", 0)
        try:
            desc = json.loads(raw)
            return {"epoch": int(desc["epoch"]),
                    "procs": [int(p) for p in desc["procs"]]}
        except Exception:
            return None

    def _epoch_advanced(self) -> bool:
        desc = self._read_epoch()
        return desc is not None and desc["epoch"] > self._epoch

    def _leader_stale(self) -> bool:
        self._monitor.poll()
        if not self._monitor.seen(self._leader):
            return time.monotonic() > self._first_beat_deadline
        return self._monitor.age(self._leader) > 2 * self._stale_after

    def _check_leader(self, what: str) -> None:
        if self._leader_stale():
            raise FabricError(what, kind="leader_lost", lost=(self._leader,))

    def _follower_recover(self) -> None:
        """Rejoin the fabric at the epoch the leader published, or learn
        that this process was evicted (``kind="evicted"``) or that the
        leader is gone (``kind="leader_lost"``).  Bounded."""
        self._abort_group()
        deadline = time.monotonic() + max(self.scfg.launch_timeout_s,
                                          4 * self._stale_after)
        while True:
            desc = self._read_epoch()
            if desc is not None and desc["epoch"] > self._epoch:
                if self._rank not in desc["procs"]:
                    raise FabricError("this process was dropped from the "
                                      "recovered fabric", kind="evicted",
                                      lost=(self._rank,))
                if F.fabric_barrier(
                        self._store, f"{self._kvp}-rec-{desc['epoch']}",
                        self._barrier_timeout, desc["procs"],
                        rank=self._rank):
                    self._epoch = desc["epoch"]
                    self._adopt_store_fabric(desc["procs"])
                    return
                # missed this rendezvous: the leader may publish a
                # further-shrunk epoch (perhaps without this process)
            if self._shutdown_set():
                return               # the next step reads the marker
            self._check_leader("the leader was lost during recovery")
            if time.monotonic() > deadline:
                if desc is None or desc["epoch"] <= self._epoch:
                    # the epoch never moved and the leader still beats:
                    # no fault to recover from; a real one announces
                    # itself as an epoch advance
                    return
                raise FabricError("the recovery window expired "
                                  "mid-rendezvous", kind="timeout")
            time.sleep(0.1)

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

"""Servable methods: the per-workload layer of the sweep service.

A :class:`ServableMethod` owns everything workload-specific:

* **host-side ``pre_process``** -- argument validation, float32
  canonicalization and content digesting, run on the CALLER's thread at
  submit time (never inside a coalesced batch, where a failure would
  fail other requests too);
* a **``launcher``** -- the device-launch recipe.  Methods that share a
  launcher instance coalesce into the same batched launches
  (featurize, find_eb, best_compressor, advise and find_setting all ride
  :class:`SweepLauncher`);
* **host-side ``post_process``** -- turning the served feature rows into
  the request's result (UC1 bisection, UC2 ranking, ...), run on the
  service's post-processing pool, off the launching thread;
* sorted **``batch_buckets``** -- the method's batch-size ladder
  (``None`` is the power-of-two ladder of :func:`_row_bucket`);
* a dummy-data **``warmup_spec``** -- shapes x eb-grid sizes x row
  buckets the service's ``warmup()`` launches once.

The batching core (``serve.sweep_service.SweepService``) knows nothing
about any of them; ``serve.registry`` names the methods it serves.

Launcher contract
-----------------
Every launch is row-independent (a row inside a padded, deduplicated
batch is the bits of that row launched alone) and eb-independent (the
row's value at an eb is the bits of that eb launched alone, in any eb
grid: a union, a bucket padded with its last eb, a chunk).  The sweep
keeps both: its numerics are fixed by a row's own shape and every
reduction over a row runs alone or in a fixed order
(``core.predictors``).  Coalescing, in-batch dedup, eb unions and the
cross-request cache are bit-equal to direct calls only because of them.

Launchers take a (k, ...) float32 stack and the service's mesh (None
for one device) and return the padded (k_pad, e, row_width) result:
a tensor, or a ``dist.sweep.ShardedRows`` left on the mesh's shards.
:meth:`Launcher.gather` brings it to the host, and is the collective
point of a process-spanning mesh.  On such a mesh every process makes
the same launch with the same stack, ebs and ``k_pad``: the leader's
own, the followers' from the leader's broadcast, with the launch config
of :meth:`Launcher.follower_cfg` (launches carry no per-request config
across processes).
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import predictors as P
from repro_torch.core import usecases as UC
from repro_torch.core.regression import predict_fast
from repro_torch.data.source import StreamingDigest
from repro_torch.dist import sweep as DS
from repro_torch.train import grad_compress as GC

_EPS_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def _row_bucket(k: int) -> int:
    """Smallest power of two >= k."""
    b = 1
    while b < k:
        b *= 2
    return b


def _eps_bucket(e: int) -> int:
    """The eb-vector length a union of ``e`` ebs is padded to: the
    smallest of ``_EPS_BUCKETS`` that holds it, else a multiple of 16."""
    for b in _EPS_BUCKETS:
        if e <= b:
            return b
    return -(-e // 16) * 16


def _f32(eps) -> float:
    """Canonical float32 error-bound key (features are computed in f32)."""
    return float(np.float32(eps))


def _host_f32(x) -> np.ndarray:
    """A tensor (any device) or array-like as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def slice_digest(x) -> str:
    """Content hash of an array's float32 bytes and shape (a float64
    array and its float32 round trip share it): the one-chunk case of
    ``data.source.StreamingDigest``, so a digest accumulated from chunked
    reads of a variable equals this one of the whole variable."""
    if hasattr(x, "detach"):                 # a tensor, on any device
        x = x.detach().cpu().numpy()
    return StreamingDigest().update(x).digest()


@dataclasses.dataclass(frozen=True)
class WarmupSpec:
    """Dummy-data warmup coverage for one method: every (trailing shape,
    eb-grid size, row bucket) combination is launched by ``warmup()``."""
    shapes: Tuple[Tuple[int, ...], ...]
    grid_sizes: Tuple[int, ...] = (1,)
    row_buckets: Tuple[int, ...] = (1,)


@dataclasses.dataclass
class Item:
    """One row's launch needs within a request."""
    key: tuple                       # (digest, launch config)
    x: np.ndarray                    # float32 row, any trailing shape
    eps_keys: Tuple[float, ...]      # float32 eb keys this request reads


@dataclasses.dataclass
class MethodRequest:
    """One accepted request, made by ``ServableMethod.pre_process`` and
    handled generically by the batching core."""
    method: "ServableMethod"
    items: List[Item]
    future: Future
    payload: dict
    t_submit: float

    @property
    def rows(self) -> int:
        return len(self.items)

    @property
    def kind(self) -> str:
        return self.method.name


class Launcher:
    """Device-launch recipe shared by every method that coalesces with
    it (the module docstring has its contract).  Identity matters:
    methods registered with the SAME instance batch together."""

    name = "launcher"
    row_width = 1                    # trailing width R of a row
    warmup_eps = 1.0                 # dummy eb of warmup launches

    def launch(self, stack: torch.Tensor, epss: np.ndarray, cfg,
               k_pad: int, mesh=None):
        """One padded launch -> (k_pad, len(epss), row_width)."""
        raise NotImplementedError

    def gather(self, out) -> np.ndarray:
        """A launch result as a host array (all-gathered over a
        process-spanning mesh's group: every member makes this call)."""
        return DS.gather_rows(out)

    def follower_cfg(self, scfg):
        """The launch config of the service's own engine config: what
        ``warmup()`` launches with, and what a follower launches with."""
        return None

    def eps_bucket(self, e: int) -> int:
        return _eps_bucket(e)


class SweepLauncher(Launcher):
    """The paper's featurization sweep: (k, m, n) / (k, d, m, n) stack x
    (e,) ebs -> (k_pad, e, 2) feature rows by one
    ``dist.sweep.sweep_padded`` launch."""

    name = "sweep"
    row_width = 2

    def launch(self, stack, epss, cfg, k_pad, mesh=None):
        return DS.sweep_padded(stack, epss, cfg, k_pad=k_pad, mesh=mesh)

    def follower_cfg(self, scfg):
        return scfg.pcfg


class QualityLauncher(Launcher):
    """The fused quality sweep (``mode="quality"``): (k, m, n) /
    (k, d, m, n) stack x (e,) ebs -> (k_pad, e, 2) [PSNR, NRMSE] rows,
    bit-equal to ``core.predictors.quality_sweep``.  Its launch config
    is the ``("quality", PredictorConfig)`` pair of the item keys, a key
    space apart from the feature sweep's bare config, so quality rows
    never collide with feature rows in the cache."""

    name = "quality"
    row_width = 2

    def launch(self, stack, epss, cfg, k_pad, mesh=None):
        return DS.sweep_padded(stack, epss, cfg[1], k_pad=k_pad, mesh=mesh,
                               mode="quality")

    def follower_cfg(self, scfg):
        return ("quality", scfg.pcfg)


class Int8CRLauncher(Launcher):
    """Predicted int8+entropy compression ratio per row
    (``train.grad_compress.predicted_cr_rows``): rows are FLATTENED
    leaves (the CR does not depend on the leaf's shape).  Every step is
    elementwise, a max, an integer count or a fixed-order row sum, so a
    row's CR is its bits alone.  The launch is local, on the mesh's
    first device of this process (no collective): on a spanning mesh
    leader and followers each compute it on their copy of the rows."""

    name = "int8cr"
    row_width = 1
    warmup_eps = 0.0

    def __init__(self, bins: int = GC.DEFAULT_BINS):
        self.bins = int(bins)

    @property
    def cfg_key(self) -> tuple:
        return ("int8cr", self.bins)

    def launch(self, stack, epss, cfg, k_pad, mesh=None):
        if mesh is not None:
            stack = stack.to(mesh.devices[0])
        k = stack.shape[0]
        if k_pad > k:
            stack = torch.cat([stack, stack[-1:].expand(
                (k_pad - k,) + tuple(stack.shape[1:]))])
        crs = GC.predicted_cr_rows(stack.reshape(k_pad, -1), self.bins)
        e = int(np.asarray(epss).reshape(-1).shape[0])
        return crs[:, None, None].expand(k_pad, e, 1).contiguous()

    def follower_cfg(self, scfg):
        return self.cfg_key


class ServableMethod:
    """Base class of the registrable methods (module docstring).
    Subclasses set ``name``, pass a launcher, and implement
    ``pre_process`` / ``post_process``."""

    name: str = ""
    batch_buckets: Optional[Tuple[int, ...]] = None

    def __init__(self, launcher: Launcher,
                 batch_buckets: Optional[Tuple[int, ...]] = None):
        self.launcher = launcher
        if batch_buckets is not None:
            self.batch_buckets = tuple(int(b) for b in batch_buckets)
        if self.batch_buckets is not None:
            bb = self.batch_buckets
            if not bb or list(bb) != sorted(set(bb)) or bb[0] < 1:
                raise ValueError(
                    f"method {self.name!r}: batch_buckets must be a "
                    f"sorted tuple of distinct positive sizes, got {bb}")

    def pre_process(self, svc, *args, **kwargs) -> MethodRequest:
        """Validate + digest a submission on the caller's thread."""
        raise NotImplementedError

    def post_process(self, req: MethodRequest,
                     rows_for: Callable[[Item], np.ndarray]):
        """Complete a request from its rows; ``rows_for(item)`` returns
        the (len(eps_keys), row_width) rows of one item."""
        raise NotImplementedError

    def warmup_spec(self, scfg) -> WarmupSpec:
        """Dummy-data warmup coverage; override for method traffic."""
        return WarmupSpec(shapes=((32, 32),), grid_sizes=(1,),
                          row_buckets=(1, 2))


def _request(method, items, payload) -> MethodRequest:
    return MethodRequest(method, items, Future(), payload, time.perf_counter())


def _stack_items(arr: np.ndarray, cfg, eps_keys) -> List[Item]:
    return [Item((slice_digest(s), cfg), s, eps_keys) for s in arr]


def _eps_keys(epss, what: str) -> Tuple[float, ...]:
    if isinstance(epss, torch.Tensor):
        epss = epss.detach().cpu().numpy()
    keys = tuple(_f32(e) for e in np.asarray(epss).reshape(-1))
    if not keys:
        raise ValueError(f"{what} needs at least one eb")
    return keys


def _checked_stack(slices, what: str) -> np.ndarray:
    arr = _host_f32(slices)
    if arr.ndim not in (3, 4):
        raise ValueError(f"{what} expects (k, m, n) or (k, d, m, n), "
                         f"got {arr.shape}")
    return arr


def _checked_rank(models: Dict[str, Any], data, what: str) -> np.ndarray:
    ndims = {m.ndim for m in models.values()}
    x = _host_f32(data)
    if len(ndims) > 1 or x.ndim != next(iter(ndims)):
        raise ValueError(
            f"{what}: models trained on {sorted(ndims)}-D data must all "
            f"match the request rank, got {x.shape}")
    return x


def _on_device(device, x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class FeaturizeMethod(ServableMethod):
    """(k, m, n) / (k, d, m, n) stack x (e,) ebs -> (k, e, 2) rows,
    bit-equal to ``features_sweep(slices, epss)``."""

    name = "featurize"

    def pre_process(self, svc, slices, epss, cfg=None) -> MethodRequest:
        cfg = svc._check_cfg(cfg if cfg is not None else svc.scfg.pcfg)
        arr = _checked_stack(slices, "submit_featurize")
        eps_keys = _eps_keys(epss, "submit_featurize")
        return _request(self, _stack_items(arr, cfg, eps_keys),
                        {"eps_keys": eps_keys})

    def post_process(self, req, rows_for):
        return np.stack([rows_for(it) for it in req.items])


class FindEbMethod(ServableMethod):
    """UC1: (eps, predicted_cr) hitting a target CR, bit-equal to
    ``usecases.find_error_bound_for_cr``: the port's ``SliceCache`` is
    seeded with the served grid rows, so the bisection reads them."""

    name = "find_eb"

    def pre_process(self, svc, grid_model, data, target_cr,
                    tol: float = 0.02, max_iters: int = 32) -> MethodRequest:
        x = _host_f32(data)
        if x.ndim != grid_model.ndim:
            raise ValueError(
                f"submit_find_eb: grid model '{grid_model.name}' was "
                f"trained on {grid_model.ndim}-D data, got {x.shape}")
        eps_keys = tuple(_f32(e) for e in np.asarray(grid_model.ebs))
        item = Item((slice_digest(x), svc._check_cfg(grid_model.cfg)), x,
                    eps_keys)
        return _request(self, [item], {
            "grid_model": grid_model, "device": svc.device,
            "target_cr": target_cr, "tol": tol, "max_iters": max_iters})

    def post_process(self, req, rows_for):
        gm, pl = req.payload["grid_model"], req.payload
        item = req.items[0]
        data = _on_device(pl["device"], item.x)
        feat_cache = P.get_engine(gm.cfg).cached(
            data, features=_on_device(pl["device"], rows_for(item)),
            epss=gm.ebs)
        return UC.find_error_bound_for_cr(
            gm, data, pl["target_cr"], tol=pl["tol"],
            max_iters=pl["max_iters"], feat_cache=feat_cache)


class BestCompressorMethod(ServableMethod):
    """UC2: (best_name, preds) at an error bound, bit-equal to
    ``usecases.best_compressor``."""

    name = "best_compressor"

    def pre_process(self, svc, models: Dict[str, Any], data,
                    eps) -> MethodRequest:
        if not models:
            raise ValueError("submit_best_compressor needs trained models")
        x = _checked_rank(models, data, "submit_best_compressor")
        cfg = svc._check_cfg(next(iter(models.values())).cfg)
        item = Item((slice_digest(x), cfg), x, (_f32(eps),))
        return _request(self, [item], {"models": models, "eps": eps})

    def post_process(self, req, rows_for):
        item = req.items[0]
        return UC.best_compressor(req.payload["models"], item.x,
                                  req.payload["eps"], feats=rows_for(item))


class AdviseMethod(ServableMethod):
    """Compression-advisor chunk: a (k, ...) row stack + per-compressor
    ``EbGridModel``s -> ``{"compressors", "ebs", "cr": (k, n_comp, e)}``,
    the per-row predicted CRs over the shared eb grid.  The features are
    compressor-independent, so one coalesced launch covers every
    compressor.  :meth:`cr_table` is the shared feats -> CR step of the
    served and the direct (``core.stream``) advisor."""

    name = "advise"

    @staticmethod
    def check_models(models: Dict[str, Any]) -> Tuple[np.ndarray, int]:
        """Validate an advisor model set: non-empty, one shared eb grid,
        one shared training rank.  Returns (grid ebs, stack ndim)."""
        if not models:
            raise ValueError("advise needs at least one trained EbGridModel")
        grids = {tuple(np.asarray(m.ebs, np.float64).tolist())
                 for m in models.values()}
        if len(grids) > 1:
            raise ValueError(
                "advise models must share one eb grid (features are "
                f"shared per grid eb); got {len(grids)} distinct grids")
        ndims = {m.ndim for m in models.values()}
        if len(ndims) > 1:
            raise ValueError(
                f"advise models mix training ndims {sorted(ndims)}")
        return np.asarray(next(iter(models.values())).ebs,
                          np.float64), ndims.pop() + 1

    @staticmethod
    def cr_table(models: Dict[str, Any], feats) -> np.ndarray:
        """(k, e, 2) feature rows -> (k, n_comp, e) float64 predicted CRs,
        NaN and inf clamped as ``EbGridModel.predict`` clamps them."""
        feats = np.asarray(feats, np.float32)
        k, e = feats.shape[0], feats.shape[1]
        cr = np.empty((k, len(models), e), np.float64)
        for ci, gm in enumerate(models.values()):
            for ei in range(e):
                preds = predict_fast(gm.models[ei].model, feats[:, ei, :])
                cr[:, ci, ei] = [UC._clamp_cr(v) for v in
                                 preds.detach().cpu().numpy()]
        return cr

    def pre_process(self, svc, models: Dict[str, Any],
                    stack) -> MethodRequest:
        ebs, stack_ndim = self.check_models(models)
        cfg = svc._check_cfg(next(iter(models.values())).cfg)
        arr = _host_f32(stack)
        if arr.ndim != stack_ndim:
            raise ValueError(
                f"submit_advise: models trained on {stack_ndim - 1}-D "
                f"data expect a rank-{stack_ndim} chunk, got {arr.shape}")
        eps_keys = tuple(_f32(e) for e in ebs)
        return _request(self, _stack_items(arr, cfg, eps_keys),
                        {"models": dict(models), "ebs": ebs})

    def post_process(self, req, rows_for):
        feats = np.stack([rows_for(it) for it in req.items])    # (k, e, 2)
        models = req.payload["models"]
        return {"compressors": tuple(models), "ebs": req.payload["ebs"],
                "cr": self.cr_table(models, feats)}


class KVGateMethod(ServableMethod):
    """KV-cache compression gate: a list of array leaves -> (k,) float32
    predicted int8 CRs, one per leaf, equal to ``predicted_cr_int8`` of
    each leaf.  Leaves are flattened and digested like any other row, so
    identical blocks dedup within a batch and repeats ride the cache.
    There is no error bound: rows key on the sentinel eb 0.0."""

    name = "kv_gate"
    batch_buckets = (1, 2, 4, 8, 16, 32, 64, 128, 256)
    EPS_KEY = 0.0

    def __init__(self, launcher: Optional[Int8CRLauncher] = None,
                 batch_buckets=None):
        super().__init__(launcher if launcher is not None
                         else Int8CRLauncher(), batch_buckets)

    def pre_process(self, svc, leaves) -> MethodRequest:
        leaves = list(leaves)
        if not leaves:
            raise ValueError("submit_kv_gate needs at least one leaf")
        items = []
        for leaf in leaves:
            arr = np.ascontiguousarray(_host_f32(leaf).reshape(-1))
            if arr.size == 0:
                raise ValueError("submit_kv_gate: empty leaf")
            items.append(Item((slice_digest(arr), self.launcher.cfg_key),
                              arr, (self.EPS_KEY,)))
        return _request(self, items, {})

    def post_process(self, req, rows_for):
        return np.asarray([rows_for(it)[0, 0] for it in req.items],
                          np.float32)

    def warmup_spec(self, scfg) -> WarmupSpec:
        return WarmupSpec(shapes=((256,),), grid_sizes=(1,),
                          row_buckets=(1, 2))


class QualityMethod(ServableMethod):
    """(k, m, n) / (k, d, m, n) stack x (e,) ebs -> (k, e, 2) [PSNR dB,
    NRMSE] rows, bit-equal to ``quality_sweep(slices, epss)``."""

    name = "quality"

    def __init__(self, launcher: Optional[QualityLauncher] = None,
                 batch_buckets=None):
        super().__init__(launcher if launcher is not None
                         else QualityLauncher(), batch_buckets)

    def pre_process(self, svc, slices, epss, cfg=None) -> MethodRequest:
        cfg = svc._check_cfg(cfg if cfg is not None else svc.scfg.pcfg)
        arr = _checked_stack(slices, "submit_quality")
        eps_keys = _eps_keys(epss, "submit_quality")
        return _request(self, _stack_items(arr, ("quality", cfg), eps_keys),
                        {"eps_keys": eps_keys})

    def post_process(self, req, rows_for):
        return np.stack([rows_for(it) for it in req.items])


class FindSettingMethod(ServableMethod):
    """UC3: the cheapest (compressor, eb) meeting a PSNR floor AND a CR
    floor, bit-equal to ``usecases.find_setting``.  One item over the
    sorted union of every model's grid ebs: one coalesced featurization
    covers every compressor, and quality is predicted from the same rows
    by each model's ``QualityTable`` (no launch of its own)."""

    name = "find_setting"

    def pre_process(self, svc, models: Dict[str, Any], data,
                    cr_floor: float, psnr_floor: float,
                    tol: float = 1e-3, max_iters: int = 48) -> MethodRequest:
        if not models:
            raise ValueError("submit_find_setting needs trained models")
        missing = sorted(n for n, m in models.items() if m.quality is None)
        if missing:
            raise ValueError(
                f"submit_find_setting needs a quality table on every "
                f"model; missing on {missing} (retrain with "
                f"EbGridModel.train)")
        cfgs = {m.cfg for m in models.values()}
        if len(cfgs) > 1:
            raise ValueError(
                "submit_find_setting models mix predictor configs; "
                "features are shared across models, so all must use one "
                "config")
        x = _checked_rank(models, data, "submit_find_setting")
        union = sorted({_f32(e) for m in models.values()
                        for e in np.asarray(m.ebs)})
        item = Item((slice_digest(x), svc._check_cfg(next(iter(cfgs)))), x,
                    tuple(union))
        return _request(self, [item], {
            "models": dict(models), "union": union, "device": svc.device,
            "cr_floor": cr_floor, "psnr_floor": psnr_floor,
            "tol": tol, "max_iters": max_iters})

    def post_process(self, req, rows_for):
        pl = req.payload
        models = pl["models"]
        item = req.items[0]
        data = _on_device(pl["device"], item.x)
        feat_cache = P.get_engine(next(iter(models.values())).cfg).cached(
            data, features=_on_device(pl["device"], rows_for(item)),
            epss=np.asarray(pl["union"], np.float64))
        return UC.find_setting(
            models, data, cr_floor=pl["cr_floor"],
            psnr_floor=pl["psnr_floor"], tol=pl["tol"],
            max_iters=pl["max_iters"], feat_cache=feat_cache)

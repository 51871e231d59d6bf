"""The paper's two production use cases (sections 1 and 5), plus UC3.

UC1 -- fixed-ratio configuration: find the error bound at which a compressor
       achieves a target CR, each bisection probe evaluating the
       *statistical model* instead of running the compressor.
UC2 -- best-compressor selection: rank compressors by predicted CR at a
       fixed error bound without running any of them.
UC3 -- joint ratio-quality configuration: the cheapest (compressor, eb)
       meeting a PSNR floor AND a CR floor, by bisection over the
       monotone joint frontier (:func:`find_setting`).

Cross-error-bound modelling follows section 4.4: per-eb regressions are fit
on a small grid of error bounds and predictions are interpolated in
log(eps).  Features come from the sweep engine on the data's device; the
per-eb fits and the search logic run on small host-side values.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import compressors as C
from repro_torch.core import pipeline as PL
from repro_torch.core import predictors as P
from repro_torch.core.regression import predict_fast
from repro_torch.dist import sweep as DS
from repro_torch.kernels.quality import PSNR_CAP


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


# Model outputs pass through np.log during cross-eb interpolation and
# bisection compares the result against the target ratio, so a degenerate
# regression (extrapolation far outside the training range) must never
# yield log(<=0) = NaN: clamp predicted CRs into a positive finite band.
# +inf must clamp to the CEILING (still "far above any target"), not the
# floor, or bisection would discard the wrong half of the bracket; NaN
# carries no direction, so it lands on the floor.
_CR_FLOOR = 1e-9
_CR_CEIL = 1e9


def _clamp_cr(value) -> float:
    v = float(value)
    if np.isnan(v):
        return _CR_FLOOR
    return float(np.clip(v, _CR_FLOOR, _CR_CEIL))


@dataclasses.dataclass
class QualityTable:
    """Per-grid-eb quality models riding next to the CR models.

    For each grid eb a least-squares affine map from the 2 predictor
    features to the quantization proxy's PSNR (labels come from the
    fused ``kernels/quality`` half of the SAME training sweep -- zero
    extra passes over the data, and UC3 queries ride the same
    SliceCache features UC1 does).  The proxy PSNR is
    compressor-independent (it depends only on the data and the eb), but
    the table lives per :class:`EbGridModel` so each compressor's grid
    carries its own quality curve.
    """
    coef: np.ndarray                      # (e, 3): [w_qent, w_trunc, bias]
    mean_psnr: np.ndarray                 # (e,) training-set mean PSNR
    mean_nrmse: np.ndarray                # (e,) training-set mean NRMSE

    @staticmethod
    def fit(feats, qual) -> "QualityTable":
        """(k, e, 2) features x (k, e, 2) [psnr, nrmse] labels -> table.

        ``lstsq`` returns the min-norm solution, so degenerate designs
        (k=1, constant features) fit cleanly instead of raising."""
        feats = _host(feats)
        qual = _host(qual)
        k, e, _ = feats.shape
        coef = np.zeros((e, 3), np.float64)
        for i in range(e):
            a = np.concatenate([feats[:, i, :], np.ones((k, 1))], axis=1)
            y = np.clip(qual[:, i, 0], -PSNR_CAP, PSNR_CAP)
            sol, *_ = np.linalg.lstsq(a, y, rcond=None)
            if not np.all(np.isfinite(sol)):
                sol = np.array([0.0, 0.0, float(np.mean(y))])
            coef[i] = sol
        return QualityTable(coef, qual[:, :, 0].mean(axis=0),
                            qual[:, :, 1].mean(axis=0))

    def predict_one(self, i: int, feats) -> float:
        """Predicted proxy PSNR (dB) at grid index ``i`` from a (2,)
        feature vector, clamped to the kernel's +-PSNR_CAP band."""
        f = _host(feats).reshape(-1)
        v = self.coef[i, 0] * f[0] + self.coef[i, 1] * f[1] + self.coef[i, 2]
        if not np.isfinite(v):
            v = self.mean_psnr[i]
        return float(np.clip(v, -PSNR_CAP, PSNR_CAP))


@dataclasses.dataclass
class EbGridModel:
    """CR predictor across error bounds: one model per grid eb +
    log-linear interpolation of log(CR) between neighbouring grid points."""
    ebs: np.ndarray                       # ascending error-bound grid
    models: list                          # CRPredictor per eb
    name: str = ""
    cfg: P.PredictorConfig = dataclasses.field(default_factory=P.PredictorConfig)
    quality: Optional[QualityTable] = None

    @staticmethod
    def train(
        slices: torch.Tensor,
        compressor: str,
        ebs: Sequence[float],
        model: str = "spline",
        cfg: P.PredictorConfig = P.PredictorConfig(),
        mesh=None,
        ndim: int = 2,
    ) -> "EbGridModel":
        """``ndim=2``: (k, m, n) slice stack; ``ndim=3``: (k, d, m, n)
        volume stack (HOSVD featurization).  Under a mesh (``mesh=`` or
        the active one) the sweep shards the slice axis, and under a
        process-spanning one the compressor runs split over the same
        mesh's processes (``dist.sweep.training_crs``); the features and
        the CR table are the unsharded ones bit for bit."""
        if slices.ndim != ndim + 1:
            raise ValueError(
                f"EbGridModel.train(ndim={ndim}) expects a rank-{ndim + 1} "
                f"stack, got {tuple(slices.shape)}")
        comp = C.get(compressor)
        # ONE fused sweep featurizes every (slice, grid-eb) pair and, with
        # quality=True, also emits the PSNR/NRMSE labels of the quality table
        feats, qual = P.get_engine(cfg).sweep(
            slices, np.asarray(ebs, np.float64), mesh=mesh, quality=True)
        cr_table = DS.training_crs(comp, slices, ebs,
                                   mesh=DS.active_sweep_mesh(mesh))
        models = []
        for i, eps in enumerate(ebs):
            models.append(PL.CRPredictor.train_from_features(
                feats[:, i, :], cr_table[:, i], float(eps), model, cfg, ndim))
        return EbGridModel(np.asarray(ebs, np.float64), models, compressor,
                           cfg, QualityTable.fit(feats, qual))

    @property
    def ndim(self) -> int:
        """Training data rank: 2 (slices) or 3 (volumes)."""
        return self.models[0].ndim if self.models else 2

    def _check_rank(self, data) -> None:
        if data.ndim != self.ndim:
            raise ValueError(
                f"EbGridModel '{self.name}' was trained on "
                f"{self.ndim}-D data; got rank-{data.ndim} input "
                f"{tuple(data.shape)}")

    def log_ebs(self) -> np.ndarray:
        """log of the eb grid, computed once per model (every bisection
        probe used to recompute it)."""
        lg = getattr(self, "_log_ebs", None)
        if lg is None:
            lg = self._log_ebs = np.log(self.ebs)
        return lg

    def predict(self, data: torch.Tensor, eps: float,
                feat_cache=None) -> float:
        """Predicted CR for one slice (or (d, m, n) volume) at an
        arbitrary eb (log-interp).

        ``feat_cache``: a ``predictors.SliceCache`` (or any callable
        eps -> (2,)); reuses the eps-independent SVD/sigma across the
        whole sweep (the paper's UC1 cost structure)."""
        self._check_rank(data)
        if feat_cache is None:
            # featurize under the SAME config the models were trained with
            feat_cache = P.get_engine(self.cfg).cached(data)
        le = np.log(eps)
        lg = self.log_ebs()
        if le <= lg[0]:
            i0, i1, t = 0, 0, 0.0
        elif le >= lg[-1]:
            i0, i1, t = len(lg) - 1, len(lg) - 1, 0.0
        else:
            i1 = int(np.searchsorted(lg, le))
            if le == lg[i1]:
                # exact interior grid point: one model evaluation
                # suffices (t would come out 1.0 and cost two)
                i0, t = i1, 0.0
            else:
                i0 = i1 - 1
                t = (le - lg[i0]) / (lg[i1] - lg[i0])
        # q-ent is eb-dependent -> evaluate features at the grid ebs
        f0 = feat_cache(self.ebs[i0])[None]
        c0 = _clamp_cr(predict_fast(self.models[i0].model, f0)[0])
        if i1 == i0:
            return c0
        f1 = feat_cache(self.ebs[i1])[None]
        c1 = _clamp_cr(predict_fast(self.models[i1].model, f1)[0])
        return float(np.exp((1 - t) * np.log(c0) + t * np.log(c1)))

    def predict_psnr(self, data: torch.Tensor, eps: float,
                     feat_cache=None) -> float:
        """Predicted proxy PSNR (dB) for one slice/volume at an
        arbitrary eb: the per-grid-eb quality models evaluated on the
        same cached features as :meth:`predict`, linear in log(eps)
        between grid points (PSNR is already a log-domain quantity)."""
        if self.quality is None:
            raise ValueError(
                f"EbGridModel '{self.name}' has no quality table; retrain "
                "with EbGridModel.train (quality models are fit from the "
                "same fused sweep that features the CR models)")
        self._check_rank(data)
        if feat_cache is None:
            feat_cache = P.get_engine(self.cfg).cached(data)
        le = np.log(eps)
        lg = self.log_ebs()
        if le <= lg[0]:
            i0, i1, t = 0, 0, 0.0
        elif le >= lg[-1]:
            i0, i1, t = len(lg) - 1, len(lg) - 1, 0.0
        else:
            i1 = int(np.searchsorted(lg, le))
            if le == lg[i1]:
                i0, t = i1, 0.0
            else:
                i0 = i1 - 1
                t = (le - lg[i0]) / (lg[i1] - lg[i0])
        p0 = self.quality.predict_one(i0, feat_cache(self.ebs[i0]))
        if i1 == i0:
            return p0
        p1 = self.quality.predict_one(i1, feat_cache(self.ebs[i1]))
        return float((1 - t) * p0 + t * p1)


def find_error_bound_for_cr(
    grid_model: EbGridModel,
    data: torch.Tensor,
    target_cr: float,
    tol: float = 0.02,
    max_iters: int = 32,
    feat_cache=None,
) -> tuple[float, float]:
    """UC1: bisection on log(eps) using the statistical model only.

    Returns (eps, predicted_cr).  CR(eps) is monotone nondecreasing, so
    bisection converges; the model evaluation replaces compressor runs.

    ``feat_cache``: an externally supplied eps -> (2,) feature source
    (e.g. a :class:`predictors.SliceCache` seeded from a shared batched
    sweep); it
    must already cover the model-grid ebs.  When None, ONE fused sweep up
    front covers every probe: SVD once, the slice read once, all grid
    q-ents from a single kernel launch.
    """
    # Bisection only ever evaluates features at the model-grid ebs.
    grid_model._check_rank(data)
    if feat_cache is None:
        feat_cache = P.get_engine(grid_model.cfg).cached(data)
        feat_cache.prefetch(grid_model.ebs)

    lo, hi = float(grid_model.ebs[0]), float(grid_model.ebs[-1])
    cr_lo = grid_model.predict(data, lo, feat_cache)
    cr_hi = grid_model.predict(data, hi, feat_cache)
    if target_cr <= cr_lo:
        return lo, cr_lo
    if target_cr >= cr_hi:
        return hi, cr_hi
    # max_iters=0 must still return a finite probe (mirrors
    # find_error_bound_exhaustive), not NameError on unbound loop vars
    mid, cr_mid = hi, cr_hi
    for _ in range(max_iters):
        mid = float(np.exp(0.5 * (np.log(lo) + np.log(hi))))
        cr_mid = grid_model.predict(data, mid, feat_cache)
        if abs(cr_mid - target_cr) / target_cr < tol:
            return mid, cr_mid
        if cr_mid < target_cr:
            lo = mid
        else:
            hi = mid
    return mid, cr_mid


def find_error_bound_exhaustive(
    compressor: str,
    data: torch.Tensor,
    target_cr: float,
    lo: float,
    hi: float,
    tol: float = 0.02,
    max_iters: int = 32,
) -> tuple[float, float, int]:
    """UC1 baseline: same bisection but *running the compressor* per probe
    (what OptZConfig does).  Returns (eps, cr, num_compressor_runs)."""
    comp = C.get(compressor)
    runs = 0
    cr_lo = comp.cr(data, lo); runs += 1
    cr_hi = comp.cr(data, hi); runs += 1
    if target_cr <= cr_lo:
        return lo, cr_lo, runs
    if target_cr >= cr_hi:
        return hi, cr_hi, runs
    mid, cr_mid = hi, cr_hi
    for _ in range(max_iters):
        mid = float(np.exp(0.5 * (np.log(lo) + np.log(hi))))
        cr_mid = comp.cr(data, mid); runs += 1
        if abs(cr_mid - target_cr) / target_cr < tol:
            break
        if cr_mid < target_cr:
            lo = mid
        else:
            hi = mid
    return mid, cr_mid, runs


def best_compressor(
    models: Dict[str, object],
    data: torch.Tensor,
    eps: float,
    feats=None,
) -> tuple[str, Dict[str, float]]:
    """UC2: rank compressors by predicted CR; no compressor executions.

    ``models``: name -> trained CRPredictor at this eps.  The expensive
    featurization (SVD + q-ent) is shared across compressors -- computed
    once by the engine, fed to every model (the paper's key UC2 cost
    structure).  ``feats``: an externally supplied (1, 2) feature matrix
    for ``data`` at ``eps`` (e.g. a row of a shared batched sweep);
    when None the engine featurizes here.
    """
    if not models:
        raise ValueError(
            "best_compressor needs at least one trained model; got an "
            "empty models dict (train CRPredictors per compressor first)")
    ndims = {m.ndim for m in models.values()}
    if len(ndims) > 1:
        raise ValueError(
            f"best_compressor models mix training ndims {sorted(ndims)}; "
            "features are shared across models, so all must be trained "
            "on the same data rank")
    model_ndim = ndims.pop()
    if data.ndim != model_ndim:
        raise ValueError(
            f"best_compressor models were trained on {model_ndim}-D data; "
            f"got rank-{data.ndim} input {tuple(data.shape)}")
    if feats is None:
        # featurize under the config the models were trained with
        cfg = next(iter(models.values())).cfg
        feats = P.get_engine(cfg).features(data[None], eps)
    preds = {name: float(predict_fast(m.model, feats)[0])
             for name, m in models.items()}
    return max(preds, key=preds.get), preds


@dataclasses.dataclass(frozen=True)
class JointSetting:
    """UC3 result: the cheapest (compressor, eb) meeting both floors.

    "Cheapest" = largest predicted CR among the settings that satisfy
    PSNR >= psnr_floor AND CR >= cr_floor.  ``feasible=False`` is the
    TYPED infeasible result: ``compressor``/``eb`` then carry the
    best-achievable diagnostic setting (highest CR inside the quality
    region, or the least-bad quality point when no compressor reaches
    the PSNR floor at all) and ``reason`` says which floor failed.
    ``candidates`` holds the per-compressor frontier diagnostics.
    """
    feasible: bool
    compressor: Optional[str]
    eb: Optional[float]
    predicted_cr: Optional[float]
    predicted_psnr: Optional[float]
    reason: str = ""
    candidates: Dict[str, dict] = dataclasses.field(default_factory=dict)


def find_setting(
    models: Dict[str, EbGridModel],
    data: torch.Tensor,
    *,
    cr_floor: float,
    psnr_floor: float,
    tol: float = 1e-3,
    max_iters: int = 48,
    feat_cache=None,
) -> JointSetting:
    """UC3: cheapest (compressor, eb) with PSNR >= ``psnr_floor`` and
    CR >= ``cr_floor``, via bisection over the monotone joint frontier.

    Per compressor the grid PSNR curve is monotonized nonincreasing in
    eb and the grid CR curve nondecreasing (both physically monotone;
    monotonization absorbs regression noise), so the quality-feasible
    region is the eb interval [grid floor, eb_q] and the best CR inside
    it sits at eb_q -- found by bisection on log(eb) with the invariant
    ``psnr(lo) >= floor > psnr(hi)``, then SNAPPED UP to the largest
    quality-feasible grid eb.  The snap makes the search grid-complete
    regardless of ``max_iters``: whenever some grid point satisfies both
    (monotonized) floors, the returned setting is feasible, because
    eb_q never undershoots a feasible grid point and CR is
    nondecreasing toward it.

    ``feat_cache``: shared eps -> (2,) feature source covering every
    model's grid ebs (e.g. one seeded from a shared batched sweep);
    when None, one engine cache per distinct grid is
    prefetched here -- featurization still happens once, not per
    compressor.  Ties prefer the lexicographically first compressor
    name (deterministic across runs).
    """
    if not models:
        raise ValueError(
            "find_setting needs at least one trained EbGridModel; got an "
            "empty models dict")
    ndims = {m.ndim for m in models.values()}
    if len(ndims) > 1:
        raise ValueError(
            f"find_setting models mix training ndims {sorted(ndims)}; "
            "features are shared across models, so all must be trained "
            "on the same data rank")
    missing = sorted(n for n, m in models.items() if m.quality is None)
    if missing:
        raise ValueError(
            f"find_setting needs a quality table on every model; missing "
            f"on {missing} (retrain with EbGridModel.train)")
    first = next(iter(models.values()))
    first._check_rank(data)
    if feat_cache is None:
        cfgs = {m.cfg for m in models.values()}
        if len(cfgs) > 1:
            raise ValueError(
                "find_setting models mix predictor configs; features are "
                "shared across models, so all must use one config")
        feat_cache = P.get_engine(first.cfg).cached(data)
        for grid in {tuple(float(e) for e in m.ebs) for m in models.values()}:
            feat_cache.prefetch(np.asarray(grid, np.float64))

    candidates: Dict[str, dict] = {}
    best: Optional[str] = None
    for name in sorted(models):
        gm = models[name]
        lg = gm.log_ebs()
        pg = np.minimum.accumulate(
            [gm.predict_psnr(data, float(e), feat_cache) for e in gm.ebs])
        cg = np.maximum.accumulate(
            [gm.predict(data, float(e), feat_cache) for e in gm.ebs])
        lcg = np.log(cg)          # cg is _clamp_cr-positive, log is finite

        if pg[0] < psnr_floor:
            # even the finest grid eb misses the quality floor
            candidates[name] = {
                "quality_ok": False, "cr_ok": False, "eb": float(gm.ebs[0]),
                "psnr": float(pg[0]), "cr": float(cg[0])}
            continue
        if pg[-1] >= psnr_floor:
            le_q = float(lg[-1])
        else:
            lo, hi = float(lg[0]), float(lg[-1])
            for _ in range(max_iters):
                if hi - lo < tol:
                    break
                mid = 0.5 * (lo + hi)
                if float(np.interp(mid, lg, pg)) >= psnr_floor:
                    lo = mid
                else:
                    hi = mid
            # grid-snap: never land below the largest quality-feasible
            # grid eb (grid-completeness must not depend on max_iters)
            j_star = int(np.nonzero(pg >= psnr_floor)[0][-1])
            le_q = max(lo, float(lg[j_star]))
        eb_q = float(np.exp(le_q))
        # exp(interp(log cr)) can round a hair BELOW the exact grid
        # value; the curve is nondecreasing, so the last grid point at
        # or under le_q is an exact lower bound -- without it a floor
        # sitting exactly on the frontier tests infeasible by one ulp
        jlo = int(np.searchsorted(lg, le_q + 1e-12, side="right") - 1)
        cr_q = float(max(np.exp(np.interp(le_q, lg, lcg)), cg[jlo]))
        psnr_q = float(np.interp(le_q, lg, pg))
        cr_ok = cr_q >= cr_floor
        candidates[name] = {
            "quality_ok": True, "cr_ok": bool(cr_ok), "eb": eb_q,
            "psnr": psnr_q, "cr": cr_q}
        if cr_ok and (best is None or cr_q > candidates[best]["cr"]):
            best = name

    if best is not None:
        c = candidates[best]
        return JointSetting(
            True, best, c["eb"], c["cr"], c["psnr"],
            reason="cheapest setting meeting both floors", candidates=candidates)
    q_ok = {n: c for n, c in candidates.items() if c["quality_ok"]}
    if q_ok:
        name = min(q_ok, key=lambda n: (-q_ok[n]["cr"], n))
        c = q_ok[name]
        return JointSetting(
            False, name, c["eb"], c["cr"], c["psnr"],
            reason=(f"no compressor reaches CR >= {cr_floor:g} inside the "
                    f"PSNR >= {psnr_floor:g} region; best achievable CR is "
                    f"{c['cr']:.3g}"),
            candidates=candidates)
    name = min(candidates, key=lambda n: (-candidates[n]["psnr"], n))
    c = candidates[name]
    return JointSetting(
        False, name, c["eb"], c["cr"], c["psnr"],
        reason=(f"PSNR floor {psnr_floor:g} is unreachable on every grid "
                f"(best {c['psnr']:.1f} dB at the finest eb)"),
        candidates=candidates)


def best_compressor_exhaustive(
    names: Sequence[str],
    data: torch.Tensor,
    eps: float,
) -> tuple[str, Dict[str, float]]:
    """UC2 baseline: run every compressor (Tao et al. 2019b procedure)."""
    crs = {n: C.get(n).cr(data, eps) for n in names}
    return max(crs, key=crs.get), crs

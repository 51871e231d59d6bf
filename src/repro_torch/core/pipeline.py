"""Two-step CR-prediction pipeline + evaluation (paper sections 3.2-3.3).

Step (1): compressor-agnostic predictors per slice (``core.predictors``).
Step (2): per-(compressor, field) regression trained on observed CRs.

Evaluation follows Algorithm 1: k-fold cross-validation, out-of-sample
median absolute percentage error (MedAPE) with 10%/90% quantiles, and the
linear correlation between true and predicted CRs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import predictors as P
from repro_torch.core import regression as R


@dataclasses.dataclass
class EvalResult:
    medape: float            # median over folds of per-fold median APE (%)
    medape_q10: float
    medape_q90: float
    correlation: float       # pooled over all out-of-sample predictions
    true_cr: np.ndarray
    pred_cr: np.ndarray


def ape(true: np.ndarray, pred: np.ndarray) -> np.ndarray:
    return 100.0 * np.abs(true - pred) / np.abs(true)


def featurize_slices(slices: torch.Tensor, eps: float,
                     cfg: P.PredictorConfig = P.PredictorConfig(), *,
                     mesh=None) -> torch.Tensor:
    """(k, m, n) slices or (k, d, m, n) volumes -> (k, 2) predictors at
    one eb (the single-eb column of the sweep engine); sharded over an
    active or passed mesh."""
    return P.get_engine(cfg).features(slices, eps, mesh=mesh)


def featurize_sweep(slices: torch.Tensor, epss,
                    cfg: P.PredictorConfig = P.PredictorConfig(), *,
                    mesh=None) -> torch.Tensor:
    """(k, m, n) | (k, d, m, n) x (e,) -> (k, e, 2) in one pass; sharded
    over an active or passed mesh."""
    return P.get_engine(cfg).sweep(slices, epss, mesh=mesh)


def kfold_evaluate(features, cr, model: str = "spline", k: int = 8,
                   seed: int = 0) -> EvalResult:
    """Algorithm 1: k-fold CV of the CR regression; returns MedAPE stats.
    The same numpy fold permutation as the reference; the small fits run
    on the CPU."""
    features = np.asarray(features, np.float64)
    cr = np.asarray(cr, np.float64)
    n = len(cr)
    k = min(k, n)
    perm = np.random.default_rng(seed).permutation(n)
    folds = np.array_split(perm, k)
    fit = R.MODEL_REGISTRY[model]

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32)

    fold_medape, all_true, all_pred = [], [], []
    for f in folds:
        test_mask = np.zeros(n, bool)
        test_mask[f] = True
        m = fit(f32(features[~test_mask]), f32(cr[~test_mask]))
        pred = m.predict(f32(features[test_mask])).numpy()
        y_te = cr[test_mask]
        fold_medape.append(float(np.median(ape(y_te, pred))))
        all_true.append(y_te)
        all_pred.append(pred)

    true = np.concatenate(all_true)
    pred = np.concatenate(all_pred)
    corr = float(np.corrcoef(true, pred)[0, 1]) if len(true) > 1 else 1.0
    med = np.asarray(fold_medape)
    return EvalResult(
        medape=float(np.quantile(med, 0.5)),
        medape_q10=float(np.quantile(med, 0.1)),
        medape_q90=float(np.quantile(med, 0.9)),
        correlation=corr, true_cr=true, pred_cr=pred)


@dataclasses.dataclass
class CRPredictor:
    """A trained (compressor, field, error-bound) CR predictor."""
    model: object
    eps: float
    cfg: P.PredictorConfig = dataclasses.field(default_factory=P.PredictorConfig)
    ndim: int = 2

    @staticmethod
    def train(slices: torch.Tensor, cr, eps: float, model: str = "spline",
              cfg: P.PredictorConfig = P.PredictorConfig(),
              ndim: int = 2) -> "CRPredictor":
        if slices.ndim != ndim + 1:
            raise ValueError(
                f"CRPredictor.train(ndim={ndim}) expects a rank-{ndim + 1} "
                f"stack, got {tuple(slices.shape)}")
        feats = featurize_slices(slices, eps, cfg)
        return CRPredictor.train_from_features(feats, cr, eps, model, cfg, ndim)

    @staticmethod
    def train_from_features(feats: torch.Tensor, cr, eps: float,
                            model: str = "spline",
                            cfg: P.PredictorConfig = P.PredictorConfig(),
                            ndim: int = 2) -> "CRPredictor":
        """Fit from a precomputed (k, 2) feature matrix; the model lives on
        the features' device."""
        feats = torch.as_tensor(feats, dtype=torch.float32)
        cr = torch.as_tensor(cr, dtype=torch.float32).to(feats.device)
        return CRPredictor(R.MODEL_REGISTRY[model](feats, cr), eps, cfg, ndim)

    def predict_from_features(self, feats: torch.Tensor) -> torch.Tensor:
        return self.model.predict(feats)

    def predict(self, slices: torch.Tensor) -> torch.Tensor:
        if slices.ndim != self.ndim + 1:
            raise ValueError(
                f"CRPredictor(ndim={self.ndim}).predict expects a "
                f"rank-{self.ndim + 1} stack, got {tuple(slices.shape)}")
        return self.model.predict(featurize_slices(slices, self.eps, self.cfg))

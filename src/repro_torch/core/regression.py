"""Regression models for CR prediction (paper section 3.2), in float32.

* ``LinearCRModel``  -- Eq. (1): log(CR) = a + b*log(qent) + c*log(svd/sigma)
                        + d * interaction, least squares.
* ``SplineCRModel``  -- Eq. (2): GAM with natural cubic splines (3 knots) per
                        predictor + tensor-product interaction, penalized LS.
* ``lasso_importance`` -- cross-validated LASSO (FISTA) on the Eq.-(1)
                        design: the predictor importances of Table 3.

Standardized predictors and log(CR) targets, as in the reference; every
tensor is float32, the precision the reference runs in.  A model lives
on the device of the features it was fit on.  A prediction adds each
design row's products in a fixed order (``refmath.sum_rows_f32``, left
to right at these widths), not by ``x @ coef``: a library mat-vec picks
its kernel, and so its order, from the row count, and a row's
prediction would then depend on how many rows it is predicted with (an
advisor chunk against the whole variable).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.refmath import sum_rows_f32


class Standardizer(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor

    @staticmethod
    def fit(x: torch.Tensor) -> "Standardizer":
        return Standardizer(x.mean(dim=0),
                            torch.clamp(torch.std(x, dim=0, correction=0),
                                        min=1e-8))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.std


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Linear model (Eq. 1)
# ---------------------------------------------------------------------------

def _linear_design(z: torch.Tensor) -> torch.Tensor:
    """[1, z1, z2, z1*z2] design from standardized predictors (n, 2)."""
    one = torch.ones((z.shape[0], 1), dtype=z.dtype, device=z.device)
    inter = (z[:, 0] * z[:, 1])[:, None]
    return torch.cat([one, z, inter], dim=1)


class LinearCRModel(NamedTuple):
    """log(CR) ~ a + b z1 + c z2 + d z1 z2 with standardized predictors."""
    std: Standardizer
    coef: torch.Tensor          # (4,)

    @staticmethod
    def fit(features, cr, ridge: float = 1e-8) -> "LinearCRModel":
        features = _f32(features)
        std = Standardizer.fit(features)
        x = _linear_design(std(features))
        y = torch.log(_f32(cr, features.device))
        xtx = x.T @ x + ridge * torch.eye(x.shape[1], device=x.device)
        coef = torch.linalg.solve(xtx, x.T @ y)
        return LinearCRModel(std, coef)

    def predict(self, features) -> torch.Tensor:
        return torch.exp(self.predict_log(features))

    def predict_log(self, features) -> torch.Tensor:
        features = _f32(features, self.coef.device)
        return sum_rows_f32(_linear_design(self.std(features)) * self.coef)


# ---------------------------------------------------------------------------
# Natural cubic spline basis (ESL section 5.2.1), K knots -> K basis funcs
# ---------------------------------------------------------------------------

def ncs_basis(x: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """Natural cubic spline basis N(x): (n,) -> (n, K).

    N1 = 1, N2 = x, N_{k+2} = d_k - d_{K-1} with
    d_k(x) = ((x - xi_k)^3_+ - (x - xi_K)^3_+) / (xi_K - xi_k).
    """
    k = knots.shape[0]

    def d(j):
        num = (torch.clamp(x - knots[j], min=0.0) ** 3
               - torch.clamp(x - knots[k - 1], min=0.0) ** 3)
        return num / (knots[k - 1] - knots[j])

    cols = [torch.ones_like(x), x]
    d_last = d(k - 2)
    for j in range(k - 2):
        cols.append(d(j) - d_last)
    return torch.stack(cols, dim=1)


def _quantile_knots(z: torch.Tensor, num_knots: int) -> torch.Tensor:
    qs = torch.linspace(0.05, 0.95, num_knots, dtype=torch.float32,
                        device=z.device)
    knots = torch.quantile(z, qs)
    # degenerate guard: strictly increasing knots
    return knots + torch.arange(num_knots, dtype=torch.float32,
                                device=z.device) * 1e-6


def _spline_design(z: torch.Tensor, knots1: torch.Tensor,
                   knots2: torch.Tensor) -> torch.Tensor:
    """GAM design: [1, N1_nonconst(z1), N2_nonconst(z2), outer(ti-parts)]."""
    smooth1 = ncs_basis(z[:, 0], knots1)[:, 1:]     # drop shared intercept
    smooth2 = ncs_basis(z[:, 1], knots2)[:, 1:]
    ti = (smooth1[:, :, None] * smooth2[:, None, :]).reshape(z.shape[0], -1)
    one = torch.ones((z.shape[0], 1), dtype=z.dtype, device=z.device)
    return torch.cat([one, smooth1, smooth2, ti], dim=1)


class SplineCRModel(NamedTuple):
    """GAM (Eq. 2): cubic splines + tensor-product interaction, 3 knots."""
    std: Standardizer
    knots1: torch.Tensor
    knots2: torch.Tensor
    coef: torch.Tensor

    @staticmethod
    def fit(features, cr, num_knots: int = 3,
            ridge: float = 1e-4) -> "SplineCRModel":
        features = _f32(features)
        std = Standardizer.fit(features)
        z = std(features)
        knots1 = _quantile_knots(z[:, 0], num_knots)
        knots2 = _quantile_knots(z[:, 1], num_knots)
        x = _spline_design(z, knots1, knots2)
        y = torch.log(_f32(cr, features.device))
        # penalized LS; the intercept is not penalized
        pen = ridge * torch.eye(x.shape[1], device=x.device)
        pen[0, 0] = 0.0
        coef = torch.linalg.solve(x.T @ x + pen, x.T @ y)
        return SplineCRModel(std, knots1, knots2, coef)

    def predict(self, features) -> torch.Tensor:
        return torch.exp(self.predict_log(features))

    def predict_log(self, features) -> torch.Tensor:
        features = _f32(features, self.coef.device)
        x = _spline_design(self.std(features), self.knots1, self.knots2)
        return sum_rows_f32(x * self.coef)

# ---------------------------------------------------------------------------
# LASSO via FISTA (predictor importance, Table 3)
# ---------------------------------------------------------------------------

def _soft_threshold(x: torch.Tensor, t) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(x.abs() - t, min=0.0)


def _fista(xtx: torch.Tensor, xty: torch.Tensor, lam: torch.Tensor,
           num_iters: int) -> torch.Tensor:
    """FISTA for a batch of problems: (..., p, p) Grams, (..., p) moments,
    (L,) penalties -> (..., L, p) coefficients, each (problem, penalty)
    the reference's iteration (step 1/L, intercept unpenalized)."""
    p = xtx.shape[-1]
    lip = torch.linalg.eigvalsh(xtx)[..., -1] + 1e-8
    step = (1.0 / lip)[..., None, None]                      # (..., 1, 1)
    thresh = step * lam[:, None]                             # (..., L, 1)
    mask = torch.ones(p, dtype=torch.float32, device=xtx.device)
    mask[0] = 0.0                                            # the intercept
    b = torch.zeros(xtx.shape[:-2] + (lam.shape[0], p),
                    dtype=torch.float32, device=xtx.device)
    v = b
    t = torch.ones((), dtype=torch.float32, device=xtx.device)
    xtx_t = xtx.transpose(-1, -2)
    for _ in range(num_iters):
        z = v - step * (v @ xtx_t - xty[..., None, :])
        b_new = _soft_threshold(z, thresh) * mask + z * (1 - mask)
        t_new = (1 + torch.sqrt(1 + 4 * t * t)) / 2
        v = b_new + ((t - 1) / t_new) * (b_new - b)
        b, t = b_new, t_new
    return b


def _moments(x: torch.Tensor, y: torch.Tensor):
    n = torch.tensor(float(x.shape[-2]), dtype=torch.float32, device=x.device)
    xt = x.transpose(-1, -2)
    return xt @ x / n, (xt @ y[..., None])[..., 0] / n


def lasso_fit(x, y, lam, num_iters: int = 500) -> torch.Tensor:
    """min_b 1/(2n) ||y - X b||^2 + lam ||b_{1:}||_1 (intercept unpenalized),
    by FISTA with the fixed step 1/L, L the largest eigenvalue of
    X^T X / n; float32.  A scalar ``lam`` gives the (p,) coefficients,
    an (L,) vector the (L, p) ones of every penalty in one batch."""
    x = _f32(x)
    lam_t = _f32(lam, x.device)
    b = _fista(*_moments(x, _f32(y, x.device)), lam_t.reshape(-1), num_iters)
    return b[0] if lam_t.ndim == 0 else b


def lasso_importance(features, cr, lam_grid=None, k: int = 8, seed: int = 0,
                     perm=None) -> torch.Tensor:
    """Cross-validated LASSO on the Eq.-(1) design; returns |coef| for
    [qent, svd/sigma, interaction] -- the paper's Table 3 numbers.

    The k folds split ``perm``, a permutation of the rows (by default
    drawn from a ``torch.Generator`` seeded with ``seed``); every fold
    and penalty of the grid (default 20 values, 1e-4 .. 1) is solved in
    one batched FISTA."""
    features = _f32(features)
    dev = features.device
    x = _linear_design(Standardizer.fit(features)(features))
    y = torch.log(_f32(cr, dev))
    yz = (y - y.mean()) / torch.clamp(torch.std(y, correction=0), min=1e-8)
    lam = (torch.logspace(-4, 0, 20, dtype=torch.float32, device=dev)
           if lam_grid is None else _f32(lam_grid, dev).reshape(-1))
    n = x.shape[0]
    if perm is None:
        gen = torch.Generator().manual_seed(seed)
        perm = torch.randperm(n, generator=gen)
    folds = torch.tensor_split(torch.as_tensor(perm, device=dev), k)
    test = torch.zeros((k, n), dtype=torch.bool, device=dev)
    for i, f in enumerate(folds):
        test[i, f] = True
    w = (~test).to(torch.float32)                            # (k, n)
    b = _fista(*_moments(x * w[:, :, None], yz * w), lam, 500)  # (k, L, p)
    resid = (b @ x.T - yz) * test[:, None, :]                # (k, L, n)
    errs = ((resid ** 2).sum(-1)
            / torch.clamp(test.sum(-1), min=1)[:, None]).mean(0)
    best = lam[torch.argmin(errs)]
    return lasso_fit(x, yz, best).abs()[1:]


def predict_fast(model, feats) -> torch.Tensor:
    """Whole-model evaluation (the reference jits this; PyTorch runs
    eagerly, so it is the plain call)."""
    return model.predict(feats)


MODEL_REGISTRY: dict[str, Callable] = {
    "linear": LinearCRModel.fit,
    "spline": SplineCRModel.fit,
}

"""Regression models for CR prediction (paper section 3.2), in float32.

* ``LinearCRModel``  -- Eq. (1): log(CR) = a + b*log(qent) + c*log(svd/sigma)
                        + d * interaction, least squares.
* ``SplineCRModel``  -- Eq. (2): GAM with natural cubic splines (3 knots) per
                        predictor + tensor-product interaction, penalized LS.
* ``lasso_importance`` -- cross-validated LASSO (FISTA) on the Eq.-(1)
                        design: the predictor importances of Table 3.

Standardized predictors and log(CR) targets, as in the reference; every
tensor is float32, the precision the reference runs in.  A model lives
on the device of the features it was fit on.

A prediction is the bits of the reference's jitted ``predict`` /
``predict_log`` (the form its use cases call, ``predict_fast``), which
do not depend on the batch.  XLA on the CPU compiles them into fused
loops whose multiply-adds LLVM contracts into FMAs, so each step is
spelled out here as one float32 operation, an FMA where XLA fuses (read
off its optimized IR):

- the standardizer ``(x - mean) / std``, a true division (the model is
  a jit argument, so no reciprocal is folded in);
- a spline column ``d_j = fma(a, a*a, -(b*(b*b))) / (xi_K - xi_j)`` with
  ``a = max(x - xi_j, 0)``, ``b = max(x - xi_K, 0)``, then
  ``N = d_j - d_{K-1}`` and the tensor-product columns as plain
  products;
- the dot as a left-to-right FMA chain, ``acc = c_0``, then
  ``acc = fma(x_j, c_j, acc)``, never ``x @ coef`` (a library mat-vec
  picks its order from the row count);
- ``exp`` as XLA's polynomial (``refmath.exp_f32``).

Every intermediate that can go subnormal is flushed to zero, as XLA's
CPU flushes it (``quant.flush_subnormals``).  A row's prediction is
therefore the same bits alone or in any batch, on the CPU and on the
card.  The fit keeps the reference's eager (unfused) design.

One prediction is a few rows, and spelled out so it is a few hundred
operations, each of which would be a kernel launch on the card.  So it
is first evaluated on the host, in numpy, by a short form
(:class:`_Short`): each FMA one float64 multiply-add rounded once to
float32, nothing flushed.  The float64 sum of a float32 product (exact
in float64) and a float32 is within half a float64 ulp of the exact
value, so its float32 rounding is the FMA's unless that sum is a float32
midpoint.  With no midpoint and no subnormal anywhere, the short form is
the exact form bit for bit; when either shows up, the prediction is
evaluated again by the exact form (:class:`_Exact`: ``fma32`` and the
flushes, in torch on the model's device).  Both run the same
``_log`` of each model.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import refmath as RM
from repro_torch.kernels.quality.ref import fma32
from repro_torch.quant import MIN_NORMAL
from repro_torch.quant import flush_subnormals as _ftz


class Standardizer(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor

    @staticmethod
    def fit(x: torch.Tensor) -> "Standardizer":
        return Standardizer(x.mean(dim=0),
                            torch.clamp(torch.std(x, dim=0, correction=0),
                                        min=1e-8))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _ftz((_ftz(x) - self.mean) / self.std)


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class _Exact:
    """The prediction's float32 steps as XLA's CPU takes them, in torch:
    exactly rounded FMAs (``fma32``) and every subnormal flushed."""

    ftz = staticmethod(_ftz)
    exp = staticmethod(RM.exp_f32)

    @staticmethod
    def fma(a, b, c):
        return _ftz(fma32(a, b, c))

    @staticmethod
    def relu(x):
        return torch.clamp(x, min=0.0) + 0.0     # max(-0, 0) is +0 in XLA

    @staticmethod
    def cat(xs, axis: int):
        return torch.cat(xs, dim=axis)

    @staticmethod
    def dot(cols, coef):
        """``[1, cols] @ coef`` as XLA's fused dot: ``acc = c_0``, then
        ``acc = fma(col_j, c_{j+1}, acc)`` left to right."""
        acc = coef[0] + torch.zeros_like(cols[:, 0])
        for j in range(cols.shape[1]):
            acc = _ftz(fma32(cols[:, j], coef[j + 1], acc))
        return acc


_LOW29 = (1 << 29) - 1         # the float64 mantissa bits below float32's
_HALF29 = 1 << 28


class _Short:
    """The short form (module docstring), in numpy on the host: what
    could make it differ from :class:`_Exact` is recorded, and
    :meth:`exact` says whether anything did."""

    def __init__(self):
        self.sums, self.vals = [], []

    def fma(self, a, b, c):
        s = np.asarray(a, np.float64) * np.asarray(b, np.float64) + \
            np.asarray(c, np.float64)
        r = s.astype(np.float32)
        self.sums.append(s)
        self.vals.append(r)
        return r

    def ftz(self, x):
        self.vals.append(x)
        return x

    @staticmethod
    def relu(x):
        return np.maximum(x, np.float32(0.0))

    @staticmethod
    def cat(xs, axis: int):
        return np.concatenate(xs, axis=axis)

    def dot(self, cols, coef):
        """:meth:`_Exact.dot`, its products taken at once in float64 (each
        is exact there)."""
        prods = cols.astype(np.float64) * coef[1:].astype(np.float64)
        acc = coef[0] + np.zeros(cols.shape[0], np.float32)
        for j in range(cols.shape[1]):
            s = prods[:, j] + acc
            acc = s.astype(np.float32)
            self.sums.append(s)
            self.vals.append(acc)
        return acc

    clip = staticmethod(np.clip)
    floor = staticmethod(np.floor)

    @staticmethod
    def f32(x):
        return np.asarray(x, np.float32)

    @staticmethod
    def pow2(k):
        return ((k.astype(np.int32) + 127) << 23).view(np.float32)

    def exp(self, a):
        """``refmath.exp_f32`` by this form's steps."""
        return RM.exp_f32(a, self)

    def exact(self) -> bool:
        """True when no FMA's float64 sum was a float32 midpoint and no
        value was subnormal."""
        s = np.concatenate([t.reshape(-1) for t in self.sums]).view(np.int64)
        v = np.abs(np.concatenate([t.reshape(-1) for t in self.vals]))
        return not (((s & _LOW29) == _HALF29).any()
                    or ((v < MIN_NORMAL) & (v != 0)).any())


def _predicted(model, features, log: bool) -> torch.Tensor:
    """``model``'s prediction of ``features`` (log CR with ``log``, else
    CR) on the model's device, by the short form on the host or, when
    its check fails, the exact form on the device."""
    params = model._params()
    host = torch.cat([p.reshape(-1) for p in params]).cpu().numpy()
    cut = np.cumsum([p.numel() for p in params])[:-1]
    hp = [h.reshape(p.shape) for h, p in zip(np.split(host, cut), params)]
    if isinstance(features, torch.Tensor):
        x = features.detach().to("cpu", torch.float32).numpy()
    else:
        x = np.asarray(features, np.float32)
    ar = _Short()
    with np.errstate(all="ignore"):      # inf and NaN as the torch form
        out = model._log(x, ar, *hp)
        out = out if log else ar.exp(out)
    dev = model.coef.device
    if ar.exact():
        return torch.from_numpy(np.ascontiguousarray(out)).to(dev)
    out = model._log(_f32(features, dev), _Exact, *params)
    return out if log else _Exact.exp(out)


def _standardized(x, ar, mean, std):
    return ar.ftz((ar.ftz(x) - mean) / std)


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
        return _predicted(self, features, log=False)

    def predict_log(self, features) -> torch.Tensor:
        return _predicted(self, features, log=True)

    def _params(self) -> tuple:
        return self.std.mean, self.std.std, self.coef

    @staticmethod
    def _log(x, ar, mean, std, coef):
        """log CR of (n, 2) features by the arithmetic ``ar``."""
        z = _standardized(x, ar, mean, std)
        return ar.dot(ar.cat([z, ar.ftz(z[:, :1] * z[:, 1:])], 1), coef)


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


def _ncs_columns(z, knots, ar):
    """The non-constant columns of :func:`ncs_basis`, ``[x, N_3, ...]``,
    of both predictors at once, in the jitted reference's float32
    arithmetic (module docstring): (n, 2) standardized predictors x
    (2, K) knots -> (n, 2, K - 1)."""
    k = knots.shape[-1]
    a = ar.ftz(ar.relu(z[:, :, None] - knots))                # (n, 2, K)
    b = a[..., k - 1:]
    b3 = ar.ftz(b * ar.ftz(b * b))
    aj = a[..., :k - 1]
    num = ar.fma(aj, ar.ftz(aj * aj), -b3)
    d = ar.ftz(num / (knots[:, k - 1:] - knots[:, :k - 1]))
    return ar.cat([z[:, :, None], ar.ftz(d[..., :k - 2] - d[..., k - 2:])],
                  2)


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
        return _predicted(self, features, log=False)

    def predict_log(self, features) -> torch.Tensor:
        return _predicted(self, features, log=True)

    def _params(self) -> tuple:
        return (self.std.mean, self.std.std,
                torch.stack([self.knots1, self.knots2]), self.coef)

    @staticmethod
    def _log(x, ar, mean, std, knots, coef):
        """log CR of (n, 2) features by the arithmetic ``ar``."""
        z = _standardized(x, ar, mean, std)
        s = _ncs_columns(z, knots, ar)
        ti = ar.ftz(s[:, 0, :, None] * s[:, 1, None, :]).reshape(
            z.shape[0], -1)
        return ar.dot(ar.cat([s[:, 0], s[:, 1], ti], 1), coef)

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
    """Whole-model evaluation: the reference jits this, and
    ``model.predict`` already gives the jitted form's bits."""
    return model.predict(feats)


MODEL_REGISTRY: dict[str, Callable] = {
    "linear": LinearCRModel.fit,
    "spline": SplineCRModel.fit,
}

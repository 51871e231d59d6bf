"""The servable advisor's shared pieces, without a service.

``slice_digest`` keys the feature cache by content; ``AdviseMethod``'s
static helpers validate an advisor's model set and turn feature rows
into predicted CRs.  The direct ``launch.advise`` path uses them now;
the coalescing sweep service that serves them as methods comes later.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.core import usecases as UC
from repro_torch.core.regression import predict_fast
from repro_torch.data.source import StreamingDigest


def slice_digest(x) -> str:
    """Content hash of an array's float32 bytes and shape (a float64
    array and its float32 round trip share it): the one-chunk case of
    ``data.source.StreamingDigest``, so a digest accumulated from chunked
    reads of a variable equals this one of the whole variable."""
    if hasattr(x, "detach"):                 # a tensor, on any device
        x = x.detach().cpu().numpy()
    return StreamingDigest().update(x).digest()


class AdviseMethod:
    """Static helpers of the reference's ``advise`` method."""

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

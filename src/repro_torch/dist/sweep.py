"""Training-side compressor runs and padded sweep launches.

Single-process forms of the reference's ``dist.sweep``:

* ``training_crs`` -- every (slice, error bound) pair compressed in this
  process (the multi-process partition and its all-gather come with the
  distributed layer);
* ``sweep_padded`` / ``scatter_requests`` / ``gather_rows`` -- one sweep
  launch over a batch padded to a row bucket, and the real rows brought
  back.  Streaming and the sweep service launch every batch through
  ``sweep_padded``.  The reference's ``mesh`` argument comes with the
  distributed layer; its ``donate`` has no meaning here (a caller that
  no longer needs its stack drops the reference).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch


def training_crs(comp, slices, ebs: Sequence[float]) -> np.ndarray:
    """The (k, e) float64 compression-ratio table an ``EbGridModel`` fit
    needs: ``comp.cr(slices[i], ebs[j])`` for every pair.

    The pairs run on a pool of one thread per CPU.  A run's cost is
    mostly its host-side lossless stage, which releases the interpreter
    lock, so the pool overlaps those; each result lands in its own cell,
    so the table is the serial loop's."""
    table = np.zeros((len(slices), len(ebs)), np.float64)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        futures = {(i, j): pool.submit(comp.cr, slices[i], float(eps))
                   for i in range(len(slices)) for j, eps in enumerate(ebs)}
        for (i, j), fut in futures.items():
            table[i, j] = float(fut.result())
    return table


def sweep_padded(slices: torch.Tensor, epss, cfg=None, *,
                 k_pad: Optional[int] = None,
                 mode: str = "features") -> torch.Tensor:
    """One sweep launch over a (k, m, n) or (k, d, m, n) batch padded to
    ``k_pad`` rows with copies of the last row.

    Returns the PADDED (k_pad, e, w) tensor on the batch's device (``w``
    per ``predictors.SWEEP_MODE_WIDTHS[mode]``; ``mode`` is "features",
    "quality" or "both"); rows past ``k`` are the pad's and the caller
    keeps only the real ones (``scatter_requests``, ``gather_rows``).
    Every real row is the bits a launch of that row alone gives: the
    sweep body does not depend on the batch (``predictors``)."""
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
        slices = torch.cat([slices, slices[-1:].expand(
            (k_pad - k,) + tuple(slices.shape[1:]))])
    return P._sweep(slices, epss, cfg, mode)


def gather_rows(out: torch.Tensor) -> np.ndarray:
    """A sweep result (any device) as a float32 numpy array on the host."""
    return out.detach().to("cpu", torch.float32).numpy()


def scatter_requests(out: torch.Tensor, sizes: Sequence[int]) -> list:
    """Split a padded (k_pad, e, w) sweep result into per-request row
    blocks: ``sizes`` are the requests' row counts in stacking order,
    and the trailing pad rows are dropped.  One host transfer for the
    whole batch; returns a list of (sizes[i], e, w) numpy arrays."""
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

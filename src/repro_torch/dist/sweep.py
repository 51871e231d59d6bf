"""Training-side compressor runs.

Only the single-process form of the reference's ``training_crs`` is
ported: every (slice, error bound) pair is compressed in this process.
The multi-process partition and its all-gather come with the
distributed layer.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np


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

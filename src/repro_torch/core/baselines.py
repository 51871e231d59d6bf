"""Prior CR-estimation methods the paper compares against (Table 5).

* ``block_sampling``  -- Tao et al. 2019b / Liang et al. 2019b: compress a
  small sample of blocks and extrapolate the ratio to the full field.
  Systematically *underestimates* CR (block boundaries break the
  decorrelation context and per-block coder overhead is amortized worse).
* ``lu_model``        -- Lu et al. 2018-style white-box SZ model: runs the
  prediction+quantization stage, then estimates the Huffman-coded size from
  a Gaussian fit to the quantization-code distribution (their key modelling
  assumption).  Systematically *overestimates* CR when codes are heavy-
  tailed, the failure mode the paper reports.
* ``optzconfig_probe`` -- Underwood et al. 2022-style black-box surrogate:
  a piecewise-linear model of log CR(log eb) fitted from 2 warm-start probe
  compressions at neighbouring error bounds, evaluated at the target eb.

The compressor runs happen on the data's device (a 2-D slice's Lorenzo
codes through the Lorenzo kernel on the card); the tile draw and the
statistics are numpy on the host, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import compressors as C
from repro_torch.compressors import lossless
from repro_torch.kernels.lorenzo import ops as lorenzo_ops
from repro_torch.kernels.lorenzo.ref import lorenzo_encode


def block_sampling(data: torch.Tensor, eps: float, compressor: str = "sz2",
                   block: int = 32, frac: float = 0.05,
                   seed: int = 0) -> float:
    """Estimate CR by compressing ``frac`` of the ``block x block`` tiles,
    drawn by ``numpy.random.default_rng(seed)`` as in the reference."""
    comp = C.get(compressor)
    m, n = data.shape
    bj = n // block
    total = (m // block) * bj
    k = max(1, int(total * frac))
    idx = np.random.default_rng(seed).choice(total, size=k, replace=False)
    sizes = raw = 0
    for t in idx:
        i, j = divmod(int(t), bj)
        tile = data[i * block:(i + 1) * block, j * block:(j + 1) * block]
        codes, aux = comp.encode(tile, eps)
        sizes += comp.size_bytes(codes, aux, eps)
        raw += tile.numel() * 4
    return raw / max(sizes, 1)


def lu_model(data: torch.Tensor, eps: float) -> float:
    """White-box SZ CR model with the Gaussian-codes assumption."""
    codes = (lorenzo_ops.lorenzo2d(data, eps) if data.ndim == 2
             else lorenzo_encode(data, eps))
    codes = lossless.host(codes).reshape(-1)
    # Gaussian fit to the code distribution (Lu et al.'s assumption)
    sigma = max(codes.std(), 1e-6)
    # entropy of a *discretized gaussian* with that sigma
    h = 0.5 * np.log2(2 * np.pi * np.e * sigma * sigma) if sigma > 0.3 else 1.0
    h = max(h, 0.05)
    est_bytes = codes.size * h / 8.0 + 1024
    return data.numel() * 4 / est_bytes


def optzconfig_probe(train_slice: torch.Tensor, eps: float,
                     compressor: str = "sz2",
                     probe_ratio: float = 4.0) -> float:
    """Warm-start piecewise-linear surrogate (Underwood et al. 2022).

    The surrogate is built from probe compressions of *previously seen*
    data of the same field (warm start) -- CR(log eb) on the training
    slice, log-interpolated at the target eb -- then applied to the new
    slice without running the compressor on it."""
    comp = C.get(compressor)
    lo, hi = eps / probe_ratio, eps * probe_ratio
    cr_lo = comp.cr(train_slice, lo)
    cr_hi = comp.cr(train_slice, hi)
    t = (np.log(eps) - np.log(lo)) / (np.log(hi) - np.log(lo))
    return float(np.exp((1 - t) * np.log(cr_lo) + t * np.log(cr_hi)))

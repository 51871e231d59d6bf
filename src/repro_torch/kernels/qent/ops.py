"""Public wrappers for the q-ent kernel (``csrc/qent.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain
version in ``ref``.  The kernel masks each cluster's element range, so
unlike the TPU route there is no padding and no pad correction: the
histogram is the same either way.  The shared memory one CTA may spend
on counters is the card's (``kernels.tune.smem_budget``: 196 608 bytes
on an H100, where 65536 bins need a cluster of 2 CTAs of 128 KiB each
and 4096 bins x 6 eps fit one CTA of 96 KiB).
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import tune as _tune
from repro_torch.kernels.qent import ref as _ref
from repro_torch.quant import validate_eps_positive as _check_eps

DEFAULT_BINS = 4096


def launch(x: torch.Tensor, epss: torch.Tensor, bins: int,
           defines: tuple = ()) -> torch.Tensor:
    """The kernel's launch on a contiguous (k, n) CUDA stack, from the
    plain build of ``csrc/qent.cu`` or, with ``defines``, from a variant
    (the offline search's candidates, ``kernels/tune.py``)."""
    _build.require_cuda(x, "qent_histogram_sweep")
    _build.require_cuda(epss, "qent_histogram_sweep eps")
    k, n = x.shape
    e = epss.shape[0]
    if not 0 < bins < 2 ** 31:
        raise ValueError(f"qent_histogram_sweep: unsupported k={k}, e={e}, "
                         f"bins={bins}")
    hist = torch.zeros((k, e, bins), dtype=torch.int32, device=x.device)
    budget = _tune.smem_budget(_tune.backend_kind(x.device))
    fn = _build.load("qent", defines).repro_qent_hist
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        code = fn(_build.ptr(x), _build.ptr(epss), _build.ptr(hist), k, n, e,
                  bins, budget, _build.stream(x))
    _build.check(code, "qent_histogram_sweep")
    _build.count(qent_histogram_sweep, (k, n, e, bins))
    return hist


def qent_histogram_sweep(x: torch.Tensor, epss: torch.Tensor,
                         bins: int = DEFAULT_BINS) -> torch.Tensor:
    """(k, n) slice stack x (e,) error bounds -> (k, e, bins) int32
    histograms of the hashed codes in one launch, each element quantized
    once per eps."""
    if x.ndim != 2:
        raise ValueError(f"qent_histogram_sweep expects (k, n), got "
                         f"{tuple(x.shape)}")
    x = x.to(torch.float32)
    epss = epss.to(device=x.device, dtype=torch.float32).reshape(-1)
    if x.device.type == "cpu":
        return _ref.qent_histogram_sweep(x, epss, bins)
    return launch(x.contiguous(), epss.contiguous(), bins)


qent_histogram_sweep.launches = 0
qent_histogram_sweep.by_shape = Counter()     # (k, n, e, bins) -> launches


def quantized_entropy_sweep(x: torch.Tensor, epss,
                            num_bins: int = DEFAULT_BINS) -> torch.Tensor:
    """Entropies (k, e) for a (k, ...) stack (trailing dims flattened per
    slice) at an (e,) vector of error bounds."""
    _check_eps(epss)
    k = x.shape[0]
    flat = x.reshape(k, -1).to(torch.float32)
    epss = torch.as_tensor(epss, dtype=torch.float32).reshape(-1)
    return _ref.entropy_bits_rows(qent_histogram_sweep(flat, epss, num_bins))


def quantized_entropy(x: torch.Tensor, eps,
                      num_bins: int = DEFAULT_BINS) -> torch.Tensor:
    """Entropy of one slice at one eps: the (k=1, e=1) case of the sweep."""
    return quantized_entropy_sweep(x.reshape(1, -1), [float(eps)],
                                   num_bins)[0, 0]

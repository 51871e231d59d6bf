"""The backends' hardware, and an offline search of the q-ent kernel's
launch shape.

The port of ``repro.kernels.tune``'s hardware table and search, over
torch and the card.  The reference also puts its search's winners on
the launch path (a ``TuneConfig`` on ``PredictorConfig``, a table per
backend, *kwarg > config > table > default*).  The port does not: on
the H100 no candidate beat the kernels' defaults by more than the
hysteresis at any shape the port launches (``PERF.md``), so the launch
shapes stay compile-time constants -- ``csrc/gram.cu``'s 128 x 128
output tile and 32-deep stage, ``csrc/qent.cu``'s 16384 elements a CTA.
A tunable and a table join the launch path only when a candidate wins
at a launched shape.

What the launch path reads from here is the card's hardware:
:func:`smem_budget` is the shared memory one q-ent CTA may spend on
counters (196 608 bytes on an H100).

The search times ``csrc/qent.cu``'s least elements a CTA (4096 to
65536): each candidate is a build of its own
(``-DREPRO_QENT_MIN_PER_CTA=<tile>``, ``kernels/_build.py``), launched
through ``kernels.qent.ops.launch`` on one cell per distinct key of the
shapes the port's paths launch, and timed by CUDA events (the median of
N, warm-up excluded; a cell whose input fits the card's L2 cold, with
the L2 overwritten before each of five times the calls, as its callers
find it and as ``PERF.md`` times such launches).  Two rules shape it:

* **Bit filter.**  A candidate is discarded unless its histograms are
  ``torch.equal`` to the default's: a tunable is admitted only if it
  leaves the bits alone (histograms are integer counts, so every tile
  passes).
* **Hysteresis.**  A winner must beat the default's median by more than
  2 % or the cell records the default.

The Gram kernel has no candidate: its stage depth sets the float32
summation order (each 32-deep stage is summed into a fresh partial),
so another depth would change the bits, and its output tile is fixed
at 128 (a 64 tile lost at every launched shape).

    python -m repro_torch.kernels.tune [--smoke] [--iters N]
        [--warmup N] [--device cuda] [--out report.json]

writes a report: each cell's default, candidates' and chosen times, the
card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import time
from typing import Any, Dict, Optional

import torch

SCHEMA_VERSION = 1

# Per-backend hardware: float32 peak outside the tensor cores, memory
# rate, the opt-in shared memory of one CTA and the L2.  h100: the SXM
# part's data sheet at 700 W (the figures chip_smoke.py's bounds use).
# The plain versions on the CPU hold no shared memory.  Unknown cards:
# the H100 PCIe's lower rates (report-only), and the shared memory and
# L2 of every card the sm_90a build runs on (H100, H200, GH200), so an
# unknown Hopper launches exactly as an H100.
BACKEND_HW: Dict[str, Dict[str, float]] = {
    "h100":    {"peak_flops": 67e12, "mem_bw": 3.35e12,
                "smem_bytes": 232448, "l2_bytes": 50e6},
    "cpu":     {"peak_flops": 5e11, "mem_bw": 20e9, "smem_bytes": 0,
                "l2_bytes": 0},
    "default": {"peak_flops": 51e12, "mem_bw": 2.0e12,
                "smem_bytes": 232448, "l2_bytes": 50e6},
}

# device names (lower case, spaces -> "-") -> backend keys
_ALIASES = {"nvidia-h100-80gb-hbm3": "h100", "nvidia-h100-sxm5-80gb": "h100",
            "nvidia-h100": "h100"}


def normalize_kind(name: str) -> str:
    """Backend key of a device name: lower case, spaces -> ``-``, then
    the alias map ("NVIDIA H100 80GB HBM3" -> ``h100``)."""
    kind = name.strip().lower().replace(" ", "-")
    return _ALIASES.get(kind, kind)


@functools.lru_cache(maxsize=None)
def _cuda_kind(index: int) -> str:
    return normalize_kind(torch.cuda.get_device_name(index))


def backend_kind(device=None) -> str:
    """Stable backend key of a device: ``cpu`` for the CPU (CUDA is not
    touched), the normalized card name for a CUDA device (``h100``).
    ``None``: the current card when CUDA is available, else ``cpu``."""
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return _cuda_kind(device.index if device.index is not None
                      else torch.cuda.current_device())


def hw_for(kind: Optional[str] = None) -> Dict[str, float]:
    """Hardware entry for a backend kind (prefix-matched, with a
    conservative ``default`` fallback)."""
    kind = _ALIASES.get(kind or "", kind) or backend_kind()
    if kind in BACKEND_HW:
        return BACKEND_HW[kind]
    for key in BACKEND_HW:
        if key != "default" and kind.startswith(key):
            return BACKEND_HW[key]
    return BACKEND_HW["default"]


@functools.lru_cache(maxsize=None)
def smem_budget(kind: str) -> int:
    """Shared memory (bytes) one q-ent CTA may spend on its counters: the
    whole 64 KiB units of the card's per-CTA opt-in shared memory (on an
    H100, 3 x 64 KiB = 196 608 of 232 448 bytes; a cluster CTA's two
    outboxes take from the rest, ``csrc/qent.cu``)."""
    return int(hw_for(kind)["smem_bytes"]) // 65536 * 65536


def _bucket_p2(x: int) -> int:
    """Size bucket: next power of two (cells generalize across the
    ragged shapes the service actually pads to)."""
    p = 1
    while p < x:
        p *= 2
    return p


def qent_key(k: int, n: int, bins: int, e: int) -> str:
    """A q-ent cell: batch (the grid's fill depends on it), slice length
    and eb-count buckets, bins."""
    return (f"qent:f32:k{_bucket_p2(k)}:n{_bucket_p2(n)}:b{bins}"
            f":e{_bucket_p2(e)}")


# ---------------------------------------------------------------------------
# Timing + search


COLD_ITERS_FACTOR = 5       # a cold cell takes this many times the calls
SPIN_CYCLES = 10_000_000    # ~5 ms at the H100's 1.98 GHz boost clock


def time_fn(fn, *args, warmup: int = 1, iters: int = 5, device="cpu",
            cold: bool = False, **kwargs) -> float:
    """Median seconds of ``fn(*args)`` over ``iters`` calls, after
    ``warmup`` calls.  On a CUDA device each call is timed by CUDA events
    (``cold``: the 50 MB L2 overwritten and a ~5 ms spin queued before
    each call, so the host's launch cost is not counted, as
    ``chip_smoke.cold_cuda_ms`` times a microsecond launch); on the CPU
    by the wall clock."""
    device = torch.device(device)
    for _ in range(max(1, warmup)):
        fn(*args, **kwargs)
    if device.type != "cuda":
        ts = []
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            ts.append(time.perf_counter() - t0)
    else:
        scratch = (torch.empty(64 * 2 ** 20, dtype=torch.int32, device=device)
                   if cold else None)
        events = []
        for _ in range(max(1, iters)):
            if cold:
                scratch.zero_()
                torch.cuda._sleep(SPIN_CYCLES)
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            fn(*args, **kwargs)
            pair[1].record()
            events.append(pair)
        torch.cuda.synchronize(device)
        ts = [a.elapsed_time(b) * 1e-3 for a, b in events]
    ts.sort()
    return ts[len(ts) // 2]


# a candidate must beat the default median by >2% to be chosen
HYSTERESIS = 0.02

DEFAULT_TILE = 16384        # csrc/qent.cu's MIN_PER_CTA
QENT_TILE_CANDIDATES = (4096, 8192, 16384, 32768, 65536)


def tile_defines(tile: int) -> tuple:
    """The ``-D`` defines of ``csrc/qent.cu``'s build at ``tile``
    elements a CTA: none for the default, the plain build."""
    return () if tile == DEFAULT_TILE else (f"REPRO_QENT_MIN_PER_CTA={tile}",)


def qent_variants() -> list:
    """``(name, defines)`` of every candidate build but the plain one
    (``kernels._build.build(variants=...)`` compiles them together)."""
    return [("qent", tile_defines(t)) for t in QENT_TILE_CANDIDATES
            if t != DEFAULT_TILE]


def _randn(shape, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


def _timer(device, warmup: int, iters: int, nbytes: int) -> tuple:
    """(timer, cold) of a cell whose input is ``nbytes``: warm CUDA
    events, or cold with ``COLD_ITERS_FACTOR`` times the calls when the
    input fits the card's L2 (a warm loop would read it from the L2,
    where its callers find it in device memory)."""
    device = torch.device(device)
    cold = (device.type == "cuda"
            and nbytes <= hw_for(backend_kind(device))["l2_bytes"])
    n = iters * COLD_ITERS_FACTOR if cold else iters
    return (lambda fn, *a: time_fn(fn, *a, warmup=warmup, iters=n,
                                   device=device, cold=cold)), cold


def _search(default, candidates, run, timer) -> tuple:
    """(best, t_default, t_best, discarded, times): every candidate's
    output held to the default's bits, then the fastest, kept only if it
    beats the default by more than ``HYSTERESIS``."""
    ref = run(default)
    t_def = timer(run, default)
    best, t_best, discarded = default, t_def, []
    times = {str(default): t_def}
    for cand in candidates:
        if cand == default:
            continue
        if not torch.equal(run(cand), ref):
            discarded.append(cand)                # bit filter
            continue
        t = times[str(cand)] = timer(run, cand)
        if t < t_best:
            best, t_best = cand, t
    if best != default and t_best > t_def * (1 - HYSTERESIS):
        best, t_best = default, t_def
    return best, t_def, t_best, discarded, times


def search_qent_cell(k: int, n: int, bins: int, e: int, *, warmup: int = 1,
                     iters: int = 5, device="cuda", run=None,
                     timer=None) -> Dict[str, Any]:
    """Search one q-ent cell: the histogram sweep of a (k, n) stack at
    ``e`` ebs, each candidate from its own build through
    ``kernels.qent.ops.launch`` (on the CPU the plain version, which has
    no tile); the filter compares the histograms.  ``run(tile)`` and
    ``timer(fn, tile) -> s`` replace the launch and the clock (tests)."""
    from repro_torch.kernels.qent import ops as qent_ops
    cold = False
    if run is None:
        x = _randn((k, n), 1, device)
        epss = torch.logspace(-3, -1, e, device=device, dtype=torch.float32)
        if x.device.type == "cuda":
            def run(tile):
                return qent_ops.launch(x, epss, bins, tile_defines(tile))
        else:
            def run(tile):
                return qent_ops.qent_histogram_sweep(x, epss, bins)
    if timer is None:
        timer, cold = _timer(device, warmup, iters, 4 * k * n)
    cands = [t for t in QENT_TILE_CANDIDATES if t <= _bucket_p2(n)]
    best, t_def, t_best, discarded, times = _search(DEFAULT_TILE, cands, run,
                                                    timer)
    return {"tile": best, "t_default": t_def, "t_tuned": t_best,
            "speedup": t_def / t_best, "shape": [k, n, bins, e],
            "cold": cold, "times": times, "discarded_bit_unsafe": discarded}


# (k, n, bins, e) q-ent cells: one per distinct key among the shapes the
# port's paths launch at the sweeps' 65536 bins, each the shape of its
# key with the most launches (PERF.md's kernel table): the training
# sweep, one slice at 6 ebs and at 1, Serve's pair at 8, Stream's 41,
# Table 4's volumes.
FULL_QENT_CELLS = ((32, 3240000, 65536, 6), (1, 3240000, 65536, 6),
                   (1, 3240000, 65536, 1), (2, 3240000, 65536, 8),
                   (41, 3240000, 65536, 6), (12, 37748736, 65536, 1))
SMOKE_QENT_CELLS = ((2, 1 << 20, 65536, 2),)


def nvidia_smi_line() -> Optional[str]:
    """The card's ``nvidia-smi`` name and power limit, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def run_search(*, smoke: bool = False, warmup: int = 1, iters: int = 5,
               device="cuda") -> Dict[str, Any]:
    """Every cell of the full (or smoke) grid searched on ``device``; the
    candidate builds are compiled first, all at once."""
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        from repro_torch.kernels import _build
        _build.build(["qent"], qent_variants())
    cells = {qent_key(k, n, bins, e): search_qent_cell(
                 k, n, bins, e, warmup=warmup, iters=iters, device=device)
             for k, n, bins, e in (SMOKE_QENT_CELLS if smoke
                                   else FULL_QENT_CELLS)}
    return {"schema_version": SCHEMA_VERSION,
            "backend": backend_kind(device),
            "card": nvidia_smi_line() if is_cuda else None,
            "torch": torch.__version__, "iters": iters, "warmup": warmup,
            "cells": cells}


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(
        description="Offline search of the q-ent kernel's launch shape")
    p.add_argument("--smoke", action="store_true",
                   help="one small cell")
    p.add_argument("--out", default=None,
                   help="also write the report as JSON here")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="device to search on (default: cuda)")
    args = p.parse_args(argv)
    report = run_search(smoke=args.smoke, warmup=args.warmup,
                        iters=args.iters, device=args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
    for key, cell in report["cells"].items():
        print(f"{key:40s} -> {cell}")
    print(f"card: {report['card']}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each of which raises on failure (nothing falls back to the CPU):

1. device  -- the ``nvidia-smi`` name and power limit every time below
              belongs to;
2. build   -- ``nvcc`` for every kernel of ``repro_torch/csrc``, in parallel;
3. kernels -- each CUDA kernel against its plain PyTorch version on the
              card, at the main path's shapes: gram within rtol 2e-5 /
              atol 2e-3 and the same bits on two launches; q-ent
              histograms, the quality SSE and tensor, the Lorenzo codes
              and the ZFP coefficients and exponents bit-equal (Lorenzo
              and ZFP on every held-out slice, ZFP also on block maxima
              planted at and next to powers of two, Lorenzo also on
              ragged shapes); gram, q-ent and quality at each shape the
              main path launches them with (the 32-slice training sweep,
              one held-out slice) and at 8 slices, and on their other
              branches (a volume unfolding's X X^T, ragged edges, a hot
              bin, one eps, bins 3000 and 4096; quality at k = 1, at
              lengths off the 2048-element tile, on unaligned slices and
              at 11 eps); CUDA-event times of kernel, plain version and,
              where one call computes the same function, the library;
              ZFP's rows also the copy floor (``copy_ms``: a cold copy
              of the slice's bytes into a second buffer, the faster of
              ``copy_`` and ``torch.neg(x, out=...)``);
4. small   -- the sweep on a small input on the card against the same
              call on the CPU, under the default config (exact sort
              q-ent) and ``use_kernels=True`` (hashed q-ent kernel); at
              full size, the kernel q-ent route against the exact
              entropy (the sort route in float64) within 1e-5 at the ebs
              whose code range fits the bins, reporting how far the sort
              route (the reference's float32 bits) lies from the exact
              entropy; then (4c) the training
              sweep on the sort route, its time and peak device memory
              with the reference's float32 q-ent and with the float64
              form it replaced, in turns;
5. main    -- the paper's path on ``cesm-cloud`` at its Table-1 edge
              (40 slices of 1800 x 1800 float32 made on the card): one
              ``EbGridModel.train`` (``use_kernels=True``) for each of the
              8 compressors of ``STUDY_2D`` on 32 slices over a 6-point
              eb grid, then UC1 (sz3-lorenzo), UC2 over the 8 models and
              UC3 over the 8 on the 8 held-out slices; every kernel's
              launch counter must be above 0, and gram's, q-ent's and
              quality's are also read by shape, one per timed row;
6. held-out MedAPE of predicted against measured CRs, per compressor,
   and UC2 agreement with the measured best of 8;
7. bits      -- sz2's and sz3-regression's codes on the card against their
              CPU route on a held-out slice (bit-equal), and a slice with
              planted subnormals: the entry points read them as zeros, as
              XLA on the CPU does, and every kernel equals its plain
              version on the card and on the CPU (given the slice as the
              entry points flush it; Lorenzo, which needs no flush, the
              raw slice);
8. Table 5   -- the prior methods (block sampling, Lu et al.'s model,
              OptZConfig's warm-start probe) against our k-fold spline
              on the 40 cesm-cloud slices at their eps (sz2), MedAPE each;
9. Table 3   -- LASSO importances of [q-ent, svd/sigma, interaction] on
              those 40 and on 24 scale-pressure slices at 1200 x 1200;
10. Fig 5    -- Gaussian fields of types 1-4, 20 samples each at 1028 x
              1028, eps 1e-3: k-fold MedAPE for sz2, zfp, mgard,
              digitrounding and bitgrooming;
11. Table 4  -- 12 miranda-vx volumes at 256 x 384 x 384: one rank-4
              sweep on the q-ent kernel route (checked against the sort
              route), the five STUDY_3D CRs per volume, k-fold MedAPE per
              compressor, TTHRESH's RMSE against its eps;
12. study kernels -- the kernels at every new shape phases 8-11 launched
              them with, against their plain versions, timed;
13. batch independence -- ``features_sweep`` (features and quality,
              both q-ent routes) of a few slices alone, bit-equal to the
              same slices inside their batch and inside a
              ``sweep_padded`` bucket, at 1800^2 (4 of the 40), 1200^2 (3
              of the 24), 1028^2 (3 of a Gaussian 20) and 256 x 384 x
              384 (2 of the 12 volumes); the Gram alone equal to the Gram
              in its batch at each shape (volumes: both unfoldings); and,
              reported only, which library reductions the sweep used to
              run over the batch (std, mean, eigvalsh, cumsum, a float64
              sum, the entropy sum) give a row other bits in the batch.
              Then the eb grid: each of 4 slices at 1800^2 and 2 volumes
              at each eb of a 6-eb grid, features under both q-ent routes
              and quality, bit-equal swept at that eb alone, in the grid,
              in an 8-eb bucket padded with its last eb and in a 12-eb
              union; the sort route's q-ent of those rows at the grid
              the same bits on the card as on the CPU; reported only,
              how many values the kernel route's entropy sum gave other
              bits in its old form (a library sum over a row's (e, bins)
              terms).  Then predictions: the same bits on the card as on
              the CPU for a spline and a linear model (400 rows alone, in
              7s and at once, ``predict`` and ``predict_log``, and the
              exact form the checked host form falls back to), phase 5's
              48 models on 400 rows, ``EbGridModel.predict`` and
              ``predict_psnr`` at 9 ebs and the UC1, UC2 and UC3 answers
              on the 8 held-out slices;
15. serve    -- (run after 13, before 14 frees phase 5's models)
              ``SweepService`` on the card: 8 client threads x 64
              requests of its seven methods (featurize on the 6-eb grid
              and on a 3-eb subgrid with one eb off it, find_eb with
              sz3-lorenzo at targets 4, 8, 16, best_compressor over the
              8 models at the grid's third eb, advise over the 8,
              find_setting at PSNR >= 60 dB and CR >= 8, quality on the
              grid, kv_gate on 16 leaves of 4 M float32 values, 4 of
              them repeated) over 4 hot held-out slices and the other 4
              once each, once under the default config and once under
              ``use_kernels=True``; a second pass over the hot rows and
              the leaves launches nothing; every served result is
              bit-equal to the port's direct
              call on the card; wall time, requests/s, latency by
              method, launches, padded and deduplicated rows, cache
              hits, the window, the model predictions made and the
              post-processing seconds by method; before it, on the idle
              card, the host time of one prediction (the reference's
              jitted bits beside the library mat-vec) and of one advise
              request's 8 x 6 predictions;
14. stream   -- the port's ``write_dataset`` writes a memmap dataset
              under ``build/`` (removed at the end, pass or fail): 96
              cesm-cloud slices of 1800^2 as float64 and 7 miranda-vx
              volumes of 256 x 384 x 384 as float32.  ``stream_features``
              at a 512 MiB budget (chunks 41 + 41 + 14 and 3 + 3 + 1):
              the slices with quality under the default config at
              prefetch 2, 0, 0 and 2 (timed in turns) and under
              ``use_kernels=True``, the volumes under the default config,
              each bit-equal to one in-memory sweep of the variable on
              the card, the streaming digest (the last two streams hash
              their chunks) equal to ``slice_digest``; wall time, rows/s, GB/s
              read and peak device memory beside the in-memory sweep's.
              Gram, q-ent and quality at the shapes the streams launched
              them with (a chunk of 41 slices, one of 3 volumes, read
              from the dataset), against their plain versions and timed,
              as in phase 12.  Then the advise CLI on the dataset
              (trained on 4 rows of each variable) in a
              subprocess (its ``main``, as ``python -m
              repro_torch.launch.advise`` runs it, with the launches of
              each variable's training and stream counted around the two
              calls): a finite report, launches of Lorenzo and ZFP in its
              training and of Gram, q-ent and quality in its stream, and
              the 2-D variable's CRs equal to ``AdviseMethod.cr_table`` on
              the in-memory features.  The same CLI with ``--service``
              (every chunk through an in-process ``SweepService``,
              counted the same way) gives the same report.  The tensors
              of phases 1-13 and 15 are freed before it.
16. serve CLI -- ``python -m repro_torch.launch.sweep_serve`` in a
              subprocess (cesm-cloud at 1800^2, zfp trained on 10
              slices, 8 clients x 8 UC1/UC2 requests): a finite report,
              ZFP launched in its training and Gram in its serving, its
              launches by shape read from its report;
17. dist     -- the sharded sweep layer (``repro_torch.dist``) on the
              card, on the training sweep (32 cesm-cloud slices of
              1800^2, the 6-eb grid, ``use_kernels=True``, features and
              quality) in three forms: (a) this process, a mesh of two
              shards on the card, timed beside one device in turns; (b)
              a one-rank NCCL group whose mesh has two shards on the
              card (NCCL refuses two ranks on one GPU); (c) a two-rank
              gloo group, one shard each on the card, SPMD and
              process-local, also on 7 miranda-vx volumes (blocks of 4
              rows, and of 3 + 1 pad) and a 2-slice batch (one-row
              blocks), ``training_crs`` of sz3-lorenzo and zfp split
              between the ranks, and phase 14's two streams under the
              group.  (b) and (c) run in fresh interpreters (``--dist-child``),
              each group under its own wall-clock limit.  Then the advise
              CLI with ``--mesh cuda:0,cuda:0`` in one process and over a
              two-rank gloo group (``--coordinator``).  Every result is bit-equal
              to one device (the tables to the main path's, the streams
              to phase 14's in-memory sweeps, the reports byte for byte
              to phase 14's direct report);
18. fabric   -- (run right after 15, on its models, plan cut to 8
              clients x 16 requests, and direct calls) the service on a
              mesh and across processes, on the kernel route: (a)
              ``SweepService(mesh=...)`` over two shards of the card in
              this process, the plan and its cached second pass; (b) a two-rank gloo group in fresh
              interpreters (``--fabric-child``), both shards on the card,
              a leader serving the plan and a follower joining every
              launch; (c) ``sweep_serve --mesh auto --coordinator ...`` in
              two processes (zfp on 6 slices, 4 clients x 16 requests,
              ``--verify``).  Every served result is bit-equal to the
              direct call; req/s, launches, and the kernels' launches by
              shape as the "Fabric" path;
19. fault    -- (run right after 18, on its models, plan and direct
              calls) the service survives a lost process, on the kernel
              route, gloo ranks with one shard each on the card and the
              group's store served by rank 0 (``--fault-child``): (a) 3
              ranks, rank 2 SIGKILLed inside its first launch after 16
              requests were served (``dist.faultinject``), the leader
              recovering onto [0, 1] and serving through the store; (b)
              2 ranks, the follower hanging inside its first launch
              after 16 requests and evicted by the leader's
              deadline, 8 s once warm; both serve phase 15's plan cut to
              8 clients x 16 requests, every result bit-equal to the
              direct call, and log detection and recovery s, req/s before
              and after the fault and the bytes through the store;
              (c) ``sweep_serve --coordinator-only`` and two
              ``--external-coordinator`` ranks, the leader SIGKILLed in
              its sixth launch (``--chaos``): the follower exits 0 with
              ``leader_lost`` within 30 s of the leader's death.
              Launches by shape as the "Fault" path;
20. path rows -- every kernel at every shape a path below launched it
              with that no row above holds (Serve's batches and warmup,
              the advise runs' training and padded service chunks, the
              load CLI, the Dist path's blocks), against its plain
              version and timed, on fresh cesm-cloud slices and
              miranda-vx volumes.
Phases 5, 8-11, 14, 15, 17 and 18 (their form (a)) each set the
kernels' launch counters to 0 just before they run and read them just
after, and the subprocesses (advise, advise ``--service``, the load
CLI, the process groups and advise runs of phase 17, phase 18's group
and CLI, phase 19's groups) count theirs by shape around their work;
phase 17's are summed into one path, "Dist", phase 18's into "Fabric"
and phase 19's into "Fault".  A
kernel a path needs that it did not launch fails the run.  A kernel
row's ``launches`` is the count of the first of these paths that
launched its shape (the main path where it did), and
``launches_by_path`` gives each path's own count.

``--profile`` traces the main path and one stream of phase 14 with
``torch.profiler`` (a separate run: tracing slows the host side) and
reports the device's busy time.

The last two lines of standard output are the card's ``nvidia-smi`` line
and ``{"ok": true, "device": {...}}``; the line before them is the
per-kernel JSON record.  The stages line gives the script's own time
(``script_s``).
"""
from __future__ import annotations

import argparse
import contextlib
import faulthandler
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FIELD = "cesm-cloud"
N_TRAIN, N_TEST = 32, 8
# the studies after the main path (counts may be cut, widths never)
SCALE_FIELD, N_SCALE = "scale-pressure", 24        # Table 3, at full_n
GAUSS_N, N_GAUSS, GAUSS_EPS = 1028, 20, 1e-3        # Fig 5, the paper's size
GAUSS_COMPRESSORS = ["sz2", "zfp", "mgard", "digitrounding", "bitgrooming"]
VOL_FIELD, N_VOL, VOL_SHAPE = "miranda-vx", 12, (256, 384, 384)   # Table 4
VOL_EB_REL = 1e-2
# phase 14: a dataset on disk streamed within a chunk budget
STREAM_FIELD, N_STREAM, STREAM_N = "cesm-cloud", 96, 1800   # float64 on disk
N_STREAM_VOL = 7                                # miranda-vx, float32 on disk
STREAM_BUDGET_MB = 512
ADVISE_TIMEOUT_S = 600
ADVISE_TRAIN_ROWS = 4           # rows of each variable the advise runs train on
# phase 15: the sweep service, 8 clients x 64 requests of the seven
# methods (featurize on the grid and on a 3-eb subgrid with one eb off
# it), 4 hot held-out slices and the other 4 once each
SEED = 0
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_HOT = 8, 64, 4
SERVE_KINDS = ("featurize", "featurize_sub", "find_eb", "best_compressor",
               "advise", "find_setting", "quality", "kv_gate")
SERVE_COLD_KINDS = ("featurize", "find_eb", "best_compressor", "quality")
SERVE_TARGETS = (4.0, 8.0, 16.0)
SERVE_CR_FLOOR, SERVE_PSNR_FLOOR = 8.0, 60.0
SERVE_CACHE_BYTES = 64 << 20     # the 4 MiB default raised for the hot rows
KV_LEAVES, KV_REPEATS, KV_LEAF_N = 16, 4, 4 << 20
# phase 16: the load CLI at the main path's width
SERVE_CLI_N = 1800
SERVE_CLI_TIMEOUT_S = 600
# phase 17: the sharded sweep layer, in one process and in process groups
# on the one card (NCCL refuses two ranks on one GPU, so the two-rank
# group is gloo and the NCCL group has one rank)
DIST_DEVICE = "cuda:0"
DIST_NCCL = "nccl"
N_DIST_VOL = 7                  # 2 ranks: blocks of 4 rows, and 3 + 1 pad
DIST_CRS = ("sz3-lorenzo", "zfp")
DIST_TIMEOUT_S = 400            # each group's wall-clock limit
DIST_COLLECTIVE_TIMEOUT_S = 300 # a group's init and each of its collectives
# phase 18: the service on a mesh and across processes
FABRIC_TIMEOUT_S = 400          # (b)'s group's wall-clock limit
FABRIC_REQUESTS = 16            # phase 15's plan cut to 8 clients x 16
# phase 19: the service survives a lost process
FAULT_TIMEOUT_S = 240           # (a)'s and (b)'s groups' wall-clock limit
FAULT_REQUESTS = 16             # the plan cut to 8 clients x 16 requests
FAULT_ARM_REQUESTS = 16         # requests served before a follower's fault
FAULT_ARM_KEY = "chip_smoke/fault/arm"   # the leader's signal to arm it
FAULT_HANG_TIMEOUT_S = 8.0      # (b)'s launch deadline once warm
FAULT_LEADER_KILL = 6           # (c): 4 warmup launches, then the second
LEADER_LOST_BOUND_S = 30.0      # (c): the follower's exit after the leader's
PLANT_EBS = (1e-5, 1e-3, 256.0)     # 256: quotients of tiny normals underflow
QENT_BINS = 65536
# H100 SXM data-sheet peaks (dense, no sparsity), at the 700 W limit
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SPIN_CYCLES = 10_000_000    # ~5 ms at the H100's 1.98 GHz boost clock
QUOTIENT_SPREAD = 52        # divisors beside the grid's in the quotient check
# the advise CLI's main in a child process, with the kernel launches of
# each variable's training and sweep (streamed, or served with
# --service) counted around the calls, in all and by shape, and written
# as JSON to argv[1]; the rest of argv is the CLI's
ADVISE_CHILD = """
import json, sys
from repro_torch import kernels as K
from repro_torch.launch import advise as ADV
trained, out = {}, {}
def train(source, name, *args, _train=ADV.train_models, **kwargs):
    res = _train(source, name, *args, **kwargs)
    trained[name] = K.launch_counts()
    return res
def variable(source, name, *args, _variable=ADV.advise_variable, **kwargs):
    before = K.launch_counts()
    res = _variable(source, name, *args, **kwargs)
    (t, ts), (s, ss) = (K.launches_since(before, trained[name]),
                        K.launches_since(trained[name]))
    out[name] = {"train": t, "sweep": s, "by_shape": {"train": ts, "sweep": ss}}
    return res
ADV.train_models, ADV.advise_variable = train, variable
ADV.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def log(msg: str, card: str | None = None) -> None:
    """Print a line; a line with times names the card they were taken on."""
    print(msg if card is None else f"{msg} [{card}]", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds per call by CUDA events around each call, with
    the 50 MB L2 overwritten before it: an input that fits L2 (one
    1800 x 1800 slice) is timed as its caller finds it, cold.  A spin
    kernel of ~5 ms sits between the flush and the start event, so the
    host has queued the call's kernels before the start event fires and
    its own time per call (the wrapper, the launch) is not counted.  The
    median, since single launches of a few tens of microseconds are
    noisy."""
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    fn()
    events = []
    for _ in range(reps):
        scratch.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        fn()
        pair[1].record()
        events.append(pair)
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes at the memory rate or
    float32 operations at the FP32 peak, whichever is larger."""
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def gram_row(torch, x, reps, cold=False, transpose=True, scaled=False):
    """gram_batched on a (k, m, n) stack as its callers hand it (mean-
    corrected slices, X^T X; a volume's mode unfoldings, X X^T): within
    rtol 2e-5 / atol 2e-3 of the float64 plain version, the same bits on
    two launches, timed beside the library product (``torch.bmm``,
    ``torch.mm`` at k = 1), whose own max abs error against the plain
    version is logged beside the kernel's.  ``scaled``: an entry's rtol is taken of its
    Cauchy-Schwarz scale sqrt(G_ii G_jj), the size of the terms it sums,
    not of itself: a mean-corrected unfolding of 147 456 columns leaves
    off-diagonal entries that cancel to near 0 with a float32 rounding
    error of that scale, in any order of the sums."""
    from repro_torch.kernels.gram import ops as gram_ops, ref as gram_ref
    k, m, n = x.shape
    got = gram_ops.gram_batched(x, transpose)
    again = gram_ops.gram_batched(x, transpose)
    want = (gram_ref.gram_xtx_batched(x) if transpose
            else gram_ref.gram_xxt_batched(x))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ref = want.abs()
    if scaled:
        d = torch.diagonal(want, dim1=1, dim2=2).clamp(min=0).sqrt()
        ref = d[:, :, None] * d[:, None, :]
    if not bool(((got - want).abs() <= 2e-3 + 2e-5 * ref).all()):
        raise AssertionError(f"gram kernel disagrees at {(k, m, n)} "
                             f"transpose={transpose}: max abs err {err}")
    if not torch.equal(got, again):
        raise AssertionError(f"gram kernel bits differ between launches "
                             f"at {(k, m, n)} transpose={transpose}")
    xt = x.transpose(1, 2)
    a, b = (xt, x) if transpose else (x, xt)
    library = ((lambda: torch.mm(a[0], b[0])[None]) if k == 1
               else (lambda: torch.bmm(a, b)))
    lib_err = float((library() - want).abs().max())
    del got, again, want
    out, inner = (n, m) if transpose else (m, n)
    b_ms, b_by = bound(4.0 * (k * m * n + k * out * out),
                       k * inner * out * (out + 1.0))
    timer = cold_cuda_ms if cold else cuda_ms
    what = "X^T X" if transpose else "X X^T"
    log(f"check gram_batched ({k}, {m}, {n}) {what}: max abs err {err:.3g} "
        f"(the library product's: {lib_err:.3g}), same bits on two launches")
    return dict(
        name=f"gram_batched ({k}, {m}, {n})" + ("" if transpose else " X X^T"),
        route="cuda", source="src/repro_torch/csrc/gram.cu",
        replaces=("src/repro/kernels/gram/gram.py:42" if k == 1
                  else "src/repro/kernels/gram/gram.py:82"),
        shape=(k, m, n, transpose), max_abs_err=err,
        library_max_abs_err=lib_err,
        tolerance=("2e-5 sqrt(G_ii G_jj) + 2e-3" if scaled
                   else "rtol 2e-5, atol 2e-3"),
        ms=timer(torch, lambda: gram_ops.gram_batched(x, transpose), reps),
        plain_ms=timer(torch, lambda: (gram_ref.gram_xtx_batched(x) if transpose
                                       else gram_ref.gram_xxt_batched(x)), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(torch, library, reps))


def qent_row(torch, flat, eps_t, reps, cold=False, bins=QENT_BINS):
    """qent_histogram_sweep on a (k, 3 240 000) stack at 65536 bins,
    bit-equal to the plain version, timed (no single PyTorch call
    computes it)."""
    from repro_torch.kernels.qent import ops as qent_ops, ref as qent_ref
    k, nel = flat.shape
    e = eps_t.shape[0]
    got = qent_ops.qent_histogram_sweep(flat, eps_t, bins)
    want = qent_ref.qent_histogram_sweep(flat, eps_t, bins)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"qent kernel disagrees at {(k, nel)} x {e} "
                             f"on {int((got != want).sum())} bins")
    del got, want
    b_ms, b_by = bound(4.0 * (k * nel + e + k * e * bins), 4.0 * k * nel * e)
    timer = cold_cuda_ms if cold else cuda_ms
    log(f"check qent_histogram_sweep ({k}, {nel}) x {e} eps x {bins} bins: "
        "bit-equal")
    return dict(
        name=f"qent_histogram_sweep ({k}, {nel}) x {e}"
             + ("" if bins == QENT_BINS else f" x {bins} bins"), route="cuda",
        source="src/repro_torch/csrc/qent.cu",
        replaces="src/repro/kernels/qent/qent.py:129",
        shape=(k, nel, e, bins), max_abs_err=0.0, tolerance="bit-equal",
        ms=timer(torch, lambda: qent_ops.qent_histogram_sweep(
            flat, eps_t, bins), reps),
        plain_ms=timer(torch, lambda: qent_ref.qent_histogram_sweep(
            flat, eps_t, bins), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_branches(torch, test, ebs_t):
    """The kernels' other branches against their plain versions: gram on
    a volume unfolding's X X^T (few output tiles, so the contraction is
    split over a cluster) and on ragged edges, each twice for identical
    bits; q-ent on a slice half of exact zeros (one hot bin), at one eps,
    at a bins that is not a power of two and at the default 4096."""
    from repro_torch.kernels.gram import ops as gram_ops, ref as gram_ref
    from repro_torch.kernels.qent import ops as qent_ops, ref as qent_ref
    g = torch.Generator(device="cuda").manual_seed(5)
    vol = torch.rand((2, 256, 65536), generator=g, device="cuda") - 0.3
    ragged = torch.rand((1, 257, 129), generator=g, device="cuda") - 0.5
    for x, tr in ((vol, False), (ragged, True), (ragged, False)):
        got = gram_ops.gram_batched(x, tr)
        again = gram_ops.gram_batched(x, tr)
        want = (gram_ref.gram_xtx_batched(x) if tr
                else gram_ref.gram_xxt_batched(x))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=2e-5, atol=2e-3):
            raise AssertionError(f"gram kernel disagrees at {tuple(x.shape)} "
                                 f"transpose={tr}: max abs err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"gram kernel bits differ between launches "
                                 f"at {tuple(x.shape)} transpose={tr}")
        log(f"check gram_batched {tuple(x.shape)} transpose={tr}: max abs "
            f"err {err:.3g}, same bits on two launches")
    flat = test.reshape(test.shape[0], -1)
    hot = flat[:1].clone()
    hot[0, : hot.shape[1] // 2] = 0.0
    for x, e, bins, what in ((hot, ebs_t, QENT_BINS, "hot bin"),
                             (hot, ebs_t[1:2], QENT_BINS, "hot bin, one eps"),
                             (flat[:2], ebs_t, 3000, "bins 3000"),
                             (flat[:2], ebs_t, 4096, "bins 4096")):
        got = qent_ops.qent_histogram_sweep(x, e, bins)
        want = qent_ref.qent_histogram_sweep(x, e, bins)
        if not torch.equal(got, want):
            raise AssertionError(f"qent kernel disagrees ({what}) on "
                                 f"{int((got != want).sum())} bins")
        log(f"check qent_histogram_sweep {tuple(x.shape)} x {e.shape[0]} "
            f"eps x {bins} bins ({what}): bit-equal")


def quality_row(torch, flat, eps_t, reps):
    """qdq_sse_sweep on a (k, 3 240 000) stack, the SSE and the (k, e, 2)
    quality tensor bit-equal to the plain version, timed back to back:
    at k = 32 the 415 MB stack exceeds the 50 MB L2, as the training
    sweep finds it (no single PyTorch call computes it)."""
    from repro_torch.kernels.quality import ops as q_ops, ref as q_ref
    k, nel = flat.shape
    e = eps_t.shape[0]
    check_quality(torch, flat, eps_t, "the timed shape")
    b_ms, b_by = bound(4.0 * (k * nel + e + k * e), 9.0 * k * nel * e)
    return dict(
        name=f"qdq_sse_sweep ({k}, {nel}) x {e}", route="cuda",
        source="src/repro_torch/csrc/quality.cu",
        replaces="src/repro/kernels/quality/quality.py:56",
        shape=(k, nel, e), max_abs_err=0.0, tolerance="bit-equal",
        ms=cuda_ms(torch, lambda: q_ops.qdq_sse_sweep(flat, eps_t), reps),
        plain_ms=cuda_ms(torch, lambda: q_ref.sse_sweep(flat, eps_t), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_quality(torch, flat, eps_t, what):
    """The quality SSE and the (k, e, 2) tensor of a (k, n) stack, bit
    for bit against the plain version."""
    from repro_torch.kernels.quality import ops as q_ops, ref as q_ref
    k, nel = flat.shape
    sse = q_ops.qdq_sse_sweep(flat, eps_t)
    sse_plain = q_ref.sse_sweep(flat, eps_t)
    if not torch.equal(sse, sse_plain):
        raise AssertionError(f"quality SSE differs at ({k}, {nel}) x "
                             f"{eps_t.shape[0]} ({what}) on "
                             f"{int((sse != sse_plain).sum())} values")
    qual = q_ops.quality_sweep(flat, eps_t)
    qual_plain = q_ref.quality_from_stats(
        sse_plain, nel, flat.amin(dim=1), flat.amax(dim=1))
    if not torch.equal(qual, qual_plain):
        raise AssertionError(f"quality tensor differs at ({k}, {nel}) "
                             f"({what})")
    log(f"check qdq_sse_sweep ({k}, {nel}) x {eps_t.shape[0]} eps ({what}): "
        "SSE and quality tensor bit-equal")


def check_kernels(torch, train, test, ebs_t):
    """Phase 3: every kernel against its plain version on the card.  Gram,
    q-ent and quality are timed at each shape the main path launches them
    with (the 32-slice training sweep; gram and q-ent also one held-out
    slice) and at the 8-slice shape of the earlier records."""
    k = test.shape[0]
    rows = []
    xc = train - train.mean(dim=1, keepdim=True)
    rows.append(gram_row(torch, xc, 5))
    del xc
    xc = test - test.mean(dim=1, keepdim=True)
    rows.append(gram_row(torch, xc, 10))
    rows.append(gram_row(torch, xc[:1].contiguous(), 50, cold=True))
    del xc
    flat32 = train.reshape(train.shape[0], -1)
    rows.append(qent_row(torch, flat32, ebs_t, 5))
    flat = test.reshape(k, -1)
    rows.append(qent_row(torch, flat, ebs_t, 10))
    rows.append(qent_row(torch, flat[:1], ebs_t, 50, cold=True))
    rows.append(qent_row(torch, flat[:1], ebs_t[1:2].contiguous(), 50,
                         cold=True))
    check_branches(torch, test, ebs_t)
    check_quotient(torch, ebs_t)
    rows.append(quality_row(torch, flat32, ebs_t, 10))
    rows.append(quality_row(torch, flat, ebs_t, 20))
    check_quality_edges(torch, test, ebs_t)
    rows.append(check_lorenzo(torch, test, ebs_t))
    rows.append(check_zfp(torch, test))
    return rows


def check_quality_edges(torch, test, ebs_t):
    """quality's other branches: one slice; lengths that are not a
    multiple of the 2048-element tile, 16-byte aligned (130 x 70) and
    not (9101, so slices 1 and 2 start off a 16-byte boundary); one eps;
    11 eps (two groups of the per-barrier fold)."""
    flat = test.reshape(-1)
    more = torch.cat([ebs_t, ebs_t[:5] * 3.0])
    for x, e, what in (
            (flat[:test.shape[1] * test.shape[2]].view(1, -1), ebs_t, "k = 1"),
            (flat[:3 * 9100].view(3, 9100), ebs_t, "130 x 70 a slice"),
            (flat[:3 * 9101].view(3, 9101), ebs_t, "unaligned slices"),
            (flat[:3 * 9101].view(3, 9101), ebs_t[1:2].contiguous(), "one eps"),
            (flat[:3 * 9100].view(3, 9100), more, "11 eps")):
        check_quality(torch, x, e, what)


def check_quotient(torch, ebs_t):
    """The quotient the quality and Lorenzo kernels share
    (``csrc/quotient.cuh``: one reciprocal per divisor, three FMAs per
    quotient) against ``__fdiv_rn`` on every finite float32, for each grid
    eps (quality's divisor), f32(2 eps) (Lorenzo's) and QUOTIENT_SPREAD
    log-spaced divisors from 2^-40 to 2^40: no quotient may differ."""
    from repro_torch.kernels.quality import ops as q_ops
    extra = QUOTIENT_SPREAD
    spread = np.float32(2.0) ** np.linspace(-40.0, 40.0, extra)
    divisors = torch.tensor(np.concatenate([
        ebs_t.cpu().numpy(), np.float32(2.0) * ebs_t.cpu().numpy(), spread
    ]).astype(np.float32), device="cuda")
    t = time.perf_counter()
    bad = q_ops.quotient_mismatches(divisors).cpu()
    secs = time.perf_counter() - t
    if int(bad.sum()):
        raise AssertionError(
            "shared-reciprocal quotient differs from __fdiv_rn: " + ", ".join(
                f"{float(d):.4g}: {int(b)}" for d, b in zip(divisors.cpu(), bad)
                if b))
    log(f"check quotient: every finite float32 over {divisors.shape[0]} "
        f"divisors (grid eps, 2 eps, {extra} from 2^-40 to 2^40) equals "
        f"__fdiv_rn ({secs:.2f} s)")


def check_lorenzo(torch, test, ebs_t):
    """lorenzo2d on every held-out slice at every grid eb, bit-equal to
    the plain ``lorenzo_encode``, and on ragged shapes (1 x 1, one row,
    one column, n % 4 != 0, rows not a multiple of the strip, a slice
    that starts off a 16-byte boundary); timed on one slice, as
    sz3-lorenzo's encode calls it."""
    from repro_torch.kernels.lorenzo import ops as lor_ops, ref as lor_ref
    k, m, n = test.shape
    ebs = [float(v) for v in ebs_t.cpu()]
    flat = test.reshape(-1)
    ragged = [flat[:a * b].view(a, b) for a, b in (
        (1, 1), (1, 1801), (1801, 1), (130, 70), (257, 1803), (33, 132))]
    ragged.append(flat[1:1 + m * n].view(m, n))
    inputs = [(test[i], eps) for i in range(k) for eps in ebs]
    inputs += [(x, eps) for x in ragged for eps in (ebs[0], ebs[-1])]
    for x, eps in inputs:
        got = lor_ops.lorenzo2d(x, eps)
        want = lor_ref.lorenzo2d(x, eps)
        if not torch.equal(got, want):
            raise AssertionError(
                f"lorenzo kernel differs on {int((got != want).sum())} "
                f"codes (shape {tuple(x.shape)}, eps {eps:.3g})")
    log(f"check lorenzo2d {k} x ({m}, {n}) x {len(ebs)} ebs and "
        f"{len(ragged)} ragged shapes x 2 ebs: bit-equal")
    return lorenzo_row(torch, test[0], ebs[1])


def lorenzo_row(torch, x, eps):
    """lorenzo2d timed cold on one (m, n) slice, as sz3-lorenzo's encode
    calls it, beside its plain version (the codes bit-equal)."""
    from repro_torch.kernels.lorenzo import ops as lor_ops, ref as lor_ref
    m, n = x.shape
    if not torch.equal(lor_ops.lorenzo2d(x, eps), lor_ref.lorenzo2d(x, eps)):
        raise AssertionError(f"lorenzo kernel differs at {(m, n)}")
    b_ms, b_by = bound(8.0 * m * n, 8.0 * m * n)
    return dict(
        name="lorenzo2d" + ("" if m == 1800 else f" ({m}, {n})"),
        route="cuda", source="src/repro_torch/csrc/lorenzo.cu",
        replaces="src/repro/kernels/lorenzo/lorenzo.py:61",
        shape=(m, n), max_abs_err=0.0, tolerance="bit-equal",
        ms=cold_cuda_ms(torch, lambda: lor_ops.lorenzo2d(x, eps), 50),
        plain_ms=cold_cuda_ms(torch, lambda: lor_ref.lorenzo2d(x, eps), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def planted_powers(torch, n: int, device="cuda"):
    """(n, n) float32 whose 4x4 blocks each hold a maximum |x| planted at
    an exact power of two 2^k (k in [-40, 40]) or 1 or 2 ulps above or
    below it, the other 15 values below half of it: the inputs on which
    the reference's ceil(log2(.)) departs from the exact exponent."""
    g = torch.Generator(device=device).manual_seed(11)
    nb = (n // 4) ** 2
    kexp = torch.randint(-40, 41, (nb,), generator=g, device=device)
    shift = torch.randint(-2, 3, (nb,), generator=g, device=device)
    mag = torch.ldexp(torch.ones(nb, device=device), kexp.to(torch.float32))
    top = mag.clone()
    for step in (1, 2):
        top = torch.where(shift >= step, torch.nextafter(
            top, torch.full_like(top, float("inf"))), top)
        top = torch.where(shift <= -step, torch.nextafter(
            top, torch.zeros_like(top)), top)
    vals = (torch.rand((nb, 16), generator=g, device=device) - 0.5) * mag[:, None]
    pos = torch.randint(0, 16, (nb,), generator=g, device=device)
    sign = torch.where(torch.rand(nb, generator=g, device=device) < 0.5, -1.0, 1.0)
    vals[torch.arange(nb, device=device), pos] = sign * top
    return (vals.reshape(n // 4, n // 4, 4, 4).permute(0, 2, 1, 3)
            .reshape(n, n).contiguous())


def check_zfp(torch, test):
    """zfp_forward2d on every held-out slice and on planted powers of two,
    coefficients and exponents bit-equal to the plain ``zfp_transform``."""
    from repro_torch.kernels.zfp_block import ops as zfp_ops, ref as zfp_ref
    k, m, n = test.shape
    inputs = [test[i] for i in range(k)] + [planted_powers(torch, m)]
    for i, x in enumerate(inputs):
        coef, exps = zfp_ops.zfp_forward2d(x)
        coef_p, exps_p = zfp_ref.zfp_forward2d(x)
        if not (torch.equal(coef, coef_p) and torch.equal(exps, exps_p)):
            raise AssertionError(
                f"zfp kernel differs on input {i}: "
                f"{int((coef != coef_p).sum())} coefficients, "
                f"{int((exps != exps_p).sum())} exponents")
    log(f"check zfp_forward2d {len(inputs)} x ({m}, {n}) (the last with "
        "planted powers of two): coefficients and exponents bit-equal")
    return zfp_row(torch, test[0])


def zfp_row(torch, x):
    """zfp_forward2d timed cold on one (m, n) slice, as a zfp encode of a
    slice calls it, beside its plain version (coefficients and exponents
    bit-equal) and beside the copy floor: a cold copy of the same 4 m n
    bytes into a second buffer, as ``copy_`` (a device-to-device memcpy)
    and as ``torch.neg(x, out=...)`` (an SM kernel); ``copy_ms`` is the
    faster of the two (``copy_by``), a yardstick, not a library call that
    computes ZFP."""
    from repro_torch.kernels.zfp_block import ops as zfp_ops, ref as zfp_ref
    m, n = x.shape
    got, want = zfp_ops.zfp_forward2d(x), zfp_ref.zfp_forward2d(x)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"zfp kernel differs at {(m, n)}")
    b_ms, b_by = bound((8.0 + 0.25) * m * n, 8.0 * m * n)
    dst = torch.empty_like(x)
    floors = {"copy_": cold_cuda_ms(torch, lambda: dst.copy_(x), 50),
              "neg": cold_cuda_ms(torch, lambda: torch.neg(x, out=dst), 50)}
    return dict(
        name="zfp_forward2d" + ("" if m == 1800 else f" ({m}, {n})"),
        route="cuda", source="src/repro_torch/csrc/zfp_block.cu",
        replaces="src/repro/kernels/zfp_block/zfp_block.py:80",
        shape=(m, n), max_abs_err=0.0, tolerance="bit-equal",
        ms=cold_cuda_ms(torch, lambda: zfp_ops.zfp_forward2d(x), 50),
        plain_ms=cold_cuda_ms(torch, lambda: zfp_ref.zfp_forward2d(x), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        copy_ms=min(floors.values()), copy_by=min(floors, key=floors.get))


def sweep_breakdown(torch, engine, train, ebs_t, card):
    """Phase 3b: the training sweep at full size, and its library part
    (``eigvalsh`` of the Gram stack), by CUDA events."""
    from repro_torch.kernels.gram import ops as gram_ops
    sweep_ms = cuda_ms(torch, lambda: engine.sweep(train, ebs_t, quality=True), 2)
    g = gram_ops.gram_batched(train - train.mean(dim=1, keepdim=True))
    eig_ms = cuda_ms(torch, lambda: torch.linalg.eigvalsh(g), 2)
    log(f"training sweep {tuple(train.shape)} x {ebs_t.shape[0]} ebs: "
        f"{sweep_ms:.2f} ms, of which eigvalsh {eig_ms:.2f} ms; sweep minus "
        f"eigvalsh {sweep_ms - eig_ms:.2f} ms", card)
    return {"sweep_ms": sweep_ms, "eigvalsh_ms": eig_ms,
            "sweep_minus_eigvalsh_ms": sweep_ms - eig_ms}


def profile_summary(torch, prof, wall_s: float, card) -> dict:
    """Device busy time of a profiled window: the CUDA kernels' own time."""
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        log("profile: the trace holds no device time (busy time not measured)")
        return {"busy_s": None, "wall_s": wall_s, "top_ms": []}
    busy_ms = sum(ms for _, ms in rows)
    top = [(name[:80], ms) for name, ms in sorted(rows, key=lambda r: -r[1])[:8]]
    log(f"profile: device busy {busy_ms / 1e3:.3f} s of {wall_s:.3f} s "
        f"({100.0 * (1 - busy_ms / 1e3 / wall_s):.2f}% idle); top kernels "
        + json.dumps([(k[:60], round(ms, 2)) for k, ms in top]), card)
    return {"busy_s": busy_ms / 1e3, "wall_s": wall_s, "top_ms": top}


def check_small(torch, P, TS):
    """Phase 4a: the sweep on the card against the CPU on a small input,
    under the default config (exact sort q-ent) and under
    ``use_kernels=True`` (the hashed q-ent kernel)."""
    x = TS.field_slices(FIELD, count=3, n=96, seed=7, device="cuda")
    ebs = [1e-3, 1e-2, 5e-2]
    for cfg in (P.PredictorConfig(), P.PredictorConfig(use_kernels=True)):
        f_gpu, q_gpu = P.features_sweep(x, ebs, cfg, quality=True)
        f_cpu, q_cpu = P.features_sweep(x.cpu(), ebs, cfg, quality=True)
        if f_gpu.shape != (3, 3, 2) or not torch.isfinite(f_gpu).all():
            raise AssertionError(f"bad feature tensor {tuple(f_gpu.shape)}")
        err = float((f_gpu.cpu() - f_cpu).abs().max())
        if err > 1e-5:
            raise AssertionError(f"features on the card differ from the CPU "
                                 f"by {err} (use_kernels={cfg.use_kernels})")
        if not torch.equal(q_gpu.cpu(), q_cpu):
            raise AssertionError("quality tensor on the card differs from the CPU")
        log(f"small input, use_kernels={cfg.use_kernels}: card vs CPU "
            f"features max abs err {err:.3g}, quality bit-equal")


def check_qent_routes(torch, P, test, ebs):
    """Phase 4b: at full size (the training stack, so the sort's memory
    is shown to fit beside it), the hashed kernel route against the
    exact entropy (the sort route in float64, ``float64_sorted_entropy``,
    the default route until it took the reference's float32 bits) within
    1e-5 in log q-ent at the ebs whose code range (data range / eb) fits
    the bins; elsewhere the largest difference is reported, and so is
    how far the default sort route, the reference's float32 arithmetic
    (its terms round at long runs), lies from the exact entropy."""
    span = float(test.amax() - test.amin())
    fits = [span / eb + 1 < QENT_BINS for eb in ebs]
    sort32 = P.quantized_entropy_sweep(test, ebs)
    with float64_sort_route(torch, P):
        exact = P.quantized_entropy_sweep(test, ebs)
    kernel = P.quantized_entropy_sweep(test, ebs, use_kernel=True)

    def log_qe(q):
        return torch.log(torch.clamp(q, min=1e-3))

    diff = (log_qe(exact) - log_qe(kernel)).abs().amax(dim=0).cpu().tolist()
    off = (sort32 - exact).abs().amax(dim=0).cpu().tolist()
    bad = [(eb, d) for eb, d, ok in zip(ebs, diff, fits) if ok and d > 1e-5]
    if bad:
        raise AssertionError(f"kernel q-ent and the exact entropy disagree "
                             f"where the codes fit the bins: {bad}")
    log(f"q-ent routes at full size {tuple(test.shape)}, max |log q-ent "
        "exact - kernel| per eb: " + ", ".join(
            f"{eb:.3g}: {d:.3g}{'' if ok else ' (range > bins)'}"
            for eb, d, ok in zip(ebs, diff, fits))
        + "; max |q-ent float32 sort - exact| bits per eb: "
        + ", ".join(f"{eb:.3g}: {d:.3g}" for eb, d in zip(ebs, off))
        + f"; peak device memory so far "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return {"kernel_vs_exact_log": dict(zip(map(float, ebs), diff)),
            "sort32_vs_exact_bits": dict(zip(map(float, ebs), off))}


def float64_sorted_entropy(torch, xs, eps):
    """The sort route's entropy as the port took it before it took the
    reference's float32 bits: g(j) from two ``torch.log2`` over the
    (k, n) ranks, each row's sum in float64 and ``log2(n) - s / n`` in
    float64 (for ``sort_route_cost`` only)."""
    from repro_torch.quant import (INT32_CODE_MAX, INT32_CODE_MIN,
                                   flush_subnormals, per_row)
    k, n = xs.shape
    codes = torch.clamp(torch.floor(flush_subnormals(xs / eps)),
                        INT32_CODE_MIN, INT32_CODE_MAX).to(torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=xs.device)
    start = torch.ones((k, n), dtype=torch.bool, device=xs.device)
    start[:, 1:] = codes[:, 1:] != codes[:, :-1]
    del codes
    run_start = torch.cummax(torch.where(start, iota, 0), dim=1).values
    del start
    j = (iota - run_start + 1).to(torch.float32)
    del run_start
    g = j * torch.log2(j) - (j - 1) * torch.log2(torch.clamp(j - 1, min=1))
    s = per_row(lambda r: r.sum(dim=1, dtype=torch.float64), g)
    return (np.log2(float(n)) - s / n).to(torch.float32)


@contextlib.contextmanager
def float64_sort_route(torch, P):
    """Within it, the sort route takes the float64 form
    (``float64_sorted_entropy``) in place of the reference's bits."""
    saved = P._sorted_entropy
    P._sorted_entropy = lambda xs, eps: float64_sorted_entropy(torch, xs, eps)
    try:
        yield
    finally:
        P._sorted_entropy = saved


def sort_route_cost(torch, P, train, ebs_t, card) -> dict:
    """Phase 4c: the training sweep (features and quality) on the sort
    q-ent route (``use_kernels=False``) with the reference's float32 q-ent
    against the float64 form it replaced, in turns (new, old, new, old;
    the first new call also builds the rank-term table), each with its
    wall time to a synchronize and its peak device memory above what was
    allocated before it; and how far the two forms' features differ."""
    engine = P.get_engine(P.PredictorConfig())
    out = {"new_s": [], "old_s": [], "new_peak_gib": [], "old_peak_gib": []}
    feats = {}
    for form in ("new", "old", "new", "old"):
        with (float64_sort_route(torch, P) if form == "old"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            feats[form] = engine.sweep(train, ebs_t, quality=True)[0]
            torch.cuda.synchronize()
            out[f"{form}_s"].append(time.perf_counter() - t)
            out[f"{form}_peak_gib"].append(
                (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
    out["max_abs_diff"] = float((feats["new"] - feats["old"]).abs().max())
    log(f"sort route, training sweep {tuple(train.shape)} x "
        f"{ebs_t.shape[0]} ebs with quality: float32 (the reference's bits) "
        f"{out['new_s']} s, peak +{out['new_peak_gib']} GiB; float64 (before) "
        f"{out['old_s']} s, peak +{out['old_peak_gib']} GiB; features differ "
        f"by {out['max_abs_diff']:.3g} at most", card)
    return out


# ---------------------------------------------------------------------------
# launch windows and the studies after the main path
# ---------------------------------------------------------------------------

def zero_counts(torch):
    from repro_torch.kernels import wrappers
    torch.cuda.synchronize()
    for fn in wrappers().values():
        fn.launches = 0
        fn.by_shape.clear()


def require_launches(what: str, launches: dict, needs) -> None:
    """Raise if a kernel of ``needs`` has no launch in ``launches``."""
    missing = [n for n in needs if launches.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"{what} never launched {missing}")


def read_counts(torch, phase: str, needs) -> dict:
    """The launches of a phase just run, by kernel and by shape; raises
    if a kernel the phase runs was launched no time."""
    from repro_torch.kernels import wrappers
    torch.cuda.synchronize()
    counts = {name: {"launches": fn.launches, "by_shape": dict(fn.by_shape)}
              for name, fn in wrappers().items()}
    require_launches(phase, {n: c["launches"] for n, c in counts.items()},
                     needs)
    log(f"{phase}: launches " + json.dumps(
        {n: {str(k): v for k, v in c["by_shape"].items()}
         for n, c in counts.items() if c["launches"]}))
    return counts


def check_regression_bits(torch, C, x, eps):
    """sz2 and sz3-regression on the card against their CPU route on one
    slice: codes, plane codes and block choices bit-equal, the same CR."""
    host = x.cpu()
    for name in ("sz2", "sz3-regression"):
        comp = C.get(name)
        codes, aux = comp.encode(x, eps)
        codes_h, aux_h = comp.encode(host, eps)
        pairs = [(codes, codes_h), (aux["coef_codes"], aux_h["coef_codes"])]
        if "use_reg" in aux:
            pairs.append((aux["use_reg"], aux_h["use_reg"]))
        for got, want in pairs:
            if not torch.equal(got.cpu(), want):
                raise AssertionError(
                    f"{name} on the card differs from the CPU on "
                    f"{int((got.cpu() != want).sum())} codes")
        cr, cr_h = comp.cr(x, eps), comp.cr(host, eps)
        if cr != cr_h:
            raise AssertionError(f"{name} CR {cr} on the card, {cr_h} on the CPU")
        log(f"check {name} {tuple(x.shape)} at eps {eps:.3g}: codes, plane "
            f"codes and CR ({cr:.6f}) bit-equal on the card and the CPU")


def planted_subnormals(torch, x):
    """(2, m, n): ``x`` with planted +-subnormals, +-values in [1e-22,
    1e-19] (squares subnormal) and +-values just above the smallest
    normal (quotients by 256 subnormal), and a slice of zeros holding a
    few of each."""
    g = torch.Generator(device="cuda").manual_seed(13)
    m, n = x.shape
    flat = x.reshape(-1).clone()
    third = min(9600, m * n // 8)
    idx = torch.randperm(m * n, generator=g, device="cuda")[:3 * third]

    def signs(k):
        return torch.where(torch.rand(k, generator=g, device="cuda") < 0.5,
                           -1.0, 1.0)

    sub = torch.randint(1, 2 ** 23, (third,), generator=g, device="cuda",
                        dtype=torch.int32).view(torch.float32)
    tiny = 10.0 ** (-22.0 + 3.0 * torch.rand(third, generator=g, device="cuda"))
    low = 2.0 ** (-126.0 + 7.0 * torch.rand(third, generator=g, device="cuda"))
    vals = torch.cat([sub * signs(third), tiny * signs(third),
                      low * signs(third)])
    flat[idx] = vals
    zeros = torch.zeros_like(flat)
    few = third // 16
    keep = torch.cat([idx[:few], idx[third:third + few],
                      idx[2 * third:2 * third + few]])
    zeros[keep] = flat[keep]
    return torch.stack([flat.view(m, n), zeros.view(m, n)])


def check_planted(torch, x):
    """Every kernel against its plain version on the planted slices, on
    the card and (the plain version) on the CPU: q-ent histograms, the
    quality SSE and tensor and the ZFP transform of the slices as the
    entry points flush them, Lorenzo codes (which need no flush, and
    ``baselines.lu_model`` does not flush) of the raw slices."""
    from repro_torch.kernels.lorenzo import ops as lor_ops, ref as lor_ref
    from repro_torch.kernels.qent import ops as qent_ops, ref as qent_ref
    from repro_torch.kernels.quality import ops as q_ops, ref as q_ref
    from repro_torch.kernels.zfp_block import ops as zfp_ops, ref as zfp_ref
    from repro_torch.core import predictors
    from repro_torch.quant import flush_subnormals
    planted = planted_subnormals(torch, x)
    host = planted.cpu()
    k = planted.shape[0]
    flushed, flushed_h = flush_subnormals(planted), flush_subnormals(host)
    flat, flat_h = flushed.reshape(k, -1), flushed_h.reshape(k, -1)
    ebs = torch.tensor(PLANT_EBS, dtype=torch.float32, device="cuda")
    ebs_h = ebs.cpu()

    def same(what, got, *wants):
        for want in wants:
            if not torch.equal(got.cpu(), want.cpu()):
                raise AssertionError(f"planted subnormals: {what} differs on "
                                     f"{int((got.cpu() != want.cpu()).sum())} "
                                     "values")

    same("q-ent histograms", qent_ops.qent_histogram_sweep(flat, ebs, QENT_BINS),
         qent_ref.qent_histogram_sweep(flat, ebs, QENT_BINS),
         qent_ref.qent_histogram_sweep(flat_h, ebs_h, QENT_BINS))
    same("quality SSE", q_ops.qdq_sse_sweep(flat, ebs),
         q_ref.sse_sweep(flat, ebs), q_ref.sse_sweep(flat_h, ebs_h))
    same("quality tensor", q_ops.quality_sweep(flat, ebs),
         q_ops.quality_sweep(flat_h, ebs_h))
    same("quality tensor from the raw slices through the entry point",
         predictors.quality_sweep(planted, ebs),
         predictors.quality_sweep(host, ebs_h))
    for i in range(k):
        for eps in PLANT_EBS[:2]:
            same("Lorenzo codes", lor_ops.lorenzo2d(planted[i], eps),
                 lor_ref.lorenzo2d(planted[i], eps),
                 lor_ref.lorenzo2d(host[i], eps))
        for got, want, want_h in zip(zfp_ops.zfp_forward2d(flushed[i]),
                                     zfp_ref.zfp_forward2d(flushed[i]),
                                     zfp_ref.zfp_forward2d(flushed_h[i])):
            same("ZFP transform", got, want, want_h)
    log(f"check planted subnormals {tuple(planted.shape)} at eps {PLANT_EBS}: "
        "q-ent histograms, quality SSE and tensor (also through the entry "
        "point), Lorenzo codes and ZFP transform of every kernel equal to "
        "the plain version on the card and on the CPU")


def medape(pred, true) -> float:
    return float(np.median(100.0 * np.abs(np.asarray(pred) - np.asarray(true))
                           / np.asarray(true)))


def study_table5(torch, data, eps, cfg, card):
    """Table 5 on sz2: our k-fold spline on every slice against block
    sampling and Lu et al.'s model on every third slice and OptZConfig's
    probe on every third from the second, warm-started on the slice half
    the stack away (benchmarks/bench_prior.py's choices)."""
    from repro_torch import compressors as C
    from repro_torch.core import baselines as B, pipeline as PL
    from repro_torch.core import predictors as P
    from repro_torch.dist import sweep as DS
    count = data.shape[0]
    feats = P.get_engine(cfg).features(data, eps)
    crs = DS.training_crs(C.get("sz2"), data, [eps])[:, 0]
    out = {"ours": PL.kfold_evaluate(feats.cpu(), crs, "spline", 8).medape}
    sample = range(0, count, 3)
    out["block_sampling"] = medape(
        [B.block_sampling(data[i], eps) for i in sample], crs[list(sample)])
    out["lu_model"] = medape([B.lu_model(data[i], eps) for i in sample],
                             crs[list(sample)])
    probe = range(1, count, 3)
    out["optzconfig"] = medape(
        [B.optzconfig_probe(data[(i + count // 2) % count], eps) for i in probe],
        crs[list(probe)])
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"Table 5: non-finite MedAPE {out}")
    log(f"Table 5 ({FIELD} {tuple(data.shape)}, sz2, eps {eps:.3g}) MedAPE % "
        + json.dumps({k: round(v, 3) for k, v in out.items()}), card)
    return out, feats, crs


def study_table3(torch, feats, crs, cfg, card):
    """Table 3: LASSO importances (k = 6) on the cesm-cloud slices and on
    N_SCALE scale-pressure slices at their Table-1 edge, sz2's CRs."""
    from repro_torch import compressors as C
    from repro_torch.core import predictors as P, regression as R
    from repro_torch.data import scientific as TS
    from repro_torch.dist import sweep as DS
    out = {FIELD: R.lasso_importance(feats, crs, k=6).cpu().tolist()}
    spec = TS.FIELDS[SCALE_FIELD]
    scale = TS.field_slices(SCALE_FIELD, count=N_SCALE, n=spec.full_n, seed=0,
                            device="cuda")
    eps = spec.eps * float(scale.amax() - scale.amin())
    sfeats = P.get_engine(cfg).features(scale, eps)
    scrs = DS.training_crs(C.get("sz2"), scale, [eps])[:, 0]
    out[SCALE_FIELD] = R.lasso_importance(sfeats, scrs, k=6).cpu().tolist()
    for v in out.values():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"Table 3: non-finite importance {out}")
    log("Table 3 LASSO |coef| [q-ent, svd/sigma, interaction] " + json.dumps(
        {k: [round(x, 4) for x in v] for k, v in out.items()})
        + f" (scale-pressure {tuple(scale.shape)}, eps {eps:.3g})", card)
    return out, scale, eps


def study_fig5(torch, cfg, card):
    """Fig 5: per Gaussian type, N_GAUSS samples at GAUSS_N, one sweep,
    the five compressors' CRs and their k-fold spline MedAPE."""
    from repro_torch import compressors as C
    from repro_torch.core import pipeline as PL, predictors as P
    from repro_torch.data import gaussian as G
    from repro_torch.dist import sweep as DS
    out = {}
    for stype in (1, 2, 3, 4):
        slices = G.sample_batch(stype, N_GAUSS, GAUSS_N, seed=stype,
                                device="cuda")
        feats = P.get_engine(cfg).features(slices, GAUSS_EPS).cpu()
        for name in GAUSS_COMPRESSORS:
            crs = DS.training_crs(C.get(name), slices, [GAUSS_EPS])[:, 0]
            out[f"type{stype}|{name}"] = PL.kfold_evaluate(
                feats, crs, "spline", 8).medape
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"Fig 5: non-finite MedAPE {out}")
    log(f"Fig 5 ({N_GAUSS} x {GAUSS_N}^2 per type, eps {GAUSS_EPS}) MedAPE % "
        + json.dumps({k: round(v, 3) for k, v in out.items()}), card)
    return out, slices


def study_table4(torch, cfg, card):
    """Table 4: N_VOL miranda-vx volumes of VOL_SHAPE, one rank-4 sweep on
    the q-ent kernel route (checked against the exact entropy within
    1e-5, as in phase 4b, which also reports the float32 sort route's
    distance from it), the five STUDY_3D CRs per volume, k-fold MedAPE,
    TTHRESH's RMSE."""
    from repro_torch import compressors as C
    from repro_torch.core import pipeline as PL, predictors as P
    from repro_torch.data import scientific as TS
    from repro_torch.dist import sweep as DS
    vols = torch.stack([TS.volume(VOL_FIELD, VOL_SHAPE, seed=s, device="cuda")
                        for s in range(N_VOL)])
    eps = VOL_EB_REL * float(vols.amax() - vols.amin())
    feats = P.features_sweep(vols, [eps], cfg)[:, 0]
    with float64_sort_route(torch, P):
        exact = P.features_sweep(vols, [eps], P.PredictorConfig())[:, 0]
        exact_qe = P.quantized_entropy_sweep(vols, [eps])
    diff = float((feats - exact).abs().max())
    if diff > 1e-5:
        raise AssertionError(f"Table 4: q-ent kernel route differs from the "
                             f"exact entropy by {diff}")
    off = float((P.quantized_entropy_sweep(vols, [eps]) - exact_qe).abs().max())
    out, crs_all = {}, {}
    for name in C.STUDY_3D:
        crs = DS.training_crs(C.get(name), vols, [eps])[:, 0]
        crs_all[name] = crs.tolist()
        out[name] = PL.kfold_evaluate(feats.cpu(), crs, "spline", 8).medape
    rmse = C.get("tthresh").roundtrip_error(vols[0], eps)
    if not rmse <= 1.05 * eps:
        raise AssertionError(f"TTHRESH RMSE {rmse} above 1.05 eps ({eps})")
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"Table 4: non-finite MedAPE {out}")
    log(f"Table 4 ({VOL_FIELD} {tuple(vols.shape)}, eps {eps:.4g}; kernel vs "
        f"exact {diff:.2g}, float32 sort vs exact {off:.2g} bits) MedAPE % "
        + json.dumps({k: round(v, 3) for k, v in out.items()})
        + f"; mean CR " + json.dumps({k: round(float(np.mean(v)), 3)
                                      for k, v in crs_all.items()})
        + f"; TTHRESH RMSE / eps {rmse / eps:.4f}", card)
    return out, vols, eps, {"crs": crs_all, "tthresh_rmse_over_eps": rmse / eps,
                            "route_diff": diff}


def study_rows(torch, inputs):
    """Phase 12: gram, q-ent and zfp at the shapes the studies launched
    them with, each against its plain version and timed."""
    rows = []
    for x, transpose in inputs["gram"]:
        rows.append(gram_row(torch, x, 5, transpose=transpose,
                             scaled=not transpose))
    for flat, eps_t in inputs["qent"]:
        rows.append(qent_row(torch, flat, eps_t, 5))
    for x in inputs["zfp"]:
        rows.append(zfp_row(torch, x))
    return rows


def probe_batched_reductions(torch, batch, picks) -> dict:
    """The library reductions the sweep used to run over a whole batch
    (before ``quant.per_row``): for each, the number of picked rows
    whose batched result differs from the row's result alone.  Reported,
    not asserted: it says which steps depended on the batch."""
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.qent import ops as qent_ops, ref as qent_ref
    k = batch.shape[0]
    dims = tuple(range(1, batch.ndim))
    flat = batch.reshape(k, -1)

    def differ(fn, x):
        whole = fn(x)
        return sum(not torch.equal(fn(x[i:i + 1].clone())[0], whole[i])
                   for i in picks)

    if batch.ndim == 3:
        u = batch - batch.mean(dim=1, keepdim=True)
        g = gram_ops.gram_batched(u, True)
    else:
        u = (batch - batch.mean(dim=dims, keepdim=True)).reshape(
            k, batch.shape[1], -1)
        g = gram_ops.gram_batched(u, False)
    ev = torch.clamp(torch.linalg.eigvalsh(g), min=0.0).flip(-1)
    eps = torch.tensor([float(flat[0].amax() - flat[0].amin()) * 1e-3],
                       device=batch.device)
    hist = qent_ops.qent_histogram_sweep(flat, eps, QENT_BINS)
    out = {"std": differ(lambda x: torch.std(x, dim=dims, correction=0),
                         batch),
           "mean (columns)" if batch.ndim == 3 else "mean (volume)": differ(
               (lambda x: x.mean(dim=1)) if batch.ndim == 3
               else (lambda x: x.mean(dim=dims)), batch),
           "eigvalsh": differ(torch.linalg.eigvalsh, g),
           "cumsum": differ(lambda x: torch.cumsum(x, dim=1), ev),
           "float64 sum": differ(lambda x: x.sum(dim=1, dtype=torch.float64),
                                 flat),
           "entropy sum": differ(
               lambda h: -qent_ref._entropy_terms(h).sum(dim=-1), hist)}
    del u, g, ev, hist
    return out


def check_batch_independence(torch, cases, card):
    """Phase 13: for each (what, batch, eb grid, picks), the sweep
    (features and quality, sort and kernel q-ent) of each picked row
    alone is bit-equal to its row in the batch's sweep and in a
    ``sweep_padded`` bucket of the picked rows; the Gram of each picked
    row alone equals its Gram in the batch (a 2-D batch mean-corrected
    by columns, X^T X; a volume batch by its mean, both unfoldings'
    X X^T)."""
    from repro_torch.core import predictors as P
    from repro_torch.dist import sweep as DS
    from repro_torch.kernels.gram import ops as gram_ops
    t = time.perf_counter()
    probes = {}
    for what, batch, epss, picks in cases:
        k_pad = len(picks) + 3
        for cfg in (P.PredictorConfig(), P.PredictorConfig(use_kernels=True)):
            whole = torch.cat(P.features_sweep(batch, epss, cfg, quality=True),
                              dim=-1)
            bucket = DS.sweep_padded(batch[picks], epss, cfg, k_pad=k_pad,
                                     mode="both")
            for j, i in enumerate(picks):
                alone = torch.cat(P.features_sweep(batch[i:i + 1], epss, cfg,
                                                   quality=True), dim=-1)[0]
                for got, where in ((whole[i], "its batch"),
                                   (bucket[j], "a padded bucket")):
                    if not torch.equal(alone, got):
                        raise AssertionError(
                            f"{what}: row {i} alone differs from the row in "
                            f"{where} (use_kernels={cfg.use_kernels}) on "
                            f"{int((alone != got).sum())} values")
            del whole, bucket
        if batch.ndim == 3:
            x = batch - batch.mean(dim=1, keepdim=True)
            grams = [(x, True)]
        else:
            x = batch - batch.mean(dim=(1, 2, 3), keepdim=True)
            k, d, m, n = x.shape
            grams = [(x.reshape(k, d, -1), False),
                     (torch.movedim(x, 2, 1).reshape(k, m, -1), False)]
        for u, tr in grams:
            g = gram_ops.gram_batched(u, tr)
            for i in picks:
                if not torch.equal(gram_ops.gram_batched(u[i:i + 1], tr)[0],
                                   g[i]):
                    raise AssertionError(f"{what}: gram of row {i} alone "
                                         f"differs from its batch's "
                                         f"({tuple(u.shape)})")
            del g
        del x, grams
        log(f"batch independence {what} {tuple(batch.shape)}: rows {picks} "
            f"alone == in the batch == in a bucket of {k_pad}, features and "
            "quality under both q-ent routes, and gram alone == in the batch")
        probes[what] = probe_batched_reductions(torch, batch, picks)
        log(f"batched library reductions, {what}: rows of {len(picks)} whose "
            f"result in the batch differs from alone "
            f"{json.dumps(probes[what])}")
    torch.cuda.synchronize()
    return time.perf_counter() - t, probes


def eb_grids(grid):
    """The eb grids a row at each eb of ``grid`` is held across: the eb
    alone, the grid, the grid padded to the next eb bucket with its last
    eb repeated, and a union with as many other ebs interleaved before,
    between and after the grid's."""
    g = [float(e) for e in grid]
    others = [g[0] * 0.5] + [float(np.sqrt(a * b)) for a, b in
                             zip(g[:-1], g[1:])]
    union = sorted(g + others[:len(g)])
    bucket = g + [g[-1]] * 2
    return {"6": g, "8": bucket, "12": union}


def probe_old_entropy_sum(torch, flat, grids):
    """The kernel route's entropy sum in its old form (a library sum over
    each row's (1, e, bins) terms): the number of (row, eb) values that
    differ from the same eb summed alone, per grid.  Reported, not
    asserted."""
    from repro_torch.kernels.qent import ops as qent_ops, ref as qent_ref
    from repro_torch.quant import per_row

    def old(epss):
        eps_t = torch.tensor(epss, dtype=torch.float32, device=flat.device)
        hist = qent_ops.qent_histogram_sweep(flat, eps_t, QENT_BINS)
        return per_row(lambda t: -t.sum(dim=-1),
                       qent_ref._entropy_terms(hist))

    grid = grids["6"]
    alone = torch.cat([old([e]) for e in grid], dim=1)
    out = {}
    for name, epss in grids.items():
        got = old(epss)
        cols = [epss.index(e) for e in grid]
        out[name] = int((got[:, cols] != alone).sum())
    return out


def check_eb_independence(torch, cases, card):
    """Phase 13, eb grids: for each (what, rows, grid), each row's
    features (both q-ent routes) and quality at each eb of the grid are
    bit-equal swept at that eb alone, in the grid, in its padded eb
    bucket and in a 12-eb union; the sort route's q-ent at the grid is
    the same bits on the card as on the CPU; and, reported only, how many
    values the old form of the kernel route's entropy sum gave other
    bits."""
    from repro_torch.core import predictors as P
    t = time.perf_counter()
    probes = {}
    for what, rows, grid in cases:
        grids = eb_grids(grid)
        runs = [(f"features use_kernels={uk}",
                 lambda x, e, uk=uk: P.features_sweep(
                     x, e, P.PredictorConfig(use_kernels=uk)))
                for uk in (False, True)]
        runs.append(("quality", lambda x, e: P.quality_sweep(x, e)))
        for name, sweep in runs:
            alone = torch.cat([sweep(rows, [e]) for e in grids["6"]], dim=1)
            for gname, epss in grids.items():
                got = sweep(rows, epss)
                cols = [epss.index(e) for e in grids["6"]]
                if not torch.equal(got[:, cols], alone):
                    raise AssertionError(
                        f"{what}: {name} at the grid's ebs differs between "
                        f"one eb alone and a grid of {gname} on "
                        f"{int((got[:, cols] != alone).sum())} values")
            del alone, got
        probes[what] = probe_old_entropy_sum(
            torch, rows.reshape(rows.shape[0], -1), grids)
        qe = P.quantized_entropy_sweep(rows, grid).cpu()
        qe_cpu = P.quantized_entropy_sweep(rows.cpu(), grid)
        if not torch.equal(qe, qe_cpu):
            raise AssertionError(
                f"{what}: the sort route's q-ent on the card differs from "
                f"the CPU on {int((qe != qe_cpu).sum())} values")
        log(f"eb independence {what} {tuple(rows.shape)}: each row at each "
            f"of {len(grid)} ebs alone == in grids of 6, 8 (padded) and 12 "
            "(union), features under both q-ent routes and quality; the "
            "sort route's q-ent on the card == on the CPU bit for bit; the "
            "old entropy sum's values differing from alone per grid "
            f"{json.dumps(probes[what])}", card)
    torch.cuda.synchronize()
    return time.perf_counter() - t, probes


def on_device(obj, dev):
    """A CR model (nested named tuples of tensors) or an ``EbGridModel``
    with every tensor moved to ``dev``."""
    import dataclasses
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(on_device(v, dev) for v in obj))
    if hasattr(obj, "models"):
        return dataclasses.replace(obj, models=[
            dataclasses.replace(m, model=on_device(m.model, dev))
            for m in obj.models])
    return obj


def check_prediction_bits(torch, models, test, ebs, psnr_floor, card):
    """Phase 13, predictions: the same bits on the card as on the CPU for
    both model kinds (fit on the card to seeded features; 400 jittered
    rows alone, in 7s and at once, ``predict`` and ``predict_log``, and
    the exact form the short one falls back to), for phase 5's eight
    grids at every eb on 400 rows, and for ``EbGridModel.predict`` /
    ``predict_psnr`` at 9 ebs and the UC1, UC2 and UC3 answers on the 8
    held-out slices (models on the card with the card's features, beside
    copies on the CPU fed the same features)."""
    import dataclasses
    from repro_torch.core import predictors as P
    from repro_torch.core import regression as R
    from repro_torch.core import usecases as UC
    t = time.perf_counter()
    rng = np.random.default_rng(SEED)
    base = rng.normal(size=(64, 2)).astype(np.float32)
    crs = np.exp(rng.normal(size=64)).astype(np.float32) + 1.0
    rows = (base[rng.integers(0, 64, 400)]
            + rng.normal(0, 0.05, (400, 2))).astype(np.float32)
    x_dev = torch.from_numpy(rows).to("cuda")
    x_cpu = torch.from_numpy(rows)

    def same(what, a, b):
        a, b = a.detach().cpu(), b.detach().cpu()
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"predictions: {what} differs card vs CPU "
                                 f"on {int((a != b).sum())} values")

    fitted = {kind: M.fit(torch.from_numpy(base).to("cuda"),
                          torch.from_numpy(crs).to("cuda"))
              for kind, M in (("spline", R.SplineCRModel),
                              ("linear", R.LinearCRModel))}
    n_models = 0
    for kind, m in fitted.items():
        mc = on_device(m, "cpu")
        for fn in ("predict", "predict_log"):
            want = getattr(mc, fn)(x_cpu)
            same(f"{kind} {fn}", getattr(m, fn)(x_dev), want)
            same(f"{kind} {fn} in 7s", torch.cat(
                [getattr(m, fn)(x_dev[i:i + 7]) for i in range(0, 400, 7)]),
                want)
            same(f"{kind} {fn} alone", torch.cat(
                [getattr(m, fn)(x_dev[i:i + 1]) for i in range(50)]),
                want[:50])
        same(f"{kind} exact form", m._log(x_dev, R._Exact, *m._params()),
             mc._log(x_cpu, R._Exact, *mc._params()))
    cpu_models = {n: on_device(gm, "cpu") for n, gm in models.items()}
    for name, gm in models.items():
        for ei, cm in enumerate(cpu_models[name].models):
            same(f"{name} at eb {ei}", gm.models[ei].model.predict(x_dev),
                 cm.model.predict(x_cpu))
            n_models += 1
    cfg = P.PredictorConfig(use_kernels=True)
    feats = P.features_sweep(test, ebs, cfg)
    probes = [ebs[0] * 0.5] + [float(e) for e in ebs] + [
        float(np.sqrt(ebs[1] * ebs[2])), ebs[-1] * 3]
    lorenzo, lorenzo_cpu = models["sz3-lorenzo"], cpu_models["sz3-lorenzo"]
    n_answers = 0
    for i in range(test.shape[0]):
        def caches(i=i):
            return (P.get_engine(cfg).cached(test[i], features=feats[i],
                                             epss=ebs),
                    P.get_engine(cfg).cached(test[i].cpu(),
                                             features=feats[i].cpu(),
                                             epss=ebs))
        cd, cc = caches()
        x_i, x_ic = test[i], test[i].cpu()
        for e in probes:
            for fn in ("predict", "predict_psnr"):
                a = getattr(lorenzo, fn)(x_i, float(e), cd)
                b = getattr(lorenzo_cpu, fn)(x_ic, float(e), cc)
                if a != b:
                    raise AssertionError(f"predictions: {fn} at {e} differs "
                                         f"card vs CPU ({a} != {b})")
        target = lorenzo.predict(x_i, float(ebs[2]), cd)
        answers = [
            (UC.find_error_bound_for_cr(lorenzo, x_i, target, feat_cache=cd),
             UC.find_error_bound_for_cr(lorenzo_cpu, x_ic, target,
                                        feat_cache=cc)),
            (UC.best_compressor({n: m.models[1] for n, m in models.items()},
                                x_i, float(ebs[1]), feats=feats[i, 1][None]),
             UC.best_compressor({n: m.models[1]
                                 for n, m in cpu_models.items()},
                                x_ic, float(ebs[1]),
                                feats=feats[i, 1][None].cpu())),
            tuple(dataclasses.asdict(UC.find_setting(
                ms, x, cr_floor=2.0, psnr_floor=psnr_floor, feat_cache=c))
                for ms, x, c in ((models, x_i, cd), (cpu_models, x_ic, cc)))]
        for a, b in answers:
            if a != b:
                raise AssertionError(f"predictions: a UC answer differs "
                                     f"card vs CPU on slice {i}: {a} != {b}")
            n_answers += 1
    torch.cuda.synchronize()
    s = time.perf_counter() - t
    log(f"predictions card == CPU bit for bit: spline and linear on 400 rows "
        f"(alone, in 7s, at once; the exact form too), {n_models} grid "
        f"models on 400 rows, predict / predict_psnr at {len(probes)} ebs "
        f"and {n_answers} UC1-UC3 answers on {test.shape[0]} slices "
        f"({s:.2f} s)", card)
    return s


# ---------------------------------------------------------------------------
# phase 15: the sweep service under concurrent clients
# ---------------------------------------------------------------------------

def serve_plan(n_hot: int, n_cold: int, requests: int = SERVE_REQUESTS):
    """Each client's ``requests`` requests as (kind, slice index, target
    CR): kinds and hot slices in rotation (every (kind, hot slice) pair
    recurs, so each hot row is admitted to the cache), the cold slices
    once each as the first request of the first clients."""
    plan = []
    for c in range(SERVE_CLIENTS):
        reqs = []
        for r in range(requests):
            kind = SERVE_KINDS[(c + r) % len(SERVE_KINDS)]
            reqs.append((kind, (c + r // len(SERVE_KINDS)) % n_hot,
                         SERVE_TARGETS[(c + r) % len(SERVE_TARGETS)]))
        plan.append(reqs)
    for j in range(n_cold):
        plan[j][0] = (SERVE_COLD_KINDS[j % len(SERVE_COLD_KINDS)], n_hot + j,
                      SERVE_TARGETS[j % len(SERVE_TARGETS)])
    return plan


def serve_submit(svc, req, ctx):
    kind, i, target = req
    x = ctx["slices"][i]
    if kind == "featurize":
        return svc.submit_featurize(x[None], ctx["ebs"])
    if kind == "featurize_sub":
        return svc.submit_featurize(x[None], ctx["sub"])
    if kind == "find_eb":
        return svc.submit_find_eb(ctx["lorenzo"], x, target)
    if kind == "best_compressor":
        return svc.submit_best_compressor(ctx["uc2"], x, ctx["eps2"])
    if kind == "advise":
        return svc.submit_advise(ctx["models"], ctx["pairs"][i])
    if kind == "find_setting":
        return svc.submit_find_setting(ctx["models"], x,
                                       cr_floor=SERVE_CR_FLOOR,
                                       psnr_floor=SERVE_PSNR_FLOOR)
    if kind == "quality":
        return svc.submit_quality(x[None], ctx["ebs"])
    return svc.submit_kv_gate(ctx["leaves"])


def serve_direct(torch, req, ctx):
    """The port's direct call for one request, on the card."""
    from repro_torch.core import predictors as P
    from repro_torch.core import usecases as UC
    from repro_torch.serve.method import AdviseMethod
    from repro_torch.train import grad_compress as GC
    kind, i, target = req
    cfg = ctx["cfg"]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            ctx.get("device", "cuda"))

    x = dev(ctx["slices"][i])
    if kind == "featurize":
        return P.features_sweep(x[None], ctx["ebs"], cfg).cpu().numpy()
    if kind == "featurize_sub":
        return P.features_sweep(x[None], ctx["sub"], cfg).cpu().numpy()
    if kind == "find_eb":
        return UC.find_error_bound_for_cr(ctx["lorenzo"], x, target)
    if kind == "best_compressor":
        return UC.best_compressor(ctx["uc2"], x, ctx["eps2"])
    if kind == "advise":
        feats = P.features_sweep(dev(ctx["pairs"][i]), ctx["ebs"], cfg)
        return AdviseMethod.cr_table(ctx["models"], feats.cpu().numpy())
    if kind == "find_setting":
        return UC.find_setting(ctx["models"], x, cr_floor=SERVE_CR_FLOOR,
                               psnr_floor=SERVE_PSNR_FLOOR)
    if kind == "quality":
        return P.quality_sweep(x[None], ctx["ebs"], cfg).cpu().numpy()
    return np.stack([GC.predicted_cr_int8(dev(leaf)).cpu().numpy()
                     for leaf in ctx["leaves"]])


def same_result(got, want) -> bool:
    if isinstance(want, np.ndarray):
        if isinstance(got, dict):
            got = got["cr"]
        return got.shape == want.shape and np.array_equal(
            got.view(np.int64 if got.dtype == np.float64 else np.int32),
            want.view(np.int64 if want.dtype == np.float64 else np.int32))
    return got == want


def serve_traffic(svc, plan, ctx, stamps=None):
    """Every client thread submits its requests one after another and
    waits for each (appending each completion's ``perf_counter`` to
    ``stamps`` when given).  Returns (results by (client, request),
    latencies in ms by kind, wall s)."""
    import threading
    results, lat, errors = {}, {}, []
    lock = threading.Lock()

    def client(c):
        try:
            for r, req in enumerate(plan[c]):
                t = time.perf_counter()
                out = serve_submit(svc, req, ctx).result(timeout=600)
                ms = (time.perf_counter() - t) * 1e3
                with lock:
                    if stamps is not None:
                        stamps.append(time.perf_counter())
                    results[(c, r)] = out
                    lat.setdefault(req[0], []).append(ms)
        except Exception as exc:        # raised after the join
            errors.append(exc)

    t = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(plan))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t
    if errors:
        raise errors[0]
    return results, lat, wall


class PredictionCount:
    """Counts the model predictions (``predict`` and ``predict_log`` of
    the linear and spline CR models: ``regression._predicted``) made
    from any thread while it is entered."""

    def __init__(self):
        import threading
        self.n = 0
        self._lock = threading.Lock()
        self._saved = None

    def __enter__(self):
        from repro_torch.core import regression as R
        self._saved = orig = R._predicted

        def counted(*args, **kwargs):
            with self._lock:
                self.n += 1
            return orig(*args, **kwargs)
        R._predicted = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.core import regression as R
        R._predicted = self._saved


def prediction_cost(torch, models, feats, card) -> dict:
    """Host ms of one model prediction read back to the host, as the
    service's post-processing makes them (median of 200, in turns), for
    1 and 2 rows: the port's prediction (the reference's jitted bits, by
    the checked short form on the host) beside the library mat-vec
    ``x @ coef`` of the design; and of one advise request's ``cr_table``
    (8 models x 6 ebs on 2 rows)."""
    from repro_torch.core import regression as R
    from repro_torch.serve.method import AdviseMethod
    m = models["sz3-lorenzo"].models[2].model

    def matvec(f):
        z = m.std(R._f32(f, m.coef.device))
        x = (R._spline_design(z, m.knots1, m.knots2) if hasattr(m, "knots1")
             else R._linear_design(z))
        return torch.exp(x @ m.coef).cpu()

    def host_ms(fn, reps):
        out = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
        return out

    rec = {}
    for rows in (1, 2):
        f = feats[:rows, 2, :]
        ours, lib = [], []
        for _ in range(200):
            ours += host_ms(lambda: m.predict(f).cpu(), 1)
            lib += host_ms(lambda: matvec(f), 1)
        rec[f"predict_{rows}_ms"] = float(np.median(ours))
        rec[f"matvec_{rows}_ms"] = float(np.median(lib))
    rec["cr_table_ms"] = float(np.median(host_ms(
        lambda: AdviseMethod.cr_table(models, feats[:2]), 20)))
    log("prediction host ms (median): the jitted form's bits 1 row "
        f"{rec['predict_1_ms']:.4f}, 2 rows {rec['predict_2_ms']:.4f}; "
        f"library mat-vec 1 row {rec['matvec_1_ms']:.4f}, 2 rows "
        f"{rec['matvec_2_ms']:.4f}; one advise cr_table (8 x 6 on 2 rows) "
        f"{rec['cr_table_ms']:.3f}", card)
    return rec


def serve_config(cfg, post_workers: int = 2):
    """Phase 15's (and 18's) service configuration on ``cfg``."""
    from repro_torch.serve.sweep_service import ServiceConfig
    return ServiceConfig(max_batch_slices=64, max_wait_ms=2.0,
                         cache_admit_after=2, cache_bytes=SERVE_CACHE_BYTES,
                         post_workers=post_workers, pcfg=cfg)


def route_ctx(cfg, models, hot_cold, ebs, leaves) -> dict:
    """The requests' context of one route: phase 5's models on ``cfg``,
    the held-out slices, the grids and the kv leaves."""
    import dataclasses

    def on_route(gm):
        return dataclasses.replace(gm, cfg=cfg, models=[
            dataclasses.replace(m, cfg=cfg) for m in gm.models])

    models = {n: on_route(m) for n, m in models.items()}
    sub = [float(ebs[1]), float(np.sqrt(ebs[2] * ebs[3])), float(ebs[4])]
    return {"cfg": cfg, "slices": hot_cold, "ebs": [float(e) for e in ebs],
            "sub": sub, "lorenzo": models["sz3-lorenzo"],
            "uc2": {n: m.models[2] for n, m in models.items()},
            "eps2": float(ebs[2]), "models": models, "leaves": leaves,
            "pairs": [np.stack([hot_cold[i], hot_cold[(i + 1) % SERVE_HOT]])
                      for i in range(len(hot_cold))]}


def serve_route(torch, cfg, models, hot_cold, ebs, leaves, card,
                post_workers=2, second_pass=True, mesh=None,
                requests=SERVE_REQUESTS):
    """One route's run: a fresh service (``post_workers`` threads in its
    post-processing pool; its launches sharded over ``mesh``) and the
    plan of ``requests`` a client served, the model predictions of the
    pass counted, and with
    ``second_pass`` served again (only the hot rows and the kv leaves,
    which must come from the cache with no launch).  Returns (record,
    the requests' context, each request with its served results) for
    :func:`check_served`."""
    from repro_torch.kernels import wrappers
    from repro_torch.serve.sweep_service import SweepService

    n_hot = SERVE_HOT
    ctx = route_ctx(cfg, models, hot_cold, ebs, leaves)
    plan = serve_plan(n_hot, len(hot_cold) - n_hot, requests)
    scfg = serve_config(cfg, post_workers)
    rec = {"post_workers": post_workers}
    results2 = {}
    with SweepService(scfg, device="cuda" if mesh is None else None,
                      mesh=mesh) as svc:
        t = time.perf_counter()
        svc.warmup()
        rec["warmup_s"] = time.perf_counter() - t
        with PredictionCount() as predictions:
            results, lat, wall = serve_traffic(svc, plan, ctx)
        st = svc.stats()
        n_req = sum(len(p) for p in plan)
        post_s = {k: m["post_s"] for k, m in st["methods"].items()}
        rec.update(requests=n_req, wall_s=wall, req_per_s=n_req / wall,
                   predictions=predictions.n, post_s=post_s,
                   pool_busy_share=sum(post_s.values())
                   / (wall * post_workers),
                   launches=st["launches"], rows_launched=st["rows_launched"],
                   rows_requested=sum(m["rows"] for m in
                                      st["methods"].values()),
                   pad_rows=st["pad_rows"], batches=st["batches"],
                   window_ms=st["window_ms"],
                   window_shrinks=st["window_shrinks"], cache=st["cache"],
                   client_ms={k: {"p50": float(np.percentile(v, 50)),
                                  "p99": float(np.percentile(v, 99)),
                                  "n": len(v)} for k, v in lat.items()},
                   service_ms={k: {"p50": m["p50_ms"], "p99": m["p99_ms"]}
                               for k, m in st["methods"].items()})
        # the second pass: hot rows and the kv leaves, all cached by now
        again = [[req for req in reqs if req[1] < n_hot] for reqs in plan]
        if second_pass:
            before = {k: fn.launches for k, fn in wrappers().items()}
            launches0 = svc.launches
            results2, _, wall2 = serve_traffic(svc, again, ctx)
            kernel_delta = {k: fn.launches - before[k]
                            for k, fn in wrappers().items()}
            rec["second_pass"] = {
                "requests": sum(len(p) for p in again), "wall_s": wall2,
                "launches": svc.launches - launches0, "kernels": kernel_delta}
            if svc.launches != launches0 or any(kernel_delta.values()):
                raise AssertionError(
                    f"serve ({cfg}): the second pass over cached rows "
                    f"launched {svc.launches - launches0} times, kernels "
                    f"{kernel_delta}")
    what = (f"serve use_kernels={cfg.use_kernels} post_workers={post_workers}"
            + ("" if mesh is None else f" on a mesh of {mesh.size} shards"))
    log(f"{what}: {n_req} requests from "
        f"{SERVE_CLIENTS} clients in {wall:.3f} s ({n_req / wall:.2f} req/s); "
        f"launches {rec['launches']}, rows launched {rec['rows_launched']} of "
        f"{rec['rows_requested']} requested, pad rows {rec['pad_rows']}, "
        f"batches {rec['batches']}, window {rec['window_ms']:.3f} ms; cache "
        f"{json.dumps(rec['cache'])}", card)
    log(f"{what}: {predictions.n} model predictions; post-processing s by "
        f"method {json.dumps({k: round(v, 3) for k, v in post_s.items()})}, "
        f"pool busy {100 * rec['pool_busy_share']:.1f} % of {post_workers} "
        "threads x wall", card)
    log(f"{what} client latency ms by method (p50 / p99): " + ", ".join(
        f"{k} {v['p50']:.2f} / {v['p99']:.2f}"
        for k, v in sorted(rec["client_ms"].items())), card)
    if second_pass:
        log(f"{what} second pass: {rec['second_pass']['requests']} requests "
            f"on cached rows in {wall2:.3f} s, 0 launches", card)
    served = [(req, [results[(c, r)]] + (
        [results2[(c, again[c].index(req))]]
        if second_pass and req[1] < n_hot else []))
        for c, reqs in enumerate(plan) for r, req in enumerate(reqs)]
    return rec, ctx, served


def check_served(torch, rec, ctx, served, direct):
    """Every served result of both passes == the port's direct call on
    the card (made once per distinct request and kept in ``direct``
    for another run of the same route)."""
    t = time.perf_counter()
    for req, got in served:
        if req not in direct:
            direct[req] = serve_direct(torch, req, ctx)
        for g in got:
            if not same_result(g, direct[req]):
                raise AssertionError(
                    f"serve (use_kernels={ctx['cfg'].use_kernels}): {req} "
                    f"served {g} != direct {direct[req]}")
    rec["direct_check_s"] = time.perf_counter() - t
    rec["distinct_requests"] = len(direct)
    log(f"serve use_kernels={ctx['cfg'].use_kernels} post_workers="
        f"{rec['post_workers']}: every served result == the direct call on "
        f"the card ({len(direct)} distinct requests)")


def serve_leaves():
    """The kv-gate leaves of phases 15 and 18: 12 distinct of 4 M float32
    values, from ``SEED``, and 4 of them again."""
    rng = np.random.default_rng(SEED)
    distinct = [rng.standard_normal(KV_LEAF_N, dtype=np.float32)
                * np.float32(10.0 ** (i % 4 - 2))
                for i in range(KV_LEAVES - KV_REPEATS)]
    return distinct + [distinct[i].copy() for i in range(KV_REPEATS)]


def phase_serve(torch, models, test, ebs, card):
    """Phase 15: ``SweepService`` on the card, 8 client threads x 64
    requests of the seven methods over 4 hot held-out slices and the
    other 4 once each, under the default config (sort q-ent) and
    ``use_kernels=True``, its launches counted for the "Serve" path.
    The cost of one prediction is taken first, on the idle card.
    Returns (record, counts, the direct results by route) -- phase 18
    holds its served results to the same direct calls."""
    from repro_torch.core import predictors as P
    hot_cold = test.cpu().numpy()
    leaves = serve_leaves()
    feats = P.features_sweep(test[:2], ebs, P.PredictorConfig()).cpu().numpy()
    cost = prediction_cost(torch, models, feats, card)
    zero_counts(torch)
    sort_cfg = P.PredictorConfig()
    runs = {f"use_kernels={cfg.use_kernels}": serve_route(
        torch, cfg, models, hot_cold, ebs, leaves, card)
        for cfg in (sort_cfg, P.PredictorConfig(use_kernels=True))}
    counts = read_counts(torch, "Serve", (
        "gram_batched", "qent_histogram_sweep", "qdq_sse_sweep"))
    directs = {}
    for rec, ctx, served in runs.values():
        check_served(torch, rec, ctx, served,
                     directs.setdefault(ctx["cfg"].use_kernels, {}))
    out = {k: rec for k, (rec, _, _) in runs.items()}
    out["prediction_cost"] = cost
    return out, counts, directs


# ---------------------------------------------------------------------------
# phase 18: the sweep service on a mesh and across processes
# ---------------------------------------------------------------------------

def fabric_child(job_file: str) -> int:
    """Phase 18 (b)'s process-group member (``--fabric-child JOB``): joins
    the job's group with its shards on the card and builds the service
    on the spanning mesh.  The leader warms it up and serves phase 15's
    plan (cut to the job's ``requests`` a client, default
    ``FABRIC_REQUESTS``) on the kernel route from 8 client threads, a
    follower joins
    every launch until the leader closes; each writes its wall time and
    its kernels' launches by shape, and the leader its served results,
    for the parent to hold to phase 15's direct calls."""
    import pickle
    import torch
    from repro_torch import kernels as K
    from repro_torch.launch import mesh as M
    from repro_torch.serve.sweep_service import SweepService
    job = json.loads(Path(job_file).read_text())
    faulthandler.dump_traceback_later(FABRIC_TIMEOUT_S - 30, exit=True)
    M.dist_init(job["init"], num_processes=job["nprocs"],
                process_id=job["rank"], backend=job["backend"],
                device=job["device"],
                init_timeout_s=DIST_COLLECTIVE_TIMEOUT_S)
    mesh = M.make_sweep_mesh(devices=[job["device"]] * job["shards"])
    ctx = torch.load(job["ctx"], weights_only=False)
    before = K.launch_counts()
    svc = SweepService(serve_config(ctx["cfg"]), mesh=mesh)
    rec = {"role": svc.role}
    if svc.role == "leader":
        t = time.perf_counter()
        svc.warmup()
        rec["warmup_s"] = time.perf_counter() - t
        plan = serve_plan(SERVE_HOT, len(ctx["slices"]) - SERVE_HOT,
                          job.get("requests", FABRIC_REQUESTS))
        results, lat, wall = serve_traffic(svc, plan, ctx)
        st = svc.stats()
        svc.close()
        n_req = sum(len(p) for p in plan)
        rec.update(requests=n_req, wall_s=wall, req_per_s=n_req / wall,
                   launches=st["launches"], rows_launched=st["rows_launched"],
                   pad_rows=st["pad_rows"], batches=st["batches"],
                   procs=st["procs"], transport=st["transport"])
        with open(job["results"], "wb") as f:
            pickle.dump(results, f)
    else:
        svc.serve()
        rec["launches"] = svc.launches
    total, by_shape = K.launches_since(before)
    rec.update(kernels=total, by_shape=by_shape)
    Path(job["out"]).write_text(json.dumps(rec))
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def phase_fabric(torch, models, test, ebs, directs, card):
    """Phase 18: the sweep service on a mesh and across processes, each
    form serving on the kernel route (``use_kernels=True``) and every
    served result held to phase 15's direct call on the card: (a) this
    process, ``SweepService(mesh=...)`` over two shards of the card,
    phase 15's plan and its cached second pass; (b) process groups in
    fresh interpreters (``--fabric-child``) serving the plan: a one-rank
    NCCL group whose mesh has two shards on the card (the fabric's
    broadcasts and gathers of CUDA tensors; NCCL refuses two ranks on one
    GPU) and a two-rank gloo group, one shard each on the card, a leader
    and a follower joining its launches;
    (c) ``sweep_serve --mesh auto --coordinator ...`` in two processes
    (zfp on 6 slices, 4 clients x 16 UC1/UC2 requests, ``--verify``:
    every served result == the direct call).  Returns (record, the
    launches of all of it by shape, as the "Fabric" path's)."""
    import pickle
    from repro_torch.core import predictors as P
    from repro_torch.launch import mesh as M
    cfg = P.PredictorConfig(use_kernels=True)
    direct = directs[True]
    hot_cold = test.cpu().numpy()
    leaves = serve_leaves()
    out = {}

    # (a) one process, two shards of the card
    zero_counts(torch)
    mesh = M.make_sweep_mesh(devices=[DIST_DEVICE] * 2)
    rec, ctx, served = serve_route(torch, cfg, models, hot_cold, ebs, leaves,
                                   card, mesh=mesh, requests=FABRIC_REQUESTS)
    counts = read_counts(torch, "Fabric (a)", (
        "gram_batched", "qent_histogram_sweep", "qdq_sse_sweep"))
    check_served(torch, rec, ctx, served, direct)
    out["a"] = rec
    parts = [{n: {str(k): v for k, v in c["by_shape"].items()}
              for n, c in counts.items()}]

    tmp = Path(tempfile.mkdtemp(prefix="fabric_", dir=ROOT / "build"))
    try:
        # (b) a one-rank NCCL group with two shards, then a leader and a
        # follower in a two-rank gloo group
        torch.save(ctx, tmp / "ctx.pt")
        plan = serve_plan(SERVE_HOT, len(hot_cold) - SERVE_HOT,
                          FABRIC_REQUESTS)
        for role, nprocs, backend, shards in (("nccl", 1, DIST_NCCL, 2),
                                              ("gloo", 2, "gloo", 1)):
            cmds, outs = [], []
            for r in range(nprocs):
                job = {"init": f"file://{tmp / ('init_' + role)}",
                       "nprocs": nprocs, "rank": r, "backend": backend,
                       "device": DIST_DEVICE, "shards": shards,
                       "ctx": str(tmp / "ctx.pt"),
                       "results": str(tmp / f"results_{role}.pkl"),
                       "out": str(tmp / f"fabric_{role}_{r}.json")}
                (tmp / f"job_{role}_{r}.json").write_text(json.dumps(job))
                cmds.append([sys.executable, str(Path(__file__).resolve()),
                             "--fabric-child",
                             str(tmp / f"job_{role}_{r}.json")])
                outs.append(Path(job["out"]))
            out[f"b_{role}_wall_s"] = run_group(f"fabric (b) {role}", cmds,
                                                tmp, FABRIC_TIMEOUT_S)
            ranks = [json.loads(p.read_text()) for p in outs]
            out[f"b_{role}"] = ranks
            parts += [r["by_shape"] for r in ranks]
            with open(tmp / f"results_{role}.pkl", "rb") as f:
                results = pickle.load(f)
            check_served(torch, dict(ranks[0], post_workers=2), ctx, [
                (req, [results[(c, r)]]) for c, reqs in enumerate(plan)
                for r, req in enumerate(reqs)], direct)
            lead = ranks[0]
            for follow in ranks[1:]:
                if follow["launches"] != lead["launches"]:
                    raise AssertionError(
                        f"fabric (b) {role}: a follower joined "
                        f"{follow['launches']} of the leader's "
                        f"{lead['launches']} launches")
            log(f"fabric (b) {role}, {nprocs} rank(s) x {shards} shard(s) "
                f"on the card: {lead['requests']} requests in "
                f"{lead['wall_s']:.3f} s ({lead['req_per_s']:.2f} req/s), "
                f"{lead['launches']} launches over {lead['transport']}; "
                "every served result == the direct call", card)

        # (c) the load CLI, leader and follower
        report = tmp / "serve_c.json"
        cmds = [[sys.executable, "-m", "repro_torch.launch.sweep_serve",
                 "--fields", FIELD, "--n", str(SERVE_CLI_N),
                 "--train-slices", "6", "--compressor", "zfp", "--clients",
                 "4", "--requests", "16", "--device", "cuda",
                 "--use-kernels", "--verify", "--mesh", "auto",
                 "--coordinator", f"file://{tmp / 'init_c'}",
                 "--num-processes", "2", "--process-id", str(r),
                 "--backend", "gloo", "--out", str(report)]
                for r in range(2)]
        out["c_wall_s"] = run_group("fabric (c)", cmds, tmp,
                                    SERVE_CLI_TIMEOUT_S)
        rep = json.loads(report.read_text())
        if rep["verify"]["mismatches"] or rep["requests"] != 16:
            raise AssertionError(f"fabric (c): {rep['verify']}, "
                                 f"{rep['requests']} requests")
        parts.append(rep["launches_by_shape"]["serve"])
        out["c"] = {k: rep[k] for k in ("requests", "wall_s", "req_per_s",
                                        "p50_ms", "p99_ms", "procs",
                                        "verify", "launches_serve")}
        log(f"fabric (c) sweep_serve over 2 processes: {rep['requests']} "
            f"requests in {rep['wall_s']:.3f} s ({rep['req_per_s']:.2f} "
            f"req/s); {rep['verify']['checked']} distinct results == the "
            "direct call", card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    merged = by_shape_counts(parts)
    require_launches("Fabric", {n: c["launches"] for n, c in merged.items()},
                     ("gram_batched", "qent_histogram_sweep",
                      "qdq_sse_sweep"))
    log("Fabric launches " + json.dumps(
        {n: {str(k): v for k, v in c["by_shape"].items()}
         for n, c in merged.items() if c["launches"]}), card)
    return out, merged


# ---------------------------------------------------------------------------
# phase 19: the service survives a lost process
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def fault_child(job_file: str) -> int:
    """Phase 19 (a) and (b)'s process-group member (``--fault-child
    JOB``): joins the job's group (gloo unless ``backend`` says nccl;
    ``group_timeout_s``) with one shard on its device and builds the
    service on the spanning mesh (``launch_timeout_s``).  The leader
    warms it up (then, with ``hang_timeout_s``, cuts its launch deadline
    to that) and serves the cut plan from 8 client threads, and sets
    ``FAULT_ARM_KEY`` in the group's store once ``FAULT_ARM_REQUESTS``
    requests are done; a follower with a ``chaos`` spec arms it
    (``dist.faultinject``) when it sees the key, so the fault lands in
    its next launch, mid-traffic.  Each stays ``linger_s`` after its
    service ends (past the group's timeout: an NCCL watchdog that found
    a collective stuck would end it meanwhile), writes its kernels'
    launches by shape and what it saw, the leader also its served
    results and the rates before and after the fault, and leaves with
    ``os._exit(0)`` (a group that lost a peer is not torn down)."""
    import dataclasses
    import pickle
    import threading
    import torch
    from repro_torch import kernels as K
    from repro_torch.dist import faultinject as FI
    from repro_torch.dist.fault import FabricError
    from repro_torch.launch import mesh as M
    from repro_torch.serve.sweep_service import SweepService
    job = json.loads(Path(job_file).read_text())
    faulthandler.dump_traceback_later(FAULT_TIMEOUT_S - 30, exit=True)
    M.dist_init(job["init"], num_processes=job["nprocs"],
                process_id=job["rank"], backend=job.get("backend", "gloo"),
                device=job["device"], init_timeout_s=job.get(
                    "group_timeout_s", DIST_COLLECTIVE_TIMEOUT_S))
    mesh = M.make_sweep_mesh(devices=[job["device"]])
    ctx = torch.load(job["ctx"], weights_only=False)
    before = K.launch_counts()
    scfg = serve_config(ctx["cfg"])
    if job.get("launch_timeout_s"):
        scfg = dataclasses.replace(scfg,
                                   launch_timeout_s=job["launch_timeout_s"])
    svc = SweepService(scfg, mesh=mesh)
    rec = {"role": svc.role}
    if svc.role == "leader":
        svc.warmup()
        if job.get("hang_timeout_s"):
            svc.scfg = dataclasses.replace(
                svc.scfg, launch_timeout_s=job["hang_timeout_s"])
        plan = serve_plan(SERVE_HOT, len(ctx["slices"]) - SERVE_HOT,
                          FAULT_REQUESTS)
        stamps = []

        def signal_arm():
            while len(stamps) < FAULT_ARM_REQUESTS:
                time.sleep(0.002)
            M.coordination_store().set(FAULT_ARM_KEY, "1")

        threading.Thread(target=signal_arm, daemon=True).start()
        t0 = time.perf_counter()
        results, _, wall = serve_traffic(svc, plan, ctx, stamps)
        st = svc.stats()
        window = svc._fault_window
        svc.close()
        n_req = sum(len(p) for p in plan)
        rec.update(requests=n_req, wall_s=wall, req_per_s=n_req / wall,
                   **{k: st[k] for k in (
                       "launches", "epoch", "transport", "recoveries",
                       "last_recovery_s", "last_detect_s", "kv_bytes",
                       "procs")})
        if window is not None and window[1] is not None:
            start, end = window
            done_before = sum(s <= start for s in stamps)
            done_after = sum(s >= end for s in stamps)
            rec.update(fault_at_s=start - t0, recovered_at_s=end - t0,
                       done_before=done_before, done_after=done_after,
                       req_per_s_before=done_before / (start - t0),
                       req_per_s_after=done_after / max(t0 + wall - end,
                                                        1e-9))
        with open(job["results"], "wb") as f:
            pickle.dump(results, f)
    else:
        if job.get("chaos"):
            def arm():
                store = M.coordination_store()
                while not store.check([FAULT_ARM_KEY]):
                    time.sleep(0.002)
                FI.configure(job["chaos"])
            threading.Thread(target=arm, daemon=True).start()
        t = time.perf_counter()
        try:
            svc.serve()
            rec["serve"] = "clean"
        except FabricError as exc:
            rec["serve"] = exc.kind
        rec["serve_s"] = time.perf_counter() - t
        svc.close()
        rec.update(launches=svc.launches, transport=svc.stats()["transport"])
    time.sleep(job.get("linger_s", 0))
    total, by_shape = K.launches_since(before)
    rec.update(kernels=total, by_shape=by_shape)
    Path(job["out"]).write_text(json.dumps(rec))
    sys.stdout.flush()
    os._exit(0)


def phase_fault(torch, models, test, ebs, directs, card):
    """Phase 19: the service on the card survives a lost process, on the
    kernel route, every served result held to phase 15's direct call:
    (a) three gloo ranks, one shard each on the card (NCCL refuses two
    ranks on one GPU), rank 2 SIGKILLed inside a launch mid-traffic: the
    leader recovers onto [0, 1] and serves through the store; (b) two
    ranks, the follower hangs inside a launch and the leader's deadline,
    ``FAULT_HANG_TIMEOUT_S`` once warm, evicts it; (c) ``sweep_serve
    --coordinator-only`` and two ``--external-coordinator`` ranks, the
    leader SIGKILLed in its second launch after warmup: the follower
    exits 0 with ``leader_lost`` within ``LEADER_LOST_BOUND_S`` of the
    leader's death.  (a) and (b) serve phase 15's plan cut to 8 clients
    x 16 requests.  Returns (record, their launches by shape, as the
    "Fault" path's)."""
    import pickle
    import signal
    import torch.distributed as dist
    from repro_torch.core import predictors as P
    cfg = P.PredictorConfig(use_kernels=True)
    direct = directs[True]
    hot_cold = test.cpu().numpy()
    ctx = route_ctx(cfg, models, hot_cold, ebs, serve_leaves())
    plan = serve_plan(SERVE_HOT, len(hot_cold) - SERVE_HOT, FAULT_REQUESTS)
    c10d = dist.distributed_c10d
    out = {"abort_calls": {
        "_abort_process_group": hasattr(c10d, "_abort_process_group"),
        "ProcessGroup.abort": hasattr(dist.ProcessGroup, "abort")}}
    log("fault: this build aborts an NCCL group with " + json.dumps(
        out["abort_calls"]), card)
    parts = []
    tmp = Path(tempfile.mkdtemp(prefix="fault_", dir=ROOT / "build"))
    try:
        torch.save(ctx, tmp / "ctx.pt")
        for form, nprocs, chaos, hang in (
                ("a", 3, "follower_launch:kill:1", None),
                ("b", 2, "follower_launch:hang:1:3600",
                 FAULT_HANG_TIMEOUT_S)):
            init = f"tcp://127.0.0.1:{free_port()}"
            cmds, outs = [], []
            for r in range(nprocs):
                job = {"init": init, "nprocs": nprocs, "rank": r,
                       "device": DIST_DEVICE, "ctx": str(tmp / "ctx.pt"),
                       "results": str(tmp / f"results_{form}.pkl"),
                       "out": str(tmp / f"fault_{form}_{r}.json"),
                       "chaos": chaos if r == nprocs - 1 else None,
                       "hang_timeout_s": hang}
                (tmp / f"job_{form}_{r}.json").write_text(json.dumps(job))
                cmds.append([sys.executable, str(Path(__file__).resolve()),
                             "--fault-child",
                             str(tmp / f"job_{form}_{r}.json")])
                outs.append(Path(job["out"]))
            killed = {nprocs - 1: -signal.SIGKILL} if form == "a" else {}
            out[f"{form}_wall_s"] = run_group(f"fault ({form})", cmds, tmp,
                                              FAULT_TIMEOUT_S, expect=killed)
            ranks = [json.loads(p.read_text()) for i, p in enumerate(outs)
                     if i not in killed]
            out[form] = ranks
            parts += [r["by_shape"] for r in ranks]
            lead = ranks[0]
            with open(tmp / f"results_{form}.pkl", "rb") as f:
                results = pickle.load(f)
            check_served(torch, dict(lead, post_workers=2), ctx, [
                (req, [results[(c, r)]]) for c, reqs in enumerate(plan)
                for r, req in enumerate(reqs)], direct)
            want = ([0, 1], "clean") if form == "a" else ([0], "evicted")
            if (lead["recoveries"], lead["procs"], ranks[1]["serve"]) != (
                    1, want[0], want[1]) or "req_per_s_after" not in lead:
                raise AssertionError(f"fault ({form}): leader {lead}, "
                                     f"follower {ranks[1]}")
            log(f"fault ({form}) {nprocs} gloo ranks on the card, "
                f"{chaos} on rank {nprocs - 1} once {FAULT_ARM_REQUESTS} "
                f"requests were done: {lead['requests']} requests in "
                f"{lead['wall_s']:.3f} s ({lead['req_per_s']:.2f} req/s; "
                f"{lead['req_per_s_before']:.2f} before the fault "
                f"[{lead['done_before']} done by {lead['fault_at_s']:.3f} s], "
                f"{lead['req_per_s_after']:.2f} after "
                f"[{lead['done_after']} from {lead['recovered_at_s']:.3f} s]"
                f"); detection {lead['last_detect_s']:.3f} s, recovery "
                f"{lead['last_recovery_s']:.3f} s, epoch {lead['epoch']}, "
                f"procs {lead['procs']}, transport {lead['transport']}, "
                f"{lead['kv_bytes']} bytes through the store, "
                f"{lead['launches']} launches; follower: {ranks[1]['serve']} "
                f"after {ranks[1]['serve_s']:.3f} s; every served result == "
                "the direct call", card)

        # (c) the store in a process of its own; the leader killed
        init = f"tcp://127.0.0.1:{free_port()}"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        coord = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.sweep_serve",
             "--coordinator-only", "--coordinator", init,
             "--num-processes", "2"], env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT)
        try:
            cmds = [[sys.executable, "-m", "repro_torch.launch.sweep_serve",
                     "--fields", FIELD, "--n", str(SERVE_CLI_N),
                     "--train-slices", "6", "--compressor", "zfp",
                     "--clients", "4", "--requests", "16", "--device",
                     "cuda", "--use-kernels", "--mesh", "auto",
                     "--coordinator", init, "--external-coordinator",
                     "--num-processes", "2", "--process-id", str(r),
                     "--backend", "gloo"]
                    + (["--chaos", f"leader_launch:kill:{FAULT_LEADER_KILL}"]
                       if r == 0 else []) for r in range(2)]
            exits, logs = {}, {}
            out["c_wall_s"] = run_group(
                "fault (c)", cmds, tmp, SERVE_CLI_TIMEOUT_S,
                expect={0: -signal.SIGKILL}, exits=exits, logs=logs)
        finally:
            coord.send_signal(signal.SIGINT)
            try:
                coord.wait(timeout=30)
            except subprocess.TimeoutExpired:
                coord.kill()
                coord.wait()
        lost_s = exits[1] - exits[0]
        out["c"] = {"leader_exit_s": exits[0], "follower_exit_s": exits[1],
                    "follower_after_leader_s": lost_s}
        if ("leader_lost" not in logs[1]
                or not 0 <= lost_s < LEADER_LOST_BOUND_S):
            raise AssertionError(f"fault (c): the follower left {lost_s:.3f}"
                                 f" s after the leader:\n{logs[1][-3000:]}")
        log(f"fault (c) sweep_serve under --coordinator-only, leader "
            f"killed at its launch {FAULT_LEADER_KILL}: the follower exited 0 "
            f"with leader_lost {lost_s:.3f} s after the leader died", card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    merged = by_shape_counts(parts)
    require_launches("Fault", {n: c["launches"] for n, c in merged.items()},
                     ("gram_batched", "qent_histogram_sweep",
                      "qdq_sse_sweep"))
    log("Fault launches " + json.dumps(
        {n: {str(k): v for k, v in c["by_shape"].items()}
         for n, c in merged.items() if c["launches"]}), card)
    return out, merged


def stream_run(torch, ST, src, name, epss, cfg, prefetch, quality,
               digest=None):
    """One streamed sweep of a variable: (result, wall s, peak device
    bytes above what was allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = ST.stream_features(
        src, name, epss, cfg, digest=digest, quality=quality, device="cuda",
        stream=ST.StreamConfig(budget_bytes=int(STREAM_BUDGET_MB * 2 ** 20),
                               prefetch=prefetch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return out, wall, torch.cuda.max_memory_allocated() - base


def in_memory_run(torch, P, src, name, epss, cfg, quality):
    """The whole variable read, put on the card and swept at once."""
    x = torch.from_numpy(src.read(name)).to("cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = P.features_sweep(x, epss, cfg, quality=quality)
    out = (tuple(o.cpu().numpy() for o in out) if quality
           else out.cpu().numpy())
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    del x
    return out, wall, peak


def same_bits(what, got, want):
    """Raise unless ``got`` (an array or a tuple of them) has ``want``'s
    shapes and bits."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape or g.tobytes() != w.tobytes():
            raise AssertionError(f"{what}: differs bit-wise from the result "
                                 "it must equal")


def stream_rows(torch, src, name2d, vol_name, ebs):
    """Gram, q-ent and quality at the shapes phase 14's streams launch
    them with: a chunk of slices (the ragged last one is padded to it)
    and a chunk of volumes at the stream budget, the first of each read
    from the dataset, each against its plain version and timed as in
    phase 12."""
    budget = int(STREAM_BUDGET_MB * 2 ** 20)
    ebs_t = torch.tensor(ebs, dtype=torch.float32, device="cuda")
    x = torch.from_numpy(src.read_rows(
        name2d, 0, src.chunk_rows(name2d, budget))).to("cuda")
    rows = [gram_row(torch, x - x.mean(dim=1, keepdim=True), 5)]
    flat = x.reshape(x.shape[0], -1)
    rows.append(qent_row(torch, flat, ebs_t, 5))
    rows.append(quality_row(torch, flat, ebs_t, 10))
    del x, flat
    v = torch.from_numpy(src.read_rows(
        vol_name, 0, src.chunk_rows(vol_name, budget))).to("cuda")
    vc = v - v.mean(dim=(1, 2, 3), keepdim=True)
    del v
    k, d, m, _ = vc.shape
    for u in (vc.reshape(k, d, -1), torch.movedim(vc, 2, 1).reshape(k, m, -1)):
        rows.append(gram_row(torch, u, 5, transpose=False, scaled=True))
    del vc
    return rows


def by_shape_counts(parts) -> dict:
    """Launches a child process reported, each part {kernel: {shape as
    text: launches}}, summed into one path's counts as
    :func:`read_counts` returns them."""
    import ast
    from repro_torch.kernels import wrappers
    out = {name: {"launches": 0, "by_shape": {}} for name in wrappers()}
    for part in parts:
        for name, shapes in part.items():
            for sh, c in shapes.items():
                key = ast.literal_eval(sh)
                out[name]["by_shape"][key] = out[name]["by_shape"].get(
                    key, 0) + c
                out[name]["launches"] += c
    return out


def advise_counts(what: str, launches: dict) -> dict:
    """The advise CLI's launches over all its variables, training and
    sweep, as one path's counts; raises if its training launched no
    Lorenzo or ZFP on the 2-D variable, or a variable's sweep no Gram,
    q-ent or quality."""
    for name, var in launches.items():
        require_launches(f"{what}'s sweep of {name}", var["sweep"],
                         ("gram_batched", "qent_histogram_sweep",
                          "qdq_sse_sweep"))
    require_launches(f"{what}'s training on {STREAM_FIELD}",
                     launches[STREAM_FIELD]["train"],
                     ("lorenzo2d", "zfp_forward2d"))
    log(f"{what} launches " + json.dumps(
        {n: {p: var[p] for p in ("train", "sweep")}
         for n, var in launches.items()}))
    return by_shape_counts(phase for var in launches.values()
                           for phase in var["by_shape"].values())


def advise_args(dataset) -> list:
    """The advise CLI's arguments on phase 14's dataset (phase 17 adds
    its mesh and process-group options to them)."""
    return [str(dataset), "--targets", "4,8,16", "--compressors",
            "sz2,sz3-lorenzo,zfp", "--psnr-floor", "60", "--budget-mb",
            str(STREAM_BUDGET_MB), "--train-rows", str(ADVISE_TRAIN_ROWS),
            "--use-kernels", "--device", "cuda"]


def phase_stream(torch, ebs, vol_eps, card, profile, tmp):
    """Phase 14: a memmap dataset on disk under ``tmp``, streamed and
    advised on.  Leaves in ``tmp`` what phase 17 holds its own streams
    and advise reports to: the dataset (``ds``), the in-memory sweeps
    (``want_2d.npz``, ``want_vol.npy``) and the direct advise report
    (``report.json``).  Returns (record, launch counts of the streams and
    of the two advise runs by path, kernel rows at the streams' shapes)."""
    from repro_torch.core import predictors as P
    from repro_torch.core import stream as ST
    from repro_torch.data import source as SRC
    from repro_torch.launch import advise as ADV
    from repro_torch.serve.method import AdviseMethod, slice_digest
    out = {}
    vol_name = VOL_FIELD + "-vol"
    gen = SRC.GeneratorSource(
        [SRC.FieldVariable(STREAM_FIELD, N_STREAM, (STREAM_N,)),
         SRC.FieldVariable(VOL_FIELD, N_STREAM_VOL, VOL_SHAPE)],
        device="cuda")
    t = time.perf_counter()
    path = SRC.write_dataset(
        os.path.join(tmp, "ds"), gen,
        dtype={STREAM_FIELD: "float64", vol_name: "float32"})
    out["write_s"] = time.perf_counter() - t
    src = SRC.open_dataset(path)
    disk = {n: os.path.getsize(os.path.join(path, n + ".bin"))
            for n in src.variables()}
    log(f"stream dataset: {dict(zip(src.variables(), (src.meta(n).shape for n in src.variables())))}, "
        f"{sum(disk.values()) / 1e9:.3f} GB on disk, written in "
        f"{out['write_s']:.2f} s", card)
    kernel_cfg = P.PredictorConfig(use_kernels=True)
    budget = int(STREAM_BUDGET_MB * 2 ** 20)
    chunks = {n: [min(src.chunk_rows(n, budget), src.meta(n).rows - lo)
                  for lo in range(0, src.meta(n).rows,
                                  src.chunk_rows(n, budget))]
              for n in src.variables()}
    log(f"stream chunks at {STREAM_BUDGET_MB} MiB: {chunks}")

    # the streams, counters read around them
    zero_counts(torch)
    runs = {}
    # prefetch 2 and 0 in turns (2, 0, 0, 2), none hashing its chunks
    for key, depth in (("2d_prefetch2", 2), ("2d_prefetch0", 0),
                       ("2d_prefetch0_again", 0),
                       ("2d_prefetch2_again", 2)):
        runs[key] = stream_run(torch, ST, src, STREAM_FIELD, ebs,
                               P.PredictorConfig(), depth, True)
    digest = SRC.StreamingDigest()
    runs["2d_kernels_digest"] = stream_run(
        torch, ST, src, STREAM_FIELD, ebs, kernel_cfg, 2, True, digest)
    vdigest = SRC.StreamingDigest()
    runs["vol"] = stream_run(torch, ST, src, vol_name, [vol_eps],
                             P.PredictorConfig(), 2, False, vdigest)
    counts = read_counts(torch, "Stream", (
        "gram_batched", "qent_histogram_sweep", "qdq_sse_sweep"))
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            _, wall, _ = stream_run(torch, ST, src, STREAM_FIELD, ebs,
                                    P.PredictorConfig(), 2, True)
        out["profile"] = profile_summary(torch, prof, wall, card)

    # the in-memory sweeps they must equal, bit for bit
    want2d, mem_s, mem_peak = in_memory_run(torch, P, src, STREAM_FIELD,
                                            ebs, P.PredictorConfig(), True)
    for key in ("2d_prefetch2", "2d_prefetch0", "2d_prefetch0_again",
                "2d_prefetch2_again"):
        same_bits(f"2-D, {key}", runs[key][0], want2d)
    want_k, mem_k_s, _ = in_memory_run(torch, P, src, STREAM_FIELD, ebs,
                                       kernel_cfg, True)
    same_bits("2-D, use_kernels", runs["2d_kernels_digest"][0], want_k)
    want_v, mem_v_s, mem_v_peak = in_memory_run(
        torch, P, src, vol_name, [vol_eps], P.PredictorConfig(), False)
    same_bits("volumes", runs["vol"][0], want_v)
    np.savez(os.path.join(tmp, "want_2d.npz"), features=want2d[0],
             quality=want2d[1])
    np.save(os.path.join(tmp, "want_vol.npy"), want_v)
    for n, d in ((STREAM_FIELD, digest), (vol_name, vdigest)):
        if d.digest() != slice_digest(src.read(n)):
            raise AssertionError(f"{n}: streaming digest != slice_digest")
    log("stream: every streamed result bit-equal to the in-memory sweep "
        "(2-D with quality at prefetch 2 and 0 and under use_kernels; "
        "volumes); streaming digests == slice_digest (hashed in the "
        "use_kernels and volume streams)")
    for key, (_, wall, peak) in runs.items():
        name = vol_name if key == "vol" else STREAM_FIELD
        meta = src.meta(name)
        out[key] = {"wall_s": wall, "rows_per_s": meta.rows / wall,
                    "gb_read_per_s": disk[name] / wall / 1e9,
                    "peak_gib": peak / 2 ** 30}
        log(f"stream {key}: {wall:.3f} s, {meta.rows / wall:.2f} rows/s, "
            f"{disk[name] / wall / 1e9:.3f} GB/s read, peak device "
            f"memory {peak / 2 ** 30:.2f} GiB", card)
    out["in_memory"] = {"2d_s": mem_s, "2d_kernels_s": mem_k_s,
                        "vol_s": mem_v_s, "2d_peak_gib": mem_peak / 2 ** 30,
                        "vol_peak_gib": mem_v_peak / 2 ** 30}
    log(f"in-memory sweeps: 2-D {mem_s:.3f} s (use_kernels {mem_k_s:.3f} "
        f"s), volumes {mem_v_s:.3f} s; peak device memory 2-D "
        f"{mem_peak / 2 ** 30:.2f} GiB, volumes "
        f"{mem_v_peak / 2 ** 30:.2f} GiB", card)
    del want_k, want_v
    rows = stream_rows(torch, src, STREAM_FIELD, vol_name, ebs)

    # the advise CLI as a user runs it, launches counted around it
    report_path = os.path.join(tmp, "report.json")
    launches_path = os.path.join(tmp, "launches.json")
    cmd = [sys.executable, "-c", ADVISE_CHILD, launches_path,
           *advise_args(path), "--out", report_path]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # the subprocess's compressor runs need tens of GiB of the card:
    # hand back what this process's allocator holds cached
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"advise starts with {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} "
        f"GiB of the card free ({torch.cuda.memory_allocated() / 2 ** 30:.2f}"
        " GiB allocated by this process)")
    t = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=ADVISE_TIMEOUT_S)
    out["advise_s"] = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"advise exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(report_path) as f:
        report = json.load(f)
    with open(launches_path) as f:
        launches = json.load(f)
    for line in proc.stdout.strip().splitlines():
        log(f"advise | {line}")
    for name, var in report["variables"].items():
        nums = [c for cs in var["cr_by_compressor"].values() for c in cs]
        nums += var["psnr_by_eb"]
        for rec in var["targets"].values():
            nums += [rec["eb"], rec["predicted_cr"], rec["predicted_psnr"]]
        if not np.all(np.isfinite(nums)):
            raise AssertionError(f"advise: non-finite report for {name}")
    paths = {"Advise": advise_counts("advise", launches)}
    # its 2-D CRs from the same models on the in-memory features
    var = report["variables"][STREAM_FIELD]
    models, aebs, _ = ADV.train_models(
        src, STREAM_FIELD, compressors=["sz2", "sz3-lorenzo", "zfp"],
        grid_rels=ADV.DEFAULT_GRID_RELS, train_rows=ADVISE_TRAIN_ROWS,
        cfg=kernel_cfg, device="cuda")
    feats = P.features_sweep(torch.from_numpy(src.read(STREAM_FIELD)).to(
        "cuda"), aebs, kernel_cfg).cpu().numpy()
    var_cr = ADV.harmonic_cr(AdviseMethod.cr_table(models, feats))
    for ci, comp in enumerate(models):
        if var["cr_by_compressor"][comp] != [float(c) for c in var_cr[ci]]:
            raise AssertionError(
                f"advise {comp}: CRs {var['cr_by_compressor'][comp]} != "
                f"cr_table on the in-memory features {var_cr[ci].tolist()}")
    log(f"advise: {out['advise_s']:.2f} s wall; report finite; "
        f"{STREAM_FIELD} CRs == cr_table on the in-memory features", card)
    # the same CLI with each chunk served by an in-process
    # SweepService, its launches counted the same way
    svc_path = os.path.join(tmp, "report_service.json")
    svc_launches_path = os.path.join(tmp, "launches_service.json")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", ADVISE_CHILD, svc_launches_path,
         *advise_args(path), "--service", "--out", svc_path], env=env,
        capture_output=True, text=True, timeout=ADVISE_TIMEOUT_S)
    out["advise_service_s"] = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"advise --service exited {proc.returncode}:"
                             f"\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    with open(svc_path) as f:
        served = json.load(f)
    with open(svc_launches_path) as f:
        svc_launches = json.load(f)
    paths["Advise --service"] = advise_counts("advise --service",
                                              svc_launches)
    if served != report:
        diff = [n for n in report["variables"]
                if served["variables"].get(n) != report["variables"][n]]
        raise AssertionError(f"advise --service report differs from the "
                             f"direct one in {diff}")
    log(f"advise --service: {out['advise_service_s']:.2f} s wall; report "
        "== the direct advise report", card)
    out["advise_report"] = report
    out["advise_launches"] = launches
    out["advise_service_launches"] = svc_launches
    return out, dict(Stream=counts, **paths), rows


def phase_serve_cli(card) -> dict:
    """Phase 16: the load CLI (``python -m repro_torch.launch.sweep_serve``)
    in a subprocess at the main path's width: a finite report, ZFP
    launched in its training and Gram in its serving.  Returns (report,
    its training's and serving's launches by shape, as one path's)."""
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="serve_cli_", dir=build)
    try:
        path = os.path.join(tmp, "serve.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.sweep_serve",
               "--fields", FIELD, "--n", str(SERVE_CLI_N), "--train-slices",
               "10", "--compressor", "zfp", "--clients", "8", "--requests",
               "64", "--device", "cuda", "--out", path]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=SERVE_CLI_TIMEOUT_S)
        wall = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"sweep_serve exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(path) as f:
            report = json.load(f)
        for line in proc.stdout.strip().splitlines():
            log(f"sweep_serve | {line}")
        nums = [report[k] for k in ("wall_s", "req_per_s", "p50_ms", "p95_ms",
                                    "p99_ms", "max_ms", "train_s")]
        if report["requests"] != 64 or not np.all(np.isfinite(nums)):
            raise AssertionError(f"sweep_serve: bad report {nums}")
        require_launches("sweep_serve's training", report["launches_train"],
                         ("zfp_forward2d",))
        require_launches("sweep_serve's serving", report["launches_serve"],
                         ("gram_batched",))
        log(f"sweep_serve: {wall:.2f} s wall; report finite; zfp launched "
            f"{report['launches_train']['zfp_forward2d']} times in training",
            card)
        report.pop("stats")
        return (dict(report, cli_wall_s=wall),
                by_shape_counts(report["launches_by_shape"].values()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dist_child(job_file: str) -> int:
    """Phase 17's process-group member (``--dist-child JOB``): joins the
    group its job file names, runs the job's parts on its device -- the
    training sweep SPMD and process-local (also split into the blocks'
    sweep and the gather), the volumes, a 2-slice batch, the training
    tables and the streams -- holds each result to the single-device one
    the parent left in the job's directory, bit for bit, and writes its
    wall times and its kernels' launches by shape."""
    import torch
    from repro_torch import compressors as C
    from repro_torch import kernels as K
    from repro_torch.core import predictors as P
    from repro_torch.core import stream as ST
    from repro_torch.data import scientific as TS
    from repro_torch.data import source as SRC
    from repro_torch.dist import sweep as DS
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as M
    job = json.loads(Path(job_file).read_text())
    # a wedged collective prints every thread's stack before the parent
    # kills the group
    faulthandler.dump_traceback_later(DIST_TIMEOUT_S - 30, exit=True)
    d, dev = Path(job["dir"]), torch.device(job["device"])
    built = all(_build.library_path(n).exists() for n in _build.KERNELS)
    cfg = P.PredictorConfig(use_kernels=True)
    ebs, times = np.asarray(job["ebs"]), {}

    def timed(key, fn):
        if dev.type != "cpu":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        res = fn()
        if dev.type != "cpu":
            torch.cuda.synchronize(dev)
        times[key] = time.perf_counter() - t
        return res

    timed("init_s", lambda: M.dist_init(
        job["init"], num_processes=job["nprocs"], process_id=job["rank"],
        backend=job["backend"], device=dev,
        init_timeout_s=DIST_COLLECTIVE_TIMEOUT_S))
    before = K.launch_counts()
    # the mesh's build is the group's first collective (NCCL sets up its
    # communicator there)
    mesh = timed("mesh_s", lambda: M.make_sweep_mesh(
        devices=[dev] * job["shards"]))

    def sweep(x, grid, **kw):
        return DS.features_sweep_sharded(x, grid, cfg, mesh=mesh, mode="both",
                                         **kw)

    def both_ways(what, x, grid, want):
        """SPMD and process-local sweeps of ``x``, each == ``want``."""
        k = x.shape[0]
        lo, hi = DS.process_block(k, mesh)
        same_bits(f"{what} SPMD", timed(
            f"{what}_spmd_s", lambda: sweep(x, grid).cpu().numpy()), want)
        same_bits(f"{what} process-local", timed(
            f"{what}_local_s", lambda: sweep(x[lo:hi], grid, process_local=True,
                                              global_k=k).cpu().numpy()), want)

    spec = TS.FIELDS[FIELD]
    train = TS.field_slices(FIELD, count=N_TRAIN + N_TEST, n=spec.full_n,
                            seed=0, device=dev)[:N_TRAIN]
    want = np.load(d / "dist_train.npy")
    both_ways("train", train, ebs, want)
    out = timed("train_blocks_s", lambda: sweep(train, ebs, gather=False))
    rows = timed("train_gather_s", lambda: DS.gather_rows(out))
    same_bits("train blocks gathered", rows[:N_TRAIN], want)
    if "more" in job["parts"]:
        vols = torch.stack([TS.volume(VOL_FIELD, VOL_SHAPE, seed=s, device=dev)
                            for s in range(N_DIST_VOL)])
        both_ways("volumes", vols, job["vol_grid"], np.load(d / "dist_vol.npy"))
        del vols
        both_ways("pair", train[:2], ebs, want[:2])
        for name in DIST_CRS:
            table = timed(f"crs_{name}_s", lambda: DS.training_crs(
                C.get(name), train, ebs, mesh=mesh))
            same_bits(f"training_crs {name}", table,
                         np.load(d / f"crs_{name}.npy"))
        src = SRC.open_dataset(job["dataset"])
        budget = ST.StreamConfig(budget_bytes=int(STREAM_BUDGET_MB * 2 ** 20))
        feats, qual = timed("stream_2d_s", lambda: ST.stream_features(
            src, STREAM_FIELD, ebs, P.PredictorConfig(), mesh=mesh,
            quality=True, device=dev, stream=budget))
        with np.load(d / "want_2d.npz") as w:
            same_bits("2-D stream", feats, w["features"])
            same_bits("2-D stream quality", qual, w["quality"])
        same_bits("volume stream", timed("stream_vol_s", lambda: (
            ST.stream_features(src, VOL_FIELD + "-vol", [job["vol_eps"]],
                               P.PredictorConfig(), mesh=mesh, device=dev,
                               stream=budget))), np.load(d / "want_vol.npy"))
    total, by_shape = K.launches_since(before)
    Path(job["out"]).write_text(json.dumps(
        {"times": times, "launches": total, "by_shape": by_shape,
         "shares": list(mesh.shares), "libraries_found": built}))
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def run_group(what: str, cmds, logs_dir: Path, timeout: float,
              expect: dict | None = None, exits: dict | None = None,
              logs: dict | None = None) -> float:
    """Start ``cmds`` together (one process each, output to files under
    ``logs_dir``), wait for all within ``timeout`` s and raise if one
    exits with another code than ``expect`` gives it (default 0) or the
    time runs out; every process is gone on return.  Returns the wall
    time; ``exits`` gets each process's exit time (s after the start),
    ``logs`` its output.  Each process gets its share of the host's
    cores for its thread pools, as ``torchrun`` gives its ranks: ranks
    that each spin up a pool of every core starve each other's CPU work
    (LAPACK's above all)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // len(cmds))))
    env.pop("REPRO_FAULT_INJECT", None)
    expect = expect or {}
    exits = {} if exits is None else exits
    procs, files = [], []
    t = time.perf_counter()
    try:
        for i, cmd in enumerate(cmds):
            files.append(open(logs_dir / f"{what.replace(' ', '_')}.{i}.log",
                              "w+"))
            procs.append(subprocess.Popen(cmd, env=env, stdout=files[-1],
                                          stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        while len(exits) < len(procs) and time.monotonic() < deadline:
            for i, p in enumerate(procs):
                if i not in exits and p.poll() is not None:
                    exits[i] = time.perf_counter() - t
            time.sleep(0.05)
        wall = time.perf_counter() - t
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = []
    for i, (p, f) in enumerate(zip(procs, files)):
        f.seek(0)
        text = f.read()
        if logs is not None:
            logs[i] = text
        tails.append(f"--- {what} process {i} (exit {p.returncode}) ---\n"
                     + text[-3000:])
        f.close()
    if any(p.returncode != expect.get(i, 0) for i, p in enumerate(procs)):
        raise AssertionError(f"{what} failed or ran past {timeout} s:\n"
                             + "\n".join(tails))
    return wall


def phase_dist(torch, ebs, vol_eps, tmp, crs_tables, card):
    """Phase 17: the sharded sweep layer on the card, in three forms of
    the training sweep (32 cesm-cloud slices of 1800^2, the main path's
    6-eb grid, ``use_kernels=True``, features and quality): (a) one
    process, a mesh of two shards on the card; (b) a one-rank NCCL group
    whose mesh has two shards on the card (the real NCCL init and
    all_gathers of CUDA tensors); (c) a two-rank gloo group, one shard
    each on the card, SPMD and process-local, also on 7 miranda-vx
    volumes and a 2-slice batch, with ``training_crs`` of sz3-lorenzo
    and zfp split between the ranks and the two streams of phase 14's
    dataset.  Then the advise CLI with ``--mesh cuda:0,cuda:0`` in one
    process and over a two-rank gloo group.  Every result is held bit
    for bit to the single-device one (the training tables to the main
    path's, the streams to phase 14's in-memory sweeps, the reports byte
    for byte to phase 14's).  Returns (record, the launches of all of it by shape,
    as the "Dist" path's)."""
    from repro_torch.core import predictors as P
    from repro_torch.data import scientific as TS
    from repro_torch.dist import sweep as DS
    from repro_torch.launch import mesh as M
    out, tmp = {}, Path(tmp)
    spec = TS.FIELDS[FIELD]
    kcfg = P.PredictorConfig(use_kernels=True)
    vol_grid = vol_eps * 10.0 ** np.linspace(-1.0, 0.25, 6)
    train = TS.field_slices(FIELD, count=N_TRAIN + N_TEST, n=spec.full_n,
                            seed=0, device="cuda")[:N_TRAIN]
    vols = torch.stack([TS.volume(VOL_FIELD, VOL_SHAPE, seed=s, device="cuda")
                        for s in range(N_DIST_VOL)])

    def both(x, grid, **kw):
        return torch.cat(P.features_sweep(x, grid, kcfg, quality=True, **kw),
                         dim=-1)

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    # the single-device results every form is held to, left for the
    # children beside phase 14's dataset
    want = both(train, ebs, sharded=False).cpu().numpy()
    np.save(tmp / "dist_train.npy", want)
    np.save(tmp / "dist_vol.npy",
            both(vols, vol_grid, sharded=False).cpu().numpy())
    del vols
    for name in DIST_CRS:
        np.save(tmp / f"crs_{name}.npy", crs_tables[name][0])

    # (a) one process, two shards on the card; timed beside one device in
    # turns (one, two shards, two shards, one), then its blocks and their
    # gather alone, counters read around those two only
    mesh = M.make_sweep_mesh(devices=[DIST_DEVICE] * 2)
    runs = {"one device": [], "two shards": []}
    for key in ("one device", "two shards", "two shards", "one device"):
        got, s = wall(lambda: (both(train, ebs, sharded=False)
                               if key == "one device" else
                               both(train, ebs, mesh=mesh)).cpu().numpy())
        same_bits(f"(a) {key}", got, want)
        runs[key].append(s)
    zero_counts(torch)
    padded, out["a_blocks_s"] = wall(lambda: DS.features_sweep_sharded(
        train, ebs, kcfg, mesh=mesh, mode="both", gather=False))
    rows, out["a_gather_s"] = wall(lambda: DS.gather_rows(padded))
    same_bits("(a) blocks gathered", rows, want)
    out["a_sweep_s"] = runs
    counts = read_counts(torch, "Dist (a)", (
        "gram_batched", "qent_histogram_sweep", "qdq_sse_sweep"))
    parts = [{n: {str(k): v for k, v in c["by_shape"].items()}
              for n, c in counts.items()}]
    del train, padded, mesh
    gc.collect()
    torch.cuda.empty_cache()

    # (b) and (c): fresh interpreters (this process holds a CUDA
    # context), each group under its own wall-clock limit
    def child(role, nprocs, rank, backend, shards, parts_):
        job = {"init": f"file://{tmp / ('init_' + role)}", "nprocs": nprocs,
                "rank": rank, "backend": backend, "device": DIST_DEVICE,
                "shards": shards, "parts": parts_, "dir": str(tmp),
                "dataset": str(tmp / "ds"), "ebs": [float(e) for e in ebs],
                "vol_grid": [float(e) for e in vol_grid],
                "vol_eps": float(vol_eps),
                "out": str(tmp / f"dist_{role}_{rank}.json")}
        path = tmp / f"job_{role}_{rank}.json"
        path.write_text(json.dumps(job))
        return [sys.executable, str(Path(__file__).resolve()), "--dist-child",
                str(path)], Path(job["out"])

    for role, nprocs, backend, shards, parts_ in (
            ("b", 1, DIST_NCCL, 2, ["train"]),
            ("c", 2, "gloo", 1, ["train", "more"])):
        cmds, outs = zip(*[child(role, nprocs, r, backend, shards, parts_)
                           for r in range(nprocs)])
        out[f"{role}_wall_s"] = run_group(f"dist ({role})", cmds, tmp,
                                          DIST_TIMEOUT_S)
        out[role] = [json.loads(p.read_text()) for p in outs]
        parts += [r["by_shape"] for r in out[role]]
        for r in out[role]:
            if not r["libraries_found"]:
                raise AssertionError(f"dist ({role}): a child found the "
                                     "kernels unbuilt")

    # the advise CLI: two shards on the card in one process, and over two
    # gloo ranks
    report = (tmp / "report.json").read_bytes()
    two = ",".join([DIST_DEVICE] * 2)
    runs = {f"advise --mesh {two}": ("mesh", [["--mesh", two]]),
            "advise 2 ranks": ("ranks", [
                ["--coordinator", f"file://{tmp / 'init_adv'}",
                 "--num-processes", "2", "--process-id", str(r),
                 "--backend", "gloo"] for r in range(2)])}
    for what, (tag, extras) in runs.items():
        cmds, launch_files = [], []
        for r, extra in enumerate(extras):
            launch_files.append(tmp / f"launches_{tag}_{r}.json")
            cmds.append([sys.executable, "-c", ADVISE_CHILD,
                         str(launch_files[-1]), *advise_args(tmp / "ds"),
                         *extra, "--out", str(tmp / f"report_{tag}.json")])
        out[f"{what} s"] = run_group(what, cmds, tmp, ADVISE_TIMEOUT_S)
        if (tmp / f"report_{tag}.json").read_bytes() != report:
            raise AssertionError(f"{what}: report differs from the direct "
                                 "advise report")
        for r, f in enumerate(launch_files):
            launches = json.loads(f.read_text())
            advise_counts(f"{what} (rank {r})", launches)
            parts += [phase for var in launches.values()
                      for phase in var["by_shape"].values()]
        log(f"{what}: {out[f'{what} s']:.2f} s wall; report == the direct "
            "advise report, byte for byte", card)
    merged = by_shape_counts(parts)
    require_launches("Dist", {n: c["launches"] for n, c in merged.items()},
                     ("gram_batched", "qent_histogram_sweep", "qdq_sse_sweep",
                      "lorenzo2d", "zfp_forward2d"))
    log("dist: (a), (b) and (c) bit-equal to one device (sweeps, volumes, "
        "the pair, training tables, streams); " + json.dumps(
            {k: v for k, v in out.items() if k not in ("b", "c")}), card)
    for role in ("b", "c"):
        for r, res in enumerate(out[role]):
            log(f"dist ({role}) rank {r} shares {res['shares']}: "
                + json.dumps({k: round(v, 4) for k, v in res["times"].items()}),
                card)
    return out, merged


def eps_for(grid, e: int) -> list:
    """``e`` ebs for a launch of that width: the grid's second eb alone
    (the UC queries'), the grid's first ``e``, or, wider than the grid,
    the grid with its geometric midpoints (an eb union) padded with its
    last eb (an eb bucket)."""
    g = [float(v) for v in grid]
    if e == 1:
        return [g[1]]
    if e <= len(g):
        return g[:e]
    both = sorted(g + [float(np.sqrt(a * b)) for a, b in zip(g, g[1:])])
    return (both + [both[-1]] * e)[:e]


def path_rows(torch, TS, counts, rows, ebs, vol_eps):
    """Every kernel at every shape a path launched it with that no row
    above holds -- Serve's own batches and its warmup's, the advise
    CLI's training and its ``--service`` chunks padded to their row
    buckets, the load CLI's training and serving -- against its plain
    version at the tolerance of its kind and timed as in phase 12, on
    fresh cesm-cloud slices of 1800^2 (cut to a smaller shape; a batch
    larger than the pool repeats it, as a padded launch repeats its
    last row) and miranda-vx volumes."""
    have = {(r["name"].split(" ")[0], tuple(r["shape"])) for r in rows}
    todo = sorted({(kernel, shape) for c in counts.values()
                   for kernel, kc in c.items() for shape in kc["by_shape"]
                   if (kernel, tuple(shape)) not in have}, key=str)
    log(f"path rows: {len(todo)} shapes launched that no row held: "
        + json.dumps([f"{k} {s}" for k, s in todo]))
    if not todo:
        return []
    spec = TS.FIELDS[FIELD]
    pool = TS.field_slices(FIELD, count=N_TEST, n=spec.full_n, seed=0,
                           device="cuda")
    vols = []
    vol_grid = vol_eps * 10.0 ** np.linspace(-1.0, 0.25, 6)

    def slices_k(k, m, n):
        idx = torch.arange(k, device=pool.device) % pool.shape[0]
        return pool[idx, :m, :n].contiguous()

    def vols_k(k):
        if not vols:
            vols.append(torch.stack([TS.volume(VOL_FIELD, VOL_SHAPE, seed=s,
                                               device="cuda")
                                     for s in range(4)]))
        idx = torch.arange(k, device=pool.device) % vols[0].shape[0]
        return vols[0][idx].contiguous()

    def flat_k(k, nel):
        """(k, nel) rows and the eb grid of their data."""
        if nel == int(np.prod(VOL_SHAPE)):
            return vols_k(k).reshape(k, -1), vol_grid
        r = math.isqrt(nel)
        if r * r == nel and r <= pool.shape[1]:
            return slices_k(k, r, r).reshape(k, -1), ebs
        full = slices_k(k, pool.shape[1], pool.shape[2]).reshape(k, -1)
        return full[:, :nel].contiguous(), ebs

    def f32(vals):
        return torch.tensor(vals, dtype=torch.float32, device="cuda")

    out = []
    for kernel, shape in todo:
        if kernel == "gram_batched":
            k, m, n, tr = shape
            if tr:
                x = slices_k(k, m, n)
                x = x - x.mean(dim=1, keepdim=True)
            else:
                v = vols_k(k)
                v = v - v.mean(dim=(1, 2, 3), keepdim=True)
                d0, d1, d2 = VOL_SHAPE
                if (m, n) == (d0, d1 * d2):
                    x = v.reshape(k, m, n)
                elif (m, n) == (d1, d0 * d2):
                    x = torch.movedim(v, 2, 1).reshape(k, m, n)
                else:
                    raise AssertionError(f"no input for gram at {shape}")
                del v
            out.append(gram_row(torch, x, 5, cold=k == 1, transpose=tr,
                                scaled=not tr))
        elif kernel == "qent_histogram_sweep":
            k, nel, e, bins = shape
            flat, grid = flat_k(k, nel)
            out.append(qent_row(torch, flat, f32(eps_for(grid, e)), 5,
                                cold=k == 1, bins=bins))
        elif kernel == "qdq_sse_sweep":
            k, nel, e = shape
            flat, grid = flat_k(k, nel)
            out.append(quality_row(torch, flat, f32(eps_for(grid, e)), 10))
        elif kernel == "lorenzo2d":
            out.append(lorenzo_row(torch, slices_k(1, *shape)[0],
                                   float(ebs[1])))
        elif kernel == "zfp_forward2d":
            out.append(zfp_row(torch, slices_k(1, *shape)[0]))
        else:
            raise AssertionError(f"no row for kernel {kernel}")
        x = flat = None
    del pool, vols
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full record as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="trace the main path with torch.profiler and "
                         "report the device's busy and idle time")
    ap.add_argument("--dist-child", metavar="JOB", help=argparse.SUPPRESS)
    ap.add_argument("--fabric-child", metavar="JOB", help=argparse.SUPPRESS)
    ap.add_argument("--fault-child", metavar="JOB", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dist_child:
        return dist_child(args.dist_child)
    if args.fabric_child:
        return fabric_child(args.fabric_child)
    if args.fault_child:
        return fault_child(args.fault_child)
    t_script = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    from repro_torch import compressors as C
    from repro_torch.compressors import lossless
    from repro_torch.core import predictors as P
    from repro_torch.core import usecases as UC
    from repro_torch.data import scientific as TS
    from repro_torch.dist import sweep as DS
    from repro_torch.kernels import _build, wrappers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"lossless stage: {lossless.BACKEND})")
    stages = {}

    t = time.perf_counter()
    _build.build()
    stages["build_s"] = time.perf_counter() - t
    log(f"build: {len(_build.KERNELS)} kernels in {stages['build_s']:.2f} s",
        smi)

    spec = TS.FIELDS[FIELD]
    t = time.perf_counter()
    data = TS.field_slices(FIELD, count=N_TRAIN + N_TEST, n=spec.full_n,
                           seed=0, device="cuda")
    torch.cuda.synchronize()
    stages["data_s"] = time.perf_counter() - t
    train, test = data[:N_TRAIN], data[N_TRAIN:]
    ebs = spec.eps * 10.0 ** np.linspace(-0.5, 2.0, 6)   # ebs[1] == eps
    ebs_t = torch.tensor(ebs, dtype=torch.float32, device="cuda")
    log(f"data: {FIELD} {tuple(data.shape)} float32 on the card in "
        f"{stages['data_s']:.2f} s; eb grid {np.array2string(ebs, precision=3)}",
        smi)

    t = time.perf_counter()
    kernels = check_kernels(torch, train, test, ebs_t)
    stages["kernel_checks_s"] = time.perf_counter() - t
    for row in kernels:
        log(f"kernel {row['name']}: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})", smi)
    kernel_cfg = P.PredictorConfig(use_kernels=True)
    stages.update(sweep_breakdown(torch, P.get_engine(kernel_cfg), train,
                                  ebs_t, smi))
    check_small(torch, P, TS)
    qent_routes = check_qent_routes(torch, P, train, ebs)
    early_peak = torch.cuda.max_memory_allocated()   # phase 4c resets it
    sort_cost = sort_route_cost(torch, P, train, ebs_t, smi)

    # ---- phase 5: the main path, counters read around it
    zero_counts(torch)
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    t_main = time.perf_counter()
    models = {}
    # each training's CR table and its wall time, kept for phase 17
    crs_tables, training_crs = {}, DS.training_crs

    def kept_crs(comp, slices, grid, **kw):
        t = time.perf_counter()
        table = training_crs(comp, slices, grid, **kw)
        crs_tables[comp.name] = (table, time.perf_counter() - t)
        return table

    DS.training_crs = kept_crs
    try:
        for name in C.STUDY_2D:
            t = time.perf_counter()
            models[name] = UC.EbGridModel.train(train, name, ebs,
                                                cfg=kernel_cfg)
            stages[f"train_{name}_s"] = time.perf_counter() - t
            log(f"train {name}: {stages[f'train_{name}_s']:.2f} s", smi)
    finally:
        DS.training_crs = training_crs
    lorenzo = models["sz3-lorenzo"]
    target = lorenzo.predict(test[0], float(ebs[2]))   # a CR inside the grid
    psnr_floor = float(lorenzo.quality.mean_psnr[2])
    uc1, uc2, uc3 = [], [], []
    uc_predictions = {}
    t = time.perf_counter()
    with PredictionCount() as n_pred:
        for i in range(N_TEST):
            uc1.append(UC.find_error_bound_for_cr(lorenzo, test[i], target))
    stages["uc1_s"] = time.perf_counter() - t
    uc_predictions["uc1"] = n_pred.n
    t = time.perf_counter()
    with PredictionCount() as n_pred:
        for i in range(N_TEST):
            uc2.append(UC.best_compressor(
                {n: m.models[1] for n, m in models.items()}, test[i],
                float(ebs[1])))
    stages["uc2_s"] = time.perf_counter() - t
    uc_predictions["uc2"] = n_pred.n
    t = time.perf_counter()
    with PredictionCount() as n_pred:
        for i in range(N_TEST):
            uc3.append(UC.find_setting(models, test[i], cr_floor=2.0,
                                       psnr_floor=psnr_floor))
    stages["uc3_s"] = time.perf_counter() - t
    uc_predictions["uc3"] = n_pred.n
    torch.cuda.synchronize()
    stages["main_path_s"] = time.perf_counter() - t_main
    counts = {"main path": read_counts(torch, "main path", wrappers())}
    profiled = None
    if prof is not None:
        prof.__exit__(None, None, None)
        profiled = profile_summary(torch, prof, stages["main_path_s"], smi)
    log(f"main path: {stages['main_path_s']:.2f} s; UC1 / UC2 / UC3 "
        f"{stages['uc1_s']:.3f} / {stages['uc2_s']:.3f} / "
        f"{stages['uc3_s']:.3f} s over {N_TEST} slices, model predictions "
        + json.dumps(uc_predictions), smi)

    # ---- phase 6: held-out MedAPE (measured CRs run the compressors)
    t = time.perf_counter()
    names = list(C.STUDY_2D)
    measured = np.stack([DS.training_crs(C.get(name), test, ebs)
                         for name in names])                # (c, k, e)
    caches = [P.get_engine(kernel_cfg).cached(test[i]) for i in range(N_TEST)]
    for cache in caches:
        cache.prefetch(ebs)
    apes = {}
    for c, name in enumerate(names):
        for i in range(N_TEST):
            for j, eb in enumerate(ebs):
                pred = models[name].predict(test[i], float(eb), caches[i])
                if not np.isfinite(pred) or pred <= 0:
                    raise AssertionError(f"bad predicted CR {pred} ({name})")
                apes.setdefault(name, []).append(
                    100.0 * abs(pred - measured[c, i, j]) / measured[c, i, j])
    stages["heldout_measure_s"] = time.perf_counter() - t
    medape = {n: float(np.median(v)) for n, v in apes.items()}
    uc1_true = [float(C.get("sz3-lorenzo").cr(test[i], eb))
                for i, (eb, _) in enumerate(uc1)]
    uc1_err = float(np.median([100.0 * abs(c - target) / target
                               for c in uc1_true]))
    best_true = [names[int(np.argmax(measured[:, i, 1]))]
                 for i in range(N_TEST)]
    uc2_agree = sum(b == p for b, (p, _) in zip(best_true, uc2))
    # the CR given up by taking UC2's pick instead of the measured best
    uc2_loss = [100.0 * (1.0 - measured[names.index(p), i, 1]
                         / measured[:, i, 1].max())
                for i, (p, _) in enumerate(uc2)]
    feasible = sum(s.feasible for s in uc3)
    if len(medape) != len(names):
        raise AssertionError(f"MedAPE for {sorted(medape)} only")
    for v in list(medape.values()) + [uc1_err]:
        if not np.isfinite(v):
            raise AssertionError("non-finite held-out error")
    log(f"held-out MedAPE % {json.dumps(medape)}")
    log(f"UC1 target CR {target:.3f}: median |true - target| / target "
        f"{uc1_err:.2f}% over {N_TEST} slices")
    log(f"UC2 predicted best of {len(names)} == measured best on "
        f"{uc2_agree}/{N_TEST} slices (measured best: "
        f"{sorted(set(best_true))}, predicted: {sorted({p for p, _ in uc2})}); "
        f"measured CR given up by the pick: median "
        f"{np.median(uc2_loss):.2f}%, max {max(uc2_loss):.2f}%")
    log(f"UC3 PSNR >= {psnr_floor:.2f} dB and CR >= 2: feasible on "
        f"{feasible}/{N_TEST} slices, picks "
        f"{sorted({s.compressor for s in uc3})}")

    # ---- phase 7: sz2/sz3-regression card vs CPU; planted subnormals
    eps = float(ebs[1])
    t = time.perf_counter()
    check_regression_bits(torch, C, test[0], eps)
    check_planted(torch, test[0])
    stages["bits_checks_s"] = time.perf_counter() - t

    # ---- phases 8-11: the paper's studies, counters read around each
    studies = {}
    zero_counts(torch)
    t = time.perf_counter()
    studies["table5"], feats40, crs40 = study_table5(torch, data, eps,
                                                     kernel_cfg, smi)
    stages["table5_s"] = time.perf_counter() - t
    counts["Table 5"] = read_counts(torch, "Table 5", (
        "gram_batched", "qent_histogram_sweep", "lorenzo2d"))
    zero_counts(torch)
    t = time.perf_counter()
    studies["table3"], scale, scale_eps = study_table3(torch, feats40, crs40,
                                                       kernel_cfg, smi)
    stages["table3_s"] = time.perf_counter() - t
    counts["Table 3"] = read_counts(torch, "Table 3", (
        "gram_batched", "qent_histogram_sweep"))
    zero_counts(torch)
    t = time.perf_counter()
    studies["fig5"], gauss = study_fig5(torch, kernel_cfg, smi)
    stages["fig5_s"] = time.perf_counter() - t
    counts["Fig 5"] = read_counts(torch, "Fig 5", (
        "gram_batched", "qent_histogram_sweep", "zfp_forward2d"))
    zero_counts(torch)
    t = time.perf_counter()
    studies["table4"], vols, vol_eps, studies["table4_detail"] = study_table4(
        torch, kernel_cfg, smi)
    stages["table4_s"] = time.perf_counter() - t
    counts["Table 4"] = read_counts(torch, "Table 4", (
        "gram_batched", "qent_histogram_sweep"))

    # ---- phase 12: the kernels at the studies' shapes
    t = time.perf_counter()

    def centred(x):
        return x - x.mean(dim=1, keepdim=True)

    vc = vols - vols.mean(dim=(1, 2, 3), keepdim=True)
    f32 = dict(dtype=torch.float32, device="cuda")
    kernels += study_rows(torch, {
        "gram": [(centred(data), True), (centred(scale), True),
                 (centred(gauss), True), (vc.reshape(N_VOL, VOL_SHAPE[0], -1),
                                          False),
                 (torch.movedim(vc, 2, 1).reshape(N_VOL, VOL_SHAPE[1], -1),
                  False)],
        "qent": [(data.reshape(data.shape[0], -1), torch.tensor([eps], **f32)),
                 (scale.reshape(N_SCALE, -1), torch.tensor([scale_eps], **f32)),
                 (gauss.reshape(N_GAUSS, -1), torch.tensor([GAUSS_EPS], **f32)),
                 (vols.reshape(N_VOL, -1), torch.tensor([vol_eps], **f32))],
        "zfp": [gauss[0]]})
    stages["study_kernels_s"] = time.perf_counter() - t

    # ---- phase 13: a row's bits do not depend on its batch
    def picks(x, n):
        return sorted({int(i) for i in np.linspace(0, x.shape[0] - 1, n)})

    stages["batch_independence_s"], batch_probes = check_batch_independence(
        torch, [
        (f"{FIELD} slices", data, ebs, picks(data, 4)),
        (f"{SCALE_FIELD} slices", scale, [scale_eps], picks(scale, 3)),
        ("Gaussian type-4 samples", gauss, [GAUSS_EPS], picks(gauss, 3)),
        (f"{VOL_FIELD} volumes", vols, [vol_eps], picks(vols, 2))], smi)
    # ... nor on the eb grid it is launched with
    stages["eb_independence_s"], eb_probes = check_eb_independence(torch, [
        (f"{FIELD} slices", data[picks(data, 4)], ebs),
        (f"{VOL_FIELD} volumes", vols[picks(vols, 2)],
         vol_eps * 10.0 ** np.linspace(-1.0, 0.25, 6))], smi)
    # ... and a prediction is the same bits on the card as on the CPU
    stages["prediction_bits_s"] = check_prediction_bits(
        torch, models, test, ebs, psnr_floor, smi)
    peak_gb = max(early_peak, torch.cuda.max_memory_allocated()) / 2 ** 30

    # ---- phase 15: the sweep service, with phase 5's models and held-out
    # slices, counters read around its traffic
    t = time.perf_counter()
    served, counts["Serve"], directs = phase_serve(torch, models, test, ebs,
                                                   smi)
    stages["serve_phase_s"] = time.perf_counter() - t

    # ---- phase 18: the service on a mesh and across processes, with the
    # same models, traffic and direct calls
    (ROOT / "build").mkdir(exist_ok=True)
    t = time.perf_counter()
    fabric, counts["Fabric"] = phase_fabric(torch, models, test, ebs,
                                            directs, smi)
    stages["fabric_phase_s"] = time.perf_counter() - t

    # ---- phase 19: the service survives a lost process, same models,
    # traffic and direct calls
    t = time.perf_counter()
    fault, counts["Fault"] = phase_fault(torch, models, test, ebs, directs,
                                         smi)
    stages["fault_phase_s"] = time.perf_counter() - t

    # ---- phase 14: a dataset on disk, streamed and advised on; the
    # tensors of phases 1-13 go first, so that it and the advise
    # subprocess find the card free
    data_shape = list(data.shape)
    del data, train, test, caches, models, lorenzo, feats40, scale, gauss
    del vols, vc
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 14 starts with {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        "GiB allocated")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="stream_", dir=ROOT / "build")
    try:
        t = time.perf_counter()
        streamed, stream_counts, stream_kernels = phase_stream(
            torch, ebs, vol_eps, smi, args.profile, tmp)
        counts.update(stream_counts)
        kernels += stream_kernels
        stages["stream_phase_s"] = time.perf_counter() - t

        # ---- phase 16: the load CLI in a subprocess
        t = time.perf_counter()
        served["sweep_serve"], counts["Serve CLI"] = phase_serve_cli(smi)
        stages["serve_cli_s"] = time.perf_counter() - t

        # ---- phase 17: the sharded sweep layer, on phase 14's dataset
        t = time.perf_counter()
        dist, counts["Dist"] = phase_dist(torch, ebs, vol_eps, tmp,
                                          crs_tables, smi)
        dist["main_path_crs_s"] = {n: crs_tables[n][1] for n in DIST_CRS}
        stages["dist_phase_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- every shape a path launched that no row above holds: its
    # kernel against the plain version there, timed
    t = time.perf_counter()
    kernels += path_rows(torch, TS, counts, kernels, ebs, vol_eps)
    stages["path_rows_s"] = time.perf_counter() - t

    # every row's launches in each path that launched its shape; its
    # `launches` is the count of the first of them (the main path where it
    # launched the shape), never a sum over paths
    for row in kernels:
        shape = row.pop("shape")
        kernel = row["name"].split(" ")[0]
        row["launches_by_path"] = {
            p: c[kernel]["by_shape"][shape] for p, c in counts.items()
            if c[kernel]["by_shape"].get(shape, 0)}
        row["launches"] = next(iter(row["launches_by_path"].values()), 0)
        lib = row["library_ms"]
        log(f"kernel {row['name']}: max abs err {row['max_abs_err']:.3g} "
            f"({row['tolerance']}); {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); "
            f"launches by path {json.dumps(row['launches_by_path'])}", smi)

    stages["script_s"] = time.perf_counter() - t_script
    log("stages s " + json.dumps({k: round(v, 3) for k, v in stages.items()}),
        smi)
    log(f"peak device memory {peak_gb:.2f} GiB (phases 1-13)")

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            device=smi, torch=torch.__version__, lossless=lossless.BACKEND,
            field=FIELD, shape=data_shape, ebs=list(map(float, ebs)),
            compressors=names, stages=stages, kernels=kernels,
            qent_routes=qent_routes, medape=medape, uc1_err=uc1_err,
            uc1_target=target, uc2_agree=uc2_agree, uc2_best=best_true,
            uc2_pick=[p for p, _ in uc2], uc2_loss_pct=uc2_loss,
            measured_crs=measured.tolist(),
            uc3_feasible=feasible, peak_gib=peak_gb, profile=profiled,
            studies=studies, stream=streamed, batch_probes=batch_probes,
            eb_probes=eb_probes, serve=served, uc_predictions=uc_predictions,
            dist=dist, fabric=fabric, fault=fault, sort_route_cost=sort_cost,
            launches_by_path={
                p: {n: {"launches": c["launches"],
                        "by_shape": {str(k): v for k, v in c["by_shape"].items()}}
                    for n, c in cs.items()} for p, cs in counts.items()}),
            indent=1))
    log(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "launches_by_path", "max_abs_err",
                             "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "copy_ms") if k in row}
        for row in kernels]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
              form it replaced;
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
              ``sweep_padded`` bucket, at 1800^2 (2 of the 40), 1200^2 (3
              of the 24), 1028^2 (3 of a Gaussian 20) and 256 x 384 x
              384 (2 of the 12 volumes); the Gram alone equal to the Gram
              in its batch at each shape (volumes: both unfoldings); and,
              reported only, which library reductions the sweep used to
              run over the batch (std, mean, eigvalsh, cumsum, a float64
              sum, the entropy sum) give a row other bits in the batch.
              Then the eb grid: 1 slice at 1800^2 and 1 volume
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
              ``SweepService`` on the card: 8 client threads x 16
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
              prefetch 2 and 0 and under
              ``use_kernels=True``, the volumes under the default config,
              each bit-equal to one in-memory sweep of the variable on
              the card, the streaming digest (the last two streams hash
              their chunks) equal to ``slice_digest``; wall time, rows/s, GB/s
              read and peak device memory beside the in-memory sweep's.
              Gram, q-ent and quality at the shapes the streams launched
              them with (a chunk of 41 slices, one of 3 volumes, read
              from the dataset), against their plain versions and timed,
              as in phase 12.  Then the advise CLI on the dataset
              (trained on 2 rows of each variable) in this process (its
              ``main``, as ``python -m repro_torch.launch.advise`` runs
              it, with the launches of each variable's training and
              stream counted around the two calls; no process start-up
              to pay for): a finite report, launches of Lorenzo and ZFP in its
              training and of Gram, q-ent and quality in its stream, and
              the 2-D variable's CRs equal to ``AdviseMethod.cr_table`` on
              the in-memory features.  The same CLI with ``--service``
              (every chunk through an in-process ``SweepService``,
              counted the same way) gives the same report.  The tensors
              of phases 1-13 and 15 are freed before it.
16. serve CLI -- ``launch.sweep_serve.main`` (the CLI's code, in this
              process: a subprocess's start-up and library load cost
              the script time it lacks) at cesm-cloud 1800^2, zfp
              trained on 6 slices, 8 clients x 8 UC1/UC2 requests: a
              finite report, ZFP launched in its training and Gram in
              its serving, its launches by shape read from its report;
17. dist     -- the sharded sweep layer (``repro_torch.dist``) on the
              card, on the training sweep (32 cesm-cloud slices of
              1800^2, the 6-eb grid, ``use_kernels=True``, features and
              quality) in three forms: (a) this process, a mesh of two
              shards on the card, timed beside one device; (b)
              a one-rank NCCL group whose mesh has two shards on the
              card (NCCL refuses two ranks on one GPU); (c) a two-rank
              gloo group, one shard each on the card, SPMD and
              process-local, also on 7 miranda-vx volumes (blocks of 4
              rows, and of 3 + 1 pad) and a 2-slice batch (one-row
              blocks), ``training_crs`` of sz3-lorenzo and zfp split
              between the ranks, and phase 14's two streams under the
              group.  (b) and (c) run in fresh interpreters (``--dist-child``),
              each group under its own wall-clock limit.  Then the advise
              CLI with ``--mesh cuda:0,cuda:0`` in this process and over a
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
20. tune     -- (run right after 19) the q-ent kernel's offline launch
              search on the card (``kernels/tune.py``; its candidate
              builds, ``-DREPRO_QENT_MIN_PER_CTA``, compiled with the
              kernels at the start): (a) the smoke search (one cell,
              every candidate through the bit filter, timed); (b) every
              candidate's histograms equal to the plain build's at each
              shape of the full search, on fresh data;
21. path rows -- every kernel at every shape a path below launched it
              with that no row above holds (Serve's batches and warmup,
              the advise runs' training and padded service chunks, the
              load CLI, the Dist path's blocks), against its plain
              version and timed, on fresh cesm-cloud slices and
              miranda-vx volumes;
22. llm      -- the LLM serving path (``repro_torch.models``,
              ``serve.engine``, ``launch.serve``; no kernel of its own:
              products are ``torch.matmul``) at granite-3-2b's full
              width, random parameters, in this process: (a)
              ``launch.serve.main`` at 10 of its 40 layers (cut to
              pay for phase 26) with ``--batch 4 --prompt-len 32
              --steps 16 --max-len 256 --kv-compress``, then again with
              ``--kv-gate-service``: the same ids and metering, one
              kv_gate request of 2 rows, times and peak memory logged;
              (b) float32 at 2 layers, prefill 15 tokens and decode the
              16th against the full forward's last logits (bound 1e-4,
              the reference's); (c) at 2 layers, parameters made on the CPU
              and copied to the card, prefill logits, K/V caches and 4
              teacher-forced decode steps card against CPU within the
              CPU tests' bounds (float32 rtol 1e-5 / atol 2e-5, bfloat16
              4 ulps of the largest |value|); (d) (a)'s K and V leaves:
              the gate's CRs, rewritten leaves and metering on the card
              bit-equal to the CPU's.  (Run right after 17, before 23.)
23. train    -- LLM training (``repro_torch.train``, ``ckpt``,
              ``launch.train``; the step's products are ``torch.matmul``)
              in this process, its launches counted as the "Train" path
              and held by phase 21, which runs after it: (a)
              ``make_train_step`` at granite-3-2b's full width and 4 of
              its 40 layers (bfloat16 parameters from seed 0, the state
              donated), 4 steps of batch 4 x seq 512 in 2 microbatches
              with ``CompressConfig()`` and ``AdamWConfig(lr=1e-3)``:
              step ms (median of steps 2-4), tokens/s, model FLOP/s (6 N
              tokens / step) and its share of the 989 TFLOP/s bfloat16
              peak, peak device memory, each step's loss, grad_norm,
              mean_pred_cr and gated leaves; finite losses, changed
              parameters and zero residuals on ungated leaves asserted;
              (b) at 2 layers of full width, parameters made on the CPU,
              batch 2 x 64, float32 and bfloat16: loss and every gradient
              leaf card against CPU (float32 rtol 1e-5 / atol 1e-5 of
              the largest |value|, bfloat16 16 ulps of it),
              ``compress_tree`` of the float32 gradients and one AdamW
              step (clip inactive) of the bfloat16 parameters, run over
              whole leaves on the card, bit-equal to the CPU's run over
              spans of each leaf: its first 2^22 values and, on a longer
              leaf, 2^20 values each side of the first chunk boundary
              (2^24 values for both) and its last 2^20 values (the
              padded last block); the whole leaves' CRs card == CPU; (c) at 2
              layers, ``loop.run`` for 4 steps with a checkpoint every
              2, step 4 deleted and the loop restarted: the resumed
              parameters within rtol 1e-5 / atol 1e-6 of the
              uninterrupted run's (bit-equality reported); a UC2-driven
              lossy checkpoint (sz3-lorenzo and zfp CR models trained
              on 12 miranda-vx slices of 96^2): every tensor within
              ``rel_eb`` x range + a bfloat16 ulp but a constant one (the
              reference's eb floor of 1e-12), predicted and achieved CR,
              time and bytes logged, loaded back for one finite step; a
              codec UC2 picks for no tensor gets a checkpoint of its
              own; (d) ``launch.train.main`` with ``--smoke --steps 8
              --compress --lossy-ckpt`` on the card.
24. families -- the moe and vlm families (``models.moe``, M-RoPE; no
              kernel of their own) at full width, depth cut to fit 80 GB,
              in this process after 23, each model freed before the next:
              (a) ``serve.engine.Engine`` for phi3.5-moe at 8 of 32
              layers and qwen2-vl-72b at 12 of 80, random parameters,
              batch 4, prompt 32, 16 decode steps, ``max_len`` 256 and the
              KV gate, then the gate through a ``SweepService``: the same
              ids and metering, one kv_gate request of 2 rows; init s,
              prefill ms, decode ms a step, tokens/s, gate ms, bytes
              saved, peak memory logged; (b) float32 at 2 layers,
              capacity factor 64: decode of the 16th token against the
              full forward (bound 1e-4), and for vlm a loss with three
              different position streams, finite and not the broadcast
              one; (c) at 1 layer, card against CPU in float32 and
              bfloat16 (phase 22's bounds): prefill logits and K/V; MoE
              routing recomputed on the CPU from the card's router
              logits bit-equal, the router logits card against CPU,
              each pair routed apart when each side makes its own
              logits a near-tie of them and their share bounded, the
              MoE output on the
              tokens routed alike; vlm logits under three streams; (d)
              ``make_train_step`` of phi3.5-moe at 1 layer, 4 steps as
              23 (a), model FLOP/s from its active parameters, the
              float32 router gated at every step.
25. mla/ssm  -- the mla_moe and ssm families (MLA and the dense first
              layer in ``models.causal_lm``, ``models.ssm``; no kernel),
              each model freed before the next: (a) as 24 (a) for
              deepseek-v2-236b at 6 of 60 layers and mamba2-370m at 48
              of 48, each scored cache leaf's CR and decision logged
              (MLA's ckv and krope of both segments, the SSM's conv
              window and float32 state); (b) as 24 (b) at 2 layers
              (deepseek: the dense first layer and one MoE layer; its
              decode step is MLA's absorbed form, its forward the
              expanded one; bound 1e-4); (c) card against CPU: deepseek
              at 2 layers in bfloat16 (routing from the same logits
              bit-equal and every pair routed apart a near-tie of the
              router logits, as 24 (c); the share apart at most 1/8) and
              one MLA layer in float32, both
              forms with its cache writes; mamba2 at 2 layers in both
              dtypes, the SSM cache after prefill included; (d)
              ``make_train_step`` of mamba2-370m whole, 4 steps as 23
              (a), its float32 SSM leaves among the gate's leaves.
26. hybrid/encdec -- the hybrid family (hymba in ``models.causal_lm``:
              attention and a mamba2 mixer side by side, sliding-window
              attention but in 3 global layers, 128 meta tokens) and the
              encdec family (``models.whisper``; no kernel), each model
              freed before the next: (a) as 24 (a) for hymba-1.5b whole
              (1 641 995 520 parameters; a prompt of 1100 ids past the
              window of 1024 and the windowed segments' 1152 ring
              slots, ``max_len`` 1280; 24 scored leaves: k, v, conv and
              state of 6 segments) and whisper-large-v3 whole
              (1 614 643 200; 1500 frames from a seeded generator; k, v,
              xk and xv scored); (b) float32 prefill and 2 decode steps
              against the forward (hymba at 4 layers past the window,
              whisper at 2 + 2; bound 1e-4); (c) card against CPU at
              phase 22's bounds: hymba at 2 layers in bfloat16 and in
              float32 past the window with its ring wrapped, whisper at
              1 + 1 layers over 1500 frames in both dtypes, the encoder
              memory included; (d) 4 training steps as 23 (a) of hymba
              at a global and a windowed layer (its float32 SSM leaves
              among the gate's) and of whisper at 2 + 2 layers, frames
              in the batch.  Its kernel launches must be none.
27. across   -- training across processes on a mesh's pod and data axes
              (``dist.{sharding, collectives, fault}``, ``train_step``'s
              podsync and data-parallel modes; no kernel), granite-3-2b
              at full width and 2 layers, batch 4 x 512 in 2
              microbatches.  (a)-(c) run in phase 17 (c)'s two gloo
              ranks on the card, after everything 17 (c) compares: (a)
              3 podsync steps on a 2 x 1 x 1 mesh with the int8
              collective and error feedback, both ranks' parameters and
              moments bit-equal after every step, and step 1's codes
              (each rank's and the gathered pair), scales, synced
              gradients and residuals equal, by bit digests, to this
              process's serial composition of the two pods (computed
              while the ranks run), the compressed mean within 0.05 of
              the plain mean; (c) a bfloat16 and a float32 leaf of (a)'s
              state through ``remesh_state`` onto 2 x 1 and
              ``shrink_mesh`` to 1, bit-equal; (b) 2 data-parallel
              ``pjit`` steps on 2 x 1, both ranks bit-equal, within the
              LLM bounds of the whole batch in one process.  (d) in this
              process: one gradient pass under each ``REPRO_REMAT``
              policy (full, dots, tp_outs), gradients bit-equal to
              full's, with each one's ms and peak memory.  Its kernel
              launches must be none.
Phases 5, 8-11, 14, 15, 17, 18 (their form (a)), 23, 24, 25, 26 and 27 each set the
kernels' launch counters to 0 just before they run and read them just
after, and the load CLI and the advise runs (in this process) and the
subprocesses (the process groups and 2-rank advise of phase 17, phase
18's group and CLI, phase 19's groups) count theirs by shape around
their work;
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
import dataclasses
import faulthandler
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

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
ADVISE_TRAIN_ROWS = 2           # rows of each variable the advise runs train on
                                # (2, the fewest a fit takes, for the time limit)
# phase 15: the sweep service, 8 clients x 16 requests of the seven
# methods (featurize on the grid and on a 3-eb subgrid with one eb off
# it), 4 hot held-out slices and the other 4 once each
SEED = 0
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_HOT = 8, 16, 4
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
FAULT_ACK_KEY = "chip_smoke/fault/armed"  # the follower's: it is armed
FAULT_ACK_TIMEOUT_S = 30.0      # the leader's wait for it, traffic held
FAULT_HANG_TIMEOUT_S = 8.0      # (b)'s launch deadline once warm
FAULT_LEADER_KILL = 6           # (c): 4 warmup launches, then the second
LEADER_LOST_BOUND_S = 30.0      # (c): the follower's exit after the leader's
PLANT_EBS = (1e-5, 1e-3, 256.0)     # 256: quotients of tiny normals underflow
QENT_BINS = 65536
# phase 20: the full search's q-ent shapes are divided by this (1: their
# own lengths)
TUNE_SHAPE_DIV = 1
# phase 22: the LLM serving path at granite-3-2b's full width and depth
LLM_ARCH = "granite-3-2b"
LLM_SERVE_ARGS = ["--batch", "4", "--prompt-len", "32", "--steps", "16",
                  "--max-len", "256", "--kv-compress", "--device", "cuda"]
LLM_SERVE_LAYERS = 10           # (a): depth cut from 40 to pay for phase 26
LLM_DECODE_TOL = 1e-4           # (b): the reference's bound at smoke size
LLM_CMP_LAYERS = 2              # (c): the card against the CPU, full width
LLM_F32_TOL = dict(rtol=1e-5, atol=2e-5)   # tests/test_torch_models.py's
LLM_BF16_ULPS = 4               # ... and its bfloat16 bound
# phase 23: LLM training at granite-3-2b's full width and depth
TRAIN_ARCH = "granite-3-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB, TRAIN_STEPS = 4, 512, 2, 4   # (a)
TRAIN_LR = 1e-3
TRAIN_CMP_LAYERS, TRAIN_CMP_BATCH, TRAIN_CMP_SEQ = 2, 2, 64     # (b)
TRAIN_BF16_ULPS = 16            # tests/test_torch_train.py's gradient bound
TRAIN_LAYERS = 4                # (a): depth cut from 40 to pay for phases 24-25
TRAIN_HEAD_VALUES = 1 << 22     # (b): each leaf's first values, held by
                                # compress_tree and AdamW card vs CPU, and
TRAIN_SPAN_VALUES = 1 << 20     # half a span across a chunk boundary, and
                                # a larger leaf's last values
TRAIN_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
TRAIN_CKPT_STEPS, TRAIN_CKPT_EVERY = 4, 2                       # (c)
TRAIN_RESTART_TOL = dict(rtol=1e-5, atol=1e-6)   # tests/test_train.py:105
TRAIN_CLI_ARGS = ["--smoke", "--steps", "8", "--compress", "--lossy-ckpt",
                  "--device", "cuda"]                            # (d)
# phase 24: the moe and vlm families at full width; only depth is cut, to
# fit the card's 80 GB in bfloat16 (all 32 / 80 layers take 84 / 145 GB)
FAM_SERVE = (("phi3.5-moe-42b-a6.6b", 8), ("qwen2-vl-72b", 12))    # (a)
FAM_BATCH, FAM_PROMPT, FAM_STEPS, FAM_MAX_LEN = 4, 32, 16, 256
FAM_DECODE_LAYERS = 2           # (b): float32 decode vs forward, no drops
FAM_CMP_LAYERS = 1              # (c): the card against the CPU
# (c): the share of the 64 (token, choice) pairs that may route apart when
# the card and the CPU each compute their router logits; 0 of 64 measured
# in both dtypes on the H100, a bfloat16 near-tie allowed 4 of 64
FAM_ROUTING_DIFFERS_MAX = {"float32": 0.0, "bfloat16": 1 / 16}
FAM_TRAIN_ARCH, FAM_TRAIN_LAYERS = "phi3.5-moe-42b-a6.6b", 1       # (d)
# phase 25: the mla_moe and ssm families at full width; deepseek-v2's depth
# is cut to fit the card in bfloat16 (all 60 layers take 471 GB), mamba2
# runs whole
FAM2_SERVE = (("deepseek-v2-236b", 6), ("mamba2-370m", 48))       # (a)
# (c): layers and dtypes of the whole model card vs CPU; deepseek's 2
# layers (the dense first one and one MoE layer) in float32 would copy
# 21 GB to the host, so its float32 check is one MLA layer alone
FAM2_CMP = {"deepseek-v2-236b": (2, ("bfloat16",)),
            "mamba2-370m": (2, ("float32", "bfloat16"))}
# (c): deepseek's top-6 of 160 experts has many more near-tied choices than
# phi3.5-moe's top-2 of 16: 14 of its 192 pairs routed apart in bfloat16
# on the H100 (13 experts, each within 0.03125 of its neighbouring router
# logit against twice their 0.0234375 max abs err, and 1 keep at an
# expert those touched), where phase 24's 1/16 allows 12; the near-tie
# check is what holds the router, the share a coarse guard above it
FAM2_ROUTING_DIFFERS_MAX = {"float32": 0.0, "bfloat16": 1 / 8}
FAM2_TRAIN_ARCH = "mamba2-370m"                                  # (d), whole
FAM2_SSM_F32 = ("ssm.a_log", "ssm.d_skip", "ssm.dt_bias")
# phase 26: the hybrid and encdec families at full width and full depth
HYB_ARCH, ENC_ARCH = "hymba-1.5b", "whisper-large-v3"
PHASE26_PARAMS = {HYB_ARCH: 1_641_995_520, ENC_ARCH: 1_614_643_200}
# (a): 1100 ids and the 128 meta tokens pass the window of 1024 and the
# windowed segments' 1152 ring slots, so the prefill wraps the ring
HYB_PROMPT, HYB_MAX_LEN = 1100, 1280
# (b), (c), (d): hymba's cut depths as (layers, global layers); (d) was
# whole, cut to a global and a windowed layer to pay for the phase
HYB_DECODE_DEPTH, HYB_CMP_DEPTH, HYB_TRAIN_DEPTH = (4, 1), (2, 1), (2, 1)
HYB_DECODE_PROMPT = 1100        # (b): past the window, then 2 steps
# (c): (dtype, batch, prompt, max_len): float32 past the window (900 ids
# and 128 meta tokens: 1028 positions) and past the windowed segment's
# min(1024, 512) + 128 ring slots; the CPU side cut from 2 x 32 and 1 x
# 1100 ids to pay for the phase
HYB_CMP = (("bfloat16", 1, FAM_PROMPT, FAM_MAX_LEN),
           ("float32", 1, 900, 512))
ENC_DECODE_LAYERS, ENC_CMP_LAYERS, ENC_TRAIN_LAYERS = 2, 1, 2  # + as many
ENC_CMP = (("bfloat16", 1, 16, 24), ("float32", 1, 16, 24))
# phase 27: training across processes on the pod and data axes, in phase
# 17 (c)'s two gloo ranks on the card after its sweeps, and (d) in this
# process: granite-3-2b at full width, 2 of its 40 layers
ACROSS_ARCH, ACROSS_LAYERS = "granite-3-2b", 2
ACROSS_BATCH, ACROSS_SEQ, ACROSS_MB = 4, 512, 2
ACROSS_POD_STEPS, ACROSS_DP_STEPS = 3, 2        # (a) podsync, (b) pjit
ACROSS_REL_MAX = 0.05           # tests/test_dist.py's compressed-mean bound
ACROSS_REMAT = ("full", "dots", "tp_outs")      # (d)
# H100 SXM data-sheet peaks (dense, no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
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
    against the float64 form it replaced (the new call also builds the
    rank-term table), each with its
    wall time to a synchronize and its peak device memory above what was
    allocated before it; and how far the two forms' features differ."""
    engine = P.get_engine(P.PredictorConfig())
    out = {"new_s": [], "old_s": [], "new_peak_gib": [], "old_peak_gib": []}
    feats = {}
    for form in ("new", "old"):
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
        f"by {out['max_abs_diff']:.3g} at most (one run each in this order, "
        "the first building the rank-term table: not comparable with "
        "timings made in turns)", card)
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


def serve_traffic(svc, plan, ctx, stamps=None, hold=None):
    """Every client thread submits its requests one after another and
    waits for each (appending each completion's ``perf_counter`` to
    ``stamps`` when given).  ``hold`` (n, event, fault): the clients
    submit n requests in all, then wait for ``event`` before the rest,
    and raise ``fault["error"]`` where it is set by then.  Returns
    (results by (client, request), latencies in ms by kind, wall s)."""
    import threading
    results, lat, errors = {}, {}, []
    lock = threading.Lock()
    submitted = [0]

    def held():
        after, event, fault = hold
        with lock:
            n = submitted[0]
            submitted[0] += 1
        if n < after:
            return
        if not event.wait(FAULT_TIMEOUT_S):
            raise AssertionError(f"the traffic held after {after} requests "
                                 f"was not released in {FAULT_TIMEOUT_S} s")
        if fault.get("error"):
            raise AssertionError(fault["error"])

    def client(c):
        try:
            for r, req in enumerate(plan[c]):
                if hold is not None:
                    held()
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
    to that) and serves the cut plan from 8 client threads; they submit
    ``FAULT_ARM_REQUESTS`` requests and wait.  Once those are done the
    leader sets ``FAULT_ARM_KEY`` in the group's store (its value the
    wall-clock time) and polls for ``FAULT_ACK_KEY`` with ``check``; a
    follower with a ``chaos`` spec arms it (``dist.faultinject``) when it
    sees the key and then sets ``FAULT_ACK_KEY``, and the leader releases
    its clients, so the fault lands in the follower's next launch,
    mid-traffic.  No acknowledgement within ``FAULT_ACK_TIMEOUT_S`` fails
    the leader's traffic, naming the key: the traffic never goes on
    unarmed.  Each side records the arm's delay: the leader from setting
    the key to seeing the acknowledgement, the follower from the key's
    time to its injector's arming.  Each stays ``linger_s`` after its
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
        release, fault = threading.Event(), {}

        def signal_arm():
            while len(stamps) < FAULT_ARM_REQUESTS:
                time.sleep(0.002)
            store = M.coordination_store()
            set_at = time.time()
            store.set(FAULT_ARM_KEY, repr(set_at))
            deadline = time.perf_counter() + FAULT_ACK_TIMEOUT_S
            while not store.check([FAULT_ACK_KEY]):
                if time.perf_counter() > deadline:
                    fault["error"] = (
                        f"the follower did not acknowledge the arm "
                        f"({FAULT_ACK_KEY} unset {FAULT_ACK_TIMEOUT_S} s "
                        f"after {FAULT_ARM_KEY}): the traffic would go on "
                        "unarmed")
                    break
                time.sleep(0.002)
            rec["arm_wait_s"] = time.time() - set_at
            release.set()

        threading.Thread(target=signal_arm, daemon=True).start()
        t0 = time.perf_counter()
        results, _, wall = serve_traffic(
            svc, plan, ctx, stamps, (FAULT_ARM_REQUESTS, release, fault))
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
                store.set(FAULT_ACK_KEY, "1")
                rec["arm_delay_s"] = time.time() - float(
                    store.get(FAULT_ARM_KEY))
                sys.stdout.write(f"armed {job['chaos']} "
                                 f"{rec['arm_delay_s']:.4f} s after the "
                                 "leader's key\n")
                sys.stdout.flush()
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
            logs = {}
            out[f"{form}_wall_s"] = run_group(f"fault ({form})", cmds, tmp,
                                              FAULT_TIMEOUT_S, expect=killed,
                                              logs=logs)
            ranks = [json.loads(p.read_text()) for i, p in enumerate(outs)
                     if i not in killed]
            out[form] = ranks
            armed = re.search(r"armed \S+ (\S+) s after the leader's key",
                              logs[nprocs - 1])
            if armed is None:
                raise AssertionError(f"fault ({form}): the follower never "
                                     f"armed:\n{logs[nprocs - 1][-3000:]}")
            out[f"{form}_arm"] = {"leader_wait_s": ranks[0]["arm_wait_s"],
                                  "follower_delay_s": float(armed.group(1))}
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
                "the direct call; the traffic held at the arm: the leader "
                f"saw the acknowledgement {lead['arm_wait_s']:.4f} s after "
                f"its key, the follower armed "
                f"{out[form + '_arm']['follower_delay_s']:.4f} s after it",
                card)

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


def advise_run(torch, argv) -> tuple[list, dict]:
    """The advise CLI's ``main`` in this process, as ``python -m
    repro_torch.launch.advise`` runs it (no process start-up for phase
    14's two runs and phase 17's mesh run), each variable's training and
    sweep launches counted as ``ADVISE_CHILD`` counts them.
    Returns (its printed lines, the launches in ``ADVISE_CHILD``'s JSON
    form)."""
    from repro_torch import kernels as K
    from repro_torch.launch import advise as ADV
    trained, out = {}, {}
    orig_train, orig_variable = ADV.train_models, ADV.advise_variable

    def train(source, name, *args, **kwargs):
        res = orig_train(source, name, *args, **kwargs)
        trained[name] = K.launch_counts()
        return res

    def variable(source, name, *args, **kwargs):
        before = K.launch_counts()
        res = orig_variable(source, name, *args, **kwargs)
        (t, ts), (s, ss) = (K.launches_since(before, trained[name]),
                            K.launches_since(trained[name]))
        out[name] = {"train": t, "sweep": s,
                     "by_shape": {"train": ts, "sweep": ss}}
        return res

    gc.collect()
    torch.cuda.empty_cache()
    ADV.train_models, ADV.advise_variable = train, variable
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            ADV.main(argv)
    finally:
        ADV.train_models, ADV.advise_variable = orig_train, orig_variable
        # hand the card back as the run's exit did: the process groups
        # that follow need tens of GiB of it
        gc.collect()
        torch.cuda.empty_cache()
    log(f"advise run done: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved "
        "by this process")
    return buf.getvalue().strip().splitlines(), json.loads(json.dumps(out))


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
    # prefetch 2 and 0, none hashing its chunks (their repeats in turns
    # went to pay for phase 24)
    for key, depth in (("2d_prefetch2", 2), ("2d_prefetch0", 0)):
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
    for key in ("2d_prefetch2", "2d_prefetch0"):
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
    log("stream: one run each, prefetch 2 first (a colder page cache): "
        "not comparable with timings made in turns")
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

    # the advise CLI as a user runs it, in this process, launches
    # counted around it
    report_path = os.path.join(tmp, "report.json")
    free, total = torch.cuda.mem_get_info()
    log(f"advise starts with {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} "
        f"GiB of the card free ({torch.cuda.memory_allocated() / 2 ** 30:.2f}"
        " GiB allocated by this process)")
    t = time.perf_counter()
    lines, launches = advise_run(torch, [*advise_args(path), "--out",
                                         report_path])
    out["advise_s"] = time.perf_counter() - t
    with open(report_path) as f:
        report = json.load(f)
    for line in lines:
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
    t = time.perf_counter()
    _, svc_launches = advise_run(torch, [*advise_args(path), "--service",
                                         "--out", svc_path])
    out["advise_service_s"] = time.perf_counter() - t
    with open(svc_path) as f:
        served = json.load(f)
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
    """Phase 16: the load CLI (``launch.sweep_serve.main``, as ``python -m
    repro_torch.launch.sweep_serve`` runs it) in this process at the main
    path's width: a finite report, ZFP launched in its training and Gram
    in its serving.  Returns (report, its training's and serving's
    launches by shape, as one path's; the CLI counts them around its own
    work)."""
    from repro_torch.launch import sweep_serve as SS
    argv = ["--fields", FIELD, "--n", str(SERVE_CLI_N), "--train-slices",
            "6", "--compressor", "zfp", "--clients", "8", "--requests",
            "64", "--device", "cuda"]
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        report = SS.main(argv)
    wall = time.perf_counter() - t
    for line in buf.getvalue().strip().splitlines():
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


def dist_child(job_file: str) -> int:
    """Phase 17's process-group member (``--dist-child JOB``): joins the
    group its job file names, runs the job's parts on its device -- the
    training sweep SPMD and process-local (also split into the blocks'
    sweep and the gather), the volumes, a 2-slice batch, the training
    tables and the streams -- holds each result to the single-device one
    the parent left in the job's directory, bit for bit, and writes its
    wall times and its kernels' launches by shape; with the ``across``
    part, then phase 27 (a)-(c) (``across_child``) and its record."""
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
            want = np.load(d / f"crs_{name}.npy")
            cells = np.argwhere(table.view(np.int64) != want.view(np.int64))
            if len(cells):
                # which side is off: each differing cell again, serially
                again = {(int(i), int(j)): (float(table[i, j]), float(
                    want[i, j]), C.get(name).cr(train[i], float(ebs[j])))
                    for i, j in cells[:8]}
                raise AssertionError(
                    f"training_crs {name}: {len(cells)} cells differ from the "
                    "main path's table; (row, eb): (here, main path, "
                    f"serially here) {again}")
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
    across = None
    if "across" in job["parts"]:
        # phase 27 (a)-(c), after everything 17 (c) compares
        del train
        gc.collect()
        across = across_child(torch, dev, job["rank"])
    Path(job["out"]).write_text(json.dumps(
        {"times": times, "launches": total, "by_shape": by_shape,
         "shares": list(mesh.shares), "libraries_found": built,
         "across": across}))
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def run_group(what: str, cmds, logs_dir: Path, timeout: float,
              expect: dict | None = None, exits: dict | None = None,
              logs: dict | None = None, meanwhile=None) -> float:
    """Start ``cmds`` together (one process each, output to files under
    ``logs_dir``), wait for all within ``timeout`` s and raise if one
    exits with another code than ``expect`` gives it (default 0) or the
    time runs out; every process is gone on return.  Returns the wall
    time; ``exits`` gets each process's exit time (s after the start),
    ``logs`` its output.  Each process gets its share of the host's
    cores for its thread pools, as ``torchrun`` gives its ranks: ranks
    that each spin up a pool of every core starve each other's CPU work
    (LAPACK's above all).  ``meanwhile`` (no arguments) runs in this
    process once all are started."""
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
        if meanwhile is not None:
            meanwhile()
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

    # (a) one process, two shards on the card; timed beside one device,
    # then its blocks and their gather alone, counters read around those
    # two only
    mesh = M.make_sweep_mesh(devices=[DIST_DEVICE] * 2)
    runs = {"one device": [], "two shards": []}
    for key in ("one device", "two shards"):
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

    serial = tmp / "across_serial.json"
    for role, nprocs, backend, shards, parts_ in (
            ("b", 1, DIST_NCCL, 2, ["train"]),
            ("c", 2, "gloo", 1, ["train", "more", "across"])):
        cmds, outs = zip(*[child(role, nprocs, r, backend, shards, parts_)
                           for r in range(nprocs)])
        out[f"{role}_wall_s"] = run_group(
            f"dist ({role})", cmds, tmp, DIST_TIMEOUT_S,
            meanwhile=(lambda: across_serial(torch, serial))
            if role == "c" else None)
        out[role] = [json.loads(p.read_text()) for p in outs]
        parts += [r["by_shape"] for r in out[role]]
        for r in out[role]:
            if not r["libraries_found"]:
                raise AssertionError(f"dist ({role}): a child found the "
                                     "kernels unbuilt")
    # phase 27 (a)-(c) rode in (c)'s ranks: held to the serial composition
    out["across"] = across_check([r.pop("across") for r in out["c"]],
                                 json.loads(serial.read_text()), card)

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
        if tag == "mesh":       # one process: this one
            t = time.perf_counter()
            _, launches = advise_run(torch, cmds[0][4:])
            out[f"{what} s"] = time.perf_counter() - t
            launch_files[0].write_text(json.dumps(launches))
        else:
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
        "the pair, training tables, streams; (a)'s one device and two "
        "shards one run each in this order, not timings made in turns); "
        + json.dumps(
            {k: v for k, v in out.items() if k not in ("b", "c", "across")}),
        card)
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


# ---------------------------------------------------------------------------
# phase 20: the q-ent kernel's offline launch search
# ---------------------------------------------------------------------------

def phase_tune(torch, card) -> dict:
    """Phase 20 (module docstring): the smoke search, then every
    candidate build against the plain one at the full search's shapes."""
    from repro_torch.kernels import tune as KT
    from repro_torch.kernels.qent import ops as qent_ops
    rec = {}
    t = time.perf_counter()
    smoke = KT.run_search(smoke=True, device="cuda")
    rec["smoke_s"] = time.perf_counter() - t
    (key, cell), = smoke["cells"].items()
    if (cell["discarded_bit_unsafe"]
            or cell["tile"] not in KT.QENT_TILE_CANDIDATES
            or set(cell["times"]) != {str(c) for c in KT.QENT_TILE_CANDIDATES}):
        raise AssertionError(f"smoke search cell {key}: {cell}")
    rec["smoke"] = smoke["cells"]
    log(f"tune (a): smoke search {key} {cell['shape']} in "
        f"{rec['smoke_s']:.2f} s, choice {cell['tile']}, "
        f"{'cold' if cell['cold'] else 'warm'} ms by tile "
        + json.dumps({k: 1e3 * v for k, v in cell["times"].items()}), card)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    t = time.perf_counter()
    rec["cells"] = []
    for k, n, bins, e in KT.FULL_QENT_CELLS:
        n = max(1, n // TUNE_SHAPE_DIV)
        x = torch.randn((k, n), generator=g, device="cuda")
        eps = torch.logspace(-3, -1, e, device="cuda")

        def hist(tile):
            return qent_ops.launch(x, eps, bins, KT.tile_defines(tile))
        want = hist(KT.DEFAULT_TILE)
        for tile in KT.QENT_TILE_CANDIDATES:
            if not torch.equal(hist(tile), want):
                raise AssertionError(
                    f"q-ent at {tile} elements a CTA differs from the plain "
                    f"build at ({k}, {n}) x {e}, {bins} bins")
        rec["cells"].append([k, n, bins, e])
        del x, want
    torch.cuda.synchronize()
    rec["cells_s"] = time.perf_counter() - t
    zero_counts(torch)
    log(f"tune (b): every q-ent candidate {list(KT.QENT_TILE_CANDIDATES)} "
        f"== the plain build at {rec['cells']} in {rec['cells_s']:.2f} s",
        card)
    return rec


def path_rows(torch, TS, counts, rows, ebs, vol_eps):
    """Every kernel at every shape a path launched it with that no row
    above holds -- Serve's own batches and its warmup's, the advise
    CLI's training and its ``--service`` chunks padded to their row
    buckets, the load CLI's training and serving, the Train path's
    lossy checkpoint -- against its plain version at the tolerance of
    its kind and timed as in phase 12, on fresh cesm-cloud slices of
    1800^2 (cut to a smaller shape; a batch larger than the pool repeats
    it, as a padded launch repeats its last row), miranda-vx volumes, and
    parameter-like normals where a shape exceeds a slice (the packed
    weights, up to (24704, 4096))."""
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

    def fits(m, n):
        return m <= pool.shape[1] and n <= pool.shape[2]

    def param_like(*shape):
        """Weights as the Train path's lossy checkpoint packs them (its
        ``_pack2d`` slices of 4096 columns): normal, std 0.02."""
        g = torch.Generator(device="cuda").manual_seed(sum(shape))
        return 0.02 * torch.randn(shape, generator=g, device="cuda")

    d0, d1, d2 = VOL_SHAPE
    out = []
    for kernel, shape in todo:
        if kernel == "gram_batched":
            k, m, n, tr = shape
            if tr and fits(m, n):
                x = slices_k(k, m, n)
                x = x - x.mean(dim=1, keepdim=True)
            elif not tr and (m, n) in ((d0, d1 * d2), (d1, d0 * d2)):
                v = vols_k(k)
                v = v - v.mean(dim=(1, 2, 3), keepdim=True)
                x = (v.reshape(k, m, n) if (m, n) == (d0, d1 * d2)
                     else torch.movedim(v, 2, 1).reshape(k, m, n))
                del v
            else:
                x = param_like(k, m, n)
                x = x - x.mean(dim=1 if tr else 2, keepdim=True)
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
            if fits(*shape):
                out.append(lorenzo_row(torch, slices_k(1, *shape)[0],
                                       float(ebs[1])))
            else:       # the lossy policy's eb: 1e-4 of the range
                x = param_like(*shape)
                out.append(lorenzo_row(torch, x, 1e-4 * float(
                    x.max() - x.min())))
        elif kernel == "zfp_forward2d":
            out.append(zfp_row(torch, slices_k(1, *shape)[0] if fits(*shape)
                               else param_like(*shape)))
        else:
            raise AssertionError(f"no row for kernel {kernel}")
        x = flat = None
    del pool, vols
    return out


# ---------------------------------------------------------------------------
# phase 22: the LLM serving path
# ---------------------------------------------------------------------------

def llm_close(got, want, dtype: str, what: str) -> float:
    """The CPU tests' parity bound: float32 rtol 1e-5 / atol 2e-5, bfloat16
    4 ulps of the largest |value| compared.  Returns the max abs error."""
    got = got.detach().float().cpu()
    want = want.detach().float().cpu()
    err = float((got - want).abs().max())
    if dtype == "float32":
        ok = bool(((got - want).abs() <= LLM_F32_TOL["atol"]
                   + LLM_F32_TOL["rtol"] * want.abs()).all())
        tol = f"rtol {LLM_F32_TOL['rtol']} / atol {LLM_F32_TOL['atol']}"
    else:
        m = max(float(want.abs().max()), 2.0 ** -126)
        bound = LLM_BF16_ULPS * 2.0 ** (math.floor(math.log2(m)) - 7)
        ok, tol = err <= bound, f"{bound:g} ({LLM_BF16_ULPS} ulps of {m:g})"
    if not ok:
        raise AssertionError(f"llm (c) {dtype} {what}: max abs err {err:g} "
                             f"outside {tol}")
    return err


def llm_card_vs_cpu(torch, card) -> dict:
    """(c): granite-3-2b's width at 2 layers, parameters made once on the
    CPU and copied to the card; prefill logits, K/V caches and 4
    teacher-forced decode steps, card against CPU, in float32 and
    bfloat16, at the CPU tests' bounds."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import causal_lm as CLM
    from repro_torch.models import model as M
    from repro_torch.models import params as PRM

    cfg = dataclasses.replace(get_arch(LLM_ARCH), num_layers=LLM_CMP_LAYERS)
    tree = PRM.init_params(M.param_table(cfg),
                           torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    rec = {}
    for dtype in ("float32", "bfloat16"):
        cfgd = dataclasses.replace(cfg, dtype=dtype)
        dt = getattr(torch, dtype)
        cpu = CLM.CausalLM(cfgd, PRM.tree_unflatten(
            tree, [x.to(dt) for x in PRM.tree_leaves(tree)]))
        dev = CLM.CausalLM(cfgd, PRM.tree_unflatten(
            tree, [x.to("cuda").to(dt) for x in PRM.tree_leaves(tree)]))
        errs = {"logits": 0.0, "k": 0.0, "v": 0.0}
        with torch.inference_mode():
            lc, cc = M.prefill(cpu, {"tokens": toks[:, :12]}, cfgd, 24)
            lg, cg = M.prefill(dev, {"tokens": toks[:, :12].to("cuda")},
                               cfgd, 24)
            for i in range(12, 17):
                what = "prefill" if i == 12 else f"decode {i - 1}"
                errs["logits"] = max(errs["logits"],
                                     llm_close(lg, lc, dtype, what))
                for name in ("k", "v"):
                    errs[name] = max(errs[name], llm_close(
                        getattr(cg["seg0"], name), getattr(cc["seg0"], name),
                        dtype, f"{what} {name}"))
                if not torch.equal(cg["seg0"].pos.cpu(), cc["seg0"].pos):
                    raise AssertionError(f"llm (c) {dtype} {what}: pos")
                if i < 16:
                    lc, cc = M.decode_step(cpu, cc, toks[:, i:i + 1], i, cfgd)
                    lg, cg = M.decode_step(dev, cg, toks[:, i:i + 1].to(
                        "cuda"), i, cfgd)
        rec[dtype] = dict(errs, max_logit=float(lc.float().abs().max()))
        del cpu, dev
    log(f"llm (c) card vs CPU at d_model {cfg.d_model}, {LLM_CMP_LAYERS} "
        f"layers, prefill + 4 teacher-forced steps: max abs err "
        + json.dumps(rec), card)
    return rec


def int_bits(torch, x):
    """``x``'s bits as a same-size integer tensor (``torch.equal`` on
    floats would take -0 for 0)."""
    return x.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


def llm_gate_bits(torch, gate) -> dict:
    """(d): run (a)'s K and V leaves, CRs and quantize/dequantize on the
    card bit-equal to the CPU's, and the metering equal."""
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.train import grad_compress as GC
    ratio = ServeConfig().kv_gate_ratio          # the launcher's gate
    before, after, saved, total = gate
    want_saved = want_total = 0
    crs = []
    for i, x in enumerate(before):
        if x.ndim < 4:
            if not torch.equal(after[i], x):
                raise AssertionError("llm (d): a non-candidate leaf changed")
            continue
        cr_card = GC.predicted_cr_int8(x.float()).cpu()
        xc = x.cpu()
        cr_cpu = GC.predicted_cr_int8(xc.float())
        if not torch.equal(int_bits(torch, cr_card), int_bits(torch, cr_cpu)):
            raise AssertionError(f"llm (d): leaf {i} CR card {cr_card} != "
                                 f"CPU {cr_cpu}")
        crs.append(float(cr_cpu))
        want_total += x.numel() * x.element_size()
        want = xc
        if float(cr_cpu) >= ratio:
            nb = -(-x.numel() // GC.BLOCK)
            want_saved += x.numel() * x.element_size() - nb * (GC.BLOCK + 4)
            want = GC.dequantize_int8(*GC.quantize_int8(xc.float()),
                                      xc.shape, xc.dtype)
        if not torch.equal(int_bits(torch, after[i].cpu()),
                           int_bits(torch, want)):
            raise AssertionError(f"llm (d): leaf {i} rewritten != CPU's")
    if (saved, total) != (want_saved, want_total):
        raise AssertionError(f"llm (d): metering {saved}/{total} != CPU's "
                             f"{want_saved}/{want_total}")
    return {"crs": crs, "saved": saved, "total": total}


@contextlib.contextmanager
def arch_depth(arch: str, layers: int):
    """``configs.base.get_arch(arch)`` at ``layers`` layers while
    entered, for a launcher that takes an architecture's name."""
    from repro_torch.configs import base
    orig = base.get_arch
    base.get_arch = lambda a: (dataclasses.replace(orig(a), num_layers=layers)
                               if a == arch else orig(a))
    try:
        yield
    finally:
        base.get_arch = orig


def phase_llm(torch, card) -> dict:
    """Phase 22: the LLM serving path at granite-3-2b's full width, in
    this process.  (a) ``launch.serve.main`` at ``LLM_SERVE_LAYERS`` of
    its 40 layers with
    ``--kv-compress`` and again with ``--kv-gate-service``: the same ids
    and metering, one kv_gate request of 2 rows; (b) float32 parameters,
    prefill 15 tokens and decode the 16th against the full forward's last
    logits; (c) card against CPU at 2 layers (``llm_card_vs_cpu``); (d)
    (a)'s gate on the card against the CPU (``llm_gate_bits``)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import serve as LS
    from repro_torch.models import causal_lm as CLM
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.serve import engine as E

    rec, gates = {}, []
    orig = E.Engine._maybe_compress_cache

    def gate(self, cache):
        before = [x.clone() for x in tree_leaves(cache)]
        out = orig(self, cache)
        gates.append((before, [x.clone() for x in tree_leaves(out)],
                      self.kv_saved_bytes, self.kv_total_bytes))
        return out

    E.Engine._maybe_compress_cache = gate
    torch.cuda.reset_peak_memory_stats()
    try:
        for name, extra in (("direct", []), ("service", ["--kv-gate-service"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    arch_depth(LLM_ARCH, LLM_SERVE_LAYERS):
                r = LS.main(["--arch", LLM_ARCH] + LLM_SERVE_ARGS + extra)
            for line in buf.getvalue().splitlines():
                log(f"serve {name} | {line}")
            rec[name] = r
    finally:
        E.Engine._maybe_compress_cache = orig
    a, b = rec["direct"], rec["service"]
    nums = [r[k] for r in (a, b) for k in ("init_s", "prefill_s", "gate_s",
                                           "decode_ms_per_step",
                                           "tokens_per_s")]
    if a["shape"] != [4, 16] or not np.all(np.isfinite(nums)):
        raise AssertionError(f"llm (a): bad report {a['shape']} {nums}")
    if a["ids"] != b["ids"]:
        raise AssertionError("llm (a): the service run's ids differ")
    if (a["kv_saved_bytes"], a["kv_total_bytes"]) != \
            (b["kv_saved_bytes"], b["kv_total_bytes"]) or \
            not 0 < a["kv_saved_bytes"] < a["kv_total_bytes"]:
        raise AssertionError(f"llm (a): metering {a['kv_saved_bytes']}/"
                             f"{a['kv_total_bytes']} vs {b['kv_saved_bytes']}"
                             f"/{b['kv_total_bytes']}")
    if (b["kv_gate"]["completed"], b["kv_gate"]["rows"]) != (1, 2):
        raise AssertionError(f"llm (a): kv_gate stats {b['kv_gate']}")
    if len(gates) != 2 or not all(
            torch.equal(int_bits(torch, x), int_bits(torch, y))
            for x, y in zip(gates[0][1], gates[1][1])):
        raise AssertionError("llm (a): the two runs' gated caches differ")
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    vocab = get_arch(LLM_ARCH).vocab_size
    rec["padded_vocab_ids"] = int(sum(i >= vocab for row in a["ids"]
                                      for i in row))
    for name in ("direct", "service"):
        r = rec[name]
        log(f"llm (a) {name}: {r['params']:,} parameters, "
            f"{r['param_bytes'] / 1e9:.3f} GB, init {r['init_s']:.3f} s, "
            f"prefill {r['prefill_s'] * 1e3:.2f} ms, gate "
            f"{r['gate_s'] * 1e3:.2f} ms, decode "
            f"{r['decode_ms_per_step']:.3f} ms/step, "
            f"{r['tokens_per_s']:.1f} tokens/s, KV saved "
            f"{r['kv_saved_bytes']:,}/{r['kv_total_bytes']:,} B", card)
    log(f"llm (a): ids equal with and without the service; kv_gate "
        f"{json.dumps(b['kv_gate'])}; {rec['padded_vocab_ids']} of 64 ids "
        f">= vocab {vocab}; peak device memory {rec['peak_gib']:.2f} GiB")

    rec["gate_bits"] = llm_gate_bits(torch, gates[0])
    log(f"llm (d): CRs {rec['gate_bits']['crs']} card == CPU, rewritten "
        "leaves and metering == CPU's")
    del gates

    cfg = dataclasses.replace(get_arch(LLM_ARCH), dtype="float32",
                              num_layers=LLM_CMP_LAYERS)
    model = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    model = model.float()
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)).to("cuda")
    with torch.inference_mode():
        full = CLM.logits_fn(model, CLM.forward(model, toks, cfg))[:, 15]
        _, cache = M.prefill(model, {"tokens": toks[:, :15]}, cfg, 20)
        lg, _ = M.decode_step(model, cache, toks[:, 15:16], 15, cfg)
    err = float((lg - full).abs().max())
    rec["decode_vs_forward"] = {"max_abs_err": err,
                                "max_logit": float(full.abs().max())}
    log(f"llm (b) float32 decode vs forward at full width, "
        f"{LLM_CMP_LAYERS} layers: max abs err "
        f"{err:.3g} (|logit| <= {rec['decode_vs_forward']['max_logit']:.3g},"
        f" bound {LLM_DECODE_TOL})")
    if not err < LLM_DECODE_TOL:
        raise AssertionError(f"llm (b): decode vs forward {err}")
    del model, cache, full, lg
    gc.collect()
    torch.cuda.empty_cache()

    rec["card_vs_cpu"] = llm_card_vs_cpu(torch, card)
    return rec


# ---------------------------------------------------------------------------
# phase 23: LLM training
# ---------------------------------------------------------------------------

def train_close(torch, got, want, dtype: str, what: str) -> float:
    """The training tests' bounds: float32 rtol 1e-5 / atol 1e-5 of the
    largest |value|, bfloat16 16 ulps of the largest |value|.  Returns
    the max abs error."""
    got = got.detach().float().cpu()
    want = want.detach().float().cpu()
    err = float((got - want).abs().max())
    m = float(want.abs().max())
    if dtype == "float32":
        ok = bool(((got - want).abs() <= 1e-5 * m + 1e-5 * want.abs()).all())
        tol = "rtol 1e-5 / atol 1e-5 x max"
    else:
        ulp = 2.0 ** (math.floor(math.log2(max(m, 2.0 ** -126))) - 7)
        ok, tol = err <= TRAIN_BF16_ULPS * ulp, f"{TRAIN_BF16_ULPS} ulps of {m:g}"
    if not ok:
        raise AssertionError(f"train (b) {dtype} {what}: max abs err {err:g} "
                             f"outside {tol}")
    return err


def train_steps(torch, card, cfg, tag: str) -> dict:
    """``make_train_step`` of ``cfg`` (random parameters from seed 0,
    donated state), 4 steps of batch 4 x seq 512 in 2 microbatches with
    ``CompressConfig()`` and ``AdamWConfig(lr=1e-3)``: each step's ms,
    loss, grad_norm, mean_pred_cr and gated leaves; step ms (median of
    steps 2-4), tokens/s, model FLOP/s (6 x active parameters x tokens
    / step) and peak memory.  Finite metrics, changed parameters and
    zero residuals on ungated leaves are asserted."""
    from repro_torch.data.tokens import make_data_iter
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_flatten, tree_leaves
    from repro_torch.train import grad_compress as GC
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state = TS.init_state(cfg, torch.Generator("cuda").manual_seed(0),
                          compress=True)
    torch.cuda.synchronize()
    rec = {"init_s": time.perf_counter() - t}
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{tag}: {n_params} parameters")
    active = M.active_params(cfg)
    before = {k: x.reshape(-1)[:1 << 20].clone()
              for k, x in tree_flatten(state.params)}
    ccfg = GC.CompressConfig()
    crs_seen, orig = [], GC.compress_tree

    def spy(grads, ef, c, inplace=False):
        out = orig(grads, ef, c, inplace)
        crs_seen.append({k: float(v) for k, v in tree_flatten(out[2])})
        return out

    step = TS.make_train_step(cfg, OPT.AdamWConfig(lr=TRAIN_LR),
                              microbatches=TRAIN_MB, compress=ccfg,
                              donate=True)
    data = make_data_iter(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device="cuda")
    steps = []
    GC.compress_tree = spy
    try:
        for i in range(TRAIN_STEPS):
            batch = data(i)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
            m = {k: float(v) for k, v in m.items()}
            crs = crs_seen[-1]
            gated = sorted(k for k, c in crs.items() if c >= ccfg.gate_ratio)
            for k, r in tree_flatten(state.ef.residuals):
                if k not in gated and bool(r.any()):
                    raise AssertionError(f"{tag} step {i}: {k} was not "
                                         "gated but its residual is not 0")
            steps.append(dict(ms=ms, gated=gated, crs=crs, **m))
            log(f"{tag} step {i}: {ms:.1f} ms, loss {m['loss']:.5f}, "
                f"grad_norm {m['grad_norm']:.5f}, mean_pred_cr "
                f"{m['mean_pred_cr']:.4f}, {len(gated)}/{len(crs)} leaves "
                f"gated (CRs {min(crs.values()):.3f}-"
                f"{max(crs.values()):.3f})", card)
    finally:
        GC.compress_tree = orig
    if not all(np.isfinite([s["loss"], s["grad_norm"], s["mean_pred_cr"]]).all()
               for s in steps):
        raise AssertionError(f"{tag}: non-finite metrics {steps}")
    changed = {k: int((x.reshape(-1)[:1 << 20] != before[k]).sum())
               for k, x in tree_flatten(state.params)}
    if not changed["embed"]:
        raise AssertionError(f"{tag}: the parameters did not change")
    step_s = float(np.median([s["ms"] for s in steps[1:]])) / 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rec.update(
        params=n_params, active_params=active, steps=steps,
        step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
        model_flops_per_s=6.0 * active * tokens / step_s,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        changed_of_first_2_20=changed)
    rec["bf16_peak_share"] = rec["model_flops_per_s"] / PEAK_BF16_FLOPS
    log(f"{tag} {cfg.name} at {cfg.num_layers} layers: {n_params:,} "
        f"parameters ({active:,} active), init {rec['init_s']:.3f} s; step "
        f"{rec['step_ms']:.1f} ms (median of steps 2-{TRAIN_STEPS}), "
        f"{rec['tokens_per_s']:.1f} tokens/s, model "
        f"{rec['model_flops_per_s'] / 1e12:.2f} TFLOP/s (6 N_active tokens "
        f"/ step, {100 * rec['bf16_peak_share']:.2f} % of the 989 TFLOP/s "
        f"bfloat16 peak), peak device memory {rec['peak_gib']:.2f} GiB; "
        f"first 2^20 values changed by leaf " + json.dumps(changed), card)
    del state, before, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def train_full_width(torch, card) -> dict:
    """(a): ``train_steps`` at granite-3-2b's full width and
    ``TRAIN_LAYERS`` of its 40 layers."""
    from repro_torch.configs.base import get_arch
    return train_steps(torch, card, dataclasses.replace(
        get_arch(TRAIN_ARCH), num_layers=TRAIN_LAYERS), "train (a)")


def leaf_spans(n: int) -> list:
    """(b)'s spans of an ``n``-value leaf, merged where they overlap: its
    first ``TRAIN_HEAD_VALUES`` values and, where the leaf is longer,
    ``TRAIN_SPAN_VALUES`` on each side of AdamW's and ``compress_tree``'s
    first chunk boundary (``optimizer.CHUNK``, ``CHUNK_BLOCKS`` blocks)
    and its last ``TRAIN_SPAN_VALUES`` values from a block boundary on
    (the padded last block among them).  Every span starts on a block
    boundary, so its int8 blocks are the leaf's."""
    from repro_torch.train import grad_compress as GC
    from repro_torch.train import optimizer as OPT
    out = [(0, min(n, TRAIN_HEAD_VALUES))]
    if n > TRAIN_HEAD_VALUES:
        w = TRAIN_SPAN_VALUES
        for b in sorted({OPT.CHUNK, GC.CHUNK_BLOCKS * GC.BLOCK}):
            if b < n:
                out.append((b - w, min(n, b + w)))
        out.append((max(0, (n - w) // GC.BLOCK * GC.BLOCK), n))
    merged = []
    for lo, hi in sorted(out):
        if lo % GC.BLOCK:
            raise AssertionError(f"train (b): span {lo} off a block boundary")
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(hi, merged[-1][1]))
        else:
            merged.append((lo, hi))
    return merged


def train_card_vs_cpu(torch, card) -> dict:
    """(b): granite-3-2b's width at 2 layers, parameters made on the CPU
    and copied to the card, batch 2 x seq 64, float32 and bfloat16: the
    loss and every gradient leaf card against CPU at the training tests'
    bounds; then each piece bit for bit in the dtype (a) runs it in:
    ``compress_tree`` of the CPU's float32 gradients and random
    residuals, and one AdamW step (clip inactive) of the bfloat16
    parameters on those sent gradients with random moments.  The card
    runs both over whole leaves, so its chunk loops cross their
    boundaries; the CPU (whose run over the whole tree took 45-50 s a
    dtype) runs them on each leaf's ``leaf_spans`` only, and each span's
    output is held to the card's at those values.  A span goes through
    the gate its leaf took on the card, whose predicted CR is held
    against ``predicted_cr_int8`` of the whole leaf on the CPU.  The CPU
    tests hold both pieces in both dtypes against the reference."""
    from repro_torch.configs.base import get_arch
    from repro_torch.data.tokens import make_data_iter
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_flatten, tree_leaves, tree_unflatten
    from repro_torch.train import grad_compress as GC
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    def dev(tree):
        return tree_unflatten(tree, [x.to("cuda") for x in tree_leaves(tree)])

    def draws(tree, scale, uniform=False):
        """Random float32 leaves like ``tree``'s, drawn on the card (the
        host's generator would take seconds)."""
        draw = torch.rand if uniform else torch.randn
        return tree_unflatten(tree, [
            draw(x.shape, generator=gen, device="cuda") * scale
            for x in tree_leaves(tree)])

    def span(x, lo, hi):
        return x.reshape(-1)[lo:hi]

    def same_span_bits(what, got, want):
        if not torch.equal(int_bits(torch, got.cpu()), int_bits(torch, want)):
            raise AssertionError(f"train (b) {what}: card != CPU on "
                                 f"{int((got.cpu() != want).sum())} values")

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=TRAIN_CMP_LAYERS)
    tree = M.init_tree(cfg, torch.Generator().manual_seed(5))
    batch = make_data_iter(cfg, TRAIN_CMP_BATCH, TRAIN_CMP_SEQ, seed=6,
                           device="cpu")(0)
    gen = torch.Generator("cuda").manual_seed(7)
    # the clip inactive (its norm's summation order is the library's):
    # the update is then the same bits on every device
    ocfg = OPT.AdamWConfig(lr=TRAIN_LR, grad_clip=1e9)
    spans = {k: leaf_spans(x.numel()) for k, x in tree_flatten(tree)}
    rec = {"spans": {k: [list(s) for s in v] for k, v in spans.items()}}
    sent_card = sent_cpu = None
    for dtype in ("float32", "bfloat16"):
        t = time.perf_counter()
        cfgd = dataclasses.replace(cfg, dtype=dtype)
        dt = getattr(torch, dtype)
        cpu = tree_unflatten(tree, [x.to(dt) for x in tree_leaves(tree)])
        r = {}
        t1 = time.perf_counter()
        lc, gc_ = TS._grads(cfgd, cpu, batch, 1, remat=False)
        r["cpu_grads_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        lg, gg = TS._grads(cfgd, dev(cpu), {k: v.to("cuda") for k, v
                                           in batch.items()}, 1)
        torch.cuda.synchronize()
        r["card_grads_s"] = time.perf_counter() - t1
        r["loss"] = (float(lg), float(lc))
        if abs(float(lg) - float(lc)) > TRAIN_LOSS_RTOL[dtype] * abs(float(lc)):
            raise AssertionError(f"train (b) {dtype}: loss {float(lg)} != "
                                 f"{float(lc)}")
        want = dict(tree_flatten(gc_))
        r["grad_err"] = {k: train_close(torch, x, want[k], dtype, k)
                         for k, x in tree_flatten(gg)}
        del gg
        if dtype == "float32":      # (a) gates float32 microbatch sums
            res = draws(gc_, 1e-4)
            sg, eg, cg = GC.compress_tree(dev(gc_), GC.EFState(res),
                                          GC.CompressConfig())
            torch.cuda.synchronize()
            gate = GC.CompressConfig().gate_ratio
            res_by = dict(tree_flatten(res))
            sent_by, resid_by = dict(tree_flatten(sg)), dict(
                tree_flatten(eg.residuals))
            r["crs"], sent_cpu = {}, {}
            t1 = time.perf_counter()
            for k, cr in tree_flatten(cg):
                g, rs = want[k].reshape(-1), res_by[k].reshape(-1)
                cr_cpu = GC.predicted_cr_int8(g + rs.cpu())
                same_span_bits(f"{dtype} CR {k}", cr, cr_cpu)
                r["crs"][k] = float(cr_cpu)
                # the span through the gate its leaf took
                ccfg = GC.CompressConfig(
                    gate_ratio=0.0 if float(cr_cpu) >= gate else math.inf)
                for lo, hi in spans[k]:
                    sc, ec, _ = GC.compress_tree(
                        {"x": g[lo:hi]}, GC.EFState({"x": span(
                            rs, lo, hi).cpu()}), ccfg)
                    same_span_bits(f"{dtype} sent {k}[{lo}:{hi}]",
                                   span(sent_by[k], lo, hi), sc["x"])
                    same_span_bits(f"{dtype} residuals {k}[{lo}:{hi}]",
                                   span(resid_by[k], lo, hi),
                                   ec.residuals["x"])
                    sent_cpu[(k, lo)] = sc["x"]
            r["cpu_compress_s"] = time.perf_counter() - t1
            sent_card = sg
            del eg, cg, res, res_by, resid_by
        else:                       # ... and updates bfloat16 parameters
            mu, nu = draws(cpu, 1e-3), draws(cpu, 1e-6, uniform=True)
            st = OPT.OptState(torch.tensor(3, dtype=torch.int32), mu, nu)
            pg, og, ng = OPT.apply(ocfg, dev(cpu), sent_card, st)
            torch.cuda.synchronize()
            r["grad_norm"] = float(ng)
            mu_by, nu_by = dict(tree_flatten(mu)), dict(tree_flatten(nu))
            out = [dict(tree_flatten(x)) for x in (pg, og.mu, og.nu)]
            t1 = time.perf_counter()
            for k, p in tree_flatten(cpu):
                for lo, hi in spans[k]:
                    pc, oc, _ = OPT.apply(ocfg, {"x": span(p, lo, hi)},
                                          {"x": sent_cpu[(k, lo)]},
                                          OPT.OptState(st.step, {"x": span(
                                              mu_by[k], lo, hi).cpu()}, {
                                              "x": span(nu_by[k], lo,
                                                        hi).cpu()}))
                    for name, got, w in (("params", out[0][k], pc["x"]),
                                         ("mu", out[1][k], oc.mu["x"]),
                                         ("nu", out[2][k], oc.nu["x"])):
                        same_span_bits(f"{dtype} AdamW {name} {k}[{lo}:{hi}]",
                                       span(got, lo, hi), w)
            r["cpu_adamw_s"] = time.perf_counter() - t1
            del mu, nu, pg, og, out, mu_by, nu_by, sent_card, sent_cpu
        del gc_, want
        r["s"] = time.perf_counter() - t
        rec[dtype] = r
        n_spans = sum(len(v) for v in spans.values())
        log(f"train (b) {dtype} card vs CPU at d_model {cfg.d_model}, "
            f"{TRAIN_CMP_LAYERS} layers, batch {TRAIN_CMP_BATCH} x "
            f"{TRAIN_CMP_SEQ}: loss {r['loss'][0]:.6f} / {r['loss'][1]:.6f}, "
            f"max gradient err {max(r['grad_err'].values()):.3g}; "
            + (f"compress_tree of the float32 gradients (whole leaves on "
               f"the card) bit-equal to the CPU's on {n_spans} spans "
               f"(heads, chunk boundaries, last blocks), CRs of the whole "
               f"leaves bit-equal ({min(r['crs'].values()):.4f}-"
               f"{max(r['crs'].values()):.4f})"
               if "crs" in r else
               f"one AdamW step of the bfloat16 parameters on those sent "
               f"gradients (whole leaves on the card) bit-equal to the "
               f"CPU's on the same {n_spans} spans (clip inactive; card "
               f"norm {r['grad_norm']:.5f})")
            + f"; {r['s']:.2f} s (" + ", ".join(
                f"{k} {v:.2f}" for k, v in r.items() if k.endswith("_s")
                and k != "s") + ")", card)
        del cpu
        gc.collect()
        torch.cuda.empty_cache()
    log("train (b) spans by leaf " + json.dumps(rec["spans"]), card)
    return rec


def train_predictors(torch):
    """UC2's recipe (``tests/test_system.py``): sz3-lorenzo and zfp CR
    models trained on 12 miranda-vx slices of 96^2 at eps = 1e-4 of their
    range, on the card."""
    from repro_torch import compressors as C
    from repro_torch.core import pipeline as PL
    from repro_torch.data import scientific as TSC
    slices = TSC.field_slices("miranda-vx", count=12, n=96, device="cuda")
    eps = 1e-4 * float(slices.max() - slices.min())
    out = {}
    for name in ("sz3-lorenzo", "zfp"):
        crs = torch.tensor([C.get(name).cr(x, eps) for x in slices],
                           dtype=torch.float32, device="cuda")
        out[name] = PL.CRPredictor.train(slices, crs, eps)
    return out


def train_checkpoints(torch, card, tmp) -> dict:
    """(c): at full width and 2 layers, ``loop.run`` for 4 steps with a
    checkpoint every 2, then step 4's deleted and the loop restarted: the
    resumed parameters == the uninterrupted run's within rtol 1e-5 / atol
    1e-6 (bit-equality reported); then one UC2-driven lossy checkpoint of
    the parameters (each tensor's error bound asserted, but on a
    constant tensor, whose zero range the reference floors to an eb of
    1e-12: its error is logged; predicted and achieved CR, time and
    bytes logged), loaded back for one finite step.  A codec UC2 picks for no tensor gets a checkpoint of its own
    (the policy's fallback compressor), so that both encodes' kernels run."""
    from repro_torch.ckpt import checkpoint as CKPT
    from repro_torch.configs.base import get_arch
    from repro_torch.data.tokens import make_data_iter
    from repro_torch.models.params import tree_flatten, tree_leaves
    from repro_torch.train import loop as LOOP
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=TRAIN_CMP_LAYERS)
    step = TS.make_train_step(cfg, OPT.AdamWConfig(lr=TRAIN_LR),
                              microbatches=TRAIN_MB, donate=True)
    data = make_data_iter(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=8, device="cuda")

    def fresh():
        return TS.init_state(cfg, torch.Generator("cuda").manual_seed(9))

    d = os.path.join(tmp, "ckpt")
    lc = LOOP.LoopConfig(total_steps=TRAIN_CKPT_STEPS,
                         ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=d)
    rec = {}
    t = time.perf_counter()
    sa, ra = LOOP.run(cfg, fresh(), step, data, lc)
    torch.cuda.synchronize()
    rec["run_s"] = time.perf_counter() - t
    shutil.rmtree(os.path.join(d, f"step_{TRAIN_CKPT_STEPS:08d}"))
    t = time.perf_counter()
    sb, rb = LOOP.run(cfg, fresh(), step, data, lc)
    torch.cuda.synchronize()
    rec["restart_s"] = time.perf_counter() - t
    if rb.restarts != 1 or sorted(rb.losses) != list(
            range(TRAIN_CKPT_EVERY, TRAIN_CKPT_STEPS)):
        raise AssertionError(f"train (c): restart ran {sorted(rb.losses)}")
    diff = {}
    for (k, a), b in zip(tree_flatten(sa.params), tree_leaves(sb.params)):
        af, bf = a.float(), b.float()
        if not bool(((af - bf).abs() <= TRAIN_RESTART_TOL["atol"]
                     + TRAIN_RESTART_TOL["rtol"] * af.abs()).all()):
            raise AssertionError(f"train (c): resumed {k} differs beyond "
                                 f"{TRAIN_RESTART_TOL}")
        diff[k] = int((a != b).sum())
    rec.update(bit_equal=not any(diff.values()), differing_values=diff,
               losses={"run": ra.losses, "restart": rb.losses})
    log(f"train (c) loop: {TRAIN_CKPT_STEPS} steps with a checkpoint every "
        f"{TRAIN_CKPT_EVERY} in {rec['run_s']:.2f} s; restart from step "
        f"{TRAIN_CKPT_EVERY} in {rec['restart_s']:.2f} s; resumed parameters "
        f"within rtol 1e-5 / atol 1e-6, bit-equal: {rec['bit_equal']} "
        f"(differing values by leaf {json.dumps(diff)}); losses "
        f"{json.dumps({str(k): v for k, v in ra.losses.items()})} vs "
        f"{json.dumps({str(k): v for k, v in rb.losses.items()})}", card)
    del sa
    shutil.rmtree(d, ignore_errors=True)

    t = time.perf_counter()
    preds = train_predictors(torch)
    rec["predictors_s"] = time.perf_counter() - t
    params = sb.params
    flat = CKPT._leaf_paths(params)
    policies = [("uc2", CKPT.LossyPolicy(enabled=True, rel_eb=1e-4,
                                         min_size=4096, predictors=preds,
                                         device="cuda"))]
    rec["lossy"] = {}
    i = 0
    while i < len(policies):
        tag, pol = policies[i]
        i += 1
        d2 = os.path.join(tmp, f"lossy_{tag}")
        t = time.perf_counter()
        man = CKPT.save(d2, 0, params, pol)
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t
        disk = sum(os.path.getsize(os.path.join(d2, "step_00000000", f))
                   for f in os.listdir(os.path.join(d2, "step_00000000")))
        restored = CKPT.load(d2, 0, params)
        lossy = {k: e for k, e in man["tensors"].items() if e["codec"] != "raw"}
        back = CKPT._leaf_paths(restored)
        constant = []
        for k in lossy:
            o, r_ = flat[k].float(), back[k].float()
            rng = float(o.max() - o.min())
            slack = 1.1e-4 * rng + float(o.abs().max()) * 2.0 ** -8
            err = float((o - r_).abs().max())
            if rng == 0.0:
                # the reference's eb floor, 1e-12, puts a constant's
                # codes past int32 (ROADMAP Queue 3, reference notes)
                constant.append(k)
            elif not err <= slack:
                raise AssertionError(f"train (c) {tag} {k}: error {err} > "
                                     f"{slack}")
            lossy[k] = dict(lossy[k], max_err=err, bound=slack)
        metered = sum(e["metered_bytes"] for e in lossy.values())
        raw = sum(e["raw_bytes"] for e in lossy.values())
        rec["lossy"][tag] = dict(save_s=save_s, disk_bytes=disk,
                                 metered_bytes=metered, raw_bytes=raw,
                                 tensors=lossy, constant=constant)
        log(f"train (c) {tag} lossy checkpoint: {len(lossy)} of "
            f"{len(man['tensors'])} tensors lossy, {save_s:.2f} s, "
            f"{raw:,} raw -> {metered:,} metered bytes (CR "
            f"{raw / max(metered, 1):.3f}), {disk:,} bytes on disk "
            "(decompressed form); every error within its bound but on the "
            f"constant tensors {constant} (the reference's eb floor)", card)
        for k, e in lossy.items():
            log(f"train (c) {tag} {k} {tuple(flat[k].shape)}: {e['codec']} "
                f"eps {e['eps']:.4g}, predicted CR "
                + ("n/a" if e["predicted_cr"] is None
                   else f"{e['predicted_cr']:.4f}")
                + f", achieved {e['achieved_cr']:.4f}, max err "
                f"{e['max_err']:.4g}, bound {e['bound']:.4g}")
        if tag == "uc2":
            used = {e["codec"] for e in lossy.values()}
            for name in sorted(set(preds) - used):
                policies.append((name, CKPT.LossyPolicy(
                    enabled=True, rel_eb=1e-4, min_size=4096,
                    compressor=name, device="cuda")))
            state = TS.TrainState(restored, sb.opt, None)
            state, m = step(state, data(TRAIN_CKPT_STEPS))
            rec["restored_loss"] = float(m["loss"])
            if not np.isfinite(rec["restored_loss"]):
                raise AssertionError("train (c): the restored state's step "
                                     "is not finite")
            log(f"train (c): the restored parameters train: loss "
                f"{rec['restored_loss']:.5f}")
            del state
        del restored, back
        shutil.rmtree(d2, ignore_errors=True)
    del sb, params, flat
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_train(torch, card, tmp) -> tuple[dict, dict]:
    """Phase 23: LLM training (``repro_torch.train``, ``ckpt``,
    ``launch.train``) in this process, its kernel launches counted as
    the "Train" path: (a) ``train_full_width``, (b) ``train_card_vs_cpu``,
    (c) ``train_checkpoints`` (the lossy checkpoint runs Gram, Lorenzo and
    ZFP), (d) ``launch.train.main`` with ``--smoke --steps 8 --compress
    --lossy-ckpt`` on the card."""
    from repro_torch.launch import train as LT
    rec = {}
    zero_counts(torch)
    for key, fn in (("a", lambda: train_full_width(torch, card)),
                    ("b", lambda: train_card_vs_cpu(torch, card)),
                    ("c", lambda: train_checkpoints(torch, card, tmp))):
        t = time.perf_counter()
        rec[key] = fn()
        rec[f"{key}_s"] = time.perf_counter() - t
    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = LT.main(["--arch", TRAIN_ARCH, *TRAIN_CLI_ARGS, "--ckpt-dir",
                     os.path.join(tmp, "cli")])
    rec["d_s"] = time.perf_counter() - t
    for line in buf.getvalue().splitlines():
        log(f"train (d) | {line}")
    if sorted(r["losses"]) != list(range(8)) or not np.all(
            np.isfinite(list(r["losses"].values()))):
        raise AssertionError(f"train (d): losses {r['losses']}")
    rec["d"] = {"losses": r["losses"], "step_s": r["step_s"]}
    log(f"train (d) launch.train {' '.join(TRAIN_CLI_ARGS)}: 8 finite "
        f"losses, {rec['d_s']:.2f} s", card)
    counts = read_counts(torch, "Train", ("gram_batched", "lorenzo2d",
                                          "zfp_forward2d"))
    log("train: stages s " + json.dumps({k: round(v, 2) for k, v in
                                         rec.items() if k.endswith("_s")}),
        card)
    return rec, counts


# ---------------------------------------------------------------------------
# phase 24: the moe and vlm families
# ---------------------------------------------------------------------------

def mrope_streams(torch, b: int, s: int, grid=(2, 4)):
    """Qwen2-VL's (t, h, w) position streams of an image of ``grid``
    patches followed by text: (3, b, s) int32, three different streams
    (broadcast positions make M-RoPE plain RoPE)."""
    gh, gw = grid
    img = torch.stack([torch.zeros(gh * gw, dtype=torch.int64),
                       torch.arange(gh).repeat_interleave(gw),
                       torch.arange(gw).repeat(gh)])
    start = int(img.max()) + 1
    text = torch.arange(start, start + s - gh * gw).expand(3, -1)
    pos = torch.cat([img, text], dim=1)[:, :s]
    return pos[:, None, :].expand(3, b, s).to(torch.int32).contiguous()


def gate_leaf_names(torch, cfg) -> list:
    """The paths of the cache leaves the KV gate scores (float, rank >= 4),
    in ``jax.tree.flatten``'s order, from a cache made on the meta
    device (encdec: ``model.init_cache``'s form)."""
    from repro_torch.models import causal_lm as CLM
    from repro_torch.models import whisper as WSP
    from repro_torch.models.params import tree_flatten
    cache = (WSP.empty_cache(cfg, 1, 1, "meta") if cfg.family == "encdec"
             else CLM.init_cache(cfg, 1, 1, "meta"))
    return [k for k, x in tree_flatten(cache)
            if x.dtype in (torch.bfloat16, torch.float32) and x.ndim >= 4]


def family_serve(torch, arch: str, layers: int, card,
                 tag="families (a)", prompt: int = FAM_PROMPT,
                 max_len: int = FAM_MAX_LEN) -> dict:
    """(a): ``serve.engine.Engine`` at full width and ``layers`` layers,
    random parameters from seed 0, ``FAM_BATCH`` prompts of ``prompt``
    ids (encdec: and frames from a seeded generator), ``FAM_STEPS``
    greedy steps, a ``max_len`` cache and the KV gate; then the gate
    through a ``SweepService``: the same ids and metering, one kv_gate
    request of a row per scored leaf.  Each scored leaf's CR and
    decision is logged; the gate must save some bytes of the cache, not
    all."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.sweep_service import ServiceConfig, SweepService
    cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
    names = gate_leaf_names(torch, cfg)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in params.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"{tag} {arch}: {n_params} parameters")
    param_bytes = sum(x.numel() * x.element_size() for x in params.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (FAM_BATCH, prompt),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to("cuda")
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["frames"] = frames_for(torch, cfg, FAM_BATCH, 3)
    runs = {}
    for name in ("direct", "service"):
        svc = (SweepService(ServiceConfig(max_wait_ms=1.0),
                            device=torch.device("cuda"))
               if name == "service" else None)
        crs = []
        try:
            eng = Engine(cfg, params, ServeConfig(
                max_len=max_len, kv_compress=True), sweep_service=svc)

            def spy(leaves, predict=eng._predict_crs):
                crs.append(predict(leaves))
                return crs[-1]

            eng._predict_crs = spy
            t = time.perf_counter()
            ids = eng.generate(batch, steps=FAM_STEPS)
            wall = time.perf_counter() - t
            gate = svc.stats()["methods"].get("kv_gate") if svc else None
        finally:
            if svc is not None:
                svc.close()
        tm = eng.timings
        ratio = eng.scfg.kv_gate_ratio
        runs[name] = dict(
            shape=list(ids.shape), ids=ids.cpu().tolist(),
            prefill_ms=tm["prefill_s"] * 1e3, gate_ms=tm["gate_s"] * 1e3,
            decode_ms_per_step=float(np.median(tm["decode_s"])) * 1e3,
            generate_s=wall, tokens_per_s=FAM_BATCH * FAM_STEPS / wall,
            kv_saved_bytes=eng.kv_saved_bytes,
            kv_total_bytes=eng.kv_total_bytes, kv_gate=gate,
            leaf_crs={k: float(c) for k, c in zip(names, crs[0])},
            gated=[k for k, c in zip(names, crs[0]) if float(c) >= ratio])
    a, b = runs["direct"], runs["service"]
    nums = [r[k] for r in (a, b) for k in ("prefill_ms", "gate_ms",
                                           "decode_ms_per_step",
                                           "tokens_per_s")]
    if a["shape"] != [FAM_BATCH, FAM_STEPS] or not np.all(np.isfinite(nums)):
        raise AssertionError(f"{tag} {arch}: bad run {a['shape']} {nums}")
    if a["ids"] != b["ids"]:
        raise AssertionError(f"{tag} {arch}: the service run's ids differ")
    if (a["kv_saved_bytes"], a["kv_total_bytes"]) != \
            (b["kv_saved_bytes"], b["kv_total_bytes"]) or \
            not 0 < a["kv_saved_bytes"] < a["kv_total_bytes"] or \
            a["leaf_crs"] != b["leaf_crs"]:
        raise AssertionError(f"{tag} {arch}: metering "
                             f"{a['kv_saved_bytes']}/{a['kv_total_bytes']} vs "
                             f"{b['kv_saved_bytes']}/{b['kv_total_bytes']}, "
                             f"CRs {a['leaf_crs']} vs {b['leaf_crs']}")
    if (b["kv_gate"]["completed"], b["kv_gate"]["rows"]) != (1, len(names)):
        raise AssertionError(f"{tag} {arch}: kv_gate {b['kv_gate']} for "
                             f"the leaves {names}")
    rec = dict(layers=cfg.num_layers, params=n_params,
               param_bytes=param_bytes, init_s=init_s, prompt=prompt,
               max_len=max_len, runs=runs,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    for name, r in runs.items():
        log(f"{tag} {arch} at {cfg.num_layers} of "
            f"{get_arch(arch).num_layers} layers, batch {FAM_BATCH} x "
            f"prompt {prompt}, {name}: {n_params:,} parameters, "
            f"{param_bytes / 1e9:.3f} GB, init {init_s:.3f} s, prefill "
            f"{r['prefill_ms']:.2f} ms, gate {r['gate_ms']:.2f} ms, decode "
            f"{r['decode_ms_per_step']:.3f} ms/step, "
            f"{r['tokens_per_s']:.1f} tokens/s, KV saved "
            f"{r['kv_saved_bytes']:,}/{r['kv_total_bytes']:,} B", card)
    log(f"{tag} {arch}: the gate's leaves, CR and decision at ratio "
        f"{ratio}: " + ", ".join(
            f"{k} {c:.4f} {'gated' if k in a['gated'] else 'kept'}"
            for k, c in a["leaf_crs"].items()), card)
    log(f"{tag} {arch}: ids equal with and without the service; "
        f"kv_gate {json.dumps(b['kv_gate'])}; peak device memory "
        f"{rec['peak_gib']:.2f} GiB", card)
    del params, eng, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def family_decode(torch, arch: str, card, tag="families (b)") -> dict:
    """(b): float32 parameters at full width and ``FAM_DECODE_LAYERS``
    layers, capacity factor 64 (no token dropped), as the reference's
    test: prefill 15 tokens and decode the 16th against the full
    forward's last logits (bound 1e-4; for mla_moe the decode step is
    MLA's absorbed form and the forward its expanded one).  For vlm also
    the loss with three different position streams: finite, and not the
    broadcast one."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import causal_lm as CLM
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_arch(arch), num_layers=FAM_DECODE_LAYERS,
                              dtype="float32", capacity_factor=64.0)
    model = M.init_params(cfg, torch.Generator("cuda").manual_seed(0)).float()
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)).to("cuda")
    vlm = cfg.family == "vlm"
    flat = (torch.arange(16, dtype=torch.int32, device="cuda").expand(3, 2, 16)
            if vlm else None)
    with torch.inference_mode():
        full = CLM.logits_fn(model, CLM.forward(
            model, toks[:, :16], cfg, mrope_positions=flat))[:, 15]
        _, cache = M.prefill(model, {"tokens": toks[:, :15]}, cfg, 20)
        lg, _ = M.decode_step(model, cache, toks[:, 15:16], 15, cfg,
                              mrope_positions=None if flat is None
                              else flat[:, :, 15:16])
        err = float((lg - full).abs().max())
        rec = {"max_abs_err": err, "max_logit": float(full.abs().max())}
        log(f"{tag} {arch} float32 decode vs forward at full width, "
            f"{FAM_DECODE_LAYERS} layers: max abs err {err:.3g} (|logit| <= "
            f"{rec['max_logit']:.3g}, bound {LLM_DECODE_TOL})", card)
        if not err < LLM_DECODE_TOL:
            raise AssertionError(f"{tag} {arch}: decode vs forward {err}")
        if vlm:
            batch = {"tokens": toks[:, :16], "labels": toks[:, 1:]}
            streams = mrope_streams(torch, 2, 16).to("cuda")
            rec["loss_broadcast"] = float(M.loss_fn(model, dict(
                batch, mrope_positions=flat), cfg, remat=False))
            rec["loss_streams"] = float(M.loss_fn(model, dict(
                batch, mrope_positions=streams), cfg, remat=False))
            log(f"{tag} {arch}: loss with broadcast positions "
                f"{rec['loss_broadcast']:.6f}, with an image's three "
                f"streams {rec['loss_streams']:.6f}", card)
            if not (np.isfinite(rec["loss_streams"])
                    and rec["loss_streams"] != rec["loss_broadcast"]):
                raise AssertionError(f"{tag} {arch}: losses {rec}")
    del model, cache, full, lg
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def routed_apart_at_near_ties(torch, logits, a, b, err: float,
                              what: str) -> dict:
    """Two routings (``moe.route``'s (weights, idx, pos, keep)) of one
    group stack: ``a`` from ``logits`` (G, T, E), ``b`` from logits at
    most ``err`` from them.  A pair whose expert differs must sit at a
    near-tie of ``logits``: the gap from its rank's logit to the next
    one above or below at most 2 ``err`` (where both gaps are wider, no
    change within ``err`` moves an expert off that rank).  A pair whose
    expert agrees but whose keep differs must be at an expert that some
    differing pair of its group chose on either side (only those
    experts' queues change).  Returns the counts and the widest such
    gap."""
    idx_a, idx_b = a[1].cpu(), b[1].cpu()
    keep_a, keep_b = a[3].cpu(), b[3].cpu()
    k = idx_a.shape[-1]
    top = torch.sort(logits.float().cpu(), dim=-1, descending=True
                     ).values[..., :k + 1]
    below = top[..., :-1] - top[..., 1:]                    # (G, T, k)
    above = torch.cat([torch.full_like(below[..., :1], math.inf),
                       below[..., :-1]], dim=-1)
    gap = torch.minimum(above, below)
    moved = idx_a != idx_b
    widest = float(gap[moved].max()) if bool(moved.any()) else 0.0
    if widest > 2 * err:
        raise AssertionError(f"{what}: a pair routed apart sits {widest:g} "
                             f"from its neighbouring logit, past twice the "
                             f"logits' max abs err {err:g}")
    keep_only = ~moved & (keep_a != keep_b)
    for g, t, c in keep_only.nonzero().tolist():
        touched = set(idx_a[g][moved[g]].tolist()) | set(
            idx_b[g][moved[g]].tolist())
        if int(idx_a[g, t, c]) not in touched:
            raise AssertionError(f"{what}: pair ({g}, {t}, {c}) kept apart "
                                 f"at expert {int(idx_a[g, t, c])}, whose "
                                 "queue no pair routed apart changed")
    return dict(expert_apart=int(moved.sum()), keep_apart=int(
        keep_only.sum()), pairs=moved.numel(), widest_gap=widest,
        gap_bound=2 * err)


def family_card_vs_cpu(torch, arch: str, card, layers=FAM_CMP_LAYERS,
                       dtypes=("float32", "bfloat16"), tag="families (c)",
                       routing_max=FAM_ROUTING_DIFFERS_MAX) -> dict:
    """(c): full width at ``layers`` layers, parameters drawn on the
    card (the host's generator takes ~7 ns a value: 24 s for qwen2-vl's
    embedding, head and layer) and copied to the CPU, so both sides
    hold the same values; in each of ``dtypes`` (the router and the
    SSM's leaves float32 in both; each side casts its own copy).
    Prefill logits and every cache leaf (K/V, MLA's latent and rotary
    key, the SSM's conv window and float32 state) card against CPU at
    phase 22's bounds, positions equal.  MoE: the routing of the card's
    router logits recomputed on the CPU from the same logits, bit-equal
    (top-k indices, dispatch positions, keep, within_cap); the router
    logits card against CPU at phase 22's bounds, and every (token,
    choice) pair routed apart by each side's own logits a near-tie of
    them (``routed_apart_at_near_ties``); the share of such pairs held
    to ``routing_max`` (phase 24:
    ``FAM_ROUTING_DIFFERS_MAX``), and the MoE output held on the tokens
    whose routing agrees (the last token's logits on the rows whose last
    token agrees, of which there must be one: one MoE layer).  vlm: also
    the final hidden states of a float32 forward with three different
    position streams (M-RoPE's angles are float32 in both dtypes)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import causal_lm as CLM
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models import params as PRM
    cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
    made = PRM.init_params(M.param_table(cfg),
                           torch.Generator("cuda").manual_seed(2))
    tree = PRM.tree_unflatten(made, [x.cpu() for x in PRM.tree_leaves(made)])
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    moe = CLM.is_moe(cfg)
    seen = []
    orig_route, orig_ffn = MOE.route, MOE.moe_ffn

    def route_spy(logits, top_k, capacity):
        out = orig_route(logits, top_k, capacity)
        seen.append(("route", logits, top_k, capacity, out))
        return out

    def ffn_spy(x, p, **kw):
        y = orig_ffn(x, p, **kw)
        seen.append(("ffn", y))
        return y

    rec = {}
    for dtype in dtypes:
        cfgd = dataclasses.replace(cfg, dtype=dtype)
        dt = getattr(torch, dtype)

        def cast(x):
            return x.to(dt) if x.dtype == torch.bfloat16 else x

        cpu = CLM.CausalLM(cfgd, PRM.tree_unflatten(
            tree, [cast(x) for x in PRM.tree_leaves(tree)]))
        dev = CLM.CausalLM(cfgd, PRM.tree_unflatten(
            made, [cast(x) for x in PRM.tree_leaves(made)]))
        r = {}
        seen.clear()
        MOE.route, MOE.moe_ffn = route_spy, ffn_spy
        try:
            with torch.inference_mode():
                lc, cc = M.prefill(cpu, {"tokens": toks}, cfgd, 24)
                lg, cg = M.prefill(dev, {"tokens": toks.to("cuda")}, cfgd, 24)
        finally:
            MOE.route, MOE.moe_ffn = orig_route, orig_ffn
        for (name, a), (_, b) in zip(PRM.tree_flatten(cg),
                                     PRM.tree_flatten(cc)):
            if a.dtype == torch.int32:
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"{tag} {arch} {dtype}: {name}")
            else:
                r[name] = llm_close(a, b, dtype, f"{arch} prefill {name}")
        if moe:
            (_, l_cpu, k, cap, out_cpu), (_, y_cpu) = seen[0], seen[1]
            (_, l_dev, _, _, out_dev), (_, y_dev) = seen[2], seen[3]
            e = cfg.num_experts
            again = orig_route(l_dev.cpu(), k, cap)
            got = (*out_dev, MOE.queue_positions(out_dev[1], e) < cap)
            want = (*again, MOE.queue_positions(again[1], e) < cap)
            names = ("weights", "idx", "pos", "keep", "within_cap")
            for name, a, b in list(zip(names, want, got))[1:]:
                if not torch.equal(a, b.cpu()):
                    raise AssertionError(f"{tag} {arch} {dtype}: "
                                         f"{name} from the same logits differ")
            r["router_logits"] = llm_close(l_dev, l_cpu, dtype,
                                           f"{arch} router logits")
            r["routed_apart"] = routed_apart_at_near_ties(
                torch, l_cpu, out_cpu, out_dev, r["router_logits"],
                f"{tag} {arch} {dtype}")
            agree = ((out_cpu[1] == out_dev[1].cpu())
                     & (out_cpu[3] == out_dev[3].cpu()))      # (G, T, k)
            r["routing_differs_share"] = float(1.0 - agree.float().mean())
            if r["routing_differs_share"] > routing_max[dtype]:
                raise AssertionError(
                    f"{tag} {arch} {dtype}: "
                    f"{r['routing_differs_share']:.4f} of the (token, "
                    "choice) pairs route apart on the card and the CPU "
                    f"(at most {routing_max[dtype]})")
            tok_ok = agree.all(dim=-1).reshape(toks.shape)    # (B, S)
            r["tokens_agreeing"] = int(tok_ok.sum())
            r["moe_out"] = llm_close(y_dev.cpu()[tok_ok], y_cpu[tok_ok], dtype,
                                     f"{arch} MoE output, agreeing tokens")
            rows = tok_ok[:, -1]
            if not bool(rows.any()):
                raise AssertionError(f"{tag} {arch} {dtype}: no row's "
                                     "last token routes alike, no logits "
                                     "to compare")
            r["logits"] = llm_close(lg.cpu()[rows], lc[rows], dtype,
                                    f"{arch} prefill logits")
            r["capacity"] = cap
        else:
            r["logits"] = llm_close(lg, lc, dtype, f"{arch} prefill logits")
        if cfg.family == "vlm" and dtype == "float32":
            streams = mrope_streams(torch, 2, 16)
            with torch.inference_mode():
                hc = CLM.forward(cpu, toks, cfgd, mrope_positions=streams)
                hg = CLM.forward(dev, toks.to("cuda"), cfgd,
                                 mrope_positions=streams.to("cuda"))
            r["streams_hidden"] = llm_close(hg, hc, dtype,
                                            f"{arch} hidden, three streams")
        r["max_logit"] = float(lc.float().abs().max())
        rec[dtype] = r
        del cpu, dev, lc, cc, lg, cg
        seen.clear()
        gc.collect()
        torch.cuda.empty_cache()
    del made, tree
    log(f"{tag} {arch} card vs CPU at full width, {layers} "
        f"layer(s), prefill of 2 x 16: " + json.dumps(rec)
        + (" (routing from the card's logits bit-equal on the CPU)"
           if moe else ""), card)
    return rec


def phase_families(torch, card) -> dict:
    """Phase 24: the moe and vlm families (``models.moe``, M-RoPE) in
    this process, each family's model freed before the next: for each of
    ``FAM_SERVE``, (a) ``family_serve``, (b) ``family_decode``, (c)
    ``family_card_vs_cpu``; then (d) ``train_steps`` of phi3.5-moe at
    full width and ``FAM_TRAIN_LAYERS`` layers, its float32 router among
    the gated leaves.  It launches no kernel of its own (products are
    ``torch.matmul``); its launches are read and logged."""
    from repro_torch.configs.base import get_arch
    rec = {}
    zero_counts(torch)
    for arch, layers in FAM_SERVE:
        r = {}
        for key, fn in (("serve", lambda: family_serve(torch, arch, layers,
                                                       card)),
                        ("decode_vs_forward", lambda: family_decode(
                            torch, arch, card)),
                        ("card_vs_cpu", lambda: family_card_vs_cpu(
                            torch, arch, card))):
            t = time.perf_counter()
            r[key] = fn()
            r[f"{key}_s"] = time.perf_counter() - t
        rec[arch] = r
    t = time.perf_counter()
    cfg = dataclasses.replace(get_arch(FAM_TRAIN_ARCH),
                              num_layers=FAM_TRAIN_LAYERS)
    rec["train"] = train_steps(torch, card, cfg, "families (d)")
    rec["train_s"] = time.perf_counter() - t
    router = [k for k in rec["train"]["steps"][0]["crs"] if k.endswith(
        "moe.router")]
    if not router or any(k not in s["gated"] for s in rec["train"]["steps"]
                         for k in router):
        raise AssertionError(f"families (d): the router leaves {router} "
                             "were not gated at every step")
    launches = read_counts(torch, "Families", ())
    rec["launches"] = {n: c["launches"] for n, c in launches.items()}
    log("families: stages s " + json.dumps(
        {a: {k: round(v, 2) for k, v in r.items() if k.endswith("_s")}
         for a, r in rec.items() if isinstance(r, dict) and a != "train"
         and a != "launches"} | {"train_s": round(rec["train_s"], 2)})
        + "; kernel launches " + json.dumps(rec["launches"]), card)
    return rec


# ---------------------------------------------------------------------------
# phase 25: the mla_moe and ssm families
# ---------------------------------------------------------------------------

def mla_card_vs_cpu(torch, arch: str, card, tag="mla/ssm (c)") -> dict:
    """(c): one MLA layer of ``arch`` at full width in float32, its
    parameters drawn on the card and copied to the CPU: the expanded
    form without a cache and as a prefill of 2 x 16 into a 24-slot
    latent cache, then the absorbed form's decode step of the 17th
    token; outputs and cache leaves card against CPU at phase 22's
    float32 bound, positions equal."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import causal_lm as CLM
    from repro_torch.models import params as PRM
    cfg = dataclasses.replace(get_arch(arch), num_layers=2, dtype="float32")
    made = PRM.init_params(CLM.param_table(cfg)["seg1"]["attn"],
                           torch.Generator("cuda").manual_seed(5))
    made = {k: x[0].float() for k, x in made.items()}
    sides = {"cuda": SimpleNamespace(**made),
             "cpu": SimpleNamespace(**{k: x.cpu() for k, x in made.items()})}
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 17, cfg.d_model)).astype(
        np.float32))
    outs = {}
    with torch.inference_mode():
        for dev, p in sides.items():
            xd = x.to(dev)
            cache = CLM.MLACache(
                torch.zeros((2, 24, cfg.kv_lora_rank), device=dev),
                torch.zeros((2, 24, cfg.qk_rope_head_dim), device=dev),
                torch.full((2, 24), 10 ** 9, dtype=torch.int32, device=dev))
            expanded = CLM.mla_block(xd[:, :16], p, cfg)
            prefill = CLM.mla_block(xd[:, :16], p, cfg, cache=cache)
            absorbed = CLM.mla_block(xd[:, 16:], p, cfg, cache=cache,
                                     pos_offset=16)
            outs[dev] = dict(expanded=expanded, prefill=prefill,
                             absorbed=absorbed, ckv=cache.ckv,
                             krope=cache.krope, pos=cache.pos)
    rec = {}
    for k, want in outs["cpu"].items():
        got = outs["cuda"][k]
        if k == "pos":
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"{tag} {arch} MLA: pos")
            continue
        rec[k] = llm_close(got, want, "float32", f"{arch} MLA {k}")
    log(f"{tag} {arch}: one MLA layer card vs CPU at full width in float32 "
        "(expanded, prefill into the latent cache, absorbed decode): max "
        "abs err " + json.dumps(rec), card)
    del made, sides, outs
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_mla_ssm(torch, card) -> dict:
    """Phase 25: the mla_moe and ssm families (``models.causal_lm``'s MLA
    and dense first layer, ``models.ssm``) in this process, each model
    freed before the next: for each of ``FAM2_SERVE``, (a)
    ``family_serve``, (b)
    ``family_decode`` (deepseek: MLA's absorbed form against its
    expanded one), (c) ``family_card_vs_cpu`` at ``FAM2_CMP``'s layers
    and dtypes (routing from the same logits bit-equal) and, for
    deepseek, ``mla_card_vs_cpu``; then (d) ``train_steps`` of mamba2 at
    full depth, its float32 SSM leaves among the gate's leaves.  It
    launches no kernel of its own (products are ``torch.matmul``); its
    launches are read and logged."""
    from repro_torch.configs.base import get_arch
    rec = {}
    zero_counts(torch)
    for arch, layers in FAM2_SERVE:
        cmp_layers, dtypes = FAM2_CMP[arch]
        parts = [("serve", lambda: family_serve(
                     torch, arch, layers, card, "mla/ssm (a)")),
                 ("decode_vs_forward", lambda: family_decode(
                     torch, arch, card, "mla/ssm (b)")),
                 ("card_vs_cpu", lambda: family_card_vs_cpu(
                     torch, arch, card, cmp_layers, dtypes, "mla/ssm (c)",
                     FAM2_ROUTING_DIFFERS_MAX))]
        if get_arch(arch).family == "mla_moe":
            parts.append(("mla_card_vs_cpu",
                          lambda: mla_card_vs_cpu(torch, arch, card)))
        r = {}
        for key, fn in parts:
            t = time.perf_counter()
            r[key] = fn()
            r[f"{key}_s"] = time.perf_counter() - t
        rec[arch] = r
    t = time.perf_counter()
    rec["train"] = train_steps(torch, card, get_arch(FAM2_TRAIN_ARCH),
                               "mla/ssm (d)")
    rec["train_s"] = time.perf_counter() - t
    leaves = [k for k in rec["train"]["steps"][0]["crs"]
              if k.endswith(FAM2_SSM_F32)]
    if len(leaves) != len(FAM2_SSM_F32) or any(
            set(leaves) - set(s["crs"]) for s in rec["train"]["steps"]):
        raise AssertionError(f"mla/ssm (d): the float32 SSM leaves "
                             f"{leaves} are not among the gate's leaves")
    log("mla/ssm (d): the float32 SSM leaves' CRs by step " + json.dumps(
        [{k: [round(s["crs"][k], 4), k in s["gated"]] for k in leaves}
         for s in rec["train"]["steps"]]), card)
    launches = read_counts(torch, "MLA/SSM", ())
    rec["launches"] = {n: c["launches"] for n, c in launches.items()}
    log("mla/ssm: stages s " + json.dumps(
        {a: {k: round(v, 2) for k, v in r.items() if k.endswith("_s")}
         for a, r in rec.items() if a in dict(FAM2_SERVE)}
        | {"train_s": round(rec["train_s"], 2)})
        + "; kernel launches " + json.dumps(rec["launches"]), card)
    return rec


# ---------------------------------------------------------------------------
# phase 26: the hybrid and encdec families
# ---------------------------------------------------------------------------

def phase26_cfg(arch: str, depth, **kw):
    """``arch``'s config at full width: hymba at ``depth`` = (layers,
    global layers), whisper at ``depth`` encoder and decoder layers."""
    from repro_torch.configs.base import get_arch
    cfg = get_arch(arch)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=depth,
                                   encoder_layers=depth, **kw)
    return dataclasses.replace(cfg, num_layers=depth[0],
                               num_global_layers=depth[1], **kw)


def frames_for(torch, cfg, b: int, seed: int, device="cuda"):
    """(b, encoder_frames, d_model) frames from a seeded generator on
    ``device``, in the activation dtype."""
    return torch.randn((b, cfg.encoder_frames, cfg.d_model),
                       generator=torch.Generator(device).manual_seed(seed),
                       device=device).to(getattr(torch, cfg.dtype))


def phase26_decode(torch, arch: str, card, tag="hybrid/encdec (b)") -> dict:
    """(b): float32 parameters at full width (hymba at
    ``HYB_DECODE_DEPTH``, a prompt of ``HYB_DECODE_PROMPT`` ids past the
    window; whisper at ``ENC_DECODE_LAYERS`` + as many, 15 ids and 1500
    frames): the prefill's logits and 2 decode steps' against the full
    forward's at the same positions (bound 1e-4)."""
    from repro_torch.models import causal_lm as CLM
    from repro_torch.models import model as M
    from repro_torch.models import whisper as WSP
    enc = arch == ENC_ARCH
    cfg = phase26_cfg(arch, ENC_DECODE_LAYERS if enc
                      else HYB_DECODE_DEPTH, dtype="float32")
    prompt, steps = (15 if enc else HYB_DECODE_PROMPT), 2
    model = M.init_params(cfg, torch.Generator("cuda").manual_seed(0)).float()
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, prompt + steps)).astype(np.int32)).to("cuda")
    batch = {"tokens": toks[:, :prompt]}
    errs = []
    with torch.inference_mode():
        if enc:
            batch["frames"] = frames_for(torch, cfg, 2, 5)
            mem = WSP.encode(model, batch["frames"], cfg)
            full = CLM.logits_fn(model, WSP.decode(model, toks, mem, cfg)[0])
        else:
            full = CLM.logits_fn(model, CLM.forward(model, toks, cfg))
        lg, cache = M.prefill(model, batch, cfg, prompt + steps + 2)
        for i in range(prompt, prompt + steps + 1):
            errs.append(float((lg - full[:, i - 1]).abs().max()))
            if i < prompt + steps:
                lg, cache = M.decode_step(model, cache, toks[:, i:i + 1], i,
                                          cfg)
    rec = {"layers": cfg.num_layers, "prompt": prompt, "max_abs_err": errs,
           "max_logit": float(full.abs().max())}
    log(f"{tag} {arch} float32 prefill of {prompt} ids and {steps} decode "
        f"steps vs the forward at full width, {cfg.num_layers} layers"
        + (f" (+ {cfg.encoder_layers} encoder layers, "
           f"{cfg.encoder_frames} frames)" if enc else
           f" (segments {CLM.segments(cfg)}, window {cfg.window_size}, "
           f"{cfg.meta_tokens} meta tokens)")
        + f": max abs err {errs} (|logit| <= {rec['max_logit']:.3g}, bound "
        f"{LLM_DECODE_TOL})", card)
    if not max(errs) < LLM_DECODE_TOL:
        raise AssertionError(f"{tag} {arch}: decode vs forward {errs}")
    del model, cache, full, lg
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase26_card_vs_cpu(torch, arch: str, card,
                        tag="hybrid/encdec (c)") -> dict:
    """(c): full width at ``HYB_CMP_DEPTH`` / ``ENC_CMP_LAYERS``,
    parameters drawn on the card and copied to the CPU, in each case of
    ``HYB_CMP`` / ``ENC_CMP`` (dtype, batch, prompt, max_len; the SSM's
    float32 leaves stay float32): the prefill's logits and every cache
    leaf card against CPU at phase 22's bounds, positions equal; hymba's
    float32 case passes the window and wraps its ring on both sides;
    whisper also the encoder's memory of the same 1500 frames."""
    from repro_torch.models import model as M
    from repro_torch.models import params as PRM
    from repro_torch.models import whisper as WSP
    enc = arch == ENC_ARCH
    cfg = phase26_cfg(arch, ENC_CMP_LAYERS if enc else HYB_CMP_DEPTH)
    made = PRM.init_params(M.param_table(cfg),
                           torch.Generator("cuda").manual_seed(2))
    tree = PRM.tree_unflatten(made, [x.cpu() for x in PRM.tree_leaves(made)])
    rec = {}
    for dtype, b, prompt, max_len in (ENC_CMP if enc else HYB_CMP):
        cfgd = dataclasses.replace(cfg, dtype=dtype)
        dt = getattr(torch, dtype)

        def cast(x):
            return x.to(dt) if x.dtype == torch.bfloat16 else x

        cpu = M.build(cfgd, PRM.tree_unflatten(
            tree, [cast(x) for x in PRM.tree_leaves(tree)]))
        dev = M.build(cfgd, PRM.tree_unflatten(
            made, [cast(x) for x in PRM.tree_leaves(made)]))
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (b, prompt)).astype(np.int32))
        sides = {"cpu": {"tokens": toks}, "cuda": {"tokens": toks.to("cuda")}}
        if enc:
            fr = frames_for(torch, cfgd, b, 6)
            sides["cuda"]["frames"], sides["cpu"]["frames"] = fr, fr.cpu()
        memories, orig = [], WSP.encode

        def encode_spy(*a, **kw):
            memories.append(orig(*a, **kw))
            return memories[-1]

        WSP.encode = encode_spy
        try:
            with torch.inference_mode():
                lc, cc = M.prefill(cpu, sides["cpu"], cfgd, max_len)
                lg, cg = M.prefill(dev, sides["cuda"], cfgd, max_len)
        finally:
            WSP.encode = orig
        r = {}
        for (name, a), (_, w) in zip(PRM.tree_flatten(cg),
                                     PRM.tree_flatten(cc)):
            if a.dtype == torch.int32:
                if not torch.equal(a.cpu(), w):
                    raise AssertionError(f"{tag} {arch} {dtype}: {name}")
            else:
                r[name] = llm_close(a, w, dtype, f"{arch} prefill {name}")
        r["logits"] = llm_close(lg, lc, dtype, f"{arch} prefill logits")
        if enc:
            r["memory"] = llm_close(memories[1], memories[0], dtype,
                                    f"{arch} encoder memory")
        else:
            slots = cc["seg1"].attn.k.shape[2]
            r["ring_wrapped"] = prompt + cfg.meta_tokens > slots
            r["past_window"] = prompt + cfg.meta_tokens > cfg.window_size
        r["max_logit"] = float(lc.float().abs().max())
        rec[f"{dtype} {b}x{prompt}"] = r
        del cpu, dev, lc, cc, lg, cg, memories
        gc.collect()
        torch.cuda.empty_cache()
    f32 = None if enc else rec[f"float32 {HYB_CMP[1][1]}x{HYB_CMP[1][2]}"]
    if f32 is not None and not (f32["ring_wrapped"] and f32["past_window"]):
        raise AssertionError(f"{tag} {arch}: the float32 prefill did not "
                             "pass the window and wrap the windowed "
                             "segment's ring")
    del made, tree
    log(f"{tag} {arch} card vs CPU at full width, {cfg.num_layers} "
        f"layer(s)" + (f" + {cfg.encoder_layers} encoder layer(s), "
                       f"{cfg.encoder_frames} frames" if enc else "")
        + ": " + json.dumps(rec), card)
    return rec


def phase_hybrid_encdec(torch, card) -> dict:
    """Phase 26: the hybrid and encdec families (hymba in
    ``models.causal_lm``, ``models.whisper``) at full width and full
    depth, in this process, each model freed before the next: for each
    family, (a) ``family_serve`` whole (hymba: ``HYB_PROMPT`` ids past
    its window and ring; whisper: 1500 frames), the parameter count the
    published one, (b) ``phase26_decode``, (c) ``phase26_card_vs_cpu``;
    then (d) ``train_steps`` of hymba at ``HYB_TRAIN_DEPTH`` (its float32
    SSM leaves among the gate's) and of whisper at ``ENC_TRAIN_LAYERS``
    + as many, frames in the batch.  It launches no kernel of its own;
    its launches are read and logged."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import causal_lm as CLM
    rec = {}
    zero_counts(torch)
    for arch in (HYB_ARCH, ENC_ARCH):
        cfg = get_arch(arch)
        hyb = cfg.family == "hybrid"
        r = {}
        for key, fn in (
                ("serve", lambda: family_serve(
                    torch, arch, cfg.num_layers, card, "hybrid/encdec (a)",
                    *((HYB_PROMPT, HYB_MAX_LEN) if hyb else ()))),
                ("decode_vs_forward", lambda: phase26_decode(
                    torch, arch, card)),
                ("card_vs_cpu", lambda: phase26_card_vs_cpu(
                    torch, arch, card))):
            t = time.perf_counter()
            r[key] = fn()
            r[f"{key}_s"] = time.perf_counter() - t
        want = PHASE26_PARAMS.get(arch)
        if want is not None and r["serve"]["params"] != want:
            raise AssertionError(f"hybrid/encdec (a) {arch}: "
                                 f"{r['serve']['params']} parameters, not "
                                 f"{want}")
        rec[arch] = r
    for arch, depth in ((HYB_ARCH, HYB_TRAIN_DEPTH),
                        (ENC_ARCH, ENC_TRAIN_LAYERS)):
        t = time.perf_counter()
        cfg = phase26_cfg(arch, depth)
        r = train_steps(torch, card, cfg, "hybrid/encdec (d)")
        if arch == HYB_ARCH:
            leaves = [k for k in r["steps"][0]["crs"]
                      if k.endswith(FAM2_SSM_F32)]
            if len(leaves) != len(FAM2_SSM_F32) * len(CLM.segments(cfg)) \
                    or any(set(leaves) - set(s["crs"]) for s in r["steps"]):
                raise AssertionError(f"hybrid/encdec (d): the float32 SSM "
                                     f"leaves {leaves} are not among the "
                                     "gate's leaves")
            log("hybrid/encdec (d): the float32 SSM leaves' CRs by step "
                + json.dumps([{k: [round(s["crs"][k], 4), k in s["gated"]]
                               for k in leaves} for s in r["steps"]]), card)
        rec[f"train {arch}"] = r
        rec[f"train {arch}_s"] = time.perf_counter() - t
    launches = read_counts(torch, "Hybrid/encdec", ())
    rec["launches"] = {n: c["launches"] for n, c in launches.items()
                       if c["launches"]}
    if rec["launches"]:
        raise AssertionError(f"hybrid/encdec: the families' path launched "
                             f"the sweep kernels {rec['launches']}")
    log("hybrid/encdec: stages s " + json.dumps(
        {a: {k: round(v, 2) for k, v in rec[a].items() if k.endswith("_s")}
         for a in (HYB_ARCH, ENC_ARCH)}
        | {k: round(v, 2) for k, v in rec.items() if k.endswith("_s")})
        + "; kernel launches " + json.dumps(rec["launches"]), card)
    return rec


# ---------------------------------------------------------------------------
# phase 27: training across processes on the pod and data axes
# ---------------------------------------------------------------------------

def bits_digest(torch, x) -> list:
    """Two int64 sums of a tensor's bit patterns (as integers of its
    width): plain and position-weighted, exact and order-free integer
    arithmetic on its device, so two tensors with the same bits give the
    same pair, and one flipped bit changes both."""
    flat = x.detach().reshape(-1)
    ints = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        flat.element_size()])
    s1 = torch.zeros((), dtype=torch.int64, device=flat.device)
    s2 = torch.zeros((), dtype=torch.int64, device=flat.device)
    for lo in range(0, flat.numel(), 1 << 24):
        b = ints[lo:lo + (1 << 24)].to(torch.int64)
        w = torch.arange(lo, lo + b.numel(), dtype=torch.int64,
                         device=flat.device) * 2654435761 % 2147483647 + 1
        s1 += b.sum()
        s2 += (b * w).sum()
    return [int(s1), int(s2)]


def tree_digests(torch, tree) -> dict:
    from repro_torch.models.params import tree_flatten
    return {k: bits_digest(torch, v) for k, v in tree_flatten(tree)}


def across_cfg():
    from repro_torch.configs.base import get_arch
    return dataclasses.replace(get_arch(ACROSS_ARCH), num_layers=ACROSS_LAYERS)


def across_serial(torch, out_path: Path) -> None:
    """27 (a)'s serial composition, in this process while the ranks run:
    step 1 of two pods from the ranks' initial parameters (seed
    ``SEED`` on the card) -- each pod's ``_grads`` on its rows, the port's
    ``quantize_int8`` of ``g + 0`` (the zero residual), the pods' mean
    (``pod_mean``) and each pod's residual -- as bit digests, and the
    compressed mean's relative error against the plain mean, per leaf."""
    from repro_torch.data.tokens import make_data_iter
    from repro_torch.dist import collectives as COL
    from repro_torch.models import model as MM
    from repro_torch.models.params import tree_flatten
    from repro_torch.train import train_step as TS
    cfg = across_cfg()
    params = MM.init_tree(cfg, torch.Generator("cuda").manual_seed(SEED))
    batch = make_data_iter(cfg, ACROSS_BATCH, ACROSS_SEQ, seed=SEED,
                           device="cuda")(0)
    pods = [TS._grads(cfg, params, TS._rows(batch, 2, p), ACROSS_MB)
            for p in range(2)]
    out = {"loss": float((pods[0][0] + pods[1][0]) * torch.tensor(
        0.5, dtype=torch.float32)), "leaves": {}, "rel": {}}
    grads = [dict(tree_flatten(g)) for _, g in pods]
    for k in grads[0]:
        gf = [g[k].to(torch.float32) + torch.zeros_like(g[k], dtype=torch.float32)
              for g in grads]
        qs = [COL.quantize_int8(x) for x in gf]
        synced = COL.pod_mean([q for q, _ in qs], [s for _, s in qs])
        plain = (gf[0] + gf[1]) * 0.5
        out["rel"][k] = float((synced - plain).abs().max()
                              / plain.abs().max().clamp(min=1e-30))
        out["leaves"][k] = {
            "q": [bits_digest(torch, q) for q, _ in qs],
            "s": [bits_digest(torch, s) for _, s in qs],
            "synced": bits_digest(torch, synced),
            "res": [bits_digest(torch, COL.residual(x, q, s))
                    for x, (q, s) in zip(gf, qs)]}
        del gf, qs, synced, plain
    out_path.write_text(json.dumps(out))
    del params, pods, grads, batch
    gc.collect()
    torch.cuda.empty_cache()


def across_child(torch, dev, rank: int) -> dict:
    """27 (a)-(c) in a rank of phase 17 (c)'s two-rank gloo group, on
    ``dev`` (granite-3-2b at full width, ``ACROSS_LAYERS`` layers, batch
    ``ACROSS_BATCH`` x ``ACROSS_SEQ`` in ``ACROSS_MB`` microbatches):

    (a) the podsync step on a 2 x 1 x 1 mesh, one pod a rank, the int8
        collective with error feedback (``gate_ratio`` 0),
        ``ACROSS_POD_STEPS`` donated steps: each rank's parameters and
        moments equal to the other's (bit digests exchanged) after every
        step; step 1's codes, scales, gathered codes, synced gradients
        and residuals as digests, for the main process to hold against
        its serial composition; step ms, each all-gather's bytes and ms,
        the loss per step, peak memory;
    (c) one bfloat16 and one float32 leaf of (a)'s state placed by
        ``remesh_state`` on a 2 x 1 (data, model) mesh -- each rank's
        block bit-equal to its slice of the leaf -- then on
        ``shrink_mesh(.., "data", 1)``: rank 0 holds the whole leaf, bit
        for bit;
    (b) the pjit step across the 2 x 1 mesh's data axis,
        ``ACROSS_DP_STEPS`` donated steps without compression: parameters
        equal on both ranks after every step; rank 0 then runs the
        whole batch in one process from the same start and holds the
        losses and parameters to the LLM bounds (bfloat16: rtol 2e-2 /
        atol 2 sum(lr), at most 1 % of a leaf past 2e-4 + 2e-2 |ref|)."""
    import torch.distributed as dist
    from repro_torch import kernels as K
    from repro_torch.data.tokens import make_data_iter
    from repro_torch.dist import collectives as COL
    from repro_torch.dist import fault as F
    from repro_torch.dist import sharding as S
    from repro_torch.launch import mesh as M
    from repro_torch.models import model as MM
    from repro_torch.models import params as PRM
    from repro_torch.models.params import tree_flatten
    from repro_torch.train import grad_compress as GC
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS
    cuda = dev.type != "cpu"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.cuda.reset_peak_memory_stats(dev)
    before = K.launch_counts()
    cfg = across_cfg()
    rec = {"rank": rank}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    gather_cpu = COL.all_gather

    def same_on_ranks(what, digests: dict) -> None:
        mine = torch.tensor([v for k in sorted(digests) for v in digests[k]],
                            dtype=torch.int64)
        both = gather_cpu(mine, dist.group.WORLD)
        if not torch.equal(both[0], both[1]):
            bad = [k for i, k in enumerate(sorted(digests))
                   if not torch.equal(both[0][2 * i:2 * i + 2],
                                      both[1][2 * i:2 * i + 2])]
            raise AssertionError(f"across (rank {rank}) {what}: the ranks "
                                 f"differ on {bad}")

    data = make_data_iter(cfg, ACROSS_BATCH, ACROSS_SEQ, seed=SEED,
                          device=dev)
    ocfg = OPT.AdamWConfig(lr=TRAIN_LR)
    # (b) without warmup: every entry moves by ~lr at step 1, so the
    # parameters test the averaged gradients' signs and sizes
    ocfg_b = OPT.AdamWConfig(lr=TRAIN_LR, warmup_steps=1)

    # (a) podsync
    t0 = time.perf_counter()
    pod_mesh = M.make_mesh((2, 1, 1), ("pod", "data", "model"))
    state = TS.stack_for_podsync(TS.init_state(
        cfg, torch.Generator(dev).manual_seed(SEED), compress=True), 2)
    sync()
    rec["a_init_s"] = time.perf_counter() - t0
    step = TS.make_train_step(
        cfg, ocfg, microbatches=ACROSS_MB, compress=GC.CompressConfig(
            enabled=True, gate_ratio=0.0), mode="podsync", mesh=pod_mesh,
        donate=True)
    gathers, first = [], {}
    orig = (COL.all_gather, COL.quantize_int8, COL.pod_mean)

    def gather(x, group):
        sync()
        t = time.perf_counter()
        out = orig[0](x, group)
        sync()
        gathers.append((x.numel() * x.element_size(),
                        1e3 * (time.perf_counter() - t)))
        if first.get("on") and x.dtype == torch.int8:
            first["gathered"].append([bits_digest(torch, o) for o in out])
        return out

    def quantize(x):
        q, s = orig[1](x)
        if first.get("on"):
            first["q"].append(bits_digest(torch, q))
            first["s"].append(bits_digest(torch, s))
        return q, s

    def mean(qs, ss):
        out = orig[2](qs, ss)
        if first.get("on"):
            first["synced"].append(bits_digest(torch, out))
        return out

    COL.all_gather, COL.quantize_int8, COL.pod_mean = gather, quantize, mean
    steps = []
    try:
        for i in range(ACROSS_POD_STEPS):
            if i == 0:
                first.update(on=True, q=[], s=[], gathered=[], synced=[])
            batch = data(i)
            n0 = len(gathers)
            sync()
            t = time.perf_counter()
            state, m = step(state, batch)
            sync()
            ms = 1e3 * (time.perf_counter() - t)
            first["on"] = False
            st = {"ms": ms, "loss": float(m["loss"]),
                  "grad_norm": float(m["grad_norm"]),
                  "gather_bytes": sum(b for b, _ in gathers[n0:]),
                  "gather_ms": sum(t_ for _, t_ in gathers[n0:]),
                  "gathers": len(gathers) - n0}
            same_on_ranks(f"(a) step {i} parameters and moments",
                          {f"{part}.{k}": v for part, tree in (
                              ("params", state.params), ("mu", state.opt.mu),
                              ("nu", state.opt.nu))
                           for k, v in tree_digests(torch, tree).items()})
            if i == 0:
                first["res"] = list(tree_digests(
                    torch, state.ef.residuals).values())
                first["loss"] = float(m["loss"])
            steps.append(st)
    finally:
        COL.all_gather, COL.quantize_int8, COL.pod_mean = orig
    first.pop("on")
    first["names"] = [k for k, _ in tree_flatten(state.params)]
    rec["a"] = {"steps": steps, "first": first, "params": sum(
        x.numel() for x in PRM.tree_leaves(state.params)),
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                     if cuda else None)}
    rec["a_s"] = time.perf_counter() - t0

    # (c) re-meshing one leaf of each dtype of (a)'s state
    t0 = time.perf_counter()
    data_mesh = M.make_mesh((2, 1), ("data", "model"))
    axes = dict(tree_flatten(PRM.logical_axes(MM.param_table(cfg)),
                             is_leaf=lambda x: isinstance(x, tuple)))
    name = "seg0.attn.wq"
    tree = {"p": state.params["seg0"]["attn"]["wq"][0],
            "m": state.opt.mu["seg0"]["attn"]["wq"][0]}
    tax = {"p": axes[name], "m": axes[name]}
    placed = F.remesh_state(tree, tax, data_mesh)
    for k, leaf in tree.items():
        d = placed[k]
        spec = S.spec_for(leaf.shape, tax[k], data_mesh)
        local = leaf
        for dim, part in enumerate(spec):
            if part == "data":
                n = leaf.shape[dim] // 2
                local = local.narrow(dim, rank * n, n)
        if not torch.equal(d.to_local(), local):
            raise AssertionError(f"across (c) rank {rank}: {k} ({leaf.dtype}"
                                 f") block differs from its slice")
    small = F.shrink_mesh(data_mesh, "data", 1)
    replaced = F.remesh_state(placed, tax, small)
    for k, leaf in tree.items():
        got = replaced[k].to_local()
        if rank == 0 and not torch.equal(got, leaf):
            raise AssertionError(f"across (c): {k} ({leaf.dtype}) differs "
                                 "after shrink_mesh")
        if rank != 0 and got.numel():
            raise AssertionError(f"across (c) rank {rank}: holds {k} outside "
                                 "the shrunk mesh")
    rec["c"] = {"leaves": {k: [str(v.dtype), list(v.shape), str(spec)]
                           for k, v in tree.items()}}
    rec["c_s"] = time.perf_counter() - t0
    del state, step, tree, placed, replaced
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # (b) data-parallel pjit, then the whole batch in one process
    t0 = time.perf_counter()
    state = TS.init_state(cfg, torch.Generator(dev).manual_seed(SEED))
    with S.use_mesh(data_mesh):
        step = TS.make_train_step(cfg, ocfg_b, microbatches=ACROSS_MB,
                                  donate=True)
    dp = []
    for i in range(ACROSS_DP_STEPS):
        batch = data(i)
        sync()
        t = time.perf_counter()
        state, m = step(state, batch)
        sync()
        dp.append({"ms": 1e3 * (time.perf_counter() - t),
                   "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
        same_on_ranks(f"(b) step {i} parameters", tree_digests(torch,
                                                              state.params))
    rec["b"] = {"steps": dp}
    if rank == 0:
        whole = TS.init_state(cfg, torch.Generator(dev).manual_seed(SEED))
        one = TS.make_train_step(cfg, ocfg_b, microbatches=ACROSS_MB,
                                 donate=True)
        lr_sum, worst = 0.0, {}
        for i in range(ACROSS_DP_STEPS):
            whole, m = one(whole, data(i))
            lr_sum += float(OPT._schedule(ocfg_b, i + 1))
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            if abs(dp[i]["loss"] - loss) > TRAIN_LOSS_RTOL[cfg.dtype] * abs(
                    loss) or abs(dp[i]["grad_norm"] - gn) > 2e-2 * gn:
                raise AssertionError(
                    f"across (b) step {i}: loss / grad_norm {dp[i]['loss']}"
                    f" / {dp[i]['grad_norm']} against the whole batch's "
                    f"{loss} / {gn}")
            dp[i]["whole_loss"], dp[i]["whole_grad_norm"] = loss, gn
        got = dict(tree_flatten(state.params))
        for k, ref in tree_flatten(whole.params):
            g, r = got[k].float(), ref.float()
            err = (g - r).abs()
            far = int((err > 2 * lr_sum + 2e-2 * r.abs()).sum())
            off = float((err > 2e-4 + 2e-2 * r.abs()).float().mean())
            worst[k] = [float(err.max()), off]
            if far or off > 0.01:
                raise AssertionError(f"across (b) {k}: {far} entries past "
                                     f"2 sum(lr), {off:.4f} past the bound")
        rec["b"]["vs_whole"] = worst
        del whole, one
    rec["b_s"] = time.perf_counter() - t0
    total, _ = K.launches_since(before)
    rec["launches"] = {k: v for k, v in total.items() if v}
    del state, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def across_check(children: list, serial: dict, card) -> dict:
    """Phase 27 (a)-(c) from the ranks' records: step 1's codes (each
    rank's own, and the gathered pair), scales, synced gradients and
    residuals equal to the serial composition's digests; the compressed
    mean within ``ACROSS_REL_MAX`` of the plain mean; no kernel launched.
    Returns the record."""
    names = children[0]["a"]["first"]["names"]
    for r, rec in enumerate(children):
        f = rec["a"]["first"]
        if rec["launches"]:
            raise AssertionError(f"across rank {r}: launched the sweep "
                                 f"kernels {rec['launches']}")
        if f["loss"] != serial["loss"]:
            raise AssertionError(f"across (a) rank {r}: step 1 loss "
                                 f"{f['loss']} against {serial['loss']}")
        for j, k in enumerate(names):
            want = serial["leaves"][k]
            for what, got, exp in (
                    ("codes", f["q"][j], want["q"][r]),
                    ("scales", f["s"][j], want["s"][r]),
                    ("gathered codes", f["gathered"][j], want["q"]),
                    ("synced gradient", f["synced"][j], want["synced"]),
                    ("residual", f["res"][j], want["res"][r])):
                if got != exp:
                    raise AssertionError(
                        f"across (a) rank {r} step 1 {k}: {what} differ "
                        "from the serial composition")
    rel = max(serial["rel"].values())
    if not rel < ACROSS_REL_MAX:
        raise AssertionError(f"across (a): compressed mean {rel} from the "
                             "plain mean")
    a = children[0]["a"]
    log(f"across (a) podsync {ACROSS_ARCH} at {ACROSS_LAYERS} layers "
        f"({a['params']:,} parameters), 2 pods x 1 rank on the card: steps "
        + json.dumps([{k: round(v, 4) for k, v in s.items()}
                      for s in a["steps"]])
        + f"; peak {a['peak_gib']} GiB a rank; ranks bit-identical after "
        "every step; step 1's codes, gathered codes, scales, synced "
        f"gradients and residuals of all {len(names)} leaves == the serial "
        f"composition; compressed mean vs plain mean rel err {rel:.4g} "
        f"(worst leaf; < {ACROSS_REL_MAX})", card)
    for r, rec in enumerate(children):
        log(f"across rank {r}: stages s " + json.dumps(
            {k: round(v, 3) for k, v in rec.items() if k.endswith("_s")}), card)
    b = children[0]["b"]
    log("across (b) data-parallel pjit on 2 x 1, ranks bit-identical: steps "
        + json.dumps([{k: round(v, 4) for k, v in s.items()}
                      for s in b["steps"]])
        + "; against the whole batch in one process (max abs err, share "
        "past 2e-4 + 2e-2 |ref|) " + json.dumps(b["vs_whole"]), card)
    log("across (c) remesh_state onto 2 x 1, shrink_mesh to 1: bit-equal "
        + json.dumps(children[0]["c"]["leaves"]), card)
    return {"rel": serial["rel"], "a": a, "b": b, "c": children[0]["c"],
            "stages": [{k: v for k, v in rec.items() if k.endswith("_s")}
                       for rec in children]}


def across_remat(torch, card) -> dict:
    """27 (d): the ``REPRO_REMAT`` policies on one card, in this process:
    granite-3-2b at ``ACROSS_LAYERS`` layers, one gradient pass (a
    step's forward and backward, where remat acts) of batch
    ``ACROSS_BATCH`` x ``ACROSS_SEQ`` in ``ACROSS_MB`` microbatches under
    each policy: ms, peak memory, and the loss and gradients equal to
    ``full``'s bit for bit."""
    from repro_torch.data.tokens import make_data_iter
    from repro_torch.models import model as MM
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import train_step as TS
    cfg = across_cfg()
    params = MM.init_tree(cfg, torch.Generator("cuda").manual_seed(SEED))
    batch = make_data_iter(cfg, ACROSS_BATCH, ACROSS_SEQ, seed=SEED,
                           device="cuda")(0)
    rec, ref = {}, None
    prev = os.environ.get("REPRO_REMAT")
    try:
        for policy in ACROSS_REMAT:
            os.environ["REPRO_REMAT"] = policy
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, grads = TS._grads(cfg, params, batch, ACROSS_MB)
            torch.cuda.synchronize()
            rec[policy] = {"ms": 1e3 * (time.perf_counter() - t),
                           "peak_gib": torch.cuda.max_memory_allocated()
                           / 2 ** 30,
                           "above_start_gib": (torch.cuda.max_memory_allocated()
                                               - base) / 2 ** 30}
            if ref is None:
                ref = (loss, tree_leaves(grads))
            elif not (torch.equal(loss, ref[0]) and all(
                    torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                      ref[1]))):
                raise AssertionError(f"across (d): {policy}'s gradients "
                                     "differ from full's")
            del grads
    finally:
        if prev is None:
            os.environ.pop("REPRO_REMAT", None)
        else:
            os.environ["REPRO_REMAT"] = prev
    log(f"across (d) remat policies, {ACROSS_ARCH} at {ACROSS_LAYERS} layers,"
        f" batch {ACROSS_BATCH} x {ACROSS_SEQ} in {ACROSS_MB} microbatches: "
        "gradients == full's bit for bit; " + json.dumps(
            {p: {k: round(v, 4) for k, v in r.items()} for p, r in rec.items()}),
        card)
    del params, ref, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


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
    from repro_torch.kernels import tune as KT

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # products accumulate in float32, as XLA's do (phase 22)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"lossless stage: {lossless.BACKEND})")
    stages = {}

    t = time.perf_counter()
    _build.build(variants=KT.qent_variants())
    stages["build_s"] = time.perf_counter() - t
    log(f"build: {len(_build.KERNELS)} kernels and "
        f"{len(KT.qent_variants())} q-ent search candidates in "
        f"{stages['build_s']:.2f} s", smi)

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
        (f"{FIELD} slices", data, ebs, picks(data, 2)),
        (f"{SCALE_FIELD} slices", scale, [scale_eps], picks(scale, 3)),
        ("Gaussian type-4 samples", gauss, [GAUSS_EPS], picks(gauss, 3)),
        (f"{VOL_FIELD} volumes", vols, [vol_eps], picks(vols, 2))], smi)
    # ... nor on the eb grid it is launched with
    stages["eb_independence_s"], eb_probes = check_eb_independence(torch, [
        (f"{FIELD} slices", data[picks(data, 1)], ebs),
        (f"{VOL_FIELD} volumes", vols[picks(vols, 1)],
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

    # ---- phase 20: the q-ent kernel's offline launch search
    t = time.perf_counter()
    tuned = phase_tune(torch, smi)
    stages["tune_phase_s"] = time.perf_counter() - t

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

        # ---- phase 16: the load CLI, in this process
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

    # ---- phase 27: training across processes on the pod and data axes;
    # (a)-(c) ran in phase 17 (c)'s ranks, (d) runs here
    gc.collect()
    torch.cuda.empty_cache()
    across = dist.pop("across")
    zero_counts(torch)
    t = time.perf_counter()
    across["d"] = across_remat(torch, smi)
    stages["across_d_s"] = time.perf_counter() - t
    stages["across_ranks_s"] = max(st["a_s"] + st["b_s"] + st["c_s"]
                                   for st in across["stages"])
    across["launches"] = {n: c["launches"] for n, c in read_counts(
        torch, "Across", ()).items() if c["launches"]}
    if across["launches"]:
        raise AssertionError(f"across (d): launched the sweep kernels "
                             f"{across['launches']}")
    log("across: kernel launches {} (ranks and this process); stages s "
        + json.dumps({"ranks": round(stages["across_ranks_s"], 2),
                      "d": round(stages["across_d_s"], 2)}), smi)

    # ---- phase 22: the LLM serving path at granite-3-2b's full width, in
    # this process, on a card freed of the phases' tensors
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    llm = phase_llm(torch, smi)
    stages["llm_phase_s"] = time.perf_counter() - t

    # ---- phase 23: LLM training at granite-3-2b's full width, in this
    # process; its kernels' shapes are held by phase 21 below
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="train_", dir=ROOT / "build")
    try:
        t = time.perf_counter()
        trained, counts["Train"] = phase_train(torch, smi, tmp)
        stages["train_phase_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- phase 24: the moe and vlm families at full width, in this
    # process, after phase 23 has freed the card
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    families = phase_families(torch, smi)
    stages["families_phase_s"] = time.perf_counter() - t

    # ---- phase 25: the mla_moe and ssm families at full width, in this
    # process, after phase 24 has freed the card
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    mla_ssm = phase_mla_ssm(torch, smi)
    stages["mla_ssm_phase_s"] = time.perf_counter() - t

    # ---- phase 26: the hybrid and encdec families at full width and
    # depth, in this process, after phase 25 has freed the card
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    hybrid_encdec = phase_hybrid_encdec(torch, smi)
    stages["hybrid_encdec_phase_s"] = time.perf_counter() - t

    # ---- phase 21: every shape a path launched that no row above holds:
    # its kernel against the plain version there, timed
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
            dist=dist, fabric=fabric, fault=fault, tune=tuned, llm=llm,
            train=trained, families=families, mla_ssm=mla_ssm,
            hybrid_encdec=hybrid_encdec, across=across,
            sort_route_cost=sort_cost,
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

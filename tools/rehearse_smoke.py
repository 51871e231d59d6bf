#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py`` on the CPU at small sizes, without a card.

    python3 tools/rehearse_smoke.py [--out build/rehearse.json]

Writes a copy of ``chip_smoke.py`` to ``build/rehearse/`` with the sizes
cut (12 + 4 slices of 128 x 128, 10 Gaussian samples of 64 x 64, 8
volumes of 16 x 24 x 32; a streamed dataset of 10 slices of 64 x 64 and
7 volumes at a 64 KiB budget; the service's clients 16 requests each
over 2 hot slices and kv leaves of 4096 values; the load CLI at 64 x
64; phase 17's process groups all gloo, every shard on the CPU; phase
20's q-ent shapes at 1/64 of their lengths, on the plain version; phase
22 on granite-3-2b's smoke config, 2 layers of d_model 64, for its
launcher runs, its decode check, its CPU comparison and the gate's
leaves; phase 23 on the same config for its full-width steps, its CPU
comparison, checkpoints and launcher, with AdamW's chunk cut to 4096
values and ``compress_tree``'s to 32 blocks so that its spans of 2048
head values and 256 values each side of a boundary still cross both
chunk boundaries; phase 24 on the smoke configs of phi3.5-moe and
qwen2-vl, 2 layers each where it serves; phase 25 on the smoke configs
of deepseek-v2 and mamba2, at 6 and 48 layers where it serves; phase
26 on the smoke configs of hymba-1.5b and whisper-large-v3, hymba at 5
layers where it serves, its prompts of 48 ids past the smoke window of
32 and its 40 ring slots; phase 27 on granite-3-2b's smoke config at 2
layers, (a)-(c) inside phase 17 (c)'s two CPU ranks as on the card),
every
tensor on the CPU, the
kernel build,
the quotient proof and the launch-count and built-library checks left
out and the
kernel-check phase cut to ZFP's, then runs it with ``torch.cuda``'s
timing calls replaced by host-clock stand-ins.  Every wrapper takes
its plain version there, so this finds wrong paths, shapes and control
flow in all phases (a few minutes); it measures nothing about the card.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CUTS = [
    ('ROOT = Path(__file__).resolve().parent', f'ROOT = Path({str(ROOT)!r})'),
    ('N_TRAIN, N_TEST = 32, 8', 'N_TRAIN, N_TEST = 12, 4'),
    ('n=spec.full_n', 'n=128'),
    ('GAUSS_N, N_GAUSS, GAUSS_EPS = 1028, 20, 1e-3',
     'GAUSS_N, N_GAUSS, GAUSS_EPS = 64, 10, 1e-3'),
    ('N_VOL, VOL_SHAPE = "miranda-vx", 12, (256, 384, 384)',
     'N_VOL, VOL_SHAPE = "miranda-vx", 8, (16, 24, 32)'),
    ('N_STREAM, STREAM_N = "cesm-cloud", 96, 1800',
     'N_STREAM, STREAM_N = "cesm-cloud", 10, 64'),
    ('STREAM_BUDGET_MB = 512', 'STREAM_BUDGET_MB = 0.0625'),
    ('SERVE_CLIENTS, SERVE_REQUESTS, SERVE_HOT = 8, 16, 4',
     'SERVE_CLIENTS, SERVE_REQUESTS, SERVE_HOT = 8, 16, 2'),
    ('KV_LEAVES, KV_REPEATS, KV_LEAF_N = 16, 4, 4 << 20',
     'KV_LEAVES, KV_REPEATS, KV_LEAF_N = 16, 4, 1 << 12'),
    ('SERVE_CLI_N = 1800', 'SERVE_CLI_N = 64'),
    ('DIST_DEVICE = "cuda:0"', 'DIST_DEVICE = "cpu"'),
    ('DIST_NCCL = "nccl"', 'DIST_NCCL = "gloo"'),
    ('            if not r["libraries_found"]:', '            if False:'),
    ('"--kv-compress", "--device", "cuda"]',
     '"--kv-compress", "--device", "cuda", "--smoke"]'),
    ('from repro_torch.configs.base import get_arch',
     'from repro_torch.configs.base import get_smoke as get_arch'),
    ('"cuda"', '"cpu"'),
    ('_build.build(variants=KT.qent_variants())', 'pass'),
    ('TUNE_SHAPE_DIV = 1', 'TUNE_SHAPE_DIV = 64'),
    ('return qent_ops.launch(x, eps, bins, KT.tile_defines(tile))',
     'return qent_ops.qent_histogram_sweep(x, eps, bins)'),
    ('    check_quotient(torch, ebs_t)\n', ''),
    ('    missing = [n for n in needs if launches.get(n, 0) <= 0]',
     '    missing = []'),
    ('x.cpu()', 'x.clone()'),
    ('kernels = check_kernels(torch, train, test, ebs_t)',
     'kernels = [check_zfp(torch, test)]'),
    ('TRAIN_HEAD_VALUES = 1 << 22', 'TRAIN_HEAD_VALUES = 1 << 11'),
    ('TRAIN_SPAN_VALUES = 1 << 20', 'TRAIN_SPAN_VALUES = 1 << 8'),
    ('FAM_SERVE = (("phi3.5-moe-42b-a6.6b", 8), ("qwen2-vl-72b", 12))',
     'FAM_SERVE = (("phi3.5-moe-42b-a6.6b", 2), ("qwen2-vl-72b", 2))'),
    ('PHASE26_PARAMS = {HYB_ARCH: 1_641_995_520, ENC_ARCH: 1_614_643_200}',
     'PHASE26_PARAMS = {}'),
    ('HYB_PROMPT, HYB_MAX_LEN = 1100, 1280', 'HYB_PROMPT, HYB_MAX_LEN = 48, 64'),
    ('HYB_DECODE_PROMPT = 1100', 'HYB_DECODE_PROMPT = 48'),
    ('("float32", 1, 900, 512))', '("float32", 1, 48, 52))'),
]
# the training chunks, cut so that the smoke leaves cross their boundaries
CHUNK_VALUES, CHUNK_BLOCKS = 1 << 12, 1 << 5


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def main(argv=None) -> int:
    src = (ROOT / "chip_smoke.py").read_text()
    for old, new in CUTS:
        if old not in src:
            raise SystemExit(f"rehearse_smoke: chip_smoke.py no longer has {old!r}")
        src = src.replace(old, new)
    out_dir = ROOT / "build" / "rehearse"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "smoke_cpu.py").write_text(src)

    import torch
    cuda = torch.cuda
    cuda.is_available = lambda: True
    cuda.synchronize = lambda *a, **k: None
    cuda.Event = _Event
    cuda._sleep = lambda cycles: None
    cuda.max_memory_allocated = lambda *a, **k: 0
    cuda.memory_allocated = lambda *a, **k: 0
    cuda.memory_reserved = lambda *a, **k: 0
    cuda.reset_peak_memory_stats = lambda *a, **k: None
    cuda.mem_get_info = lambda *a, **k: (0, 0)
    cuda.get_device_name = lambda *a: "cpu rehearsal"
    cuda.device_count = lambda: 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.train import grad_compress, optimizer
    optimizer.CHUNK = CHUNK_VALUES
    grad_compress.CHUNK_BLOCKS = CHUNK_BLOCKS
    sys.path.insert(0, str(out_dir))
    import smoke_cpu
    smoke_cpu.nvidia_smi_line = lambda: "cpu rehearsal (no card)"
    return smoke_cpu.main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

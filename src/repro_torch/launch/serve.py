"""Serving launcher: batched greedy generation with an optional KV gate.

    python -m repro_torch.launch.serve --arch granite-3-2b \\
        --batch 4 --prompt-len 32 --steps 16 --kv-compress [--kv-gate-service]

builds the architecture's model (``--smoke``: its reduced config) with
random parameters from seed 0 (no weights are downloaded), draws
``--batch`` prompts of ``--prompt-len`` ids from seed 1, prefills a
``--max-len`` cache and decodes ``--steps`` tokens.  ``--kv-compress``
gates the prefilled cache's K/V leaves on their predicted int8 CR;
with ``--kv-gate-service`` the gate's CRs are served by a
``serve.sweep_service.SweepService`` through its ``kv_gate`` method.
The run is on the card unless ``--device cpu`` asks for the host.
An encdec architecture (whisper) is refused: its prefill needs the
batch's ``frames``, which this launcher, as the reference's, does not
make.

``main(argv)`` prints the report and returns it as a dict: the ids and
their shape, the parameter count and bytes, init and prefill seconds,
decode ms per step (median), tokens/s, the gate's bytes saved and total,
and the service's ``kv_gate`` stats.  On the card it turns off cuBLAS's
reduced-precision bfloat16 reductions and TF32, so that products
accumulate in float32 as the reference's do.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Batched greedy generation with an optional KV gate.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--kv-compress", action="store_true")
    ap.add_argument("--kv-gate-service", action="store_true",
                    help="serve KV-gate CR predictions through the shared "
                         "sweep service (kv_gate method) instead of the "
                         "engine's own call")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs.base import get_arch, get_smoke
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine, ServeConfig

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    if cfg.family == "encdec":
        # the reference's launcher builds a batch of tokens alone and
        # fails in its prefill (KeyError: 'frames'); this one makes up
        # no frames either
        ap.error(f"--arch {args.arch}: the encdec family's prefill encodes "
                 "the batch's frames (the stubbed conv frontend's output, "
                 f"(batch, {cfg.encoder_frames}, {cfg.d_model})), and this "
                 "launcher's batch has only token ids")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(dev)
    scfg = ServeConfig(max_len=args.max_len, kv_compress=args.kv_compress)

    svc = None
    if args.kv_gate_service:
        from repro_torch.serve.sweep_service import ServiceConfig, SweepService
        svc = SweepService(ServiceConfig(max_wait_ms=1.0), device=dev)
    try:
        eng = Engine(cfg, params, scfg, sweep_service=svc)
        t0 = time.perf_counter()
        out = eng.generate({"tokens": tokens}, steps=args.steps)
        wall = time.perf_counter() - t0
        gate = svc.stats()["methods"].get("kv_gate") if svc else None
    finally:
        if svc is not None:
            svc.close()

    tm = eng.timings
    toks = args.batch * args.steps
    report = {
        "arch": cfg.name, "smoke": args.smoke, "device": args.device,
        "shape": list(out.shape), "ids": out.cpu().tolist(),
        "params": n_params, "param_bytes": param_bytes, "init_s": init_s,
        "prefill_s": tm["prefill_s"], "gate_s": tm["gate_s"],
        "decode_ms_per_step": float(np.median(tm["decode_s"])) * 1e3,
        "generate_s": wall, "tokens_per_s": toks / wall,
        "kv_saved_bytes": eng.kv_saved_bytes,
        "kv_total_bytes": eng.kv_total_bytes, "kv_gate": gate}
    print(f"{cfg.name}: {n_params:,} parameters ({param_bytes / 1e9:.2f} GB) "
          f"initialized in {init_s:.3f} s on {args.device}")
    print(f"generated {tuple(out.shape)} in {wall:.3f} s ({toks / wall:.1f} "
          f"tok/s): prefill {tm['prefill_s'] * 1e3:.1f} ms, decode "
          f"{report['decode_ms_per_step']:.2f} ms/step (median)")
    if args.kv_compress:
        print(f"KV gate: {eng.kv_saved_bytes:,}/{eng.kv_total_bytes:,} "
              f"bytes saved")
    if gate is not None:
        print(f"kv_gate service: {gate['completed']} requests, "
              f"{gate['rows']} leaves, p50={gate['p50_ms']:.1f}ms "
              f"p95={gate['p95_ms']:.1f}ms")
    return report


if __name__ == "__main__":
    main()

"""Training launcher: --arch <id> on one card (or the CPU).

    python -m repro_torch.launch.train --arch granite-3-2b --smoke --steps 20
    python -m repro_torch.launch.train --arch granite-3-2b \\
        --batch 4 --seq 512 --microbatches 2 --compress --steps 8

builds the architecture's model (``--smoke``: its reduced config) with
random parameters from seed 0, trains it for ``--steps`` steps on the
synthetic token stream (``data.tokens``) through ``train.loop.run``
with a checkpoint every quarter of the run (``--lossy-ckpt``: under the
paper's lossy policy, sz3-lorenzo) and prints the reference's summary
line.  The run is on the card unless ``--device cpu`` asks for the
host; on the card cuBLAS's reduced-precision bfloat16 reductions and
TF32 are turned off, so that products accumulate in float32 as the
reference's do.  ``--mesh`` (training across cards) is not ported:
ROADMAP Queue 1 item 7.

``main(argv)`` returns a report: the losses by step, the step times,
the parameter count and the last checkpoint's manifest.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train a model on the synthetic token stream.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default=None, help="e.g. 16x16 (data x model)")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--lossy-ckpt", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch
    from repro_torch.ckpt.checkpoint import LossyPolicy
    from repro_torch.configs.base import get_arch, get_smoke
    from repro_torch.data.tokens import make_data_iter
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import loop as LOOP
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS
    from repro_torch.train.grad_compress import CompressConfig

    if args.mesh:
        raise NotImplementedError(TS.ACROSS_CARDS)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    compress = CompressConfig(enabled=True) if args.compress else None

    state = TS.init_state(cfg, torch.Generator(dev).manual_seed(0),
                          compress=compress is not None)
    times = []
    step = TS.make_train_step(cfg, OPT.AdamWConfig(lr=args.lr),
                              microbatches=args.microbatches,
                              compress=compress, donate=True)

    def timed_step(st, batch):
        t0 = time.perf_counter()
        out = step(st, batch)
        float(out[1]["loss"])
        times.append(time.perf_counter() - t0)
        return out

    data = make_data_iter(cfg, args.batch, args.seq, device=dev)
    lc = LOOP.LoopConfig(
        total_steps=args.steps, ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir,
        lossy=LossyPolicy(enabled=args.lossy_ckpt, device=args.device))
    state, res = LOOP.run(cfg, state, timed_step, data, lc)
    ks = sorted(res.losses)
    print(f"{cfg.name}: steps {ks[0]}..{ks[-1]} "
          f"loss {res.losses[ks[0]]:.3f} -> {res.losses[ks[-1]]:.3f}")
    return {"arch": cfg.name, "smoke": args.smoke, "device": args.device,
            "losses": res.losses, "step_s": times,
            "restarts": res.restarts, "straggler_steps": res.straggler_steps,
            "params": sum(p.numel() for p in tree_leaves(state.params)),
            "ckpt_dir": args.ckpt_dir}


if __name__ == "__main__":
    main()

"""Training launcher: --arch <id> on one card (or the CPU), or on a mesh
of processes.

    python -m repro_torch.launch.train --arch granite-3-2b --smoke --steps 20
    python -m repro_torch.launch.train --arch granite-3-2b \\
        --batch 4 --seq 512 --microbatches 2 --compress --steps 8
    python -m repro_torch.launch.train --arch granite-3-2b --mesh 2x1 \\
        --coordinator tcp://10.0.0.1:29500 --num-processes 2 \\
        --process-id $RANK --batch 8

builds the architecture's model (``--smoke``: its reduced config) with
random parameters from seed 0, trains it for ``--steps`` steps on the
synthetic token stream (``data.tokens``) through ``train.loop.run``
with a checkpoint every quarter of the run (``--lossy-ckpt``: under the
paper's lossy policy, sz3-lorenzo) and prints the reference's summary
line.  The run is on the card unless ``--device cpu`` asks for the
host; on the card cuBLAS's reduced-precision bfloat16 reductions and
TF32 are turned off, so that products accumulate in float32 as the
reference's do.

``--mesh DxM`` or ``PxDxM`` trains on a ``(data, model)`` or ``(pod,
data, model)`` mesh over a process group: each process joins it with
``--coordinator ADDRESS --num-processes N --process-id I`` (and
``--backend``; without ``--coordinator``, a mesh of one process), and
the step runs in the ``pjit`` mode under the mesh, as the reference's
launcher runs it (never podsync): each ``data`` rank trains on its rows
of every batch and the gradients are averaged (``train.train_step``).
Rank 0 alone writes the checkpoints and prints the summary line; every
rank resumes from them.  ``M`` above 1 (tensor-parallel layers) raises
``NotImplementedError``: ROADMAP Queue 1 item 7's model-axis half.

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
    ap.add_argument("--coordinator", default=None,
                    help="join a process group first: tcp://host:port or "
                         "file://path, the same on every process")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="processes in the group (with --coordinator)")
    ap.add_argument("--process-id", type=int, default=0,
                    help="this process's rank (with --coordinator)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the group's backend (default: nccl on the card, "
                         "gloo on the CPU)")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs.base import get_arch, get_smoke
    from repro_torch.dist import sharding as S
    from repro_torch.launch import mesh as M
    from repro_torch.train import train_step as TS
    from repro_torch.train.grad_compress import CompressConfig

    shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else ()
    if shape and shape[-1] > 1:
        raise NotImplementedError(TS.ACROSS_CARDS)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    compress = CompressConfig(enabled=True) if args.compress else None
    if args.coordinator:
        M.dist_init(args.coordinator, num_processes=args.num_processes,
                    process_id=args.process_id, backend=args.backend,
                    device=args.device)
        dev = M.rank_device()
    try:
        mesh = None
        if shape:
            axes = (("data", "model") if len(shape) == 2
                    else ("pod", "data", "model"))
            mesh = M.make_mesh(shape, axes)
        with S.use_mesh(mesh):
            report = _run(args, cfg, compress, dev)
    finally:
        if args.coordinator:
            import torch.distributed as dist
            dist.destroy_process_group()
    return report


def _run(args, cfg, compress, dev) -> dict:
    """The loop of ``main``, under its mesh (if any)."""
    import torch
    from repro_torch.ckpt.checkpoint import LossyPolicy
    from repro_torch.data.tokens import make_data_iter
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import loop as LOOP
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

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
    lead = args.process_id == 0
    lc = LOOP.LoopConfig(
        total_steps=args.steps, ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir, save=lead,
        lossy=LossyPolicy(enabled=args.lossy_ckpt, device=dev.type))
    state, res = LOOP.run(cfg, state, timed_step, data, lc)
    ks = sorted(res.losses)
    if lead:
        print(f"{cfg.name}: steps {ks[0]}..{ks[-1]} "
              f"loss {res.losses[ks[0]]:.3f} -> {res.losses[ks[-1]]:.3f}")
    return {"arch": cfg.name, "smoke": args.smoke, "device": args.device,
            "losses": res.losses, "step_s": times,
            "restarts": res.restarts, "straggler_steps": res.straggler_steps,
            "params": sum(p.numel() for p in tree_leaves(state.params)),
            "ckpt_dir": args.ckpt_dir, "mesh": args.mesh,
            "process_id": args.process_id}


if __name__ == "__main__":
    main()

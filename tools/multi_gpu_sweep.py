#!/usr/bin/env python3
"""Time the sharded training sweep over the GPUs of one host, each form
held bit for bit to one GPU's sweep.

    python3 tools/multi_gpu_sweep.py [--cards 4]
    python3 tools/multi_gpu_sweep.py --device cpu --n 64

The sweep is the training sweep of ``chip_smoke.py``: 32 cesm-cloud
slices of 1800 x 1800 made from seed 0, its 6-point eb grid,
``use_kernels=True``, features and quality.  In one process, after one
untimed call of each, these run in turns (forward, then backward):

* ``one card``: the single-device sweep on the first card;
* ``mesh over cards``: a ``SweepMesh`` of one shard per card, as
  ``dist.sweep`` runs it (a thread per card);
* ``cards in turn``: the same blocks swept card after card from the
  calling thread, then gathered;
* ``shards on one card``: a mesh of as many shards, all on the first
  card.

Then a process group of one fresh process per card (``nccl``, joined by
``file://`` under ``build/``): SPMD and process-local sweeps twice
each, then the blocks alone and their gather.  Every result must equal
the one-card sweep bit for bit.

``--serve`` then serves ``chip_smoke.py``'s phase-15 plan (8 clients x
64 requests of the seven methods over its 8 held-out slices, kernel
q-ent) with models of sz3-lorenzo, zfp and bitgrooming trained on the
first card, three ways in turn: a ``SweepService`` on the first card,
one on a mesh of a shard per card in this process, and a leader with
one follower per other card in an NCCL group (``chip_smoke.py
--fabric-child``); every served result equal to the direct call on the
first card, and each way's requests/s.

``--serve --chaos`` then serves the plan cut to 8 clients x 16
requests over an NCCL group of one rank per card again, the last rank
SIGKILLed inside its first launch after 16 requests were served
(``chip_smoke.py --fault-child``, ``dist.faultinject``), the group's
timeout 30 s and the leader's launch deadline 15 s: the survivors abort
the group
(``dist.fault.abort_group``) and finish through the store, every served
result equal to the direct call, and each survivor stays 35 s more, past
the group's timeout, so that an NCCL watchdog that found a collective
stuck would end it (exit code not 0) before it reports.

``--device cpu`` rehearses the control flow on the host (``cpu`` and
``cpu:0`` take turns as the cards, gloo ranks).  Prints
``nvidia-smi``'s name and power limit of every card, then one JSON
object, last.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FIELD, K = "cesm-cloud", 32
TIMEOUT_S = 600


def stack(torch, n: int, device):
    """The 40 slices (32 training, 8 held out) and the eb grid of
    ``chip_smoke.py``."""
    from repro_torch.data import scientific as TS
    spec = TS.FIELDS[FIELD]
    x = TS.field_slices(FIELD, count=40, n=n, seed=0, device=device)
    return x, spec.eps * 10.0 ** np.linspace(-0.5, 2.0, 6)


def cards(torch, device: str, n: int) -> list:
    if device == "cpu":              # two distinct devices, in turn
        return [torch.device("cpu", 0) if i % 2 else torch.device("cpu")
                for i in range(n)]
    if torch.cuda.device_count() < n:
        raise SystemExit(f"{n} cards asked for, {torch.cuda.device_count()} "
                         "present")
    return [torch.device("cuda", i) for i in range(n)]


def sync(torch, devs) -> None:
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def same_bits(what, got, want) -> None:
    if got.shape != want.shape or got.tobytes() != want.tobytes():
        raise AssertionError(f"{what}: differs bit-wise from one card")


def child(job_file: str) -> int:
    """A process-group member: one card, SPMD and process-local sweeps
    and the blocks' gather, each == one card's sweep; writes its times."""
    import torch
    from repro_torch.core import predictors as P
    from repro_torch.dist import sweep as DS
    from repro_torch.launch import mesh as M
    job = json.loads(Path(job_file).read_text())
    dev = torch.device(job["device"])
    times = {}

    def timed(key, fn):
        sync(torch, [dev])
        t = time.perf_counter()
        res = fn()
        sync(torch, [dev])
        times.setdefault(key, []).append(time.perf_counter() - t)
        return res

    timed("init_s", lambda: M.dist_init(
        job["init"], num_processes=job["nprocs"], process_id=job["rank"],
        device=dev, init_timeout_s=300))
    mesh = timed("mesh_s", lambda: M.make_sweep_mesh())
    x, ebs = stack(torch, job["n"], dev)
    x = x[:K]
    want = np.load(job["want"])
    cfg = P.PredictorConfig(use_kernels=True)
    lo, hi = DS.process_block(K, mesh)
    for _ in range(2):
        same_bits("SPMD", timed("spmd_s", lambda: DS.features_sweep_sharded(
            x, ebs, cfg, mesh=mesh, mode="both").cpu().numpy()), want)
        same_bits("process-local", timed(
            "local_s", lambda: DS.features_sweep_sharded(
                x[lo:hi], ebs, cfg, mesh=mesh, mode="both",
                process_local=True, global_k=K).cpu().numpy()), want)
    blocks = timed("blocks_s", lambda: DS.features_sweep_sharded(
        x, ebs, cfg, mesh=mesh, mode="both", gather=False))
    same_bits("gathered blocks", timed(
        "gather_s", lambda: DS.gather_rows(blocks))[:K], want)
    Path(job["out"]).write_text(json.dumps(
        {"times": times, "backend": torch.distributed.get_backend(),
         "shares": list(mesh.shares)}))
    torch.distributed.destroy_process_group()
    return 0


def group(devs, n: int, want_file: Path, tmp: Path) -> list:
    """One fresh process per card, all started together, each under
    TIMEOUT_S; returns their reports.  Raises if one fails."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // len(devs))))
    procs, outs = [], []
    for r, d in enumerate(devs):
        job = tmp / f"job{r}.json"
        outs.append(tmp / f"out{r}.json")
        job.write_text(json.dumps({
            "init": f"file://{tmp / 'init'}", "nprocs": len(devs), "rank": r,
            "device": "cpu" if d.type == "cpu" else str(d), "n": n,
            "want": str(want_file), "out": str(outs[-1])}))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--child", str(job)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("process group failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{(log or '')[-3000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return [json.loads(o.read_text()) for o in outs]


def serve(torch, devs, x_all, ebs, tmp: Path, chaos: bool = False) -> dict:
    """``--serve`` (module docstring): requests/s of each way."""
    import pickle
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from repro_torch.core import predictors as P
    from repro_torch.core import usecases as UC
    from repro_torch.launch import mesh as M
    from repro_torch.serve.sweep_service import SweepService
    cfg = P.PredictorConfig(use_kernels=True)
    t = time.perf_counter()
    models = {name: UC.EbGridModel.train(x_all[:8], name, ebs, cfg=cfg)
              for name in ("sz3-lorenzo", "zfp", "bitgrooming")}
    out = {"train_s": time.perf_counter() - t}
    ctx = dict(CS.route_ctx(cfg, models, x_all[K:].cpu().numpy(), ebs,
                            CS.serve_leaves()), device=str(devs[0]))
    plan = CS.serve_plan(CS.SERVE_HOT, len(ctx["slices"]) - CS.SERVE_HOT)
    direct = {}

    def check(what, results, wall):
        n_req = sum(len(p) for p in plan)
        rec = {"post_workers": 2, "wall_s": wall, "req_per_s": n_req / wall}
        CS.check_served(torch, rec, ctx, [
            (req, [results[(c, r)]]) for c, reqs in enumerate(plan)
            for r, req in enumerate(reqs)], direct)
        print(f"serve, {what}: {n_req} requests in {wall:.3f} s "
              f"({n_req / wall:.2f} req/s), every result == the direct "
              "call", flush=True)
        return rec

    for what, kw in (("one card", {"device": devs[0]}),
                     ("mesh over cards",
                      {"mesh": M.make_sweep_mesh(devices=devs)})):
        with SweepService(CS.serve_config(cfg), **kw) as svc:
            svc.warmup()
            results, _, wall = CS.serve_traffic(svc, plan, ctx)
            launches = svc.launches
        out[what] = dict(check(what, results, wall), launches=launches)
    torch.save(ctx, tmp / "ctx.pt")
    backend = "gloo" if devs[0].type == "cpu" else "nccl"
    cmds = []
    for r, d in enumerate(devs):
        job = {"init": f"file://{tmp / 'init_serve'}", "nprocs": len(devs),
               "rank": r, "backend": backend,
               "device": "cpu" if d.type == "cpu" else str(d), "shards": 1,
               "ctx": str(tmp / "ctx.pt"), "results": str(tmp / "res.pkl"),
               "out": str(tmp / f"serve{r}.json"),
               "requests": CS.SERVE_REQUESTS}
        (tmp / f"serve{r}.job").write_text(json.dumps(job))
        cmds.append([sys.executable, str(ROOT / "chip_smoke.py"),
                     "--fabric-child", str(tmp / f"serve{r}.job")])
    CS.run_group("serve group", cmds, tmp, TIMEOUT_S)
    ranks = [json.loads((tmp / f"serve{r}.json").read_text())
             for r in range(len(devs))]
    with open(tmp / "res.pkl", "rb") as f:
        results = pickle.load(f)
    out[f"{backend} group"] = dict(
        check(f"{backend} group of {len(devs)}", results, ranks[0]["wall_s"]),
        launches=[r["launches"] for r in ranks])
    if chaos:
        out[f"{backend} group, a rank killed"] = lost_rank(
            torch, devs, backend, ctx, direct, tmp)
    return out


def lost_rank(torch, devs, backend: str, ctx: dict, direct: dict,
              tmp: Path) -> dict:
    """``--chaos`` (module docstring): the last rank of a group of one
    rank per card killed mid-traffic; the survivors' records."""
    import pickle
    import signal
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    plan = CS.serve_plan(CS.SERVE_HOT, len(ctx["slices"]) - CS.SERVE_HOT,
                         CS.FAULT_REQUESTS)
    init = f"tcp://127.0.0.1:{CS.free_port()}"
    last = len(devs) - 1
    cmds = []
    for r, d in enumerate(devs):
        job = {"init": init, "nprocs": len(devs), "rank": r,
               "backend": backend, "device": "cpu" if d.type == "cpu"
               else str(d), "ctx": str(tmp / "ctx.pt"),
               "results": str(tmp / "chaos.pkl"),
               "out": str(tmp / f"chaos{r}.json"),
               "chaos": "follower_launch:kill:1" if r == last else None,
               "group_timeout_s": 30.0,
               "launch_timeout_s": 15.0, "linger_s": 35.0}
        (tmp / f"chaos{r}.job").write_text(json.dumps(job))
        cmds.append([sys.executable, str(ROOT / "chip_smoke.py"),
                     "--fault-child", str(tmp / f"chaos{r}.job")])
    CS.run_group("chaos group", cmds, tmp, TIMEOUT_S,
                 expect={last: -signal.SIGKILL})
    ranks = [json.loads((tmp / f"chaos{r}.json").read_text())
             for r in range(last)]
    with open(tmp / "chaos.pkl", "rb") as f:
        results = pickle.load(f)
    lead = ranks[0]
    CS.check_served(torch, dict(lead, post_workers=2), ctx, [
        (req, [results[(c, r)]]) for c, reqs in enumerate(plan)
        for r, req in enumerate(reqs)], direct)
    if lead["recoveries"] != 1 or lead["procs"] != list(range(last)) or any(
            r["serve"] != "clean" for r in ranks[1:]):
        raise AssertionError(f"chaos group: {ranks}")
    print(f"serve, {backend} group of {len(devs)}, rank {last} killed: "
          f"{lead['requests']} requests ({lead['req_per_s_before']:.2f} "
          f"req/s before the fault, {lead['req_per_s_after']:.2f} after), "
          f"detection {lead['last_detect_s']:.3f} s, recovery "
          f"{lead['last_recovery_s']:.3f} s; the {last} survivors outlived "
          "the group's timeout; every result == the direct call", flush=True)
    return {"leader": lead, "followers": ranks[1:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=None,
                    help="slice edge (default: the field's, 1800)")
    ap.add_argument("--serve", action="store_true",
                    help="also serve chip_smoke.py's phase-15 plan on one "
                         "card, a mesh of every card and an NCCL group")
    ap.add_argument("--chaos", action="store_true",
                    help="with --serve: kill one rank of the group "
                         "mid-traffic and check the survivors' recovery")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multi_gpu_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import predictors as P
    from repro_torch.dist import sweep as DS
    from repro_torch.data import scientific as TS
    from repro_torch.launch import mesh as M
    smi = []
    if args.device == "cuda":
        from repro_torch.kernels import _build
        _build.build()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()
        for line in smi:
            print(line.strip())
    devs = cards(torch, args.device, args.cards)
    n = args.n or TS.FIELDS[FIELD].full_n
    x, ebs = stack(torch, n, devs[0])
    x_all = x
    x = x[:K]
    cfg = P.PredictorConfig(use_kernels=True)
    spread = M.make_sweep_mesh(devices=devs)
    piled = M.make_sweep_mesh(devices=[devs[0]] * len(devs))
    rpd = -(-K // len(devs))
    padded = DS._pad_block(x, rpd * len(devs))

    def in_turn():
        outs = []
        for i, d in enumerate(devs):
            with DS._on(d):
                outs.append(P._sweep(padded[i * rpd:(i + 1) * rpd].to(d), ebs,
                                     cfg, "both"))
        return np.concatenate([o.cpu().numpy() for o in outs])[:K]

    forms = {
        "one card": lambda: P._sweep(x, ebs, cfg, "both").cpu().numpy(),
        "mesh over cards": lambda: DS.features_sweep_sharded(
            x, ebs, cfg, mesh=spread, mode="both").cpu().numpy(),
        "cards in turn": in_turn,
        "shards on one card": lambda: DS.features_sweep_sharded(
            x, ebs, cfg, mesh=piled, mode="both").cpu().numpy()}
    want = forms["one card"]()
    times = {k: [] for k in forms}
    order = list(forms) + list(forms)[::-1]
    for i, key in enumerate(list(forms) + order):
        sync(torch, devs)
        t = time.perf_counter()
        got = forms[key]()
        sync(torch, devs)
        if i >= len(forms):               # the first call of each: untimed
            times[key].append(time.perf_counter() - t)
        same_bits(key, got, want)
        print(f"{key}: {time.perf_counter() - t:.4f} s", flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="multi_gpu_", dir=ROOT / "build"))
    try:
        np.save(tmp / "want.npy", want)
        ranks = group(devs, n, tmp / "want.npy", tmp)
        served = (serve(torch, devs, x_all, ebs, tmp, args.chaos)
                  if args.serve else None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"device": [s.strip() for s in smi], "k": K, "n": n,
                      "cards": len(devs), "sweep_s": times,
                      "ranks": ranks, "serve": served}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

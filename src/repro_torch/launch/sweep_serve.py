"""Sweep-service load generator: concurrent clients issuing UC1/UC2 requests.

Trains one ``EbGridModel`` per field (``--compressor`` over a 4-point eb
grid) and two UC2 predictors (``--compressor`` and bitgrooming), then
drives ``serve.sweep_service.SweepService`` with ``--clients`` threads
issuing ``--requests`` requests in all -- half ``find_eb`` at a random
target CR, half ``best_compressor`` -- over ``--hot-slices`` held-out
slices per field, the traffic the service's coalescing and cache are
for.  Prints throughput, latency quantiles (all requests and by method),
cache and launch statistics, and each kernel's launches during training
and during serving (in the ``--out`` report also by launch shape).

    python -m repro_torch.launch.sweep_serve --fields cesm-cloud --n 1800 \\
        --clients 8 --requests 64 --out serve.json

The run is on the card unless ``--device cpu`` asks for the host;
``--use-kernels`` takes the hashed q-ent kernel route.  ``--queue-rows``
enables bounded-queue admission control (overload rejects with
``RetryAfter`` instead of queueing without limit).

``--mesh auto|none|N|DEV,DEV,...`` shards the service's launches over a
``dist.sweep.SweepMesh`` (as ``launch.advise --mesh``; ``none``, the
default, serves on one device).  With ``--coordinator ADDRESS
--num-processes P --process-id I`` (and ``--backend``) every process
first joins a process group of P processes and the mesh spans them:
process 0 (the leader) trains the models, runs the clients and prints
the report, and every other process serves as a follower, joining the
leader's launches until it closes the service::

    python -m repro_torch.launch.sweep_serve --mesh auto \
        --coordinator tcp://localhost:29500 --num-processes 2 \
        --process-id $RANK --device cpu

``--coordinator`` without a mesh that spans the processes fails on
every process.  ``--verify`` makes every distinct request again as a
direct call after the run and reports how many served results differ
from it (the service's contract: none, also across a recovery).

The fabric survives a lost follower (``serve.sweep_service``):
``--launch-timeout-s`` bounds each of the leader's launches and
``--heartbeat-s`` sets the liveness beat; the report gives
``recoveries``, ``epoch`` and the surviving ``procs``.  A follower whose
fabric fails (evicted, or the leader lost) prints the ``FabricError``
and exits 0.  ``--chaos SPEC`` arms ``dist.faultinject`` in this process
(e.g. ``follower_launch:kill:2``).  For a store that outlives the leader,
serve it in a process of its own and join it from every rank::

    python -m repro_torch.launch.sweep_serve --coordinator-only \
        --coordinator tcp://localhost:29500 --num-processes 3 &
    python -m repro_torch.launch.sweep_serve --mesh auto \
        --coordinator tcp://localhost:29500 --external-coordinator \
        --num-processes 3 --process-id $RANK --device cpu

``--coordinator-only`` serves until SIGINT.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.sweep_serve",
        description="Synthetic multi-client UC1/UC2 load on the sweep "
                    "service.")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=64,
                    help="total requests across all clients")
    ap.add_argument("--fields", default="miranda-vx,scale-u")
    ap.add_argument("--hot-slices", type=int, default=4,
                    help="distinct slices per field the clients hammer")
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--compressor", default="zfp")
    ap.add_argument("--train-slices", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=3.0)
    ap.add_argument("--min-wait-ms", type=float, default=0.0,
                    help="adaptive micro-batch window floor under "
                         "sustained load")
    ap.add_argument("--max-live-batches", type=int, default=2,
                    help="launched-but-not-post-processed batches in "
                         "flight (admission control)")
    ap.add_argument("--no-adaptive-window", action="store_true",
                    help="pin the micro-batch window at --max-wait-ms "
                         "instead of adapting it to load")
    ap.add_argument("--cache-bytes", type=int, default=4 << 20)
    ap.add_argument("--queue-rows", type=int, default=0,
                    help="bounded-queue admission control: reject with "
                         "RetryAfter beyond this many queued rows "
                         "(0 = unbounded)")
    ap.add_argument("--use-kernels", action="store_true",
                    help="q-ent by the hashed histogram kernel instead of "
                         "the exact sort route")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the service, training and compressors run")
    ap.add_argument("--mesh", default="none",
                    help="'none' (one device), 'auto' (every device of the "
                         "process; one shard per process in a process "
                         "group), a shard count, or a comma list of "
                         "devices (cuda:0,cuda:0: two shards on one card)")
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
    ap.add_argument("--external-coordinator", action="store_true",
                    help="join the store --coordinator-only serves at "
                         "--coordinator (tcp://) as a client, so the ranks "
                         "survive the leader's death")
    ap.add_argument("--coordinator-only", action="store_true",
                    help="serve the process group's store at --coordinator "
                         "for --num-processes ranks until SIGINT; not a "
                         "rank of the fabric")
    ap.add_argument("--launch-timeout-s", type=float, default=60.0,
                    help="the leader's bound per fabric launch; must cover "
                         "a first launch's kernel build")
    ap.add_argument("--heartbeat-s", type=float, default=0.5,
                    help="the fabric's liveness publish interval")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="arm repro_torch.dist.faultinject in this process, "
                         "e.g. follower_launch:kill:2")
    ap.add_argument("--verify", action="store_true",
                    help="after the run, make every distinct request again "
                         "as a direct call and count the served results "
                         "that differ from it")
    ap.add_argument("--out", default="", help="write the JSON report here")
    args = ap.parse_args(argv)
    from repro_torch.launch import mesh as M
    if args.coordinator_only:
        if (args.coordinator is None or args.num_processes < 2
                or not args.coordinator.startswith("tcp://")):
            raise SystemExit("--coordinator-only needs --coordinator "
                             "tcp://host:port and --num-processes")
        print(f"# serving the store at {args.coordinator} for "
              f"{args.num_processes} processes ...", flush=True)
        M.serve_coordinator(args.coordinator, args.num_processes)
        return {}
    if args.chaos is not None:
        from repro_torch.dist import faultinject
        faultinject.configure(args.chaos)
        print(f"# chaos armed: {args.chaos}", flush=True)
    if args.coordinator is None:
        return _serve(args)
    import torch.distributed as dist
    M.dist_init(args.coordinator, num_processes=args.num_processes,
                process_id=args.process_id, backend=args.backend,
                device=args.device,
                external_coordinator=args.external_coordinator)
    report = _serve(args)
    if not _faulted(report):
        # a faulted group is never used again, nor torn down: a peer may
        # be gone and a collective abandoned on it
        dist.destroy_process_group()
    return report


def _faulted(report: dict) -> bool:
    """True when this process's fabric faulted: recovered onto the
    store transport, or failed."""
    return report.get("transport") == "kv" or bool(report.get("fabric_error"))


def _serve(args) -> dict:
    import torch
    from repro_torch import compressors as C
    from repro_torch.core import pipeline as PL
    from repro_torch.core import predictors as P
    from repro_torch.core import usecases as UC
    from repro_torch.kernels import launch_counts, launches_since
    from repro_torch.data import scientific
    from repro_torch.dist import sweep as DS
    from repro_torch.launch import mesh as M
    from repro_torch.serve.sweep_service import ServiceConfig, SweepService

    cfg = P.PredictorConfig(use_kernels=args.use_kernels)
    scfg = ServiceConfig(max_batch_slices=args.max_batch,
                         max_wait_ms=args.max_wait_ms,
                         min_wait_ms=args.min_wait_ms,
                         adapt_window=not args.no_adaptive_window,
                         max_live_batches=args.max_live_batches,
                         cache_bytes=args.cache_bytes,
                         launch_timeout_s=args.launch_timeout_s,
                         heartbeat_s=args.heartbeat_s,
                         max_queue_rows=args.queue_rows, pcfg=cfg)
    mesh = DS.active_sweep_mesh(M.mesh_from_spec(args.mesh, args.device))
    if args.coordinator is not None and not DS.mesh_spans_processes(mesh):
        # on every process: a follower of a mesh that does not span the
        # processes would serve a service that never stops
        raise SystemExit("--coordinator needs a mesh that spans the "
                         "processes: pass --mesh auto (or a device list)")
    device = args.device if mesh is None else None
    # the service comes before training: the leader's heartbeat starts
    # here, so followers can tell a leader busy training from a dead one
    svc = SweepService(scfg, device=device, mesh=mesh)
    if svc.role == "follower":
        from repro_torch.dist.fault import FabricError
        print(f"# follower {args.process_id} serving ...", flush=True)
        error = None
        try:
            svc.serve()
        except FabricError as exc:
            error = str(exc)
            print(f"# follower {args.process_id} fabric error: {exc}",
                  flush=True)
        finally:
            svc.close()
        if error is None:
            print(f"# follower {args.process_id} done ({svc.launches} "
                  "launches joined)", flush=True)
        return {"role": "follower", "launches": svc.launches,
                "transport": svc.stats()["transport"], "fabric_error": error}

    fields = args.fields.split(",")
    print(f"# training {args.compressor} grid models on {fields} "
          f"({args.device}) ...", flush=True)
    before = launch_counts()
    t0 = time.perf_counter()
    hot, grid_models, uc2_models = {}, {}, {}
    for f in fields:
        slices = scientific.field_slices(
            f, count=args.train_slices + args.hot_slices, n=args.n,
            device=args.device)
        rng = float(slices.max() - slices.min())
        ebs = [r * rng for r in (1e-5, 1e-4, 1e-3, 1e-2)]
        train = slices[:args.train_slices]
        grid_models[f] = UC.EbGridModel.train(train, args.compressor, ebs,
                                              cfg=cfg)
        eps = ebs[2]
        models = {}
        for name in (args.compressor, "bitgrooming"):
            comp = C.get(name)
            crs = [comp.cr(s, eps) for s in train]
            models[name] = PL.CRPredictor.train(train, crs, eps, cfg=cfg)
        uc2_models[f] = (models, eps)
        # clients hold host rows: the service stages from the host
        hot[f] = slices[args.train_slices:].cpu().numpy()
    if args.device == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches, train_shapes = launches_since(before)
    print(f"trained in {train_s:.2f}s; kernel launches "
          f"{json.dumps(train_launches)}", flush=True)

    lat, lock = [], threading.Lock()
    errors, served = [], {}

    def client(svc, cid: int, count: int):
        rnd = np.random.default_rng(cid)
        try:
            for _ in range(count):
                f = fields[int(rnd.integers(len(fields)))]
                i = int(rnd.integers(args.hot_slices))
                x = hot[f][i]
                t = time.perf_counter()
                if rnd.random() < 0.5:
                    req = ("find_eb", f, i, float(rnd.uniform(3.0, 12.0)))
                    out = svc.find_eb(grid_models[f], x, target_cr=req[3])
                else:
                    req = ("best_compressor", f, i, None)
                    models, eps = uc2_models[f]
                    out = svc.best_compressor(models, x, eps)
                with lock:
                    lat.append(time.perf_counter() - t)
                    served.setdefault(req, []).append(out)
        except Exception as exc:        # reported after the run
            errors.append(exc)

    per_client = max(1, args.requests // args.clients)
    with svc:
        svc.warmup([(args.n, args.n)], grid_sizes=(1, 4),
                   row_buckets=(1, args.clients))
        before = launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(svc, c, per_client))
                   for c in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        serve_launches, serve_shapes = launches_since(before)
        stats = svc.stats()
    if errors:
        raise errors[0]
    verify = _verify(served, hot, grid_models, uc2_models, args.device,
                     UC) if args.verify else None
    if verify is not None:
        verify.update({k: stats[k] for k in ("recoveries", "epoch", "procs")})

    done = len(lat)
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    cache = stats["cache"]
    probes = cache["hits"] + cache["misses"]
    report = {
        "device": args.device, "fields": fields, "n": args.n,
        "mesh": stats["mesh"], "procs": stats["procs"],
        "compressor": args.compressor, "clients": args.clients,
        "requests": done, "train_s": train_s, "wall_s": wall,
        "req_per_s": done / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p95_ms": float(np.percentile(lat_ms, 95)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "max_ms": float(lat_ms[-1]),
        "hit_rate": cache["hits"] / max(probes, 1),
        "launches_train": train_launches, "launches_serve": serve_launches,
        "launches_by_shape": {"train": train_shapes, "serve": serve_shapes},
        "recoveries": stats["recoveries"], "epoch": stats["epoch"],
        "transport": stats["transport"], "verify": verify, "stats": stats}
    print(f"served {done} requests from {args.clients} clients in "
          f"{wall:.2f}s -> {done / wall:.1f} req/s")
    print(f"latency p50={report['p50_ms']:.1f}ms p95={report['p95_ms']:.1f}ms "
          f"p99={report['p99_ms']:.1f}ms max={report['max_ms']:.1f}ms")
    print(f"launches={stats['launches']} rows={stats['rows_launched']} "
          f"pad_rows={stats['pad_rows']} batches={stats['batches']} "
          f"executables={stats['executables']} "
          f"window_ms={stats['window_ms']:.3f} "
          f"(shrinks={stats['window_shrinks']})")
    for name, m in sorted(stats["methods"].items()):
        print(f"method {name}: {m['completed']} done ({m['failed']} "
              f"failed), {m['rows']} rows, p50={m['p50_ms']:.1f}ms "
              f"p95={m['p95_ms']:.1f}ms p99={m['p99_ms']:.1f}ms")
    print(f"cache: hit_rate={report['hit_rate']:.2%} "
          f"({cache['hits']}/{probes}), entries={cache['entries']}, "
          f"bytes={cache['bytes']}")
    print(f"kernel launches while serving {json.dumps(serve_launches)}",
          flush=True)
    if stats["recoveries"]:
        print(f"recoveries={stats['recoveries']} epoch={stats['epoch']} "
              f"transport={stats['transport']} procs={stats['procs']} "
              f"last_recovery_s={stats['last_recovery_s']:.3f} "
              f"last_detect_s={stats['last_detect_s']:.3f}", flush=True)
    if verify is not None:
        print(f"verify: {verify['checked']} distinct requests, "
              f"{verify['mismatches']} served results differ from the "
              f"direct call (recoveries={stats['recoveries']}, epoch="
              f"{stats['epoch']}, procs={stats['procs']})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


def _verify(served: dict, hot: dict, grid_models: dict, uc2_models: dict,
            device: str, UC) -> dict:
    """Each distinct request of the run made again as a direct call
    (``usecases``): how many served results differ from it."""
    import torch
    bad = 0
    for (kind, f, i, target), outs in served.items():
        x = torch.from_numpy(hot[f][i]).to(device)
        if kind == "find_eb":
            want = UC.find_error_bound_for_cr(grid_models[f], x, target)
        else:
            models, eps = uc2_models[f]
            want = UC.best_compressor(models, x, eps)
        bad += sum(out != want for out in outs)
    return {"checked": len(served), "mismatches": int(bad)}


if __name__ == "__main__":
    if _faulted(main()):
        # a collective abandoned on the faulted group may still be waiting
        # in a daemon thread; if it returned while the interpreter shut
        # down, the process would abort, so it leaves at once
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)

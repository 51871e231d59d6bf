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
``RetryAfter`` instead of queueing without limit).  The reference's
mesh, multi-process and fault-injection options come with the
distributed layer.
"""
from __future__ import annotations

import argparse
import json
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
    ap.add_argument("--out", default="", help="write the JSON report here")
    args = ap.parse_args(argv)

    import torch
    from repro_torch import compressors as C
    from repro_torch.core import pipeline as PL
    from repro_torch.core import predictors as P
    from repro_torch.core import usecases as UC
    from repro_torch.kernels import launch_counts, launches_since
    from repro_torch.data import scientific
    from repro_torch.serve.sweep_service import ServiceConfig, SweepService

    cfg = P.PredictorConfig(use_kernels=args.use_kernels)
    scfg = ServiceConfig(max_batch_slices=args.max_batch,
                         max_wait_ms=args.max_wait_ms,
                         min_wait_ms=args.min_wait_ms,
                         adapt_window=not args.no_adaptive_window,
                         max_live_batches=args.max_live_batches,
                         cache_bytes=args.cache_bytes,
                         max_queue_rows=args.queue_rows, pcfg=cfg)

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
    errors = []

    def client(svc, cid: int, count: int):
        rnd = np.random.default_rng(cid)
        try:
            for _ in range(count):
                f = fields[int(rnd.integers(len(fields)))]
                x = hot[f][int(rnd.integers(args.hot_slices))]
                t = time.perf_counter()
                if rnd.random() < 0.5:
                    svc.find_eb(grid_models[f], x,
                                target_cr=float(rnd.uniform(3.0, 12.0)))
                else:
                    models, eps = uc2_models[f]
                    svc.best_compressor(models, x, eps)
                with lock:
                    lat.append(time.perf_counter() - t)
        except Exception as exc:        # reported after the run
            errors.append(exc)

    per_client = max(1, args.requests // args.clients)
    with SweepService(scfg, device=args.device) as svc:
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

    done = len(lat)
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    cache = stats["cache"]
    probes = cache["hits"] + cache["misses"]
    report = {
        "device": args.device, "fields": fields, "n": args.n,
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
        "stats": stats}
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
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()

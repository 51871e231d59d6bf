"""Compression advisor CLI: sweep every variable of a dataset, report per
field the (compressor, error bound) that reaches each CR target.

The paper's production story (UC1 + UC2 at dataset scale): stream every
variable of a file-backed dataset through the chunked featurization
sweep (``core.stream``), train one ``EbGridModel`` per candidate
compressor on a small leading sample of each variable (the ONLY
compressor runs of the whole advice), and report per CR target the
compressor reaching it at the smallest error bound.

    python -m repro_torch.launch.advise DATASET --targets 4,8,16 \\
        --compressors sz2,sz3-lorenzo,zfp --budget-mb 512 --out report.json

``DATASET`` is a ``repro_torch.launch.make_dataset`` (or the reference's
``tools/make_dataset.py``) output: a memmap directory or an ``.npz``.
Variables larger than the card stream within ``--budget-mb``, and the
streamed features are bit-equal to an in-memory sweep.  Each variable's
streaming content digest (``slice_digest`` of the never-materialized
variable) lands in the report, which has the reference's format.  Two
options are the port's own: the run is on the card unless ``--device
cpu`` asks for the host, and ``--use-kernels`` takes the hashed q-ent
kernel route (exact while a grid eb's codes fit the 65536 bins, as the
default grid's do) in place of the exact sort route.  ``--service``
submits each chunk to an in-process ``serve.SweepService`` (its
``advise`` method, and ``quality`` under ``--psnr-floor``) in place of
the direct stream, its launches sharded over ``--mesh``; the report is
the same.  With ``--service`` across processes the mesh's first process
is the service's leader: it trains the models alone and streams every
chunk through the service, and the other processes join its launches
(``SweepService.serve``) and report nothing.

``--mesh auto|none|N|DEV,DEV,...`` shards the training sweeps and the
stream over a ``dist.sweep.SweepMesh``: ``auto`` takes every device of
the process (one shard each; no sharding with one), ``N`` the first N
of them (more than there are raises), and a comma list those devices
in order (a device may repeat: ``cuda:0,cuda:0`` puts two shards on one
card).  With ``--coordinator ADDRESS
--num-processes P --process-id I`` (and ``--backend``) the process first
joins a process group of P processes; the mesh then spans them (``auto``:
one shard per process), every process runs the same command on the
dataset, reads only its rows of each chunk, compresses only its share
of the training rows, and process 0 writes the report.  The variable's
digest needs every byte, so process 0 reads the variable once more for
it.  The report is the single-device report byte for byte.

Per-variable recommendation
---------------------------
Per-row predicted CRs (``AdviseMethod.cr_table``) aggregate across the
variable by HARMONIC mean per (compressor, grid eb): rows share one
uncompressed size, so the harmonic mean is the variable's total-bytes
CR.  Per target the eb hitting it interpolates log-log along the
(monotonized) CR-vs-eb curve; among compressors reaching the target the
SMALLEST eb (least distortion) wins, and when none reaches it the
closest-achieving compressor at the grid ceiling is reported with
``feasible: false``.

``--psnr-floor DB`` adds the quality axis (UC3): the same streamed pass
also emits the fused per-(row, eb) PSNR/NRMSE tensor, the variable's
worst-row PSNR curve turns the floor into an eb ceiling, and a setting
is feasible only when it meets the CR target inside the
quality-feasible region.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import compressors as C
from repro_torch.core import stream as ST
from repro_torch.core import usecases as UC
from repro_torch.core.predictors import PredictorConfig
from repro_torch.data import source as SRC
from repro_torch.dist import sweep as DS
from repro_torch.launch import mesh as M
from repro_torch.serve.method import AdviseMethod

DEFAULT_GRID_RELS = (1e-4, 1e-3, 1e-2)
DEFAULT_TARGETS = (4.0, 8.0, 16.0)


def harmonic_cr(cr_rows: np.ndarray) -> np.ndarray:
    """(k, n_comp, e) per-row CRs -> (n_comp, e) variable-level CRs.
    Rows have equal uncompressed size, so total_bytes / total_compressed
    is the harmonic mean of the per-row ratios."""
    return cr_rows.shape[0] / np.sum(1.0 / np.maximum(cr_rows, 1e-12),
                                     axis=0)


def eb_for_target(ebs: np.ndarray, crs: np.ndarray,
                  target: float) -> Optional[tuple[float, float]]:
    """Smallest grid-interpolated eb at which the (monotonized) CR curve
    reaches ``target``; None when even the grid ceiling falls short.
    Returns (eb, predicted_cr at that eb)."""
    mono = np.maximum.accumulate(np.maximum(crs, 1e-12))
    if target > mono[-1]:
        return None
    if target <= mono[0]:
        return float(ebs[0]), float(mono[0])
    le = float(np.interp(np.log(target), np.log(mono), np.log(ebs)))
    cr = float(np.exp(np.interp(le, np.log(ebs), np.log(mono))))
    return float(np.exp(le)), cr


def recommend(names, ebs: np.ndarray, var_cr: np.ndarray, targets, *,
              psnr_floor: Optional[float] = None,
              var_psnr: Optional[np.ndarray] = None) -> Dict[str, dict]:
    """Per-target pick from a (n_comp, e) variable CR table: the
    feasible compressor with the smallest eb, else the closest.

    With ``psnr_floor`` and ``var_psnr`` (the variable's worst-row PSNR
    per grid eb, compressor-independent), PSNR is monotonized
    nonincreasing in eb, the floor becomes an eb CEILING (the largest
    log-eb still meeting it), and only settings at or below it count as
    feasible; each recommendation then also reports ``predicted_psnr``
    and ``psnr_ok``.  When even the finest grid eb misses the floor,
    every target is infeasible and reports the finest-eb setting."""
    lg = np.log(ebs)
    le_ceil = None
    pm = None
    if psnr_floor is not None and var_psnr is not None:
        pm = np.minimum.accumulate(np.asarray(var_psnr, np.float64))
        if pm[0] < psnr_floor:
            out = {}
            for t in targets:
                ci = int(np.argmax(var_cr[:, 0]))
                out[f"{float(t):g}"] = {
                    "compressor": names[ci], "eb": float(ebs[0]),
                    "predicted_cr": float(var_cr[ci, 0]),
                    "predicted_psnr": float(pm[0]), "psnr_ok": False,
                    "feasible": False}
            return out
        if pm[-1] >= psnr_floor:
            le_ceil = float(lg[-1])
        else:
            # pm is nonincreasing: reversed it is nondecreasing, the
            # shape np.interp wants
            le_ceil = float(np.interp(psnr_floor, pm[::-1], lg[::-1]))

    def psnr_at(le: float) -> Optional[float]:
        return None if pm is None else float(np.interp(le, lg, pm))

    out: Dict[str, dict] = {}
    for t in targets:
        hits = []
        for ci, name in enumerate(names):
            hit = eb_for_target(ebs, var_cr[ci], float(t))
            if hit is None:
                continue
            if le_ceil is not None and np.log(hit[0]) > le_ceil + 1e-12:
                continue                # reaches the CR only past the floor
            hits.append((hit[0], name, hit[1]))
        if hits:
            eb, name, cr = min(hits)
            rec = {"compressor": name, "eb": eb,
                   "predicted_cr": cr, "feasible": True}
        elif le_ceil is None:
            ci = int(np.argmax(var_cr[:, -1]))
            rec = {"compressor": names[ci], "eb": float(ebs[-1]),
                   "predicted_cr": float(var_cr[ci, -1]), "feasible": False}
        else:
            # best achievable CR inside the quality-feasible region: CR is
            # (monotonized) nondecreasing in eb, so it sits at the ceiling
            le_cap = min(le_ceil, float(lg[-1]))
            caps = [float(np.exp(np.interp(
                le_cap, lg,
                np.log(np.maximum.accumulate(np.maximum(var_cr[ci], 1e-12))))))
                for ci in range(len(names))]
            ci = int(np.argmax(caps))
            rec = {"compressor": names[ci], "eb": float(np.exp(le_cap)),
                   "predicted_cr": caps[ci], "feasible": False}
        if pm is not None:
            p = psnr_at(float(np.log(rec["eb"])))
            rec["predicted_psnr"] = p
            rec["psnr_ok"] = bool(p >= psnr_floor - 1e-9)
        out[f"{float(t):g}"] = rec
    return out


def train_models(source: SRC.DatasetSource, name: str, *, compressors,
                 grid_rels, train_rows: int, cfg: PredictorConfig,
                 device="cuda", mesh=None):
    """The advisor's models of one variable: one ``EbGridModel`` per
    compressor on its first ``train_rows`` rows, over an eb grid of
    ``grid_rels`` times the sample's value range, trained under ``mesh``
    (sharded sweep; compressor runs split over a spanning mesh's
    processes).  Returns (models, ebs, value range), or None for a
    constant sample."""
    meta = source.meta(name)
    sample = source.read_rows(name, 0, min(int(train_rows), meta.rows))
    rng = float(np.max(sample) - np.min(sample))
    if rng <= 0:
        return None
    ebs = np.asarray([r * rng for r in grid_rels], np.float64)
    stack = torch.from_numpy(sample).to(device)
    models = {comp: UC.EbGridModel.train(stack, comp, ebs, cfg=cfg, mesh=mesh,
                                         ndim=len(meta.shape) - 1)
              for comp in compressors}
    return models, ebs, rng


def advise_variable(source: SRC.DatasetSource, name: str, *,
                    compressors, grid_rels, targets, train_rows: int,
                    cfg: PredictorConfig, stream: ST.StreamConfig,
                    psnr_floor: Optional[float] = None,
                    device="cuda", service=None, mesh=None) -> dict:
    """Train sample models + stream the full variable -> report entry.

    ``psnr_floor``: also stream the fused quality tensor (same pass,
    ``quality=True``) and recommend only quality-feasible settings (see
    :func:`recommend`).  ``service``: a ``serve.SweepService`` on
    ``device``; each chunk is submitted to its ``advise`` method (and,
    with a floor, its ``quality`` method) in place of the direct
    stream; the futures overlap the next chunk's read, and at most
    ``stream.max_in_flight`` chunks are outstanding, so the chunk
    budget bounds host memory on this path too.  ``mesh``: the training
    and the stream run sharded over it (collective under a
    process-spanning mesh, whose first process alone reads the variable
    once more for the digest; the others report none)."""
    meta = source.meta(name)
    trained = train_models(source, name, compressors=compressors,
                           grid_rels=grid_rels, train_rows=train_rows,
                           cfg=cfg, device=device, mesh=mesh)
    if trained is None:
        return {"shape": list(meta.shape), "skipped": "constant sample"}
    models, ebs, rng = trained

    digest = SRC.StreamingDigest()
    var_psnr = None
    if service is not None:
        pending, crs, quals = collections.deque(), [], []

        def drain_one():
            fut, qfut = pending.popleft()
            crs.append(fut.result()["cr"])
            if qfut is not None:
                quals.append(qfut.result())

        for _, chunk in source.chunks(name, budget_bytes=stream.budget_bytes):
            digest.update(chunk)
            # at most max_in_flight chunks (and their host copies) are
            # outstanding at the service, as in the direct stream
            while len(pending) >= stream.max_in_flight:
                drain_one()
            pending.append((service.submit_advise(models, chunk),
                            None if psnr_floor is None else
                            service.submit_quality(chunk, ebs, cfg)))
        while pending:
            drain_one()
        cr_rows = np.concatenate(crs, axis=0)
        if quals:
            var_psnr = np.concatenate(quals, axis=0)[:, :, 0].min(axis=0)
    else:
        spans = DS.mesh_spans_processes(mesh)
        feats = ST.stream_features(
            source, name, ebs, cfg, stream=stream, mesh=mesh,
            digest=None if spans else digest,
            quality=psnr_floor is not None, device=device)
        if psnr_floor is not None:
            feats, qual = feats
            # worst row per eb: the variable meets the floor only when
            # every row does
            var_psnr = np.asarray(qual)[:, :, 0].min(axis=0)
        cr_rows = AdviseMethod.cr_table(models, feats)
        if spans:
            digest = _first_process_digest(source, name, stream, mesh)

    var_cr = harmonic_cr(cr_rows)
    names = tuple(models)
    entry = {
        "shape": list(meta.shape), "rows": meta.rows,
        "digest": None if digest is None else digest.digest(),
        "eb_grid": [float(e) for e in ebs],
        "value_range": rng,
        "cr_by_compressor": {n: [float(c) for c in var_cr[i]]
                             for i, n in enumerate(names)},
        "targets": recommend(names, ebs, var_cr, targets,
                             psnr_floor=psnr_floor, var_psnr=var_psnr),
    }
    if var_psnr is not None:
        entry["psnr_floor"] = float(psnr_floor)
        entry["psnr_by_eb"] = [float(p) for p in var_psnr]
    return entry


def _first_process_digest(source: SRC.DatasetSource, name: str,
                          stream: ST.StreamConfig, mesh):
    """The variable's streaming digest, read whole by the mesh's first
    process (a spanning stream reads each row on one process only);
    None on the others."""
    import torch.distributed as dist
    if dist.get_rank() != mesh.ranks[0]:
        return None
    digest = SRC.StreamingDigest()
    for _, chunk in source.chunks(name, budget_bytes=stream.budget_bytes):
        digest.update(chunk)
    return digest


def advise_dataset(source: SRC.DatasetSource, *, compressors=None,
                   grid_rels=DEFAULT_GRID_RELS, targets=DEFAULT_TARGETS,
                   train_rows: int = 6,
                   cfg: PredictorConfig = PredictorConfig(),
                   stream: Optional[ST.StreamConfig] = None,
                   fields=None,
                   psnr_floor: Optional[float] = None,
                   device="cuda", service=None, mesh=None) -> dict:
    """The advisor as a library call (the CLI routes here).  Returns the
    full report dict; ``service`` and ``mesh`` as in
    :func:`advise_variable`."""
    stream = stream if stream is not None else ST.StreamConfig()
    report: dict = {"targets": [float(t) for t in targets],
                    "budget_bytes": stream.budget_bytes, "variables": {}}
    if psnr_floor is not None:
        report["psnr_floor"] = float(psnr_floor)
    for name in (fields if fields else source.variables()):
        meta = source.meta(name)
        comps = compressors if compressors else (
            C.STUDY_2D if len(meta.shape) == 3 else C.STUDY_3D)
        report["variables"][name] = advise_variable(
            source, name, compressors=comps, grid_rels=grid_rels,
            targets=targets, train_rows=train_rows, cfg=cfg,
            stream=stream, psnr_floor=psnr_floor, device=device,
            service=service, mesh=mesh)
    return report


def _print_report(report: dict, file=sys.stdout) -> None:
    print(f"# advisor report  (chunk budget "
          f"{report['budget_bytes'] / 2**20:.1f} MiB)", file=file)
    for name, var in report["variables"].items():
        if "skipped" in var:
            print(f"{name}: skipped ({var['skipped']})", file=file)
            continue
        print(f"{name}  shape={tuple(var['shape'])}  "
              f"digest={var['digest'][:12]}", file=file)
        for t, rec in var["targets"].items():
            note = "" if rec["feasible"] else "  (best achievable)"
            q = ""
            if "predicted_psnr" in rec:
                mark = "" if rec["psnr_ok"] else " <floor"
                q = f"  psnr={rec['predicted_psnr']:.1f}dB{mark}"
            print(f"  CR>={t:>4}: {rec['compressor']:<16} "
                  f"eb={rec['eb']:.3e}  predicted_cr={rec['predicted_cr']:.2f}"
                  f"{q}{note}", file=file)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.advise",
        description="Per-field compression recommendations for a "
                    "file-backed dataset via streamed predictor sweeps.")
    ap.add_argument("dataset", help="memmap dataset dir or .npz archive "
                                    "(launch.make_dataset output)")
    ap.add_argument("--fields", default="",
                    help="comma-separated variable subset (default: all)")
    ap.add_argument("--compressors", default="",
                    help="comma-separated candidate set (default: the "
                         "full STUDY_2D/STUDY_3D set per variable rank)")
    ap.add_argument("--targets", default=",".join(
        f"{t:g}" for t in DEFAULT_TARGETS),
        help="comma-separated CR targets")
    ap.add_argument("--grid-rels", default=",".join(
        f"{r:g}" for r in DEFAULT_GRID_RELS),
        help="eb grid as fractions of each variable's value range")
    ap.add_argument("--train-rows", type=int, default=6,
                    help="leading rows per variable the models train on "
                         "(the only compressor runs)")
    ap.add_argument("--psnr-floor", type=float, default=None,
                    help="minimum acceptable PSNR (dB) of the "
                         "quantization proxy; recommendations then pick "
                         "the cheapest quality-feasible setting (UC3)")
    ap.add_argument("--budget-mb", type=float, default=64.0,
                    help="per-chunk f32 byte budget (device memory cap)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="chunks the reader stages ahead (0 = synchronous)")
    ap.add_argument("--use-kernels", action="store_true",
                    help="q-ent by the hashed histogram kernel instead of "
                         "the exact sort route")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the sweeps and compressors run")
    ap.add_argument("--service", action="store_true",
                    help="route chunks through an in-process SweepService "
                         "advise method (coalesced launches + feature "
                         "cache)")
    ap.add_argument("--mesh", default="auto",
                    help="'auto' (every device of the process when >1, one "
                         "shard per process in a process group), 'none', "
                         "a shard count, or a comma list of devices "
                         "(cuda:0,cuda:0 puts two shards on one card)")
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
    ap.add_argument("--out", default="", help="write the JSON report here")
    args = ap.parse_args(argv)

    source = SRC.open_dataset(args.dataset)
    stream = ST.StreamConfig(budget_bytes=int(args.budget_mb * 2**20),
                             prefetch=args.prefetch)
    fields = [f for f in args.fields.split(",") if f]
    comps = [c for c in args.compressors.split(",") if c]
    targets = [float(t) for t in args.targets.split(",") if t]
    grid_rels = sorted(float(r) for r in args.grid_rels.split(",") if r)
    cfg = PredictorConfig(use_kernels=args.use_kernels)
    svc = None
    if args.coordinator:
        M.dist_init(args.coordinator, num_processes=args.num_processes,
                    process_id=args.process_id, backend=args.backend,
                    device=args.device)
    try:
        mesh = M.mesh_from_spec(args.mesh, args.device)
        if args.service:
            from repro_torch.serve.sweep_service import (ServiceConfig,
                                                         SweepService)
            sharded = DS.active_sweep_mesh(mesh)
            svc = SweepService(ServiceConfig(pcfg=cfg), mesh=sharded,
                               device=args.device if sharded is None
                               else None)
            if DS.mesh_spans_processes(sharded):
                # the leader trains alone and submits; followers join
                # its launches until it closes the service
                mesh = None
        if svc is not None and svc.role == "follower":
            svc.serve()
            report = None
        else:
            report = advise_dataset(
                source, compressors=comps or None, grid_rels=grid_rels,
                targets=targets, train_rows=args.train_rows, cfg=cfg,
                stream=stream, fields=fields or None,
                psnr_floor=args.psnr_floor, device=args.device, service=svc,
                mesh=mesh)
    finally:
        if svc is not None:
            svc.close()
        if args.coordinator:
            import torch.distributed as dist
            dist.destroy_process_group()
    if report is not None and args.process_id == 0:
        _print_report(report)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()

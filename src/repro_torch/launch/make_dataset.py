"""Deterministic multi-variable synthetic dataset writer.

Writes a file-backed dataset from the port's ``data.scientific`` field
generators (made on the card unless ``--device cpu``) without ever
holding a whole variable: a chunked ``GeneratorSource`` copied by
``write_dataset``, bounded by ``--budget-mb``.  The same spec always
writes the same bytes, 2-D slice variables are bit-equal to
``scientific.field_slices(field, count, seed, n)``, and the format is
the reference's, so ``tools/make_dataset.py``'s readers open it too.

    python -m repro_torch.launch.make_dataset OUT \\
        --var cesm-cloud:96:1800 --var miranda-vx:7:256:384:384 \\
        --format memmap --dtype float64

``--var field:count:n`` adds ``count`` rows of (n, n) 2-D slices;
``--var field:count:d:m:n`` adds ``count`` independent (d, m, n)
volumes (a rank-4 variable, written as ``<field>-vol``).  ``--format
memmap`` (default) writes a manifest directory; ``--format npz`` one
archive.  ``--dtype float64`` models real archives (readers pay the
f64 -> f32 ingest conversion).
"""
from __future__ import annotations

import argparse

from repro_torch.data import source as SRC


def parse_var(spec: str, seed: int) -> SRC.FieldVariable:
    parts = spec.split(":")
    if len(parts) not in (3, 5):
        raise SystemExit(
            f"--var {spec!r}: expected field:count:n (2-D slices) or "
            "field:count:d:m:n (volumes)")
    field, count = parts[0], int(parts[1])
    shape = tuple(int(p) for p in parts[2:])
    return SRC.FieldVariable(field, count, shape, seed=seed)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.make_dataset",
        description="Write a deterministic multi-variable synthetic "
                    "dataset (memmap dir or .npz) for streaming sweeps.")
    ap.add_argument("out", help="output dataset path")
    ap.add_argument("--var", action="append", default=[],
                    help="field:count:n (slices) or field:count:d:m:n "
                         "(volumes); repeatable")
    ap.add_argument("--format", choices=("memmap", "npz"), default="memmap")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget-mb", type=float, default=64.0,
                    help="per-chunk byte budget while writing")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the fields are generated")
    args = ap.parse_args(argv)
    if not args.var:
        raise SystemExit("need at least one --var spec")

    gen = SRC.GeneratorSource([parse_var(s, args.seed) for s in args.var],
                              device=args.device)
    path = SRC.write_dataset(
        args.out, gen, fmt=args.format, dtype=args.dtype,
        budget_bytes=int(args.budget_mb * 2**20), seed=args.seed)
    total = sum(gen.meta(n).nbytes_f32 for n in gen.variables())
    print(f"wrote {path}: {len(gen.variables())} variables, "
          f"{total / 2**20:.1f} MiB (f32 equivalent)")
    for n in gen.variables():
        print(f"  {n}: shape={gen.meta(n).shape} dtype={args.dtype}")
    return path


if __name__ == "__main__":
    main()

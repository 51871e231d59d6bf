#!/usr/bin/env python3
"""Time the port's Gram and q-ent CUDA kernels of two source trees side by
side on one GPU, at the shapes the main path launches them with.

    git archive <rev> | tar -x -C build/ab_base     # the tree to compare
    python3 tools/ab_kernels.py --base build/ab_base [--out FILE]

Both trees' ``src/repro_torch/csrc/{gram,qent}.cu`` must keep the C entry
points ``repro_gram_batched`` and ``repro_qent_hist``; each q-ent is given
the counter budget its own ``kernels/qent/ops.py`` sets.  Each library is
built with the port's nvcc flags, checked on the card (gram within rtol
2e-5 / atol 2e-3 of the float64 plain version, q-ent bit-equal to it) and
timed by CUDA events, back to back after a warm-up, in the order base,
this, this, base, on cesm-cloud 1800 x 1800 slices made on the card from
seed 0 (as ``chip_smoke.py`` makes them).  Prints one JSON object, last,
with the ``nvidia-smi`` name and power limit of the card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

QENT_BINS = 65536


def build(tree: Path, tag: str, nvcc_flags, nvcc: str) -> dict:
    """Compile gram.cu and qent.cu of ``tree``, both at once."""
    out_dir = ROOT / "build" / "repro_torch" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("gram", "qent"):
        src = tree / "src" / "repro_torch" / "csrc" / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        lib = out_dir / f"{tag}-{name}-{digest}.so"
        cmd = [nvcc, *nvcc_flags, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} {name}.cu failed to build:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def qent_budget(tree: Path) -> int:
    text = (tree / "src/repro_torch/kernels/qent/ops.py").read_text()
    m = re.search(r"^SMEM_BUDGET = (\d+) \* 1024", text, re.M)
    if m is None:
        raise RuntimeError(f"no SMEM_BUDGET in {tree}'s qent/ops.py")
    return int(m.group(1)) * 1024


def runners(torch, libs, budget):
    g = libs["gram"].repro_gram_batched
    g.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    g.restype = ctypes.c_int
    q = libs["qent"].repro_qent_hist
    q.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    q.restype = ctypes.c_int

    def gram(x):
        k, m, n = x.shape
        out = torch.empty((k, n, n), device=x.device)
        code = g(x.data_ptr(), out.data_ptr(), k, m, n, 1,
                 torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"gram: CUDA error {code}")
        return out

    def qent(x, eps):
        k, n = x.shape
        out = torch.zeros((k, eps.shape[0], QENT_BINS), dtype=torch.int32,
                          device=x.device)
        code = q(x.data_ptr(), eps.data_ptr(), out.data_ptr(), k, n,
                 eps.shape[0], QENT_BINS, budget,
                 torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"qent: CUDA error {code}")
        return out
    return gram, qent


def cuda_ms(torch, fn, reps: int) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="root of the tree to compare against")
    ap.add_argument("--out", help="also write the record as JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data import scientific as TS
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram import ref as gram_ref
    from repro_torch.kernels.qent import ref as qent_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    nvcc = _build.nvcc()
    trees = {"base": args.base.resolve(), "this": ROOT}
    fns = {tag: runners(torch, build(tree, tag, _build.NVCC_FLAGS, nvcc),
                        qent_budget(tree))
           for tag, tree in trees.items()}

    spec = TS.FIELDS["cesm-cloud"]
    data = TS.field_slices("cesm-cloud", count=40, n=spec.full_n, seed=0,
                           device="cuda")
    train, test = data[:32], data[32:]
    ebs = torch.tensor(spec.eps * 10.0 ** np.linspace(-0.5, 2.0, 6),
                       dtype=torch.float32, device="cuda")
    xc32 = train - train.mean(dim=1, keepdim=True)
    xc8 = test - test.mean(dim=1, keepdim=True)
    flat32, flat8 = train.reshape(32, -1), test.reshape(8, -1)
    cases = [("gram", (32, 1800, 1800), xc32, None, 5),
             ("gram", (8, 1800, 1800), xc8, None, 10),
             ("gram", (1, 1800, 1800), xc8[:1].contiguous(), None, 30),
             ("qent", (32, flat32.shape[1], 6), flat32, ebs, 5),
             ("qent", (8, flat8.shape[1], 6), flat8, ebs, 10),
             ("qent", (1, flat8.shape[1], 6), flat8[:1], ebs, 30),
             ("qent", (1, flat8.shape[1], 1), flat8[:1], ebs[1:2].contiguous(),
              30)]
    rows = []
    for kernel, shape, x, eps, reps in cases:
        if kernel == "gram":
            want = gram_ref.gram_xtx_batched(x)
            for tag in trees:
                got = fns[tag][0](x)
                torch.cuda.synchronize()
                if not torch.allclose(got, want, rtol=2e-5, atol=2e-3):
                    raise AssertionError(f"{tag} gram disagrees at {shape}")
            call = {tag: (lambda f=fns[tag][0]: f(x)) for tag in trees}
        else:
            want = qent_ref.qent_histogram_sweep(x, eps, QENT_BINS)
            for tag in trees:
                if not torch.equal(fns[tag][1](x, eps), want):
                    raise AssertionError(f"{tag} qent disagrees at {shape}")
            call = {tag: (lambda f=fns[tag][1]: f(x, eps)) for tag in trees}
        del want
        times = {"base": [], "this": []}
        for tag in ("base", "this", "this", "base"):
            times[tag].append(cuda_ms(torch, call[tag], reps))
        rows.append(dict(kernel=kernel, shape=list(shape), base_ms=times["base"],
                         this_ms=times["this"]))
        print(f"{kernel} {shape}: base {times['base']} ms, this "
              f"{times['this']} ms [{smi}]", flush=True)
    record = {"device": smi, "base": str(args.base), "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

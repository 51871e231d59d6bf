#!/usr/bin/env python3
"""Time the port's Gram, q-ent, quality and Lorenzo CUDA kernels of two
source trees side by side on one GPU, at the shapes the main path
launches them with.

    git archive <rev> | tar -x -C build/ab_base     # the tree to compare
    python3 tools/ab_kernels.py --base build/ab_base [--out FILE]

Both trees' ``src/repro_torch/csrc/{gram,qent,quality,lorenzo}.cu`` must
keep the C entry points ``repro_gram_batched``, ``repro_qent_hist``,
``repro_quality_sse`` and ``repro_lorenzo2d``; each q-ent is given the
counter budget its own ``kernels/qent/ops.py`` sets.  Each library is
built with the port's nvcc flags, checked on the card against this
tree's plain versions (gram within rtol 2e-5 / atol 2e-3 of float64, the
q-ent histograms, the quality SSE and the Lorenzo codes bit-equal) and
timed by CUDA events in the order base, this, this, base, on cesm-cloud
1800 x 1800 slices made on the card from seed 0 (as ``chip_smoke.py``
makes them): gram, q-ent and quality back to back after a warm-up (the
(32, 3.24 M) x 6 stacks exceed the 50 MB L2), Lorenzo on one slice with
the L2 flushed before each call (``chip_smoke.cold_cuda_ms``).  The
quality SSE is two launches (the tile folds, then the in-order tile
chain); ``torch.profiler``'s kernel rows split its time between them.
Prints one JSON object, last, with the ``nvidia-smi`` name and power
limit of the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import cold_cuda_ms, cuda_ms, nvidia_smi_line  # noqa: E402

QENT_BINS = 65536
KERNELS = ("gram", "qent", "quality", "lorenzo")
QUALITY_PASSES = ("tile_sse_kernel", "sum_tiles_kernel")


def build(tree: Path, tag: str, nvcc_flags, nvcc: str) -> dict:
    """Compile the four kernels of ``tree``, all at once."""
    from repro_torch.kernels._build import source_digest
    out_dir = ROOT / "build" / "repro_torch" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    csrc = tree / "src" / "repro_torch" / "csrc"
    for name in KERNELS:
        src = csrc / f"{name}.cu"
        lib = out_dir / f"{tag}-{name}-{source_digest(csrc, name)}.so"
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


def _bind(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def runners(torch, libs, budget) -> dict:
    """name -> a call of that kernel with the argument list of its
    ``kernels/<name>/ops.py`` wrapper's launch."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def checked(what, code):
        if code:
            raise RuntimeError(f"{what}: CUDA error {code}")

    g = _bind(libs["gram"], "repro_gram_batched", [P, P, I, I, I, I, P])
    q = _bind(libs["qent"], "repro_qent_hist", [P, P, P, I, L, I, I, I, P])
    s = _bind(libs["quality"], "repro_quality_sse", [P, P, P, P, I, L, I, P])
    lz = _bind(libs["lorenzo"], "repro_lorenzo2d",
               [P, P, I, I, ctypes.c_float, ctypes.c_float, P])

    def gram(x):
        k, m, n = x.shape
        out = torch.empty((k, n, n), device=x.device)
        checked("gram", g(x.data_ptr(), out.data_ptr(), k, m, n, 1, stream()))
        return out

    def qent(x, eps):
        k, n = x.shape
        out = torch.zeros((k, eps.shape[0], QENT_BINS), dtype=torch.int32,
                          device=x.device)
        checked("qent", q(x.data_ptr(), eps.data_ptr(), out.data_ptr(), k, n,
                          eps.shape[0], QENT_BINS, budget, stream()))
        return out

    def quality(x, eps):
        k, n = x.shape
        e = eps.shape[0]
        partial = torch.empty((-(-n // 2048), k * e), device=x.device)
        out = torch.empty((k, e), device=x.device)
        checked("quality", s(x.data_ptr(), eps.data_ptr(), partial.data_ptr(),
                             out.data_ptr(), k, n, e, stream()))
        return out

    def lorenzo(x, eps):
        m, n = x.shape
        out = torch.empty((m, n), dtype=torch.int32, device=x.device)
        checked("lorenzo", lz(x.data_ptr(), out.data_ptr(), m, n,
                              float(np.float32(2.0 * eps)),
                              float(np.float32(eps)), stream()))
        return out

    return dict(gram=gram, qent=qent, quality=quality, lorenzo=lorenzo)


def pass_split(torch, fn, reps: int) -> dict | None:
    """Device ms per call of each quality pass, from torch.profiler's
    kernel rows; None where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        for name in QUALITY_PASSES:
            if name in ev.key:
                split[name] = ev.self_device_time_total / 1e3 / reps
    return split if len(split) == len(QUALITY_PASSES) else None


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
    from repro_torch.kernels.lorenzo import ref as lor_ref
    from repro_torch.kernels.qent import ref as qent_ref
    from repro_torch.kernels.quality import ref as q_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
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
    flat32, flat8 = train.reshape(32, -1), test.reshape(8, -1)
    nel = flat8.shape[1]
    xc32 = train - train.mean(dim=1, keepdim=True)
    xc8 = test - test.mean(dim=1, keepdim=True)
    # (kernel, shape, inputs, reps, cold)
    cases = [("gram", (32, 1800, 1800), (xc32,), 5, False),
             ("gram", (8, 1800, 1800), (xc8,), 10, False),
             ("gram", (1, 1800, 1800), (xc8[:1].contiguous(),), 30, False),
             ("qent", (32, nel, 6), (flat32, ebs), 5, False),
             ("qent", (8, nel, 6), (flat8, ebs), 10, False),
             ("qent", (1, nel, 6), (flat8[:1], ebs), 30, False),
             ("qent", (1, nel, 1), (flat8[:1], ebs[1:2].contiguous()), 30,
              False),
             ("quality", (32, nel, 6), (flat32, ebs), 10, False),
             ("quality", (8, nel, 6), (flat8, ebs), 20, False),
             ("lorenzo", (1800, 1800), (test[0], float(ebs[1])), 50, True)]
    plain = {"gram": gram_ref.gram_xtx_batched,
             "qent": lambda x, e: qent_ref.qent_histogram_sweep(x, e, QENT_BINS),
             "quality": q_ref.sse_sweep, "lorenzo": lor_ref.lorenzo2d}
    rows = []
    for kernel, shape, inputs, reps, cold in cases:
        want = plain[kernel](*inputs)
        for tag in trees:
            got = fns[tag][kernel](*inputs)
            torch.cuda.synchronize()
            ok = (torch.allclose(got, want, rtol=2e-5, atol=2e-3)
                  if kernel == "gram" else torch.equal(got, want))
            if not ok:
                raise AssertionError(f"{tag} {kernel} disagrees at {shape}")
        del want, got
        call = {tag: (lambda f=fns[tag][kernel]: f(*inputs)) for tag in trees}
        timer = cold_cuda_ms if cold else cuda_ms
        times = {"base": [], "this": []}
        for tag in ("base", "this", "this", "base"):
            times[tag].append(timer(torch, call[tag], reps))
        row = dict(kernel=kernel, shape=list(shape), cold=cold,
                   base_ms=times["base"], this_ms=times["this"])
        if kernel == "quality":
            row["passes_ms"] = {tag: pass_split(torch, call[tag], reps)
                                for tag in trees}
        rows.append(row)
        log = (f"{kernel} {shape}{' cold' if cold else ''}: base "
               f"{times['base']} ms, this {times['this']} ms")
        if "passes_ms" in row:
            log += f"; passes {row['passes_ms']}"
        print(f"{log} [{smi}]", flush=True)
    record = {"device": smi, "base": str(args.base), "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

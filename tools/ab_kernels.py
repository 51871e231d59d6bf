#!/usr/bin/env python3
"""Time the port's Gram, q-ent, quality and Lorenzo CUDA kernels of two
source trees side by side on one GPU, at the shapes the main path
launches them with.

    git archive <rev> | tar -x -C build/ab_base     # the tree to compare
    python3 tools/ab_kernels.py --base build/ab_base [--gram-rn] [--out FILE]

Both trees' ``src/repro_torch/csrc/{gram,qent,quality,lorenzo}.cu`` must
keep the C entry points ``repro_gram_batched``, ``repro_qent_hist``,
``repro_quality_sse`` and ``repro_lorenzo2d``; each q-ent is given the
counter budget its own ``kernels/qent/ops.py`` sets, and each Gram the
argument list of its own tree: the contraction chunks and scratch
where its ``kernels/gram/ops.py`` sets a ``CHUNK_T`` (the chunked
kernel), none before (the cluster-split kernel).  Each library is
built with the port's nvcc flags, checked on the card against this
tree's plain versions (gram within rtol 2e-5 / atol 2e-3 of float64, the
q-ent histograms, the quality SSE and the Lorenzo codes bit-equal) and
timed by CUDA events in the order base, this, this, base, on cesm-cloud
1800 x 1800 slices made on the card from seed 0 (as ``chip_smoke.py``
makes them) and on Table 4's volume unfoldings (12 miranda-vx volumes of
256 x 384 x 384, X X^T of modes 0 and 1, held within 2e-5 sqrt(G_ii
G_jj) + 2e-3); each Gram row also says whether the two trees give the
same bits: gram, q-ent and quality back to back after a warm-up (the
(32, 3.24 M) x 6 stacks exceed the 50 MB L2), Lorenzo on one slice with
the L2 flushed before each call (``chip_smoke.cold_cuda_ms``).  The
quality SSE is two launches (the tile folds, then the in-order tile
chain); ``torch.profiler``'s kernel rows split its time between them.
``--gram-rn`` adds a third Gram, this tree's with its ``.ftz`` PTX
arithmetic (``mul/fma/add.rn.ftz.f32``) made the non-flushing
``__fmul_rn``/``__fmaf_rn``/``__fadd_rn``, to the Gram rows (order base,
this, rn, rn, this, base), which separates what the flush forms cost
from the rest of a change.  Each tree's Gram kernels' registers a
thread, as ptxas reports them (``-Xptxas -v``), are printed and
recorded.  Prints one JSON object, last, with the ``nvidia-smi`` name
and power limit of the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
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
# gram.cu's flushing PTX forms and their non-flushing intrinsics
FTZ_TO_RN = (
    ('asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));',
     "r = __fmul_rn(a, b);"),
    ('asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), '
     '"f"(c));', "r = __fmaf_rn(a, b, c);"),
    ('asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));',
     "r = __fadd_rn(a, b);"))


def rn_variant(tree: Path) -> Path:
    """A copy of ``tree``'s kernels (``csrc`` and the ``ops.py`` files the
    runners read) under ``build/ab_rn`` whose gram.cu computes with the
    non-flushing forms; raises if gram.cu lacks one of the three."""
    out = ROOT / "build" / "ab_rn"
    shutil.rmtree(out, ignore_errors=True)
    pkg = tree / "src" / "repro_torch"
    shutil.copytree(pkg / "csrc", out / "src" / "repro_torch" / "csrc")
    for name in ("gram", "qent"):
        dst = out / "src" / "repro_torch" / "kernels" / name
        dst.mkdir(parents=True)
        shutil.copy(pkg / "kernels" / name / "ops.py", dst / "ops.py")
    gram = out / "src" / "repro_torch" / "csrc" / "gram.cu"
    text = gram.read_text()
    for ftz, rn in FTZ_TO_RN:
        if ftz not in text:
            raise RuntimeError(f"{tree}'s gram.cu has no {ftz!r}")
        text = text.replace(ftz, rn)
    gram.write_text(text)
    return out


def build(tree: Path, tag: str, nvcc_flags, nvcc: str) -> tuple:
    """Compile the four kernels of ``tree``, all at once.  Returns (name
    -> library, gram's registers a thread by kernel, from ptxas)."""
    from repro_torch.kernels._build import source_digest
    out_dir = ROOT / "build" / "repro_torch" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    csrc = tree / "src" / "repro_torch" / "csrc"
    for name in KERNELS:
        src = csrc / f"{name}.cu"
        lib = out_dir / f"{tag}-{name}-{source_digest(csrc, name)}.so"
        cmd = [nvcc, *nvcc_flags, "-Xptxas", "-v", "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs, regs = {}, {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} {name}.cu failed to build:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
        if name == "gram":
            regs = ptxas_registers(out)
    return libs, regs


def ptxas_registers(text: str) -> dict:
    """Kernel (mangled name) -> registers a thread, from ``nvcc -Xptxas
    -v`` output (only the names and counts; no code changes with -v)."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = int(m.group(1))
            fn = None
    return out


def qent_budget(tree: Path) -> int:
    text = (tree / "src/repro_torch/kernels/qent/ops.py").read_text()
    m = re.search(r"^SMEM_BUDGET = (\d+) \* 1024", text, re.M)
    if m is None:
        raise RuntimeError(f"no SMEM_BUDGET in {tree}'s qent/ops.py")
    return int(m.group(1)) * 1024


def gram_chunk(tree: Path) -> int | None:
    """The tree's Gram contraction chunk, None for the cluster-split
    kernel (no ``CHUNK_T`` in its ``kernels/gram/ops.py``)."""
    text = (tree / "src/repro_torch/kernels/gram/ops.py").read_text()
    m = re.search(r"^CHUNK_T = (\d+)", text, re.M)
    return None if m is None else int(m.group(1))


def _bind(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def runners(torch, libs, budget, chunk_t) -> dict:
    """name -> a call of that kernel with the argument list of its
    ``kernels/<name>/ops.py`` wrapper's launch."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def checked(what, code):
        if code:
            raise RuntimeError(f"{what}: CUDA error {code}")

    g = _bind(libs["gram"], "repro_gram_batched",
              [P, P, I, I, I, I, P] if chunk_t is None
              else [P, P, P, I, I, I, I, I, I, P])
    q = _bind(libs["qent"], "repro_qent_hist", [P, P, P, I, L, I, I, I, P])
    s = _bind(libs["quality"], "repro_quality_sse", [P, P, P, P, I, L, I, P])
    lz = _bind(libs["lorenzo"], "repro_lorenzo2d",
               [P, P, I, I, ctypes.c_float, ctypes.c_float, P])

    def gram(x, xtx=True):
        k, m, n = x.shape
        big_n, t = (n, m) if xtx else (m, n)
        out = torch.empty((k, big_n, big_n), device=x.device)
        if chunk_t is None:
            checked("gram", g(x.data_ptr(), out.data_ptr(), k, m, n, int(xtx),
                              stream()))
            return out
        chunks = max(1, -(-t // chunk_t))
        tiles = -(-big_n // 128)
        partial = (torch.empty((k, tiles * (tiles + 1) // 2, chunks, 128 * 128),
                               device=x.device) if chunks > 1 else None)
        checked("gram", g(x.data_ptr(), out.data_ptr(),
                          None if partial is None else partial.data_ptr(),
                          k, m, n, int(xtx), chunks, chunk_t, stream()))
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
    ap.add_argument("--gram-rn", action="store_true",
                    help="also time this tree's Gram without the .ftz forms")
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
    if args.gram_rn:
        trees["rn"] = rn_variant(ROOT)
    fns, registers = {}, {}
    for tag, tree in trees.items():
        libs, registers[tag] = build(tree, tag, _build.NVCC_FLAGS, nvcc)
        fns[tag] = runners(torch, libs, qent_budget(tree), gram_chunk(tree))
    print(f"gram registers a thread (ptxas): {json.dumps(registers)}",
          flush=True)

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
    vols = torch.stack([TS.volume("miranda-vx", (256, 384, 384), seed=s,
                                  device="cuda") for s in range(12)])
    vc = vols - vols.mean(dim=(1, 2, 3), keepdim=True)
    del vols
    for u in (vc.reshape(12, 256, -1),
              torch.movedim(vc, 2, 1).reshape(12, 384, -1)):
        cases.append(("gram_xxt", tuple(u.shape), (u, False), 5, False))
    del vc
    plain = {"gram": gram_ref.gram_xtx_batched,
             "gram_xxt": lambda x, _: gram_ref.gram_xxt_batched(x),
             "qent": lambda x, e: qent_ref.qent_histogram_sweep(x, e, QENT_BINS),
             "quality": q_ref.sse_sweep, "lorenzo": lor_ref.lorenzo2d}
    rows = []
    for kernel, shape, inputs, reps, cold in cases:
        want = plain[kernel](*inputs)
        fn = "gram" if kernel == "gram_xxt" else kernel
        tags = [t for t in trees if t != "rn" or fn == "gram"]
        outs = {}
        for tag in tags:
            got = outs[tag] = fns[tag][fn](*inputs)
            torch.cuda.synchronize()
            if kernel == "gram_xxt":
                d = torch.diagonal(want, dim1=1, dim2=2).clamp(min=0).sqrt()
                ok = bool(((got - want).abs()
                           <= 2e-3 + 2e-5 * d[:, :, None] * d[:, None, :]).all())
            elif kernel == "gram":
                ok = torch.allclose(got, want, rtol=2e-5, atol=2e-3)
            else:
                ok = torch.equal(got, want)
            if not ok:
                raise AssertionError(f"{tag} {kernel} disagrees at {shape}")
        same_bits = torch.equal(outs["base"], outs["this"])
        rn_bits = torch.equal(outs["this"], outs["rn"]) if "rn" in outs else None
        del want, got, outs
        call = {tag: (lambda f=fns[tag][fn]: f(*inputs)) for tag in tags}
        timer = cold_cuda_ms if cold else cuda_ms
        times = {tag: [] for tag in tags}
        for tag in tags + tags[::-1]:
            times[tag].append(timer(torch, call[tag], reps))
        row = dict(kernel=kernel, shape=list(shape), cold=cold,
                   base_ms=times["base"], this_ms=times["this"],
                   same_bits=same_bits)
        if "rn" in times:
            row.update(rn_ms=times["rn"], rn_same_bits=rn_bits)
        if kernel == "quality":
            row["passes_ms"] = {tag: pass_split(torch, call[tag], reps)
                                for tag in tags}
        rows.append(row)
        log = (f"{kernel} {shape}{' cold' if cold else ''}: base "
               f"{times['base']} ms, this {times['this']} ms, same bits "
               f"{same_bits}")
        if "rn" in times:
            log += f"; rn {times['rn']} ms, same bits as this {rn_bits}"
        if "passes_ms" in row:
            log += f"; passes {row['passes_ms']}"
        print(f"{log} [{smi}]", flush=True)
    record = {"device": smi, "base": str(args.base),
              "gram_registers": registers, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

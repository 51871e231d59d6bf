#!/usr/bin/env python3
"""Time the port's Gram, q-ent, quality, Lorenzo and ZFP CUDA kernels of
two source trees side by side on one GPU, at the shapes the main path
launches them with.

    git archive <rev> | tar -x -C build/ab_base     # the tree to compare
    python3 tools/ab_kernels.py --base build/ab_base [--gram-rn]
        [--zfp-probes] [--out FILE]

Both trees' ``src/repro_torch/csrc/{gram,qent,quality,lorenzo,
zfp_block}.cu`` must keep the C entry points ``repro_gram_batched``,
``repro_qent_hist``, ``repro_quality_sse``, ``repro_lorenzo2d`` and
``repro_zfp_forward2d``; each ZFP is bound by its own tree's argument
list (the grid's CTAs from ``launch_plan`` where its
``kernels/zfp_block/ops.py`` has one, none before); each q-ent is given the
counter budget its own ``kernels/qent/ops.py`` sets (the H100's
196 608 bytes of ``kernels/tune.smem_budget`` where it sets none), and each Gram the
argument list of its own tree: the contraction chunks and scratch
where its ``kernels/gram/ops.py`` sets a ``CHUNK_T`` (the chunked
kernel), none before (the cluster-split kernel).  Each library is
built with the port's nvcc flags, checked on the card against this
tree's plain versions (gram within rtol 2e-5 / atol 2e-3 of float64, the
q-ent histograms, the quality SSE, the Lorenzo codes and the ZFP
coefficients and exponents bit-equal) and
timed by CUDA events in the order base, this, this, base, on cesm-cloud
1800 x 1800 slices made on the card from seed 0 (as ``chip_smoke.py``
makes them) and on Table 4's volume unfoldings (12 miranda-vx volumes of
256 x 384 x 384, X X^T of modes 0 and 1, held within 2e-5 sqrt(G_ii
G_jj) + 2e-3); each Gram row also says whether the two trees give the
same bits: gram, q-ent and quality back to back after a warm-up (the
(32, 3.24 M) x 6 stacks exceed the 50 MB L2), Lorenzo and ZFP on one
slice with the L2 flushed before each call (``chip_smoke.cold_cuda_ms``;
ZFP at 1800^2 on a cesm-cloud slice and at 1028^2 on a Gaussian field,
Fig 5's size), each ZFP row beside the copy floor: a cold copy of the
same 4 m n bytes into a second buffer, as ``copy_`` (a device-to-device
memcpy) and as ``torch.neg(x, out=...)`` (an SM kernel), the faster of
the two as ``copy_ms``.  ``--zfp-probes`` adds to the ZFP rows: the
bulk-copy design of ``tools/variants/zfp_bulk.cu`` at a few
(threads, stages, CTAs an SM), this tree's ZFP with its arithmetic
taken out (its loads and stores alone, the values' bits copied), and
cold times with an L2 full of clean lines (a 256 MB read) instead of
the dirty ones ``cold_cuda_ms``'s flush leaves.  The
quality SSE is two launches (the tile folds, then the in-order tile
chain); ``torch.profiler``'s kernel rows split its time between them.
``--gram-rn`` adds a third Gram, this tree's with its ``.ftz`` PTX
arithmetic (``mul/fma/add.rn.ftz.f32``) made the non-flushing
``__fmul_rn``/``__fmaf_rn``/``__fadd_rn``, to the Gram rows (order base,
this, rn, rn, this, base), which separates what the flush forms cost
from the rest of a change.  Each tree's Gram kernels' registers a
thread, and each ZFP's registers and static shared memory a CTA, as
ptxas reports them (``-Xptxas -v``; the bulk design's dynamic shared
memory is its stages'), are printed and recorded.  Prints one JSON
object, last, with the ``nvidia-smi`` name and power limit of the card.
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

from chip_smoke import SPIN_CYCLES, bound, cold_cuda_ms, cuda_ms  # noqa: E402
from chip_smoke import nvidia_smi_line  # noqa: E402

QENT_BINS = 65536
KERNELS = ("gram", "qent", "quality", "lorenzo", "zfp_block")
# the bulk-copy design's (threads, stages, CTAs an SM) timed by --zfp-probes
ZFP_BULK = ((128, 4, 4), (256, 4, 2), (256, 4, 3), (512, 2, 3))
# this tree's ZFP with its arithmetic taken out: the values' bits copied
ZFP_NOMATH = ("    exps[b] = zfp::forward_block(v, q);",
              "#pragma unroll\n"
              "    for (int i = 0; i < 16; ++i)\n"
              "      q[i / 4][i % 4] = __float_as_int(v[i / 4][i % 4]);\n"
              "    exps[b] = 0;")
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
    for name in ("gram", "qent", "zfp_block"):
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


def build(tree: Path, tag: str, nvcc_flags, nvcc: str,
          extra: dict | None = None) -> tuple:
    """Compile the kernels of ``tree`` and the ``extra`` libraries (name
    -> (source, nvcc -D flags)), all at once.  Returns (name -> library,
    name -> ptxas's kernels: registers and static shared memory)."""
    from repro_torch.kernels._build import source_digest
    out_dir = ROOT / "build" / "repro_torch" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    csrc = tree / "src" / "repro_torch" / "csrc"
    jobs = {name: (csrc / f"{name}.cu", [], source_digest(csrc, name))
            for name in KERNELS}
    for name, (src, defs) in (extra or {}).items():
        jobs[name] = (src, defs, "-".join(d.split("=")[-1] for d in defs))
    for name, (src, defs, key) in jobs.items():
        lib = out_dir / f"{tag}-{name}-{key}.so"
        cmd = [nvcc, *nvcc_flags, *defs, "-Xptxas", "-v", "-o", str(lib),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs, info = {}, {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} {name} failed to build:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
        info[name] = ptxas_info(out)
    return libs, info


def ptxas_info(text: str) -> dict:
    """Kernel (mangled name) -> {"registers", "smem"} a thread and a CTA,
    from ``nvcc -Xptxas -v`` output (no code changes with -v)."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            sm = re.search(r"(\d+) bytes smem", line)
            out[fn] = {"registers": int(m.group(1)),
                       "smem": int(sm.group(1)) if sm else 0}
            fn = None
    return out


def qent_budget(tree: Path) -> int:
    text = (tree / "src/repro_torch/kernels/qent/ops.py").read_text()
    m = re.search(r"^SMEM_BUDGET = (\d+) \* 1024", text, re.M)
    if m is not None:
        return int(m.group(1)) * 1024
    if "smem_budget" in text:          # kernels/tune.smem_budget("h100")
        return 196608
    raise RuntimeError(f"no SMEM_BUDGET in {tree}'s qent/ops.py")


def zfp_planned(tree: Path) -> bool:
    """Whether the tree's ZFP takes its grid from ``launch_plan``."""
    text = (tree / "src/repro_torch/kernels/zfp_block/ops.py").read_text()
    return re.search(r"^def launch_plan\(", text, re.M) is not None


def bulk_plan(m: int, n: int, sms: int, per_sm: int) -> tuple[int, int]:
    """(ctas, per) of ``tools/variants/zfp_bulk.cu``: CTA c takes blocks
    [c * per, (c + 1) * per) of the band-major order."""
    nblocks = (m // 4) * (n // 4)
    ctas = max(1, min(sms * per_sm, nblocks))
    per = -(-nblocks // ctas)
    return -(-nblocks // per), per


def nomath_variant() -> Path:
    """A copy of this tree's zfp_block.cu and its header under
    ``build/ab_zfp`` whose blocks skip the arithmetic."""
    out = ROOT / "build" / "ab_zfp"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", out)
    src = out / "zfp_block.cu"
    text = src.read_text()
    if ZFP_NOMATH[0] not in text:
        raise RuntimeError("zfp_block.cu has no zfp::forward_block call")
    src.write_text(text.replace(*ZFP_NOMATH))
    return src


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


def zfp_runner(torch, lib, plan, types):
    """A call of one ZFP library: ``plan(m, n)`` gives the arguments its
    argument list adds after (m, n), of ctypes ``types`` (none for the
    first kernel's 2-D grid)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _bind(lib, "repro_zfp_forward2d", [P, P, P, I, I, *types, P])

    def zfp(x):
        m, n = x.shape
        coef = torch.empty((m, n), dtype=torch.int32, device=x.device)
        exps = torch.empty((m // 4, n // 4), dtype=torch.int32,
                           device=x.device)
        code = fn(x.data_ptr(), coef.data_ptr(), exps.data_ptr(), m, n,
                  *plan(m, n), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"zfp: CUDA error {code}")
        return coef, exps
    return zfp


def clean_cold_ms(torch, fn, reps: int) -> float:
    """``cold_cuda_ms`` with the L2 filled by a 256 MB read instead of a
    write: the call finds no dirty line to write back."""
    scratch = torch.ones(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    fn()
    events = []
    for _ in range(reps):
        scratch.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        fn()
        pair[1].record()
        events.append(pair)
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def zfp_rows(torch, fns, probes, inputs, smi) -> list:
    """The ZFP rows: each tree's kernel (and ``probes``' calls, name ->
    fn) on each input, bit-equal to this tree's plain version (but the
    arithmetic-free probe), timed cold in turns beside the copy floor."""
    from repro_torch.kernels.zfp_block import ref as zfp_ref
    rows = []
    for x in inputs:
        m, n = x.shape
        want = zfp_ref.zfp_forward2d(x)
        kernels = {"base": fns["base"]["zfp"], "this": fns["this"]["zfp"],
                   **probes}
        outs = {}
        for tag, f in kernels.items():
            outs[tag] = f(x)
            torch.cuda.synchronize()
            if tag != "nomath" and not all(
                    torch.equal(a, b) for a, b in zip(outs[tag], want)):
                raise AssertionError(f"{tag} zfp disagrees at {(m, n)}")
        same_bits = all(torch.equal(a, b)
                        for a, b in zip(outs["base"], outs["this"]))
        del outs, want
        dst = torch.empty_like(x)
        calls = {tag: (lambda f=f: f(x)) for tag, f in kernels.items()}
        calls.update(memcpy=lambda: dst.copy_(x),
                     neg=lambda: torch.neg(x, out=dst))
        times = {tag: [] for tag in calls}
        for tag in list(calls) + list(calls)[::-1]:
            times[tag].append(cold_cuda_ms(torch, calls[tag], 50))
        floor = {t: float(np.mean(times[t])) for t in ("memcpy", "neg")}
        b_ms, _ = bound(8.25 * m * n, 8.0 * m * n)
        row = dict(kernel="zfp", shape=[m, n], cold=True,
                   base_ms=times["base"], this_ms=times["this"],
                   same_bits=same_bits, memcpy_ms=times["memcpy"],
                   neg_ms=times["neg"], copy_ms=min(floor.values()),
                   copy_by=min(floor, key=floor.get), bound_ms=b_ms)
        if probes:
            row["probes_ms"] = {t: times[t] for t in probes}
            row["clean_l2_ms"] = {t: clean_cold_ms(torch, calls[t], 50)
                                  for t in ("base", "this", "nomath", "neg")}
        rows.append(row)
        print(f"zfp {(m, n)} cold: " + ", ".join(
            f"{t} {times[t]} ms" for t in calls)
            + f"; same bits {same_bits}; bound {b_ms} ms"
            + (f"; clean L2 {row['clean_l2_ms']}" if probes else "")
            + f" [{smi}]", flush=True)
    return rows


def runners(torch, libs, budget, chunk_t, zfp_args) -> dict:
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

    return dict(gram=gram, qent=qent, quality=quality, lorenzo=lorenzo,
                zfp=zfp_runner(torch, libs["zfp_block"], *zfp_args))


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
    ap.add_argument("--zfp-probes", action="store_true",
                    help="also time the bulk-copy ZFP, an arithmetic-free "
                         "ZFP and a clean L2")
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
    from repro_torch.kernels.zfp_block import ops as zfp_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    nvcc = _build.nvcc()
    trees = {"base": args.base.resolve(), "this": ROOT}
    if args.gram_rn:
        trees["rn"] = rn_variant(ROOT)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    I, LL = ctypes.c_int, ctypes.c_longlong
    extra = {}
    if args.zfp_probes:
        bulk = ROOT / "tools" / "variants" / "zfp_bulk.cu"
        for threads, stages in sorted({(t, s) for t, s, _ in ZFP_BULK}):
            extra[f"bulk_t{threads}_s{stages}"] = (
                bulk, [f"-DZFP_THREADS={threads}", f"-DZFP_STAGES={stages}"])
        extra["nomath"] = (nomath_variant(), [])
    fns, ptxas, probes = {}, {}, {}
    for tag, tree in trees.items():
        libs, ptxas[tag] = build(tree, tag, _build.NVCC_FLAGS, nvcc,
                                 extra if tag == "this" else None)
        zfp_args = (((lambda m, n: (zfp_ops.launch_plan(m, n, sms)[0],)),
                     [I]) if zfp_planned(tree) else ((lambda m, n: ()), []))
        fns[tag] = runners(torch, libs, qent_budget(tree), gram_chunk(tree),
                           zfp_args)
        if tag == "this" and args.zfp_probes:
            for threads, stages, per_sm in ZFP_BULK:
                probes[f"bulk_t{threads}_s{stages}_c{per_sm}"] = zfp_runner(
                    torch, libs[f"bulk_t{threads}_s{stages}"],
                    lambda m, n, c=per_sm: bulk_plan(m, n, sms, c), [I, LL])
            probes["nomath"] = zfp_runner(torch, libs["nomath"], *zfp_args)
    registers = {tag: info["gram"] for tag, info in ptxas.items()}
    zfp_ptxas = {tag: {k: v for k, v in info.items()
                       if k == "zfp_block" or k in extra}
                 for tag, info in ptxas.items()}
    print(f"gram registers a thread (ptxas): {json.dumps(registers)}",
          flush=True)
    print(f"zfp registers and static smem (ptxas): {json.dumps(zfp_ptxas)}; "
          "the bulk design's dynamic smem a CTA: " + json.dumps(
              {f"t{t}_s{s}": s * 4 * t * 16 + s * 8
               for t, s in sorted({(t, s) for t, s, _ in ZFP_BULK})}),
          flush=True)

    spec = TS.FIELDS["cesm-cloud"]
    data = TS.field_slices("cesm-cloud", count=40, n=spec.full_n, seed=0,
                           device="cuda")
    train, test = data[:32], data[32:]
    gauss = torch.randn((1028, 1028), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    rows = zfp_rows(torch, fns, probes, [test[0], gauss], smi)
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
              "gram_registers": registers, "zfp_ptxas": zfp_ptxas,
              "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

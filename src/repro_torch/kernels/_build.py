"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so <name>.cu

``--use_fast_math`` and ``-ftz=true`` are deliberately absent: the
kernels rely on IEEE division and ``sqrtf``, and flush subnormal
intermediates themselves where the reference does (``csrc/flush.cuh``;
their input is flushed by the entry points, ``quant.flush_subnormals``),
to match the plain versions bit for bit.  The library name carries a hash of the flags, the source and
the headers beside it (``csrc/*.cuh``), so an edited source is rebuilt
on its next use.  ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for them together.
A *variant* is a source built with ``-D`` defines of its own (the
candidates of ``kernels/tune.py``'s offline search); the kernels' entry
points load the plain build.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("gram", "qent", "quality", "lorenzo", "zfp_block")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch are compiled at first use")


def _flags(defines: Tuple[str, ...] = ()) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def source_digest(csrc: Path, name: str,
                  defines: Tuple[str, ...] = ()) -> str:
    """Hash of the nvcc flags (``defines`` included), ``<csrc>/<name>.cu``
    and every header it may include."""
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for path in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Where ``csrc/<name>.cu`` (with ``defines``) builds to, keyed by the
    sources' hash."""
    return BUILD_DIR / f"{name}-{source_digest(CSRC, name, defines)}.so"


def build(names: Iterable[str] = KERNELS,
          variants: Iterable[Tuple[str, Tuple[str, ...]]] = ()
          ) -> Dict[Any, Path]:
    """Compile every named kernel and every ``(name, defines)`` variant
    whose library is missing, one ``nvcc`` per library, all started
    together.  Returns name (or the variant's pair) -> library path."""
    specs = list(dict.fromkeys(
        [(n, ()) for n in names] + [(n, tuple(d)) for n, d in variants]))
    paths = {(n if not d else (n, d)): library_path(n, d) for n, d in specs}
    todo = [(n, d, library_path(n, d)) for n, d in specs
            if not library_path(n, d).exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for n, d, p in todo:
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *_flags(d), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, d, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, p))
    failed = []
    for n, d, proc, tmp, p in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu {' '.join(_flags(d)[len(NVCC_FLAGS):])} "
                          f"(nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, p)        # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (with ``defines``: a
    variant), built first if needed."""
    key = (name, tuple(defines))
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            path = library_path(name, key[1])
            if not path.exists():
                build((), [key])
            lib = _LIBS[key] = ctypes.CDLL(str(path))
        return lib


def count(fn, shape) -> None:
    """One launch of ``fn``'s kernel at ``shape``: its ``launches`` and
    ``by_shape`` counters go up together under a lock, so launches from
    several threads (a service's worker and its post-processing pool)
    are all counted."""
    with _COUNT_LOCK:
        fn.launches += 1
        fn.by_shape[shape] += 1


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(t: torch.Tensor, what: str, dtype=torch.float32) -> None:
    """The wrapper-side checks every kernel needs before its pointers go
    to C: a contiguous tensor of the expected dtype on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")

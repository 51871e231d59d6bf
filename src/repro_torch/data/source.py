"""Out-of-core dataset sources: named variables -> fixed-budget chunks.

A :class:`DatasetSource` names its variables and serves any contiguous
row range of each one on demand; :meth:`DatasetSource.chunks` turns a
variable into fixed-budget row chunks.  The streaming sweep driver
(``repro_torch.core.stream``) consumes exactly this contract.

Three backings, as in the reference's ``data.source``:

* :class:`MemmapSource` -- a directory holding one raw C-order binary
  per variable plus a ``manifest.json`` (shape, dtype, file).
  ``read_rows`` slices a ``np.memmap``, so only the requested rows are
  ever resident.
* :class:`NpzSource` -- an ``.npz`` archive, for datasets that fit in
  host memory (the most recently read variable is cached).
* :class:`GeneratorSource` -- the port's ``data.scientific`` fields as a
  virtual dataset, made on the card by default: 2-D slice variables
  are bit-equal to ``scientific.field_slices`` row for row, volume
  variables are ``scientific.volume`` with a per-row seed.

The file format is byte for byte the reference's (``manifest.json``,
``format_version`` 1, raw C-order ``.bin``), so a dataset written by
either package opens in the other.  Rows are served as C-contiguous
float32 numpy arrays; a float64 file pays the f64 -> f32 conversion on
read, the ingest work a real archive costs.  :class:`StreamingDigest`
keeps its own copy of the reference's sha1 recipe, so equal bytes give
equal digests in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MANIFEST = "manifest.json"
_FORMAT_VERSION = 1


class StreamingDigest:
    """Incremental content digest of a variable fed as row chunks.

    The sha1 of the array's C-order float32 bytes followed by its shape
    (``str((rows,) + row_shape)``): the reference's ``slice_digest``
    recipe, which keys the feature cache.  Row chunks are contiguous
    along axis 0, so hashing each chunk's bytes in order gives the
    digest of the whole variable without it ever being resident."""

    def __init__(self):
        self._h = hashlib.sha1()
        self._rows = 0
        self._tail: Optional[Tuple[int, ...]] = None

    def update(self, chunk) -> "StreamingDigest":
        """Absorb the next row chunk (read as C-order float32); chunks
        must share a trailing shape."""
        arr = np.ascontiguousarray(np.asarray(chunk, np.float32))
        if arr.ndim == 0:
            raise ValueError("StreamingDigest needs rows, got a scalar")
        if self._tail is None:
            self._tail = arr.shape[1:]
        elif arr.shape[1:] != self._tail:
            raise ValueError(
                f"chunk trailing shape {arr.shape[1:]} != first chunk's "
                f"{self._tail}")
        self._h.update(memoryview(arr).cast("B"))
        self._rows += arr.shape[0]
        return self

    @property
    def rows(self) -> int:
        return self._rows

    def digest(self) -> str:
        """The hex digest so far: equal to ``slice_digest`` of the
        concatenation of every chunk absorbed.  More chunks may follow."""
        if self._tail is None:
            raise ValueError("StreamingDigest.digest() before any update()")
        h = self._h.copy()
        h.update(str((self._rows,) + self._tail).encode())
        return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class VariableMeta:
    """Shape and on-disk dtype of one named variable; ``shape[0]`` is the
    row axis the sweep chunks over."""
    name: str
    shape: Tuple[int, ...]
    dtype: str                         # on-disk dtype ("float32"/"float64")

    @property
    def rows(self) -> int:
        return int(self.shape[0])

    @property
    def row_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape[1:])

    @property
    def row_nbytes_f32(self) -> int:
        """float32 bytes of ONE row, the unit chunk budgets are charged in
        (chunks are staged and launched as float32 whatever the file's
        dtype)."""
        return 4 * int(np.prod(self.row_shape, dtype=np.int64))

    @property
    def nbytes_f32(self) -> int:
        return self.rows * self.row_nbytes_f32


def rows_per_chunk(meta: VariableMeta, budget_bytes: int) -> int:
    """Rows of ``meta`` fitting a ``budget_bytes`` float32 chunk (>= 1: a
    row is the indivisible unit even when it alone exceeds the budget)."""
    if budget_bytes <= 0:
        raise ValueError(f"chunk budget must be positive, got {budget_bytes}")
    return max(1, min(meta.rows, budget_bytes // max(meta.row_nbytes_f32, 1)))


class DatasetSource:
    """Named variables -> on-demand contiguous row ranges.

    Subclasses implement :meth:`variables`, :meth:`meta` and
    :meth:`read_rows`; chunk iteration, budget math and whole-variable
    reads are shared here."""

    def variables(self) -> Tuple[str, ...]:
        raise NotImplementedError

    def meta(self, name: str) -> VariableMeta:
        raise NotImplementedError

    def read_rows(self, name: str, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of variable ``name`` as a fresh C-contiguous
        float32 ``(hi - lo,) + row_shape`` array."""
        raise NotImplementedError

    def read_rows_into(self, name: str, lo: int, hi: int,
                       out: np.ndarray) -> np.ndarray:
        """:meth:`read_rows` written into ``out`` (a float32 array of the
        rows' shape, e.g. a view of pinned staging memory); file-backed
        sources convert straight into it, with no intermediate copy."""
        out[...] = self.read_rows(name, lo, hi)
        return out

    # -- shared conveniences -------------------------------------------

    def read(self, name: str) -> np.ndarray:
        """The whole variable (the in-memory path of tests and checks)."""
        return self.read_rows(name, 0, self.meta(name).rows)

    def chunk_rows(self, name: str, budget_bytes: int) -> int:
        return rows_per_chunk(self.meta(name), budget_bytes)

    def chunks(self, name: str, *, budget_bytes: Optional[int] = None,
               rows: Optional[int] = None,
               ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(lo, chunk)`` pairs covering variable ``name`` in order:
        every chunk has ``rows`` rows (from ``budget_bytes`` when not
        given) except a possibly ragged final one.  Boundaries depend
        only on (k, rows)."""
        meta = self.meta(name)
        if rows is None:
            if budget_bytes is None:
                raise ValueError("chunks() needs rows= or budget_bytes=")
            rows = rows_per_chunk(meta, budget_bytes)
        if rows < 1:
            raise ValueError(f"chunk rows must be >= 1, got {rows}")
        for lo in range(0, meta.rows, rows):
            hi = min(lo + rows, meta.rows)
            yield lo, self.read_rows(name, lo, hi)

    def _check_range(self, meta: VariableMeta, lo: int, hi: int) -> None:
        if not (0 <= lo <= hi <= meta.rows):
            raise ValueError(
                f"rows [{lo}, {hi}) out of range for variable "
                f"{meta.name!r} with {meta.rows} rows")


def _as_f32_rows(block) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(block, np.float32))


# ---------------------------------------------------------------------------
# File-backed sources
# ---------------------------------------------------------------------------


class MemmapSource(DatasetSource):
    """Raw-binary dataset directory (the out-of-core backing): a
    ``manifest.json`` mapping variable names to ``{"shape", "dtype",
    "file"}`` plus one C-order raw binary per variable, read through
    ``np.memmap`` so a chunk read touches only that chunk's bytes."""

    def __init__(self, path: str):
        self.path = str(path)
        mf = os.path.join(self.path, MANIFEST)
        if not os.path.exists(mf):
            raise FileNotFoundError(
                f"{self.path!r} is not a memmap dataset (no {MANIFEST}); "
                "write one with python -m repro_torch.launch.make_dataset "
                "or data.source.write_dataset")
        with open(mf) as f:
            manifest = json.load(f)
        if manifest.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported dataset format_version "
                f"{manifest.get('format_version')!r} in {mf}")
        self._vars: Dict[str, dict] = dict(manifest["variables"])
        self._maps: Dict[str, np.memmap] = {}

    def variables(self) -> Tuple[str, ...]:
        return tuple(self._vars)

    def meta(self, name: str) -> VariableMeta:
        spec = self._vars[name]
        return VariableMeta(name, tuple(int(s) for s in spec["shape"]),
                            str(spec["dtype"]))

    def _map(self, name: str) -> np.memmap:
        mm = self._maps.get(name)
        if mm is None:
            spec = self._vars[name]
            mm = self._maps[name] = np.memmap(
                os.path.join(self.path, spec["file"]), mode="r",
                dtype=np.dtype(spec["dtype"]),
                shape=tuple(int(s) for s in spec["shape"]))
        return mm

    def read_rows(self, name: str, lo: int, hi: int) -> np.ndarray:
        self._check_range(self.meta(name), lo, hi)
        return np.array(self._map(name)[lo:hi], dtype=np.float32, order="C")

    def read_rows_into(self, name: str, lo: int, hi: int,
                       out: np.ndarray) -> np.ndarray:
        self._check_range(self.meta(name), lo, hi)
        np.copyto(out, self._map(name)[lo:hi], casting="same_kind")
        return out


class NpzSource(DatasetSource):
    """``.npz`` dataset (host-memory backing): ``np.load`` materializes a
    whole variable per access, so the most recently read variable is
    cached.  For datasets larger than host memory use
    :class:`MemmapSource`."""

    def __init__(self, path: str):
        self.path = str(path)
        self._npz = np.load(self.path)
        self._cached: Tuple[Optional[str], Optional[np.ndarray]] = (None, None)

    def variables(self) -> Tuple[str, ...]:
        return tuple(self._npz.files)

    def meta(self, name: str) -> VariableMeta:
        if name != self._cached[0]:
            self._cached = (name, self._npz[name])
        arr = self._cached[1]
        return VariableMeta(name, tuple(arr.shape), str(arr.dtype))

    def read_rows(self, name: str, lo: int, hi: int) -> np.ndarray:
        meta = self.meta(name)               # fills the cache
        self._check_range(meta, lo, hi)
        return _as_f32_rows(self._cached[1][lo:hi])


def open_dataset(path: str) -> DatasetSource:
    """Open a dataset written by :func:`write_dataset`: a ``.npz`` file
    or a memmap manifest directory."""
    if os.path.isdir(path):
        return MemmapSource(path)
    if path.endswith(".npz"):
        return NpzSource(path)
    raise ValueError(
        f"{path!r} is neither a dataset directory nor a .npz archive")


# ---------------------------------------------------------------------------
# Generator-backed source (data.scientific as a virtual dataset)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FieldVariable:
    """One synthetic variable: ``count`` rows of a named
    ``data.scientific`` field.  ``shape=(n,)`` (or an int) makes rows
    (n, n) 2-D slices bit-equal to ``scientific.field_slices``;
    ``shape=(d, m, n)`` makes rows (d, m, n) volumes (a rank-4 variable)
    by ``scientific.volume`` with the seed ``seed + row``."""
    field: str
    count: int
    shape: Tuple[int, ...]
    seed: int = 0

    def __post_init__(self):
        shape = self.shape
        if isinstance(shape, int):
            shape = (int(shape),)
        object.__setattr__(self, "shape", tuple(int(s) for s in shape))
        if len(self.shape) not in (1, 3):
            raise ValueError(
                f"FieldVariable shape must be (n,) for 2-D slices or "
                f"(d, m, n) for volumes, got {self.shape}")

    @property
    def row_shape(self) -> Tuple[int, ...]:
        n = self.shape[0]
        return (n, n) if len(self.shape) == 1 else self.shape


class _FieldRows:
    """Rows of ``scientific.field_slices(field, count, seed, n)`` on
    demand.  ``field_slices`` draws every row from one sequential
    generator, so row ``i`` needs the generator's state after row
    ``i - 1``: the state after each row made is kept (a few bytes for a
    CUDA generator), and a read resumes from the last row made at or
    below its start.  A sequential stream so makes each row once, and
    every row is the bits ``field_slices`` gives it."""

    def __init__(self, field: str, count: int, n: int, seed: int, device):
        import torch
        from repro_torch.data import gaussian, scientific
        self._spec = scientific.FIELDS[field]
        self._n = n
        self._device = device
        self._gen = torch.Generator(device=device)
        self._gen.manual_seed(zlib.crc32(field.encode()) % (2 ** 31) + seed)
        self._draws = gaussian.TorchDraws(self._gen, device)
        self._zs = torch.linspace(0.0, math.pi, count,
                                  dtype=torch.float64).tolist()
        self._states: List = [self._gen.get_state()]   # [i]: before row i

    def rows(self, lo: int, hi: int) -> np.ndarray:
        if lo == hi:
            return np.zeros((0, self._n, self._n), np.float32)
        start = min(lo, len(self._states) - 1)
        self._gen.set_state(self._states[start])
        out = []
        for i in range(start, hi):
            row = self._spec.generator(self._draws, self._n, self._zs[i],
                                       device=self._device)
            if i + 1 == len(self._states):
                self._states.append(self._gen.get_state())
            if i >= lo:
                out.append(row.cpu().numpy())
        return np.stack(out)


class GeneratorSource(DatasetSource):
    """``data.scientific`` fields as a chunk-addressable dataset, made on
    ``device`` (the card unless the caller asks for the CPU).

    2-D slice variables are ``scientific.field_slices(field, count,
    seed, n)`` row for row (see :class:`_FieldRows`): a variable larger
    than host memory can be streamed or written to disk chunk by chunk
    with a bounded footprint."""

    def __init__(self, variables: Sequence[FieldVariable], device="cuda"):
        self.device = device
        self._vars: Dict[str, FieldVariable] = {}
        self._rows: Dict[str, _FieldRows] = {}
        for v in variables:
            key = self.variable_name(v)
            if key in self._vars:
                raise ValueError(f"duplicate generated variable {key!r}")
            self._vars[key] = v

    @staticmethod
    def variable_name(v: FieldVariable) -> str:
        return v.field if len(v.shape) == 1 else v.field + "-vol"

    def variables(self) -> Tuple[str, ...]:
        return tuple(self._vars)

    def meta(self, name: str) -> VariableMeta:
        v = self._vars[name]
        return VariableMeta(name, (v.count,) + v.row_shape, "float32")

    def read_rows(self, name: str, lo: int, hi: int) -> np.ndarray:
        self._check_range(self.meta(name), lo, hi)
        v = self._vars[name]
        if lo == hi:
            return np.zeros((0,) + v.row_shape, np.float32)
        if len(v.shape) == 1:
            rows = self._rows.get(name)
            if rows is None:
                rows = self._rows[name] = _FieldRows(
                    v.field, v.count, v.shape[0], v.seed, self.device)
            return _as_f32_rows(rows.rows(lo, hi))
        from repro_torch.data import scientific
        return _as_f32_rows(np.stack(
            [scientific.volume(v.field, v.shape, seed=v.seed + i,
                               device=self.device).cpu().numpy()
             for i in range(lo, hi)]))


def generate_field_rows(field: str, count: int, lo: int, hi: int, *,
                        n: Optional[int] = None, seed: int = 0,
                        device="cuda") -> np.ndarray:
    """Rows [lo, hi) of ``scientific.field_slices(field, count, seed,
    n)``, bit-equal to slicing the full stack.  The port's generator is
    sequential, so this one-off call makes rows [0, hi) and keeps the
    last ``hi - lo``; a :class:`GeneratorSource` streams without that
    cost."""
    from repro_torch.data import scientific
    n = n or scientific.FIELDS[field].n
    return _FieldRows(field, count, n, seed, device).rows(lo, hi)


# ---------------------------------------------------------------------------
# Dataset writer (``python -m repro_torch.launch.make_dataset`` wraps it)
# ---------------------------------------------------------------------------


def write_dataset(path: str, source: DatasetSource, *,
                  fmt: str = "memmap", dtype="float32",
                  budget_bytes: int = 64 << 20,
                  seed: Optional[int] = None) -> str:
    """Copy every variable of ``source`` to a file-backed dataset.

    ``fmt="memmap"`` writes ``<path>/manifest.json`` and one raw C-order
    binary per variable, chunk by chunk (peak memory one chunk);
    ``fmt="npz"`` writes one uncompressed archive.  ``dtype="float64"``
    upcasts on write, so streaming reads pay the f64 -> f32 ingest
    conversion of real archives; a ``{variable: dtype}`` mapping gives
    each variable its own.  Returns the dataset path (``fmt="npz"``
    appends ``.npz`` when missing)."""
    dtypes = {name: np.dtype(dtype[name] if isinstance(dtype, dict)
                             else dtype) for name in source.variables()}
    for d in dtypes.values():
        if d not in (np.dtype(np.float32), np.dtype(np.float64)):
            raise ValueError(f"dtype must be float32/float64, got {d}")
    if fmt == "npz":
        if not path.endswith(".npz"):
            path = path + ".npz"
        arrs = {name: source.read(name).astype(dtypes[name])
                for name in source.variables()}
        np.savez(path, **arrs)
        return path
    if fmt != "memmap":
        raise ValueError(f"fmt must be 'memmap' or 'npz', got {fmt!r}")
    os.makedirs(path, exist_ok=True)
    manifest = {"format_version": _FORMAT_VERSION, "seed": seed,
                "variables": {}}
    for name in source.variables():
        meta = source.meta(name)
        np_dtype = dtypes[name]
        fn = name.replace("/", "_") + ".bin"
        mm = np.memmap(os.path.join(path, fn), mode="w+", dtype=np_dtype,
                       shape=meta.shape)
        for lo, chunk in source.chunks(name, budget_bytes=budget_bytes):
            mm[lo:lo + chunk.shape[0]] = chunk.astype(np_dtype)
        mm.flush()
        del mm
        manifest["variables"][name] = {
            "shape": list(meta.shape), "dtype": str(np_dtype), "file": fn}
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return path

"""Entropy-coding size measurement (host-side).

The real byte counts come from zstandard on serialized quantization
codes, the lossless backend SZ/MGARD/Bit-Grooming use.  Where
``zstandard`` is not installed, stdlib DEFLATE (zlib) stands in and
``HAVE_ZSTD`` is False: CRs are then zlib-based and not comparable with
zstd-based ones.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

try:
    import zstandard

    HAVE_ZSTD = True
    _LOCAL = threading.local()   # a ZstdCompressor is not thread-safe

    def _compress(payload: bytes) -> bytes:
        cctx = getattr(_LOCAL, "cctx", None)
        if cctx is None:
            cctx = _LOCAL.cctx = zstandard.ZstdCompressor(level=3)
        return cctx.compress(payload)
except ImportError:  # minimal environments: stdlib DEFLATE stands in
    import zlib

    HAVE_ZSTD = False

    def _compress(payload: bytes) -> bytes:
        return zlib.compress(payload, 6)

BACKEND = "zstd" if HAVE_ZSTD else "zlib"


def host(arr) -> np.ndarray:
    """A tensor (on any device) or array as a C-ordered numpy array."""
    if isinstance(arr, torch.Tensor):
        return np.ascontiguousarray(arr.detach().cpu().numpy())
    return np.ascontiguousarray(np.asarray(arr))


def zstd_bytes(payload: bytes) -> int:
    """Entropy-coded byte count (zstd when installed, else zlib)."""
    return len(_compress(payload))


def pack_codes(codes: np.ndarray) -> tuple[bytes, int]:
    """Serialize integer codes in the narrowest width; large outliers are
    stored out-of-band like SZ's 'unpredictable values' list.

    Returns (payload, outlier_bytes).
    """
    codes = np.asarray(codes)
    lo, hi = codes.min(), codes.max()
    outlier_bytes = 0
    if lo >= np.iinfo(np.int16).min and hi <= np.iinfo(np.int16).max:
        if lo >= np.iinfo(np.int8).min and hi <= np.iinfo(np.int8).max:
            payload = codes.astype(np.int8).tobytes()
        else:
            payload = codes.astype(np.int16).tobytes()
    else:
        # clip to int16 range, store outliers exactly (4B each)
        clipped = np.clip(codes, np.iinfo(np.int16).min + 1, np.iinfo(np.int16).max)
        n_out = int(np.sum(clipped != codes))
        outlier_bytes = 8 * n_out  # 4B index + 4B value
        payload = clipped.astype(np.int16).tobytes()
    return payload, outlier_bytes


def coded_size_bytes(codes, aux_bytes: int = 0) -> int:
    """Real compressed size: zstd over packed codes + aux/outlier overhead."""
    payload, outlier_bytes = pack_codes(host(codes))
    return zstd_bytes(payload) + outlier_bytes + aux_bytes + 32  # header


def raw_zstd_size_bytes(arr, aux_bytes: int = 0) -> int:
    """zstd over raw array bytes (Bit Grooming / Digit Rounding path)."""
    return zstd_bytes(host(arr).tobytes()) + aux_bytes + 32

"""Error-feedback gradient compression gated by the paper's CR
prediction (``repro/train/grad_compress.py``).

Block-wise int8 quantization: int8 codes of 256-value blocks, each
block scaled by its largest magnitude, and a predicted CR of ``4 N /
(N H(codes) / 8 + 4 n_blocks)`` from the quantized entropy of the
codes (the paper's q-ent size model).  The serving layer's ``kv_gate``
method scores leaves with :func:`predicted_cr_rows`; training's
:func:`compress_tree` quantizes each gradient leaf (plus its carried
residual) and ships the round trip where the predicted CR clears
``gate_ratio``, keeping the quantization error as the next step's
residual (error feedback).

Bits follow the reference's float32 operations: the scale is
``max(amax, 1e-12) * f32(1/127)`` (the reference multiplies by the
reciprocal explicitly), ``round`` is half to even in both packages,
``log2`` is the reference's (``refmath.log2_f32``) and the 4096-term
entropy sum adds in XLA's order (``refmath.sum_rows_f32``).  Every step
is elementwise, a max or an integer count, and that sum runs row by
row in a fixed order, so a row's CR is the same bits alone and in any
batch.  The size model is the reference's jitted
``predicted_cr_int8``, which is the form every caller in its program
runs (the engine's gate, the service's ``kv_gate`` launcher and
``compress_tree`` are all jitted): XLA multiplies the counts by
``f32(1 / n)`` and contracts the size into ``fma(h, n / 8, 4
n_blocks)`` (its optimized IR and object code), which
:func:`predicted_cr_jit` follows.  The reference's eager call divides
``counts / n`` and rounds the size twice, so it differs where ``n`` is
not a power of two; nothing in its program runs it, and the port has
no such form.  The residual is ``fma(-code, scale, g)``, also
contracted there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import refmath
from repro_torch.kernels.quality.ref import fma32
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.quant import scalar, spans

BLOCK = 256  # quantization block (per-block scale)
DEFAULT_BINS = 4096
INV_127 = float(np.float32(1.0 / 127.0))


def _blockify(rows: torch.Tensor) -> torch.Tensor:
    """(k, n) -> (k, n_blocks, BLOCK), the last block zero-padded."""
    pad = (-rows.shape[1]) % BLOCK
    return torch.nn.functional.pad(rows, (0, pad)).reshape(
        rows.shape[0], -1, BLOCK)


def _quantize_blocks(blocks: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., BLOCK) float32 blocks -> (int8 codes, (...) float32 scales)."""
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) * scalar(INV_127, blocks)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127)
    return codes.to(torch.int8), scale[..., 0]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8: (codes (n_blocks, BLOCK) int8, scales)."""
    blocks = _blockify(x.reshape(1, -1).to(torch.float32))[0]
    return _quantize_blocks(blocks)


def dequantize_int8(codes: torch.Tensor, scales: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    n = int(np.prod(shape, dtype=np.int64))
    blocks = codes.to(torch.float32) * scales[:, None]
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def predicted_cr_rows(rows: torch.Tensor,
                      bins: int = DEFAULT_BINS) -> torch.Tensor:
    """(k, n) float32 rows -> (k,) predicted int8+entropy CRs against raw
    float32, each row the reference's jitted ``predicted_cr_int8`` of
    that row alone (:func:`predicted_cr_jit` of its code counts)."""
    blocks = _blockify(rows.to(torch.float32))
    k, nb, _ = blocks.shape
    codes, _ = _quantize_blocks(blocks)
    n = nb * BLOCK                       # codes, the padded block included
    idx = torch.remainder(codes.reshape(k, n).to(torch.int64) + 128, bins)
    idx = idx + (torch.arange(k, device=rows.device) * bins)[:, None]
    counts = torch.bincount(idx.reshape(-1), minlength=k * bins
                            ).reshape(k, bins)
    return predicted_cr_jit(counts, n, nb)


def predicted_cr_int8(g: torch.Tensor, bins: int = DEFAULT_BINS
                      ) -> torch.Tensor:
    """Predicted CR of the int8+entropy-coded ``g`` against raw float32:
    size ~ N H(codes) / 8 + 4 bytes per block scale, CR = 4 N / size
    (a 0-dim float32 tensor)."""
    return predicted_cr_rows(g.reshape(1, -1), bins)[0]


# ---------------------------------------------------------------------------
# Error feedback (training)
# ---------------------------------------------------------------------------

CHUNK_BLOCKS = 1 << 16      # blocks of a leaf quantized at a time


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    enabled: bool = True
    gate_ratio: float = 2.0       # predicted CR must beat this to compress
    qent_bins: int = DEFAULT_BINS


class EFState(NamedTuple):
    """Error-feedback residuals, one float32 tensor per gradient leaf."""
    residuals: Any


def init_ef(grads) -> EFState:
    return EFState(tree_unflatten(grads, [
        torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for g in tree_leaves(grads)]))


def _quantize_span(flat: torch.Tensor, lo: int, hi: int):
    """Codes (k, BLOCK) and scales (k,) of ``flat[lo:hi]``, whose last
    block is zero-padded as ``quantize_int8`` pads a leaf's."""
    return _quantize_blocks(_blockify(flat[lo:hi].reshape(1, -1))[0])


def _code_counts(codes: torch.Tensor, bins: int) -> torch.Tensor:
    """Histogram of ``(code + 128) % bins`` over int8 codes: a count of
    the 256 code values (uint8 adds wrap, so ``code + 128`` lands in
    [0, 255]), folded into ``bins``."""
    u = codes.reshape(-1).view(torch.uint8) + 128
    c256 = torch.bincount(u, minlength=256)
    if bins >= 256:
        return torch.nn.functional.pad(c256, (0, bins - 256))
    fold = torch.arange(256, device=codes.device) % bins
    return torch.zeros(bins, dtype=c256.dtype,
                       device=codes.device).index_add_(0, fold, c256)


def predicted_cr_jit(counts: torch.Tensor, n: int, n_blocks: int
                     ) -> torch.Tensor:
    """The predicted CR of ``n`` codes (padding included) in ``n_blocks``
    blocks from their ``counts`` histogram (..., bins), as the
    reference's jitted ``predicted_cr_int8`` computes it: ``p = counts *
    f32(1/n)``, the entropy sum in XLA's order, ``size = fma(h, n/8, 4
    n_blocks)`` and ``4 n / max(size, 1)`` (float32, one per histogram;
    each row's bits its own)."""
    like = counts
    inv_n = float(np.float32(1.0) / np.float32(n))
    p = counts.to(torch.float32) * scalar(inv_n, like)
    terms = torch.where(p > 0, p * refmath.log2_f32(torch.clamp(p, min=1e-30)),
                        torch.zeros_like(p))
    h = -refmath.sum_rows_f32(terms)
    size = fma32(h, float(np.float32(n) * np.float32(0.125)),
                 float(np.float32(n_blocks * 4.0)))
    return scalar(float(np.float32(4.0 * n)), like) / torch.clamp(size, min=1.0)


def _ef_leaf(g: torch.Tensor, r: torch.Tensor, cfg: CompressConfig,
             inplace: bool):
    """(sent in g's dtype, new residual, predicted CR) of one leaf."""
    flat_g = g.reshape(-1)
    gf = r.reshape(-1)
    if inplace:
        if not (g.is_contiguous() and r.is_contiguous()):
            raise ValueError("an in-place update needs contiguous leaves")
        gf.add_(flat_g)
    else:
        gf = flat_g.to(torch.float32) + gf
    n = gf.numel()
    n_blocks = -(-n // BLOCK)
    codes = torch.empty((n_blocks, BLOCK), dtype=torch.int8, device=g.device)
    scales = torch.empty(n_blocks, dtype=torch.float32, device=g.device)
    counts = torch.zeros(cfg.qent_bins, dtype=torch.int64, device=g.device)
    for lo, hi in spans(n, CHUNK_BLOCKS * BLOCK):
        c, sc = _quantize_span(gf, lo, hi)
        codes[lo // BLOCK: lo // BLOCK + c.shape[0]] = c
        scales[lo // BLOCK: lo // BLOCK + c.shape[0]] = sc
        counts += _code_counts(c, cfg.qent_bins)
    cr = predicted_cr_jit(counts, n_blocks * BLOCK, n_blocks)
    sent = flat_g if inplace and g.dtype == torch.float32 else torch.empty(
        n, dtype=g.dtype, device=g.device)
    if not bool(cr >= cfg.gate_ratio):
        sent.copy_(gf)
        resid = gf.zero_() if inplace else torch.zeros_like(gf)
        return sent.reshape(g.shape), resid.reshape(g.shape), cr
    resid = gf if inplace else torch.empty_like(gf)
    for lo, hi in spans(n, CHUNK_BLOCKS * BLOCK):
        b0, b1 = lo // BLOCK, -(-hi // BLOCK)
        cf = codes[b0:b1].to(torch.float32)
        sf = scales[b0:b1, None].expand_as(cf)
        cf, sf = cf.reshape(-1)[:hi - lo], sf.reshape(-1)[:hi - lo]
        sent[lo:hi] = cf * sf
        resid[lo:hi] = fma32(-cf, sf, gf[lo:hi])
    return sent.reshape(g.shape), resid.reshape(g.shape), cr


def compress_tree(grads, ef: EFState, cfg: CompressConfig,
                  inplace: bool = False) -> Tuple[Any, EFState, Any]:
    """Quantize-dequantize each leaf with error feedback + q-ent gating.

    Returns (sent grads, new EF state, {leaf: predicted CR}).  Per leaf:
    ``gf = g + r`` in float32; where the predicted CR of ``gf``'s int8
    codes clears ``gate_ratio`` the dequantized codes are sent (in
    ``g``'s dtype) and ``fma(-code, scale, gf)`` is kept; elsewhere
    ``gf`` is sent and the residual is exactly zero.  The leaves go
    through one at a time and a leaf's blocks ``CHUNK_BLOCKS`` at a
    time, so the temporaries stay small.  With ``inplace`` the sums and
    residuals are written over ``ef``'s tensors and float32 sent grads
    over ``grads``' (the port's form of donating them)."""
    if not cfg.enabled:
        return grads, ef, {}
    out = [_ef_leaf(g, r, cfg, inplace)
           for g, r in zip(tree_leaves(grads), tree_leaves(ef.residuals))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            EFState(tree_unflatten(grads, [o[1] for o in out])),
            tree_unflatten(grads, [o[2] for o in out]))

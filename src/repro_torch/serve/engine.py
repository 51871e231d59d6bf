"""Batched serving engine: prefill + decode with a KV-cache compression gate.

The paper's integration on the serving side (``repro/serve/engine.py``):
after prefill the cache's K/V leaves are scored with the q-ent size
model of their int8 codes; a leaf whose predicted CR clears
``kv_gate_ratio`` is stored int8-quantized (quantized and dequantized in
the cache), and the bytes it saves are metered.  This is the runtime
analogue of UC2: decide whether to compress without trial-compressing.

The gate's CRs are the reference's jitted ``predicted_cr_int8``
(``train.grad_compress.predicted_cr_int8``) per leaf, synced once, or -- with ``sweep_service=`` -- from the shared
``serve.sweep_service.SweepService``'s ``kv_gate`` method, so concurrent
engines' scoring coalesces into its batched launches and repeats ride its
cache.  Either way the gated leaves are rewritten by one quantize and
one dequantize over all their blocks together (a block's codes depend on
the block alone, so this equals the per-leaf round trip bit for bit).

A leaf is a candidate when it is a bfloat16 or float32 tensor of rank
>= 4, in ``jax.tree.flatten``'s order: for a dense model's cache that is
``[seg0.k, seg0.v]`` (``pos`` is int32), each leaf stacked over layers;
a hybrid segment adds its SSM's ``conv`` and float32 ``state``, and
whisper's cache scores ``k``, ``v``, ``xk`` and ``xv``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.train import grad_compress as GC


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 2048
    kv_compress: bool = False
    kv_gate_ratio: float = 2.5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def qdq_leaves(leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """``dequantize_int8(*quantize_int8(x), x.shape, x.dtype)`` of every
    leaf, as one quantize and one dequantize: each leaf is zero-padded to
    whole blocks (as ``quantize_int8`` pads it) and the blocks of all
    leaves go through together."""
    flats = [x.reshape(-1).to(torch.float32) for x in leaves]
    padded = [F.pad(f, (0, (-f.numel()) % GC.BLOCK)) for f in flats]
    codes, scales = GC.quantize_int8(torch.cat(padded))
    deq = GC.dequantize_int8(codes, scales, (codes.numel(),))
    out = []
    for x, part in zip(leaves, torch.split(deq, [p.numel() for p in padded])):
        out.append(part[:x.numel()].reshape(x.shape).to(x.dtype))
    return out


class Engine:
    def __init__(self, cfg: ModelConfig, params,
                 scfg: Optional[ServeConfig] = None, *, sweep_service=None):
        # None sentinel: a dataclass default instance would be shared (and
        # mutated) across every Engine constructed without a config
        scfg = scfg if scfg is not None else ServeConfig()
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self._svc = sweep_service
        self.kv_saved_bytes = 0
        self.kv_total_bytes = 0
        self.timings: Dict[str, Any] = {}

    def _predict_crs(self, leaves: List[torch.Tensor]) -> np.ndarray:
        """Predicted int8 CR per leaf: through the shared sweep service's
        ``kv_gate`` method when one was attached, else computed here on
        the leaves' device and read back once."""
        if self._svc is not None:
            return np.asarray(self._svc.submit_kv_gate(leaves).result())
        return torch.stack([GC.predicted_cr_int8(x.to(torch.float32))
                            for x in leaves]).cpu().numpy()

    def _maybe_compress_cache(self, cache):
        """Quantize-dequantize K/V leaves whose predicted CR clears the gate."""
        if not self.scfg.kv_compress:
            return cache

        leaves = tree_leaves(cache)
        cand = [i for i, x in enumerate(leaves)
                if x.dtype in (torch.bfloat16, torch.float32) and x.ndim >= 4]
        if not cand:
            return cache
        crs = self._predict_crs([leaves[i] for i in cand])
        gated = []
        for cr, i in zip(crs, cand):
            x = leaves[i]
            nbytes = x.numel() * x.element_size()
            self.kv_total_bytes += nbytes
            if float(cr) >= self.scfg.kv_gate_ratio:
                # quantize_int8 pads to BLOCK-sized blocks: nb blocks of
                # int8 codes plus one f32 scale each, metered host-side
                nb = -(-x.numel() // GC.BLOCK)
                self.kv_saved_bytes += int(nbytes - (nb * GC.BLOCK + nb * 4))
                gated.append(i)
        if gated:
            for i, leaf in zip(gated, qdq_leaves([leaves[i] for i in gated])):
                leaves[i] = leaf
        return tree_unflatten(cache, leaves)

    @torch.inference_mode()
    def generate(self, batch: Dict[str, torch.Tensor],
                 steps: int) -> torch.Tensor:
        """Prefill, one gate pass, then ``steps`` greedy decode steps;
        returns (B, steps) int32 ids.  The batch goes to the prefill
        whole: encdec reads its ``frames`` there.  The first id comes from the
        prefill's logits; the last decode's logits are not used.
        ``timings`` gets the prefill's and gate's seconds and each
        decode step's (each read after a device synchronize)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        dev = tokens.device
        t0 = time.perf_counter()
        logits, cache = M.prefill(self.params, batch, self.cfg,
                                  self.scfg.max_len)
        _sync(dev)
        t1 = time.perf_counter()
        cache = self._maybe_compress_cache(cache)
        _sync(dev)
        t2 = time.perf_counter()
        out, step_s = [], []
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for i in range(steps):
            t = time.perf_counter()
            out.append(tok[:, 0])
            logits, cache = M.decode_step(self.params, cache, tok, s + i,
                                          self.cfg)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            _sync(dev)
            step_s.append(time.perf_counter() - t)
        self.timings = {"prefill_s": t1 - t0, "gate_s": t2 - t1,
                        "decode_s": step_s}
        return torch.stack(out, dim=1)

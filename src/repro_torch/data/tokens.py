"""Deterministic synthetic token streams for LM training
(``repro/data/tokens.py``).

The reference's structured stream: noisy arithmetic progressions (a
random start, a stride in [1, 16], 10 % of positions replaced by random
ids), ids in ``[0, vocab)``, labels the tokens shifted by one.  Step N's
batch is a pure function of (seed, N): it is drawn from a
``torch.Generator`` seeded with both, on the host, then moved to
``device``.  So a restarted loop regenerates the exact same stream.

The draws are PyTorch's, not JAX's threefry bits: the two packages'
streams have the same law, not the same ids.  Parity tests feed both
packages one numpy batch.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig


def _generator(seed: int, step: int) -> torch.Generator:
    """A host generator for (seed, step): distinct pairs, distinct seeds."""
    return torch.Generator().manual_seed(
        ((int(seed) & 0xFFFFFFFF) << 31 | (int(step) & 0x7FFFFFFF))
        & 0x7FFFFFFFFFFFFFFF)


def _batch(gen: torch.Generator, batch: int, seq: int,
           vocab: int) -> torch.Tensor:
    """Structured (learnable) token stream: noisy arithmetic progressions."""
    start = torch.randint(0, vocab, (batch, 1), generator=gen)
    stride = torch.randint(1, 17, (batch, 1), generator=gen)
    base = (start + stride * torch.arange(seq)[None, :]) % vocab
    noise = torch.rand((batch, seq), generator=gen) < 0.1
    rand = torch.randint(0, vocab, (batch, seq), generator=gen)
    return torch.where(noise, rand, base).to(torch.int32)


def make_data_iter(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                   device="cuda"):
    """step -> batch dict (tokens/labels [+frames/mrope_positions]),
    deterministic in (seed, step), on ``device``."""
    def it(step: int) -> Dict[str, torch.Tensor]:
        gen = _generator(seed, step)
        toks = _batch(gen, batch, seq + 1, cfg.vocab_size)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "encdec":
            out["frames"] = torch.randn(
                (batch, cfg.encoder_frames, cfg.d_model), generator=gen
            ).to(torch.bfloat16).to(getattr(torch, cfg.dtype))
        if cfg.family == "vlm":
            out["mrope_positions"] = torch.arange(
                seq, dtype=torch.int32).expand(3, batch, seq)
        return {k: v.contiguous().to(device) for k, v in out.items()}
    return it

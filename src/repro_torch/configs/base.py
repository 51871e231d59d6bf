"""Model / shape / run configuration schema.

The reference's ``repro/configs/base.py`` field for field: every assigned
architecture is a ``ModelConfig`` (exact published dims) in
``repro_torch/configs/<id>.py`` with a reduced ``smoke()`` variant for
CPU tests, and ``ShapeConfig`` encodes the assigned input-shape cells.
All ten architectures are data here, and the port's model builds each
(``models/model``: ``models/whisper`` for encdec, ``models/causal_lm``
for the other six families).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | mla_moe | encdec | ssm | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # attention details
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0      # stablelm uses 0.25
    qkv_bias: bool = False           # qwen-style
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (if != d_ff)
    dense_first_layer: bool = False  # deepseek-v2: layer 0 is dense
    capacity_factor: float = 1.25
    # MLA (deepseek-v2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500       # stubbed conv-frontend output length
    # hybrid (hymba)
    window_size: int = 0             # sliding-window attention width (0=full)
    num_global_layers: int = 0       # full-attention layers in a SWA model
    meta_tokens: int = 0             # hymba learnable prefix
    # vlm (qwen2-vl)
    mrope_sections: Tuple[int, ...] = ()
    # numerics
    dtype: str = "bfloat16"
    # serving
    sliding_window_decode: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over the mesh."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM state or SWA)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Parameter count of the port's model."""
        from repro_torch.models import model as M
        return M.count_params(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1            # gradient-accumulation steps (train)


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524288, 1),
}

ARCH_IDS = [
    "stablelm-3b", "codeqwen1.5-7b", "granite-8b", "granite-3-2b",
    "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "whisper-large-v3",
    "mamba2-370m", "qwen2-vl-72b", "hymba-1.5b",
]


def _module(arch_id: str):
    import importlib
    return importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")


def get_arch(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()

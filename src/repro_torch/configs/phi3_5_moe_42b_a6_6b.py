"""phi3.5-moe-42b-a6.6b: 32L d_model=4096 32H (GQA kv=8) d_ff=6400 (per
expert), MoE 16 experts top-2, vocab=32064
[hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    num_experts=16, experts_per_token=2,
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256, num_experts=4, experts_per_token=2)

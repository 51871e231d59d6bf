"""stablelm-3b: 32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b family; unverified] -- StableLM-style
partial rotary embeddings (25%), MHA (kv == heads)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304, partial_rotary=0.25,
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256)

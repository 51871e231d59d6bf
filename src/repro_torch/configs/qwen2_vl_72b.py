"""qwen2-vl-72b: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064,
M-RoPE sections (16,24,24), dynamic-resolution vision frontend STUBBED
[arXiv:2409.12191; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, qkv_bias=True, rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, mrope_sections=(2, 3, 3))

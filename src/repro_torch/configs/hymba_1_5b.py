"""hymba-1.5b: 32L d_model=1600 25H (GQA kv=5) d_ff=5504, parallel
attn+mamba heads, ssm_state=16, SWA + 3 global layers, 128 meta tokens
[arXiv:2411.13676; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    window_size=1024, num_global_layers=3, meta_tokens=128,
    sliding_window_decode=True,
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, ssm_state=8,
        ssm_head_dim=16, window_size=32, num_global_layers=1,
        meta_tokens=8, ssm_chunk=16)

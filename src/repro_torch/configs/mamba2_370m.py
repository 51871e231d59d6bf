"""mamba2-370m: 48L d_model=1024 attn-free, ssm_state=128, SSD
[arXiv:2405.21060; unverified].  d_inner=2048, 32 heads x P=64, 1 group."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=32, num_kv_heads=32,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=32)

"""deepseek-v2-236b: 60L d_model=5120 128H MLA (kv_lora=512, rope 64,
nope/v head dims 128) d_ff=1536 per routed expert; 2 shared + 160 routed
top-6; dense first layer (d_ff=12288); vocab=102400 [arXiv:2405.04434; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="mla_moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=1536, vocab_size=102400, head_dim=128,
    num_experts=160, experts_per_token=6, num_shared_experts=2,
    moe_d_ff=1536, dense_first_layer=True,
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=64, vocab_size=256,
        num_experts=8, experts_per_token=2, num_shared_experts=1,
        moe_d_ff=64, q_lora_rank=32, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)

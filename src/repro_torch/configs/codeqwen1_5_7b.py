"""codeqwen1.5-7b: 32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416.
qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B; hf] -- QKV projection biases."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416, qkv_bias=True, rope_theta=1000000.0,
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=256)

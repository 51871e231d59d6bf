"""whisper-large-v3: enc-dec, 32+32L d_model=1280 20H d_ff=5120
vocab=51866 [arXiv:2212.04356; unverified].  Conv frontend STUBBED:
input_specs provides precomputed 1500-frame embeddings."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    num_layers=32, encoder_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, d_ff=5120, vocab_size=51866,
    encoder_frames=1500,
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, encoder_frames=64)

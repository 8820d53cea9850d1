"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.config import Config, ModelConfig


def config() -> Config:
    return Config(arch="llama3.2-3b", model=ModelConfig(
        name="llama3.2-3b", family="dense", num_layers=28, d_model=3072,
        num_heads=24, num_kv_heads=8, d_ff=8192, vocab_size=128256,
        rope_theta=500000.0))


def smoke() -> Config:
    return Config(arch="llama3.2-3b", model=ModelConfig(
        name="llama3.2-3b-smoke", family="dense", num_layers=2, d_model=48,
        num_heads=6, num_kv_heads=2, d_ff=96, vocab_size=128,
        rope_theta=500000.0))

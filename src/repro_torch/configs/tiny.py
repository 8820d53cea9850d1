"""Tiny dense config for unit tests and the quickstart example."""
from repro_torch.config import Config, ModelConfig, TrainConfig


def config() -> Config:
    return Config(arch="tiny", model=ModelConfig(
        name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256),
        train=TrainConfig(seq_len=64, global_batch=8, steps=10))


def smoke() -> Config:
    return config()

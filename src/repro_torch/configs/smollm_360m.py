"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
— llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from repro_torch.config import Config, ModelConfig


def config() -> Config:
    return Config(arch="smollm-360m", model=ModelConfig(
        name="smollm-360m", family="dense", num_layers=32, d_model=960,
        num_heads=15, num_kv_heads=5, d_ff=2560, vocab_size=49152))


def smoke() -> Config:
    return Config(arch="smollm-360m", model=ModelConfig(
        name="smollm-360m-smoke", family="dense", num_layers=2, d_model=60,
        num_heads=3, num_kv_heads=1, d_ff=120, vocab_size=128))

"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.config import Config, ModelConfig


def config() -> Config:
    return Config(arch="mixtral-8x22b", model=ModelConfig(
        name="mixtral-8x22b", family="moe", num_layers=56, d_model=6144,
        num_heads=48, num_kv_heads=8, d_ff=16384, vocab_size=32768,
        num_experts=8, experts_per_token=2,
        attn_pattern=("local",), window_size=4096))


def smoke() -> Config:
    return Config(arch="mixtral-8x22b", model=ModelConfig(
        name="mixtral-8x22b-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
        num_experts=4, experts_per_token=2,
        attn_pattern=("local",), window_size=8))

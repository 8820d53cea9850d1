"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + parallel dense residual FFN (dense-MoE hybrid)
[hf:Snowflake/snowflake-arctic-base; hf]."""
from repro_torch.config import Config, ModelConfig


def config() -> Config:
    return Config(arch="arctic-480b", model=ModelConfig(
        name="arctic-480b", family="moe", num_layers=35, d_model=7168,
        num_heads=56, num_kv_heads=8, d_ff=4864, vocab_size=32000,
        num_experts=128, experts_per_token=2, dense_residual_d_ff=4864))


def smoke() -> Config:
    return Config(arch="arctic-480b", model=ModelConfig(
        name="arctic-480b-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=256,
        num_experts=8, experts_per_token=2, dense_residual_d_ff=96))

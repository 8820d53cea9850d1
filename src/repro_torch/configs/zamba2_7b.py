"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 blocks + shared attention blocks
[arXiv:2411.15242; unverified].

Plan: period (mamba, mamba, attn) × 27; the attn(+MLP) block weights are
*shared* across all 27 periods (zamba2's signature trick).
"""
from repro_torch.config import Config, ModelConfig


def config() -> Config:
    return Config(arch="zamba2-7b", model=ModelConfig(
        name="zamba2-7b", family="hybrid", num_layers=81, d_model=3584,
        num_heads=32, num_kv_heads=32, d_ff=14336, vocab_size=32000,
        layer_pattern=("mamba", "mamba", "attn"), shared_attn_weights=True,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256))


def smoke() -> Config:
    return Config(arch="zamba2-7b", model=ModelConfig(
        name="zamba2-7b-smoke", family="hybrid", num_layers=6, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        layer_pattern=("mamba", "mamba", "attn"), shared_attn_weights=True,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8))

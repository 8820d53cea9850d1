"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.config import Config, ModelConfig


def config() -> Config:
    return Config(arch="mamba2-780m", model=ModelConfig(
        name="mamba2-780m", family="ssm", num_layers=48, d_model=1536,
        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
        layer_pattern=("mamba",), ssm_state=128, ssm_head_dim=64,
        ssm_expand=2, ssm_chunk=256))


def smoke() -> Config:
    return Config(arch="mamba2-780m", model=ModelConfig(
        name="mamba2-780m-smoke", family="ssm", num_layers=4, d_model=64,
        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=256,
        layer_pattern=("mamba",), ssm_state=16, ssm_head_dim=16,
        ssm_expand=2, ssm_chunk=8))

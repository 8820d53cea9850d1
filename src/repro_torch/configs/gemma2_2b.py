"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000
— local+global alternating attention, logit softcaps [arXiv:2408.00118; hf].

head_dim is 256 (not d_model/H); embeddings are tied and scaled by sqrt(d);
local window 4096; attn softcap 50, final softcap 30; post-norms.
"""
from repro_torch.config import Config, ModelConfig


def config() -> Config:
    return Config(arch="gemma2-2b", model=ModelConfig(
        name="gemma2-2b", family="dense", num_layers=26, d_model=2304,
        num_heads=8, num_kv_heads=4, head_dim=256, d_ff=9216,
        vocab_size=256000, attn_pattern=("local", "global"), window_size=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        tie_embeddings=True, scale_embed=True, use_post_norm=True,
        act_fn="gelu"))


def smoke() -> Config:
    return Config(arch="gemma2-2b", model=ModelConfig(
        name="gemma2-2b-smoke", family="dense", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        attn_pattern=("local", "global"), window_size=8,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        tie_embeddings=True, scale_embed=True, use_post_norm=True,
        act_fn="gelu"))

"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

The vision frontend is a stub, as in the reference: the batch carries
precomputed patch embeddings (B, num_image_tokens, d_model) as its
"memory" (``data/synthetic.lm_batch``), which the cross-attention slots
project and attend to.
"""
from repro_torch.config import Config, ModelConfig


def config() -> Config:
    return Config(arch="llama-3.2-vision-11b", model=ModelConfig(
        name="llama-3.2-vision-11b", family="vlm", num_layers=40,
        d_model=4096, num_heads=32, num_kv_heads=8, d_ff=14336,
        vocab_size=128256, cross_attn_every=5, num_image_tokens=1024,
        rope_theta=500000.0))


def smoke() -> Config:
    return Config(arch="llama-3.2-vision-11b", model=ModelConfig(
        name="llama-3.2-vision-11b-smoke", family="vlm", num_layers=4,
        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
        cross_attn_every=2, num_image_tokens=16))

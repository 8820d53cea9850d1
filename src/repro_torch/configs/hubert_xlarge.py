"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504
— encoder-only, wav2vec2-style backbone [arXiv:2106.07447; unverified].

Encoder-only: there is no decode step, so the serving engine refuses it.
The CNN feature extractor is a stub, as in the reference: the batch
carries precomputed frame embeddings (B, S, d_model) and framewise labels
(``data/synthetic.lm_batch``).
"""
from repro_torch.config import Config, ModelConfig


def config() -> Config:
    return Config(arch="hubert-xlarge", model=ModelConfig(
        name="hubert-xlarge", family="audio", num_layers=48, d_model=1280,
        num_heads=16, num_kv_heads=16, d_ff=5120, vocab_size=504,
        is_encoder=True, act_fn="gelu"))


def smoke() -> Config:
    return Config(arch="hubert-xlarge", model=ModelConfig(
        name="hubert-xlarge-smoke", family="audio", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=32,
        is_encoder=True, act_fn="gelu"))

"""AlexNet (CIFAR variant) — the paper's own evaluation model (tabs. 1–6)."""
import dataclasses

from repro_torch.config import Config, ModelConfig, QuantConfig, TrainConfig


def config() -> Config:
    return Config(arch="alexnet", model=ModelConfig(
        name="alexnet", family="cnn", vocab_size=10),
        quant=QuantConfig(buff=4),
        train=TrainConfig(seq_len=0, global_batch=512, steps=1000))


def smoke() -> Config:
    c = config()
    return dataclasses.replace(
        c, model=dataclasses.replace(c.model, name="alexnet-smoke"),
        train=dataclasses.replace(c.train, global_batch=16, steps=4))

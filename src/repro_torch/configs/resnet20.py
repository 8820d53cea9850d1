"""ResNet20 (CIFAR) — the paper's own evaluation model (tabs. 1–6)."""
import dataclasses

from repro_torch.config import Config, ModelConfig, QuantConfig, TrainConfig


def config() -> Config:
    return Config(arch="resnet20", model=ModelConfig(
        name="resnet20", family="cnn", vocab_size=10),
        quant=QuantConfig(buff=8),
        train=TrainConfig(seq_len=0, global_batch=512, steps=1000))


def smoke() -> Config:
    c = config()
    return dataclasses.replace(
        c, model=dataclasses.replace(c.model, name="resnet20-smoke"),
        train=dataclasses.replace(c.train, global_batch=16, steps=4))

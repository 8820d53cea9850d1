"""Architecture registry of the port: one module per architecture the
reference registers. Each module exposes ``config()`` (the published dims) and
``smoke()`` (a reduced same-family config for CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.config import Config

# arch id -> module name
_MODULES = {
    "granite-8b": "granite_8b",
    "gemma2-2b": "gemma2_2b",
    "llama3.2-3b": "llama3_2_3b",
    "smollm-360m": "smollm_360m",
    "mixtral-8x22b": "mixtral_8x22b",
    "arctic-480b": "arctic_480b",
    "zamba2-7b": "zamba2_7b",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-780m": "mamba2_780m",
    "alexnet": "alexnet",
    "resnet20": "resnet20",
    "tiny": "tiny",
}


def _load(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


# Production-mesh training defaults for the LM family, as in the reference
# registry (full-scan remat + 8-way gradient accumulation; arctic-480b also
# accumulates its gradients in bf16); the CNN family keeps its config's own.
_LM_TRAIN = {"remat": "full", "accum_steps": 8}
_ARCH_TRAIN = {
    "arctic-480b": {**_LM_TRAIN, "accum_dtype": "bfloat16"},
}


def get_config(arch: str) -> Config:
    cfg = _load(arch).config()
    if cfg.model.family != "cnn" and arch != "tiny":
        kw = _ARCH_TRAIN.get(arch, _LM_TRAIN)
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **kw))
    return cfg


def get_smoke_config(arch: str) -> Config:
    return _load(arch).smoke()


def list_archs() -> List[str]:
    return sorted(_MODULES)

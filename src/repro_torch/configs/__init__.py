"""Architecture registry of the port: one module per architecture the port
serves so far. Each module exposes ``config()`` (the published dims) and
``smoke()`` (a reduced same-family config for CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.config import Config

# arch id -> module name
_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "tiny": "tiny",
}

# Architectures the reference package registers that the port does not
# serve yet, with the slice of the port that brings each one.
_LATER = {
    "granite-8b": "the dense-family slice",
    "smollm-360m": "the dense-family slice",
    "gemma2-2b": "the gemma2 slice (softcap, local/global windows)",
    "mixtral-8x22b": "the MoE slice",
    "arctic-480b": "the MoE slice",
    "zamba2-7b": "the SSM/hybrid slice",
    "mamba2-780m": "the SSM/hybrid slice",
    "llama-3.2-vision-11b": "the VLM slice",
    "hubert-xlarge": "the audio-encoder slice",
    "alexnet": "the CNN slice",
    "resnet20": "the CNN slice",
}


def _load(arch: str):
    if arch in _LATER:
        raise KeyError(f"arch {arch!r} is not ported yet; it comes with "
                       f"{_LATER[arch]} (ROADMAP.md, Queue 1)")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


# Production-mesh training defaults for the LM family, as in the reference
# registry (full-scan remat + 8-way gradient accumulation).
_LM_TRAIN = {"remat": "full", "accum_steps": 8}


def get_config(arch: str) -> Config:
    cfg = _load(arch).config()
    if cfg.model.family != "cnn" and arch != "tiny":
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **_LM_TRAIN))
    return cfg


def get_smoke_config(arch: str) -> Config:
    return _load(arch).smoke()


def list_archs() -> List[str]:
    return sorted(_MODULES)

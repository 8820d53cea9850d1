"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` or, by default, ``cuda``. Raises when CUDA is asked for
    (explicitly or by default) and the host has none: the port never
    carries on quietly on the CPU; pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and this host has no CUDA "
            "device; pass device='cpu' to run the plain PyTorch versions")
    return dev

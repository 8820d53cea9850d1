"""Quantization-friendly initialization (paper §3.1).

Fan-in truncated-normal variance scaling (TNVS):

    W^l ~ N(mu=0, sigma=sqrt(s / n_in)), truncated at ±sqrt(3 s / n_in)

Counterpart of ``repro/core/init.py``: the same distribution drawn from a
``torch.Generator``, so not the same bits as ``jax.random`` (tests that need
equal weights take them from the reference through ``repro_torch.interop``).
"""
from __future__ import annotations

import torch


def fan_in(shape, kind: str = "linear") -> int:
    """n_in for a weights tensor. linear: (in, out) or (L, in, out);
    conv: (kh, kw, cin, cout); embed: (vocab, d) -> d is fan-in of the lookup."""
    if kind == "conv":
        kh, kw, cin = shape[-4], shape[-3], shape[-2]
        return kh * kw * cin
    if kind == "embed":
        return shape[-1]
    return shape[-2]


def tnvs(generator: torch.Generator, shape, *, scale: float = 1.0,
         kind: str = "linear", dtype=torch.float32,
         device=None) -> torch.Tensor:
    n = max(fan_in(shape, kind), 1)
    sigma = (scale / n) ** 0.5
    bound = (3.0 * scale / n) ** 0.5
    w = torch.empty(tuple(shape), dtype=torch.float32,
                    device=device if device is not None else generator.device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=sigma, a=-bound, b=bound,
                                generator=generator)
    return w.to(dtype)

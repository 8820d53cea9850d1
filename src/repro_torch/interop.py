"""Carry trees of numpy arrays, keyed and shaped as the JAX package's,
between the port's torch trees and numpy, both ways.

The two packages draw different random numbers from the same seed, so where
both must start from the same weights and state, the reference's trees are
converted to numpy (``jax.tree.map(np.asarray, tree)``) and brought over
here, and the port's go back the same way. numpy's bfloat16 (the
``ml_dtypes`` type JAX uses) is carried bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device) -> Dict[str, Any]:
    """Nested dict of numpy arrays → the same dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def adapt_state_from_numpy(state, device) -> Dict[str, Any]:
    """The reference's AdaPT controller state → the port's, "grad_sum"
    included. "tensors" is keyed by slash-joined param path in both."""
    out = {k: params_from_numpy(v, device) for k, v in state.items()
           if k != "tensors"}
    out["tensors"] = {
        path: {k: tensor_from_numpy(v, device) for k, v in ts.items()}
        for path, ts in state["tensors"].items()}
    return out


def seed_from_key(key) -> torch.Tensor:
    """The run seed of a reference PRNG key: ``jax.random.PRNGKey(seed)``
    is uint32 ``[0, seed]`` for a seed in [0, 2^32), and the port keeps the
    seed itself, an int64 scalar on the host, as ``train_loop.init_state``
    makes it. Raises on a key of any other form (a split or folded key),
    which no seed of the port stands for."""
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32 or int(k[0]) != 0:
        raise ValueError(f"not a PRNGKey(seed) of a seed in [0, 2^32): "
                         f"{k.dtype} {k.shape} {k.tolist()}")
    return torch.tensor(int(k[1]), dtype=torch.int64)


def train_state_from_numpy(state, device) -> Dict[str, Any]:
    """The reference's whole train state (params, stats, opt, adapt, step,
    rng) → the port's; the PRNG key becomes the port's run seed
    (``seed_from_key``)."""
    out = {k: params_from_numpy(v, device) for k, v in state.items()
           if k not in ("adapt", "rng")}
    out["adapt"] = adapt_state_from_numpy(state["adapt"], device)
    out["rng"] = seed_from_key(state["rng"])
    return out


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor (any device) → a numpy copy (the port updates state in
    place), bf16 as ``ml_dtypes.bfloat16`` bit for bit."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return np.array(t.view(torch.int16).numpy()).view(ml_dtypes.bfloat16)
    return np.array(t.numpy())


def to_numpy(tree):
    """A nested dict of tensors (a params tree or a whole train state) →
    the same dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)

"""Carry trees of numpy arrays, keyed and shaped as the JAX package's, into
the port's torch trees on a given device.

The two packages draw different random numbers from the same seed, so where
both must serve the same weights, the reference's trees are converted to
numpy (``jax.tree.map(np.asarray, tree)``) and brought over here. numpy's
bfloat16 (the ``ml_dtypes`` type JAX uses) is carried bit for bit.
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
    """The reference's AdaPT controller state → the port's: every leaf but
    the per-tensor "grad_sum", which the port's serving state leaves out
    (``repro_torch.core.controller``)."""
    out = {k: params_from_numpy(v, device) for k, v in state.items()
           if k != "tensors"}
    out["tensors"] = {
        path: {k: tensor_from_numpy(v, device) for k, v in ts.items()
               if k != "grad_sum"}
        for path, ts in state["tensors"].items()}
    return out

"""Optimizers: ASGD (the paper's AdaPT-SGD), plain SGD (with momentum), Adam
(ablation), with the paper's reduce-on-plateau (ROP) scheduler as tensor
state (counterpart of ``repro/train/optimizer.py``).

ASGD = SGD where gradients of quantized tensors are L2-normalized per
tensor (paper §3.3), and the loss already carries the L1/L2/P regularizers
(``core/sparsity.py``).

Trees are nested dicts of tensors keyed as the params. Where the reference
returns new arrays, the port updates IN PLACE to save device memory, and
says so: ``normalize_grads`` and ``clip_by_global_norm`` overwrite the
gradient tensors, ``apply_updates`` the params and the optimizer's moment
tensors. Each still returns its tree. The arithmetic is the reference's,
in the same order and precision: updates are computed in f32 and cast back
to each tensor's dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Set, Tuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.core.controller import flatten_with_path, unbind_layers


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def init_opt_state(params, ocfg: OptimizerConfig) -> Dict[str, Any]:
    dev = next(t for _, t in flatten_with_path(params)).device
    state: Dict[str, Any] = {
        "lr": torch.tensor(ocfg.lr, dtype=torch.float32, device=dev),
        "step": torch.tensor(0, dtype=torch.int32, device=dev),
        "rop_best": torch.tensor(float("inf"), dtype=torch.float32, device=dev),
        "rop_bad": torch.tensor(0, dtype=torch.int32, device=dev),
    }

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if ocfg.name == "adam":
        state["m"] = _map(zeros, params)
        state["v"] = _map(zeros, params)
    elif ocfg.momentum > 0.0:
        state["mom"] = _map(zeros, params)
    return state


def _layers(*leaves):
    """Per-layer views of same-shaped tensors for a stacked leaf (ndim >= 3),
    else the tensors whole: f32 temporaries stay per layer."""
    return unbind_layers(*leaves, stacked=leaves[0].ndim >= 3)


def _sq_norm(g: torch.Tensor) -> torch.Tensor:
    """Σ g² in f32."""
    return sum(torch.sum(torch.square(p.to(torch.float32)))
               for (p,) in _layers(g))


def _whole(sum_over, path: str, t: torch.Tensor) -> torch.Tensor:
    """A sum over a leaf's block completed to the whole leaf:
    ``sum_over(path, t)`` all-reduces it over the ranks that hold the
    leaf's other blocks (the identity for a leaf held whole)."""
    return t if sum_over is None else sum_over(path, t)


def normalize_grads(grads, quantized_paths: Set[str], *, sum_over=None):
    """Per-tensor L2 normalization of the AdaPT-quantized tensors (paper
    §3.3): g / max(‖g‖₂, 1e-12) in f32, cast back to g's dtype. In place.
    For gradients held in blocks ``sum_over`` (``_whole``) makes ‖g‖ the
    whole tensor's."""
    for path, g in flatten_with_path(grads):
        if path in quantized_paths:
            sq = _whole(sum_over, path, _sq_norm(g))
            n = torch.clamp(torch.sqrt(sq), min=1e-12)
            for (p,) in _layers(g):
                p.copy_(p.to(torch.float32) / n)
    return grads


def global_norm(grads, *, sum_over=None) -> torch.Tensor:
    """√(Σ over leaves of Σ g²) in f32 (each leaf's sum over its whole
    tensor under ``sum_over``)."""
    return torch.sqrt(sum(_whole(sum_over, path, _sq_norm(g))
                          for path, g in flatten_with_path(grads)))


def clip_by_global_norm(grads, max_norm: float, *, sum_over=None):
    """g ← g·min(1, max_norm/‖g‖) in f32, cast back, in place; a no-op for
    ``max_norm <= 0``."""
    if max_norm <= 0:
        return grads
    norm = global_norm(grads, sum_over=sum_over)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for _, g in flatten_with_path(grads):
        for (p,) in _layers(g):
            p.copy_(p.to(torch.float32) * scale)
    return grads


def apply_updates(params, grads, state: Dict[str, Any],
                  ocfg: OptimizerConfig) -> Tuple[Any, Dict[str, Any]]:
    """p ← (p − lr·u) in f32, cast back to p's dtype, in place. u is the
    gradient (asgd/sgd), the momentum sum, or Adam's corrected step; the
    moment tensors are updated in place too. Elementwise, so params,
    gradients and moments may be a rank's blocks of the same layout."""
    lr = state["lr"]
    step = state["step"] + 1
    new_state = dict(state, step=step)
    if ocfg.name == "adam":
        b1, b2, eps = ocfg.beta1, ocfg.beta2, ocfg.adam_eps
        t = step.to(torch.float32)
        corr = torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        moments = (state["m"], state["v"])

        def update(g, m, v):
            gf = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * gf)
            v.copy_(b2 * v + (1 - b2) * torch.square(gf))
            return corr * m / (torch.sqrt(v) + eps)
    elif ocfg.momentum > 0.0:
        moments = (state["mom"],)

        def update(g, mo):
            mo.copy_(ocfg.momentum * mo + g.to(torch.float32))
            return mo
    else:
        moments = ()

        def update(g):
            return g.to(torch.float32)
    flat_g = dict(flatten_with_path(grads))
    flat_m = [dict(flatten_with_path(m)) for m in moments]
    for path, p in flatten_with_path(params):
        for pl, *rest in _layers(p, flat_g[path], *(m[path] for m in flat_m)):
            pl.copy_(pl.to(torch.float32) - lr * update(*rest))
    return params, new_state


def rop_update(state: Dict[str, Any], loss: torch.Tensor,
               ocfg: OptimizerConfig) -> Dict[str, Any]:
    """Reduce-on-plateau: lr *= factor after `patience` steps without a
    `threshold` improvement (paper §4.1 uses torch's ReduceLROnPlateau)."""
    loss = loss.to(torch.float32)
    improved = loss < state["rop_best"] - ocfg.rop_threshold
    best = torch.minimum(state["rop_best"], loss)
    bad = torch.where(improved, torch.zeros_like(state["rop_bad"]),
                      state["rop_bad"] + 1)
    reduce_now = bad >= ocfg.rop_patience
    lr = torch.where(reduce_now, state["lr"] * ocfg.rop_factor, state["lr"])
    bad = torch.where(reduce_now, torch.zeros_like(bad), bad)
    return dict(state, lr=lr, rop_best=best, rop_bad=bad)

"""Sparsifying regularization (paper §3.4; counterpart of
``repro/core/sparsity.py``).

    L̂(W) = L + α‖W‖₁ + (β/2)‖W‖₂² + P,   P = Σ_l (WL^l / 32) · sp^l

WL and sp enter P without gradient (discrete controller outputs).

The elastic net is taken over the value view of the quantized copy, as the
reference takes it over ``unpack_tree(qparams)``. A packed ⟨q8, sc, wref⟩
leaf may be passed as it is: it is read through its bf16 view
(``dequant_packed``) one leaf at a time, inside an autograd Function that
keeps no f32 temporary past its own leaf and routes the gradient
β·w ± α to "wref" in bf16, the gradient the reference's ``dequant_packed``
rule gives it. A quantize-prologue ⟨wm, seed, flq, mode⟩ leaf is read
through its f32 view (``fixed_point.qdense_view``), layer by layer: the
words are drawn again (on the card by the SR int8 kernel, whose words are
the prologue's for a 2-D slice) in the forward and once more in the
backward, and the gradient passes straight to "wm" in f32.

On a model axis of more than one rank a leaf held in ``model`` blocks
gives the rank's part of its terms: ``adapt_loss(model_blocks=,
model_sum=)`` sums those parts over the ranks (forward only; each block's
gradient stays its own) and counts a leaf whole on every rank once.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core.controller import unbind_layers


def _leaf_terms(w: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """α Σ|w| + β/2 Σ w² in f32, as the reference orders it."""
    w = w.to(torch.float32)
    return alpha * torch.sum(torch.abs(w)) + 0.5 * beta * torch.sum(w * w)


def _leaf_grad(w: torch.Tensor, alpha: float, beta: float, g) -> torch.Tensor:
    """g·(β·w ± α) in f32, the reference's autodiff of :func:`_leaf_terms`:
    its |w|' is +1 at w = 0 (a select on w >= 0), not sign(0) = 0."""
    w = w.to(torch.float32)
    return (w * beta).add_(torch.where(w >= 0, alpha, -alpha)).mul_(g)


class _ElasticNet(torch.autograd.Function):
    """:func:`_leaf_terms` of a plain tensor with the reference's gradient."""

    @staticmethod
    def forward(ctx, w, alpha, beta):
        ctx.save_for_backward(w)
        ctx.coef = (alpha, beta)
        return _leaf_terms(w, alpha, beta)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return _leaf_grad(w, *ctx.coef, g).to(w.dtype), None, None


def _layers(q8: torch.Tensor, sc: torch.Tensor):
    """(words, scale) per layer of a stacked (L, ...) leaf whose scale has
    its leading dim, else the leaf whole: temporaries stay per layer."""
    return unbind_layers(q8, sc, stacked=q8.ndim >= 3 and sc.ndim == q8.ndim
                         and sc.shape[0] == q8.shape[0])


class _PackedElasticNet(torch.autograd.Function):
    """α‖w‖₁ + β/2‖w‖₂² of the bf16 view of a packed leaf, without saving
    the view: the backward recomputes it from the words."""

    @staticmethod
    def forward(ctx, q8, sc, wref, alpha, beta):
        ctx.save_for_backward(q8, sc)
        ctx.coef = (alpha, beta)
        total = None
        for w8, s in _layers(q8, sc):
            term = _leaf_terms(fxp.dequant_packed(w8, s), alpha, beta)
            total = term if total is None else total + term
        return total

    @staticmethod
    def backward(ctx, g):
        q8, sc = ctx.saved_tensors
        alpha, beta = ctx.coef
        parts = [_leaf_grad(fxp.dequant_packed(w8, s), alpha, beta, g)
                 .to(torch.bfloat16) for w8, s in _layers(q8, sc)]
        dw = torch.stack(parts) if parts[0].ndim < q8.ndim else parts[0]
        return None, None, dw, None, None


class _QdenseElasticNet(torch.autograd.Function):
    """α‖v‖₁ + β/2‖v‖₂² of the view v of a prologue leaf, layer by layer,
    without saving the view: the backward draws the words again and writes
    g·(β·v ± α) into the f32 gradient of "wm"."""

    @staticmethod
    def forward(ctx, wm, seed, flq, mode, alpha, beta):
        ctx.save_for_backward(wm)
        ctx.meta = (seed, flq, mode)
        ctx.coef = (alpha, beta)
        total = None
        for args in _qdense_layers(wm, seed, flq, mode):
            term = _leaf_terms(fxp.qdense_view(*args), alpha, beta)
            total = term if total is None else total + term
        return total

    @staticmethod
    def backward(ctx, g):
        (wm,) = ctx.saved_tensors
        dw = torch.empty_like(wm)
        for args, out in zip(_qdense_layers(wm, *ctx.meta),
                             _qdense_layers(dw, *ctx.meta)):
            out[0].copy_(_leaf_grad(fxp.qdense_view(*args), *ctx.coef, g))
        return dw, None, None, None, None, None


def _qdense_layers(wm, seed, flq, mode):
    """(w, seed, fl, mode) of each 2-D layer of a prologue leaf: one per
    layer of a stacked leaf (its (L,) seed, FL and mode unbound with it),
    else the leaf whole."""
    return unbind_layers(wm, seed, flq, mode, stacked=flq.ndim > 0)


def _leaves(tree, prefix: str = ""):
    """(path, leaf) of a tree of dicts, a packed or prologue dict counting
    as a leaf."""
    if isinstance(tree, dict) and not (fxp.is_packed(tree)
                                       or fxp.is_qdense(tree)):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def elastic_net(params, alpha: float, beta: float, quantized_paths
                ) -> torch.Tensor:
    """α Σ‖W‖₁ + β/2 Σ‖W‖₂² over the quantized tensors only (those of
    ``quantized_paths`` that are in ``params``)."""
    total = None
    for path, leaf in _leaves(params):
        if path not in quantized_paths:
            continue
        if fxp.is_packed(leaf):
            term = _PackedElasticNet.apply(leaf["q8"], leaf["sc"],
                                           leaf["wref"], alpha, beta)
        elif fxp.is_qdense(leaf):
            term = _QdenseElasticNet.apply(leaf["wm"], leaf["seed"],
                                           leaf["flq"], leaf["mode"], alpha,
                                           beta)
        else:
            term = _ElasticNet.apply(leaf, alpha, beta)
        total = term if total is None else total + term
    return total if total is not None else torch.zeros((), dtype=torch.float32)


def wordlength_penalty(adapt_state: Dict[str, Any], max_wl: int = 32
                       ) -> torch.Tensor:
    """P = mean_l (WL^l/32 · sp^l); mean (not sum) keeps the coefficient
    architecture-size independent."""
    terms = [torch.mean(ts["wl"].detach().to(torch.float32) / float(max_wl)
                        * ts["sp"].detach())
             for ts in adapt_state["tensors"].values()]
    if not terms:
        return torch.zeros((), dtype=torch.float32)
    return torch.mean(torch.stack(terms))


def adapt_loss(task_loss: torch.Tensor, params, adapt_state, *, alpha: float,
               beta: float, penalty_coef: float, max_wl: int = 32,
               model_blocks=(), model_sum=None) -> torch.Tensor:
    """task + elastic net + WL penalty. ``model_blocks``: the quantized
    paths whose leaves are the rank's ``model`` blocks, whose partial terms
    ``model_sum`` (reduce from model) adds up over the ranks; the other
    leaves' terms are whole on every rank."""
    quantized = set(adapt_state["tensors"].keys())
    blocks = quantized & set(model_blocks)
    reg = elastic_net(params, alpha, beta, quantized - blocks)
    if blocks:
        reg = reg.to(task_loss.device) + model_sum(
            elastic_net(params, alpha, beta, blocks).to(task_loss.device))
    pen = penalty_coef * wordlength_penalty(adapt_state, max_wl)
    return task_loss + reg.to(task_loss.device) + pen.to(task_loss.device)

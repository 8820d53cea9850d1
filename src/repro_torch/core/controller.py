"""PrecisionController, serving half (counterpart of ``repro/core/controller.py``).

State layout (a plain dict tree):

    state = {
      "tensors": { path: {
          "wl":       int32 (L,) or ()     word length
          "fl":       int32 (L,) or ()     fractional length
          "lb":       int32 (L,) or ()     lookback
          "res":      int32 (L,) or ()     EDF resolution
          "count":    int32 (L,) or ()     optimizer steps in current window
          "norm_sum": f32   (L,) or ()     Σ‖g_k‖₂ over window
          "sp":       f32   (L,) or ()     non-zero fraction at last switch
      }},
      "strategy":  int32 ()                 st ∈ {0:min, 1:mean, 2:max}
      "loss_hist": f32 (H,)                 ring buffer
      "loss_ptr":  int32 ()
      "loss_seen": int32 ()
    }

The reference also keeps "grad_sum", a bf16 param-sized gradient sum that
only the training step reads and writes. Serving reads nothing but wl/fl,
so the port leaves grad_sum out until the training slice ports
``accumulate`` and ``precision_switch``.

Leaves with a leading stacked-layer dim L (the "blocks" stack) carry
per-layer precision.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.config import QuantConfig
from repro_torch.core import fixed_point as fxp

STACKED_PREFIXES = ("blocks", "layers")

_TRAINING_SLICE = ("comes with the training slice of the port "
                   "(ROADMAP.md, Queue 1)")


def path_str(path) -> str:
    return "/".join(str(k) for k in path)


def flatten_with_path(tree, prefix: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(slash-joined path, leaf) of a tree of dicts, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_with_path(v, prefix + (str(k),))
    else:
        yield path_str(prefix), tree


def is_quantized_leaf(path: str, leaf: torch.Tensor, qcfg: QuantConfig) -> bool:
    """Weights matrices/conv kernels are quantized; vectors, norms, routers,
    SSM dynamics params are not."""
    if leaf.ndim < 2:
        return False
    low = path.lower()
    return not any(pat in low for pat in qcfg.exclude)


def is_stacked(path: str) -> bool:
    return path.split("/", 1)[0] in STACKED_PREFIXES


def _per_layer_shape(path: str, leaf: torch.Tensor):
    return (leaf.shape[0],) if (is_stacked(path) and leaf.ndim >= 3) else ()


def init_adapt_state(params, qcfg: QuantConfig) -> Dict[str, Any]:
    tensors = {}
    device = None
    for p, leaf in flatten_with_path(params):
        device = leaf.device
        if not is_quantized_leaf(p, leaf, qcfg):
            continue
        ps = _per_layer_shape(p, leaf)

        def mk(v, dt):
            return torch.full(ps, v, dtype=dt, device=leaf.device)

        tensors[p] = {
            "wl": mk(qcfg.init_wl, torch.int32),
            "fl": mk(qcfg.init_fl, torch.int32),
            "lb": mk(qcfg.lb_lwr, torch.int32),
            "res": mk(qcfg.r_lwr, torch.int32),
            "count": mk(0, torch.int32),
            "norm_sum": mk(0.0, torch.float32),
            "sp": mk(1.0, torch.float32),
        }
    st0 = {"min": 0, "mean": 1, "max": 2}[qcfg.strategy]
    return {
        "tensors": tensors,
        "strategy": torch.tensor(st0, dtype=torch.int32, device=device),
        "loss_hist": torch.zeros((qcfg.loss_hist_len,), dtype=torch.float32,
                                 device=device),
        "loss_ptr": torch.tensor(0, dtype=torch.int32, device=device),
        "loss_seen": torch.tensor(0, dtype=torch.int32, device=device),
    }


def _sc_for(p: str, leaf: torch.Tensor, fl: torch.Tensor) -> torch.Tensor:
    """Dequant scale 2^-FL in bf16, shaped so a per-layer loop can slice it:
    per-layer (L,)-FL leaves get (L, 1, ...); a per-TENSOR ⟨WL,FL⟩ on a
    stacked leaf still gets the leading layer dim."""
    sc = fxp.pow2i(-fl).to(torch.bfloat16)
    if fl.ndim:
        return sc.reshape(tuple(fl.shape) + (1,) * (leaf.ndim - 1))
    if is_stacked(p) and leaf.ndim >= 2:
        return sc.reshape((1,) * leaf.ndim).expand(
            (leaf.shape[0],) + (1,) * (leaf.ndim - 1))
    return sc


def _set_path(tree: dict, path: str, value) -> None:
    *parents, last = path.split("/")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[last] = value


def quantize_params_packed(params, state: Dict[str, Any], qcfg: QuantConfig,
                           key=None):
    """Packed tree: quantized leaves become {"q8", "sc", "wref"} dicts
    (``fixed_point.PACKED_KEYS``); every other leaf is cast to bf16.

    Only the round-to-nearest branch (``key=None``, or stochastic rounding
    off) is ported: round-half-even words, clipped to [-128, 127]. The
    stochastic-rounding and quantize-prologue branches raise.

    "wref" is a bf16 zero of the leaf's shape that serving never reads, so
    it is a zero-stride view that takes no memory."""
    if key is not None and qcfg.stochastic_rounding:
        raise NotImplementedError(
            "stochastic-rounding quantize_params_packed " + _TRAINING_SLICE)
    if qcfg.use_pallas and qcfg.dense_prologue:
        raise NotImplementedError(
            "the quantize-prologue format (quant.dense_prologue) "
            + _TRAINING_SLICE)
    tensors = state["tensors"]
    out: Dict[str, Any] = {}
    for p, leaf in flatten_with_path(params):
        if p not in tensors:
            _set_path(out, p, leaf.to(torch.bfloat16))
            continue
        fl = tensors[p]["fl"]
        flb = fl.reshape(tuple(fl.shape) + (1,) * (leaf.ndim - 1)) \
            if fl.ndim else fl
        # in place on the one f32 temporary: at full width the largest leaf
        # is 2.8 GB in f32, so every extra temporary counts
        x = leaf.to(torch.float32) * fxp.pow2i(flb)
        q8 = x.round_().clamp_(-128.0, 127.0).to(torch.int8)
        del x
        wref = torch.zeros((), dtype=torch.bfloat16,
                           device=leaf.device).expand(leaf.shape)
        _set_path(out, p, {"q8": q8, "sc": _sc_for(p, leaf, fl),
                           "wref": wref})
    return out


def clamp_adapt_state(state: Dict[str, Any], max_wl) -> Dict[str, Any]:
    """AdaBits-style (1912.09666) serve-time view of the controller state:
    every tensor's WL clamped to ``max_wl``, FL reduced by the same amount
    so the integer range is preserved and only fractional LSBs are dropped.
    Returns a NEW state dict; the input is not mutated."""
    tensors = {}
    for path, ts in state["tensors"].items():
        wl = ts["wl"]
        new_wl = torch.clamp(wl, max=int(max_wl))
        tensors[path] = {**ts, "wl": new_wl, "fl": ts["fl"] - (wl - new_wl)}
    return {**state, "tensors": tensors}

"""MuPPET baseline (paper §2.2; counterpart of ``repro/core/muppet.py``), the
comparison system AdaPT is evaluated against.

MuPPET: block-floating-point quantization with a *global* word length WL^net
and per-layer scale factors, precision switched *upward only* between epochs
by an inter-epoch gradient-diversity ratio test. Quantization levels are a
fixed ladder (the MuPPET paper uses 8→12→14→16 → float32).

    s = | log2 min((UB+0.5)/X_max, (LB-0.5)/X_min) |        (per-layer scale)
    x_q = floor(x · 2^s + Unif(-0.5, 0.5))                  (stochastic)
    Δs(w)^j = Σ_l [ Σ_k ‖∇f_l^k‖² / ‖Σ_k ∇f_l^k‖² ] / |L|   (epoch j, window r)
    p = max S(j) / Δs(w)^j ;  switch when p > threshold ρ times

The arithmetic is the reference's op for op: log2 as its expansion
log(x) / log(2) in f32 and the scale 2^s built from the exponent bits, so
the quantized values are the reference's bits. The diversity's mean over
the layers is a float sum, taken in torch's order, not XLA's: it agrees
to an ulp or two.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core import threefry
from repro_torch.device import resolve_device

LADDER = (8, 12, 14, 16, 32)  # 32 == float32 final level


def _log2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2``'s own expansion, log(x) / log(2) in f32."""
    return torch.log(x) / torch.log(torch.tensor(2.0, device=x.device))


def block_fp_scale(x: torch.Tensor, wl: int) -> torch.Tensor:
    """Per-tensor shared exponent s (paper eq. in §2.2), an integer-valued
    f32."""
    ub = 2.0 ** (wl - 1) - 1.0
    lb = -(2.0 ** (wl - 1))
    xmax = torch.clamp(torch.max(x), min=1e-12)
    xmin = torch.clamp(torch.min(x), max=-1e-12)
    s = _log2(torch.minimum((ub + 0.5) / xmax, (lb - 0.5) / xmin))
    return torch.abs(torch.floor(s))


def quantize_block_fp(x: torch.Tensor, wl: int,
                      u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-floating-point quantize with the shared scale, in f32; ``u``
    (U[0, 1) of x's shape) rounds stochastically, None to nearest."""
    if wl >= 32:
        return x.to(torch.float32)
    s = block_fp_scale(x, wl)
    scale = fxp.pow2i(s).to(x.device)   # exact power of two (s is an integer)
    q = x.to(torch.float32) * scale + 0.5
    if u is not None:
        q = q + (u - 0.5)
    q = torch.clamp(torch.floor(q), -(2.0 ** (wl - 1)), 2.0 ** (wl - 1) - 1.0)
    return q / scale


def init_state(num_layers: int, r: int = 3, threshold: float = 1.15,
               violations_needed: int = 2, *, device=None) -> Dict[str, Any]:
    """The switch state on ``device`` (default ``cuda``; raises without it
    unless ``"cpu"``)."""
    dev = resolve_device(device)

    def scalar(v, dt=torch.int32):
        return torch.tensor(v, dtype=dt, device=dev)

    return {
        "level": scalar(0),                     # index into LADDER
        "epoch_in_level": scalar(0),
        "violations": scalar(0),
        "norm_sq_sum": torch.zeros((num_layers,), dtype=torch.float32,
                                   device=dev),
        "diversity_hist": torch.zeros((64,), dtype=torch.float32, device=dev),
        "hist_len": scalar(0),
        "threshold": scalar(threshold, torch.float32),
        "violations_needed": scalar(violations_needed),
        "r": scalar(r),
    }


def epoch_diversity(norm_sq_sum: torch.Tensor,
                    grad_sum_norm_sq: torch.Tensor) -> torch.Tensor:
    """Σ_l ‖·‖²/‖Σ·‖² / |L| from per-layer accumulators."""
    per_layer = norm_sq_sum / torch.clamp(grad_sum_norm_sq, min=1e-30)
    return torch.mean(per_layer)


def end_of_epoch(state: Dict[str, Any], diversity: torch.Tensor
                 ) -> Dict[str, Any]:
    """Inter-epoch switch decision: p = max S(j) / Δs^j > τ counts a
    violation; ``violations_needed`` violations trigger a level-up (never
    down). Returns a new state."""
    h = state["diversity_hist"].clone()
    d = torch.as_tensor(diversity, dtype=torch.float32, device=h.device)
    n = state["hist_len"]
    h[torch.clamp(n, max=63).long()] = d
    n = torch.clamp(n + 1, max=64)
    mask = torch.arange(64, device=h.device) < n
    smax = torch.max(torch.where(mask, h, -torch.inf))
    p = smax / torch.clamp(d, min=1e-30)
    violated = p > state["threshold"]
    violations = torch.where(violated, state["violations"] + 1,
                             state["violations"])
    do_switch = violations >= state["violations_needed"]
    new_level = torch.clamp(state["level"] + do_switch.to(torch.int32),
                            max=len(LADDER) - 1)
    zero = torch.zeros_like(n)
    return {
        **state,
        "level": new_level,
        "violations": torch.where(do_switch, zero, violations),
        "diversity_hist": torch.where(do_switch, torch.zeros_like(h), h),
        "hist_len": torch.where(do_switch, zero, n),
        "epoch_in_level": torch.where(do_switch, zero,
                                      state["epoch_in_level"] + 1),
    }


def current_wl(state: Dict[str, Any]) -> torch.Tensor:
    return torch.tensor(LADDER, dtype=torch.int32,
                        device=state["level"].device)[state["level"].long()]


def _keypath_text(keys) -> str:
    """``str`` of the JAX key path of a dict leaf, a tuple's text, e.g.
    "(DictKey(key='conv1'), DictKey(key='w'))" or "(DictKey(key='fc'),)"."""
    items = [f"DictKey(key={k!r})" for k in keys]
    return "(" + ", ".join(items) + ("," if len(items) == 1 else "") + ")"


def quantize_params(params, state: Dict[str, Any],
                    key: Optional[threefry.Key] = None):
    """Every >= 2-D leaf block-FP quantized at the current global level
    (f32; the rest cast to f32), stochastically with ``key`` (a threefry
    key, as ``jax.random.PRNGKey``'s) and to nearest without it.

    Leaf noise: ``uniform(fold_in(key, abs(hash(text)) % 2**31), shape)``,
    ``text`` the JAX key path's text that the reference hashes. Python
    salts ``hash`` per process (``PYTHONHASHSEED``), so neither package's
    stream is reproducible across processes; within one process the port
    draws the reference's noise bit for bit."""
    wl = LADDER[int(state["level"])]

    def visit(tree, keys):
        if isinstance(tree, dict):
            return {k: visit(v, keys + (k,)) for k, v in tree.items()}
        if tree.ndim < 2 or wl >= 32:
            return tree.to(torch.float32)
        u = None
        if key is not None:
            leaf_key = threefry.fold_in(
                key, abs(hash(_keypath_text(keys))) % (2 ** 31))
            u = threefry.uniform(leaf_key, tree.shape, device=tree.device)
        return quantize_block_fp(tree, wl, u)

    return visit(params, ())

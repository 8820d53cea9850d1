"""PushUp and the strategy / lookback / resolution adaptation (paper §3.3;
counterpart of ``repro/core/pushup.py``, function for function, in f32).

Gradient diversity over the last lb batches:
    Δs = Σ_k ‖∇f_k‖₂ / ‖Σ_k ∇f_k‖₂            (eq. 3, per layer)
If log Δs > 0 two precision-increase suggestions are combined by strategy:
    s1 = max(⌈1 / (log Δs − 1)⌉, 1)
    s2 = max(min(32·log²Δs − 1, 32) − FL_min, 1)
    s  = min/mean/max(s1, s2)                   (eq. 4)
else s = 1. Then FL = min(FL_min + s, max_wl − buff) and
WL = clip(max(WL_min, FL + 1) + buff, 2, max_wl).

Every function is elementwise over its tensor arguments, so a per-layer
(L,) state goes through in one call.
"""
from __future__ import annotations

import torch

ST_MIN, ST_MEAN, ST_MAX = 0, 1, 2


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def gradient_diversity(norm_sum, grad_sum_norm) -> torch.Tensor:
    """Δs from windowed accumulators; Δs ≥ 1 by the triangle inequality."""
    return norm_sum / torch.clamp(grad_sum_norm, min=1e-20)


def suggestions(delta_s, fl_min, max_wl: int = 32):
    log_ds = torch.log(torch.clamp(delta_s, min=1e-20))
    d = log_ds - 1.0
    s1 = torch.ceil(1.0 / torch.where(torch.abs(d) < 1e-6,
                                      torch.full_like(d, 1e-6), d))
    s1 = torch.clamp(s1, min=1.0)
    s2 = torch.clamp(torch.clamp(32.0 * log_ds * log_ds - 1.0,
                                 max=float(max_wl)) - _f32(fl_min), min=1.0)
    return s1, s2


def combine(s1, s2, strategy) -> torch.Tensor:
    """Combine suggestions under st ∈ {min, mean, max} (eq. 4)."""
    choices = torch.stack([torch.minimum(s1, s2),
                           torch.ceil(0.5 * (s1 + s2)),
                           torch.maximum(s1, s2)])
    return choices[torch.as_tensor(strategy).long()]


def push_up(wl_min, fl_min, delta_s, strategy, *, buff: int,
            max_wl: int = 32):
    """New (WL, FL) int32 for each layer/tensor."""
    log_ds = torch.log(torch.clamp(delta_s, min=1e-20))
    s1, s2 = suggestions(delta_s, fl_min, max_wl)
    s = torch.where(log_ds > 0.0, combine(s1, s2, strategy),
                    torch.ones_like(s1))
    fl = torch.clamp(_f32(fl_min) + s, max=float(max_wl - buff))
    wl = torch.maximum(_f32(wl_min), fl + 1.0) + float(buff)
    wl = torch.clamp(wl, 2.0, float(max_wl))
    fl = torch.minimum(torch.clamp(fl, min=0.0), wl - 1.0)
    return wl.to(torch.int32), fl.to(torch.int32)


def adapt_strategy(strategy, loss_avg, loss_now) -> torch.Tensor:
    """Eq. 5: escalate (min→mean→max) while loss stagnates, reset to min
    when it improves."""
    stagnating = torch.abs(loss_avg) <= torch.abs(loss_now)
    escalated = torch.clamp(strategy + 1, max=ST_MAX)
    return torch.where(stagnating, escalated,
                       torch.full_like(escalated, ST_MIN)).to(torch.int32)


def adapt_lookback(lb, delta_s, *, lb_lwr: int, lb_upr: int,
                   gamma: float) -> torch.Tensor:
    """lb_new = clip(⌈lb_upr/Δs⌉) with momentum γ (paper §3.3)."""
    finite = (delta_s > 0) & torch.isfinite(delta_s)
    lb_new = torch.where(
        finite,
        torch.clamp(torch.ceil(float(lb_upr) / torch.clamp(delta_s, min=1e-20)),
                    float(lb_lwr), float(lb_upr)),
        torch.full_like(delta_s, float(lb_upr)))
    out = torch.ceil(lb_new * gamma + (1.0 - gamma) * _f32(lb))
    return torch.clamp(out, float(lb_lwr), float(lb_upr)).to(torch.int32)


def adapt_resolution(r, lb, *, lb_lwr: int, lb_upr: int, r_lwr: int,
                     r_upr: int) -> torch.Tensor:
    """r += 1 when lookback saturates high, r -= 1 when it saturates low."""
    delta = torch.where(lb >= lb_upr, 1, torch.where(lb <= lb_lwr, -1, 0))
    return torch.clamp(r + delta, r_lwr, r_upr).to(torch.int32)

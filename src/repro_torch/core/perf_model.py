"""Analytical performance model (paper §4.1.2, eq. 6–9; the port's copy of
``repro/core/perf_model.py``, pure Python: the same floats in the same
order, so equal inputs give the reference's results).

The paper evaluates AdaPT's speedup/size/memory with an analytical model
(fixed-point hardware was unavailable to the authors too): per-layer MAdds
weighted by word length and non-zero fraction, plus AdaPT's own overhead.

    costs_train ≤ Σ_i Σ_l ops^l · (sp_i^l · WL_i^l + 32/accs)           (8)
    ops_pd ≤ 2·log2(32−8)·r · 3 · Π dims                               (6)
    ops_pu ≤ (lb+1)·Π dims + 1                                          (7)
    costs_AdaPT ≤ Σ_i Σ_l 32 · (sp·ops_pd + ops_pu)/(accs·lb)           (9)

    SU  = (bs_other · costs_other) / (bs_ours · costs_ours)
    sz  = Σ_l sp_n^l · WL_n^l ;  SZ = sz_other / sz_ours
    mem = (Σ_i Σ_l sp_i^l·WL_i^l + 32) / n ;  MEM = mem_other / mem_ours

All inputs come from training telemetry: per-step {path: (wl, sp, lb, r)}
snapshots plus static per-tensor op counts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

FULL_WL = 32.0


@dataclass
class LayerOps:
    """Static per-tensor characteristics: MAdds per forward pass and #params."""
    ops: float
    params: float


@dataclass
class StepTelemetry:
    """One training step's AdaPT snapshot: per tensor (wl, sp, lb, r)."""
    wl: Dict[str, float]
    sp: Dict[str, float]
    lb: Dict[str, float]
    r: Dict[str, float]


def train_costs(layer_ops: Dict[str, LayerOps], telemetry: Sequence[StepTelemetry],
                accs: int = 1) -> float:
    """Eq. 8: quantized sparse forward + float32 backward (amortized by accs)."""
    total = 0.0
    for t in telemetry:
        for path, lo in layer_ops.items():
            wl = t.wl.get(path, FULL_WL)
            sp = t.sp.get(path, 1.0)
            total += lo.ops * (sp * wl + FULL_WL / accs)
    return total


def adapt_overhead(layer_ops: Dict[str, LayerOps],
                   telemetry: Sequence[StepTelemetry], accs: int = 1) -> float:
    """Eq. 6, 7, 9."""
    total = 0.0
    for t in telemetry:
        for path, lo in layer_ops.items():
            r = t.r.get(path, 50.0)
            lb = max(t.lb.get(path, 25.0), 1.0)
            sp = t.sp.get(path, 1.0)
            dims = lo.params
            ops_pd = 2.0 * math.log2(FULL_WL - 8.0) * r * 3.0 * dims
            ops_pu = (lb + 1.0) * dims + 1.0
            total += FULL_WL * (sp * ops_pd + ops_pu) / (accs * lb)
    return total


def float32_costs(layer_ops: Dict[str, LayerOps], n_steps: int,
                  accs: int = 1) -> float:
    """Same model, dense float32 forward+backward baseline."""
    per_step = sum(lo.ops * (FULL_WL + FULL_WL / accs) for lo in layer_ops.values())
    return per_step * n_steps


def inference_costs(layer_ops: Dict[str, LayerOps], final: StepTelemetry) -> float:
    """Forward only, quantized + sparse."""
    return sum(lo.ops * final.sp.get(p, 1.0) * final.wl.get(p, FULL_WL)
               for p, lo in layer_ops.items())


def float32_inference_costs(layer_ops: Dict[str, LayerOps]) -> float:
    return sum(lo.ops * FULL_WL for lo in layer_ops.values())


def speedup(costs_other: float, costs_ours: float, bs_other: float = 1.0,
            bs_ours: float = 1.0) -> float:
    return (bs_other * costs_other) / max(bs_ours * costs_ours, 1e-30)


def model_size(layer_ops: Dict[str, LayerOps], final: StepTelemetry) -> float:
    """sz = Σ_l sp^l · WL^l (relative units; dims cancel in the ratio)."""
    return sum(final.sp.get(p, 1.0) * final.wl.get(p, FULL_WL) * lo.params
               for p, lo in layer_ops.items())


def float32_model_size(layer_ops: Dict[str, LayerOps]) -> float:
    return sum(FULL_WL * lo.params for lo in layer_ops.values())


def avg_memory(layer_ops: Dict[str, LayerOps],
               telemetry: Sequence[StepTelemetry]) -> float:
    """mem: quantized copy + float32 master, averaged over training (the +32
    term is the master copy the paper charges AdaPT for)."""
    if not telemetry:
        return 0.0
    tot = 0.0
    for t in telemetry:
        tot += sum((t.sp.get(p, 1.0) * t.wl.get(p, FULL_WL) + FULL_WL) * lo.params
                   for p, lo in layer_ops.items())
    return tot / len(telemetry)


def float32_avg_memory(layer_ops: Dict[str, LayerOps]) -> float:
    return sum(FULL_WL * lo.params for lo in layer_ops.values())


def summarize(layer_ops: Dict[str, LayerOps], telemetry: List[StepTelemetry],
              accs: int = 1, bs_ours: float = 1.0, bs_other: float = 1.0) -> Dict[str, float]:
    """All paper metrics vs the float32 baseline in one dict."""
    n = len(telemetry)
    ours = train_costs(layer_ops, telemetry, accs) + adapt_overhead(
        layer_ops, telemetry, accs)
    base = float32_costs(layer_ops, n, accs)
    final = telemetry[-1]
    return {
        "SU_train": speedup(base, ours, bs_other, bs_ours),
        "SU_infer": speedup(float32_inference_costs(layer_ops),
                            inference_costs(layer_ops, final)),
        "SZ": model_size(layer_ops, final) / max(float32_model_size(layer_ops), 1e-30),
        # paper convention (tab. 3/4 + fig. 7): MEM = mem_ours / mem_f32 > 1
        # (the f32 master copy makes AdaPT *heavier* during training; the
        # advantage is speed + the quantized final model)
        "MEM": avg_memory(layer_ops, telemetry) / max(float32_avg_memory(layer_ops), 1e-30),
        "avg_wl": sum(final.wl.values()) / max(len(final.wl), 1),
        "avg_sp": sum(final.sp.values()) / max(len(final.sp), 1),
    }

"""PushDown (paper alg. 3; counterpart of ``repro/core/pushdown.py``): the
smallest ⟨WL,FL⟩ whose round-to-nearest encoding loses no information.

The master weights W and their re-quantized Ŵ are binned into EDFs at the
live resolution r^l, and the discrete KL divergence KL(Ŵ‖W) reads as the
bits the encoding loses. The whole WL ladder is evaluated at once and the
smallest rung with KL < eps_kl is taken, on a strided subsample of at most
``quant.edf_sample`` elements per tensor, as in the reference.

The reference runs one tensor (or one layer, under ``jax.vmap``) per call;
here the layer dimension is written out: every function takes a batch
(L, n) of subsampled layers, L = 1 for an unstacked tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.kernels import ops as kops

# WL candidate ladder, ascending. Covers every width the paper can reach.
WL_LADDER = tuple(range(2, 17)) + (20, 24, 32)


def subsample(flat: torch.Tensor, n: int) -> torch.Tensor:
    """Deterministic strided subsample of the last dim to at most n
    elements (a view)."""
    size = flat.shape[-1]
    if size <= n:
        return flat
    stride = size // n
    return flat[..., : n * stride: stride]


def _edf_span(x: torch.Tensor):
    """Each layer's (lo, span = max(hi − lo, 1e-12)), (L, 1) f32."""
    lo = x.amin(dim=1, keepdim=True)
    hi = x.amax(dim=1, keepdim=True)
    return lo, torch.clamp(hi - lo, min=1e-12)


def _histogram(x: torch.Tensor, lo: torch.Tensor, span: torch.Tensor,
               r: torch.Tensor, r_upr: int) -> torch.Tensor:
    """Masked histograms (L, r_upr) of x (L, n): r[l] live bins of layer
    l's [lo, lo + span]. A NaN bin (the span overflowed to inf) becomes bin
    0, as XLA's float→int conversion makes it in the reference."""
    rf = r.to(torch.float32).reshape(-1, 1)
    idx = torch.floor((x - lo) / span * rf)
    idx = torch.minimum(torch.maximum(idx, torch.zeros_like(idx)), rf - 1)
    idx = torch.nan_to_num(idx, nan=0.0).to(torch.int64)
    counts = torch.zeros((x.shape[0], r_upr), dtype=torch.float32,
                         device=x.device)
    return counts.scatter_add_(1, idx, torch.ones_like(x))


def kl_bits(p_counts: torch.Tensor, q_counts: torch.Tensor) -> torch.Tensor:
    """KL(P‖Q) in bits over the last dim, with add-one smoothing on the
    support union. log2 is log(x) / log(2), as ``jnp.log2`` computes it."""
    p = p_counts + 1e-6
    q = q_counts + 1e-6
    p = p / torch.sum(p, dim=-1, keepdim=True)
    q = q / torch.sum(q, dim=-1, keepdim=True)
    ln2 = torch.log(torch.tensor(2.0, device=p.device))
    return torch.sum(p * (torch.log(p) / ln2 - torch.log(q) / ln2), dim=-1)


def kl_for_wl(w: torch.Tensor, wl: int, r: torch.Tensor, r_upr: int):
    """KL(quantized ‖ original) of each layer of w (L, n) for one candidate
    word length, FL range-derived (the largest FL that still represents
    max|w|). Returns (kl_bits (L,), fl (L,))."""
    amax = torch.amax(torch.abs(w), dim=1)
    fl = fxp.fl_for_wl(amax, wl)
    q = fxp.quantize(w, wl, fl.reshape(-1, 1), u=None)  # deterministic probe
    lo, span = _edf_span(w)
    hq = _histogram(q, lo, span, r, r_upr)
    hw = _histogram(w, lo, span, r, r_upr)
    return kl_bits(hq, hw), fl


def _select_wl(kls: torch.Tensor, fls: torch.Tensor, *, eps_kl: float,
               max_wl: int):
    """Smallest feasible rung per layer given its KLs and FLs (L, T)."""
    ladder = torch.tensor(WL_LADDER, dtype=torch.int32, device=kls.device)
    ok = (kls < eps_kl) & (ladder <= max_wl)
    first = torch.argmax(ok.to(torch.int32), dim=1)     # 0 if none is ok
    widest = torch.full_like(first, len(WL_LADDER) - 1)
    idx = torch.where(ok.any(dim=1), first, widest)
    wl_min = torch.clamp(ladder[idx], max=max_wl)
    fl_min = torch.gather(fls, 1, idx.reshape(-1, 1)).reshape(-1)
    fl_min = torch.minimum(torch.clamp(fl_min, min=0), wl_min - 1)
    return wl_min.to(torch.int32), fl_min.to(torch.int32)


def push_down(w: torch.Tensor, r: torch.Tensor, *, r_upr: int, eps_kl: float,
              max_wl: int = 32, use_pallas: bool = False):
    """Smallest ⟨WL_min, FL_min⟩ with KL < eps_kl over the WL ladder, per
    layer. w: (L, n) f32 subsampled layers; r: (L,) int32 live resolution.
    Returns int32 (wl_min (L,), fl_min (L,)).

    ``use_pallas`` takes all 18 probes from one EDF-ladder pass
    (``kops.edf_ladder_hists``: the CUDA kernel on the card), then the
    KL/argmin epilogue; otherwise 18 quantize + histogram probes. Both
    choose the same ⟨WL,FL⟩ (the same bin edges, the same RN quantizer)."""
    if use_pallas:
        amax = torch.amax(torch.abs(w), dim=1, keepdim=True)
        ladder = torch.tensor(WL_LADDER, dtype=torch.int32, device=w.device)
        fls = fxp.fl_for_wl(amax, ladder.reshape(1, -1))
        counts = kops.edf_ladder_hists(w, fls, r, wl_ladder=WL_LADDER,
                                       r_upr=r_upr, use_pallas=True)
        kls = kl_bits(counts[:, 1:], counts[:, :1])
        return _select_wl(kls, fls, eps_kl=eps_kl, max_wl=max_wl)
    probes = [kl_for_wl(w, wl, r, r_upr) for wl in WL_LADDER]
    kls = torch.stack([k for k, _ in probes], dim=1)
    fls = torch.stack([f for _, f in probes], dim=1)
    return _select_wl(kls, fls, eps_kl=eps_kl, max_wl=max_wl)

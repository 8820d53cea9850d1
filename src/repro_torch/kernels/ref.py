"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

Each ``ref_*`` function is the semantic ground truth its CUDA kernel is held
against: the CPU tests compare these with the JAX reference, and
``chip_smoke.py`` compares the kernels with these on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ref_fxp_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor | None = None, *,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x @ (wq * scale) with f32 accumulation, the scale applied in f32.

    x: (M, K) float; wq: (K, N) int8 fixed-point words; scale: () or (N,).
    ``out_dtype`` defaults to x's dtype."""
    acc = torch.matmul(x.to(torch.float32), wq.to(torch.float32))
    out = acc * scale.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(out_dtype or x.dtype)


def _attention_logits(q, k, *, causal, window, softcap, scale):
    """(B, H, Sq, Skv) f32 logits with the mask applied (-1e30) and the
    (Sq, Skv) mask itself. Queries are end-aligned: q_offset = Skv − Sq."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
    sc = scale if scale is not None else (1.0 / D ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * sc
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return torch.where(mask[None, None], logits, NEG_INF), mask


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: float | None = None) -> torch.Tensor:
    """Multi-head attention oracle, as ``repro.kernels.ref.ref_attention``:
    a row that no key reaches softmaxes into a uniform average.

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D). GQA via head-group broadcast."""
    rep = q.shape[2] // k.shape[2]
    logits, _ = _attention_logits(q, k, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    p = torch.softmax(logits, dim=-1)
    vr = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.to(torch.float32))
    return out.to(q.dtype)


def ref_attention_lse(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, scale: float | None = None
                      ) -> torch.Tensor:
    """Per-row logsumexp (B, H, Sq) f32 of the masked (softcapped) logits."""
    logits, _ = _attention_logits(q, k, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    return torch.logsumexp(logits, dim=-1)


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float | None = None,
                        return_lse: bool = False):
    """Plain version of the flash kernel: :func:`ref_attention` computed in
    f32, except that a row that no key reaches (Sq > Skv under causal
    end-alignment, or a window past every key) is exactly 0 with
    lse = -1e30, the kernel's convention (``flash_attention.py:126-139``
    of the reference). Output in q's dtype; lse (B, H, Sq) f32."""
    rep = q.shape[2] // k.shape[2]
    logits, mask = _attention_logits(q, k, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    dead = ~mask.any(dim=-1)                                   # (Sq,)
    p = torch.softmax(logits, dim=-1)
    vr = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.to(torch.float32))
    out = torch.where(dead[None, :, None, None], 0.0, out).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(dead[None, None, :], NEG_INF,
                      torch.logsumexp(logits, dim=-1))
    return out, lse

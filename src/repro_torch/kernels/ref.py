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


# ---------------------------------------------------------------------------
# Backward oracles (counterparts of the reference's ``ref_matmul_dx``,
# ``ref_matmul_dw`` and ``ref_attention_grads``), and the plain version of
# the flash backward kernels.


def ref_matmul_dx(dy: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor
                  ) -> torch.Tensor:
    """dx = dy @ (wq·scale)ᵀ, f32 accumulation, dy's dtype out."""
    acc = torch.matmul(dy.to(torch.float32), wq.to(torch.float32).T)
    return (acc * scale.to(torch.float32)).to(dy.dtype)


def ref_matmul_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw = xᵀ @ dy in f32."""
    return torch.matmul(x.to(torch.float32).T, dy.to(torch.float32))


def ref_attention_grads(q, k, v, dy, **kwargs):
    """(dq, dk, dv) by autograd of :func:`ref_attention`."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = ref_attention(*leaves, **kwargs)
        return torch.autograd.grad(out, leaves, dy)


def _flash_bwd_terms(q, k, v, do, lse, delta, causal, window, softcap,
                     scale):
    """What both backward kernels recompute from the stashed lse, in f32:
    p = exp(t − lse) under the mask (exactly 0 where the mask admits no
    key) and dt = p∘(dp − D) through the softcap chain, (B, H, Sq, Skv);
    with q, do, the kv heads repeated to H, and the softmax scale."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    rep = H // Hkv
    sc = scale if scale is not None else 1.0 / D ** 0.5
    f32 = torch.float32
    qf, dof = q.to(f32), do.to(f32)
    kf, vf = k.to(f32), v.to(f32)
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sc
    t = softcap * torch.tanh(s / softcap) if softcap > 0.0 else s
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    # the mask goes in before the exp: lse = -1e30 on a row that reaches
    # no key, where exp(t - lse) would overflow
    p = torch.exp(torch.where(mask[None, None], t - lse[..., None], NEG_INF))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    g = p * (dp - delta[..., None])
    if softcap > 0.0:
        g = g * (1.0 - torch.square(t / softcap))
    return p, g, qf, kf, dof, sc


def ref_flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: int = 0, softcap: float = 0.0,
                           scale: float | None = None) -> torch.Tensor:
    """dQ as the dQ kernel computes it from (lse, D = Σ do∘o): q/do
    (B, Sq, H, D), k/v (B, Skv, Hkv, D), lse/delta (B, H, Sq) f32. dq in
    q's dtype."""
    _, g, _, kf, _, sc = _flash_bwd_terms(q, k, v, do, lse, delta, causal,
                                          window, softcap, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", g, kf) * sc).to(q.dtype)


def ref_flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0,
                            scale: float | None = None):
    """dK, dV as the dK/dV kernel computes them, the rep query heads of
    each GQA group summed; inputs as :func:`ref_flash_attention_dq`.
    dk/dv in k's and v's dtype."""
    B, Skv, Hkv, D = k.shape
    rep = q.shape[2] // Hkv
    p, g, qf, _, dof, sc = _flash_bwd_terms(q, k, v, do, lse, delta,
                                            causal, window, softcap, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", g, qf) * sc
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Skv, Hkv, rep, D).sum(3)
    dv = dv.reshape(B, Skv, Hkv, rep, D).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def ref_flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0,
                            scale: float | None = None):
    """dQ/dK/dV of :func:`ref_flash_attention` from its stashed (o, lse), as
    the reference's ``flash_attention_bwd`` computes them: D = Σ do∘o in
    f32, then :func:`ref_flash_attention_dq` and
    :func:`ref_flash_attention_dkv`, each recomputing p under the mask (so
    a row that reaches no key gives dq = 0 and nothing to dK/dV), as the
    two kernels do. Returns (dq, dk, dv) in the inputs' dtypes."""
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
    delta = delta.permute(0, 2, 1)                             # (B, H, Sq)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    dq = ref_flash_attention_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *ref_flash_attention_dkv(q, k, v, do, lse, delta, **kw))

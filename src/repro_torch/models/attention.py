"""Grouped-query attention block with KV caching (counterpart of
``repro/models/attention.py``; ``cross_attend``/``project_memory`` come with
the VLM slice).

  * ``attend_full``   — prefill / full-sequence forward
  * ``attend_decode`` — one-token decode against a (possibly rolling) cache
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common


def init_layer(generator: torch.Generator, cfg: ModelConfig, num_layers: int,
               device=None) -> Dict[str, torch.Tensor]:
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    L = (num_layers,) if num_layers > 0 else ()

    def mk(shape):
        return common.init_dense(generator, L + shape, device=device)

    p = {
        "wq": mk((d, h * dh)),
        "wk": mk((d, hkv * dh)),
        "wv": mk((d, hkv * dh)),
        "wo": mk((h * dh, d)),
        "pre_norm": torch.zeros(L + (d,), dtype=torch.float32, device=device),
    }
    if cfg.use_post_norm:
        p["post_norm"] = torch.zeros(L + (d,), dtype=torch.float32, device=device)
    if cfg.use_qk_norm:
        p["q_norm"] = torch.zeros(L + (dh,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.zeros(L + (dh,), dtype=torch.float32, device=device)
    return p


def _project_qkv(p, x, cfg: ModelConfig, positions: Optional[torch.Tensor],
                 rope_on: bool = True, use_pallas: bool = False):
    B, S, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = common.dense(x, p["wq"], use_pallas=use_pallas).reshape(B, S, h, dh)
    k = common.dense(x, p["wk"], use_pallas=use_pallas).reshape(B, S, hkv, dh)
    v = common.dense(x, p["wv"], use_pallas=use_pallas).reshape(B, S, hkv, dh)
    if cfg.use_qk_norm:
        q = common.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = common.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope_on and positions is not None:
        q = common.rope(q, positions, cfg.rope_theta)
        k = common.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attend_full(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, window: int = 0,
                causal: bool = True, use_pallas: bool = False
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over the whole sequence. Returns (out, (k, v)).
    ``window`` is a static int here (the plan's per-slot window), so under
    ``use_pallas`` every layer takes the flash kernel."""
    h = common.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg, positions, use_pallas=use_pallas)
    if use_pallas:
        out = ops.attention(q, k, v, causal=causal, window=window,
                            softcap=cfg.attn_logit_softcap, use_pallas=True)
    else:
        out = _masked_attention(q, k, v, positions, positions, window,
                                cfg.attn_logit_softcap, causal)
    B, S = x.shape[:2]
    out = common.dense(out.reshape(B, S, -1), p["wo"], use_pallas=use_pallas)
    if cfg.use_post_norm:
        out = common.rms_norm(out, p["post_norm"], cfg.norm_eps)
    return x + out, (k, v)


def _masked_attention(q, k, v, qpos, kpos, window, cap, causal):
    """Attention with explicit position masks (plain; no kernel on the TPU
    either). GQA repeats K/V to the full H query heads.

    qpos: (B, Sq), kpos: (B, Skv) absolute positions; kpos = -1 marks empty
    cache slots. ``window`` 0 disables the window."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)          # (B, Skv, H, D)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * (1.0 / D ** 0.5)
    logits = common.softcap(logits, cap)
    qp = qpos[:, :, None]                            # (B, Sq, 1)
    kp = kpos[:, None, :]                            # (B, 1, Skv)
    mask = kp >= 0                                   # (B, Sq, Skv) by broadcast
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    logits = torch.where(mask[:, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    # The AV product runs in the input dtype on the card, as the reference
    # does on the TPU (bf16 probabilities, f32 accumulation), and in f32 on
    # the CPU, as the reference does there (XLA CPU has no batched bf16 dot).
    av_dt = torch.float32 if q.device.type == "cpu" else v.dtype
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(av_dt), v.to(av_dt))
    return out.to(q.dtype)


def attend_decode(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                  cache_k: torch.Tensor, cache_v: torch.Tensor,
                  slot_pos: torch.Tensor, t: int, *, window: int = 0,
                  use_pallas: bool = False
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode. x: (B, 1, D); cache: (B, C, Hkv, Dh); slot_pos: (C,)
    absolute positions per cache slot (-1 = empty); t: current position.

    The new k/v are written into the cache IN PLACE (the reference returns
    updated copies); the returned caches are the same tensors."""
    h = common.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    B = x.shape[0]
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, h, cfg, pos, use_pallas=use_pallas)
    C = cache_k.shape[1]
    slot = t % C
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    kpos = slot_pos[None, :].expand(B, C)
    out = _masked_attention(q, cache_k, cache_v, pos, kpos, window,
                            cfg.attn_logit_softcap, causal=True)
    out = common.dense(out.reshape(B, 1, -1), p["wo"], use_pallas=use_pallas)
    if cfg.use_post_norm:
        out = common.rms_norm(out, p["post_norm"], cfg.norm_eps)
    return x + out, (cache_k, cache_v)

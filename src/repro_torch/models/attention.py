"""Grouped-query attention block with KV caching and cross-attention
(counterpart of ``repro/models/attention.py``).

  * ``attend_full``    — prefill / full-sequence forward (causal, or not
                         for an encoder)
  * ``attend_decode``  — one-token decode against a (possibly rolling) cache
  * ``project_memory`` — an encoder memory's k/v, projected once (VLM)
  * ``cross_attend``   — queries over that memory (VLM cross slots)

On a model axis of more than one rank (``sharding.model_group``) the
training forward is tensor-parallel (``_project_qkv_tp``): q, k and v are
column-parallel on the rank's blocks of wq, wk and wv, the heads that
divide the axis are attended to locally, and wo is row-parallel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import sharding as shd
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
    q, k = _qk_norm_rope(q, k, p.get("q_norm"), p.get("k_norm"), cfg,
                         positions if rope_on else None)
    return q, k, v


def _qk_norm_rope(q, k, q_norm, k_norm, cfg: ModelConfig,
                  positions: Optional[torch.Tensor]):
    """q and k (B, S, heads, D) after the qk-norm, where the config has
    one, and rope at ``positions``, where given."""
    if cfg.use_qk_norm:
        q = common.rms_norm(q, q_norm, cfg.norm_eps)
        k = common.rms_norm(k, k_norm, cfg.norm_eps)
    if positions is not None:
        q = common.rope(q, positions, cfg.rope_theta)
        k = common.rope(k, positions, cfg.rope_theta)
    return q, k


def _project_qkv_tp(p, x, cfg: ModelConfig, positions, group):
    """q, k, v of the rank on a model axis of ``group.size`` ranks, and
    whether its heads are local. q, k and v are column-parallel products
    (one all-reduce of x's f32 gradient for all three). When the query
    heads divide the axis the rank takes its heads of q and, for each of
    them, its kv head: its own block of k and v when the kv heads divide
    too; else k and v whole (gathered from their column blocks under
    ``mesh.kv_proj=shard``, or products of whole wk, wv under
    ``replicate``), their gradients summed over the ranks (``copy``), and
    the kv head of each of the rank's query heads taken. When the query
    heads do not divide (``mesh.seq_shard_attn=off``), q, k and v are
    gathered whole and attention is replicated: returns (q, k, v, False)
    with every head."""
    B, S, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    m, r = group.size, group.index
    heads_local = h % m == 0
    # wq is always split (launch/mesh.check_ported); wk and wv are whole
    # under mesh.kv_proj=replicate when the kv heads do not divide
    kv_split = p["wk"].shape[-1] != hkv * dh
    col = [p["wq"]] + ([p["wk"], p["wv"]] if kv_split else [])
    outs = common.column_dense(x, col, group)
    q = outs[0]
    if kv_split:
        k, v = outs[1], outs[2]
    else:
        k = common.dense(x, p["wk"])
        v = common.dense(x, p["wv"])
    kv_local = heads_local and hkv % m == 0 and kv_split
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    if heads_local:
        q = q.reshape(B, S, h // m, dh)
        if q_norm is not None:          # a norm's gradient over local heads
            q_norm = group.copy(q_norm)
    else:
        q = group.gather(q, -1).reshape(B, S, h, dh)
    if kv_local:
        k = k.reshape(B, S, hkv // m, dh)
        v = v.reshape(B, S, hkv // m, dh)
        if k_norm is not None:
            k_norm = group.copy(k_norm)
    else:
        if kv_split:
            k, v = group.gather(k, -1), group.gather(v, -1)
        k = k.reshape(B, S, hkv, dh)
        v = v.reshape(B, S, hkv, dh)
    q, k = _qk_norm_rope(q, k, q_norm, k_norm, cfg, positions)
    if heads_local and not kv_local:
        # each local query head's kv head; the gradient of the whole k, v
        # is the sum of every rank's heads' parts
        rep = h // hkv
        idx = torch.arange(r * (h // m), (r + 1) * (h // m),
                           device=x.device) // rep
        k = group.copy(k).index_select(2, idx)
        v = group.copy(v).index_select(2, idx)
    return q, k, v, heads_local


def _attention(q, k, v, positions, window, cfg: ModelConfig, causal: bool,
               use_pallas: bool):
    if use_pallas:
        return ops.attention(q, k, v, causal=causal, window=window,
                             softcap=cfg.attn_logit_softcap, use_pallas=True)
    return _masked_attention(q, k, v, positions, positions, window,
                             cfg.attn_logit_softcap, causal)


def _attend_full_tp(p, x, cfg: ModelConfig, positions, window: int,
                    causal: bool, use_pallas: bool, group):
    """``attend_full``'s tensor-parallel body: returns (out, (k, v)), out
    after the row-parallel wo. Replicated attention (query heads that do
    not divide the axis) gives each rank every head; the gradient of its
    output is summed over the ranks (``copy``) before the rank takes its
    rows of wo's input."""
    h = common.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    q, k, v, local = _project_qkv_tp(p, h, cfg, positions, group)
    out = _attention(q, k, v, positions, window, cfg, causal, use_pallas)
    B, S = x.shape[:2]
    out = out.reshape(B, S, -1)
    if not local:
        out = _own_columns(group.copy(out), group)
    out = common.row_dense(out, p["wo"], group,
                           common.tp_reduce_dtype(out, group))
    return out, (k, v)


def _own_columns(t: torch.Tensor, group) -> torch.Tensor:
    """The rank's columns of ``t`` along its last dim (a view that keeps
    the gradient flowing to the whole)."""
    n = t.shape[-1] // group.size
    return t[..., group.index * n:(group.index + 1) * n]


def attend_full(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, window: int = 0,
                causal: bool = True, use_pallas: bool = False
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over the whole sequence. Returns (out, (k, v)).
    ``window`` is a static int here (the plan's per-slot window), so under
    ``use_pallas`` every layer takes the flash kernel. On a model axis of
    more than one rank, tensor-parallel (``_attend_full_tp``)."""
    group = shd.model_group()
    if group is not None:
        out, kv = _attend_full_tp(p, x, cfg, positions, window, causal,
                                  use_pallas, group)
    else:
        h = common.rms_norm(x, p["pre_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, h, cfg, positions, use_pallas=use_pallas)
        out = _attention(q, k, v, positions, window, cfg, causal, use_pallas)
        B, S = x.shape[:2]
        out = common.dense(out.reshape(B, S, -1), p["wo"],
                           use_pallas=use_pallas)
        kv = (k, v)
    if cfg.use_post_norm:
        out = common.rms_norm(out, p["post_norm"], cfg.norm_eps)
    return x + out, kv


def av_dtype(v: torch.Tensor) -> torch.dtype:
    """The dtype of the plain path's AV product: v's own on the card, as
    the reference computes it on the TPU (bf16 probabilities, f32
    accumulation), and f32 on the CPU, as the reference does there (XLA CPU
    has no batched bf16 dot; the reference's ``_CPU_EXEC``)."""
    return torch.float32 if v.device.type == "cpu" else v.dtype


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
    av_dt = av_dtype(v)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(av_dt), v.to(av_dt))
    return out.to(q.dtype)


def attend_decode(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                  cache_k: torch.Tensor, cache_v: torch.Tensor,
                  slot_pos: torch.Tensor, t, *, window: int = 0,
                  use_pallas: bool = False
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode. x: (B, 1, D); cache: (B, C, Hkv, Dh).

    ``t`` is the current position: a Python int, every row at t, with
    slot_pos (C,) the absolute position of each cache slot (-1 = empty); or
    a (B,) int32 tensor on x's device, row b at t[b] (the continuous
    batcher's slot pool, the reference's single-row decode vmapped over the
    slots), with slot_pos (B, C). Each row then takes rope at its own
    position and writes its new k/v at t[b] % C of its own cache row; the
    tensor path reads nothing back to the host, so it can be captured in a
    CUDA graph.

    The new k/v are written into the cache IN PLACE (the reference returns
    updated copies); the returned caches are the same tensors."""
    h = common.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    B = x.shape[0]
    per_row = isinstance(t, torch.Tensor)
    pos = (t.to(torch.int32)[:, None] if per_row
           else torch.full((B, 1), t, dtype=torch.int32, device=x.device))
    q, k, v = _project_qkv(p, h, cfg, pos, use_pallas=use_pallas)
    C = cache_k.shape[1]
    if per_row:
        rows = torch.arange(B, device=x.device)
        slot = torch.remainder(pos[:, 0], C).to(torch.long)
        cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
        kpos = slot_pos
    else:
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


def cross_attend(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                 memory_k: torch.Tensor, memory_v: torch.Tensor,
                 use_pallas: bool = False) -> torch.Tensor:
    """Cross-attention over a precomputed encoder memory (the VLM's cross
    slots; ``attention.py:190-207``). memory_k/v: (B, M, Hkv, Dh), from
    ``project_memory``: f32 in the forward (the f32 memory through the
    dense layer), the cache's dtype at decode. The query takes no rope;
    every query sees every memory slot (no causal mask, no window), in the
    plain attention, as in the reference under ``use_pallas`` too: its AV
    product in v's dtype on the card (``av_dtype``)."""
    h = common.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    B, S, _ = x.shape
    hq, dh = cfg.num_heads, cfg.resolved_head_dim
    q = common.dense(h, p["wq"], use_pallas=use_pallas).reshape(B, S, hq, dh)
    M = memory_k.shape[1]
    kpos = torch.arange(M, dtype=torch.int32, device=x.device)[None].expand(B, M)
    qpos = torch.full((B, S), M, dtype=torch.int32, device=x.device)
    out = _masked_attention(q, memory_k, memory_v, qpos, kpos, 0,
                            cfg.attn_logit_softcap, causal=False)
    out = common.dense(out.reshape(B, S, -1), p["wo"], use_pallas=use_pallas)
    if cfg.use_post_norm:
        out = common.rms_norm(out, p["post_norm"], cfg.norm_eps)
    return x + out


def project_memory(p: Dict[str, torch.Tensor], memory: torch.Tensor,
                   cfg: ModelConfig, use_pallas: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder memory (B, M, D) projected to (k, v), each (B, M, Hkv,
    Dh) in the memory's dtype (f32 from the batch: under ``use_pallas`` on
    packed words the fxp kernel's f32 branch; the memory needs no gradient,
    so training runs ``matmul_dw`` for it and no ``matmul_dx``)."""
    if memory is None:
        raise ValueError("a cross-attention slot needs the encoder memory: "
                         "pass memory= (B, num_image_tokens, d_model)")
    B, M, _ = memory.shape
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    k = common.dense(memory, p["wk"], use_pallas=use_pallas
                     ).reshape(B, M, hkv, dh)
    v = common.dense(memory, p["wv"], use_pallas=use_pallas
                     ).reshape(B, M, hkv, dh)
    return k, v

"""Dense LM stack (counterpart of ``repro/models/transformer.py``, dense
attention+MLP family).

The layer plan is periodic: parameters are stacked as (num_periods, ...)
per slot of the period, and where the reference ``lax.scan``s over periods
the port loops over them in Python, slicing the stacked leaves per layer
(views, no copies).

Params layout (stacked leaves carry the leading num_periods dim):

    {"embed": (V, D),
     "blocks": {"s{i}_attn": {...}, "s{i}_mlp": {...}},
     "final_norm": (D,),
     "head": (D, V)?}                  # absent when tie_embeddings

Slots of kind mamba/cross, shared attention weights and MoE FFNs raise
NotImplementedError: they come with later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import fixed_point as fxp
from repro_torch.device import resolve_device
from repro_torch.models import attention, common, mlp


# ---------------------------------------------------------------------------
# Plan


@dataclass(frozen=True)
class Slot:
    kind: str          # attn | mamba | cross
    window: int        # 0 = full; >0 = sliding window (static)
    ffn: str           # mlp | moe | none
    shared: bool = False  # weights shared across periods (zamba2 attn blocks)

    @property
    def name(self) -> str:
        return self.kind


def _layer_descriptors(cfg: ModelConfig) -> list:
    """Fully expanded per-layer slot list (length num_layers)."""
    ffn_default = ("moe" if cfg.num_experts else
                   ("mlp" if cfg.d_ff else "none"))
    out = []
    attn_idx = 0
    for i in range(cfg.num_layers):
        if cfg.cross_attn_every and (i + 1) % cfg.cross_attn_every == 0:
            kind = "cross"
        else:
            kind = cfg.layer_pattern[i % len(cfg.layer_pattern)]
        window = 0
        ffn = ffn_default
        shared = False
        if kind == "attn":
            pat = cfg.attn_pattern[attn_idx % len(cfg.attn_pattern)]
            window = cfg.window_size if pat == "local" else 0
            attn_idx += 1
            shared = cfg.shared_attn_weights
        elif kind == "mamba":
            ffn = "none"
        out.append(Slot(kind, window, ffn, shared))
    return out


def build_plan(cfg: ModelConfig) -> Tuple[Tuple[Slot, ...], int]:
    """Smallest periodic plan: (slots_per_period, num_periods)."""
    layers = _layer_descriptors(cfg)
    L = len(layers)
    for p in range(1, L + 1):
        if L % p:
            continue
        if all(layers[i] == layers[i % p] for i in range(L)):
            return tuple(layers[:p]), L // p
    return tuple(layers), 1


def slot_key(i: int, slot: Slot) -> str:
    return f"s{i}_{slot.kind}"


def ffn_key(i: int, slot: Slot) -> str:
    return f"s{i}_{slot.ffn}"


def _ported_plan(cfg: ModelConfig):
    plan, np_ = build_plan(cfg)
    for slot in plan:
        if slot.kind != "attn" or slot.shared or slot.ffn == "moe":
            raise NotImplementedError(
                f"slot {slot} (kind={slot.kind}, ffn={slot.ffn}, "
                f"shared={slot.shared}) is not ported yet: mamba, cross, "
                "shared-attention and MoE slots come with later slices "
                "(ROADMAP.md, Queue 1)")
    return plan, np_


# ---------------------------------------------------------------------------
# Init


def init_params(key: int, cfg: ModelConfig, *, device=None) -> Dict[str, Any]:
    """Fresh TNVS weights from the integer seed ``key``, drawn by a
    ``torch.Generator`` on ``device`` (default ``cuda``; raises on a host
    without CUDA unless ``device="cpu"``). The same distribution as the
    reference, not the same bits."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(key))
    plan, np_ = _ported_plan(cfg)
    if cfg.is_encoder:
        raise NotImplementedError("encoder (audio) models come with a later "
                                  "slice (ROADMAP.md, Queue 1)")
    params: Dict[str, Any] = {"blocks": {}}
    params["embed"] = common.init_embed(gen, cfg.vocab_size, cfg.d_model,
                                        device=dev)
    for i, slot in enumerate(plan):
        params["blocks"][slot_key(i, slot)] = attention.init_layer(
            gen, cfg, np_, device=dev)
        if slot.ffn == "mlp":
            params["blocks"][ffn_key(i, slot)] = mlp.init_layer(
                gen, cfg, np_, device=dev)
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                       device=dev)
    if not cfg.tie_embeddings:
        params["head"] = common.init_dense(
            gen, (cfg.d_model, cfg.vocab_size or 1), device=dev)
    return params


# ---------------------------------------------------------------------------
# Helpers


def _layer(tree, l: int):
    """Layer ``l`` of a tree of stacked leaves (packed dicts slice each of
    their three leaves)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def _top(params, use_pallas: bool):
    """Non-block params, dequantized at entry except dense leaves under
    ``use_pallas`` and the embedding, whose rows ``embed_lookup`` gathers
    before dequantizing."""
    rest = {k: v for k, v in params.items() if k not in ("blocks", "embed")}
    top = fxp.unpack_tree(rest, keep_dense=use_pallas)
    top["embed"] = params["embed"]
    return top


def _head_logits(top, x, cfg: ModelConfig, use_pallas: bool) -> torch.Tensor:
    head = top.get("head")
    if head is None:
        embed = fxp.unpack_tree({"embed": top["embed"]})["embed"]
        logits = common.dense(x, embed.T)
    else:
        logits = common.dense(x, head, use_pallas=use_pallas)
    return common.softcap(logits.to(torch.float32), cfg.final_logit_softcap)


def _embed(top, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return common.embed_lookup(top["embed"], tokens,
                               scale_by_dim=cfg.scale_embed).to(torch.bfloat16)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


# ---------------------------------------------------------------------------
# Forward (full sequence)


def forward(params: Dict[str, Any], cfg: ModelConfig, *,
            tokens: torch.Tensor, use_pallas: bool = False) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, V) f32."""
    plan, np_ = _ported_plan(cfg)
    top = _top(params, use_pallas)
    x = _embed(top, tokens, cfg)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    causal = not cfg.is_encoder
    for l in range(np_):
        pslice = fxp.unpack_tree(_layer(params["blocks"], l),
                                 keep_dense=use_pallas)
        for i, slot in enumerate(plan):
            x, _ = attention.attend_full(
                pslice[slot_key(i, slot)], x, cfg, positions,
                window=slot.window, causal=causal, use_pallas=use_pallas)
            if slot.ffn == "mlp":
                x = mlp.apply(pslice[ffn_key(i, slot)], x, cfg,
                              use_pallas=use_pallas)
    x = common.rms_norm(x, top["final_norm"], cfg.norm_eps)
    return _head_logits(top, x, cfg, use_pallas)


# ---------------------------------------------------------------------------
# Decode (single new token against per-slot caches)


def cache_len(slot: Slot, context: int) -> int:
    return min(slot.window, context) if slot.window else context


def init_caches(cfg: ModelConfig, batch: int, context: int,
                dtype=torch.bfloat16, *, device=None) -> Dict[str, Any]:
    plan, np_ = _ported_plan(cfg)
    dev = resolve_device(device)
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    caches: Dict[str, Any] = {}
    for i, slot in enumerate(plan):
        C = cache_len(slot, context)
        caches[slot_key(i, slot)] = {
            "k": torch.zeros((np_, batch, C, hkv, dh), dtype=dtype, device=dev),
            "v": torch.zeros((np_, batch, C, hkv, dh), dtype=dtype, device=dev),
        }
    return caches


def _slot_positions(C: int, t: int, device=None) -> torch.Tensor:
    """Absolute position held by each rolling-cache slot at time t (-1 empty)."""
    idx = torch.arange(C, dtype=torch.int32, device=device)
    p = t - torch.remainder(t - idx, C)
    return torch.where(p >= 0, p, -1).to(torch.int32)


def decode_step(params: Dict[str, Any], cfg: ModelConfig, token: torch.Tensor,
                caches: Dict[str, Any], t: int, *, use_pallas: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: (B,) int; t: current absolute position (a Python int).
    Returns (logits (B, V) f32, caches). The caches are updated in place
    (the reference returns new ones) and returned."""
    plan, np_ = _ported_plan(cfg)
    t = int(t)
    top = _top(params, use_pallas)
    x = _embed(top, token[:, None], cfg)
    # slot positions depend only on the slot's cache length and t: one
    # per slot, not one per layer
    spos = {key: _slot_positions(c["k"].shape[2], t, device=x.device)
            for key, c in caches.items()}
    for l in range(np_):
        pslice = fxp.unpack_tree(_layer(params["blocks"], l),
                                 keep_dense=use_pallas)
        for i, slot in enumerate(plan):
            key = slot_key(i, slot)
            ck, cv = caches[key]["k"][l], caches[key]["v"][l]
            x, _ = attention.attend_decode(
                pslice[key], x, cfg, ck, cv, spos[key], t, window=slot.window,
                use_pallas=use_pallas)
            if slot.ffn == "mlp":
                x = mlp.apply(pslice[ffn_key(i, slot)], x, cfg,
                              use_pallas=use_pallas)
    x = common.rms_norm(x, top["final_norm"], cfg.norm_eps)
    return _head_logits(top, x, cfg, use_pallas)[:, 0], caches


# ---------------------------------------------------------------------------
# Prefill (forward + cache collection → decode handoff)


def _roll_into_cache(k: torch.Tensor, C: int) -> torch.Tensor:
    """Scatter the last C positions of k (B,S,H,D) into rolling-cache layout
    (slot = position % C), matching attend_decode's write pattern."""
    S = k.shape[1]
    take = k[:, S - C:]
    idx = torch.arange(S - C, S, device=k.device) % C
    out = torch.zeros_like(take)
    out[:, idx] = take
    return out


def prefill(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor, *,
            use_pallas: bool = False, cache_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt, returning (last-position logits (B,V), caches
    stacked (num_periods, B, C, Hkv, Dh) per slot)."""
    plan, np_ = _ported_plan(cfg)
    top = _top(params, use_pallas)
    x = _embed(top, tokens, cfg)
    B, S = tokens.shape
    positions = _positions(B, S, x.device)
    per_layer = {slot_key(i, slot): {"k": [], "v": []}
                 for i, slot in enumerate(plan)}
    for l in range(np_):
        pslice = fxp.unpack_tree(_layer(params["blocks"], l),
                                 keep_dense=use_pallas)
        for i, slot in enumerate(plan):
            key = slot_key(i, slot)
            x, (k, v) = attention.attend_full(
                pslice[key], x, cfg, positions, window=slot.window,
                use_pallas=use_pallas)
            C = cache_len(slot, S)
            per_layer[key]["k"].append(_roll_into_cache(k, C).to(cache_dtype))
            per_layer[key]["v"].append(_roll_into_cache(v, C).to(cache_dtype))
            if slot.ffn == "mlp":
                x = mlp.apply(pslice[ffn_key(i, slot)], x, cfg,
                              use_pallas=use_pallas)
    caches = {key: {n: torch.stack(c[n]) for n in ("k", "v")}
              for key, c in per_layer.items()}
    x = common.rms_norm(x[:, -1:], top["final_norm"], cfg.norm_eps)
    return _head_logits(top, x, cfg, use_pallas)[:, 0], caches


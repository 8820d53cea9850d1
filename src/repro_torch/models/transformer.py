"""LM stack (counterpart of ``repro/models/transformer.py``): attention,
cross-attention (the VLM), mamba2 and zamba2's shared attention slots,
each with its MLP or MoE FFN, over tokens or, for an encoder (the audio
family), precomputed frame embeddings.

The layer plan is periodic: parameters are stacked as (num_periods, ...)
per slot of the period, and where the reference ``lax.scan``s over periods
the port loops over them in Python. The stacked leaves are sliced with one
``torch.unbind`` per leaf per call (views, no copies): under autograd its
backward stacks the per-layer gradients once, where indexing each layer
would write a zero tensor of the whole stack per layer.

Params layout (stacked leaves carry the leading num_periods dim):

    {"embed": (V, D)?,                 # absent for an encoder
     "in_proj": (D, D)?,               # an encoder's frame projection
     "blocks": {"s{i}_attn"|"s{i}_mamba"|"s{i}_cross": {...},
                "s{i}_mlp"|"s{i}_moe": {...}},
     "shared": {"attn": {...}, "mlp": {...}}?,  # zamba2: one unstacked
                                        # block that every period uses
     "final_norm": (D,),
     "head": (D, V)?}                  # absent when tie_embeddings

The controller sees "blocks/..." paths as stacked (per-layer precision)
and "shared/..." as per-tensor, so a shared leaf's gradient is the sum of
its uses.

On a model axis of more than one rank (``sharding.model_group``, the
training forward of the dense and MoE families) the embedding and the head
are vocab-parallel: the lookup reads the rank's rows and sums over the
ranks, the logits are the rank's vocabulary columns, and ``lm_loss``
reduces over the ranks in f32. The residual stream is whole on every
model rank. A cross slot projects the encoder memory (image-patch
embeddings) inside the layer body, so remat recomputes it; prefill caches
the projected k/v, which decode reads and never writes.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import sharding as shd
from repro_torch.config import ModelConfig
from repro_torch.core import fixed_point as fxp
from repro_torch.core.controller import unbind_layers
from repro_torch.device import resolve_device
from repro_torch.models import attention, common, mlp, moe, ssm


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
    plan, np_ = build_plan(cfg)
    params: Dict[str, Any] = {"blocks": {}}
    if cfg.is_encoder:
        # the stub frontend's frames arrive at d_model; a learned
        # projection keeps the path trainable (``transformer.py:127-132``)
        params["in_proj"] = common.init_dense(gen, (cfg.d_model, cfg.d_model),
                                              device=dev)
    else:
        params["embed"] = common.init_embed(gen, cfg.vocab_size, cfg.d_model,
                                            device=dev)
    for i, slot in enumerate(plan):
        if slot.shared:
            if "shared" not in params:
                params["shared"] = {"attn": attention.init_layer(
                    gen, cfg, 0, device=dev)}
                if slot.ffn == "mlp":
                    params["shared"]["mlp"] = mlp.init_layer(gen, cfg, 0,
                                                             device=dev)
        elif slot.kind == "mamba":
            params["blocks"][slot_key(i, slot)] = ssm.init_layer(
                gen, cfg, np_, device=dev)
        else:
            params["blocks"][slot_key(i, slot)] = attention.init_layer(
                gen, cfg, np_, device=dev)
        if slot.ffn == "mlp" and not slot.shared:
            params["blocks"][ffn_key(i, slot)] = mlp.init_layer(
                gen, cfg, np_, device=dev)
        elif slot.ffn == "moe":
            params["blocks"][ffn_key(i, slot)] = moe.init_layer(
                gen, cfg, np_, device=dev)
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                       device=dev)
    if not cfg.tie_embeddings:
        params["head"] = common.init_dense(
            gen, (cfg.d_model, cfg.vocab_size or 1), device=dev)
    return params


# ---------------------------------------------------------------------------
# Helpers


def _top(params, use_pallas: bool):
    """Non-block params, dequantized at entry except dense leaves under
    ``use_pallas`` (an encoder's ``in_proj`` among them) and the embedding,
    whose rows ``embed_lookup`` gathers before dequantizing."""
    rest = {k: v for k, v in params.items() if k not in ("blocks", "embed")}
    top = fxp.unpack_tree(rest, keep_dense=use_pallas)
    if "embed" in params:
        top["embed"] = params["embed"]
    return top


def _head_logits(top, x, cfg: ModelConfig, use_pallas: bool) -> torch.Tensor:
    """The logits (f32, after the final softcap): on a model axis of more
    than one rank the rank's vocabulary columns, a column-parallel product
    with the rank's columns of ``head`` or rows of the tied ``embed``."""
    head = top.get("head")
    if head is None:
        head = fxp.unpack_tree({"embed": top["embed"]})["embed"].T
        use_pallas = False
    group = shd.model_group()
    if group is not None:
        (logits,) = common.column_dense(x, [head], group)
    else:
        logits = common.dense(x, head, use_pallas=use_pallas)
    return common.softcap(logits.to(torch.float32), cfg.final_logit_softcap)


def _embed(top, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return common.embed_lookup(top["embed"], tokens,
                               scale_by_dim=cfg.scale_embed,
                               group=shd.model_group()).to(torch.bfloat16)


def _inputs(top, cfg: ModelConfig, tokens, embeds, use_pallas: bool
            ) -> torch.Tensor:
    """The residual stream's input, bf16: the tokens' embeddings, or an
    encoder's frame embeddings cast to bf16 and projected by ``in_proj``
    (``transformer.py:207-213``)."""
    if tokens is not None:
        return _embed(top, tokens, cfg)
    if embeds is None:
        raise ValueError("forward needs tokens= or, for an encoder, embeds=")
    return common.dense(embeds.to(torch.bfloat16), top["in_proj"],
                        use_pallas=use_pallas)


def _cross(top, pslice, x, cfg: ModelConfig, i: int, slot: Slot, memory,
           use_pallas: bool):
    """A cross slot over ``memory``: its k/v projected, then attended to.
    Returns (x, (k, v))."""
    p = _attn_params(top, pslice, i, slot)
    mk, mv = attention.project_memory(p, memory, cfg, use_pallas=use_pallas)
    return attention.cross_attend(p, x, cfg, mk, mv,
                                  use_pallas=use_pallas), (mk, mv)


def _attn_params(top, pslice, i: int, slot: Slot):
    """An attention slot's params: its slice of the stack, or the shared
    block's (``transformer.py:164-167``)."""
    return top["shared"]["attn"] if slot.shared else pslice[slot_key(i, slot)]


def _apply_ffn(top, pslice, x, cfg: ModelConfig, i: int, slot: Slot,
               use_pallas: bool, dropless: bool = False) -> torch.Tensor:
    """The slot's FFN (``transformer.py:170-179``): the gated MLP (the
    shared block's on a shared slot), or the MoE layer, dropless only in
    the decode step, as the reference's."""
    if slot.ffn == "none":
        return x
    if slot.shared:     # the reference's: a shared slot runs no MoE layer
        return (mlp.apply(top["shared"]["mlp"], x, cfg, use_pallas=use_pallas)
                if "mlp" in top["shared"] else x)
    if slot.ffn == "mlp":
        return mlp.apply(pslice[ffn_key(i, slot)], x, cfg,
                         use_pallas=use_pallas)
    if slot.ffn == "moe":
        return moe.apply(pslice[ffn_key(i, slot)], x, cfg, dropless=dropless,
                         use_pallas=use_pallas)
    return x


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


# ---------------------------------------------------------------------------
# Forward (full sequence)


def _maybe_qact(x, act_wl, name):
    if act_wl is None or name not in act_wl:
        return x
    return common.quantize_act(x, act_wl[name], True)


def _save_dots(ctx, op, *args, **kwargs):
    """The selective remat policy: keep the outputs of ``aten.mm``, the
    products without batch dimensions (the dense layers of
    ``common._PlainDense``), and recompute every other op."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, remat: str):
    """``body`` checkpointed as ``remat`` names: "none" runs it as it is;
    "full" saves only its inputs and recomputes it in the backward
    (``jax.checkpoint(body)``); "selective" also saves the outputs of the
    dense products without batch dimensions
    (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``).

    Both are ``torch.utils.checkpoint`` without reentrancy, so the step's
    ``torch.autograd.grad`` reaches through them. The hand-written kernels
    are ctypes calls inside autograd Functions, which the dispatcher does
    not see: under "selective" they are recomputed, as the reference's
    policy names ``dot_general`` and never a ``pallas_call``; the plain
    attention's products have batch dimensions (``aten.bmm``) and are
    recomputed too. The recompute repeats the forward bit for bit: the
    kernels and their plain versions are deterministic, the quantize
    prologue hashes the element index, activation quantization rounds to
    nearest; nothing in the body draws from torch's generators, so their
    state is not saved."""
    if remat == "none":
        return body
    if remat not in ("full", "selective"):
        raise ValueError(f"remat={remat!r}: one of none, full, selective")
    from torch.utils import checkpoint as ckpt
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "selective":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(ckpt.checkpoint, body, **kw)


def forward(params: Dict[str, Any], cfg: ModelConfig, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            memory: Optional[torch.Tensor] = None,
            act_wl: Dict[str, torch.Tensor] | None = None,
            use_pallas: bool = False, remat: str = "none") -> torch.Tensor:
    """Full-sequence forward → logits (B, S, V) f32, differentiable.

    ``tokens``: (B, S) int for the LM archs; ``embeds``: (B, S, D) frame
    embeddings for an encoder, whose attention is not causal; ``memory``:
    (B, M, D) image-patch embeddings for the cross slots, projected in
    every cross layer's body.

    ``act_wl`` ({slot key: (num_periods,) int WL}, ``act_wl_from_state``)
    quantizes the residual stream at the end of each slot at that layer's
    word length. ``remat`` ("none" | "full" | "selective", ``_remat``)
    checkpoints each layer's body, from unpacking its slice of the params
    to its activation quantization, so no unpacked weight is saved; the
    embedding, the final norm and the head stay outside, as in the
    reference's per-period scan."""
    plan, _ = build_plan(cfg)
    top = _top(params, use_pallas)
    x = _inputs(top, cfg, tokens, embeds, use_pallas)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    causal = not cfg.is_encoder
    rows = (unbind_layers(params["blocks"], act_wl) if act_wl
            else [(b, None) for (b,) in unbind_layers(params["blocks"])])

    def layer(x, pslice, awl):
        pslice = fxp.unpack_tree(pslice, keep_dense=use_pallas)
        for i, slot in enumerate(plan):
            if slot.kind == "mamba":
                x = ssm.apply(pslice[slot_key(i, slot)], x, cfg,
                              use_pallas=use_pallas)
            elif slot.kind == "cross":
                x, _ = _cross(top, pslice, x, cfg, i, slot, memory,
                              use_pallas)
            else:
                x, _ = attention.attend_full(
                    _attn_params(top, pslice, i, slot), x, cfg, positions,
                    window=slot.window, causal=causal, use_pallas=use_pallas)
            x = _apply_ffn(top, pslice, x, cfg, i, slot, use_pallas)
            x = _maybe_qact(x, awl, slot_key(i, slot))
        return x

    layer = _remat(layer, remat)
    for pslice, awl in rows:
        x = layer(x, pslice, awl)
    x = common.rms_norm(x, top["final_norm"], cfg.norm_eps)
    return _head_logits(top, x, cfg, use_pallas)


# ---------------------------------------------------------------------------
# Loss


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor, *, shift: bool = True
            ) -> torch.Tensor:
    """Causal LM loss (shifted) or framewise CE (``shift=False``): the mean
    negative log-likelihood in f32. On a model axis of more than one rank
    the logits are the rank's vocabulary columns (``vocab_parallel_nll``)."""
    if shift:
        logits = logits[:, :-1]
        targets = tokens[:, 1:]
    else:
        targets = tokens
    group = shd.model_group()
    if group is not None:
        return torch.mean(vocab_parallel_nll(logits, targets, group))
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].to(torch.long))[..., 0]
    return torch.mean(nll)


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, group
                       ) -> torch.Tensor:
    """Per-token −log softmax(logits)[target] from the rank's vocabulary
    columns, in f32, log_softmax's own terms: the maximum over the ranks
    (a constant of the gradient), the sum of exp(x − max) over the ranks,
    and the target's shifted logit x_t − max from the rank that holds it
    (an id outside the rank's columns reads column 0 and is zeroed, so no
    index leaves the block). nll = log Σ − (x_t − max), the same on every
    rank; the backward is each rank's own columns' softmax − onehot."""
    lf = logits.to(torch.float32)
    vl = lf.shape[-1]
    mx = group.max(lf.detach().amax(-1, keepdim=True))
    shifted = lf - mx
    total = group.reduce(torch.sum(torch.exp(shifted), dim=-1))
    idx = targets.to(torch.long) - group.index * vl
    inside = (idx >= 0) & (idx < vl)
    idx = torch.where(inside, idx, 0)
    picked = torch.gather(shifted, -1, idx[..., None])[..., 0]
    picked = group.reduce(torch.where(inside, picked,
                                      torch.zeros((), dtype=picked.dtype,
                                                  device=picked.device)))
    return torch.log(total) - picked


# ---------------------------------------------------------------------------
# Decode (single new token against per-slot caches)


def cache_len(slot: Slot, context: int) -> int:
    return min(slot.window, context) if slot.window else context


def init_caches(cfg: ModelConfig, batch: int, context: int,
                dtype=torch.bfloat16, *, device=None) -> Dict[str, Any]:
    plan, np_ = build_plan(cfg)
    dev = resolve_device(device)
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    caches: Dict[str, Any] = {}
    for i, slot in enumerate(plan):
        if slot.kind == "mamba":
            caches[slot_key(i, slot)] = ssm.init_cache(cfg, batch, np_, dtype,
                                                       device=dev)
            continue
        # a cross slot holds the memory's projected k/v, one per image token
        C = (cfg.num_image_tokens if slot.kind == "cross"
             else cache_len(slot, context))
        caches[slot_key(i, slot)] = {
            "k": torch.zeros((np_, batch, C, hkv, dh), dtype=dtype, device=dev),
            "v": torch.zeros((np_, batch, C, hkv, dh), dtype=dtype, device=dev),
        }
    return caches


def _slot_positions(C: int, t, device=None) -> torch.Tensor:
    """Absolute position held by each rolling-cache slot at time t (-1
    empty): (C,) for an int t, (B, C) for a (B,) tensor of per-row
    positions."""
    idx = torch.arange(C, dtype=torch.int32, device=device)
    if isinstance(t, torch.Tensor):
        t = t.to(torch.int32)[:, None]
    p = t - torch.remainder(t - idx, C)
    return torch.where(p >= 0, p, -1).to(torch.int32)


def decode_step(params: Dict[str, Any], cfg: ModelConfig, token: torch.Tensor,
                caches: Dict[str, Any], t, *, use_pallas: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: (B,) int; t: the current absolute position, a Python int
    (every row at t, the ``Engine``'s case) or a (B,) int32 tensor on
    token's device (row b at t[b]: the continuous batcher's slot pool, one
    batch where the reference vmaps a single-row decode over the slots;
    nothing of this path reads back to the host, so it can be captured in
    a CUDA graph). Returns (logits (B, V) f32, caches). The caches are
    updated in place (the reference returns new ones) and returned: an
    attention slot's new k/v, a mamba slot's conv window and SSM state; a
    cross slot reads its cache (the memory's k/v from prefill) and writes
    nothing."""
    plan, _ = build_plan(cfg)
    if not isinstance(t, torch.Tensor):
        t = int(t)
    top = _top(params, use_pallas)
    x = _embed(top, token[:, None], cfg)
    # slot positions depend only on the slot's cache length and t: one
    # per self-attention slot, not one per layer
    spos = {slot_key(i, slot): _slot_positions(
        caches[slot_key(i, slot)]["k"].shape[2], t, device=x.device)
        for i, slot in enumerate(plan) if slot.kind == "attn"}
    for l, (pslice,) in enumerate(unbind_layers(params["blocks"])):
        pslice = fxp.unpack_tree(pslice, keep_dense=use_pallas)
        for i, slot in enumerate(plan):
            key = slot_key(i, slot)
            if slot.kind == "mamba":
                x, _ = ssm.apply_decode(
                    pslice[key], x, cfg,
                    {n: c[l] for n, c in caches[key].items()},
                    use_pallas=use_pallas)
            elif slot.kind == "cross":
                x = attention.cross_attend(
                    _attn_params(top, pslice, i, slot), x, cfg,
                    caches[key]["k"][l], caches[key]["v"][l],
                    use_pallas=use_pallas)
            else:
                ck, cv = caches[key]["k"][l], caches[key]["v"][l]
                x, _ = attention.attend_decode(
                    _attn_params(top, pslice, i, slot), x, cfg, ck, cv,
                    spos[key], t, window=slot.window, use_pallas=use_pallas)
            x = _apply_ffn(top, pslice, x, cfg, i, slot, use_pallas,
                           dropless=True)
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
            memory: Optional[torch.Tensor] = None, use_pallas: bool = False,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt, returning (last-position logits (B,V), caches
    stacked over the periods per slot: (num_periods, B, C, Hkv, Dh) k and v
    for attention, (num_periods, B, M, Hkv, Dh) for a cross slot (the
    projected ``memory``, in ``cache_dtype``), the conv window in
    ``cache_dtype`` and the f32 SSM state for mamba)."""
    plan, _ = build_plan(cfg)
    top = _top(params, use_pallas)
    x = _embed(top, tokens, cfg)
    B, S = tokens.shape
    positions = _positions(B, S, x.device)
    per_layer = {slot_key(i, slot): {} for i, slot in enumerate(plan)}
    for (pslice,) in unbind_layers(params["blocks"]):
        pslice = fxp.unpack_tree(pslice, keep_dense=use_pallas)
        for i, slot in enumerate(plan):
            key = slot_key(i, slot)
            if slot.kind == "mamba":
                x, st = ssm.apply(pslice[key], x, cfg, return_state=True,
                                  use_pallas=use_pallas)
                st["conv"] = st["conv"].to(cache_dtype)
            elif slot.kind == "cross":
                x, (k, v) = _cross(top, pslice, x, cfg, i, slot, memory,
                                   use_pallas)
                st = {"k": k.to(cache_dtype), "v": v.to(cache_dtype)}
            else:
                x, (k, v) = attention.attend_full(
                    _attn_params(top, pslice, i, slot), x, cfg, positions,
                    window=slot.window, use_pallas=use_pallas)
                C = cache_len(slot, S)
                st = {"k": _roll_into_cache(k, C).to(cache_dtype),
                      "v": _roll_into_cache(v, C).to(cache_dtype)}
            for n, t in st.items():
                per_layer[key].setdefault(n, []).append(t)
            x = _apply_ffn(top, pslice, x, cfg, i, slot, use_pallas)
    caches = {key: {n: torch.stack(ts) for n, ts in c.items()}
              for key, c in per_layer.items()}
    x = common.rms_norm(x[:, -1:], top["final_norm"], cfg.norm_eps)
    return _head_logits(top, x, cfg, use_pallas)[:, 0], caches


# ---------------------------------------------------------------------------
# AdaPT integration


def act_wl_from_state(adapt_state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Per-slot activation word length = the slot out-projection's WL
    (paper: activations are quantized at the layer's precision): ``wo`` of
    an attention or cross slot, ``out_proj`` of a mamba slot. A shared slot
    has none, as in the reference."""
    out = {}
    for path, ts in adapt_state["tensors"].items():
        parts = path.split("/")
        if len(parts) == 3 and parts[0] == "blocks" and parts[2] in (
                "wo", "out_proj"):
            out[parts[1]] = ts["wl"]
    return out

"""Batch serving engine (counterpart of ``repro/serve/engine.py``).

The engine takes the AdaPT controller's final ⟨WL,FL⟩ map, quantizes the
weights ONCE at load (rounded to nearest) and serves from the quantized
copy. With ``quant.container_dtype=int8_packed`` that is int8 words in the
packed ⟨q8, sc, wref⟩ format: under ``quant.use_pallas`` every dense layer
and the LM head run the fxp matmul kernel on them. Any other container is
served from f32 grid values (``controller.quantize_params``), whose dense
layers are library products, as the reference leaves them to XLA. Under
``quant.use_pallas`` the prefill's attention runs the flash kernel.
``quantize_serving_levels`` makes the AdaBits word-set ladder that the
continuous batcher (``serve/scheduler.py``) swaps between decode steps.
A VLM's prompt comes with its image memory, whose projected k/v the
prefill caches for every decode step. An encoder (the audio family) has
no decode step: the engine refuses it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import Config
from repro_torch.core import controller, threefry
from repro_torch.core.controller import flatten_with_path
from repro_torch.device import resolve_device
from repro_torch.models import transformer


def quantize_for_serving(params, adapt_state, qcfg, max_wl=None):
    """One-shot weight quantization at the final ⟨WL,FL⟩ (deterministic —
    nearest rounding). ``max_wl`` optionally clamps every tensor's word
    length first (``controller.clamp_adapt_state``). The packed container
    always materializes the words (the quantize-prologue format is turned
    off); every other container quantizes into f32 grid values, as the
    reference passes no dtype (``serve/engine.py:57``). Without
    controller tensors (``quant.mode=off``) the params are served as they
    are."""
    if not adapt_state or not adapt_state.get("tensors"):
        return params
    if max_wl is not None:
        adapt_state = controller.clamp_adapt_state(adapt_state, max_wl)
    if qcfg.container_dtype == "int8_packed":
        qcfg = dataclasses.replace(qcfg, dense_prologue=False)
        return controller.quantize_params_packed(params, adapt_state, qcfg)
    return controller.quantize_params(params, adapt_state, qcfg)


def serving_adapt_state(adapt_state):
    """The controller state as serving reads it: each tensor's ⟨WL,FL⟩
    and nothing else. A training state's other entries (the bf16 gradient
    sums, half the master's bytes, and the lookback ring) are left out, so
    a caller that keeps only this frees them before the weights are
    quantized."""
    tensors = (adapt_state or {}).get("tensors") or {}
    return {"tensors": {p: {"wl": ts["wl"], "fl": ts["fl"]}
                        for p, ts in tensors.items()}}


def quantize_serving_levels(params, adapt_state, qcfg, levels):
    """One quantized word set per serving word length (AdaBits: one set of
    trained weights served at several bit-widths): {wl: qparams} for
    ``levels`` (descending, levels[0] full precision), each the same
    deterministic requantization with the controller state WL-clamped
    (``quantize_for_serving(..., max_wl=wl)``). Every level must have the
    same paths, leaf shapes and dtypes, so the batcher's decode reads any
    of them through buffers of one layout (on the card, each level's
    captured graph); a level that differs raises ``AssertionError`` here,
    at load.

    Without controller tensors there is nothing to requantize: the single
    passthrough tree is returned under levels[0]."""
    levels = tuple(levels)
    if not levels:
        raise ValueError("quantize_serving_levels: empty level ladder")
    if not adapt_state or not adapt_state.get("tensors"):
        return {levels[0]: quantize_for_serving(params, adapt_state, qcfg)}
    out = {wl: quantize_for_serving(params, adapt_state, qcfg, max_wl=wl)
           for wl in levels}
    ref = dict(flatten_with_path(out[levels[0]]))
    for wl in levels[1:]:
        leaves = dict(flatten_with_path(out[wl]))
        if sorted(leaves) != sorted(ref):
            raise AssertionError(
                f"serving level WL={wl} has other paths than the "
                "full-precision level: swapping it in would need another "
                "decode graph")
        for path, a in ref.items():
            b = leaves[path]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(
                    f"serving level WL={wl}: leaf {path} {tuple(a.shape)}/"
                    f"{a.dtype} vs {tuple(b.shape)}/{b.dtype}: a precision "
                    "swap would need another decode graph")
    return out


def make_prefill(cfg: Config):
    m = cfg.model

    def prefill_step(qparams, tokens, memory=None):
        return transformer.prefill(qparams, m, tokens, memory=memory,
                                   use_pallas=cfg.quant.use_pallas)

    return prefill_step


def make_decode(cfg: Config):
    m = cfg.model

    def decode_step(qparams, token, caches, t):
        return transformer.decode_step(qparams, m, token, caches, t,
                                       use_pallas=cfg.quant.use_pallas)

    return decode_step


def check_decoder(cfg: Config) -> None:
    """Serving decodes tokens: an encoder has no embedding and no decode
    step (the reference's ``Engine.generate`` fails on the missing
    ``embed``), so it is refused by name."""
    if cfg.model.is_encoder:
        raise ValueError(f"{cfg.model.name} is an encoder: it has no decode "
                         "step to serve")


def sample(logits: torch.Tensor, key: Optional[threefry.Key] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """Greedy (argmax) at temperature 0, else the reference's draw
    ``jax.random.categorical(key, logits / T)``: the argmax of Threefry
    gumbel noise under ``key`` plus logits / T (``core/threefry.py``).
    Returns (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return threefry.categorical(key, logits.to(torch.float32) / temperature
                                ).to(torch.int32)


class Engine:
    """Minimal batched serving engine over the quantized model.

    ``device`` defaults to ``cuda`` and raises on a host without CUDA unless
    ``device="cpu"``; every tensor of ``params`` must lie on it. An encoder
    raises ``ValueError`` (``check_decoder``)."""

    def __init__(self, cfg: Config, params, adapt_state: Optional[dict] = None,
                 *, device=None):
        check_decoder(cfg)
        self.device = resolve_device(device)
        for path, leaf in flatten_with_path(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"Engine on {self.device}: param {path} "
                                 f"lies on {leaf.device}")
        self.cfg = cfg
        self.qparams = quantize_for_serving(params, adapt_state or {},
                                            cfg.quant)
        self._prefill = make_prefill(cfg)
        self._decode = make_decode(cfg)

    @torch.inference_mode()
    def generate(self, tokens: torch.Tensor, max_new_tokens: int, *,
                 memory: Optional[torch.Tensor] = None,
                 temperature: float = 0.0, seed: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) prompt batch (same length); ``memory``: (B, M, D)
        image-patch embeddings for a VLM's cross slots. Returns (generated
        (B, max_new) int32, last logits (B, V) f32)."""
        tokens = tokens.to(self.device)
        if memory is not None:
            memory = memory.to(self.device)
        B, S = tokens.shape
        context = S + max_new_tokens
        caches = transformer.init_caches(self.cfg.model, B, context,
                                         device=self.device)
        logits, pref_caches = self._prefill(self.qparams, tokens, memory)
        caches = _merge_prefill_caches(caches, pref_caches, S)
        # the reference's keys: PRNGKey(seed) for the first token,
        # fold_in(key, i) for token i + 1 (greedy decoding needs none)
        draw = temperature > 0.0
        key = threefry.key_from_seed(seed) if draw else None
        out = []
        tok = sample(logits, key, temperature)
        for i in range(max_new_tokens):
            out.append(tok)
            if i == max_new_tokens - 1:
                break
            logits, caches = self._decode(self.qparams, tok, caches, S + i)
            tok = sample(logits, threefry.fold_in(key, i) if draw else None,
                         temperature)
        return torch.stack(out, dim=1), logits


def _merge_prefill_caches(full: Dict[str, Any], pref: Dict[str, Any],
                          prompt_len: int) -> Dict[str, Any]:
    """Embed prefill caches (sized to the prompt) into the generation-sized
    cache buffers (in place). Positions keep their slot = pos % C invariant
    because the full cache length C' >= prompt length. A mamba slot's
    conv window and SSM state, and a cache as long in both (a cross slot's
    memory k/v, ``engine.py:170``), are copied whole."""
    for key, slot_cache in full.items():
        p = pref[key]
        if "ssm" in slot_cache or (slot_cache["k"].shape[2]
                                   == p["k"].shape[2]):
            for n, dst in slot_cache.items():
                dst.copy_(p[n])
            continue
        dst_k = slot_cache["k"]
        C_dst, C_src = dst_k.shape[2], p["k"].shape[2]
        pos = torch.arange(prompt_len - C_src, prompt_len, device=dst_k.device)
        src_slot, dst_slot = pos % C_src, pos % C_dst
        for n in ("k", "v"):
            slot_cache[n][:, :, dst_slot] = p[n][:, :, src_slot].to(dst_k.dtype)
    return full

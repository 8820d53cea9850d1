"""Batch serving engine (counterpart of ``repro/serve/engine.py``).

The engine takes the AdaPT controller's final ⟨WL,FL⟩ map, quantizes the
weights ONCE at load (round-to-nearest int8 words in the packed
⟨q8, sc, wref⟩ format), and serves from the words: under
``quant.use_pallas`` every dense layer and the LM head run the fxp matmul
kernel on them, and the prefill's attention runs the flash kernel.

``quantize_serving_levels`` (the AdaBits word-set ladder) comes with the
scheduler slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import Config
from repro_torch.core import controller
from repro_torch.core.controller import flatten_with_path
from repro_torch.device import resolve_device
from repro_torch.models import transformer


def quantize_for_serving(params, adapt_state, qcfg, max_wl=None):
    """One-shot weight quantization at the final ⟨WL,FL⟩ (deterministic —
    nearest rounding). ``max_wl`` optionally clamps every tensor's word
    length first (``controller.clamp_adapt_state``). Serving always
    materializes the words (the quantize-prologue format is turned off)."""
    if not adapt_state or not adapt_state.get("tensors"):
        return params
    if max_wl is not None:
        adapt_state = controller.clamp_adapt_state(adapt_state, max_wl)
    if qcfg.container_dtype != "int8_packed":
        raise NotImplementedError(
            f"serving from container_dtype={qcfg.container_dtype!r} (float "
            "grid containers) comes with the training slice of the port; "
            "use quant.container_dtype=int8_packed")
    qcfg = dataclasses.replace(qcfg, dense_prologue=False)
    return controller.quantize_params_packed(params, adapt_state, qcfg,
                                             key=None)


def make_prefill(cfg: Config):
    m = cfg.model

    def prefill_step(qparams, tokens):
        return transformer.prefill(qparams, m, tokens,
                                   use_pallas=cfg.quant.use_pallas)

    return prefill_step


def make_decode(cfg: Config):
    m = cfg.model

    def decode_step(qparams, token, caches, t):
        return transformer.decode_step(qparams, m, token, caches, t,
                                       use_pallas=cfg.quant.use_pallas)

    return decode_step


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """Greedy (argmax) at temperature 0, else a draw from softmax(logits/T)
    with ``generator``. Returns (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


class Engine:
    """Minimal batched serving engine over the quantized model.

    ``device`` defaults to ``cuda`` and raises on a host without CUDA unless
    ``device="cpu"``; every tensor of ``params`` must lie on it."""

    def __init__(self, cfg: Config, params, adapt_state: Optional[dict] = None,
                 *, device=None):
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
                 temperature: float = 0.0, seed: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) prompt batch (same length). Returns (generated
        (B, max_new) int32, last logits (B, V) f32)."""
        tokens = tokens.to(self.device)
        B, S = tokens.shape
        context = S + max_new_tokens
        caches = transformer.init_caches(self.cfg.model, B, context,
                                         device=self.device)
        logits, pref_caches = self._prefill(self.qparams, tokens)
        caches = _merge_prefill_caches(caches, pref_caches, S)
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        out = []
        tok = sample(logits, gen, temperature)
        for i in range(max_new_tokens):
            out.append(tok)
            if i == max_new_tokens - 1:
                break
            logits, caches = self._decode(self.qparams, tok, caches, S + i)
            tok = sample(logits, gen, temperature)
        return torch.stack(out, dim=1), logits


def _merge_prefill_caches(full: Dict[str, Any], pref: Dict[str, Any],
                          prompt_len: int) -> Dict[str, Any]:
    """Embed prefill caches (sized to the prompt) into the generation-sized
    cache buffers (in place). Positions keep their slot = pos % C invariant
    because the full cache length C' >= prompt length."""
    for key, slot_cache in full.items():
        p = pref[key]
        dst_k = slot_cache["k"]
        C_dst, C_src = dst_k.shape[2], p["k"].shape[2]
        pos = torch.arange(prompt_len - C_src, prompt_len, device=dst_k.device)
        src_slot, dst_slot = pos % C_src, pos % C_dst
        for n in ("k", "v"):
            slot_cache[n][:, :, dst_slot] = p[n][:, :, src_slot].to(dst_k.dtype)
    return full

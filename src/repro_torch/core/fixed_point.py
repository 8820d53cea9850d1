"""Fixed-point ⟨WL, FL⟩ words for serving (paper §2.1, §3.2).

A signed fixed-point number with word length ``WL`` and fractional length
``FL`` represents values q / 2**FL with integer q in [-2**(WL-1), 2**(WL-1)-1].
Serving keeps the network in int8 words plus a 2^-FL scale: the packed
⟨q8, sc, wref⟩ dict the controller emits, dequantized at its use site or
fed whole to the fxp matmul kernel.

Counterpart of ``repro/core/fixed_point.py`` (serving subset). The gradient
rule of ``dequant_packed`` and the stochastic-rounding helpers come with
the training slice.
"""
from __future__ import annotations

import torch

MAX_WL = 32


def pow2i(e) -> torch.Tensor:
    """Exact 2^e (f32) for integer e, built from the exponent bits (clamped
    to the normal range [-126, 127]). Never ``torch.exp2``: a transcendental
    lowering can be an ulp off for |e| ≳ 10, which knocks the ⟨WL,FL⟩ grid
    off its exact powers of two."""
    e = torch.as_tensor(e).to(torch.int32).clamp(-126, 127)
    return ((e + 127) << 23).view(torch.float32)


def fxp_bounds(wl) -> tuple[torch.Tensor, torch.Tensor]:
    """(qmin, qmax) integer bounds of a signed WL-bit word (f32 container,
    exact up to WL=32: 2^31 is representable)."""
    qmax = pow2i(torch.as_tensor(wl).to(torch.int32) - 1) - 1.0
    return -qmax - 1.0, qmax


def quantize_int8(w: torch.Tensor, fl) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize to int8 words (WL<=8 enforced by the clip) + scale 2^-FL,
    round-to-nearest-even (``torch.round``, as ``jnp.round``). The
    stochastic-rounding form (``u=``) comes with the training slice.

    Returns (q_int8, scale) with dequant = q * scale."""
    scale = pow2i(fl).to(w.device)
    q = torch.round(w.to(torch.float32) * scale)
    q = q.clamp(-128.0, 127.0).to(torch.int8)
    return q, (1.0 / scale).to(torch.float32)


def fl_for_wl(w_absmax, wl) -> torch.Tensor:
    """Largest FL for word length WL s.t. max|w| is representable: FL = WL-1-IL."""
    w_absmax = torch.as_tensor(w_absmax, dtype=torch.float32)
    il = torch.clamp(torch.ceil(torch.log2(torch.clamp(w_absmax, min=1e-12))),
                     min=0.0)
    return torch.as_tensor(wl).to(torch.int32) - 1 - il.to(torch.int32)


# ---------------------------------------------------------------------------
# Packed int8 format: a quantized tensor is {"q8": int8, "sc": bf16 scale,
# "wref": bf16 zeros}. "wref" is the gradient receiver of the training slice;
# serving never reads it.

PACKED_KEYS = frozenset(("q8", "sc", "wref"))

# Param-tree leaf names consumed by models/common.dense (2-D x@W matmuls):
# only these reach the fxp matmul kernel; every other quantized leaf is
# dequantized at its use site.
DENSE_PARAM_NAMES = frozenset((
    "wq", "wk", "wv", "wo",            # attention projections
    "wi_gate", "wi_up",                # gated-MLP in-projections
    "in_proj", "out_proj",             # SSM / audio-frontend projections
    "head",                            # LM head
))


def is_packed(leaf) -> bool:
    return isinstance(leaf, dict) and frozenset(leaf) == PACKED_KEYS


def is_dense_param(path: str) -> bool:
    """True when the (slash-joined) param path names a dense-layer weight."""
    return path.rsplit("/", 1)[-1] in DENSE_PARAM_NAMES


def dequant_packed(q8: torch.Tensor, sc: torch.Tensor, wref=None
                   ) -> torch.Tensor:
    """bf16 value view of int8 words: ``q8.to(bf16) * sc`` in bf16 (exact:
    an int8 word times a power of two fits bf16's 8-bit significand)."""
    del wref
    return q8.to(torch.bfloat16) * sc


def unpack_tree(tree, keep_dense: bool = False, _prefix: str = ""):
    """Dequantize every packed leaf in a (sub)tree of dicts; plain leaves
    pass. ``keep_dense=True`` leaves packed dicts whose path names a
    dense-layer weight (``is_dense_param``) intact: the kernel dense path
    consumes them directly (``models/common.dense``)."""
    if is_packed(tree):
        if keep_dense and is_dense_param(_prefix):
            return tree
        return dequant_packed(tree["q8"], tree["sc"], tree["wref"])
    if isinstance(tree, dict):
        return {k: unpack_tree(v, keep_dense, f"{_prefix}/{k}" if _prefix
                               else str(k))
                for k, v in tree.items()}
    return tree

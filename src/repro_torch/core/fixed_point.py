"""Fixed-point ⟨WL, FL⟩ quantization (paper §2.1, §3.2).

A signed fixed-point number with word length ``WL`` and fractional length
``FL`` represents values q / 2**FL with integer q in [-2**(WL-1), 2**(WL-1)-1].
The network keeps int8 words plus a 2^-FL scale: the packed
⟨q8, sc, wref⟩ dict the controller emits, dequantized at its use site or
fed whole to the fxp matmul kernels, with gradients routed to "wref".

Counterpart of ``repro/core/fixed_point.py``: grids, round-to-nearest and
stochastic-rounding quantization (the noise ``u`` supplied by the caller,
or drawn from a jax.random key by ``uniform_noise_like``),
activation quantization with the straight-through gradient, the packed
format with ``dequant_packed``'s gradient rule, the quantize-prologue
format ⟨wm, seed, flq, mode⟩ with its value view ``qdense_view``, and
``sparsity``.
"""
from __future__ import annotations

import torch

from repro_torch import sharding as shd
from repro_torch.core import threefry

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


def stochastic_round(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """SR(x): floor(x) + (u < frac(x)). ``u`` ~ U[0,1) with x's shape."""
    f = torch.floor(x)
    return f + (u < (x - f)).to(x.dtype)


def _round(x: torch.Tensor, u) -> torch.Tensor:
    """Round to nearest, half to even (``torch.round``, as ``jnp.round``)
    when ``u`` is None, else stochastically with the noise ``u``."""
    if u is None:
        return torch.round(x)
    return stochastic_round(x, u.to(torch.float32))


def quantize(w: torch.Tensor, wl, fl, *, u=None) -> torch.Tensor:
    """Quantize to the ⟨WL,FL⟩ grid; returns grid values in f32. ``u``
    supplies U[0,1) noise for stochastic rounding; ``None`` rounds to
    nearest (PushDown's deterministic probe). WL/FL are ints or tensors
    broadcastable to w."""
    w = w.to(torch.float32)
    scale = pow2i(fl).to(w.device)
    qmin, qmax = fxp_bounds(wl)
    q = _round(w * scale, u)
    q = torch.clamp(q, qmin.to(w.device), qmax.to(w.device))
    return q / scale


def quantize_int8(w: torch.Tensor, fl, *, u=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize to int8 words (WL<=8 enforced by the clip) + scale 2^-FL,
    rounding as :func:`quantize`.

    Returns (q_int8, scale) with dequant = q * scale."""
    scale = pow2i(fl).to(w.device)
    q = _round(w.to(torch.float32) * scale, u)
    q = q.clamp(-128.0, 127.0).to(torch.int8)
    return q, (1.0 / scale).to(torch.float32)


def uniform_noise_like(key, x: torch.Tensor) -> torch.Tensor:
    """U[0,1) f32 noise of x's shape from a jax.random key (a pair of
    ints): ``jax.random.uniform(key, x.shape)`` bit for bit
    (``fixed_point.py:111``, ``core/threefry.py``)."""
    return threefry.uniform(key, x.shape, device=x.device)


def fl_for_wl(w_absmax, wl) -> torch.Tensor:
    """Largest FL for word length WL s.t. max|w| is representable: FL = WL-1-IL.

    A floating ``w_absmax`` keeps its dtype, and log2 is ``jnp.log2``'s own
    expansion log(x) / log(2) in that dtype, as in the reference: for a
    bf16 abs-max this gives the reference's IL bit for bit (its rounded
    log2 can exceed an exact power of two's, e.g. 32 → IL 6)."""
    w_absmax = torch.as_tensor(w_absmax)
    if not w_absmax.is_floating_point():
        w_absmax = w_absmax.to(torch.float32)
    m = torch.clamp(w_absmax, min=1e-12)
    log2 = torch.log(m) / torch.log(torch.tensor(2.0, dtype=m.dtype,
                                                  device=m.device))
    il = torch.clamp(torch.ceil(log2), min=0.0)
    return torch.as_tensor(wl).to(torch.int32) - 1 - il.to(torch.int32)


def quantize_activation(a: torch.Tensor, wl) -> torch.Tensor:
    """Dynamic-range activation quantization: FL from the batch's abs-max
    (on a rank of a data-parallel step, the whole global batch's:
    ``sharding.batch_max``), the value rounded to nearest on the ⟨WL,FL⟩
    grid in a's dtype, and the straight-through gradient
    ``a + (q − a).detach()``."""
    ad = a.detach()
    amax = shd.batch_max(torch.max(torch.abs(ad)))
    fl = fl_for_wl(amax, wl)
    q = quantize(ad, wl, fl).to(a.dtype)
    return a + (q - ad)


# ---------------------------------------------------------------------------
# Packed int8 format: a quantized tensor is {"q8": int8, "sc": bf16 scale,
# "wref": bf16 zeros}. Nothing reads "wref": it is the gradient receiver,
# where the straight-through gradient of the words lands.

PACKED_KEYS = frozenset(("q8", "sc", "wref"))

# Quantize-prologue format: the quantized copy of a dense-consumed weight is
# the f32 MASTER "wm" itself plus ⟨"seed", "flq", "mode"⟩ (int32, (L,) on a
# stacked leaf); the dense kernels draw the int8 words in registers and the
# gradient lands on "wm". "seed" and "mode" are host (CPU) tensors, "flq"
# the controller's device FL.
QDENSE_KEYS = frozenset(("wm", "seed", "flq", "mode"))

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


def is_qdense(leaf) -> bool:
    return isinstance(leaf, dict) and frozenset(leaf) == QDENSE_KEYS


def is_dense_param(path: str) -> bool:
    """True when the (slash-joined) param path names a dense-layer weight."""
    return path.rsplit("/", 1)[-1] in DENSE_PARAM_NAMES


class _DequantPacked(torch.autograd.Function):
    """The reference's custom VJP (``fixed_point.py:161-178``): the
    cotangent of the value view goes to ``wref`` in bf16, the scale gets
    zero, the words none."""

    @staticmethod
    def forward(ctx, q8, sc, wref):
        ctx.sc_like = (sc.shape, sc.dtype, sc.device)
        return q8.to(torch.bfloat16) * sc

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.sc_like
        dsc = (torch.zeros(shape, dtype=dtype, device=device)
               if ctx.needs_input_grad[1] else None)
        return None, dsc, g.to(torch.bfloat16)


def dequant_packed(q8: torch.Tensor, sc: torch.Tensor, wref=None
                   ) -> torch.Tensor:
    """bf16 value view of int8 words: ``q8.to(bf16) * sc`` in bf16 (exact:
    an int8 word times a power of two fits bf16's 8-bit significand).
    Differentiable into ``wref`` (straight-through) when it is given."""
    if wref is None:
        return q8.to(torch.bfloat16) * sc
    return _DequantPacked.apply(q8, sc, wref)


def qdense_view(wm: torch.Tensor, seed, flq, mode) -> torch.Tensor:
    """The value view of a quantize-prologue leaf (``fixed_point.py:181``):
    the dequantized ⟨8,FL⟩ words the matmul draws in registers, per layer of
    a stacked leaf, in wm's dtype, as wm + (view − wm) with the difference
    detached, so the gradient passes to ``wm`` unchanged."""
    from repro_torch.kernels import ops

    def one(w, s, f, m):
        words = ops.qdense_words(w, s, f, m).to(torch.float32)
        return words * pow2i(-f).to(w.device)

    flq = torch.as_tensor(flq)
    if flq.ndim:
        view = torch.stack([one(w, s, f, m) for w, s, f, m in
                            zip(wm.detach(), seed, flq, mode)])
    else:
        view = one(wm.detach(), seed, flq, mode)
    return wm + (view.to(wm.dtype) - wm).detach()


def unpack_tree(tree, keep_dense: bool = False, _prefix: str = ""):
    """Dequantize every packed leaf, and take the value view of every
    quantize-prologue leaf, in a (sub)tree of dicts; plain leaves pass.
    ``keep_dense=True`` leaves the dicts whose path names a dense-layer
    weight (``is_dense_param``) intact: the kernel dense path consumes them
    directly (``models/common.dense``)."""
    if is_qdense(tree):
        if keep_dense and is_dense_param(_prefix):
            return tree
        return qdense_view(tree["wm"], tree["seed"], tree["flq"], tree["mode"])
    if is_packed(tree):
        if keep_dense and is_dense_param(_prefix):
            return tree
        return dequant_packed(tree["q8"], tree["sc"], tree["wref"])
    if isinstance(tree, dict):
        return {k: unpack_tree(v, keep_dense, f"{_prefix}/{k}" if _prefix
                               else str(k))
                for k, v in tree.items()}
    return tree


def exact_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The f32 mean of values whose f32 sum is exact (a 0/1 mask, small
    integers), as XLA takes ``jnp.mean`` on the CPU: the sum times the f32
    reciprocal f32(1) / f32(n). ``torch.mean`` divides by n instead, and for
    some (sum, n) the two round to neighbouring floats (1151 of 1152 gives
    0.99913192 against XLA's 0.99913198), so this never divides. ``dim`` is one
    dim or a tuple of dims (all dims when None)."""
    x = x.to(torch.float32)
    dims = tuple(range(x.ndim)) if dim is None else (
        (dim,) if isinstance(dim, int) else tuple(dim))
    n = 1
    for d in dims:
        n *= x.shape[d]
    inv = recip_f32(n)
    return torch.sum(x, dim=dims) * inv if dims else x * inv


def recip_f32(n: int) -> float:
    """f32(1) / f32(n), as a Python float (an f32 value, so a product with
    an f32 tensor is taken at that value)."""
    return (torch.tensor(1.0) / torch.tensor(float(n))).item()


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """a·b + c of f32 values rounded once to f32, as a fused multiply-add
    gives it. In f64 the product is exact (24 + 24 bits); the sum is taken
    rounded to odd (the nearest sum, moved one ulp toward the exact value
    when it was inexact and its last bit even), and rounding that to f32 is
    the correct rounding, since f64 has more than 24 + 2 bits."""
    a, b, c = (t.to(torch.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)       # s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def sparsity(w: torch.Tensor, axes=None, eps: float = 0.0) -> torch.Tensor:
    """Fraction of non-zero elements (paper's sp^l); |w| <= eps counts as 0.
    The mean of the 0/1 mask is the reference's bits (``exact_mean``)."""
    return exact_mean((torch.abs(w) > eps).to(torch.float32), axes)

"""Shared model building blocks (counterpart of ``repro/models/common.py``):
plain functions over tensors and param dicts. The reference's sharding
annotations are no-ops on one device and are left out."""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core import init as weight_init


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.to(torch.float32))).to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return logits
    return cap * torch.tanh(logits / cap)


def act_fn(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        # jax.nn.gelu(approximate=True)'s own op chain, the constants first
        # rounded to x's dtype (jax's weak types), each op rounded to it:
        # torch's fused gelu rounds once and differs in bf16
        c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
        a = torch.tensor(0.044715, dtype=x.dtype)
        return x * (0.5 * (1 + torch.tanh(c * (x + a * x ** 3))))
    # jax.nn.silu's own op chain, x * (1 / (1 + exp(-x))), each op rounded
    # to x's dtype: in bf16 this gives the reference's values bit for bit,
    # where x * sigmoid(x) differs in about a quarter of them
    return x * (1 / (1 + torch.exp(-x)))


@contextlib.contextmanager
def _full_precision_reduction():
    """cuBLAS may reduce a bf16 GEMM's split-K partial sums in bf16
    (``allow_bf16_reduced_precision_reduction``, on by default); turned
    off, a bf16 product accumulates in f32 and rounds once, as the
    reference's ``preferred_element_type=f32`` dot."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = before


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """a @ b for two tensors of one dtype, a (..., K) by b (K, N) or two 3-D
    stacks batched (``torch.bmm``): f32 accumulation, rounded once to
    ``out_dtype`` (a's by default). On the card a bf16 product is cuBLAS's
    bf16 GEMM, with an f32 result where asked; on the CPU the factors are
    widened to f32 first."""
    out_dtype = out_dtype or a.dtype
    mm = torch.bmm if b.dim() == 3 else torch.matmul
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        with _full_precision_reduction():
            if out_dtype == a.dtype:
                return mm(a, b)
            return (torch.bmm if b.dim() == 3 else torch.mm)(
                a, b, out_dtype=out_dtype)
    return mm(a.to(torch.float32), b.to(torch.float32)).to(out_dtype)


class _PlainDense(torch.autograd.Function):
    """y = x @ w.astype(x.dtype), f32 accumulation, in x's dtype or in
    ``out_dtype``, as the reference's ``jnp.dot`` (``models/common.py:64-68``)
    or, for two 3-D stacks, its ``einsum(...,
    preferred_element_type=float32)`` over the MoE experts
    (``models/moe.py:33-38``), with the gradients of its dtype chain: the
    f32 products of the cotangent, dx in x's dtype, dw rounded to x's
    dtype (the transpose of the cast) and then to w's. Saves x and the
    weight leaf itself and recasts in the backward, so no f32 or bf16 copy
    of a weight outlives its own product."""

    @staticmethod
    def forward(ctx, x, w, out_dtype=None):
        ctx.save_for_backward(x, w)
        return _mm(x, w.to(x.dtype), out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm(dy, w.to(x.dtype).to(dy.dtype).mT, x.dtype)
        if ctx.needs_input_grad[1]:
            x2, dy2 = x, dy
            if w.dim() == 2:
                x2 = x.reshape(-1, x.shape[-1])
                dy2 = dy.reshape(-1, dy.shape[-1])
            dw = _mm(x2.to(dy.dtype).mT, dy2, x.dtype).to(w.dtype)
        return dx, dw, None


def dense(x: torch.Tensor, w, *, use_pallas: bool = False) -> torch.Tensor:
    """x @ w with f32 accumulation, returned in x's dtype.

    ``w`` is a plain weight (a grid-value leaf of a float container, or
    the master: cast to x's dtype first, as the reference's
    ``jnp.dot(x, w.astype(x.dtype))``, a library product as the reference
    leaves it to XLA), a packed ⟨q8, sc, wref⟩ dict, which under
    ``use_pallas`` goes whole to the fxp matmul (the kernel on the card,
    so no dequantized weight exists in device memory), or a
    quantize-prologue ⟨wm, seed, flq, mode⟩ dict, whose words the prologue
    kernels draw from the master in registers."""
    if isinstance(w, dict):
        return _dense_quantized(x, w, use_pallas)
    return _PlainDense.apply(x, w)


def _dense_quantized(x: torch.Tensor, w: dict, use_pallas: bool
                     ) -> torch.Tensor:
    """Dense over a packed or prologue dict; x may be (..., K): leading
    dims are flattened into M for the 2-D kernels."""
    from repro_torch.kernels import ops

    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if fxp.is_qdense(w):
        y2 = ops.fxp_qdense(x2, w["wm"], w["seed"], w["flq"], w["mode"],
                            out_dtype=x.dtype)
    elif not fxp.is_packed(w):
        raise TypeError(f"dense: unrecognized weight dict keys {set(w)}")
    elif use_pallas:
        y2 = ops.fxp_dense(x2, w["q8"], w["sc"].reshape(()), w["wref"],
                           use_pallas=True, out_dtype=x.dtype)
    else:
        y2 = _PlainDense.apply(x2, fxp.dequant_packed(w["q8"], w["sc"],
                                                      w["wref"]))
    return y2.reshape(lead + (y2.shape[-1],))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    half = d // 2
    # log(theta) in f32, as jnp.log of a weakly typed float; a fill on the
    # device, not a copy from the host, so a CUDA graph can capture it
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32,
                                     device=x.device))
    freq = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32,
                                               device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq        # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if 2 * half < d:  # odd head dim: pass the tail through
        rot = torch.cat([rot, x[..., 2 * half:]], dim=-1)
    return rot.to(x.dtype)


def quantize_act(x: torch.Tensor, wl, enabled: bool) -> torch.Tensor:
    """Activation fixed-point quantization at the layer's word length
    (dynamic-range FL, nearest rounding, straight-through gradient)."""
    if not enabled or wl is None:
        return x
    return fxp.quantize_activation(x, wl)


def embed_lookup(table, ids: torch.Tensor, scale_by_dim: bool = False
                 ) -> torch.Tensor:
    """Rows of ``table`` at ``ids``. ``table`` may be a packed dict: its rows
    are gathered before they are dequantized, which gives the bf16 values
    of dequantizing the whole table first without writing that table."""
    idx = ids.to(torch.long)
    if fxp.is_packed(table):
        # the index's backward scatter-adds the rows' bf16 gradients into a
        # dense (V, D) gradient of "wref", as the reference's take →
        # dequant_packed transpose does
        out = fxp.dequant_packed(table["q8"][idx], table["sc"],
                                 table["wref"][idx])
        d = table["q8"].shape[-1]
    else:
        out = table[idx]
        d = table.shape[-1]
    if scale_by_dim:
        # sqrt(d) rounded to out's dtype, filled on the device (a copy from
        # the host would stop the batcher's CUDA graph capture)
        out = out * torch.full((), d ** 0.5, dtype=out.dtype,
                               device=out.device)
    return out


def init_dense(generator: torch.Generator, shape, scale: float = 1.0,
               device=None) -> torch.Tensor:
    return weight_init.tnvs(generator, shape, scale=scale, kind="linear",
                            device=device)


def init_embed(generator: torch.Generator, vocab: int, d: int,
               scale: float = 1.0, device=None) -> torch.Tensor:
    return weight_init.tnvs(generator, (vocab, d), scale=scale, kind="embed",
                            device=device)

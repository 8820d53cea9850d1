"""Shared model building blocks (counterpart of ``repro/models/common.py``):
plain functions over tensors and param dicts. The reference's sharding
annotations are no-ops on one device and are left out; on a model axis of
more than one rank the layers call ``column_dense`` and ``row_dense``,
the Megatron pair with the collectives GSPMD places for the reference."""
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


def _mm_rows(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """``_mm`` of a (..., K) by a 2-D b (K, N) as one 2-D product (the card's
    GEMM with an f32 result takes 2-D operands), or of two 3-D stacks."""
    if b.dim() == 3:
        return _mm(a, b, out_dtype)
    y = _mm(a.reshape(-1, a.shape[-1]), b, out_dtype)
    return y.reshape(a.shape[:-1] + (b.shape[-1],))


def _dw(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The weight gradient of y = x @ w.astype(x.dtype): xᵀ dy with f32
    accumulation, rounded to x's dtype (the transpose of the cast), then
    to w's."""
    x2, dy2 = x, dy
    if w.dim() == 2:
        x2 = x.reshape(-1, x.shape[-1])
        dy2 = dy.reshape(-1, dy.shape[-1])
    return _mm(x2.to(dy.dtype).mT, dy2, x.dtype).to(w.dtype)


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
            dw = _dw(x, dy, w)
        return dx, dw, None


class _ColumnDense(torch.autograd.Function):
    """Column-parallel dense layers that share their input x, whole on
    every model rank: y_i = x @ w_i.astype(x.dtype) on the rank's columns
    of each w_i, as ``_PlainDense``. The backward sums the f32 products
    dy_i @ w_iᵀ, all-reduces that f32 partial over the model ranks and
    rounds it once to x's dtype (GSPMD's dot(preferred=f32) → all-reduce
    → convert); each w_i's gradient is its own block's."""

    @staticmethod
    def forward(ctx, x, group, out_dtype, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.group = group
        return tuple(_mm_rows(x, w.to(x.dtype), out_dtype) for w in ws)

    @staticmethod
    def backward(ctx, *dys):
        x, *ws = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            for dy, w in zip(dys, ws):
                part = _mm_rows(dy, w.to(x.dtype).to(dy.dtype).mT,
                                torch.float32)
                dx = part if dx is None else dx.add_(part)
            dx = ctx.group.sum(dx).to(x.dtype)
        dws = [_dw(x, dy, w) if ctx.needs_input_grad[3 + i] else None
               for i, (dy, w) in enumerate(zip(dys, ws))]
        return (dx, None, None, *dws)


class _RowDense(torch.autograd.Function):
    """A row-parallel dense layer: x holds the rank's columns of the
    input and w the matching rows; the partial product (f32, or bf16 under
    ``train.tp_reduce_dtype=bfloat16``) is summed over the model ranks in
    that dtype and only then rounded to x's dtype, GSPMD's order for the
    reference's ``jnp.dot(..., preferred_element_type)`` →
    ``astype``. The backward is the rank's own: dx = dy @ wᵀ, dw = xᵀ dy."""

    @staticmethod
    def forward(ctx, x, w, group, reduce_dtype):
        ctx.save_for_backward(x, w)
        part = _mm_rows(x, w.to(x.dtype), reduce_dtype)
        return group.sum(part).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_rows(dy, w.to(x.dtype).to(dy.dtype).mT, x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _dw(x, dy, w)
        return dx, dw, None, None


def column_dense(x: torch.Tensor, ws, group, out_dtype=None) -> tuple:
    """(x @ w for w in ws) on the rank's column blocks of each weight (2-D,
    or two 3-D expert stacks), x whole on every model rank: one all-reduce
    of x's f32 gradient for all of them (``_ColumnDense``). The weights are
    plain tensors: packed words under ``quant.use_pallas`` on a split leaf
    are refused (``controller._refuse_sharded_dense_kernels``) and a split
    leaf never takes the quantize prologue."""
    return _ColumnDense.apply(x, group, out_dtype, *ws)


def row_dense(x: torch.Tensor, w, group, reduce_dtype=torch.float32
              ) -> torch.Tensor:
    """x @ w summed over the model ranks, x the rank's input columns and w
    its rows, rounded to x's dtype after the sum (``_RowDense``)."""
    return _RowDense.apply(x, w, group, reduce_dtype)


def tp_reduce_dtype(x: torch.Tensor, group) -> torch.dtype:
    """The dtype a row-parallel dense layer's partial crosses the ranks in:
    bf16 under ``#tp_reduce_bf16`` for a bf16 input (``common.py:64-67``
    of the reference), else f32."""
    return (torch.bfloat16 if group.reduce_bf16 and x.dtype == torch.bfloat16
            else torch.float32)


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


def embed_lookup(table, ids: torch.Tensor, scale_by_dim: bool = False, *,
                 group=None) -> torch.Tensor:
    """Rows of ``table`` at ``ids``. ``table`` may be a packed dict: its rows
    are gathered before they are dequantized, which gives the bf16 values
    of dequantizing the whole table first without writing that table.

    With a model ``group`` the table is the rank's block of vocabulary rows
    (vocab-parallel): an id outside them reads row 0 and is zeroed, and the
    rows are summed over the model ranks (one rank holds each id's, so the
    sum is exact); the backward is each rank's own rows."""
    idx = ids.to(torch.long)
    inside = None
    if group is not None:
        rows = (table["q8"] if fxp.is_packed(table) else table).shape[0]
        idx = idx - group.index * rows
        inside = (idx >= 0) & (idx < rows)
        idx = torch.where(inside, idx, 0)
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
    if inside is not None:
        out = group.reduce(torch.where(inside[..., None], out,
                                       torch.zeros((), dtype=out.dtype,
                                                   device=out.device)))
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

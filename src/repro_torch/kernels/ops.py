"""Dispatch over the port's kernels (counterpart of ``repro/kernels/ops.py``):
the fxp matmul, the model's differentiable dense layers (over int8 words,
and the quantize prologue over the f32 master) and attention, the
stochastic-rounding words (int8, and grid values in a float container) and
PushDown's EDF ladder; and the three kernels only this module reaches, as
in the reference: the SR quantize with the noise given (``sr_quantize``),
the W8A8 matmul (``int8_matmul``, differentiable into its two scales) and
the KL double histogram (``kl_hist``).

The rule, by the device of the tensor each op is given:

* a CPU tensor → the plain PyTorch version (``kernels/ref.py``);
* a CUDA tensor → the hand-written kernel, which raises unless the device
  has compute capability 9.0.

There is no fallback from the kernel to the plain version and no switch to
force one. ``use_pallas`` keeps the reference's meaning: ``False`` is the
plain XLA-style path (dequantize-then-matmul, masked attention) on any
device. Under ``use_pallas``, ``fxp_dense``, ``fxp_qdense`` and
``attention`` are ``torch.autograd.Function``s whose backward passes are
kernels too (dx/dw for the dense layers, dq/dkv for attention), as the
reference's custom VJPs are (``fxp_matmul.py:556-630``,
``flash_attention.py:419-453``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import edf_ladder as _el
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fxp_matmul as _fm
from repro_torch.kernels import int8_matmul as _im
from repro_torch.kernels import kl_hist as _kh
from repro_torch.kernels import ref
from repro_torch.kernels import sr_quantize as _sq
from repro_torch.kernels.sr_quantize import fold_shard_seed


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise RuntimeError(f"repro_torch kernels run on CUDA or, as their plain "
                       f"versions, on the CPU; got a tensor on {t.device}")


def fxp_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
               use_pallas: bool = False, bias: torch.Tensor | None = None,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = x @ (wq * scale) (+ bias), f32 accumulation, any ⟨M,K,N⟩.
    Forward only (the reference differentiates it into dscale, which no
    path of the port uses)."""
    if use_pallas and _on_card(x):
        out = _fm.fxp_matmul(x, wq, scale.reshape(()), out_dtype=out_dtype)
        return out if bias is None else out + bias
    return ref.ref_fxp_matmul(x, wq, scale, bias, out_dtype=out_dtype)


class _FxpDense(torch.autograd.Function):
    """Straight-through dense layer over int8 words: forward
    y = (x @ wq)·scale; backward dx = (dy @ wqᵀ)·scale on the same words
    and dw = xᵀ @ dy, which lands whole on ``wref`` in wref's dtype (bf16,
    rounded to nearest even, as ``_fxp_dense_diff_bwd`` casts it). The
    scale is controller state: its gradient is zero; the words get none."""

    @staticmethod
    def forward(ctx, x, wq, scale, wref, out_dtype):
        ctx.save_for_backward(x, wq, scale)
        ctx.wref_dtype = wref.dtype
        if _on_card(x):
            return _fm.fxp_matmul(x, wq, scale, out_dtype=out_dtype)
        return ref.ref_fxp_matmul(x, wq, scale, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, wq, scale = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = dscale = None
        card = _on_card(dy)
        if ctx.needs_input_grad[0]:
            dx = (_fm.matmul_dx(dy, wq, scale, out_dtype=x.dtype) if card
                  else ref.ref_matmul_dx(dy, wq, scale).to(x.dtype))
        if ctx.needs_input_grad[3]:
            dw = (_fm.matmul_dw(x, dy, out_dtype=ctx.wref_dtype) if card
                  else ref.ref_matmul_dw(x, dy).to(ctx.wref_dtype))
        if ctx.needs_input_grad[2]:
            dscale = torch.zeros_like(scale)
        return dx, None, dscale, dw, None


def fxp_dense(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
              wref: torch.Tensor, *, use_pallas: bool = False,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The model's dense layer over materialized int8 words (the packed
    ⟨q8, sc, wref⟩ container), differentiable with the straight-through
    weight gradient onto ``wref``. x: (M, K); wq: (K, N) int8; scale: one
    element (2^-FL). Without ``use_pallas`` it is the f32
    dequant-then-dot the kernels replace, differentiated by autograd."""
    if use_pallas:
        return _FxpDense.apply(x.contiguous(), wq, scale.reshape(()), wref,
                               out_dtype or x.dtype)
    wv = (wq.to(torch.float32) * scale.detach().to(torch.float32).reshape(())
          + wref.to(torch.float32))
    out = torch.matmul(x.to(torch.float32), wv)
    return out.to(out_dtype or x.dtype)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the recompute backward: the forward stashes
    (o, lse), the backward is ``flash_attention_bwd`` (the dQ and dK/dV
    kernels on the card, their plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        fwd = _fa.flash_attention if _on_card(q) else ref.ref_flash_attention
        o, lse = fwd(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = (_fa.flash_attention_bwd if _on_card(q)
               else ref.ref_flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: float | None = None, use_pallas: bool = False
              ) -> torch.Tensor:
    """Attention over (B, S, H, D) tensors. With ``use_pallas``: the flash
    contract (a row that no key reaches is 0), differentiable through the
    flash backward; on the card the CUDA kernels. Without it:
    ``ref_attention`` under autograd."""
    if use_pallas:
        return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal, window, softcap,
                                     scale)
    return ref.ref_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)


def sr_quantize(x: torch.Tensor, u: torch.Tensor, wl, fl, *,
                use_pallas: bool = False) -> torch.Tensor:
    """⟨WL,FL⟩ SR grid values of x with the U[0,1) noise ``u`` given, in
    x's dtype (``repro/kernels/ops.py:28``). With ``use_pallas`` the kernel
    on the card (scalar ⟨wl, fl⟩), its plain version on the CPU; without
    it the plain version on any device, ⟨wl, fl⟩ broadcast against x."""
    if use_pallas:
        return _sq.sr_quantize(x.contiguous(), u.to(torch.float32).contiguous(),
                               wl, fl)
    return ref.ref_sr_quantize(x, u, wl, fl)


def _stacked_shape(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An (L,) precision as (L, 1, ...) against the stacked x."""
    return p.reshape(tuple(p.shape) + (1,) * (x.ndim - 1))


def _fused_sharded(x: torch.Tensor, seed, extras, extra_lead, call,
                   sharding) -> torch.Tensor:
    """``call(x, seed', *extras')`` on the rank's block ``x`` of a leaf
    laid out by ``sharding`` (``repro/kernels/ops.py:40-76``): the seed is
    folded with the linear shard index, the axes the spec names in dim order
    (``distributed.shard_index``), so the words of the whole leaf are a
    function of ⟨seed, layout⟩ alone, and replicas along the other axes draw
    the same ones. A spec that names axes of size 1 still folds (index 0:
    fold_shard_seed(seed, 0) != seed). ``extra_lead[i]`` marks extras[i] as
    an (L,) precision of the leaf's leading dim, of which the block takes
    its own rows; other extras are scalars. A column block is not
    contiguous in memory: the kernel is given a contiguous copy. The
    caller has checked that the spec divides the leaf (``shard_grid``)."""
    from repro_torch import distributed as dst
    from repro_torch.sharding import folded_axes, spec_dim_axes
    spec, mesh = sharding.spec, sharding.mesh
    if not folded_axes(spec, x.ndim):
        return call(x, seed, *extras)
    if mesh.coords is None:
        raise ValueError("sharding= needs a rank's mesh (mesh.coords)")
    idx = dst.shard_index(spec, mesh, x.ndim)
    seed_loc = int(fold_shard_seed(seed, idx))
    lead = 0
    for a in spec_dim_axes(spec, x.ndim)[0]:
        lead = lead * mesh.shape[a] + mesh.coords[a]
    b0 = x.shape[0]
    locs = [e[lead * b0:(lead + 1) * b0] if is_lead else e
            for e, is_lead in zip(extras, extra_lead)]
    return call(x.contiguous(), seed_loc, *locs)


def _no_sharded_fallback(name: str, sharding) -> None:
    if sharding is not None:
        raise ValueError(f"{name}: sharding= requires use_pallas=True (the "
                         "jax.random fallback draws the noise of the whole "
                         "leaf; use the noise path instead)")


def sr_quantize_fused_int8(x: torch.Tensor, seed, fl, *,
                           use_pallas: bool = False,
                           sharding=None) -> torch.Tensor:
    """int8 SR words of the f32 master (dequant = q8·2^-FL at the
    consumer): an (L,) FL selects the stacked kernel (layer l at fl[l], one
    launch), a scalar FL the flat one, as ``repro/kernels/ops.py:129-160``
    does, with the noise drawn in the kernel. ``seed`` is a host int.
    ``sharding`` (a ``sharding.NamedSharding`` on a rank's mesh): ``x`` is
    the rank's block and is quantized with the per-shard seed
    (``_fused_sharded``). Without ``use_pallas`` the reference's jax.random
    oracle: the noise is ``jax.random.uniform(PRNGKey(seed), x.shape)``
    (``core/threefry.py``)."""
    fl = torch.as_tensor(fl, dtype=torch.int32, device=x.device)
    if not use_pallas:
        _no_sharded_fallback("sr_quantize_fused_int8", sharding)
        return ref.ref_sr_quantize_fused_int8(
            x, seed, _stacked_shape(fl, x) if fl.ndim else fl)
    stacked = bool(fl.ndim)

    def call(xv, sv, flv):
        if stacked:
            return _sq.sr_quantize_fused_stacked_int8(xv, sv, flv)
        return _sq.sr_quantize_fused_int8(xv, sv, flv)

    if sharding is not None:
        return _fused_sharded(x, seed, (fl,), (stacked,), call, sharding)
    return call(x, seed, fl)


def sr_quantize_fused(x: torch.Tensor, seed, wl, fl, *,
                      use_pallas: bool = False,
                      out_dtype: torch.dtype = torch.float32,
                      sharding=None) -> torch.Tensor:
    """SR grid values of the f32 master on ⟨WL,FL⟩ in ``out_dtype`` (f32,
    or bf16 rounded to nearest even): an (L,) ⟨WL,FL⟩ selects the stacked
    kernel (layer l at ⟨wl[l], fl[l]⟩, one launch), a scalar the flat one
    (``repro/kernels/ops.py:79-126``), with the noise drawn in the kernel.
    ``seed`` is a host int. ``sharding``: as for
    ``sr_quantize_fused_int8``. Without ``use_pallas`` the reference's
    jax.random oracle (noise ``jax.random.uniform(PRNGKey(seed),
    x.shape)``)."""
    wl = torch.as_tensor(wl, dtype=torch.int32, device=x.device)
    fl = torch.as_tensor(fl, dtype=torch.int32, device=x.device)
    if not use_pallas:
        _no_sharded_fallback("sr_quantize_fused", sharding)
        if wl.ndim:
            wl, fl = _stacked_shape(wl, x), _stacked_shape(fl, x)
        return ref.ref_sr_quantize_fused(x, seed, wl, fl).to(out_dtype)
    stacked = bool(wl.ndim)

    def call(xv, sv, wlv, flv):
        if stacked:
            return _sq.sr_quantize_fused_stacked(xv, sv, wlv, flv,
                                                 out_dtype=out_dtype)
        return _sq.sr_quantize_fused(xv, sv, wlv, flv, out_dtype=out_dtype)

    if sharding is not None:
        return _fused_sharded(x, seed, (wl, fl), (stacked, stacked), call,
                              sharding)
    return call(x, seed, wl, fl)


class _Int8Matmul(torch.autograd.Function):
    """The W8A8 product differentiated into its scales
    (``_int8_matmul_diff``, ``fxp_matmul.py:510-534``): the backward reruns
    the kernel at unit scale for the raw sums, g0 = Σ dy·acc in f32,
    dsx = g0·sw and dsw = g0·sx in the scales' shapes and dtypes; the words
    get no gradient."""

    @staticmethod
    def forward(ctx, xq, wq, sx, sw):
        ctx.save_for_backward(xq, wq, sx, sw)
        s = (sx.to(torch.float32) * sw.to(torch.float32)).reshape(())
        return _im.int8_matmul(xq, wq, s)

    @staticmethod
    def backward(ctx, dy):
        xq, wq, sx, sw = ctx.saved_tensors
        one = torch.ones((), dtype=torch.float32, device=xq.device)
        acc = _im.int8_matmul(xq, wq, one)
        g0 = torch.sum(dy.to(torch.float32) * acc)
        dsx = (g0 * sw.to(torch.float32)).reshape(sx.shape).to(sx.dtype)
        dsw = (g0 * sx.to(torch.float32)).reshape(sw.shape).to(sw.dtype)
        return None, None, dsx, dsw


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, sx, sw, *,
                use_pallas: bool = False) -> torch.Tensor:
    """W8A8: f32 (xq @ wq)·sx·sw for int8 words xq (M, K), wq (K, N), any
    ⟨M, K, N⟩ (``repro/kernels/ops.py:198``). With ``use_pallas`` the
    kernel (its plain version on the CPU) at s = f32(sx)·f32(sw), one-element
    scales, differentiable into sx and sw; without it the reference's
    oracle (acc·sx·sw, two roundings, scales that broadcast), under
    autograd."""
    if use_pallas:
        dev = xq.device
        return _Int8Matmul.apply(xq.contiguous(), wq.contiguous(),
                                 torch.as_tensor(sx, device=dev),
                                 torch.as_tensor(sw, device=dev))
    return ref.ref_int8_matmul(xq, wq, sx, sw)


def kl_hist(w: torch.Tensor, q: torch.Tensor, num_bins: int = 256, *,
            use_pallas: bool = False) -> torch.Tensor:
    """f32 counts (2, num_bins) of w and its quantized copy q over w's
    [min, max] (``repro/kernels/ops.py:245``). With ``use_pallas`` the
    kernel's formula (the kernel on the card, its plain version on the
    CPU); without it the reference's jnp oracle, which divides by the span
    and counts a NaN bin in bin 0."""
    if use_pallas:
        return _kh.kl_hist(w, q, num_bins)
    return ref.ref_kl_hist(w, q, num_bins)


class _FxpQDense(torch.autograd.Function):
    """The quantize-prologue dense layer (``fxp_qdense_vjp``): forward
    y = (x @ Q(w))·2^-fl with the words drawn from the master ``w`` in
    registers; backward dx = (dy @ Q(w)ᵀ)·2^-fl on the same words and the
    straight-through dw = xᵀ @ dy in f32, onto the master itself. Seed, FL
    and mode get no gradient."""

    @staticmethod
    def forward(ctx, x, w, seed, fl, mode, out_dtype):
        ctx.save_for_backward(x, w, fl)
        ctx.seed, ctx.mode = seed, mode
        if _on_card(x):
            return _fm.fxp_qmatmul(x, w, seed, fl, mode, out_dtype=out_dtype)
        return ref.ref_fxp_qdense(x, w, seed, fl, mode, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, fl = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        card = _on_card(dy)
        if ctx.needs_input_grad[0]:
            dx = (_fm.matmul_qdx(dy, w, ctx.seed, fl, ctx.mode,
                                 out_dtype=x.dtype) if card
                  else ref.ref_matmul_qdx(dy, w, ctx.seed, fl, ctx.mode,
                                          out_dtype=x.dtype))
        if ctx.needs_input_grad[1]:
            dw = (_fm.matmul_dw(x, dy) if card
                  else ref.ref_matmul_dw(x, dy)).to(w.dtype)
        return dx, dw, None, None, None, None


def fxp_qdense(x: torch.Tensor, w: torch.Tensor, seed, fl, mode, *,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The quantize-prologue dense layer (``repro/kernels/ops.py:225``):
    x (M, K) against the f32 master ``w`` (K, N), whose ⟨8,FL⟩ words are
    drawn inside the matmul (mode 1 SR with the portable stream of index
    k·N + n, mode 0 round to nearest); the words never exist in device
    memory. ``seed`` and ``mode`` are host ints, ``fl`` a one-element
    tensor. A prologue leaf exists only under ``use_pallas``, so there is
    no plain-XLA branch: the kernels on the card, their plain versions on
    the CPU."""
    return _FxpQDense.apply(x.contiguous(), w, int(seed), fl.reshape(()),
                            int(mode), out_dtype or x.dtype)


def qdense_words(w: torch.Tensor, seed, fl, mode) -> torch.Tensor:
    """The prologue's int8 words of a 2-D master slice, materialized (the
    value view of the regularizer): mode 1 through the SR int8 kernel
    (``sr_quantize_fused_int8``, whose words are the prologue's for a 2-D
    leaf; its plain version on the CPU), mode 0 rounded to nearest."""
    if int(mode) == 1:
        return _sq.sr_quantize_fused_int8(w, int(seed), fl)
    return ref.ref_qdense_words(w, seed, fl, 0)


def edf_ladder_hists(w: torch.Tensor, fls: torch.Tensor, r, *,
                     wl_ladder: tuple, r_upr: int,
                     use_pallas: bool = False) -> torch.Tensor:
    """Master + per-WL-candidate histograms in one data pass: w (L, n),
    fls (L, T) and r (L,) give (L, 1+T, r_upr), one layer of the
    reference's vmap per row. With ``use_pallas`` the kernel (its plain
    version on the CPU), otherwise the plain version on any device."""
    r = torch.as_tensor(r, dtype=torch.int32, device=w.device).reshape(-1)
    w = w.to(torch.float32).contiguous()
    fn = _el.edf_ladder_hists if use_pallas else ref.ref_edf_ladder_hists
    return fn(w, fls, r, wl_ladder=wl_ladder, r_upr=r_upr)

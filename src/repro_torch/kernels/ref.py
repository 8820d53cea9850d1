"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

Each ``ref_*`` function is the semantic ground truth its CUDA kernel is held
against: the CPU tests compare these with the JAX reference, and
``chip_smoke.py`` compares the kernels with these on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import threefry
from repro_torch.core.fixed_point import pow2i

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# The portable counter-hash stream of the fused SR quantize kernels, a
# contract pinned by ``tests/golden/sr_prng_stream.json``: for element
# ``idx`` of a tensor, the murmur3 finalizer of ``idx + seed·0x9E3779B9``
# (uint32 arithmetic) gives u = (h >> 8)·2^-24. torch has no uint32
# arithmetic on the CPU, so these run in int64 and mask to 32 bits after
# every step; a product with a 32-bit constant is split into its 16-bit
# halves so that it stays below 2^63.

FUSED_LANES = 512          # the fused kernels' padded row width
_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2^32 for int64 h in [0, 2^32), in place on ``h``."""
    hi = h * (c >> 16)
    hi.bitwise_and_(0xFFFF).bitwise_left_shift_(16)
    return h.mul_(c & 0xFFFF).add_(hi).bitwise_and_(_M32)


def _u32(v) -> int:
    """An int32 (or any int) as the uint32 of the same low 32 bits."""
    return int(v) & _M32


def _mix(h: torch.Tensor) -> torch.Tensor:
    """The rounds both hashes share, in place: h ^= h >> 16;
    h *= 0x7FEB352D; h ^= h >> 15."""
    h.bitwise_xor_(h >> 16)
    _mul32(h, 0x7FEB352D)
    return h.bitwise_xor_(h >> 15)


def _uniform(seed, h: torch.Tensor) -> torch.Tensor:
    """U[0,1) f32 of the int64 indices ``h`` in [0, 2^32), hashed in place:
    h += seed·0x9E3779B9, the finalizer, u = (h >> 8)·2^-24."""
    h.add_((_u32(seed) * 0x9E3779B9) & _M32).bitwise_and_(_M32)
    _mix(h)
    _mul32(h, 0x846CA68B)
    h.bitwise_xor_(h >> 16)
    return (h >> 8).to(torch.float32).mul_(1.0 / (1 << 24))


def ref_fused_noise(seed, n: int, offset: int = 0, *,
                    device=None) -> torch.Tensor:
    """U[0,1) f32 words the fused kernels draw for flat padded elements
    [offset, offset + n) (``repro/kernels/ref.py:71``)."""
    h = torch.arange(n, dtype=torch.int64, device=device)
    return _uniform(seed, h.add_(_u32(offset)).bitwise_and_(_M32))


def ref_fold_shard_seed(seed, idx) -> torch.Tensor:
    """Per-shard seed fold (``repro/kernels/ref.py:85``): int32 in and
    out, the bit pattern of the mixed uint32. ``seed`` and ``idx`` are
    ints or int tensors (broadcast)."""
    s = torch.as_tensor(idx, dtype=torch.int64).bitwise_and(_M32)
    _mul32(s, 0x9E3779B9)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=s.device)
    s.add_(seed.bitwise_and(_M32)).bitwise_and_(_M32)
    _mix(s)
    return torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.int32)


def _sr_int8(x: torch.Tensor, u: torch.Tensor, fl) -> torch.Tensor:
    """clip(floor(x·2^fl) + [u < frac], −128, 127) as int8."""
    s = x.to(torch.float32) * pow2i(fl).to(x.device)
    f = torch.floor(s)
    q = f + (u < (s - f)).to(torch.float32)
    return q.clamp_(-128.0, 127.0).to(torch.int8)


# Elements of a plain SR pass on the CPU at a time: a chunk's int64 hash
# temporaries (8 MiB each) stay in the caches, which makes the pass about
# four times faster than over a whole layer. The bits do not depend on it;
# on the card a pass takes the whole layer.
_CPU_CHUNK = 1 << 20


def _sr_by_chunks(x: torch.Tensor, seed, offset: int, rnd, out: torch.Tensor
                  ) -> torch.Tensor:
    """``out`` (contiguous, x's number of elements) with element i the
    rounding ``rnd(x_i, u)`` of x's flat element i by the noise u of index
    offset + i."""
    xf, of = x.reshape(-1), out.view(-1)
    n = xf.numel()
    step = _CPU_CHUNK if x.device.type == "cpu" else max(n, 1)
    for s in range(0, n, step):
        e = min(n, s + step)
        of[s:e] = rnd(xf[s:e], ref_fused_noise(seed, e - s, offset=offset + s,
                                               device=x.device))
    return out


def ref_sr_quantize_fused_int8_words(x: torch.Tensor, seed, fl
                                     ) -> torch.Tensor:
    """Plain version of ``sr_quantize_fused_int8`` (the words of the
    portable stream, ``repro/kernels/ref.py:104``): element i of the flat
    tensor takes the noise of index i."""
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    return _sr_by_chunks(x, seed, 0, lambda xs, u: _sr_int8(xs, u, fl), out)


def _stacked_stride(x: torch.Tensor) -> tuple[int, int]:
    """(elements of one layer, the padded plane's stride rows·512)."""
    n = x[0].numel()
    return n, -(-n // FUSED_LANES) * FUSED_LANES


def ref_sr_quantize_fused_stacked_int8_words(x: torch.Tensor, seed,
                                             fl: torch.Tensor
                                             ) -> torch.Tensor:
    """Plain version of ``sr_quantize_fused_stacked_int8``
    (``repro/kernels/ref.py:163``): layer l at FL ``fl[l]``, noise from
    flat offset l·rows·512 of the shared stream. One layer at a time, so
    the int64 hash temporaries stay one layer's size."""
    n, stride = _stacked_stride(x)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    for l in range(x.shape[0]):
        _sr_by_chunks(x[l], seed, l * stride,
                      lambda xs, u: _sr_int8(xs, u, fl[l]), out[l])
    return out


def _sr_grid(x: torch.Tensor, u: torch.Tensor, wl, fl) -> torch.Tensor:
    """SR onto the ⟨WL,FL⟩ grid in f32 (``repro/kernels/ref.py:22``):
    s = x·2^fl, q = floor(s) + [u < frac], clipped to [−qmax − 1, qmax]
    with qmax = 2^(wl−1) − 1 rounded to f32, then q / 2^fl (a division,
    as the reference's)."""
    scale = pow2i(fl).to(x.device)
    qmax = pow2i(torch.as_tensor(wl) - 1).to(x.device) - 1.0
    s = x.to(torch.float32) * scale
    f = torch.floor(s)
    q = f + (u < (s - f)).to(torch.float32)
    return torch.clamp(q, -qmax - 1.0, qmax).div_(scale)


def ref_sr_quantize_fused_words(x: torch.Tensor, seed, wl, fl, *,
                                out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of ``sr_quantize_fused`` (the portable stream's grid
    values, ``repro/kernels/ref.py:97``): element i of the flat tensor
    takes the noise of index i; the f32 result cast to ``out_dtype``
    (round to nearest even)."""
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    return _sr_by_chunks(x, seed, 0, lambda xs, u: _sr_grid(xs, u, wl, fl),
                         out)


def ref_sr_quantize_fused_stacked_words(x: torch.Tensor, seed, wl, fl, *,
                                        out_dtype=torch.float32
                                        ) -> torch.Tensor:
    """Plain version of ``sr_quantize_fused_stacked``
    (``repro/kernels/ref.py:150``): layer l on the ⟨wl[l], fl[l]⟩ grid,
    noise from flat offset l·rows·512 of the shared stream, one layer at a
    time."""
    n, stride = _stacked_stride(x)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    for l in range(x.shape[0]):
        _sr_by_chunks(x[l], seed, l * stride,
                      lambda xs, u: _sr_grid(xs, u, wl[l], fl[l]), out[l])
    return out


def ref_sr_quantize_fused_sharded_words(x: torch.Tensor, seed, wl, fl,
                                        grid: tuple, *, int8: bool = False,
                                        out_dtype=torch.float32
                                        ) -> torch.Tensor:
    """Plain version of the sharded fused quantize, assembled in one
    process (``repro/kernels/ref.py:177``): ``grid[d]`` equal blocks along
    dim d; block b, row-major over ``grid`` (the wrapper's fold order),
    quantized with seed ``ref_fold_shard_seed(seed, b)`` and its own local
    stream. ``wl``/``fl`` scalars or (L,) vectors (a stacked leaf, whose
    dim-0 blocks take their rows of them); ``wl`` is unused for ``int8``
    words."""
    import itertools
    blocks = [s // g for s, g in zip(x.shape, grid)]
    fl = torch.as_tensor(fl, dtype=torch.int32)
    wl = torch.as_tensor(wl, dtype=torch.int32)
    stacked = bool(fl.ndim)
    out = torch.empty(x.shape, dtype=torch.int8 if int8 else out_dtype,
                      device=x.device)
    for lin, coords in enumerate(itertools.product(*[range(g)
                                                     for g in grid])):
        sl = tuple(slice(c * b, (c + 1) * b) for c, b in zip(coords, blocks))
        s = int(ref_fold_shard_seed(seed, lin))
        blk = x[sl].contiguous()
        if int8:
            q = (ref_sr_quantize_fused_stacked_int8_words(blk, s, fl[sl[0]])
                 if stacked else ref_sr_quantize_fused_int8_words(blk, s, fl))
        else:
            q = (ref_sr_quantize_fused_stacked_words(
                blk, s, wl[sl[0]], fl[sl[0]], out_dtype=out_dtype)
                 if stacked else ref_sr_quantize_fused_words(
                     blk, s, wl, fl, out_dtype=out_dtype))
        out[sl] = q
    return out


# ---------------------------------------------------------------------------
# The quantize prologue: int8 words drawn from the f32 master inside the
# matmul. Element (k, n) of a (K, N) master hashes its flat index k·N + n,
# so for a 2-D leaf the SR words are ``sr_quantize_fused_int8``'s.


def ref_qdense_words(w: torch.Tensor, seed, fl, mode) -> torch.Tensor:
    """Plain version of the prologue's word draw (``repro/kernels/ref.py:113``):
    ``mode`` 1 rounds stochastically with the portable stream, 0 to
    nearest (half to even); clipped to [−128, 127], int8."""
    if int(mode) == 1:
        return ref_sr_quantize_fused_int8_words(w, seed, fl)
    s = w.to(torch.float32) * pow2i(fl).to(w.device)
    return s.round_().clamp_(-128.0, 127.0).to(torch.int8)


def ref_fxp_qdense(x: torch.Tensor, w: torch.Tensor, seed, fl, mode, *,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of the prologue matmul (``repro/kernels/ref.py:131``):
    y = (x @ Q⟨8,fl⟩(w))·2^-fl with f32 accumulation, x's dtype out."""
    words = ref_qdense_words(w, seed, fl, mode).to(torch.float32)
    acc = torch.matmul(x.to(torch.float32), words)
    return (acc * pow2i(-torch.as_tensor(fl)).to(x.device)).to(
        out_dtype or x.dtype)


def ref_matmul_qdx(dy: torch.Tensor, w: torch.Tensor, seed, fl, mode, *,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of the prologue's dx: (dy @ Q⟨8,fl⟩(w)ᵀ)·2^-fl, the
    same words as the forward, f32 accumulation, dy's dtype out."""
    words = ref_qdense_words(w, seed, fl, mode).to(torch.float32)
    acc = torch.matmul(dy.to(torch.float32), words.T)
    return (acc * pow2i(-torch.as_tensor(fl)).to(dy.device)).to(
        out_dtype or dy.dtype)


def _edf_bins(v: torch.Tensor, lo, span, rf) -> torch.Tensor:
    """Bin of each value, clip(floor((v − lo) / span · r), 0, r − 1) in
    f32 in the reference's expression order; NaN where that is NaN."""
    t = torch.floor((v - lo) / span * rf)
    return torch.minimum(torch.maximum(t, torch.zeros_like(t)), rf - 1)


def ref_edf_ladder_hists(w: torch.Tensor, fls: torch.Tensor, r: torch.Tensor,
                         *, wl_ladder: tuple, r_upr: int) -> torch.Tensor:
    """Plain version of the EDF-ladder kernel, batched over layers.

    w: (L, n) f32 subsampled weights; fls: (L, T) int32 per-candidate FLs;
    r: (L,) int32 live bins. Returns f32 counts (L, 1+T, r_upr): row 0 the
    master's histogram, row 1+t that of w rounded to nearest (half to
    even) on ⟨wl_ladder[t], fls[t]⟩, all over each layer's own [min, max]
    with r live bins.

    As ``repro/kernels/ref.py:207``, except for an element whose bin is NaN
    (``hi − lo`` overflows to inf): the Pallas kernel counts it in no row,
    and so does this function, while the reference's jnp oracle converts
    the NaN to bin 0 (XLA's float→int conversion) and counts it there."""
    L, n = w.shape
    T = len(wl_ladder)
    wf = w.to(torch.float32)
    lo = wf.amin(dim=1, keepdim=True)
    hi = wf.amax(dim=1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    rf = r.to(torch.float32).reshape(L, 1)
    rows = [_edf_bins(wf, lo, span, rf)]
    for t, wl in enumerate(wl_ladder):
        scale = pow2i(fls[:, t]).reshape(L, 1)
        qmax = torch.tensor(2.0 ** (wl - 1) - 1.0, dtype=torch.float32)
        qmin = -qmax - 1.0
        q = torch.clamp(torch.round(wf * scale), qmin.item(), qmax.item())
        rows.append(_edf_bins(q / scale, lo, span, rf))
    bins = torch.stack(rows, dim=1)                            # (L, 1+T, n)
    live = ~torch.isnan(bins)
    flat = torch.where(live, bins, 0.0).to(torch.int64)
    flat += (torch.arange(L * (1 + T), device=w.device) * r_upr
             ).reshape(L, 1 + T, 1)
    counts = torch.zeros(L * (1 + T) * r_upr, dtype=torch.float32,
                         device=w.device)
    counts.index_add_(0, flat.reshape(-1), live.reshape(-1).to(torch.float32))
    return counts.reshape(L, 1 + T, r_upr)


def ref_fxp_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor | None = None, *,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x @ (wq * scale) with f32 accumulation, the scale applied in f32.

    x: (M, K) float; wq: (K, N) int8 fixed-point words; scale: () or (N,).
    ``out_dtype`` defaults to x's dtype."""
    acc = torch.matmul(x.to(torch.float32), wq.to(torch.float32))
    out = acc * scale.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(out_dtype or x.dtype)


def _attention_logits(q, k, *, causal, window, softcap, scale):
    """(B, H, Sq, Skv) f32 logits with the mask applied (-1e30) and the
    (Sq, Skv) mask itself. Queries are end-aligned: q_offset = Skv − Sq."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
    sc = scale if scale is not None else (1.0 / D ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * sc
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return torch.where(mask[None, None], logits, NEG_INF), mask


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: float | None = None) -> torch.Tensor:
    """Multi-head attention oracle, as ``repro.kernels.ref.ref_attention``:
    a row that no key reaches softmaxes into a uniform average.

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D). GQA via head-group broadcast."""
    rep = q.shape[2] // k.shape[2]
    logits, _ = _attention_logits(q, k, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    p = torch.softmax(logits, dim=-1)
    vr = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.to(torch.float32))
    return out.to(q.dtype)


def ref_attention_lse(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, scale: float | None = None
                      ) -> torch.Tensor:
    """Per-row logsumexp (B, H, Sq) f32 of the masked (softcapped) logits."""
    logits, _ = _attention_logits(q, k, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    return torch.logsumexp(logits, dim=-1)


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float | None = None,
                        return_lse: bool = False):
    """Plain version of the flash kernel: :func:`ref_attention` computed in
    f32, except that a row that no key reaches (Sq > Skv under causal
    end-alignment, or a window past every key) is exactly 0 with
    lse = -1e30, the kernel's convention (``flash_attention.py:126-139``
    of the reference). Output in q's dtype; lse (B, H, Sq) f32."""
    rep = q.shape[2] // k.shape[2]
    logits, mask = _attention_logits(q, k, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    dead = ~mask.any(dim=-1)                                   # (Sq,)
    p = torch.softmax(logits, dim=-1)
    vr = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.to(torch.float32))
    out = torch.where(dead[None, :, None, None], 0.0, out).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(dead[None, None, :], NEG_INF,
                      torch.logsumexp(logits, dim=-1))
    return out, lse


# ---------------------------------------------------------------------------
# Backward oracles (counterparts of the reference's ``ref_matmul_dx``,
# ``ref_matmul_dw`` and ``ref_attention_grads``), and the plain version of
# the flash backward kernels.


def ref_matmul_dx(dy: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor
                  ) -> torch.Tensor:
    """dx = dy @ (wq·scale)ᵀ, f32 accumulation, dy's dtype out."""
    acc = torch.matmul(dy.to(torch.float32), wq.to(torch.float32).T)
    return (acc * scale.to(torch.float32)).to(dy.dtype)


def ref_matmul_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw = xᵀ @ dy in f32."""
    return torch.matmul(x.to(torch.float32).T, dy.to(torch.float32))


def ref_attention_grads(q, k, v, dy, **kwargs):
    """(dq, dk, dv) by autograd of :func:`ref_attention`."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = ref_attention(*leaves, **kwargs)
        return torch.autograd.grad(out, leaves, dy)


def _flash_bwd_terms(q, k, v, do, lse, delta, causal, window, softcap,
                     scale):
    """What both backward kernels recompute from the stashed lse, in f32:
    p = exp(t − lse) under the mask (exactly 0 where the mask admits no
    key) and dt = p∘(dp − D) through the softcap chain, (B, H, Sq, Skv);
    with q, do, the kv heads repeated to H, and the softmax scale."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    rep = H // Hkv
    sc = scale if scale is not None else 1.0 / D ** 0.5
    f32 = torch.float32
    qf, dof = q.to(f32), do.to(f32)
    kf, vf = k.to(f32), v.to(f32)
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sc
    t = softcap * torch.tanh(s / softcap) if softcap > 0.0 else s
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    # the mask goes in before the exp: lse = -1e30 on a row that reaches
    # no key, where exp(t - lse) would overflow
    p = torch.exp(torch.where(mask[None, None], t - lse[..., None], NEG_INF))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    g = p * (dp - delta[..., None])
    if softcap > 0.0:
        g = g * (1.0 - torch.square(t / softcap))
    return p, g, qf, kf, dof, sc


def ref_flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: int = 0, softcap: float = 0.0,
                           scale: float | None = None) -> torch.Tensor:
    """dQ as the dQ kernel computes it from (lse, D = Σ do∘o): q/do
    (B, Sq, H, D), k/v (B, Skv, Hkv, D), lse/delta (B, H, Sq) f32. dq in
    q's dtype."""
    _, g, _, kf, _, sc = _flash_bwd_terms(q, k, v, do, lse, delta, causal,
                                          window, softcap, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", g, kf) * sc).to(q.dtype)


def ref_flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0,
                            scale: float | None = None):
    """dK, dV as the dK/dV kernel computes them, the rep query heads of
    each GQA group summed; inputs as :func:`ref_flash_attention_dq`.
    dk/dv in k's and v's dtype."""
    B, Skv, Hkv, D = k.shape
    rep = q.shape[2] // Hkv
    p, g, qf, _, dof, sc = _flash_bwd_terms(q, k, v, do, lse, delta,
                                            causal, window, softcap, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", g, qf) * sc
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Skv, Hkv, rep, D).sum(3)
    dv = dv.reshape(B, Skv, Hkv, rep, D).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def ref_flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0,
                            scale: float | None = None):
    """dQ/dK/dV of :func:`ref_flash_attention` from its stashed (o, lse), as
    the reference's ``flash_attention_bwd`` computes them: D = Σ do∘o in
    f32, then :func:`ref_flash_attention_dq` and
    :func:`ref_flash_attention_dkv`, each recomputing p under the mask (so
    a row that reaches no key gives dq = 0 and nothing to dK/dV), as the
    two kernels do. Returns (dq, dk, dv) in the inputs' dtypes."""
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
    delta = delta.permute(0, 2, 1)                             # (B, H, Sq)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    dq = ref_flash_attention_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *ref_flash_attention_dkv(q, k, v, do, lse, delta, **kw))


# ---------------------------------------------------------------------------
# The kernels only ``kernels/ops`` reaches: the SR quantize with given noise,
# the W8A8 int8 matmul and the KL double histogram; and the reference's
# jax.random oracles of the fused SR quantize.


def ref_sr_quantize(x: torch.Tensor, u: torch.Tensor, wl, fl
                    ) -> torch.Tensor:
    """⟨WL,FL⟩ stochastic-rounding quantize with the noise ``u`` given
    (``repro/kernels/ref.py:23-33``): s = f32(x)·2^fl, q = floor(s) +
    [u < s − floor(s)] clipped to [−qmax − 1, qmax] with qmax = 2^(wl−1) − 1
    rounded to f32, then q / 2^fl in f32, cast to x's dtype. ⟨wl, fl⟩ are
    ints or int tensors that broadcast against x (2^e is exact for e in
    [−126, 127], as the reference's ``ldexp``). Also the plain version of
    the ``sr_quantize`` kernel, which takes scalar ⟨wl, fl⟩."""
    dev = x.device
    scale = pow2i(torch.as_tensor(fl, device=dev))
    qmax = pow2i(torch.as_tensor(wl, device=dev) - 1) - 1.0
    s = x.to(torch.float32) * scale
    f = torch.floor(s)
    q = f + (u.to(torch.float32) < (s - f)).to(torch.float32)
    q = torch.minimum(torch.maximum(q, -qmax - 1.0), qmax)
    return (q / scale).to(x.dtype)


def ref_sr_quantize_fused(x: torch.Tensor, seed, wl, fl) -> torch.Tensor:
    """The reference's jax.random oracle of the fused SR quantize
    (``repro/kernels/ref.py:36``): u = ``jax.random.uniform(PRNGKey(seed),
    x.shape)`` through ``core/threefry.py``, then :func:`ref_sr_quantize`
    (⟨wl, fl⟩ broadcast against x)."""
    u = threefry.uniform(threefry.key_from_seed(seed), x.shape,
                         device=x.device)
    return ref_sr_quantize(x, u, wl, fl)


def ref_sr_quantize_fused_int8(x: torch.Tensor, seed, fl) -> torch.Tensor:
    """The reference's jax.random oracle of the fused SR int8 words
    (``repro/kernels/ref.py:45``): clip(floor(x·2^fl) + [u < frac], −128,
    127) as int8 with the same u as :func:`ref_sr_quantize_fused` (its
    ``2.0 ** fl`` is exact, as ``pow2i``)."""
    u = threefry.uniform(threefry.key_from_seed(seed), x.shape,
                         device=x.device)
    return _sr_int8(x, u, torch.as_tensor(fl, device=x.device))


def ref_int8_matmul(xq: torch.Tensor, wq: torch.Tensor, sx, sw
                    ) -> torch.Tensor:
    """The reference's oracle of the W8A8 product (``repro/kernels/ref.py:245``):
    the exact int32 sum xq @ wq, then f32(acc)·f32(sx)·f32(sw), left to
    right (two roundings)."""
    acc = _int8_acc(xq, wq).to(torch.float32)
    return (acc * torch.as_tensor(sx).to(acc.device, torch.float32)
            * torch.as_tensor(sw).to(acc.device, torch.float32))


def _int8_acc(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The int32 sum Σ_k xq·wq of int8 words. On the CPU in int64 and
    wrapped to int32 as an int32 accumulator wraps; on the card an f64
    product, exact while |acc| < 2^53 (the kernel's wrapper admits
    K ≤ 131071, so |acc| < 2^31), returned as f64."""
    if xq.device.type == "cpu":
        return torch.matmul(xq.to(torch.int64), wq.to(torch.int64)).to(
            torch.int32)
    return torch.matmul(xq.to(torch.float64), wq.to(torch.float64))


def ref_int8_matmul_kernel(xq: torch.Tensor, wq: torch.Tensor,
                           s: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``int8_matmul`` kernel: f32(Σ_k xq·wq)·s with
    s = f32(sx)·f32(sw) formed once (``fxp_matmul.py:181``); f32 out. The
    int32 → f32 conversion rounds to nearest even, as the f64 → f32 cast
    does on the card."""
    acc = _int8_acc(xq, wq).to(torch.float32)
    return acc * s.to(acc.device, torch.float32).reshape(())


def ref_kl_hist(w: torch.Tensor, q: torch.Tensor, num_bins: int
                ) -> torch.Tensor:
    """The reference's oracle of the KL double histogram
    (``repro/kernels/ref.py:325-337``): f32 counts (2, num_bins) of w and q
    over w's [min, max], bin = clip(floor((x − lo) / span · num_bins), 0,
    num_bins − 1) with span = max(hi − lo, 1e-12), divided first and then
    multiplied. A NaN bin counts in bin 0, as XLA's float → int conversion
    makes it (torch's is undefined for NaN)."""
    wf = w.to(torch.float32).reshape(-1)
    lo, hi = wf.min(), wf.max()
    span = torch.clamp(hi - lo, min=1e-12)

    def hist(x):
        t = torch.floor((x.to(torch.float32).reshape(-1) - lo) / span
                        * num_bins).clamp(0, num_bins - 1)
        idx = torch.where(torch.isnan(t), 0.0, t).to(torch.int64)
        return torch.bincount(idx, minlength=num_bins).to(torch.float32)

    return torch.stack([hist(wf), hist(q)])


def kl_bins(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            num_bins: int) -> torch.Tensor:
    """The KL kernel's f32 bin of each element, in its expression order:
    inv_span = num_bins / max(hi − lo, 1e-12), then clip(floor((x − lo) ·
    inv_span), 0, num_bins − 1); NaN where that is NaN."""
    inv = (torch.tensor(float(num_bins), dtype=torch.float32,
                        device=x.device) / torch.clamp(hi - lo, min=1e-12))
    t = torch.floor((x.to(torch.float32) - lo) * inv)
    return torch.minimum(torch.maximum(t, torch.zeros_like(t)),
                         torch.full_like(t, num_bins - 1))


def ref_kl_hist_kernel(w: torch.Tensor, q: torch.Tensor, num_bins: int
                       ) -> torch.Tensor:
    """Plain version of the ``kl_hist`` kernel: f32 counts (2, num_bins) of
    w and q over w's [min, max] with :func:`kl_bins` (multiplied by the
    inverse span, ``kl_hist.py:37-42``); an element whose bin is NaN is
    counted in no row, as the kernel's one-hot compare counts it nowhere.
    The reference's lane padding (filled with lo, its count taken back
    from bin 0) leaves the counts of a NaN-free w as these."""
    wf = w.to(torch.float32).reshape(-1)
    lo, hi = torch.aminmax(wf)
    rows = []
    for x in (wf, q.reshape(-1)):
        t = kl_bins(x, lo, hi, num_bins)
        idx = t[~torch.isnan(t)].to(torch.int64)
        rows.append(torch.bincount(idx, minlength=num_bins))
    return torch.stack(rows).to(torch.float32)

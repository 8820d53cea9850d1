"""Stochastic rounding of the f32 master with the noise drawn inside the
kernel, and with the noise given: the CUDA kernels of
``csrc/sr_quantize.cu`` beside their plain versions, and the contract
pieces of the portable noise stream.

Grid values with the noise given (``kernels/ops.sr_quantize``):

* ``sr_quantize`` replaces the TPU kernel ``_sr_quantize_kernel`` of
  ``repro/kernels/sr_quantize.py``: x (f32 or bf16) and u (U[0,1) f32 of
  x's shape) in, q = clip(floor(x·2^fl) + [u < frac], −2^(wl−1),
  2^(wl−1) − 1) / 2^fl out in x's dtype. Bound by its bytes: 12 per f32
  element (x and u read, q written).

Int8 words (the packed container; dequant = q8·2^-FL at the consumer):

* ``sr_quantize_fused_int8`` replaces the TPU kernel
  ``_sr_fused_int8_kernel`` of ``repro/kernels/sr_quantize.py`` (an
  unstacked leaf: element i hashes index i).
* ``sr_quantize_fused_stacked_int8`` replaces
  ``_sr_fused_stacked_int8_kernel`` (an (L, ...) leaf with a per-layer FL:
  element i of layer l hashes l·rows·512 + i, rows = ⌈n_l / 512⌉).

Both give q = clip(floor(x·2^fl) + [u < frac], −128, 127) as int8,
u = ``uniform_from_index(seed, idx)``.

Grid values in a float container (``controller.quantize_params``):

* ``sr_quantize_fused`` replaces ``_sr_fused_kernel`` (flat, one ⟨WL,FL⟩);
* ``sr_quantize_fused_stacked`` replaces ``_sr_fused_stacked_kernel``
  (layer l at ⟨wl[l], fl[l]⟩, the same index stride as the int8 stack).

They clip q to [−2^(WL−1), 2^(WL−1) − 1] and return q / 2^FL in f32 or
bf16 (rounded to nearest even). Both launch one persistent kernel that
walks equal chunks of x by bulk asynchronous copies; ``grid_plan``,
``grid_chunk``, ``grid_bulk`` and ``grid_split`` below mirror its plan
for the CPU tests.

All four are bit for bit the reference's portable stream (its interpret
mode); the TPU hardware PRNG has no counterpart. On an H100 they are bound
by their bytes (4 read per element, 1, 4 or 2 written). A CPU tensor takes
the plain version; a CUDA tensor takes the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.fxp_matmul import _seed32, check_card

plain = ref.ref_sr_quantize_fused_int8_words
plain_stacked = ref.ref_sr_quantize_fused_stacked_int8_words
plain_grid = ref.ref_sr_quantize_fused_words
plain_grid_stacked = ref.ref_sr_quantize_fused_stacked_words
plain_given = ref.ref_sr_quantize

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}

# One implementation of the shard-seed fold; tests pin it to the golden file.
fold_shard_seed = ref.ref_fold_shard_seed


def uniform_from_index(seed, idx: torch.Tensor) -> torch.Tensor:
    """Portable U[0,1) f32 of element indices ``idx`` (taken mod 2^32):
    the murmur3 finalizer of idx + seed·0x9E3779B9, u = (h >> 8)·2^-24
    (``repro/kernels/sr_quantize.py:113``)."""
    h = torch.as_tensor(idx).to(torch.int64).bitwise_and(ref._M32)
    return ref._uniform(seed, h)


# The grid-value kernel's plan (``csrc/sr_quantize.cu``, namespace ``grid``):
# elements a chunk, and CTAs an SM of its persistent grid.
GRID_CHUNK = 8192
GRID_CTAS_PER_SM = 1


def grid_plan(L: int, n_l: int, sm_count: int) -> tuple[int, int, int]:
    """(chunk, ctas, chunks a layer) of an (L, n_l) launch on a card of
    ``sm_count`` SMs: each layer is cut into ⌈n_l / chunk⌉ chunks that never
    cross it, and a persistent grid of ``ctas`` CTAs walks the L·⌈n_l /
    chunk⌉ chunks, CTA b taking chunks b, b + ctas, ..."""
    cpl = -(-n_l // GRID_CHUNK)
    return GRID_CHUNK, min(L * cpl, GRID_CTAS_PER_SM * sm_count), cpl


def grid_chunk(c: int, n_l: int, cpl: int) -> tuple[int, int, int]:
    """(l, g0, g1): chunk c is elements [g0, g1) of the flat tensor, in
    layer l."""
    l = c // cpl
    g0 = l * n_l + (c - l * cpl) * GRID_CHUNK
    return l, g0, min(g0 + GRID_CHUNK, (l + 1) * n_l)


def grid_bulk(x_addr: int, q_addr: int, out_size: int) -> tuple[int, int]:
    """(period, phase): element g of the flat tensor has both its f32 x and
    its ``out_size``-byte q at 16-byte aligned addresses when g ≡ phase
    (mod period); period 0 when no element has (x and q cannot be aligned
    together)."""
    period = 16 // out_size
    ex, eq = -x_addr % 16 // 4, -q_addr % 16 // out_size
    if x_addr % 4 or q_addr % out_size or eq % 4 != ex:
        return 0, 0
    return period, eq


def grid_split(g0: int, g1: int, period: int, phase: int) -> tuple[int, int]:
    """(a, b): the chunk [g0, g1) goes by bulk copies over [a, b) and by
    the kernel's element path over [g0, a) and [b, g1)."""
    if not period:
        return g1, g1
    a = min(g0 + ((phase - g0) & (period - 1)), g1)
    return a, a + ((g1 - a) & -period)


def _lib():
    """The five entry points: int8 flat and stacked, grid flat and
    stacked, and grid values with the noise given."""
    lib = _build.load("sr_quantize")
    fns = (lib.sr_quantize_fused_int8_launch,
           lib.sr_quantize_fused_stacked_int8_launch,
           lib.sr_quantize_fused_launch, lib.sr_quantize_fused_stacked_launch,
           lib.sr_quantize_launch)
    if fns[0].argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn, args in zip(fns, ([p, p, p, i, ll, p], [p, p, p, i, i, ll, p],
                                  [p, p, i, p, p, i, ll, p],
                                  [p, p, i, p, p, i, i, ll, p],
                                  [p, p, p, i, p, p, ll, p])):
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return fns


def _check(name: str, x: torch.Tensor, fl_shape, **prec) -> None:
    check_card(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous float32, got "
                         f"{x.dtype}")
    for key, t in prec.items():
        if t.dtype != torch.int32 or t.device != x.device \
                or tuple(t.shape) != fl_shape or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous int32 "
                             f"{fl_shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _fl_on(fl, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(fl, dtype=torch.int32, device=x.device)


def sr_quantize_fused_int8(x: torch.Tensor, seed, fl) -> torch.Tensor:
    """int8 SR words of an unstacked tensor at one FL (a 0-dim int32
    tensor, read by the kernel on the card). ``seed``: a host int (int32
    bits). Same shape as x."""
    fl = _fl_on(fl, x)
    if x.device.type == "cpu":
        return plain(x, seed, fl)
    x = x.to(torch.float32).contiguous()
    _check("sr_quantize_fused_int8", x, (), fl=fl)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()[0](x.data_ptr(), q.data_ptr(), fl.data_ptr(), _seed32(seed),
                    x.numel(), stream)
    _build.check(err, "sr_quantize_fused_int8")
    sr_quantize_fused_int8.launches += 1
    return q


sr_quantize_fused_int8.launches = 0


def sr_quantize_fused_stacked_int8(x: torch.Tensor, seed, fl) -> torch.Tensor:
    """int8 SR words of an (L, ...) stacked tensor, layer l at ``fl[l]``
    (an (L,) int32 tensor, read by the kernel on the card), in one
    launch. Same shape as x."""
    fl = _fl_on(fl, x)
    if x.device.type == "cpu":
        return plain_stacked(x, seed, fl)
    x = x.to(torch.float32).contiguous()
    L = x.shape[0]
    _check("sr_quantize_fused_stacked_int8", x, (L,), fl=fl)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()[1](x.data_ptr(), q.data_ptr(), fl.data_ptr(), _seed32(seed),
                    L, x[0].numel() if L else 0, stream)
    _build.check(err, "sr_quantize_fused_stacked_int8")
    sr_quantize_fused_stacked_int8.launches += 1
    return q


sr_quantize_fused_stacked_int8.launches = 0


def _out_code(name: str, out_dtype: torch.dtype) -> int:
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"{name}: out_dtype {out_dtype} not in f32/bf16")
    return _OUT_CODE[out_dtype]


def sr_quantize_fused(x: torch.Tensor, seed, wl, fl, *,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """SR grid values of an unstacked tensor at one ⟨WL,FL⟩ (0-dim int32
    tensors, read by the kernel on the card), in ``out_dtype`` (f32, or
    bf16 rounded to nearest even). ``seed``: a host int (int32 bits)."""
    wl, fl = _fl_on(wl, x), _fl_on(fl, x)
    if x.device.type == "cpu":
        return plain_grid(x, seed, wl, fl, out_dtype=out_dtype)
    x = x.to(torch.float32).contiguous()
    _check("sr_quantize_fused", x, (), wl=wl, fl=fl)
    code = _out_code("sr_quantize_fused", out_dtype)
    q = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()[2](x.data_ptr(), q.data_ptr(), code, wl.data_ptr(),
                    fl.data_ptr(), _seed32(seed), x.numel(), stream)
    _build.check(err, "sr_quantize_fused")
    sr_quantize_fused.launches += 1
    return q


sr_quantize_fused.launches = 0


def sr_quantize_fused_stacked(x: torch.Tensor, seed, wl, fl, *,
                              out_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """SR grid values of an (L, ...) stacked tensor, layer l at
    ⟨wl[l], fl[l]⟩ ((L,) int32 tensors, read by the kernel on the card), in
    one launch, in ``out_dtype``."""
    wl, fl = _fl_on(wl, x), _fl_on(fl, x)
    if x.device.type == "cpu":
        return plain_grid_stacked(x, seed, wl, fl, out_dtype=out_dtype)
    x = x.to(torch.float32).contiguous()
    L = x.shape[0]
    _check("sr_quantize_fused_stacked", x, (L,), wl=wl, fl=fl)
    code = _out_code("sr_quantize_fused_stacked", out_dtype)
    q = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()[3](x.data_ptr(), q.data_ptr(), code, wl.data_ptr(),
                    fl.data_ptr(), _seed32(seed), L,
                    x[0].numel() if L else 0, stream)
    _build.check(err, "sr_quantize_fused_stacked")
    sr_quantize_fused_stacked.launches += 1
    return q


sr_quantize_fused_stacked.launches = 0


def sr_quantize(x: torch.Tensor, u: torch.Tensor, wl, fl) -> torch.Tensor:
    """SR grid values of x at one ⟨WL,FL⟩ (0-dim int32 tensors, read by the
    kernel on the card) with the U[0,1) noise ``u`` (f32, x's shape), in
    x's dtype (f32, or bf16 rounded to nearest even from the f32 value).
    On the CPU the plain version, which also takes ⟨wl, fl⟩ that broadcast
    against x."""
    if x.device.type == "cpu":
        return plain_given(x, u, wl, fl)
    wl, fl = _fl_on(wl, x), _fl_on(fl, x)
    check_card(x)
    if x.dtype not in _OUT_CODE or not x.is_contiguous():
        raise ValueError(f"sr_quantize: x must be contiguous float32 or "
                         f"bfloat16, got {x.dtype}")
    if u.dtype != torch.float32 or u.device != x.device \
            or u.shape != x.shape or not u.is_contiguous():
        raise ValueError(f"sr_quantize: u must be contiguous float32 of "
                         f"x's shape {tuple(x.shape)} on {x.device}, got "
                         f"{u.dtype} {tuple(u.shape)} on {u.device}")
    for key, t in (("wl", wl), ("fl", fl)):
        if t.dtype != torch.int32 or t.ndim != 0:
            raise ValueError(f"sr_quantize: {key} must be an int32 scalar, "
                             f"got {t.dtype} {tuple(t.shape)}")
    q = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()[4](x.data_ptr(), u.data_ptr(), q.data_ptr(),
                    _OUT_CODE[x.dtype], wl.data_ptr(), fl.data_ptr(),
                    x.numel(), stream)
    _build.check(err, "sr_quantize")
    sr_quantize.launches += 1
    return q


sr_quantize.launches = 0

"""Fixed-point matmul y = (x @ wq) · 2^-FL, int8 words dequantized in
registers, its two backward products, and the quantize-prologue pair that
draws the words from the f32 master in registers: the CUDA kernels of
``csrc/fxp_matmul.cu``, ``csrc/fxp_matmul_bwd.cu`` and
``csrc/fxp_qmatmul.cu``, each beside its plain version.

* ``fxp_matmul`` replaces the TPU kernel ``_fxp_matmul_kernel`` of
  ``repro/kernels/fxp_matmul.py``. On an H100 a decode call is bound by
  the int8 weight bytes and a prefill call by its operations.
* ``matmul_dx`` replaces ``_matmul_dx_kernel``: dx = (dy @ wqᵀ)·scale,
  reading the forward's (K, N) words in place.
* ``matmul_dw`` replaces ``_matmul_dw_kernel``: dw = xᵀ @ dy, f32
  accumulation, out in f32 or bf16.
* ``fxp_qmatmul`` replaces ``_fxp_qmatmul_kernel``: y = (x @ Q(w))·2^-FL,
  the ⟨8,FL⟩ words Q(w) of the (K, N) f32 master drawn in registers
  (stochastically rounded with the portable stream of index k·N + n, or
  rounded to nearest).
* ``matmul_qdx`` replaces ``_matmul_qdx_kernel``: dx = (dy @ Q(w)ᵀ)·2^-FL
  on the same words.

Every wrapper takes a tensor-core kernel on bf16 activations (the main
path), counted in its ``tc_launches``: wgmma, the activations by TMA, the
words read or drawn into shared memory by producer warpgroups (none for
``matmul_dw``, whose operands both arrive by TMA as they lie); and a SIMT
kernel on f32 activations. ``fxp_matmul`` chooses by M too: at M <= 16
(decode) either dtype takes its GEMV (one launch, the K split over a
thread-block cluster in a fixed order, ``gemv_plan``), counted in
``gemv_launches``, and bf16 x with M > 16 the tensor cores. A refused
launch raises; no branch falls back to another or to the plain version.

No kernel writes a dequantized weight or a word tensor to device memory
(see the notes at the top of the CUDA sources for their designs).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (ref_fxp_matmul, ref_fxp_qdense,
                                     ref_matmul_dw, ref_matmul_dx,
                                     ref_matmul_qdx)

plain = ref_fxp_matmul
plain_dx = ref_matmul_dx
plain_dw = ref_matmul_dw
plain_q = ref_fxp_qdense
plain_qdx = ref_matmul_qdx

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The GEMV of csrc/fxp_matmul.cu (namespace gemv): M <= 16; a CTA of 8
# warps owns 128 columns of y; up to 8 CTAs of a cluster split K.
GEMV_MAX_M = 16
GEMV_COLS = 128
GEMV_MAX_CLUSTER = 8


def takes_gemv(m: int) -> bool:
    """Whether ``fxp_matmul`` at M = ``m`` takes the GEMV (decode, the
    prefill's head): M <= 16, either dtype."""
    return m <= GEMV_MAX_M


@functools.lru_cache(maxsize=None)
def gemv_plan(m: int, k: int, n: int) -> tuple[int, int, int]:
    """The GEMV's split of (m, k, n), a function of the shape alone:
    (mb, cs, kc). mb is the M bucket (4, 8 or 16); a CTA's k rows go
    round-robin to 16 slots at mb = 4 (8 warps, each reading two word rows
    at once), 8 above. The k rows go to a cluster of cs CTAs, kc each (rank
    r the rows [r·kc, (r+1)·kc), kc a multiple of the slots): cs doubles
    from 1 while the grid holds fewer than 96 CTAs, or fewer than 256 with
    more than 1536 rows a CTA, and each CTA keeps at least 128 rows (the
    fastest split of each decode shape of llama3.2-3b on an H100 among
    1, 2, 4 and 8, PERF.md section 6)."""
    def cdiv(a, b):
        return -(-a // b)

    mb = 4 if m <= 4 else 8 if m <= 8 else 16
    slots = 16 if mb == 4 else 8
    tiles, cs = cdiv(n, GEMV_COLS), 1
    while cs < GEMV_MAX_CLUSTER and k >= 2 * cs * 128:
        ctas, rows = tiles * cs, cdiv(k, cs)
        if not (ctas < 96 or (ctas < 256 and rows > 1536)):
            break
        cs *= 2
    return mb, cs, cdiv(cdiv(k, cs), slots) * slots


def _lib():
    lib = _build.load("fxp_matmul")
    fns = (lib.fxp_matmul_launch, lib.fxp_matmul_tc_launch,
           lib.fxp_matmul_gemv_launch)
    if fns[0].argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fns[0].argtypes = [p, i, p, p, i, p, i, i, i, i, p]
        fns[1].argtypes = [p, i, p, p, i, p, i, i, i, i, p]
        fns[2].argtypes = [p, i, p, p, i, p, i, i, i, i, i, i, p]
        for fn in fns:
            fn.restype = ctypes.c_int
    return fns


@functools.lru_cache(maxsize=None)
def _capability(index: int):
    return torch.cuda.get_device_capability(index)


def check_card(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a CUDA device of compute capability 9.0."""
    if t.device.type != "cuda":
        raise RuntimeError(f"expected a CUDA tensor, got {t.device}")
    cap = _capability(t.device.index if t.device.index is not None
                      else torch.cuda.current_device())
    if cap != (9, 0):
        raise RuntimeError(f"the repro_torch kernels are built for sm_90a "
                           f"(H100); this device has capability {cap}")


def fxp_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: y = (x @ wq) * scale, f32 accumulation.

    x: (M, K) bf16/f32 contiguous; wq: (K, N) int8 contiguous; scale: a
    one-element bf16/f32 tensor (2^-FL) on the same device, read by the
    kernel (no host sync). ``out_dtype`` (bf16/f32) defaults to x's. M <= 16
    takes the GEMV (counted in ``fxp_matmul.gemv_launches``; its split is
    ``gemv_plan``), bf16 x with M > 16 the tensor-core kernel
    (``fxp_matmul.tc_launches``), f32 x with M > 16 the SIMT one."""
    check_card(x)
    out_dtype = out_dtype or x.dtype
    if x.ndim != 2 or wq.ndim != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"fxp_matmul: shapes {tuple(x.shape)} @ {tuple(wq.shape)}")
    if wq.dtype != torch.int8:
        raise TypeError(f"fxp_matmul: wq must be int8, got {wq.dtype}")
    for name, t in (("x", x), ("scale", scale), ("out", None)):
        dt = out_dtype if t is None else t.dtype
        if dt not in _DTYPE_CODE:
            raise TypeError(f"fxp_matmul: {name} dtype {dt} not in bf16/f32")
    if scale.numel() != 1:
        raise ValueError("fxp_matmul: scale must hold one element")
    for name, t in (("x", x), ("wq", wq), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"fxp_matmul: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fxp_matmul: {name} must be contiguous")
    M, K = x.shape
    N = wq.shape[1]
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    gemv = takes_gemv(M)
    tc = not gemv and x.dtype == torch.bfloat16
    codes = (_DTYPE_CODE[scale.dtype], y.data_ptr(), _DTYPE_CODE[out_dtype])
    if gemv:
        _, cs, kc = gemv_plan(M, K, N)
        err = _lib()[2](x.data_ptr(), _DTYPE_CODE[x.dtype], wq.data_ptr(),
                        scale.data_ptr(), *codes, M, N, K, cs, kc, stream)
    elif tc:
        a = _tma_rows(x)
        err = _lib()[1](a.data_ptr(), a.shape[1], wq.data_ptr(),
                        scale.data_ptr(), *codes, M, N, K, stream)
    else:
        err = _lib()[0](x.data_ptr(), _DTYPE_CODE[x.dtype], wq.data_ptr(),
                        scale.data_ptr(), *codes, M, N, K, stream)
    _build.check(err, "fxp_matmul")
    fxp_matmul.launches += 1
    fxp_matmul.tc_launches += int(tc)
    fxp_matmul.gemv_launches += int(gemv)
    return y


fxp_matmul.launches = 0
fxp_matmul.tc_launches = 0
fxp_matmul.gemv_launches = 0


def _bwd_lib():
    lib = _build.load("fxp_matmul_bwd")
    dx, dw = lib.matmul_dx_launch, lib.matmul_dw_launch
    dx_tc, dw_tc = lib.matmul_dx_tc_launch, lib.matmul_dw_tc_launch
    if dx.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        dx.argtypes = [p, i, p, p, i, p, i, i, i, i, p]
        dx.restype = ctypes.c_int
        dw.argtypes = [p, p, p, i, i, i, i, p]
        dw.restype = ctypes.c_int
        dx_tc.argtypes = [p, i, p, p, i, p, i, i, i, i, p]
        dx_tc.restype = ctypes.c_int
        dw_tc.argtypes = [p, i, p, i, p, i, i, i, i, p]
        dw_tc.restype = ctypes.c_int
    return dx, dw, dx_tc, dw_tc


def _check_operands(name: str, ref: torch.Tensor, **tensors) -> None:
    for key, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name}: {key} on {t.device}, not {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _tma_rows(a: torch.Tensor) -> torch.Tensor:
    """``a`` (R, C) itself when TMA can address its rows (16-byte aligned,
    C a multiple of 8 elements), else a copy padded with zero columns to
    the next multiple of 8."""
    R, C = a.shape
    if C % 8 == 0 and a.data_ptr() % 16 == 0:
        return a
    padded = a.new_zeros((R, C + -C % 8))
    padded[:, :C] = a
    return padded


def matmul_dx(dy: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: dx = (dy @ wqᵀ) * scale, f32 accumulation.

    dy: (M, N) bf16/f32 contiguous; wq: (K, N) int8 contiguous, read in
    place (no transposed copy); scale: a one-element bf16/f32 tensor read
    on the device. ``out_dtype`` (bf16/f32) defaults to dy's. bf16 dy
    takes the tensor-core kernel (counted in ``matmul_dx.tc_launches``),
    f32 dy the SIMT one."""
    check_card(dy)
    out_dtype = out_dtype or dy.dtype
    if dy.ndim != 2 or wq.ndim != 2 or dy.shape[1] != wq.shape[1]:
        raise ValueError(f"matmul_dx: shapes {tuple(dy.shape)}, {tuple(wq.shape)}")
    if wq.dtype != torch.int8:
        raise TypeError(f"matmul_dx: wq must be int8, got {wq.dtype}")
    for name, dt in (("dy", dy.dtype), ("scale", scale.dtype), ("out", out_dtype)):
        if dt not in _DTYPE_CODE:
            raise TypeError(f"matmul_dx: {name} dtype {dt} not in bf16/f32")
    if scale.numel() != 1:
        raise ValueError("matmul_dx: scale must hold one element")
    _check_operands("matmul_dx", dy, dy=dy, wq=wq, scale=scale)
    M, N = dy.shape
    K = wq.shape[0]
    dx = torch.empty((M, K), dtype=out_dtype, device=dy.device)
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    tc = dy.dtype == torch.bfloat16
    if tc:
        a = _tma_rows(dy)
        err = _bwd_lib()[2](a.data_ptr(), a.shape[1], wq.data_ptr(),
                            scale.data_ptr(), _DTYPE_CODE[scale.dtype],
                            dx.data_ptr(), _DTYPE_CODE[out_dtype], M, N, K,
                            stream)
    else:
        err = _bwd_lib()[0](dy.data_ptr(), _DTYPE_CODE[dy.dtype], wq.data_ptr(),
                            scale.data_ptr(), _DTYPE_CODE[scale.dtype],
                            dx.data_ptr(), _DTYPE_CODE[out_dtype], M, N, K,
                            stream)
    _build.check(err, "matmul_dx")
    matmul_dx.launches += 1
    matmul_dx.tc_launches += int(tc)
    return dx


matmul_dx.launches = 0
matmul_dx.tc_launches = 0


def matmul_dw(x: torch.Tensor, dy: torch.Tensor, *,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the CUDA kernel: dw = xᵀ @ dy, f32 accumulation over M.

    x: (M, K), dy: (M, N), contiguous, both bf16 or both f32. The result is
    (K, N) in ``out_dtype``: f32, or bf16 rounded to nearest even (the
    straight-through cast onto a bf16 receiver). bf16 operands take the
    tensor-core kernel (counted in ``matmul_dw.tc_launches``), f32 ones the
    SIMT one."""
    check_card(x)
    if x.ndim != 2 or dy.ndim != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"matmul_dw: shapes {tuple(x.shape)}, {tuple(dy.shape)}")
    if x.dtype not in _DTYPE_CODE or dy.dtype != x.dtype:
        raise TypeError(f"matmul_dw: dtypes {x.dtype}/{dy.dtype}, want one of "
                        "bf16/f32 for both")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"matmul_dw: out dtype {out_dtype} not in bf16/f32")
    _check_operands("matmul_dw", x, x=x, dy=dy)
    M, K = x.shape
    N = dy.shape[1]
    dw = torch.empty((K, N), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tc = x.dtype == torch.bfloat16
    if tc:
        a, b = _tma_rows(x), _tma_rows(dy)
        err = _bwd_lib()[3](a.data_ptr(), a.shape[1], b.data_ptr(), b.shape[1],
                            dw.data_ptr(), _DTYPE_CODE[out_dtype], M, K, N,
                            stream)
    else:
        err = _bwd_lib()[1](x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                            _DTYPE_CODE[out_dtype], M, K, N, stream)
    _build.check(err, "matmul_dw")
    matmul_dw.launches += 1
    matmul_dw.tc_launches += int(tc)
    return dw


matmul_dw.launches = 0
matmul_dw.tc_launches = 0


def _q_lib():
    lib = _build.load("fxp_qmatmul")
    fns = (lib.fxp_qmatmul_launch, lib.matmul_qdx_launch,
           lib.fxp_qmatmul_tc_launch, lib.matmul_qdx_tc_launch)
    if fns[0].argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in fns:
            fn.argtypes = [p, i, p, p, i, i, p, i, i, i, i, p]
            fn.restype = ctypes.c_int
    return fns


def _seed32(seed) -> int:
    """The seed as the int32 the kernels reinterpret as uint32."""
    s = int(seed) & 0xFFFFFFFF
    return s - (1 << 32) if s >= (1 << 31) else s


def _prologue(name: str, a: torch.Tensor, w: torch.Tensor, seed, fl, mode,
              out_dtype, out_shape, qdx: bool) -> torch.Tensor:
    """Check the operands and launch ``fxp_qmatmul`` (``qdx`` False) or
    ``matmul_qdx``: on the tensor cores for bf16 ``a`` (whose rows are
    padded with zeros to a multiple of 8 elements when TMA cannot address
    them), else on the SIMT kernel."""
    check_card(a)
    if a.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtypes {a.dtype} -> {out_dtype}, want "
                        "bf16/f32")
    if w.dtype != torch.float32:
        raise TypeError(f"{name}: the master must be float32, got {w.dtype}")
    if not (isinstance(fl, torch.Tensor) and fl.dtype == torch.int32
            and fl.device == a.device):
        fl = torch.as_tensor(fl, dtype=torch.int32, device=a.device)
    if fl.numel() != 1:
        raise ValueError(f"{name}: fl must hold one element")
    if int(mode) not in (0, 1):
        raise ValueError(f"{name}: mode must be 1 (SR) or 0 (RTN), got {mode}")
    _check_operands(name, a, a=a, w=w, fl=fl)
    M, N, K = out_shape[0], w.shape[1], w.shape[0]
    out = torch.empty(out_shape, dtype=out_dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    fns = _q_lib()
    if a.dtype == torch.bfloat16:
        a = _tma_rows(a)
        args = (a.data_ptr(), a.shape[1], w.data_ptr(), fl.data_ptr(),
                _seed32(seed), int(mode), out.data_ptr(),
                _DTYPE_CODE[out_dtype], M, N, K)
        err = fns[3 if qdx else 2](*args, stream)
    else:
        err = fns[int(qdx)](a.data_ptr(), _DTYPE_CODE[a.dtype], w.data_ptr(),
                            fl.data_ptr(), _seed32(seed), int(mode),
                            out.data_ptr(), _DTYPE_CODE[out_dtype], M, N, K,
                            stream)
    _build.check(err, name)
    return out


def fxp_qmatmul(x: torch.Tensor, w: torch.Tensor, seed, fl, mode, *,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: y = (x @ Q⟨8,fl⟩(w))·2^-fl, the words drawn
    from the master in registers, f32 accumulation.

    x: (M, K) bf16/f32 contiguous; w: (K, N) f32 master, contiguous; fl: a
    one-element int32 tensor on the device, read by the kernel (no host
    sync); seed (int32 bits) and mode (1 SR, 0 RTN): host ints.
    ``out_dtype`` (bf16/f32) defaults to x's. bf16 x takes the tensor-core
    kernel (counted in ``fxp_qmatmul.tc_launches``), f32 x the SIMT one."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fxp_qmatmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    y = _prologue("fxp_qmatmul", x, w, seed, fl, mode, out_dtype or x.dtype,
                  (x.shape[0], w.shape[1]), False)
    fxp_qmatmul.launches += 1
    fxp_qmatmul.tc_launches += int(x.dtype == torch.bfloat16)
    return y


fxp_qmatmul.launches = 0
fxp_qmatmul.tc_launches = 0


def matmul_qdx(dy: torch.Tensor, w: torch.Tensor, seed, fl, mode, *,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: dx = (dy @ Q⟨8,fl⟩(w)ᵀ)·2^-fl on the words
    the forward drew. dy: (M, N) bf16/f32 contiguous; w: the (K, N) f32
    master, read in place along n; fl, seed, mode as ``fxp_qmatmul``.
    ``out_dtype`` defaults to dy's. bf16 dy takes the tensor-core kernel,
    f32 dy the SIMT one."""
    if dy.ndim != 2 or w.ndim != 2 or dy.shape[1] != w.shape[1]:
        raise ValueError(f"matmul_qdx: shapes {tuple(dy.shape)}, "
                         f"{tuple(w.shape)}")
    dx = _prologue("matmul_qdx", dy, w, seed, fl, mode, out_dtype or dy.dtype,
                   (dy.shape[0], w.shape[0]), True)
    matmul_qdx.launches += 1
    matmul_qdx.tc_launches += int(dy.dtype == torch.bfloat16)
    return dx


matmul_qdx.launches = 0
matmul_qdx.tc_launches = 0

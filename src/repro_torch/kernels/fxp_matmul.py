"""Fixed-point matmul y = (x @ wq) · 2^-FL, int8 words dequantized in
registers, and its two backward products: the CUDA kernels of
``csrc/fxp_matmul.cu`` and ``csrc/fxp_matmul_bwd.cu``, each beside its
plain version.

* ``fxp_matmul`` replaces the TPU kernel ``_fxp_matmul_kernel`` of
  ``repro/kernels/fxp_matmul.py``. On an H100 a decode call is bound by
  the int8 weight bytes and a prefill call by its operations.
* ``matmul_dx`` replaces ``_matmul_dx_kernel``: dx = (dy @ wqᵀ)·scale,
  reading the forward's (K, N) words in place.
* ``matmul_dw`` replaces ``_matmul_dw_kernel``: dw = xᵀ @ dy, f32
  accumulation, out in f32 or bf16.

No kernel writes a dequantized weight to device memory (see the notes at
the top of the CUDA sources for their designs).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (ref_fxp_matmul, ref_matmul_dw,
                                     ref_matmul_dx)

plain = ref_fxp_matmul
plain_dx = ref_matmul_dx
plain_dw = ref_matmul_dw

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SPLITK_MAX_M = 16          # the kernel's GEMV path takes M <= 16


def _lib():
    lib = _build.load("fxp_matmul")
    fn = lib.fxp_matmul_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, p, i, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def check_card(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a CUDA device of compute capability 9.0."""
    if t.device.type != "cuda":
        raise RuntimeError(f"expected a CUDA tensor, got {t.device}")
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(f"the repro_torch kernels are built for sm_90a "
                           f"(H100); this device has capability {cap}")


def fxp_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: y = (x @ wq) * scale, f32 accumulation.

    x: (M, K) bf16/f32 contiguous; wq: (K, N) int8 contiguous; scale: a
    one-element bf16/f32 tensor (2^-FL) on the same device, read by the
    kernel (no host sync). ``out_dtype`` (bf16/f32) defaults to x's."""
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
    ws = (torch.empty((M, N), dtype=torch.float32, device=x.device)
          if M <= _SPLITK_MAX_M else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), _DTYPE_CODE[x.dtype], wq.data_ptr(),
                 scale.data_ptr(), _DTYPE_CODE[scale.dtype], y.data_ptr(),
                 _DTYPE_CODE[out_dtype], None if ws is None else ws.data_ptr(),
                 M, N, K, stream)
    _build.check(err, "fxp_matmul")
    fxp_matmul.launches += 1
    return y


fxp_matmul.launches = 0


def _bwd_lib():
    lib = _build.load("fxp_matmul_bwd")
    dx, dw = lib.matmul_dx_launch, lib.matmul_dw_launch
    if dx.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        dx.argtypes = [p, i, p, p, i, p, i, i, i, i, p]
        dx.restype = ctypes.c_int
        dw.argtypes = [p, p, i, p, i, i, i, i, p]
        dw.restype = ctypes.c_int
    return dx, dw


def _check_operands(name: str, ref: torch.Tensor, **tensors) -> None:
    for key, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name}: {key} on {t.device}, not {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def matmul_dx(dy: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: dx = (dy @ wqᵀ) * scale, f32 accumulation.

    dy: (M, N) bf16/f32 contiguous; wq: (K, N) int8 contiguous, read in
    place (no transposed copy); scale: a one-element bf16/f32 tensor read
    on the device. ``out_dtype`` (bf16/f32) defaults to dy's."""
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
    err = _bwd_lib()[0](dy.data_ptr(), _DTYPE_CODE[dy.dtype], wq.data_ptr(),
                        scale.data_ptr(), _DTYPE_CODE[scale.dtype],
                        dx.data_ptr(), _DTYPE_CODE[out_dtype], M, N, K, stream)
    _build.check(err, "matmul_dx")
    matmul_dx.launches += 1
    return dx


matmul_dx.launches = 0


def matmul_dw(x: torch.Tensor, dy: torch.Tensor, *,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the CUDA kernel: dw = xᵀ @ dy, f32 accumulation over M.

    x: (M, K), dy: (M, N), contiguous, both bf16 or both f32. The result is
    (K, N) in ``out_dtype``: f32, or bf16 rounded to nearest even (the
    straight-through cast onto a bf16 receiver)."""
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
    err = _bwd_lib()[1](x.data_ptr(), dy.data_ptr(), _DTYPE_CODE[x.dtype],
                        dw.data_ptr(), _DTYPE_CODE[out_dtype], M, K, N, stream)
    _build.check(err, "matmul_dw")
    matmul_dw.launches += 1
    return dw


matmul_dw.launches = 0

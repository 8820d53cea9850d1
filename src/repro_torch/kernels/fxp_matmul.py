"""Fixed-point matmul y = (x @ wq) · 2^-FL, int8 words dequantized in
registers: the CUDA kernel ``csrc/fxp_matmul.cu`` and its plain version.

Replaces the TPU kernel ``_fxp_matmul_kernel`` of
``repro/kernels/fxp_matmul.py`` (``fxp_matmul``). On an H100 a decode call
is bound by the int8 weight bytes and a prefill call by its operations; the
kernel never writes a dequantized weight to device memory (see the note at
the top of the CUDA source for its design).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_fxp_matmul

plain = ref_fxp_matmul

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

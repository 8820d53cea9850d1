"""Flash attention, forward and backward: the CUDA kernels of
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``, each
beside its plain version.

* ``flash_attention`` replaces the TPU kernel ``_flash_kernel`` of
  ``repro/kernels/flash_attention.py`` (``flash_attention``, with
  ``return_lse``).
* ``flash_attention_dq`` replaces ``_flash_dq_kernel`` and
  ``flash_attention_dkv`` replaces ``_flash_dkv_kernel``; together with
  the per-row D = Σ do∘o (a plain f32 reduction, as it is outside the
  kernels in the reference) they are ``flash_attention_bwd``.

On an H100 all three are bound by their operations at the model's shapes;
the (Sq × Skv) logits never leave the SM and tiles that the causal/window
mask cannot reach are skipped (see the notes at the top of the CUDA
sources for their designs).

The forward has two branches, chosen here by dtype and shape alone (never
by falling back after a failure): bf16 q/k/v with a head dim that is a
multiple of 16 (and Skv ≥ 1, 16-byte aligned bases) run on the tensor
cores (wgmma, K/V by TMA), counted in ``flash_attention.tc_launches``;
f32 inputs and other head dims run the SIMT kernel. Both count in
``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fxp_matmul import check_card
from repro_torch.kernels.ref import (ref_flash_attention,
                                     ref_flash_attention_bwd,
                                     ref_flash_attention_dkv,
                                     ref_flash_attention_dq)

plain = ref_flash_attention
plain_dq = ref_flash_attention_dq
plain_dkv = ref_flash_attention_dkv
plain_bwd = ref_flash_attention_bwd

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, f, p]
        fn.restype = ctypes.c_int
    return fn


def _tc_lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_tc_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, i, f, p]
        fn.restype = ctypes.c_int
    return fn


def takes_tensor_cores(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> bool:
    """True when the forward runs its tensor-core branch: bf16, a head dim
    that is a multiple of 16, at least one key, 16-byte aligned bases (TMA
    reads them)."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] % 16 == 0
            and k.shape[1] > 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def _check(name: str, q, k, v, **more) -> None:
    """Raise unless q (B, Sq, H, D) and k/v (B, Skv, Hkv, D) (and ``more``
    tensors) are contiguous CUDA tensors of one bf16/f32 dtype that the
    kernels take."""
    check_card(q)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} not in 1..{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    for key, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.device != q.device:
            raise ValueError(f"{name}: {key} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    scale: float | None = None, return_lse: bool = False):
    """Launch the CUDA kernel. q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D), all
    contiguous and of one dtype (bf16/f32); returns o (B, Sq, H, D) in q's
    dtype and, with ``return_lse``, the per-row logsumexp (B, H, Sq) f32.
    Queries are end-aligned (q_offset = Skv − Sq); a row that no key
    reaches is 0 with lse = -1e30."""
    _check("flash_attention", q, k, v)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / D ** 0.5
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lse_ptr = None if lse is None else lse.data_ptr()
    tc = takes_tensor_cores(q, k, v)
    if tc:
        err = _tc_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse_ptr, B, Sq, Skv, H, Hkv, D, float(sc),
                        int(bool(causal)), int(window), float(softcap), stream)
    else:
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse_ptr, _DTYPE_CODE[q.dtype], B, Sq, Skv, H, Hkv, D,
                     float(sc), int(bool(causal)), int(window),
                     float(softcap), stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.tc_launches += int(tc)
    return (o, lse) if return_lse else o


flash_attention.launches = 0
flash_attention.tc_launches = 0


def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    dq, dkv = lib.flash_attention_dq_launch, lib.flash_attention_dkv_launch
    if dq.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, f, p]
        dq.restype = ctypes.c_int
        dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, i,
                        f, p]
        dkv.restype = ctypes.c_int
    return dq, dkv


def _stats_ok(name: str, q: torch.Tensor, lse: torch.Tensor,
              delta: torch.Tensor) -> None:
    want = (q.shape[0], q.shape[2], q.shape[1])
    for key, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} must be f32 {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                       window: int = 0, softcap: float = 0.0,
                       scale: float | None = None) -> torch.Tensor:
    """Launch the dQ kernel. q/do: (B, Sq, H, D); k/v: (B, Skv, Hkv, D);
    lse/delta: (B, H, Sq) f32. Returns dq in q's dtype."""
    _check("flash_attention_dq", q, k, v, do=do, lse=lse, delta=delta)
    _stats_ok("flash_attention_dq", q, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash_attention_dq: do must match q")
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / D ** 0.5
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_lib()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), _DTYPE_CODE[q.dtype], B, Sq, Skv, H,
                        Hkv, D, float(sc), int(bool(causal)), int(window),
                        float(softcap), stream)
    _build.check(err, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        scale: float | None = None):
    """Launch the dK/dV kernel (the GQA group summed inside it). Shapes as
    :func:`flash_attention_dq`; returns (dk, dv) in k's dtype."""
    _check("flash_attention_dkv", q, k, v, do=do, lse=lse, delta=delta)
    _stats_ok("flash_attention_dkv", q, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash_attention_dkv: do must match q")
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / D ** 0.5
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_lib()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], B,
                        Sq, Skv, H, Hkv, D, float(sc), int(bool(causal)),
                        int(window), float(softcap), stream)
    _build.check(err, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        scale: float | None = None):
    """dQ/dK/dV of :func:`flash_attention` from its stashed (o, lse): the
    per-row D = Σ do∘o as a plain f32 reduction, then the dQ and dK/dV
    kernels. Returns (dq, dk, dv) in the inputs' dtype."""
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
    delta = delta.permute(0, 2, 1).contiguous()                # (B, H, Sq)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    dq = flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv

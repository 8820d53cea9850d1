"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain version.

Replaces the TPU kernel ``_flash_kernel`` of
``repro/kernels/flash_attention.py`` (``flash_attention``, with
``return_lse``). At the serving prefill on an H100 it is bound by its
operations; the (Sq × Skv) logits never leave the SM and kv tiles that the
causal/window mask cannot reach are skipped (see the note at the top of the
CUDA source for its design).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fxp_matmul import check_card
from repro_torch.kernels.ref import ref_flash_attention

plain = ref_flash_attention

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    scale: float | None = None, return_lse: bool = False):
    """Launch the CUDA kernel. q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D), all
    contiguous and of one dtype (bf16/f32); returns o (B, Sq, H, D) in q's
    dtype and, with ``return_lse``, the per-row logsumexp (B, H, Sq) f32.
    Queries are end-aligned (q_offset = Skv − Sq); a row that no key
    reaches is 0 with lse = -1e30."""
    check_card(q)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} not in 1..{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    sc = scale if scale is not None else 1.0 / D ** 0.5
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), _DTYPE_CODE[q.dtype],
                 B, Sq, Skv, H, Hkv, D, float(sc), int(bool(causal)),
                 int(window), float(softcap), stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0

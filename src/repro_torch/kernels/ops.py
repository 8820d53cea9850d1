"""Dispatch over the port's kernels (counterpart of ``repro/kernels/ops.py``,
serving subset: forward only).

The rule, by the device of the tensor each op is given:

* a CPU tensor → the plain PyTorch version (``kernels/ref.py``);
* a CUDA tensor → the hand-written kernel, which raises unless the device
  has compute capability 9.0.

There is no fallback from the kernel to the plain version and no switch to
force one. ``use_pallas`` keeps the reference's meaning: ``False`` is the
plain XLA-style path (dequantize-then-matmul, masked attention) on any
device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fxp_matmul as _fm
from repro_torch.kernels import ref


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
    """y = x @ (wq * scale) (+ bias), f32 accumulation, any ⟨M,K,N⟩."""
    if use_pallas and _on_card(x):
        out = _fm.fxp_matmul(x, wq, scale.reshape(()), out_dtype=out_dtype)
        return out if bias is None else out + bias
    return ref.ref_fxp_matmul(x, wq, scale, bias, out_dtype=out_dtype)


def fxp_dense(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
              wref: torch.Tensor, *, use_pallas: bool = False,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The model's dense layer over materialized int8 words (the packed
    ⟨q8, sc, wref⟩ container), forward only: the straight-through gradient
    rule comes with the training slice. Without ``use_pallas`` it is the
    f32 dequant-then-dot the kernel replaces."""
    if use_pallas:
        return fxp_matmul(x, wq, scale, use_pallas=True, out_dtype=out_dtype)
    wv = (wq.to(torch.float32) * scale.to(torch.float32).reshape(())
          + wref.to(torch.float32))
    out = torch.matmul(x.to(torch.float32), wv)
    return out.to(out_dtype or x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: float | None = None, use_pallas: bool = False
              ) -> torch.Tensor:
    """Attention over (B, S, H, D) tensors. With ``use_pallas``: the flash
    contract (a row that no key reaches is 0), on the card the CUDA kernel.
    Without it: ``ref_attention``."""
    if use_pallas:
        if _on_card(q):
            return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
        return ref.ref_flash_attention(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
    return ref.ref_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)

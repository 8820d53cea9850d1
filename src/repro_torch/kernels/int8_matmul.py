"""The W8A8 matmul: the CUDA kernel of ``csrc/int8_matmul.cu`` beside its
plain version.

``int8_matmul`` replaces the TPU kernel ``_int8_matmul_kernel`` of
``repro/kernels/fxp_matmul.py`` (reached through ``int8_matmul`` and its
VJP): out = f32(Σ_k xq·wq)·s for int8 words xq (M, K) and wq (K, N), the
sum exact in int32 and s = f32(sx)·f32(sw) formed once (``fxp_matmul.py:181``),
any ⟨M, K, N⟩. On an H100 it is bound by its operations at every dense
shape. Where TMA can address both operands (``takes_tensor_cores``: K and
N multiples of 16, both bases 16-byte aligned) it runs on the int8 tensor
cores (wgmma, the words transposed to K-major in the kernel), counted in
``int8_matmul.tc_launches``; any other shape takes a SIMT ``__dp4a``
kernel. A CPU tensor takes the plain version; a CUDA tensor takes a kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fxp_matmul import check_card
from repro_torch.kernels.ref import ref_int8_matmul_kernel

plain = ref_int8_matmul_kernel

# |Σ_k xq·wq| ≤ K·2^14 stays below 2^31 up to this depth: the int32 sum
# cannot wrap, and the card's plain version (an f64 product) is exact.
MAX_K = 131071


def _lib():
    lib = _build.load("int8_matmul")
    fns = (lib.int8_matmul_launch, lib.int8_matmul_tc_launch)
    if fns[0].argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in fns:
            fn.argtypes = [p, p, p, p, i, i, i, p]
            fn.restype = ctypes.c_int
    return fns


def takes_tensor_cores(k: int, n: int, xq_ptr: int, wq_ptr: int) -> bool:
    """Whether ``int8_matmul`` of (M, k) @ (k, n) int8 words at these
    addresses takes the tensor-core kernel: TMA must address both operands'
    rows (k and n multiples of 16 bytes, both bases 16-byte aligned), and
    k > 0. Any other shape takes the ``__dp4a`` kernel."""
    return (k > 0 and k % 16 == 0 and n % 16 == 0 and xq_ptr % 16 == 0
            and wq_ptr % 16 == 0)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, s: torch.Tensor
                ) -> torch.Tensor:
    """f32 (M, N) = f32(xq @ wq, exact int32)·s. xq: (M, K) int8, wq: (K, N)
    int8, both contiguous; s: a one-element f32 tensor on the same device,
    read by the kernel (no host synchronisation). The tensor cores where
    ``takes_tensor_cores``, else the ``__dp4a`` kernel."""
    if xq.device.type == "cpu":
        return plain(xq, wq, s)
    check_card(xq)
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(xq.shape)} @ "
                         f"{tuple(wq.shape)}")
    for name, t in (("xq", xq), ("wq", wq)):
        if t.dtype != torch.int8 or not t.is_contiguous() \
                or t.device != xq.device:
            raise ValueError(f"int8_matmul: {name} must be contiguous int8 on "
                             f"{xq.device}, got {t.dtype} on {t.device}")
    if s.dtype != torch.float32 or s.numel() != 1 or s.device != xq.device:
        raise ValueError(f"int8_matmul: s must be one float32 element on "
                         f"{xq.device}, got {s.dtype} {tuple(s.shape)}")
    M, K = xq.shape
    N = wq.shape[1]
    if K > MAX_K or max(M, N) >= 2 ** 31:
        raise ValueError(f"int8_matmul: ({M}, {K}, {N}) past the kernel's "
                         f"range (K ≤ {MAX_K})")
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    tc = takes_tensor_cores(K, N, xq.data_ptr(), wq.data_ptr())
    err = _lib()[int(tc)](xq.data_ptr(), wq.data_ptr(),
                          s.contiguous().data_ptr(), out.data_ptr(), M, K, N,
                          stream)
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    int8_matmul.tc_launches += int(tc)
    return out


int8_matmul.launches = 0
int8_matmul.tc_launches = 0

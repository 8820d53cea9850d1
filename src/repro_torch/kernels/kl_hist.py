"""The KL probe's double histogram: the CUDA kernel of ``csrc/kl_hist.cu``
beside its plain version.

``kl_hist`` replaces the TPU kernel ``_kl_hist_kernel`` of
``repro/kernels/kl_hist.py`` (reached through ``kl_hist``): f32 counts
(2, num_bins) of w and of its quantized copy q over w's [min, max], each
element in bin clip(floor((x − lo)·inv_span), 0, num_bins − 1) with
inv_span = num_bins / max(hi − lo, 1e-12), the TPU kernel's formula (its
jnp oracle divides by the span instead, which at a bin boundary can move an
element one bin over). lo and hi are taken on the device here, outside the
kernel, as the TPU kernel's wrapper takes them. On an H100 it is bound by
its bytes (8 per element). A CPU tensor takes the plain version; a CUDA
tensor takes the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fxp_matmul import check_card
from repro_torch.kernels.ref import ref_kl_hist_kernel

plain = ref_kl_hist_kernel

_SHARED_DEFAULT = 48 * 1024     # per block, without an opt-in
_SHARED_MAX = 232448            # the H100's opt-in limit per block


def _lib():
    fn = _build.load("kl_hist").kl_hist_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def kl_hist(w: torch.Tensor, q: torch.Tensor, num_bins: int = 256
            ) -> torch.Tensor:
    """f32 counts (2, num_bins) of w (row 0) and q (row 1), both of w's
    number of elements (cast to f32 if they are not). An element whose
    bin is NaN is counted in no row, as in the Pallas kernel."""
    if w.device.type == "cpu":
        return plain(w, q, num_bins)
    check_card(w)
    if q.device != w.device or q.numel() != w.numel():
        raise ValueError(f"kl_hist: q must have w's {w.numel()} elements on "
                         f"{w.device}, got {q.numel()} on {q.device}")
    n = w.numel()
    if n >= 2 ** 31:
        raise ValueError(f"kl_hist: {n} elements overflow the int32 counts")
    nb = int(num_bins)
    smem = max(_SHARED_DEFAULT, 8 * nb)
    if nb <= 0 or smem > _SHARED_MAX:
        raise ValueError(f"kl_hist: {nb} bins do not fit the kernel's shared "
                         "memory")
    wf = w.reshape(-1).to(torch.float32).contiguous()
    qf = q.reshape(-1).to(torch.float32).contiguous()
    lohi = torch.stack(torch.aminmax(wf))
    counts = torch.empty((2, nb), dtype=torch.int32, device=w.device)
    out = torch.empty((2, nb), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = _lib()(wf.data_ptr(), qf.data_ptr(), lohi.data_ptr(),
                 counts.data_ptr(), out.data_ptr(), n, nb, smem, stream)
    _build.check(err, "kl_hist")
    kl_hist.launches += 1
    return out


kl_hist.launches = 0

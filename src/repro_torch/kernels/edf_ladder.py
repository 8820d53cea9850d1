"""PushDown's EDF ladder in one pass: the CUDA kernel of
``csrc/edf_ladder.cu`` beside its plain version.

``edf_ladder_hists`` replaces the TPU kernel ``_edf_ladder_kernel`` of
``repro/kernels/edf_ladder.py`` (reached through ``edf_ladder_hists``).
For each layer of a (L, n) batch of subsampled weights it counts, into a
(1+T, r_upr) table, the master's histogram (row 0) and the histogram of
the weights rounded to nearest (half to even) on each WL-ladder candidate
⟨wl_ladder[t], fls[t]⟩ (row 1+t), all over the layer's own [min, max] with
r live bins. The reference runs one layer per call under ``jax.vmap``;
here one launch covers every layer of a leaf. The work is tiny (19 bins
per element of a 65536-element subsample): on an H100 it is bound by its
launch latency. A CPU tensor takes the plain version; a CUDA tensor takes
the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fxp_matmul import check_card
from repro_torch.kernels.ref import ref_edf_ladder_hists

plain = ref_edf_ladder_hists

_SHARED_BYTES = 48 * 1024       # the kernel's counters live in shared memory


def _lib():
    fn = _build.load("edf_ladder").edf_ladder_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return fn


def edf_ladder_hists(w: torch.Tensor, fls: torch.Tensor, r: torch.Tensor, *,
                     wl_ladder: tuple, r_upr: int) -> torch.Tensor:
    """f32 counts (L, 1+T, r_upr) of w (L, n) f32, fls (L, T) int32 and
    r (L,) int32 (each r[l] ≤ r_upr). An element whose bin is NaN (the
    layer's max − min overflows to inf) is counted in no row, as in the
    Pallas kernel."""
    if w.device.type == "cpu":
        return plain(w, fls, r, wl_ladder=wl_ladder, r_upr=r_upr)
    check_card(w)
    T = len(wl_ladder)
    if w.ndim != 2 or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"edf_ladder_hists: w must be contiguous float32 "
                         f"(L, n), got {w.dtype} {tuple(w.shape)}")
    L, n = w.shape
    if n >= 2 ** 31:
        raise ValueError(f"edf_ladder_hists: {n} elements overflow int32 "
                         "indexing: subsample first (pushdown.subsample)")
    fls = fls.to(torch.int32).contiguous()
    r = r.to(torch.int32).contiguous()
    for name, t, shape in (("fls", fls, (L, T)), ("r", r, (L,))):
        if t.device != w.device or tuple(t.shape) != shape:
            raise ValueError(f"edf_ladder_hists: {name} must be {shape} on "
                             f"{w.device}, got {tuple(t.shape)} on {t.device}")
    if (1 + T) * r_upr * 4 + 3 * T * 4 > _SHARED_BYTES:
        raise ValueError(f"edf_ladder_hists: {1 + T} x {r_upr} counters do "
                         "not fit the kernel's shared memory")
    lo = w.amin(dim=1)
    hi = w.amax(dim=1)
    # qmax of each rung as the reference's kernel takes it: the f32 of the
    # double 2^(wl-1) - 1 (2^31 for WL 32)
    qmax = torch.tensor([2.0 ** (wl - 1) - 1.0 for wl in wl_ladder],
                        dtype=torch.float32).to(w.device)
    counts = torch.empty((L, 1 + T, r_upr), dtype=torch.int32, device=w.device)
    out = torch.empty((L, 1 + T, r_upr), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = _lib()(w.data_ptr(), fls.data_ptr(), r.data_ptr(), lo.data_ptr(),
                 hi.data_ptr(), qmax.data_ptr(), counts.data_ptr(),
                 out.data_ptr(), L, n, T, r_upr, stream)
    _build.check(err, "edf_ladder_hists")
    edf_ladder_hists.launches += 1
    return out


edf_ladder_hists.launches = 0

"""PushDown's EDF ladder in one pass: the CUDA kernel of
``csrc/edf_ladder.cu`` beside its plain version.

``edf_ladder_hists`` replaces the TPU kernel ``_edf_ladder_kernel`` of
``repro/kernels/edf_ladder.py:41`` (reached through ``edf_ladder_hists`` at
``:83``). For each layer of a (L, n) batch of subsampled weights it counts,
into a (1+T, r_upr) table, the master's histogram (row 0) and the histogram
of the weights rounded to nearest (half to even) on each WL-ladder
candidate ⟨wl_ladder[t], fls[t]⟩ (row 1+t), all over the layer's own
[min, max] with r live bins. The reference runs one layer per call under
``jax.vmap``; here one launch covers every layer of a leaf: a cluster of
``CLUSTER`` CTAs a layer, each binning a slice held in shared memory, the
narrow rungs (WL ≤ ``LEVEL_WL``) by integer level. Its bound, each input
read once and ~166 f32 operations an element, is 0.0045 ms at (28, 65536)
and 0.00016 ms at (1, 65536), below a launch's own cost; on an H100 at
700 W a call takes 0.055–0.056 and 0.042 ms by device time, set by
each thread's chain of dependent work (PERF.md §6). A CPU tensor takes the
plain version; a CUDA tensor takes the kernel or raises.

The functions below mirror the kernel's plan (its slices, staging split
and level counters) for the CPU tests.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fxp_matmul import check_card
from repro_torch.kernels.ref import ref_edf_ladder_hists

plain = ref_edf_ladder_hists

# The kernel's constants (csrc/edf_ladder.cu).
CLUSTER = 8             # CTAs a layer, one cluster
SLICE = 8192            # elements a CTA holds in shared memory
LEVEL_WL = 12           # rungs of WL <= LEVEL_WL count integer levels
LEVELS = 8192           # level counters a CTA
MAX_T = 32              # rungs of the ladder
COUNT_INTS = 12288      # (1 + T) x r_upr counters in shared memory


def level_plan(wl_ladder: tuple) -> tuple[list[int], int]:
    """(off, levels): rung t counts its levels from counter off[t] (-1: it
    bins each element), ``levels`` counters in all: the narrow rungs
    (1 ≤ WL ≤ LEVEL_WL) in ladder order while their 2^WL levels fit."""
    off, levels = [], 0
    for wl in wl_ladder:
        narrow = 1 <= wl <= LEVEL_WL and levels + (1 << wl) <= LEVELS
        off.append(levels if narrow else -1)
        levels += (1 << wl) if narrow else 0
    return off, levels


def slice_of(n: int, rank: int) -> tuple[int, int]:
    """Elements [start, end) of a layer of n that CTA ``rank`` takes."""
    s = -(-n // CLUSTER)
    start = min(rank * s, n)
    return start, min(start + s, n)


def chunks_of(n: int, start: int, end: int) -> list[tuple[int, int]]:
    """The pieces [c0, c1) in which a CTA stages its slice: the whole slice
    when every slice of the layer fits (ceil(n / CLUSTER) ≤ SLICE), else
    SLICE at a time (read twice: min and max from device memory first)."""
    if -(-n // CLUSTER) <= SLICE:
        return [(start, end)]
    return [(c0, min(c0 + SLICE, end)) for c0 in range(start, end, SLICE)]


def phase_of(addr: int) -> int:
    """Flat element g of a float32 tensor at ``addr`` lies on a 16-byte
    boundary when g % 4 == phase_of(addr)."""
    return -(addr >> 2) & 3


def stage_split(g_row: int, c0: int, c1: int, phase: int) -> tuple[int, int, int]:
    """(a, b, pad): elements [c0, c1) of a layer starting at flat element
    g_row are staged at shared offset pad + (e - c0); [a, b) by one bulk
    copy (16-byte aligned at both ends), the rest by the threads."""
    a = min(c0 + ((phase - (g_row + c0)) & 3), c1)
    return a, a + ((c1 - a) & ~3), (c0 - a) & 3


def _lib():
    fn = _build.load("edf_ladder").edf_ladder_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 3 + [ctypes.POINTER(ctypes.c_int), i, p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _ladder(wl_ladder: tuple):
    return (ctypes.c_int * max(len(wl_ladder), 1))(*wl_ladder)


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
    if L > 65535:
        raise ValueError(f"edf_ladder_hists: {L} layers exceed the grid's "
                         "65535")
    fls = fls.to(torch.int32).contiguous()
    r = r.to(torch.int32).contiguous()
    for name, t, shape in (("fls", fls, (L, T)), ("r", r, (L,))):
        if t.device != w.device or tuple(t.shape) != shape:
            raise ValueError(f"edf_ladder_hists: {name} must be {shape} on "
                             f"{w.device}, got {tuple(t.shape)} on {t.device}")
    if T > MAX_T or (1 + T) * r_upr > COUNT_INTS:
        raise ValueError(f"edf_ladder_hists: {1 + T} x {r_upr} counters do "
                         "not fit the kernel's shared memory")
    out = torch.empty((L, 1 + T, r_upr), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = _lib()(w.data_ptr(), fls.data_ptr(), r.data_ptr(), out.data_ptr(),
                 L, n, T, _ladder(tuple(wl_ladder)), r_upr, stream)
    _build.check(err, "edf_ladder_hists")
    edf_ladder_hists.launches += 1
    return out


edf_ladder_hists.launches = 0

"""QSGD-style gradient compression across pods (counterpart of
``repro/quant/qsgd.py``).

Gradients are stochastically quantized to signed int8 (per-tensor
max-norm scale, unbiased) before the sum over the "pod" axis and decoded
after: the payload that crosses between pods is the int8 words and one f32
scale a tensor, a quarter of the f32 bytes. E[decode(encode(g))] = g.

The noise of leaf i is ``jax.random.uniform(fold_in(step_key, i),
g.shape)`` (``core/threefry.py``), i the leaf's index in the reference's
flatten order: JAX sorts the keys of every dict, so the leaves go in the
order of their key paths compared key by key (``sorted_paths``), not in
the insertion order of the port's trees. Every pod draws the same noise.
A rank that holds a block of a pod's gradient (the data-axis fold) takes
the maximum over the pod's ranks (``all_reduce`` max) and draws the noise
of its block's own elements, so its words are those of the whole tensor's.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import distributed as dst
from repro_torch.core import threefry
from repro_torch.core.controller import flatten_with_path, map_with_path


def sorted_paths(paths: Sequence[str]) -> list:
    """Slash paths in JAX's flatten order of a tree of dicts."""
    return sorted(paths, key=lambda p: p.split("/"))


# Elements encoded at a time: the noise's int64 hash words and the f32
# temporaries stay a chunk's, not a leaf's (an embedding's gradient is
# 394 M elements at full width).
_CHUNK = 1 << 24


def encode(g: torch.Tensor, key, bits: int = 8, *, amax=None,
           place=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, f32 scale) with E[q·scale] = g: q = floor(x) + [u < frac],
    x = g/amax·levels, clipped to [−levels − 1, levels], scale =
    amax/levels, levels = 2^(bits−1) − 1, amax = max(max|g|, 1e-30).
    ``amax`` given (the maximum over the whole tensor when ``g`` is a
    block of it); ``place`` = (whole shape, block starts) draws the noise
    of the block's elements in the whole tensor. Chunk by chunk
    (``_CHUNK``); the bits do not depend on it."""
    levels = float(2 ** (bits - 1) - 1)
    gf = g.to(torch.float32).reshape(-1)
    if amax is None:
        amax = torch.linalg.vector_norm(gf, ord=float("inf"))
    amax = torch.clamp(amax.to(torch.float32), min=1e-30)
    q = torch.empty(gf.shape, dtype=torch.int8, device=g.device)
    for start in range(0, gf.numel(), _CHUNK):
        count = min(_CHUNK, gf.numel() - start)
        u = threefry.uniform(key, tuple(g.shape), offset=start, count=count,
                             device=g.device, place=place)
        x = gf[start:start + count] / amax * levels
        f = torch.floor(x)
        x = f + (u < (x - f)).to(torch.float32)
        q[start:start + count] = torch.clamp(x, -levels - 1, levels)
    return q.reshape(g.shape), (amax / levels).to(torch.float32)


def decode(q: torch.Tensor, scale: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def sum_decoded(qs: Sequence[torch.Tensor], scales: Sequence[torch.Tensor]
                ) -> torch.Tensor:
    """Σ_p decode(q_p, s_p) in pod order, each pod's payload decoded to f32
    first (scales differ per pod)."""
    acc = decode(qs[0], scales[0])
    for q, s in zip(qs[1:], scales[1:]):
        acc = acc + decode(q, s)
    return acc


def psum_compressed(grads, key, mesh, axis_name: str = "pod",
                    bits: int = 8, *, placements: Optional[Dict] = None,
                    amax_axes: Sequence[str] = ()):
    """Sum a gradient tree over the ranks along ``axis_name`` with an int8
    payload: each rank encodes its gradient (leaf i with
    fold_in(key, i)), the words and scales are all-gathered along the
    axis, and every rank decodes and sums them in pod order, so all get
    the same bits. ``placements[path]`` = (whole shape, block starts) for a
    leaf held as a block, whose amax is all-reduced (max) over
    ``amax_axes`` (the axes of the pod's ranks that hold its other
    blocks). Returns a tree of the same structure (f32)."""
    placements = placements or {}
    flat = dict(flatten_with_path(grads))
    order = {p: i for i, p in enumerate(sorted_paths(flat))}
    g_ax, ranks = mesh.group((axis_name,)) if hasattr(mesh, "group") \
        else (None, [0])
    out = {}
    for p in sorted_paths(flat):
        g = flat[p]
        place = placements.get(p)
        if place is not None and tuple(place[0]) == tuple(g.shape):
            place = None              # a block that is the whole tensor
        amax = None
        if place is not None:
            amax = torch.linalg.vector_norm(g.to(torch.float32),
                                            ord=float("inf"))
            dst.all_reduce(amax, amax_axes, mesh, op="max")
        q, s = encode(g, threefry.fold_in(key, order[p]), bits, amax=amax,
                      place=place)
        if g_ax is None:
            out[p] = decode(q, s)
            continue
        qs = _gather_payload(q, g_ax, len(ranks), mesh)
        ss = _gather_payload(s.reshape(1), g_ax, len(ranks), mesh)
        out[p] = sum_decoded(qs, [t.reshape(()) for t in ss])
    return map_with_path(lambda p, _: out[p], grads)


def _gather_payload(t: torch.Tensor, group, n: int, mesh) -> list:
    import torch.distributed as dist
    h = dst._host(t.contiguous(), mesh)
    mesh.count("all_gather", h)
    parts = [torch.empty_like(h) for _ in range(n)]
    dist.all_gather(parts, h, group=group)
    return [x.to(t.device) for x in parts]

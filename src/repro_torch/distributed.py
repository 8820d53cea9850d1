"""The (pod, data, model) mesh on ``torch.distributed``: what GSPMD does
for the reference's jitted step, done explicitly, and nothing more.

Ranks lie on a (pod, data, model) mesh in row-major order: rank
r = (pod·D + data)·M + model, as ``jax.make_mesh`` orders its devices.
Every rank runs the model on its own rows of the batch; it holds the block
that a leaf's spec gives it (``local_block``), gathers the quantized
copy's blocks along the leaf's data axes (``all_gather``) and keeps its
``model`` block for compute, and sums the gradients into its block along
the data axes (``reduce_scatter``). Sums of squares and maxima over a leaf
held in blocks are ``all_reduce``\\ d over every axis its spec names.

On a model axis of more than one rank the layers compute on their
``model`` blocks (tensor and expert parallelism, the Megatron pattern) and
meet through ``ModelGroup``: copy to model (identity forward, all-reduce
backward), reduce from model (all-reduce forward, identity backward) and
gather from model (all-gather forward, the rank's own slice backward).

``init_mesh`` makes one process group per subset of the mesh's axes
(whose sizes multiply to more than one) and per position along the other
axes; a collective over axes whose sizes multiply to one is the identity,
so a one-rank mesh needs no process group at all.

The backend is the caller's choice, never probed for:

* ``nccl`` when each rank has its own GPU (device ``cuda:LOCAL_RANK``);
  asking for it with more ranks on a host than it has GPUs raises;
* ``gloo`` when ranks share one card or run on the CPU. Gloo is given
  host tensors only: a CUDA payload is copied to host memory, reduced or
  gathered there and copied back. That is transport; the compute stays on
  the card. Gloo has no reduce-scatter: it runs as one ``reduce`` to each
  member of the group of its block.
"""
from __future__ import annotations

import itertools
import math
import os
from datetime import timedelta
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding import (Mesh, NamedSharding, P, folded_axes,
                                  held_in_blocks, shard_grid, spec_dim_axes)

AXES = ("pod", "data", "model")


def rank_coords(rank: int, axis_names: Sequence[str],
                sizes: Sequence[int]) -> Dict[str, int]:
    """Coordinates of ``rank`` on a row-major mesh."""
    out = {}
    for a, s in zip(reversed(tuple(axis_names)), reversed(tuple(sizes))):
        out[a] = rank % s
        rank //= s
    return {a: out[a] for a in axis_names}


class RankMesh(Mesh):
    """This rank's view of the mesh: coordinates, backend, device, the
    process group of each subset of axes that contains it, and
    ``sent_bytes``: the bytes of this rank's own payload handed to each
    kind of collective over more than one rank (a reduce-scatter's whole
    input, an all-gather's block), the record of what a step moves."""

    def __init__(self, axis_names, sizes, rank: int, backend: str,
                 device: torch.device):
        super().__init__(axis_names, sizes,
                         rank_coords(rank, axis_names, sizes))
        self.rank = rank
        self.backend = backend
        self.device = torch.device(device)
        self.groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        self.sent_bytes = {"all_gather": 0, "reduce_scatter": 0,
                           "all_reduce": 0, "broadcast": 0,
                           "model_all_reduce": 0, "model_all_gather": 0}

    def count(self, kind: str, t: torch.Tensor) -> None:
        self.sent_bytes[kind] += t.numel() * t.element_size()

    def rank_at(self, coords: Mapping[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def group(self, axes: Sequence[str]):
        """(process group, member ranks) of ``axes`` through this rank, or
        (None, [rank]) when their sizes multiply to one."""
        key = tuple(a for a in self.axis_names
                    if a in axes and self.shape[a] > 1)
        if not key:
            return None, [self.rank]
        return self.groups[key]


def _check_backend(backend: str, device: torch.device, local_world: int):
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        n = torch.cuda.device_count()
        if device.type != "cuda" or local_world > n:
            raise ValueError(
                f"nccl needs one GPU per rank: {local_world} ranks on this "
                f"host and {n} GPUs (device {device}); ranks that share a "
                "card or run on the CPU take backend='gloo'")


def init_mesh(sizes: Mapping[str, int], backend: str, *, device=None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              init_method: Optional[str] = None,
              timeout_s: float = 600.0) -> RankMesh:
    """Join the process group (torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` unless ``rank``,
    ``world_size`` and ``init_method`` are given) and make the mesh's
    groups. ``sizes``: {"pod": p, "data": d, "model": m}, missing axes 1;
    p·d·m must be the world size. ``device`` defaults to
    ``cuda:LOCAL_RANK`` under nccl and to ``cuda`` under gloo, which raises
    on a host without CUDA: the CPU is ``device="cpu"``. A one-rank mesh
    makes no process group."""
    names = AXES
    shape = [int(sizes.get(a, 1)) for a in names]
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
             else int(world_size))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} has "
                         f"{math.prod(shape)} ranks, the world {world}")
    if device is None and backend == "nccl":
        device = f"cuda:{local_rank}"
    _check_backend(backend, torch.device("cuda" if device is None
                                         else device), local_world)
    device = resolve_device(device)
    mesh = RankMesh(names, shape, rank, backend, device)
    if world == 1:
        return mesh
    if backend == "nccl":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = {"backend": backend, "rank": rank, "world_size": world,
              "timeout": timedelta(seconds=timeout_s)}
        if init_method is not None:
            kw["init_method"] = init_method
        dist.init_process_group(**kw)
    # every rank makes every group, in the same order
    for k in range(1, len(names) + 1):
        for key in itertools.combinations(names, k):
            if any(mesh.shape[a] == 1 for a in key):
                continue
            rest = [a for a in names if a not in key]
            for vals in itertools.product(*(range(mesh.shape[a])
                                            for a in rest)):
                ranks = []
                for kv in itertools.product(*(range(mesh.shape[a])
                                              for a in key)):
                    c = dict(zip(rest, vals))
                    c.update(zip(key, kv))
                    ranks.append(mesh.rank_at(c))
                ranks = sorted(ranks)
                g = dist.new_group(ranks)
                if rank in ranks:
                    mesh.groups[key] = (g, ranks)
    return mesh


def destroy(mesh: Optional[RankMesh] = None) -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Blocks


def block_slices(shape, spec, mesh: Mesh,
                 coords: Optional[Mapping[str, int]] = None
                 ) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that the rank at ``coords``
    (default ``mesh.coords``) holds under ``spec``: along each dim, block
    i of the grid, i the row-major index over the dim's axes."""
    coords = mesh.coords if coords is None else coords
    grid = shard_grid(shape, spec, mesh)
    if grid is None:
        raise ValueError(f"spec {spec} does not divide shape {tuple(shape)} "
                         f"on {mesh.shape}")
    out = []
    for d, axes in enumerate(spec_dim_axes(spec, len(shape))):
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + coords[a]
        b = shape[d] // grid[d]
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


def local_block(x: torch.Tensor, spec, mesh: Mesh,
                coords: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """The rank's block of ``x`` (a view; a column block is not contiguous
    in memory)."""
    return x[block_slices(x.shape, spec, mesh, coords)]


def shard_index(spec, mesh: Mesh, ndim: int,
                coords: Optional[Mapping[str, int]] = None) -> int:
    """The linear shard index the per-shard seed folds: the axes the spec
    names, in dim order, row-major (``repro/kernels/ops.py:64-68``). Axes
    the spec does not name leave it unchanged, so replicas along them
    compute the same words."""
    coords = mesh.coords if coords is None else coords
    idx = 0
    for a in folded_axes(spec, ndim):
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def block_place(sh: NamedSharding):
    """(whole shape, block starts) of the rank's block of a tensor laid out
    by ``sh`` (a spec on the rank's mesh, with the whole shape)."""
    return sh.shape, tuple(s.start for s in
                           block_slices(sh.shape, sh.spec, sh.mesh))


def _host(t: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """The tensor gloo is given: a host copy of a CUDA tensor."""
    if mesh.backend == "gloo" and t.device.type != "cpu":
        return t.to("cpu")
    return t


def all_gather(block: torch.Tensor, spec, mesh: RankMesh, shape
               ) -> torch.Tensor:
    """The whole tensor of ``shape`` from the blocks that the ranks along
    the spec's axes hold, each placed at its own coordinates."""
    axes = folded_axes(spec, len(shape))
    g, ranks = mesh.group(axes)
    if g is None:
        return block
    src = _host(block.contiguous(), mesh)
    mesh.count("all_gather", src)
    parts = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(parts, src, group=g)
    out = torch.empty(tuple(shape), dtype=block.dtype, device=block.device)
    for r, part in zip(ranks, parts):
        c = rank_coords(r, mesh.axis_names,
                        [mesh.shape[a] for a in mesh.axis_names])
        out[block_slices(shape, spec, mesh, c)] = part.to(block.device)
    return out


def reduce_scatter(full: torch.Tensor, spec, mesh: RankMesh) -> torch.Tensor:
    """The rank's block of the sum over the ranks along the spec's axes of
    their whole ``full`` tensors."""
    axes = folded_axes(spec, full.ndim)
    g, ranks = mesh.group(axes)
    if g is None:
        return local_block(full, spec, mesh).contiguous()
    names = mesh.axis_names
    sizes = [mesh.shape[a] for a in names]
    chunks = [local_block(full, spec, mesh,
                          rank_coords(r, names, sizes)).contiguous()
              for r in ranks]
    mesh.count("reduce_scatter", full)
    if mesh.backend == "nccl":
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=g)
        return out
    mine = None
    for r, c in zip(ranks, chunks):
        h = _host(c, mesh)
        dist.reduce(h, dst=r, group=g)
        if r == mesh.rank:
            mine = h.to(full.device)
    return mine


def all_reduce(t: torch.Tensor, axes: Sequence[str], mesh: Mesh,
               op: str = "sum", kind: str = "all_reduce") -> torch.Tensor:
    """``t`` summed (or its maximum taken) over the ranks along ``axes``;
    every one of them gets the same bits. In place when ``t`` is on the
    device the collective runs on; returns the result. ``kind``: the
    ``sent_bytes`` entry that counts it."""
    if not isinstance(mesh, RankMesh):
        return t
    g, _ = mesh.group(axes)
    if g is None:
        return t
    mesh.count(kind, t)
    h = _host(t, mesh)
    dist.all_reduce(h, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=g)
    if h is not t:
        t.copy_(h)
    return t


def broadcast(t: torch.Tensor, axes: Sequence[str], mesh: RankMesh,
              src: Mapping[str, int]) -> torch.Tensor:
    """``t`` of the rank at coordinates ``src`` (along ``axes``) on every
    rank along ``axes``."""
    g, _ = mesh.group(axes)
    if g is None:
        return t
    c = dict(mesh.coords)
    c.update(src)
    mesh.count("broadcast", t)
    h = _host(t, mesh)
    dist.broadcast(h, src=mesh.rank_at(c), group=g)
    if h is not t:
        t.copy_(h)
    return t


# ---------------------------------------------------------------------------
# The model axis: the Megatron pairs


class ModelGroup:
    """This rank's ranks along the model axis (the same coordinates on the
    other axes) and the collectives that the tensor- and expert-parallel
    layers place where GSPMD places them for the reference: ``copy``,
    ``reduce`` and ``gather`` (autograd functions), ``sum`` (no autograd).
    ``index`` is the rank's model coordinate, ``size`` the axis' size;
    ``reduce_bf16`` is ``train.tp_reduce_dtype=bfloat16`` (the reference's
    ``#tp_reduce_bf16``: a row-parallel dense layer's partial product
    crosses the ranks in bf16). Bytes are counted in the mesh's
    ``sent_bytes`` as "model_all_reduce" and "model_all_gather"."""

    def __init__(self, mesh: RankMesh, reduce_bf16: bool = False):
        self.mesh = mesh
        self.size = mesh.shape["model"]
        self.index = mesh.coords["model"]
        self.reduce_bf16 = bool(reduce_bf16)

    def sum(self, t: torch.Tensor, dtype: Optional[torch.dtype] = None
            ) -> torch.Tensor:
        """A new tensor: ``t`` summed over the model ranks in ``dtype``
        (``t``'s by default), returned in ``t``'s dtype; ``t`` is left as
        it is. Every rank gets the same bits."""
        dtype = dtype or t.dtype
        w = t.to(dtype, copy=True).contiguous()
        all_reduce(w, ("model",), self.mesh, kind="model_all_reduce")
        return w.to(t.dtype)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """A new tensor: the elementwise maximum of ``t`` over the model
        ranks."""
        w = t.clone().contiguous()
        return all_reduce(w, ("model",), self.mesh, op="max",
                          kind="model_all_reduce")

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in model order."""
        g, ranks = self.mesh.group(("model",))
        src = _host(t.contiguous(), self.mesh)
        self.mesh.count("model_all_gather", src)
        parts = [torch.empty_like(src) for _ in ranks]
        dist.all_gather(parts, src, group=g)
        return torch.cat([q.to(t.device) for q in parts], dim=dim)

    def own(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's slice of ``t`` along ``dim`` (``size`` equal
        slices, a contiguous copy)."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n).contiguous()

    def copy(self, x: torch.Tensor, sum_dtype=torch.float32) -> torch.Tensor:
        """Copy to model: ``x`` forward; backward, the gradient summed over
        the model ranks (in ``sum_dtype``, rounded once to the gradient's
        dtype). For a tensor whole on every rank whose uses on each rank
        give a part of its gradient."""
        return _CopyToModel.apply(x, self, sum_dtype)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Reduce from model: ``x`` summed over the model ranks (in its
        dtype) forward; backward, the gradient as it is."""
        return _ReduceFromModel.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Gather from model: the ranks' ``x`` concatenated along ``dim``
        forward; backward, the rank's own slice of the gradient, which must
        be whole on every rank (a ``copy`` downstream makes it so)."""
        return _GatherFromModel.apply(x, self, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sum_dtype):
        ctx.group, ctx.sum_dtype = group, sum_dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.sum(g, ctx.sum_dtype), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.own(g, ctx.dim), None, None


def model_group(mesh, reduce_bf16: bool = False) -> Optional[ModelGroup]:
    """The rank's ``ModelGroup`` on a model axis of more than one rank,
    else None."""
    if not isinstance(mesh, RankMesh) or mesh.shape.get("model", 1) == 1:
        return None
    return ModelGroup(mesh, reduce_bf16)


# ---------------------------------------------------------------------------
# A tree held in blocks


def _compute_part(sh: NamedSharding):
    """(spec, shape) of the rank's ``model`` block of a tensor laid out by
    ``sh``, seen as a tensor of its own laid out over the data axes:
    ``model`` leaves the spec and divides its dim of the shape."""
    parts, shape = [], []
    for n, axes in zip(sh.shape, spec_dim_axes(sh.spec, len(sh.shape))):
        keep = tuple(a for a in axes if a != "model")
        shape.append(n // (sh.mesh.shape["model"] if "model" in axes else 1))
        parts.append(None if not keep else
                     (keep[0] if len(keep) == 1 else keep))
    return P(*parts), tuple(shape)


class Layout:
    """How this rank holds the leaves of a tree keyed by path: each path's
    ``NamedSharding`` (the reference's spec and the whole shape) on the
    rank's mesh. A leaf is held as the rank's block when its spec names an
    axis and divides it (``sharding.held_in_blocks``), else whole. The
    rank computes on its *compute block*: the leaf gathered along its data
    axes and cut along ``model`` (``gather``); its gradient is summed back
    into the block along the data axes only (``scatter_sum``)."""

    def __init__(self, mesh: Mesh, shardings: Mapping[str, NamedSharding]):
        self.mesh = mesh
        self.shardings = dict(shardings)

    def held(self, path: str) -> bool:
        sh = self.shardings.get(path)
        return sh is not None and held_in_blocks(sh.shape, sh)

    def spec(self, path: str):
        return self.shardings[path].spec

    def axes(self, path: str) -> Tuple[str, ...]:
        """The mesh axes along which this leaf's blocks differ."""
        if not self.held(path):
            return ()
        sh = self.shardings[path]
        return folded_axes(sh.spec, len(sh.shape))

    def data_axes(self, path: str) -> Tuple[str, ...]:
        """The leaf's axes other than ``model``: those its compute block is
        gathered and its gradient summed along."""
        return tuple(a for a in self.axes(path) if a != "model")

    def block(self, path: str, full: torch.Tensor) -> torch.Tensor:
        """The rank's block of the whole tensor (a contiguous copy), or the
        tensor itself for a leaf held whole."""
        if not self.held(path):
            return full
        return local_block(full, self.spec(path), self.mesh).contiguous()

    def gather(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """The compute block from the rank's block: gathered along the
        leaf's data axes, its ``model`` block kept."""
        if not self.data_axes(path):
            return t
        spec, shape = _compute_part(self.shardings[path])
        return all_gather(t, spec, self.mesh, shape)

    def whole(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from the rank's block, gathered along every
        axis of the leaf's spec."""
        if not self.held(path):
            return t
        sh = self.shardings[path]
        return all_gather(t, sh.spec, self.mesh, sh.shape)

    def scatter_sum(self, path: str, full: torch.Tensor) -> torch.Tensor:
        """The rank's block of Σ over the ranks along the leaf's data axes
        of their compute blocks ``full`` (a ``model`` block's gradient is
        that block's own); ``full`` itself for a leaf with no data
        axis."""
        if not self.data_axes(path):
            return full
        spec, _ = _compute_part(self.shardings[path])
        return reduce_scatter(full, spec, self.mesh)

    def sum_over(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """A partial sum over the rank's block completed to the whole
        tensor (all-reduced along the leaf's axes)."""
        return all_reduce(t, self.axes(path), self.mesh)

    def whole_rows(self, path: str, partial: torch.Tensor,
                   rows: tuple) -> torch.Tensor:
        """Per-layer partial sums of the rank's block (a stacked leaf:
        ``rows`` = (L,)) or one partial sum, completed to the whole
        tensor's: the block's layers at their rows of an (L,) vector of
        zeros, all-reduced."""
        if not self.held(path):
            return partial
        if rows:
            sh = self.shardings[path]
            r0 = block_slices(sh.shape, sh.spec, self.mesh)[0].start
            full = torch.zeros(rows, dtype=partial.dtype,
                               device=partial.device)
            full[r0:r0 + partial.shape[0]] = partial
            partial = full
        return all_reduce(partial.contiguous(), self.axes(path), self.mesh)

    def place(self, path: str):
        """(whole shape, block starts) of a leaf held in blocks, else
        None."""
        return block_place(self.shardings[path]) if self.held(path) else None

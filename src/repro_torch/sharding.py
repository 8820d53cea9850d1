"""Logical-axis sharding of the port (counterpart of ``repro/sharding.py``).

Model code names the dims of a tensor by *logical* axes ("batch", "seq",
"heads", "ff", "experts", "vocab", "embed"); a launcher installs a rule set
that maps each logical axis to mesh axes (``launch/mesh.make_rules``).
Outside any rule context every helper here is a no-op, as in the reference.

A mesh here is a description: its axis names, the size of each, and, on a
rank of a ``torch.distributed`` run, that rank's coordinate on each axis
(``distributed.RankMesh``). Specs and grids are computed from it as the
reference computes them from a ``jax.sharding.Mesh``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Mapping, Optional, Sequence, Tuple


class P(tuple):
    """A partition spec: one entry per leading dim of a tensor, each None
    (replicated), a mesh axis name, or a tuple of names (the dim split over
    their product, the first name major). Shorter than the tensor's rank
    means the remaining dims are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


class Mesh:
    """A mesh description: ``axis_names`` in order, ``shape[name]`` their
    sizes, and ``coords[name]`` the coordinates of one rank (None for a
    description that is no rank's, such as a production mesh)."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 coords: Optional[Mapping[str, int]] = None):
        if len(axis_names) != len(sizes):
            raise ValueError(f"{len(axis_names)} axis names for "
                             f"{len(sizes)} sizes")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in sizes)))
        self.coords = None if coords is None else dict(coords)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def at(self, coords: Mapping[str, int]) -> "Mesh":
        """The same mesh seen from the rank at ``coords``."""
        return Mesh(self.axis_names, [self.shape[a] for a in self.axis_names],
                    coords)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}"
                + (f", coords={self.coords}" if self.coords else "") + ")")


class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``),
    with the global ``shape`` of the tensor it lays out where that is known:
    a rank holds the block that ``spec`` gives it of a tensor of ``shape``
    (``distributed.local_block``)."""

    def __init__(self, mesh: Mesh, spec: P, shape: Optional[tuple] = None):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)
        self.shape = None if shape is None else tuple(shape)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r}, {self.shape})"


_RULES: contextvars.ContextVar[Optional[Tuple[Mesh, Dict[str, tuple]]]] = \
    contextvars.ContextVar("repro_torch_sharding_rules", default=None)


@contextlib.contextmanager
def use_rules(mesh: Mesh, rules: Dict[str, tuple]):
    """rules: logical axis name -> tuple of mesh axis names (or ())."""
    token = _RULES.set((mesh, dict(rules)))
    try:
        yield
    finally:
        _RULES.reset(token)


def active() -> bool:
    return _RULES.get() is not None


def current_mesh() -> Optional[Mesh]:
    ctx = _RULES.get()
    return ctx[0] if ctx else None


def spec(*logical_axes: Optional[str]) -> Optional[P]:
    """Partition spec of a tensor whose dims carry these logical names; a
    mesh axis appears at most once in it (a later dim that asks for an axis
    already used gets the rest of its axes, or None)."""
    ctx = _RULES.get()
    if ctx is None:
        return None
    _, rules = ctx
    parts = []
    used = set()
    for name in logical_axes:
        axes = rules.get(name, ()) if name else ()
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
        else:
            parts.append(tuple(axes))
    return P(*parts)


def shard(x, *logical_axes: Optional[str]):
    """The identity. In the reference this pins ``x``'s layout for GSPMD
    (``with_sharding_constraint``); in the port a rank runs the model on its
    own rows, and the collectives that GSPMD would insert are placed by the
    model code itself: over the batch, the activation quantize's maximum
    (``batch_max``); over the model axis, the Megatron pairs of
    ``distributed`` that the layers call through ``model_group``."""
    return x


# A rank's partial maximum → the whole batch tensor's: set by the
# data-parallel step around its forward and backward (``batch_max_over``),
# read by the activation quantize. A setting of the process, not a context
# variable: the backward, and a checkpointed layer's recompute inside it,
# run on autograd's own threads.
_BATCH_MAX = None


@contextlib.contextmanager
def batch_max_over(fn):
    """Within the block ``batch_max(t)`` is ``fn(t)``: on a rank of a
    data-parallel step, the all-reduce (max) of ``t`` over the ranks whose
    rows make up the reference's batch tensor."""
    global _BATCH_MAX
    prev, _BATCH_MAX = _BATCH_MAX, fn
    try:
        yield
    finally:
        _BATCH_MAX = prev


def batch_max(t):
    """``t``, a maximum over this rank's rows of a batch tensor, made the
    maximum over the whole batch tensor, as the reference's ``jnp.max``
    over a tensor sharded along the batch is (GSPMD adds the all-reduce);
    the identity outside a data-parallel step."""
    return t if _BATCH_MAX is None else _BATCH_MAX(t)


# The rank's group along the model axis (``distributed.ModelGroup``): set by
# the step around its forward and backward (``model_group_of``), read by the
# model code's tensor- and expert-parallel layers. None outside such a step,
# or on a model axis of one rank. A setting of the process, as
# ``batch_max_over``'s, for the same reason: autograd's threads and a
# checkpointed layer's recompute read it.
_MODEL_GROUP = None


@contextlib.contextmanager
def model_group_of(group):
    """Within the block ``model_group()`` is ``group``."""
    global _MODEL_GROUP
    prev, _MODEL_GROUP = _MODEL_GROUP, group
    try:
        yield
    finally:
        _MODEL_GROUP = prev


def model_group():
    """The rank's model group inside a step on a model axis of more than
    one rank, else None."""
    return _MODEL_GROUP


def named_sharding(*logical_axes: Optional[str]) -> Optional[NamedSharding]:
    ctx = _RULES.get()
    if ctx is None:
        return None
    return NamedSharding(ctx[0], spec(*logical_axes))


def spec_dim_axes(spec, ndim: int) -> Tuple[tuple, ...]:
    """Per-dim tuples of mesh-axis names of a spec, padded to ``ndim`` dims
    (missing and None entries mean replicated)."""
    entries = tuple(spec) if spec is not None else ()
    entries = entries[:ndim] + (None,) * (ndim - len(entries))
    return tuple(() if e is None else ((e,) if isinstance(e, str)
                                       else tuple(e)) for e in entries)


def folded_axes(spec, ndim: int) -> Tuple[str, ...]:
    """The mesh axes a spec names, in dim order (the order in which the
    per-shard seed folds them, ``repro/kernels/ops.py:64-68``)."""
    return tuple(a for axes in spec_dim_axes(spec, ndim) for a in axes)


def shard_grid(shape, spec, mesh) -> Optional[Tuple[int, ...]]:
    """Per-dim shard counts of a tensor of ``shape`` under (spec, mesh), or
    None when a sharded dim does not divide evenly over its mesh axes."""
    grid = []
    for d, axes in enumerate(spec_dim_axes(spec, len(shape))):
        k = 1
        for a in axes:
            k *= mesh.shape[a]
        if shape[d] % k:
            return None
        grid.append(k)
    return tuple(grid)


def held_in_blocks(leaf_shape, sh) -> bool:
    """True when a leaf under ``sh`` is held as a rank's block: the spec
    names a mesh axis and divides the whole shape (``sh.shape``, else
    ``leaf_shape``). A spec that does not divide it leaves the leaf whole
    on every rank (GSPMD would pad it), and its quantized copy takes the
    noise path, whose values do not depend on the layout."""
    if sh is None:
        return False
    shape = sh.shape if sh.shape is not None else tuple(leaf_shape)
    return bool(folded_axes(sh.spec, len(shape))) and \
        shard_grid(shape, sh.spec, sh.mesh) is not None


def strip_axes(rules: Dict[str, tuple], axes) -> Dict[str, tuple]:
    """Rules with the given mesh axes removed (flags kept as they are)."""
    out = {}
    for k, v in rules.items():
        out[k] = tuple(a for a in v if a not in axes) \
            if isinstance(v, tuple) else v
    return out


def flag(name: str):
    """An out-of-band flag of the rules dict (keys starting with '#');
    None outside a rules context."""
    ctx = _RULES.get()
    if ctx is None:
        return None
    return ctx[1].get(name)


def axis_size(logical: str) -> int:
    """Product of the mesh-axis sizes a logical axis maps to (1 outside
    rules)."""
    ctx = _RULES.get()
    if ctx is None:
        return 1
    mesh, rules = ctx
    n = 1
    for a in rules.get(logical, ()):
        n *= mesh.shape[a]
    return n

"""Meshes, logical-axis rule sets and parameter shardings of the port
(counterpart of ``repro/launch/mesh.py``; every name rule is the
reference's).

Mesh (per task spec):
    single-pod: (16, 16)      axes ("data", "model")        — 256 ranks
    multi-pod:  (2, 16, 16)   axes ("pod", "data", "model") — 512 ranks

A production mesh is a description the specs are computed on; no run of
the port launches it. A run's mesh is ``distributed.init_mesh``'s.

Rule sets map the model code's logical axes to mesh axes per input-shape
kind: batch → (pod, data), heads/ff/experts/vocab → model; long-context
decode shards the KV-cache sequence over data instead of the batch.

Parameter shardings are name-based (megatron TP): column-parallel in-proj,
row-parallel out-proj, vocab-sharded embedding/head, expert-parallel MoE.
Tensors of at least ``FSDP_THRESHOLD`` elements, and every tensor under
``train.zero_shard``, also fold the data axis into their last free dim that
divides (ZeRO/FSDP: each data rank holds a block of the f32 master and its
optimizer state).

Every function reads a mesh through ``mesh.axis_names`` and
``mesh.shape[name]``, and a tree through nested dicts whose leaves have a
``.shape`` (tensors, or any shape stand-in).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch.config import Config
from repro_torch.core.controller import (flatten_with_path, is_stacked,
                                         map_with_path)
from repro_torch.sharding import Mesh, NamedSharding, P

# elements; ~256 MiB in bf16. Above this a weight also shards over "data".
FSDP_THRESHOLD = 128 * 1024 * 1024


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_cpu_mesh() -> Mesh:
    """1-rank mesh with the same axis names (tests / local smoke)."""
    return Mesh(("data", "model"), (1, 1))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_rules(cfg: Config, mesh, kind: str) -> Dict[str, tuple]:
    """Logical→physical rules for activations inside the model code."""
    dp = dp_axes(mesh)
    e = cfg.model.num_experts
    msize = mesh.shape["model"]
    expert_parallel = e > 0 and e % msize == 0
    heads_ok = _div(cfg.model.num_heads, msize)
    ssa = cfg.mesh.seq_shard_attn
    q_seq = ("model",) if (ssa == "on" or (ssa == "auto" and not heads_ok)) \
        else ()
    pad_heads = 0
    if ssa == "pad" and not heads_ok:
        pad_heads = ((cfg.model.num_heads + msize - 1) // msize) * msize
        q_seq = ()
    rules = {
        "batch": dp,
        "seq": (),
        "q_seq": q_seq,
        "heads": ("model",) if (heads_ok or pad_heads) else (),
        "#pad_heads_to": pad_heads or None,
        "kv_heads": ("model",) if _div(cfg.model.num_kv_heads, msize) else (),
        "ff": () if expert_parallel else ("model",),
        "experts": ("model",) if expert_parallel else (),
        "vocab": ("model",),
        "embed": (),
    }
    rules.setdefault("kv_seq", ())
    if kind == "decode" and cfg.mesh.decode_kv_shard == "seq" and \
            not _div(cfg.model.num_kv_heads, msize):
        rules["kv_seq"] = ("model",)
        rules["heads"] = ()
    if kind == "long":
        rules["batch"] = ()
        rules["kv_seq"] = dp
    if cfg.train.tp_reduce_dtype == "bfloat16":
        rules["#tp_reduce_bf16"] = True
    return rules


def _div(n: int, k: int) -> bool:
    return n > 0 and n % k == 0


def _fits(shape, dim: int, n: int) -> bool:
    return shape[dim] % n == 0 and shape[dim] >= n


def param_pspec(path: str, shape: Tuple[int, ...], cfg: Config, mesh, *,
                fsdp: Optional[bool] = None) -> P:
    """Partition spec of one parameter tensor. ``fsdp=None`` folds the data
    axis in for tensors of at least ``FSDP_THRESHOLD`` elements; True/False
    force it (the ZeRO master-shard flag)."""
    msize = mesh.shape["model"]
    dsize = mesh.shape["data"]
    name = path.split("/")[-1]
    parts: list = [None] * len(shape)

    def col(dim):   # shard output/column dim over model
        if _fits(shape, dim, msize):
            parts[dim] = "model"

    e = cfg.model.num_experts
    expert_parallel = e > 0 and e % msize == 0

    if name == "embed":
        col(0)                                   # vocab rows
    elif name == "head":
        col(len(shape) - 1)                      # vocab cols
    elif name in ("wk", "wv"):
        # kv_proj="replicate" keeps a small wk/wv replicated when the kv
        # heads do not divide the model axis
        if _fits((cfg.model.num_kv_heads,), 0, msize) or \
                cfg.mesh.kv_proj != "replicate":
            col(len(shape) - 1)
    elif name in ("wq", "wi_gate", "wi_up", "in_proj"):
        col(len(shape) - 1)
    elif name in ("wo", "out_proj"):
        col(len(shape) - 2)                      # row-parallel (contraction)
    elif name == "conv_w":
        col(len(shape) - 1)                      # depthwise channels
    elif name in ("we_gate", "we_up", "we_down"):
        edim = len(shape) - 3
        if expert_parallel:
            parts[edim] = "model"
        else:                                    # TP inside each expert
            fdim = (len(shape) - 1 if name != "we_down" else len(shape) - 2)
            col(fdim)
    elif name == "router" or len(shape) < 2:
        pass                                     # replicated
    elif name == "w" and len(shape) == 4:
        pass                                     # conv kernels (CNN): DP only
    elif name == "w":
        col(len(shape) - 1)

    size = math.prod(shape)
    want_fsdp = fsdp if fsdp is not None else size >= FSDP_THRESHOLD
    if want_fsdp:
        for dim in range(len(shape) - 1, -1, -1):
            if parts[dim] is None and _fits(shape, dim, dsize) and \
                    shape[dim] >= dsize:
                parts[dim] = "data"
                break
    return P(*parts)


def zero_flag(cfg: Config) -> Optional[bool]:
    """The data-axis fold of the master, optimizer and controller state:
    ``train.fsdp`` (auto → by size, on, off), forced on by
    ``train.zero_shard``."""
    zero = {"auto": None, "on": True, "off": False}.get(cfg.train.fsdp, None)
    return True if cfg.train.zero_shard else zero


def state_shardings(state_shapes, cfg: Config, mesh, *,
                    zero: Optional[bool] = None):
    """Shardings of the whole train-state tree (params + stats + opt +
    adapt), each with its leaf's global shape. ``zero`` controls the
    data-axis fold of master/opt/adapt tensors (default ``zero_flag``)."""
    if zero is None:
        zero = zero_flag(cfg)

    def visit(p, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return NamedSharding(mesh, P(), shape)
        if p.startswith("params/") or p.startswith("stats/"):
            spec = param_pspec(p.split("/", 1)[1], shape, cfg, mesh, fsdp=zero)
        elif p.startswith("opt/m/") or p.startswith("opt/v/") or \
                p.startswith("opt/mom/"):
            spec = param_pspec(p.split("/", 2)[2], shape, cfg, mesh, fsdp=zero)
        elif p.startswith("adapt/tensors/") and p.endswith("/grad_sum"):
            tensor_path = p[len("adapt/tensors/"):-len("/grad_sum")]
            spec = param_pspec(tensor_path, shape, cfg, mesh, fsdp=zero)
        else:
            spec = P()
        return NamedSharding(mesh, spec, shape)

    return map_with_path(visit, state_shapes)


def packed_slice_specs(param_shapes, cfg: Config, mesh) -> Dict:
    """TP-only shardings of the per-period slice of each stacked weight
    (leading period dim dropped, keyed without "blocks/") and full specs of
    the unstacked tensors."""
    out = {}
    for p, leaf in flatten_with_path(param_shapes):
        shape = tuple(leaf.shape)
        if len(shape) < 2:
            continue
        if is_stacked(p) and len(shape) >= 3:
            spec = param_pspec(p, shape[1:], cfg, mesh, fsdp=False)
            key = p.split("/", 1)[1]
            shape = shape[1:]
        else:
            spec = param_pspec(p, shape, cfg, mesh, fsdp=False)
            key = p
        out[key] = NamedSharding(mesh, spec, shape)
    return out


def param_shardings(param_shapes, cfg: Config, mesh, *,
                    fsdp: Optional[bool] = None):
    """Shardings of a bare parameter tree (serving)."""

    def visit(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return NamedSharding(mesh, P(), shape)
        return NamedSharding(mesh, param_pspec(path, shape, cfg, mesh,
                                               fsdp=fsdp), shape)

    return map_with_path(visit, param_shapes)


def _dp_entry(mesh):
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def batch_shardings(batch_shapes, mesh, kind: str = "train"):
    """Leading (batch) dim over (pod, data), the rest replicated."""
    spec_dp = _dp_entry(mesh)

    def visit(path, leaf):
        parts = [None] * len(leaf.shape)
        if parts:
            parts[0] = spec_dp
        return NamedSharding(mesh, P(*parts), tuple(leaf.shape))

    return map_with_path(visit, batch_shapes)


def cache_shardings(cache_shapes, cfg: Config, mesh, kind: str):
    """Decode caches: (NP, B, C, H, D) — batch over data (decode) or cache
    seq over data (long, batch=1); kv heads over model when divisible."""
    msize = mesh.shape["model"]
    spec_dp = _dp_entry(mesh)
    split_kv = cfg.mesh.decode_kv_shard == "seq"

    def visit(path, leaf):
        name = path.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        parts: list = [None] * len(shape)
        if name in ("k", "v") and len(shape) == 5:
            NPd, B, C, H, D = shape
            if kind == "long" and B == 1:
                if C % max(dp_size(mesh), 1) == 0:
                    parts[2] = spec_dp
            else:
                parts[1] = spec_dp
            if H % msize == 0:
                parts[3] = "model"
            elif split_kv and C % msize == 0:
                parts[2] = "model"
        elif name == "conv" and len(shape) == 4:     # (NP,B,K,C)
            if kind != "long":
                parts[1] = spec_dp
            if shape[3] % msize == 0:
                parts[3] = "model"
        elif name == "ssm" and len(shape) == 5:      # (NP,B,H,P,N)
            if kind != "long":
                parts[1] = spec_dp
            if shape[2] % msize == 0:
                parts[2] = "model"
        return NamedSharding(mesh, P(*parts), shape)

    return map_with_path(visit, cache_shapes)


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# What the port runs on a mesh, and what it refuses by name


def _tp_dims(cfg: Config, msize: int) -> Dict[str, int]:
    """The dims that the Megatron layout splits over a model axis of
    ``msize`` ranks, by what each splits: the vocabulary, the query and
    (under ``mesh.kv_proj=shard``, or when the kv heads divide) kv
    projections' columns, the MLP's hidden units, and the experts or, when
    they do not divide, each expert's hidden units."""
    m = cfg.model
    dh = m.resolved_head_dim
    dims = {"vocab": m.vocab_size, "wq": m.num_heads * dh}
    if _div(m.num_kv_heads, msize) or cfg.mesh.kv_proj != "replicate":
        dims["wk/wv"] = m.num_kv_heads * dh
    if m.num_experts:
        if m.num_experts % msize:
            dims["expert d_ff"] = m.moe_d_ff or m.d_ff
        if m.dense_residual_d_ff:
            dims["dense residual d_ff"] = m.dense_residual_d_ff
    elif m.d_ff:
        dims["d_ff"] = m.d_ff
    return dims


_NOT_MEGATRON = {"ssm": "the SSM family", "hybrid": "the hybrid family",
                 "vlm": "the VLM's cross-attention slots",
                 "audio": "the encoder (audio family)",
                 "cnn": "the CNN family"}


def check_ported(cfg: Config, mesh, kind: str = "train") -> None:
    """Raise ``NotImplementedError`` for what the port does not run on a
    mesh, each naming its ROADMAP item: serving on a mesh
    (``cache_shardings``, split-KV decode: item 11); the MoE family, whose
    dispatch groups are the data ranks (``repro/models/moe.py:81``), and
    the CNN family, whose batch-norm statistics are the global batch's,
    over more than one data rank (item 12); checkpoints of a state held in
    blocks (item 13); on a model axis of more than one rank, the families
    whose tensor parallelism needs more than the Megatron pattern (SSM and
    hybrid, the encoder, cross-attention slots, the CNN) and the attention
    levers ``mesh.seq_shard_attn`` (``q_seq``, ``#pad_heads_to``): item 14.
    The dense and MoE families train on a model axis of more than one rank,
    under ``train.tp_reduce_dtype`` either way; a model whose split dims
    do not divide the axis raises ``ValueError``."""
    msize = mesh.shape.get("model", 1)
    if kind in ("prefill", "decode", "long", "serve"):
        raise NotImplementedError(
            "serving on a mesh (cache_shardings, split-KV decode) is not "
            "ported: ROADMAP.md Queue 1 item 11")
    if msize > 1:
        m = cfg.model
        what = None
        if m.family not in ("dense", "moe"):
            what = _NOT_MEGATRON.get(m.family, f"the {m.family} family")
        elif cfg.mesh.seq_shard_attn != "off":
            what = (f"mesh.seq_shard_attn={cfg.mesh.seq_shard_attn} "
                    "(q_seq, #pad_heads_to)")
        if what is not None:
            raise NotImplementedError(
                f"{what} on a model axis of {msize} ranks is not ported: "
                "ROADMAP.md Queue 1 item 14")
        bad = {k: n for k, n in _tp_dims(cfg, msize).items()
               if not _fits((n,), 0, msize)}
        if bad:
            raise ValueError(f"{bad} do not divide the model axis of "
                             f"{msize} ranks")
    dp = dp_size(mesh)
    if dp > 1 and cfg.model.num_experts > 0:
        raise NotImplementedError(
            "the MoE family over more than one data rank (dispatch groups "
            "per data rank, repro/models/moe.py:81) is not ported: "
            "ROADMAP.md Queue 1 item 12")
    if dp > 1 and cfg.model.family == "cnn":
        raise NotImplementedError(
            "the CNN family over more than one data rank (global batch-norm "
            "statistics) is not ported: ROADMAP.md Queue 1 item 12")
    if kind == "checkpoint":
        raise NotImplementedError(
            "checkpoints of a state held in blocks are not ported: "
            "ROADMAP.md Queue 1 item 13")

"""PrecisionController (counterpart of ``repro/core/controller.py``): the
state, the quantized copy for the forward (grid values in a float
container, packed int8 words, or the quantize prologue's master plus draw
metadata; round-to-nearest or stochastically rounded), the per-step
accumulation of the training step, and the precision switch (PushDown +
PushUp, alg. 2).

State layout (a plain dict tree):

    state = {
      "tensors": { path: {
          "wl":       int32 (L,) or ()     word length
          "fl":       int32 (L,) or ()     fractional length
          "lb":       int32 (L,) or ()     lookback
          "res":      int32 (L,) or ()     EDF resolution
          "count":    int32 (L,) or ()     optimizer steps in current window
          "norm_sum": f32   (L,) or ()     Σ‖g_k‖₂ over window
          "grad_sum": bf16  like param     Σ g_k over window
          "sp":       f32   (L,) or ()     non-zero fraction at last switch
      }},
      "strategy":  int32 ()                 st ∈ {0:min, 1:mean, 2:max}
      "loss_hist": f32 (H,)                 ring buffer
      "loss_ptr":  int32 ()
      "loss_seen": int32 ()
    }

Leaves with a leading stacked-layer dim L (the "blocks" stack) carry
per-layer precision. The training step reads wl/fl and writes the
accumulators; ``accumulate`` updates "grad_sum" in place, and
``precision_switch`` zeroes it in place where a window closes (the
reference returns new arrays), to keep one param-sized bf16 copy on the
device.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Mapping, Optional, Tuple

import torch

from repro_torch import distributed as dst
from repro_torch import sharding as shd
from repro_torch.config import QuantConfig
from repro_torch.core import fixed_point as fxp
from repro_torch.core import pushdown, pushup, threefry
from repro_torch.kernels import ops as kops
from repro_torch.kernels.sr_quantize import fold_shard_seed

STACKED_PREFIXES = ("blocks", "layers")


def path_str(path) -> str:
    return "/".join(str(k) for k in path)


def flatten_with_path(tree, prefix: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(slash-joined path, leaf) of a tree of dicts, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_with_path(v, prefix + (str(k),))
    else:
        yield path_str(prefix), tree


def map_with_path(fn, tree, prefix: Tuple[str, ...] = ()):
    """``fn(slash-joined path, leaf)`` over a tree of dicts, keeping its
    structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    return fn(path_str(prefix), tree)


def unbind_layers(*leaves, stacked: bool = True) -> list:
    """Per-layer views of ``leaves`` stacked along dim 0, one tuple per
    layer (a dict of stacked leaves gives one dict per layer), or
    ``[leaves]`` whole when not ``stacked``. One ``torch.unbind`` per
    tensor: views, no copies, and under autograd its backward stacks the
    layer gradients once, where indexing layer l would write a zero
    tensor of the whole stack for every l."""
    if not stacked:
        return [leaves]
    return list(zip(*(_unbind(t) for t in leaves)))


def _unbind(t):
    if isinstance(t, dict):
        parts = {k: _unbind(v) for k, v in t.items()}
        n = len(next(iter(parts.values())))
        return [{k: p[l] for k, p in parts.items()} for l in range(n)]
    return torch.unbind(t)


def is_quantized_leaf(path: str, leaf: torch.Tensor, qcfg: QuantConfig) -> bool:
    """Weights matrices/conv kernels are quantized; vectors, norms, routers,
    SSM dynamics params are not."""
    if leaf.ndim < 2:
        return False
    low = path.lower()
    return not any(pat in low for pat in qcfg.exclude)


def is_stacked(path: str) -> bool:
    return path.split("/", 1)[0] in STACKED_PREFIXES


def _per_layer_shape(path: str, leaf: torch.Tensor):
    return (leaf.shape[0],) if (is_stacked(path) and leaf.ndim >= 3) else ()


def init_adapt_state(params, qcfg: QuantConfig) -> Dict[str, Any]:
    tensors = {}
    device = None
    for p, leaf in flatten_with_path(params):
        device = leaf.device
        if not is_quantized_leaf(p, leaf, qcfg):
            continue
        ps = _per_layer_shape(p, leaf)

        def mk(v, dt):
            return torch.full(ps, v, dtype=dt, device=leaf.device)

        tensors[p] = {
            "wl": mk(qcfg.init_wl, torch.int32),
            "fl": mk(qcfg.init_fl, torch.int32),
            "lb": mk(qcfg.lb_lwr, torch.int32),
            "res": mk(qcfg.r_lwr, torch.int32),
            "count": mk(0, torch.int32),
            "norm_sum": mk(0.0, torch.float32),
            "grad_sum": torch.zeros(leaf.shape, dtype=torch.bfloat16,
                                    device=leaf.device),
            "sp": mk(1.0, torch.float32),
        }
    st0 = {"min": 0, "mean": 1, "max": 2}[qcfg.strategy]
    return {
        "tensors": tensors,
        "strategy": torch.tensor(st0, dtype=torch.int32, device=device),
        "loss_hist": torch.zeros((qcfg.loss_hist_len,), dtype=torch.float32,
                                 device=device),
        "loss_ptr": torch.tensor(0, dtype=torch.int32, device=device),
        "loss_seen": torch.tensor(0, dtype=torch.int32, device=device),
    }


def _sc_for(p: str, leaf: torch.Tensor, fl: torch.Tensor) -> torch.Tensor:
    """Dequant scale 2^-FL in bf16, shaped so a per-layer loop can slice it:
    per-layer (L,)-FL leaves get (L, 1, ...); a per-TENSOR ⟨WL,FL⟩ on a
    stacked leaf still gets the leading layer dim."""
    sc = fxp.pow2i(-fl).to(torch.bfloat16)
    if fl.ndim:
        return sc.reshape(tuple(fl.shape) + (1,) * (leaf.ndim - 1))
    if is_stacked(p) and leaf.ndim >= 2:
        return sc.reshape((1,) * leaf.ndim).expand(
            (leaf.shape[0],) + (1,) * (leaf.ndim - 1))
    return sc


def _set_path(tree: dict, path: str, value) -> None:
    *parents, last = path.split("/")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[last] = value


def path_hash(path: str) -> int:
    """The reference's stable per-path hash (``controller.py:230-234``)."""
    h = 0
    for ch in path:
        h = (h * 131 + ord(ch)) % (2 ** 31 - 1)
    return h


def leaf_seeds(seed: int, step: int, paths: Iterable[str]) -> Dict[str, int]:
    """The int32 SR seed of each leaf at a step, for the fused kernels: the
    reference's ``_leaf_seed`` (``controller.py:238-242``),
    ``randint(fold_in(step_key(seed, step), path_hash(p)), (), 0,
    2**31 - 1)``, bit for bit. Host ints in, host ints out: the Threefry
    hashes of every path run at once on CPU tensors, so the device never
    synchronises."""
    paths = list(paths)
    sk = step_key(seed, step)
    hashes = torch.tensor([path_hash(p) for p in paths], dtype=torch.int64)
    zero = torch.zeros_like(hashes)
    lk = threefry.threefry2x32(sk[0], sk[1], zero, hashes)     # leaf keys
    # randint: split the leaf key (counters (0, 0) and (0, 1)), one 32-bit
    # draw (counter (0, 0)) under each half
    bits = []
    for half in (0, 1):
        k1, k2 = threefry.threefry2x32(lk[0], lk[1], zero, zero + half)
        o1, o2 = threefry.threefry2x32(k1, k2, zero, zero)
        bits.append(o1 ^ o2)
    seeds = threefry.randint_words(bits[0], bits[1], 0, 2 ** 31 - 1)
    return dict(zip(paths, seeds.tolist()))


def step_key(seed: int, step: int) -> threefry.Key:
    """The reference's step key ``fold_in(PRNGKey(run seed), step)``
    (``train/train_loop.py:127``), from which the jax.random SR noise of
    every leaf is drawn."""
    return threefry.fold_in(threefry.key_from_seed(seed), step)


def leaf_key(key: threefry.Key, path: str) -> threefry.Key:
    """The reference's per-leaf key ``fold_in(key, path_hash(path))``
    (``controller._leaf_key``, ``controller.py:230-235``)."""
    return threefry.fold_in(key, path_hash(path))


# Elements of a leaf whose noise is drawn at once: threefry keeps about six
# int64 temporaries of a chunk, so 2^25 elements take ~1.6 GB on the card;
# on the CPU a chunk that stays in cache is several times faster.
_NOISE_CHUNK = {"cpu": 1 << 18, "cuda": 1 << 25}


def _jax_random_sr(leaf: torch.Tensor, key, path: str, fl: torch.Tensor,
                   wl: Optional[torch.Tensor] = None,
                   out_dtype: torch.dtype = torch.int8,
                   place=None) -> torch.Tensor:
    """The reference's SR with jax.random noise (``controller.py:364-376``
    and ``:476-484``), u = ``jax.random.uniform(leaf_key(key, path),
    leaf.shape)``. Without ``wl``: int8 words clip(SR(leaf·2^FL), −128,
    127); with it: the ⟨WL,FL⟩ grid values (``fixed_point.quantize``) cast
    to ``out_dtype``. A per-layer (L,) ⟨WL,FL⟩ takes layer l of the stacked
    leaf at its own precision; layer l's noise is the flat range
    [l·n, (l + 1)·n) of the whole leaf's, n elements a layer. The noise is
    drawn in chunks (``_NOISE_CHUNK``) and freed before the next one, so
    the whole leaf's noise never exists. ``place`` = (global shape, block
    starts) when ``leaf`` is a rank's block of a larger tensor: each
    element then draws the noise of its own index in the whole tensor, so
    the values do not depend on the layout (``fl``/``wl`` are the block's
    rows of a per-layer precision)."""
    if key is None:
        raise ValueError(f"{path}: stochastic rounding without the fused "
                         "kernels needs the step key (controller.step_key)")
    lkey = leaf_key(key, path)
    layers = fl.shape[0] if fl.ndim else 1
    n = leaf.numel() // layers
    src = leaf.reshape(layers, n)
    out = torch.empty((layers, n), dtype=out_dtype, device=leaf.device)
    size = _NOISE_CHUNK["cpu" if leaf.device.type == "cpu" else "cuda"]
    for l in range(layers):
        fl_l = fl[l] if fl.ndim else fl
        for start, count in threefry.chunks(n, size):
            u = threefry.uniform(lkey, leaf.shape, offset=l * n + start,
                                 count=count, device=leaf.device, place=place)
            x = src[l, start:start + count]
            if wl is None:
                q = fxp.stochastic_round(
                    x.to(torch.float32) * fxp.pow2i(fl_l).to(x.device), u)
                out[l, start:start + count] = q.clamp_(-128.0, 127.0)
            else:
                wl_l = wl[l] if wl.ndim else wl
                out[l, start:start + count] = fxp.quantize(x, wl_l, fl_l, u=u)
            del u
    return out.reshape(leaf.shape)


def _global_shape(leaf: torch.Tensor, sh) -> tuple:
    """The shape of the whole tensor of which ``leaf`` is a rank's block
    (``leaf``'s own without a sharding or a known shape)."""
    if sh is None or sh.shape is None:
        return tuple(leaf.shape)
    return sh.shape


def _place(leaf: torch.Tensor, sh):
    """(global shape, block starts) of a leaf held in blocks, else None."""
    return dst.block_place(sh) if shd.held_in_blocks(leaf.shape, sh) \
        else None


def _block_rows(t: torch.Tensor, leaf: torch.Tensor, place) -> torch.Tensor:
    """A per-layer precision's rows of the leaf's block (all of it for a
    scalar, or a leaf held whole)."""
    if place is None or not t.ndim:
        return t
    return t[place[1][0]:place[1][0] + leaf.shape[0]]


def _use_fused_prng(qcfg: QuantConfig, sr: bool, fl: torch.Tensor,
                    leaf: torch.Tensor, sh=None) -> bool:
    """True when ``leaf`` takes the in-kernel-noise SR quantize
    (``controller.py:245-272``): SR on, ``use_pallas`` and ``fused_prng``,
    a precision that is a scalar or one per layer of the leaf's leading
    dim, and, under a sharding, a spec that divides the leaf evenly
    (``sharding.shard_grid``): an uneven leaf keeps the noise path."""
    if not (sr and qcfg.use_pallas and qcfg.fused_prng):
        return False
    shape = _global_shape(leaf, sh)
    if not (fl.ndim == 0 or (fl.ndim == 1 and fl.shape[0] == shape[0])):
        return False
    return sh is None or shd.shard_grid(shape, sh.spec, sh.mesh) is not None


def _use_dense_prologue(qcfg: QuantConfig, path: str, fl: torch.Tensor,
                        leaf: torch.Tensor, sh=None) -> bool:
    """True when ``leaf`` skips word materialization and is quantized in
    the matmul prologue (``controller.py:274-306``): ``use_pallas`` and
    ``dense_prologue``, a dense-layer weight, 2-D with a scalar ⟨WL,FL⟩ or
    (L, K, N) with one per layer, and no sharding that names a mesh axis
    (the prologue would need the whole f32 master on every rank, four
    times the packed words' bytes)."""
    if not (qcfg.use_pallas and qcfg.dense_prologue):
        return False
    if not fxp.is_dense_param(path):
        return False
    if sh is not None and any(shd.spec_dim_axes(sh.spec, leaf.ndim)):
        return False
    if fl.ndim == 0:
        return leaf.ndim == 2
    return fl.ndim == 1 and leaf.ndim == 3 and fl.shape[0] == leaf.shape[0]


def _flat_shardings(shardings) -> Dict[str, Any]:
    return {} if shardings is None else dict(flatten_with_path(shardings))


def _shards(sh) -> int:
    """How many distinct blocks ``sh`` cuts its tensor into."""
    n = 1
    for a in set(shd.folded_axes(sh.spec, len(sh.spec))):
        n *= sh.mesh.shape[a]
    return n


def _per_layer(t: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """An (L,) precision broadcast over a stacked leaf as (L, 1, ...)."""
    return t.reshape(tuple(t.shape) + (1,) * (leaf.ndim - 1)) if t.ndim else t


def _rtn_words(leaf: torch.Tensor, fl: torch.Tensor) -> torch.Tensor:
    """round(w·2^FL) half to even, clipped to [−128, 127], as f32 values.
    In place on the one f32 temporary: at full width the largest leaf is
    2.8 GB in f32, so every extra temporary counts."""
    x = leaf.to(torch.float32) * fxp.pow2i(_per_layer(fl, leaf))
    return x.round_().clamp_(-128.0, 127.0)


def quantize_params(params, state: Dict[str, Any], qcfg: QuantConfig,
                    seeds: Optional[Mapping[str, int]] = None,
                    dtype: torch.dtype = torch.float32, *, key=None,
                    shardings=None, gather=None):
    """The quantized copy of the master params as grid values in a float
    container (``controller.py:308-387``): quantized leaves on their
    ⟨WL,FL⟩ grid in ``dtype`` (f32 or bf16), every other leaf cast to it.

    With ``quant.stochastic_rounding`` and ``seeds`` or ``key`` the values
    are stochastically rounded: under ``quant.use_pallas`` and
    ``quant.fused_prng`` with the noise drawn in the kernel from ``seeds``
    (an int32 seed per quantized leaf path, ``leaf_seeds``); otherwise, as
    the registry's default quantizer does, with ``jax.random`` noise from
    ``key`` (the step key, ``step_key``), bit for bit the reference's.
    Without either they are rounded to nearest, half to even
    (``fixed_point.quantize``).

    ``dtype=torch.int8`` is the reference's int8 branch: int8 words
    (stochastically rounded, or to nearest; clipped to [−128, 127]) times
    the bf16 scale 2^-FL, in bf16, as are the other leaves.

    ``shardings``: a tree (or flat dict by path) of
    ``sharding.NamedSharding`` with each leaf's whole shape. A leaf whose
    spec names a mesh axis and divides it is the rank's block: the fused
    kernel quantizes it with the per-shard seed (``kops._fused_sharded``),
    the noise path draws each element's own noise of the whole tensor.
    ``gather(path, block)`` then gathers the wire payload, the int8 words
    of the int8 container or the grid values otherwise, into the tensor
    the rank computes on (``distributed.Layout.gather``: along the leaf's
    data axes, its ``model`` block kept); without it the blocks are
    returned."""
    int8 = dtype == torch.int8
    out_dtype = torch.bfloat16 if int8 else dtype
    sr = qcfg.stochastic_rounding and (seeds is not None or key is not None)
    tensors = state["tensors"]
    flat_sh = _flat_shardings(shardings)
    out: Dict[str, Any] = {}
    for p, leaf in flatten_with_path(params):
        sh = flat_sh.get(p)
        if p not in tensors:
            _set_path(out, p, _cast_whole(p, leaf, out_dtype, sh, gather))
            continue
        place = _place(leaf, sh)
        wl = _block_rows(tensors[p]["wl"], leaf, place)
        fl = _block_rows(tensors[p]["fl"], leaf, place)
        if _use_fused_prng(qcfg, sr, tensors[p]["fl"], leaf, sh):
            sh_k = sh if place is not None else None
            if int8:
                q = kops.sr_quantize_fused_int8(leaf, seeds[p],
                                                tensors[p]["fl"],
                                                use_pallas=True,
                                                sharding=sh_k)
            else:
                q = kops.sr_quantize_fused(leaf, seeds[p], tensors[p]["wl"],
                                           tensors[p]["fl"], use_pallas=True,
                                           out_dtype=out_dtype,
                                           sharding=sh_k)
        elif sr and int8:
            q = _jax_random_sr(leaf, key, p, fl, place=place)
        elif sr:
            q = _jax_random_sr(leaf, key, p, fl, wl, out_dtype=out_dtype,
                               place=place)
        elif int8:
            q = _rtn_words(leaf, fl).to(torch.int8)
        else:
            q = fxp.quantize(leaf, _per_layer(wl, leaf),
                             _per_layer(fl, leaf)).to(out_dtype)
        if place is not None and gather is not None:
            q = gather(p, q)
            place = None
        if int8:
            q = q.to(torch.bfloat16).mul_(_sc_for(p, q, _block_rows(
                tensors[p]["fl"], q, place)))
        _set_path(out, p, q)
    return out


def _cast_whole(p: str, leaf: torch.Tensor, dtype: torch.dtype, sh,
                gather) -> torch.Tensor:
    """A leaf the controller does not quantize, cast to the container's
    dtype, then gathered whole when it is a rank's block."""
    q = leaf.to(dtype)
    if gather is not None and shd.held_in_blocks(leaf.shape, sh):
        q = gather(p, q)
    return q


def _refuse_sharded_dense_kernels(p: str, qcfg: QuantConfig, sh) -> None:
    """The reference's refusal (``controller.py:433-452``): the dense
    kernels cannot take a leaf split over ranks."""
    if (qcfg.use_pallas and fxp.is_dense_param(p) and sh is not None
            and sh.mesh.size > 1 and _shards(sh) > 1):
        raise ValueError(
            f"quantize_params_packed: dense leaf '{p}' is sharded over "
            "a multi-device mesh while quant.use_pallas is on — the "
            "dense kernel path (models/common.dense → fxp kernels) "
            "cannot be partitioned by GSPMD and would replicate every "
            "launch. Disable quant.use_pallas for mesh runs (ROADMAP: "
            "shard_map wrapper for the dense matmul kernels).")


def quantize_params_packed(params, state: Dict[str, Any], qcfg: QuantConfig,
                           seeds: Optional[Mapping[str, int]] = None, *,
                           key=None, shardings=None, gather=None):
    """Packed tree: quantized leaves become {"q8", "sc", "wref"} dicts
    (``fixed_point.PACKED_KEYS``); every other leaf is cast to bf16.

    With ``quant.stochastic_rounding`` and ``seeds`` or ``key`` the words
    are stochastically rounded: under ``quant.use_pallas`` and
    ``quant.fused_prng`` with the noise drawn in the kernel from ``seeds``
    (an int32 seed per quantized leaf path, ``leaf_seeds``; a leaf takes
    the stacked kernel when its FL is per layer), otherwise with
    ``jax.random`` noise from ``key`` (the step key), bit for bit the
    reference's. Without either the words are rounded to nearest, half to
    even. All clip to [-128, 127].

    Dense-layer weights under ``quant.use_pallas`` + ``quant.dense_prologue``
    (``_use_dense_prologue``) become quantize-prologue dicts
    ⟨wm, seed, flq, mode⟩ (``fixed_point.QDENSE_KEYS``,
    ``controller.py:451-462``): "wm" is the f32 master itself, "seed" the
    leaf's seed (0 under RTN) folded with the layer index on a stacked leaf
    (``fold_shard_seed``), "mode" 1 for SR and 0 for RTN; the dense kernels
    draw the words in registers.

    "wref" is a bf16 zero of the leaf's shape that nothing reads, so it is
    a zero-stride view that takes no memory; ``grad_receivers`` makes it
    the leaf's gradient receiver, whose gradient autograd materializes.

    ``shardings`` and ``gather`` as for ``quantize_params``: the int8 words
    of a leaf held in blocks are gathered (the packed container's wire
    format) and "wref" has the gathered shape. Under ``quant.use_pallas`` a
    dense leaf split over more than one rank raises ``ValueError``, as in
    the reference (``controller.py:433-452``): the dense kernels take
    whole words."""
    sr = qcfg.stochastic_rounding and (seeds is not None or key is not None)
    tensors = state["tensors"]
    flat_sh = _flat_shardings(shardings)
    out: Dict[str, Any] = {}
    for p, leaf in flatten_with_path(params):
        sh = flat_sh.get(p)
        if p not in tensors:
            _set_path(out, p, _cast_whole(p, leaf, torch.bfloat16, sh, gather))
            continue
        _refuse_sharded_dense_kernels(p, qcfg, sh)
        fl_all = tensors[p]["fl"]
        if _use_dense_prologue(qcfg, p, fl_all, leaf, sh):
            seed = int(seeds[p]) if sr else 0
            if fl_all.ndim:
                seed = fold_shard_seed(seed, torch.arange(fl_all.shape[0]))
            else:
                seed = torch.tensor(seed, dtype=torch.int32)
            _set_path(out, p, {
                "wm": leaf.to(torch.float32), "seed": seed, "flq": fl_all,
                "mode": torch.full(tuple(fl_all.shape), int(sr),
                                   dtype=torch.int32)})
            continue
        place = _place(leaf, sh)
        fl = _block_rows(fl_all, leaf, place)
        if _use_fused_prng(qcfg, sr, fl_all, leaf, sh):
            q8 = kops.sr_quantize_fused_int8(
                leaf, seeds[p], fl_all, use_pallas=True,
                sharding=sh if place is not None else None)
        elif sr:
            q8 = _jax_random_sr(leaf, key, p, fl, place=place)
        else:
            q8 = _rtn_words(leaf, fl).to(torch.int8)
        if place is not None and gather is not None:
            q8 = gather(p, q8)
        else:
            fl_all = fl
        wref = torch.zeros((), dtype=torch.bfloat16,
                           device=leaf.device).expand(q8.shape)
        _set_path(out, p, {"q8": q8, "sc": _sc_for(p, q8, fl_all),
                           "wref": wref})
    return out


def grad_receivers(qparams) -> Dict[str, torch.Tensor]:
    """The tensors the training step differentiates with respect to, by
    param path, each set to require grad: a packed leaf's "wref", a
    quantize-prologue leaf's "wm" (the master itself) and every other leaf
    (a grid-value or cast leaf of the quantized copy, or the master where
    nothing is quantized). The reference differentiates w.r.t. the whole
    tree and then keeps each packed dict's "wref" and each prologue dict's
    "wm" cotangent (``strip_packed_grads``); asking autograd for the
    receivers alone gives the same per-param gradients. The caller clears
    ``requires_grad`` again once the gradients are taken: a receiver may be
    a master param, which the optimizer updates in place."""
    out: Dict[str, torch.Tensor] = {}

    def visit(tree, prefix: str) -> None:
        if fxp.is_packed(tree):
            out[prefix] = tree["wref"].requires_grad_()
        elif fxp.is_qdense(tree):
            out[prefix] = tree["wm"].requires_grad_()
        elif isinstance(tree, dict):
            for k, v in tree.items():
                visit(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            out[prefix] = tree.requires_grad_()

    visit(qparams, "")
    return out


def accumulate(state: Dict[str, Any], grads, loss: torch.Tensor, *,
               layout=None) -> Dict[str, Any]:
    """Windowed gradient statistics of one step: per tensor (per layer for
    stacked leaves) ‖g‖₂ into "norm_sum", g into "grad_sum" (f32 sum,
    rounded to bf16, IN PLACE) and "count" + 1; the loss into the ring.
    ``grads`` is a tree keyed as the params. Under a ``layout``
    (``distributed.Layout``) the gradients and "grad_sum" are the rank's
    blocks, and each norm is the whole tensor's: the blocks' sums of
    squares are all-reduced, so ⟨WL,FL⟩'s inputs stay equal on every rank.
    Returns the new state."""
    flat = dict(flatten_with_path(grads))
    tensors = {}
    for path, ts in state["tensors"].items():
        g = flat[path]
        stacked = bool(ts["wl"].shape)
        # per layer: one f32 temporary per layer
        sums = []
        for gl, sl in unbind_layers(g, ts["grad_sum"], stacked=stacked):
            gf = gl.to(torch.float32)
            sums.append(torch.sum(gf * gf))
            sl.copy_(sl.to(torch.float32) + gf)
        sq = torch.stack(sums) if stacked else sums[0]
        if layout is not None:
            sq = layout.whole_rows(path, sq, tuple(ts["wl"].shape))
        gn = torch.sqrt(sq + 1e-30)
        tensors[path] = {**ts, "norm_sum": ts["norm_sum"] + gn,
                         "count": ts["count"] + 1}
    h = state["loss_hist"].clone()
    ptr = state["loss_ptr"]
    h[ptr.long()] = loss.detach().to(torch.float32)
    return {**state, "tensors": tensors, "loss_hist": h,
            "loss_ptr": (ptr + 1) % h.shape[0],
            "loss_seen": state["loss_seen"] + 1}


# ---------------------------------------------------------------------------
# Precision switch (PushDown + PushUp, masked per tensor/layer)


def _avg_lookback(state: Dict[str, Any]) -> torch.Tensor:
    """The mean over the tensors of each tensor's mean lookback, with the
    bits of the reference's jit on XLA's CPU backend: it goes into a ceil,
    where one ulp can move the loss window by a step. Each tensor's mean is
    its exact sum times f32(1/n) (``fixed_point.exact_mean``); the tensors
    go in sorted path order (the pytree's); the backend contracts the outer
    sum into fused multiply-adds (a product by 1 is no product), the first
    product into the second term and each later one into the running sum,
    and multiplies that by f32(1/t)."""
    parts = [(torch.sum(ts["lb"].to(torch.float32)),
              fxp.recip_f32(ts["lb"].numel()))
             for _, ts in sorted(state["tensors"].items())]
    if not parts:
        return torch.tensor(0.0, device=state["loss_hist"].device)
    (s0, c0), rest = parts[0], parts[1:]
    if not rest:
        return s0 * c0
    (s1, c1) = rest[0]
    total = (fxp.fma_f32(s0, torch.tensor(c0), s1 * c1) if c0 != 1.0
             else fxp.fma_f32(s1, torch.tensor(c1), s0))
    for s, c in rest[1:]:
        total = fxp.fma_f32(s, torch.tensor(c), total)
    return total * fxp.recip_f32(len(parts))


def _loss_stats(state: Dict[str, Any], lb_avg: torch.Tensor):
    """(avg loss over the last ⌈lb_avg⌉ entries, most recent loss) from
    the ring buffer."""
    h = state["loss_hist"]
    n = h.shape[0]
    ptr = state["loss_ptr"].long()                # next write slot
    seen = torch.clamp(state["loss_seen"], max=n)
    k = torch.minimum(torch.clamp(torch.ceil(lb_avg).to(torch.int32), min=1),
                      seen)
    ar = torch.arange(n, device=h.device)
    vals = h[(ptr - 1 - ar) % n]                  # most recent first
    mask = (ar < k).to(torch.float32)
    avg = torch.sum(vals * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return avg, vals[0]


def _switch_tensor(ts: Dict[str, torch.Tensor], w: torch.Tensor,
                   strategy: torch.Tensor, qcfg: QuantConfig
                   ) -> Dict[str, torch.Tensor]:
    """PushDown + PushUp for one tensor, every layer of a stacked one at
    once (the reference's ``jax.vmap`` written out as a leading dim). Where
    the window is not full (count < lb) the layer keeps its state; where it
    is, count and norm_sum reset and "grad_sum" is zeroed in place."""
    per_layer = bool(ts["wl"].shape)
    shape = ts["wl"].shape
    L = w.shape[0] if per_layer else 1
    gsum = ts["grad_sum"]
    norms = [torch.sqrt(torch.sum(torch.square(g.to(torch.float32))) + 1e-30)
             for (g,) in unbind_layers(gsum, stacked=per_layer)]
    gsum_norm = torch.stack(norms).reshape(shape)

    def vec(t):                                   # state leaf → (L,)
        return t.reshape(L)

    ds = pushup.gradient_diversity(vec(ts["norm_sum"]), vec(gsum_norm))
    flat = pushdown.subsample(w.reshape(L, -1).to(torch.float32),
                              qcfg.edf_sample).contiguous()
    wl_min, fl_min = pushdown.push_down(
        flat, vec(ts["res"]), r_upr=qcfg.r_upr, eps_kl=qcfg.eps_kl,
        max_wl=qcfg.max_wl, use_pallas=qcfg.use_pallas)
    wl_new, fl_new = pushup.push_up(wl_min, fl_min, ds, strategy,
                                    buff=qcfg.buff, max_wl=qcfg.max_wl)
    lb_new = pushup.adapt_lookback(vec(ts["lb"]), ds, lb_lwr=qcfg.lb_lwr,
                                   lb_upr=qcfg.lb_upr, gamma=qcfg.gamma)
    res_new = pushup.adapt_resolution(vec(ts["res"]), lb_new,
                                      lb_lwr=qcfg.lb_lwr, lb_upr=qcfg.lb_upr,
                                      r_lwr=qcfg.r_lwr, r_upr=qcfg.r_upr)
    # sparsity of the subsample quantized at the new precision
    qw = fxp.quantize(flat, wl_new.reshape(L, 1), fl_new.reshape(L, 1))
    sp_new = fxp.sparsity(qw, axes=1)
    should = ts["count"] >= ts["lb"]

    def pick(new, old):
        return torch.where(should, new.reshape(shape).to(old.dtype), old)

    gsum.masked_fill_(should.reshape(shape + (1,) * (gsum.ndim - len(shape))),
                      0.0)
    zero = torch.zeros_like
    return {"wl": pick(wl_new, ts["wl"]), "fl": pick(fl_new, ts["fl"]),
            "lb": pick(lb_new, ts["lb"]), "res": pick(res_new, ts["res"]),
            "count": pick(zero(ts["count"]), ts["count"]),
            "norm_sum": pick(zero(ts["norm_sum"]), ts["norm_sum"]),
            "grad_sum": gsum, "sp": pick(sp_new, ts["sp"])}


def precision_switch(state: Dict[str, Any], params, qcfg: QuantConfig, *,
                     layout=None) -> Dict[str, Any]:
    """Alg. 2: AdaptStrategy, then per tensor Adapt{Lookback,Resolution} +
    PushDown + PushUp where the window is full (masked, no host
    synchronisation). Returns the new state; "grad_sum" is updated in
    place. Under a ``layout`` the params and "grad_sum" are the rank's
    blocks: each tensor's master and "grad_sum" are gathered, the switch
    runs on the whole tensors on every rank (the same bits in, the same
    ⟨WL,FL⟩ out), and the rank keeps its block of the zeroed "grad_sum"."""
    lb_avg = _avg_lookback(state)
    loss_avg, loss_now = _loss_stats(state, lb_avg)
    strategy = pushup.adapt_strategy(state["strategy"], loss_avg, loss_now)
    flat = dict(flatten_with_path(params))
    tensors = {}
    for path, ts in state["tensors"].items():
        if layout is None or not layout.held(path):
            tensors[path] = _switch_tensor(ts, flat[path], strategy, qcfg)
            continue
        w = layout.whole(path, flat[path])
        gsum = layout.whole(path, ts["grad_sum"])
        new = _switch_tensor({**ts, "grad_sum": gsum}, w, strategy, qcfg)
        del w
        ts["grad_sum"].copy_(layout.block(path, gsum))
        tensors[path] = {**new, "grad_sum": ts["grad_sum"]}
    return {**state, "tensors": tensors, "strategy": strategy}


def snapshot(state: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Host-side summary {path: {wl, fl, sp, lb, res}} (numpy) for logging
    and the paper's performance model."""
    return {path: {k: ts[k].detach().cpu().numpy()
                   for k in ("wl", "fl", "sp", "lb", "res")}
            for path, ts in state["tensors"].items()}


def clamp_adapt_state(state: Dict[str, Any], max_wl) -> Dict[str, Any]:
    """AdaBits-style (1912.09666) serve-time view of the controller state:
    every tensor's WL clamped to ``max_wl``, FL reduced by the same amount
    so the integer range is preserved and only fractional LSBs are dropped.
    Returns a NEW state dict; the input is not mutated."""
    tensors = {}
    for path, ts in state["tensors"].items():
        wl = ts["wl"]
        new_wl = torch.clamp(wl, max=int(max_wl))
        tensors[path] = {**ts, "wl": new_wl, "fl": ts["fl"] - (wl - new_wl)}
    return {**state, "tensors": tensors}

"""AdaPT-SGD training loop of the port (paper alg. 1; counterpart of
``repro/train/train_loop.py``), the LM stack's families (an encoder's
frames and a VLM's image memory among them) and the CNN family.

Each ``train_step``:
    1. L̂ = Quantize(L, Q)            — the quantized copy of the f32 master
                                        at the controller's ⟨WL,FL⟩, in the
                                        container ``quant.container_dtype``
                                        names: grid values in float32 or
                                        bfloat16, int8 words times 2^-FL in
                                        bf16 (``int8``), packed int8 words
                                        (``int8_packed``), or, for dense
                                        layers under
                                        ``quant.dense_prologue``, the master
                                        itself with the words drawn inside
                                        the matmul; stochastically rounded
                                        with a seed per ⟨run seed, step,
                                        leaf⟩ (``quant.stochastic_rounding``;
                                        the kernel draws the noise under
                                        ``quant.use_pallas`` and
                                        ``quant.fused_prng``, and otherwise,
                                        as the registry's defaults do, the
                                        reference's jax.random noise of the
                                        step key fold_in(PRNGKey(run seed),
                                        step)) or rounded to nearest. With
                                        ``quant.mode=off`` the master itself;
    2. the forward (flash attention under ``quant.use_pallas``; dense
       layers through the fxp kernels on packed words and prologue leaves,
       as library products on a float container's grid values),
       activations quantized per slot; the loss with the elastic net and
       the WL penalty. The CNN family (AlexNet, ResNet20: ``models/cnn``)
       takes the reference's exceptions: ``int8_packed`` gives the float32
       grid values, activations are not quantized, ``train.remat`` is
       ignored; its forward returns new batch-norm stats and the batch's
       accuracy, which the step returns as ``state["stats"]`` and
       ``metrics["acc"]``;
    3. the backward (dq/dkv and, on packed and prologue leaves, dx/dw
       kernels), the gradients taken with respect to the quantized copy's
       leaves: a packed leaf's "wref", a prologue leaf's master, a float
       leaf itself;
    4. controller.accumulate, per-tensor grad normalization, clipping, ROP
       and the optimizer update of the master (in place). ``quant.mode=off``
       skips the regularizer, accumulate and normalization.

With ``train.accum_steps`` a > 1, steps 2 and 3 run once per microbatch
of B/a rows on the one quantized copy of the step, and their gradients
are summed in ``train.accum_dtype`` and scaled by 1/a before step 4
(``_accumulate``); the new stats and the accuracy are the last
microbatch's, each microbatch reading the step's input stats.
``train.remat`` checkpoints each layer's body (``transformer._remat``).

Every ``adapt_interval`` steps the precision switch (alg. 2: PushDown
through the EDF-ladder kernel under ``quant.use_pallas``, then PushUp and
the adaptation of strategy, lookback and resolution) moves each tensor
whose window is full to its new ⟨WL,FL⟩ (never with ``quant.mode=off``).

On a mesh (``mesh=``, a ``distributed.RankMesh`` of (pod, data, model))
the step is the reference's sharded step with what GSPMD did made
explicit (``make_train_step``): each rank holds its block of every leaf
its spec shards (``launch/mesh.state_shardings``: tensor and expert
parallelism over ``model``, the ZeRO fold of the master, the optimizer
state and "grad_sum" over data), gathers the quantized copy along the data
axes and keeps its ``model`` blocks, runs the model on its rows of the
batch (on a model axis of more than one rank the layers are
tensor-parallel and meet through ``distributed.ModelGroup``), and sums the
gradients into its blocks along the data axes; with
``train.qsgd_pod_compression`` the sum across pods carries int8 words
(``quant/qsgd.py``).

What is not ported raises, by name (``launch/mesh.check_ported``):
serving on a mesh, the MoE and CNN families over more than one data rank,
checkpoints of a state held in blocks, and, on a model axis of more than
one rank, the SSM, hybrid, encoder, cross-attention and CNN models and
``mesh.seq_shard_attn``.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import distributed as dst
from repro_torch import sharding as shd
from repro_torch.config import Config
from repro_torch.core import controller, sparsity
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import cnn, transformer
from repro_torch.quant import qsgd
from repro_torch.train import optimizer as opt_lib


# ---------------------------------------------------------------------------
# State


def init_state(cfg: Config, seed: Optional[int] = None, *, device=None,
               mesh=None) -> Dict[str, Any]:
    """Fresh TNVS params from ``seed`` (default ``cfg.train.seed``), the
    batch-norm stats of the CNN family (width 0.25 for a "-smoke" model
    name, else 1.0; ``model.vocab_size`` classes), the controller state,
    the optimizer state, step 0. On ``device`` (default ``cuda``; raises
    without it unless ``"cpu"``).

    On a ``mesh`` every rank draws the same whole params and keeps the
    block ``launch/mesh.state_shardings`` gives it of each leaf (the
    optimizer's moments and "grad_sum" are made at block size); the state
    then holds "layout", the params' shardings with their whole shapes
    (``distributed.Layout``)."""
    dev = resolve_device(device)
    seed = cfg.train.seed if seed is None else int(seed)
    m = cfg.model
    if mesh is not None:
        mesh_lib.check_ported(cfg, mesh, "train")
    if m.family == "cnn":
        init_fn, _ = cnn.MODELS[m.name.replace("-smoke", "")]
        width = 0.25 if m.name.endswith("smoke") else 1.0
        params, stats = init_fn(seed, num_classes=m.vocab_size, width=width,
                                device=dev)
    else:
        params = transformer.init_params(seed, m, device=dev)
        stats = {}
    adapt = (controller.init_adapt_state(params, cfg.quant)
             if cfg.quant.mode != "off" else {"tensors": {}})
    state = {
        "params": params,
        "stats": stats,
        "opt": opt_lib.init_opt_state(params, cfg.optimizer),
        "adapt": adapt,
        "step": torch.tensor(0, dtype=torch.int32, device=dev),
        "rng": torch.tensor(seed, dtype=torch.int64),
    }
    return state if mesh is None else shard_state(state, cfg, mesh)


def shard_state(state: Dict[str, Any], cfg: Config, mesh) -> Dict[str, Any]:
    """A whole train state → the rank's: its block (a copy) of every leaf
    of the params, the optimizer's moments and "grad_sum" that
    ``launch/mesh.state_shardings`` shards, and "layout", the params'
    shardings with their whole shapes. The whole leaves are freed as their
    blocks are made, once the caller drops ``state``."""
    mesh_lib.check_ported(cfg, mesh, "train")
    shardings = mesh_lib.state_shardings({"params": state["params"]}, cfg,
                                         mesh)["params"]
    layout = dst.Layout(mesh, dict(controller.flatten_with_path(shardings)))

    def block(p, leaf):
        b = layout.block(p, leaf)
        return b.clone() if b is not leaf else leaf

    def blocks(tree):
        out: Dict[str, Any] = {}
        for p, leaf in list(controller.flatten_with_path(tree)):
            _set_path(out, p, block(p, leaf))
        return out

    opt = {k: (blocks(v) if isinstance(v, dict) else v)
           for k, v in state["opt"].items()}
    adapt = dict(state["adapt"])
    adapt["tensors"] = {p: {**ts, "grad_sum": block(p, ts["grad_sum"])}
                        for p, ts in state["adapt"]["tensors"].items()}
    return {**state, "params": blocks(state["params"]), "opt": opt,
            "adapt": adapt, "layout": layout.shardings}


def gather_state(state: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The whole train state from a rank's blocks (every rank gets it): the
    params, the optimizer's moments and "grad_sum" gathered leaf by leaf;
    no "layout"."""
    layout = dst.Layout(mesh, state["layout"])

    def whole(tree):
        out: Dict[str, Any] = {}
        for p, t in controller.flatten_with_path(tree):
            _set_path(out, p, layout.whole(p, t))
        return out

    opt = {k: (whole(v) if isinstance(v, dict) else v)
           for k, v in state["opt"].items()}
    adapt = dict(state["adapt"])
    adapt["tensors"] = {p: {**ts, "grad_sum": layout.whole(p, ts["grad_sum"])}
                        for p, ts in state["adapt"]["tensors"].items()}
    out = {**state, "params": whole(state["params"]), "opt": opt,
           "adapt": adapt}
    del out["layout"]
    return out


# ---------------------------------------------------------------------------
# Loss


def _task_loss(cfg: Config, qparams, batch, act_wl=None) -> torch.Tensor:
    """The LM loss of the quantized copy on ``batch`` (differentiable), as
    the reference dispatches it (``train_loop.py:77-86``): an encoder's
    framewise CE of ``embeds`` against ``labels`` (no shift), else the
    shifted loss of ``tokens``; a VLM's forward also reads ``memory``."""
    m = cfg.model
    if m.is_encoder:
        kwargs = {"embeds": batch["embeds"]}
        targets, shift = batch["labels"], False
    else:
        kwargs = {"tokens": batch["tokens"]}
        targets, shift = batch["tokens"], True
    if m.cross_attn_every:
        kwargs["memory"] = batch["memory"]
    logits = transformer.forward(qparams, m, act_wl=act_wl,
                                 use_pallas=cfg.quant.use_pallas,
                                 remat=cfg.train.remat, **kwargs)
    return transformer.lm_loss(logits, targets, shift=shift)


def _cnn_task_loss(cfg: Config, qparams, stats, batch):
    """(cross-entropy of the quantized copy on ``batch``, differentiable;
    {"stats": the new batch-norm stats, "acc": the batch's accuracy}), the
    reference's CNN branch of ``_task_loss`` (``train_loop.py:67-76``)."""
    _, fwd = cnn.MODELS[cfg.model.name.replace("-smoke", "")]
    logits, new_stats = fwd(qparams, stats, batch["images"], True)
    loss = cnn.ce_loss(logits, batch["labels"])
    return loss, {"stats": new_stats,
                  "acc": cnn.accuracy(logits.detach(), batch["labels"])}


# ---------------------------------------------------------------------------
# Train step


def _set_path(tree: dict, path: str, value) -> None:
    *parents, last = path.split("/")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[last] = value


# The float container of each ``quant.container_dtype`` other than
# int8_packed (``train_loop.py:147-149``: anything else is float32).
_CONTAINERS = {"bfloat16": torch.bfloat16, "int8": torch.int8}


def _quantized_copy(cfg: Config, params, adapt, seeds, key, layout=None):
    """The quantized copy the forward reads: the master itself under
    ``quant.mode=off``; for the CNN family ``int8_packed`` is the float32
    container, as in the reference (``train_loop.py:135-149``). Under a
    ``layout`` each rank quantizes its blocks (the fused kernels with
    per-shard seeds) and the copy is gathered along the data axes into the
    rank's compute blocks (``model`` blocks stay the rank's): the int8
    words of the int8 and packed containers, the grid values of the float
    ones."""
    qcfg = cfg.quant
    if qcfg.mode == "off":
        if layout is None:
            return params
        out: Dict[str, Any] = {}
        for p, t in controller.flatten_with_path(params):
            _set_path(out, p, layout.gather(p, t))
        return out
    kw = {} if layout is None else {"shardings": layout.shardings,
                                    "gather": layout.gather}
    if qcfg.container_dtype == "int8_packed" and cfg.model.family != "cnn":
        return controller.quantize_params_packed(params, adapt, qcfg, seeds,
                                                 key=key, **kw)
    dtype = _CONTAINERS.get(qcfg.container_dtype, torch.float32)
    return controller.quantize_params(params, adapt, qcfg, seeds, dtype=dtype,
                                      key=key, **kw)


def _microbatch(batch: Dict[str, torch.Tensor], accum: int) -> list:
    """The ``accum`` microbatches of ``batch``: microbatch i holds rows
    [i·B/a, (i+1)·B/a), the reshape (a, B/a, ...) of the reference's
    ``_microbatch`` (views, no copies)."""
    out = [{} for _ in range(accum)]
    for k, v in batch.items():
        if v.shape[0] % accum:
            raise ValueError(f"train.accum_steps={accum} does not divide the "
                             f"batch of {v.shape[0]} rows ({k!r})")
        for mb, part in zip(out, v.reshape((accum, v.shape[0] // accum)
                                           + tuple(v.shape[1:]))):
            mb[k] = part
    return out


def rank_rows(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The rank's rows of a batch, laid over (pod, data) as
    ``launch/mesh.batch_shardings`` lays them (pod-major)."""
    sh = mesh_lib.batch_shardings(batch, mesh)
    return {k: dst.local_block(v, sh[k].spec, mesh) for k, v in batch.items()}


def _accum_dtype(tcfg) -> torch.dtype:
    return torch.bfloat16 if tcfg.accum_dtype == "bfloat16" else torch.float32


def _accumulate(cfg: Config, loss_fn, receivers, batch, mesh=None):
    """The reference's microbatch scan (``train_loop.py:176-190``): the
    full loss and its gradients with respect to ``receivers`` per
    microbatch, in microbatch order; the gradients summed into zeros of
    the receivers' shapes in ``train.accum_dtype``, the loss and task in
    f32; then each times 1/a, the gradients cast to f32. In the reference
    1/a is a weakly typed Python float, so a bf16 accumulator is
    multiplied by 1/a rounded to bf16 first (1/3 → 0.333984375); torch
    would multiply by the f32 value and round once, so the factor is a
    tensor of the accumulator's dtype. Each microbatch's graph is freed by
    its own ``autograd.grad``. On a ``mesh`` each microbatch is the rank's
    rows of the global batch's (the reference shards the microbatch's dim
    1). Returns (grads, full, task)."""
    accum = cfg.train.accum_steps
    dtype = _accum_dtype(cfg.train)
    leaves = list(receivers.values())
    acc = [torch.zeros(t.shape, dtype=dtype, device=t.device) for t in leaves]
    full_sum = task_sum = torch.zeros((), dtype=torch.float32,
                                      device=leaves[0].device)
    for mb in _microbatch(batch, accum):
        if mesh is not None:
            mb = rank_rows(mb, mesh)
        full, task = loss_fn(mb)
        flat = torch.autograd.grad(full, leaves, materialize_grads=True)
        for a, g in zip(acc, flat):
            a.add_(g.to(dtype))
        del flat
        full_sum = full_sum + full.detach()
        task_sum = task_sum + task.detach()
    inv = torch.tensor(1.0 / accum, dtype=dtype)
    grads = []
    while acc:      # a bf16 sum is freed as its f32 copy is made
        a = acc.pop(0)
        grads.append(a.mul_(inv) if dtype == torch.float32
                     else (a * inv).to(torch.float32))
    inv32 = torch.tensor(1.0 / accum, dtype=torch.float32)
    return grads, full_sum * inv32, task_sum * inv32


def loss_and_grads(cfg: Config, qparams, state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor], mesh=None):
    """Steps 2 and 3 of the step: the full loss (task + regularizer) of the
    quantized copy ``qparams`` on ``batch`` (on a ``mesh``, on the rank's
    rows of the global batch; under ``train.accum_steps`` in microbatches)
    and its gradients with respect to the copy's receivers. Returns
    ({param path: gradient}, full loss, task loss, aux: a CNN's new stats
    and accuracy), the losses detached."""
    qcfg, ocfg = cfg.quant, cfg.optimizer
    adaptive = qcfg.mode != "off"
    adapt = state["adapt"]
    act_wl = (transformer.act_wl_from_state(adapt)
              if adaptive and qcfg.quantize_activations
              and cfg.model.family != "cnn" else None)
    aux: Dict[str, Any] = {}

    # the layers' tensor and expert parallelism on a model axis of more
    # than one rank; None otherwise
    group = dst.model_group(mesh, cfg.train.tp_reduce_dtype == "bfloat16")
    tp_loss = {}
    if group is not None and adaptive:
        layout = _layout_of(state, mesh)
        tp_loss = {"model_blocks": {p for p in adapt["tensors"]
                                    if "model" in layout.axes(p)},
                   "model_sum": group.reduce}

    def loss_fn(mb):
        """(full loss, task loss) of the quantized copy on ``mb``; a
        CNN's new stats and accuracy go to ``aux``, so that after the
        microbatches it holds the last one's, as the reference's
        ``auxes[-1]``, each microbatch having read the step's stats."""
        if cfg.model.family == "cnn":
            task, mb_aux = _cnn_task_loss(cfg, qparams, state["stats"], mb)
            aux.update(mb_aux)
        else:
            task = _task_loss(cfg, qparams, mb, act_wl)
        if not adaptive:
            return task, task
        # the regularizer reads packed and prologue leaves through
        # their value views; its gradients add onto the same receivers
        return sparsity.adapt_loss(
            task, qparams, adapt, alpha=ocfg.l1, beta=ocfg.l2,
            penalty_coef=ocfg.penalty_coef, max_wl=qcfg.max_wl,
            **tp_loss), task

    receivers = controller.grad_receivers(qparams)
    try:
        with _global_batch(cfg, mesh), shd.model_group_of(group):
            if cfg.train.accum_steps > 1:
                flat, full, task = _accumulate(cfg, loss_fn, receivers,
                                               batch, mesh)
            else:
                rows = batch if mesh is None else rank_rows(batch, mesh)
                full, task = loss_fn(rows)
                flat = torch.autograd.grad(full, list(receivers.values()),
                                           materialize_grads=True)
    finally:
        # a receiver may be a master param: no graph outlives the step
        for t in receivers.values():
            t.requires_grad_(False)
    return dict(zip(receivers, flat)), full.detach(), task.detach(), aux


def _batch_axes(cfg: Config, mesh) -> Tuple[str, ...]:
    """The mesh axes whose ranks' rows make up one batch tensor of the
    reference's step: (pod, data); within the pod under
    ``train.qsgd_pod_compression``, whose step is manual over pod
    (``train_loop.py:201-224``)."""
    return tuple(a for a in mesh_lib.dp_axes(mesh)
                 if not (cfg.train.qsgd_pod_compression and a == "pod"))


def _global_batch(cfg: Config, mesh):
    """On a ``mesh``, the forward's maxima over the batch
    (``sharding.batch_max``: the activation quantize's) taken over the
    ranks of ``_batch_axes``, as the reference takes them over its whole
    batch tensor; otherwise nothing."""
    if mesh is None:
        return contextlib.nullcontext()
    axes = _batch_axes(cfg, mesh)
    return shd.batch_max_over(
        lambda t: dst.all_reduce(t, axes, mesh, op="max"))


def apply_grads(cfg: Config, state: Dict[str, Any],
                flat: Dict[str, torch.Tensor], full: torch.Tensor,
                task: torch.Tensor, aux: Dict[str, Any], layout=None
                ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Step 4: ``controller.accumulate``, per-tensor normalization,
    clipping, ROP and the update of the master (in place) from the
    gradients ``flat`` ({param path: gradient}; under a ``layout`` the
    rank's blocks of the mean over ranks, each norm all-reduced). Returns
    (new state, metrics)."""
    qcfg, ocfg = cfg.quant, cfg.optimizer
    params, adapt = state["params"], state["adapt"]
    sum_over = None if layout is None else layout.sum_over
    with torch.no_grad():
        grads: Dict[str, Any] = {}
        for path in list(flat):
            _set_path(grads, path, flat.pop(path))
        if qcfg.mode != "off":
            adapt = controller.accumulate(adapt, grads, task, layout=layout)
            grads = opt_lib.normalize_grads(grads, set(adapt["tensors"]),
                                            sum_over=sum_over)
        grads = opt_lib.clip_by_global_norm(grads, ocfg.grad_clip,
                                            sum_over=sum_over)
        opt = opt_lib.rop_update(state["opt"], task, ocfg)
        params, opt = opt_lib.apply_updates(params, grads, opt, ocfg)
        metrics = {"loss": task, "full_loss": full, "lr": opt["lr"],
                   "grad_norm": opt_lib.global_norm(grads, sum_over=sum_over)}
        if "acc" in aux:
            metrics["acc"] = aux["acc"]
    new_state = {**state, "params": params,
                 "stats": aux.get("stats", state["stats"]), "opt": opt,
                 "adapt": adapt, "step": state["step"] + 1}
    return new_state, metrics


def _layout_of(state: Dict[str, Any], mesh) -> dst.Layout:
    """The params' layout on ``mesh``: the state's "layout", which
    ``init_state(..., mesh=)`` and ``shard_state`` set."""
    if "layout" not in state:
        raise ValueError("a step on a mesh takes the state of that mesh "
                         "(train_loop.init_state(..., mesh=) or shard_state), "
                         "which holds its 'layout'")
    return dst.Layout(mesh, state["layout"])


def _reduce_grads(cfg: Config, grads: Dict[str, torch.Tensor],
                  layout: dst.Layout, mesh, key) -> Dict[str, torch.Tensor]:
    """Each rank's gradients of its compute blocks (the mean over its rows)
    → the rank's blocks of the mean over the data-parallel ranks: summed
    into the block along the leaf's data axes (``reduce_scatter``),
    all-reduced along the other (pod, data) axes, divided by their count.
    Along ``model`` nothing is summed: a ``model`` block's gradient is that
    block's, and a leaf whole on every model rank has the same gradient
    on each of them (the layers' collectives make it so). Under
    ``train.qsgd_pod_compression`` the mean is first taken within the pod,
    then summed across pods with int8 words (``qsgd.psum_compressed``,
    with the step key the reference's ``step_key``) and divided by the pod
    count (``train_loop.py:201-224``)."""
    dp = mesh_lib.dp_axes(mesh)
    compress = cfg.train.qsgd_pod_compression
    out = {}
    for p in list(grads):
        g = grads.pop(p)
        axes = layout.data_axes(p)
        blk = layout.scatter_sum(p, g)
        del g
        rest = [a for a in _batch_axes(cfg, mesh) if a not in axes]
        dst.all_reduce(blk, rest, mesh)
        n = math.prod(mesh.shape[a] for a in axes + tuple(rest) if a in dp)
        out[p] = blk.div_(n) if n > 1 else blk
    if not compress:
        return out
    pods = mesh.shape["pod"]
    out = qsgd.psum_compressed(
        out, key, mesh, "pod", cfg.train.qsgd_bits,
        placements={p: layout.place(p) for p in out if layout.held(p)},
        amax_axes=[a for a in mesh.axis_names if a != "pod"])
    if pods > 1:
        for g in out.values():
            g.div_(pods)
    return out


def _rank_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over the data-parallel ranks of a per-rank scalar (each the
    mean over its own rows: the same rows each)."""
    dp = mesh_lib.dp_axes(mesh)
    t = dst.all_reduce(t.clone(), dp, mesh)
    n = mesh_lib.dp_size(mesh)
    return t / n if n > 1 else t


def make_train_step(cfg: Config, mesh=None) -> Callable:
    """``train_step(state, batch, step=None) -> (state, metrics)``. The
    step updates the master params, the optimizer's moments and the
    controller's "grad_sum" in place and returns the state dict with the
    new scalars. ``step`` is the host's index of this step (the value of
    ``state["step"]``), from which the SR seeds of the fused kernels and the
    step key of the jax.random noise are derived; when it is not given,
    ``state["step"]`` is read once. Under ``train.accum_steps`` > 1 the
    batch is taken in microbatches (``_accumulate``); the quantized copy is
    made once per step, before them.

    On a ``mesh`` (``distributed.RankMesh``) the state holds the rank's
    blocks and their "layout" (``init_state(..., mesh=)``) and ``batch``
    is the global batch, of which the rank takes its rows (``rank_rows``;
    with microbatches, its rows of each, as the reference shards the
    microbatch's dim 1). The step (``train_loop.py:109-249``): the rank
    quantizes its blocks (per-shard seeds) and gathers the copy; forward
    and backward on its rows; the gradients summed into its blocks
    (``_reduce_grads``: QSGD across pods when asked); the loss the mean
    over ranks; accumulate, normalize, clip and the update on the blocks,
    every whole-tensor norm all-reduced. ``train.qsgd_pod_compression``
    sums across the mesh's pod axis and so needs a mesh, as the
    reference's does (a one-rank mesh is ``distributed.init_mesh({},
    backend, device=...)``)."""
    if mesh is None and cfg.train.qsgd_pod_compression:
        raise ValueError("train.qsgd_pod_compression sums across the mesh's "
                         "pod axis: pass mesh= (distributed.init_mesh({}, "
                         "backend, device=...) for one rank)")
    if mesh is not None:
        mesh_lib.check_ported(cfg, mesh, "train")
    qcfg = cfg.quant
    adaptive = qcfg.mode != "off"

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   step: Optional[int] = None
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        params, adapt = state["params"], state["adapt"]
        i = int(state["step"]) if step is None else step
        layout = None if mesh is None else _layout_of(state, mesh)
        seeds = key = None
        if adaptive and qcfg.stochastic_rounding:
            seeds = controller.leaf_seeds(int(state["rng"]), i,
                                          adapt["tensors"])
            key = controller.step_key(int(state["rng"]), i)
        qparams = _quantized_copy(cfg, params, adapt, seeds, key, layout)
        flat, full, task, aux = loss_and_grads(cfg, qparams, state, batch,
                                               mesh)
        del qparams
        with torch.no_grad():
            if mesh is not None:
                flat = _reduce_grads(cfg, flat, layout, mesh,
                                     controller.step_key(int(state["rng"]),
                                                         i))
                task, full = _rank_mean(task, mesh), _rank_mean(full, mesh)
        return apply_grads(cfg, state, flat, full, task, aux, layout)

    return train_step


def make_precision_switch(cfg: Config, mesh=None) -> Callable:
    """``precision_switch(state) -> state``: alg. 2 on the controller
    state, from the current master params. On a ``mesh`` each tensor's
    master and "grad_sum" are gathered from the blocks and the switch runs
    whole on every rank (``controller.precision_switch``)."""
    qcfg = cfg.quant

    def precision_switch(state: Dict[str, Any]) -> Dict[str, Any]:
        layout = (dst.Layout(mesh, state["layout"])
                  if mesh is not None and "layout" in state else None)
        adapt = controller.precision_switch(state["adapt"], state["params"],
                                            qcfg, layout=layout)
        return {**state, "adapt": adapt}

    return precision_switch


# ---------------------------------------------------------------------------
# Data dispatch and the host-side loop


def make_batch(cfg: Config, step: int, *, device=None) -> Dict[str, torch.Tensor]:
    if cfg.model.family == "cnn":
        return synthetic.cifar_batch(cfg.model.vocab_size,
                                     cfg.train.global_batch, step,
                                     cfg.train.seed, device=device)
    return synthetic.lm_batch(cfg, step, device=device)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """One device, where an index that is not given is any of its type."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def train(cfg: Config, *, steps: Optional[int] = None,
          state: Optional[Dict[str, Any]] = None,
          checkpoint_mgr=None, watchdog=None,
          log: Callable[[str], None] = print,
          telemetry: Optional[list] = None,
          metrics_logger=None, preemption_guard=None, heartbeat=None,
          device=None, mesh=None) -> Tuple[Dict[str, Any], list]:
    """Run the loop on ``device`` (default ``cuda``); returns (state,
    history). The precision switch is called after every
    ``adapt_interval``-th step (``quant.lb_lwr`` when 0), as in the
    reference, and never with ``quant.mode=off``.

    After each step, in the reference's order (``train_loop.py:299-345``):
    after a switch, ``controller.snapshot`` into ``telemetry`` (a list)
    and ``metrics_logger.log_switch``; ``watchdog.observe`` (a
    ``fault_tolerance.StepWatchdog``); the log line and
    ``metrics_logger.log_step`` (a ``metrics.MetricsLogger``) every
    ``log_every`` steps; ``checkpoint_mgr.save`` (a
    ``checkpoint.CheckpointManager``) every ``checkpoint_every`` steps;
    ``heartbeat.beat``; and, once ``preemption_guard.requested`` (a
    ``fault_tolerance.PreemptionGuard`` has seen SIGTERM), a final save,
    its wait, and an early return.

    On a ``mesh`` (``distributed.init_mesh``) the loop runs on the mesh's
    device (a ``device`` that differs raises), the state is the rank's
    blocks (``init_state(..., mesh=)``), every rank draws the same global batch and
    trains on its rows, and only rank 0 logs. Checkpoints of a state held
    in blocks are not ported (``launch/mesh.check_ported``)."""
    steps = steps if steps is not None else cfg.train.steps
    dev = resolve_device(device if mesh is None else mesh.device)
    if mesh is not None and device is not None and not _same_device(
            torch.device(device), dev):
        raise ValueError(f"device {device} is not the mesh's {dev}: a rank "
                         "runs on its mesh's device (distributed.init_mesh("
                         "..., device=))")
    if mesh is not None and checkpoint_mgr is not None:
        mesh_lib.check_ported(cfg, mesh, "checkpoint")
    if mesh is not None and mesh.rank != 0:
        log = lambda msg: None  # noqa: E731
    if state is None:
        state = init_state(cfg, device=dev, mesh=mesh)
    step_fn = make_train_step(cfg, mesh=mesh)
    switch_fn = (make_precision_switch(cfg, mesh=mesh)
                 if cfg.quant.mode != "off" else None)
    interval = cfg.train.adapt_interval or cfg.quant.lb_lwr
    every = cfg.train.checkpoint_every

    history = []
    start_step = int(state["step"])
    for i in range(start_step, start_step + steps):
        t0 = time.perf_counter()
        batch = make_batch(cfg, i, device=dev)
        state, metrics = step_fn(state, batch, step=i)
        if switch_fn is not None and (i + 1) % interval == 0:
            state = switch_fn(state)
            if telemetry is not None or metrics_logger is not None:
                snap = controller.snapshot(state["adapt"])
                if telemetry is not None:
                    telemetry.append(snap)
                if metrics_logger is not None:
                    metrics_logger.log_switch(i + 1, snap)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if watchdog is not None:
            watchdog.observe(i, dt)
        if (i + 1) % max(cfg.train.log_every, 1) == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i + 1, **m, "dt": dt})
            if metrics_logger is not None:
                metrics_logger.log_step(i + 1, m, dt=dt)
            log(f"step {i + 1:5d} loss={m['loss']:.4f} lr={m['lr']:.4g} "
                + (f"acc={m['acc']:.3f} " if "acc" in m else "")
                + f"grad_norm={m['grad_norm']:.4f} ({dt * 1e3:.0f} ms)")
        if checkpoint_mgr is not None and every and (i + 1) % every == 0:
            checkpoint_mgr.save(state, step=i + 1)
        if heartbeat is not None:
            heartbeat.beat(i + 1, extra=f"loss={float(metrics['loss']):.4f}")
        if preemption_guard is not None and preemption_guard.requested:
            log(f"[preempt] SIGTERM at step {i + 1}: saving final "
                "checkpoint and exiting")
            if checkpoint_mgr is not None:
                checkpoint_mgr.save(state, step=i + 1)
                checkpoint_mgr.wait()
            break
    return state, history

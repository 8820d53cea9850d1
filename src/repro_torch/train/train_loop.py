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

What is not ported raises, by name: QSGD pod compression.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import Config
from repro_torch.core import controller, sparsity
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models import cnn, transformer
from repro_torch.train import optimizer as opt_lib


def _check_ported(cfg: Config) -> None:
    if cfg.train.qsgd_pod_compression:
        raise NotImplementedError("train.qsgd_pod_compression comes with the "
                                  "multi-GPU slice (ROADMAP.md, Queue 1)")


# ---------------------------------------------------------------------------
# State


def init_state(cfg: Config, seed: Optional[int] = None, *, device=None
               ) -> Dict[str, Any]:
    """Fresh TNVS params from ``seed`` (default ``cfg.train.seed``), the
    batch-norm stats of the CNN family (width 0.25 for a "-smoke" model
    name, else 1.0; ``model.vocab_size`` classes), the controller state,
    the optimizer state, step 0. On ``device`` (default ``cuda``; raises
    without it unless ``"cpu"``)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    seed = cfg.train.seed if seed is None else int(seed)
    m = cfg.model
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
    return {
        "params": params,
        "stats": stats,
        "opt": opt_lib.init_opt_state(params, cfg.optimizer),
        "adapt": adapt,
        "step": torch.tensor(0, dtype=torch.int32, device=dev),
        "rng": torch.tensor(seed, dtype=torch.int64),
    }


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


def _quantized_copy(cfg: Config, params, adapt, seeds, key):
    """The quantized copy the forward reads: the master itself under
    ``quant.mode=off``; for the CNN family ``int8_packed`` is the float32
    container, as in the reference (``train_loop.py:135-149``)."""
    qcfg = cfg.quant
    if qcfg.mode == "off":
        return params
    if qcfg.container_dtype == "int8_packed" and cfg.model.family != "cnn":
        return controller.quantize_params_packed(params, adapt, qcfg, seeds,
                                                 key=key)
    dtype = _CONTAINERS.get(qcfg.container_dtype, torch.float32)
    return controller.quantize_params(params, adapt, qcfg, seeds, dtype=dtype,
                                      key=key)


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


def _accum_dtype(tcfg) -> torch.dtype:
    return torch.bfloat16 if tcfg.accum_dtype == "bfloat16" else torch.float32


def _accumulate(cfg: Config, loss_fn, receivers, batch):
    """The reference's microbatch scan (``train_loop.py:176-190``): the
    full loss and its gradients with respect to ``receivers`` per
    microbatch, in microbatch order; the gradients summed into zeros of
    the receivers' shapes in ``train.accum_dtype``, the loss and task in
    f32; then each times 1/a, the gradients cast to f32. In the reference
    1/a is a weakly typed Python float, so a bf16 accumulator is
    multiplied by 1/a rounded to bf16 first (1/3 → 0.333984375); torch
    would multiply by the f32 value and round once, so the factor is a
    tensor of the accumulator's dtype. Each microbatch's graph is freed by
    its own ``autograd.grad``. Returns (grads, full, task)."""
    accum = cfg.train.accum_steps
    dtype = _accum_dtype(cfg.train)
    leaves = list(receivers.values())
    acc = [torch.zeros(t.shape, dtype=dtype, device=t.device) for t in leaves]
    full_sum = task_sum = torch.zeros((), dtype=torch.float32,
                                      device=leaves[0].device)
    for mb in _microbatch(batch, accum):
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


def make_train_step(cfg: Config) -> Callable:
    """``train_step(state, batch, step=None) -> (state, metrics)``. The
    step updates the master params, the optimizer's moments and the
    controller's "grad_sum" in place and returns the state dict with the
    new scalars. ``step`` is the host's index of this step (the value of
    ``state["step"]``), from which the SR seeds of the fused kernels and the
    step key of the jax.random noise are derived; when it is not given,
    ``state["step"]`` is read once. Under ``train.accum_steps`` > 1 the
    batch is taken in microbatches (``_accumulate``); the quantized copy is
    made once per step, before them."""
    _check_ported(cfg)
    qcfg, ocfg = cfg.quant, cfg.optimizer
    adaptive = qcfg.mode != "off"

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   step: Optional[int] = None
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        params, adapt = state["params"], state["adapt"]
        seeds = key = None
        if adaptive and qcfg.stochastic_rounding:
            i = int(state["step"]) if step is None else step
            seeds = controller.leaf_seeds(int(state["rng"]), i,
                                          adapt["tensors"])
            key = controller.step_key(int(state["rng"]), i)
        qparams = _quantized_copy(cfg, params, adapt, seeds, key)
        act_wl = (transformer.act_wl_from_state(adapt)
                  if adaptive and qcfg.quantize_activations
                  and cfg.model.family != "cnn" else None)

        aux: Dict[str, Any] = {}

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
                penalty_coef=ocfg.penalty_coef, max_wl=qcfg.max_wl), task

        receivers = controller.grad_receivers(qparams)
        try:
            if cfg.train.accum_steps > 1:
                flat, full, task = _accumulate(cfg, loss_fn, receivers, batch)
            else:
                full, task = loss_fn(batch)
                flat = torch.autograd.grad(full, list(receivers.values()),
                                           materialize_grads=True)
        finally:
            # a receiver may be a master param: no graph outlives the step
            for t in receivers.values():
                t.requires_grad_(False)
        grads: Dict[str, Any] = {}
        for path, g in zip(receivers, flat):
            _set_path(grads, path, g)
        del qparams, receivers, flat
        with torch.no_grad():
            task, full = task.detach(), full.detach()
            if adaptive:
                adapt = controller.accumulate(adapt, grads, task)
                grads = opt_lib.normalize_grads(grads, set(adapt["tensors"]))
            grads = opt_lib.clip_by_global_norm(grads, ocfg.grad_clip)
            opt = opt_lib.rop_update(state["opt"], task, ocfg)
            params, opt = opt_lib.apply_updates(params, grads, opt, ocfg)
            metrics = {"loss": task, "full_loss": full, "lr": opt["lr"],
                       "grad_norm": opt_lib.global_norm(grads)}
            if "acc" in aux:
                metrics["acc"] = aux["acc"]
        new_state = {**state, "params": params,
                     "stats": aux.get("stats", state["stats"]), "opt": opt,
                     "adapt": adapt, "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def make_precision_switch(cfg: Config) -> Callable:
    """``precision_switch(state) -> state``: alg. 2 on the controller
    state, from the current master params."""
    qcfg = cfg.quant

    def precision_switch(state: Dict[str, Any]) -> Dict[str, Any]:
        adapt = controller.precision_switch(state["adapt"], state["params"],
                                            qcfg)
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


def train(cfg: Config, *, steps: Optional[int] = None,
          state: Optional[Dict[str, Any]] = None,
          checkpoint_mgr=None, watchdog=None,
          log: Callable[[str], None] = print,
          telemetry: Optional[list] = None,
          metrics_logger=None, preemption_guard=None, heartbeat=None,
          device=None) -> Tuple[Dict[str, Any], list]:
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
    its wait, and an early return."""
    steps = steps if steps is not None else cfg.train.steps
    dev = resolve_device(device)
    if state is None:
        state = init_state(cfg, device=dev)
    step_fn = make_train_step(cfg)
    switch_fn = (make_precision_switch(cfg) if cfg.quant.mode != "off"
                 else None)
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

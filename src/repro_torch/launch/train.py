"""Training launcher of the port: fresh TNVS init from a seed (or the
latest checkpoint under ``--resume``), then AdaPT-SGD steps through
``train_loop.train``. The registry's llama3.2-3b config (remat full, 8-way
gradient accumulation, the QuantConfig defaults), cut to a batch that fits
one card:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --override train.global_batch=8 --override train.seq_len=512 \
        --override quant.init_fl=10 --steps 2

Packed int8 words (the fxp kernels): add
``--override quant.container_dtype=int8_packed --override
quant.use_pallas=true``; the quantize prologue (the dense layers draw
their words from the f32 master inside the matmul): add
``--override quant.dense_prologue=true`` to those. Checkpoints and JSONL
metrics:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --smoke --steps 4 --checkpoint-dir /tmp/ckpt --resume \
        --metrics-dir /tmp/metrics --override train.checkpoint_every=2

``--resume`` continues from the latest complete checkpoint in
``--checkpoint-dir`` (the reference's format: either package's). The run
saves every ``train.checkpoint_every`` steps and once at the end; SIGTERM
saves at the step it interrupts and stops (``PreemptionGuard``); a
watchdog logs straggler steps and a heartbeat logs liveness. Runs on
``cuda`` unless ``--device cpu`` (``--arch tiny`` is the size for the
CPU).

Training on a (pod, data, model) mesh, one process a rank, started by
torchrun (the counterpart of the reference's
``jax.distributed.initialize``): ``--mesh POD,DATA,MODEL`` (or
``POD,DATA``, model 1) gives the mesh, POD·DATA·MODEL the number of
ranks. A model axis of more than one rank runs the dense and MoE families
tensor- and expert-parallel. Each rank holds its blocks of the master
and optimizer state under ``train.zero_shard`` (the FSDP fold over data);
``train.qsgd_pod_compression`` sends int8 words across pods. On N cards of
one host, one rank a card:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3.2-3b --mesh 2,2 --backend nccl \
        --override train.zero_shard=true --override quant.use_pallas=true \
        --override quant.fused_prng=true --override train.global_batch=8 \
        --override train.seq_len=512

Ranks that share one card (or the CPU) take ``--backend gloo`` (and
``--device cuda:0``, or ``--device cpu``); two tensor-parallel ranks of
tiny on the CPU:

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch tiny --mesh 1,1,2 --backend gloo --device cpu --steps 2 \
        --override train.global_batch=4 --override train.seq_len=32
"""
from __future__ import annotations

import argparse

from repro_torch import distributed as dst
from repro_torch.config import apply_overrides, load_config, with_shape
from repro_torch.device import resolve_device
from repro_torch.train import train_loop
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import (Heartbeat, PreemptionGuard,
                                               StepWatchdog)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--metrics-dir", default="",
                    help="write JSONL step/switch telemetry here")
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--mesh", default="",
                    help="POD,DATA[,MODEL]: the mesh's ranks (under "
                         "torchrun)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    args = ap.parse_args(argv)

    if args.smoke:
        from repro_torch.configs import get_smoke_config
        cfg = get_smoke_config(args.arch)
        if args.shape:
            cfg = with_shape(cfg, args.shape)
        cfg = apply_overrides(cfg, args.override)
    else:
        cfg = load_config(args.arch, args.shape, overrides=args.override)
    mesh = None
    if args.mesh:
        sizes = [int(v) for v in args.mesh.split(",")]
        if len(sizes) not in (2, 3):
            ap.error(f"--mesh {args.mesh!r}: POD,DATA or POD,DATA,MODEL")
        mesh = dst.init_mesh(dict(zip(("pod", "data", "model"), sizes)),
                             args.backend,
                             device=(None if args.backend == "nccl"
                                     else args.device))
        device = mesh.device
    else:
        device = resolve_device(args.device)

    state = None
    mgr = None
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir,
                                keep=cfg.train.keep_checkpoints,
                                async_save=cfg.train.async_checkpoint)
        if args.resume and mgr.latest_step() is not None:
            state = mgr.restore(train_loop.init_state(cfg, device=device))
            print(f"[train] resumed from step {int(state['step'])}")

    watchdog = StepWatchdog(factor=cfg.train.straggler_factor,
                            on_straggler=lambda s, dt, med: print(
                                f"[watchdog] straggler step {s}: "
                                f"{dt:.2f}s vs median {med:.2f}s"))

    metrics_logger = None
    if args.metrics_dir:
        from repro_torch.train.metrics import MetricsLogger
        metrics_logger = MetricsLogger(args.metrics_dir,
                                       run_name=args.arch.replace("/", "_"))

    telemetry: list = []
    with PreemptionGuard() as guard:
        state, history = train_loop.train(
            cfg, steps=args.steps, state=state, checkpoint_mgr=mgr,
            watchdog=watchdog, telemetry=telemetry,
            metrics_logger=metrics_logger, preemption_guard=guard,
            heartbeat=Heartbeat(), device=device, mesh=mesh)
    if metrics_logger is not None:
        metrics_logger.log_event("finished", steps=int(state["step"]))
        metrics_logger.close()
    if mgr is not None:
        mgr.save(state, step=int(state["step"]))
        mgr.wait()
    if history:
        print(f"[train] done: step={history[-1]['step']} "
              f"loss={history[-1]['loss']:.4f} on {device}"
              + (f" (mesh {mesh.shape}, rank {mesh.rank})" if mesh else ""))
    if mesh is not None:
        dst.destroy(mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Training launcher of the port: fresh TNVS init from a seed, then AdaPT-SGD
steps through ``train_loop.train``. Packed int8 words (the fxp kernels):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --override quant.container_dtype=int8_packed \
        --override quant.use_pallas=true \
        --override quant.init_fl=10 --override train.remat=none \
        --override train.accum_steps=1 --override train.global_batch=4 \
        --override train.seq_len=512 --steps 3

The registry's float32 container (grid values from the float SR kernels,
dense layers as library products): the same command without the
``quant.container_dtype`` override. The quantize prologue (the dense
layers draw their words from the f32 master inside the matmul): add
``--override quant.dense_prologue=true`` to the int8_packed command.

Runs on ``cuda`` unless ``--device cpu`` (``--arch tiny`` is the size for
the CPU). ``--checkpoint-dir``, ``--resume`` and ``--metrics-dir`` are not
ported yet.
"""
from __future__ import annotations

import argparse

from repro_torch.config import apply_overrides, load_config, with_shape
from repro_torch.device import resolve_device
from repro_torch.train import train_loop

_QUEUE_1_CHECKPOINT = ("is not ported yet: checkpoints and metrics come with "
                   "ROADMAP.md Queue 1 item 2")


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
    ap.add_argument("--metrics-dir", default="")
    ap.add_argument("--override", action="append", default=[])
    args = ap.parse_args(argv)

    for flag, given in (("--checkpoint-dir", args.checkpoint_dir),
                        ("--resume", args.resume),
                        ("--metrics-dir", args.metrics_dir)):
        if given:
            raise NotImplementedError(f"{flag} {_QUEUE_1_CHECKPOINT}")
    if args.smoke:
        from repro_torch.configs import get_smoke_config
        cfg = get_smoke_config(args.arch)
        if args.shape:
            cfg = with_shape(cfg, args.shape)
        cfg = apply_overrides(cfg, args.override)
    else:
        cfg = load_config(args.arch, args.shape, overrides=args.override)
    device = resolve_device(args.device)

    _, history = train_loop.train(cfg, steps=args.steps, device=device)
    if history:
        print(f"[train] done: step={history[-1]['step']} "
              f"loss={history[-1]['loss']:.4f} on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Serving launcher of the port: fresh TNVS init from a seed, quantize once
at the AdaPT controller's ⟨WL,FL⟩, and serve a batch of generation requests
with the ``Engine``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --override quant.container_dtype=int8_packed \
        --override quant.use_pallas=true --override quant.init_fl=10

Without the ``quant.container_dtype`` override the registry's float32
container is served from f32 grid values (dense layers as library
products). Serving always materializes the words: ``quant.dense_prologue``
is turned off.

``--checkpoint-dir`` serves the latest complete checkpoint there (the
reference's format: either package's), restored into a fresh
``train_loop.init_state``. Runs on ``cuda`` unless ``--device cpu``.
``--continuous`` (the overload-robust batcher) is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import apply_overrides, load_config
from repro_torch.device import resolve_device
from repro_torch.serve.engine import Engine
from repro_torch.train import train_loop
from repro_torch.train.checkpoint import CheckpointManager


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--override", action="append", default=[])
    args = ap.parse_args(argv)

    if args.continuous:
        raise NotImplementedError("--continuous (the continuous batcher) is "
                                  "not yet ported (ROADMAP.md, Queue 1)")
    if args.smoke:
        from repro_torch.configs import get_smoke_config
        cfg = apply_overrides(get_smoke_config(args.arch), args.override)
    else:
        cfg = load_config(args.arch, overrides=args.override)
    device = resolve_device(args.device)

    state = train_loop.init_state(cfg, device=device)
    if args.checkpoint_dir:
        state = CheckpointManager(args.checkpoint_dir).restore(state)
        print(f"[serve] restored step {int(state['step'])}")
    engine = Engine(cfg, state["params"], state["adapt"], device=device)
    del state
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    prompts = torch.randint(0, cfg.model.vocab_size, (args.batch, args.tokens),
                            generator=gen, device=device)
    t0 = time.perf_counter()
    out, _ = engine.generate(prompts, args.max_new,
                             temperature=args.temperature)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    print(f"[serve] generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. kernel builds) on {device}")
    print("[serve] sample:", [int(t) for t in out[0][:16]])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

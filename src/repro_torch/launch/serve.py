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

Continuous mode (``--continuous``) drives the overload-robust
``ContinuousBatcher`` instead: admission control, deadlines, a durable
request journal and AdaBits-style precision degradation under queue
pressure, on the card one CUDA graph of the slot pool's decode per level.
It submits ``--requests`` prompts of ``--tokens`` tokens (the reference's
prompts: ``jax.random.randint`` under ``fold_in(PRNGKey(1), r)``, from
``core/threefry.py``) and prints the reference's summary lines:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny --smoke \
        --device cpu --continuous --requests 16 --max-new 8 \
        --journal /tmp/serve.journal \
        --override serve.max_queue=8 --override serve.degrade_high_watermark=4

Of ``train_loop.init_state`` the launcher keeps the master weights and
each tensor's ⟨WL,FL⟩ (``engine.serving_adapt_state``) and drops the rest
(the optimizer state and the gradient sums) before the weights are
quantized: memory only, so that granite-8b's three word sets fit beside
its f32 master on one 80 GB card.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import apply_overrides, load_config
from repro_torch.device import resolve_device
from repro_torch.serve.engine import Engine, serving_adapt_state
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
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batcher with admission control, "
                         "journal, and precision degradation")
    ap.add_argument("--requests", type=int, default=16,
                    help="[continuous] synthetic requests to submit")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="[continuous] per-request deadline in seconds")
    ap.add_argument("--journal", default="",
                    help="[continuous] durable request journal path")
    ap.add_argument("--no-degrade", action="store_true",
                    help="[continuous] disable the precision policy")
    ap.add_argument("--override", action="append", default=[])
    args = ap.parse_args(argv)

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
    state = {"params": state["params"],
             "adapt": serving_adapt_state(state["adapt"])}
    if args.continuous:
        return _serve_continuous(cfg, state, args, device)
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


def _serve_continuous(cfg, state, args, device):
    from repro_torch.core import threefry
    from repro_torch.serve.policy import PrecisionPolicy
    from repro_torch.serve.scheduler import ContinuousBatcher, DrainTimeout

    policy = (None if args.no_degrade
              else PrecisionPolicy.from_config(cfg.serve))
    cb = ContinuousBatcher(cfg, state["params"], state["adapt"],
                           policy=policy, journal_path=args.journal,
                           device=device)
    state.clear()
    key = threefry.key_from_seed(1)
    plen = min(args.tokens, cb.max_context - 1)
    for r in range(args.requests):
        prompt = threefry.randint(threefry.fold_in(key, r), (plen,), 0,
                                  cfg.model.vocab_size).tolist()
        cb.submit(prompt, max_new_tokens=args.max_new,
                  temperature=args.temperature,
                  timeout=args.timeout or None)
    t0 = time.perf_counter()
    try:
        done = cb.run_until_drained()
    except DrainTimeout as e:
        print(f"[serve] DRAIN TIMEOUT: stranded rids {sorted(e.unfinished)}")
        done = e.done
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s incl. compile)")
    print(f"[serve] stats: {dict(cb.stats)}")
    if policy is not None and cb.wl_trace:
        print(f"[serve] WL trace: start={cb.wl_trace[0]} "
              f"min={min(cb.wl_trace)} end={cb.wl_trace[-1]} "
              f"switches={cb.stats.get('precision_switches', 0)}")
    by_status = {}
    for r in done:
        by_status.setdefault(r.status.value, []).append(r.rid)
    for status, rids in sorted(by_status.items()):
        print(f"[serve]   {status}: {len(rids)}")
    print(f"[serve] on {device}: {cb.decode_captures} decode graphs "
          "captured")
    if cb.journal is not None:
        cb.journal.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

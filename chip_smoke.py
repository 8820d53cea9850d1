#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one H100: build the kernels, hold
each against its plain version, serve llama3.2-3b through the ``Engine``,
and compare the card with the CPU at depth 2.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device: the card's name and power limit; require compute capability 9.0;
  2. build: nvcc the CUDA sources of ``src/repro_torch/csrc`` (in parallel);
  3. kernels: ``fxp_matmul`` at every shape of the serving path (prefill and
     decode M) plus ragged shapes, ``flash_attention`` at the prefill shape
     plus ragged / window+softcap / no-key-rows cases and lse, each against
     its plain version on the same inputs; times of the kernel, the plain
     version, one PyTorch call (``library_ms``, a yardstick only) and the
     bound;
  4. main path: llama3.2-3b at full config (28 layers, random TNVS weights
     from a seed, int8 words at FL 10), ``Engine.generate`` on 4 prompts of
     128 tokens, 32 new tokens, greedy; launch counts per forward;
  5. card against CPU: the same model at depth 2, same weights, plain
     versions on the CPU against the kernels on the card.

The second-to-last line is the kernels' JSON record and the last line is
``{"ok": true, "device": {...}}``. Per-shape details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call is the
# larger of its bytes over HBM bandwidth and its operations over the bf16
# tensor-core rate (activations are bf16; int8 words are exact in bf16).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# Serving shapes of llama3.2-3b: (K, N) of each dense layer, launches per
# layer, and the LM head.
D_MODEL, D_FF, VOCAB, N_LAYERS = 3072, 8192, 128256, 28
HEADS, KV_HEADS, HEAD_DIM = 24, 8, 128
LAYER_SHAPES = {                       # (K, N): launches per layer
    (D_MODEL, D_MODEL): 2,             # wq, attention wo
    (D_MODEL, KV_HEADS * HEAD_DIM): 2,  # wk, wv
    (D_MODEL, D_FF): 2,                # wi_gate, wi_up
    (D_FF, D_MODEL): 1,                # MLP wo
}
HEAD_SHAPE = (D_MODEL, VOCAB)
BATCH, PROMPT, NEW = 4, 128, 32
OVERRIDES = ["quant.container_dtype=int8_packed", "quant.use_pallas=true",
             "quant.init_fl=10"]


def log(msg: str) -> None:
    print(msg, flush=True)


def bf16_ulp(t):
    """One bf16 unit in the last place at |t| (8-bit significand)."""
    import torch
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def cuda_time_ms(fns, reps: int) -> float:
    """Mean device time of one call, cycling over ``fns`` (closures over
    distinct buffers, so weights come from HBM, not from the 50 MB L2)."""
    import torch
    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions


def check_fxp_matmul(torch, fm, gen):
    """Every (M, K, N) of the serving path, plus ragged shapes on both of
    the kernel's paths. Tolerance: the kernel and the plain version sum the
    same exact f32 products in different orders, so a bf16 output may round
    to the neighbouring value: |kernel − plain| <= one bf16 ulp at |plain|
    + 2^-16·max|plain|."""
    dev = "cuda"
    scale = torch.tensor(2.0 ** -10, dtype=torch.bfloat16, device=dev)
    prefill_m, decode_m = BATCH * PROMPT, BATCH
    cases = [(m, k, n) for (k, n) in LAYER_SHAPES for m in (prefill_m, decode_m)]
    cases += [(decode_m, *HEAD_SHAPE), (prefill_m, *HEAD_SHAPE),
              (37, 3071, 1025), (3, 3071, 1025), (16, 100, 36), (17, 129, 257)]
    rows, max_err = [], 0.0
    for (m, k, n) in cases:
        timed = (k, n) in LAYER_SHAPES or (k, n) == HEAD_SHAPE
        copies = max(1, min(16, math.ceil(128e6 / (k * n)))) if timed else 1
        xs = [torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(copies)]
        ws = [torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(copies)]
        got = fm.fxp_matmul(xs[0], ws[0], scale)
        want = fm.plain(xs[0], ws[0], scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = bf16_ulp(want.float()) + 2.0 ** -16 * want.float().abs().max()
        if not bool((err <= tol).all()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"fxp_matmul ({m},{k},{n}): max err "
                                 f"{err.max().item()} over tolerance")
        max_err = max(max_err, err.max().item())
        row = {"m": m, "k": k, "n": n, "max_abs_err": err.max().item()}
        if timed:
            reps = 20 if k * n * max(m, 64) < 4e10 else 5
            row["ms"] = cuda_time_ms(
                [lambda x=x, w=w: fm.fxp_matmul(x, w, scale)
                 for x, w in zip(xs, ws)], reps)
            row["plain_ms"] = cuda_time_ms(
                [lambda x=x, w=w: fm.plain(x, w, scale)
                 for x, w in zip(xs, ws)], max(3, reps // 4))
            wds = [(w.to(torch.bfloat16) * scale) for w in ws]
            row["library_ms"] = cuda_time_ms(
                [lambda x=x, w=w: torch.matmul(x, w) for x, w in zip(xs, wds)],
                reps)
            del wds
            row["bound_ms"], row["bound_by"] = bound(
                2 * m * k + k * n + 2 * m * n + 2, 2.0 * m * k * n)
        # f32 activations and f32 output on the same words (tests the other
        # instantiations; f32 sums in another order, rtol 1e-5 of the max)
        if (m, k, n) == (37, 3071, 1025) or (m, k, n) == (3, 3071, 1025):
            xf = xs[0].float()
            g32 = fm.fxp_matmul(xf, ws[0], scale.float(), out_dtype=torch.float32)
            w32 = fm.plain(xf, ws[0], scale.float(), out_dtype=torch.float32)
            e32 = (g32 - w32).abs().max().item()
            if e32 > 1e-5 * w32.abs().max().item():
                raise AssertionError(f"fxp_matmul f32 ({m},{k},{n}): {e32}")
        rows.append(row)
        log(f"[kernels] fxp_matmul {m}x{k}x{n}: " + ", ".join(
            f"{key}={val:.4g}" if isinstance(val, float) else f"{key}={val}"
            for key, val in row.items() if key not in ("m", "k", "n")))
        del xs, ws, got, want
    return rows, max_err


def check_flash(torch, fa, gen):
    """The prefill shape (with lse) and the contract's other cases.
    Tolerance: both compute in f32 from the same inputs; outputs in bf16
    may round to the neighbouring value: |kernel − plain| <= one bf16 ulp
    + 1e-4; f32 outputs and lse within 1e-4."""
    dev = "cuda"
    cases = [
        # name, B, Sq, Skv, H, Hkv, D, dtype, causal, window, softcap
        ("prefill", BATCH, PROMPT, PROMPT, HEADS, KV_HEADS, HEAD_DIM,
         torch.bfloat16, True, 0, 0.0),
        ("sq<skv", 2, 77, 200, HEADS, KV_HEADS, HEAD_DIM, torch.bfloat16,
         True, 0, 0.0),
        ("window+softcap", 2, 150, 150, 8, 2, 64, torch.float32, True, 37, 30.0),
        ("no-key rows", 2, 100, 60, 6, 3, 128, torch.float32, True, 0, 0.0),
        ("non-causal", 1, 45, 45, 4, 4, 96, torch.float32, False, 0, 0.0),
    ]
    rows, max_err = [], 0.0
    for name, B, Sq, Skv, H, Hkv, D, dt, causal, window, softcap in cases:
        q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, Skv, Hkv, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, Skv, Hkv, D, generator=gen, device=dev).to(dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        po, plse = fa.plain(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        err = (o.float() - po.float()).abs()
        tol = (bf16_ulp(po.float()) + 1e-4 if dt == torch.bfloat16
               else torch.full_like(err, 1e-4))
        lerr = (lse - plse).abs().max().item()
        if not bool((err <= tol).all()) or lerr > 1e-4 \
                or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"flash_attention {name}: max err "
                                 f"{err.max().item()}, lse err {lerr}")
        if name == "no-key rows":
            dead = torch.arange(Sq, device=dev) + (Skv - Sq) < 0
            if not (bool((o[:, dead] == 0).all())
                    and bool((lse[:, :, dead] == -1e30).all())):
                raise AssertionError("flash_attention: rows with no key")
        max_err = max(max_err, err.max().item())
        row = {"case": name, "shape": [B, Sq, Skv, H, Hkv, D],
               "max_abs_err": err.max().item(), "lse_err": lerr}
        if name == "prefill":
            row["ms"] = cuda_time_ms([lambda: fa.flash_attention(q, k, v, **kw)], 50)
            row["plain_ms"] = cuda_time_ms([lambda: fa.plain(q, k, v, **kw)], 10)
            # SDPA on (B, H, S, D) with the kv heads repeated beforehand
            rep = H // Hkv
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in
                          (q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row["library_ms"] = cuda_time_ms(
                [lambda: sdpa(qt, kt, vt, is_causal=True)], 50)
            pairs = Sq * (Sq + 1) // 2            # causal, Sq == Skv
            row["bound_ms"], row["bound_by"] = bound(
                2 * (2 * q.numel() + k.numel() + v.numel()),
                4.0 * D * pairs * B * H)
        rows.append(row)
        log(f"[kernels] flash_attention {name} {row['shape']}: " + ", ".join(
            f"{key}={val:.4g}" if isinstance(val, float) else f"{key}={val}"
            for key, val in row.items() if key not in ("case", "shape")))
    return rows, max_err


# ---------------------------------------------------------------------------
# Phases 4 and 5


def instrument(eng, torch, fm, fa, record):
    """Wrap the engine's prefill/decode steps to time them (host clock
    around a synchronised call) and record each call's kernel launches."""
    def wrap(fn, kind):
        def call(*args):
            torch.cuda.synchronize()
            n0 = (fm.fxp_matmul.launches, fa.flash_attention.launches)
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            record.append({"kind": kind,
                           "ms": (time.perf_counter() - t0) * 1e3,
                           "fxp": fm.fxp_matmul.launches - n0[0],
                           "flash": fa.flash_attention.launches - n0[1]})
            return out
        return call
    eng._prefill = wrap(eng._prefill, "prefill")
    eng._decode = wrap(eng._decode, "decode")


def main_path(torch, fm, fa):
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine

    cfg = load_config("llama3.2-3b", overrides=OVERRIDES)
    m = cfg.model
    assert (m.num_layers, m.d_model, m.d_ff, m.vocab_size) == (
        N_LAYERS, D_MODEL, D_FF, VOCAB)
    t0 = time.perf_counter()
    params = transformer.init_params(SEED, m, device="cuda")
    state = controller.init_adapt_state(params, cfg.quant)
    eng = Engine(cfg, params, state, device="cuda")
    del params, state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[main] init + quantize llama3.2-3b: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompts = torch.randint(0, m.vocab_size, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    record = []
    instrument(eng, torch, fm, fa, record)
    torch.cuda.reset_peak_memory_stats()
    fm.fxp_matmul.launches = 0
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    out, logits = eng.generate(prompts, NEW)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"fxp_matmul": fm.fxp_matmul.launches,
                "flash_attention": fa.flash_attention.launches}
    per_fwd = 7 * N_LAYERS + 1
    if record[0]["kind"] != "prefill" or len(record) != NEW:
        raise AssertionError(f"unexpected step record {record}")
    for r in record:
        want = (per_fwd, N_LAYERS if r["kind"] == "prefill" else 0)
        if (r["fxp"], r["flash"]) != want:
            raise AssertionError(f"{r['kind']}: launches {r} != {want}")
    if launches != {"fxp_matmul": per_fwd * NEW, "flash_attention": N_LAYERS}:
        raise AssertionError(f"main-path launches {launches}")
    if out.shape != (BATCH, NEW) or int(out.min()) < 0 or int(out.max()) >= VOCAB:
        raise AssertionError(f"tokens out of range: {out}")
    if not bool(torch.isfinite(logits).all()) or float(logits.std()) == 0.0:
        raise AssertionError("logits not finite or constant")
    cold = step_times(record)
    # The same run again, warm (every PyTorch kernel loaded), then a
    # profiled prefill and 8 profiled decode steps for the breakdown.
    record.clear()
    t0 = time.perf_counter()
    eng.generate(prompts, NEW)
    torch.cuda.synchronize()
    warm = step_times(record, total_s=time.perf_counter() - t0)
    res = {"cold": {**cold, "total_s": total_s,
                    "tokens_per_s": BATCH * NEW / total_s},
           "warm": warm,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "logits_std": float(logits.std()),
           "sample": [int(t) for t in out[0][:16]],
           "profile": profile_steps(torch, eng, prompts)}
    for name, r in (("cold", res["cold"]), ("warm", warm)):
        log(f"[main] {name}: prefill {r['prefill_ms']:.2f} ms, decode "
            f"{r['decode_ms_per_step']:.2f} ms/step, {r['tokens_per_s']:.1f} "
            f"tok/s end to end, {r['decode_tokens_per_s']:.1f} tok/s decode")
    log(f"[main] peak {res['peak_gib']:.2f} GiB, launches {launches}")
    for kind, prof in res["profile"].items():
        log(f"[profile] {kind}: wall {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['busy_ms']:.2f} ms (share {prof['busy_share']}); by kernel: "
            + ", ".join(f"{k} {v:.2f}" for k, v in prof["groups_ms"].items()))
    del eng
    torch.cuda.empty_cache()
    return res


def step_times(record, total_s=None):
    prefill_ms = record[0]["ms"]
    decode_ms = [r["ms"] for r in record[1:]]
    per_step = sum(decode_ms) / len(decode_ms)
    out = {"prefill_ms": prefill_ms, "decode_ms_per_step": per_step,
           "decode_ms_steps": decode_ms,
           "decode_tokens_per_s": BATCH / (per_step / 1e3)}
    if total_s is not None:
        out.update(total_s=total_s, tokens_per_s=BATCH * NEW / total_s)
    return out


def device_breakdown(torch, fn):
    """Run ``fn`` under torch.profiler: device kernel time by kernel (ours
    grouped by name), and the device's busy share of the window's wall
    time (the profiler's own host cost lengthens the window, so the share
    is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, n = {}, 0
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            continue
        n += 1
        name = e.name
        for key in ("fxp_matmul", "flash_fwd", "Memset", "Memcpy"):
            if key in name:
                name = key
                break
        else:
            name = name[:48]
        groups[name] = groups.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(groups.values())
    top = dict(sorted(groups.items(), key=lambda kv: -kv[1])[:10])
    return {"wall_ms": wall_ms, "device_events": n, "busy_ms": busy,
            "busy_share": busy / wall_ms if n else None, "groups_ms": top}


def profile_steps(torch, eng, prompts):
    from repro_torch.models import transformer
    from repro_torch.serve import engine as engine_mod
    B, S = prompts.shape
    state = {}
    with torch.inference_mode():
        def prefill():
            state["logits"], state["pref"] = eng._prefill(eng.qparams, prompts)
        out = {"prefill": device_breakdown(torch, prefill)}
        caches = engine_mod._merge_prefill_caches(
            transformer.init_caches(eng.cfg.model, B, S + 9, device=eng.device),
            state["pref"], S)
        tok = engine_mod.sample(state["logits"])

        def decode():
            nonlocal caches
            for i in range(8):
                _, caches = eng._decode(eng.qparams, tok, caches, S + i)
        out["decode_8_steps"] = device_breakdown(torch, decode)
    return out


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def drive(eng, prompt, steps, feed=None):
    """Prefill + ``steps`` decode steps through the engine's step functions;
    the decode tokens are ``feed`` (teacher forcing) or the greedy choice.
    Returns (per-step logits on the CPU, tokens fed)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve import engine as engine_mod
    B, S = prompt.shape
    caches = transformer.init_caches(eng.cfg.model, B, S + steps + 1,
                                     device=eng.device)
    with torch.inference_mode():
        logits, pref = eng._prefill(eng.qparams, prompt)
        caches = engine_mod._merge_prefill_caches(caches, pref, S)
        outs, toks = [logits.float().cpu()], []
        for i in range(steps):
            tok = (feed[i].to(eng.device) if feed is not None
                   else engine_mod.sample(logits))
            toks.append(tok.cpu())
            logits, caches = eng._decode(eng.qparams, tok, caches, S + i)
            outs.append(logits.float().cpu())
    return outs, toks


def card_vs_cpu(torch):
    """Depth 2 at full width, the same weights (drawn on the card, copied to
    the CPU). Tolerance, as in the CPU parity tests: bf16 activations round
    f32 sums taken in different orders, and decode attention multiplies
    probabilities by V in bf16 on the card and in f32 on the CPU, so logits
    are held within 2^-5 of the largest logit (four bf16 ulps there);
    greedy tokens must agree wherever the CPU's top-1/top-2 margin exceeds
    twice that."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine

    cfg = load_config("llama3.2-3b", overrides=OVERRIDES + ["model.num_layers=2"])
    params = transformer.init_params(SEED, cfg.model, device="cuda")
    cpu_params = to_device(params, "cpu")
    engines = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        engines[dev] = Engine(cfg, p, controller.init_adapt_state(p, cfg.quant),
                              device=dev)
    del params, cpu_params
    gen = torch.Generator().manual_seed(SEED + 2)
    prompt = torch.randint(0, cfg.model.vocab_size, (2, 32), generator=gen)
    t0 = time.perf_counter()
    cpu_logits, cpu_toks = drive(engines["cpu"], prompt, 4)
    cpu_s = time.perf_counter() - t0
    gpu_logits, _ = drive(engines["cuda"], prompt.cuda(), 4, feed=cpu_toks)
    worst, agreed, gated = 0.0, 0, 0
    for step, (c, g) in enumerate(zip(cpu_logits, gpu_logits)):
        tol = 2.0 ** -5 * c.abs().max().item()
        err = (c - g).abs().max().item()
        worst = max(worst, err / tol)
        if err > tol or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"depth-2 step {step}: |cpu-card| {err} > {tol}")
        top2 = torch.topk(c, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
        same = c.argmax(-1) == g.argmax(-1)
        if not bool(same[sure].all()):
            raise AssertionError(f"depth-2 step {step}: greedy tokens differ "
                                 "where the margin allows no tie")
        agreed += int(same.sum())
        gated += int(sure.sum())
    res = {"worst_err_over_tol": worst, "tokens_agreeing": agreed,
           "tokens_checked": 2 * len(cpu_logits), "tokens_past_margin": gated,
           "cpu_s": cpu_s}
    log(f"[depth2] card vs CPU: worst |err|/tol {worst:.3f}, greedy tokens "
        f"agree {agreed}/{2 * len(cpu_logits)} ({gated} past the margin)")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fxp_matmul as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    cap = torch.cuda.get_device_capability(0)
    log(f"[device] {torch.cuda.get_device_name(0)} capability {cap}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0, got {cap}")

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build(["fxp_matmul", "flash_attention"])
    log(f"[build] {sorted(reports) or 'cached'} in {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3. kernels
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fxp_rows, fxp_err = check_fxp_matmul(torch, fm, gen)
    flash_rows, flash_err = check_flash(torch, fa, gen)
    torch.cuda.empty_cache()

    # 4. main path
    main_res = main_path(torch, fm, fa)

    # 5. card against CPU
    depth2 = card_vs_cpu(torch)

    # Kernel record: each number sums the kernel's launches in the main
    # path: the prefill's 196 layer calls at M = 512 and its head call at
    # M = 4, then 31 decode steps of 197 calls at M = 4.
    by_shape = {(r["m"], r["k"], r["n"]): r for r in fxp_rows if "ms" in r}
    calls = {}
    for (k, n), per_layer in LAYER_SHAPES.items():
        calls[(BATCH * PROMPT, k, n)] = per_layer * N_LAYERS
        calls[(BATCH, k, n)] = per_layer * N_LAYERS * (NEW - 1)
    calls[(BATCH, *HEAD_SHAPE)] = NEW
    fxp_sum = {key: sum(by_shape[s][key] * c for s, c in calls.items())
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    bytes_part = sum(by_shape[s]["bound_ms"] * c for s, c in calls.items()
                     if by_shape[s]["bound_by"] == "bytes")
    pf = next(r for r in flash_rows if r["case"] == "prefill")
    kernels = [
        {"name": "fxp_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/fxp_matmul.cu",
         "replaces": "src/repro/kernels/fxp_matmul.py:84",
         "launches": main_res["launches"]["fxp_matmul"],
         "max_abs_err": fxp_err, **fxp_sum,
         "bound_by": "bytes" if bytes_part >= fxp_sum["bound_ms"] / 2
         else "operations"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:82",
         "launches": main_res["launches"]["flash_attention"],
         "max_abs_err": flash_err,
         **{key: pf[key] * N_LAYERS
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
         "bound_by": pf["bound_by"]},
    ]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "fxp_matmul": fxp_rows, "flash_attention": flash_rows,
        "main_path": main_res, "depth2": depth2, "kernels": kernels,
        "seconds": time.perf_counter() - t_start}, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

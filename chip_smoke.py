#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one H100: build the kernels, hold
each against its plain version, serve llama3.2-3b through the ``Engine``,
train it with AdaPT-SGD through ``train_loop.train`` (round-to-nearest
words, stochastically rounded words through a precision switch, the float
containers, the quantize prologue, the registry's default quantizer with
the reference's jax.random noise), drive the three kernels only
``kernels/ops`` reaches, and compare the card with the CPU at depth 2 for
each.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device: the card's name and power limit; require compute capability 9.0;
  2. build: nvcc the CUDA sources of ``src/repro_torch/csrc`` (in parallel);
  3. kernels, each against its plain version on the same inputs, with the
     times of the kernel, the plain version, one PyTorch call
     (``library_ms``, a yardstick only) and the bound: ``fxp_matmul`` at
     every shape of the serving and training paths plus ragged shapes and
     a misaligned x, on all three branches (bf16 x with M > 16 on the
     tensor cores, M <= 16 on the GEMV, f32 x with M > 16 on the SIMT
     kernel), the kernel and ``torch.matmul`` also timed by CUDA-graph
     replay;
     ``flash_attention`` at the prefill and training shapes plus ragged /
     window+softcap / no-key-rows / non-causal cases and lse, on both
     branches (bf16 with D % 16 == 0 on the tensor cores, D up to 256;
     f32 and bf16 at D=72 on the SIMT kernel), the redesigned kernel and
     SDPA also timed by CUDA-graph replay (``device_ms``,
     ``library_device_ms``); ``matmul_dx`` and
     ``matmul_dw`` at every training shape (M = 2048) plus ragged and
     misaligned shapes in bf16 and f32 (both on bf16 operands on the
     tensor cores, on f32 on the SIMT kernels; ``matmul_dw`` timed with
     bf16 and f32 out; their and the library's times also by CUDA-graph
     replay); ``flash_attention_dq``/``_dkv`` at
     (4, 512, 24/8, 128) causal plus the contract's other cases, on both
     branches (bf16 with D % 16 == 0 and D <= 128 on the tensor cores, at
     D = 32, 64, 96 and 128; f32, and bf16 at D = 72 and 256, on the SIMT
     kernels), their and SDPA's backward (pinned to the flash-attention
     backend) also timed by CUDA-graph replay; the SR
     int8 words and the EDF ladder bit for bit; the float SR grid values (flat and stacked, f32
     and bf16 out) bit for bit at every leaf shape, WL 2…32, FL −3…28;
     ``fxp_qmatmul``/``matmul_qdx`` at every training shape and ragged
     and misaligned shapes in both modes (both on bf16 x / dy on the
     tensor cores; on f32 on the SIMT
     kernels; their and the library's times also by CUDA-graph replay);
     the float containers' cuBLAS bf16 GEMMs with and without bf16
     split-K reduction; ``sr_quantize`` (the noise given)
     bit for bit on the stacked (28, 3072, 8192) leaf at <8,4> and <16,13>,
     one layer of it, bf16 x, a ragged size and the pathological values;
     ``int8_matmul`` bit for bit at M = 2048 on the four dense shapes and
     the head, at 509 x 1031 x 127, at M = 4 and on the largest sums, its
     scale gradients within 1e-5; ``kl_hist`` bit for bit on that leaf
     against its SR copy at 256 and 150 bins and on the pathological
     values;
  4. serving main path: llama3.2-3b at full config (28 layers, random TNVS
     weights from a seed, int8 words at FL 10), ``Engine.generate`` on 4
     prompts of 128 tokens, 32 new tokens, greedy; launch counts per forward
     (here and on every later path, every flash forward, dq and dkv,
     ``matmul_dx``, ``matmul_dw``, ``fxp_qmatmul``, ``matmul_qdx`` and
     ``fxp_matmul`` at M > 16 must have taken the tensor-core branch, and
     ``fxp_matmul`` at M <= 16, decode and the prefill's head, its GEMV);
  5. serving, card against CPU: the same model at depth 2, same weights,
     plain versions on the CPU against the kernels on the card;
  6. training main path: full llama3.2-3b, RTN words at FL 10, 3 steps of
     4 x 512 tokens (no precision switch), per-step ms, tokens/s, loss,
     grad_norm and exact launch counts, peak memory; one more step under
     the profiler: device busy share, time by kernel, and no library GEMM;
  7. training, card against CPU: one step at depth 2, batch 2 x 64;
  8. SR training main path: full llama3.2-3b with the registry's
     stochastic rounding, 4 steps of 4 x 512 tokens with a precision switch
     after steps 2 and 4 (lookback 2, so every tensor switches after step
     2): exact launch counts per step and per switch, the <WL,FL>
     histogram over the 198 tensor-layers before and after, the switch's
     wall and device time by kernel, a profiled SR step;
  9. SR training, card against CPU at depth 2: the same state through
     ``precision_switch`` on both, and the SR words of every leaf with the
     same seeds;
 10. path A, the float containers: full llama3.2-3b in the registry's
     float32 container with SR, 4 steps through two switches (7 stacked +
     2 flat float-SR launches a step, no fxp kernel, a profiled step whose
     dense layers are library GEMMs, as the reference's XLA dots), the
     switch's wall time; 2 steps each of the bfloat16 and int8 containers
     and of quant.mode=off; ``Engine`` serving from the trained float32
     container; the peak memory of each;
 11. path A, card against CPU at depth 2: the grid values of every leaf
     bit-equal, one step, the switch identical;
 12. path B, the quantize prologue: full llama3.2-3b, int8_packed with
     quant.dense_prologue and SR, 4 steps through two switches (197
     fxp_qmatmul, matmul_qdx and matmul_dw launches a step), a profiled
     step with no library GEMM;
 13. path B, card against CPU at depth 2: the prologue words of every
     dense leaf (through the regularizer's view) bit-equal, one step;
 14. the registry's default quantizer: full llama3.2-3b under the
     QuantConfig defaults (float32 container, SR, quant.use_pallas=false:
     cuBLAS dense layers, plain attention, the plain EDF ladder, the SR
     noise from the plain-PyTorch threefry of ``core/threefry.py``), cut
     as path A, 4 steps through two switches with no hand-written kernel
     launched, step times, tokens/s, peak memory, a profiled step and the
     share of its device time that the noise alone takes; then the ops
     path: ``ops.sr_quantize`` on every
     layer of one of the step's stacked leaves with the step's own noise
     (equal to the controller's grid values bit for bit), ``ops.kl_hist``
     of that leaf against its SR copy and ``ops.int8_matmul`` forward and
     backward on words of the step, each launch counted;
 15. phase 14's configuration, card against CPU at depth 2: the quantized
     copy each step read bit-equal, one step within the slice-2 bounds
     (the CPU taking the plain attention's AV product in the card's bf16),
     the switch identical.

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
TRAIN_B, TRAIN_S = 4, 512              # training batch: 4 sequences of 512
TRAIN_M = TRAIN_B * TRAIN_S
OVERRIDES = ["quant.container_dtype=int8_packed", "quant.use_pallas=true",
             "quant.init_fl=10"]
# Training with round-to-nearest words, no remat and no gradient
# accumulation (not ported), 4 sequences of 512 tokens.
TRAIN_OVERRIDES = OVERRIDES + [
    "quant.stochastic_rounding=false", "train.remat=none",
    "train.accum_steps=1", f"train.global_batch={TRAIN_B}",
    f"train.seq_len={TRAIN_S}", "train.log_every=1"]
TRAIN_STEPS = 3
# The SR path: the registry's stochastic rounding, a switch after every
# second step, a window of two steps, 4 steps.
SR_OVERRIDES = OVERRIDES + [
    "train.remat=none", "train.accum_steps=1",
    f"train.global_batch={TRAIN_B}", f"train.seq_len={TRAIN_S}",
    "train.log_every=1", "train.adapt_interval=2", "quant.lb_lwr=2"]
SR_STEPS = 4
N_STACKED, N_FLAT = 7, 2               # quantized leaves: blocks/..., embed, head
# Leaf shapes of llama3.2-3b the SR kernels quantize every step.
STACKED_SHAPES = {                     # per-layer (K, N): stacked leaves
    (D_MODEL, D_MODEL): 2, (D_MODEL, KV_HEADS * HEAD_DIM): 2,
    (D_MODEL, D_FF): 2, (D_FF, D_MODEL): 1}
FLAT_SHAPES = [(VOCAB, D_MODEL), (D_MODEL, VOCAB)]   # embed, head
EDF_SAMPLE = 65536
F32_OPS = 67e12                        # H100 SXM f32 / int32 CUDA-core rate
KERNELS = ("fxp_matmul", "matmul_dx", "matmul_dw", "flash_attention",
           "flash_attention_dq", "flash_attention_dkv",
           "sr_quantize_fused_stacked_int8", "sr_quantize_fused_int8",
           "edf_ladder_hists", "sr_quantize_fused_stacked", "sr_quantize_fused",
           "fxp_qmatmul", "matmul_qdx", "sr_quantize", "int8_matmul",
           "kl_hist")
SOURCES = ("fxp_matmul", "flash_attention", "fxp_matmul_bwd",
           "flash_attention_bwd", "sr_quantize", "edf_ladder", "fxp_qmatmul",
           "int8_matmul", "kl_hist")
# The kernels with a tensor-core branch (bf16 activations; for fxp_matmul
# with M > 16, beside its GEMV at M <= 16) beside a SIMT one.
TC_KERNELS = ("flash_attention", "matmul_dx", "fxp_qmatmul", "matmul_qdx",
              "flash_attention_dq", "flash_attention_dkv", "matmul_dw",
              "fxp_matmul")
INT8_OPS = 1979e12                     # H100 SXM dense int8 tensor-core rate
ZERO = {k: 0 for k in KERNELS}
DENSE_CALLS = 7 * N_LAYERS + 1          # dense layers and the head
FLASH_STEP = {**ZERO, "flash_attention": N_LAYERS,
              "flash_attention_dq": N_LAYERS, "flash_attention_dkv": N_LAYERS}
# Per training step: every dense layer and the head run fwd, dx and dw;
# every layer runs the flash forward, dq and dkv.
PER_STEP = {**FLASH_STEP, "fxp_matmul": DENSE_CALLS,
            "matmul_dx": DENSE_CALLS, "matmul_dw": DENSE_CALLS}
# With SR words: one stacked launch per blocks/ leaf and one flat launch for
# embed and head each step; one EDF-ladder launch per leaf each switch.
SR_PER_STEP = {**PER_STEP, "sr_quantize_fused_stacked_int8": N_STACKED,
               "sr_quantize_fused_int8": N_FLAT}
PER_SWITCH = {"edf_ladder_hists": N_STACKED + N_FLAT}
# Path A, the float containers: the registry's float32 container (grid
# values from the float SR kernels), then bfloat16 (the same kernels, bf16
# out), int8 (the SR int8 kernels) and quant.mode=off (nothing quantized);
# the dense layers are library products, as the reference's XLA dots.
FLOAT_OVERRIDES = [
    "quant.use_pallas=true", "quant.init_fl=10", "train.remat=none",
    "train.accum_steps=1", f"train.global_batch={TRAIN_B}",
    f"train.seq_len={TRAIN_S}", "train.log_every=1",
    "train.adapt_interval=2", "quant.lb_lwr=2"]
FLOAT_STEPS = 4
FLOAT_PER_STEP = {**FLASH_STEP, "sr_quantize_fused_stacked": N_STACKED,
                  "sr_quantize_fused": N_FLAT}
OTHER_CONTAINERS = {                     # overrides, launches per step
    "bfloat16": (["quant.container_dtype=bfloat16"], FLOAT_PER_STEP),
    "int8": (["quant.container_dtype=int8"],
             {**FLASH_STEP, "sr_quantize_fused_stacked_int8": N_STACKED,
              "sr_quantize_fused_int8": N_FLAT}),
    "mode_off": (["quant.mode=off"], FLASH_STEP)}
OTHER_STEPS = 2                          # the second ends in a switch
# Path B, the quantize prologue: every dense layer and the head draw their
# words from the f32 master inside fxp_qmatmul (forward) and matmul_qdx
# (dx); dw is matmul_dw in f32. The embedding keeps its SR int8 words (one
# flat launch), and the regularizer draws the view of each of the 197
# dense layer-slices through the flat SR int8 kernel in the forward and
# again in the backward.
PROLOGUE_OVERRIDES = SR_OVERRIDES + ["quant.dense_prologue=true"]
PROLOGUE_STEPS = 4
PROLOGUE_PER_STEP = {**FLASH_STEP, "fxp_qmatmul": DENSE_CALLS,
                     "matmul_qdx": DENSE_CALLS, "matmul_dw": DENSE_CALLS,
                     "sr_quantize_fused_int8": 1 + 2 * DENSE_CALLS}
# The registry's default quantizer (phase 14): path A's cut without
# quant.use_pallas, so the QuantConfig defaults stand (float32 container,
# SR with jax.random noise, no hand-written kernel).
DEFAULT_OVERRIDES = [o for o in FLOAT_OVERRIDES if o != "quant.use_pallas=true"]
DEFAULT_STEPS = 4
# The ops path of phase 14: one launch of sr_quantize per layer of the
# (28, 3072, 8192) leaf below, one kl_hist of it, int8_matmul forward and
# its backward (the kernel again at unit scale) at M = 2048.
OPS_LEAF = "blocks/s0_mlp/wi_gate"
OPS_PATH = {**ZERO, "sr_quantize": N_LAYERS, "kl_hist": 1, "int8_matmul": 2}
# PyTorch ops that would run a library GEMM: none may appear in a step.
LIBRARY_GEMMS = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
                 "aten::matmul", "aten::linear", "aten::einsum"}


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


def graph_time_ms(fns, reps: int) -> float:
    """Device time of one call: ``reps`` calls (cycling over ``fns``)
    captured in one CUDA graph and replayed, so the host's cost of a launch
    (the wrapper's checks, ctypes, the tensor maps) is not in it. Reported
    as ``device_ms`` beside ``ms`` (``cuda_time_ms``, the yardstick of
    every row) for the redesigned kernels (the flash forward, dq and dkv,
    ``matmul_dx``, ``fxp_qmatmul``, ``matmul_qdx``) and their library
    calls, whose launches can cost the host more time than the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns[:3]:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (2 * reps)
    del graph
    # the capture and the side stream's warm-up leave cuBLAS workspaces
    # (32 MiB a stream) that would otherwise stay allocated through every
    # later phase's peak memory
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    return ms


def bound(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def bit_stable(torch, fn, reps: int, what: str) -> int:
    """``fn`` called ``reps`` times more on the same inputs returns the first
    call's outputs bit for bit: the tensor-core kernels use no atomics, so a
    difference is a race (one in matmul_dx_tc's word staging showed only at
    the head's long contraction, a word row in a few calls of forty).
    Returns ``reps``."""
    first = fn()
    first = [t.clone() for t in (first if isinstance(first, tuple) else (first,))]
    for _ in range(reps):
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        if not all(torch.equal(a, b) for a, b in zip(first, out)):
            raise AssertionError(f"{what}: a repeated call differs bitwise")
    return reps


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions


def check_fxp_matmul(torch, fm, gen):
    """Every (M, K, N) of the serving path and of the training path
    (M = batch·seq), plus ragged shapes and a misaligned x, each on the
    branch it should take (the wrapper's counts): bf16 x with M > 16 on the
    tensor cores, M <= 16 on the GEMV, f32 x with M > 16 on the SIMT
    kernel. Tolerance: the kernel and the plain version sum the same exact
    f32 products in different orders, so a bf16 output may round to the
    neighbouring value: |kernel − plain| <= one bf16 ulp at |plain|
    + 2^-16·max|plain|; f32 outputs within 1e-5·max|plain|. Times at the
    serving and training shapes: the kernel, the plain version, one
    ``torch.matmul`` of x against the bf16-dequantized words and the
    bound; the kernel and the library call also by CUDA-graph replay
    (``device_ms``, ``library_device_ms``). The tensor-core kernel repeated
    at the training head's shape must give equal bits."""
    dev = "cuda"
    scale = torch.tensor(2.0 ** -10, dtype=torch.bfloat16, device=dev)
    prefill_m, decode_m = BATCH * PROMPT, BATCH
    cases = [(m, k, n) for (k, n) in LAYER_SHAPES
             for m in (prefill_m, decode_m, TRAIN_M)]
    cases += [(decode_m, *HEAD_SHAPE), (prefill_m, *HEAD_SHAPE),
              (TRAIN_M, *HEAD_SHAPE),
              (37, 3071, 1025), (3, 3071, 1025), (16, 100, 36), (17, 129, 257),
              MISALIGNED]
    c = fm.fxp_matmul

    def branch(m, dtype):
        return "gemv" if m <= 16 else "tc" if dtype == torch.bfloat16 else "simt"

    def on_branch(x, w, s, **kw):
        """One launch, on the branch that x's M and dtype call for."""
        want = branch(x.shape[0], x.dtype)
        before = (c.launches, c.tc_launches, c.gemv_launches)
        out = fm.fxp_matmul(x, w, s, **kw)
        moved = tuple(b - a for a, b in zip(
            before, (c.launches, c.tc_launches, c.gemv_launches)))
        if moved != (1, int(want == "tc"), int(want == "gemv")):
            raise AssertionError(f"fxp_matmul {tuple(x.shape)} {x.dtype}: "
                                 f"launches {moved}, want the {want} branch")
        return out

    rows, max_err = [], 0.0
    for (m, k, n) in cases:
        timed = (k, n) in LAYER_SHAPES or (k, n) == HEAD_SHAPE
        copies = max(1, min(16, math.ceil(128e6 / (k * n)))) if timed else 1
        xs = [torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(copies)]
        if (m, k, n) == MISALIGNED:
            xs = [misaligned(torch, x) for x in xs]
        ws = [torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(copies)]
        got = on_branch(xs[0], ws[0], scale)
        want = fm.plain(xs[0], ws[0], scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = bf16_ulp(want.float()) + 2.0 ** -16 * want.float().abs().max()
        if not bool((err <= tol).all()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"fxp_matmul ({m},{k},{n}): max err "
                                 f"{err.max().item()} over tolerance")
        max_err = max(max_err, err.max().item())
        row = {"m": m, "k": k, "n": n, "branch": branch(m, xs[0].dtype),
               "max_abs_err": err.max().item()}

        def f32_close(got, want, what):
            e32 = (got - want).abs().max().item()
            if got.dtype != torch.float32 or \
                    e32 > 1e-5 * want.abs().max().item():
                raise AssertionError(f"fxp_matmul {what} ({m},{k},{n}): {e32}")

        # bf16 x with f32 out: the branch's f32 sums at every shape
        f32_close(on_branch(xs[0], ws[0], scale, out_dtype=torch.float32),
                  fm.plain(xs[0], ws[0], scale, out_dtype=torch.float32),
                  "bf16 -> f32")
        if timed:
            reps = 20 if k * n * max(m, 64) < 4e10 else 3
            kern = [lambda x=x, w=w: fm.fxp_matmul(x, w, scale)
                    for x, w in zip(xs, ws)]
            wds = [(w.to(torch.bfloat16) * scale) for w in ws]
            lib = [lambda x=x, w=w: torch.matmul(x, w) for x, w in zip(xs, wds)]
            row["ms"] = cuda_time_ms(kern, reps)
            row["plain_ms"] = cuda_time_ms(
                [lambda x=x, w=w: fm.plain(x, w, scale)
                 for x, w in zip(xs, ws)], max(3, reps // 4))
            row["library_ms"] = cuda_time_ms(lib, reps)
            row["device_ms"] = graph_time_ms(kern, reps)
            row["library_device_ms"] = graph_time_ms(lib, reps)
            del wds, lib
            if (m, k, n) == (TRAIN_M, *HEAD_SHAPE):
                row["repeats_bit_equal"] = bit_stable(
                    torch, lambda: fm.fxp_matmul(xs[0], ws[0], scale), 20,
                    f"fxp_matmul ({m},{k},{n})")
            row["bound_ms"], row["bound_by"] = bound(
                2 * m * k + k * n + 2 * m * n + 2, 2.0 * m * k * n)
        else:
            # f32 activations and f32 output on the same words (the other
            # instantiations: SIMT at M > 16, the GEMV below)
            xf = xs[0].float()
            f32_close(on_branch(xf, ws[0], scale.float(), out_dtype=torch.float32),
                      fm.plain(xf, ws[0], scale.float(), out_dtype=torch.float32),
                      "f32")
        rows.append(row)
        log(f"[kernels] fxp_matmul {m}x{k}x{n}: " + ", ".join(
            f"{key}={val:.4g}" if isinstance(val, float) else f"{key}={val}"
            for key, val in row.items() if key not in ("m", "k", "n")))
        del xs, ws, got, want
    torch.cuda.empty_cache()
    return rows, max_err


def check_flash(torch, fa, gen):
    """The prefill shape (with lse) and the contract's other cases, on both
    branches: bf16 with D % 16 == 0 takes the tensor cores (the prefill and
    training shapes, sq<skv, window+softcap at D=64, rows with no key,
    non-causal at D=96, D=256), f32 and bf16 at D=72 the SIMT kernel; each
    case checks the branch it took. Tolerance: both compute in f32 from the
    same inputs; outputs in bf16 may round to the neighbouring value:
    |kernel − plain| <= one bf16 ulp + 1e-4; f32 outputs and lse within
    1e-4. At the prefill and training shapes the kernel, the plain version
    and SDPA are timed by events around calls launched from the host
    (``ms``, ``plain_ms``, ``library_ms``), and the kernel and SDPA also by
    CUDA-graph replay (``device_ms``, ``library_device_ms``)."""
    dev = "cuda"
    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, B, Sq, Skv, H, Hkv, D, dtype, causal, window, softcap
        ("prefill", BATCH, PROMPT, PROMPT, HEADS, KV_HEADS, HEAD_DIM, bf,
         True, 0, 0.0),
        ("train", TRAIN_B, TRAIN_S, TRAIN_S, HEADS, KV_HEADS, HEAD_DIM, bf,
         True, 0, 0.0),
        ("sq<skv", 2, 77, 200, HEADS, KV_HEADS, HEAD_DIM, bf, True, 0, 0.0),
        ("window+softcap", 2, 150, 150, 8, 2, 64, f32, True, 37, 30.0),
        ("no-key rows", 2, 100, 60, 6, 3, 128, f32, True, 0, 0.0),
        ("non-causal", 1, 45, 45, 4, 4, 96, f32, False, 0, 0.0),
        ("window+softcap bf16", 2, 150, 150, 8, 2, 64, bf, True, 37, 30.0),
        ("no-key rows bf16", 2, 100, 60, 6, 3, 128, bf, True, 0, 0.0),
        ("non-causal bf16", 1, 45, 45, 4, 4, 96, bf, False, 0, 0.0),
        ("D=256 bf16", 2, 200, 200, 8, 4, 256, bf, True, 0, 0.0),
        ("D=72 bf16 (SIMT)", 1, 33, 40, 4, 2, 72, bf, True, 0, 0.0),
    ]
    rows, max_err = [], 0.0
    for name, B, Sq, Skv, H, Hkv, D, dt, causal, window, softcap in cases:
        q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, Skv, Hkv, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, Skv, Hkv, D, generator=gen, device=dev).to(dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        tc0 = fa.flash_attention.tc_launches
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        tc = fa.flash_attention.tc_launches - tc0
        if tc != int(dt == bf and D % 16 == 0):
            raise AssertionError(f"flash_attention {name}: tensor-core "
                                 f"launches {tc}")
        po, plse = fa.plain(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        err = (o.float() - po.float()).abs()
        tol = (bf16_ulp(po.float()) + 1e-4 if dt == bf
               else torch.full_like(err, 1e-4))
        lerr = (lse - plse).abs().max().item()
        if not bool((err <= tol).all()) or lerr > 1e-4 \
                or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"flash_attention {name}: max err "
                                 f"{err.max().item()}, lse err {lerr}")
        if name.startswith("no-key rows"):
            dead = torch.arange(Sq, device=dev) + (Skv - Sq) < 0
            if not (bool((o[:, dead] == 0).all())
                    and bool((lse[:, :, dead] == -1e30).all())):
                raise AssertionError(f"flash_attention {name}: rows with "
                                     "no key")
        max_err = max(max_err, err.max().item())
        row = {"case": name, "shape": [B, Sq, Skv, H, Hkv, D],
               "branch": "tensor cores" if tc else "simt",
               "max_abs_err": err.max().item(), "lse_err": lerr}
        if name in ("prefill", "train"):
            kern = [lambda: fa.flash_attention(q, k, v, **kw)]
            tc0 = fa.flash_attention.tc_launches
            row["ms"] = cuda_time_ms(kern, 50)
            row["device_ms"] = graph_time_ms(kern, 50)
            row["plain_ms"] = cuda_time_ms([lambda: fa.plain(q, k, v, **kw)], 10)
            if fa.flash_attention.tc_launches == tc0:
                raise AssertionError(f"flash_attention {name}: timed off the "
                                     "tensor cores")
            # SDPA on (B, H, S, D) with the kv heads repeated beforehand
            rep = H // Hkv
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in
                          (q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
            lib = [lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)]
            row["library_ms"] = cuda_time_ms(lib, 50)
            row["library_device_ms"] = graph_time_ms(lib, 50)
            pairs = Sq * (Sq + 1) // 2            # causal, Sq == Skv
            row["bound_ms"], row["bound_by"] = bound(
                2 * (2 * q.numel() + k.numel() + v.numel()),
                4.0 * D * pairs * B * H)
        rows.append(row)
        log(f"[kernels] flash_attention {name} {row['shape']}: " + ", ".join(
            f"{key}={val:.4g}" if isinstance(val, float) else f"{key}={val}"
            for key, val in row.items() if key not in ("case", "shape")))
    return rows, max_err


def close_bf16(got, want, extra: float):
    """|got − want| <= one bf16 ulp at |want| + extra·max|want| (the two
    sum exact f32 products in different orders, so a bf16 output may round
    to the neighbouring value); returns (ok, max abs error)."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = bf16_ulp(w) + extra * w.abs().max()
    return bool((err <= tol).all()) and bool(torch.isfinite(g).all()), \
        err.max().item()


def check_matmul_bwd(torch, fm, gen):
    """``matmul_dx`` and ``matmul_dw`` at every (K, N) of the training path
    with M = batch·seq, plus the ragged shapes of ``RAGGED`` and a
    misaligned dy in bf16 and f32, each against its plain version. bf16
    operands must take each wrapper's tensor-core branch and f32 ones its
    SIMT one. Tolerance: bf16 outputs within one bf16 ulp + 2^-16·max|plain|
    (summation order); f32 outputs within 1e-5·max|plain|. bf16 operands
    with f32 out are checked at every shape, so the tensor-core kernels'
    f32 sums are held at the head's contraction (dx) and output (dw) too.
    Times: the kernel, the plain version, one ``torch.matmul`` of the same
    product (dx: dy @ the dequantized bf16 wqᵀ; dw: xᵀ @ dy, bf16 out, for
    both of dw's output dtypes) and the bound; the kernel and the library
    call also by CUDA-graph replay (``device_ms``, ``library_device_ms``).
    ``matmul_dw`` is timed with bf16 out (the packed path's ``wref``) and
    f32 out (path B's master, ``matmul_dw_f32``). Both tensor-core kernels
    repeated at the head's shape must give equal bits; ``matmul_dw`` with
    no rows (M = 0) must write zeros."""
    dev = "cuda"
    scale = torch.tensor(2.0 ** -10, dtype=torch.bfloat16, device=dev)
    m = TRAIN_M
    cases = [(m, k, n) for (k, n) in LAYER_SHAPES] + [(m, *HEAD_SHAPE)]
    cases += RAGGED + [MISALIGNED]
    rows = {"matmul_dx": [], "matmul_dw": [], "matmul_dw_f32": []}
    max_err = {"matmul_dx": 0.0, "matmul_dw": 0.0}

    def on_branch(fn, a, *args, **kw):
        """``fn`` (``matmul_dx`` or ``matmul_dw``) launched once, on the
        tensor cores iff ``a`` is bf16."""
        want_tc = a.dtype == torch.bfloat16
        l0, t0 = fn.launches, fn.tc_launches
        out = fn(a, *args, **kw)
        if (fn.launches - l0, fn.tc_launches - t0) != (1, int(want_tc)):
            raise AssertionError(f"{fn.__name__} {tuple(a.shape)} {a.dtype}: "
                                 f"tensor cores {want_tc} not taken")
        return out

    for (m, k, n) in cases:
        timed = m == TRAIN_M
        size = 2 * m * n + 2 * m * k + k * n
        copies = max(1, min(4, math.ceil(128e6 / size))) if timed else 1
        dys = [torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(copies)]
        if (m, k, n) == MISALIGNED:
            dys = [misaligned(torch, d) for d in dys]
        xs = [torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(copies)]
        ws = [torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(copies)]
        dx = on_branch(fm.matmul_dx, dys[0], ws[0], scale,
                       out_dtype=torch.bfloat16)
        dw = on_branch(fm.matmul_dw, xs[0], dys[0], out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        ok_x, ex = close_bf16(dx, fm.plain_dx(dys[0], ws[0], scale), 2.0 ** -16)
        ok_w, ew = close_bf16(dw, fm.plain_dw(xs[0], dys[0]), 2.0 ** -16)
        if not (ok_x and ok_w):
            raise AssertionError(f"matmul_dx/dw ({m},{k},{n}): max err {ex}/{ew}")
        max_err["matmul_dx"] = max(max_err["matmul_dx"], ex)
        max_err["matmul_dw"] = max(max_err["matmul_dw"], ew)
        del dx, dw

        def f32_close(name, got, want):
            e32 = (got - want).abs().max().item()
            if got.dtype != torch.float32 or \
                    e32 > 1e-5 * want.abs().max().item():
                raise AssertionError(f"matmul_{name} f32 ({m},{k},{n}): {e32}")
            return e32

        d32, s32, x32 = dys[0].float(), scale.float(), xs[0].float()
        # the tensor-core kernels' f32 sums at every shape, the head's
        # N = 128256 included, where dx's contraction shows its promotion
        # and dw's output is largest
        e32 = f32_close("dx bf16->f32", on_branch(
            fm.matmul_dx, dys[0], ws[0], scale, out_dtype=torch.float32),
            fm.plain_dx(d32, ws[0], s32))
        ew32 = f32_close("dw bf16->f32", on_branch(fm.matmul_dw, xs[0], dys[0]),
                         fm.plain_dw(x32, d32))
        if not timed:
            # the other f32 instantiations on the same values
            for name, got, want in (
                    ("dx", on_branch(fm.matmul_dx, d32, ws[0], s32,
                                     out_dtype=torch.float32),
                     fm.plain_dx(d32, ws[0], s32)),
                    ("dx bf16, f32 scale", on_branch(
                        fm.matmul_dx, dys[0], ws[0], s32,
                        out_dtype=torch.float32),
                     fm.plain_dx(d32, ws[0], s32)),
                    ("dw", on_branch(fm.matmul_dw, x32, d32),
                     fm.plain_dw(x32, d32))):
                f32_close(name, got, want)
            log(f"[kernels] matmul_dx/dw {m}x{k}x{n} (ragged"
                f"{', misaligned dy' if (m, k, n) == MISALIGNED else ''}): "
                f"max err {ex:.4g}/{ew:.4g}")
            continue
        log(f"[kernels] matmul_dx/dw {m}x{k}x{n} bf16 in, f32 out: max err "
            f"{e32:.4g}/{ew32:.4g}")
        head = (k, n) == HEAD_SHAPE
        del d32, x32
        reps = 10 if k * n < 1e8 else 3
        wds = [(w.to(torch.bfloat16) * scale) for w in ws]
        flops = 2.0 * m * k * n
        dw_lib = [lambda x=x, d=d: torch.matmul(x.T, d) for x, d in zip(xs, dys)]
        dw_plain = [lambda x=x, d=d: fm.plain_dw(x, d) for x, d in zip(xs, dys)]
        for name, kern, plain, lib, nbytes, err, repeat in (
                ("matmul_dx",
                 [lambda d=d, w=w: fm.matmul_dx(d, w, scale) for d, w in zip(dys, ws)],
                 [lambda d=d, w=w: fm.plain_dx(d, w, scale) for d, w in zip(dys, ws)],
                 [lambda d=d, w=w: torch.matmul(d, w.T) for d, w in zip(dys, wds)],
                 2 * m * n + k * n + 2 * m * k + 2, ex, 40),
                ("matmul_dw",
                 [lambda x=x, d=d: fm.matmul_dw(x, d, out_dtype=torch.bfloat16)
                  for x, d in zip(xs, dys)],
                 dw_plain, dw_lib, 2 * m * k + 2 * m * n + 2 * k * n, ew, 20),
                ("matmul_dw_f32",
                 [lambda x=x, d=d: fm.matmul_dw(x, d) for x, d in zip(xs, dys)],
                 dw_plain, dw_lib, 2 * m * k + 2 * m * n + 4 * k * n, ew32, 0)):
            row = {"m": m, "k": k, "n": n, "max_abs_err": err,
                   "ms": cuda_time_ms(kern, reps),
                   "plain_ms": cuda_time_ms(plain, max(2, reps // 3)),
                   "library_ms": cuda_time_ms(lib, reps),
                   "device_ms": graph_time_ms(kern, reps),
                   "library_device_ms": graph_time_ms(lib, reps)}
            if head and repeat:
                row["repeats_bit_equal"] = bit_stable(
                    torch, kern[0], repeat, f"{name} ({m},{k},{n})")
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
            rows[name].append(row)
            log(f"[kernels] {name} {m}x{k}x{n}: " + ", ".join(
                f"{key}={val:.4g}" if isinstance(val, float) else f"{key}={val}"
                for key, val in row.items() if key not in ("m", "k", "n")))
        del wds, dw_lib, dw_plain
        del dys, xs, ws
    # no rows: dw is exact zeros, on the tensor cores, in both dtypes
    x0 = torch.empty(0, 136, dtype=torch.bfloat16, device=dev)
    dy0 = torch.empty(0, 72, dtype=torch.bfloat16, device=dev)
    for od in (torch.bfloat16, torch.float32):
        z = on_branch(fm.matmul_dw, x0, dy0, out_dtype=od)
        if z.shape != (136, 72) or z.dtype != od or bool(z.any()):
            raise AssertionError(f"matmul_dw M = 0 ({od}): not zeros")
    torch.cuda.empty_cache()
    return rows, max_err


def sdpa_flash_backward(torch, q, k, v, do):
    """SDPA's backward on the inputs of a flash backward call, pinned to
    PyTorch's flash-attention backend: (B, H, S, D) copies with the kv heads
    repeated beforehand, the forward run once, then two closures over the
    same inputs: ``autograd.grad`` through ``scaled_dot_product_attention``
    under ``sdpa_kernel(FLASH_ATTENTION)`` (the launched yardstick), and the
    aten flash backward op that call dispatches to (capturable in a CUDA
    graph, the device yardstick). A yardstick only: the port never calls
    it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in
                  (q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
    dot = do.transpose(1, 2).contiguous()
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)

    def launched():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        qt.detach(), kt.detach(), vt.detach(), 0.0, True)
    o, lse, cq, ck, mq, mk, seed, offset = fwd[:8]

    def device():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dot, qt.detach(), kt.detach(), vt.detach(), o, lse, cq, ck, mq, mk,
            0.0, True, seed, offset)

    return launched, device


def check_flash_bwd(torch, fa, gen):
    """``flash_attention_dq``/``_dkv`` (through ``flash_attention_bwd``) at
    the training shape and the contract's other cases, against the plain
    backward on the same (q, k, v, o, lse, do), on both branches: bf16 with
    D % 16 == 0 and D <= 128 takes the tensor cores (the training shape,
    sq<skv, and window+softcap, rows with no key and non-causal ragged at
    D = 64, 96 and 128, window with rows with no key at D = 32), f32 and
    bf16 at D = 256 or 72 the SIMT kernels; each case checks the branch
    both kernels took. Tolerance: both compute in f32 from the same inputs;
    bf16 outputs within one bf16 ulp + 1e-4·max|plain|, f32 outputs within
    1e-4·max|plain|. A row that no key reaches must give dq = 0. Times at
    the training shape: each kernel launched from the host (``ms``) and by
    CUDA-graph replay (``device_ms``), its plain version (``plain_dq``,
    ``plain_dkv``) and its bound; SDPA's backward, pinned to PyTorch's
    flash-attention backend (kv heads repeated beforehand), computes dq, dk
    and dv in one call, so its times (``library_ms`` launched,
    ``library_device_ms`` by graph replay of the aten backward op) stand
    once, on the dq row, marked as covering both kernels."""
    dev = "cuda"
    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, B, Sq, Skv, H, Hkv, D, dtype, causal, window, softcap
        ("train", TRAIN_B, TRAIN_S, TRAIN_S, HEADS, KV_HEADS, HEAD_DIM, bf,
         True, 0, 0.0),
        ("sq<skv", 2, 77, 200, HEADS, KV_HEADS, HEAD_DIM, bf, True, 0, 0.0),
        ("window+softcap", 2, 150, 150, 8, 2, 64, f32, True, 37, 30.0),
        ("no-key rows", 2, 100, 60, 6, 3, 128, f32, True, 0, 0.0),
        ("non-causal ragged", 1, 45, 45, 4, 4, 96, f32, False, 0, 0.0),
        ("window no-key", 1, 40, 21, 4, 2, 32, f32, True, 5, 2.0),
        *((f"window+softcap bf16 D={d}", 2, 150, 150, 8, 2, d, bf, True, 37,
           30.0) for d in (64, 96, 128)),
        *((f"no-key rows bf16 D={d}", 2, 100, 60, 6, 3, d, bf, True, 0, 0.0)
          for d in (64, 96, 128)),
        *((f"non-causal ragged bf16 D={d}", 1, 45, 45, 4, 4, d, bf, False, 0,
           0.0) for d in (64, 96, 128)),
        ("window no-key bf16", 1, 40, 21, 4, 2, 32, bf, True, 5, 2.0),
        ("D=256 bf16 (SIMT)", 1, 130, 130, 4, 2, 256, bf, True, 0, 0.0),
        ("D=72 bf16 (SIMT)", 1, 33, 40, 4, 2, 72, bf, True, 0, 0.0),
    ]
    rows = {"flash_attention_dq": [], "flash_attention_dkv": []}
    max_err = {"flash_attention_dq": 0.0, "flash_attention_dkv": 0.0}
    for name, B, Sq, Skv, H, Hkv, D, dt, causal, window, softcap in cases:
        q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, Skv, Hkv, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, Skv, Hkv, D, generator=gen, device=dev).to(dt)
        do = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        tc0 = (fa.flash_attention_dq.tc_launches,
               fa.flash_attention_dkv.tc_launches)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        tc = (fa.flash_attention_dq.tc_launches - tc0[0],
              fa.flash_attention_dkv.tc_launches - tc0[1])
        want_tc = int(dt == bf and D % 16 == 0 and D <= 128)
        if tc != (want_tc, want_tc):
            raise AssertionError(f"flash backward {name}: tensor-core "
                                 f"launches (dq, dkv) {tc}")
        want = fa.plain_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        errs = []
        for g, w in zip(got, want):
            if dt == bf:
                ok, e = close_bf16(g, w, 1e-4)
            else:
                e = (g - w).abs().max().item()
                ok = e <= 1e-4 * w.abs().max().item() and \
                    bool(torch.isfinite(g).all())
            if not ok or g.dtype != dt:
                raise AssertionError(f"flash backward {name}: max errs {errs + [e]}")
            errs.append(e)
        dead = (torch.arange(Sq, device=dev) + (Skv - Sq) < 0) if causal else None
        if dead is not None and bool(dead.any()) and \
                not bool((got[0][:, dead] == 0).all()):
            raise AssertionError(f"flash backward {name}: dq of rows with no key")
        kerr = {"flash_attention_dq": errs[0],
                "flash_attention_dkv": max(errs[1], errs[2])}
        for kname, e in kerr.items():
            max_err[kname] = max(max_err[kname], e)
        branch = "tensor cores" if want_tc else "simt"
        log(f"[kernels] flash backward {name} {[B, Sq, Skv, H, Hkv, D]} "
            f"({branch}): max err dq {errs[0]:.3g}, dk {errs[1]:.3g}, "
            f"dv {errs[2]:.3g}")
        if name != "train":
            continue
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        launched, device = sdpa_flash_backward(torch, q, k, v, do)
        library = {"library_ms": cuda_time_ms([launched], 20),
                   "library_device_ms": graph_time_ms([device], 20),
                   "library_covers": "flash_attention_dq+flash_attention_dkv",
                   "library_backend": "SDPA backward pinned to "
                                      "SDPBackend.FLASH_ATTENTION (aten::"
                                      "_scaled_dot_product_flash_attention_"
                                      "backward)"}
        pairs = B * H * Sq * (Sq + 1) // 2             # causal, Sq == Skv
        ins = 2 * (2 * q.numel() + k.numel() + v.numel()) + 8 * B * H * Sq
        args = (q, k, v, do, lse, delta)
        for kname, fn, plain, flops, outs, lib in (
                ("flash_attention_dq", fa.flash_attention_dq, fa.plain_dq,
                 6.0 * D * pairs, 2 * q.numel(), library),
                ("flash_attention_dkv", fa.flash_attention_dkv, fa.plain_dkv,
                 8.0 * D * pairs, 2 * (k.numel() + v.numel()),
                 {"library_ms": None, "library_device_ms": None,
                  "library_covers": "see flash_attention_dq"})):
            kern = [lambda: fn(*args, **kw)]
            tc0 = fn.tc_launches
            row = {"case": name, "shape": [B, Sq, Skv, H, Hkv, D],
                   "branch": branch, "max_abs_err": kerr[kname],
                   "ms": cuda_time_ms(kern, 20),
                   "device_ms": graph_time_ms(kern, 20),
                   "plain_ms": cuda_time_ms([lambda: plain(*args, **kw)], 5),
                   **lib}
            if fn.tc_launches == tc0:
                raise AssertionError(f"{kname} {name}: timed off the tensor "
                                     "cores")
            row["repeats_bit_equal"] = bit_stable(
                torch, lambda: fn(*args, **kw), 20, f"{kname} {name}")
            row["bound_ms"], row["bound_by"] = bound(ins + outs, flops)
            rows[kname].append(row)
            log(f"[kernels] {kname} {row['shape']}: " + ", ".join(
                f"{key}={val:.4g}" if isinstance(val, float) else f"{key}={val}"
                for key, val in row.items() if key not in ("case", "shape")))
        del launched, device, args
    torch.cuda.empty_cache()
    return rows, max_err


def check_sr_quantize(torch, sq, gen):
    """Both SR int8 kernels against their plain versions, words bit for
    bit: at every leaf shape of llama3.2-3b (the stacked blocks/ leaves
    with a per-layer FL that takes 0, 10 and 28 among others, embed and
    head flat, and one layer of each blocks/ leaf flat, as the prologue's
    regularizer draws it), and at ragged shapes: n not a multiple of 512 or of 4 (the
    scalar path), one layer equal to the flat kernel, FL −3…28, negative
    and large seeds. Times: kernel, plain version, bound (4 bytes read and
    1 written per element; the ~20 integer and float operations per
    element at the CUDA-core rate take less)."""
    dev = "cuda"
    rows = {"sr_quantize_fused_stacked_int8": [],
            "sr_quantize_fused_int8": []}

    def fls_for(L):
        return torch.tensor([(0, 10, 28, 4, 17, -3, 9)[l % 7] for l in range(L)],
                            dtype=torch.int32, device=dev)

    def timed(name, shape, x, seed, fl, kern, plain):
        got, want = kern(x, seed, fl), plain(x, seed, fl)
        torch.cuda.synchronize()
        if got.dtype != torch.int8 or not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{name} {shape}: {bad} words differ")
        n = x.numel()
        row = {"shape": list(shape), "max_abs_err": 0.0,
               "ms": cuda_time_ms([lambda: kern(x, seed, fl)], 5),
               "plain_ms": cuda_time_ms([lambda: plain(x, seed, fl)], 2),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = max(
            (5.0 * n / HBM_BYTES_PER_S * 1e3, "bytes"),
            (20.0 * n / F32_OPS * 1e3, "operations"))
        rows[name].append(row)
        log(f"[kernels] {name} {list(shape)}: bit-equal, ms={row['ms']:.4g}, "
            f"plain_ms={row['plain_ms']:.4g}, bound_ms={row['bound_ms']:.4g}")
        del got, want

    for (k, n) in STACKED_SHAPES:
        x = torch.randn(N_LAYERS, k, n, generator=gen, device=dev) * 0.05
        timed("sr_quantize_fused_stacked_int8", (N_LAYERS, k, n), x, -12345,
              fls_for(N_LAYERS), sq.sr_quantize_fused_stacked_int8,
              sq.plain_stacked)
        del x
        torch.cuda.empty_cache()
    # embed and head; the layer slices the prologue's regularizer view draws
    for shape in FLAT_SHAPES + list(STACKED_SHAPES):
        x = torch.randn(*shape, generator=gen, device=dev) * 0.05
        fl = torch.tensor(10, dtype=torch.int32, device=dev)
        timed("sr_quantize_fused_int8", shape, x, 2 ** 31 - 7, fl,
              sq.sr_quantize_fused_int8, sq.plain)
        del x
        torch.cuda.empty_cache()
    # ragged shapes, every FL, seeds of both signs
    for shape in [(3, 1000), (5, 513), (2, 1001), (7, 3, 5, 7), (1, 777),
                  (32, 130)]:
        x = torch.randn(*shape, generator=gen, device=dev) * 3.0
        for seed in (-1, 0, 987654321, -2 ** 31):
            fl = fls_for(shape[0])
            got = sq.sr_quantize_fused_stacked_int8(x, seed, fl)
            if not torch.equal(got, sq.plain_stacked(x, seed, fl)):
                raise AssertionError(f"stacked SR {shape} seed {seed}")
            flat = sq.sr_quantize_fused_int8(x[0].contiguous(), seed, fl[0])
            if not torch.equal(flat, sq.plain(x[0], seed, fl[0])):
                raise AssertionError(f"flat SR {shape[1:]} seed {seed}")
            if shape[0] == 1 and not torch.equal(flat, got[0]):
                raise AssertionError("one stacked layer != the flat kernel")
    x = torch.randn(32, 700, generator=gen, device=dev)
    for f in range(-3, 29):
        fl = torch.full((32,), f, dtype=torch.int32, device=dev)
        x32 = x * 2.0 ** (6 - f)
        if not torch.equal(sq.sr_quantize_fused_stacked_int8(x32, -77, fl),
                           sq.plain_stacked(x32, -77, fl)):
            raise AssertionError(f"stacked SR at FL {f}")
    for case in pathological(torch):
        x = case.to(dev)
        for f in (0, 4, 12):
            fl = torch.tensor(f, dtype=torch.int32, device=dev)
            if not torch.equal(sq.sr_quantize_fused_int8(x, 31, fl),
                               sq.plain(x, 31, fl)):
                raise AssertionError(f"flat SR pathological at FL {f}")
    log("[kernels] sr_quantize ragged shapes, FL -3..28, seeds of both signs, "
        "pathological values: bit-equal")
    return rows


def check_sr_grid(torch, sq, gen):
    """Both float SR kernels (grid values) against their plain versions,
    bit for bit in f32 and in bf16: at every leaf shape of llama3.2-3b (the
    stacked blocks/ leaves with a per-layer <WL,FL> that takes WL 2…32 and
    FL −3…28 among others; embed and head flat at <8,10>), and at ragged
    shapes, WL 2…32 against FL −3…28, seeds of both signs and the
    pathological values. Times (f32 and bf16 out): kernel, plain version,
    bound (4 bytes read and 4 or 2 written per element; the ~22 integer and
    float operations per element, a division among them, at the CUDA-core
    rate take less)."""
    dev = "cuda"
    rows = {"sr_quantize_fused_stacked": [], "sr_quantize_fused": []}
    wl_cycle = (8, 16, 32, 2, 12, 24, 5)
    fl_cycle = (10, 13, 28, 0, -3, 17, 4)

    def prec(L):
        return (torch.tensor([wl_cycle[l % 7] for l in range(L)],
                             dtype=torch.int32, device=dev),
                torch.tensor([fl_cycle[l % 7] for l in range(L)],
                             dtype=torch.int32, device=dev))

    def same(got, want):
        return got.dtype == want.dtype and torch.equal(
            got.view(torch.int16 if got.dtype == torch.bfloat16
                     else torch.int32),
            want.view(torch.int16 if want.dtype == torch.bfloat16
                      else torch.int32))

    def timed(name, shape, x, seed, wl, fl, kern, plain):
        for dt in (torch.float32, torch.bfloat16):
            got = kern(x, seed, wl, fl, out_dtype=dt)
            want = plain(x, seed, wl, fl, out_dtype=dt)
            torch.cuda.synchronize()
            if not same(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"{name} {shape} {dt}: {bad} values differ")
            del got, want
            n = x.numel()
            out_b = 4 if dt == torch.float32 else 2
            row = {"shape": list(shape), "out": str(dt).split(".")[-1],
                   "max_abs_err": 0.0,
                   "ms": cuda_time_ms([lambda: kern(x, seed, wl, fl,
                                                    out_dtype=dt)], 5),
                   "plain_ms": cuda_time_ms([lambda: plain(
                       x, seed, wl, fl, out_dtype=dt)], 2),
                   "library_ms": None}
            row["bound_ms"], row["bound_by"] = max(
                ((4.0 + out_b) * n / HBM_BYTES_PER_S * 1e3, "bytes"),
                (22.0 * n / F32_OPS * 1e3, "operations"))
            rows[name].append(row)
            log(f"[kernels] {name} {list(shape)} {row['out']}: bit-equal, "
                f"ms={row['ms']:.4g}, plain_ms={row['plain_ms']:.4g}, "
                f"bound_ms={row['bound_ms']:.4g}")

    for (k, n) in STACKED_SHAPES:
        x = torch.randn(N_LAYERS, k, n, generator=gen, device=dev) * 0.05
        timed("sr_quantize_fused_stacked", (N_LAYERS, k, n), x, -12345,
              *prec(N_LAYERS), sq.sr_quantize_fused_stacked,
              sq.plain_grid_stacked)
        del x
        torch.cuda.empty_cache()
    for shape in FLAT_SHAPES:
        x = torch.randn(*shape, generator=gen, device=dev) * 0.05
        wl = torch.tensor(8, dtype=torch.int32, device=dev)
        fl = torch.tensor(10, dtype=torch.int32, device=dev)
        timed("sr_quantize_fused", shape, x, 2 ** 31 - 7, wl, fl,
              sq.sr_quantize_fused, sq.plain_grid)
        del x
        torch.cuda.empty_cache()
    # ragged shapes, seeds of both signs, both output dtypes
    for shape in [(3, 1000), (5, 513), (2, 1001), (7, 3, 5, 7), (1, 777),
                  (32, 130)]:
        x = torch.randn(*shape, generator=gen, device=dev) * 3.0
        wl, fl = prec(shape[0])
        for seed in (-1, 0, 987654321, -2 ** 31):
            for dt in (torch.float32, torch.bfloat16):
                got = sq.sr_quantize_fused_stacked(x, seed, wl, fl, out_dtype=dt)
                if not same(got, sq.plain_grid_stacked(x, seed, wl, fl,
                                                       out_dtype=dt)):
                    raise AssertionError(f"stacked grid {shape} seed {seed} {dt}")
                flat = sq.sr_quantize_fused(x[0].contiguous(), seed, wl[0],
                                            fl[0], out_dtype=dt)
                if not same(flat, sq.plain_grid(x[0], seed, wl[0], fl[0],
                                                out_dtype=dt)):
                    raise AssertionError(f"flat grid {shape[1:]} seed {seed} {dt}")
                if shape[0] == 1 and not same(flat, got[0]):
                    raise AssertionError("one stacked layer != the flat kernel")
    # every WL against every FL
    x = torch.randn(32, 700, generator=gen, device=dev)
    for f in range(-3, 29):
        fl = torch.full((31,), f, dtype=torch.int32, device=dev)
        wl = torch.arange(2, 33, dtype=torch.int32, device=dev)
        x31 = x[:31] * 2.0 ** (6 - f)
        for dt in (torch.float32, torch.bfloat16):
            if not same(sq.sr_quantize_fused_stacked(x31, -77, wl, fl, out_dtype=dt),
                        sq.plain_grid_stacked(x31, -77, wl, fl, out_dtype=dt)):
                raise AssertionError(f"stacked grid at FL {f} {dt}")
    for case in pathological(torch):
        x = case.to(dev)
        for w, f in ((8, 0), (8, 4), (16, 12), (32, 20)):
            wl = torch.tensor(w, dtype=torch.int32, device=dev)
            fl = torch.tensor(f, dtype=torch.int32, device=dev)
            if not same(sq.sr_quantize_fused(x, 31, wl, fl),
                        sq.plain_grid(x, 31, wl, fl)):
                raise AssertionError(f"flat grid pathological at <{w},{f}>")
    log("[kernels] sr_quantize_fused[_stacked] ragged shapes, WL 2..32 x "
        "FL -3..28, seeds of both signs, pathological values, f32 and bf16: "
        "bit-equal")
    return rows


def misaligned(torch, t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary (a column slice made contiguous at an odd offset), so
    the tensor-core wrappers must pad it."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


# Ragged <M, K, N> of the matmul checks: ragged cases of every tile edge of
# the SIMT (128) and tensor-core (64 wide, 256 or 512 rows) kernels,
# K % 8 != 0 and N % 8 != 0 (the wrappers pad rows for TMA), M not a
# multiple of 512, K and N multiples of 8 but not of 64; a fifth case
# passes x / dy misaligned.
RAGGED = [(37, 3071, 1025), (130, 257, 129), (7, 67, 33), (2050, 100, 8),
          (700, 200, 328)]
MISALIGNED = (600, 264, 136)


def check_qmatmul(torch, fm, gen):
    """``fxp_qmatmul`` and ``matmul_qdx`` against their plain versions at
    every (K, N) of the training path and the head with M = batch·seq,
    bf16 x/dy and out as on the main path, in both modes (SR and RTN), and
    the same bf16 inputs with f32 out; plus the ragged <M, K, N> of
    ``RAGGED`` and a misaligned x / dy in both modes with f32 and bf16
    operands. Tolerance: the kernel and the plain version sum
    the same exact f32 products (the same words: any word that differed
    would move a sum by a whole step) in other orders, so f32 outputs are
    held within 1e-5·max|plain| and bf16 outputs within one bf16 ulp +
    2^-16·max|plain|. Each bf16 call must take the tensor-core branch and
    each f32 one the SIMT kernel. Times (SR, the main path's mode): the
    kernel, the plain version, one ``torch.matmul`` of bf16 x (dy) against
    the bf16-dequantized words (their transpose) and the bound; the kernel
    and the library call also by CUDA-graph replay (``device_ms``,
    ``library_device_ms``). The prologue's dw, ``matmul_dw`` with f32 out,
    is timed in ``check_matmul_bwd``."""
    from repro_torch.kernels import ops
    dev = "cuda"
    rows = {"fxp_qmatmul": [], "matmul_qdx": []}
    max_err = {"fxp_qmatmul": 0.0, "matmul_qdx": 0.0}
    f = 10
    fl = torch.tensor(f, dtype=torch.int32, device=dev)
    m = TRAIN_M
    cases = [(m, k, n) for (k, n) in LAYER_SHAPES] + [(m, *HEAD_SHAPE)]
    cases += RAGGED + [MISALIGNED]
    counters = (fm.fxp_qmatmul, fm.matmul_qdx)

    def f32_close(got, want, what):
        e = (got.float() - want.float()).abs().max().item()
        if got.dtype != torch.float32 or not bool(torch.isfinite(got).all()) \
                or e > 1e-5 * want.float().abs().max().item():
            raise AssertionError(f"{what}: max err {e}")
        return e

    def on_branch(fn, want_tc, what):
        """Call ``fn``; it must launch one kernel, on the tensor cores iff
        ``want_tc``."""
        before = [(c.launches, c.tc_launches) for c in counters]
        out = fn()
        moved = [(c.launches - l0, c.tc_launches - t0)
                 for c, (l0, t0) in zip(counters, before)]
        if sum(l for l, _ in moved) != 1 or sum(t for _, t in moved) != int(want_tc):
            raise AssertionError(f"{what}: launches {moved}, want tensor "
                                 f"cores {want_tc}")
        return out

    for (m, k, n) in cases:
        timed = m == TRAIN_M
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        dy = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn(k, n, generator=gen, device=dev) * 0.02
        if (m, k, n) == MISALIGNED:
            x, dy = misaligned(torch, x), misaligned(torch, dy)
        seed = -(m * 7 + k)
        for mode in (1, 0):
            for name, kern, plain, a in (
                    ("fxp_qmatmul", fm.fxp_qmatmul, fm.plain_q, x),
                    ("matmul_qdx", fm.matmul_qdx, fm.plain_qdx, dy)):
                want = plain(a, w, seed, fl, mode)
                what = f"{name} mode {mode} ({m},{k},{n})"
                got = on_branch(lambda: kern(a, w, seed, fl, mode), True, what)
                torch.cuda.synchronize()
                ok, e = close_bf16(got, want, 2.0 ** -16)
                if not ok or got.dtype != torch.bfloat16:
                    raise AssertionError(f"{what}: max err {e}")
                max_err[name] = max(max_err[name], e)
                del got, want
                e32 = f32_close(
                    on_branch(lambda: kern(a, w, seed, fl, mode,
                                           out_dtype=torch.float32),
                              True, f"{name} f32 out"),
                    plain(a, w, seed, fl, mode, out_dtype=torch.float32),
                    f"{name} f32 out mode {mode} ({m},{k},{n})")
                if not timed:
                    af = a.float()
                    f32_close(on_branch(lambda: kern(af, w, seed, fl, mode),
                                        False, f"{name} f32"),
                              plain(af, w, seed, fl, mode),
                              f"{name} f32 mode {mode} ({m},{k},{n})")
                max_err[name] = max(max_err[name], e32)
        if not timed:
            log(f"[kernels] fxp_qmatmul/matmul_qdx {m}x{k}x{n} (ragged"
                f"{', misaligned' if (m, k, n) == MISALIGNED else ''}, both "
                "modes, bf16 and f32): within tolerance")
            continue
        reps = 10 if k * n < 1e8 else 3
        flops = 2.0 * m * k * n
        words = (ops.qdense_words(w, seed, fl, 1).to(torch.bfloat16)
                 * torch.tensor(2.0 ** -f, dtype=torch.bfloat16, device=dev))
        for name, kern, plain, a, lib, nbytes in (
                ("fxp_qmatmul", fm.fxp_qmatmul, fm.plain_q, x,
                 lambda: torch.matmul(x, words),
                 2 * m * k + 4 * k * n + 2 * m * n),
                ("matmul_qdx", fm.matmul_qdx, fm.plain_qdx, dy,
                 lambda: torch.matmul(dy, words.T),
                 2 * m * n + 4 * k * n + 2 * m * k)):
            row = {"m": m, "k": k, "n": n, "max_abs_err": max_err[name],
                   "ms": cuda_time_ms([lambda: kern(a, w, seed, fl, 1)], reps),
                   "plain_ms": cuda_time_ms([lambda: plain(a, w, seed, fl, 1)],
                                            max(2, reps // 3)),
                   "library_ms": cuda_time_ms([lib], reps),
                   "device_ms": graph_time_ms([lambda: kern(a, w, seed, fl, 1)],
                                              reps),
                   "library_device_ms": graph_time_ms([lib], reps)}
            if (k, n) == HEAD_SHAPE:
                row["repeats_bit_equal"] = bit_stable(
                    torch, lambda: kern(a, w, seed, fl, 1), 20,
                    f"{name} ({m},{k},{n})")
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
            rows[name].append(row)
            log(f"[kernels] {name} {m}x{k}x{n}: " + ", ".join(
                f"{key}={val:.4g}" if isinstance(val, float) else f"{key}={val}"
                for key, val in row.items() if key not in ("m", "k", "n")))
        del x, dy, w, words
        torch.cuda.empty_cache()
    return rows, max_err


def check_cublas_reduction(torch, gen):
    """The float containers' dense layers are cuBLAS bf16 GEMMs with f32
    accumulation (``models/common._mm``), which turns off
    ``allow_bf16_reduced_precision_reduction`` so that split-K partial
    sums are not reduced in bf16. At every training shape (M = 2048, the
    forward's x @ w), the products with the flag on and off: how many
    bf16 outputs differ, the largest difference, and each one's time."""
    from repro_torch.models import common
    flags = torch.backends.cuda.matmul
    rows = []
    for (k, n) in list(LAYER_SHAPES) + [HEAD_SHAPE]:
        x = torch.randn(TRAIN_M, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(k, n, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        before = flags.allow_bf16_reduced_precision_reduction
        flags.allow_bf16_reduced_precision_reduction = True
        on = torch.matmul(x, w)
        on_ms = cuda_time_ms([lambda: torch.matmul(x, w)], 10)
        flags.allow_bf16_reduced_precision_reduction = before
        off = common._mm(x, w)
        off_ms = cuda_time_ms([lambda: common._mm(x, w)], 10)
        exact = (x.float() @ w.float()).to(torch.bfloat16)
        rows.append({"k": k, "n": n,
                     "differ": int((on != off).sum()),
                     "max_abs_diff": (on.float() - off.float()).abs().max().item(),
                     "off_differs_from_f32": int((off != exact).sum()),
                     "on_ms": on_ms, "off_ms": off_ms})
        log(f"[cublas] bf16 GEMM {TRAIN_M}x{k}x{n}: reduced-precision "
            f"reduction on/off differ in {rows[-1]['differ']} of {on.numel()} "
            f"outputs (max {rows[-1]['max_abs_diff']:.4g}); off vs f32 "
            f"products rounded once: {rows[-1]['off_differs_from_f32']} "
            f"differ; {on_ms:.4g} / {off_ms:.4g} ms")
        del x, w, on, off, exact
    torch.cuda.empty_cache()
    return rows


def check_ops_kernels(torch, gen):
    """The three kernels only ``kernels/ops`` reaches, each against its
    plain version on the same inputs. ``sr_quantize`` (the noise given),
    values bit for bit: the stacked (28, 3072, 8192) f32 leaf at <8,4> and
    <16,13>, one (3072, 8192) layer of it (the shape of the ops path), bf16
    x, a ragged 1-D size, the pathological values. ``int8_matmul`` bit for
    bit against the f64 plain version (exact: |acc| < 2^31 << 2^53, and
    f64 -> f32 rounds as int32 -> f32 does) at M = 2048 on the four dense
    shapes and the head, at 509 x 1031 x 127, at M = 4 and on the largest
    sums (all words -128 with K = 8192: acc = 2^27; all 127: 132 128 768,
    which f32 rounds); its scale gradients through ``ops.int8_matmul``
    within 1e-5 relative of the plain version's (Σ dy·acc in another
    order). ``kl_hist`` counts bit for bit on that leaf against its SR copy
    at 256 and 150 bins and on the pathological values. Times: the kernel,
    the plain version, a library yardstick (``torch._int_mm``, cuBLASLt's
    int8 product with int32 out; two ``torch.histc`` calls over [lo, hi],
    timed only, since histc bins by its own formula; none for the SR
    values) and the bound."""
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import kl_hist as kh
    from repro_torch.kernels import ops
    from repro_torch.kernels import sr_quantize as sq
    dev = "cuda"
    rows = {"sr_quantize": [], "int8_matmul": [], "kl_hist": []}

    def i32(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    def scalars(wl, fl):
        return (torch.tensor(wl, dtype=torch.int32, device=dev),
                torch.tensor(fl, dtype=torch.int32, device=dev))

    def sr_case(x, u, wl, fl, timed):
        wlt, flt = scalars(wl, fl)
        got, want = sq.sr_quantize(x, u, wlt, flt), sq.plain_given(x, u, wlt, flt)
        torch.cuda.synchronize()
        if got.dtype != x.dtype or not torch.equal(i32(got), i32(want)):
            bad = int((i32(got) != i32(want)).sum())
            raise AssertionError(f"sr_quantize {tuple(x.shape)} {x.dtype} "
                                 f"<{wl},{fl}>: {bad} values differ")
        if not timed:
            return got
        n, xb = x.numel(), x.element_size()
        row = {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
               "max_abs_err": 0.0,
               "ms": cuda_time_ms([lambda: sq.sr_quantize(x, u, wlt, flt)], 5),
               "plain_ms": cuda_time_ms([lambda: sq.plain_given(
                   x, u, wlt, flt)], 2),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = max(
            ((2 * xb + 4.0) * n / HBM_BYTES_PER_S * 1e3, "bytes"),
            (12.0 * n / F32_OPS * 1e3, "operations"))
        rows["sr_quantize"].append(row)
        log(f"[kernels] sr_quantize {row['shape']} {row['dtype']}: bit-equal, "
            f"ms={row['ms']:.4g}, plain_ms={row['plain_ms']:.4g}, "
            f"bound_ms={row['bound_ms']:.4g}")
        return got

    x = torch.randn(N_LAYERS, D_MODEL, D_FF, generator=gen, device=dev) * 0.05
    u = torch.rand(x.shape, generator=gen, device=dev)
    sr_case(x, u, 8, 4, False)
    q = sr_case(x, u, 16, 13, True)
    sr_case(x[0].contiguous(), u[0].contiguous(), 16, 13, True)
    del u
    # kl_hist on the leaf against its SR copy
    for nb in (256, 150):
        got, want = kh.kl_hist(x, q, nb), kh.plain(x, q, nb)
        torch.cuda.synchronize()
        # every element in some bin: the f32 counts (exact up to 2^24, within
        # half an ulp above it, as the reference's) add up to numel within
        # their own rounding, summed in f64
        c = got[0].double()
        half_ulp = torch.where(c >= 2.0 ** 24,
                               torch.exp2(torch.floor(torch.log2(c.clamp_min(1.0))) - 24),
                               torch.zeros_like(c))
        missing = abs(float(c.sum()) - x.numel())
        if not torch.equal(got, want) or missing > float(half_ulp.sum()):
            raise AssertionError(f"kl_hist {tuple(x.shape)} {nb} bins: counts "
                                 f"differ by {(got - want).abs().max().item()}, "
                                 f"sum off numel by {missing}")
        if nb != 256:
            continue
        lo, hi = (float(v) for v in torch.aminmax(x))
        n = x.numel()
        row = {"shape": list(x.shape), "bins": nb, "max_abs_err": 0.0,
               "ms": cuda_time_ms([lambda: kh.kl_hist(x, q, nb)], 5),
               "plain_ms": cuda_time_ms([lambda: kh.plain(x, q, nb)], 2),
               "library_ms": cuda_time_ms([lambda: (
                   torch.histc(x, nb, lo, hi), torch.histc(q, nb, lo, hi))], 5),
               "library_covers": "two torch.histc calls (their own bin formula)"}
        row["bound_ms"], row["bound_by"] = max(
            (8.0 * n / HBM_BYTES_PER_S * 1e3, "bytes"),
            (12.0 * n / F32_OPS * 1e3, "operations"))
        rows["kl_hist"].append(row)
        log(f"[kernels] kl_hist {row['shape']} {nb} bins: bit-equal, "
            f"ms={row['ms']:.4g}, plain_ms={row['plain_ms']:.4g}, "
            f"histc x2 {row['library_ms']:.4g}, bound_ms={row['bound_ms']:.4g}")
    del x, q
    torch.cuda.empty_cache()
    # bf16 x, a ragged size, the pathological values
    xb = (torch.randn(D_MODEL, D_FF, generator=gen, device=dev) * 0.05).to(
        torch.bfloat16)
    sr_case(xb, torch.rand(xb.shape, generator=gen, device=dev), 8, 4, True)
    for dt in (torch.float32, torch.bfloat16):
        xr = (torch.randn(1000003, generator=gen, device=dev) * 3).to(dt)
        for wl, fl in ((8, 4), (16, 13), (32, 20), (2, -3)):
            sr_case(xr, torch.rand(xr.shape, generator=gen, device=dev), wl, fl,
                    False)
    for case in pathological(torch):
        xp = case.to(dev)
        up = torch.rand(xp.shape, generator=gen, device=dev)
        up[::7] = 0.0
        for wl, fl in ((8, 0), (8, 4), (16, 12), (32, 20)):
            sr_case(xp, up, wl, fl, False)
        for nb in (50, 256):
            qp = sq.plain_given(xp, up, *scalars(8, 4))
            if not torch.equal(kh.kl_hist(xp, qp, nb), kh.plain(xp, qp, nb)):
                raise AssertionError(f"kl_hist pathological at {nb} bins")
    log("[kernels] sr_quantize bf16, ragged and pathological; kl_hist "
        "pathological: bit-equal")

    # int8_matmul
    s = torch.tensor(0.02 * 0.3, dtype=torch.float32, device=dev)
    cases = [(TRAIN_M, k, n) for (k, n) in LAYER_SHAPES] + [(TRAIN_M, *HEAD_SHAPE)]
    cases += [(509, 1031, 127), (BATCH, D_MODEL, D_MODEL), (37, 3071, 1025)]
    for (m, k, n) in cases:
        xq = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        got, want = im.int8_matmul(xq, wq, s), im.plain(xq, wq, s)
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or not torch.equal(got, want):
            raise AssertionError(f"int8_matmul ({m},{k},{n}): max err "
                                 f"{(got - want).abs().max().item()}")
        del got, want
        if m != TRAIN_M:
            continue
        reps = 10 if k * n < 1e8 else 3
        row = {"m": m, "k": k, "n": n, "max_abs_err": 0.0,
               "ms": cuda_time_ms([lambda: im.int8_matmul(xq, wq, s)], reps),
               "plain_ms": cuda_time_ms([lambda: im.plain(xq, wq, s)],
                                        max(2, reps // 3)),
               "library_ms": cuda_time_ms([lambda: torch._int_mm(xq, wq)], reps),
               "library_covers": "torch._int_mm (int32 out, no scale)"}
        row["bound_ms"], row["bound_by"] = max(
            ((m * k + k * n + 4.0 * m * n) / HBM_BYTES_PER_S * 1e3, "bytes"),
            (2.0 * m * k * n / INT8_OPS * 1e3, "operations"))
        rows["int8_matmul"].append(row)
        log(f"[kernels] int8_matmul {m}x{k}x{n}: bit-equal, ms={row['ms']:.4g}, "
            f"plain_ms={row['plain_ms']:.4g}, _int_mm {row['library_ms']:.4g}, "
            f"bound_ms={row['bound_ms']:.4g} ({row['bound_by']})")
        del xq, wq
    one = torch.ones((), dtype=torch.float32, device=dev)
    for word, want_acc in ((-128, 2.0 ** 27), (127, 132128768.0)):
        xq = torch.full((64, 8192), word, dtype=torch.int8, device=dev)
        got = im.int8_matmul(xq, xq.T.contiguous(), one)
        if not torch.equal(got, im.plain(xq, xq.T.contiguous(), one)) \
                or float(got[0, 0]) != want_acc:
            raise AssertionError(f"int8_matmul largest sums ({word}): "
                                 f"{float(got[0, 0])}")
    xq = torch.randint(-128, 128, (TRAIN_M, D_MODEL), generator=gen, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (D_MODEL, KV_HEADS * HEAD_DIM), generator=gen,
                       device=dev, dtype=torch.int8)
    dy = torch.randn(TRAIN_M, KV_HEADS * HEAD_DIM, generator=gen, device=dev)
    sx = torch.tensor(0.02, device=dev, requires_grad=True)
    sw = torch.tensor(0.3, device=dev, requires_grad=True)
    got = torch.autograd.grad(ops.int8_matmul(xq, wq, sx, sw, use_pallas=True),
                              (sx, sw), dy)
    g0 = torch.sum(dy * im.plain(xq, wq, one))
    for g, w in zip(got, (g0 * sw.detach(), g0 * sx.detach())):
        if not abs(float(g) - float(w)) <= 1e-5 * abs(float(w)):
            raise AssertionError(f"int8_matmul scale gradients {got} vs "
                                 f"{float(g0 * sw)}, {float(g0 * sx)}")
    log("[kernels] int8_matmul ragged, M = 4, largest sums: bit-equal; scale "
        "gradients within 1e-5")
    del xq, wq, dy
    torch.cuda.empty_cache()
    return rows


def pathological(torch):
    """The pathological tensors of tests/test_quantize_differential.py."""
    f32 = torch.float32
    return [torch.tensor([0.0, -0.0] * 320, dtype=f32),
            torch.tensor([1e-42, -3e-41, 5e-44, -1e-45] * 160, dtype=f32),
            torch.tensor([3.3e38, -3.3e38, 1e30, -1e25] * 160, dtype=f32),
            torch.full((640,), 0.3, dtype=f32),
            torch.full((640,), -1.75, dtype=f32),
            torch.tensor([0.0, -0.0, 1e-42, 3.3e38, -3.3e38, 0.5, -0.5,
                          1.0] * 80, dtype=f32)]


def edf_inputs(torch, w):
    """PushDown's range-derived FLs of each layer of w (L, n)."""
    from repro_torch.core import fixed_point as fxp
    from repro_torch.core import pushdown
    ladder = torch.tensor(pushdown.WL_LADDER, dtype=torch.int32,
                          device=w.device)
    return fxp.fl_for_wl(w.abs().amax(dim=1, keepdim=True),
                         ladder.reshape(1, -1))


def check_edf_ladder(torch, el, gen):
    """The EDF-ladder kernel against its plain version, counts bit for bit:
    at (28, 65536) and (1, 65536), the subsample of a switch of
    llama3.2-3b, with per-layer live bins in [50, 150]; at ragged sizes;
    on the pathological values (a bin that is NaN counted in no row).
    Times: kernel, plain version, bound (each input read once, the counts
    written once; ~166 f32 operations per element at the CUDA-core
    rate)."""
    from repro_torch.core import pushdown
    dev = "cuda"
    kw = dict(wl_ladder=pushdown.WL_LADDER, r_upr=150)
    T = len(pushdown.WL_LADDER)
    rows = []
    for L, n in ((N_LAYERS, EDF_SAMPLE), (1, EDF_SAMPLE), (3, 65541),
                 (2, 1), (4, 127)):
        w = torch.randn(L, n, generator=gen, device=dev) * 0.02
        fls = edf_inputs(torch, w)
        r = torch.randint(50, 151, (L,), generator=gen, device=dev,
                          dtype=torch.int32)
        got = el.edf_ladder_hists(w, fls, r, **kw)
        want = el.plain(w, fls, r, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"edf_ladder ({L}, {n}): counts differ by "
                                 f"{(got - want).abs().max().item()}")
        if not bool((got.sum(dim=2) == n).all()):
            raise AssertionError(f"edf_ladder ({L}, {n}): rows do not sum to n")
        if n == EDF_SAMPLE:
            row = {"shape": [L, n], "max_abs_err": 0.0,
                   "ms": cuda_time_ms([lambda: el.edf_ladder_hists(
                       w, fls, r, **kw)], 20),
                   "plain_ms": cuda_time_ms([lambda: el.plain(
                       w, fls, r, **kw)], 5),
                   "library_ms": None}
            nbytes = 4.0 * (L * n + L * T + L + 2 * L + T) + \
                4.0 * L * (1 + T) * 150
            row["bound_ms"], row["bound_by"] = max(
                (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                (166.0 * L * n / F32_OPS * 1e3, "operations"))
            rows.append(row)
            log(f"[kernels] edf_ladder_hists ({L}, {n}): bit-equal, "
                f"ms={row['ms']:.4g}, plain_ms={row['plain_ms']:.4g}, "
                f"bound_ms={row['bound_ms']:.4g}")
    for case in pathological(torch):
        w = case.to(dev).reshape(1, -1)
        fls = edf_inputs(torch, w)
        for rr in (50, 150):
            r = torch.tensor([rr], dtype=torch.int32, device=dev)
            if not torch.equal(el.edf_ladder_hists(w, fls, r, **kw),
                               el.plain(w, fls, r, **kw)):
                raise AssertionError("edf_ladder on pathological values")
    log("[kernels] edf_ladder_hists ragged sizes and pathological values: "
        "bit-equal")
    return rows


# ---------------------------------------------------------------------------
# Phases 4 and 5


def instrument(eng, torch, fm, fa, record):
    """Wrap the engine's prefill/decode steps to time them (host clock
    around a synchronised call) and record each call's kernel launches."""
    def wrap(fn, kind):
        def call(*args):
            torch.cuda.synchronize()
            counts = (lambda: (fm.fxp_matmul.launches,
                               fa.flash_attention.launches,
                               fm.fxp_matmul.tc_launches,
                               fm.fxp_matmul.gemv_launches))
            n0 = counts()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            n1 = counts()
            record.append({"kind": kind,
                           "ms": (time.perf_counter() - t0) * 1e3,
                           **{key: b - a for key, a, b in zip(
                               ("fxp", "flash", "fxp_tc", "fxp_gemv"),
                               n0, n1)}})
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
    reset_counts({"fxp_matmul": fm.fxp_matmul,
                  "flash_attention": fa.flash_attention})
    t0 = time.perf_counter()
    out, logits = eng.generate(prompts, NEW)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"fxp_matmul": fm.fxp_matmul.launches,
                "flash_attention": fa.flash_attention.launches}
    per_fwd = 7 * N_LAYERS + 1
    # the prefill's dense layers (M = 512) take the tensor cores, its head
    # (the last position of each prompt, M = 4) and every decode call the
    # GEMV
    check_tensor_cores("main", launches, gemv=1 + per_fwd * (NEW - 1))
    if record[0]["kind"] != "prefill" or len(record) != NEW:
        raise AssertionError(f"unexpected step record {record}")
    for r in record:
        want = ((per_fwd, N_LAYERS, per_fwd - 1, 1) if r["kind"] == "prefill"
                else (per_fwd, 0, 0, per_fwd))
        if (r["fxp"], r["flash"], r["fxp_tc"], r["fxp_gemv"]) != want:
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
        for key in ("fxp_qmatmul", "matmul_qdx", "fxp_matmul", "flash_fwd",
                    "matmul_dx", "matmul_dw", "flash_dq", "flash_dkv",
                    "sr_kernel", "edf_ladder", "nvjet", "gemm", "Memset",
                    "Memcpy"):
            if key in name:
                name = key
                break
        else:
            name = name[:48]
        groups[name] = groups.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(groups.values())
    top = dict(sorted(groups.items(), key=lambda kv: -kv[1])[:12])
    gemms = sorted({e.key for e in prof.key_averages() if e.key in LIBRARY_GEMMS})
    return {"wall_ms": wall_ms, "device_events": n, "busy_ms": busy,
            "busy_share": busy / wall_ms if n else None, "groups_ms": top,
            "library_gemm_ops": gemms}


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


# ---------------------------------------------------------------------------
# Phases 6 and 7: training


def wrappers():
    """Each kernel's wrapper (its launch counter), by kernel name."""
    from repro_torch.kernels import edf_ladder as el
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fxp_matmul as fm
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import kl_hist as kh
    from repro_torch.kernels import sr_quantize as sq
    out = {"fxp_matmul": fm.fxp_matmul, "matmul_dx": fm.matmul_dx,
           "matmul_dw": fm.matmul_dw, "flash_attention": fa.flash_attention,
           "flash_attention_dq": fa.flash_attention_dq,
           "flash_attention_dkv": fa.flash_attention_dkv,
           "sr_quantize_fused_stacked_int8": sq.sr_quantize_fused_stacked_int8,
           "sr_quantize_fused_int8": sq.sr_quantize_fused_int8,
           "edf_ladder_hists": el.edf_ladder_hists,
           "sr_quantize_fused_stacked": sq.sr_quantize_fused_stacked,
           "sr_quantize_fused": sq.sr_quantize_fused,
           "fxp_qmatmul": fm.fxp_qmatmul, "matmul_qdx": fm.matmul_qdx,
           "sr_quantize": sq.sr_quantize, "int8_matmul": im.int8_matmul,
           "kl_hist": kh.kl_hist}
    assert tuple(out) == KERNELS
    return out


def reset_counts(ws):
    """Set every wrapper's counts (launches, and the tensor-core and GEMV
    launches of those that have them) to 0."""
    for w in ws.values():
        for key in ("launches", "tc_launches", "gemv_launches"):
            if hasattr(w, key):
                setattr(w, key, 0)


def check_tensor_cores(tag, launches, gemv=0):
    """Every flash forward, dq and dkv, ``matmul_dx``, ``matmul_dw``,
    ``fxp_qmatmul``, ``matmul_qdx`` and ``fxp_matmul`` at M > 16 of a main
    path's run (bf16 activations) took the tensor-core branch, and the
    ``gemv`` launches of ``fxp_matmul`` at M <= 16 (decode, the prefill's
    head) its GEMV: the wrappers' ``tc_launches`` and ``gemv_launches``, set
    to 0 with ``launches`` just before the run, account for every launch."""
    ws = wrappers()
    for name in TC_KERNELS:
        if name not in launches:
            continue
        want = launches[name] - (gemv if name == "fxp_matmul" else 0)
        if ws[name].tc_launches != want:
            raise AssertionError(f"{tag}: {ws[name].tc_launches} of "
                                 f"{launches[name]} {name} launches took "
                                 f"the tensor cores, want {want}")
    if "fxp_matmul" in launches and ws["fxp_matmul"].gemv_launches != gemv:
        raise AssertionError(f"{tag}: {ws['fxp_matmul'].gemv_launches} "
                             f"fxp_matmul launches took the GEMV, want {gemv}")


def train_path(torch, fm, fa):
    """llama3.2-3b at full width and depth, random TNVS weights from a
    seed: ``train_loop.train`` takes 3 AdaPT-SGD steps (one cold, two warm;
    no precision switch is reached), with the launch counts of every step;
    then one more step under the profiler."""
    from repro_torch.config import load_config
    from repro_torch.train import train_loop

    cfg = load_config("llama3.2-3b", overrides=TRAIN_OVERRIDES)
    m = cfg.model
    assert (m.num_layers, m.d_model, m.num_heads, m.num_kv_heads, m.d_ff,
            m.vocab_size) == (N_LAYERS, D_MODEL, HEADS, KV_HEADS, D_FF, VOCAB)
    interval = cfg.train.adapt_interval or cfg.quant.lb_lwr
    assert TRAIN_STEPS + 1 < interval, "the run must not reach a switch"
    t0 = time.perf_counter()
    state = train_loop.init_state(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"[train] init llama3.2-3b master + controller state: "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    ws = wrappers()
    marks = []

    def log_step(line):
        marks.append({k: w.launches for k, w in ws.items()})
        log(f"[train] {line}")

    torch.cuda.reset_peak_memory_stats()
    reset_counts(ws)
    state, history = train_loop.train(cfg, steps=TRAIN_STEPS, state=state,
                                      log=log_step, device="cuda")
    launches = {k: w.launches for k, w in ws.items()}
    check_tensor_cores("train", launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(history) != TRAIN_STEPS or len(marks) != TRAIN_STEPS:
        raise AssertionError(f"train history {history}")
    prev = {k: 0 for k in ws}
    tokens = TRAIN_B * TRAIN_S
    steps = []
    for h, mark in zip(history, marks):
        per = {k: mark[k] - prev[k] for k in ws}
        prev = mark
        if per != PER_STEP:
            raise AssertionError(f"step {h['step']}: launches {per} != {PER_STEP}")
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                and h["grad_norm"] > 0):
            raise AssertionError(f"step {h['step']}: {h}")
        steps.append({"step": h["step"], "ms": h["dt"] * 1e3,
                      "tokens_per_s": tokens / h["dt"], "loss": h["loss"],
                      "grad_norm": h["grad_norm"], "lr": h["lr"]})
        log(f"[train] step {h['step']}: {h['dt'] * 1e3:.1f} ms, "
            f"{tokens / h['dt']:.0f} tokens/s, loss {h['loss']:.4f}, "
            f"grad_norm {h['grad_norm']:.4f}")
    log(f"[train] peak device memory {peak:.2f} GiB, launches {launches}")

    step_fn = train_loop.make_train_step(cfg)
    batch = train_loop.make_batch(cfg, TRAIN_STEPS, device="cuda")
    box = {"state": state}

    def one_step():
        box["state"], box["metrics"] = step_fn(box["state"], batch)

    prof = device_breakdown(torch, one_step)
    if prof["library_gemm_ops"]:
        raise AssertionError(f"library GEMMs in the train step: "
                             f"{prof['library_gemm_ops']}")
    if not math.isfinite(float(box["metrics"]["loss"])):
        raise AssertionError("profiled step: loss not finite")
    log(f"[profile] train step: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms (share {prof['busy_share']:.3f}); no "
        "library GEMM; by kernel: "
        + ", ".join(f"{k} {v:.1f}" for k, v in prof["groups_ms"].items()))
    del state, box, step_fn, batch
    torch.cuda.empty_cache()
    return {"steps": steps, "launches": launches, "peak_gib": peak,
            "profile": prof}


def flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_paths(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def train_card_vs_cpu(torch):
    """One train step at depth 2, full width, batch 2 x 64: the same state
    (drawn on the card, copied to the CPU) and batch, kernels on the card
    and plain versions on the CPU; once as configured and once with
    activation quantization off. Both sides round after every op and only
    sum in other orders, so loss is held to rtol 2e-3, grad_norm to 2e-2
    and every leaf's update to 2e-2 normwise, the CPU tests' bounds for a
    first step from the same params. One exception, with activation
    quantization on only: the int8 activation words turn a one-ulp flip
    before the last slot's quantization into a whole quantization step,
    which the final norm and the head see first and directly, so those
    two leaves are held to 5e-2."""
    from repro_torch.config import load_config
    from repro_torch.train import train_loop

    res = {}
    for name, extra, loose in (("act_quant_on", [], ("final_norm", "head")),
                               ("act_quant_off",
                                ["quant.quantize_activations=false"], ())):
        cfg = load_config("llama3.2-3b", overrides=TRAIN_OVERRIDES + [
            "model.num_layers=2", "train.global_batch=2", "train.seq_len=64"]
            + extra)
        gpu = train_loop.init_state(cfg, SEED + 3, device="cuda")
        cpu = to_device(gpu, "cpu")
        p0 = flat_paths(to_device(gpu["params"], "cpu"))
        batch = train_loop.make_batch(cfg, 0, device="cpu")
        step = train_loop.make_train_step(cfg)
        t0 = time.perf_counter()
        cpu, cm = step(cpu, batch)
        bounds = {path: 5e-2 if path in loose else 2e-2 for path in p0}
        r = {"cpu_s": time.perf_counter() - t0, "bounds": bounds}
        gpu, gm = step(gpu, {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        for k, rtol in (("loss", 2e-3), ("grad_norm", 2e-2)):
            c, g = float(cm[k]), float(gm[k])
            r[k] = {"cpu": c, "card": g}
            if not abs(c - g) <= rtol * abs(c):
                raise AssertionError(f"depth-2 train step ({name}) {k}: "
                                     f"cpu {c} card {g}")
        gp = flat_paths(gpu["params"])
        r["update_rel"] = {}
        for path, c in flat_paths(cpu["params"]).items():
            dc = c - p0[path]
            dg = gp[path].cpu() - p0[path]
            r["update_rel"][path] = float(torch.linalg.vector_norm(dg - dc)
                                          / torch.linalg.vector_norm(dc))
        rel = r["update_rel"]
        tight = [p for p in rel if p not in loose]
        worst = max(tight, key=rel.get)
        log(f"[depth2] train step card vs CPU ({name}): loss {r['loss']}, "
            f"grad_norm {r['grad_norm']}, worst leaf update {rel[worst]:.4f} "
            f"normwise ({worst}, bound 2e-2)"
            + "".join(f", {p} {rel[p]:.4f} (bound 5e-2)" for p in loose)
            + f"; CPU step {r['cpu_s']:.1f} s")
        over = {p: e for p, e in rel.items() if not e <= bounds[p]}
        if over:
            raise AssertionError(f"depth-2 train step ({name}): updates "
                                 f"over their bound: {over}")
        res[name] = r
        del gpu, cpu, p0
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phases 8 and 9: training with SR words through the precision switch


def wlfl_histogram(state):
    """{"<WL,FL>": tensor-layers} over every quantized tensor and layer."""
    hist = {}
    for ts in state["adapt"]["tensors"].values():
        for wl, fl in zip(ts["wl"].reshape(-1).tolist(),
                          ts["fl"].reshape(-1).tolist()):
            key = f"<{wl},{fl}>"
            hist[key] = hist.get(key, 0) + 1
    return dict(sorted(hist.items()))


def sr_train_path(torch):
    """llama3.2-3b at full width and depth with the registry's stochastic
    rounding: ``train_loop.train`` takes 2 steps (the switch after step 2
    closes every tensor's window of two) and then 2 more (a second switch
    after step 4), with exact launch counts per step and switch; the
    <WL,FL> histogram before and after the first switch; then the
    switch's own wall time and device time by kernel, and one profiled SR
    step (no library GEMM)."""
    from repro_torch.config import load_config
    from repro_torch.train import train_loop

    cfg = load_config("llama3.2-3b", overrides=SR_OVERRIDES)
    q = cfg.quant
    assert q.stochastic_rounding and q.use_pallas and q.fused_prng
    assert (cfg.train.adapt_interval, q.lb_lwr) == (2, 2)
    t0 = time.perf_counter()
    state = train_loop.init_state(cfg, SEED + 5, device="cuda")
    torch.cuda.synchronize()
    log(f"[sr] init llama3.2-3b: {time.perf_counter() - t0:.1f} s")
    n_layers = sum(ts["wl"].numel() for ts in state["adapt"]["tensors"].values())
    if n_layers != N_STACKED * N_LAYERS + N_FLAT:
        raise AssertionError(f"{n_layers} tensor-layers")
    before = wlfl_histogram(state)
    ws = wrappers()
    marks = []

    def log_step(line):
        marks.append({k: w.launches for k, w in ws.items()})
        log(f"[sr] {line}")

    torch.cuda.reset_peak_memory_stats()
    reset_counts(ws)
    state, history = train_loop.train(cfg, steps=2, state=state, log=log_step,
                                      device="cuda")
    after = wlfl_histogram(state)
    counts = torch.cat([ts["count"].reshape(-1)
                        for ts in state["adapt"]["tensors"].values()])
    if int(counts.abs().max()) != 0:
        raise AssertionError("the switch after step 2 left a window open")
    state, more = train_loop.train(cfg, steps=2, state=state, log=log_step,
                                   device="cuda")
    history += more
    launches = {k: w.launches for k, w in ws.items()}
    check_tensor_cores("sr", launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[sr] <WL,FL> over {n_layers} tensor-layers before the switch: "
        f"{before}; after: {after}")
    prev = {k: 0 for k in ws}
    tokens = TRAIN_B * TRAIN_S
    steps = []
    for h, mark in zip(history, marks):
        per = {k: mark[k] - prev[k] for k in ws}
        prev = mark
        want = dict(SR_PER_STEP)
        if h["step"] % 2 == 0:
            want.update(PER_SWITCH)
        if per != want:
            raise AssertionError(f"SR step {h['step']}: launches {per} != {want}")
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                and h["grad_norm"] > 0):
            raise AssertionError(f"SR step {h['step']}: {h}")
        steps.append({"step": h["step"], "ms": h["dt"] * 1e3,
                      "switch": h["step"] % 2 == 0,
                      "tokens_per_s": tokens / h["dt"], "loss": h["loss"],
                      "grad_norm": h["grad_norm"]})
        log(f"[sr] step {h['step']}{' + switch' if h['step'] % 2 == 0 else ''}"
            f": {h['dt'] * 1e3:.1f} ms, loss {h['loss']:.4f}, grad_norm "
            f"{h['grad_norm']:.4f}")
    if len(steps) != SR_STEPS:
        raise AssertionError(f"SR history {history}")
    log(f"[sr] peak device memory {peak:.2f} GiB, launches {launches}")

    # the switch alone: wall time around synchronised calls, then one under
    # the profiler (the masks pass over closed windows; the work is the same)
    switch = train_loop.make_precision_switch(cfg)
    box = {"state": state}

    def one_switch():
        box["state"] = switch(box["state"])

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_switch()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    sw_prof = device_breakdown(torch, one_switch)
    log(f"[sr] switch alone: wall {walls[0]:.1f} / {walls[1]:.1f} ms; "
        f"profiled wall {sw_prof['wall_ms']:.1f} ms, device busy "
        f"{sw_prof['busy_ms']:.2f} ms; by kernel: "
        + ", ".join(f"{k} {v:.2f}" for k, v in sw_prof["groups_ms"].items()))

    step_fn = train_loop.make_train_step(cfg)
    batch = train_loop.make_batch(cfg, SR_STEPS, device="cuda")

    def one_step():
        box["state"], box["metrics"] = step_fn(box["state"], batch,
                                               step=SR_STEPS)

    prof = device_breakdown(torch, one_step)
    if prof["library_gemm_ops"]:
        raise AssertionError(f"library GEMMs in the SR step: "
                             f"{prof['library_gemm_ops']}")
    if not math.isfinite(float(box["metrics"]["loss"])):
        raise AssertionError("profiled SR step: loss not finite")
    log(f"[profile] SR train step: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms (share {prof['busy_share']:.3f}); by "
        "kernel: " + ", ".join(f"{k} {v:.1f}"
                               for k, v in prof["groups_ms"].items()))
    del state, box, step_fn, batch
    torch.cuda.empty_cache()
    return {"steps": steps, "launches": launches, "peak_gib": peak,
            "wlfl_before": before, "wlfl_after": after,
            "switch_wall_ms": walls, "switch_profile": sw_prof,
            "profile": prof}


def sr_card_vs_cpu(torch):
    """Depth 2 at full width, batch 2 x 64, SR words: two steps on the card
    from a seeded state, then (1) the same state and params through
    ``precision_switch`` on the card (the EDF-ladder kernel) and on the CPU
    (its plain version): identical wl, fl, lb, res, count and strategy,
    equal sp; (2) with the same seeds, the packed SR words of every leaf
    bit-identical between the card's kernels and the CPU's plain versions."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.train import train_loop

    cfg = load_config("llama3.2-3b", overrides=SR_OVERRIDES + [
        "model.num_layers=2", "train.global_batch=2", "train.seq_len=64"])
    state = train_loop.init_state(cfg, SEED + 7, device="cuda")
    step = train_loop.make_train_step(cfg)
    for i in range(2):
        state, _ = step(state, train_loop.make_batch(cfg, i, device="cuda"),
                        step=i)
    cpu = to_device(state, "cpu")
    t0 = time.perf_counter()
    c_out = controller.precision_switch(cpu["adapt"], cpu["params"], cfg.quant)
    cpu_switch_s = time.perf_counter() - t0
    g_out = controller.precision_switch(state["adapt"], state["params"],
                                        cfg.quant)
    switched = 0
    for path, cts in c_out["tensors"].items():
        gts = g_out["tensors"][path]
        for k in ("wl", "fl", "lb", "res", "count", "sp", "norm_sum"):
            if not torch.equal(gts[k].cpu(), cts[k]):
                raise AssertionError(f"depth-2 switch {path} {k}: card "
                                     f"{gts[k].tolist()} cpu {cts[k].tolist()}")
        if not torch.equal(gts["grad_sum"].cpu(), cts["grad_sum"]):
            raise AssertionError(f"depth-2 switch {path} grad_sum")
        switched += int((cts["count"] == 0).sum())
    if int(g_out["strategy"]) != int(c_out["strategy"]):
        raise AssertionError("depth-2 switch strategy")
    seeds = controller.leaf_seeds(int(state["rng"]), 2, state["adapt"]["tensors"])
    t0 = time.perf_counter()
    cq = controller.quantize_params_packed(cpu["params"], c_out, cfg.quant,
                                           seeds)
    cpu_words_s = time.perf_counter() - t0
    gq = controller.quantize_params_packed(state["params"], g_out, cfg.quant,
                                           seeds)
    leaves = 0
    gq, cq = flat_paths(gq), flat_paths(cq)
    for path in g_out["tensors"]:
        g, c = gq[path + "/q8"], cq[path + "/q8"]
        if g.dtype != torch.int8 or not torch.equal(g.cpu(), c):
            raise AssertionError(f"depth-2 SR words of {path} differ")
        leaves += 1
    res = {"tensor_layers_switched": switched, "leaves_bit_equal": leaves,
           "wlfl": wlfl_histogram({"adapt": c_out}),
           "cpu_switch_s": cpu_switch_s, "cpu_words_s": cpu_words_s}
    log(f"[depth2] SR: precision_switch card == CPU ({switched} tensor-layers "
        f"switched, {res['wlfl']}); SR words of {leaves} leaves bit-equal; "
        f"CPU switch {cpu_switch_s:.1f} s, CPU words {cpu_words_s:.1f} s")
    del state, cpu, gq, cq
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phases 10-13: the float containers (path A) and the quantize prologue
# (path B)


def run_steps(torch, tag, cfg, state, steps, per_step, per_switch=None):
    """``train_loop.train`` for ``steps`` steps from ``state`` with every
    count set to 0 just before and read just after: exact launches per
    step (``per_step``, plus ``per_switch``, by default ``PER_SWITCH``,
    after a switch step), finite loss and grad_norm. Returns (state,
    per-step records, launches, peak GiB)."""
    per_switch = PER_SWITCH if per_switch is None else per_switch
    from repro_torch.train import train_loop
    ws = wrappers()
    marks = []

    def log_step(line):
        marks.append({k: w.launches for k, w in ws.items()})
        log(f"[{tag}] {line}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ws)
    start = int(state["step"])
    state, history = train_loop.train(cfg, steps=steps, state=state,
                                      log=log_step, device="cuda")
    launches = {k: w.launches for k, w in ws.items()}
    check_tensor_cores(tag, launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(history) != steps or len(marks) != steps:
        raise AssertionError(f"{tag} history {history}")
    interval = cfg.train.adapt_interval or cfg.quant.lb_lwr
    switching = cfg.quant.mode != "off"
    prev, out = dict(ZERO), []
    for h, mark in zip(history, marks):
        per = {k: mark[k] - prev[k] for k in ws}
        prev = mark
        switch = switching and h["step"] % interval == 0
        want = {**per_step, **(per_switch if switch else {})}
        if per != want:
            raise AssertionError(f"{tag} step {h['step']}: launches {per} "
                                 f"!= {want}")
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                and h["grad_norm"] > 0):
            raise AssertionError(f"{tag} step {h['step']}: {h}")
        out.append({"step": h["step"], "ms": h["dt"] * 1e3, "switch": switch,
                    "tokens_per_s": TRAIN_B * TRAIN_S / h["dt"],
                    "loss": h["loss"], "grad_norm": h["grad_norm"]})
        log(f"[{tag}] step {h['step']}{' + switch' if switch else ''}: "
            f"{h['dt'] * 1e3:.1f} ms, {TRAIN_B * TRAIN_S / h['dt']:.0f} "
            f"tokens/s, loss {h['loss']:.4f}, grad_norm {h['grad_norm']:.4f}")
    if int(state["step"]) != start + steps:
        raise AssertionError(f"{tag}: step counter {int(state['step'])}")
    log(f"[{tag}] peak device memory {peak:.2f} GiB, launches {launches}")
    return state, out, launches, peak


def switch_alone(torch, cfg, state):
    """Wall time of two precision switches around synchronised calls."""
    from repro_torch.train import train_loop
    switch = train_loop.make_precision_switch(cfg)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = switch(state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return state, walls


def profiled_step(torch, cfg, state, step, library_gemms: bool):
    """One step under the profiler: device busy share and time by kernel;
    the library GEMMs must be present (float containers: the reference's
    XLA dots) or absent (the kernels' paths)."""
    from repro_torch.train import train_loop
    step_fn = train_loop.make_train_step(cfg)
    batch = train_loop.make_batch(cfg, step, device="cuda")
    box = {"state": state}

    def one_step():
        box["state"], box["metrics"] = step_fn(box["state"], batch, step=step)

    prof = device_breakdown(torch, one_step)
    gemms = set(prof["library_gemm_ops"])
    if library_gemms and not gemms & {"aten::mm", "aten::matmul"}:
        raise AssertionError(f"no library GEMM in a float-container step: "
                             f"{sorted(gemms)}")
    if not library_gemms and gemms:
        raise AssertionError(f"library GEMMs in the step: {sorted(gemms)}")
    if not math.isfinite(float(box["metrics"]["loss"])):
        raise AssertionError("profiled step: loss not finite")
    return box["state"], prof


def float_train_path(torch, fm, fa):
    """Path A: llama3.2-3b at full width and depth in the registry's
    float32 container with its stochastic rounding and the fused kernels:
    4 steps through a switch after steps 2 and 4 (lookback 2), exact
    launches per step and switch (7 stacked + 2 flat float-SR launches,
    the flash kernels per layer, no fxp kernel), the switch's wall time, a
    profiled step whose dense layers are library GEMMs; then 2 steps each
    of the bfloat16 and int8 containers and of quant.mode=off, and
    ``Engine`` serving from the trained float32 container (batch 4,
    prompt 128, 32 new tokens)."""
    from repro_torch.config import load_config
    from repro_torch.serve.engine import Engine
    from repro_torch.train import train_loop

    cfg = load_config("llama3.2-3b", overrides=FLOAT_OVERRIDES)
    q = cfg.quant
    assert (q.container_dtype, q.stochastic_rounding, q.use_pallas,
            q.fused_prng, q.dense_prologue) == ("float32", True, True, True,
                                                False)
    t0 = time.perf_counter()
    state = train_loop.init_state(cfg, SEED + 11, device="cuda")
    torch.cuda.synchronize()
    log(f"[float32] init llama3.2-3b: {time.perf_counter() - t0:.1f} s")
    before = wlfl_histogram(state)
    state, steps, launches, peak = run_steps(torch, "float32", cfg, state,
                                             FLOAT_STEPS, FLOAT_PER_STEP)
    after = wlfl_histogram(state)
    log(f"[float32] <WL,FL> before: {before}; after 2 switches: {after}")
    state, walls = switch_alone(torch, cfg, state)
    log(f"[float32] switch alone: wall {walls[0]:.1f} / {walls[1]:.1f} ms")
    state, prof = profiled_step(torch, cfg, state, FLOAT_STEPS, True)
    log(f"[profile] float32 train step: wall {prof['wall_ms']:.1f} ms, device "
        f"busy {prof['busy_ms']:.1f} ms (share {prof['busy_share']:.3f}); "
        f"library GEMMs {prof['library_gemm_ops']}; by kernel: "
        + ", ".join(f"{k} {v:.1f}" for k, v in prof["groups_ms"].items()))
    res = {"float32": {"steps": steps, "launches": launches, "peak_gib": peak,
                       "wlfl_before": before, "wlfl_after": after,
                       "switch_wall_ms": walls, "profile": prof}}

    # serving from the trained float32 container
    params, adapt = state["params"], state["adapt"]
    del state
    for ts in adapt["tensors"].values():
        ts.pop("grad_sum")
    torch.cuda.empty_cache()
    eng = Engine(load_config("llama3.2-3b", overrides=FLOAT_OVERRIDES),
                 params, adapt, device="cuda")
    del params, adapt
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    prompts = torch.randint(0, VOCAB, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    record = []
    instrument(eng, torch, fm, fa, record)
    torch.cuda.reset_peak_memory_stats()
    ws = wrappers()
    reset_counts(ws)
    t0 = time.perf_counter()
    out, logits = eng.generate(prompts, NEW)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    serve_launches = {k: w.launches for k, w in ws.items()}
    if serve_launches != {**ZERO, "flash_attention": N_LAYERS}:
        raise AssertionError(f"float32 serving launches {serve_launches}")
    check_tensor_cores("float32 serving", serve_launches)
    if out.shape != (BATCH, NEW) or int(out.min()) < 0 or int(out.max()) >= VOCAB:
        raise AssertionError(f"float32 serving tokens out of range: {out}")
    if not bool(torch.isfinite(logits).all()) or float(logits.std()) == 0.0:
        raise AssertionError("float32 serving logits not finite or constant")
    cold = step_times(record)
    record.clear()
    t0 = time.perf_counter()
    eng.generate(prompts, NEW)
    torch.cuda.synchronize()
    warm = step_times(record, total_s=time.perf_counter() - t0)
    res["serve_float32"] = {"cold": {**cold, "total_s": total_s}, "warm": warm,
                            "launches": serve_launches,
                            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                            "sample": [int(t) for t in out[0][:16]]}
    log(f"[float32] Engine: prefill {warm['prefill_ms']:.2f} ms warm "
        f"({cold['prefill_ms']:.2f} cold), decode "
        f"{warm['decode_ms_per_step']:.2f} ms/step warm, peak "
        f"{res['serve_float32']['peak_gib']:.2f} GiB")
    del eng, logits
    torch.cuda.empty_cache()

    for name, (extra, per_step) in OTHER_CONTAINERS.items():
        ocfg = load_config("llama3.2-3b", overrides=FLOAT_OVERRIDES + extra)
        state = train_loop.init_state(ocfg, SEED + 13, device="cuda")
        state, steps, launches, peak = run_steps(torch, name, ocfg, state,
                                                 OTHER_STEPS, per_step)
        res[name] = {"steps": steps, "launches": launches, "peak_gib": peak}
        del state
        torch.cuda.empty_cache()
    return res


def prologue_train_path(torch):
    """Path B: llama3.2-3b at full width and depth, int8_packed with
    quant.dense_prologue and the registry's SR: 4 steps through a switch
    after steps 2 and 4, exact launches per step (197 fxp_qmatmul, 197
    matmul_qdx, 197 matmul_dw, 1 + 2·197 flat SR-int8: the embedding's
    words and the regularizer's view, the flash kernels per layer) and per
    switch; a profiled step with no library GEMM."""
    from repro_torch.config import load_config
    from repro_torch.train import train_loop

    cfg = load_config("llama3.2-3b", overrides=PROLOGUE_OVERRIDES)
    q = cfg.quant
    assert (q.container_dtype, q.dense_prologue, q.stochastic_rounding,
            q.use_pallas) == ("int8_packed", True, True, True)
    t0 = time.perf_counter()
    state = train_loop.init_state(cfg, SEED + 17, device="cuda")
    torch.cuda.synchronize()
    log(f"[prologue] init llama3.2-3b: {time.perf_counter() - t0:.1f} s")
    state, steps, launches, peak = run_steps(torch, "prologue", cfg, state,
                                             PROLOGUE_STEPS, PROLOGUE_PER_STEP)
    after = wlfl_histogram(state)
    state, prof = profiled_step(torch, cfg, state, PROLOGUE_STEPS, False)
    log(f"[profile] prologue train step: wall {prof['wall_ms']:.1f} ms, device "
        f"busy {prof['busy_ms']:.1f} ms (share {prof['busy_share']:.3f}); no "
        "library GEMM; by kernel: "
        + ", ".join(f"{k} {v:.1f}" for k, v in prof["groups_ms"].items()))
    del state
    torch.cuda.empty_cache()
    return {"steps": steps, "launches": launches, "peak_gib": peak,
            "wlfl_after": after, "profile": prof}


def step_card_vs_cpu(torch, tag, overrides, seed, loose):
    """One train step at depth 2, full width, batch 2 x 64, from the same
    state (drawn on the card, copied to the CPU) and batch: loss within
    rtol 2e-3, grad_norm within 2e-2 and every leaf's update within 2e-2
    normwise (``loose`` leaves, which activation quantization makes see
    one-ulp flips as whole steps first, within 5e-2), the slice-2 bounds
    of a first step. Returns (card state after the step, the CPU copy of
    the state before it, the config, the record)."""
    from repro_torch.config import load_config
    from repro_torch.train import train_loop

    cfg = load_config("llama3.2-3b", overrides=overrides + [
        "model.num_layers=2", "train.global_batch=2", "train.seq_len=64"])
    gpu = train_loop.init_state(cfg, seed, device="cuda")
    cpu = to_device(gpu, "cpu")
    before = to_device(gpu, "cpu")
    p0 = flat_paths(before["params"])
    batch = train_loop.make_batch(cfg, 0, device="cpu")
    step = train_loop.make_train_step(cfg)
    t0 = time.perf_counter()
    cpu, cm = step(cpu, batch, step=0)
    r = {"cpu_s": time.perf_counter() - t0}
    gpu, gm = step(gpu, {k: v.cuda() for k, v in batch.items()}, step=0)
    torch.cuda.synchronize()
    for k, rtol in (("loss", 2e-3), ("grad_norm", 2e-2)):
        c, g = float(cm[k]), float(gm[k])
        r[k] = {"cpu": c, "card": g}
        if not abs(c - g) <= rtol * abs(c):
            raise AssertionError(f"depth-2 {tag} step {k}: cpu {c} card {g}")
    gp = flat_paths(gpu["params"])
    rel = {}
    for path, c in flat_paths(cpu["params"]).items():
        dc = c - p0[path]
        dg = gp[path].cpu() - p0[path]
        rel[path] = float(torch.linalg.vector_norm(dg - dc)
                          / torch.linalg.vector_norm(dc))
    over = {p: e for p, e in rel.items()
            if not e <= (5e-2 if p in loose else 2e-2)}
    if over:
        raise AssertionError(f"depth-2 {tag} step: updates over their bound: "
                             f"{over}")
    tight = [p for p in rel if p not in loose]
    worst = max(tight, key=rel.get)
    r["update_rel"] = rel
    log(f"[depth2] {tag} step card vs CPU: loss {r['loss']}, grad_norm "
        f"{r['grad_norm']}, worst leaf update {rel[worst]:.4f} normwise "
        f"({worst}, bound 2e-2)"
        + "".join(f", {p} {rel[p]:.4f} (bound 5e-2)" for p in loose)
        + f"; CPU step {r['cpu_s']:.1f} s")
    return gpu, before, cfg, r


def float_card_vs_cpu(torch):
    """Path A at depth 2: the float32 container's SR grid values of every
    leaf bit-equal between the card's kernels and the CPU's plain versions
    (same state, same seeds); one step within the slice-2 bounds; then,
    after a second step on the card (every window of two closes), the same
    state through ``precision_switch`` on the card and on the CPU:
    identical."""
    from repro_torch.core import controller
    gpu, before, cfg, r = step_card_vs_cpu(
        torch, "float32", FLOAT_OVERRIDES, SEED + 19, ("final_norm", "head"))
    seeds = controller.leaf_seeds(int(before["rng"]), 0,
                                  before["adapt"]["tensors"])
    cq = controller.quantize_params(before["params"], before["adapt"],
                                    cfg.quant, seeds)
    gq = controller.quantize_params(to_device(before["params"], "cuda"),
                                    to_device(before["adapt"], "cuda"),
                                    cfg.quant, seeds)
    gflat = flat_paths(gq)
    for path, c in flat_paths(cq).items():
        g = gflat[path]
        if g.dtype != torch.float32 or not torch.equal(g.cpu(), c):
            raise AssertionError(f"depth-2 float32 grid values of {path} differ")
    leaves = len(before["adapt"]["tensors"])
    del cq, gq, gflat
    # a second step on the card closes every window of two steps
    from repro_torch.train import train_loop
    gpu, _ = train_loop.make_train_step(cfg)(
        gpu, train_loop.make_batch(cfg, 1, device="cuda"), step=1)
    cpu = to_device(gpu, "cpu")
    c_out = controller.precision_switch(cpu["adapt"], cpu["params"], cfg.quant)
    g_out = controller.precision_switch(gpu["adapt"], gpu["params"], cfg.quant)
    switched = 0
    for path, cts in c_out["tensors"].items():
        gts = g_out["tensors"][path]
        for k in ("wl", "fl", "lb", "res", "count", "sp", "norm_sum",
                  "grad_sum"):
            if not torch.equal(gts[k].cpu(), cts[k]):
                raise AssertionError(f"depth-2 float32 switch {path} {k}")
        switched += int((cts["count"] == 0).sum())
    r.update(leaves_bit_equal=leaves, tensor_layers_switched=switched,
             wlfl=wlfl_histogram({"adapt": c_out}))
    log(f"[depth2] float32: grid values of {leaves} leaves bit-equal; "
        f"precision_switch card == CPU ({switched} tensor-layers switched, "
        f"{r['wlfl']})")
    del gpu, cpu, before
    torch.cuda.empty_cache()
    return r


def prologue_card_vs_cpu(torch):
    """Path B at depth 2: the prologue words of every dense layer-slice,
    drawn through the regularizer's view (the SR int8 kernel on the card,
    its plain version on the CPU), bit-equal from the same state and
    seeds; one step within the slice-2 bounds."""
    from repro_torch.core import controller
    from repro_torch.core import fixed_point as fxp
    gpu, before, cfg, r = step_card_vs_cpu(
        torch, "prologue", PROLOGUE_OVERRIDES, SEED + 23,
        ("final_norm", "head"))
    seeds = controller.leaf_seeds(int(before["rng"]), 0,
                                  before["adapt"]["tensors"])
    cq = controller.quantize_params_packed(before["params"], before["adapt"],
                                           cfg.quant, seeds)
    gq = controller.quantize_params_packed(to_device(before["params"], "cuda"),
                                           to_device(before["adapt"], "cuda"),
                                           cfg.quant, seeds)
    leaves = 0
    for path in before["adapt"]["tensors"]:
        c, g = cq, gq
        for k in path.split("/"):
            c, g = c[k], g[k]
        if not fxp.is_qdense(c):
            continue
        cv = fxp.qdense_view(c["wm"], c["seed"], c["flq"], c["mode"])
        gv = fxp.qdense_view(g["wm"], g["seed"], g["flq"], g["mode"])
        if not torch.equal(gv.cpu(), cv):
            raise AssertionError(f"depth-2 prologue view of {path} differs")
        leaves += 1
    if leaves != 8:
        raise AssertionError(f"{leaves} prologue leaves, expected 8")
    r["views_bit_equal"] = leaves
    log(f"[depth2] prologue: the views of {leaves} prologue leaves bit-equal")
    del gpu, before, cq, gq
    torch.cuda.empty_cache()
    return r


# ---------------------------------------------------------------------------
# Phases 14 and 15: the registry's default quantizer (jax.random noise)


def noise_alone(torch, state, key):
    """The jax.random noise of one step's quantized copy drawn alone, chunk
    by chunk as ``controller._jax_random_sr`` draws it, and discarded."""
    from repro_torch.core import controller, threefry
    params = flat_paths(state["params"])
    size = controller._NOISE_CHUNK["cuda"]
    for path, ts in state["adapt"]["tensors"].items():
        leaf = params[path]
        layers = ts["fl"].shape[0] if ts["fl"].ndim else 1
        n = leaf.numel() // layers
        lkey = controller.leaf_key(key, path)
        for l in range(layers):
            for start, count in threefry.chunks(n, size):
                threefry.uniform(lkey, leaf.shape, offset=l * n + start,
                                 count=count, device="cuda")


def default_quantizer_path(torch):
    """Phase 14: llama3.2-3b at full width and depth under the QuantConfig
    defaults (float32 container, SR, quant.use_pallas=false), cut as path
    A: 4 steps through a switch after steps 2 and 4 with no hand-written
    kernel launched (the dense layers are cuBLAS GEMMs, attention the
    plain masked path, the ladder its plain version, the SR noise the
    plain-PyTorch threefry); step times, tokens/s, peak memory; the
    quantized copy's own wall time, the device time of its noise drawn
    alone (CUDA events) and a profiled step (whose dense layers are
    library GEMMs), the noise's share of its device time. Then the ops path, with every count set to 0 just
    before and read just after: ``ops.sr_quantize(use_pallas=True)`` on
    each layer of the stacked ``OPS_LEAF`` with the step's own noise
    (bit-equal to the grid values the controller's jax.random branch made),
    ``ops.kl_hist`` of the leaf against that SR copy, and
    ``ops.int8_matmul`` forward and backward on int8 words of the step
    (the step's embedded tokens and layer 0 of the SR copy)."""
    from repro_torch.config import load_config
    from repro_torch.core import controller, threefry
    from repro_torch.core import fixed_point as fxp
    from repro_torch.kernels import ops
    from repro_torch.train import train_loop

    cfg = load_config("llama3.2-3b", overrides=DEFAULT_OVERRIDES)
    q = cfg.quant
    assert (q.mode, q.container_dtype, q.stochastic_rounding,
            q.use_pallas) == ("simulate", "float32", True, False)
    t0 = time.perf_counter()
    state = train_loop.init_state(cfg, SEED + 29, device="cuda")
    torch.cuda.synchronize()
    log(f"[default] init llama3.2-3b: {time.perf_counter() - t0:.1f} s")
    state, steps, launches, peak = run_steps(torch, "default", cfg, state,
                                             DEFAULT_STEPS, ZERO, ZERO)
    if any(launches.values()):
        raise AssertionError(f"kernel launches under the defaults: {launches}")
    after = wlfl_histogram(state)
    step = int(state["step"])
    # the quantized copy alone: host clock around a synchronised call
    key = controller.step_key(int(state["rng"]), step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qp = controller.quantize_params(state["params"], state["adapt"], q, key=key)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    del qp
    noise_ms = cuda_time_ms([lambda: noise_alone(torch, state, key)], 1)
    state, prof = profiled_step(torch, cfg, state, step, True)
    prof_rec = {**prof, "threefry_device_ms": noise_ms,
                "threefry_share_of_busy": noise_ms / prof["busy_ms"]}
    log(f"[default] <WL,FL> after 2 switches: {after}; quantized copy alone "
        f"{copy_ms:.1f} ms, its noise alone {noise_ms:.1f} ms (CUDA events); "
        f"profiled step wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms (share {prof['busy_share']:.3f}), the "
        f"noise {prof_rec['threefry_share_of_busy']:.3f} of it; library GEMMs "
        f"{prof['library_gemm_ops']}; by kernel: "
        + ", ".join(f"{k} {v:.1f}" for k, v in prof["groups_ms"].items()))

    # the ops path
    step = int(state["step"])
    key = controller.step_key(int(state["rng"]), step)
    ts = state["adapt"]["tensors"][OPS_LEAF]
    leaf = flat_paths(state["params"])[OPS_LEAF]
    tree = leaf
    for k in reversed(OPS_LEAF.split("/")):
        tree = {k: tree}
    want = flat_paths(controller.quantize_params(tree, state["adapt"], q,
                                                 key=key))[OPS_LEAF]
    lkey = controller.leaf_key(key, OPS_LEAF)
    n = leaf[0].numel()
    batch = train_loop.make_batch(cfg, step, device="cuda")
    emb = state["params"]["embed"][batch["tokens"].reshape(-1)]
    fl_x = fxp.fl_for_wl(emb.abs().max(), 8)
    xq = torch.clamp(torch.round(emb * fxp.pow2i(fl_x).cuda()), -128, 127).to(
        torch.int8)
    dy = torch.randn(xq.shape[0], leaf.shape[2], device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(SEED))
    ws = wrappers()
    torch.cuda.synchronize()
    reset_counts(ws)
    got = torch.empty_like(leaf)
    for l in range(leaf.shape[0]):
        u = threefry.uniform(lkey, leaf.shape, offset=l * n, count=n,
                             device="cuda").reshape(leaf.shape[1:])
        got[l] = ops.sr_quantize(leaf[l], u, ts["wl"][l], ts["fl"][l],
                                 use_pallas=True)
        del u
    hist = ops.kl_hist(leaf, got, 256, use_pallas=True)
    wq = torch.clamp(got[0] * fxp.pow2i(ts["fl"][0]), -128, 127).to(torch.int8)
    sx = fxp.pow2i(-fl_x).cuda().requires_grad_()
    sw = fxp.pow2i(-ts["fl"][0]).requires_grad_()
    y = ops.int8_matmul(xq, wq, sx, sw, use_pallas=True)
    dsx, dsw = torch.autograd.grad(y, (sx, sw), dy)
    torch.cuda.synchronize()
    ops_launches = {k: w.launches for k, w in ws.items()}
    if ops_launches != OPS_PATH:
        raise AssertionError(f"ops path launches {ops_launches} != {OPS_PATH}")
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("ops.sr_quantize with the step's noise differs "
                             "from the controller's grid values")
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import kl_hist as kh
    s = (sx.detach() * sw.detach()).reshape(())
    if not torch.equal(y.detach(), im.plain(xq, wq, s)) \
            or not torch.equal(hist, kh.plain(leaf, got, 256)) \
            or float(hist[0].sum()) != leaf.numel():
        raise AssertionError("ops path: int8_matmul or kl_hist differs from "
                             "its plain version")
    if not (math.isfinite(float(dsx)) and math.isfinite(float(dsw))):
        raise AssertionError("ops path: scale gradients not finite")
    log(f"[default] ops path: sr_quantize x{leaf.shape[0]} on {OPS_LEAF} with "
        f"the step's noise == the controller's grid values; kl_hist and "
        f"int8_matmul (fwd + bwd, M = {xq.shape[0]}) == their plain versions; "
        f"launches {ops_launches}")
    del state, got, want, leaf, hist, xq, wq, y
    torch.cuda.empty_cache()
    return {"steps": steps, "launches": launches, "peak_gib": peak,
            "wlfl_after": after, "quantized_copy_ms": copy_ms,
            "profile": prof_rec, "ops_launches": ops_launches,
            "ops_int8_scale_grads": [float(dsx), float(dsw)]}


def default_card_vs_cpu(torch):
    """Phase 14's configuration at depth 2: one step from the same state on
    the card and on the CPU; the quantized copy each step read (captured
    from ``train_loop._quantized_copy``) bit-equal, since threefry is
    integer arithmetic and the quantize exact-rounded f32; the step within
    the slice-2 bounds; then, after a second step on the card (every window
    of two closes), the same state through ``precision_switch`` on both:
    identical. The plain attention of this path takes its AV product in
    bf16 on the card and in f32 on the CPU (``attention.av_dtype``, the
    reference's choice by backend); the slice-2 bounds hold two sides that
    round alike and sum in other orders, so for this step the CPU takes the
    card's bf16 AV product."""
    from repro_torch.core import controller
    from repro_torch.models import attention
    from repro_torch.train import train_loop
    seen = []
    inner, av_dtype = train_loop._quantized_copy, attention.av_dtype

    def capture(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(out)
        return out

    train_loop._quantized_copy = capture
    attention.av_dtype = lambda v: v.dtype
    try:
        gpu, _, cfg, r = step_card_vs_cpu(torch, "default", DEFAULT_OVERRIDES,
                                          SEED + 31, ("final_norm", "head"))
    finally:
        train_loop._quantized_copy = inner
        attention.av_dtype = av_dtype
    if len(seen) != 2:
        raise AssertionError(f"{len(seen)} quantized copies, expected 2")
    # the quantized leaves (the others are the master itself, cast to f32:
    # the same tensor, which the step then updated in place)
    cq, gq = (flat_paths(t) for t in seen)
    leaves = 0
    for path in gpu["adapt"]["tensors"]:
        c, g = cq[path], gq[path]
        if g.dtype != c.dtype or not torch.equal(g.cpu(), c):
            raise AssertionError(f"depth-2 default quantized copy of {path} "
                                 "differs")
        leaves += 1
    del seen, cq, gq
    gpu, _ = train_loop.make_train_step(cfg)(
        gpu, train_loop.make_batch(cfg, 1, device="cuda"), step=1)
    cpu = to_device(gpu, "cpu")
    c_out = controller.precision_switch(cpu["adapt"], cpu["params"], cfg.quant)
    g_out = controller.precision_switch(gpu["adapt"], gpu["params"], cfg.quant)
    switched = 0
    for path, cts in c_out["tensors"].items():
        gts = g_out["tensors"][path]
        for k in ("wl", "fl", "lb", "res", "count", "sp", "norm_sum",
                  "grad_sum"):
            if not torch.equal(gts[k].cpu(), cts[k]):
                raise AssertionError(f"depth-2 default switch {path} {k}")
        switched += int((cts["count"] == 0).sum())
    r.update(quantized_leaves_bit_equal=leaves,
             tensor_layers_switched=switched,
             wlfl=wlfl_histogram({"adapt": c_out}))
    log(f"[depth2] default quantizer: the quantized copy ({leaves} quantized "
        f"leaves) bit-equal; precision_switch card == CPU ({switched} "
        f"tensor-layers switched, {r['wlfl']})")
    del gpu, cpu
    torch.cuda.empty_cache()
    return r


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import edf_ladder as el
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fxp_matmul as fm
    from repro_torch.kernels import sr_quantize as sq

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
    reports = _build.build(SOURCES)
    log(f"[build] {sorted(reports) or 'cached'} ({len(SOURCES)} sources) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if any(key in line for key in ("registers", "spill", "Warning",
                                           "Performance Loss")):
                log(f"[build] {name}: {line.strip()}")

    marks = {"build": time.perf_counter() - t_start}

    def mark(name):
        marks[name] = time.perf_counter() - t_start - sum(marks.values())
        log(f"[time] phase {name}: {marks[name]:.1f} s")

    # 3. kernels, each check's seconds in check_seconds
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    check_s = {}

    def timed(check, *modules):
        t0 = time.perf_counter()
        out = check(torch, *modules, gen)
        torch.cuda.synchronize()
        check_s[check.__name__] = time.perf_counter() - t0
        return out

    fxp_rows, fxp_err = timed(check_fxp_matmul, fm)
    flash_rows, flash_err = timed(check_flash, fa)
    bwd_rows, bwd_err = timed(check_matmul_bwd, fm)
    fbwd_rows, fbwd_err = timed(check_flash_bwd, fa)
    sr_rows = timed(check_sr_quantize, sq)
    edf_rows = timed(check_edf_ladder, el)
    grid_rows = timed(check_sr_grid, sq)
    q_rows, q_err = timed(check_qmatmul, fm)
    cublas_rows = timed(check_cublas_reduction)
    ops_rows = timed(check_ops_kernels)
    torch.cuda.empty_cache()
    log("[time] checks: " + ", ".join(f"{k} {v:.1f} s" for k, v in check_s.items()))
    mark("3 kernels")

    # 4. serving main path; 5. serving, card against CPU
    main_res = main_path(torch, fm, fa)
    mark("4 serving")
    depth2 = card_vs_cpu(torch)
    mark("5 serving depth 2")

    # 6. training main path; 7. training, card against CPU
    train_res = train_path(torch, fm, fa)
    mark("6 training")
    train_depth2 = train_card_vs_cpu(torch)
    mark("7 training depth 2")

    # 8. SR training main path through the switch; 9. card against CPU
    sr_res = sr_train_path(torch)
    mark("8 SR training")
    sr_depth2 = sr_card_vs_cpu(torch)
    mark("9 SR depth 2")

    # 10. float containers (path A); 11. card against CPU
    float_res = float_train_path(torch, fm, fa)
    mark("10 path A")
    float_depth2 = float_card_vs_cpu(torch)
    mark("11 path A depth 2")

    # 12. the quantize prologue (path B); 13. card against CPU
    prologue_res = prologue_train_path(torch)
    mark("12 path B")
    prologue_depth2 = prologue_card_vs_cpu(torch)
    mark("13 path B depth 2")

    # 14. the registry's default quantizer and the ops path; 15. card
    # against CPU
    default_res = default_quantizer_path(torch)
    mark("14 default quantizer")
    default_depth2 = default_card_vs_cpu(torch)
    mark("15 default depth 2")

    runs = [main_res["launches"], train_res["launches"], sr_res["launches"],
            *(r["launches"] for r in float_res.values()),
            prologue_res["launches"], default_res["launches"],
            default_res["ops_launches"]]
    kernels = kernel_record(runs, fxp_rows, fxp_err, flash_rows, flash_err,
                            bwd_rows, bwd_err, fbwd_rows, fbwd_err, sr_rows,
                            edf_rows, grid_rows, q_rows, q_err, ops_rows)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "fxp_matmul": fxp_rows, "flash_attention": flash_rows,
        "matmul_bwd": bwd_rows, "flash_bwd": fbwd_rows,
        "sr_quantize": sr_rows, "edf_ladder": edf_rows,
        "sr_grid": grid_rows, "qmatmul": q_rows, "cublas": cublas_rows,
        "main_path": main_res, "depth2": depth2, "train": train_res,
        "train_depth2": train_depth2, "sr_train": sr_res,
        "sr_depth2": sr_depth2, "float_train": float_res,
        "float_depth2": float_depth2, "prologue_train": prologue_res,
        "prologue_depth2": prologue_depth2, "ops_kernels": ops_rows,
        "default_train": default_res, "default_depth2": default_depth2,
        "kernels": kernels, "phase_seconds": marks, "check_seconds": check_s,
        "seconds": time.perf_counter() - t_start}, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_record(runs, fxp_rows, fxp_err, flash_rows, flash_err, bwd_rows,
                  bwd_err, fbwd_rows, fbwd_err, sr_rows, edf_rows, grid_rows,
                  q_rows, q_err, ops_rows):
    """One entry per kernel. ``launches`` sums the counts of the main
    paths' runs (``runs``). Every time sums the kernel's launches in those
    runs from the per-shape times of phase 3: serving (the prefill's 196
    layer calls at M = 512 and its head call at M = 4, then 31 decode steps
    of 197 calls at M = 4; 28 flash launches), the 3 RTN and the 4 SR
    training steps (per step 197 fwd, dx and dw calls at M = 2048; 28
    flash forward, dq and dkv launches; 7 stacked and 2 flat SR int8
    launches; 9 EDF-ladder launches per switch, after steps 2 and 4), path
    A (4 float32 steps with 7 stacked and 2 flat f32 grid-value launches,
    2 bfloat16 steps with the same launches in bf16, 2 int8-container steps
    with the SR int8 launches, 2 mode-off steps, 28 flash launches for
    each step's forward, dq and dkv and for the float32 Engine's prefill,
    a switch after every second step but the mode-off ones) and path B (4
    steps of 197 fxp_qmatmul, matmul_qdx and f32-out matmul_dw calls at
    M = 2048, 1 + 2·197 flat SR int8 launches, a switch after steps 2 and
    4). Phase 14's default quantizer launches no kernel; its ops path
    launches ``sr_quantize`` once per (3072, 8192) f32 layer of the
    stacked leaf, ``kl_hist`` once on the (28, 3072, 8192) leaf (256 bins)
    and ``int8_matmul`` twice at 2048 x 3072 x 8192. ``fxp_matmul``'s entry
    also sums its two bf16 branches apart (``tensor_cores``: M > 16, the
    prefill's layers and training; ``gemv``: M <= 16, decode and the
    prefill's head), and ``matmul_dw`` takes path B's calls at the f32-out
    times of ``check_matmul_bwd``."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    device_keys = ("device_ms", "library_device_ms")

    def summed(rows_by_shape, calls, extra=()):
        out = {key: None if any(rows_by_shape[s].get(key) is None
                                for s in calls)
               else sum(rows_by_shape[s][key] * c for s, c in calls.items())
               for key in keys + extra}
        bytes_part = sum(rows_by_shape[s]["bound_ms"] * c
                         for s, c in calls.items()
                         if rows_by_shape[s]["bound_by"] == "bytes")
        out["bound_by"] = ("bytes" if bytes_part >= out["bound_ms"] / 2
                           else "operations")
        return out

    def by_shape(rows):
        return {(r["m"], r["k"], r["n"]): r for r in rows if "ms" in r}

    def dense_calls(steps, m=TRAIN_M):
        calls = {(m, k, n): per_layer * N_LAYERS * steps
                 for (k, n), per_layer in LAYER_SHAPES.items()}
        calls[(m, *HEAD_SHAPE)] = steps
        return calls

    steps = TRAIN_STEPS + SR_STEPS
    train_calls = dense_calls(steps)
    fwd_calls = dict(train_calls)
    for (k, n), per_layer in LAYER_SHAPES.items():
        fwd_calls[(BATCH * PROMPT, k, n)] = per_layer * N_LAYERS
        fwd_calls[(BATCH, k, n)] = per_layer * N_LAYERS * (NEW - 1)
    fwd_calls[(BATCH, *HEAD_SHAPE)] = NEW
    prologue_calls = dense_calls(PROLOGUE_STEPS)
    fxp_by_shape = by_shape(fxp_rows)
    # fxp_matmul by branch: M > 16 on the tensor cores (prefill, training),
    # M <= 16 on the GEMV (decode, the prefill's head); the main paths'
    # runs hold each launch to its branch (check_tensor_cores)
    fxp_branches = {
        name: {"launches": sum(calls.values()),
               **summed(fxp_by_shape, calls, device_keys)}
        for name, calls in (
            ("tensor_cores", {s: c for s, c in fwd_calls.items() if s[0] > 16}),
            ("gemv", {s: c for s, c in fwd_calls.items() if s[0] <= 16}))}
    dw_by_shape = by_shape(bwd_rows["matmul_dw"])
    for shape, r in by_shape(bwd_rows["matmul_dw_f32"]).items():
        dw_by_shape[("f32",) + shape] = r        # path B's f32-out dw
    dw_calls = {**train_calls,
                **{("f32",) + s: c for s, c in prologue_calls.items()}}

    float_steps = FLOAT_STEPS + 3 * OTHER_STEPS + PROLOGUE_STEPS
    flash_by_case = {r["case"]: r for r in flash_rows if "ms" in r}
    flash_calls = {"prefill": 2 * N_LAYERS,
                   "train": N_LAYERS * (steps + float_steps)}
    launches = {k: sum(run.get(k, 0) for run in runs) for k in KERNELS}
    # SR int8: 4 SR steps, 2 int8-container steps; path B's embedding
    int8_steps = SR_STEPS + OTHER_STEPS
    stacked_by_shape = {tuple(r["shape"]): r
                        for r in sr_rows["sr_quantize_fused_stacked_int8"]}
    stacked_calls = {(N_LAYERS, k, n): c * int8_steps
                     for (k, n), c in STACKED_SHAPES.items()}
    flat_by_shape = {tuple(r["shape"]): r
                     for r in sr_rows["sr_quantize_fused_int8"]}
    flat_calls = {FLAT_SHAPES[0]: int8_steps + PROLOGUE_STEPS,
                  FLAT_SHAPES[1]: int8_steps}
    for (k, n), c in STACKED_SHAPES.items():     # path B's view, fwd + bwd
        flat_calls[(k, n)] = 2 * c * N_LAYERS * PROLOGUE_STEPS
    flat_calls[FLAT_SHAPES[1]] += 2 * PROLOGUE_STEPS
    # grid values: f32 in 4 steps, bf16 in 2
    grid_calls = {"float32": FLOAT_STEPS, "bfloat16": OTHER_STEPS}
    gs_by = {(tuple(r["shape"]), r["out"]): r
             for r in grid_rows["sr_quantize_fused_stacked"]}
    gs_calls = {((N_LAYERS, k, n), dt): c * s
                for (k, n), c in STACKED_SHAPES.items()
                for dt, s in grid_calls.items()}
    gf_by = {(tuple(r["shape"]), r["out"]): r
             for r in grid_rows["sr_quantize_fused"]}
    gf_calls = {(shape, dt): s for shape in FLAT_SHAPES
                for dt, s in grid_calls.items()}
    edf_by_shape = {tuple(r["shape"]): r for r in edf_rows}
    switches = SR_STEPS // 2 + FLOAT_STEPS // 2 + 2 + PROLOGUE_STEPS // 2
    edf_calls = {(N_LAYERS, EDF_SAMPLE): N_STACKED * switches,
                 (1, EDF_SAMPLE): N_FLAT * switches}
    given_by = {(tuple(r["shape"]), r["dtype"]): r
                for r in ops_rows["sr_quantize"]}
    given_calls = {((D_MODEL, D_FF), "float32"): OPS_PATH["sr_quantize"]}
    kl_by = {tuple(r["shape"]): r for r in ops_rows["kl_hist"]}
    kl_calls = {(N_LAYERS, D_MODEL, D_FF): OPS_PATH["kl_hist"]}
    i8_calls = {(TRAIN_M, D_MODEL, D_FF): OPS_PATH["int8_matmul"]}

    def entry(name, source, replaces, err, times):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": launches[name], "max_abs_err": err, **times}

    return [
        entry("fxp_matmul", "fxp_matmul.cu", "fxp_matmul.py:84", fxp_err,
              {**summed(fxp_by_shape, fwd_calls, device_keys),
               **fxp_branches}),
        entry("flash_attention", "flash_attention.cu", "flash_attention.py:82",
              flash_err, summed(flash_by_case, flash_calls, device_keys)),
        entry("matmul_dx", "fxp_matmul_bwd.cu", "fxp_matmul.py:203",
              bwd_err["matmul_dx"], summed(by_shape(bwd_rows["matmul_dx"]),
                                           train_calls, device_keys)),
        entry("matmul_dw", "fxp_matmul_bwd.cu", "fxp_matmul.py:259",
              bwd_err["matmul_dw"], summed(dw_by_shape, dw_calls, device_keys)),
        entry("flash_attention_dq", "flash_attention_bwd.cu",
              "flash_attention.py:245", fbwd_err["flash_attention_dq"],
              {**summed({"train": fbwd_rows["flash_attention_dq"][0]},
                        {"train": N_LAYERS * (steps + float_steps)},
                        device_keys),
               "library_covers": "flash_attention_dq+flash_attention_dkv"}),
        entry("flash_attention_dkv", "flash_attention_bwd.cu",
              "flash_attention.py:279", fbwd_err["flash_attention_dkv"],
              {**summed({"train": fbwd_rows["flash_attention_dkv"][0]},
                        {"train": N_LAYERS * (steps + float_steps)},
                        device_keys),
               "library_covers": "see flash_attention_dq"}),
        entry("sr_quantize_fused_stacked_int8", "sr_quantize.cu",
              "sr_quantize.py:299", 0.0,
              summed(stacked_by_shape, stacked_calls)),
        entry("sr_quantize_fused_int8", "sr_quantize.cu", "sr_quantize.py:188",
              0.0, summed(flat_by_shape, flat_calls)),
        entry("edf_ladder_hists", "edf_ladder.cu", "edf_ladder.py:41", 0.0,
              summed(edf_by_shape, edf_calls)),
        entry("sr_quantize_fused_stacked", "sr_quantize.cu",
              "sr_quantize.py:282", 0.0, summed(gs_by, gs_calls)),
        entry("sr_quantize_fused", "sr_quantize.cu", "sr_quantize.py:174", 0.0,
              summed(gf_by, gf_calls)),
        entry("fxp_qmatmul", "fxp_qmatmul.cu", "fxp_matmul.py:345",
              q_err["fxp_qmatmul"],
              summed(by_shape(q_rows["fxp_qmatmul"]), prologue_calls,
                     device_keys)),
        entry("matmul_qdx", "fxp_qmatmul.cu", "fxp_matmul.py:408",
              q_err["matmul_qdx"],
              summed(by_shape(q_rows["matmul_qdx"]), prologue_calls,
                     device_keys)),
        entry("sr_quantize", "sr_quantize.cu", "sr_quantize.py:66", 0.0,
              summed(given_by, given_calls)),
        entry("int8_matmul", "int8_matmul.cu", "fxp_matmul.py:145", 0.0,
              {**summed(by_shape(ops_rows["int8_matmul"]), i8_calls),
               "library_covers": "torch._int_mm (int32 out, no scale)"}),
        entry("kl_hist", "kl_hist.cu", "kl_hist.py:27", 0.0,
              {**summed(kl_by, kl_calls),
               "library_covers": "two torch.histc calls (their own bin "
                                 "formula)"}),
    ]


if __name__ == "__main__":
    raise SystemExit(main())

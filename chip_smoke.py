#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one H100: build the kernels, hold
each against its plain version, serve llama3.2-3b through the ``Engine``,
train it with AdaPT-SGD through ``train_loop.train`` (round-to-nearest
words, stochastically rounded words through a precision switch, the float
containers, the quantize prologue, the registry's default quantizer with
the reference's jax.random noise, remat and microbatch accumulation, the
registry's own config), drive the three kernels only ``kernels/ops``
reaches, save and resume a run, compare the card with the CPU at depth 2
for each, train the paper's own models, AlexNet and ResNet20, on the
synthetic CIFAR stream, serve a burst through the continuous batcher on a
captured decode, serve (and for smollm-360m train) the dense family's
granite-8b and smollm-360m, serve, train and batch gemma2-2b at full width
and depth, and serve and train the MoE layer's mixtral-8x22b and
arctic-480b at full width with their depth cut.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device: the card's name and power limit; require compute capability 9.0;
  2. build: nvcc the CUDA sources of ``src/repro_torch/csrc`` (in parallel);
     ptxas must report no spill for the GEMV, the int8 tensor-core
     kernel, the float SR grid-value kernel and the EDF ladder;
  3. kernels, each against its plain version on the same inputs, with the
     times of the kernel, the plain version, one PyTorch call
     (``library_ms``, a yardstick only) and the bound: ``fxp_matmul`` at
     every shape of the serving and training paths plus ragged shapes and
     a misaligned x, on all three branches (bf16 x with M > 16 on the
     tensor cores, M <= 16 on the GEMV, f32 x with M > 16 on the SIMT
     kernel), the kernel and ``torch.matmul`` also timed by CUDA-graph
     replay, the GEMV at M = 1, 3, 4, 8, 16 and on misaligned words, and
     repeated for equal bits at the decode head and the MLP wo;
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
     int8 words bit for bit; the EDF ladder bit for bit at the switch's
     shapes, ragged and empty slices, a misaligned base, values near
     ±3.3e38, a NaN layer and the pathological values, also timed by
     CUDA-graph replay, repeated for equal bits, and one kernel event a
     call under the profiler; the float SR grid values (flat and stacked, f32
     and bf16 out) bit for bit at every leaf shape, WL 2…32, FL −3…28,
     layers of a chunk's length ± 1, bf16 out with n_l % 8 != 0, x and q
     misaligned and 65535 layers, also timed by CUDA-graph replay;
     ``fxp_qmatmul``/``matmul_qdx`` at every training shape and ragged
     and misaligned shapes in both modes (both on bf16 x / dy on the
     tensor cores; on f32 on the SIMT
     kernels; their and the library's times also by CUDA-graph replay);
     the float containers' cuBLAS bf16 GEMMs with and without bf16
     split-K reduction; ``sr_quantize`` (the noise given)
     bit for bit on the stacked (28, 3072, 8192) leaf at <8,4> and <16,13>,
     one layer of it, bf16 x, a ragged size and the pathological values;
     ``int8_matmul`` bit for bit at M = 2048 on the four dense shapes and
     the head, at 509 x 1031 x 127, at M = 4, on a misaligned xq and on the
     largest sums, each on the branch its shape and alignment name (the
     tensor cores or ``__dp4a``), repeated for equal bits at the head,
     timed by CUDA-graph replay against ``torch._int_mm`` with wq
     row-major and column-major, its scale gradients within 1e-5;
     ``kl_hist`` bit for bit on that leaf
     against its SR copy at 256 and 150 bins and on the pathological
     values; the SR int8 words, ``sr_quantize`` and ``kl_hist`` also
     timed by CUDA-graph replay (the SR int8 words over three graphs);
  4. serving main path: llama3.2-3b at full config (28 layers, random TNVS
     weights from a seed, int8 words at FL 10), ``Engine.generate`` on 4
     prompts of 128 tokens, 32 new tokens, greedy; launch counts per forward
     (here and on every later path, every flash forward, dq and dkv,
     ``matmul_dx``, ``matmul_dw``, ``fxp_qmatmul``, ``matmul_qdx`` and
     ``fxp_matmul`` at M > 16 must have taken the tensor-core branch, and
     ``fxp_matmul`` at M <= 16, decode and the prefill's head, its GEMV);
     8 profiled decode steps show no more GEMV kernels than calls, no
     finish kernel and no memset (fewer kernel events than the exact
     launch count are the profiler's loss: logged, with its launch calls
     that have no device event);
  5. serving, card against CPU: the same model at depth 2, same weights,
     plain versions on the CPU against the kernels on the card;
  6. training main path: full llama3.2-3b, RTN words at FL 10, 3 steps of
     4 x 512 tokens (no precision switch), per-step ms, tokens/s, loss,
     grad_norm and exact launch counts, peak memory; one more step under
     the profiler: device busy share, time by kernel, and no library GEMM;
  7. training, card against CPU: one step at depth 2, batch 2 x 64, with
     activation quantization on (the main path's) and one with it off;
  8. SR training main path: full llama3.2-3b with the registry's
     stochastic rounding, 4 steps of 4 x 512 tokens with a precision switch
     after steps 2 and 4 (lookback 2, so every tensor switches after step
     2): exact launch counts per step and per switch, the <WL,FL>
     histogram over the 198 tensor-layers before and after, the switch's
     wall and device time by kernel (one ladder kernel event a call, no
     second ladder kernel), a profiled SR step (its SR kernel events
     against the launch count);
  9. SR training, card against CPU at depth 2: the same state through
     ``precision_switch`` on both, and the SR words of every leaf with the
     same seeds;
 10. path A, the float containers: full llama3.2-3b in the registry's
     float32 container with SR, 4 steps through two switches (7 stacked +
     2 flat float-SR launches a step, no fxp kernel, a profiled step whose
     dense layers are library GEMMs, as the reference's XLA dots, and its
     float SR kernel events against the launch count), the
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
     dense leaf (through the regularizer's view) bit-equal (path B's
     step at depth 2 is phase 16's, with remat and accumulation);
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
     backward on words of the step (both on the tensor cores), each launch
     counted;
 15. phase 14's configuration, card against CPU at depth 2: the quantized
     copy each step read bit-equal, one step within the slice-2 bounds
     (the CPU taking the plain attention's AV product in the card's bf16),
     the switch identical;
 16. remat and microbatch accumulation on the packed path (full
     llama3.2-3b, SR words at FL 10): one step of 4 x 512 from the same
     state and batch under remat none, full and selective, exact launches
     (the layers' forward kernels twice under full and selective), params,
     "grad_sum", loss and grad_norm bit-equal across the three, the peak
     memory of each (full's below none's); then 8 x 512 in 8 microbatches
     of 1 x 512 under full remat: exact launches per step (8 x the
     layers' forward kernels twice and the head's once, 8 backwards, the
     SR words once), the first step's loss and params within 5e-3 of one
     batch of the same rows, two more steps through a switch, step ms,
     tokens/s, peak memory; then card against CPU at depth 2, batch 8 x 64,
     remat full and 2 microbatches, through the quantize prologue, one
     step within phase 7's bounds;
 17. the registry's config: ``get_config("llama3.2-3b")`` with only the
     batch (8) and the sequence (512) cut (remat full, 8 microbatches in
     an f32 accumulator, the QuantConfig defaults, no kernel launched), 2
     steps, step ms from the loop's watchdog, peak memory;
 18. checkpoints: the reduced llama3.2-3b, packed with SR under
     ``quant.use_pallas``: 2 steps, an async save, 2 more; restored into a
     fresh state on the card, the same 2 steps bit-equal to the
     uninterrupted run; ``launch.train --resume --metrics-dir`` from it and
     ``launch.serve --checkpoint-dir``;
 19. the CNN family: (a) ``get_config("alexnet")`` and
     ``get_config("resnet20")`` at full width, batch 512, CIFAR10, the
     QuantConfig defaults (no hand-written kernel), with only a switch
     after every second step and a window of two, 4 steps: step ms,
     images/s, peak memory, loss and accuracy; (b) the same under
     ``quant.use_pallas`` and ResNet20 on CIFAR100: exactly one
     ``sr_quantize_fused`` launch per quantized leaf a step (8 and 22) and
     one ``edf_ladder_hists`` launch per tensor a switch, nothing else; the
     <WL,FL> histogram before and after the first switch; held-out
     accuracy (RTN words from ``quantize_for_serving``, the eval forward
     on 8 batches from step 10000); the analytical perf model's summary
     over the run's switches (``perf_model.summarize``, not a time on the
     card); (c) both kernels bit for bit against their plain versions at
     every full-width leaf shape (timed), one full-width step run twice
     under the global cuDNN flags at torch's defaults and twice with them
     off, all four bit-equal, and card against CPU at smoke width: the
     quantized copy bit-equal, one step within the CPU tests' bounds, the
     switch identical;
 20. the continuous batcher (``serve/scheduler.py``) on the phase-4 model:
     4 slots, a context of 256, cfg.serve's policy (levels 8/6/4), a
     queue of 12; the decode of the slot pool one CUDA graph per level,
     captured at construction (a warm-up decode and three captures: the
     GEMV's exact launches, nothing else); a burst of 16 requests (prompts
     of 8-96 tokens, 8-24 new, EOS ids, one over the context, three past
     the queue) drains with every step timed, the WL down to 4 and back
     one level at a time, every rid one terminal status, ``decode_captures``
     3 at the end; 8 replays mid-burst bit-equal to the eager decode of the
     same state (logits and caches); the same burst again: the same WL
     trace and outputs; a request alone and among 3 others: the same
     output; the seeded faults of ``test_serve_robustness.py``'s whole
     contract; a journal, ``evict_all`` and ``recover`` draining all;
     ``launch.serve --continuous``; 16 replays timed by CUDA events and 8
     under the profiler (GEMV events against the graph's calls); then card
     against CPU at depth 2 (logits within 2^-5 of the largest, greedy
     tokens equal past the margin);
 21. the dense family: every shape smollm-360m and granite-8b bring to a
     kernel against its plain version, as phase 3 (``fxp_matmul`` at M = 4,
     512 and, for smollm, 2048 at K = 960, 4096 and 14336 and the heads of
     49152, the GEMV repeated for equal bits; ``matmul_dx``/``_dw``,
     the flash forward at D = 64 and 128 and its backward at D = 64, the SR
     int8 words at 32 layers, the EDF ladder at (32, 65536)); smollm-360m
     at full width: ``Engine`` on 4 x 128 prompts, 32 new tokens, with exact
     launches, the batcher's burst, 3 packed SR steps of 4 x 512 through a
     switch with exact launches, ``get_config("smollm-360m")`` with only
     batch 8 and sequence 512 cut, 2 steps; granite-8b at full width,
     serving only: ``Engine``, then the batcher with its three levels, the
     peak memory;
 22. gemma2-2b at full width and depth (26 x 2304, 8/4 heads of 256, d_ff
     9216, V 256000, tied head, softcaps 50/30, local window 4096): every
     new kernel shape against its plain version (the flash forward at
     D = 256 with softcap and window, also at a 4160-token prompt where the
     window bites; dq/dkv at (4, 512, 8/4, 256) on the SIMT branch;
     ``fxp_matmul`` at K = 2304, 2048 and 9216 at M = 4 (the GEMV), 512 and
     2048 (the tensor cores); ``matmul_dx``/``_dw`` at 2048); ``Engine`` on
     4 x 128 prompts, 32 new tokens, exact launches, 8 profiled decode
     steps (the tied head's dequantize and library GEMM timed by its
     kernels); one request of 4160 prompt tokens and 16 new, its greedy
     tokens against a teacher-forced forward's argmax; the batcher (4
     slots, levels 8/6/4, replays bit-equal to the eager decode); 3 packed
     SR steps of 4 x 512 through a switch with exact launches and a
     profiled step (the SIMT dq + dkv, the tied head); the peak memory;
     the smoke config (window 8) card against CPU;
 23. the MoE layer, with only the router, expert and tied-head products
     (and decode attention's own einsums) allowed as library GEMMs in
     every profiled window (``library_sites``): the new kernel shapes
     (mixtral's and arctic's attention, arctic's dense residual, the heads,
     the flash forward at 48/8 and 56/8 heads, the SR int8 words and float
     grid values of the (1, 8, 6144, 16384) expert stack bit for bit);
     mixtral-8x22b (d 6144, 48/8 heads, d_ff 16384, 8 experts top-2, V
     32768) at depth 2 of 56 through ``Engine`` (its prefill's dropped
     pairs, a dropless decode) and the batcher, at depth 1 through 2
     packed SR steps of 4 x 512 with a switch (capacity 640, the dropped
     pairs of each step, exact launches, a profiled step), each peak
     beside the reckoned parameter bytes; arctic-480b (d 7168, 56/8 heads,
     d_ff 4864, V 32000, a dense residual of 4864) at depth 1 with 16 of
     its 128 experts: its registry config (8 microbatches of 1 x 512,
     remat full, a bf16 accumulator, the QuantConfig defaults), 2 steps,
     and ``Engine``; both smoke configs card against CPU (logits, chosen
     experts and every pair's slot, one packed step's updates and dropped
     pairs);
 24. the SSM family: mamba2-780m and zamba2-7b at full width (the dense
     kernels at their ragged N and unaligned head rows, flash at D = 112),
     served (``Engine``, batcher) and trained (mamba2 at full depth, zamba2
     at 9 of 27 periods); smoke configs card against CPU;
 25. cross-attention and the audio encoder: the non-causal flash forward,
     dq and dkv at hubert-xlarge's (4, 512, 16/16, 80) beside non-causal
     SDPA; the f32 SIMT ``fxp_matmul`` and ``matmul_dw`` at the VLM's
     memory projection (4096 x 4096 x 1024) beside f32 ``torch.matmul``;
     ``fxp_matmul``, ``matmul_dx`` and ``matmul_dw`` at every dense layer
     and head of both models at the training M = 2048 (hubert's head at
     N = 504) and the VLM's GEMV shapes; llama-3.2-vision-11b
     served at full depth (``Engine`` with a (4, 1024, 4096) f32 image
     memory, exact launches by branch) and trained at 4 of its 8 periods
     (3 packed SR steps of 4 x 512 with 1024 image tokens a row, through a
     switch); hubert-xlarge trained at full depth (3 packed SR steps of 4 x
     512 frames through a switch, then its registry config with only batch
     and sequence cut); each peak; both smoke configs card against CPU
     (the VLM's ``Engine`` and batcher, one packed SR step of each with
     activation quantization on and one with it off);
 26. the data-parallel mesh: (a) full-width llama3.2-3b leaves (the
     embedding, stacked wq and wi_up) under the specs ``param_pspec`` gives
     them with zero_shard on (1, 2, 1), (2, 2, 1) and (1, 4, 1) meshes,
     quantized block by block on the card by the four fused SR entry
     points with the per-shard seeds, each block and the assembled leaf
     bit for bit against their plain versions, each launch timed; (b) two
     ranks spawned on cuda:0 over gloo (the kernels built first, here),
     llama3.2-3b at full width and depth 14 of 28 in the float32
     container under use_pallas, fused_prng and SR: 2 steps and a switch
     on a (1, 2, 1) mesh with zero_shard, 2 steps on a (2, 1, 1) mesh with
     QSGD across pods, exact launches a rank, ⟨WL,FL⟩ equal on both ranks, the
     first step within 2e-2 normwise a leaf of one process that computes
     each rank's gradients on its rows with the same words and sums them
     as the ranks do; step ms a rank, the bytes each collective is handed,
     the QSGD payload against f32, the peak a rank (two ranks on one card:
     not a multi-GPU speed).

The second-to-last line is the kernels' JSON record and the last line is
``{"ok": true, "device": {...}}``. Per-shape details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
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
F32_FLOPS = 67e12                      # outside the tensor cores

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
# accumulation (phase 16 drives both), 4 sequences of 512 tokens.
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
# Phases 7, 11, 15 and 16 compare card and CPU at depth 2 with the
# vocabulary cut to 8192: over the full embedding and head (788 M of the
# 940 M quantized elements at depth 2) the CPU's quantized copies, noise
# and products took most of their 66, 54, 84 and 96 s.
DEPTH2_VOCAB = "model.vocab_size=8192"
DEFAULT_DEPTH2_CUTS = ["model.num_layers=2", DEPTH2_VOCAB,
                       "train.global_batch=2", "train.seq_len=64"]
DEFAULT_STEPS = 4
# The ops path of phase 14: one launch of sr_quantize per layer of the
# (28, 3072, 8192) leaf below, one kl_hist of it, int8_matmul forward and
# its backward (the kernel again at unit scale) at M = 2048.
OPS_LEAF = "blocks/s0_mlp/wi_gate"
OPS_PATH = {**ZERO, "sr_quantize": N_LAYERS, "kl_hist": 1, "int8_matmul": 2}
# Phase 16: remat and microbatch accumulation on the packed path with SR
# words. (a) one step of 4 x 512 under each remat mode; under full and
# selective remat every layer's forward kernels run again in the backward
# (the head is outside the checkpointed body). (b) 8 x 512 in 8
# microbatches of 1 x 512 (M = 512: the tensor cores) under full remat:
# per microbatch the layers' forward kernels twice and the head's once,
# one backward; the SR words once per step.
REMAT_OVERRIDES = OVERRIDES + [
    "train.accum_steps=1", f"train.global_batch={TRAIN_B}",
    f"train.seq_len={TRAIN_S}", "train.log_every=1"]
LAYER_DENSE = 7 * N_LAYERS
REMAT_STEP = {**SR_PER_STEP, "fxp_matmul": 2 * LAYER_DENSE + 1,
              "flash_attention": 2 * N_LAYERS}
ACCUM_B, ACCUM = 8, 8
ACCUM_OVERRIDES = OVERRIDES + [
    "train.remat=full", f"train.accum_steps={ACCUM}",
    f"train.global_batch={ACCUM_B}", f"train.seq_len={TRAIN_S}",
    "train.log_every=1", "train.adapt_interval=2", "quant.lb_lwr=2"]
ACCUM_STEPS = 3                        # the first alone, then two through train
ACCUM_PER_STEP = {
    **ZERO, "fxp_matmul": ACCUM * (2 * LAYER_DENSE + 1),
    "flash_attention": ACCUM * 2 * N_LAYERS,
    "matmul_dx": ACCUM * DENSE_CALLS, "matmul_dw": ACCUM * DENSE_CALLS,
    "flash_attention_dq": ACCUM * N_LAYERS,
    "flash_attention_dkv": ACCUM * N_LAYERS,
    "sr_quantize_fused_stacked_int8": N_STACKED,
    "sr_quantize_fused_int8": N_FLAT}
# accum_steps=8 against 1 on the same rows: the reference's own bound
# (tests/test_train.py::test_accumulation_matches_full_batch)
ACCUM_ABS = 5e-3
# Phase 17: the registry's llama3.2-3b config with only the batch and the
# sequence cut (remat full, 8-way accumulation in f32, the QuantConfig
# defaults: no hand-written kernel).
REGISTRY_CUTS = [f"train.global_batch={ACCUM_B}", f"train.seq_len={TRAIN_S}"]
REGISTRY_STEPS = 2
# Phase 18: checkpoints of the reduced llama3.2-3b on the packed path.
CKPT_OVERRIDES = ["quant.container_dtype=int8_packed", "quant.use_pallas=true",
                  "quant.init_fl=8", "train.global_batch=4",
                  "train.seq_len=64", "train.adapt_interval=2",
                  "quant.lb_lwr=2", "train.log_every=1"]
# Phase 19: the CNN family, the paper's own models: the registry's configs
# (full width, batch 512, CIFAR10, the QuantConfig defaults) with only a
# switch after every second step and a window of two steps, so the first
# switch closes every tensor's window ("train.log_every=1" only logs each
# step), 4 steps, then a window of CNN_WINDOW steps with no switch, timed;
# under quant.use_pallas the SR kernel of the container (float grid values,
# or int8 words with quant.container_dtype=int8) once per quantized leaf a
# step and the ladder once per tensor a switch.
CNN_MODELS = ("alexnet", "resnet20")
CNN_OVERRIDES = ["train.adapt_interval=2", "quant.lb_lwr=2",
                 "train.log_every=1"]
CNN_STEPS = 4
CNN_WINDOW = 8
CNN_LEAVES = {"alexnet": 8, "resnet20": 22}      # quantized leaves
CNN_EVAL = 8                           # held-out batches, from step 10000
# One smoke-width step, card against CPU: the CPU tests' bounds
# (tests/test_torch_cnn_step.py)
CNN_LOSS_RTOL, CNN_GRAD_NORM_RTOL = 1e-5, 1e-4
CNN_UPDATE, CNN_STATS = 1e-3, 2e-5
# CUDA graphs a device time of the SR int8 kernels takes the median of: the
# flat kernel's launched time scattered by a third between runs.
GRAPH_RUNS = 3
# The profiled window's name, and the spin kernels launched ahead of it.
WINDOW = "chip_smoke.window"
SPINS = 64
# Phase 20: the continuous batcher on the phase-4 model (int8 words at FL
# 10 under quant.use_pallas): 4 slots, a context of 256, cfg.serve's policy
# (levels 8/6/4, pressure at a queue of 8, drained at 1, patience 2), a
# queue of 12, a burst of 16 requests (one over the context, three past the
# queue), so the WL walks down to 4 and back one level at a time.
CB_SLOTS, CB_CONTEXT, CB_QUEUE, CB_BURST = 4, 256, 12, 16
CB_LEVELS = (8, 6, 4)
CB_CHECKED = 8                         # replays bit-equal to the eager decode
CB_TIMED = 16                          # replays timed by CUDA events, each
CB_DEPTH2_NEW = 4                      # new tokens a request, card vs CPU
# Phase 21: the dense family's other two configs at full width.
SMOLLM, GRANITE = "smollm-360m", "granite-8b"
FAMILY = (SMOLLM, GRANITE)
SMOLLM_SR_STEPS = 3                    # a switch after the second
# Phase 22: gemma2-2b at full width and depth; a request past its local
# window of 4096.
GEMMA = "gemma2-2b"
GEMMA_SR_STEPS = 3                     # a switch after the second
LONG_PROMPT, LONG_NEW = 4160, 16
# Phase 23: the MoE family at full width. mixtral-8x22b is cut to depth 2
# of 56 to serve and 1 to train; arctic-480b to depth 1 of 35 and 16 of its
# 128 experts (one layer of all 128 is 13.37 G params, 53.5 GB of f32
# master, and 4.46 G elements a layer slice, past the kernels' 2^31
# guards).
MIXTRAL, ARCTIC = "mixtral-8x22b", "arctic-480b"
MIXTRAL_SERVE_LAYERS, MIXTRAL_TRAIN_LAYERS = 2, 1
MIXTRAL_STEPS = 2                      # the second ends in a switch
ARCTIC_CUTS = ["model.num_layers=1", "model.num_experts=16"]
# Phase 24: the SSM family at full width. mamba2-780m at full depth (48
# layers, 0.857 G params); zamba2-7b served at full depth (27 periods of
# two mamba layers and the shared attention + MLP block, 4.645 G params)
# and trained at 9 of its 27 periods (1.84 G params: a full-depth step
# holds ~19 GB of f32 master, as much of f32 gradients and ~9 GB of
# grad_sum and the quantized copy before any activation).
MAMBA, ZAMBA = "mamba2-780m", "zamba2-7b"
SSM_SR_STEPS = 2                       # the second ends in a switch
ZAMBA_TRAIN_PERIODS = 9
# Phase 25: the last two registered architectures at full width.
# llama-3.2-vision-11b (8 periods of four self-attention layers and a
# cross slot over 1024 image tokens, 9.775 G params) serves at full depth
# and trains at 4 of its 8 periods (5.41 G params, a packed step's peak
# 62.14 GiB on the card; at full depth the f32 master and gradients alone
# are ~73 GiB); hubert-xlarge (48 encoder layers, 1.261 G params) trains
# at full depth.
VLM, HUBERT = "llama-3.2-vision-11b", "hubert-xlarge"
VLM_TRAIN_PERIODS = 4
CROSS_SR_STEPS = 3                     # the second ends in a switch
# PyTorch ops that would run a library GEMM: none may appear in a step.
LIBRARY_GEMMS = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
                 "aten::matmul", "aten::linear", "aten::einsum"}
# Phases 22-23: the only call sites that may run a library GEMM, where the
# reference computes the product outside Pallas (the MoE router and expert
# einsums, gemma2's tied head); ``library_sites`` names them in a trace, and
# the backward of the autograd Function they run names their gradients.
SITE = "chip_smoke.site:"
# ``common._PlainDense`` serves all three; its backward's batched GEMMs
# are the experts'.
BACKWARD = "_PlainDenseBackward"
BATCHED_GEMMS = {"aten::bmm", "aten::baddbmm"}


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


def bound(nbytes: float, flops: float, rate: float = BF16_FLOPS):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def spill_free(reports, kernels) -> None:
    """ptxas -v of each source built in this run: every function whose name
    holds ``kernels[source]`` has 0 bytes of spill stores and loads. A
    source already built (no report) is not checked."""
    for source, key in kernels.items():
        lines = reports.get(source, "").splitlines()
        seen = 0
        for i, line in enumerate(lines):
            if "Function properties for" not in line or key not in line:
                continue
            seen += 1
            props = next((l for l in lines[i + 1:i + 3] if "spill" in l), "")
            if "0 bytes spill stores, 0 bytes spill loads" not in props:
                raise AssertionError(f"{source}: {line.strip()} {props.strip()}")
        if lines and not seen:
            raise AssertionError(f"{source}: no ptxas report for {key}")
        log(f"[build] {source}: {seen} {key} functions, no spill"
            if lines else f"[build] {source}: built before, spills not checked")


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
    at the training head's shape, and the GEMV at the decode head's and
    the MLP wo's, must give equal bits. The GEMV's cases cover its three M
    buckets (M <= 4, 8, 16), M = 1, ragged K and N and misaligned words."""
    dev = "cuda"
    scale = torch.tensor(2.0 ** -10, dtype=torch.bfloat16, device=dev)
    prefill_m, decode_m = BATCH * PROMPT, BATCH
    cases = [(m, k, n) for (k, n) in LAYER_SHAPES
             for m in (prefill_m, decode_m, TRAIN_M)]
    cases += [(decode_m, *HEAD_SHAPE), (prefill_m, *HEAD_SHAPE),
              (TRAIN_M, *HEAD_SHAPE),
              (37, 3071, 1025), (3, 3071, 1025), (16, 100, 36), (17, 129, 257),
              MISALIGNED, (8, 1000, 300), (1, 8192, 200), GEMV_MISALIGNED_W]
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
        if (m, k, n) == GEMV_MISALIGNED_W:
            ws = [misaligned(torch, w) for w in ws]
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
            if (m, k, n) in ((TRAIN_M, *HEAD_SHAPE), (decode_m, *HEAD_SHAPE),
                             (decode_m, D_FF, D_MODEL)):
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


def sdpa_flash_backward(torch, q, k, v, do, causal=True):
    """SDPA's backward on the inputs of a flash backward call (causal, or
    not for an encoder's), pinned to
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
            qt, kt, vt, is_causal=causal)

    def launched():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        qt.detach(), kt.detach(), vt.detach(), 0.0, causal)
    o, lse, cq, ck, mq, mk, seed, offset = fwd[:8]

    def device():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dot, qt.detach(), kt.detach(), vt.detach(), o, lse, cq, ck, mq, mk,
            0.0, causal, seed, offset)

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
    and large seeds. Times: kernel (launched, and by CUDA-graph replay,
    ``device_ms``: the median of ``GRAPH_RUNS`` graphs, each replayed
    twice, all kept in ``device_ms_runs``), plain version, bound (4 bytes
    read and 1 written per element; the ~20 integer and float operations
    per element at the CUDA-core rate take less)."""
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
        runs = [graph_time_ms([lambda: kern(x, seed, fl)], 5)
                for _ in range(GRAPH_RUNS)]
        row = {"shape": list(shape), "max_abs_err": 0.0,
               "ms": cuda_time_ms([lambda: kern(x, seed, fl)], 5),
               "device_ms": sorted(runs)[len(runs) // 2],
               "device_ms_runs": runs,
               "plain_ms": cuda_time_ms([lambda: plain(x, seed, fl)], 2),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = max(
            (5.0 * n / HBM_BYTES_PER_S * 1e3, "bytes"),
            (20.0 * n / F32_OPS * 1e3, "operations"))
        rows[name].append(row)
        log(f"[kernels] {name} {list(shape)}: bit-equal, ms={row['ms']:.4g}, "
            f"device_ms={row['device_ms']:.4g} (graph runs "
            f"{', '.join(f'{r:.4g}' for r in runs)}), "
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
    pathological values; and at the edges of the chunked kernel: layers of
    a chunk's length ± 1, bf16 out with n_l % 8 != 0, x one element past a
    16-byte boundary, q off x (through the C entry points, as the wrappers
    allocate q aligned), and 65535 layers of 5 elements (against the plain
    formula on the hash index of every element). Times (f32 and bf16 out):
    kernel launched (``ms``) and by CUDA-graph replay (``device_ms``, with
    ``device_tb_per_s``), plain version, bound (4 bytes read and 4 or 2
    written per element; the ~22 integer and float operations per element
    at the CUDA-core rate take less)."""
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
            call = [lambda: kern(x, seed, wl, fl, out_dtype=dt)]
            row = {"shape": list(shape), "out": str(dt).split(".")[-1],
                   "max_abs_err": 0.0, "ms": cuda_time_ms(call, 5),
                   "device_ms": graph_time_ms(call, 5),
                   "plain_ms": cuda_time_ms([lambda: plain(
                       x, seed, wl, fl, out_dtype=dt)], 2),
                   "library_ms": None, "library_device_ms": None}
            row["device_tb_per_s"] = ((4.0 + out_b) * n
                                      / (row["device_ms"] * 1e9))
            row["bound_ms"], row["bound_by"] = max(
                ((4.0 + out_b) * n / HBM_BYTES_PER_S * 1e3, "bytes"),
                (22.0 * n / F32_OPS * 1e3, "operations"))
            rows[name].append(row)
            log(f"[kernels] {name} {list(shape)} {row['out']}: bit-equal, "
                f"ms={row['ms']:.4g} (device {row['device_ms']:.4g}, "
                f"{row['device_tb_per_s']:.3g} TB/s), plain_ms="
                f"{row['plain_ms']:.4g}, bound_ms={row['bound_ms']:.4g}")

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
    # the chunked kernel's edges: layers of CHUNK - 1, CHUNK and CHUNK + 1
    # elements, bf16 out with n_l % 8 != 0 (every other layer starts 8
    # bytes off a 16-byte boundary of q), x misaligned, q off x
    C = sq.GRID_CHUNK
    lib = sq._lib()

    def direct(x, seed, wl, fl, dt, off):
        """The C entry point with q ``off`` elements past an aligned
        buffer's start (stacked for a 1-D wl, else flat)."""
        buf = torch.empty(x.numel() + off, dtype=dt, device=dev)
        q = buf[off:].view(x.shape)
        stream = torch.cuda.current_stream().cuda_stream
        head = (x.data_ptr(), q.data_ptr(), sq._OUT_CODE[dt], wl.data_ptr(),
                fl.data_ptr(), sq._seed32(seed))
        if wl.dim():
            err = lib[3](*head, x.shape[0], x[0].numel(), stream)
        else:
            err = lib[2](*head, x.numel(), stream)
        sq._build.check(err, "sr_quantize_fused[_stacked] (q off x)")
        return q

    for shape in [(3, C - 1), (2, C), (3, C + 1), (5, 4100), (3, 4, 4097)]:
        x = torch.randn(*shape, generator=gen, device=dev) * 3.0
        wl, fl = prec(shape[0])
        for dt in (torch.float32, torch.bfloat16):
            want = sq.plain_grid_stacked(x, 5, wl, fl, out_dtype=dt)
            want0 = sq.plain_grid(x[0], 5, wl[0], fl[0], out_dtype=dt)
            for xx in (x, misaligned(torch, x)):
                if not same(sq.sr_quantize_fused_stacked(xx, 5, wl, fl,
                                                         out_dtype=dt), want):
                    raise AssertionError(f"stacked grid edge {shape} {dt} "
                                         f"x at {xx.data_ptr() % 16}")
                x0 = xx[0] if xx is x else misaligned(torch, x[0])
                if not same(sq.sr_quantize_fused(x0.contiguous(), 5, wl[0],
                                                 fl[0], out_dtype=dt), want0):
                    raise AssertionError(f"flat grid edge {shape[1:]} {dt} "
                                         f"x at {x0.data_ptr() % 16}")
                for off in (1, 2, 3):
                    if not same(direct(xx, 5, wl, fl, dt, off), want):
                        raise AssertionError(f"stacked grid edge {shape} {dt}"
                                             f" q {off} elements off")
                    if not same(direct(x0.contiguous(), 5, wl[0], fl[0], dt,
                                       off), want0):
                        raise AssertionError(f"flat grid edge {shape[1:]} "
                                             f"{dt} q {off} elements off")
    # the most layers a launch takes, 5 elements each: the plain formula on
    # every element's hash index l·stride + e (stride 512)
    L, n = 65535, 5
    x = torch.randn(L, n, generator=gen, device=dev) * 3.0
    wl, fl = prec(L)
    idx = (torch.arange(L, device=dev)[:, None] * 512
           + torch.arange(n, device=dev))
    u = sq.uniform_from_index(-9, idx)
    for dt in (torch.float32, torch.bfloat16):
        want = sq.plain_given(x, u, wl[:, None], fl[:, None]).to(dt)
        if not same(sq.sr_quantize_fused_stacked(x, -9, wl, fl, out_dtype=dt),
                    want):
            raise AssertionError(f"stacked grid at L = {L} {dt}")
    log("[kernels] sr_quantize_fused[_stacked] ragged shapes, WL 2..32 x "
        "FL -3..28, seeds of both signs, pathological values, layers of "
        f"{C} - 1, {C}, {C} + 1 and 4100 elements, x and q misaligned, "
        f"{L} layers, f32 and bf16: bit-equal")
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
GEMV_MISALIGNED_W = (5, 300, 64)        # the GEMV's words one byte off 16


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
    which f32 rounds) and on a misaligned xq, each on the branch that
    ``takes_tensor_cores`` names (the counters: the tensor cores where TMA
    can address both operands, else ``__dp4a``); the tensor-core kernel
    repeated at the head's shape must give equal bits; its scale gradients
    through ``ops.int8_matmul``
    within 1e-5 relative of the plain version's (Σ dy·acc in another
    order). ``kl_hist`` counts bit for bit on that leaf against its SR copy
    at 256 and 150 bins and on the pathological values. Times: the kernel,
    the plain version, a library yardstick (``torch._int_mm``, cuBLASLt's
    int8 product with int32 out, with wq as it lies and, made before the
    timing, column-major as cuBLASLt's int8 kernels want it, the faster of
    the two named; ``int8_matmul`` and both also by CUDA-graph replay;
    two ``torch.histc`` calls over [lo, hi],
    timed only, since histc bins by its own formula; none for the SR
    values), the kernels of ``sr_quantize`` and ``kl_hist`` also by
    CUDA-graph replay (``device_ms``), and the bound."""
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
               "device_ms": graph_time_ms(
                   [lambda: sq.sr_quantize(x, u, wlt, flt)], 5),
               "plain_ms": cuda_time_ms([lambda: sq.plain_given(
                   x, u, wlt, flt)], 2),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = max(
            ((2 * xb + 4.0) * n / HBM_BYTES_PER_S * 1e3, "bytes"),
            (12.0 * n / F32_OPS * 1e3, "operations"))
        rows["sr_quantize"].append(row)
        log(f"[kernels] sr_quantize {row['shape']} {row['dtype']}: bit-equal, "
            f"ms={row['ms']:.4g}, device_ms={row['device_ms']:.4g}, "
            f"plain_ms={row['plain_ms']:.4g}, bound_ms={row['bound_ms']:.4g}")
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
               "device_ms": graph_time_ms([lambda: kh.kl_hist(x, q, nb)], 5),
               "plain_ms": cuda_time_ms([lambda: kh.plain(x, q, nb)], 2),
               "library_ms": cuda_time_ms([lambda: (
                   torch.histc(x, nb, lo, hi), torch.histc(q, nb, lo, hi))], 5),
               "library_covers": "two torch.histc calls (their own bin formula)"}
        row["bound_ms"], row["bound_by"] = max(
            (8.0 * n / HBM_BYTES_PER_S * 1e3, "bytes"),
            (12.0 * n / F32_OPS * 1e3, "operations"))
        rows["kl_hist"].append(row)
        log(f"[kernels] kl_hist {row['shape']} {nb} bins: bit-equal, "
            f"ms={row['ms']:.4g}, device_ms={row['device_ms']:.4g}, "
            f"plain_ms={row['plain_ms']:.4g}, "
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
    cases += [(509, 1031, 127), (BATCH, D_MODEL, D_MODEL), (37, 3071, 1025),
              (64, 256, 64)]
    c = im.int8_matmul

    def on_branch(xq, wq, s):
        """One launch, on the branch ``takes_tensor_cores`` names."""
        want_tc = im.takes_tensor_cores(xq.shape[1], wq.shape[1],
                                        xq.data_ptr(), wq.data_ptr())
        before = (c.launches, c.tc_launches)
        out = im.int8_matmul(xq, wq, s)
        if (c.launches - before[0], c.tc_launches - before[1]) != (1, int(want_tc)):
            raise AssertionError(f"int8_matmul {tuple(xq.shape)} @ "
                                 f"{tuple(wq.shape)}: not on the "
                                 f"{'tensor-core' if want_tc else 'dp4a'} branch")
        return out, want_tc

    for (m, k, n) in cases:
        xq = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        if (m, k, n) == (64, 256, 64):
            xq = misaligned(torch, xq)
        got, tc = on_branch(xq, wq, s)
        want = im.plain(xq, wq, s)
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or not torch.equal(got, want):
            raise AssertionError(f"int8_matmul ({m},{k},{n}): max err "
                                 f"{(got - want).abs().max().item()}")
        del got, want
        if m != TRAIN_M:
            log(f"[kernels] int8_matmul {m}x{k}x{n}: bit-equal on the "
                f"{'tensor-core' if tc else 'dp4a'} branch")
            continue
        reps = 10 if k * n < 1e8 else 3
        wq_t = wq.t().contiguous()          # column-major wq for cuBLASLt
        kern = [lambda: im.int8_matmul(xq, wq, s)]
        lib_rm = [lambda: torch._int_mm(xq, wq)]
        lib_cm = [lambda: torch._int_mm(xq, wq_t.t())]
        row = {"m": m, "k": k, "n": n, "branch": "tc" if tc else "dp4a",
               "max_abs_err": 0.0, "ms": cuda_time_ms(kern, reps),
               "plain_ms": cuda_time_ms([lambda: im.plain(xq, wq, s)],
                                        max(2, reps // 3)),
               "library_ms_row_major": cuda_time_ms(lib_rm, reps),
               "library_ms_col_major": cuda_time_ms(lib_cm, reps),
               "device_ms": graph_time_ms(kern, reps),
               "library_device_ms_row_major": graph_time_ms(lib_rm, reps),
               "library_device_ms_col_major": graph_time_ms(lib_cm, reps)}
        faster = ("col_major" if row["library_device_ms_col_major"]
                  <= row["library_device_ms_row_major"] else "row_major")
        row["library_ms"] = row[f"library_ms_{faster}"]
        row["library_device_ms"] = row[f"library_device_ms_{faster}"]
        row["library_covers"] = (f"torch._int_mm (int32 out, no scale), wq "
                                 f"{faster.replace('_', '-')}")
        if n == VOCAB:
            row["repeats_bit_equal"] = bit_stable(
                torch, lambda: im.int8_matmul(xq, wq, s), 20,
                f"int8_matmul ({m},{k},{n})")
        row["bound_ms"], row["bound_by"] = max(
            ((m * k + k * n + 4.0 * m * n) / HBM_BYTES_PER_S * 1e3, "bytes"),
            (2.0 * m * k * n / INT8_OPS * 1e3, "operations"))
        rows["int8_matmul"].append(row)
        log(f"[kernels] int8_matmul {m}x{k}x{n}: bit-equal on the "
            f"{row['branch']} branch, ms={row['ms']:.4g} (device "
            f"{row['device_ms']:.4g}), plain_ms={row['plain_ms']:.4g}, _int_mm "
            f"row-major {row['library_ms_row_major']:.4g} (device "
            f"{row['library_device_ms_row_major']:.4g}), column-major "
            f"{row['library_ms_col_major']:.4g} (device "
            f"{row['library_device_ms_col_major']:.4g}), bound_ms="
            f"{row['bound_ms']:.4g} ({row['bound_by']})")
        del xq, wq, wq_t
    one = torch.ones((), dtype=torch.float32, device=dev)
    for word, want_acc in ((-128, 2.0 ** 27), (127, 132128768.0)):
        xq = torch.full((64, 8192), word, dtype=torch.int8, device=dev)
        got, _ = on_branch(xq, xq.T.contiguous(), one)
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
    llama3.2-3b, with per-layer live bins in [50, 150]; at ragged sizes
    (n of 1, 5, CLUSTER - 1, 65541: every slice split, empty slices, slices
    streamed twice), from a base one element off a 16-byte boundary, near
    ±3.3e38 (FL -127, clamped), with a NaN layer, and on the pathological
    values (a bin that is NaN counted in no row). Repeated calls give equal
    bits; three calls under the profiler are three kernel events and
    nothing else (no memset, copy or second kernel). Times: kernel launched
    and by graph replay, plain version, bound (each input read once, the
    counts written once; ~166 f32 operations per element at the CUDA-core
    rate)."""
    from repro_torch.core import pushdown
    dev = "cuda"
    kw = dict(wl_ladder=pushdown.WL_LADDER, r_upr=150)
    T = len(pushdown.WL_LADDER)

    def same(w, fls, r, what):
        got = el.edf_ladder_hists(w, fls, r, **kw)
        want = el.plain(w, fls, r, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"edf_ladder {what}: counts differ by "
                                 f"{(got - want).abs().max().item()}")
        return got

    rows = []
    cases = [(N_LAYERS, EDF_SAMPLE, 0.02), (1, EDF_SAMPLE, 0.02),
             (3, 65541, 0.02), (2, 1, 0.02), (4, 127, 0.02), (3, 5, 0.02),
             (2, el.CLUSTER - 1, 0.02), (2, 4099, 1e38)]
    for L, n, scale in cases:
        w = torch.randn(L, n, generator=gen, device=dev) * scale
        w = w.clamp(-3.3e38, 3.3e38)
        fls = edf_inputs(torch, w)
        r = torch.randint(50, 151, (L,), generator=gen, device=dev,
                          dtype=torch.int32)
        got = same(w, fls, r, f"({L}, {n})")
        if scale < 1 and not bool((got.sum(dim=2) == n).all()):
            raise AssertionError(f"edf_ladder ({L}, {n}): rows do not sum to n")
        if n != EDF_SAMPLE:
            continue
        call = [lambda: el.edf_ladder_hists(w, fls, r, **kw)]
        row = {"shape": [L, n], "max_abs_err": 0.0,
               "ms": cuda_time_ms(call, 20), "device_ms": graph_time_ms(call, 20),
               "plain_ms": cuda_time_ms([lambda: el.plain(w, fls, r, **kw)], 5),
               "library_ms": None}
        nbytes = 4.0 * (L * n + L * T + L + 2 * L + T) + \
            4.0 * L * (1 + T) * 150
        row["bound_ms"], row["bound_by"] = max(
            (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
            (166.0 * L * n / F32_OPS * 1e3, "operations"))
        if L == N_LAYERS:
            row["repeats_bit_equal"] = bit_stable(torch, call[0], 20,
                                                  "edf_ladder_hists")
            before = el.edf_ladder_hists.launches
            prof = device_breakdown(torch, lambda: [c() for c in call * 3])
            if el.edf_ladder_hists.launches - before != 3:
                raise AssertionError("edf_ladder: profiled calls not counted")
            row["profiled_events"] = trace_count(prof, "edf_ladder", 3,
                                                 "three ladder calls")
            if prof["device_events"] != row["profiled_events"]:
                raise AssertionError(f"edf_ladder: three calls ran "
                                     f"{prof['counts']} (one kernel a call)")
        rows.append(row)
        log(f"[kernels] edf_ladder_hists ({L}, {n}): bit-equal, "
            f"ms={row['ms']:.4g}, device_ms={row['device_ms']:.4g}, "
            f"plain_ms={row['plain_ms']:.4g}, bound_ms={row['bound_ms']:.4g}")
    # a base one element off a 16-byte boundary: every layer's bulk part
    # starts elsewhere
    base = torch.randn(3 * 65541 + 1, generator=gen, device=dev) * 0.02
    w = base[1:].view(3, 65541)
    r = torch.tensor([150, 64, 101], dtype=torch.int32, device=dev)
    same(w, edf_inputs(torch, w), r, "(3, 65541) off 4 bytes")
    # a layer with a NaN counts nothing, the other its counts
    w = torch.randn(2, 4096, generator=gen, device=dev) * 0.02
    w[1, 1234] = float("nan")
    got = same(w, edf_inputs(torch, w[:1]).expand(2, T), r[:2], "NaN layer")
    if bool(got[1].any()) or not bool((got[0].sum(dim=1) == 4096).all()):
        raise AssertionError("edf_ladder: the NaN layer")
    for case in pathological(torch):
        w = case.to(dev).reshape(1, -1)
        fls = edf_inputs(torch, w)
        for rr in (50, 150):
            same(w, fls, torch.tensor([rr], dtype=torch.int32, device=dev),
                 "on pathological values")
    log("[kernels] edf_ladder_hists ragged sizes, misaligned base, extremes, "
        "NaN layer and pathological values: bit-equal; "
        f"repeats bit-equal: {rows[0]['repeats_bit_equal']}, one kernel "
        f"event a call ({rows[0]['profiled_events']} of 3)")
    return rows


# ---------------------------------------------------------------------------
# Phases 4 and 5


def plan_counts(m):
    """What one forward of ``m`` runs and quantizes, from its layer plan:
    (``fxp_matmul`` calls of a packed forward under ``quant.use_pallas``,
    flash-attention layers, stacked quantized leaves, flat ones). A
    layer's four attention projections (zamba2's shared block's in every
    period; a cross slot's wq, its wk and wv on the image memory, its wo),
    a mamba layer's in_proj and out_proj, a gated MLP's three, an MoE
    layer's dense residual's three (arctic; the experts are library
    products over dequantized words), an encoder's in_proj, and the head
    unless it is tied (a library product over the dequantized embedding).
    A cross slot attends in the plain attention, as the reference's does
    under ``use_pallas`` too. The stacked leaves: a slot's attention
    projections, its MLP's or its MoE layer's expert stacks and residual,
    a mamba slot's in_proj, conv_w and out_proj; the flat ones: the
    embedding (an encoder's in_proj), the head, a mamba slot's d_skip (one
    ⟨WL,FL⟩ per tensor) and every leaf of the shared block. The router,
    the norms and the SSM dynamics are not quantized."""
    from repro_torch.models import transformer
    plan, periods = transformer.build_plan(m)
    dense = attn = stacked = 0
    flat = 1 + int(not m.tie_embeddings)
    for slot in plan:
        if slot.kind == "mamba":
            dense, stacked, flat = dense + 2 * periods, stacked + 3, flat + 1
            continue
        ffn = {"mlp": 3, "moe": 3 if m.dense_residual_d_ff else 0,
               "none": 0}[slot.ffn]
        leaves = 4 + {"mlp": 3, "moe": 3 + ffn, "none": 0}[slot.ffn]
        attn += periods if slot.kind == "attn" else 0
        dense += (4 + ffn) * periods
        if slot.shared:
            flat += leaves
        else:
            stacked += leaves
    return (dense + int(not m.tie_embeddings) + int(m.is_encoder), attn,
            stacked, flat)


def memory_calls(m):
    """``fxp_matmul`` calls of a packed forward on a VLM's f32 image memory
    (each cross layer's wk and wv): the SIMT branch, as the decode step
    reads them from its cache and calls neither. In training the memory
    needs no gradient, so they run no ``matmul_dx``, and their f32
    ``matmul_dw`` runs on the SIMT branch too."""
    from repro_torch.models import transformer
    plan, periods = transformer.build_plan(m)
    return 2 * periods * sum(slot.kind == "cross" for slot in plan)


def fxp_per_forward(m):
    """``fxp_matmul`` calls of one packed forward under ``quant.use_pallas``
    (``plan_counts``)."""
    return plan_counts(m)[0]


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


def engine_run(torch, fm, fa, eng, prompts, tag, packed=True, memory=None):
    """Phase 4's serving check, shared by every ``Engine`` run:
    ``generate`` on ``prompts`` (``NEW`` new tokens, greedy; a VLM's with
    its image ``memory``) with every count set to 0 just before and read
    just after. Each prefill and decode call's launches are exact: with
    the packed container the prefill's dense layers on the tensor cores
    (a VLM's memory projections on the f32 SIMT branch), its head and
    every decode call on the GEMV; one flash launch a self-attention layer
    in the prefill; with a float container the flash launches alone.
    Tokens in range, logits finite and not constant; then the same run
    warm. Returns (record, tokens, logits) of the first run."""
    m = eng.cfg.model
    L = plan_counts(m)[1]                 # attention layers
    per_fwd = fxp_per_forward(m) if packed else 0
    mem = memory_calls(m) if packed else 0        # the prefill's alone
    per_dec = per_fwd - mem
    head = int(packed and not m.tie_embeddings)   # the head's GEMV call
    record = []
    instrument(eng, torch, fm, fa, record)
    ws = wrappers()
    reset_counts(ws)
    t0 = time.perf_counter()
    out, logits = eng.generate(prompts, NEW, memory=memory)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in ws.items() if w.launches}
    gemv = head + per_dec * (NEW - 1) if packed else 0
    check_tensor_cores(tag, launches, gemv=gemv, simt={"fxp_matmul": mem})
    want = {**({"flash_attention": L} if L else {}),
            **({"fxp_matmul": per_fwd + per_dec * (NEW - 1)} if packed
               else {})}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want}")
    per_call = {"prefill": (per_fwd, L, per_fwd - head - mem, head),
                "decode": (per_dec, 0, 0, per_dec)}
    if record[0]["kind"] != "prefill" or len(record) != NEW:
        raise AssertionError(f"{tag}: unexpected step record {record}")
    for r in record:
        if (r["fxp"], r["flash"], r["fxp_tc"], r["fxp_gemv"]) != \
                per_call[r["kind"]]:
            raise AssertionError(f"{tag} {r['kind']}: launches {r} != "
                                 f"{per_call[r['kind']]}")
    if out.shape != (prompts.shape[0], NEW) or int(out.min()) < 0 or \
            int(out.max()) >= m.vocab_size:
        raise AssertionError(f"{tag}: tokens out of range: {out}")
    if not bool(torch.isfinite(logits).all()) or float(logits.std()) == 0.0:
        raise AssertionError(f"{tag}: logits not finite or constant")
    cold = step_times(record)
    record.clear()
    t0 = time.perf_counter()
    eng.generate(prompts, NEW, memory=memory)
    torch.cuda.synchronize()
    warm = step_times(record, total_s=time.perf_counter() - t0)
    for name, r in (("cold", cold), ("warm", warm)):
        log(f"[{tag}] {name}: prefill {r['prefill_ms']:.2f} ms, decode "
            f"{r['decode_ms_per_step']:.2f} ms/step, "
            f"{r['decode_tokens_per_s']:.1f} tok/s decode")
    return ({"cold": {**cold, "total_s": total_s,
                      "tokens_per_s": BATCH * NEW / total_s},
             "warm": warm, "launches": launches,
             "sample": [int(t) for t in out[0][:16]]}, out, logits)


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
    torch.cuda.reset_peak_memory_stats()
    # the same run twice (cold, then warm: every PyTorch kernel loaded),
    # then a profiled prefill and 8 profiled decode steps for the breakdown
    res, _, logits = engine_run(torch, fm, fa, eng, prompts, "main")
    launches = res["launches"]
    per_fwd = 7 * N_LAYERS + 1
    res.update({"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "logits_std": float(logits.std()),
                "profile": profile_steps(torch, eng, prompts)})
    dec = res["profile"]["decode_8_steps"]
    if dec["gemv_finish_launches"] or dec["memsets"]:
        raise AssertionError(
            f"profiled decode: {dec['gemv_finish_launches']} finish kernels "
            f"and {dec['memsets']} memsets (want one kernel a call)")
    trace_count(dec, "fxp_matmul_gemv", 8 * per_fwd, "profiled decode")
    for name in ("cold", "warm"):
        r = res[name]
        log(f"[main] {name}: {r['tokens_per_s']:.1f} tok/s end to end")
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
    is a lower bound). The profiler kept no record of the first kernels
    it saw, 0 to 42 a window on the H100 (the launches left without a
    device event were each window's first: the embedding's gather of a
    prefill or decode, the quantize at the start of a step, all 9 float SR
    kernels of a float32 step), so spin kernels go first and take that
    loss; the breakdown leaves them out."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.01)
        with record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    groups, counts, n = {}, {}, 0
    lost = profiler_lost(prof)
    if lost and lost["n"]:
        log(f"[trace] the profiler recorded no device event for {lost['n']} "
            f"launch calls of this window (issued by {', '.join(lost['ops'])})")
    for e in prof.events():
        # the spin kernels and the window's own range on the device's
        # timeline are not the window's work
        if (not str(e.device_type).endswith("CUDA") or "spin_kernel" in e.name
                or e.name == WINDOW):
            continue
        n += 1
        name = e.name
        for key in ("fxp_qmatmul", "matmul_qdx", "fxp_matmul_gemv",
                    "fxp_matmul_finish", "fxp_matmul", "flash_fwd",
                    "matmul_dx", "matmul_dw", "flash_dq", "flash_dkv",
                    "sr_grid_kernel", "sr_kernel", "edf_ladder", "nvjet",
                    "gemm", "Memset", "Memcpy"):
            if key in name:
                name = key
                break
        else:
            name = name[:48]
        groups[name] = groups.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
        counts[name] = counts.get(name, 0) + 1
    busy = sum(groups.values())
    top = dict(sorted(groups.items(), key=lambda kv: -kv[1])[:12])
    gemms = sorted({e.key for e in prof.key_averages() if e.key in LIBRARY_GEMMS})
    sites, site_kernels, site_kernels_n = library_sites_of(prof)
    return {"wall_ms": wall_ms, "device_events": n, "busy_ms": busy,
            "busy_share": busy / wall_ms if n else None, "groups_ms": top,
            "groups_n": {k: counts[k] for k in top}, "library_gemm_ops": gemms,
            "all_groups_ms": groups,
            "counts": counts, "lost_launches": lost,
            "library_gemm_sites": sites, "site_kernels_ms": site_kernels,
            "site_kernels_n": site_kernels_n,
            "gemv_launches": counts.get("fxp_matmul_gemv", 0),
            "memsets": counts.get("Memset", 0),
            "gemv_finish_launches": counts.get("fxp_matmul_finish", 0)}


def site_of(p, e):
    """The site that host event ``p`` names for the library GEMM op ``e``
    inside it, else "unattributed"."""
    if p.name.startswith(SITE):
        return p.name[len(SITE):]
    if BACKWARD in p.name:
        return ("experts (backward)" if e.name in BATCHED_GEMMS
                else "router or tied head (backward)")
    return "unattributed"


def parents_of(e):
    names, p = [], e.cpu_parent
    while p is not None:
        names.append(p.name[:48])
        p = p.cpu_parent
    return names


def library_sites_of(prof):
    """Each library GEMM op of a profiled window by the call site that
    called it: a ``SITE`` range that ``library_sites`` opens around the
    router, the expert products and the tied head, or the backward of the
    autograd Function that those sites run (``common._PlainDense``, which
    in the packed paths of phases 22-23 only they reach: its batched
    GEMMs are the experts', its others the router's or the tied head's);
    "unattributed" for any other. Also
    the device ms and the count of the kernels launched inside each
    ``SITE`` range, by kernel. Returns ({site: {op: events}}, {site:
    {kernel: ms}}, {site: {kernel: events}})."""
    sites, kernels, counts = {}, {}, {}
    host = [e for e in prof.events()
            if not str(e.device_type).endswith("CUDA")]
    # the events that name a site, for an op whose parent link the
    # profiler lost (seen once in 416 einsums): nesting by time on its thread
    namers = [x for x in host if x.name.startswith(SITE) or BACKWARD in x.name]
    if not any(x.name.startswith(SITE) for x in namers):
        namers = []                       # no ``library_sites`` window
    by_time = {}
    for e in host:
        if e.name.startswith(SITE):
            into = kernels.setdefault(e.name[len(SITE):], {})
            n = counts.setdefault(e.name[len(SITE):], {})
            stack = [e]
            while stack:
                x = stack.pop()
                stack.extend(x.cpu_children)
                for k in x.kernels:
                    into[k.name[:48]] = into.get(k.name[:48], 0.0) \
                        + k.duration / 1e3
                    n[k.name[:48]] = n.get(k.name[:48], 0) + 1
        if e.name not in LIBRARY_GEMMS:
            continue
        site, p = "unattributed", e.cpu_parent
        while p is not None and site == "unattributed":
            site = site_of(p, e)
            p = p.cpu_parent
        around = [x for x in namers if site == "unattributed"
                  and x.thread == e.thread
                  and x.time_range.start <= e.time_range.start
                  and e.time_range.end <= x.time_range.end]
        if around:
            site = site_of(max(around, key=lambda x: x.time_range.start), e)
            key = f"{e.name} under {parents_of(e)}: {site}"
            by_time[key] = by_time.get(key, 0) + 1
        ops = sites.setdefault(site, {})
        ops[e.name] = ops.get(e.name, 0) + 1
    if by_time:
        log(f"[sites] library GEMM ops with no site among their parents, "
            f"placed by time on their thread: {by_time}")
    return sites, kernels, counts


def profiler_lost(prof):
    """The kernel launch calls of the profiled window (the
    ``cudaLaunchKernel*`` and ``cuLaunchKernel*`` records inside
    ``WINDOW``) whose correlation id
    has no device event: kernels that ran but that the profiler did not
    record. Returns their count and, for up to 8 of them, the innermost
    host op that issued each (by time, on its thread; "?" for a launch
    from outside any op, as the port's wrappers make); None where this
    torch's profiler does not expose the correlation ids."""
    try:
        calls, seen, ops, window = {}, set(), [], (0, -1)
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if str(e.device_type()).endswith("CUDA"):
                seen.add(e.correlation_id())
            elif name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
                calls[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
            elif name == WINDOW:
                window = (e.start_ns(), e.end_ns())
            elif not name.startswith(("cuda", "cu")):
                ops.append((e.start_ns(), e.end_ns(), e.start_thread_id(), name))
    except (AttributeError, RuntimeError):
        return None
    lost = sorted(v for c, v in calls.items()
                  if c not in seen and window[0] <= v[0] <= window[1])
    by = []
    for t, tid in lost[:8]:
        inner = [o for o in ops if o[2] == tid and o[0] <= t <= o[1]]
        by.append(min(inner, key=lambda o: o[1] - o[0])[3] if inner else "?")
    return {"n": len(lost), "ops": by}


def trace_count(prof, key, counted, what):
    """The trace's events of kernel group ``key`` against the wrapper's
    exact launch count: an extra event fails (a second kernel a call); fewer
    are launches the profiler did not record, logged with the trace's own
    count of launch calls left without a device event. Returns the events."""
    seen = prof["counts"].get(key, 0)
    if seen > counted:
        raise AssertionError(f"{what}: {seen} {key} events for {counted} "
                             "launches")
    if seen < counted:
        lost = prof["lost_launches"]
        log(f"[trace] {what}: {seen} {key} events for {counted} counted "
            "launches; the profiler recorded no device event for "
            + (f"{lost['n']} of the trace's launch calls (issued by "
               f"{', '.join(lost['ops'])})" if lost else "some launches "
               "(correlation ids not exposed)"))
    return seen


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


def drive(eng, prompt, steps, feed=None, memory=None):
    """Prefill (a VLM's with its image ``memory``) + ``steps`` decode steps
    through the engine's step functions; the decode tokens are ``feed``
    (teacher forcing) or the greedy choice. Returns (per-step logits on
    the CPU, tokens fed)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve import engine as engine_mod
    B, S = prompt.shape
    caches = transformer.init_caches(eng.cfg.model, B, S + steps + 1,
                                     device=eng.device)
    with torch.inference_mode():
        logits, pref = eng._prefill(eng.qparams, prompt, memory)
        caches = engine_mod._merge_prefill_caches(caches, pref, S)
        outs, toks = [logits.float().cpu()], []
        for i in range(steps):
            tok = (feed[i].to(eng.device) if feed is not None
                   else engine_mod.sample(logits))
            toks.append(tok.cpu())
            logits, caches = eng._decode(eng.qparams, tok, caches, S + i)
            outs.append(logits.float().cpu())
    return outs, toks


def card_vs_cpu(torch, cfg=None, tag="depth2"):
    """Depth 2 at full width (or ``cfg``), the same weights (drawn on the
    card, copied to the CPU). Tolerance, as in the CPU parity tests: bf16 activations round
    f32 sums taken in different orders, and decode attention multiplies
    probabilities by V in bf16 on the card and in f32 on the CPU, so logits
    are held within 2^-5 of the largest logit (four bf16 ulps there);
    greedy tokens must agree wherever the CPU's top-1/top-2 margin exceeds
    twice that. A VLM's prompt comes with an N(0, 1) image memory."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine

    if cfg is None:
        cfg = load_config("llama3.2-3b",
                          overrides=OVERRIDES + ["model.num_layers=2"])
    params = transformer.init_params(SEED, cfg.model, device="cuda")
    cpu_params = to_device(params, "cpu")
    engines = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        engines[dev] = Engine(cfg, p, controller.init_adapt_state(p, cfg.quant),
                              device=dev)
    del params, cpu_params
    gen = torch.Generator().manual_seed(SEED + 2)
    m = cfg.model
    prompt = torch.randint(0, m.vocab_size, (2, 32), generator=gen)
    memory = (torch.randn((2, m.num_image_tokens, m.d_model), generator=gen)
              if m.cross_attn_every else None)
    t0 = time.perf_counter()
    cpu_logits, cpu_toks = drive(engines["cpu"], prompt, 4, memory=memory)
    cpu_s = time.perf_counter() - t0
    gpu_logits, _ = drive(engines["cuda"], prompt.cuda(), 4, feed=cpu_toks,
                          memory=None if memory is None else memory.cuda())
    worst, agreed, gated = 0.0, 0, 0
    for step, (c, g) in enumerate(zip(cpu_logits, gpu_logits)):
        tol = 2.0 ** -5 * c.abs().max().item()
        err = (c - g).abs().max().item()
        worst = max(worst, err / tol)
        if err > tol or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag} step {step}: |cpu-card| {err} > {tol}")
        top2 = torch.topk(c, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
        same = c.argmax(-1) == g.argmax(-1)
        if not bool(same[sure].all()):
            raise AssertionError(f"{tag} step {step}: greedy tokens differ "
                                 "where the margin allows no tie")
        agreed += int(same.sum())
        gated += int(sure.sum())
    res = {"worst_err_over_tol": worst, "tokens_agreeing": agreed,
           "tokens_checked": 2 * len(cpu_logits), "tokens_past_margin": gated,
           "cpu_s": cpu_s}
    log(f"[{tag}] card vs CPU: worst |err|/tol {worst:.3f}, greedy tokens "
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


def check_tensor_cores(tag, launches, gemv=0, simt=None):
    """Every flash forward, dq and dkv, ``matmul_dx``, ``matmul_dw``,
    ``fxp_qmatmul``, ``matmul_qdx`` and ``fxp_matmul`` at M > 16 of a main
    path's run (bf16 activations) took the tensor-core branch, and the
    ``gemv`` launches of ``fxp_matmul`` at M <= 16 (decode, the prefill's
    head) its GEMV: the wrappers' ``tc_launches`` and ``gemv_launches``, set
    to 0 with ``launches`` just before the run, account for every launch.
    ``simt`` maps a kernel to how many of its launches took its SIMT
    branch instead (gemma2's flash backward at D = 256, a VLM's f32 memory
    projections)."""
    ws = wrappers()
    simt = simt or {}
    for name in TC_KERNELS:
        if name not in launches:
            continue
        want = launches[name] - simt.get(name, 0) - (
            gemv if name == "fxp_matmul" else 0)
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
    """One train step at depth 2, full width (the vocabulary cut to 8192:
    ``DEPTH2_VOCAB``), batch 2 x 64, with activation quantization on (the main path's packed step) and one with it off: the
    same state (drawn on the card, copied to the CPU) and batch, kernels on
    the card and plain versions on the CPU. Both sides round after every
    op and only sum in other orders, so loss is held to rtol 2e-3,
    grad_norm to 2e-2 and every leaf's update to 2e-2 normwise, the CPU
    tests' bounds for a first step from the same params. With activation
    quantization on, the int8 activation words turn a one-ulp flip before
    the last slot's quantization into a whole quantization step, which
    the final norm and the head see first and directly, so those two
    leaves are held to 5e-2 there."""
    from repro_torch.config import load_config
    from repro_torch.train import train_loop

    res = {}
    for name, extra, loose in (("act_quant_on", [], ("final_norm", "head")),
                               ("act_quant_off",
                                ["quant.quantize_activations=false"], ())):
        cfg = load_config("llama3.2-3b", overrides=TRAIN_OVERRIDES + [
            "model.num_layers=2", DEPTH2_VOCAB, "train.global_batch=2",
            "train.seq_len=64"] + extra)
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
    ladder = wrappers()["edf_ladder_hists"]
    calls = ladder.launches
    sw_prof = device_breakdown(torch, one_switch)
    calls = ladder.launches - calls
    if calls != PER_SWITCH["edf_ladder_hists"]:
        raise AssertionError(f"profiled switch: {calls} ladder calls")
    # one kernel a ladder call: its own events, no conversion kernel
    sw_prof["edf_ladder_events"] = trace_count(sw_prof, "edf_ladder", calls,
                                               "profiled switch")
    if any("to_f32" in k or "edf" in k for k in sw_prof["counts"]
           if k != "edf_ladder"):
        raise AssertionError(f"profiled switch: a second ladder kernel in "
                             f"{sorted(sw_prof['counts'])}")
    log(f"[sr] switch alone: wall {walls[0]:.1f} / {walls[1]:.1f} ms; "
        f"profiled wall {sw_prof['wall_ms']:.1f} ms, device busy "
        f"{sw_prof['busy_ms']:.2f} ms, {sw_prof['edf_ladder_events']} ladder "
        f"kernels for {calls} calls, {sw_prof['memsets']} memsets; by "
        "kernel: " + ", ".join(f"{k} {v:.2f}"
                               for k, v in sw_prof["groups_ms"].items()))

    step_fn = train_loop.make_train_step(cfg)
    batch = train_loop.make_batch(cfg, SR_STEPS, device="cuda")

    def one_step():
        box["state"], box["metrics"] = step_fn(box["state"], batch,
                                               step=SR_STEPS)

    prof = device_breakdown(torch, one_step)
    if prof["library_gemm_ops"]:
        raise AssertionError(f"library GEMMs in the SR step: "
                             f"{prof['library_gemm_ops']}")
    prof["sr_events"] = trace_count(prof, "sr_kernel", N_STACKED + N_FLAT,
                                    "profiled SR step")
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


def run_steps(torch, tag, cfg, state, steps, per_step, per_switch=None,
              simt=None):
    """``train_loop.train`` for ``steps`` steps from ``state`` with every
    count set to 0 just before and read just after: exact launches per
    step (``per_step``, plus ``per_switch``, by default ``PER_SWITCH``,
    after a switch step), finite loss and grad_norm. Returns (state,
    per-step records, launches, peak GiB)."""
    per_switch = PER_SWITCH if per_switch is None else per_switch
    tokens = cfg.train.global_batch * cfg.train.seq_len
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
    check_tensor_cores(tag, launches, simt=simt)
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
                    "tokens_per_s": tokens / h["dt"],
                    "loss": h["loss"], "grad_norm": h["grad_norm"]})
        log(f"[{tag}] step {h['step']}{' + switch' if switch else ''}: "
            f"{h['dt'] * 1e3:.1f} ms, {tokens / h['dt']:.0f} "
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
    from repro_torch.serve.engine import Engine, serving_adapt_state
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
    prof["sr_grid_events"] = trace_count(prof, "sr_grid_kernel",
                                         N_STACKED + N_FLAT,
                                         "profiled float32 step")
    log(f"[profile] float32 train step: wall {prof['wall_ms']:.1f} ms, device "
        f"busy {prof['busy_ms']:.1f} ms (share {prof['busy_share']:.3f}), "
        f"{prof['sr_grid_events']} float SR kernels, library GEMMs "
        f"{prof['library_gemm_ops']}; by kernel: "
        + ", ".join(f"{k} {v:.1f}" for k, v in prof["groups_ms"].items()))
    res = {"float32": {"steps": steps, "launches": launches, "peak_gib": peak,
                       "wlfl_before": before, "wlfl_after": after,
                       "switch_wall_ms": walls, "profile": prof}}

    # serving from the trained float32 container
    params, adapt = state["params"], serving_adapt_state(state["adapt"])
    del state
    torch.cuda.empty_cache()
    eng = Engine(load_config("llama3.2-3b", overrides=FLOAT_OVERRIDES),
                 params, adapt, device="cuda")
    del params, adapt
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    prompts = torch.randint(0, VOCAB, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    torch.cuda.reset_peak_memory_stats()
    serve, _, _ = engine_run(torch, fm, fa, eng, prompts, "float32 serving",
                             packed=False)
    res["serve_float32"] = {
        **serve, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[float32] Engine: peak {res['serve_float32']['peak_gib']:.2f} GiB")
    del eng
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


def step_card_vs_cpu(torch, tag, overrides, seed, loose, batch=2, cfg=None):
    """One train step at depth 2, full width (the vocabulary cut to 8192),
    ``batch`` x 64 (2 x 64 by default), or of ``cfg``, from the same
    state (drawn on the card, copied to the CPU) and batch: loss within
    rtol 2e-3, grad_norm within 2e-2 and every leaf's update within 2e-2
    normwise (``loose`` leaves, which activation quantization makes see
    one-ulp flips as whole steps first, within 5e-2), the slice-2 bounds
    of a first step. Returns (card state after the step, the CPU copy of
    the state before it, the config, the record)."""
    from repro_torch.config import load_config
    from repro_torch.train import train_loop

    if cfg is None:
        cfg = load_config("llama3.2-3b", overrides=overrides + [
            "model.num_layers=2", DEPTH2_VOCAB, f"train.global_batch={batch}",
            "train.seq_len=64"])
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
    seeds. Path B's step, card against CPU, is phase 16's: 2 microbatches
    of 4 x 64 under full remat run the same kernels at M = 256."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.core import fixed_point as fxp
    from repro_torch.train import train_loop
    cfg = load_config("llama3.2-3b", overrides=PROLOGUE_OVERRIDES + [
        "model.num_layers=2", "train.global_batch=2", "train.seq_len=64"])
    gpu = train_loop.init_state(cfg, SEED + 23, device="cuda")
    before = to_device(gpu, "cpu")
    r = {}
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
    log(f"[depth2] prologue: the views of {leaves} prologue leaves bit-equal "
        "(the step: phase 16)")
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
    if ws["int8_matmul"].tc_launches != OPS_PATH["int8_matmul"]:
        raise AssertionError(f"ops path: {ws['int8_matmul'].tc_launches} of "
                             f"{OPS_PATH['int8_matmul']} int8_matmul launches "
                             "on the tensor cores")
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


@contextlib.contextmanager
def card_av():
    """The plain attention's AV product in v's own dtype on the CPU too,
    as on the card (``attention.av_dtype``; the reference takes f32 on the
    CPU): the card-against-CPU comparisons then hold two sides that round
    alike and sum in other orders."""
    from repro_torch.models import attention
    inner = attention.av_dtype
    attention.av_dtype = lambda v: v.dtype
    try:
        yield
    finally:
        attention.av_dtype = inner


def default_card_vs_cpu(torch):
    """Phase 14's configuration at depth 2, full-width layers and a
    vocabulary of 8192 (``DEFAULT_DEPTH2_CUTS``): one step from the same
    state on the card and on the CPU; the quantized copy each step read
    (captured from ``train_loop._quantized_copy``) bit-equal, since
    threefry is integer arithmetic and the quantize exact-rounded f32;
    the step within
    the slice-2 bounds; then, after a second step on the card (every window
    of two closes), the same state through ``precision_switch`` on both:
    identical. The plain attention of this path takes its AV product in
    bf16 on the card and in f32 on the CPU (``attention.av_dtype``, the
    reference's choice by backend); the slice-2 bounds hold two sides that
    round alike and sum in other orders, so for this step the CPU takes the
    card's bf16 AV product."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.train import train_loop
    seen = []
    inner = train_loop._quantized_copy

    def capture(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(out)
        return out

    train_loop._quantized_copy = capture
    try:
        with card_av():
            gpu, _, cfg, r = step_card_vs_cpu(
                torch, "default", DEFAULT_OVERRIDES, SEED + 31,
                ("final_norm", "head"), cfg=load_config(
                    "llama3.2-3b", overrides=DEFAULT_OVERRIDES
                    + DEFAULT_DEPTH2_CUTS))
    finally:
        train_loop._quantized_copy = inner
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


# ---------------------------------------------------------------------------
# Phases 16-18: remat and accumulation, the registry's config, checkpoints


def counted_step(torch, tag, cfg, state, batch, step, want, held=0):
    """One ``train_step`` with every count set to 0 just before and read
    just after: exact launches ``want``, each on the branch the earlier
    phases require; host clock around the synchronised step, peak memory
    less the ``held`` bytes the caller keeps on the card for a comparison.
    Returns (state, metrics as floats, record)."""
    from repro_torch.train import train_loop
    ws = wrappers()
    step_fn = train_loop.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ws)
    t0 = time.perf_counter()
    state, m = step_fn(state, batch, step=step)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: w.launches for k, w in ws.items()}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want}")
    check_tensor_cores(tag, launches)
    m = {k: float(v) for k, v in m.items()}
    if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
            and m["grad_norm"] > 0):
        raise AssertionError(f"{tag}: {m}")
    tokens = batch["tokens"].numel()
    rec = {"ms": dt * 1e3, "tokens_per_s": tokens / dt, **m,
           "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
           "launches": launches}
    log(f"[{tag}] {dt * 1e3:.1f} ms, {tokens / dt:.0f} tokens/s, loss "
        f"{m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, peak "
        f"{rec['peak_gib']:.2f} GiB")
    return state, m, rec


def step_outputs(state):
    """What a step writes: the master params and the controller's
    "grad_sum", by path."""
    out = {f"params/{p}": t for p, t in flat_paths(state["params"]).items()}
    for path, ts in state["adapt"]["tensors"].items():
        out[f"grad_sum/{path}"] = ts["grad_sum"]
    return out


def remat_accum_path(torch):
    """Phase 16 on llama3.2-3b at full width and depth, int8_packed words
    with SR under ``quant.use_pallas``, FL 10. (a) One step of 4 x 512 from
    the same state and batch under remat none, full and selective: exact
    launches (the layers' forward kernels twice under full and selective),
    the updated params, "grad_sum", loss and grad_norm bit-equal across
    the three, the peak memory of each, full's below none's. (b) 8 x 512
    in 8 microbatches of 1 x 512 under full remat: the first step alone,
    its loss and params within 5e-3 of one step of the same rows with
    accum_steps=1 (remat full), then two more through ``train_loop.train``
    with a switch after step 2, exact launches per step and switch, step
    ms, tokens/s, peak memory."""
    from repro_torch.config import load_config
    from repro_torch.train import train_loop

    from repro_torch.models import transformer

    # the first checkpointed call sets torch.utils.checkpoint up (imports,
    # about 4 s on the card's host); it is no step's time
    x = torch.ones(8, 8, device="cuda", requires_grad=True)
    for remat in ("full", "selective"):
        torch.autograd.grad(transformer._remat(lambda t: t @ t, remat)(x).sum(),
                            x)
    res = {"modes": {}}
    base = load_config("llama3.2-3b", overrides=REMAT_OVERRIDES)
    assert base.quant.stochastic_rounding and base.quant.use_pallas
    batch = train_loop.make_batch(base, 0, device="cuda")
    first, held = None, 0
    for remat in ("none", "full", "selective"):
        cfg = load_config("llama3.2-3b",
                          overrides=REMAT_OVERRIDES + [f"train.remat={remat}"])
        state = train_loop.init_state(cfg, SEED + 41, device="cuda")
        state, m, rec = counted_step(
            torch, f"remat {remat}", cfg, state, batch, 0,
            SR_PER_STEP if remat == "none" else REMAT_STEP, held)
        out = step_outputs(state)
        if first is None:
            first = {"m": m, "out": {k: t.clone() for k, t in out.items()}}
            held = sum(t.numel() * t.element_size()
                       for t in first["out"].values())
        else:
            if m != first["m"]:
                raise AssertionError(f"remat {remat}: metrics {m} != remat "
                                     f"none's {first['m']}")
            for path, t in out.items():
                if not torch.equal(t, first["out"][path]):
                    raise AssertionError(f"remat {remat}: {path} differs "
                                         "from remat none's")
        res["modes"][remat] = rec
        del state, out
        torch.cuda.empty_cache()
    del first
    peaks = {k: r["peak_gib"] for k, r in res["modes"].items()}
    if not peaks["full"] < peaks["none"]:
        raise AssertionError(f"remat full's peak is not below none's: {peaks}")
    log(f"[remat] none, full and selective: params, grad_sum, loss and "
        f"grad_norm bit-equal; peaks {peaks} GiB")

    # (b) accumulation: the same rows in one batch, then in 8 microbatches
    one = load_config("llama3.2-3b",
                      overrides=ACCUM_OVERRIDES + ["train.accum_steps=1"])
    cfg = load_config("llama3.2-3b", overrides=ACCUM_OVERRIDES)
    batch = train_loop.make_batch(cfg, 0, device="cuda")
    state = train_loop.init_state(one, SEED + 43, device="cuda")
    state, m1, rec1 = counted_step(torch, "accum 1", one, state, batch, 0,
                                   REMAT_STEP)
    want = {k: t.clone() for k, t in flat_paths(state["params"]).items()}
    held = sum(t.numel() * t.element_size() for t in want.values())
    del state
    torch.cuda.empty_cache()
    state = train_loop.init_state(cfg, SEED + 43, device="cuda")
    state, m8, rec8 = counted_step(torch, "accum 8", cfg, state, batch, 0,
                                   ACCUM_PER_STEP, held)
    loss_diff = abs(m8["loss"] - m1["loss"])
    got = flat_paths(state["params"])
    param_diff = max(float((got[k] - w).abs().max()) for k, w in want.items())
    if not (loss_diff < ACCUM_ABS and param_diff < ACCUM_ABS):
        raise AssertionError(f"accum 8 vs 1: loss {loss_diff}, params "
                             f"{param_diff} (bound {ACCUM_ABS})")
    log(f"[accum] 8 microbatches vs one batch of 8 x {TRAIN_S}: loss diff "
        f"{loss_diff:.3g}, max |param diff| {param_diff:.3g} (bound "
        f"{ACCUM_ABS})")
    del want, got
    torch.cuda.empty_cache()
    state, steps, launches, peak = run_steps(
        torch, "accum", cfg, state, ACCUM_STEPS - 1, ACCUM_PER_STEP)
    res.update(accum_1=rec1, accum_8_first=rec8, accum_8_steps=steps,
               accum_8_launches=launches, accum_8_peak_gib=peak,
               accum_loss_diff=loss_diff, accum_param_diff=param_diff)
    del state
    torch.cuda.empty_cache()
    return res


def remat_accum_card_vs_cpu(torch):
    """Phase 16 (c): one step at depth 2, batch 8 x 64, remat full and
    accum_steps=2 (microbatches of 4 x 64), on the card and on the CPU from
    the same state, through the quantize prologue (which stands for phase
    13's step), within phase 7's bounds. The CPU's time is the script's
    largest; the packed path's step at depth 2 is phase 7's, and this one
    draws the prologue's words once a microbatch and a pass, so it takes
    two microbatches, not four."""
    out = {}
    extra = ["train.remat=full", "train.accum_steps=2"]
    for tag, ov, seed in (("prologue", OVERRIDES + ["quant.dense_prologue=true"],
                           SEED + 47),):
        gpu, _, _, r = step_card_vs_cpu(torch, f"remat+accum {tag}", ov + extra,
                                        seed, ("final_norm", "head"), batch=8)
        out[tag] = r
        del gpu
        torch.cuda.empty_cache()
    return out


def registry_path(torch, arch="llama3.2-3b", cuts=()):
    """Phase 17 (and 21 for smollm-360m, 23 for arctic-480b with its
    ``cuts``): ``get_config(arch)`` with only the batch (8) and the
    sequence (512) cut: remat full, 8 microbatches of 1 x 512 summed in the
    registry's accumulator (f32; bf16 for arctic-480b), the QuantConfig
    defaults (float32 container, SR
    from the jax.random stream, no hand-written kernel), 2 steps through
    ``train_loop.train``; the step times from its watchdog and the loss
    from its heartbeat (the config logs every 10th step), no kernel
    launched, finite params, the peak memory."""
    from repro_torch.config import apply_overrides
    from repro_torch.configs import get_config
    from repro_torch.train import train_loop
    from repro_torch.train.fault_tolerance import Heartbeat, StepWatchdog

    cfg = apply_overrides(get_config(arch), REGISTRY_CUTS + list(cuts))
    tag = "registry" if arch == "llama3.2-3b" else f"registry {arch}"
    t, q = cfg.train, cfg.quant
    assert (t.remat, t.accum_steps, t.accum_dtype, q.container_dtype,
            q.stochastic_rounding, q.use_pallas) == (
        "full", 8, "bfloat16" if arch == ARCTIC else "float32", "float32",
        True, False), (t, q)
    t0 = time.perf_counter()
    state = train_loop.init_state(cfg, device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    log(f"[{tag}] init: {time.perf_counter() - t0:.1f} s, {held:.2f} GiB "
        "held")
    ws = wrappers()
    watchdog, beats = StepWatchdog(), []
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ws)
    state, _ = train_loop.train(cfg, steps=REGISTRY_STEPS, state=state,
                                watchdog=watchdog, device="cuda",
                                heartbeat=Heartbeat(0.0, beats.append),
                                log=lambda line: log(f"[{tag}] {line}"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: w.launches for k, w in ws.items()}
    if any(launches.values()):
        raise AssertionError(f"kernel launches under the defaults: {launches}")
    losses = [float(b.rsplit("loss=", 1)[1]) for b in beats]
    finite = all(bool(torch.isfinite(p).all())
                 for p in flat_paths(state["params"]).values())
    if len(losses) != REGISTRY_STEPS or not all(map(math.isfinite, losses)) \
            or not finite or int(state["step"]) != REGISTRY_STEPS:
        raise AssertionError(f"registry config: losses {losses}, params "
                             f"finite {finite}, step {int(state['step'])}")
    tokens = t.global_batch * t.seq_len
    steps = [{"step": i + 1, "ms": dt * 1e3, "tokens_per_s": tokens / dt,
              "loss": loss} for i, (dt, loss) in enumerate(zip(watchdog.times,
                                                               losses))]
    for r in steps:
        log(f"[{tag}] step {r['step']}: {r['ms']:.1f} ms, "
            f"{r['tokens_per_s']:.0f} tokens/s, loss {r['loss']:.4f}")
    log(f"[{tag}] peak device memory {peak:.2f} GiB ({held:.2f} GiB held "
        "by the state), no kernel launched")
    del state
    torch.cuda.empty_cache()
    return {"steps": steps, "peak_gib": peak, "state_gib": held,
            "accum_dtype": t.accum_dtype, "launches": launches}


def checkpoint_path(torch):
    """Phase 18 on ``get_smoke_config("llama3.2-3b")``, int8_packed words
    with SR under ``quant.use_pallas``: 2 steps, an async save, 2 more (a
    switch after each second step); the checkpoint restored into a fresh
    ``init_state`` on the card and the same 2 steps again: params, adapt
    state, opt state and step bit-equal to the uninterrupted run. Then
    ``launch.train --resume`` from that checkpoint to step 6, writing both
    JSONL files, and ``launch.serve --checkpoint-dir`` serving from it."""
    import shutil
    from repro_torch.config import apply_overrides
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.train import train_loop
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.metrics import read_jsonl

    work = ROOT / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(work, ignore_errors=True)
    ckpt, mdir = str(work / "ckpt"), str(work / "metrics")
    cfg = apply_overrides(get_smoke_config("llama3.2-3b"), CKPT_OVERRIDES)
    ws = wrappers()
    reset_counts(ws)

    def run(state, steps):
        return train_loop.train(cfg, steps=steps, state=state, device="cuda",
                                log=lambda line: None)[0]

    state = run(train_loop.init_state(cfg, device="cuda"), 2)
    mgr = CheckpointManager(ckpt, async_save=True)
    mgr.save(state, step=2)
    state = run(state, 2)
    mgr.wait()
    launches = {k: w.launches for k, w in ws.items()}
    for name in ("fxp_matmul", "matmul_dx", "matmul_dw", "flash_attention",
                 "flash_attention_dq", "flash_attention_dkv",
                 "sr_quantize_fused_stacked_int8", "sr_quantize_fused_int8",
                 "edf_ladder_hists"):
        if not launches[name]:
            raise AssertionError(f"checkpoint run: no {name} launch")
    resumed = run(mgr.restore(train_loop.init_state(cfg, SEED + 99,
                                                    device="cuda")), 2)
    a, b = flat_paths(resumed), flat_paths(state)
    if a.keys() != b.keys():
        raise AssertionError("resumed state's leaves differ")
    for path, t in b.items():
        if a[path].dtype != t.dtype or a[path].device != t.device \
                or not torch.equal(a[path], t):
            raise AssertionError(f"resumed run: {path} differs from the "
                                 "uninterrupted run")
    wlfl = wlfl_histogram(state)
    log(f"[checkpoint] 2 steps, async save at step 2, restore into a fresh "
        f"state, 2 steps: {len(b)} leaves bit-equal to the uninterrupted run "
        f"(<WL,FL> {wlfl}); launches {launches}")
    meta = mgr.restore_meta()
    mgr.save(state, step=4)
    mgr.wait()
    argv = ["--arch", "llama3.2-3b", "--smoke"] + sum(
        (["--override", o] for o in CKPT_OVERRIDES), [])
    if train_launcher.main(argv + ["--steps", "2", "--checkpoint-dir", ckpt,
                                   "--resume", "--metrics-dir", mdir]) != 0:
        raise AssertionError("launch.train --resume failed")
    steps = read_jsonl(str(work / "metrics" / "llama3.2-3b.metrics.jsonl"))
    switches = read_jsonl(str(work / "metrics" / "llama3.2-3b.switches.jsonl"))
    if [r["step"] for r in steps if r["kind"] == "step"] != [5, 6] \
            or [r["step"] for r in switches] != [6] \
            or CheckpointManager(ckpt).latest_step() != 6:
        raise AssertionError(f"launch.train --resume: {steps} {switches}")
    if serve_launcher.main(["--arch", "llama3.2-3b", "--smoke",
                            "--checkpoint-dir", ckpt, "--max-new", "4"]
                           + argv[3:]) != 0:
        raise AssertionError("launch.serve --checkpoint-dir failed")
    shutil.rmtree(work, ignore_errors=True)
    del state, resumed
    torch.cuda.empty_cache()
    return {"leaves_bit_equal": len(b), "meta": meta, "wlfl": wlfl,
            "launches": launches, "launcher_steps": len(steps)}


# ---------------------------------------------------------------------------
# Phase 19: the CNN family


def cnn_config(name, extra=(), smoke=False):
    """The registry's config (or its smoke config) of ``name`` with
    ``CNN_OVERRIDES`` and ``extra``."""
    from repro_torch.config import apply_overrides
    from repro_torch.configs import get_config, get_smoke_config
    base = get_smoke_config(name) if smoke else get_config(name)
    return apply_overrides(base, CNN_OVERRIDES + list(extra))


def cnn_perf_model(cfg, state, telemetry):
    """``perf_model.summarize`` (the paper's analytical model, eq. 6–9, not
    a time on the card) over the run's switch snapshots, each standing for
    the ``adapt_interval`` steps it closes; ops^l is ``layer_madds`` times
    the batch, as the reference's ``paper_tables`` takes it."""
    import numpy as np
    from repro_torch.core import perf_model
    from repro_torch.models import cnn
    interval = cfg.train.adapt_interval or cfg.quant.lb_lwr
    tel = []
    for snap in telemetry:
        t = perf_model.StepTelemetry(
            **{field: {k: float(np.mean(v[key])) for k, v in snap.items()}
               for field, key in (("wl", "wl"), ("sp", "sp"), ("lb", "lb"),
                                  ("r", "res"))})
        tel.extend([t] * interval)
    sizes = {p: t.numel() for p, t in flat_paths(state["params"]).items()}
    ops = {k: perf_model.LayerOps(ops=v * cfg.train.global_batch,
                                  params=float(sizes[k]))
           for k, v in cnn.layer_madds(state["params"]).items()}
    return perf_model.summarize(ops, tel, accs=1)


def held_out_accuracy(torch, cfg, state):
    """The reference's ``_eval_acc``: RTN grid values at the final <WL,FL>
    (``quantize_for_serving``), the eval forward on ``CNN_EVAL`` batches
    from step 10000 on, the mean accuracy."""
    from repro_torch.models import cnn
    from repro_torch.serve import engine
    from repro_torch.train import train_loop
    _, fwd = cnn.MODELS[cfg.model.name.replace("-smoke", "")]
    params = engine.quantize_for_serving(state["params"], state["adapt"],
                                         cfg.quant)
    accs = []
    with torch.no_grad():
        for i in range(CNN_EVAL):
            b = train_loop.make_batch(cfg, 10_000 + i, device="cuda")
            logits, _ = fwd(params, state["stats"], b["images"], False)
            accs.append(float(cnn.accuracy(logits, b["labels"])))
    return sum(accs) / len(accs)


def cnn_sr_kernel(cfg):
    """The SR kernel a CNN step launches per quantized leaf under
    ``quant.use_pallas``: int8 words in the int8 container, else float
    grid values (``int8_packed`` is the float32 container for the CNN)."""
    return ("sr_quantize_fused_int8" if cfg.quant.container_dtype == "int8"
            else "sr_quantize_fused")


def cnn_run(torch, tag, cfg):
    """``CNN_STEPS`` steps of ``train_loop.train`` from a fresh state on the
    card, then ``CNN_WINDOW`` more with no switch (the interval set past
    them), every count set to 0 just before the first and read just after
    the last: exact launches per step (under ``quant.use_pallas`` one
    ``cnn_sr_kernel`` launch per quantized leaf, and one ladder launch per
    tensor at a switch; otherwise none), finite loss, accuracy in [0, 1];
    step ms (the switch in the steps that end in one; the window's median,
    min and max), images/s, peak memory, the <WL,FL> histogram before and
    after the first switch, held-out accuracy and the perf model's
    summary."""
    import statistics
    from repro_torch.config import apply_overrides
    from repro_torch.train import train_loop
    leaves = CNN_LEAVES[cfg.model.name]
    pallas = cfg.quant.use_pallas
    per_step = {**ZERO, **({cnn_sr_kernel(cfg): leaves} if pallas else {})}
    per_switch = {"edf_ladder_hists": leaves if pallas else 0}
    ws = wrappers()
    state = train_loop.init_state(cfg, device="cuda")
    before = wlfl_histogram(state)
    marks, telemetry = [], []

    def log_step(line):
        marks.append({k: w.launches for k, w in ws.items()})
        log(f"[cnn] {tag} {line}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ws)
    state, history = train_loop.train(cfg, steps=CNN_STEPS, state=state,
                                      log=log_step, telemetry=telemetry,
                                      device="cuda")
    state, window = train_loop.train(
        apply_overrides(cfg, [f"train.adapt_interval={10 ** 9}"]),
        steps=CNN_WINDOW, state=state, log=log_step, device="cuda")
    launches = {k: w.launches for k, w in ws.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if (len(history) != CNN_STEPS or len(telemetry) != CNN_STEPS // 2
            or len(window) != CNN_WINDOW):
        raise AssertionError(f"{tag}: history {history} {window}")
    images = cfg.train.global_batch
    prev, steps = dict(ZERO), []
    for h, mark in zip(history + window, marks):
        per = {k: mark[k] - prev[k] for k in ws}
        prev = mark
        switch = h["step"] <= CNN_STEPS and h["step"] % 2 == 0
        want = {**per_step, **(per_switch if switch else {})}
        if per != want:
            raise AssertionError(f"{tag} step {h['step']}: launches {per} "
                                 f"!= {want}")
        if not (math.isfinite(h["loss"]) and 0.0 <= h["acc"] <= 1.0
                and h["grad_norm"] > 0):
            raise AssertionError(f"{tag} step {h['step']}: {h}")
        steps.append({"step": h["step"], "ms": h["dt"] * 1e3,
                      "switch": switch, "images_per_s": images / h["dt"],
                      "loss": h["loss"], "acc": h["acc"]})
    finite = all(bool(torch.isfinite(p).all())
                 for p in flat_paths(state["params"]).values())
    if not finite or int(state["step"]) != CNN_STEPS + CNN_WINDOW:
        raise AssertionError(f"{tag}: params finite {finite}, step "
                             f"{int(state['step'])}")
    win = [r["ms"] for r in steps[CNN_STEPS:]]
    rec = {"steps": steps, "peak_gib": peak, "launches": launches,
           "window_ms": {"median": statistics.median(win), "min": min(win),
                         "max": max(win)},
           "wlfl_before": before,
           "wlfl_after_switch": wlfl_histogram(
               {"adapt": {"tensors": telemetry[0]}}),
           "wlfl_end": wlfl_histogram(state)}
    if pallas:
        rec["leaf_shapes"] = leaf_shapes(cfg, state)
        rec["held_out_acc"] = held_out_accuracy(torch, cfg, state)
        rec["perf_model"] = cnn_perf_model(cfg, state, telemetry)
    wm = rec["window_ms"]
    log(f"[cnn] {tag}: {CNN_WINDOW} steps with no switch median "
        f"{wm['median']:.2f} ms ({wm['min']:.2f}-{wm['max']:.2f}; "
        f"{images / wm['median'] * 1e3:.0f} images/s at the median), steps "
        f"2-{CNN_STEPS} " + ", ".join(f"{r['ms']:.1f}" for r in
                                       steps[1:CNN_STEPS])
        + f" ms, peak {peak:.2f} GiB, <WL,FL> {before} -> "
        f"{rec['wlfl_after_switch']} -> {rec['wlfl_end']}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if pallas:
        log(f"[cnn] {tag}: held-out accuracy {rec['held_out_acc']:.4f} "
            f"({CNN_EVAL} batches from step 10000, RTN words at the final "
            "<WL,FL>); the analytical perf model (paper eq. 6-9, not a "
            f"time on the card): "
            + ", ".join(f"{k} {v:.4g}" for k, v in rec["perf_model"].items()))
    del state
    torch.cuda.empty_cache()
    return rec


def leaf_shapes(cfg, state):
    """{kernel: {shape: leaves}}: each quantized leaf's shape (the SR launch
    of a step, ``cnn_sr_kernel``) and its switch input's (the ladder launch of a
    switch: the leaf whole up to ``edf_sample`` elements, else its strided
    subsample of that many), as ``cnn_kernel_shapes`` keys them."""
    params = flat_paths(state["params"])
    sr = cnn_sr_kernel(cfg)
    out = {sr: {}, "edf_ladder_hists": {}}
    for path in state["adapt"]["tensors"]:
        leaf = params[path]
        for kernel, shape in (
                (sr, list(leaf.shape)),
                ("edf_ladder_hists",
                 [1, min(leaf.numel(), cfg.quant.edf_sample)])):
            out[kernel][str(shape)] = out[kernel].get(str(shape), 0) + 1
    return out


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def cnn_kernel_shapes(torch, sq, el):
    """``sr_quantize_fused``, ``sr_quantize_fused_int8`` and
    ``edf_ladder_hists`` against their plain versions, bit for bit, at
    every quantized leaf of both models at full width (CIFAR10 and, for
    ResNet20's fc, CIFAR100): the grid values at <8,4> (the init) and
    <6,9>, the int8 words at FL 4 and 9, the ladder on the switch's input
    (the leaf whole up to ``edf_sample`` elements, else its strided
    subsample) with the init's resolution; each timed (launched, and the
    plain version), with its bound."""
    from repro_torch.core import pushdown
    from repro_torch.train import train_loop
    rows = {"sr_quantize_fused": {}, "sr_quantize_fused_int8": {},
            "edf_ladder_hists": {}}
    kw = dict(wl_ladder=pushdown.WL_LADDER, r_upr=150)
    T = len(pushdown.WL_LADDER)
    for name, extra in (("alexnet", ()), ("resnet20", ()),
                        ("resnet20", ("model.vocab_size=100",))):
        cfg = cnn_config(name, ("quant.use_pallas=true",) + extra)
        state = train_loop.init_state(cfg, SEED + 19, device="cuda")
        for path, ts in state["adapt"]["tensors"].items():
            leaf = flat_paths(state["params"])[path]
            shape = str(list(leaf.shape))
            if shape not in rows["sr_quantize_fused"]:
                for w, f in ((8, 4), (6, 9)):
                    wl = torch.tensor(w, dtype=torch.int32, device="cuda")
                    fl = torch.tensor(f, dtype=torch.int32, device="cuda")
                    got = sq.sr_quantize_fused(leaf, -4321, wl, fl)
                    want = sq.plain_grid(leaf, -4321, wl, fl)
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(torch.int32),
                                       want.view(torch.int32)):
                        raise AssertionError(f"sr_quantize_fused {shape} "
                                             f"<{w},{f}> differs")
                n = leaf.numel()
                row = {"shape": list(leaf.shape), "max_abs_err": 0.0,
                       "ms": cuda_time_ms([lambda: sq.sr_quantize_fused(
                           leaf, 7, ts["wl"], ts["fl"])], 20),
                       "plain_ms": cuda_time_ms([lambda: sq.plain_grid(
                           leaf, 7, ts["wl"], ts["fl"])], 5),
                       "library_ms": None}
                row["bound_ms"], row["bound_by"] = max(
                    (8.0 * n / HBM_BYTES_PER_S * 1e3, "bytes"),
                    (22.0 * n / F32_OPS * 1e3, "operations"))
                rows["sr_quantize_fused"][shape] = row
                for f in (4, 9):
                    fl = torch.tensor(f, dtype=torch.int32, device="cuda")
                    got = sq.sr_quantize_fused_int8(leaf, -4321, fl)
                    want = sq.plain(leaf, -4321, fl)
                    torch.cuda.synchronize()
                    if got.dtype != torch.int8 or not torch.equal(got, want):
                        raise AssertionError(f"sr_quantize_fused_int8 {shape} "
                                             f"FL {f} differs")
                row = {"shape": list(leaf.shape), "max_abs_err": 0.0,
                       "ms": cuda_time_ms([lambda: sq.sr_quantize_fused_int8(
                           leaf, 7, ts["fl"])], 20),
                       "plain_ms": cuda_time_ms([lambda: sq.plain(
                           leaf, 7, ts["fl"])], 5),
                       "library_ms": None}
                row["bound_ms"], row["bound_by"] = max(
                    (5.0 * n / HBM_BYTES_PER_S * 1e3, "bytes"),
                    (20.0 * n / F32_OPS * 1e3, "operations"))
                rows["sr_quantize_fused_int8"][shape] = row
            flat = pushdown.subsample(leaf.reshape(1, -1), cfg.quant.edf_sample
                                      ).contiguous()
            key = str(list(flat.shape))
            if key in rows["edf_ladder_hists"]:
                continue
            fls = edf_inputs(torch, flat)
            r = ts["res"].reshape(1)
            got = el.edf_ladder_hists(flat, fls, r, **kw)
            if not torch.equal(got, el.plain(flat, fls, r, **kw)):
                raise AssertionError(f"edf_ladder_hists {key} differs")
            n = flat.numel()
            row = {"shape": list(flat.shape), "max_abs_err": 0.0,
                   "ms": cuda_time_ms([lambda: el.edf_ladder_hists(
                       flat, fls, r, **kw)], 20),
                   "plain_ms": cuda_time_ms([lambda: el.plain(
                       flat, fls, r, **kw)], 5),
                   "library_ms": None}
            nbytes = 4.0 * (n + T + 3) + 4.0 * (1 + T) * 150
            row["bound_ms"], row["bound_by"] = max(
                (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                (166.0 * n / F32_OPS * 1e3, "operations"))
            rows["edf_ladder_hists"][key] = row
        del state
    log(f"[cnn] float SR grid values and int8 words at "
        f"{len(rows['sr_quantize_fused'])} and the ladder at "
        f"{len(rows['edf_ladder_hists'])} full-width leaf shapes: bit-equal "
        "to the plain versions")
    return rows


def cnn_determinism(torch, name):
    """One full-width step (batch 512, ``quant.use_pallas``) twice from the
    same state and batch, once with the global cuDNN flags at torch's
    defaults (TF32 on, nondeterministic algorithms allowed) and once with
    both off: the four runs bit-equal (params, stats, metrics), so the
    flags ``cnn.conv`` enters govern its forward and backward."""
    from repro_torch.train import train_loop
    cfg = cnn_config(name, ("quant.use_pallas=true",))
    state0 = train_loop.init_state(cfg, SEED + 24, device="cuda")
    batch = train_loop.make_batch(cfg, 0, device="cuda")
    step = train_loop.make_train_step(cfg)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    outs = []
    try:
        for flags in ((True, False), (False, False)):
            torch.backends.cudnn.allow_tf32, \
                torch.backends.cudnn.deterministic = flags
            for _ in range(2):
                s, m = step(clone_tree(state0), batch, step=0)
                outs.append((flags, {**flat_paths(
                    {"params": s["params"], "stats": s["stats"]}),
                    **{f"metrics/{k}": v for k, v in m.items()}}))
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cudnn.deterministic = saved
    ref = outs[0][1]
    for flags, out in outs[1:]:
        for path, t in ref.items():
            if not torch.equal(out[path], t):
                raise AssertionError(f"{name} step with global cuDNN flags "
                                     f"{flags}: {path} differs")
    log(f"[cnn] {name}: 4 full-width steps from one state (global "
        "allow_tf32/deterministic (True, False) twice, (False, False) "
        f"twice) bit-equal over {len(ref)} leaves and metrics")
    return len(ref)


def cnn_card_vs_cpu(torch, name):
    """At smoke width under ``quant.use_pallas``: the quantized copy of the
    same state and seeds bit-equal (kernel against plain version); one
    step within the CPU tests' bounds (tests/test_torch_cnn_step.py);
    then, after a second step on the card, the same state through
    ``precision_switch`` on the card and on the CPU: identical."""
    from repro_torch.core import controller
    from repro_torch.train import train_loop
    cfg = cnn_config(name, ("quant.use_pallas=true",), smoke=True)
    gpu = train_loop.init_state(cfg, SEED + 23, device="cuda")
    before = to_device(gpu, "cpu")
    cpu = to_device(gpu, "cpu")
    seeds = controller.leaf_seeds(int(before["rng"]), 0,
                                  before["adapt"]["tensors"])
    cq = controller.quantize_params(before["params"], before["adapt"],
                                    cfg.quant, seeds)
    gq = controller.quantize_params(to_device(before["params"], "cuda"),
                                    to_device(before["adapt"], "cuda"),
                                    cfg.quant, seeds)
    gflat = flat_paths(gq)
    for path, c in flat_paths(cq).items():
        if gflat[path].dtype != c.dtype or not torch.equal(gflat[path].cpu(),
                                                           c):
            raise AssertionError(f"{name} smoke: quantized copy {path} differs")
    batch = train_loop.make_batch(cfg, 0, device="cpu")
    step = train_loop.make_train_step(cfg)
    cpu, cm = step(cpu, batch, step=0)
    gpu, gm = step(gpu, {k: v.cuda() for k, v in batch.items()}, step=0)
    r = {k: {"cpu": float(cm[k]), "card": float(gm[k])}
         for k in ("loss", "full_loss", "grad_norm", "acc", "lr")}
    for k, rtol in (("loss", CNN_LOSS_RTOL), ("full_loss", CNN_LOSS_RTOL),
                    ("grad_norm", CNN_GRAD_NORM_RTOL), ("acc", 0.0),
                    ("lr", 0.0)):
        c, g = r[k]["cpu"], r[k]["card"]
        if not abs(c - g) <= rtol * abs(c):
            raise AssertionError(f"{name} smoke step {k}: cpu {c} card {g}")
    p0 = flat_paths(before["params"])
    gp = flat_paths(gpu["params"])
    worst = 0.0
    for path, c in flat_paths(cpu["params"]).items():
        dc, dg = c - p0[path], gp[path].cpu() - p0[path]
        rel = float(torch.linalg.vector_norm(dg - dc)
                    / torch.linalg.vector_norm(dc))
        if not rel <= CNN_UPDATE:
            raise AssertionError(f"{name} smoke step: {path} update off by "
                                 f"{rel} normwise")
        worst = max(worst, rel)
    gs = flat_paths(gpu["stats"])
    for path, c in flat_paths(cpu["stats"]).items():
        err = float((gs[path].cpu() - c).abs().max())
        if not err <= CNN_STATS * float(c.abs().max()):
            raise AssertionError(f"{name} smoke step: stats {path} off by {err}")
    leaves = len(gflat)
    gpu, _ = step(gpu, train_loop.make_batch(cfg, 1, device="cuda"), step=1)
    cpu = to_device(gpu, "cpu")
    c_out = controller.precision_switch(cpu["adapt"], cpu["params"], cfg.quant)
    g_out = controller.precision_switch(gpu["adapt"], gpu["params"], cfg.quant)
    for path, cts in c_out["tensors"].items():
        for k in ("wl", "fl", "lb", "res", "count", "sp", "norm_sum",
                  "grad_sum"):
            if not torch.equal(g_out["tensors"][path][k].cpu(), cts[k]):
                raise AssertionError(f"{name} smoke switch {path} {k}")
    if int(g_out["strategy"]) != int(c_out["strategy"]):
        raise AssertionError(f"{name} smoke switch strategy")
    r.update(leaves_bit_equal=leaves, worst_update=worst,
             wlfl=wlfl_histogram({"adapt": c_out}))
    log(f"[cnn] {name} smoke, card vs CPU: quantized copy of {leaves} leaves "
        f"bit-equal; step loss {r['loss']}, acc {r['acc']}, worst leaf "
        f"update {worst:.3g} normwise (bound {CNN_UPDATE}); precision_switch "
        f"identical ({r['wlfl']})")
    return r


def lookback_card_vs_cpu(torch):
    """The switch's mean lookback (``controller._avg_lookback``: f32 fused
    multiply-adds taken in f64, rounded to odd) on the card against the
    CPU, bit for bit: 64 states of 7 leaves stacked over 28 layers and of
    22 single lookbacks beside 3 stacked leaves, random lookbacks 2-100."""
    from repro_torch.core import controller
    gen = torch.Generator().manual_seed(SEED + 25)
    for i in range(64):
        shapes = [(28,)] * 7 if i % 2 else [()] * 22 + [(28,)] * 3
        lbs = {f"t{j:02d}": torch.randint(2, 101, shp, generator=gen,
                                          dtype=torch.int32)
               for j, shp in enumerate(shapes)}
        out = []
        for dev in ("cpu", "cuda"):
            out.append(controller._avg_lookback({
                "tensors": {k: {"lb": v.to(dev)} for k, v in lbs.items()},
                "loss_hist": torch.zeros(4, device=dev)}).cpu())
        if not torch.equal(out[0].view(torch.int32), out[1].view(torch.int32)):
            raise AssertionError(f"_avg_lookback state {i}: card {out[1]} "
                                 f"cpu {out[0]}")
    log("[cnn] the switch's mean lookback: card = CPU on 64 states")


def cnn_path(torch, sq, el):
    """Phase 19: (a) the registry's AlexNet and ResNet20 at full width under
    the QuantConfig defaults (no hand-written kernel); (b) the same under
    ``quant.use_pallas``, with the float32 and with the int8 container, and
    ResNet20 on CIFAR100, with exact launches,
    held-out accuracy and the perf model; (c) each kernel at every
    full-width leaf shape, the full-width step's determinism under the
    global cuDNN flags, card against CPU at smoke width, and the switch's
    mean lookback card against CPU."""
    runs = {}
    for name in CNN_MODELS:
        runs[f"{name}_defaults"] = cnn_run(torch, f"{name} defaults",
                                           cnn_config(name))
    for tag, name, extra in (("alexnet_pallas", "alexnet", ()),
                             ("resnet20_pallas", "resnet20", ()),
                             ("alexnet_pallas_int8", "alexnet",
                              ("quant.container_dtype=int8",)),
                             ("resnet20_pallas_int8", "resnet20",
                              ("quant.container_dtype=int8",)),
                             ("resnet20_cifar100_pallas", "resnet20",
                              ("model.vocab_size=100",))):
        runs[tag] = cnn_run(torch, tag.replace("_", " "), cnn_config(
            name, ("quant.use_pallas=true",) + extra))
    shapes = cnn_kernel_shapes(torch, sq, el)
    determinism = {name: cnn_determinism(torch, name) for name in CNN_MODELS}
    depth = {name: cnn_card_vs_cpu(torch, name) for name in CNN_MODELS}
    lookback_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in KERNELS}
    return {"runs": runs, "kernel_shapes": shapes,
            "determinism_leaves": determinism, "card_vs_cpu": depth,
            "launches": launches}


# ---------------------------------------------------------------------------
# Phase 20: the continuous batcher


def burst(cb, vocab, seed, n=CB_BURST, plen=(8, 97), new=(8, 25), long_at=5):
    """``n`` requests submitted at once: prompts of ``plen`` tokens, ``new``
    new tokens, every third with an EOS id (its prompt's first token), the
    request at ``long_at`` with a prompt of the whole context (rejected).
    Returns the requests."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    reqs = []
    for i in range(n):
        length = (cb.max_context if i == long_at
                  else int(torch.randint(*plen, (1,), generator=gen)))
        prompt = torch.randint(0, vocab, (length,), generator=gen).tolist()
        budget = int(torch.randint(*new, (1,), generator=gen))
        reqs.append(cb.submit(prompt, max_new_tokens=budget,
                              eos_id=prompt[0] if i % 3 == 0 else None))
    return reqs


def new_batcher(torch, cfg, params, state, tag, **kw):
    """A ``ContinuousBatcher`` on the card with every count set to 0 just
    before its construction and read just after, each call of its decode
    (``_decode_into``) read apart as launched (the warm-up decode) or
    recorded into a graph (a stream under capture: no kernel runs). One
    warm-up decode and one capture per level, each ``fxp_matmul`` call of
    the decode (the dense layers and the head) on the GEMV, nothing else;
    ``decode_captures`` equal to the levels. Returns (batcher, record):
    ``launches_at_construction`` holds the launches alone."""
    from repro_torch.serve.scheduler import ContinuousBatcher
    ws = wrappers()
    split = {"launched": {}, "recorded": {}}
    inner = ContinuousBatcher._decode_into

    def counted(self, qparams):
        n0 = {k: (w.launches, w.gemv_launches if k == "fxp_matmul" else 0)
              for k, w in ws.items()}
        inner(self, qparams)
        into = split["recorded" if torch.cuda.is_current_stream_capturing()
                     else "launched"]
        for k, w in ws.items():
            now = (w.launches, w.gemv_launches if k == "fxp_matmul" else 0)
            for key, a, b in zip((k, k + "_gemv"), n0[k], now):
                if b - a:
                    into[key] = into.get(key, 0) + b - a

    reset_counts(ws)
    ContinuousBatcher._decode_into = counted
    try:
        t0 = time.perf_counter()
        cb = ContinuousBatcher(cfg, params, state, slots=CB_SLOTS,
                               max_context=kw.pop("max_context", CB_CONTEXT),
                               device="cuda", **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        ContinuousBatcher._decode_into = inner
    levels = len(cb._graphs)
    per_fwd = fxp_per_forward(cfg.model)
    total = {k: w.launches for k, w in ws.items() if w.launches}
    want = {"fxp_matmul": per_fwd, "fxp_matmul_gemv": per_fwd}
    if split["launched"] != want or \
            split["recorded"] != {k: levels * v for k, v in want.items()} or \
            total != {"fxp_matmul": (levels + 1) * per_fwd} or \
            cb.decode_captures != levels or \
            levels != max(len(cb.qparam_levels), 1):
        raise AssertionError(f"{tag}: construction {split}, counts {total} "
                             f"(want {want} launched and {levels} times "
                             f"that recorded), {cb.decode_captures} captures "
                             f"of {levels} graphs")
    log(f"[{tag}] batcher: {levels} levels quantized and captured in "
        f"{build_s:.2f} s: {per_fwd} GEMV launches (the warm-up decode), "
        f"{levels * per_fwd} GEMV calls recorded into the graphs")
    return cb, {"build_s": build_s, "captures": cb.decode_captures,
                "launches_at_construction": {
                    "fxp_matmul": split["launched"]["fxp_matmul"]},
                "recorded_at_capture": {
                    "fxp_matmul": split["recorded"]["fxp_matmul"]}}


def timed_drain(cb, max_steps=4000, at=None):
    """``step`` until the queue and the slots are empty; the host ms of
    every step that decoded (each ends in the step's copy to the host, so
    it is synchronised). ``at`` = (step, fn) calls ``fn`` before that step.
    Returns (finished requests, ms per decoding step, wall s)."""
    done, ms = [], []
    t0 = time.perf_counter()
    for i in range(max_steps):
        if at is not None and i == at[0]:
            at[1]()
        s0, n0 = time.perf_counter(), cb._step_i
        done += cb.step()
        if cb._step_i != n0:
            ms.append((time.perf_counter() - s0) * 1e3)
        if not cb.queue and all(s.free for s in cb.slots):
            return done, ms, time.perf_counter() - t0
    raise AssertionError(f"batcher not drained after {max_steps} steps")


def replay_vs_eager(torch, cb, steps):
    """``steps`` decodes of the batcher's state as it stands, cycling over
    its levels: each level's graph replayed, then the state restored and
    the same decode run eagerly (``_decode_into``); logits and caches must
    be equal bit for bit. The state is restored after."""
    def snap():
        return {k: {n: c[n].clone() for n in c} for k, c in cb.caches.items()}

    def restore(s):
        for k, c in cb.caches.items():
            for n in c:
                c[n].copy_(s[k][n])

    start, inputs = snap(), cb._inputs.clone()
    trees = cb._trees()
    for i in range(steps):
        wl = list(trees)[i % len(trees)]
        cb._inputs[1].copy_(inputs[1] + i)
        before = snap()
        cb._graphs[wl].replay()
        logits, after = cb._logits.clone(), snap()
        restore(before)
        with torch.inference_mode():
            cb._decode_into(trees[wl])
        same = torch.equal(cb._logits, logits) and all(
            torch.equal(c[n], after[k][n])
            for k, c in cb.caches.items() for n in c)
        if not same or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"replay {i} (WL {wl}) differs from the "
                                 "eager decode")
    restore(start)
    cb._inputs.copy_(inputs)
    torch.cuda.synchronize()
    return steps


def replay_times(torch, cb, per_fwd, tag, memsets=0):
    """The active level's graph: ``CB_TIMED`` replays, each timed by CUDA
    events (device ms a replay, their median), and 8 under the profiler,
    whose GEMV kernel events are held against the graph's ``per_fwd`` calls
    a replay, with no GEMV finish kernel and at most ``memsets`` memsets a
    replay (a library GEMM's, counted in an eager decode step)."""
    graph = cb._graphs[cb.active_wl]
    graph.replay()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(CB_TIMED)]
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(end) for start, end in events)
    prof = device_breakdown(torch, lambda: [graph.replay() for _ in range(8)])
    if prof["gemv_finish_launches"] or prof["memsets"] > 8 * memsets:
        raise AssertionError(f"{tag}: replays ran a GEMV finish kernel or "
                             f"{prof['memsets']} memsets")
    return {"replay_device_ms": times[CB_TIMED // 2],
            "replay_device_ms_range": [times[0], times[-1]],
            "profile_8_replays": prof,
            "gemv_events_8_replays": trace_count(
                prof, "fxp_matmul_gemv", 8 * per_fwd, f"{tag}: 8 replays")}


def serve_burst(torch, cfg, params, state, tag, seed, check_replay=False,
                **burst_kw):
    """A batcher with ``cfg.serve``'s policy and ``CB_QUEUE``, a burst,
    drained with every step timed: every rid reaches one terminal status
    (the over-long prompt rejected), the WL never skips a level, the
    captures unchanged at the end. Returns (record, batcher)."""
    from repro_torch.serve.policy import PrecisionPolicy
    from repro_torch.serve.scheduler import TERMINAL
    cb, rec = new_batcher(torch, cfg, params, state, tag,
                          max_queue=CB_QUEUE,
                          policy=PrecisionPolicy.from_config(cfg.serve))
    reqs = burst(cb, cfg.model.vocab_size, seed, **burst_kw)
    at = (24, lambda: rec.update(
        replays_bit_equal=replay_vs_eager(torch, cb, CB_CHECKED))
        ) if check_replay else None
    done, ms, wall = timed_drain(cb, at=at)
    ladder = {wl: i for i, wl in enumerate(CB_LEVELS)}
    if set(cb.terminal) != {r.rid for r in reqs} or \
            any(r.status not in TERMINAL for r in reqs) or \
            sum(cb.stats[s.value] for s in TERMINAL) != len(reqs) or \
            any(abs(ladder[a] - ladder[b]) > 1
                for a, b in zip(cb.wl_trace, cb.wl_trace[1:])) or \
            cb.decode_captures != len(CB_LEVELS):
        raise AssertionError(f"{tag}: {dict(cb.stats)}, trace "
                             f"{cb.wl_trace}, {cb.decode_captures} captures")
    tokens = sum(len(r.output) for r in done)
    rec.update({
        "requests": len(reqs), "stats": dict(cb.stats),
        "statuses": {r.rid: [r.status.value, r.reason] for r in reqs},
        "outputs": {r.rid: r.output for r in reqs}, "wl_trace": cb.wl_trace,
        "decode_steps": len(ms), "step_ms_median": sorted(ms)[len(ms) // 2],
        "step_ms_min": min(ms), "step_ms_max": max(ms), "wall_s": wall,
        "tokens": tokens, "tokens_per_s": tokens / wall,
        "captures_at_end": cb.decode_captures})
    log(f"[{tag}] {len(reqs)} requests, {tokens} tokens in {wall:.2f} s "
        f"({rec['tokens_per_s']:.1f} tok/s), {len(ms)} steps, step ms median "
        f"{rec['step_ms_median']:.2f} ({rec['step_ms_min']:.2f}-"
        f"{rec['step_ms_max']:.2f}); stats {dict(cb.stats)}; WL trace start "
        f"{cb.wl_trace[0]} min {min(cb.wl_trace)} end {cb.wl_trace[-1]}; "
        f"captures {cb.decode_captures}")
    return rec, cb


def batcher_isolation(torch, cfg, params, state):
    """One batcher without a policy (one graph): a request alone (slot 0),
    then the same request among 3 others (slot 3): the same output."""
    cb, rec = new_batcher(torch, cfg, params, state, "batcher isolation")
    gen = torch.Generator().manual_seed(SEED + 4)
    prompts = [torch.randint(0, cfg.model.vocab_size, (n,),
                             generator=gen).tolist() for n in (40, 17, 63, 9)]
    alone = cb.submit(prompts[0], max_new_tokens=16)
    cb.run_until_drained()
    others = [cb.submit(p, max_new_tokens=16) for p in prompts[1:]]
    among = cb.submit(prompts[0], max_new_tokens=16)
    cb.run_until_drained()
    if among.output != alone.output or \
            any(len(r.output) != 16 for r in others) or \
            cb.decode_captures != 1:
        raise AssertionError(f"alone {alone.output} != among 3 others "
                             f"{among.output}")
    log(f"[batcher] a request alone and among 3 others: the same "
        f"{len(alone.output)} tokens")
    return {**rec, "output": alone.output}


def batcher_faults(torch, cfg, params, state):
    """test_serve_robustness.py's whole contract at full width: 14
    requests into a queue of 6 under seeded NaN rows and transient errors,
    tight deadlines on an injected clock, a retry budget of 1; every rid
    reaches exactly one terminal status, the stats add up, a second finish
    raises."""
    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.scheduler import TERMINAL, Status
    fi = FaultInjector.seeded(3, steps=400, slots=CB_SLOTS, nan_rate=0.08,
                              error_rate=0.05)
    now = [0.0]

    def clock():
        now[0] += 0.01
        return now[0]

    cb, rec = new_batcher(torch, cfg, params, state, "batcher faults",
                          max_queue=6, retry_budget=1, faults=fi, clock=clock)
    reqs = [cb.submit([i + 1, i + 2], max_new_tokens=3,
                      timeout=0.5 if i % 5 == 4 else None) for i in range(14)]
    cb.run_until_drained(max_steps=400)
    ok = [r for r in reqs if r.status is Status.OK]
    if set(cb.terminal) != {r.rid for r in reqs} or \
            any(cb.terminal[r.rid] is not r for r in reqs) or \
            sum(cb.stats[s.value] for s in TERMINAL) != len(reqs) or \
            cb.stats["submitted"] != len(reqs) or not ok or \
            cb.decode_captures != 1:
        raise AssertionError(f"batcher faults: {dict(cb.stats)}")
    try:
        cb._finish(ok[0], Status.FAILED, "again")
    except AssertionError:
        pass
    else:
        raise AssertionError("batcher faults: a second terminal status")
    log(f"[batcher] seeded faults: {len(fi.fired)} fired, stats "
        f"{dict(cb.stats)}")
    return {**rec, "stats": dict(cb.stats), "fired": len(fi.fired)}


def batcher_recovery(torch, cfg, params, state):
    """A journaled batcher takes 6 requests, steps 5 times and evicts all;
    ``recover`` from its journal re-admits all 6 (their rids) and drains
    them; the journal then holds nothing unfinished."""
    from repro_torch.serve.journal import RequestJournal
    from repro_torch.serve.scheduler import ContinuousBatcher
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    jp = str(out / "batcher_journal.jsonl")
    Path(jp).unlink(missing_ok=True)
    cb, rec = new_batcher(torch, cfg, params, state, "batcher journal",
                          journal_path=jp)
    reqs = [cb.submit([7 * i + 1, 7 * i + 2, 7 * i + 3], max_new_tokens=6)
            for i in range(6)]
    for _ in range(5):
        cb.step()
    evicted = cb.evict_all()
    cb.journal.close()
    del cb
    torch.cuda.empty_cache()
    cb = ContinuousBatcher.recover(cfg, params, state, journal_path=jp,
                                   slots=CB_SLOTS, max_context=CB_CONTEXT,
                                   device="cuda")
    replayed = [r.rid for r in cb.queue]
    done = cb.run_until_drained()
    cb.journal.close()
    if len(evicted) != 6 or replayed != [r.rid for r in reqs] or \
            any(r.status.value != "ok" for r in done) or len(done) != 6 or \
            RequestJournal.unfinished(jp) or cb.decode_captures != 1:
        raise AssertionError(f"batcher recovery: evicted {len(evicted)}, "
                             f"replayed {replayed}, {dict(cb.stats)}")
    log(f"[batcher] journal: 6 evicted, {len(replayed)} replayed and drained")
    return {**rec, "evicted": len(evicted), "replayed": replayed}


def batcher_launcher(torch, arch="llama3.2-3b"):
    """``launch.serve --continuous --arch arch`` at full width with the
    phase-4 overrides, in this process: it exits 0, captures 3 graphs and
    prints the reference's summary lines. The peak memory is read from
    its start."""
    import contextlib
    import io
    from repro_torch.launch import serve as serve_launcher
    argv = ["--arch", arch, "--continuous"]
    for o in OVERRIDES:
        argv += ["--override", o]
    buf = io.StringIO()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_launcher.main(argv)
    out = buf.getvalue()
    log(out.rstrip())
    if rc != 0 or "[serve] stats:" not in out or \
            "3 decode graphs captured" not in out:
        raise AssertionError(f"launch.serve --arch {arch} --continuous: "
                             f"rc {rc}")
    res = {"rc": rc, "s": time.perf_counter() - t0,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "lines": out.splitlines()}
    log(f"[{arch} launcher] {res['s']:.1f} s, peak {res['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()
    return res


def batcher_path(torch, fm):
    """Phase 20: the batcher on the phase-4 model."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.models import transformer
    cfg = load_config("llama3.2-3b", overrides=OVERRIDES)
    assert (cfg.serve.degrade_levels, cfg.serve.degrade_high_watermark,
            cfg.serve.degrade_low_watermark, cfg.serve.degrade_patience) == (
        CB_LEVELS, 8, 1, 2), cfg.serve
    per_fwd = 7 * N_LAYERS + 1
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(SEED, cfg.model, device="cuda")
    state = controller.init_adapt_state(params, cfg.quant)
    first, cb = serve_burst(torch, cfg, params, state, "batcher", SEED + 5,
                            check_replay=True)
    first.update(replay_times(torch, cb, per_fwd, "batcher"))
    del cb
    torch.cuda.empty_cache()
    second, cb = serve_burst(torch, cfg, params, state, "batcher again",
                             SEED + 5)
    del cb
    torch.cuda.empty_cache()
    if second["wl_trace"] != first["wl_trace"] or \
            second["outputs"] != first["outputs"] or \
            min(first["wl_trace"]) != min(CB_LEVELS) or \
            first["wl_trace"][-1] != CB_LEVELS[0]:
        raise AssertionError(f"batcher: WL traces {first['wl_trace']} / "
                             f"{second['wl_trace']}")
    res = {"burst": first, "again": {k: second[k] for k in (
        "step_ms_median", "tokens_per_s", "wall_s", "captures",
        "captures_at_end", "decode_steps", "launches_at_construction")},
           "isolation": batcher_isolation(torch, cfg, params, state),
           "faults": batcher_faults(torch, cfg, params, state),
           "recovery": batcher_recovery(torch, cfg, params, state)}
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params, state
    torch.cuda.empty_cache()
    res["launcher"] = batcher_launcher(torch)
    log(f"[batcher] replayed step {first['replay_device_ms']:.3f} ms on the "
        f"device, {first['step_ms_median']:.2f} ms a step on the host clock "
        f"(median of {first['decode_steps']}), {first['tokens_per_s']:.1f} "
        f"tok/s, peak {res['peak_gib']:.2f} GiB; the same WL trace and "
        f"outputs twice; {first['replays_bit_equal']} replays bit-equal to "
        "the eager decode")
    return res


def batcher_card_vs_cpu(torch, cfg=None, tag="batcher depth 2"):
    """The batcher at depth 2 (full width, the same weights; or ``cfg``, a
    smoke config), card against CPU, 3 requests in 4 slots: every step's
    logits within 2^-5 of the CPU's largest, greedy tokens equal where the
    CPU's top-1/top-2 margin exceeds twice that (phase 5's rule); after a
    near tie the streams part and the comparison stops."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.models import transformer
    from repro_torch.serve.scheduler import ContinuousBatcher
    if cfg is None:
        cfg = load_config("llama3.2-3b", overrides=OVERRIDES + [
            "model.num_layers=2"])
    params = transformer.init_params(SEED, cfg.model, device="cuda")
    runs = {}
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else to_device(params, "cpu")
        cb = ContinuousBatcher(cfg, p, controller.init_adapt_state(
            p, cfg.quant), slots=CB_SLOTS, max_context=64, device=dev)
        logits, inner = [], cb._read_back

        def read_back(lg, inner=inner, logits=logits):
            logits.append(lg.float().cpu().clone())
            return inner(lg)

        cb._read_back = read_back
        gen = torch.Generator().manual_seed(SEED + 6)
        reqs = [cb.submit(torch.randint(0, cfg.model.vocab_size, (6,),
                                        generator=gen).tolist(),
                          max_new_tokens=CB_DEPTH2_NEW) for _ in range(3)]
        cb.run_until_drained()
        runs[dev] = (logits, [r.output for r in reqs], cb.decode_captures)
        del cb, p
    cpu_s = time.perf_counter() - t0
    worst, steps, parted = 0.0, 0, None
    for step, (g, c) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
        tol = 2.0 ** -5 * c.abs().max().item()
        err = (g - c).abs().max().item()
        worst = max(worst, err / tol)
        if err > tol or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag} step {step}: |card-cpu| "
                                 f"{err} > {tol}")
        top2 = torch.topk(c, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
        same = g.argmax(-1) == c.argmax(-1)
        if not bool(same[sure].all()):
            raise AssertionError(f"{tag} step {step}: greedy "
                                 "tokens differ past the margin")
        steps += 1
        if not bool(same.all()):
            parted = step
            break
    if parted is None and runs["cuda"][1] != runs["cpu"][1]:
        raise AssertionError(f"{tag}: outputs differ with no tie")
    if runs["cuda"][2] != 1 or runs["cpu"][2] != 0:
        raise AssertionError(f"{tag}: captures {runs['cuda'][2]}, "
                             f"{runs['cpu'][2]}")
    log(f"[{tag}] card vs CPU: worst |err|/tol {worst:.3f} over "
        f"{steps} steps, outputs {'equal' if parted is None else 'parted after a near tie at step %d' % parted}")
    return {"worst_err_over_tol": worst, "steps_compared": steps,
            "parted_at": parted, "outputs": runs["cuda"][1],
            "cpu_outputs": runs["cpu"][1], "s": cpu_s}


# ---------------------------------------------------------------------------
# Phase 21: the dense family


def family_shapes(m):
    """(K, N): calls per layer of each dense layer of ``m`` (h·dh = d in
    both configs), and its head's (K, N)."""
    d, kv = m.d_model, m.num_kv_heads * m.resolved_head_dim
    assert m.num_heads * m.resolved_head_dim == d, m
    return {(d, d): 2, (d, kv): 2, (d, m.d_ff): 2, (m.d_ff, d): 1}, (
        d, m.vocab_size)


def check_family_shapes(torch, fm, fa, sq, el, gen):
    """Phase 3's checks at every shape the two configs bring that no
    earlier phase gave its kernel: ``fxp_matmul`` at each dense layer and
    the head of smollm-360m (K = 960, N = 320, 960, 2560, 49152) and
    granite-8b (K = 4096 and 14336, N = 1024, 4096, 14336, 49152) at M = 4
    (decode and the batcher: the GEMV, repeated for equal bits), M = 512
    (the prefill: the tensor cores) and, for smollm, M = 2048 (training),
    with phase 3's tolerance; ``matmul_dx``/``matmul_dw`` at smollm's
    training shapes; the flash forward at smollm's prefill and training
    shapes (D = 64, 15/5 heads) and granite's prefill (D = 128, 32/8), the
    backward at smollm's training shape; the SR int8 words at smollm's
    stacked (32 layers) and flat leaves, bit for bit; the EDF ladder at
    (32, 65536). Each on the branch the main path takes, with the kernel's,
    the plain version's and the library call's times and the bound."""
    from repro_torch.config import load_config
    from repro_torch.core import pushdown
    dev = "cuda"
    rows = {k: [] for k in ("fxp_matmul", "matmul_bwd", "flash_attention",
                            "flash_backward",
                            "sr_quantize_fused_stacked_int8",
                            "sr_quantize_fused_int8", "edf_ladder_hists")}
    for arch in FAMILY:
        m = load_config(arch).model
        layers, head = family_shapes(m)
        smollm = arch == SMOLLM
        fxp_rows_at(torch, fm, gen, arch, [*layers, head],
                    (BATCH, BATCH * PROMPT) + ((TRAIN_M,) if smollm else ()),
                    rows, train_m=TRAIN_M)
        flash_rows_at(torch, fa, gen, arch, m, (
            ("prefill", BATCH, PROMPT),
            *((("train", TRAIN_B, TRAIN_S),) if smollm else ())), rows,
            bwd_case="train")
    # smollm's SR words (32 layers) and EDF ladder, bit for bit
    m = load_config(SMOLLM).model
    layers, head = family_shapes(m)
    fls = torch.tensor([(0, 10, 28, 4, 17, -3, 9)[i % 7]
                        for i in range(m.num_layers)], dtype=torch.int32,
                       device=dev)
    for name, shape, fl, kern, plain in (
            *(("sr_quantize_fused_stacked_int8", (m.num_layers, k, n), fls,
               sq.sr_quantize_fused_stacked_int8, sq.plain_stacked)
              for k, n in layers),
            *(("sr_quantize_fused_int8", s, fls[1], sq.sr_quantize_fused_int8,
               sq.plain) for s in ((m.vocab_size, m.d_model), head))):
        x = torch.randn(*shape, generator=gen, device=dev) * 0.05
        got = kern(x, -4321, fl)
        if got.dtype != torch.int8 or not torch.equal(got, plain(x, -4321, fl)):
            raise AssertionError(f"{name} {shape}: words differ")
        n = x.numel()
        row = {"arch": SMOLLM, "shape": list(shape), "max_abs_err": 0.0,
               "ms": cuda_time_ms([lambda: kern(x, -4321, fl)], 5),
               "plain_ms": cuda_time_ms([lambda: plain(x, -4321, fl)], 2),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = max(
            (5.0 * n / HBM_BYTES_PER_S * 1e3, "bytes"),
            (20.0 * n / F32_OPS * 1e3, "operations"))
        rows[name].append(row)
        log(f"[family] {name} {list(shape)}: bit-equal, {fmt_row(row)}")
        del x, got
    kw = dict(wl_ladder=pushdown.WL_LADDER, r_upr=150)
    for L in (m.num_layers, 1):
        w = torch.randn(L, EDF_SAMPLE, generator=gen, device=dev) * 0.02
        fl = edf_inputs(torch, w)
        r = torch.randint(50, 151, (L,), generator=gen, device=dev,
                          dtype=torch.int32)
        got = el.edf_ladder_hists(w, fl, r, **kw)
        if not torch.equal(got, el.plain(w, fl, r, **kw)):
            raise AssertionError(f"edf_ladder ({L}, {EDF_SAMPLE}) differs")
        T = len(pushdown.WL_LADDER)
        row = {"arch": SMOLLM, "shape": [L, EDF_SAMPLE], "max_abs_err": 0.0,
               "ms": cuda_time_ms([lambda: el.edf_ladder_hists(
                   w, fl, r, **kw)], 10),
               "plain_ms": cuda_time_ms([lambda: el.plain(w, fl, r, **kw)], 3),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = max(
            (4.0 * (L * EDF_SAMPLE + L * (T + 3) + T + L * (1 + T) * 150)
             / HBM_BYTES_PER_S * 1e3, "bytes"),
            (166.0 * L * EDF_SAMPLE / F32_OPS * 1e3, "operations"))
        rows["edf_ladder_hists"].append(row)
        log(f"[family] edf_ladder_hists ({L}, {EDF_SAMPLE}): bit-equal, "
            f"{fmt_row(row)}")
    torch.cuda.empty_cache()
    return rows


def family_bwd(torch, fm, gen, arch, x, w, wd, scale):
    """``matmul_dx`` and ``matmul_dw`` at one of smollm's training shapes
    (M = 2048), bf16 operands on the tensor cores, against their plain
    versions (phase 3's tolerance), timed beside ``torch.matmul``."""
    m, k = x.shape
    n = w.shape[1]
    dy = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
    t0 = (fm.matmul_dx.tc_launches, fm.matmul_dw.tc_launches)
    dx = fm.matmul_dx(dy, w, scale, out_dtype=torch.bfloat16)
    dw = fm.matmul_dw(x, dy, out_dtype=torch.bfloat16)
    ok_x, ex = close_bf16(dx, fm.plain_dx(dy, w, scale), 2.0 ** -16)
    ok_w, ew = close_bf16(dw, fm.plain_dw(x, dy), 2.0 ** -16)
    if not (ok_x and ok_w) or (fm.matmul_dx.tc_launches - t0[0],
                               fm.matmul_dw.tc_launches - t0[1]) != (1, 1):
        raise AssertionError(f"matmul_dx/dw {arch} ({m},{k},{n}): {ex}/{ew}")
    flops = 2.0 * m * k * n
    row = {"arch": arch, "m": m, "k": k, "n": n}
    for name, kern, plain, lib, nbytes, err in (
            ("matmul_dx", lambda: fm.matmul_dx(dy, w, scale),
             lambda: fm.plain_dx(dy, w, scale), lambda: torch.matmul(dy, wd.T),
             2 * m * n + k * n + 2 * m * k + 2, ex),
            ("matmul_dw", lambda: fm.matmul_dw(x, dy, out_dtype=torch.bfloat16),
             lambda: fm.plain_dw(x, dy), lambda: torch.matmul(x.T, dy),
             2 * m * k + 2 * m * n + 2 * k * n, ew)):
        b, by = bound(nbytes, flops)
        row[name] = {"max_abs_err": err, "ms": cuda_time_ms([kern], 5),
                     "plain_ms": cuda_time_ms([plain], 2),
                     "library_ms": cuda_time_ms([lib], 5), "bound_ms": b,
                     "bound_by": by}
    log(f"[family] matmul_dx/dw {arch} {m}x{k}x{n}: dx {row['matmul_dx']}, "
        f"dw {row['matmul_dw']}")
    return row


def family_engine(torch, fm, fa, cfg, params, state, tag):
    """An ``Engine`` of the config quantized on the card, then phase 4's
    serving check (``engine_run``) on 4 prompts of 128 tokens (a VLM's
    with an N(0, 1) f32 image memory of (4, num_image_tokens, d_model)).
    Returns the record."""
    from repro_torch.serve.engine import Engine
    t0 = time.perf_counter()
    eng = Engine(cfg, params, state, device="cuda")
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    m = cfg.model
    prompts = torch.randint(0, m.vocab_size, (BATCH, PROMPT),
                            generator=gen, device="cuda")
    memory = (torch.randn((BATCH, m.num_image_tokens, m.d_model),
                          generator=gen, device="cuda")
              if m.cross_attn_every else None)
    res, _, _ = engine_run(torch, fm, fa, eng, prompts, tag, memory=memory)
    del eng, memory
    torch.cuda.empty_cache()
    return {"quantize_s": quantize_s, **res}


def smollm_path(torch, fm, fa):
    """Phase 21, smollm-360m at full width: the Engine, 3 packed SR steps
    through a switch, the registry's config with only batch and sequence
    cut, and the batcher."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.models import transformer
    from repro_torch.train import train_loop
    res = {}
    cfg = load_config(SMOLLM, overrides=OVERRIDES)
    m = cfg.model
    assert (m.num_layers, m.d_model, m.resolved_head_dim, m.vocab_size) == (
        32, 960, 64, 49152), m
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(SEED, m, device="cuda")
    state = controller.init_adapt_state(params, cfg.quant)
    res["engine"] = family_engine(torch, fm, fa, cfg, params, state,
                                  "smollm engine")
    res["batcher"], cb = serve_burst(torch, cfg, params, state,
                                     "smollm batcher", SEED + 8,
                                     plen=(8, 25), new=(4, 13))
    res["batcher"].update(replay_times(torch, cb, 7 * m.num_layers + 1,
                                       "smollm batcher"))
    res["serving_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del cb, params, state
    torch.cuda.empty_cache()
    # packed SR training through a switch, exact launches
    cfg = load_config(SMOLLM, overrides=SR_OVERRIDES)
    L = cfg.model.num_layers
    dense = 7 * L + 1
    per_step = {**ZERO, "fxp_matmul": dense, "matmul_dx": dense,
                "matmul_dw": dense, "flash_attention": L,
                "flash_attention_dq": L, "flash_attention_dkv": L,
                "sr_quantize_fused_stacked_int8": N_STACKED,
                "sr_quantize_fused_int8": N_FLAT}
    state = train_loop.init_state(cfg, device="cuda")
    state, steps, launches, peak = run_steps(torch, "smollm SR", cfg, state,
                                             SMOLLM_SR_STEPS, per_step)
    res["sr_train"] = {"steps": steps, "launches": launches,
                       "peak_gib": peak}
    del state
    torch.cuda.empty_cache()
    res["registry"] = registry_path(torch, SMOLLM)
    return res


def granite_path(torch, fm, fa):
    """Phase 21, granite-8b at full width, serving only (one card cannot
    train it: the f32 master alone is ~32 GB): the Engine, then the
    batcher with its three levels, then ``launch.serve --continuous``; the
    peak memory of each. Serving reads only each tensor's ⟨WL,FL⟩ of the
    controller state (``engine.serving_adapt_state``, as the launcher cuts
    it), so the rest (the bf16 gradient sums, another 14.9 GiB at this
    width) is dropped first."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.models import transformer
    from repro_torch.serve.engine import serving_adapt_state
    cfg = load_config(GRANITE, overrides=OVERRIDES)
    m = cfg.model
    assert (m.num_layers, m.d_model, m.d_ff, m.vocab_size) == (
        36, 4096, 14336, 49152), m
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(SEED, m, device="cuda")
    state = serving_adapt_state(controller.init_adapt_state(params,
                                                            cfg.quant))
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0,
           "master_gib": torch.cuda.memory_allocated() / 2**30}
    res["engine"] = family_engine(torch, fm, fa, cfg, params, state,
                                  "granite engine")
    res["batcher"], cb = serve_burst(torch, cfg, params, state,
                                     "granite batcher", SEED + 9,
                                     plen=(8, 25), new=(4, 13))
    res["batcher"].update(replay_times(torch, cb, 7 * m.num_layers + 1,
                                       "granite batcher"))
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[granite] master {res['master_gib']:.2f} GiB, peak "
        f"{res['peak_gib']:.2f} GiB with three levels")
    del cb, params, state
    res["launcher"] = batcher_launcher(torch, GRANITE)
    return res


# ---------------------------------------------------------------------------
# Phases 22 and 23: gemma2-2b, and the MoE layer (mixtral-8x22b, arctic-480b)


@contextlib.contextmanager
def library_sites():
    """Inside, a ``SITE`` range opens around each call site where the
    reference computes a product outside Pallas, so that a trace can name
    the site of every library GEMM (``library_sites_of``): the MoE
    router (``moe.route``), the expert products (``moe.expert_product``)
    and a tied head (``transformer._head_logits`` without a "head"); also
    the decode step's attention (``attention._masked_attention``, the
    reference's own einsums over the caches, which no phase computes in a
    kernel), which only the decode windows allow."""
    from torch.profiler import record_function
    from repro_torch.models import attention, moe, transformer
    route, experts, head = moe.route, moe.expert_product, \
        transformer._head_logits
    masked = attention._masked_attention

    def ranged(name, fn):
        def call(*args, **kw):
            with record_function(SITE + name):
                return fn(*args, **kw)
        return call

    def head_logits(top, *args, **kw):
        if top.get("head") is None:
            return ranged("tied head", head)(top, *args, **kw)
        return head(top, *args, **kw)

    moe.route, moe.expert_product = ranged("router", route), \
        ranged("experts", experts)
    transformer._head_logits = head_logits
    attention._masked_attention = ranged("decode attention", masked)
    try:
        yield
    finally:
        moe.route, moe.expert_product = route, experts
        transformer._head_logits = head
        attention._masked_attention = masked


def check_sites(prof, allowed, required, what):
    """Every library GEMM op of a profiled window came from an ``allowed``
    site, and each ``required`` site ran one. Returns the sites."""
    sites = prof["library_gemm_sites"]
    if not set(sites) <= set(allowed) or not set(required) <= set(sites):
        raise AssertionError(f"{what}: library GEMMs by site {sites}; "
                             f"allowed {sorted(allowed)}, required "
                             f"{sorted(required)}")
    return sites


def fxp_rows_at(torch, fm, gen, arch, layers, ms, rows, train_m=None):
    """Phase 21's ``fxp_matmul`` check at each (K, N) of ``layers`` and each
    M of ``ms``: on the branch its M names (the GEMV at M <= 16, repeated
    for equal bits; else the tensor cores), against the plain version with
    phase 3's tolerance, timed beside ``torch.matmul`` of the dequantized
    words, with the bound; at ``train_m`` also ``matmul_dx``/``_dw``."""
    dev, bf = "cuda", torch.bfloat16
    scale = torch.tensor(2.0 ** -10, dtype=bf, device=dev)
    for k, n in layers:
        copies = max(1, min(8, math.ceil(64e6 / (k * n))))
        ws = [torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(copies)]
        wds = [w.to(bf) * scale for w in ws]
        for mm in ms:
            xs = [torch.randn(mm, k, generator=gen, device=dev).to(bf)
                  for _ in range(copies)]
            c = fm.fxp_matmul
            before = (c.launches, c.tc_launches, c.gemv_launches)
            got = fm.fxp_matmul(xs[0], ws[0], scale)
            moved = tuple(b - a for a, b in zip(before, (
                c.launches, c.tc_launches, c.gemv_launches)))
            gemv = mm <= 16
            if moved != (1, int(not gemv), int(gemv)):
                raise AssertionError(f"fxp_matmul {arch} ({mm},{k},{n}): "
                                     f"branch counts {moved}")
            ok, err = close_bf16(got, fm.plain(xs[0], ws[0], scale), 2.0 ** -16)
            if not ok:
                raise AssertionError(f"fxp_matmul {arch} ({mm},{k},{n}): "
                                     f"max err {err}")
            reps = 20 if gemv else 5
            row = {"arch": arch, "m": mm, "k": k, "n": n,
                   "branch": "gemv" if gemv else "tc", "max_abs_err": err,
                   "ms": cuda_time_ms([lambda x=x, w=w: fm.fxp_matmul(
                       x, w, scale) for x, w in zip(xs, ws)], reps),
                   "plain_ms": cuda_time_ms([lambda: fm.plain(
                       xs[0], ws[0], scale)], 2),
                   "library_ms": cuda_time_ms([
                       lambda x=x, w=w: torch.matmul(x, w)
                       for x, w in zip(xs, wds)], reps)}
            if gemv:
                row["repeats_bit_equal"] = bit_stable(
                    torch, lambda: fm.fxp_matmul(xs[0], ws[0], scale), 10,
                    f"fxp_matmul {arch} ({mm},{k},{n})")
            row["bound_ms"], row["bound_by"] = bound(
                2 * mm * k + k * n + 2 * mm * n + 2, 2.0 * mm * k * n)
            rows["fxp_matmul"].append(row)
            log(f"[{arch}] fxp_matmul {mm}x{k}x{n}: {fmt_row(row)}")
            if mm == train_m:
                rows["matmul_bwd"].append(family_bwd(
                    torch, fm, gen, arch, xs[0], ws[0], wds[0], scale))
            del xs
        del ws, wds
    torch.cuda.empty_cache()


def fmt_row(row):
    return ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in row.items())


def flash_rows_at(torch, fa, gen, arch, m, cases, rows, bwd_case=None):
    """The flash forward at each (case, B, S) of ``cases`` with ``m``'s
    heads, head dim, window and softcap (``window`` when the config's
    attention is local somewhere), causal unless ``m`` is an encoder, on
    the tensor cores, against the plain version with phase 3's tolerance,
    timed beside SDPA where SDPA computes the same function (no softcap,
    no window); at ``bwd_case`` also dq and dkv, on the branch their head
    dim names (the tensor cores at D <= 128, else SIMT), against the plain
    backward."""
    dev, bf = "cuda", torch.bfloat16
    h, hkv, dh = m.num_heads, m.num_kv_heads, m.resolved_head_dim
    window = m.window_size if "local" in m.attn_pattern else 0
    softcap = m.attn_logit_softcap
    causal = not m.is_encoder
    kw = dict(causal=causal, window=window, softcap=softcap)
    for case, B, S in cases:
        q = torch.randn(B, S, h, dh, generator=gen, device=dev).to(bf)
        k_ = torch.randn(B, S, hkv, dh, generator=gen, device=dev).to(bf)
        v = torch.randn(B, S, hkv, dh, generator=gen, device=dev).to(bf)
        t0 = fa.flash_attention.tc_launches
        o, lse = fa.flash_attention(q, k_, v, return_lse=True, **kw)
        po = fa.plain(q, k_, v, **kw)
        torch.cuda.synchronize()
        ok, err = close_bf16(o, po, 1e-4)
        if not ok or fa.flash_attention.tc_launches != t0 + 1:
            raise AssertionError(f"flash {arch} {case}: err {err}")
        w = window if window and window < S else S
        pairs = B * h * (sum(min(i + 1, w) for i in range(S)) if causal
                         else S * S)
        lib = None
        if not softcap and not (window and window < S):
            rep = h // hkv
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (
                q, k_.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
            lib = cuda_time_ms([
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal)], 10)
            del qt, kt, vt
        row = {"arch": arch, "case": case, "shape": [B, S, S, h, hkv, dh],
               "causal": causal, "window": window, "softcap": softcap,
               "branch": "tensor cores",
               "max_abs_err": err,
               "ms": cuda_time_ms([lambda: fa.flash_attention(
                   q, k_, v, **kw)], 10),
               "plain_ms": cuda_time_ms([lambda: fa.plain(q, k_, v, **kw)], 2),
               "library_ms": lib}
        row["bound_ms"], row["bound_by"] = bound(
            2 * (2 * q.numel() + k_.numel() + v.numel()), 4.0 * dh * pairs)
        rows["flash_attention"].append(row)
        log(f"[{arch}] flash_attention {case}: {fmt_row(row)}")
        if case == bwd_case:
            rows["flash_backward"].append(flash_bwd_row(
                torch, fa, gen, arch, q, k_, v, o, lse, pairs, kw))
        del q, k_, v, o, lse, po
    torch.cuda.empty_cache()


def flash_bwd_row(torch, fa, gen, arch, q, k, v, o, lse, pairs, kw):
    """dq and dkv at one training shape against the plain backward (phase
    3's tolerance), on the tensor cores at D <= 128 and on the SIMT kernels
    above (``TC_BWD_MAX_HEAD_DIM``), timed, with their bounds; SDPA's
    backward beside them where it computes the same function."""
    B, S, H, D = q.shape
    tc = D <= fa.TC_BWD_MAX_HEAD_DIM
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    t0 = (fa.flash_attention_dq.tc_launches, fa.flash_attention_dkv.tc_launches,
          fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = fa.plain_bwd(q, k, v, o, lse, do, **kw)
    errs = []
    for g, w in zip(got, want):
        ok, e = close_bf16(g, w, 1e-4)
        if not ok:
            raise AssertionError(f"flash backward {arch}: err {e}")
        errs.append(e)
    moved = (fa.flash_attention_dq.tc_launches - t0[0],
             fa.flash_attention_dkv.tc_launches - t0[1],
             fa.flash_attention_dq.launches - t0[2],
             fa.flash_attention_dkv.launches - t0[3])
    if moved != (int(tc), int(tc), 1, 1):
        raise AssertionError(f"flash backward {arch} D={D}: counts {moved}")
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, delta)
    ins = 2 * (2 * q.numel() + k.numel() + v.numel()) + 8 * B * H * S
    lib = None
    if not kw["softcap"] and not (kw["window"] and kw["window"] < S):
        launched, _ = sdpa_flash_backward(torch, q, k, v, do, kw["causal"])
        lib = cuda_time_ms([launched], 10)
    row = {"arch": arch, "shape": [B, S, S, H, k.shape[2], D],
           "causal": kw["causal"],
           "branch": "tensor cores" if tc else "SIMT", "library_ms": lib,
           "library_covers": "flash_attention_dq+flash_attention_dkv"}
    for name, fn, plain, flops, outs, err in (
            ("flash_attention_dq", fa.flash_attention_dq, fa.plain_dq,
             6.0 * D * pairs, 2 * q.numel(), errs[0]),
            ("flash_attention_dkv", fa.flash_attention_dkv, fa.plain_dkv,
             8.0 * D * pairs, 2 * (k.numel() + v.numel()), max(errs[1:]))):
        b, by = bound(ins + outs, flops)
        row[name] = {"max_abs_err": err,
                     "ms": cuda_time_ms([lambda: fn(*args, **kw)], 5),
                     "plain_ms": cuda_time_ms([lambda: plain(*args, **kw)], 2),
                     "bound_ms": b, "bound_by": by}
    log(f"[{arch}] flash backward {row['shape']} ({row['branch']}): "
        f"dq {row['flash_attention_dq']}, dkv {row['flash_attention_dkv']}, "
        f"SDPA backward {lib} ms")
    return row


def gemma2_shapes(torch, fm, fa, gen):
    """Phase 22's kernel shapes, each against its plain version: the flash
    forward at D = 256 with softcap 50 and window 4096 at the prefill (4 x
    128), training (4 x 512) and the long prompt's (1 x 4160, where the
    window bites) shapes; dq/dkv at (4, 512, 8/4, 256) on the SIMT branch;
    ``fxp_matmul`` at every dense layer of gemma2-2b (K = 2304, 2048 and
    9216) at M = 4 (the GEMV), 512 and 2048 (the tensor cores), and
    ``matmul_dx``/``_dw`` at M = 2048."""
    from repro_torch.config import load_config
    m = load_config(GEMMA).model
    d, q, kv = m.d_model, m.num_heads * m.resolved_head_dim, \
        m.num_kv_heads * m.resolved_head_dim
    rows = {k: [] for k in ("fxp_matmul", "matmul_bwd", "flash_attention",
                            "flash_backward")}
    flash_rows_at(torch, fa, gen, GEMMA, m, (
        ("prefill", BATCH, PROMPT), ("train", TRAIN_B, TRAIN_S),
        ("long prompt", 1, LONG_PROMPT)), rows, bwd_case="train")
    fxp_rows_at(torch, fm, gen, GEMMA, [(d, q), (d, kv), (q, d), (d, m.d_ff),
                                        (m.d_ff, d)],
                (BATCH, BATCH * PROMPT, TRAIN_M), rows, train_m=TRAIN_M)
    return rows


def moe_shapes(torch, fm, fa, sq, gen):
    """Phase 23's kernel shapes, each against its plain version: mixtral's
    attention and head (K = 6144, N = 6144, 1024, 32768) at M = 4, 512 and
    2048, with ``matmul_dx``/``_dw`` at 2048; arctic's attention, dense
    residual and head (K = 7168 and 4864) at M = 4 and 512 (its training
    runs the QuantConfig defaults: no kernel); the flash forward at their
    prefill shapes (48/8 and 56/8 heads of 128, mixtral's window 4096) and
    mixtral's training shape, with dq/dkv there on the tensor cores; the SR
    int8 words and float grid values of mixtral's 4-D expert stack (1, 8,
    6144, 16384), the largest leaf the slice quantizes, bit for bit against
    their plain versions drawn in chunks of 2^26 elements."""
    from repro_torch.config import load_config
    from repro_torch.kernels import ref
    rows = {k: [] for k in ("fxp_matmul", "matmul_bwd", "flash_attention",
                            "flash_backward", "sr_quantize_fused_stacked_int8",
                            "sr_quantize_fused_stacked")}
    for arch, ms, train_m, cases in (
            (MIXTRAL, (BATCH, BATCH * PROMPT, TRAIN_M), TRAIN_M,
             (("prefill", BATCH, PROMPT), ("train", TRAIN_B, TRAIN_S))),
            (ARCTIC, (BATCH, BATCH * PROMPT), None,
             (("prefill", BATCH, PROMPT),))):
        m = load_config(arch).model
        d, kv = m.d_model, m.num_kv_heads * m.resolved_head_dim
        layers = [(d, d), (d, kv), (d, m.vocab_size)]
        if m.dense_residual_d_ff:
            layers += [(d, m.dense_residual_d_ff), (m.dense_residual_d_ff, d)]
        flash_rows_at(torch, fa, gen, arch, m, cases, rows, bwd_case="train")
        fxp_rows_at(torch, fm, gen, arch, layers, ms, rows, train_m=train_m)
    m = load_config(MIXTRAL).model
    shape = (1, m.num_experts, m.d_model, m.d_ff)
    x = torch.randn(shape, generator=gen, device="cuda") * 0.05
    fl = torch.tensor([10], dtype=torch.int32, device="cuda")
    wl = torch.tensor([8], dtype=torch.int32, device="cuda")
    n = x.numel()
    for name, kern, rnd, out_bytes in (
            ("sr_quantize_fused_stacked_int8",
             lambda: sq.sr_quantize_fused_stacked_int8(x, -4321, fl),
             lambda xs, u: ref._sr_int8(xs, u, fl[0]), 1),
            ("sr_quantize_fused_stacked",
             lambda: sq.sr_quantize_fused_stacked(x, -4321, wl, fl),
             lambda xs, u: ref._sr_grid(xs, u, wl[0], fl[0]), 4)):
        got = kern()
        want = torch.empty_like(got)
        plain_ms = chunked_plain(torch, x, -4321, rnd, want)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {list(shape)}: differs from its "
                                 "plain version")
        row = {"arch": MIXTRAL, "shape": list(shape), "max_abs_err": 0.0,
               "ms": cuda_time_ms([kern], 5), "plain_ms": plain_ms,
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = max(
            ((4.0 + out_bytes) * n / HBM_BYTES_PER_S * 1e3, "bytes"),
            (20.0 * n / F32_OPS * 1e3, "operations"))
        rows[name].append(row)
        log(f"[{MIXTRAL}] {name} {list(shape)}: bit-equal, {fmt_row(row)}")
        del got, want
    del x
    torch.cuda.empty_cache()
    return rows


def chunked_plain(torch, x, seed, rnd, out, chunk=1 << 26):
    """The stacked SR kernels' plain version (``ref``'s: layer l's noise
    from flat offset l·rows·512 of the stream) written into ``out`` in
    chunks of ``chunk`` elements, so that the hash's int64 temporaries stay
    small at a layer of 805 M elements. Returns its device ms."""
    from repro_torch.kernels import ref
    n, stride = ref._stacked_stride(x)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for l in range(x.shape[0]):
        xf, of = x[l].reshape(-1), out[l].view(-1)
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            ref._sr_by_chunks(xf[s:e], seed, l * stride + s, rnd, of[s:e])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def packed_per_step(m):
    """Exact launches of one packed SR step of ``m`` (no remat, no
    accumulation): each dense call forward and twice backward (once, for
    dw alone, where its input needs no gradient: a VLM's memory
    projections, an encoder's in_proj on the frames), one flash forward,
    dq and dkv a self-attention layer, the SR words of every quantized
    leaf."""
    dense, L, stacked, flat = plan_counts(m)
    dx = dense - memory_calls(m) - int(m.is_encoder)
    return {**ZERO, "fxp_matmul": dense, "matmul_dx": dx,
            "matmul_dw": dense, "flash_attention": L,
            "flash_attention_dq": L, "flash_attention_dkv": L,
            "sr_quantize_fused_stacked_int8": stacked,
            "sr_quantize_fused_int8": flat}, {"edf_ladder_hists": stacked + flat}


def profiled_packed_step(torch, cfg, state, step, allowed, required, tag):
    """One packed step under the profiler with ``library_sites``: device
    busy share and time by kernel, every library GEMM from an allowed
    site."""
    from repro_torch.train import train_loop
    step_fn = train_loop.make_train_step(cfg)
    batch = train_loop.make_batch(cfg, step, device="cuda")
    box = {"state": state}

    def one_step():
        box["state"], box["metrics"] = step_fn(box["state"], batch, step=step)

    with library_sites():
        prof = device_breakdown(torch, one_step)
    check_sites(prof, allowed, required, f"{tag} profiled step")
    if not math.isfinite(float(box["metrics"]["loss"])):
        raise AssertionError(f"{tag} profiled step: loss not finite")
    log(f"[{tag}] profiled step: wall {prof['wall_ms']:.1f} ms, busy "
        f"{prof['busy_ms']:.1f} ms ({prof['busy_share']}); library GEMMs "
        f"by site {prof['library_gemm_sites']}; by kernel: "
        + ", ".join(f"{k} {v:.2f}" for k, v in prof["groups_ms"].items()))
    return box["state"], prof


def profiled_decode(torch, eng, prompts, allowed, required, tag):
    """The engine's prefill and 8 decode steps under the profiler
    (``profile_steps``) with ``library_sites``: every library GEMM from an
    allowed site (the decode's also from its attention over the caches),
    the decode's GEMV events against its launches, no GEMV finish kernel
    and no memset outside a library site (cuBLAS clears a split-K
    output for gemma2's tied head)."""
    with library_sites():
        prof = profile_steps(torch, eng, prompts)
    dec = prof["decode_8_steps"]
    check_sites(prof["prefill"], allowed, required, f"{tag} profiled prefill")
    check_sites(dec, set(allowed) | {"decode attention"},
                set(required) | {"decode attention"}, f"{tag} profiled decode")
    library_memsets = sum(n for by in dec["site_kernels_n"].values()
                          for k, n in by.items() if k.startswith("Memset"))
    if dec["gemv_finish_launches"] or dec["memsets"] != library_memsets:
        raise AssertionError(f"{tag}: profiled decode ran a GEMV finish "
                             f"kernel or a memset outside a library site: "
                             f"{dec['site_kernels_n']}, {dec['memsets']} "
                             "memsets in all")
    trace_count(dec, "fxp_matmul_gemv", 8 * fxp_per_forward(eng.cfg.model),
                f"{tag} profiled decode")
    dec["library_memsets"] = library_memsets
    log(f"[{tag}] 8 profiled decode steps: wall {dec['wall_ms']:.1f} ms, busy "
        f"{dec['busy_ms']:.1f} ms; library GEMMs by site "
        f"{dec['library_gemm_sites']}; by site's kernels "
        f"{dec['site_kernels_ms']}")
    return prof


def params_count(tree):
    return sum(t.numel() for t in flat_paths(tree).values())


def window_request(torch, eng, tag):
    """One request whose prompt passes gemma2's local window (4096): a
    prompt of ``LONG_PROMPT`` tokens, ``LONG_NEW`` greedy new tokens through
    ``Engine.generate`` (the flash prefill masks by the window, the decode's
    rolling caches of the local layers wrap), against the argmax of a
    teacher-forced ``transformer.forward`` over the prompt and the
    generated tokens on the same words: each token equal wherever the
    forward's top-1/top-2 margin exceeds twice phase 5's tolerance (2^-5 of
    the largest logit)."""
    from repro_torch.models import transformer
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    m = eng.cfg.model
    prompt = torch.randint(0, m.vocab_size, (1, LONG_PROMPT), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = eng.generate(prompt, LONG_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    seq = torch.cat([prompt, out.to(prompt.dtype)], dim=1)
    with torch.inference_mode():
        logits = transformer.forward(eng.qparams, m, tokens=seq,
                                     use_pallas=True)[0, LONG_PROMPT - 1:-1]
    tol = 2.0 ** -5 * logits.abs().max().item()
    top2 = torch.topk(logits, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
    same = logits.argmax(-1) == out[0].to(logits.device)
    if not bool(same[sure].all()) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: greedy tokens {out[0].tolist()} differ "
                             "from the teacher-forced argmax past the margin")
    res = {"prompt": LONG_PROMPT, "new": LONG_NEW, "generate_s": gen_s,
           "tokens_equal": int(same.sum()), "tokens_past_margin":
           int(sure.sum()), "tokens": out[0].tolist()}
    log(f"[{tag}] prompt {LONG_PROMPT} past the window: {LONG_NEW} tokens in "
        f"{gen_s:.2f} s, {res['tokens_equal']}/{LONG_NEW} equal to the "
        f"teacher-forced argmax ({res['tokens_past_margin']} past the margin)")
    del logits, seq
    torch.cuda.empty_cache()
    return res


def tied_head_replay_ms(torch, eng):
    """The tied head of a decode step (``transformer._head_logits`` at
    B = 4: the embedding's words dequantized, the library GEMM, the
    softcap) captured alone in a CUDA graph, as the batcher's decode graph
    holds it: the median device ms of ``CB_TIMED`` replays by CUDA
    events."""
    from repro_torch.models import transformer
    m = eng.cfg.model
    top = transformer._top(eng.qparams, True)
    x = torch.randn(BATCH, 1, m.d_model, device="cuda").to(torch.bfloat16)
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            transformer._head_logits(top, x, m, True)       # warm-up
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            transformer._head_logits(top, x, m, True)
    times = []
    for _ in range(CB_TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return sorted(times)[CB_TIMED // 2]


def gemma2_path(torch, fm, fa):
    """Phase 22: gemma2-2b at full width and depth (2.61 G params): the
    ``Engine`` on 4 x 128 prompts, 32 new tokens, with exact launches and 8
    profiled decode steps (the tied head: the dequantized 256000 x 2304
    table and its library GEMM), the long prompt past the window, 3 packed
    SR steps of 4 x 512 through a switch with exact launches and a
    profiled step (the SIMT dq + dkv at D = 256, the tied head's forward
    and backward), the batcher (4 slots, levels 8/6/4, replays bit-equal to
    the eager decode), the peak memory."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine, serving_adapt_state
    from repro_torch.train import train_loop
    res = {}
    cfg = load_config(GEMMA, overrides=OVERRIDES)
    m = cfg.model
    assert (m.num_layers, m.d_model, m.resolved_head_dim, m.d_ff,
            m.vocab_size, m.window_size, m.attn_logit_softcap,
            m.tie_embeddings) == (26, 2304, 256, 9216, 256000, 4096, 50.0,
                                  True), m
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(SEED, m, device="cuda")
    res["params"] = params_count(params)
    state = serving_adapt_state(controller.init_adapt_state(params, cfg.quant))
    t0 = time.perf_counter()
    eng = Engine(cfg, params, state, device="cuda")
    torch.cuda.synchronize()
    res["quantize_s"] = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    prompts = torch.randint(0, m.vocab_size, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    res["engine"], _, _ = engine_run(torch, fm, fa, eng, prompts,
                                     "gemma2 engine")
    prof = profiled_decode(torch, eng, prompts, {"tied head"}, {"tied head"},
                           "gemma2 engine")
    res["engine"]["profile"] = prof
    words = m.vocab_size * m.d_model
    head = prof["decode_8_steps"]["site_kernels_ms"].get("tied head", {})
    res["tied_head_decode"] = {
        "ms_8_steps": sum(head.values()), "by_kernel_ms": head,
        # per step: the words read once, the logits written once
        "bound_ms_8_steps": 8 * bound(words + 4 * BATCH * m.vocab_size,
                                      2.0 * BATCH * words)[0]}
    res["tied_head_decode"]["replay_ms"] = tied_head_replay_ms(torch, eng)
    log(f"[gemma2] tied head in 8 decode steps: "
        f"{res['tied_head_decode']['ms_8_steps']:.3f} ms on the device "
        f"(bound {res['tied_head_decode']['bound_ms_8_steps']:.3f} ms), by "
        f"kernel {head}; captured alone, "
        f"{res['tied_head_decode']['replay_ms']:.3f} ms a replay")
    res["window"] = window_request(torch, eng, "gemma2 window")
    res["serving_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del eng
    torch.cuda.empty_cache()
    res["batcher"], cb = serve_burst(torch, cfg, params, state,
                                     "gemma2 batcher", SEED + 12,
                                     check_replay=True, plen=(8, 25),
                                     new=(4, 13))
    res["batcher"].update(replay_times(
        torch, cb, fxp_per_forward(m), "gemma2 batcher",
        memsets=math.ceil(prof["decode_8_steps"]["library_memsets"] / 8)))
    res["batcher_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del cb, params, state
    torch.cuda.empty_cache()
    # packed SR training through a switch, exact launches, a profiled step
    cfg = load_config(GEMMA, overrides=SR_OVERRIDES)
    per_step, per_switch = packed_per_step(cfg.model)
    torch.cuda.reset_peak_memory_stats()
    state = train_loop.init_state(cfg, device="cuda")
    state, steps, launches, peak = run_steps(
        torch, "gemma2 SR", cfg, state, GEMMA_SR_STEPS, per_step, per_switch,
        simt={n: per_step[n] * GEMMA_SR_STEPS
              for n in ("flash_attention_dq", "flash_attention_dkv")})
    state, prof = profiled_packed_step(
        torch, cfg, state, GEMMA_SR_STEPS, {"tied head",
                                            "router or tied head (backward)"},
        {"tied head", "router or tied head (backward)"}, "gemma2 SR")
    g = prof["all_groups_ms"]
    pairs = TRAIN_B * m.num_heads * sum(min(i + 1, TRAIN_S)
                                        for i in range(TRAIN_S))
    D = m.resolved_head_dim
    ins = 2 * TRAIN_M * (2 * m.num_heads + 2 * m.num_kv_heads) * D \
        + 8 * TRAIN_M * m.num_heads
    outs = 2 * TRAIN_M * (m.num_heads + 2 * m.num_kv_heads) * D
    res["sr_train"] = {
        "steps": steps, "launches": launches, "peak_gib": peak,
        "profile": prof,
        "simt_dq_dkv_ms": g.get("flash_dq", 0.0) + g.get("flash_dkv", 0.0),
        "simt_dq_dkv_events": prof["counts"].get("flash_dq", 0)
        + prof["counts"].get("flash_dkv", 0),
        "simt_dq_dkv_bound_ms": m.num_layers * bound(
            ins + outs, 14.0 * D * pairs)[0],
        "tied_head_step_ms": sum(prof["site_kernels_ms"].get(
            "tied head", {}).values())}
    log(f"[gemma2 SR] profiled step: dq + dkv (SIMT, D = 256) "
        f"{res['sr_train']['simt_dq_dkv_ms']:.2f} ms over "
        f"{res['sr_train']['simt_dq_dkv_events']} kernel events (bound "
        f"{res['sr_train']['simt_dq_dkv_bound_ms']:.3f} ms); the tied head's "
        f"forward {res['sr_train']['tied_head_step_ms']:.2f} ms")
    del state
    torch.cuda.empty_cache()
    res["peak_gib"] = max(res["serving_peak_gib"], res["batcher_peak_gib"],
                          peak)
    log(f"[gemma2] {res['params'] / 1e9:.3f} G params; peak serving "
        f"{res['serving_peak_gib']:.2f} GiB, batcher "
        f"{res['batcher_peak_gib']:.2f}, training {peak:.2f}")
    return res


def gemma2_card_vs_cpu(torch):
    """gemma2-2b's smoke config (window 8, softcap 50/30, tied head,
    post-norms) card against CPU: phase 5's drive of the ``Engine`` past
    the window, logits within 2^-5 of the largest and greedy tokens equal
    past the margin."""
    from repro_torch.config import apply_overrides
    from repro_torch.configs import get_smoke_config
    cfg = apply_overrides(get_smoke_config(GEMMA), OVERRIDES)
    assert cfg.model.window_size == 8
    return card_vs_cpu(torch, cfg=cfg, tag="gemma2 smoke")


def count_drops(torch, fn):
    """``fn()`` with ``moe.route`` wrapped to count the dropped (token,
    choice) pairs of every MoE call (the pairs routed to the drop slot
    E·cap, a device scalar a call, read after ``fn``; a forward that remat
    recomputes routes, and counts, again): its result and those counts."""
    from repro_torch.models import moe
    route, counts = moe.route, []

    def counted(h, router, cfg, dropless=False):
        weights, chosen, dest, cap = route(h, router, cfg, dropless)
        counts.append(torch.sum(dest == cfg.num_experts * cap))
        return weights, chosen, dest, cap

    moe.route = counted
    try:
        out = fn()
        drops = [int(d) for d in counts]
    finally:
        moe.route = route
    return out, drops


def mixtral_serving(torch, fm, fa):
    """Phase 23, mixtral-8x22b at full width, depth 2 (5.41 G params):
    the ``Engine`` on 4 x 128 prompts (capacity 160 a expert in the
    prefill, dropless decode), 8 profiled decode steps (library GEMMs only
    at the router and the experts), the batcher with its three levels, the
    peak memory beside the reckoning."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine, serving_adapt_state
    cfg = load_config(MIXTRAL, overrides=OVERRIDES + [
        f"model.num_layers={MIXTRAL_SERVE_LAYERS}"])
    m = cfg.model
    assert (m.d_model, m.num_heads, m.num_kv_heads, m.d_ff, m.num_experts,
            m.experts_per_token, m.vocab_size, m.attn_pattern) == (
        6144, 48, 8, 16384, 8, 2, 32768, ("local",)), m
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(SEED, m, device="cuda")
    n = params_count(params)
    res = {"cut": f"depth {MIXTRAL_SERVE_LAYERS} of 56", "params": n,
           "reckoned_master_gib": 4 * n / 2**30,
           "reckoned_words_gib_a_level": n / 2**30}
    state = serving_adapt_state(controller.init_adapt_state(params, cfg.quant))
    eng = Engine(cfg, params, state, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    prompts = torch.randint(0, m.vocab_size, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    (res["engine"], _, _), drops = count_drops(
        torch, lambda: engine_run(torch, fm, fa, eng, prompts,
                                  "mixtral engine"))
    # two generate runs (cold, warm): each a prefill (capacity 160) and 31
    # dropless decode steps, a call a layer
    L = m.num_layers
    runs = [drops[i:i + NEW * L] for i in (0, NEW * L)]
    if len(drops) != 2 * NEW * L or any(any(r[L:]) for r in runs) or \
            runs[0][:L] != runs[1][:L]:
        raise AssertionError(f"mixtral engine: drops {drops}")
    res["engine"]["dropped_pairs_prefill"] = runs[0][:L]
    res["engine"]["profile"] = profiled_decode(
        torch, eng, prompts, {"router", "experts"}, {"router", "experts"},
        "mixtral engine")
    res["serving_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del eng
    torch.cuda.empty_cache()
    res["batcher"], cb = serve_burst(torch, cfg, params, state,
                                     "mixtral batcher", SEED + 14,
                                     check_replay=True, plen=(8, 25),
                                     new=(4, 13))
    res["batcher"].update(replay_times(torch, cb, fxp_per_forward(m),
                                       "mixtral batcher"))
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[mixtral] {res['cut']}: {n / 1e9:.3f} G params (reckoned 5.41 G: "
        f"master {res['reckoned_master_gib']:.2f} GiB, "
        f"{res['reckoned_words_gib_a_level']:.2f} GiB of words a level); "
        f"peak serving {res['serving_peak_gib']:.2f} GiB, with the "
        f"batcher's three levels {res['peak_gib']:.2f} GiB")
    del cb, params, state
    torch.cuda.empty_cache()
    return res


def mixtral_training(torch):
    """Phase 23, mixtral-8x22b at full width, depth 1 (2.91 G params): 2
    packed SR steps of 4 x 512 through a switch (capacity 640 a expert),
    exact launches, the dropped pairs of each step, a profiled step whose
    library GEMMs come only from the router and the experts, the peak
    beside the reckoning."""
    from repro_torch.config import load_config
    from repro_torch.models import moe
    from repro_torch.train import train_loop
    cfg = load_config(MIXTRAL, overrides=SR_OVERRIDES + [
        f"model.num_layers={MIXTRAL_TRAIN_LAYERS}"])
    m = cfg.model
    assert moe.capacity(TRAIN_M, m, False) == 640
    per_step, per_switch = packed_per_step(m)
    torch.cuda.reset_peak_memory_stats()
    state = train_loop.init_state(cfg, device="cuda")
    n = params_count(state["params"])
    (state, steps, launches, peak), drops = count_drops(
        torch, lambda: run_steps(torch, "mixtral SR", cfg, state,
                                 MIXTRAL_STEPS, per_step, per_switch))
    if len(drops) != MIXTRAL_STEPS * m.num_layers:
        raise AssertionError(f"mixtral SR: drop records {drops}")
    for r, d in zip(steps, drops):
        r["dropped_pairs"] = d
        log(f"[mixtral SR] step {r['step']}: {d} of {2 * TRAIN_M} (token, "
            "choice) pairs dropped at capacity 640")
    allowed = {"router", "experts", "experts (backward)",
               "router or tied head (backward)"}
    state, prof = profiled_packed_step(torch, cfg, state, MIXTRAL_STEPS,
                                       allowed, allowed, "mixtral SR")
    res = {"cut": f"depth {MIXTRAL_TRAIN_LAYERS} of 56", "params": n,
           "reckoned_master_gib": 4 * n / 2**30, "steps": steps,
           "launches": launches, "peak_gib": peak, "profile": prof}
    log(f"[mixtral SR] {res['cut']}: {n / 1e9:.3f} G params (reckoned 2.91 "
        f"G, master {res['reckoned_master_gib']:.2f} GiB); peak {peak:.2f} "
        "GiB")
    del state
    torch.cuda.empty_cache()
    return res


def arctic_path(torch, fm, fa):
    """Phase 23, arctic-480b at its published widths with depth 1 and 16 of
    its 128 experts (one card's memory; a layer slice of all 128 experts
    is 4.46 G elements, past the kernels' 2^31 guards): its registry config
    with only those cuts and the batch (8 microbatches of 1 x 512, remat
    full, a bf16 accumulator, the QuantConfig defaults: no kernel), 2
    steps; then the ``Engine`` from int8 words under ``quant.use_pallas``."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine, serving_adapt_state
    res = {"cuts": ARCTIC_CUTS}
    res["registry"] = registry_path(torch, ARCTIC, cuts=ARCTIC_CUTS)
    cfg = load_config(ARCTIC, overrides=OVERRIDES + ARCTIC_CUTS)
    m = cfg.model
    assert (m.d_model, m.num_heads, m.num_kv_heads, m.d_ff,
            m.dense_residual_d_ff, m.num_experts, m.vocab_size) == (
        7168, 56, 8, 4864, 4864, 16, 32000), m
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(SEED, m, device="cuda")
    res["params"] = params_count(params)
    state = serving_adapt_state(controller.init_adapt_state(params, cfg.quant))
    eng = Engine(cfg, params, state, device="cuda")
    del params, state
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    prompts = torch.randint(0, m.vocab_size, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    res["engine"], _, _ = engine_run(torch, fm, fa, eng, prompts,
                                     "arctic engine")
    res["serving_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[arctic] {res['params'] / 1e9:.3f} G params (reckoned 2.35 G); "
        f"serving peak {res['serving_peak_gib']:.2f} GiB")
    del eng
    torch.cuda.empty_cache()
    return res


def moe_card_vs_cpu(torch):
    """Both MoE smoke configs, card against CPU: phase 5's drive of the
    ``Engine`` (logits within 2^-5 of the largest, greedy tokens equal past
    the margin); the routing of the same normed input (B = 2, S = 32) at
    the prefill's capacity and dropless, the chosen experts and the
    destination of every (token, choice) pair identical; one packed step
    from the same state within the CPU tests' bounds (loss 2e-3, every
    update 2e-2 normwise), with the same dropped pairs in each MoE call."""
    from repro_torch.config import apply_overrides
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import common, moe, transformer
    res = {}
    for arch in (MIXTRAL, ARCTIC):
        r = res[arch] = {}
        cfg = apply_overrides(get_smoke_config(arch), OVERRIDES)
        m = cfg.model
        r["serving"] = card_vs_cpu(torch, cfg=cfg, tag=f"{arch} smoke")
        params = transformer.init_params(SEED, m, device="cuda")
        blk = params["blocks"]["s0_moe"]
        gen = torch.Generator().manual_seed(SEED + 16)
        x = torch.randn(2, 32, m.d_model, generator=gen).to(torch.bfloat16)
        x[0, 5] = 0.0                     # an all-zero row: ties to 0, 1
        routes = {}
        for l in range(m.num_layers):
            for dropless in (False, True):
                got = {}
                for dev in ("cuda", "cpu"):
                    h = common.rms_norm(x, blk["pre_norm"][l].cpu(),
                                        m.norm_eps).to(dev)
                    _, chosen, dest, cap = moe.route(
                        h, blk["router"][l].to(dev), m, dropless)
                    got[dev] = (chosen.cpu(), dest.cpu(), cap)
                if not (torch.equal(got["cuda"][0], got["cpu"][0])
                        and torch.equal(got["cuda"][1], got["cpu"][1])):
                    raise AssertionError(f"{arch} layer {l} routing "
                                         f"(dropless {dropless}) differs")
                cap = got["cpu"][2]
                routes[f"layer {l}, {'dropless' if dropless else 'capacity'}"] = {
                    "cap": cap, "dropped": int((got["cpu"][1] == m.num_experts
                                                * cap).sum())}
        if tuple(got["cpu"][0][5].tolist()) != (0, 1):
            raise AssertionError(f"{arch}: the zero row chose "
                                 f"{got['cpu'][0][5].tolist()}")
        r["routing"] = routes
        del params
        step_cfg = apply_overrides(get_smoke_config(arch), TRAIN_OVERRIDES + [
            "train.global_batch=2", "train.seq_len=64"])
        (gpu, _, _, rec), drops = count_drops(
            torch, lambda: step_card_vs_cpu(torch, f"{arch} smoke",
                                            TRAIN_OVERRIDES, SEED, (),
                                            cfg=step_cfg))
        half = len(drops) // 2
        if drops[:half] != drops[half:]:
            raise AssertionError(f"{arch} step: dropped pairs CPU "
                                 f"{drops[:half]} card {drops[half:]}")
        rec["dropped_pairs"] = drops[:half]
        r["step"] = rec
        log(f"[{arch} smoke] routing identical {routes}; the step's dropped "
            f"pairs {drops[:half]} on both")
        del gpu
    return res


# ---------------------------------------------------------------------------
# Phase 24: the SSM family (mamba2-780m, zamba2-7b)


def qmatmul_rows_at(torch, fm, gen, arch, layers, m, rows):
    """``fxp_qmatmul`` and ``matmul_qdx`` (SR, bf16 x and dy: the tensor
    cores) at each (K, N) of ``layers`` with M = ``m``, against their plain
    versions with ``check_qmatmul``'s tolerance, timed beside
    ``torch.matmul`` of the dequantized words, with the bound."""
    from repro_torch.kernels import ops
    dev, bf = "cuda", torch.bfloat16
    f = 10
    fl = torch.tensor(f, dtype=torch.int32, device=dev)
    for k, n in layers:
        x = torch.randn(m, k, generator=gen, device=dev).to(bf)
        dy = torch.randn(m, n, generator=gen, device=dev).to(bf)
        w = torch.randn(k, n, generator=gen, device=dev) * 0.02
        seed = -(m * 7 + k)
        words = (ops.qdense_words(w, seed, fl, 1).to(bf)
                 * torch.tensor(2.0 ** -f, dtype=bf, device=dev))
        for name, kern, plain, a, lib, nbytes in (
                ("fxp_qmatmul", fm.fxp_qmatmul, fm.plain_q, x,
                 lambda: torch.matmul(x, words),
                 2 * m * k + 4 * k * n + 2 * m * n),
                ("matmul_qdx", fm.matmul_qdx, fm.plain_qdx, dy,
                 lambda: torch.matmul(dy, words.T),
                 2 * m * n + 4 * k * n + 2 * m * k)):
            t0 = kern.tc_launches
            got = kern(a, w, seed, fl, 1)
            ok, err = close_bf16(got, plain(a, w, seed, fl, 1), 2.0 ** -16)
            if not ok or kern.tc_launches != t0 + 1:
                raise AssertionError(f"{name} {arch} ({m},{k},{n}): max err "
                                     f"{err}")
            row = {"arch": arch, "m": m, "k": k, "n": n, "max_abs_err": err,
                   "ms": cuda_time_ms([lambda: kern(a, w, seed, fl, 1)], 5),
                   "plain_ms": cuda_time_ms([lambda: plain(a, w, seed, fl,
                                                           1)], 2),
                   "library_ms": cuda_time_ms([lib], 5),
                   "repeats_bit_equal": bit_stable(
                       torch, lambda: kern(a, w, seed, fl, 1), 10,
                       f"{name} {arch} ({m},{k},{n})")}
            row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * m * k * n)
            rows[name].append(row)
            log(f"[{arch}] {name} {m}x{k}x{n}: {fmt_row(row)}")
        del x, dy, w, words
    torch.cuda.empty_cache()


def ssm_dense_shapes(m):
    """(K, N) of a mamba layer's in_proj (N = 2·d_inner + 2·state + heads,
    not a multiple of 128) and out_proj, and of the head."""
    di = m.ssm_expand * m.d_model
    heads = di // m.ssm_head_dim
    return [(m.d_model, 2 * di + 2 * m.ssm_state + heads), (di, m.d_model),
            (m.d_model, m.vocab_size)]


def ssm_shapes(torch, fm, fa, gen):
    """Phase 24's kernel shapes, each against its plain version:
    ``fxp_matmul`` at mamba2-780m's in_proj (N = 6448), out_proj and head
    (V = 50280, whose word rows are not 16-byte aligned) and zamba2-7b's
    (N = 14576, V = 32000) at M = 4 (the GEMV, repeated for equal bits),
    512 and 2048 (the tensor cores), with ``matmul_dx``/``_dw`` at 2048;
    zamba2's shared attention and MLP (K = 3584 and 14336) at M = 4 and
    512; ``fxp_qmatmul``/``matmul_qdx`` at mamba2's training shapes; the
    flash forward at zamba2's head dim 112 (32/32 heads) at the prefill
    (4 x 128) and training (4 x 512) shapes, and dq/dkv at training on
    the tensor cores."""
    from repro_torch.config import load_config
    rows = {k: [] for k in ("fxp_matmul", "matmul_bwd", "flash_attention",
                            "flash_backward", "fxp_qmatmul", "matmul_qdx")}
    ms = (BATCH, BATCH * PROMPT, TRAIN_M)
    mm = load_config(MAMBA).model
    fxp_rows_at(torch, fm, gen, MAMBA, ssm_dense_shapes(mm), ms, rows,
                train_m=TRAIN_M)
    qmatmul_rows_at(torch, fm, gen, MAMBA, ssm_dense_shapes(mm), TRAIN_M,
                    rows)
    zm = load_config(ZAMBA).model
    assert zm.resolved_head_dim == 112, zm
    flash_rows_at(torch, fa, gen, ZAMBA, zm, (
        ("prefill", BATCH, PROMPT), ("train", TRAIN_B, TRAIN_S)), rows,
        bwd_case="train")
    fxp_rows_at(torch, fm, gen, ZAMBA, ssm_dense_shapes(zm), ms, rows,
                train_m=TRAIN_M)
    d = zm.d_model
    fxp_rows_at(torch, fm, gen, ZAMBA, [(d, d), (d, zm.d_ff), (zm.d_ff, d)],
                ms[:2], rows)
    return rows


def ssm_serving(torch, fm, fa, cfg, tag, seed):
    """``cfg``'s model at its full width and depth, served: the ``Engine``
    on 4 x 128 prompts, 32 new tokens (phase 4's exact launches), then the
    batcher with its three levels on a burst of 16 requests over 4 slots
    (every slot serves several: a reused slot starts from zeroed caches),
    replays bit-equal to the eager decode and timed; the peak memory."""
    from repro_torch.core import controller
    from repro_torch.models import transformer
    from repro_torch.serve.engine import serving_adapt_state
    m = cfg.model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(SEED, m, device="cuda")
    state = serving_adapt_state(controller.init_adapt_state(params, cfg.quant))
    torch.cuda.synchronize()
    res = {"params": params_count(params), "init_s": time.perf_counter() - t0}
    res["engine"] = family_engine(torch, fm, fa, cfg, params, state,
                                  f"{tag} engine")
    res["serving_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["batcher"], cb = serve_burst(torch, cfg, params, state,
                                     f"{tag} batcher", seed,
                                     check_replay=True, plen=(8, 25),
                                     new=(4, 13))
    if res["batcher"]["requests"] <= CB_SLOTS:
        raise AssertionError(f"{tag} batcher: no slot was reused")
    res["batcher"].update(replay_times(torch, cb, fxp_per_forward(m),
                                       f"{tag} batcher"))
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] {res['params'] / 1e9:.3f} G params; peak serving "
        f"{res['serving_peak_gib']:.2f} GiB, with the batcher's three levels "
        f"{res['peak_gib']:.2f} GiB")
    del cb, params, state
    torch.cuda.empty_cache()
    return res


def packed_sr_train(torch, cfg, tag, n_steps=SSM_SR_STEPS):
    """``n_steps`` packed SR steps of 4 x 512 through a switch, exact
    launches (``packed_per_step``; a VLM's memory projections on the SIMT
    branches, ``memory_calls``). Returns (state, record)."""
    from repro_torch.train import train_loop
    per_step, per_switch = packed_per_step(cfg.model)
    mem = memory_calls(cfg.model) * n_steps
    torch.cuda.reset_peak_memory_stats()
    state = train_loop.init_state(cfg, device="cuda")
    n = params_count(state["params"])
    state, steps, launches, peak = run_steps(
        torch, tag, cfg, state, n_steps, per_step, per_switch,
        simt={"fxp_matmul": mem, "matmul_dw": mem})
    log(f"[{tag}] {n / 1e9:.3f} G params; peak {peak:.2f} GiB")
    return state, {"params": n, "steps": steps, "launches": launches,
                   "peak_gib": peak}


def mamba2_path(torch, fm, fa):
    """Phase 24, mamba2-780m at full width and depth (0.857 G params): the
    ``Engine`` and the batcher (``ssm_serving``); 2 packed SR steps of 4 x
    512 (two chunks of 256 a sequence) through a switch; from that state
    one step through the quantize prologue with exact launches; the
    registry's config with only the batch cut (8 microbatches of 1 x 512,
    remat full, the QuantConfig defaults: no kernel)."""
    from repro_torch.config import load_config
    from repro_torch.train import train_loop
    cfg = load_config(MAMBA, overrides=OVERRIDES)
    m = cfg.model
    assert (m.num_layers, m.d_model, m.ssm_expand, m.ssm_head_dim,
            m.ssm_state, m.ssm_chunk, m.vocab_size) == (
        48, 1536, 2, 64, 128, 256, 50280), m
    res = ssm_serving(torch, fm, fa, cfg, "mamba2", SEED + 17)
    cfg = load_config(MAMBA, overrides=SR_OVERRIDES)
    state, res["sr_train"] = packed_sr_train(torch, cfg, "mamba2 SR")
    # the prologue: in_proj, out_proj and the head draw their words in the
    # dense kernels; conv_w keeps its stacked SR words, the embedding and
    # d_skip their flat ones, and the regularizer draws each dense
    # layer-slice's view through the flat kernel, forward and backward
    pcfg = load_config(MAMBA, overrides=PROLOGUE_OVERRIDES)
    dense = fxp_per_forward(m)
    want = {**ZERO, "fxp_qmatmul": dense, "matmul_qdx": dense,
            "matmul_dw": dense, "sr_quantize_fused_stacked_int8": 1,
            "sr_quantize_fused_int8": 2 + 2 * dense}
    batch = train_loop.make_batch(pcfg, SSM_SR_STEPS, device="cuda")
    state, _, res["prologue"] = counted_step(
        torch, "mamba2 prologue", pcfg, state, batch, SSM_SR_STEPS, want)
    del state, batch
    torch.cuda.empty_cache()
    res["registry"] = registry_path(torch, MAMBA)
    return res


def zamba2_path(torch, fm, fa):
    """Phase 24, zamba2-7b at full width: served at full depth (4.645 G
    params: ``ssm_serving``, the shared block's flash forward at head dim
    112 in every period of the prefill), then trained at 9 of its 27
    periods (1.84 G params), 2 packed SR steps of 4 x 512 through a switch
    (flash dq/dkv at D = 112 on the tensor cores, the shared block's
    per-tensor SR words and its gradient summed over the periods)."""
    from repro_torch.config import load_config
    cfg = load_config(ZAMBA, overrides=OVERRIDES)
    m = cfg.model
    assert (m.num_layers, m.d_model, m.num_heads, m.num_kv_heads,
            m.resolved_head_dim, m.d_ff, m.ssm_state, m.vocab_size,
            m.shared_attn_weights) == (81, 3584, 32, 32, 112, 14336, 64,
                                        32000, True), m
    res = ssm_serving(torch, fm, fa, cfg, "zamba2", SEED + 18)
    cfg = load_config(ZAMBA, overrides=SR_OVERRIDES + [
        f"model.num_layers={3 * ZAMBA_TRAIN_PERIODS}"])
    state, res["sr_train"] = packed_sr_train(torch, cfg, "zamba2 SR")
    res["sr_train"]["cut"] = f"{ZAMBA_TRAIN_PERIODS} of 27 periods"
    del state
    torch.cuda.empty_cache()
    return res


def ssm_card_vs_cpu(torch):
    """Both smoke configs (chunk 8), card against CPU: phase 5's drive of
    the ``Engine`` (a 32-token prefill of four chunks and 4 decode steps;
    logits within 2^-5 of the largest, greedy tokens equal past the
    margin) and one packed step of 2 x 64 from the same state within the
    CPU tests' bounds (loss 2e-3, every update 2e-2 normwise)."""
    from repro_torch.config import apply_overrides
    from repro_torch.configs import get_smoke_config
    res = {}
    for arch in (MAMBA, ZAMBA):
        cfg = apply_overrides(get_smoke_config(arch), OVERRIDES)
        r = res[arch] = {"serving": card_vs_cpu(torch, cfg=cfg,
                                                tag=f"{arch} smoke")}
        step_cfg = apply_overrides(get_smoke_config(arch), TRAIN_OVERRIDES + [
            "train.global_batch=2", "train.seq_len=64"])
        gpu, _, _, r["step"] = step_card_vs_cpu(
            torch, f"{arch} smoke", TRAIN_OVERRIDES, SEED, (), cfg=step_cfg)
        del gpu
    return res


# ---------------------------------------------------------------------------
# Phase 25: cross-attention (llama-3.2-vision-11b) and the audio encoder
# (hubert-xlarge)


def memory_projection_rows(torch, fm, gen, m, k, n):
    """The f32 SIMT branches at a VLM's memory projection (M = batch ·
    image tokens, K = d_model, N = kv heads · head dim), each one launch
    on the branch the dtypes name (no tensor-core or GEMV count):
    ``fxp_matmul`` of f32 x on int8 words with the bf16 scale 2^-10, f32
    out, within 1e-5·max|plain| of the plain version (the same f32
    products summed in another order), beside ``torch.matmul`` in f32 on
    the dequantized words; ``matmul_dw`` of f32 x and f32 dy into the
    bf16 receiver (phase 3's bf16 tolerance), beside ``torch.matmul(x.T,
    dy)`` in f32. TF32 is off, so the library calls are f32 products too;
    the bounds take 67 TFLOP/s."""
    dev = "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    scale = torch.tensor(2.0 ** -10, dtype=torch.bfloat16, device=dev)
    x = torch.randn(m, k, generator=gen, device=dev)
    w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    dy = torch.randn(m, n, generator=gen, device=dev)
    wd = w.float() * scale.float()
    rows = []
    for name, kern, plain, lib, nbytes in (
            ("fxp_matmul", lambda: fm.fxp_matmul(x, w, scale),
             lambda: fm.plain(x, w, scale), lambda: torch.matmul(x, wd),
             4 * m * k + k * n + 4 * m * n + 2),
            ("matmul_dw", lambda: fm.matmul_dw(x, dy,
                                               out_dtype=torch.bfloat16),
             lambda: fm.plain_dw(x, dy), lambda: torch.matmul(x.T, dy),
             4 * m * k + 4 * m * n + 2 * k * n)):
        c = getattr(fm, name)
        before = (c.launches, c.tc_launches, getattr(c, "gemv_launches", 0))
        got, want = kern(), plain()
        moved = tuple(b - a for a, b in zip(before, (
            c.launches, c.tc_launches, getattr(c, "gemv_launches", 0))))
        if name == "fxp_matmul":
            err = (got - want).abs().max().item()
            ok = got.dtype == torch.float32 and \
                err <= 1e-5 * want.abs().max().item()
        else:
            ok, err = close_bf16(got, want, 2.0 ** -16)
        if not ok or moved != (1, 0, 0) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} f32 {VLM} memory ({m},{k},{n}): "
                                 f"max err {err}, counts {moved}")
        row = {"arch": VLM, "kernel": name, "m": m, "k": k, "n": n,
               "branch": "simt", "dtype": "float32", "max_abs_err": err,
               "ms": cuda_time_ms([kern], 5),
               "plain_ms": cuda_time_ms([plain], 2),
               "library_ms": cuda_time_ms([lib], 5)}
        row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * m * k * n,
                                                 F32_FLOPS)
        rows.append(row)
        log(f"[{VLM}] {name} f32 memory projection {m}x{k}x{n}: "
            f"{fmt_row(row)}")
        del got, want
    del x, w, dy, wd
    torch.cuda.empty_cache()
    return rows


def cross_encoder_shapes(torch, fm, fa, gen):
    """Phase 25's kernel shapes, each against its plain version and beside
    its library call, with its bound: the non-causal flash forward, dq and
    dkv at hubert-xlarge's training shape (4 x 512, 16/16 heads of 80: the
    tensor cores, the backward's head dim padded to 128) beside
    non-causal SDPA; the f32 SIMT ``fxp_matmul`` and ``matmul_dw`` at the
    VLM's memory projection (M = 4 · 1024 image tokens, K = 4096, N =
    1024; ``memory_projection_rows``); ``fxp_matmul``, ``matmul_dx`` and
    ``matmul_dw`` at M = 2048 (training, the tensor cores) at every dense
    layer and the head of hubert (K = 1280 with N = 1280 and 5120, K =
    5120 with N = 1280, and the head's N = 504: word rows that are not
    16-byte aligned) and of the VLM (K = 4096 with N = 4096, 1024, 14336
    and 128256, K = 14336 with N = 4096), which no earlier phase gave
    dx and dw; the GEMV at the VLM's wk/wv (N = 1024) and head (N =
    128256) at M = 4."""
    from repro_torch.config import load_config
    rows = {k: [] for k in ("fxp_matmul", "matmul_bwd", "flash_attention",
                            "flash_backward")}
    hm = load_config(HUBERT).model
    assert (hm.is_encoder, hm.num_heads, hm.num_kv_heads,
            hm.resolved_head_dim) == (True, 16, 16, 80), hm
    flash_rows_at(torch, fa, gen, HUBERT, hm, (("train", TRAIN_B, TRAIN_S),),
                  rows, bwd_case="train")
    layers, head = family_shapes(hm)
    fxp_rows_at(torch, fm, gen, HUBERT, [*layers, head], (TRAIN_M,), rows,
                train_m=TRAIN_M)
    vm = load_config(VLM).model
    kv = vm.num_kv_heads * vm.resolved_head_dim
    layers, head = family_shapes(vm)
    fxp_rows_at(torch, fm, gen, VLM, [(vm.d_model, kv), head],
                (BATCH, TRAIN_M), rows, train_m=TRAIN_M)
    fxp_rows_at(torch, fm, gen, VLM, [s for s in layers
                                      if s != (vm.d_model, kv)],
                (TRAIN_M,), rows, train_m=TRAIN_M)
    rows["memory_projection"] = memory_projection_rows(
        torch, fm, gen, BATCH * vm.num_image_tokens, vm.d_model, kv)
    return rows


def vlm_path(torch, fm, fa):
    """Phase 25, llama-3.2-vision-11b at full width: served at full depth
    (9.775 G params; RTN int8 words at FL 10 under ``quant.use_pallas``:
    ``family_engine`` on 4 prompts of 128 tokens and 32 new, greedy, with a
    (4, 1024, 4096) f32 image memory: the prefill's 16 memory projections
    on the f32 SIMT branch, its other dense layers on the tensor cores, its
    head and every decode call on the GEMV, one flash launch a
    self-attention layer; the serving peak), then trained at
    ``VLM_TRAIN_PERIODS`` of its 8 periods (5.41 G params; each stacked
    cross leaf holds four layers): ``CROSS_SR_STEPS`` packed SR steps of 4 x
    512 tokens, each row with 1024 image tokens, through a switch every
    tensor takes (``packed_sr_train``: the cross slots' wk/wv forward and
    dw on the SIMT branches, no dx for them)."""
    from repro_torch.config import load_config
    from repro_torch.core import controller
    from repro_torch.models import transformer
    from repro_torch.serve.engine import serving_adapt_state
    cfg = load_config(VLM, overrides=OVERRIDES)
    m = cfg.model
    assert (m.num_layers, m.d_model, m.num_heads, m.num_kv_heads,
            m.resolved_head_dim, m.d_ff, m.vocab_size, m.cross_attn_every,
            m.num_image_tokens) == (40, 4096, 32, 8, 128, 14336, 128256, 5,
                                    1024), m
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(SEED, m, device="cuda")
    state = serving_adapt_state(controller.init_adapt_state(params,
                                                            cfg.quant))
    torch.cuda.synchronize()
    res = {"params": params_count(params), "init_s": time.perf_counter() - t0,
           "master_gib": torch.cuda.memory_allocated() / 2**30}
    res["engine"] = family_engine(torch, fm, fa, cfg, params, state,
                                  "vlm engine")
    res["serving_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[vlm] {res['params'] / 1e9:.3f} G params, master "
        f"{res['master_gib']:.2f} GiB; peak serving "
        f"{res['serving_peak_gib']:.2f} GiB")
    del params, state
    torch.cuda.empty_cache()
    cfg = load_config(VLM, overrides=SR_OVERRIDES + [
        f"model.num_layers={5 * VLM_TRAIN_PERIODS}"])
    state, res["sr_train"] = packed_sr_train(torch, cfg, "vlm SR",
                                             CROSS_SR_STEPS)
    res["sr_train"]["cut"] = f"{VLM_TRAIN_PERIODS} of 8 periods"
    del state
    torch.cuda.empty_cache()
    return res


def hubert_path(torch):
    """Phase 25, hubert-xlarge at full width and depth (48 encoder layers,
    d 1280, 16/16 heads of 80, d_ff 5120, GELU, V 504; 1.261 G params):
    ``CROSS_SR_STEPS`` packed SR steps of 4 x 512 frames through a switch
    (``packed_sr_train``: in_proj on the frames with no dx, the
    non-causal flash forward, dq and dkv at D = 80 on the tensor cores, the
    head at N = 504), then the registry's config with only the batch and
    the sequence cut (``registry_path``: 8 x 512 in 8 microbatches, remat
    full, the QuantConfig defaults)."""
    from repro_torch.config import load_config
    cfg = load_config(HUBERT, overrides=SR_OVERRIDES)
    m = cfg.model
    assert (m.num_layers, m.d_model, m.d_ff, m.vocab_size, m.act_fn,
            m.is_encoder) == (48, 1280, 5120, 504, "gelu", True), m
    state, res = packed_sr_train(torch, cfg, "hubert SR", CROSS_SR_STEPS)
    del state
    torch.cuda.empty_cache()
    return {"sr_train": res, "registry": registry_path(torch, HUBERT)}


def cross_encoder_card_vs_cpu(torch):
    """Both smoke configs, card against CPU, the CPU given the card's AV
    dtype (``card_av``): the VLM's ``Engine`` with an image memory (phase
    5's drive: logits within 2^-5 of the largest, greedy tokens equal past
    the margin) and its batcher (phase 20's comparison: the cross slots
    read the zero caches, under the card's CUDA graph); one packed SR step
    of 2 x 64 of each from the same state within phase 7's bounds (loss
    2e-3, every update 2e-2 normwise; with activation quantization on, the
    main path's step, the final norm and the head 5e-2), and beside it
    phase 7's control, the same step with activation quantization off,
    every leaf within 2e-2."""
    from repro_torch.config import apply_overrides
    from repro_torch.configs import get_smoke_config
    res = {}
    with card_av():
        cfg = apply_overrides(get_smoke_config(VLM), OVERRIDES)
        res[VLM] = {"serving": card_vs_cpu(torch, cfg=cfg, tag="vlm smoke"),
                    "batcher": batcher_card_vs_cpu(
                        torch, cfg=cfg, tag="vlm smoke batcher")}
        res[HUBERT] = {}
        for arch in (VLM, HUBERT):
            for name, extra, loose in (
                    ("act_quant_on", [], ("final_norm", "head")),
                    ("act_quant_off", ["quant.quantize_activations=false"],
                     ())):
                cfg = apply_overrides(get_smoke_config(arch), SR_OVERRIDES + [
                    "train.global_batch=2", "train.seq_len=64"] + extra)
                gpu, _, _, res[arch][f"step_{name}"] = step_card_vs_cpu(
                    torch, f"{arch} smoke SR ({name})", SR_OVERRIDES, SEED,
                    loose, cfg=cfg)
                del gpu
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 26: the data-parallel mesh (sharding rules, per-shard SR words,
# ZeRO blocks, QSGD across pods)

MESH_AXES = ("pod", "data", "model")
# the data meshes of phase 26 and the model-axis meshes of phase 27: the
# per-shard seed folds the model coordinate too
SHARD_MESHES = [(1, 2, 1), (2, 2, 1), (1, 4, 1), (1, 1, 2), (1, 2, 2)]
SHARD_LEAVES = {"embed": (VOCAB, D_MODEL),
                "blocks/s0_attn/wq": (N_LAYERS, D_MODEL, D_MODEL),
                "blocks/s0_mlp/wi_up": (N_LAYERS, D_MODEL, D_FF)}
# Two ranks share cuda:0 over gloo, so the full depth's two masters, their
# gathered copies and gradients would not fit 80 GB; depth 7 of 28 since
# phase 27 came (depth 14 took 154.9-177.3 s of the script, most of it
# gloo's transport through host memory).
DP_DEPTH = 7
DP_STEPS = 2                   # the first held against one process, then
DP_SEED = 29                   # a switch after the second (lookback 2)
DP_OVERRIDES = FLOAT_OVERRIDES + [f"model.num_layers={DP_DEPTH}"]
# (mesh, overrides, a switch after the steps): the switch, which gathers
# each master and "grad_sum", runs once, on the blocks of the zero run
DP_RUNS = {"zero_1x2x1": ((1, 2, 1), ["train.zero_shard=true"], True),
           "qsgd_2x1x1": ((2, 1, 1), ["train.qsgd_pod_compression=true"],
                          False)}
# The ranks' first step against one process given the same words (each
# leaf quantized block by block as the ranks quantize it). The zero run:
# one step on the whole global batch with no mesh, so a fault in how the
# ranks split the batch shows. Each rank's weight gradients come out of
# bf16 GEMMs on its half of the rows, rounded to bf16 there (<= 2^-9
# relative an element) and then averaged, where the one process rounds the
# whole batch's once: the updates differ by that rounding (2.4e-3 normwise
# per leaf in tests/test_torch_dp.py's two-rank step on the CPU), held at
# 1e-2, and the losses at 1e-4. The QSGD run: each pod's gradient on its
# rows (sliced from the batch, not by the ranks' split), encoded with the
# step key, the decoded words summed in pod order: the same GEMMs and the
# same sums, so held at bit equality.
DP_UPDATE_NORMWISE = 1e-2
DP_LOSS_RTOL = 1e-4
DP_JOIN_S = 420
# a rank's launches over the steps: every quantized leaf's block once a
# step, the flash kernels once a layer; the switch adds the ladder once a
# tensor (on the gathered master)
DP_PATH = {**ZERO, "sr_quantize_fused_stacked": N_STACKED * DP_STEPS,
           "sr_quantize_fused": N_FLAT * DP_STEPS,
           "flash_attention": DP_DEPTH * DP_STEPS,
           "flash_attention_dq": DP_DEPTH * DP_STEPS,
           "flash_attention_dkv": DP_DEPTH * DP_STEPS}
DP_SWITCH = {"edf_ladder_hists": N_STACKED + N_FLAT}


def _rank_blocks(shape, spec, sizes):
    """(shard index, block slices, that rank's ``NamedSharding``) of each
    distinct block of a leaf of ``shape`` under ``spec`` on a mesh of
    ``sizes``, as the first rank that holds it sees it: replicas along the
    axes the spec does not name hold the same block and draw the same
    words."""
    from repro_torch import distributed as dst
    from repro_torch.sharding import Mesh, NamedSharding
    mesh = Mesh(MESH_AXES, sizes)
    seen = set()
    for r in range(math.prod(sizes)):
        m = mesh.at(dst.rank_coords(r, MESH_AXES, sizes))
        i = dst.shard_index(spec, m, len(shape))
        if i not in seen:
            seen.add(i)
            yield (i, dst.block_slices(shape, spec, m),
                   NamedSharding(m, spec, shape))


def sharded_kernels(torch):
    """Phase 26 (a): full-width llama3.2-3b leaves (the embedding, a stacked
    wq and wi_up) under every spec ``param_pspec`` gives them with
    zero_shard on the meshes of ``SHARD_MESHES`` (data axes, and the model
    axis of phase 27 with and without data), quantized
    block by block on the card by all four entry points with the per-shard
    seeds (``kops.sr_quantize_fused[_int8](sharding=)``), each block bit for
    bit against its plain version and the whole against the assembled
    plain version (``ref_sr_quantize_fused_sharded_words``); each launch
    timed by CUDA events beside its plain version and its bound."""
    from repro_torch.config import load_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import Mesh, shard_grid
    cfg = load_config("llama3.2-3b", overrides=["train.zero_shard=true"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    rows = []
    for path, shape in SHARD_LEAVES.items():
        x = torch.randn(shape, generator=gen, device="cuda") * 0.02
        stacked = len(shape) == 3
        L = shape[0]
        wl = (torch.full((L,), 8, dtype=torch.int32, device="cuda")
              if stacked else torch.tensor(8, dtype=torch.int32,
                                           device="cuda"))
        fl = wl + 2
        for sizes in SHARD_MESHES:
            mesh = Mesh(MESH_AXES, sizes)
            spec = mesh_lib.param_pspec(path, shape, cfg, mesh, fsdp=True)
            grid = shard_grid(shape, spec, mesh)
            for int8 in (True, False):
                name = ("sr_quantize_fused" + ("_stacked" if stacked else "")
                        + ("_int8" if int8 else ""))
                whole = torch.empty(shape, dtype=torch.int8 if int8
                                    else torch.float32, device="cuda")
                for i, sl, sh in _rank_blocks(shape, spec, sizes):
                    blk = x[sl].contiguous()

                    def call(b=blk, sh=sh):
                        if int8:
                            return ops.sr_quantize_fused_int8(
                                b, 17, fl, use_pallas=True, sharding=sh)
                        return ops.sr_quantize_fused(b, 17, wl, fl,
                                                     use_pallas=True,
                                                     sharding=sh)
                    q = call()
                    seed = int(ref.ref_fold_shard_seed(17, i))
                    rows_l = sl[0]
                    if int8:
                        plain = (lambda b=blk: ref
                                 .ref_sr_quantize_fused_stacked_int8_words(
                                     b, seed, fl[rows_l]) if stacked else
                                 ref.ref_sr_quantize_fused_int8_words(
                                     b, seed, fl))
                    else:
                        plain = (lambda b=blk: ref
                                 .ref_sr_quantize_fused_stacked_words(
                                     b, seed, wl[rows_l], fl[rows_l])
                                 if stacked else
                                 ref.ref_sr_quantize_fused_words(b, seed, wl,
                                                                 fl))
                    want = plain()
                    if not torch.equal(q, want):
                        raise AssertionError(f"{name} {sizes} block {i} of "
                                             f"{path}: not bit-equal")
                    whole[sl] = q
                    out_b = 1 if int8 else 4
                    n = blk.numel()
                    tb, by = bound(n * (4 + out_b), 0)
                    rows.append({
                        "kernel": name, "leaf": path, "mesh": list(sizes),
                        "spec": [list(a) if isinstance(a, tuple) else a
                                 for a in spec],
                        "block": i, "shape": list(blk.shape),
                        "ms": cuda_time_ms([call], 5),
                        "plain_ms": cuda_time_ms([plain], 1),
                        "bound_ms": tb, "bound_by": by})
                assembled = ref.ref_sr_quantize_fused_sharded_words(
                    x, 17, wl, fl, grid, int8=int8)
                if not torch.equal(whole, assembled):
                    raise AssertionError(f"{name} {sizes} {path}: assembled "
                                         "blocks differ")
                del whole, assembled
                torch.cuda.empty_cache()
        del x
    log(f"[26a] {len(rows)} blocks bit-equal on {len(SHARD_MESHES)} meshes")
    return rows


def _dp_config(extra):
    from repro_torch.config import load_config
    return load_config("llama3.2-3b", overrides=DP_OVERRIDES + list(extra))


@contextlib.contextmanager
def _rank_sum_order(qparams, sh, parts):
    """Within the block one process sums each row-parallel product as
    ``parts`` model ranks do: a layer's weight whose spec splits its rows
    (K) over "model" (attention's and the MLP's wo; the embedding's rows
    are a lookup's) gives ``parts`` f32 partials
    over K's contiguous blocks, each the same GEMM as a rank's, added and
    rounded once to x's dtype (``common._RowDense``'s forward; two ranks'
    f32 sum is the same either way round). The backward stays
    ``_PlainDense``'s. Yields {"layers": the layers' row-parallel weights
    found, "calls": the products so summed}.
    Phase 27's witness: this order alone moves the one process's first
    step onto the ranks'."""
    import torch

    from repro_torch.core import controller
    from repro_torch.models import common
    rows = [t for p, t in controller.flatten_with_path(qparams)
            if p.startswith("blocks/") and torch.is_tensor(t)
            and "model" in (_spec_dims(sh[p].spec, t.ndim)[-2] or ())]
    ptrs = {t.untyped_storage().data_ptr() for t in rows}
    seen = {"layers": sum(t.shape[0] for t in rows), "calls": 0}

    class RankOrder(common._PlainDense):
        @staticmethod
        def forward(ctx, x, w, out_dtype=None):
            ctx.save_for_backward(x, w)
            k = w.shape[-2] // parts
            y = None
            for i in range(parts):
                part = common._mm_rows(
                    x[..., i * k:(i + 1) * k].contiguous(),
                    w[..., i * k:(i + 1) * k, :].to(x.dtype), torch.float32)
                y = part if y is None else y.add_(part)
            seen["calls"] += 1
            return y.to(out_dtype or x.dtype)

    plain = common.dense

    def dense(x, w, *, use_pallas=False):
        if torch.is_tensor(w) and w.untyped_storage().data_ptr() in ptrs:
            return RankOrder.apply(x, w)
        return plain(x, w, use_pallas=use_pallas)
    common.dense = dense
    try:
        yield seen
    finally:
        common.dense = plain


def _spec_dims(spec, ndim):
    """A PartitionSpec's entries as ``ndim`` tuples of axis names (None
    where a dim is whole)."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        out.append(None if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return out


def _dp_one_process(torch, cfg, sizes, batch, seed=DP_SEED, order=None):
    """The ranks' first step in one process, with no mesh, from the same
    initial state (``init_state`` from ``DP_SEED``) and the same words
    (every leaf the ranks hold in blocks quantized block by block with its
    per-shard seeds, ``_rank_blocks``). Without QSGD the gradients of the
    whole global batch (``train_loop.loss_and_grads``); under QSGD each
    pod's gradient on its own rows, sliced from the batch, encoded with the
    step key, the decoded words summed in pod order and divided by the pod
    count. Then ``train_loop.apply_grads``. With ``order`` the forward
    sums each row-parallel product as that many model ranks do
    (``_rank_sum_order``), and the metrics add its "rank_order" count."""
    from repro_torch.core import controller, threefry
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.quant import qsgd
    from repro_torch.sharding import Mesh, folded_axes, held_in_blocks
    from repro_torch.train import train_loop
    state = train_loop.init_state(cfg, seed, device="cuda")
    sh = dict(controller.flatten_with_path(mesh_lib.state_shardings(
        {"params": state["params"]}, cfg, Mesh(MESH_AXES, sizes))["params"]))
    tensors = state["adapt"]["tensors"]
    seeds = controller.leaf_seeds(seed, 0, tensors)
    qparams = controller.quantize_params(state["params"], state["adapt"],
                                         cfg.quant, seeds)
    for p, leaf in controller.flatten_with_path(state["params"]):
        if p not in tensors or not folded_axes(sh[p].spec, leaf.ndim):
            continue
        if not held_in_blocks(leaf.shape, sh[p]):
            raise AssertionError(f"[26b] {p}: an uneven leaf takes the "
                                 "noise path; the check quantizes blocks")
        words = torch.empty_like(leaf)
        for _, sl, bsh in _rank_blocks(tuple(leaf.shape), sh[p].spec, sizes):
            words[sl] = ops.sr_quantize_fused(
                leaf[sl], seeds[p], tensors[p]["wl"], tensors[p]["fl"],
                use_pallas=True, sharding=bsh)
        controller._set_path(qparams, p, words)
    if not cfg.train.qsgd_pod_compression:
        with (_rank_sum_order(qparams, sh, order) if order
              else contextlib.nullcontext(None)) as seen:
            g, full, task, aux = train_loop.loss_and_grads(cfg, qparams,
                                                           state, batch)
        del qparams
        state, m = train_loop.apply_grads(cfg, state, g, full, task, aux)
        return state, {**m, "rank_order": seen}
    pods = sizes[0]
    rows = next(iter(batch.values())).shape[0] // pods
    key = controller.step_key(seed, 0)
    full = task = 0.0
    words = []
    for i in range(pods):
        part = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        g, f, t, aux = train_loop.loss_and_grads(cfg, qparams, state, part)
        full, task = full + f, task + t
        order = {p: j for j, p in enumerate(qsgd.sorted_paths(g))}
        words.append({p: qsgd.encode(v, threefry.fold_in(key, order[p]),
                                     cfg.train.qsgd_bits)
                      for p, v in g.items()})
        del g
    del qparams
    total = {p: qsgd.sum_decoded([w[p][0] for w in words],
                                 [w[p][1] for w in words]).div_(pods)
             for p in words[0]}
    del words
    return train_loop.apply_grads(cfg, state, total, full / pods,
                                  task / pods, aux)


def dp_rank(rank: int, world: int, store: str, sizes, extra, switch: bool,
            out: str):
    """One rank of phase 26 (b), a spawned process on cuda:0 over gloo: the
    reduced llama3.2-3b, ``DP_STEPS`` steps (and a switch when ``switch``)
    on the mesh ``sizes`` (launches counted from 0 over them, each timed, the
    bytes each collective was handed in the first step, the peak memory),
    the first step's gathered params kept on the host; then rank 0 frees
    its state and runs the first step in one process
    (``_dp_one_process``) against them. Writes its record to ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import distributed as dst
    from repro_torch.core import controller
    from repro_torch.train import train_loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    mesh = dst.init_mesh(dict(zip(MESH_AXES, sizes)), "gloo",
                         device="cuda:0", rank=rank, world_size=world,
                         init_method=f"file://{store}", timeout_s=DP_JOIN_S)
    cfg = _dp_config(extra)
    t0 = time.perf_counter()
    state = train_loop.init_state(cfg, DP_SEED, device="cuda:0", mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = train_loop.make_train_step(cfg, mesh=mesh)
    switch_fn = train_loop.make_precision_switch(cfg, mesh=mesh)
    batches = [train_loop.make_batch(cfg, i, device="cuda:0")
               for i in range(DP_STEPS)]
    ws = wrappers()
    reset_counts(ws)
    torch.cuda.reset_peak_memory_stats()
    steps, metrics, first = [], [], None
    for i in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i], step=i)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            sent = dict(mesh.sent_bytes)
            launches_1 = {k: w.launches for k, w in ws.items()}
            layout = dst.Layout(mesh, state["layout"])
            first = {p: layout.whole(p, t).to("cpu", copy=True) for p, t in
                     controller.flatten_with_path(state["params"])}
    switch_ms = None
    if switch:
        t0 = time.perf_counter()
        state = switch_fn(state)
        torch.cuda.synchronize()
        switch_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: w.launches for k, w in ws.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wlfl = {p: (ts["wl"].tolist(), ts["fl"].tolist())
            for p, ts in state["adapt"]["tensors"].items()}
    blocks = {p: list(t.shape) for p, t in
              controller.flatten_with_path(state["params"])}
    rec = {"rank": rank, "mesh": list(sizes), "init_s": init_s,
           "step_ms": steps, "switch_ms": switch_ms, "metrics": metrics,
           "launches": launches, "launches_step_1": launches_1,
           "sent_bytes_step_1": sent, "peak_gib": peak, "wlfl": wlfl,
           "blocks": blocks}
    del state, batches[1:]
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    if rank == 0:
        t0 = time.perf_counter()
        one, om = _dp_one_process(torch, cfg, sizes, batches[0])
        init = dict(controller.flatten_with_path(train_loop.init_state(
            cfg, DP_SEED, device="cuda:0")["params"]))
        errs = {}
        for p, t in controller.flatten_with_path(one["params"]):
            d_one = (t - init[p]).float()
            d_rank = (first[p].to(t.device) - init[p]).float()
            errs[p] = float(torch.linalg.vector_norm(d_rank - d_one)
                            / torch.linalg.vector_norm(d_one))
        rec["check"] = {"seconds": time.perf_counter() - t0,
                        "update_normwise": errs,
                        "loss_one_process": float(om["loss"]),
                        "loss_ranks": metrics[0]["loss"],
                        "grad_norm_one_process": float(om["grad_norm"]),
                        "grad_norm_ranks": metrics[0]["grad_norm"]}
    torch.distributed.barrier()
    Path(out).write_text(json.dumps(rec))
    dst.destroy(mesh)


def dp_path(torch):
    """Phase 26 (b): two ranks sharing cuda:0 over gloo (spawned; the
    kernels built by the parent before), per run of ``DP_RUNS``: the
    reduced llama3.2-3b in the float32 container under use_pallas,
    fused_prng and SR, ``DP_STEPS`` steps (and the zero run's switch),
    ⟨WL,FL⟩ equal on both ranks, every kernel of the path launched, the
    first step against one process given the same words
    (``_dp_one_process``): the zero run within ``DP_UPDATE_NORMWISE`` and
    ``DP_LOSS_RTOL``, the QSGD run bit for bit. These are two ranks on one
    card: not a multi-GPU speed."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = {}
    for tag, (sizes, extra, switch) in DP_RUNS.items():
        world = math.prod(sizes)
        store = ROOT / "build" / f"dp_store_{tag}"
        store.parent.mkdir(exist_ok=True)
        store.unlink(missing_ok=True)
        files = [ROOT / "build" / f"dp_{tag}_rank{r}.json"
                 for r in range(world)]
        for f in files:
            f.unlink(missing_ok=True)
        t0 = time.perf_counter()
        procs = [ctx.Process(target=dp_rank, args=(r, world, str(store),
                                                   sizes, extra, switch,
                                                   str(f)))
                 for r, f in enumerate(files)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(DP_JOIN_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise AssertionError(f"[26b] {tag}: rank exit codes {codes}")
        recs = [json.loads(f.read_text()) for f in files]
        store.unlink(missing_ok=True)
        if any(r["wlfl"] != recs[0]["wlfl"] for r in recs[1:]):
            raise AssertionError(f"[26b] {tag}: <WL,FL> differ across ranks")
        want = {**DP_PATH, **(DP_SWITCH if switch else {})}
        for r in recs:
            for k, per in want.items():
                if r["launches"][k] != per:
                    raise AssertionError(f"[26b] {tag} rank {r['rank']}: "
                                         f"{k} launched {r['launches'][k]}")
        chk = recs[0]["check"]
        worst = max(chk["update_normwise"].values())
        rel = abs(chk["loss_ranks"] - chk["loss_one_process"]) / abs(
            chk["loss_one_process"])
        bounds = ((0.0, 0.0) if "qsgd" in tag
                  else (DP_UPDATE_NORMWISE, DP_LOSS_RTOL))
        if worst > bounds[0] or rel > bounds[1]:
            raise AssertionError(f"[26b] {tag}: against one process update "
                                 f"{worst:.3g}, loss {rel:.3g}, held at "
                                 f"{bounds}")
        f32 = sum(math.prod(s) for s in
                  (recs[0]["blocks"][p] for p in recs[0]["blocks"])) * 4
        out[tag] = {"ranks": recs, "seconds": time.perf_counter() - t0,
                    "worst_update_normwise": worst, "loss_rel": rel}
        log(f"[26b] {tag}: mesh {sizes}, step ms "
            + ", ".join("/".join(f"{x:.0f}" for x in r["step_ms"])
                        for r in recs)
            + f", switch {recs[0]['switch_ms']} ms, peak "
            + "/".join(f"{r['peak_gib']:.2f}" for r in recs)
            + f" GiB, step-1 bytes rank 0 {recs[0]['sent_bytes_step_1']}, "
            f"vs one process: update {worst:.3g}, loss {rel:.3g}; "
            f"{out[tag]['seconds']:.1f} s")
        if "qsgd" in tag:
            words = sum(math.prod(s) + 4 for s in recs[0]["blocks"].values())
            out[tag]["qsgd_payload_bytes"] = words
            out[tag]["f32_bytes"] = f32
            log(f"[26b] QSGD payload {words} B against f32 {f32} B")
    return out


# ---------------------------------------------------------------------------
# Phase 27: tensor and expert parallelism (a model axis of two ranks)

TP_MESH = (1, 1, 2)
TP_B = 2                       # 2 x 512 rows, the same on both model ranks
TP_SEED = 30
# llama3.2-3b at depth 14 of 28: per step a rank hands ~4 f32 activation
# all-reduces a layer (2 x 512 x 3072 x 4 B = 12.6 MB each) to gloo, and the
# check and the switch gather each master and "grad_sum" whole; through
# host memory at phase 26's 0.4-0.5 GB/s the full depth would double the
# phase's ~60 s. mixtral-8x22b at depth 1 (phase 23's cut), one step.
TP_DEPTH = 14
TP_OVERRIDES = FLOAT_OVERRIDES + [f"train.global_batch={TP_B}",
                                  "quant.fused_prng=true"]
# tag: (arch, extra overrides, steps, a switch after them, the control)
TP_RUNS = {"llama_tp": ("llama3.2-3b", [f"model.num_layers={TP_DEPTH}"], 2,
                        True, True),
           "mixtral_ep": (MIXTRAL, [f"model.num_layers={MIXTRAL_TRAIN_LAYERS}"],
                          1, False, False)}
# The ranks' first step against one process given the same words
# (``tp_one_process_variants``), activations quantized as configured. The
# ranks sum each row-parallel product (wo) in two f32 halves, one process
# in one; the residual stream's quantization at its layer's WL turns those
# last-bit differences into whole quantization steps. Read on the H100
# (NVIDIA H100 80GB HBM3, 700.00 W), llama at depth 14: the one process
# summing as the ranks do ("rank_order") has the ranks' loss to the last
# bit and their updates within 1.22e-2 normwise (wq; what is left is the
# backward, whose column-parallel dx the ranks sum in f32 where one
# process adds bf16 products), held at TP_ORDER_NORMWISE; in the plain
# order the loss is 3.52e-5 and the head's update 6.07e-2 off, held at
# TP_PLAIN_NORMWISE; the control (llama, activations not quantized) moves
# by the order alone 1.69e-2 at most (wq), held at TP_CONTROL_NORMWISE.
# The losses at 1e-4 in the plain order; in the ranks' order at 1e-6, all
# that the loss's own vocabulary-parallel sums leave.
TP_ORDER_NORMWISE = 2e-2
TP_ORDER_LOSS_RTOL = 1e-6
TP_PLAIN_NORMWISE = 1e-1
TP_CONTROL_NORMWISE = 3e-2
TP_LOSS_RTOL = DP_LOSS_RTOL
TP_JOIN_S = 600


def tp_launches(steps, layers, switch):
    """A rank's launches over a run: every quantized leaf's model block
    once a step (7 stacked leaves: wq, wk, wv, wo and the FFN's three; the
    embedding and the head flat), the flash forward, dq and dkv once a
    layer a step on the rank's heads; the switch the ladder once a tensor,
    on the gathered master."""
    return {**ZERO, "sr_quantize_fused_stacked": N_STACKED * steps,
            "sr_quantize_fused": N_FLAT * steps,
            "flash_attention": layers * steps,
            "flash_attention_dq": layers * steps,
            "flash_attention_dkv": layers * steps,
            "edf_ladder_hists": (N_STACKED + N_FLAT) if switch else 0}


def _tp_config(tag, more=()):
    from repro_torch.config import load_config
    arch, extra = TP_RUNS[tag][:2]
    return load_config(arch, overrides=TP_OVERRIDES + list(extra) + list(more))


def _held_whole_digests(state, layout):
    """SHA-256 of the bytes of every leaf held whole on the model axis
    (norm scales, the router) and of its "grad_sum": equal on both model
    ranks when their gradients were."""
    import hashlib

    import torch
    from repro_torch.core import controller

    def digest(t):
        raw = t.detach().to("cpu").contiguous().view(-1).view(torch.uint8)
        return hashlib.sha256(raw.numpy().tobytes()).hexdigest()
    out = {p: digest(t)
           for p, t in controller.flatten_with_path(state["params"])
           if "model" not in layout.axes(p)}
    out.update({f"grad_sum/{p}": digest(ts["grad_sum"])
                for p, ts in state["adapt"]["tensors"].items()
                if "model" not in layout.axes(p)})
    return out


def tp_rank(rank: int, world: int, store: str, tag: str, out: str):
    """One rank of phase 27, a spawned process on cuda:0 over gloo: the
    run ``tag`` of ``TP_RUNS`` on the (1, 1, 2) mesh (launches counted from
    0 over its steps and switch, each step timed, the bytes each collective
    was handed a step, the digests of the leaves held whole after each
    step, the peak memory); the first step's params gathered whole and kept
    on the host; under a switch, rank 0 keeps the whole master and
    "grad_sum" that the switch gathers and the controller state before it.
    Then rank 0 frees its state and runs the first step in one process
    (``_dp_one_process``) and the switch in one process on the kept
    tensors."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import distributed as dst
    from repro_torch.core import controller
    from repro_torch.train import train_loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    _, _, steps_n, switch, _ = TP_RUNS[tag]
    mesh = dst.init_mesh(dict(zip(MESH_AXES, TP_MESH)), "gloo",
                         device="cuda:0", rank=rank, world_size=world,
                         init_method=f"file://{store}", timeout_s=TP_JOIN_S)
    cfg = _tp_config(tag)
    t0 = time.perf_counter()
    state = train_loop.init_state(cfg, TP_SEED, device="cuda:0", mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layout = dst.Layout(mesh, state["layout"])
    step_fn = train_loop.make_train_step(cfg, mesh=mesh)
    switch_fn = train_loop.make_precision_switch(cfg, mesh=mesh)
    batches = [train_loop.make_batch(cfg, i, device="cuda:0")
               for i in range(steps_n)]
    ws = wrappers()
    reset_counts(ws)
    torch.cuda.reset_peak_memory_stats()
    steps, metrics, sent, digests, first = [], [], [], [], None
    for i in range(steps_n):
        before = dict(mesh.sent_bytes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i], step=i)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        sent.append({k: v - before[k] for k, v in mesh.sent_bytes.items()})
        digests.append(_held_whole_digests(state, layout))
        if i == 0:
            launches_1 = {k: w.launches for k, w in ws.items()}
            peak_1 = torch.cuda.max_memory_allocated() / 2 ** 30
            first = {p: layout.whole(p, t).to("cpu", copy=True) for p, t in
                     controller.flatten_with_path(state["params"])}
    switch_ms, kept, adapt_before = None, {}, None
    if switch:
        # the controller state before the switch; a held leaf's "grad_sum"
        # is kept whole as the switch gathers it (``keep``)
        adapt_before = {**state["adapt"], "tensors": {
            p: {k: (v if k == "grad_sum" and layout.held(p) else v.clone())
                for k, v in ts.items()}
            for p, ts in state["adapt"]["tensors"].items()}}
        whole = dst.Layout.whole

        def keep(self, path, t):
            got = whole(self, path, t)
            if rank == 0:
                kept.setdefault(path, []).append(got.to("cpu", copy=True))
            return got
        dst.Layout.whole = keep
        try:
            t0 = time.perf_counter()
            state = switch_fn(state)
            torch.cuda.synchronize()
            switch_ms = (time.perf_counter() - t0) * 1e3
        finally:
            dst.Layout.whole = whole
    launches = {k: w.launches for k, w in ws.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wlfl = {p: (ts["wl"].tolist(), ts["fl"].tolist())
            for p, ts in state["adapt"]["tensors"].items()}
    blocks = {p: list(t.shape) for p, t in
              controller.flatten_with_path(state["params"])}
    rec = {"rank": rank, "mesh": list(TP_MESH), "init_s": init_s,
           "step_ms": steps, "switch_ms": switch_ms, "metrics": metrics,
           "launches": launches, "launches_step_1": launches_1,
           "sent_bytes": sent, "digests": digests, "peak_gib": peak,
           "peak_gib_step_1": peak_1, "wlfl": wlfl, "blocks": blocks}
    own = {p: t for p, t in controller.flatten_with_path(state["params"])
           if not layout.held(p)}
    own = {p: t.to("cpu", copy=True) for p, t in own.items()}
    del state, batches[1:]
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    if rank == 0:
        t0 = time.perf_counter()
        rec["check"] = {}
        if switch:
            # the switch in one process on the tensors the ranks' switch
            # gathered (each master and "grad_sum" whole)
            params = {}
            for p in blocks:
                t = kept[p][0] if p in kept else own[p]
                train_loop._set_path(params, p, t.to("cuda:0"))
            tensors = {p: {**ts, "grad_sum": (kept[p][1] if p in kept else
                                              ts["grad_sum"]).to("cuda:0")}
                       for p, ts in adapt_before["tensors"].items()}
            sw = controller.precision_switch(
                {**adapt_before, "tensors": tensors}, params, cfg.quant)
            rec["check"]["wlfl_one_process"] = {
                p: (ts["wl"].tolist(), ts["fl"].tolist())
                for p, ts in sw["tensors"].items()}
            del params, tensors, sw
        del kept, own, adapt_before
        torch.cuda.empty_cache()
        rec["check"]["variants"] = tp_one_process_variants(
            torch, tag, batches[0], first)
        rec["check"]["seconds"] = time.perf_counter() - t0
    torch.distributed.barrier()
    Path(out).write_text(json.dumps(rec))
    dst.destroy(mesh)


def tp_one_process_variants(torch, tag, batch, first):
    """The ranks' first step (``first``: each param whole, on the host)
    against one process given the same words (``_dp_one_process``), once
    in the plain order ("one") and once summing each row-parallel product
    as the two ranks do ("rank_order"); under the run's control the same
    pair with activations not quantized ("one_act_off",
    "rank_order_act_off"), held against each other and not the ranks.
    Returns, per variant, the updates' normwise distance per leaf from the
    ranks' ("vs_ranks"; not for the control) and from the plain order's
    of its pair ("vs_plain"), its loss and grad norm, and what the rank
    order summed (``_rank_sum_order``'s count)."""
    from repro_torch.core import controller
    from repro_torch.train import train_loop
    cfg = _tp_config(tag)
    init = dict(controller.flatten_with_path(train_loop.init_state(
        cfg, TP_SEED, device="cuda:0")["params"]))
    runs = [("one", cfg, None), ("rank_order", cfg, TP_MESH[2])]
    if TP_RUNS[tag][4]:
        off = _tp_config(tag, ["quant.quantize_activations=false"])
        runs += [("one_act_off", off, None),
                 ("rank_order_act_off", off, TP_MESH[2])]

    def dist(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))
    out, plain = {}, None
    for name, c, order in runs:
        one, om = _dp_one_process(torch, c, TP_MESH, batch, TP_SEED,
                                  order=order)
        rec = {"loss": float(om["loss"]), "grad_norm": float(om["grad_norm"]),
               "rank_order": om["rank_order"]}
        deltas = {p: (t - init[p]).float() for p, t in
                  controller.flatten_with_path(one["params"])}
        del one
        if "act_off" not in name:
            rec["vs_ranks"] = {p: dist(first[p].to(d.device).float()
                                       - init[p].float(), d)
                               for p, d in deltas.items()}
        if order is None:
            plain = {p: d.to("cpu") for p, d in deltas.items()}
        else:
            rec["vs_plain"] = {p: dist(d, plain[p].to(d.device))
                               for p, d in deltas.items()}
            plain = None
        del deltas
        torch.cuda.empty_cache()
        out[name] = rec
    return out


def tp_path(torch, smi):
    """Phase 27: two ranks sharing cuda:0 over gloo on a (1, 1, 2) mesh
    (spawned; the kernels built by the parent before), per run of
    ``TP_RUNS``: llama3.2-3b at full width, tensor-parallel (12/4 heads,
    d_ff 4096, 64128 vocabulary rows a rank), 2 steps and a switch;
    mixtral-8x22b at full width, expert-parallel (4 of 8 experts a rank),
    one step. Both in the float32 container under use_pallas, fused_prng
    and SR. Held: every launch count of ``tp_launches`` on each rank; the
    leaves held whole bit-equal on both ranks after each step; ⟨WL,FL⟩
    equal on both ranks and to the one process's switch on the same
    tensors; the first step against one process given the same words
    (``tp_one_process_variants``): summing as the ranks do within
    ``TP_ORDER_NORMWISE`` and ``TP_ORDER_LOSS_RTOL``, in the plain order
    within ``TP_PLAIN_NORMWISE`` and ``TP_LOSS_RTOL``; the
    control's two orders within ``TP_CONTROL_NORMWISE`` of each other.
    These are two ranks on one card: not a multi-GPU speed."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = {}
    for tag, (arch, _, steps_n, switch, _) in TP_RUNS.items():
        world = math.prod(TP_MESH)
        store = ROOT / "build" / f"tp_store_{tag}"
        store.parent.mkdir(exist_ok=True)
        store.unlink(missing_ok=True)
        files = [ROOT / "build" / f"tp_{tag}_rank{r}.json"
                 for r in range(world)]
        for f in files:
            f.unlink(missing_ok=True)
        t0 = time.perf_counter()
        procs = [ctx.Process(target=tp_rank, args=(r, world, str(store), tag,
                                                   str(f)))
                 for r, f in enumerate(files)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(TP_JOIN_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise AssertionError(f"[27] {tag}: rank exit codes {codes}")
        recs = [json.loads(f.read_text()) for f in files]
        store.unlink(missing_ok=True)
        layers = _tp_config(tag).model.num_layers
        want = tp_launches(steps_n, layers, switch)
        for r in recs:
            for k, per in want.items():
                if r["launches"][k] != per:
                    raise AssertionError(f"[27] {tag} rank {r['rank']}: "
                                         f"{k} launched {r['launches'][k]}, "
                                         f"predicted {per}")
        for i, d in enumerate(recs[0]["digests"]):
            if not d or any(r["digests"][i] != d for r in recs[1:]):
                raise AssertionError(f"[27] {tag} step {i + 1}: a leaf held "
                                     "whole differs across model ranks")
        chk = recs[0]["check"]
        if switch:
            if any(r["wlfl"] != recs[0]["wlfl"] for r in recs[1:]):
                raise AssertionError(f"[27] {tag}: <WL,FL> differ across "
                                     "ranks")
            if chk["wlfl_one_process"] != recs[0]["wlfl"]:
                raise AssertionError(f"[27] {tag}: <WL,FL> differ from the "
                                     "one process's switch")
        var = chk["variants"]
        found = {}
        for name, v in var.items():
            if name.startswith("rank_order"):
                ro = v["rank_order"]
                if ro["layers"] == 0 or ro["calls"] != ro["layers"]:
                    raise AssertionError(f"[27] {tag} {name}: summed {ro}, "
                                         "not each row-parallel weight once")
            for key in ("vs_ranks", "vs_plain"):
                if key in v:
                    e = v[key]
                    worst = max(e, key=e.get)
                    found[f"{name} {key}"] = (e[worst], worst)
            if "vs_ranks" in v:
                found[f"{name} loss"] = (abs(recs[0]["metrics"][0]["loss"]
                                             - v["loss"]) / abs(v["loss"]),
                                         "loss")
        log(f"[27] {tag}: the first step's updates, worst leaf normwise, "
            "and losses: " + "; ".join(f"{k} {x:.3g} ({p})"
                                       for k, (x, p) in found.items()))
        bounds = {"rank_order vs_ranks": TP_ORDER_NORMWISE,
                  "one vs_ranks": TP_PLAIN_NORMWISE,
                  "rank_order_act_off vs_plain": TP_CONTROL_NORMWISE,
                  "rank_order loss": TP_ORDER_LOSS_RTOL,
                  "one loss": TP_LOSS_RTOL}
        for k, bound in bounds.items():
            if k in found and not found[k][0] <= bound:
                raise AssertionError(f"[27] {tag}: {k} {found[k][0]:.3g} "
                                     f"past {bound}")
        out[tag] = {"arch": arch, "layers": layers, "ranks": recs,
                    "seconds": time.perf_counter() - t0,
                    "against_one_process": {k: x for k, (x, _) in
                                            found.items()},
                    "held_whole_leaves": len(recs[0]["digests"][0])}
        log(f"[27] {smi} | {tag}: {arch} depth {layers}, mesh {TP_MESH}, "
            "step ms a rank "
            + ", ".join("/".join(f"{x:.0f}" for x in r["step_ms"])
                        for r in recs)
            + f", switch {recs[0]['switch_ms']} ms, peak GiB a rank "
            + "/".join(f"{r['peak_gib']:.2f}" for r in recs)
            + f", init {recs[0]['init_s']:.1f} s, bytes handed a step "
            f"(rank 0) {recs[0]['sent_bytes']}; "
            f"{out[tag]['held_whole_leaves']} leaves held whole bit-equal; "
            f"check {chk['seconds']:.1f} s; {out[tag]['seconds']:.1f} s")
    return out


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
    spill_free(reports, {"fxp_matmul": "fxp_matmul_gemv",
                         "int8_matmul": "int8_matmul_tc",
                         "sr_quantize": "sr_grid_kernel",
                         "edf_ladder": "edf_ladder_kernel"})

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

    # 16. remat and accumulation on the packed path; 17. the registry's
    # config; 18. checkpoints
    remat_res = remat_accum_path(torch)
    mark("16 remat accum")
    remat_depth2 = remat_accum_card_vs_cpu(torch)
    mark("16 remat accum depth 2")
    registry_res = registry_path(torch)
    mark("17 registry config")
    ckpt_res = checkpoint_path(torch)
    mark("18 checkpoint")

    # 19. the CNN family: AlexNet and ResNet20
    cnn_res = cnn_path(torch, sq, el)
    mark("19 cnn")

    # 20. the continuous batcher on the phase-4 model; card against CPU
    batcher_res = batcher_path(torch, fm)
    mark("20 batcher")
    batcher_depth2 = batcher_card_vs_cpu(torch)
    mark("20 batcher depth 2")

    # 21. the dense family: every new shape, smollm-360m, granite-8b
    family_rows = check_family_shapes(torch, fm, fa, sq, el, gen)
    mark("21 family shapes")
    smollm_res = smollm_path(torch, fm, fa)
    mark("21 smollm-360m")
    granite_res = granite_path(torch, fm, fa)
    mark("21 granite-8b")

    # 22. gemma2-2b at full width and depth; its smoke config card vs CPU
    gemma_rows = gemma2_shapes(torch, fm, fa, gen)
    mark("22 gemma2 shapes")
    gemma_res = gemma2_path(torch, fm, fa)
    mark("22 gemma2-2b")
    gemma_depth2 = gemma2_card_vs_cpu(torch)
    mark("22 gemma2 smoke vs CPU")

    # 23. the MoE layer: mixtral-8x22b and arctic-480b; smoke configs vs CPU
    moe_rows = moe_shapes(torch, fm, fa, sq, gen)
    mark("23 moe shapes")
    mixtral_serve = mixtral_serving(torch, fm, fa)
    mark("23 mixtral serving")
    mixtral_train = mixtral_training(torch)
    mark("23 mixtral training")
    arctic_res = arctic_path(torch, fm, fa)
    mark("23 arctic-480b")
    moe_depth2 = moe_card_vs_cpu(torch)
    mark("23 moe smoke vs CPU")

    # 24. the SSM family: mamba2-780m and zamba2-7b; smoke configs vs CPU
    ssm_rows = ssm_shapes(torch, fm, fa, gen)
    mark("24 ssm shapes")
    mamba_res = mamba2_path(torch, fm, fa)
    mark("24 mamba2-780m")
    zamba_res = zamba2_path(torch, fm, fa)
    mark("24 zamba2-7b")
    ssm_depth2 = ssm_card_vs_cpu(torch)
    mark("24 ssm smoke vs CPU")

    # 25. cross-attention and the encoder: llama-3.2-vision-11b,
    # hubert-xlarge; smoke configs vs CPU
    cross_rows = cross_encoder_shapes(torch, fm, fa, gen)
    mark("25 shapes")
    vlm_res = vlm_path(torch, fm, fa)
    mark("25 llama-3.2-vision-11b")
    hubert_res = hubert_path(torch)
    mark("25 hubert-xlarge")
    cross_depth2 = cross_encoder_card_vs_cpu(torch)
    mark("25 smoke vs CPU")

    # 26. the data-parallel mesh: the per-shard SR kernels at full width;
    # two ranks sharing the card over gloo (ZeRO blocks, QSGD across pods)
    shard_rows = sharded_kernels(torch)
    mark("26 per-shard kernels")
    torch.cuda.empty_cache()
    dp_res = dp_path(torch)
    mark("26 two ranks")

    # 27. tensor and expert parallelism: two model ranks sharing the card
    # over gloo (llama3.2-3b tensor-parallel, mixtral-8x22b expert-parallel)
    torch.cuda.empty_cache()
    tp_res = tp_path(torch, smi)
    mark("27 model axis")

    runs = [main_res["launches"], train_res["launches"], sr_res["launches"],
            *(r["launches"] for r in float_res.values()),
            prologue_res["launches"], default_res["launches"],
            default_res["ops_launches"]]
    later = [*(r["launches"] for r in remat_res["modes"].values()),
             remat_res["accum_1"]["launches"],
             remat_res["accum_8_first"]["launches"],
             remat_res["accum_8_launches"], registry_res["launches"],
             ckpt_res["launches"]]
    batchers = [batcher_res["burst"], batcher_res["again"],
                batcher_res["isolation"], batcher_res["faults"],
                batcher_res["recovery"], smollm_res["batcher"],
                granite_res["batcher"]]
    family = [*(b["launches_at_construction"] for b in batchers),
              smollm_res["engine"]["launches"],
              smollm_res["sr_train"]["launches"],
              smollm_res["registry"]["launches"],
              granite_res["engine"]["launches"]]
    slice_16 = [gemma_res["engine"]["launches"],
                gemma_res["batcher"]["launches_at_construction"],
                gemma_res["sr_train"]["launches"],
                mixtral_serve["engine"]["launches"],
                mixtral_serve["batcher"]["launches_at_construction"],
                mixtral_train["launches"], arctic_res["engine"]["launches"],
                arctic_res["registry"]["launches"]]
    slice_17 = [*(r[k]["launches"] for r in (mamba_res, zamba_res)
                  for k in ("engine", "sr_train")),
                *(r["batcher"]["launches_at_construction"]
                  for r in (mamba_res, zamba_res)),
                mamba_res["prologue"]["launches"],
                mamba_res["registry"]["launches"]]
    slice_18 = [vlm_res["engine"]["launches"], vlm_res["sr_train"]["launches"],
                hubert_res["sr_train"]["launches"],
                hubert_res["registry"]["launches"]]
    kernels = kernel_record(runs, later, fxp_rows, fxp_err, flash_rows,
                            flash_err, bwd_rows, bwd_err, fbwd_rows, fbwd_err,
                            sr_rows, edf_rows, grid_rows, q_rows, q_err,
                            ops_rows, cnn_res, family, slice_16, slice_17,
                            slice_18, shard_rows, dp_res, tp_res)

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
        "remat_accum": remat_res, "remat_accum_depth2": remat_depth2,
        "registry": registry_res, "checkpoint": ckpt_res, "cnn": cnn_res,
        "batcher": batcher_res, "batcher_depth2": batcher_depth2,
        "family_shapes": family_rows, "smollm": smollm_res,
        "granite": granite_res, "gemma2_shapes": gemma_rows,
        "gemma2": gemma_res, "gemma2_smoke_vs_cpu": gemma_depth2,
        "moe_shapes": moe_rows, "mixtral_serving": mixtral_serve,
        "mixtral_training": mixtral_train, "arctic": arctic_res,
        "moe_smoke_vs_cpu": moe_depth2, "ssm_shapes": ssm_rows,
        "mamba2": mamba_res, "zamba2": zamba_res,
        "ssm_smoke_vs_cpu": ssm_depth2, "cross_encoder_shapes": cross_rows,
        "vlm": vlm_res, "hubert": hubert_res,
        "cross_encoder_smoke_vs_cpu": cross_depth2,
        "sharded_kernels": shard_rows, "data_parallel": dp_res,
        "tensor_parallel": tp_res,
        "kernels": kernels,
        "phase_seconds": marks, "check_seconds": check_s,
        "seconds": time.perf_counter() - t_start}, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_record(runs, later, fxp_rows, fxp_err, flash_rows, flash_err,
                  bwd_rows, bwd_err, fbwd_rows, fbwd_err, sr_rows, edf_rows,
                  grid_rows, q_rows, q_err, ops_rows, cnn_res, family,
                  slice_16, slice_17, slice_18, shard_rows, dp_res, tp_res):
    """One entry per kernel. ``launches`` sums the counts of the main
    paths' runs of phases 4-14 (``runs``); ``launches_16_18`` those of the
    counted runs of phases 16-18 (``later``: remat, accumulation at
    M = 512, the registry's config, the checkpoint run), whose shapes
    the times below do not cover. Every time sums the kernel's launches in those
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
    times of ``check_matmul_bwd``. ``launches_19`` counts the counted runs
    of phase 19 (the CNN family); ``sr_quantize_fused``,
    ``sr_quantize_fused_int8`` and ``edf_ladder_hists``, the only kernels
    it launches, add ``cnn_19``:
    their times summed over those launches from the per-shape times of
    ``cnn_kernel_shapes``. ``launches_20_21`` counts the launches of the
    counted runs of phases 20 and 21 (``family``: each batcher's warm-up
    decode at construction; smollm-360m's and granite-8b's ``Engine``
    runs, smollm's SR steps and registry config). The GEMV calls recorded
    into the batchers' graphs and replayed are in no count here: the JSON
    file holds, per batcher, the calls recorded at capture and the GEMV
    events the profiler saw in 8 replays. The per-shape times of phases
    20 and 21 are ``check_family_shapes``'s rows in the JSON file.
    ``launches_22_23`` counts those of phases 22 and 23 (``slice_16``:
    gemma2-2b's, mixtral-8x22b's and arctic-480b's ``Engine`` runs, the
    batchers' warm-up decodes, gemma2's and mixtral's SR steps, arctic's
    registry config), whose per-shape times are ``gemma2_shapes``'s and
    ``moe_shapes``'s rows in the JSON file. ``launches_24`` counts those
    of phase 24 (``slice_17``: mamba2-780m's and zamba2-7b's ``Engine``
    runs, SR steps and batchers' warm-up decodes, mamba2's prologue step
    and registry config), whose per-shape times are ``ssm_shapes``'s rows
    in the JSON file. ``launches_25`` counts those of phase 25
    (``slice_18``: llama-3.2-vision-11b's ``Engine`` run and SR steps,
    hubert-xlarge's SR steps and registry config), whose per-shape times
    are ``cross_encoder_shapes``'s rows in the JSON file.
    ``launches_26`` counts those of phase 26's two-rank runs (both ranks
    of both meshes, ``DP_RUNS``); the four fused SR kernels add
    ``sharded_26``: phase 26 (a)'s per-shard launches (one per distinct
    block of each full-width leaf and mesh, the model-axis meshes among
    them), their times, plain times and bounds summed. ``launches_27``
    counts those of phase 27's runs (both ranks of both, ``TP_RUNS``)."""
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
    launches_later = {k: sum(run.get(k, 0) for run in later) for k in KERNELS}
    launches_family = {k: sum(run.get(k, 0) for run in family)
                       for k in KERNELS}
    launches_slice_16 = {k: sum(run.get(k, 0) for run in slice_16)
                         for k in KERNELS}
    launches_slice_17 = {k: sum(run.get(k, 0) for run in slice_17)
                         for k in KERNELS}
    launches_slice_18 = {k: sum(run.get(k, 0) for run in slice_18)
                         for k in KERNELS}
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

    # phase 19: per run, each quantized leaf's shape once a step (the float
    # SR grid values) and its switch input's once a switch (the ladder)
    cnn_calls = {"sr_quantize_fused": {}, "sr_quantize_fused_int8": {},
                 "edf_ladder_hists": {}}
    for run in cnn_res["runs"].values():
        for kernel, per in (("sr_quantize_fused", CNN_STEPS + CNN_WINDOW),
                            ("sr_quantize_fused_int8", CNN_STEPS + CNN_WINDOW),
                            ("edf_ladder_hists", CNN_STEPS // 2)):
            for shape, c in run.get("leaf_shapes", {}).get(kernel, {}).items():
                cnn_calls[kernel][shape] = cnn_calls[kernel].get(shape, 0) \
                    + c * per
    cnn_19 = {k: {"launches": sum(c.values()),
                  **summed(cnn_res["kernel_shapes"][k], c)}
              for k, c in cnn_calls.items()}
    for k, rec in cnn_19.items():
        if rec["launches"] != cnn_res["launches"][k]:
            raise AssertionError(f"phase 19 {k}: {rec['launches']} launches "
                                 f"timed, {cnn_res['launches'][k]} counted")

    launches_26 = {k: sum(r["launches"][k] for run in dp_res.values()
                          for r in run["ranks"]) for k in KERNELS}
    launches_27 = {k: sum(r["launches"][k] for run in tp_res.values()
                          for r in run["ranks"]) for k in KERNELS}
    sharded_26 = {}
    for row in shard_rows:
        acc = sharded_26.setdefault(row["kernel"], {
            "blocks": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": row["bound_by"]})
        acc["blocks"] += 1
        for key in ("ms", "plain_ms", "bound_ms"):
            acc[key] += row[key]

    def entry(name, source, replaces, err, times):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": launches[name],
                "launches_16_18": launches_later[name],
                "launches_19": cnn_res["launches"][name],
                "launches_20_21": launches_family[name],
                "launches_22_23": launches_slice_16[name],
                "launches_24": launches_slice_17[name],
                "launches_25": launches_slice_18[name],
                "launches_26": launches_26[name],
                "launches_27": launches_27[name], "max_abs_err": err,
                **times, **({"cnn_19": cnn_19[name]} if name in cnn_19
                            else {}),
                **({"sharded_26": sharded_26[name]} if name in sharded_26
                   else {})}

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
              summed(stacked_by_shape, stacked_calls, ("device_ms",))),
        entry("sr_quantize_fused_int8", "sr_quantize.cu", "sr_quantize.py:188",
              0.0, summed(flat_by_shape, flat_calls, ("device_ms",))),
        entry("edf_ladder_hists", "edf_ladder.cu", "edf_ladder.py:41", 0.0,
              summed(edf_by_shape, edf_calls, device_keys)),
        entry("sr_quantize_fused_stacked", "sr_quantize.cu",
              "sr_quantize.py:282", 0.0, summed(gs_by, gs_calls, device_keys)),
        entry("sr_quantize_fused", "sr_quantize.cu", "sr_quantize.py:174", 0.0,
              summed(gf_by, gf_calls, device_keys)),
        entry("fxp_qmatmul", "fxp_qmatmul.cu", "fxp_matmul.py:345",
              q_err["fxp_qmatmul"],
              summed(by_shape(q_rows["fxp_qmatmul"]), prologue_calls,
                     device_keys)),
        entry("matmul_qdx", "fxp_qmatmul.cu", "fxp_matmul.py:408",
              q_err["matmul_qdx"],
              summed(by_shape(q_rows["matmul_qdx"]), prologue_calls,
                     device_keys)),
        entry("sr_quantize", "sr_quantize.cu", "sr_quantize.py:66", 0.0,
              summed(given_by, given_calls, ("device_ms",))),
        entry("int8_matmul", "int8_matmul.cu", "fxp_matmul.py:145", 0.0,
              {**summed(by_shape(ops_rows["int8_matmul"]), i8_calls,
                        device_keys + ("library_ms_row_major",
                                       "library_ms_col_major",
                                       "library_device_ms_row_major",
                                       "library_device_ms_col_major")),
               "library_covers": by_shape(ops_rows["int8_matmul"])[
                   (TRAIN_M, D_MODEL, D_FF)]["library_covers"]}),
        entry("kl_hist", "kl_hist.cu", "kl_hist.py:27", 0.0,
              {**summed(kl_by, kl_calls, ("device_ms",)),
               "library_covers": "two torch.histc calls (their own bin "
                                 "formula)"}),
    ]


if __name__ == "__main__":
    raise SystemExit(main())

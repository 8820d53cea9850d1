"""Config system for the repro framework.

Plain dataclasses (no external deps), a registry populated by
``repro_torch.configs``, and dotted-path CLI overrides:

    cfg = load_config("granite-8b", shape="train_4k",
                      overrides=["quant.mode=native_int8", "train.steps=100"])
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# ---------------------------------------------------------------------------
# Model


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio | cnn
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 512
    # attention flavour
    attn_pattern: Tuple[str, ...] = ("global",)   # cycled over layers: global|local
    window_size: int = 4096                       # for "local"/SWA layers
    attn_logit_softcap: float = 0.0               # gemma2: 50.0
    final_logit_softcap: float = 0.0              # gemma2: 30.0
    rope_theta: float = 10000.0
    use_qk_norm: bool = False
    # layer kind pattern (cycled): attn | mamba | cross  — transformer block kind
    layer_pattern: Tuple[str, ...] = ("attn",)
    shared_attn_weights: bool = False             # zamba2: attn blocks share weights
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                             # 0 -> d_ff
    dense_residual_d_ff: int = 0                  # arctic: parallel dense FFN
    capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # VLM
    cross_attn_every: int = 0                     # >0: cross-attn block every k layers
    num_image_tokens: int = 1024                  # stub frontend output length
    # audio / encoder
    is_encoder: bool = False
    num_input_frames: int = 1024                  # stub frontend output length
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embed: bool = False                     # gemma2: embed * sqrt(d)
    act_fn: str = "silu"                          # silu | gelu
    use_post_norm: bool = False                   # gemma2 post-attn/ffn norms

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return all(k == "mamba" for k in self.layer_pattern)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs: every layer is mamba or windowed attention."""
        if self.is_encoder:
            return False
        if any(k == "cross" for k in self.layer_pattern):
            return False
        kinds = set(self.layer_pattern)
        if kinds == {"mamba"}:
            return True
        if "attn" in kinds and all(p == "local" for p in self.attn_pattern):
            return True
        # hybrid: mamba + (any) attention is fine — attention layers are few
        return "mamba" in kinds


# ---------------------------------------------------------------------------
# Quantization (AdaPT)


@dataclass(frozen=True)
class QuantConfig:
    # off: no quantize, no controller state, qparams = params. simulate:
    # grid values in a float container (paper-faithful). native_int8:
    # int8 words + 2^-FL scale; with container_dtype="int8_packed" the
    # words travel the mesh as 1-byte payloads AND feed the dense Pallas
    # kernels directly (see use_pallas below).
    mode: str = "simulate"        # off | simulate | native_int8
    init_wl: int = 8
    init_fl: int = 4
    buff: int = 4                 # buffer bits (paper §3.3)
    max_wl: int = 32
    r_lwr: int = 50
    r_upr: int = 150
    lb_lwr: int = 25
    lb_upr: int = 100
    gamma: float = 0.33           # lookback momentum
    eps_kl: float = 1e-2          # "KL == 0" tolerance (bits)
    strategy: str = "mean"        # initial push-up strategy: min | mean | max
    # quantize_activations: per-slot dynamic-range activation quantize at
    # the layer's WL (STE gradient). Purely elementwise — it never changes
    # kernel dispatch (the flash/dense kernels see the quantized values).
    quantize_activations: bool = True
    # stochastic_rounding=False forces RTN everywhere, which ALSO disables
    # the in-kernel-PRNG quantize (controller._use_fused_prng: the fused
    # kernel is an SR kernel) — RTN leaves take the deterministic XLA path.
    # Dense-prologue leaves stay on the kernel path either way (mode 0 is
    # in-kernel round-half-even, bit-identical to the XLA jnp.round path).
    stochastic_rounding: bool = True
    edf_sample: int = 65536       # PushDown EDF subsample size per tensor
    loss_hist_len: int = 128      # ring buffer for strategy adaptation
    # container dtype of the quantized forward copy. float32 = bit-exact
    # ⟨WL,FL⟩ grid for all WL≤24 (paper-faithful / QPyTorch-equivalent);
    # bfloat16 halves every weight gather/all-reduce byte but is only exact
    # for WL≤8 (8-bit mantissa) — beyond-paper §Perf lever, deviation
    # documented in EXPERIMENTS.md. int8 = int8 words dequantized at the
    # producer; int8_packed = lazy ⟨q8, sc, wref⟩ dicts dequantized at the
    # USE site (weights cross the mesh as 1 byte/param) — and the ONLY
    # container that feeds the dense Pallas kernel path (use_pallas below):
    # float-container grids always reach the model as plain XLA tensors.
    container_dtype: str = "float32"
    # sub-tensor exclusions (substring match on param path): these leaves
    # are never quantized and always reach the model as plain arrays —
    # independent of every dispatch flag below.
    exclude: Tuple[str, ...] = ("router", "norm", "a_log", "dt_bias", "scale")
    # --- Pallas dispatch flags -------------------------------------------
    # use_pallas routes the WHOLE train step through the fused TPU kernels
    # (interpret mode on CPU, so CI exercises the same code):
    #   * quantize_params / quantize_params_packed → sr_quantize_fused[:_int8]
    #   * precision_switch's PushDown ladder        → edf_ladder_hists
    #   * the model forward's attention              → flash_attention
    #   * the model's DENSE LAYERS (container_dtype="int8_packed"):
    #     models/common.dense feeds packed/prologue leaves straight to the
    #     fxp kernels — forward streams int8 weight tiles into the MXU
    #     (dequant in-register), dx streams the SAME tiles through a
    #     transposed index map, dw = xᵀ@dy lands straight-through on the
    #     master (kernels/ops.fxp_dense / fxp_qdense) — no dequantized
    #     weight copy exists in HBM; tests/test_dense_path.py asserts the
    #     jaxpr has fwd+dx+dw per dense layer and ZERO dequantized-weight
    #     XLA matmuls.
    #     — all of it UNDER value_and_grad: every forward op carries a
    #     custom VJP whose backward passes are Pallas kernels, pinned by
    #     tests/test_vjp_differential.py + tests/test_dense_path.py.
    # Any layer shape is eligible — primes included: the gridded kernels
    # tail-mask partial boundary blocks in-register (no divisibility
    # restriction, no whole-dim VMEM fallback; tests/test_tailmask.py).
    # Remaining exclusions: attention slots whose window arrives as a traced
    # scalar (masked XLA path), the CNN family's conv forward, non-2-D
    # quantized leaves that no dense layer consumes (embed tables, depthwise
    # conv kernels, MoE expert einsum operands — dequantized at their use
    # site as before; fixed_point.DENSE_PARAM_NAMES), and unevenly-sharded /
    # RTN-mode quantize leaves (controller._use_fused_prng).
    use_pallas: bool = False
    # fused_prng draws the stochastic-rounding noise INSIDE the quantize
    # kernel (hardware PRNG on TPU, counter-hash under interpret), so the
    # param-sized U[0,1) tensor never exists in HBM: 2 HBM transfers per
    # tensor instead of ~4. Only consulted when use_pallas is set. All
    # three leaf regimes are served (controller._use_fused_prng): scalar
    # ⟨WL,FL⟩, per-layer-stacked (L,)-vector precision (one stacked-kernel
    # launch per "blocks" leaf), and evenly-sharded leaves (shard_map-
    # wrapped kernel with per-shard folded seeds, zero collectives).
    # Noise streams are deterministic per step key but differ from the
    # jax.random stream the XLA path uses — same distribution, not same bits.
    fused_prng: bool = True
    # dense_prologue (OPT-IN) fuses the QUANTIZE into the dense matmul
    # PROLOGUE
    # (kernels/fxp_matmul.fxp_qmatmul): dense-consumed leaves skip word
    # materialization entirely — the "quantized copy" is the master plus
    # ⟨seed, FL, mode⟩, and int8 tiles are drawn in VMEM en route to the
    # MXU, killing the q8 HBM write+read-back round trip (ROADMAP's fused
    # quantize-into-matmul item). Only consulted when use_pallas is set
    # and container_dtype="int8_packed"; non-dense quantized leaves keep
    # the materialized container either way. SR always uses the PORTABLE
    # index-hash stream — a pure function of ⟨seed, element index⟩, so
    # the fwd and dx recompute agree on every word even though they tile
    # the weight differently. On CPU/interpret that makes prologue words
    # bit-identical to sr_quantize_fused_int8 on 2-D leaves; on compiled
    # TPU the MATERIALIZED kernel draws from the hardware PRNG instead,
    # so the two dispatches are same-distribution, not same-bits (same
    # caveat as fused_prng above). RTN (serving / SR off) is
    # round-half-even, bit-identical to the XLA packed path everywhere. Explicitly-
    # sharded dense leaves are EXCLUDED (they keep the materialized packed
    # container): pallas_call has no SPMD partitioning rule, and a
    # prologue dict on a mesh would gather the f32 master into every
    # launch (controller._use_dense_prologue; ROADMAP open item). Off by
    # default: the prologue re-reads the f32 MASTER once per M-block where
    # the materialized path re-reads 1-byte words, so plain HBM-bytes
    # arithmetic favors materialized words whenever the M grid has more
    # than ~2 blocks (large-batch training); enable it for
    # quantize-round-trip-bound regimes (the bench train_step rows
    # measure both). Serving always materializes regardless
    # (serve/engine.quantize_for_serving).
    dense_prologue: bool = False


# ---------------------------------------------------------------------------
# Serving (admission control / overload behavior / degradation)


@dataclass(frozen=True)
class ServeConfig:
    """Overload/robustness knobs for the continuous batcher (serve/).

    Admission control: the queue is bounded (``max_queue``; 0 = unbounded)
    and prompts that cannot fit ``max_context`` are rejected at submit()
    with a typed reason instead of silently wrapping the ring cache.
    ``default_timeout`` (seconds, 0 = off) attaches a deadline to requests
    submitted without one; queued requests whose deadline passes are
    expired with status ``timed_out``.

    Fault handling: a request whose slot produces non-finite logits (or
    whose decode step raises transiently) is re-admitted from scratch up to
    ``retry_budget`` times before being marked ``failed``; a raising decode
    is retried in-step ``transient_retries`` times first.

    Degradation (AdaBits-style, 1912.09666): under queue pressure the
    batcher swaps the active qparams tree to a lower word length from
    ``degrade_levels`` (descending; pre-materialized at load — same pytree
    structure, so the jitted decode never recompiles) and recovers when the
    queue drains, with ``degrade_patience`` consecutive observations of
    pressure/drain required per step (hysteresis). Pressure = queue depth
    ≥ ``degrade_high_watermark`` or (if ``degrade_p95_ms`` > 0) p95 queue
    wait above it; drain = depth ≤ ``degrade_low_watermark``."""
    slots: int = 4
    max_context: int = 256
    max_queue: int = 64
    default_timeout: float = 0.0
    retry_budget: int = 2
    transient_retries: int = 2
    journal_dir: str = ""             # append-only request journal ("" = off)
    degrade_levels: Tuple[int, ...] = (8, 6, 4)
    degrade_high_watermark: int = 8
    degrade_low_watermark: int = 1
    degrade_p95_ms: float = 0.0
    degrade_patience: int = 2


# ---------------------------------------------------------------------------
# Optimizer / training


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "asgd"            # asgd | sgd | adam
    lr: float = 0.05
    momentum: float = 0.0         # paper's ASGD is momentum-free
    beta1: float = 0.9
    beta2: float = 0.999
    adam_eps: float = 1e-8
    l1: float = 1e-6              # sparsifying L1 (paper)
    l2: float = 1e-5              # elastic-net L2 (paper)
    penalty_coef: float = 1e-4    # P = WL/32 * sp (paper §3.4)
    grad_normalize: bool = True   # per-tensor L2 grad normalization (paper)
    grad_clip: float = 0.0
    # ROP scheduler (paper §4.1)
    rop_factor: float = 0.5
    rop_patience: int = 10
    rop_threshold: float = 1e-3


@dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 4096
    global_batch: int = 256
    microbatch_per_device: int = 1
    accum_steps: int = 1
    accum_dtype: str = "float32"  # bfloat16 halves the grad accumulator
                                  # (arctic-480b HBM headroom; DESIGN.md §3)
    steps: int = 100
    log_every: int = 10
    adapt_interval: int = 0       # 0 -> lb_lwr; cadence of precision_switch
    remat: str = "none"           # none | full | selective
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    zero_shard: bool = False      # shard master/opt state over data axis too
    fsdp: str = "auto"            # auto (by tensor size) | on | off — fold
                                  # the data axis into weight shardings
    tp_reduce_dtype: str = "float32"  # bfloat16 halves TP partial-sum
                                      # all-reduce bytes (§Perf lever)
    qsgd_pod_compression: bool = False  # int8 all-reduce across "pod" axis
    qsgd_bits: int = 8
    seed: int = 0
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    straggler_factor: float = 3.0


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (1, 1)
    axes: Tuple[str, ...] = ("data", "model")
    # attention q-seq sharding over `model` when heads don't divide the TP
    # degree (smollm 15H, llama3.2 24H, gemma2 8H, arctic 56H on 16-way):
    # off = replicate attention (naive-TP baseline), auto = shard q-seq iff
    # heads indivisible, on = always. §Perf hillclimb lever.
    seq_shard_attn: str = "off"   # off | auto | on
    # wk/wv sharding when kv heads don't divide the TP degree: "shard" =
    # col-shard the flat projection (baseline; forces K/V activation
    # all-gathers every layer), "replicate" = keep the small wk/wv
    # replicated (no gathers, redundant kv-proj compute). §Perf lever.
    kv_proj: str = "shard"        # shard | replicate
    # decode KV-cache layout when kv heads don't divide the TP degree:
    # "heads" replicates the cache over model (baseline; attention gathers
    # the full cache every layer), "seq" shards the cache SEQUENCE over
    # model (split-KV decode: only per-head softmax stats cross chips).
    decode_kv_shard: str = "heads"  # heads | seq

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class Config:
    arch: str = "tiny"
    shape: str = "train_4k"
    model: ModelConfig = field(default_factory=ModelConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)


# ---------------------------------------------------------------------------
# Assigned input-shape sets (LM family; spec'd per task)

SHAPES = {
    "train_4k":    dict(kind="train",   seq_len=4096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524288, global_batch=1),
}


def shape_kind(shape: str) -> str:
    return SHAPES[shape]["kind"]


# ---------------------------------------------------------------------------
# Overrides & registry


def _coerce(current: Any, raw: str) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        items = [s for s in raw.split(",") if s]
        if current and isinstance(current[0], int):
            return tuple(int(s) for s in items)
        return tuple(items)
    return raw


def apply_overrides(cfg: Config, overrides) -> Config:
    """Apply ["a.b.c=v", ...] dotted overrides to a frozen Config."""
    for ov in overrides or ():
        path, _, raw = ov.partition("=")
        keys = path.strip().split(".")
        objs = [cfg]
        for k in keys[:-1]:
            objs.append(getattr(objs[-1], k))
        value: Any = _coerce(getattr(objs[-1], keys[-1]), raw.strip())
        for parent, k in zip(reversed(objs), reversed(keys)):
            value = dataclasses.replace(parent, **{k: value})
        cfg = value
    return cfg


def with_shape(cfg: Config, shape: str) -> Config:
    s = SHAPES[shape]
    return dataclasses.replace(
        cfg, shape=shape,
        train=dataclasses.replace(cfg.train, seq_len=s["seq_len"],
                                  global_batch=s["global_batch"]))


def load_config(arch: str, shape: Optional[str] = None, overrides=None) -> Config:
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if shape:
        cfg = with_shape(cfg, shape)
    return apply_overrides(cfg, overrides)


def config_summary(cfg: Config) -> str:
    m = cfg.model
    return (f"{cfg.arch}[{m.family}] L={m.num_layers} d={m.d_model} "
            f"H={m.num_heads}/{m.num_kv_heads} ff={m.d_ff} V={m.vocab_size} "
            f"shape={cfg.shape} quant={cfg.quant.mode}")

"""llama-3.2-vision-11b, the VLM (a cross-attention slot every
``cross_attn_every`` layers over precomputed image-patch embeddings),
against the JAX reference on the CPU, on its smoke config (4 layers, a
cross slot every 2, M = 16 image tokens): its config field for field,
``project_memory`` and ``cross_attend`` (k/v in f32 as the forward makes
them and in bf16 as the decode cache holds them), the forward with memory
(packed words under ``quant.use_pallas``, the port's plain kernel versions
against interpret-mode Pallas; and the float32 container), greedy serving
through the ``Engine`` with memory, ``_merge_prefill_caches`` with prompts
shorter and longer than the memory, one packed SR training step, the
continuous batcher, the image-memory batches and the training launcher.

Tolerances: the memory projection in f32 within 1e-5 relative (summation
order); the bf16 outputs of a cross slot within 2^-7 of the largest |x|
(a bf16 ulp of the residual stream: the port rounds as the reference
compiled without excess precision rounds, up to f32 summation order);
logits within 2^-5 of the reference's largest logit, and greedy tokens
equal; the step as ``tests/test_torch_dense_family.py`` holds its: the
loss within 2e-3, the gradient norm and every leaf's master update and
``grad_sum`` within 2e-2 normwise, against the reference's step compiled
without excess precision.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import apply_overrides as jax_apply_overrides  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.core import controller as jax_controller  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.serve import scheduler as jax_scheduler  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import apply_overrides  # noqa: E402
from repro_torch.configs import (get_config, get_smoke_config,  # noqa: E402
                                 list_archs, llama3_2_vision_11b)
from repro_torch.core import controller  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.serve import engine, scheduler  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

ARCH = "llama-3.2-vision-11b"
SERVE_OVERRIDES = ["quant.container_dtype=int8_packed",
                   "quant.use_pallas=true", "quant.init_fl=8"]
STEP_OVERRIDES = SERVE_OVERRIDES + [
    "train.global_batch=2", "train.seq_len=16", "train.remat=none",
    "train.accum_steps=1"]
B, S, NEW = 2, 12, 4
M = 16                        # the smoke config's image tokens
LOSS_RTOL = 2e-3
UPDATE_NORMWISE = 2e-2
COMPILE = {"xla_allow_excess_precision": False,
           "xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _normwise(got, want, rtol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.linalg.norm((got - want).ravel()))
    assert err <= rtol * float(np.linalg.norm(want.ravel())), (what, err)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=COMPILE)


def _ref_params(jcfg, seed):
    """The reference's ``init_params``, jitted: the same threefry draws as
    its eager call, in less time."""
    return jax.jit(jax_transformer.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg.model)


def _both(overrides, seed):
    jcfg = jax_apply_overrides(jax_get_smoke(ARCH), overrides)
    cfg = apply_overrides(get_smoke_config(ARCH), overrides)
    jp = _ref_params(jcfg, seed)
    js = jax_controller.init_adapt_state(jp, jcfg.quant)
    return (jcfg, cfg, jp, js, interop.params_from_numpy(_np(jp), "cpu"),
            interop.adapt_state_from_numpy(_np(js), "cpu"))


def _memory(seed, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, M, 64)).astype(np.float32)


def test_config_equals_the_references():
    assert ARCH in list_archs()
    ref_mod = __import__("repro.configs.llama3_2_vision_11b",
                         fromlist=["config"])
    mod = llama3_2_vision_11b
    for got, want in ((mod.config(), ref_mod.config()),
                      (mod.smoke(), ref_mod.smoke()),
                      (get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_get_smoke(ARCH))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = get_config(ARCH)
    assert (cfg.train.remat, cfg.train.accum_steps) == ("full", 8)
    plan, periods = transformer.build_plan(cfg.model)
    assert [s.kind for s in plan] == ["attn"] * 4 + ["cross"] and periods == 8


def test_params_and_controller_leaves():
    """The port's params have the reference's paths, shapes and dtypes (a
    cross slot an attention layer stacked over the periods), and the
    controller quantizes the cross slots' projections per layer; the
    cross slot's ``wo`` sets its activation word length."""
    jcfg, cfg = jax_get_smoke(ARCH), get_smoke_config(ARCH)
    want = _flat(jax.eval_shape(lambda: jax_transformer.init_params(
        jax.random.PRNGKey(0), jcfg.model)))
    params = transformer.init_params(0, cfg.model, device="cpu")
    got = _flat(params)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
    state = controller.init_adapt_state(params, cfg.quant)
    jstate = jax_controller.init_adapt_state(_ref_params(jcfg, 0),
                                             jcfg.quant)
    assert sorted(state["tensors"]) == sorted(jstate["tensors"])
    assert tuple(state["tensors"]["blocks/s1_cross/wk"]["wl"].shape) == (2,)
    acts = set(transformer.act_wl_from_state(state))
    assert acts == set(jax_transformer.act_wl_from_state(jstate))
    assert {"s0_attn", "s1_cross"} <= acts


@pytest.mark.parametrize("kv", ["float32", "bfloat16"])
def test_project_memory_and_cross_attend_match_the_reference(kv):
    """One cross layer from the reference's f32 weights: the memory's k/v
    (f32, as the forward projects them), then the slot over k/v in
    ``kv`` (f32 in the forward and training, bf16 from the decode
    cache)."""
    jcfg = jax_get_smoke(ARCH)
    m = jcfg.model
    jp = jax_attention.init_layer(jax.random.PRNGKey(3), m, 0, cross=True)
    tp = interop.params_from_numpy(_np(jp), "cpu")
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((B, S, 64)), jnp.bfloat16)
    mem = _memory(5)
    jk, jv = _compiled(lambda p, a: jax_attention.project_memory(p, a, m),
                       jp, mem)(jp, mem)
    tk, tv = attention.project_memory(tp, torch.from_numpy(mem), m)
    for g, w in ((tk, jk), (tv, jv)):
        assert g.dtype == torch.float32 and tuple(g.shape) == (B, M, 2, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))
    dt = getattr(jnp, kv)
    jk, jv = (a.astype(dt) for a in (jk, jv))
    want = np.asarray(_compiled(
        lambda p, a, b, c: jax_attention.cross_attend(p, a, m, b, c),
        jp, x, jk, jv)(jp, x, jk, jv).astype(jnp.float32))
    tx = interop.tensor_from_numpy(np.asarray(x), "cpu")
    got = attention.cross_attend(
        tp, tx, m, *(interop.tensor_from_numpy(np.asarray(a), "cpu")
                     for a in (jk, jv)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * float(np.abs(want).max()))


@pytest.mark.parametrize("container", ["int8_packed", "float32"])
def test_forward_with_memory_matches_the_reference(container):
    """The smoke model's forward over tokens and memory, from the serving
    copy of the reference's weights: int8 words under ``quant.use_pallas``
    (the memory projection on the fxp kernel's f32 branch, the
    self-attention on flash; interpret Pallas in the reference, the plain
    versions in the port), or the float32 container's grid values on the
    library path. Logits within 2^-5 of the largest."""
    overrides = [f"quant.container_dtype={container}", "quant.init_fl=8"]
    pallas = container == "int8_packed"
    jcfg, cfg, jp, js, tp, ts = _both(overrides, 6)
    tokens = np.random.default_rng(7).integers(
        0, 256, (B, S)).astype(np.int32)
    mem = _memory(8)
    jq = jax_engine.quantize_for_serving(jp, js, jcfg.quant)
    want = np.asarray(_compiled(lambda p, t, a: jax_transformer.forward(
        p, jcfg.model, tokens=t, memory=a, use_pallas=pallas),
        jq, tokens, mem)(jq, tokens, mem))
    got = transformer.forward(
        engine.quantize_for_serving(tp, ts, cfg.quant), cfg.model,
        tokens=torch.from_numpy(tokens), memory=torch.from_numpy(mem),
        use_pallas=pallas).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -5 * float(np.abs(want).max()))
    # the memory reaches the logits
    other = transformer.forward(
        engine.quantize_for_serving(tp, ts, cfg.quant), cfg.model,
        tokens=torch.from_numpy(tokens), memory=torch.zeros(B, M, 64),
        use_pallas=pallas).numpy()
    assert np.abs(other - got).max() > 2.0 ** -5 * float(np.abs(want).max())


@pytest.mark.parametrize("prompt", [S, 2 * M])
def test_engine_with_memory_matches_the_reference(prompt):
    """Greedy tokens of ``Engine.generate(..., memory=)`` equal the
    reference's, with a prompt shorter (12) and longer (32) than the
    memory's 16 tokens; the last logits within 2^-5 of the largest."""
    jcfg, cfg, jp, js, tp, ts = _both(SERVE_OVERRIDES, 0)
    tokens = np.random.default_rng(prompt).integers(
        0, 256, (B, prompt)).astype(np.int32)
    mem = _memory(prompt + 1)
    jout, jlog = jax_engine.Engine(jcfg, jp, js).generate(
        jnp.asarray(tokens), NEW, memory=jnp.asarray(mem))
    tout, tlog = engine.Engine(cfg, tp, ts, device="cpu").generate(
        torch.from_numpy(tokens), NEW, memory=torch.from_numpy(mem))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    jlog = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0,
                               atol=2.0 ** -5 * np.abs(jlog).max())


@pytest.mark.parametrize("prompt", [5, 3 * M])
def test_merge_prefill_caches_matches_the_reference(prompt):
    """Caches of a prefill of ``prompt`` tokens (seeded values) merged into
    the generation-sized buffers, bit for bit the reference's: the cross
    slot's memory k/v (M = 16 in both) copied whole, the attention slot's
    positions moved to slot pos % (prompt + 4)."""
    cfg = get_smoke_config(ARCH).model
    rng = np.random.default_rng(prompt)
    pref = {}
    for key, c in transformer.init_caches(cfg, B, prompt,
                                          device="cpu").items():
        pref[key] = {n: rng.standard_normal(tuple(t.shape)).astype(
            np.float32) for n, t in c.items()}
    jfull = jax_transformer.init_caches(jax_get_smoke(ARCH).model, B,
                                        prompt + NEW)
    want = _np(jax_engine._merge_prefill_caches(jfull, jax.tree.map(
        jnp.asarray, pref), prompt))
    full = transformer.init_caches(cfg, B, prompt + NEW, device="cpu")
    got = engine._merge_prefill_caches(
        full, {k: {n: torch.from_numpy(a).to(torch.bfloat16)
                   for n, a in c.items()} for k, c in pref.items()}, prompt)
    assert got["s1_cross"]["k"].shape[2] == M
    for key, c in want.items():
        for n, w in c.items():
            np.testing.assert_array_equal(
                got[key][n].float().numpy(), w.astype(np.float32),
                err_msg=f"{key}/{n}")


def test_packed_sr_step_matches_the_reference():
    """One training step on the smoke config with SR int8 words under
    ``quant.use_pallas`` (the same leaf seeds: the same words), the
    reference's batch (tokens and memory), from the same state."""
    overrides = STEP_OVERRIDES + ["quant.stochastic_rounding=true"]
    jcfg = jax_apply_overrides(jax_get_smoke(ARCH), overrides)
    cfg = apply_overrides(get_smoke_config(ARCH), overrides)
    jstate = jax_train_loop.init_state(jcfg)
    state = interop.train_state_from_numpy(_np(jstate), "cpu")
    p0 = _flat(_np(jstate["params"]))
    batch = jax_train_loop.make_batch(jcfg, 0)
    assert batch["memory"].shape == (2, M, 64)
    jstate, jm = _compiled(jax_train_loop.make_train_step(jcfg), jstate,
                           batch)(jstate, batch)
    state, tm = train_loop.make_train_step(cfg)(
        state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=UPDATE_NORMWISE)
    jp = _flat(_np(jstate["params"]))
    tp = _flat(interop.to_numpy(state["params"]))
    assert tp.keys() == jp.keys()
    for path in p0:
        _normwise(tp[path] - p0[path], jp[path] - p0[path], UPDATE_NORMWISE,
                  path)
    for path, jts in jstate["adapt"]["tensors"].items():
        _normwise(interop.to_numpy(
            state["adapt"]["tensors"][path]["grad_sum"]),
            np.asarray(jts["grad_sum"]), UPDATE_NORMWISE, f"grad_sum {path}")


def test_batcher_matches_the_references():
    """The batcher on the VLM smoke config (2 slots, a context of 32, the
    policy's levels), five staggered requests in each package's own
    batcher: the same statuses, stats, WL trace and outputs up to the
    near-tie rule. Neither batcher takes an image memory: the cross slots
    read the zero caches of ``init_caches``, which a reused slot gets back
    zeroed."""
    jcfg = jax_apply_overrides(jax_get_smoke(ARCH), ["quant.init_fl=8"])
    cfg = apply_overrides(get_smoke_config(ARCH), ["quant.init_fl=8"])
    jp = _ref_params(jcfg, 3)
    js = jax_controller.init_adapt_state(jp, jcfg.quant)
    tp = interop.params_from_numpy(_np(jp), "cpu")
    ts = interop.adapt_state_from_numpy(_np(js), "cpu")
    jcb = jax_scheduler.ContinuousBatcher(jcfg, jp, js, slots=2,
                                          max_context=32)
    margins = {}
    inner = jcb._decode

    def decode(qparams, tokens, caches, positions):
        logits, new = inner(qparams, tokens, caches, positions)
        lg = np.asarray(logits)
        tol = 2.0 ** -5 * float(np.abs(lg).max())
        for i, s in enumerate(jcb.slots):
            if not (s.free or s.pending):
                top2 = np.sort(lg[i])[-2:]
                margins[(s.request.rid, len(s.request.output))] = (
                    float(top2[1] - top2[0]), tol)
        return logits, new

    jcb._decode = decode
    cb = scheduler.ContinuousBatcher(cfg, tp, ts, slots=2, max_context=32,
                                     device="cpu")
    assert tuple(cb.caches["s1_cross"]["k"].shape) == (2, 2, M, 2, 16)
    prompts = [[(7 * i + j) % 256 for j in range(3 + 2 * i)]
               for i in range(5)]
    for side in (jcb, cb):
        for i, prompt in enumerate(prompts):
            side.submit(prompt, max_new_tokens=3 + i)
        side.run_until_drained()
    assert sorted(cb.terminal) == sorted(jcb.terminal)
    for rid, r in jcb.terminal.items():
        p = cb.terminal[rid]
        assert (p.status.value, p.reason) == (r.status.value, r.reason)
        for i, (a, b) in enumerate(zip(r.output, p.output)):
            if a != b:
                gap, tol = margins[(rid, i)]
                assert gap <= 2 * tol, (rid, i, r.output, p.output)
                break
        else:
            assert len(p.output) == len(r.output) == r.max_new_tokens
    assert dict(cb.stats) == dict(jcb.stats)
    assert cb.wl_trace == jcb.wl_trace
    assert float(cb.caches["s1_cross"]["k"].abs().sum()) == 0.0


def test_decode_reads_the_cross_cache_and_copies_nothing_from_the_host(
        monkeypatch):
    """The batcher captures ``decode_step`` in a CUDA graph: at per-row
    positions the cross slot reads its cache, writes nothing to it, and no
    tensor is built from host data on the decode's device."""
    cfg = apply_overrides(get_smoke_config(ARCH), SERVE_OVERRIDES)
    params = transformer.init_params(0, cfg.model, device="cpu")
    q = engine.quantize_for_serving(
        params, controller.init_adapt_state(params, cfg.quant), cfg.quant)
    caches = transformer.init_caches(cfg.model, 2, 16, device="cpu")
    for t in caches["s1_cross"].values():
        t.copy_(torch.randn(t.shape))
    before = {n: t.clone() for n, t in caches["s1_cross"].items()}
    made, real = [], torch.tensor

    def tensor(*args, **kw):
        if kw.get("device") is not None:
            made.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(torch, "tensor", tensor)
    logits, _ = transformer.decode_step(
        q, cfg.model, real([3, 5], dtype=torch.int32), caches,
        real([9, 2], dtype=torch.int32), use_pallas=True)
    assert made == []
    assert torch.isfinite(logits).all()
    for n, t in caches["s1_cross"].items():
        assert torch.equal(t, before[n]), n
    assert float(caches["s0_attn"]["k"].abs().sum()) > 0


def test_lm_batch_carries_the_image_memory():
    """``lm_batch`` of the VLM: tokens (B, S) int32 and memory (B, M, D)
    f32 N(0, 1), one batch per (seed, step), the memory apart from the
    token stream."""
    cfg = apply_overrides(get_smoke_config(ARCH), [
        "train.global_batch=4", "train.seq_len=8"])
    a = synthetic.lm_batch(cfg, 3, device="cpu")
    assert set(a) == {"tokens", "memory"}
    assert a["tokens"].shape == (4, 8) and a["tokens"].dtype == torch.int32
    assert a["memory"].shape == (4, M, 64)
    assert a["memory"].dtype == torch.float32
    again = synthetic.lm_batch(cfg, 3, device="cpu")
    for k in a:
        assert torch.equal(a[k], again[k]), k
    other = synthetic.lm_batch(cfg, 4, device="cpu")
    assert not torch.equal(a["memory"], other["memory"])
    mem = a["memory"].double()
    assert abs(float(mem.mean())) < 0.1 and abs(float(mem.std()) - 1) < 0.1
    # the memory draws from its own stream, not the tokens'
    gen = synthetic._step_generator(cfg.train.seed, 3, torch.device("cpu"))
    assert not torch.equal(a["memory"], torch.randn((4, M, 64),
                                                    generator=gen))


def test_launch_train_takes_the_arch(capsys):
    from repro_torch.launch import train as train_launcher
    assert train_launcher.main([
        "--arch", ARCH, "--smoke", "--steps", "1", "--device", "cpu",
        "--override", "train.global_batch=2", "--override",
        "train.seq_len=16", "--override", "train.log_every=1"]) == 0
    assert "step     1" in capsys.readouterr().out

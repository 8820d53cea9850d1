"""hubert-xlarge, the audio encoder (an encoder-only stack fed precomputed
frame embeddings through ``in_proj``, non-causal attention, a framewise CE
against per-frame labels), against the JAX reference on the CPU, on its
smoke config (2 layers, d 64, 4/4 heads of 16, V 32): its config field for
field, its params and controller leaves, ``forward(embeds=)`` (packed
words under ``quant.use_pallas``, the plain kernel versions against
interpret-mode Pallas, and the float32 container), the plain non-causal
flash forward and backward at hubert's full head dim D = 80 against
interpret Pallas, ``lm_loss(shift=False)`` and its gradient against
``jax.grad``, one packed SR step and one step of the registry's training
config (remat full, 2 microbatches, the QuantConfig defaults), the frame
batches, the serving stack's refusal, and the training launcher.

Tolerances: logits within 2^-5 of the reference's largest logit; the
flash kernels in f32 within 1e-5 relative (summation order); the loss and
its gradient within 1e-6 relative; the steps as
``tests/test_torch_dense_family.py`` holds its (the loss within 2e-3, the
gradient norm and every leaf's master update and ``grad_sum`` within 2e-2
normwise, against the reference's step compiled without excess
precision).
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
from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import apply_overrides  # noqa: E402
from repro_torch.configs import (get_config, get_smoke_config,  # noqa: E402
                                 hubert_xlarge, list_archs)
from repro_torch.core import controller  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine, scheduler  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

ARCH = "hubert-xlarge"
SMALL = ["train.global_batch=2", "train.seq_len=24", "train.remat=none",
         "train.accum_steps=1", "quant.init_fl=8"]
STEPS = {
    "packed_sr": SMALL + ["quant.container_dtype=int8_packed",
                          "quant.use_pallas=true"],
    # the registry's training config at the smoke size: remat full and
    # accumulation (2 microbatches of the batch of 4), the QuantConfig
    # defaults (float32 container, SR from jax.random noise)
    "registry": ["train.global_batch=4", "train.seq_len=24",
                 "train.remat=full", "train.accum_steps=2",
                 "quant.init_fl=8"],
}
B, S = 2, 24
D, V = 64, 32                 # the smoke config's width and vocabulary
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


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |v| (8-bit significand)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _ref_params(jcfg, seed):
    """The reference's ``init_params``, jitted: the same threefry draws as
    its eager call, in less time."""
    return jax.jit(jax_transformer.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg.model)


def test_config_equals_the_references():
    assert ARCH in list_archs()
    ref_mod = __import__("repro.configs.hubert_xlarge", fromlist=["config"])
    mod = hubert_xlarge
    for got, want in ((mod.config(), ref_mod.config()),
                      (mod.smoke(), ref_mod.smoke()),
                      (get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_get_smoke(ARCH))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = get_config(ARCH)
    assert (cfg.train.remat, cfg.train.accum_steps) == ("full", 8)
    m = cfg.model
    assert m.is_encoder and m.resolved_head_dim == 80 and m.act_fn == "gelu"
    assert transformer.build_plan(m)[1] == 48


def test_params_and_controller_leaves():
    """An encoder has ``in_proj`` (D, D) and no embedding; its paths,
    shapes and controller leaves are the reference's (``in_proj`` one
    ⟨WL,FL⟩ per tensor)."""
    jcfg, cfg = jax_get_smoke(ARCH), get_smoke_config(ARCH)
    want = _flat(jax.eval_shape(lambda: jax_transformer.init_params(
        jax.random.PRNGKey(0), jcfg.model)))
    params = transformer.init_params(0, cfg.model, device="cpu")
    got = _flat(params)
    assert sorted(got) == sorted(want)
    assert "embed" not in params and tuple(params["in_proj"].shape) == (D, D)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
    state = controller.init_adapt_state(params, cfg.quant)
    jstate = jax_controller.init_adapt_state(_ref_params(jcfg, 0),
                                             jcfg.quant)
    assert sorted(state["tensors"]) == sorted(jstate["tensors"])
    for path, ts in state["tensors"].items():
        assert tuple(ts["wl"].shape) == jstate["tensors"][path]["wl"].shape
    assert state["tensors"]["in_proj"]["wl"].shape == ()


@pytest.mark.parametrize("container", ["int8_packed", "float32"])
def test_forward_from_embeds_matches_the_reference(container):
    """``forward(embeds=)`` from the serving copy of the reference's
    weights: int8 words under ``quant.use_pallas`` (``in_proj`` and the
    layers on the fxp kernel, attention on the non-causal flash kernel;
    interpret Pallas in the reference, the plain versions in the port), or
    the float32 container's grid values on the library path. Logits within
    2^-5 of the largest; a change to the last frame moves the first
    frame's logits (the attention is not causal)."""
    overrides = [f"quant.container_dtype={container}", "quant.init_fl=8"]
    pallas = container == "int8_packed"
    jcfg = jax_apply_overrides(jax_get_smoke(ARCH), overrides)
    cfg = apply_overrides(get_smoke_config(ARCH), overrides)
    jp = _ref_params(jcfg, 2)
    js = jax_controller.init_adapt_state(jp, jcfg.quant)
    jq = jax_engine.quantize_for_serving(jp, js, jcfg.quant)
    tq = engine.quantize_for_serving(
        interop.params_from_numpy(_np(jp), "cpu"),
        interop.adapt_state_from_numpy(_np(js), "cpu"), cfg.quant)
    emb = np.random.default_rng(3).standard_normal((B, S, D)).astype(
        np.float32)
    want = np.asarray(_compiled(lambda p, e: jax_transformer.forward(
        p, jcfg.model, embeds=e, use_pallas=pallas), jq, emb)(jq, emb))
    got = transformer.forward(tq, cfg.model, embeds=torch.from_numpy(emb),
                              use_pallas=pallas).numpy()
    assert got.shape == (B, S, V)
    tol = 2.0 ** -5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    late = emb.copy()
    late[:, -1] += 3.0
    moved = transformer.forward(tq, cfg.model, embeds=torch.from_numpy(late),
                                use_pallas=pallas).numpy()
    assert np.abs(moved[:, 0] - got[:, 0]).max() > tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_non_causal_flash_at_d80_matches_pallas(dtype):
    """The plain flash forward and backward with ``causal=False`` at
    hubert's head dim 80 (16/16 heads narrowed to 4/4), several q and kv
    blocks (bq = bk = 8), against the interpret-mode Pallas kernels: in
    f32 within 1e-5 relative; from bf16 inputs (the model's) within one
    bf16 ulp at each value plus 1e-4 of the largest."""
    rng = np.random.default_rng(80)
    q, k, v, do = (rng.standard_normal((2, 21, 4, 80)).astype(np.float32)
                   for _ in range(4))
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    kw = dict(causal=False, window=0, softcap=0.0)
    o, lse = jax_flash.flash_attention(jq, jk, jv, bq=8, bk=8, interpret=True,
                                       return_lse=True, **kw)
    want_grads = jax_flash.flash_attention_bwd(jq, jk, jv, o, lse, jdo, bq=8,
                                               bk=8, interpret=True, **kw)
    t = [interop.tensor_from_numpy(np.asarray(a), "cpu")
         for a in (jq, jk, jv, jdo)]
    got_o, got_lse = flash_attention.plain(*t[:3], return_lse=True, **kw)
    got_grads = flash_attention.plain_bwd(
        *t[:3], interop.tensor_from_numpy(np.asarray(o), "cpu"),
        torch.from_numpy(np.array(lse)), t[3], **kw)
    pairs = [(got_o, o), (got_lse, lse)] + list(zip(got_grads, want_grads))
    for i, (g, w) in enumerate(pairs):
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape, i
        if dtype == "float32" or i == 1:
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()))
        else:
            assert np.all(np.abs(g - w) <= _bf16_ulp(w)
                          + 1e-4 * np.abs(w).max()), i


def test_framewise_loss_and_grad_match_jax():
    """``lm_loss(shift=False)``: the framewise CE of (B, S, V) f32 logits
    against per-frame labels, and its gradient, against ``jax.grad``."""
    rng = np.random.default_rng(9)
    logits = (3 * rng.standard_normal((B, S, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda x: jax_transformer.lm_loss(
        x, jnp.asarray(labels), shift=False))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss = transformer.lm_loss(x, torch.from_numpy(labels), shift=False)
    (g,) = torch.autograd.grad(loss, [x])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6 * float(np.abs(jg).max()))
    shifted = transformer.lm_loss(x.detach(), torch.from_numpy(labels))
    assert abs(float(shifted) - float(loss.detach())) > 1e-3


@pytest.mark.parametrize("mode", STEPS)
def test_step_matches_the_reference(mode):
    """One training step on the reference's frame batch from the same
    state: packed SR words under ``quant.use_pallas`` (the same leaf seeds:
    the same words), or the registry's config (remat full, accumulation,
    the default quantizer's jax.random noise from the same step key)."""
    jcfg = jax_apply_overrides(jax_get_smoke(ARCH), STEPS[mode])
    cfg = apply_overrides(get_smoke_config(ARCH), STEPS[mode])
    jstate = jax_train_loop.init_state(jcfg)
    state = interop.train_state_from_numpy(_np(jstate), "cpu")
    p0 = _flat(_np(jstate["params"]))
    batch = jax_train_loop.make_batch(jcfg, 0)
    assert set(batch) == {"embeds", "labels"}
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


def test_frame_batches_label_each_frame_by_its_first_features():
    """``lm_batch`` of an encoder: embeds (B, S, D) f32 N(0, 1) and labels
    (B, S) int32, the argmax of each frame's first V features; one batch
    per (seed, step)."""
    cfg = apply_overrides(get_smoke_config(ARCH), [
        "train.global_batch=4", "train.seq_len=16"])
    a = synthetic.lm_batch(cfg, 5, device="cpu")
    assert set(a) == {"embeds", "labels"}
    assert a["embeds"].shape == (4, 16, D)
    assert a["embeds"].dtype == torch.float32
    assert a["labels"].shape == (4, 16) and a["labels"].dtype == torch.int32
    want = np.argmax(a["embeds"].numpy()[..., :V], axis=-1)
    np.testing.assert_array_equal(a["labels"].numpy(), want)
    assert int(a["labels"].max()) < V
    again = synthetic.lm_batch(cfg, 5, device="cpu")
    assert all(torch.equal(a[k], again[k]) for k in a)
    assert not torch.equal(a["embeds"],
                           synthetic.lm_batch(cfg, 6, device="cpu")["embeds"])


def test_serving_refuses_an_encoder():
    """An encoder has no decode step: the ``Engine`` and the batcher raise
    ``ValueError`` by name (the reference's ``Engine`` fails at
    ``generate`` on the missing embedding); a forward without tokens or
    frames raises too."""
    cfg = get_smoke_config(ARCH)
    params = transformer.init_params(0, cfg.model, device="cpu")
    state = controller.init_adapt_state(params, cfg.quant)
    with pytest.raises(ValueError, match="encoder"):
        engine.Engine(cfg, params, state, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        scheduler.ContinuousBatcher(cfg, params, state, slots=1,
                                    max_context=8, device="cpu")
    with pytest.raises(ValueError, match="embeds"):
        transformer.forward(params, cfg.model)


def test_launch_train_takes_the_arch(capsys):
    from repro_torch.launch import train as train_launcher
    assert train_launcher.main([
        "--arch", ARCH, "--smoke", "--steps", "1", "--device", "cpu",
        "--override", "train.global_batch=2", "--override",
        "train.seq_len=16", "--override", "train.log_every=1"]) == 0
    assert "step     1" in capsys.readouterr().out

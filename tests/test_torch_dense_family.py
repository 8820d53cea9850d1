"""The dense family's two registry entries the port adds, granite-8b and
smollm-360m, against the JAX reference on the CPU: their configs field for
field, one packed training step of each smoke config, and greedy serving
of each smoke config through the ``Engine``.

The step is held as ``tests/test_torch_train.py`` holds tiny's first step:
the reference's step compiled without XLA's excess precision (its Pallas
kernels in interpret mode, the port's plain versions), the loss within
2e-3, the gradient norm within 2e-2, and every leaf's master update and
``grad_sum`` within 2e-2 normwise. Greedy tokens follow
``tests/test_torch_model.py``'s near-tie rule: logits within 2^-5 of the
reference's largest logit, tokens equal until the reference's top-1/top-2
margin falls within twice that.
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
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import apply_overrides  # noqa: E402
from repro_torch.configs import (get_config, get_smoke_config,  # noqa: E402
                                 list_archs)
from repro_torch.configs import granite_8b, smollm_360m  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

ARCHS = ["granite-8b", "smollm-360m"]
MODULES = {"granite-8b": granite_8b, "smollm-360m": smollm_360m}
STEP_OVERRIDES = ["quant.container_dtype=int8_packed",
                  "quant.stochastic_rounding=false", "quant.init_fl=8",
                  "quant.use_pallas=true", "train.global_batch=2",
                  "train.seq_len=32", "train.remat=none",
                  "train.accum_steps=1"]
SERVE_OVERRIDES = ["quant.container_dtype=int8_packed",
                   "quant.use_pallas=true", "quant.init_fl=8"]
B, S, NEW = 2, 12, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    assert arch in list_archs()
    mod = MODULES[arch]
    ref_mod = __import__(f"repro.configs.{mod.__name__.split('.')[-1]}",
                         fromlist=["config"])
    for got, want in ((mod.config(), ref_mod.config()),
                      (mod.smoke(), ref_mod.smoke()),
                      (get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_get_smoke(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = get_config(arch)
    assert (cfg.train.remat, cfg.train.accum_steps) == ("full", 8)
    assert cfg.model.family == "dense"


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_step_matches_the_reference(arch):
    jcfg = jax_apply_overrides(jax_get_smoke(arch), STEP_OVERRIDES)
    cfg = apply_overrides(get_smoke_config(arch), STEP_OVERRIDES)
    jstate = jax_train_loop.init_state(jcfg)
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           "cpu")
    p0 = _flat(jax.tree.map(np.asarray, jstate["params"]))
    batch = jax_train_loop.make_batch(jcfg, 0)
    jstep = jax.jit(jax_train_loop.make_train_step(jcfg)).lower(
        jstate, batch).compile(
            compiler_options={"xla_allow_excess_precision": False})
    jstate, jm = jstep(jstate, batch)
    state, tm = train_loop.make_train_step(cfg)(
        state, {"tokens": torch.from_numpy(np.array(batch["tokens"]))})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-2)
    jp = _flat(jax.tree.map(np.asarray, jstate["params"]))
    tp = _flat(interop.to_numpy(state["params"]))
    assert tp.keys() == jp.keys()
    for path in p0:
        _normwise(tp[path] - p0[path], jp[path] - p0[path], 2e-2, path)
    for path, jts in jstate["adapt"]["tensors"].items():
        _normwise(interop.to_numpy(
            state["adapt"]["tensors"][path]["grad_sum"]),
            np.asarray(jts["grad_sum"]), 2e-2, f"grad_sum {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_the_reference(arch):
    jcfg = jax_apply_overrides(jax_get_smoke(arch), SERVE_OVERRIDES)
    cfg = apply_overrides(get_smoke_config(arch), SERVE_OVERRIDES)
    jp = jax_transformer.init_params(jax.random.PRNGKey(0), jcfg.model)
    js = jax_controller.init_adapt_state(jp, jcfg.quant)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = interop.adapt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.model.vocab_size, (B, S)).astype(np.int32)
    jout, jlog = jax_engine.Engine(jcfg, jp, js).generate(
        jnp.asarray(tokens), NEW)
    tout, tlog = engine.Engine(cfg, tp, ts, device="cpu").generate(
        torch.from_numpy(tokens), NEW)
    jout, tout = np.asarray(jout), tout.numpy()
    assert tout.shape == (B, NEW)
    seq = np.concatenate([tokens, jout], axis=1)
    logits = np.asarray(jax_transformer.forward(
        jax_engine.quantize_for_serving(jp, js, jcfg.quant), jcfg.model,
        tokens=jnp.asarray(seq), use_pallas=True))
    tol = 2.0 ** -5 * float(np.abs(logits).max())
    # the port's logits over the same tokens, teacher-forced, within tol
    got = transformer.forward(
        engine.quantize_for_serving(tp, ts, cfg.quant), cfg.model,
        tokens=torch.from_numpy(seq), use_pallas=True).numpy()
    np.testing.assert_allclose(got, logits, rtol=0, atol=tol)
    for b in range(B):
        for i in range(NEW):
            top2 = np.sort(logits[b, S - 1 + i])[-2:]
            if top2[1] - top2[0] <= 2 * tol:
                break
            assert tout[b, i] == jout[b, i], (b, i)
    if np.array_equal(tout, jout):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=2.0 ** -5 * np.abs(np.asarray(jlog)).max())

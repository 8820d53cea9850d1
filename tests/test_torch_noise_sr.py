"""The registry's default quantizer in the port: stochastic rounding with
``jax.random`` noise (``quant.use_pallas=false``, the paper's simulate
mode), against the JAX reference on ``tiny``. For the same
``PRNGKey(seed)`` and step, ``quantize_params`` (float32, bfloat16, int8)
and ``quantize_params_packed`` (int8_packed) must equal the reference's bit
for bit, at a ⟨WL,FL⟩ that differs between leaves and layers; so must
``ops.sr_quantize_fused[_int8]`` without ``use_pallas`` (the reference's
jax.random oracles). One train step under the registry's quant defaults
is held against the reference's jitted step (compiled without XLA's
excess precision) at the slice-2 bounds, and the precision switch from
the same state must come out identical.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import load_config as jax_load_config  # noqa: E402
from repro.core import controller as jax_controller  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import load_config  # noqa: E402
from repro_torch.core import controller  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

# One step from the same state against the reference's jitted step without
# excess precision: the loss within 1e-5 relative and each leaf's master
# update within 2e-2 normwise (the slice-2 bounds of a first step,
# tests/test_torch_train.py and tests/test_torch_containers.py).
LOSS_RTOL = 1e-5
UPDATE_NORMWISE = 2e-2
STEP_OVERRIDES = ["train.global_batch=2", "train.seq_len=16",
                  "quant.init_fl=8"]
CONTAINERS = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16),
              "int8": (jnp.int8, torch.int8)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _assert_trees_equal(got, want):
    jflat, tflat = _flat(_np(want)), _flat(got)
    assert tflat.keys() == jflat.keys()
    for path, w in jflat.items():
        g = interop.tensor_to_numpy(tflat[path])
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def _reference_state(ov, seed):
    """The reference's tiny train state from ``seed`` with a ⟨WL,FL⟩ that
    differs between leaves and layers."""
    jcfg = jax_load_config("tiny", overrides=ov + [f"train.seed={seed}"])
    jstate = jax_train_loop.init_state(jcfg)
    tensors = {}
    for i, (p, ts) in enumerate(jstate["adapt"]["tensors"].items()):
        ar = jnp.arange(ts["fl"].size).reshape(ts["fl"].shape)
        tensors[p] = {**ts, "wl": (ts["wl"] + 4 * ar + i % 3).astype(jnp.int32),
                      "fl": (ts["fl"] + ar + i % 2).astype(jnp.int32)}
    return jcfg, jstate, {**jstate["adapt"], "tensors": tensors}


def _port(jstate, jadapt):
    return (interop.params_from_numpy(_np(jstate["params"]), "cpu"),
            interop.adapt_state_from_numpy(_np(jadapt), "cpu"))


def test_the_registry_defaults_are_the_jax_random_branch():
    q = load_config("tiny").quant
    assert (q.mode, q.container_dtype, q.stochastic_rounding,
            q.use_pallas) == ("simulate", "float32", True, False)


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("container", list(CONTAINERS))
def test_quantize_params_matches_the_reference(container, seed, step):
    ov = [f"quant.container_dtype={container}"]
    jcfg, jstate, jadapt = _reference_state(ov, seed)
    key = jax.random.fold_in(jstate["rng"], step)
    jdt, tdt = CONTAINERS[container]
    jq = jax_controller.quantize_params(jstate["params"], jadapt, jcfg.quant,
                                        key, dtype=jdt)
    cfg = load_config("tiny", overrides=ov)
    params, adapt = _port(jstate, jadapt)
    tq = controller.quantize_params(params, adapt, cfg.quant, dtype=tdt,
                                    key=controller.step_key(seed, step))
    _assert_trees_equal(tq, jq)
    # stochastically rounded: not the round-to-nearest copy
    rtn = controller.quantize_params(params, adapt, cfg.quant, dtype=tdt)
    assert not torch.equal(rtn["head"], tq["head"])


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("seed", [0, 7])
def test_quantize_params_packed_matches_the_reference(seed, step):
    ov = ["quant.container_dtype=int8_packed"]
    jcfg, jstate, jadapt = _reference_state(ov, seed)
    key = jax.random.fold_in(jstate["rng"], step)
    jq = jax_controller.quantize_params_packed(jstate["params"], jadapt,
                                               jcfg.quant, key)
    cfg = load_config("tiny", overrides=ov)
    params, adapt = _port(jstate, jadapt)
    tq = controller.quantize_params_packed(
        params, adapt, cfg.quant, key=controller.step_key(seed, step))
    _assert_trees_equal(tq, jq)


def test_chunked_noise_equals_the_whole_leaf_draw(monkeypatch):
    """Drawn in chunks of 1000 elements (layer boundaries inside chunks'
    reach), the words are those of the whole-leaf draw."""
    ov = ["quant.container_dtype=int8_packed"]
    jcfg, jstate, jadapt = _reference_state(ov, 3)
    key = jax.random.fold_in(jstate["rng"], 2)
    jq = jax_controller.quantize_params_packed(jstate["params"], jadapt,
                                               jcfg.quant, key)
    monkeypatch.setattr(controller, "_NOISE_CHUNK",
                        {"cpu": 1000, "cuda": 1000})
    params, adapt = _port(jstate, jadapt)
    tq = controller.quantize_params_packed(
        params, adapt, load_config("tiny", overrides=ov).quant,
        key=controller.step_key(3, 2))
    _assert_trees_equal(tq, jq)


def test_step_and_leaf_keys_are_the_references():
    jkey = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    key = controller.step_key(11, 4)
    assert key == tuple(int(v) for v in np.asarray(jkey))
    for path in ("embed", "blocks/s0_attn/wq", "head"):
        want = jax_controller._leaf_key(jkey, path)
        assert controller.leaf_key(key, path) == tuple(
            int(v) for v in np.asarray(want))


@pytest.mark.parametrize("seed", [23, -5, 2 ** 31 - 1])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_fused_ops_without_pallas_match_the_reference(stacked, seed):
    """``ops.sr_quantize_fused[_int8]`` without ``use_pallas``: the
    reference's jax.random oracles, scalar and per-layer ⟨WL,FL⟩."""
    x = (np.random.default_rng(seed & 0xFFFF).normal(0, 3.0, (3, 40, 24))
         .astype(np.float32))
    if stacked:
        wl = np.array([4, 8, 16], np.int32)
        fl = np.array([2, 5, -1], np.int32)
    else:
        x, wl, fl = x[0], np.int32(8), np.int32(4)
    want = jops.sr_quantize_fused(jnp.asarray(x), seed, jnp.asarray(wl),
                                  jnp.asarray(fl))
    got = ops.sr_quantize_fused(torch.from_numpy(x), seed,
                                torch.from_numpy(np.asarray(wl)),
                                torch.from_numpy(np.asarray(fl)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want8 = jops.sr_quantize_fused_int8(jnp.asarray(x), seed, jnp.asarray(fl))
    got8 = ops.sr_quantize_fused_int8(torch.from_numpy(x), seed,
                                      torch.from_numpy(np.asarray(fl)))
    assert got8.dtype == torch.int8
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    # bf16 out is the f32 grid value rounded to nearest even
    bf = ops.sr_quantize_fused(torch.from_numpy(x), seed,
                               torch.from_numpy(np.asarray(wl)),
                               torch.from_numpy(np.asarray(fl)),
                               out_dtype=torch.bfloat16)
    assert torch.equal(bf, got.to(torch.bfloat16))


def _jit_step(jcfg, jstate, batch):
    return jax.jit(jax_train_loop.make_train_step(jcfg)).lower(
        jstate, batch).compile(
            compiler_options={"xla_allow_excess_precision": False})


@pytest.fixture(scope="module")
def default_step():
    """One step of the reference's jitted step and of the port's under the
    registry's quant defaults (float32 container, SR, no Pallas), from the
    same state and batch."""
    jcfg = jax_load_config("tiny", overrides=STEP_OVERRIDES)
    cfg = load_config("tiny", overrides=STEP_OVERRIDES)
    jstate = jax_train_loop.init_state(jcfg)
    state = interop.train_state_from_numpy(_np(jstate), "cpu")
    batch = _np(jax_train_loop.make_batch(jcfg, 0))
    jstep = _jit_step(jcfg, jstate, batch)
    jout, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    tout, tm = train_loop.make_train_step(cfg)(
        state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    return dict(jcfg=jcfg, cfg=cfg, jstate=jstate, jout=jout, tout=tout,
                jm={k: float(v) for k, v in jm.items()},
                tm={k: float(v) for k, v in tm.items()})


def test_one_step_under_the_defaults_matches_the_reference(default_step):
    r = default_step
    for k in ("loss", "full_loss"):
        np.testing.assert_allclose(r["tm"][k], r["jm"][k], rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(r["tm"]["grad_norm"], r["jm"]["grad_norm"],
                               rtol=UPDATE_NORMWISE)
    p0 = _flat(_np(r["jstate"]["params"]))
    jp = _flat(_np(r["jout"]["params"]))
    tp = _flat(interop.to_numpy(r["tout"]["params"]))
    for path, before in p0.items():
        want = jp[path].astype(np.float32) - before.astype(np.float32)
        got = tp[path].astype(np.float32) - before.astype(np.float32)
        err = float(np.linalg.norm((got - want).ravel()))
        ref = float(np.linalg.norm(want.ravel()))
        assert err <= UPDATE_NORMWISE * ref, f"{path}: {err} > {ref}"


def test_the_step_quantizes_with_the_reference_noise(default_step):
    """The quantized copy the step read: the port's step key of (run seed,
    step 0) gives the reference's copy of the same master bit for bit."""
    r = default_step
    jkey = jax.random.fold_in(r["jstate"]["rng"], r["jstate"]["step"])
    jq = jax_controller.quantize_params(r["jstate"]["params"],
                                        r["jstate"]["adapt"],
                                        r["jcfg"].quant, jkey)
    state = interop.train_state_from_numpy(_np(r["jstate"]), "cpu")
    tq = controller.quantize_params(
        state["params"], state["adapt"], r["cfg"].quant,
        key=controller.step_key(int(state["rng"]), 0))
    _assert_trees_equal(tq, jq)


def test_the_switch_from_the_same_state_is_identical(default_step):
    """The reference's state after its step, through precision_switch in
    both (the plain EDF ladder under the defaults): identical ⟨WL,FL⟩,
    lookback, resolution, window counts and strategy."""
    r = default_step
    jstate = r["jout"]
    jcfg, cfg = r["jcfg"], r["cfg"]
    tensors = {p: {**ts, "lb": jnp.ones_like(ts["lb"])}
               for p, ts in jstate["adapt"]["tensors"].items()}
    jadapt = {**jstate["adapt"], "tensors": tensors}
    jout = jax_controller.precision_switch(jadapt, jstate["params"],
                                           jcfg.quant)
    tout = controller.precision_switch(
        interop.adapt_state_from_numpy(_np(jadapt), "cpu"),
        interop.params_from_numpy(_np(jstate["params"]), "cpu"), cfg.quant)
    ja, ta = _np(jout), interop.to_numpy(tout)
    moved = 0
    for path, jts in ja["tensors"].items():
        for k in ("wl", "fl", "lb", "res", "count"):
            np.testing.assert_array_equal(ta["tensors"][path][k], jts[k],
                                          err_msg=f"{path} {k}")
        moved += int(np.sum(jts["wl"] != _np(tensors[path]["wl"])))
    assert int(ta["strategy"]) == int(ja["strategy"])
    assert moved > 0


def test_training_under_the_defaults_runs_through_a_switch():
    cfg = load_config("tiny", overrides=STEP_OVERRIDES + [
        "train.adapt_interval=2", "quant.lb_lwr=2", "train.log_every=1"])
    state, history = train_loop.train(cfg, steps=3, device="cpu",
                                      log=lambda s: None)
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert all(int(ts["count"].max()) <= 1
               for ts in state["adapt"]["tensors"].values())

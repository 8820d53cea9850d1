"""Port parity for one AdaPT-SGD train step of the CNN family: AlexNet and
ResNet20 at smoke width (batch 16), from the reference's state and batch,
under six quantizer settings:

- the QuantConfig defaults: the float32 container, SR with the
  reference's jax.random noise (``core/threefry.py``);
- ``quant.use_pallas=true``: the float SR grid values (the kernel's plain
  version) against the interpret-mode Pallas kernel;
- ``container_dtype=int8``: int8 words times 2^-FL in bf16;
- both: the int8 words of the fused kernel's plain version
  (``sr_quantize_fused_int8``) against the interpret-mode Pallas kernel;
- ``int8_packed``: for the CNN family the float32 grid values, as in the
  reference, so the step equals the float32 container's bit for bit;
- ``quant.mode=off``.

The quantized copy is the reference's bit for bit; the loss, the accuracy,
the gradient norm, the new batch-norm stats and each leaf's master update
are held within the bounds below against the reference's step, compiled
without excess precision as ``tests/test_torch_train.py`` compiles it.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import apply_overrides as jax_apply_overrides  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import controller as jax_controller  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import apply_overrides  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import controller  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's many small torch ops run on one thread: beside other
    test processes an intra-op thread pool only waits for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SETTINGS = {
    "defaults": [],
    "use_pallas": ["quant.use_pallas=true"],
    "int8": ["quant.container_dtype=int8"],
    "use_pallas_int8": ["quant.use_pallas=true",
                        "quant.container_dtype=int8"],
    "int8_packed": ["quant.container_dtype=int8_packed"],
    "mode_off": ["quant.mode=off"],
}
# Bounds against the reference's step (measured on this model pair: loss
# and full loss within 1e-7 relative, grad_norm 3e-6, stats 4e-7 of their
# largest value, leaf updates 8.2e-5 normwise in f32 and 6.3e-4 in the
# int8 container (3.6e-4 with use_pallas), whose bf16 leaves and
# gradients turn one-ulp differences into bf16 steps)
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
STATS_RTOL = 2e-5
UPDATE_NORMWISE = {"int8": 5e-3, "use_pallas_int8": 5e-3}
UPDATE_NORMWISE_F32 = 1e-3


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _np(t):
    return interop.tensor_to_numpy(t).astype(np.float32) \
        if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@functools.lru_cache(maxsize=None)
def _reference_state(name, mode_off):
    jcfg = jax_apply_overrides(jax_smoke(name),
                               ["quant.mode=off"] if mode_off else [])
    return jax.jit(functools.partial(jax_train_loop.init_state, jcfg))()


def _configs(name, setting):
    ov = SETTINGS[setting]
    return (jax_apply_overrides(jax_smoke(name), ov),
            apply_overrides(get_smoke_config(name), ov))


@functools.lru_cache(maxsize=None)
def _steps(name, setting):
    """(reference state after, its metrics, port state after, its metrics,
    port state before) of one step from the same state and batch, as numpy
    and floats (cached: the reference's compile takes most of a test)."""
    jcfg, cfg = _configs(name, setting)
    jstate = _reference_state(name, setting == "mode_off")
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           "cpu")
    before = interop.to_numpy(state)
    jbatch = jax_train_loop.make_batch(jcfg, 0)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    jstep = jax.jit(jax_train_loop.make_train_step(jcfg)).lower(
        jstate, jbatch).compile(
            compiler_options={"xla_allow_excess_precision": False})
    jafter, jm = jstep(jstate, jbatch)
    after, tm = train_loop.make_train_step(cfg)(state, batch, step=0)
    return (jax.tree.map(np.asarray, jafter),
            {k: float(v) for k, v in jm.items()}, interop.to_numpy(after),
            {k: float(v) for k, v in tm.items()}, before)


@pytest.mark.parametrize("setting", [s for s in SETTINGS if s != "mode_off"])
@pytest.mark.parametrize("name", ["alexnet", "resnet20"])
def test_quantized_copy_is_the_references(name, setting):
    """The copy the forward reads, from the same state, step key and leaf
    seeds: every leaf bit-equal, in the reference's dtype, to the
    reference's (jitted, as its step takes it)."""
    jcfg, cfg = _configs(name, setting)
    jstate = _reference_state(name, False)
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           "cpu")
    qkey = jax.random.fold_in(jstate["rng"], jstate["step"])
    dtype = {"bfloat16": jnp.bfloat16, "int8": jnp.int8}.get(
        jcfg.quant.container_dtype, jnp.float32)
    quantize = jax.jit(lambda p, a, k: jax_controller.quantize_params(
        p, a, jcfg.quant, k, dtype=dtype))
    jq = _flat(jax.tree.map(np.asarray, quantize(jstate["params"],
                                                 jstate["adapt"], qkey)))
    seeds = controller.leaf_seeds(int(state["rng"]), 0,
                                  state["adapt"]["tensors"])
    tq = _flat(train_loop._quantized_copy(
        cfg, state["params"], state["adapt"], seeds,
        controller.step_key(int(state["rng"]), 0)))
    assert tq.keys() == jq.keys()
    for path, want in jq.items():
        got = interop.tensor_to_numpy(tq[path])
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    n_quantized = len(state["adapt"]["tensors"])
    assert n_quantized == {"alexnet": 8, "resnet20": 22}[name]


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("name", ["alexnet", "resnet20"])
def test_step_matches_reference(name, setting):
    jafter, jm, after, tm, before = _steps(name, setting)
    for k in ("loss", "full_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_NORM_RTOL)
    assert float(tm["acc"]) == float(jm["acc"])
    assert float(tm["lr"]) == float(jm["lr"])
    bound = UPDATE_NORMWISE.get(setting, UPDATE_NORMWISE_F32)
    p0 = _flat(before["params"])
    tp, jp = _flat(after["params"]), _flat(jafter["params"])
    assert tp.keys() == jp.keys()
    for path, want in jp.items():
        dj = _np(want) - _np(p0[path])
        dt = _np(tp[path]) - _np(p0[path])
        err = float(np.linalg.norm(dt - dj))
        assert err <= bound * float(np.linalg.norm(dj)), \
            f"{setting} {path}: update off by {err}"
    ts, js = _flat(after["stats"]), _flat(jafter["stats"])
    assert ts.keys() == js.keys()
    assert bool(ts) == (name == "resnet20")
    for path, want in js.items():
        got = _np(ts[path])
        assert float(np.max(np.abs(got - want))) <= \
            STATS_RTOL * float(np.max(np.abs(want))), path
    if setting != "mode_off":
        for path, ts_ in _flat(after["adapt"]["tensors"]).items():
            if path.endswith("count"):
                assert int(ts_) == 1, path


def test_int8_packed_is_the_float32_step():
    """For the CNN family ``int8_packed`` is the float32 container (the
    reference's exception): the port's steps are bit-equal."""
    for name in ("alexnet", "resnet20"):
        a = _flat(_steps(name, "int8_packed")[2])
        b = _flat(_steps(name, "defaults")[2])
        assert a.keys() == b.keys()
        for path, v in b.items():
            np.testing.assert_array_equal(a[path], v, err_msg=path)

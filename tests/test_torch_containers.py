"""Port parity for the float containers on ``tiny``: the SR grid values of
the float-container kernels' plain versions bit for bit against the JAX
package's fused kernels in interpret mode and its bit-exact oracles,
``quantize_params`` for float32, bfloat16 and int8 (SR and RTN) bit for
bit, one train step per container and with ``quant.mode=off`` against the
reference's step, and ``Engine`` serving from a float container.

The reference runs its Pallas kernels in interpret mode on the CPU (its
portable noise stream); the port runs the kernels' plain versions there.
SR seeds: the reference draws each leaf's seed from ``jax.random``
(``controller._leaf_seed``); the port is handed those same seeds.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import load_config as jax_load_config  # noqa: E402
from repro.core import controller as jax_controller  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import load_config  # noqa: E402
from repro_torch.core import controller  # noqa: E402
from repro_torch.kernels import ops, sr_quantize as sq  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

SEEDS = [23, -5, 2 ** 31 - 1, -2 ** 31]
WLS = [2, 4, 8, 12, 16, 24, 31, 32]

# Loss and per-leaf update bounds of one step from the same state against
# the reference's jitted step compiled without XLA's excess precision (it
# then rounds to bf16 after every op, as the port does): the two sum the
# same products in other orders, so the loss agrees within 1e-5 relative
# and every leaf's master update within 2e-2 normwise, the slice-2 bound
# of a first step (tests/test_torch_train.py).
LOSS_RTOL = 1e-5
UPDATE_NORMWISE = 2e-2
STEP_OVERRIDES = ["train.global_batch=2", "train.seq_len=16",
                  "quant.init_fl=8"]


def _x(shape, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _want(x, seed, wl, fl):
    return np.asarray(jops.sr_quantize_fused(
        jnp.asarray(x), jnp.int32(seed), jnp.asarray(wl, jnp.int32),
        jnp.asarray(fl, jnp.int32), use_pallas=True))


def _got(x, seed, wl, fl, out_dtype=torch.float32):
    return ops.sr_quantize_fused(
        torch.from_numpy(x), seed, torch.tensor(wl, dtype=torch.int32),
        torch.tensor(fl, dtype=torch.int32), use_pallas=True,
        out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# SR grid values


@pytest.mark.parametrize("wl", WLS)
@pytest.mark.parametrize("shape", [(1,), (511,), (513,), (2, 513), (3, 5, 7),
                                   (64, 48)])
def test_flat_grid_values_bit_equal(shape, wl):
    """Against the interpret-mode kernel and the bit-exact oracle, at FLs
    that put the values inside the grid and past its clip."""
    x = _x(shape, wl * 7 + shape[-1])
    for seed, fl in zip(SEEDS, (0, 4, wl - 1, 10)):
        got = _got(x, seed, wl, fl).numpy()
        want = _want(x, seed, wl, fl)
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got, want, err_msg=f"fl {fl}")
        np.testing.assert_array_equal(got, np.asarray(
            jref.ref_sr_quantize_fused_words(jnp.asarray(x), seed, wl, fl)))


@pytest.mark.parametrize("fl", list(range(-3, 29)))
def test_every_fl_bit_equal(fl):
    """FL −3…28 at WL 8, 16 and 32 (qmax rounds to 2^31 in f32 there)."""
    x = _x((3, 700), fl + 200, scale=2.0 ** (6 - fl))
    for wl in (8, 16, 32):
        np.testing.assert_array_equal(_got(x[0], -77, wl, fl).numpy(),
                                      _want(x[0], -77, wl, fl))
    wls = np.array([8, 32, 3], np.int32)
    fls = np.array([fl, 0, 28], np.int32)
    np.testing.assert_array_equal(_got(x, 9, wls, fls).numpy(),
                                  _want(x, 9, wls, fls))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("trail", [(1,), (513,), (127, 3), (5, 7, 11)])
@pytest.mark.parametrize("L", [1, 3, 7])
def test_stacked_grid_values_bit_equal(L, trail, seed):
    x = _x((L,) + trail, L * 37 + sum(trail))
    wls = np.array([8, 2, 16, 32, 5, 12, 24][:L], np.int32)
    fls = np.array([4, 0, 10, 28, -3, 7, 2][:L], np.int32)
    got = _got(x, seed, wls, fls).numpy()
    np.testing.assert_array_equal(got, _want(x, seed, wls, fls))
    np.testing.assert_array_equal(got, np.asarray(
        jref.ref_sr_quantize_fused_stacked_words(jnp.asarray(x), seed, wls,
                                                 fls)))
    if L == 1:
        # one layer of a stack is the flat leaf
        np.testing.assert_array_equal(
            got[0], _got(x[0], seed, int(wls[0]), int(fls[0])).numpy())


@pytest.mark.parametrize("name", ["signed_zeros", "denormals",
                                  "inf_adjacent", "all_equal", "mixed"])
def test_pathological_values_bit_equal(name):
    x = {"signed_zeros": np.array([0.0, -0.0] * 320, np.float32),
         "denormals": np.array([1e-42, -3e-41, 5e-44, -1e-45] * 160,
                               np.float32),
         "inf_adjacent": np.array([3.3e38, -3.3e38, 1e30, -1e25] * 160,
                                  np.float32),
         "all_equal": np.full((640,), -1.75, np.float32),
         "mixed": np.array([0.0, -0.0, 1e-42, 3.3e38, -3.3e38, 0.5, -0.5,
                            1.0] * 80, np.float32)}[name]
    for wl, fl in ((8, 0), (8, 4), (16, 12), (32, 20)):
        got = _got(x, 31, wl, fl).numpy()
        want = _want(x, 31, wl, fl)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=f"<{wl},{fl}>")


@pytest.mark.parametrize("stacked", [False, True])
def test_bf16_out_is_the_f32_values_rounded(stacked):
    """The bf16 container: the f32 grid values rounded to nearest even,
    as the reference's ``.astype(bfloat16)``."""
    x = _x((3, 1000), 5, scale=0.3)
    wl = np.array([16, 12, 24], np.int32) if stacked else 16
    fl = np.array([13, 9, 20], np.int32) if stacked else 13
    got = _got(x, 4, wl, fl, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = jnp.asarray(_want(x, 4, wl, fl)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(interop.tensor_to_numpy(got),
                                  np.asarray(want))


def test_wrappers_take_the_plain_version_on_the_cpu():
    x = torch.zeros(2, 8)
    wl = torch.full((2,), 8, dtype=torch.int32)
    fl = torch.zeros(2, dtype=torch.int32)
    n0 = (sq.sr_quantize_fused.launches, sq.sr_quantize_fused_stacked.launches)
    assert sq.sr_quantize_fused_stacked(x, 3, wl, fl).dtype == torch.float32
    assert sq.sr_quantize_fused(x[0], 3, wl[0], fl[0]).shape == (8,)
    assert (sq.sr_quantize_fused.launches,
            sq.sr_quantize_fused_stacked.launches) == n0
    meta = torch.zeros(2, 8, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        sq.sr_quantize_fused_stacked(
            meta, 3, torch.zeros(2, dtype=torch.int32, device="meta"),
            torch.zeros(2, dtype=torch.int32, device="meta"))
    # without use_pallas: the reference's jax.random oracle, on any device
    want = jops.sr_quantize_fused(jnp.zeros((2, 8)), 3, 8, 0)
    np.testing.assert_array_equal(
        ops.sr_quantize_fused(x, 3, 8, 0, use_pallas=False).numpy(),
        np.asarray(want))


# ---------------------------------------------------------------------------
# quantize_params


def _reference_state(ov):
    """The reference's tiny train state with a ⟨WL,FL⟩ that differs
    between leaves and layers."""
    jcfg = jax_load_config("tiny", overrides=ov)
    jstate = jax_train_loop.init_state(jcfg)
    tensors = {}
    for i, (p, ts) in enumerate(jstate["adapt"]["tensors"].items()):
        ar = jnp.arange(ts["fl"].size).reshape(ts["fl"].shape)
        tensors[p] = {**ts, "wl": (ts["wl"] + 4 * ar + i % 3).astype(jnp.int32),
                      "fl": (ts["fl"] + ar + i % 2).astype(jnp.int32)}
    return jcfg, jstate, {**jstate["adapt"], "tensors": tensors}


@pytest.mark.parametrize("sr", [True, False], ids=["sr", "rtn"])
@pytest.mark.parametrize("container", ["float32", "bfloat16", "int8"])
def test_quantize_params_matches_the_reference(container, sr):
    ov = [f"quant.container_dtype={container}", "quant.use_pallas=true"]
    jcfg, jstate, jadapt = _reference_state(ov)
    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
             "int8": jnp.int8}[container]
    key = jax.random.fold_in(jstate["rng"], 5) if sr else None
    jq = jax_controller.quantize_params(jstate["params"], jadapt, jcfg.quant,
                                        key, dtype=dtype)
    seeds = ({p: int(jax_controller._leaf_seed(key, p))
              for p in jadapt["tensors"]} if sr else None)
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}[container]
    tq = controller.quantize_params(
        interop.params_from_numpy(_np(jstate["params"]), "cpu"),
        interop.adapt_state_from_numpy(_np(jadapt), "cpu"),
        load_config("tiny", overrides=ov).quant, seeds, dtype=tdtype)
    jflat, tflat = _flat(_np(jq)), _flat(tq)
    assert tflat.keys() == jflat.keys()
    for path, want in jflat.items():
        got = interop.tensor_to_numpy(tflat[path])
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    if sr:
        rtn = controller.quantize_params(
            interop.params_from_numpy(_np(jstate["params"]), "cpu"),
            interop.adapt_state_from_numpy(_np(jadapt), "cpu"),
            load_config("tiny", overrides=ov).quant, dtype=tdtype)
        assert not torch.equal(rtn["head"], tq["head"])


def test_sr_without_the_fused_kernel_raises():
    """The reference's other SR branch draws jax.random noise from the
    step key: the port draws the same noise (tests/test_torch_noise_sr.py
    holds it bit for bit), and raises only when it is given no key."""
    for ov in (["quant.use_pallas=false"],
               ["quant.use_pallas=true", "quant.fused_prng=false"]):
        cfg = load_config("tiny", overrides=ov)
        state = train_loop.init_state(cfg, device="cpu")
        seeds = controller.leaf_seeds(0, 0, state["adapt"]["tensors"])
        with pytest.raises(ValueError, match="step key"):
            controller.quantize_params(state["params"], state["adapt"],
                                       cfg.quant, seeds)
        key = controller.step_key(0, 0)
        q = controller.quantize_params(state["params"], state["adapt"],
                                       cfg.quant, seeds, key=key)
        rtn = controller.quantize_params(state["params"], state["adapt"],
                                         cfg.quant)
        assert q["head"].dtype == torch.float32
        assert not torch.equal(q["head"], rtn["head"])


# ---------------------------------------------------------------------------
# One train step per container


def one_step_against_reference(ov):
    """One step of the reference's jitted step (without excess precision)
    and of the port's from the same state and batch, each with its own SR
    seeds (the port's ``leaf_seeds`` are the reference's ``_leaf_seed``);
    returns the metrics and the master before and after, as numpy."""
    jcfg = jax_load_config("tiny", overrides=ov)
    cfg = load_config("tiny", overrides=ov)
    jstate = jax_train_loop.init_state(jcfg)
    state = interop.train_state_from_numpy(_np(jstate), "cpu")
    batch = _np(jax_train_loop.make_batch(jcfg, 0))
    jstep = jax.jit(jax_train_loop.make_train_step(jcfg)).lower(
        jstate, batch).compile(
            compiler_options={"xla_allow_excess_precision": False})
    p0 = _flat(_np(jstate["params"]))
    jout, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    tout, tm = train_loop.make_train_step(cfg)(
        state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    return dict(jm={k: float(v) for k, v in jm.items()},
                tm={k: float(v) for k, v in tm.items()}, p0=p0,
                jp=_flat(_np(jout["params"])),
                tp=_flat(interop.to_numpy(tout["params"])), tstate=tout)


def check_step(r):
    for k in ("loss", "full_loss"):
        np.testing.assert_allclose(r["tm"][k], r["jm"][k], rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(r["tm"]["grad_norm"], r["jm"]["grad_norm"],
                               rtol=UPDATE_NORMWISE)
    assert r["tm"]["lr"] == r["jm"]["lr"]
    for path, before in r["p0"].items():
        want = r["jp"][path].astype(np.float32) - before.astype(np.float32)
        got = r["tp"][path].astype(np.float32) - before.astype(np.float32)
        err = float(np.linalg.norm((got - want).ravel()))
        ref = float(np.linalg.norm(want.ravel()))
        assert err <= UPDATE_NORMWISE * ref, f"{path}: {err} > {ref}"


@pytest.mark.parametrize("sr", [True, False], ids=["sr", "rtn"])
@pytest.mark.parametrize("container", ["float32", "bfloat16", "int8"])
def test_one_step_matches_the_reference(container, sr):
    ov = STEP_OVERRIDES + [f"quant.container_dtype={container}",
                           "quant.use_pallas=true",
                           f"quant.stochastic_rounding={str(sr).lower()}"]
    r = one_step_against_reference(ov)
    check_step(r)
    # the master carries no graph after the step
    assert not any(t.requires_grad for t in
                   _flat(r["tstate"]["params"]).values())


@pytest.mark.parametrize("use_pallas", [True, False])
def test_mode_off_step_matches_the_reference(use_pallas):
    """quant.mode=off: the master itself, no regularizer, no accumulate,
    no normalization, and an empty controller."""
    ov = STEP_OVERRIDES + ["quant.mode=off",
                           f"quant.use_pallas={str(use_pallas).lower()}"]
    r = one_step_against_reference(ov)
    check_step(r)
    assert r["tm"]["full_loss"] == r["tm"]["loss"]
    assert r["tstate"]["adapt"] == {"tensors": {}}


def test_mode_off_trains_without_a_switch():
    cfg = load_config("tiny", overrides=STEP_OVERRIDES + [
        "quant.mode=off", "train.adapt_interval=1", "train.log_every=1"])
    state, history = train_loop.train(cfg, steps=2, device="cpu",
                                      log=lambda s: None)
    assert [h["step"] for h in history] == [1, 2]
    assert state["adapt"] == {"tensors": {}}
    assert all(np.isfinite(h["loss"]) for h in history)


def test_float32_container_trains_through_a_switch():
    """The registry's default container with SR and the fused kernels:
    the switch after step 2 closes every window and moves the precision."""
    cfg = load_config("tiny", overrides=STEP_OVERRIDES + [
        "quant.use_pallas=true", "train.adapt_interval=2", "quant.lb_lwr=2",
        "train.log_every=1"])
    state, history = train_loop.train(cfg, steps=3, device="cpu",
                                      log=lambda s: None)
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in history)
    tensors = state["adapt"]["tensors"].values()
    assert all(int(ts["count"].max()) == 1 for ts in tensors)
    assert any(not torch.equal(ts["wl"], torch.full_like(ts["wl"], 8))
               for ts in tensors)


# ---------------------------------------------------------------------------
# Serving from a float container


@pytest.mark.parametrize("container", ["float32", "bfloat16"])
def test_engine_serves_a_float_container_like_the_reference(container):
    """RTN f32 grid values (the reference passes no dtype, whatever the
    container) bit for bit, then greedy tokens as the reference's Engine's."""
    ov = [f"quant.container_dtype={container}", "quant.use_pallas=true",
          "quant.init_fl=8"]
    jcfg, jstate, jadapt = _reference_state(ov)
    cfg = load_config("tiny", overrides=ov)
    tp = interop.params_from_numpy(_np(jstate["params"]), "cpu")
    ts = interop.adapt_state_from_numpy(_np(jadapt), "cpu")
    tq = engine.quantize_for_serving(tp, ts, cfg.quant)
    jq = jax_engine.quantize_for_serving(jstate["params"], jadapt, jcfg.quant)
    for path, want in _flat(_np(jq)).items():
        got = interop.tensor_to_numpy(_flat(tq)[path])
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=path)
    tokens = np.random.default_rng(3).integers(
        0, cfg.model.vocab_size, (2, 12)).astype(np.int32)
    jout, _ = jax_engine.Engine(jcfg, jstate["params"], jadapt).generate(
        jnp.asarray(tokens), 4)
    tout, tlog = engine.Engine(cfg, tp, ts, device="cpu").generate(
        torch.from_numpy(tokens), 4)
    jout, tout = np.asarray(jout), tout.numpy()
    assert torch.isfinite(tlog).all() and tout.shape == (2, 4)
    # As tests/test_torch_model.py holds the packed Engine: logits within
    # 2^-5 of the largest (bf16 activations round f32 sums taken in other
    # orders); the tokens equal up to the first choice whose top-1/top-2
    # margin of the reference's logits is within twice that.
    seq = np.concatenate([tokens, jout], axis=1)
    logits = np.asarray(jax_transformer.forward(
        jq, jcfg.model, tokens=jnp.asarray(seq), use_pallas=True))
    tlogits = transformer.forward(tq, cfg.model, tokens=torch.from_numpy(seq),
                                  use_pallas=True).detach().numpy()
    tol = 2.0 ** -5 * float(np.abs(logits).max())
    np.testing.assert_allclose(tlogits, logits, rtol=0, atol=tol)
    for b in range(2):
        for i in range(4):
            top2 = np.sort(logits[b, 11 + i])[-2:]
            if top2[1] - top2[0] <= 2 * tol:
                break
            assert tout[b, i] == jout[b, i], (b, i)
    # mode=off (no controller tensors): the params as they are
    assert engine.quantize_for_serving(tp, {"tensors": {}}, cfg.quant) is tp

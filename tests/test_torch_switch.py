"""Port parity for the precision switch (paper alg. 2) and the SR words of
the controller on ``tiny``: the same state and params from the JAX
reference, through ``precision_switch`` and ``quantize_params_packed`` in
both packages; a trajectory through two switches against the reference;
the port's own SR training through a switch.

The reference runs its Pallas kernels in interpret mode on the CPU; the
port runs the kernels' plain versions there.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import load_config as jax_load_config  # noqa: E402
from repro.core import controller as jax_controller  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import load_config  # noqa: E402
from repro_torch.core import controller, pushdown  # noqa: E402
from repro_torch.core import fixed_point as fxp  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

# int8 words at FL 8 put tiny's TNVS weights in about ±55; a window of two
# steps (lb_lwr = 2) so that a switch closes it after two steps.
OVERRIDES = ["quant.container_dtype=int8_packed", "quant.init_fl=8",
             "train.global_batch=2", "train.seq_len=32", "quant.lb_lwr=2"]
SWITCH_KEYS = ("wl", "fl", "lb", "res", "count")

# The trajectory's bounds are slice 2's (tests/test_torch_train.py): the
# first step's updates within 2e-2 normwise of the reference's, later steps
# (whose params already differ) within 5e-2.
FIRST_STEP_NORMWISE = 2e-2
LATER_STEPS_NORMWISE = 5e-2


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _normwise(got, want, rtol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.linalg.norm((got - want).ravel()))
    ref = float(np.linalg.norm(want.ravel()))
    assert err <= rtol * ref, f"{what}: |diff| {err} > {rtol} * {ref}"


def _jit_step(jcfg, jstate, batch):
    return jax.jit(jax_train_loop.make_train_step(jcfg)).lower(
        jstate, batch).compile(
            compiler_options={"xla_allow_excess_precision": False})


def _assert_switch_equal(tstate, jstate, what):
    """Identical wl, fl, lb, res, count and strategy; sp within 1e-6;
    grad_sum and norm_sum bit for bit."""
    ja, ta = _np(jstate), interop.to_numpy(tstate)
    assert ta["tensors"].keys() == ja["tensors"].keys()
    for path, jts in ja["tensors"].items():
        tts = ta["tensors"][path]
        for k in SWITCH_KEYS:
            np.testing.assert_array_equal(tts[k], jts[k],
                                          err_msg=f"{what} {path} {k}")
            assert tts[k].dtype == np.int32
        np.testing.assert_allclose(tts["sp"], jts["sp"], rtol=0, atol=1e-6,
                                   err_msg=f"{what} {path} sp")
        np.testing.assert_array_equal(tts["norm_sum"], jts["norm_sum"],
                                      err_msg=f"{what} {path} norm_sum")
        np.testing.assert_array_equal(
            np.asarray(tts["grad_sum"], np.float32),
            np.asarray(jts["grad_sum"], np.float32),
            err_msg=f"{what} {path} grad_sum")
    assert int(ta["strategy"]) == int(ja["strategy"]), what


# ---------------------------------------------------------------------------
# The same state through precision_switch


@pytest.fixture(scope="module")
def switch_states():
    """The reference's tiny train state after 2 and after 4 of its jitted
    steps (no switch between them, so count = 2 and 4 against lb = 2).
    In each, a few layers get lb = 5 (above their count) so that the
    switch passes them over: some tensors and layers switch, some do
    not."""
    jcfg = jax_load_config("tiny", overrides=OVERRIDES + [
        "quant.stochastic_rounding=false"])
    jstate = jax_train_loop.init_state(jcfg)
    step = None
    out = {}
    for i in range(4):
        batch = jax_train_loop.make_batch(jcfg, i)
        if step is None:
            step = _jit_step(jcfg, jstate, batch)
        jstate, _ = step(jstate, batch)
        if i in (1, 3):
            out[i + 1] = _hold_some(jstate)
    return out


def _hold_some(jstate):
    tensors = dict(jstate["adapt"]["tensors"])
    for path in ("blocks/s0_attn/wk", "blocks/s0_mlp/wo"):
        ts = tensors[path]
        tensors[path] = {**ts, "lb": ts["lb"].at[1].set(5)}
    tensors["head"] = {**tensors["head"], "lb": jnp.int32(5)}
    return {**jstate, "adapt": {**jstate["adapt"], "tensors": tensors}}


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "plain"])
@pytest.mark.parametrize("after", [2, 4])
def test_precision_switch_matches_the_reference(switch_states, after,
                                                use_pallas):
    ov = OVERRIDES + [f"quant.use_pallas={str(use_pallas).lower()}"]
    jcfg, cfg = jax_load_config("tiny", overrides=ov), load_config(
        "tiny", overrides=ov)
    jstate = switch_states[after]
    state = interop.train_state_from_numpy(_np(jstate), "cpu")
    jswitch = jax.jit(jax_train_loop.make_precision_switch(jcfg))
    jout = jswitch(jstate)["adapt"]
    tout = train_loop.make_precision_switch(cfg)(state)["adapt"]
    _assert_switch_equal(tout, jout, f"after {after}")
    # both branches happened: a held layer kept its count, the rest reset
    counts = np.concatenate([np.ravel(np.asarray(ts["count"]))
                             for ts in jout["tensors"].values()])
    assert (counts == 0).any() and (counts == after).any()
    # and the switch moved some precision
    before = _np(jstate["adapt"]["tensors"])
    assert any(not np.array_equal(np.asarray(ts["wl"]), before[p]["wl"])
               for p, ts in jout["tensors"].items())


# ---------------------------------------------------------------------------
# SR words at the controller level


def test_sr_packed_words_match_the_reference_with_its_seeds():
    """quantize_params_packed with the reference's per-leaf seeds gives
    the reference's words bit for bit on every leaf, and the same scales,
    at a per-layer precision that differs between layers."""
    ov = OVERRIDES + ["quant.use_pallas=true"]
    jcfg = jax_load_config("tiny", overrides=ov)
    jstate = jax_train_loop.init_state(jcfg)
    tensors = {p: {**ts, "fl": ts["fl"] + jnp.arange(ts["fl"].size).reshape(
        ts["fl"].shape).astype(jnp.int32)} for p, ts in
        jstate["adapt"]["tensors"].items()}
    jadapt = {**jstate["adapt"], "tensors": tensors}
    key = jax.random.fold_in(jstate["rng"], 7)
    jq = jax_controller.quantize_params_packed(jstate["params"], jadapt,
                                               jcfg.quant, key)
    seeds = {p: int(jax_controller._leaf_seed(key, p)) for p in tensors}
    tq = controller.quantize_params_packed(
        interop.params_from_numpy(_np(jstate["params"]), "cpu"),
        interop.adapt_state_from_numpy(_np(jadapt), "cpu"),
        load_config("tiny", overrides=ov).quant, seeds)
    jflat, tflat = _flat(_np(jq)), _flat(tq)
    assert tflat.keys() == jflat.keys()
    for path, want in jflat.items():
        got = interop.tensor_to_numpy(tflat[path])
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    # and the words are not RTN's
    rtn = controller.quantize_params_packed(
        interop.params_from_numpy(_np(jstate["params"]), "cpu"),
        interop.adapt_state_from_numpy(_np(jadapt), "cpu"),
        load_config("tiny", overrides=ov).quant)
    assert not torch.equal(rtn["head"]["q8"], tq["head"]["q8"])


def test_leaf_seeds_are_int32_per_step_and_path():
    paths = ["blocks/s0_attn/wq", "embed", "head"]
    a = controller.leaf_seeds(0, 3, paths)
    assert list(a) == paths
    assert all(-2 ** 31 <= s < 2 ** 31 for s in a.values())
    assert len(set(a.values())) == 3
    assert a == controller.leaf_seeds(0, 3, paths)
    assert a != controller.leaf_seeds(0, 4, paths)
    assert a != controller.leaf_seeds(1, 3, paths)
    # the reference's hash (controller.py:230-234), pinned
    assert controller.path_hash("embed") == 2073941638
    assert controller.path_hash("blocks/s0_attn/wq") == 583981485


# ---------------------------------------------------------------------------
# A trajectory through two switches


def _own_rungs(params, res, path, qcfg):
    """(KLs (L, T), FLs (L, T)) of the WL ladder on a tensor's own params,
    as the port's PushDown computes them (equal to the reference's on the
    same params: the same-state tests hold that)."""
    w = _flat(params)[path]
    w = torch.from_numpy(np.array(w, np.float32))
    L = w.shape[0] if path.startswith("blocks/") else 1
    flat = pushdown.subsample(w.reshape(L, -1), qcfg.edf_sample).contiguous()
    ladder = torch.tensor(pushdown.WL_LADDER, dtype=torch.int32)
    fls = fxp.fl_for_wl(flat.abs().amax(dim=1, keepdim=True),
                        ladder.reshape(1, -1))
    r = torch.from_numpy(np.array(res, np.int32)).reshape(L)
    counts = kops.edf_ladder_hists(flat, fls, r, wl_ladder=pushdown.WL_LADDER,
                                   r_upr=qcfg.r_upr, use_pallas=True)
    return pushdown.kl_bits(counts[:, 1:], counts[:, :1]).numpy(), fls.numpy()


def _boundary_case(jparams, tparams, res, path, layer, qcfg):
    """Why the two runs chose different rungs for a layer whose params
    differ by the trajectory's drift: at the lower of the two first rungs
    under eps_kl, the two KLs lie on either side of eps_kl (an eps_kl
    boundary), or the range-derived FLs differ (a ceil boundary of
    log2 max|w|). Returns the numbers, or None when neither holds."""
    jk, jf = _own_rungs(jparams, res, path, qcfg)
    tk, tf = _own_rungs(tparams, res, path, qcfg)
    jk, jf, tk, tf = jk[layer], jf[layer], tk[layer], tf[layer]
    first = [int(np.argmax(k < qcfg.eps_kl)) for k in (jk, tk)]
    t = min(first)
    if (jk[t] < qcfg.eps_kl) != (tk[t] < qcfg.eps_kl):
        return {"kind": "eps_kl", "wl": pushdown.WL_LADDER[t],
                "kl_reference": float(jk[t]), "kl_port": float(tk[t])}
    if not np.array_equal(jf, tf):
        return {"kind": "ceil", "fl_reference": jf.tolist(),
                "fl_port": tf.tolist()}
    return None


@pytest.fixture(scope="module")
def trajectory():
    """Six steps of tiny with SR off, a switch after every second step and
    lookback in [2, 3]: the reference's step compiled without excess
    precision and its jitted switch, and the port's, from the same state
    and batches; numpy snapshots after every step and switch.

    At each switch the port's switch also runs on the reference's own
    pre-switch state, which must give the reference's result exactly (the
    same-state hold). A layer whose switch in the trajectory chose another
    rung than the reference's is recorded with the reason
    (``_boundary_case``), and the port then continues from the
    reference's ⟨WL,FL⟩ and sp for that layer, so that the later steps
    stay comparable."""
    ov = OVERRIDES + ["quant.stochastic_rounding=false",
                      "quant.use_pallas=true", "quant.lb_upr=3",
                      "train.adapt_interval=2"]
    jcfg, cfg = jax_load_config("tiny", overrides=ov), load_config(
        "tiny", overrides=ov)
    jstate = jax_train_loop.init_state(jcfg)
    state = interop.train_state_from_numpy(_np(jstate), "cpu")
    batches = [_np(jax_train_loop.make_batch(jcfg, i)) for i in range(6)]
    jstep = _jit_step(jcfg, jstate, batches[0])
    jswitch = jax.jit(jax_train_loop.make_precision_switch(jcfg))
    step = train_loop.make_train_step(cfg)
    switch = train_loop.make_precision_switch(cfg)
    snaps = [(_np(jstate), interop.to_numpy(state), None, None)]
    flips, same_state = [], []
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, tm = step(state, {k: torch.from_numpy(np.array(v))
                                 for k, v in batch.items()}, step=i)
        if (i + 1) % 2 == 0:
            jpre, tparams = _np(jstate), interop.to_numpy(state["params"])
            held = switch(interop.train_state_from_numpy(jpre, "cpu"))
            jstate, state = jswitch(jstate), switch(state)
            same_state.append((i + 1, held["adapt"], jstate["adapt"]))
            for path, jts in _np(jstate["adapt"]["tensors"]).items():
                tts = state["adapt"]["tensors"][path]
                differ = (tts["wl"].numpy() != jts["wl"]) | (
                    tts["fl"].numpy() != jts["fl"])
                for layer in np.flatnonzero(np.ravel(differ)):
                    flips.append({
                        "step": i + 1, "path": path, "layer": int(layer),
                        "reference": (int(np.ravel(jts["wl"])[layer]),
                                      int(np.ravel(jts["fl"])[layer])),
                        "port": (int(np.ravel(tts["wl"].numpy())[layer]),
                                 int(np.ravel(tts["fl"].numpy())[layer])),
                        "why": _boundary_case(
                            jpre["params"], tparams,
                            jpre["adapt"]["tensors"][path]["res"], path,
                            int(layer), cfg.quant)})
                if differ.any():
                    for k in ("wl", "fl", "sp"):
                        tts[k] = torch.from_numpy(np.array(jts[k]))
        snaps.append((_np(jstate), interop.to_numpy(state),
                      {k: float(v) for k, v in jm.items()},
                      {k: float(v) for k, v in tm.items()}))
    return {"snaps": snaps, "flips": flips, "same_state": same_state}


def test_trajectory_switches_identically(trajectory):
    """Every switch of the trajectory, from the reference's state, is the
    reference's exactly; in the trajectory itself every tensor switches at
    least twice with identical count, lb, res and strategy, and
    ⟨WL,FL⟩ is identical except where a rung flips at an eps_kl or ceil
    boundary (ROADMAP.md Queue 3 gives the case)."""
    for step, held, want in trajectory["same_state"]:
        _assert_switch_equal(held, want, f"same state, switch after {step}")
    for flip in trajectory["flips"]:
        assert flip["why"] is not None, f"unexplained rung flip {flip}"
    # three are known (ROADMAP.md Queue 3 gives their KLs); many more would
    # mean the runs drift apart faster than the update bounds below show
    assert len(trajectory["flips"]) <= 4, trajectory["flips"]
    snaps = trajectory["snaps"]
    switched = {}
    for i in (2, 4, 6):
        ja, ta = snaps[i][0]["adapt"], snaps[i][1]["adapt"]
        for path, jts in ja["tensors"].items():
            for k in SWITCH_KEYS:
                np.testing.assert_array_equal(
                    ta["tensors"][path][k], jts[k],
                    err_msg=f"after step {i} {path} {k}")
            switched[path] = switched.get(path, 0) + (
                np.asarray(jts["count"]) == 0)
        assert int(ta["strategy"]) == int(ja["strategy"])
    for path, n in switched.items():
        assert np.all(n >= 2), f"{path} switched {n} times"


def test_trajectory_losses_and_updates_match(trajectory):
    snaps = trajectory["snaps"]
    for i in range(1, len(snaps)):
        (j0, t0, _, _), (j1, t1, jm, tm) = snaps[i - 1], snaps[i]
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-3)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=2e-2)
        bound = FIRST_STEP_NORMWISE if i == 1 else LATER_STEPS_NORMWISE
        jp0, jp1 = _flat(j0["params"]), _flat(j1["params"])
        tp0, tp1 = _flat(t0["params"]), _flat(t1["params"])
        for path in jp1:
            _normwise(tp1[path] - tp0[path], jp1[path] - jp0[path], bound,
                      f"step {i} {path}")


# ---------------------------------------------------------------------------
# The port's own SR training


def test_sr_training_runs_through_two_switches():
    """train on the CPU with the registry's SR default: finite losses
    through the switches after steps 2 and 6 (lookback in [2, 3]), which
    every tensor takes, and words that differ from round-to-nearest's."""
    ov = OVERRIDES + ["quant.use_pallas=true", "train.adapt_interval=2",
                      "quant.lb_upr=3", "train.log_every=1"]
    cfg = load_config("tiny", overrides=ov)
    assert cfg.quant.stochastic_rounding
    history = []
    state = None
    for steps in (2, 4):
        state, h = train_loop.train(cfg, steps=steps, state=state,
                                    device="cpu", log=lambda s: None)
        history += h
        assert all(int(ts["count"].max()) == 0
                   for ts in state["adapt"]["tensors"].values())
    assert [h["step"] for h in history] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in history)
    adapt, params = state["adapt"], state["params"]
    seeds = controller.leaf_seeds(int(state["rng"]), 6, adapt["tensors"])
    sr = _flat(controller.quantize_params_packed(params, adapt, cfg.quant,
                                                 seeds))
    rtn = _flat(controller.quantize_params_packed(params, adapt, cfg.quant))
    for path in adapt["tensors"]:
        a, b = sr[path + "/q8"], rtn[path + "/q8"]
        assert not torch.equal(a, b), path
        assert int((a.int() - b.int()).abs().max()) == 1, path


def test_reference_state_round_trips_and_trains_through_a_switch():
    """A fresh reference state becomes a port state (its PRNGKey(seed) the
    port's int64 run seed) on which train runs through a switch; a key
    that no seed stands for raises."""
    ov = OVERRIDES + ["quant.use_pallas=true", "train.adapt_interval=2",
                      "train.log_every=1"]
    jcfg = jax_load_config("tiny", overrides=ov + ["train.seed=1234"])
    jstate = jax_train_loop.init_state(jcfg)
    state = interop.train_state_from_numpy(_np(jstate), "cpu")
    assert state["rng"].dtype == torch.int64 and state["rng"].ndim == 0
    assert int(state["rng"]) == 1234
    fresh = train_loop.init_state(load_config("tiny", overrides=ov + [
        "train.seed=1234"]), device="cpu")
    assert torch.equal(state["rng"], fresh["rng"])
    state, history = train_loop.train(
        load_config("tiny", overrides=ov), steps=2, state=state,
        device="cpu", log=lambda s: None)
    assert int(state["step"]) == 2 and np.isfinite(history[-1]["loss"])
    assert all(int(ts["count"].max()) == 0
               for ts in state["adapt"]["tensors"].values())
    for key in (jax.random.split(jstate["rng"])[0],
                jax.random.fold_in(jstate["rng"], 3)):
        with pytest.raises(ValueError, match="PRNGKey"):
            interop.seed_from_key(np.asarray(key))

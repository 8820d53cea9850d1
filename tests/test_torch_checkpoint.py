"""The port's checkpoints: the counterparts of ``tests/test_checkpoint.py``
(the controller's int32 ⟨WL,FL⟩ and every other leaf restored bit for bit,
a missing DONE falls back, a CRC mismatch raises, an async writer's
failure surfaces on wait and on the next save, SIGTERM saves a final
checkpoint and the resumed run equals the uninterrupted one), checkpoints
crossing between the packages both ways with one step on each side from
the crossed state, and the meta map's MessagePack codec against the
``msgpack`` package.
"""
import os
import signal

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.config import load_config as jax_load_config  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import load_config  # noqa: E402
from repro_torch.train import checkpoint, train_loop  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.fault_tolerance import (Heartbeat,  # noqa: E402
                                               PreemptionGuard)

SMALL = ["train.global_batch=2", "train.seq_len=16", "quant.init_fl=8",
         "train.adapt_interval=2", "quant.lb_lwr=2"]
PACKED = ["quant.container_dtype=int8_packed", "quant.use_pallas=true"]
# One step on each side from the crossed state: the slice-2 bounds of a
# first step (tests/test_torch_train.py): loss within 2e-3, grad_norm and
# every leaf's update within 2e-2 normwise.
LOSS_RTOL = 2e-3
UPDATE_NORMWISE = 2e-2


def _cfg(container="float32", *extra):
    ov = SMALL + (PACKED if container == "int8_packed" else []) + list(extra)
    return load_config("tiny", overrides=ov)


def _train(cfg, steps, state=None, **kw):
    return train_loop.train(cfg, steps=steps, state=state, device="cpu",
                            log=lambda s: None, **kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _assert_same_bits(got, want, what=""):
    """Two states (torch or numpy leaves), leaf by leaf: the same keys,
    dtypes, shapes and bits."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for path in w:
        a, b = g[path], w[path]
        if isinstance(a, torch.Tensor):
            a = interop.tensor_to_numpy(a)
        if isinstance(b, torch.Tensor):
            b = interop.tensor_to_numpy(b)
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, path,
                                                            a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), f"{what} {path} differs"


# ---------------------------------------------------------------------------
# Full state restore


@pytest.mark.parametrize("container", ["float32", "int8_packed"])
def test_restore_preserves_adapt_state_exactly(container, tmp_path):
    """Every leaf, the controller's int32 ⟨WL,FL⟩, lookback and resolution
    and the bf16 "grad_sum" among them, comes back bit for bit after two
    switches, and training goes on from it."""
    cfg = _cfg(container)
    state, _ = _train(cfg, 4)
    assert state["adapt"]["tensors"], "controller state empty — bad setup"
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(state, step=4)
    restored = mgr.restore(train_loop.init_state(cfg, device="cpu"))
    _assert_same_bits(restored, state, container)
    for path, ts in restored["adapt"]["tensors"].items():
        for field in ("wl", "fl", "lb", "res"):
            assert ts[field].dtype == torch.int32, (path, field)
        assert ts["grad_sum"].dtype == torch.bfloat16
    assert restored["rng"].dtype == torch.int64
    st2, _ = _train(cfg, 2, restored)
    assert int(st2["step"]) == 6
    meta = mgr.restore_meta()
    assert meta["step"] == 4 and meta["device_count"] == 1
    assert meta["num_arrays"] == len(_flat(state))


def test_restore_missing_done_falls_back(tmp_path):
    cfg = _cfg("int8_packed")
    state, _ = _train(cfg, 2)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(state, step=2)
    st4, _ = _train(cfg, 2, state)
    mgr.save(st4, step=4)
    os.remove(tmp_path / "step_00000004" / "DONE")   # a torn write
    assert mgr.latest_step() == 2
    restored = mgr.restore(train_loop.init_state(cfg, device="cpu"))
    assert int(restored["step"]) == 2


def test_restore_crc_mismatch_raises(tmp_path):
    cfg = _cfg("int8_packed")
    state = train_loop.init_state(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(state, step=2)
    npz = tmp_path / "step_00000002" / "arrays.npz"
    data = bytearray(npz.read_bytes())
    data[len(data) // 2] ^= 0xFF
    npz.write_bytes(bytes(data))
    with pytest.raises(IOError, match="CRC"):
        mgr.restore(train_loop.init_state(cfg, device="cpu"))


def test_restore_checks_every_leaf(tmp_path):
    cfg = _cfg("int8_packed")
    state = train_loop.init_state(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(state, step=1)
    wider = train_loop.init_state(load_config("tiny", overrides=SMALL + [
        "model.d_model=32"]), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(wider)
    extra = train_loop.init_state(cfg, device="cpu")
    extra["params"]["more"] = torch.zeros(3)
    with pytest.raises(KeyError, match="params::more"):
        mgr.restore(extra)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_keep_prunes_the_oldest(tmp_path):
    state = train_loop.init_state(_cfg("int8_packed"), device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3):
        mgr.save(state, step=s)
    assert mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]


def test_save_copies_before_the_writer_runs(tmp_path):
    """The step updates the state in place: what lands is the state as it
    was when ``save`` returned."""
    state = train_loop.init_state(_cfg("int8_packed"), device="cpu")
    want = interop.to_numpy(state)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(state, step=1)
    state["params"]["head"].add_(1.0)
    state["adapt"]["tensors"]["head"]["grad_sum"].add_(1.0)
    mgr.wait()
    fresh = train_loop.init_state(_cfg("int8_packed"), device="cpu")
    _assert_same_bits(mgr.restore(fresh), want)


# ---------------------------------------------------------------------------
# Async-save error surfacing


def _blocked(mgr, tmp_path):
    """Point the writer at a path under a regular file: makedirs raises."""
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    mgr.dir = str(blocker / "nested")


def test_async_save_failure_surfaces_on_wait(tmp_path):
    state = train_loop.init_state(_cfg("int8_packed"), device="cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    _blocked(mgr, tmp_path)
    mgr.save(state, step=2)
    with pytest.raises(IOError, match="async checkpoint save failed"):
        mgr.wait()
    mgr.dir = str(tmp_path)           # the error is consumed
    mgr.save(state, step=2)
    mgr.wait()
    assert mgr.latest_step() == 2


def test_async_save_failure_surfaces_on_next_save(tmp_path):
    state = train_loop.init_state(_cfg("int8_packed"), device="cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    _blocked(mgr, tmp_path)
    mgr.save(state, step=2)
    mgr._thread.join()                # the failure lands, unconsumed
    mgr.dir = str(tmp_path)
    with pytest.raises(IOError, match="async checkpoint save failed"):
        mgr.save(state, step=3)


# ---------------------------------------------------------------------------
# Preemption contract


def test_sigterm_saves_final_checkpoint_and_resume_matches(tmp_path):
    """SIGTERM during step 3: the loop saves at step 3 and returns; the
    run resumed from that checkpoint equals the uninterrupted one bit for
    bit (batches, SR seeds and noise key off the step index)."""
    cfg = _cfg("int8_packed", "train.checkpoint_every=100",
               "quant.stochastic_rounding=true")
    ref_state, _ = _train(cfg, 6)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    fired = []

    def emit(line):
        if "step=3 " in line and not fired:
            fired.append(True)
            os.kill(os.getpid(), signal.SIGTERM)

    with PreemptionGuard() as guard:
        st3, _ = _train(cfg, 6, checkpoint_mgr=mgr, preemption_guard=guard,
                        heartbeat=Heartbeat(interval=0.0, emit=emit))
    assert fired and int(st3["step"]) == 3
    assert mgr.latest_step() == 3
    restored = mgr.restore(train_loop.init_state(cfg, device="cpu"))
    _assert_same_bits(restored, st3, "restored")
    resumed, _ = _train(cfg, 3, restored)
    assert int(resumed["step"]) == 6
    _assert_same_bits(resumed, ref_state, "resumed")


def test_periodic_saves_and_the_loop_hooks(tmp_path):
    cfg = _cfg("int8_packed", "train.checkpoint_every=2", "train.log_every=1")
    mgr = CheckpointManager(str(tmp_path), keep=5, async_save=True)
    telemetry, beats = [], []
    state, history = _train(cfg, 5, checkpoint_mgr=mgr, telemetry=telemetry,
                            heartbeat=Heartbeat(interval=0.0,
                                                emit=beats.append))
    mgr.wait()
    assert mgr.all_steps() == [2, 4]
    assert len(telemetry) == 2 and len(beats) == 5 and len(history) == 5
    assert set(telemetry[0]) == set(state["adapt"]["tensors"])


# ---------------------------------------------------------------------------
# Crossing: a checkpoint of either package restores into the other


@pytest.fixture(scope="module")
def crossing():
    """The reference's step (jitted without excess precision) and switch
    on the packed path with SR words, two steps and a switch from its
    init; the port's two steps and switch from its own init."""
    ov = SMALL + PACKED + ["quant.stochastic_rounding=true"]
    jcfg = jax_load_config("tiny", overrides=ov)
    cfg = load_config("tiny", overrides=ov)
    jstate = jax_train_loop.init_state(jcfg)
    batches = [jax.tree.map(np.asarray, jax_train_loop.make_batch(jcfg, i))
               for i in range(3)]
    jstep = jax.jit(jax_train_loop.make_train_step(jcfg)).lower(
        jstate, batches[0]).compile(
            compiler_options={"xla_allow_excess_precision": False})
    jswitch = jax.jit(jax_train_loop.make_precision_switch(jcfg))
    for b in batches[:2]:
        jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, b))
    jstate = jswitch(jstate)
    tstate, _ = _train(cfg, 2)
    return dict(jcfg=jcfg, cfg=cfg, jstep=jstep, jstate=jstate,
                tstate=tstate, batch=batches[2])


def _one_step_each(r, jstate, tstate):
    """One step of each package from the same state (given as both)."""
    p0 = _flat(jax.tree.map(np.asarray, jstate["params"]))
    jout, jm = r["jstep"](jstate, jax.tree.map(jnp.asarray, r["batch"]))
    tout, tm = train_loop.make_train_step(r["cfg"])(
        tstate, {k: torch.from_numpy(np.array(v))
                 for k, v in r["batch"].items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=UPDATE_NORMWISE)
    jp = _flat(jax.tree.map(np.asarray, jout["params"]))
    tp = _flat(interop.to_numpy(tout["params"]))
    for path, w0 in p0.items():
        want, got = jp[path] - w0, tp[path] - w0
        err = float(np.linalg.norm((got - want).ravel()))
        assert err <= UPDATE_NORMWISE * float(np.linalg.norm(want.ravel())), \
            path


def test_reference_checkpoint_restores_into_the_port(crossing, tmp_path):
    r = crossing
    JaxManager(str(tmp_path), async_save=False).save(r["jstate"], step=2)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_meta() == JaxManager(str(tmp_path)).restore_meta()
    restored = mgr.restore(train_loop.init_state(r["cfg"], device="cpu"))
    want = interop.train_state_from_numpy(
        jax.tree.map(np.asarray, r["jstate"]), "cpu")
    _assert_same_bits(restored, want, "reference → port")
    assert int(restored["rng"]) == r["cfg"].train.seed
    _one_step_each(r, r["jstate"], restored)


def test_port_checkpoint_restores_into_the_reference(crossing, tmp_path):
    r = crossing
    CheckpointManager(str(tmp_path), async_save=False).save(r["tstate"],
                                                            step=2)
    restored = JaxManager(str(tmp_path)).restore(
        jax_train_loop.init_state(r["jcfg"]))
    want = interop.to_numpy({k: v for k, v in r["tstate"].items()
                             if k != "rng"})
    got = jax.tree.map(np.asarray, restored)
    np.testing.assert_array_equal(got.pop("rng"), np.array(
        [0, r["cfg"].train.seed], np.uint32))
    _assert_same_bits(got, want, "port → reference")
    assert restored["adapt"]["tensors"]["head"]["wl"].dtype == jnp.int32
    port = CheckpointManager(str(tmp_path)).restore(
        train_loop.init_state(r["cfg"], device="cpu"))
    _one_step_each(r, restored, port)


def test_run_seed_needs_a_prngkey_form(tmp_path):
    state = train_loop.init_state(_cfg("int8_packed"), device="cpu")
    state["rng"] = torch.tensor(2 ** 32, dtype=torch.int64)
    with pytest.raises(ValueError, match="PRNGKey"):
        CheckpointManager(str(tmp_path), async_save=False).save(state, 1)
    flat = checkpoint.flatten_state(train_loop.init_state(
        _cfg("int8_packed"), device="cpu"))
    assert flat["rng"].dtype == np.uint32 and flat["step"].dtype == np.int32
    flat["rng"] = np.array([1, 5], np.uint32)           # a folded key
    with pytest.raises(ValueError, match="PRNGKey"):
        checkpoint.unflatten_into(
            train_loop.init_state(_cfg("int8_packed"), device="cpu"), flat)


# ---------------------------------------------------------------------------
# The meta map's MessagePack codec

_EDGES = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
          2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
          -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.5, -0.0, float("inf"), "",
          "x" * 31, "x" * 32, "x" * 255, "x" * 256, "ü" * 40000, {},
          {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
          {str(i): None for i in range(70000)},
          {"step": 6, "crc32": 4000000000, "num_arrays": 95,
           "device_count": 1}]


@pytest.mark.parametrize("obj", _EDGES, ids=[str(i) for i in range(len(_EDGES))])
def test_codec_writes_msgpacks_bytes(obj):
    data = msgpack.packb(obj)
    assert checkpoint.packb(obj) == data
    assert checkpoint.unpackb(data) == msgpack.unpackb(data)


def test_codec_refuses_other_types():
    for other in (b"bytes", [1, 2], 1.25):
        data = msgpack.packb(other, use_single_float=True)
        with pytest.raises(ValueError, match=f"0x{data[0]:02x}"):
            checkpoint.unpackb(data)
    for other in ({"x": np.int32(3)}, [1], (1,), b"x"):
        with pytest.raises(TypeError):
            checkpoint.packb(other)
    with pytest.raises(OverflowError):
        checkpoint.packb(2 ** 64)
    with pytest.raises(ValueError, match="bytes after"):
        checkpoint.unpackb(msgpack.packb(1) + b"\x00")


_META = st.recursive(
    st.none() | st.booleans()
    | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
    | st.floats(allow_nan=False) | st.text(max_size=40),
    lambda children: st.dictionaries(st.text(max_size=12), children,
                                     max_size=6),
    max_leaves=30)


@settings(max_examples=200, deadline=None, database=None)
@given(st.dictionaries(st.text(max_size=20), _META, max_size=20))
def test_codec_matches_msgpack_on_drawn_maps(meta):
    data = msgpack.packb(meta)
    assert checkpoint.packb(meta) == data
    assert checkpoint.unpackb(data) == meta

"""The CNN family's run around the step, against the JAX reference:
gradient accumulation (stats and accuracy of the last microbatch), the
checkpoint round trip with batch-norm stats in both directions,
``quantize_for_serving`` on a CNN tree with the eval forward,
``train_loop.train`` on both models and ``launch.train --arch resnet20``.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import apply_overrides as jax_apply_overrides  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.models import cnn as jax_cnn  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import apply_overrides  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import controller  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's many small torch ops run on one thread: beside other
    test processes an intra-op thread pool only waits for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SWITCH = ["train.adapt_interval=2", "quant.lb_lwr=2"]
# Stats after a step of 2 microbatches against the reference's (f32 sums
# in other orders; measured 4e-7 of the largest)
STATS_RTOL = 2e-5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _assert_same_bits(got, want, what):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for path, v in w.items():
        a = interop.tensor_to_numpy(g[path]) if isinstance(
            g[path], torch.Tensor) else np.asarray(g[path])
        b = interop.tensor_to_numpy(v) if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {path}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {path}")


def test_accumulation_keeps_the_last_microbatchs_stats_and_accuracy():
    """ResNet20 with 2 microbatches: the new stats and ``acc`` are the
    second microbatch's (each read the step's input stats), within
    ``STATS_RTOL`` of the reference's step and equal to the port's forward
    on the second half alone."""
    ov = ["train.accum_steps=2"]
    jcfg = jax_apply_overrides(jax_smoke("resnet20"), ov)
    cfg = apply_overrides(get_smoke_config("resnet20"), ov)
    jstate = jax.tree.map(np.asarray, jax.jit(
        functools.partial(jax_train_loop.init_state, jcfg))())
    jbatch = jax.tree.map(np.asarray, jax_train_loop.make_batch(jcfg, 0))
    jafter, jm = jax.jit(jax_train_loop.make_train_step(jcfg))(
        jax.tree.map(jnp.asarray, jstate), jbatch)
    state = interop.train_state_from_numpy(jstate, "cpu")
    stats0 = interop.params_from_numpy(jstate["stats"], "cpu")
    params0 = interop.params_from_numpy(jstate["params"], "cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    after, tm = train_loop.make_train_step(cfg)(state, batch, step=0)
    assert float(tm["acc"]) == float(jm["acc"])
    jstats = _flat(jax.tree.map(np.asarray, jafter["stats"]))
    tstats = _flat(after["stats"])
    for path, want in jstats.items():
        err = float(np.max(np.abs(tstats[path].numpy() - want)))
        assert err <= STATS_RTOL * float(np.max(np.abs(want))), path
    # the second half alone, on the step's quantized copy, from the input stats
    seeds = controller.leaf_seeds(int(state["rng"]), 0,
                                  state["adapt"]["tensors"])
    adapt0 = interop.adapt_state_from_numpy(jstate["adapt"], "cpu")
    qp = train_loop._quantized_copy(cfg, params0, adapt0, seeds,
                                    controller.step_key(int(state["rng"]), 0))
    with torch.no_grad():
        halves = []
        for rows in (slice(0, 8), slice(8, 16)):
            logits, new = cnn.resnet20_forward(qp, stats0,
                                               batch["images"][rows], True)
            halves.append((cnn.accuracy(logits, batch["labels"][rows]),
                           _flat(new)))
    assert float(tm["acc"]) == float(halves[1][0])
    for path, v in halves[1][1].items():
        assert torch.equal(tstats[path], v), path
    assert any(not torch.equal(tstats[p], v)
               for p, v in halves[0][1].items())


@functools.lru_cache(maxsize=None)
def _crossing():
    cfg = apply_overrides(get_smoke_config("resnet20"), SWITCH)
    jcfg = jax_apply_overrides(jax_smoke("resnet20"), SWITCH)
    jstate = jax.jit(functools.partial(jax_train_loop.init_state, jcfg))()
    step = jax.jit(jax_train_loop.make_train_step(jcfg))
    for i in range(2):
        jstate, _ = step(jstate, jax_train_loop.make_batch(jcfg, i))
    return cfg, jcfg, jstate


def test_reference_checkpoint_with_stats_restores_into_the_port(tmp_path):
    cfg, jcfg, jstate = _crossing()
    JaxManager(str(tmp_path), async_save=False).save(jstate, step=2)
    restored = CheckpointManager(str(tmp_path)).restore(
        train_loop.init_state(cfg, device="cpu"))
    want = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          "cpu")
    assert _flat(restored["stats"]) and int(restored["step"]) == 2
    _assert_same_bits(restored, want, "reference → port")


def test_port_checkpoint_with_stats_restores_into_the_reference(tmp_path):
    cfg, jcfg, jstate = _crossing()
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           "cpu")
    state, _ = train_loop.make_train_step(cfg)(
        state, train_loop.make_batch(cfg, 2, device="cpu"), step=2)
    CheckpointManager(str(tmp_path), async_save=False).save(state, step=3)
    restored = jax.tree.map(np.asarray, JaxManager(str(tmp_path)).restore(
        jax_train_loop.init_state(jcfg)))
    restored.pop("rng")
    _assert_same_bits(restored, interop.to_numpy(
        {k: v for k, v in state.items() if k != "rng"}), "port → reference")
    back = CheckpointManager(str(tmp_path)).restore(
        train_loop.init_state(cfg, device="cpu"))
    _assert_same_bits(back, state, "port → port")


def test_quantize_for_serving_on_a_cnn_tree():
    """RTN grid values at the final ⟨WL,FL⟩ of every quantized leaf, the
    rest as they are, bit-equal to the reference's; the eval forward on
    them gives the reference's held-out accuracy (its ``_eval_acc``, on
    the reference's batches)."""
    cfg, jcfg, jstate = _crossing()
    jstate = jax.jit(jax_train_loop.make_precision_switch(jcfg))(jstate)
    jq = jax_engine.quantize_for_serving(jstate["params"], jstate["adapt"],
                                         jcfg.quant)
    npstate = jax.tree.map(np.asarray, jstate)
    state = interop.train_state_from_numpy(npstate, "cpu")
    tq = engine.quantize_for_serving(state["params"], state["adapt"],
                                     cfg.quant)
    _assert_same_bits(tq, jax.tree.map(np.asarray, jq), "serving copy")
    jfwd = jax.jit(jax_cnn.resnet20_forward, static_argnums=3)
    for i in range(2):
        b = jax_synthetic.cifar_batch(10, 16, 10_000 + i, 0)
        jl, _ = jfwd(jq, jstate["stats"], b["images"], False)
        tl, _ = cnn.resnet20_forward(tq, state["stats"],
                                     torch.from_numpy(np.array(b["images"])),
                                     False)
        assert float(cnn.accuracy(tl, torch.from_numpy(np.array(
            b["labels"])))) == float(jax_cnn.accuracy(jl, b["labels"]))


@pytest.mark.parametrize("name", ["alexnet", "resnet20"])
def test_train_runs_the_cnn_family(name):
    """``train_loop.train`` on the smoke configs with ``device="cpu"``:
    the loop logs ``acc=``, switches after step 2 and 4, keeps the stats
    in the state; over more than one data rank the family raises by name
    (its batch-norm statistics are the global batch's)."""
    cfg = apply_overrides(get_smoke_config(name),
                          SWITCH + ["train.log_every=1"])
    logged, telemetry = [], []
    state, history = train_loop.train(cfg, steps=4, device="cpu",
                                      log=logged.append, telemetry=telemetry)
    assert [h["step"] for h in history] == [1, 2, 3, 4]
    assert all("acc=" in line for line in logged)
    assert all(0.0 <= h["acc"] <= 1.0 and np.isfinite(h["loss"])
               for h in history)
    assert len(telemetry) == 2 and set(telemetry[0]) == set(
        state["adapt"]["tensors"])
    assert bool(_flat(state["stats"])) == (name == "resnet20")
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import Mesh
    qsgd = apply_overrides(cfg, ["train.qsgd_pod_compression=true"])
    with pytest.raises(NotImplementedError, match="CNN family"):
        train_loop.make_train_step(qsgd, mesh=Mesh(("pod", "data", "model"),
                                                   (2, 1, 1)))


@pytest.mark.parametrize("classes", [10, 100])
def test_launcher_trains_resnet20(classes, capsys):
    argv = ["--arch", "resnet20", "--smoke", "--device", "cpu", "--steps",
            "2", "--override", "train.log_every=1", "--override",
            f"model.vocab_size={classes}"]
    assert train_launcher.main(argv) == 0
    out = capsys.readouterr().out
    assert "acc=" in out and "[train] done: step=2" in out

"""The port's data-parallel step against the reference's live mesh step.

The reference runs its mesh path on the CPU when the mesh is built with
``jax.sharding.Mesh`` (Auto axes; ``make_cpu_mesh``'s ``jax.make_mesh``
gives Explicit axes, on which ``sharding.shard`` raises). Its 4-device
step runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: the full sharded
step of ``launch/dryrun.py:39-60`` on a (2, 2, 1) (pod, data, model)
mesh, with ``quant.use_pallas``, ``quant.fused_prng``, ``train.zero_shard``
and ``train.qsgd_pod_compression``, the float32 container and SR; it runs
the per-shard Pallas SR kernels in interpret mode. The port runs the same
step on 4 gloo ranks, each a subprocess of this file, from the reference's
initial state and batch.

Both steps are compiled or run without excess precision where that
matters: the reference's jitted step is compiled with
``xla_allow_excess_precision=False`` (tests/test_torch_containers.py).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

OVERRIDES = ["quant.use_pallas=true", "quant.fused_prng=true",
             "train.zero_shard=true", "train.qsgd_pod_compression=true",
             "quant.container_dtype=float32", "quant.stochastic_rounding=true",
             "train.global_batch=4", "train.seq_len=32"]

# The quantized copies agree bit for bit and, on one rank, the losses to
# the last bit. The updates differ where the two sum the same products in
# other orders: within 7.4e-3 normwise per leaf without QSGD (one rank,
# the reference compiled without excess precision). QSGD's stochastic
# rounding turns a gradient element on either side of a level boundary
# into words one level (amax/127) apart, which moves a leaf's update by up
# to 1.9e-2 normwise on one rank: held at 3e-2.
UPDATE_NORMWISE = 3e-2
LOSS_RTOL = 1e-5
# On four devices the losses agree to the last bit: each rank quantizes
# its activations at the FL of the whole batch's maximum (all-reduced, as
# GSPMD reduces the reference's jnp.max). The updates and "grad_sum" differ
# where QSGD's stochastic rounding turns an element on either side of a
# level boundary into words one level apart (1.76e-2 normwise measured):
# held at the one-rank QSGD bound.
FOUR_RANK_NORMWISE = UPDATE_NORMWISE
# Two ranks against one process that takes the whole global batch with the
# same words (no mesh: the ranks' split of the batch is not shared). Each
# rank's weight gradients come out of bf16 GEMMs on its half of the rows,
# rounded to bf16 there (≤ 2^-9 relative an element) and then averaged,
# where the one process rounds the whole batch's once: the updates differ
# by that rounding, 2.4e-3 normwise per leaf measured, held at 1e-2. The
# losses are means of the same per-token terms in other orders: 1e-6.
TWO_RANK_NORMWISE = 1e-2
TWO_RANK_LOSS_RTOL = 1e-6
CHILD_TIMEOUT_S = 240
GLOO_TIMEOUT_S = 60


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _updates_close(before, after_ref, after_port, bound):
    """Per leaf ‖Δport − Δref‖ ≤ bound·‖Δref‖."""
    b, r, t = _flat(before), _flat(after_ref), _flat(after_port)
    assert set(r) == set(t)
    for k in r:
        dr = np.asarray(r[k], np.float32) - np.asarray(b[k], np.float32)
        dt = np.asarray(t[k], np.float32) - np.asarray(b[k], np.float32)
        err = float(np.linalg.norm(dt - dr))
        ref = float(np.linalg.norm(dr))
        assert err <= bound * ref, f"{k}: |diff| {err} > {bound} * {ref}"


def _wlfl(adapt):
    return {p: (np.asarray(ts["wl"]).tolist(), np.asarray(ts["fl"]).tolist())
            for p, ts in adapt["tensors"].items()}


def _run(cmds, timeout=CHILD_TIMEOUT_S):
    """Start every command, wait for all; a child that outlives the
    timeout is killed and fails the test."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for c, env in cmds]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a child ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _env():
    """The children's environment: the repo's sources, one thread each, and
    no device-count flag of the parent's (the reference child sets its
    own)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    return env


# ---------------------------------------------------------------------------
# Children


_REFERENCE = r'''
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import sharding
from repro.config import load_config
from repro.launch import mesh as mesh_lib, specs as specs_lib
from repro.train import train_loop
args = pickle.load(open(sys.argv[1], "rb"))
cfg = load_config("tiny", overrides=args["overrides"])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(args["shape"]),
            ("pod", "data", "model"))
rules = mesh_lib.make_rules(cfg, mesh, "train")
state = jax.tree.map(jnp.asarray, args["state"])
state["rng"] = jnp.asarray(args["state"]["rng"], jnp.uint32)
batch = jax.tree.map(jnp.asarray, args["batch"])
opts = {"xla_allow_excess_precision": False}
with sharding.use_rules(mesh, rules):
    ssh = mesh_lib.state_shardings(specs_lib.state_specs(cfg), cfg, mesh)
    bsh = mesh_lib.batch_shardings(specs_lib.batch_specs(cfg), mesh)
    fn = jax.jit(train_loop.make_train_step(cfg, qparam_shardings=ssh["params"]),
                 in_shardings=(ssh, bsh), out_shardings=(ssh, None))
    step = fn.lower(state, batch).compile(compiler_options=opts)
    state, m = step(state, batch)
    sw = jax.jit(train_loop.make_precision_switch(cfg), in_shardings=(ssh,),
                 out_shardings=ssh)
    switched = sw.lower(state).compile(compiler_options=opts)(state)
out = {"state": jax.tree.map(np.asarray, state),
       "metrics": {k: float(v) for k, v in m.items()},
       "switched": jax.tree.map(np.asarray, switched["adapt"])}
pickle.dump(out, open(sys.argv[2], "wb"))
'''


def _rank_main(argv):
    """One rank of the port: the reference's state cut to its blocks, one
    step on the (pod, data, model) mesh, a switch; rank files hold the
    gathered state, the metrics and ⟨WL,FL⟩."""
    rank, world, store, args_path, out_path = argv
    torch.set_num_threads(1)
    from repro_torch import distributed as dst
    from repro_torch import interop
    from repro_torch.config import load_config
    from repro_torch.train import train_loop
    args = pickle.load(open(args_path, "rb"))
    cfg = load_config("tiny", overrides=args["overrides"])
    pod, data, model = args["shape"]
    mesh = dst.init_mesh({"pod": pod, "data": data, "model": model}, "gloo",
                         device="cpu", rank=int(rank), world_size=int(world),
                         init_method=f"file://{store}",
                         timeout_s=GLOO_TIMEOUT_S)
    state = train_loop.shard_state(
        interop.train_state_from_numpy(args["state"], "cpu"), cfg, mesh)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             args["batch"].items()}
    state, m = train_loop.make_train_step(cfg, mesh=mesh)(state, batch, step=0)
    whole = train_loop.gather_state(state, mesh)
    switched = train_loop.make_precision_switch(cfg, mesh=mesh)(state)
    out = {"params": interop.to_numpy(whole["params"]),
           "grad_sum": {p: interop.tensor_to_numpy(ts["grad_sum"]) for p, ts
                        in whole["adapt"]["tensors"].items()},
           "metrics": {k: float(v) for k, v in m.items()},
           "wlfl": _wlfl(switched["adapt"]),
           "blocks": {p: tuple(t.shape) for p, t in
                      _flat(state["params"]).items()}}
    pickle.dump(out, open(out_path, "wb"))
    dst.destroy(mesh)


# ---------------------------------------------------------------------------
# Tests


def _reference_start(overrides):
    from repro.config import load_config as jax_load_config
    from repro.train import train_loop as jtl
    jcfg = jax_load_config("tiny", overrides=overrides)
    return (jax.tree.map(np.asarray, jtl.init_state(jcfg)),
            jax.tree.map(np.asarray, jtl.make_batch(jcfg, 0)))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference's 4-device step and the port's 4 gloo ranks, run at
    once from the same state and batch."""
    tmp = tmp_path_factory.mktemp("dp4")
    state, batch = _reference_start(OVERRIDES)
    args = {"overrides": OVERRIDES, "shape": (2, 2, 1), "state": state,
            "batch": batch}
    args_path = tmp / "args.pkl"
    pickle.dump(args, open(args_path, "wb"))
    ref_out = tmp / "reference.pkl"
    cmds = [([sys.executable, "-c", _REFERENCE, str(args_path), str(ref_out)],
             _env())]
    for r in range(4):
        cmds.append(([sys.executable, __file__, str(r), "4",
                      str(tmp / "store"), str(args_path),
                      str(tmp / f"rank{r}.pkl")], _env()))
    _run(cmds)
    ranks = [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(4)]
    return {"start": state, "ref": pickle.load(open(ref_out, "rb")),
            "ranks": ranks}


def _one_process_step(cfg, state_np, batch_np, sizes):
    """The ranks' step in one process with no mesh: the same words (each
    leaf the ranks hold in blocks quantized block by block with its
    per-shard seeds), the gradients of the whole global batch, the
    update. Returns the params and metrics."""
    from repro_torch import distributed as dst
    from repro_torch import interop
    from repro_torch.core import controller
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import (Mesh, NamedSharding, folded_axes,
                                      held_in_blocks)
    from repro_torch.train import train_loop
    names = ("pod", "data", "model")
    state = interop.train_state_from_numpy(state_np, "cpu")
    mesh = Mesh(names, sizes)
    sh = dict(controller.flatten_with_path(mesh_lib.state_shardings(
        {"params": state["params"]}, cfg, mesh)["params"]))
    tensors = state["adapt"]["tensors"]
    seeds = controller.leaf_seeds(int(state["rng"]), 0, tensors)
    q = controller.quantize_params(state["params"], state["adapt"], cfg.quant,
                                   seeds)
    for p, leaf in controller.flatten_with_path(state["params"]):
        if p not in tensors or not folded_axes(sh[p].spec, leaf.ndim):
            continue
        assert held_in_blocks(leaf.shape, sh[p]), p
        words = torch.empty_like(leaf)
        for r in range(mesh.size):
            m = mesh.at(dst.rank_coords(r, names, sizes))
            sl = dst.block_slices(leaf.shape, sh[p].spec, m)
            words[sl] = ops.sr_quantize_fused(
                leaf[sl], seeds[p], tensors[p]["wl"], tensors[p]["fl"],
                use_pallas=True,
                sharding=NamedSharding(m, sh[p].spec, tuple(leaf.shape)))
        controller._set_path(q, p, words)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in batch_np.items()}
    g, full, task, aux = train_loop.loss_and_grads(cfg, q, state, batch)
    state, m = train_loop.apply_grads(cfg, state, g, full, task, aux)
    return interop.to_numpy(state["params"]), {k: float(v)
                                               for k, v in m.items()}


def test_two_rank_step_matches_one_process(tmp_path):
    """A (1, 2, 1) zero-sharded step on two gloo ranks against one process
    that takes the whole global batch: a fault in how the ranks split the
    batch (both taking the same rows, say) would move the updates by the
    gradient of other data."""
    from repro_torch.config import load_config
    ov = [o for o in OVERRIDES if "qsgd" not in o]
    state, batch = _reference_start(ov)
    args = {"overrides": ov, "shape": (1, 2, 1), "state": state,
            "batch": batch}
    args_path = tmp_path / "args.pkl"
    pickle.dump(args, open(args_path, "wb"))
    _run([([sys.executable, __file__, str(r), "2", str(tmp_path / "store"),
            str(args_path), str(tmp_path / f"rank{r}.pkl")], _env())
          for r in range(2)])
    ranks = [pickle.load(open(tmp_path / f"rank{r}.pkl", "rb"))
             for r in range(2)]
    params, m = _one_process_step(load_config("tiny", overrides=ov), state,
                                  batch, (1, 2, 1))
    for r in ranks:
        for k in ("loss", "full_loss"):
            np.testing.assert_allclose(r["metrics"][k], m[k],
                                       rtol=TWO_RANK_LOSS_RTOL)
    _updates_close(state["params"], params, ranks[0]["params"],
                   TWO_RANK_NORMWISE)


def test_four_rank_step_matches_reference(four_ranks):
    ref, ranks = four_ranks["ref"], four_ranks["ranks"]
    for r in ranks:
        for k in ("loss", "full_loss"):
            assert r["metrics"][k] == ref["metrics"][k], k
        np.testing.assert_allclose(r["metrics"]["grad_norm"],
                                   ref["metrics"]["grad_norm"], rtol=2e-3)
        assert r["metrics"]["lr"] == ref["metrics"]["lr"]
    # every rank gathers the same state, bit for bit
    for r in ranks[1:]:
        for k, v in _flat(r["params"]).items():
            assert np.array_equal(v, _flat(ranks[0]["params"])[k]), k
    _updates_close(four_ranks["start"]["params"], ref["state"]["params"],
                   ranks[0]["params"], FOUR_RANK_NORMWISE)


def test_four_rank_blocks_follow_the_specs(four_ranks):
    """zero_shard folds data into every leaf: a (2, 2, 1) rank holds half
    of each weight's data dim (wq (L, 64, 64) → (L, 32, 64); embed
    (256, 64) → (256, 32)); "grad_sum" gathers whole."""
    blocks = four_ranks["ranks"][0]["blocks"]
    assert blocks["blocks/s0_attn/wq"] == (2, 32, 64)
    assert blocks["blocks/s0_attn/wo"] == (2, 64, 32)
    assert blocks["embed"] == (256, 32)
    assert blocks["final_norm"] == (32,)
    ref_gs = {p: ts["grad_sum"] for p, ts in
              four_ranks["ref"]["state"]["adapt"]["tensors"].items()}
    for p, g in four_ranks["ranks"][0]["grad_sum"].items():
        got = np.asarray(g, np.float32)
        want = np.asarray(ref_gs[p], np.float32)
        err = float(np.linalg.norm(got - want))
        assert err <= FOUR_RANK_NORMWISE * float(np.linalg.norm(want)), p


def test_four_rank_switch_matches_reference(four_ranks):
    """⟨WL,FL⟩ after a switch on the mesh: equal on every rank, and equal
    to the reference's."""
    ranks = four_ranks["ranks"]
    for r in ranks[1:]:
        assert r["wlfl"] == ranks[0]["wlfl"]
    assert ranks[0]["wlfl"] == _wlfl(four_ranks["ref"]["switched"])


@pytest.mark.parametrize("qsgd", [False, True], ids=["plain", "qsgd"])
def test_one_rank_step_matches_reference(qsgd):
    """A (1, 1, 1) mesh in one process: the reference's live step on an
    Auto mesh against the port's step on a one-rank mesh (no process
    group). The specs name size-1 axes, so the words fold with shard 0 and
    differ from the unsharded path's; the quantized copies still agree bit
    for bit, and so do the losses."""
    from jax.sharding import Mesh as JaxMesh
    from repro import sharding as jax_sharding
    from repro.config import load_config as jax_load_config
    from repro.launch import mesh as jax_mesh_lib
    from repro.launch import specs as jax_specs
    from repro.train import train_loop as jtl
    from repro_torch import distributed as dst
    from repro_torch import interop
    from repro_torch.config import load_config
    from repro_torch.train import train_loop
    ov = [o for o in OVERRIDES if "qsgd" not in o] + [
        f"train.qsgd_pod_compression={str(qsgd).lower()}"]
    jcfg = jax_load_config("tiny", overrides=ov)
    cfg = load_config("tiny", overrides=ov)
    state, batch = _reference_start(ov)
    mesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                   ("pod", "data", "model"))
    with jax_sharding.use_rules(mesh, jax_mesh_lib.make_rules(jcfg, mesh,
                                                              "train")):
        ssh = jax_mesh_lib.state_shardings(jax_specs.state_specs(jcfg), jcfg,
                                           mesh)
        js = jax.tree.map(jax.numpy.asarray, state)
        jb = jax.tree.map(jax.numpy.asarray, batch)
        step = jax.jit(jtl.make_train_step(
            jcfg, qparam_shardings=ssh["params"])).lower(js, jb).compile(
                compiler_options={"xla_allow_excess_precision": False})
        jstate, jm = step(js, jb)
    one = dst.init_mesh({}, "gloo", device="cpu", rank=0, world_size=1)
    tstate = train_loop.shard_state(
        interop.train_state_from_numpy(state, "cpu"), cfg, one)
    tstate, tm = train_loop.make_train_step(cfg, mesh=one)(
        tstate, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
        step=0)
    for k in ("loss", "full_loss"):
        assert float(tm[k]) == float(jm[k])
    _updates_close(state["params"], jax.tree.map(np.asarray,
                                                 jstate["params"]),
                   interop.to_numpy(train_loop.gather_state(tstate, one)[
                       "params"]), UPDATE_NORMWISE)


# ---------------------------------------------------------------------------
# Refusals


def test_refusals_name_their_roadmap_items(tmp_path):
    from repro_torch import distributed as dst
    from repro_torch.config import load_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import Mesh
    from repro_torch.train import checkpoint, train_loop
    tiny = load_config("tiny")
    tp = Mesh(("pod", "data", "model"), (1, 1, 2))
    dp2 = Mesh(("pod", "data", "model"), (1, 2, 1))
    # a model axis runs the dense and MoE families (item 10); what needs
    # more than the Megatron pattern is item 14
    mesh_lib.check_ported(tiny, tp)
    mesh_lib.check_ported(load_config(
        "tiny", overrides=["train.tp_reduce_dtype=bfloat16"]), dp2)
    with pytest.raises(NotImplementedError, match="item 14"):
        mesh_lib.check_ported(load_config("mamba2-780m"), tp)
    with pytest.raises(NotImplementedError, match="item 14"):
        mesh_lib.check_ported(load_config(
            "tiny", overrides=["mesh.seq_shard_attn=on"]), tp)
    for kind in ("prefill", "decode", "long", "serve"):
        with pytest.raises(NotImplementedError, match="item 11"):
            mesh_lib.check_ported(tiny, dp2, kind)
    moe = load_config("tiny", overrides=["model.num_experts=4",
                                         "model.experts_per_token=2"])
    with pytest.raises(NotImplementedError, match="item 12"):
        train_loop.make_train_step(moe, mesh=dp2)
    mesh_lib.check_ported(moe, Mesh(("pod", "data", "model"), (1, 1, 1)))
    cnn = load_config("resnet20")
    with pytest.raises(NotImplementedError, match="item 12"):
        train_loop.make_train_step(cnn, mesh=dp2)
    with pytest.raises(NotImplementedError, match="item 13"):
        mesh_lib.check_ported(tiny, dp2, "checkpoint")
    # a state held in blocks is not saved, even on one rank
    cfg = load_config("tiny", overrides=["train.global_batch=2",
                                         "train.seq_len=8"])
    one = dst.init_mesh({}, "gloo", device="cpu", rank=0, world_size=1)
    state = train_loop.init_state(cfg, device="cpu", mesh=one)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(NotImplementedError, match="item 13"):
        mgr.save(state, step=0)
    with pytest.raises(NotImplementedError, match="item 13"):
        train_loop.train(cfg, steps=1, mesh=one, checkpoint_mgr=mgr,
                         log=lambda s: None)
    # nccl wants one GPU a rank; the backend is never guessed
    with pytest.raises(ValueError, match="one GPU per rank"):
        dst.init_mesh({"data": 2}, "nccl", rank=0, world_size=2,
                      device="cuda:0")
    with pytest.raises(ValueError, match="backend"):
        dst.init_mesh({}, "mpi", rank=0, world_size=1)
    with pytest.raises(ValueError, match="world"):
        dst.init_mesh({"data": 2}, "gloo", rank=0, world_size=1)
    # the device defaults to cuda under gloo too: the CPU is asked for
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            dst.init_mesh({}, "gloo", rank=0, world_size=1)
    # a loop on a mesh runs on the mesh's device
    with pytest.raises(ValueError, match="mesh's"):
        train_loop.train(cfg, steps=1, mesh=one, device="cuda",
                         log=lambda s: None)
    # QSGD sums across the mesh's pod axis: it takes a mesh
    with pytest.raises(ValueError, match="pass mesh="):
        train_loop.make_train_step(load_config(
            "tiny", overrides=["train.qsgd_pod_compression=true"]))


def test_one_rank_train_loop_and_launcher(tmp_path, capsys):
    """``train(mesh=)`` and ``launch.train --mesh 1,1 --backend gloo`` on a
    one-rank mesh (no process group): a zero-sharded QSGD run of two steps
    through a switch."""
    from repro_torch import distributed as dst
    from repro_torch.config import load_config
    from repro_torch.launch import train as launcher
    from repro_torch.train import train_loop
    ov = ["train.zero_shard=true", "train.qsgd_pod_compression=true",
          "quant.use_pallas=true", "quant.fused_prng=true",
          "train.global_batch=2", "train.seq_len=8", "train.adapt_interval=2",
          "train.log_every=1"]
    cfg = load_config("tiny", overrides=ov)
    one = dst.init_mesh({}, "gloo", device="cpu", rank=0, world_size=1)
    logged = []
    state, hist = train_loop.train(cfg, steps=2, mesh=one, log=logged.append)
    assert [h["step"] for h in hist] == [1, 2] and len(logged) == 2
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "layout" in state
    argv = ["--arch", "tiny", "--steps", "1", "--device", "cpu", "--mesh",
            "1,1", "--backend", "gloo"]
    for o in ov:
        argv += ["--override", o]
    assert launcher.main(argv) == 0
    assert "mesh {'pod': 1, 'data': 1, 'model': 1}" in capsys.readouterr().out


if __name__ == "__main__":
    _rank_main(sys.argv[1:])

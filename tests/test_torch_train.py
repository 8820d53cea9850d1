"""Port parity for the training slice on ``tiny``: the pieces of the AdaPT
step (``dequant_packed``'s gradient rule, activation quantization, the
regularizer, the optimizers, ``controller.accumulate``) and three whole
train steps, against the JAX reference on the same params, state and
batches; the launcher with its checkpoint and metrics flags; and the raise
of what is not ported yet.

The reference runs its Pallas kernels in interpret mode on the CPU; the
port runs the kernels' plain versions there.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.config import load_config as jax_load_config  # noqa: E402
from repro.core import controller as jax_controller  # noqa: E402
from repro.core import fixed_point as jax_fxp  # noqa: E402
from repro.core import sparsity as jax_sparsity  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import OptimizerConfig, load_config  # noqa: E402
from repro_torch.core import controller  # noqa: E402
from repro_torch.core import fixed_point as fxp  # noqa: E402
from repro_torch.core import sparsity  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

# int8 words at FL 8 put tiny's TNVS weights in about ±55 (none clipped);
# SR off: the reference's per-leaf SR seeds come from jax.random, so step
# parity is held with round-to-nearest words.
OVERRIDES = ["quant.container_dtype=int8_packed",
             "quant.stochastic_rounding=false", "quant.init_fl=8",
             "train.global_batch=2", "train.seq_len=32"]
STEPS = 3

# Per-leaf normwise bounds on gradients and master updates against the
# reference's jitted step. The reference is compiled without XLA's excess
# precision (``xla_allow_excess_precision=False``), so that it rounds to
# bf16 after every op as the port does: the first step's loss then agrees
# bit for bit on this configuration and every leaf's update within 0.9%,
# held at 2e-2. From the second step on, the two trajectories start from
# params that differ by those 0.9%, and the int8 activation words turn
# one-ulp differences into whole quantization steps: the updates differ
# by up to 2.8%, as much as the reference's own step compiled with and
# without excess precision differs from itself (2.6-3.3% per step). The
# later steps are held at 5e-2.
FIRST_STEP_NORMWISE = 2e-2
LATER_STEPS_NORMWISE = 5e-2


def _flat(tree, prefix=""):
    """{slash path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _step_bound(step: int) -> float:
    return FIRST_STEP_NORMWISE if step == 1 else LATER_STEPS_NORMWISE


def _normwise(got, want, rtol: float, what: str) -> None:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = float(np.linalg.norm((got - want).ravel()))
    ref = float(np.linalg.norm(want.ravel()))
    assert err <= rtol * ref, f"{what}: |diff| {err} > {rtol} * {ref}"


def _to_torch(tree):
    return interop.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


# ---------------------------------------------------------------------------
# Whole steps


@pytest.fixture(scope="module", params=[True, False], ids=["pallas", "plain"])
def trajectories(request):
    """Three steps of the JAX step (compiled once, without excess
    precision) and of the port's from the same state and batches: numpy
    snapshots after every step."""
    ov = OVERRIDES + [f"quant.use_pallas={str(request.param).lower()}"]
    jcfg = jax_load_config("tiny", overrides=ov)
    cfg = load_config("tiny", overrides=ov)
    jstate = jax_train_loop.init_state(jcfg)
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           "cpu")
    batches = [jax.tree.map(np.asarray, jax_train_loop.make_batch(jcfg, i))
               for i in range(STEPS)]
    jstep = jax.jit(jax_train_loop.make_train_step(jcfg)).lower(
        jstate, batches[0]).compile(
            compiler_options={"xla_allow_excess_precision": False})
    step = train_loop.make_train_step(cfg)
    jsnaps = [jax.tree.map(np.asarray, jstate)]
    tsnaps = [interop.to_numpy(state)]
    jmets, tmets = [], []
    for batch in batches:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, tm = step(state, {k: torch.from_numpy(np.array(v))
                                 for k, v in batch.items()})
        jsnaps.append(jax.tree.map(np.asarray, jstate))
        tsnaps.append(interop.to_numpy(state))
        jmets.append({k: float(v) for k, v in jm.items()})
        tmets.append({k: float(v) for k, v in tm.items()})
    return dict(j=jsnaps, t=tsnaps, jm=jmets, tm=tmets)


def test_step_losses_and_grad_norms_match(trajectories):
    tr = trajectories
    for jm, tm in zip(tr["jm"], tr["tm"]):
        # ROADMAP's exit bounds: bf16 activations and gradients round f32
        # sums taken in different orders
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-3)
        np.testing.assert_allclose(tm["full_loss"], jm["full_loss"], rtol=2e-3)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=2e-2)
        assert tm["lr"] == jm["lr"]
        assert np.isfinite(tm["loss"]) and tm["grad_norm"] > 0


def test_step_master_updates_match(trajectories):
    """Per leaf and step, ‖Δmaster_port − Δmaster_jax‖₂ within the step's
    bound of ‖Δmaster_jax‖₂ (normwise: the update is lr·g/‖g‖ from bf16
    gradients)."""
    tr = trajectories
    for i in range(1, STEPS + 1):
        jp0, jp1 = _flat(tr["j"][i - 1]["params"]), _flat(tr["j"][i]["params"])
        tp0, tp1 = _flat(tr["t"][i - 1]["params"]), _flat(tr["t"][i]["params"])
        assert tp1.keys() == jp1.keys()
        for path in jp1:
            assert tp1[path].dtype == np.float32
            _normwise(tp1[path] - tp0[path], jp1[path] - jp0[path],
                      _step_bound(i), f"step {i} {path}")


def test_step_controller_and_optimizer_state_match(trajectories):
    tr = trajectories
    for i in range(1, STEPS + 1):
        ja, ta = tr["j"][i]["adapt"], tr["t"][i]["adapt"]
        assert ta["tensors"].keys() == ja["tensors"].keys()
        for path, jts in ja["tensors"].items():
            tts = ta["tensors"][path]
            assert tts["grad_sum"].dtype == jts["grad_sum"].dtype   # bf16
            _normwise(tts["grad_sum"], jts["grad_sum"], _step_bound(i),
                      f"grad_sum {path}")
            # the norms of those gradients agree far closer than their
            # directions: 2e-2
            _normwise(tts["norm_sum"], jts["norm_sum"], 2e-2, f"norm_sum {path}")
            for k in ("count", "wl", "fl", "lb", "res"):
                np.testing.assert_array_equal(tts[k], jts[k], err_msg=k)
            # no switch in three steps: ⟨WL,FL⟩ unchanged
            np.testing.assert_array_equal(tts["wl"], tr["t"][0]["adapt"][
                "tensors"][path]["wl"])
            np.testing.assert_array_equal(tts["fl"], tr["t"][0]["adapt"][
                "tensors"][path]["fl"])
        for k in ("loss_ptr", "loss_seen", "strategy"):
            assert int(ta[k]) == int(ja[k]), k
        np.testing.assert_allclose(ta["loss_hist"], ja["loss_hist"], rtol=2e-3)
        jo, to = tr["j"][i]["opt"], tr["t"][i]["opt"]
        for k in ("lr", "step", "rop_bad"):
            assert to[k] == jo[k], k
        np.testing.assert_allclose(to["rop_best"], jo["rop_best"], rtol=2e-3)
        assert int(tr["t"][i]["step"]) == int(tr["j"][i]["step"]) == i


def test_one_step_matches_the_reference_op_by_op():
    """One step against the reference evaluated op by op (jax.disable_jit;
    its plain path, as interpret-mode kernels op by op take minutes): the
    loss within 2e-3 and every leaf's update and grad_sum within 2e-2
    normwise (bf16 gradients summed in other orders)."""
    ov = OVERRIDES + ["quant.use_pallas=false"]
    jcfg = jax_load_config("tiny", overrides=ov)
    jstate = jax_train_loop.init_state(jcfg)
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           "cpu")
    p0 = _flat(jax.tree.map(np.asarray, jstate["params"]))
    batch = jax_train_loop.make_batch(jcfg, 0)
    with jax.disable_jit():
        jstate, jm = jax_train_loop.make_train_step(jcfg)(jstate, batch)
    state, tm = train_loop.make_train_step(load_config("tiny", overrides=ov))(
        state, {"tokens": torch.from_numpy(np.array(batch["tokens"]))})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-3)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2e-2)
    jp, tp = _flat(jax.tree.map(np.asarray, jstate["params"])), _flat(
        interop.to_numpy(state["params"]))
    for path in p0:
        _normwise(tp[path] - p0[path], jp[path] - p0[path], 2e-2, path)
    for path, jts in jstate["adapt"]["tensors"].items():
        _normwise(interop.to_numpy(state["adapt"]["tensors"][path]["grad_sum"]),
                  np.asarray(jts["grad_sum"]), 2e-2, f"grad_sum {path}")


# ---------------------------------------------------------------------------
# Pieces of the step


def test_dequant_packed_gradient_rule():
    rng = np.random.default_rng(0)
    q8 = rng.integers(-128, 128, (5, 7)).astype(np.int8)
    g = rng.normal(0, 1, (5, 7)).astype(np.float32)
    sc = jnp.asarray(2.0 ** -6, jnp.bfloat16)
    out, vjp = jax.vjp(jax_fxp.dequant_packed, jnp.asarray(q8), sc,
                       jnp.zeros((5, 7), jnp.bfloat16))
    _, jsc, jw = vjp(jnp.asarray(g, jnp.bfloat16))
    tsc = torch.tensor(2.0 ** -6, dtype=torch.bfloat16).requires_grad_()
    tw = torch.zeros((), dtype=torch.bfloat16).expand(5, 7).requires_grad_()
    tout = fxp.dequant_packed(torch.from_numpy(q8), tsc, tw)
    gsc, gw = torch.autograd.grad(
        tout, (tsc, tw), torch.from_numpy(g).to(torch.bfloat16))
    np.testing.assert_array_equal(tout.detach().float().numpy(), _f32(out))
    assert tout.dtype == gw.dtype == torch.bfloat16
    np.testing.assert_array_equal(gw.float().numpy(), _f32(jw))
    assert float(gsc) == 0.0 == float(jsc)


@pytest.mark.parametrize("wl", [8, 6])
@pytest.mark.parametrize("amax", [3.0, 258.0])
def test_quantize_activation_value_and_ste(wl, amax):
    """Value bit for bit in bf16 (FL from the bf16 abs-max through
    jnp.log2's bf16 expansion, which puts 258 at IL 9), gradient = the
    cotangent."""
    rng = np.random.default_rng(wl)
    a = rng.normal(0, 1, (2, 6, 16)).astype(np.float32)
    a[0, 0, 0] = amax
    ja = jnp.asarray(a, jnp.bfloat16)
    c = rng.normal(0, 1, a.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax_fxp.quantize_activation(
        x, jnp.int32(wl)), ja)
    (jg,) = vjp(jnp.asarray(c, jnp.bfloat16))
    ta = torch.from_numpy(_f32(ja)).to(torch.bfloat16).requires_grad_()
    got = fxp.quantize_activation(ta, torch.tensor(wl, dtype=torch.int32))
    (tg,) = torch.autograd.grad(got, ta, torch.from_numpy(c).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(), _f32(want))
    np.testing.assert_array_equal(tg.float().numpy(), _f32(jg))


def test_fl_for_wl_matches_on_the_bf16_grid():
    """Every bf16 abs-max from 1e-3 to 3e4 gives the reference's FL, the
    values just above and at powers of two included."""
    v = np.geomspace(1e-3, 3e4, 20000)
    jv = jnp.unique(jnp.asarray(v, jnp.bfloat16))
    want = np.asarray(jax_fxp.fl_for_wl(jv, jnp.int32(8)))
    tv = torch.from_numpy(_f32(jv)).to(torch.bfloat16)
    np.testing.assert_array_equal(fxp.fl_for_wl(tv, 8).numpy(), want)
    want32 = np.asarray(jax_fxp.fl_for_wl(jv.astype(jnp.float32), jnp.int32(6)))
    np.testing.assert_array_equal(fxp.fl_for_wl(tv.float(), 6).numpy(), want32)


def test_quantize_and_sparsity_match():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.3, (4, 33)).astype(np.float32)
    for wl, fl in ((8, 5), (4, 2), (12, 9)):
        want = jax_fxp.quantize(jnp.asarray(w), jnp.int32(wl), jnp.int32(fl))
        got = fxp.quantize(torch.from_numpy(w), wl, fl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))   # exact
        np.testing.assert_allclose(
            float(fxp.sparsity(got)), float(jax_fxp.sparsity(want)), rtol=0)


@pytest.fixture(scope="module")
def packed():
    """Tiny's packed quantized copy from the same master in both packages."""
    jcfg = jax_load_config("tiny", overrides=OVERRIDES)
    jstate = jax_train_loop.init_state(jcfg)
    cfg = load_config("tiny", overrides=OVERRIDES)
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jstate=jstate, state=state)


@pytest.mark.parametrize("view", ["packed", "unpacked"])
def test_adapt_loss_value_and_grad(packed, view):
    """The regularizer on the packed copy (read leaf by leaf) or on its
    unpack_tree view: value, and the gradient that reaches each "wref"
    (β·w ± α in bf16, +α at w = 0 as the reference's |w|')."""
    s = packed
    jq = jax_controller.quantize_params_packed(
        s["jstate"]["params"], s["jstate"]["adapt"], s["jcfg"].quant)
    o = s["jcfg"].optimizer

    def jloss(qp):
        return jax_sparsity.adapt_loss(
            jnp.float32(1.5), jax_fxp.unpack_tree(qp), s["jstate"]["adapt"],
            alpha=o.l1, beta=o.l2, penalty_coef=o.penalty_coef)

    jval, jgrad = jax.value_and_grad(jloss, allow_int=True)(jq)
    jgrad = jax_controller.strip_packed_grads(jgrad)
    tq = controller.quantize_params_packed(s["state"]["params"],
                                           s["state"]["adapt"], s["cfg"].quant)
    recv = controller.grad_receivers(tq)
    tval = sparsity.adapt_loss(
        torch.tensor(1.5), tq if view == "packed" else fxp.unpack_tree(tq),
        s["state"]["adapt"], alpha=o.l1, beta=o.l2,
        penalty_coef=o.penalty_coef)
    grads = dict(zip(recv, torch.autograd.grad(tval, list(recv.values()),
                                               materialize_grads=True)))
    # f32 sums of ~10^5 terms in another order
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-6)
    jflat = _flat(jax.tree.map(np.asarray, jgrad))
    for path in s["state"]["adapt"]["tensors"]:
        assert grads[path].dtype == torch.bfloat16
        np.testing.assert_array_equal(grads[path].float().numpy(),
                                      _f32(jflat[path]), err_msg=path)


def test_controller_snapshot_matches(packed):
    want = jax_controller.snapshot(packed["jstate"]["adapt"])
    got = controller.snapshot(packed["state"]["adapt"])
    assert got.keys() == want.keys()
    for path, ts in want.items():
        for k, v in ts.items():
            np.testing.assert_array_equal(got[path][k], np.asarray(v))


def test_controller_accumulate_matches(packed):
    s = packed
    rng = np.random.default_rng(2)
    jgrads = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(0, 1, p.shape), jnp.bfloat16),
        s["jstate"]["params"])
    ja = s["jstate"]["adapt"]
    ta = interop.adapt_state_from_numpy(jax.tree.map(np.asarray, ja), "cpu")
    for loss in (2.5, 2.25):
        ja = jax_controller.accumulate(ja, jgrads, jnp.float32(loss))
        ta = controller.accumulate(ta, _to_torch(jgrads), torch.tensor(loss))
    for path, jts in ja["tensors"].items():
        tts = ta["tensors"][path]
        # grad_sum: the same f32 sum rounded to bf16 → identical
        np.testing.assert_array_equal(tts["grad_sum"].float().numpy(),
                                      _f32(jts["grad_sum"]))
        np.testing.assert_allclose(tts["norm_sum"].numpy(),
                                   np.asarray(jts["norm_sum"]), rtol=1e-5)
        assert np.array_equal(tts["count"].numpy(), np.asarray(jts["count"]))
    np.testing.assert_array_equal(ta["loss_hist"].numpy(),
                                  np.asarray(ja["loss_hist"]))
    assert int(ta["loss_ptr"]) == int(ja["loss_ptr"]) == 2
    assert int(ta["loss_seen"]) == 2


def _opt_case(seed=3):
    rng = np.random.default_rng(seed)
    params = {"blocks": {"w": rng.normal(0, 1, (2, 5, 6)).astype(np.float32)},
              "head": rng.normal(0, 1, (6, 4)).astype(np.float32),
              "norm": rng.normal(0, 1, (6,)).astype(np.float32)}
    grads = [jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, 1, p.shape), jnp.bfloat16), params) for _ in range(2)]
    return params, grads


@pytest.mark.parametrize("name,momentum", [("asgd", 0.0), ("sgd", 0.9),
                                           ("adam", 0.0)])
def test_optimizer_updates_match(name, momentum):
    """Two steps of normalize → clip → update from the same params and bf16
    grads: f32 arithmetic in the same order (adam: rtol 1e-6 for its
    sqrt/divide)."""
    params, grads = _opt_case()
    kw = dict(name=name, momentum=momentum, lr=0.1, grad_clip=1.5)
    jo, to = JaxOptimizerConfig(**kw), OptimizerConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jax_opt.init_opt_state(jp, jo)
    tp = _to_torch(params)
    tst = opt.init_opt_state(tp, to)
    quantized = {"blocks/w", "head"}
    for g in grads:
        jg = jax_opt.clip_by_global_norm(
            jax_opt.normalize_grads(g, quantized), jo.grad_clip)
        jp, jst = jax_opt.apply_updates(jp, jg, jst, jo)
        tg = opt.clip_by_global_norm(
            opt.normalize_grads(_to_torch(g), quantized), to.grad_clip)
        for path, leaf in _flat(jax.tree.map(np.asarray, jg)).items():
            assert _flat(tg)[path].dtype == torch.bfloat16
            np.testing.assert_allclose(_flat(tg)[path].float().numpy(),
                                       _f32(leaf), rtol=2 ** -8, atol=1e-6)
        tp, tst = opt.apply_updates(tp, tg, tst, to)
    for path, leaf in _flat(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(_flat(tp)[path].numpy(), leaf,
                                   rtol=1e-6, atol=1e-6, err_msg=path)
    assert int(tst["step"]) == int(jst["step"]) == 2


def test_rop_update_over_a_plateau():
    kw = dict(rop_patience=2, rop_factor=0.5, rop_threshold=1e-3)
    jo, to = JaxOptimizerConfig(**kw), OptimizerConfig(**kw)
    jst = jax_opt.init_opt_state({"w": jnp.zeros(2)}, jo)
    tst = opt.init_opt_state({"w": torch.zeros(2)}, to)
    for loss in (3.0, 2.0, 2.0, 1.9995, 2.1, 1.0, 1.0, 1.0, 1.0):
        jst = jax_opt.rop_update(jst, jnp.float32(loss), jo)
        tst = opt.rop_update(tst, torch.tensor(loss), to)
        for k in ("lr", "rop_best", "rop_bad"):
            assert float(tst[k]) == float(jst[k]), (loss, k)
    assert float(tst["lr"]) == float(np.float32(0.05 * 0.25))  # reduced twice


def test_synthetic_lm_batch_is_stride_induction():
    cfg = load_config("tiny", overrides=["train.global_batch=8",
                                         "train.seq_len=64"])
    a = synthetic.lm_batch(cfg, 3, device="cpu")["tokens"]
    b = synthetic.lm_batch(cfg, 3, device="cpu")["tokens"]
    c = synthetic.lm_batch(cfg, 4, device="cpu")["tokens"]
    assert a.shape == (8, 64) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.model.vocab_size
    # 5% corruption: most consecutive differences equal the row's stride
    d = torch.remainder(a[:, 1:] - a[:, :-1], cfg.model.vocab_size)
    mode = torch.mode(d, dim=1).values[:, None]
    assert float((d == mode).float().mean()) > 0.8


# ---------------------------------------------------------------------------
# The launcher and the step options


def test_launcher_trains_tiny_on_the_cpu(capsys, tmp_path):
    """Two steps, then ``--checkpoint-dir``, ``--resume`` and
    ``--metrics-dir``: the resumed run starts from the final checkpoint of
    the first, goes on to step 4, writes both JSONL files, and
    ``launch.serve --checkpoint-dir`` serves from its checkpoint."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.train.metrics import read_jsonl
    ov = sum((["--override", o] for o in OVERRIDES + [
        "quant.use_pallas=true", "train.log_every=1"]), [])
    assert train_launcher.main(
        ["--arch", "tiny", "--steps", "2", "--device", "cpu"] + ov) == 0
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and "[train] done: step=2" in out
    ckpt, mdir = str(tmp_path / "ckpt"), str(tmp_path / "metrics")
    flags = ["--checkpoint-dir", ckpt, "--resume", "--metrics-dir", mdir]
    for done in (2, 4):
        assert train_launcher.main(["--arch", "tiny", "--steps", "2",
                                    "--device", "cpu"] + flags + ov) == 0
        out = capsys.readouterr().out
        assert f"[train] done: step={done}" in out
        assert ("[train] resumed from step 2" in out) == (done == 4)
    records = read_jsonl(str(tmp_path / "metrics" / "tiny.metrics.jsonl"))
    assert [r["step"] for r in records if r["kind"] == "step"] == [1, 2, 3, 4]
    assert [r["steps"] for r in records if r["kind"] == "finished"] == [2, 4]
    assert (tmp_path / "metrics" / "tiny.switches.jsonl").exists()
    assert serve_launcher.main(["--arch", "tiny", "--device", "cpu",
                                "--checkpoint-dir", ckpt, "--max-new", "2",
                                "--tokens", "3"] + ov) == 0
    assert "[serve] restored step 4" in capsys.readouterr().out


def test_train_raises_at_the_first_switch_step():
    """The first switch step used to raise (the switch was not ported);
    now ``train`` passes it: the switch after step 2 closes every
    tensor's window (count back to 0) and the run goes on to step 4."""
    cfg = load_config("tiny", overrides=OVERRIDES + [
        "train.adapt_interval=2", "quant.lb_lwr=2", "train.log_every=1"])
    logged = []
    state, history = train_loop.train(cfg, steps=4, device="cpu",
                                      log=logged.append)
    assert len(logged) == 4 and logged[1].startswith("step     2")
    assert [h["step"] for h in history] == [1, 2, 3, 4]
    assert all(int(ts["count"].max()) <= 2
               for ts in state["adapt"]["tensors"].values())
    assert any(not torch.equal(ts["wl"], torch.full_like(ts["wl"], 8))
               for ts in state["adapt"]["tensors"].values())


@pytest.mark.parametrize("override,match", [
    ("train.remat=full", "remat"),
    ("train.accum_steps=2", "accum_steps"),
    ("train.qsgd_pod_compression=true", "qsgd"),
])
def test_unported_step_options_raise(override, match):
    """Remat, microbatch accumulation and QSGD pod compression (on a
    one-rank mesh: it sums across the mesh's pod axis) are ported and
    train a step (tests/test_torch_remat_accum.py and tests/test_torch_dp.py
    hold them against the reference)."""
    from repro_torch import distributed as dst
    cfg = load_config("tiny", overrides=OVERRIDES + [override])
    mesh = (dst.init_mesh({}, "gloo", device="cpu", rank=0, world_size=1)
            if match == "qsgd" else None)
    state = train_loop.init_state(cfg, device="cpu", mesh=mesh)
    state, metrics = train_loop.make_train_step(cfg, mesh=mesh)(
        state, train_loop.make_batch(cfg, 0, device="cpu"))
    assert np.isfinite(float(metrics["loss"])) and int(state["step"]) == 1
    assert float(metrics["grad_norm"]) > 0


def test_float_containers_raise():
    """The float containers are ported (tests/test_torch_containers.py),
    and so is their SR from jax.random noise (stochastic rounding without
    quant.use_pallas and quant.fused_prng, tests/test_torch_noise_sr.py):
    a step of each takes its noise from the step key and trains."""
    for ov in ([], ["quant.container_dtype=bfloat16"],
               ["quant.container_dtype=int8", "quant.use_pallas=true",
                "quant.fused_prng=false"],
               OVERRIDES + ["quant.stochastic_rounding=true"]):
        cfg = load_config("tiny", overrides=ov + ["train.global_batch=2",
                                                  "train.seq_len=8"])
        state = train_loop.init_state(cfg, device="cpu")
        step = train_loop.make_train_step(cfg)
        state, metrics = step(state, train_loop.make_batch(cfg, 0,
                                                           device="cpu"))
        assert np.isfinite(float(metrics["loss"])) and int(state["step"]) == 1

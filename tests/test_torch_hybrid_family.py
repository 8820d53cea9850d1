"""The registry entries of this slice, mamba2-780m (every layer a mamba2
SSD block) and zamba2-7b (two mamba2 blocks and one attention + MLP block
a period, the attention block's weights shared by all periods), against
the JAX reference on the CPU: their configs field for field, their params
and controller leaves (``d_skip`` one ⟨WL,FL⟩ per tensor on a stacked leaf,
``conv_w`` one per layer, the ``shared`` subtree per tensor), the forward
of each smoke config, greedy serving through the ``Engine``, one training
step packed under ``quant.use_pallas`` and one under the QuantConfig
defaults, the precision switch from the same state, the continuous batcher
on the mamba2 smoke config with a slot reused, a zamba2 checkpoint across
the packages both ways, and both launchers.

The steps are held as ``tests/test_torch_dense_family.py`` holds its: the
reference's step compiled without XLA's excess precision (its Pallas
kernels in interpret mode, the port's plain versions), the loss within
2e-3, the gradient norm within 2e-2, and every leaf's master update and
``grad_sum`` within 2e-2 normwise. Logits within 2^-5 of the reference's
largest logit; greedy tokens equal until the reference's top-1/top-2
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
from repro.serve import scheduler as jax_scheduler  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import apply_overrides  # noqa: E402
from repro_torch.configs import (get_config, get_smoke_config,  # noqa: E402
                                 list_archs, mamba2_780m, zamba2_7b)
from repro_torch.core import controller  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine, scheduler  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402

MAMBA, ZAMBA = "mamba2-780m", "zamba2-7b"
ARCHS = [MAMBA, ZAMBA]
MODULES = {MAMBA: mamba2_780m, ZAMBA: zamba2_7b}
SMALL = ["train.global_batch=2", "train.seq_len=24", "train.remat=none",
         "train.accum_steps=1", "quant.init_fl=8"]
STEPS = {
    "packed": SMALL + ["quant.container_dtype=int8_packed",
                       "quant.stochastic_rounding=false",
                       "quant.use_pallas=true"],
    "defaults": SMALL,
}
SERVE_OVERRIDES = ["quant.container_dtype=int8_packed",
                   "quant.use_pallas=true", "quant.init_fl=8"]
B, S, NEW = 2, 12, 4          # the smoke chunk is 8: the prompt pads
LOSS_RTOL = 2e-3
UPDATE_NORMWISE = 2e-2
SWITCH_KEYS = ("wl", "fl", "lb", "res", "count")
# the reference compiled as the CPU parity tests compile it: no excess
# precision, and LLVM's lowest level (the same program in less time)
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


def _ref_params(jcfg, seed):
    """The reference's ``init_params``, jitted: the same threefry draws as
    its eager call, in less time."""
    return jax.jit(jax_transformer.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg.model)


def _both(arch, overrides, seed):
    """(reference config, port config, reference params, reference
    controller state, the port's copies of both)."""
    jcfg = jax_apply_overrides(jax_get_smoke(arch), overrides)
    cfg = apply_overrides(get_smoke_config(arch), overrides)
    jp = _ref_params(jcfg, seed)
    js = jax_controller.init_adapt_state(jp, jcfg.quant)
    return (jcfg, cfg, jp, js, interop.params_from_numpy(_np(jp), "cpu"),
            interop.adapt_state_from_numpy(_np(js), "cpu"))


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
    assert (cfg.train.remat, cfg.train.accum_steps,
            cfg.train.accum_dtype) == ("full", 8, "float32")
    assert cfg.model.family == ("ssm" if arch == MAMBA else "hybrid")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_controller_leaves(arch):
    """The port's params have the reference's paths, shapes and dtypes; the
    controller quantizes ``in_proj``, ``conv_w`` and ``out_proj`` per layer,
    ``d_skip`` per tensor and every ``shared`` leaf per tensor, and leaves
    ``a_log``, ``dt_bias`` and the norms alone, as the reference's."""
    jcfg = jax_get_smoke(arch)
    cfg = get_smoke_config(arch)
    want = _flat(jax.eval_shape(lambda: jax_transformer.init_params(
        jax.random.PRNGKey(0), jcfg.model)))
    params = transformer.init_params(0, cfg.model, device="cpu")
    got = _flat(params)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(w.dtype), path
    state = controller.init_adapt_state(params, cfg.quant)
    jstate = jax_controller.init_adapt_state(
        _ref_params(jcfg, 0), jcfg.quant)
    assert sorted(state["tensors"]) == sorted(jstate["tensors"])
    L = transformer.build_plan(cfg.model)[1]
    for path, ts in state["tensors"].items():
        assert ts["wl"].shape == jstate["tensors"][path]["wl"].shape, path
        per_layer = path.startswith("blocks/") and not path.endswith("d_skip")
        assert tuple(ts["wl"].shape) == ((L,) if per_layer else ()), path
    assert "blocks/s0_mamba/d_skip" in state["tensors"]
    assert not any(k in p for p in state["tensors"]
                   for k in ("a_log", "dt_bias", "norm"))
    if arch == ZAMBA:
        assert {p for p in state["tensors"] if p.startswith("shared/")} == {
            "shared/attn/wq", "shared/attn/wk", "shared/attn/wv",
            "shared/attn/wo", "shared/mlp/wi_gate", "shared/mlp/wi_up",
            "shared/mlp/wo"}
        assert transformer.act_wl_from_state(state).keys() == {
            "s0_mamba", "s1_mamba"}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch):
    """Each smoke config's forward from the reference's f32 params (the
    packed words under ``quant.use_pallas`` are held by the ``Engine``
    test); logits within 2^-5 of the reference's largest."""
    jcfg, cfg, jp, js, tp, ts = _both(arch, SERVE_OVERRIDES, 5)
    tokens = np.random.default_rng(6).integers(
        0, cfg.model.vocab_size, (B, 2 * S)).astype(np.int32)
    want = np.asarray(_compiled(lambda p, t: jax_transformer.forward(
        p, jcfg.model, tokens=t), jp, tokens)(jp, tokens))
    got = transformer.forward(tp, cfg.model,
                              tokens=torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -5 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_the_reference(arch):
    jcfg, cfg, jp, js, tp, ts = _both(arch, SERVE_OVERRIDES, 0)
    tokens = np.random.default_rng(1).integers(
        0, cfg.model.vocab_size, (B, S)).astype(np.int32)
    jout, jlog = jax_engine.Engine(jcfg, jp, js).generate(
        jnp.asarray(tokens), NEW)
    tout, tlog = engine.Engine(cfg, tp, ts, device="cpu").generate(
        torch.from_numpy(tokens), NEW)
    jout, tout = np.asarray(jout), tout.numpy()
    assert tout.shape == (B, NEW)
    seq = np.concatenate([tokens, jout], axis=1)
    jq = jax_engine.quantize_for_serving(jp, js, jcfg.quant)
    logits = np.asarray(_compiled(lambda p, t: jax_transformer.forward(
        p, jcfg.model, tokens=t, use_pallas=True), jq, seq)(jq, seq))
    tol = 2.0 ** -5 * float(np.abs(logits).max())
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
        jlog = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0,
                                   atol=2.0 ** -5 * np.abs(jlog).max())


@pytest.mark.parametrize("mode", STEPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_the_reference(arch, mode):
    jcfg = jax_apply_overrides(jax_get_smoke(arch), STEPS[mode])
    cfg = apply_overrides(get_smoke_config(arch), STEPS[mode])
    jstate = jax_train_loop.init_state(jcfg)
    state = interop.train_state_from_numpy(_np(jstate), "cpu")
    p0 = _flat(_np(jstate["params"]))
    batch = jax_train_loop.make_batch(jcfg, 0)
    jstate, jm = _compiled(jax_train_loop.make_train_step(jcfg), jstate,
                           batch)(jstate, batch)
    state, tm = train_loop.make_train_step(cfg)(
        state, {"tokens": torch.from_numpy(np.array(batch["tokens"]))})
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


def test_switch_on_ssm_leaves_is_identical():
    """mamba2's packed state with one step's window statistics drawn from a
    numpy seed (a gradient sum, its norm and a loss) and every window
    closed (lb = 1), through ``precision_switch`` in both (the EDF
    ladder's plain version against interpret Pallas): identical ⟨WL,FL⟩,
    lookback, resolution, counts and strategy on every leaf (``d_skip``'s
    one per tensor and ``conv_w``'s one per layer among them), and the
    same ``grad_sum``."""
    jcfg = jax_apply_overrides(jax_get_smoke(MAMBA), STEPS["packed"])
    cfg = apply_overrides(get_smoke_config(MAMBA), STEPS["packed"])
    jstate = jax_train_loop.init_state(jcfg)
    rng = np.random.default_rng(4)
    tensors = {}
    for p, ts in jstate["adapt"]["tensors"].items():
        g = rng.normal(0, 1e-3, ts["grad_sum"].shape)
        gn = np.sqrt(np.sum(g.reshape(ts["wl"].size, -1) ** 2, axis=1))
        tensors[p] = {**ts, "lb": jnp.ones_like(ts["lb"]),
                      "count": jnp.ones_like(ts["count"]),
                      "grad_sum": jnp.asarray(g, jnp.bfloat16),
                      "norm_sum": jnp.asarray(
                          gn.reshape(ts["wl"].shape) * 1.5, jnp.float32)}
    jadapt = {**jstate["adapt"], "tensors": tensors,
              "loss_hist": jstate["adapt"]["loss_hist"].at[0].set(5.5),
              "loss_ptr": jnp.int32(1), "loss_seen": jnp.int32(1)}
    jout = _np(jax.jit(lambda a, p: jax_controller.precision_switch(
        a, p, jcfg.quant))(jadapt, jstate["params"]))
    tout = interop.to_numpy(controller.precision_switch(
        interop.adapt_state_from_numpy(_np(jadapt), "cpu"),
        interop.params_from_numpy(_np(jstate["params"]), "cpu"), cfg.quant))
    assert tout["tensors"].keys() == jout["tensors"].keys()
    for path, jts in jout["tensors"].items():
        tts = tout["tensors"][path]
        for k in SWITCH_KEYS:
            np.testing.assert_array_equal(tts[k], jts[k],
                                          err_msg=f"{path} {k}")
        np.testing.assert_allclose(tts["sp"], jts["sp"], rtol=0, atol=1e-6,
                                   err_msg=f"{path} sp")
        np.testing.assert_array_equal(
            np.asarray(tts["grad_sum"], np.float32),
            np.asarray(jts["grad_sum"], np.float32), err_msg=path)
    L = cfg.model.num_layers
    conv, skip = (jout["tensors"][f"blocks/s0_mamba/{n}"]
                  for n in ("conv_w", "d_skip"))
    assert conv["wl"].shape == (L,) and skip["wl"].shape == ()
    for path in ("blocks/s0_mamba/conv_w", "blocks/s0_mamba/d_skip"):
        assert np.any(jout["tensors"][path]["wl"]
                      != _np(tensors[path]["wl"])), path
    assert int(tout["strategy"]) == int(jout["strategy"])


def _assert_same_bits(got, want, what):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for path, wv in w.items():
        gv = np.asarray(g[path])
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, (what, path)
        np.testing.assert_array_equal(np.atleast_1d(gv).view(np.uint8),
                                      np.atleast_1d(wv).view(np.uint8),
                                      err_msg=f"{what} {path}")


def test_zamba2_checkpoint_crosses_the_packages(tmp_path):
    """zamba2's smoke state (the mamba stacks and the shared block) after
    a port step: saved by the port and restored by the reference, bit for
    bit; the reference's initial state, saved by it and restored by the
    port, bit for bit."""
    jcfg = jax_apply_overrides(jax_get_smoke(ZAMBA), STEPS["packed"])
    cfg = apply_overrides(get_smoke_config(ZAMBA), STEPS["packed"])
    jstate = jax_train_loop.init_state(jcfg)
    batch = jax_train_loop.make_batch(jcfg, 0)
    tstate = interop.train_state_from_numpy(_np(jstate), "cpu")
    tstate, _ = train_loop.make_train_step(cfg)(
        tstate, {"tokens": torch.from_numpy(np.array(batch["tokens"]))})
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        tstate, step=1)
    restored = _np(JaxManager(str(tmp_path / "port")).restore(
        jax_train_loop.init_state(jcfg)))
    np.testing.assert_array_equal(restored.pop("rng"), np.array(
        [0, cfg.train.seed], np.uint32))
    _assert_same_bits(restored, interop.to_numpy(
        {k: v for k, v in tstate.items() if k != "rng"}), "port → reference")
    assert restored["params"]["shared"]["attn"]["wq"].ndim == 2
    assert restored["adapt"]["tensors"]["blocks/s0_mamba/d_skip"][
        "wl"].shape == ()

    JaxManager(str(tmp_path / "ref"), async_save=False).save(jstate, step=1)
    got = CheckpointManager(str(tmp_path / "ref")).restore(
        train_loop.init_state(cfg, device="cpu"))
    assert int(got.pop("rng")) == cfg.train.seed
    want = _np({k: v for k, v in jstate.items() if k != "rng"})
    _assert_same_bits(interop.to_numpy(got), want, "reference → port")


def test_batcher_on_mamba2_matches_the_references():
    """The batcher on mamba2's smoke config (2 slots, a context of 32, the
    policy's levels): five staggered requests, so that each slot serves
    more than one, each package its own batcher; the same statuses, stats,
    WL trace and outputs up to the near-tie rule. A reused slot must start
    from a zero SSM state and conv window, as the reference zeroes every
    cache leaf of the slot on admission."""
    jcfg = jax_apply_overrides(jax_get_smoke(MAMBA), ["quant.init_fl=8"])
    cfg = apply_overrides(get_smoke_config(MAMBA), ["quant.init_fl=8"])
    jp = _ref_params(jcfg, 3)
    js = jax_controller.init_adapt_state(jp, jcfg.quant)
    tp = interop.params_from_numpy(_np(jp), "cpu")
    ts = interop.adapt_state_from_numpy(_np(js), "cpu")
    jcb = jax_scheduler.ContinuousBatcher(jcfg, jp, js, slots=2,
                                          max_context=32)
    margins = {}
    inner = jcb._decode

    def decode(qparams, tokens, caches, positions):
        logits, new = inner(qparams, tokens, caches, positions)
        lg = np.asarray(logits)
        tol = 2.0 ** -5 * float(np.abs(lg).max())
        for i, s in enumerate(jcb.slots):
            if not (s.free or s.pending):
                top2 = np.sort(lg[i])[-2:]
                margins[(s.request.rid, len(s.request.output))] = (
                    float(top2[1] - top2[0]), tol)
        return logits, new

    jcb._decode = decode
    cb = scheduler.ContinuousBatcher(cfg, tp, ts, slots=2, max_context=32,
                                     device="cpu")
    assert set(cb.caches["s0_mamba"]) == {"conv", "ssm"}
    prompts = [[(7 * i + j) % 256 for j in range(3 + 2 * i)]
               for i in range(5)]
    for side in (jcb, cb):
        for i, prompt in enumerate(prompts):
            side.submit(prompt, max_new_tokens=3 + i)
        side.run_until_drained()
    assert sorted(cb.terminal) == sorted(jcb.terminal)
    for rid, r in jcb.terminal.items():
        p = cb.terminal[rid]
        assert (p.status.value, p.reason) == (r.status.value, r.reason)
        for i, (a, b) in enumerate(zip(r.output, p.output)):
            if a != b:
                gap, tol = margins[(rid, i)]
                assert gap <= 2 * tol, (rid, i, r.output, p.output)
                break
        else:
            assert len(p.output) == len(r.output) == r.max_new_tokens
    assert dict(cb.stats) == dict(jcb.stats)
    assert cb.wl_trace == jcb.wl_trace


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_take_the_arch(arch, capsys):
    """``launch.train`` and ``launch.serve`` (static and continuous) run
    each smoke config by ``--arch`` on the CPU."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    small = ["--override", "train.global_batch=2", "--override",
             "train.seq_len=16", "--override", "train.log_every=1"]
    assert train_launcher.main(["--arch", arch, "--smoke", "--steps", "1",
                                "--device", "cpu", *small]) == 0
    assert "step     1" in capsys.readouterr().out
    common = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
              "--tokens", "6", "--max-new", "3"]
    assert serve_launcher.main(common) == 0
    assert serve_launcher.main(common + ["--continuous", "--requests",
                                         "3"]) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_copies_nothing_from_the_host(arch, monkeypatch):
    """The batcher captures ``decode_step`` in a CUDA graph, which refuses a
    copy from the host: no tensor may be built from host data on the
    decode's device, in the mamba step or the shared block. Every
    ``torch.tensor`` call that names a device is recorded."""
    cfg = apply_overrides(get_smoke_config(arch), SERVE_OVERRIDES)
    params = transformer.init_params(0, cfg.model, device="cpu")
    q = engine.quantize_for_serving(
        params, controller.init_adapt_state(params, cfg.quant), cfg.quant)
    caches = transformer.init_caches(cfg.model, 2, 16, device="cpu")
    made, real = [], torch.tensor

    def tensor(*args, **kw):
        if kw.get("device") is not None:
            made.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(torch, "tensor", tensor)
    logits, _ = transformer.decode_step(
        q, cfg.model, real([3, 5], dtype=torch.int32), caches,
        real([9, 2], dtype=torch.int32), use_pallas=True)
    assert made == []
    assert torch.isfinite(logits).all()
    assert float(caches["s0_mamba"]["ssm"].abs().sum()) > 0

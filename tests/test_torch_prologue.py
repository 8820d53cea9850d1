"""Port parity for the quantize prologue on ``tiny``: the prologue's words
and its matmul pair (the plain versions of the CUDA kernels) against the
JAX package's interpret-mode kernels and ``jax.grad``, the prologue
branch of ``quantize_params_packed`` with ``qdense_view`` bit for bit, the
regularizer over prologue leaves, and one train step with
``quant.dense_prologue`` against the reference's step.

The reference runs its Pallas kernels in interpret mode on the CPU; the
port runs the kernels' plain versions there. Matmul tolerance: both sum
the same exact f32 products in other orders, so f32 results are held
within rtol 1e-5 of the largest, as tests/test_torch_train_kernels.py
holds dx and dw.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import load_config as jax_load_config  # noqa: E402
from repro.core import controller as jax_controller  # noqa: E402
from repro.core import fixed_point as jax_fxp  # noqa: E402
from repro.core import sparsity as jax_sparsity  # noqa: E402
from repro.kernels import fxp_matmul as jfm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import load_config  # noqa: E402
from repro_torch.core import controller  # noqa: E402
from repro_torch.core import fixed_point as fxp  # noqa: E402
from repro_torch.core import sparsity  # noqa: E402
from repro_torch.kernels import fxp_matmul as fm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_torch_containers import (STEP_OVERRIDES,  # noqa: E402
                                   check_step, one_step_against_reference)

RTOL = 1e-5
SHAPES = [(37, 67, 33), (130, 257, 129), (7, 64, 48), (16, 100, 36)]
PROLOGUE = ["quant.container_dtype=int8_packed", "quant.use_pallas=true",
            "quant.dense_prologue=true"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    dy = rng.normal(0, 1, (m, n)).astype(np.float32)
    return x, w, dy


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()), f"{what}: {err}"


# ---------------------------------------------------------------------------
# Words and the matmul pair


@pytest.mark.parametrize("mode", [1, 0])
@pytest.mark.parametrize("seed", [7, -3, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(1, 1), (3, 513), (67, 33), (64, 48)])
def test_words_bit_equal(shape, seed, mode):
    """The prologue's words, SR (portable stream of index k·N + n) and
    RTN (half to even, ties included), over FL −3…28; for SR they are the
    SR int8 kernel's words."""
    w = np.random.default_rng(sum(shape)).normal(0, 1, shape).astype(np.float32)
    w[0, 0] = 2.5 * 2.0 ** -3                   # a tie at FL 3
    for fl in (-3, 0, 3, 10, 28):
        got = ref.ref_qdense_words(torch.from_numpy(w), seed,
                                   torch.tensor(fl, dtype=torch.int32), mode)
        want = jref.ref_qdense_words(jnp.asarray(w), jnp.int32(seed),
                                     jnp.int32(fl), mode)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"fl {fl}")
        view = ops.qdense_words(torch.from_numpy(w), seed,
                                torch.tensor(fl, dtype=torch.int32), mode)
        np.testing.assert_array_equal(view.numpy(), got.numpy())


@pytest.mark.parametrize("mode", [1, 0])
@pytest.mark.parametrize("mkn", SHAPES)
def test_qmatmul_and_qdx_match_interpret_kernels(mkn, mode):
    """The plain forward and dx against ``fxp_qmatmul``/``matmul_qdx`` in
    interpret mode, f32 operands."""
    x, w, dy = _operands(*mkn, seed=sum(mkn) + mode)
    seed, fl = 1234 + mode, 9
    want_y = jfm.fxp_qmatmul(jnp.asarray(x), jnp.asarray(w), jnp.int32(seed),
                             jnp.int32(fl), jnp.int32(mode), interpret=True)
    want_dx = jfm.matmul_qdx(jnp.asarray(dy), jnp.asarray(w), jnp.int32(seed),
                             jnp.int32(fl), jnp.int32(mode), interpret=True)
    flt = torch.tensor(fl, dtype=torch.int32)
    y = fm.plain_q(torch.from_numpy(x), torch.from_numpy(w), seed, flt, mode)
    dx = fm.plain_qdx(torch.from_numpy(dy), torch.from_numpy(w), seed, flt,
                      mode)
    assert y.dtype == dx.dtype == torch.float32
    _close(y, want_y, "fxp_qmatmul")
    _close(dx, want_dx, "matmul_qdx")


@pytest.mark.parametrize("mode", [1, 0])
def test_qmatmul_bf16_within_one_ulp(mode):
    """bf16 x and output: the two round f32 sums taken in other orders, so
    a value may land on the neighbouring bf16."""
    x, w, _ = _operands(66, 130, 70, seed=11)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jfm.fxp_qmatmul(xb, jnp.asarray(w), jnp.int32(5),
                                      jnp.int32(8), jnp.int32(mode),
                                      interpret=True).astype(jnp.float32))
    got = fm.plain_q(interop.tensor_from_numpy(np.asarray(xb), "cpu"),
                     torch.from_numpy(w), 5, torch.tensor(8), mode)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(got - want) <= ulp + 2.0 ** -16 * np.abs(want).max())


@pytest.mark.parametrize("mode", [1, 0])
@pytest.mark.parametrize("mkn", SHAPES[:3])
def test_fxp_qdense_autograd_matches_jax_grad(mkn, mode):
    """``ops.fxp_qdense`` (the autograd Function) against the reference's
    interpret-mode ``fxp_qdense_vjp`` under ``jax.grad``: forward, dx, and
    the straight-through dw = xᵀ @ dy in f32 onto the master; seed, FL and
    mode get none."""
    x, w, dy = _operands(*mkn, seed=3 * sum(mkn) + mode)
    seed, fl = -99, 7

    def jloss(xx, ww):
        y = jops.fxp_qdense(xx, ww, jnp.int32(seed), jnp.int32(fl),
                            jnp.int32(mode), use_pallas=True)
        return jnp.sum(y * jnp.asarray(dy)), y

    (_, want_y), (want_dx, want_dw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = ops.fxp_qdense(tx, tw, torch.tensor(seed), torch.tensor(fl),
                       torch.tensor(mode))
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(dy))
    assert dw.dtype == torch.float32
    _close(y.detach(), want_y, "y")
    _close(dx, want_dx, "dx")
    _close(dw, want_dw, "dw")


def test_prologue_wrappers_raise_off_the_card():
    x, w = torch.zeros(4, 8), torch.zeros(8, 3)
    n0 = (fm.fxp_qmatmul.launches, fm.matmul_qdx.launches)
    y = ops.fxp_qdense(x, w, 0, torch.tensor(4), 1)
    assert y.shape == (4, 3) and (fm.fxp_qmatmul.launches,
                                  fm.matmul_qdx.launches) == n0
    with pytest.raises(RuntimeError, match="CUDA"):
        fm.fxp_qmatmul(x, w, 0, torch.tensor(4), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        fm.matmul_qdx(torch.zeros(4, 3), w, 0, torch.tensor(4), 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prologue_dispatch_counters_stay_put_off_the_card(dtype):
    """Both prologue wrappers count tensor-core launches; a CPU tensor of
    either dtype (bf16 would take the tensor-core kernel, f32 the SIMT
    one) raises before any count moves, with fl given as a device int32
    tensor or as a host int, and the plain path through ``ops.fxp_qdense``
    moves none."""
    counters = (fm.fxp_qmatmul, fm.matmul_qdx)
    before = [(c.launches, c.tc_launches) for c in counters]
    x, w, dy = torch.zeros(4, 8, dtype=dtype), torch.zeros(8, 3), \
        torch.zeros(4, 3, dtype=dtype)
    fl = torch.tensor(4, dtype=torch.int32)
    for f in (fl, 4):
        with pytest.raises(RuntimeError, match="CUDA"):
            fm.fxp_qmatmul(x, w, 0, f, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        fm.matmul_qdx(dy, w, 0, fl, 0)
    tx = x.float().requires_grad_()
    y = ops.fxp_qdense(tx, w, 0, fl, 1)
    y.backward(torch.ones_like(y))
    assert tx.grad.shape == (4, 8)
    assert [(c.launches, c.tc_launches) for c in counters] == before


# ---------------------------------------------------------------------------
# The prologue leaves of quantize_params_packed


def _reference_prologue(sr: bool):
    jcfg = jax_load_config("tiny", overrides=PROLOGUE)
    jstate = jax_train_loop.init_state(jcfg)
    tensors = {}
    for p, ts in jstate["adapt"]["tensors"].items():
        ar = jnp.arange(ts["fl"].size).reshape(ts["fl"].shape)
        tensors[p] = {**ts, "fl": (ts["fl"] + ar).astype(jnp.int32)}
    jadapt = {**jstate["adapt"], "tensors": tensors}
    key = jax.random.fold_in(jstate["rng"], 3) if sr else None
    jq = jax_controller.quantize_params_packed(jstate["params"], jadapt,
                                               jcfg.quant, key)
    seeds = ({p: int(jax_controller._leaf_seed(key, p)) for p in tensors}
             if sr else None)
    params = interop.params_from_numpy(_np(jstate["params"]), "cpu")
    tq = controller.quantize_params_packed(
        params, interop.adapt_state_from_numpy(_np(jadapt), "cpu"),
        load_config("tiny", overrides=PROLOGUE).quant, seeds)
    return jq, tq, params, jadapt


@pytest.mark.parametrize("sr", [True, False], ids=["sr", "rtn"])
def test_quantize_params_packed_prologue_matches(sr):
    """Every dense leaf becomes ⟨wm, seed, flq, mode⟩ with the reference's
    values (wm the master itself, per-layer folded seeds on stacked
    leaves, 0 under RTN); the embedding stays packed; ``qdense_view`` is
    the reference's bit for bit."""
    jq, tq, params, _ = _reference_prologue(sr)
    jflat, tflat = _flat(_np(jq)), _flat(tq)
    assert tflat.keys() == jflat.keys()
    for path, want in jflat.items():
        np.testing.assert_array_equal(interop.tensor_to_numpy(tflat[path]),
                                      want, err_msg=path)
    dense = [p for p, leaf in _flat(params).items() if p + "/wm" in tflat]
    assert "head" in dense and len(dense) == 8 and "embed/q8" in tflat
    for p in dense:
        assert tflat[p + "/wm"] is _flat(params)[p]
        assert bool((tflat[p + "/mode"] == int(sr)).all())
        jleaf, tleaf = _node(jq, p), _node(tq, p)
        want = jax_fxp.qdense_view(jleaf["wm"], jleaf["seed"], jleaf["flq"],
                                   jleaf["mode"])
        got = fxp.qdense_view(tleaf["wm"], tleaf["seed"], tleaf["flq"],
                              tleaf["mode"])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=p)
    unpacked = fxp.unpack_tree(tq)
    assert not isinstance(unpacked["head"], dict)


@pytest.mark.parametrize("sr", [True, False], ids=["sr", "rtn"])
def test_regularizer_over_prologue_leaves_matches(sr):
    """α‖v‖₁ + β/2‖v‖₂² over the views of the prologue leaves (and the
    packed embedding): the value and the gradient onto each master, f32,
    against the reference's ``adapt_loss`` over ``unpack_tree``."""
    jq, tq, _, jadapt = _reference_prologue(sr)
    kw = dict(alpha=1e-4, beta=1e-3, penalty_coef=1e-2)
    wms = {p[:-3]: leaf for p, leaf in _flat(jq).items()
           if p.endswith("/wm")}

    def jloss(wm):
        tree = jax.tree.map(lambda t: t, jq)
        for p, leaf in wm.items():
            node = tree
            for k in p.split("/"):
                node = node[k]
            node["wm"] = leaf
        return jax_sparsity.adapt_loss(jnp.float32(0.0),
                                       jax_fxp.unpack_tree(tree), jadapt,
                                       **kw)

    want, want_g = jax.value_and_grad(jloss)(wms)
    receivers = {p: leaf["wm"].requires_grad_() for p, leaf in
                 ((p, _node(tq, p)) for p in wms)}
    tadapt = interop.adapt_state_from_numpy(_np(jadapt), "cpu")
    got = sparsity.adapt_loss(torch.zeros(()), tq, tadapt, **kw)
    grads = torch.autograd.grad(got, list(receivers.values()))
    for t in receivers.values():
        t.requires_grad_(False)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for (p, _), g in zip(receivers.items(), grads):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[p]),
                                   rtol=1e-6, atol=1e-9, err_msg=p)


def _node(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# One train step through the prologue


@pytest.mark.parametrize("sr", [True, False], ids=["sr", "rtn"])
def test_one_prologue_step_matches_the_reference(sr):
    ov = STEP_OVERRIDES + PROLOGUE + [
        f"quant.stochastic_rounding={str(sr).lower()}"]
    r = one_step_against_reference(ov)
    check_step(r)
    assert not any(t.requires_grad for t in
                   _flat(r["tstate"]["params"]).values())


def test_prologue_trains_through_a_switch():
    cfg = load_config("tiny", overrides=STEP_OVERRIDES + PROLOGUE + [
        "train.adapt_interval=2", "quant.lb_lwr=2", "train.log_every=1"])
    from repro_torch.train import train_loop
    state, history = train_loop.train(cfg, steps=3, device="cpu",
                                      log=lambda s: None)
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert any(not torch.equal(ts["wl"], torch.full_like(ts["wl"], 8))
               for ts in state["adapt"]["tensors"].values())

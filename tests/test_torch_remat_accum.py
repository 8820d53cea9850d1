"""Port parity for remat and microbatch accumulation on ``tiny``: the
three remat modes give bit-equal port steps, each within the slice-2
bounds of the reference's step under the same mode; selective remat
recomputes no dense product and full remat all of them; ``accum_steps`` 2
and 4 (f32 accumulator) and 3 (bf16) against the reference's step, the
bf16 factor 1/3 rounded as the reference's weakly typed float is, and
accumulation against one full batch.

The reference is jitted and compiled without XLA's excess precision
(``xla_allow_excess_precision=False``), so that it rounds to bf16 after
every op as the port does; it runs its Pallas kernels in interpret mode,
the port the kernels' plain versions.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.config import load_config as jax_load_config  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import load_config  # noqa: E402
from repro_torch.core import controller  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

# The slice-2 bounds of a first step from the same state
# (tests/test_torch_train.py): loss and full loss within 2e-3, grad_norm
# within 2e-2, every leaf's master update within 2e-2 normwise.
LOSS_RTOL = 2e-3
UPDATE_NORMWISE = 2e-2
# accum_steps=4 against one batch of the same rows: the reference's own
# bound (tests/test_train.py::test_accumulation_matches_full_batch).
ACCUM_ABS = 5e-3

BASE = ["train.global_batch=2", "train.seq_len=16", "quant.init_fl=8"]
PACKED = ["quant.container_dtype=int8_packed", "quant.use_pallas=true"]
CONTAINERS = {
    "float32": ["quant.use_pallas=true"],
    "int8_packed": PACKED,
    "prologue": PACKED + ["quant.dense_prologue=true"],
    "mode_off": ["quant.mode=off"],
}
REMATS = ("none", "full", "selective")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _reference_step(ov):
    """(state before, batch, state after, metrics) of the reference's
    jitted step, as numpy."""
    jcfg = jax_load_config("tiny", overrides=ov)
    jstate = jax_train_loop.init_state(jcfg)
    batch = _np(jax_train_loop.make_batch(jcfg, 0))
    jstep = jax.jit(jax_train_loop.make_train_step(jcfg)).lower(
        jstate, batch).compile(
            compiler_options={"xla_allow_excess_precision": False})
    before = _np(jstate)
    jout, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    return before, batch, _np(jout), {k: float(v) for k, v in jm.items()}


def _port_step(ov, before, batch):
    """The port's step from the reference's state and batch: (state after
    as numpy, metrics)."""
    cfg = load_config("tiny", overrides=ov)
    state = interop.train_state_from_numpy(before, "cpu")
    out, m = train_loop.make_train_step(cfg)(
        state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert not any(t.requires_grad for t in _flat(out["params"]).values())
    return interop.to_numpy(out), {k: float(v) for k, v in m.items()}


def _check_against_reference(before, jout, jm, tout, tm):
    for k in ("loss", "full_loss"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                               rtol=UPDATE_NORMWISE)
    assert tm["lr"] == jm["lr"]
    p0 = _flat(before["params"])
    jp, tp = _flat(jout["params"]), _flat(tout["params"])
    for path, w0 in p0.items():
        want = jp[path].astype(np.float32) - w0.astype(np.float32)
        got = tp[path].astype(np.float32) - w0.astype(np.float32)
        err = float(np.linalg.norm((got - want).ravel()))
        ref = float(np.linalg.norm(want.ravel()))
        assert err <= UPDATE_NORMWISE * ref, f"{path}: {err} > {ref}"
    for path, jts in jout["adapt"]["tensors"].items():
        tts = tout["adapt"]["tensors"][path]
        got = np.asarray(tts["grad_sum"], np.float32)
        want = np.asarray(jts["grad_sum"], np.float32)
        err = float(np.linalg.norm((got - want).ravel()))
        assert err <= UPDATE_NORMWISE * float(np.linalg.norm(want.ravel())), \
            f"grad_sum {path}"


def _assert_same_bits(a, b, what):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for path in fa:
        x, y = np.asarray(fa[path]), np.asarray(fb[path])
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what} {path}"
        assert x.tobytes() == y.tobytes(), f"{what} {path} differs"


# ---------------------------------------------------------------------------
# Remat


@pytest.fixture(scope="module", params=list(CONTAINERS))
def remat_steps(request):
    """Per remat mode, the reference's step and the port's from the same
    state and batch."""
    out = {}
    for remat in REMATS:
        ov = BASE + CONTAINERS[request.param] + [f"train.remat={remat}"]
        before, batch, jout, jm = _reference_step(ov)
        tout, tm = _port_step(ov, before, batch)
        out[remat] = dict(before=before, jout=jout, jm=jm, tout=tout, tm=tm)
    return out


def test_remat_modes_give_bit_equal_steps(remat_steps):
    """The recompute repeats the forward bit for bit (the SR words hash
    the element index, activation quantization rounds to nearest), so
    updated params, controller and optimizer state and the metrics are
    the same bits under every mode."""
    none = remat_steps["none"]
    for remat in ("full", "selective"):
        r = remat_steps[remat]
        _assert_same_bits(r["tout"], none["tout"], remat)
        assert r["tm"] == none["tm"], remat


@pytest.mark.parametrize("remat", REMATS)
def test_remat_step_matches_the_reference(remat_steps, remat):
    r = remat_steps[remat]
    _check_against_reference(r["before"], r["jout"], r["jm"], r["tout"],
                             r["tm"])


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _op_counts(remat):
    """aten.mm and aten.bmm calls of one forward and backward of the
    float32 container's dense layers as library products and the plain
    attention (quant.use_pallas=false), by phase."""
    cfg = load_config("tiny", overrides=BASE + [
        "quant.stochastic_rounding=false", f"train.remat={remat}"])
    state = train_loop.init_state(cfg, device="cpu")
    qp = train_loop._quantized_copy(cfg, state["params"], state["adapt"],
                                    None, None)
    receivers = controller.grad_receivers(qp)
    batch = train_loop.make_batch(cfg, 0, device="cpu")
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    with _CountOps() as fwd:
        loss = train_loop._task_loss(cfg, qp, batch)
    with _CountOps() as bwd:
        torch.autograd.grad(loss, list(receivers.values()))
    return {(phase, name): mode.counts.get(op, 0)
            for phase, mode in (("fwd", fwd), ("bwd", bwd))
            for name, op in (("mm", mm), ("bmm", bmm))}


def test_selective_recomputes_no_dense_product():
    """Full remat recomputes every product of the layer bodies in the
    backward; selective saves every ``aten.mm`` (the dense layers, no batch
    dims) and recomputes the attention's ``aten.bmm``, as
    ``dots_with_no_batch_dims_saveable`` does."""
    none, full, sel = (_op_counts(r) for r in REMATS)
    cfg = load_config("tiny")
    layer_mm = 7 * cfg.model.num_layers         # wq wk wv wo gate up down
    assert none[("fwd", "mm")] == layer_mm + 1   # and the head
    assert none[("fwd", "bmm")] > 0
    for counts in (full, sel):
        assert counts[("fwd", "mm")] == none[("fwd", "mm")]
        assert counts[("fwd", "bmm")] == none[("fwd", "bmm")]
    assert full[("bwd", "mm")] == none[("bwd", "mm")] + layer_mm
    assert full[("bwd", "bmm")] == none[("bwd", "bmm")] + none[("fwd", "bmm")]
    assert sel[("bwd", "mm")] == none[("bwd", "mm")]
    assert sel[("bwd", "bmm")] == full[("bwd", "bmm")]


def test_unknown_remat_raises():
    cfg = load_config("tiny", overrides=BASE + ["train.remat=some"])
    state = train_loop.init_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="remat='some'"):
        train_loop.make_train_step(cfg)(
            state, train_loop.make_batch(cfg, 0, device="cpu"))


# ---------------------------------------------------------------------------
# Microbatch accumulation


@pytest.mark.parametrize("container,accum,dtype,remat", [
    ("int8_packed", 2, "float32", "none"),
    ("int8_packed", 4, "float32", "full"),
    ("int8_packed", 3, "bfloat16", "selective"),
    ("float32", 2, "float32", "full"),
    ("prologue", 4, "float32", "full"),
])
def test_accumulated_step_matches_the_reference(container, accum, dtype,
                                                remat):
    """The quantized copy once per step, each microbatch's full loss
    (regularizer included), the gradients summed in the accumulator's dtype
    in microbatch order and scaled by 1/a."""
    ov = CONTAINERS[container] + [
        "train.seq_len=16", "quant.init_fl=8", f"train.global_batch={accum}",
        f"train.accum_steps={accum}", f"train.accum_dtype={dtype}",
        f"train.remat={remat}"]
    before, batch, jout, jm = _reference_step(ov)
    tout, tm = _port_step(ov, before, batch)
    _check_against_reference(before, jout, jm, tout, tm)


def test_accumulation_matches_the_full_batch():
    """accum_steps=4 against 1 on the same 8 rows, remat full: the loss and
    every param within 5e-3."""
    out = {}
    for accum in (1, 4):
        cfg = load_config("tiny", overrides=PACKED + [
            "quant.stochastic_rounding=false", "quant.init_fl=8",
            "train.seq_len=32", "train.global_batch=8", "train.remat=full",
            f"train.accum_steps={accum}"])
        state = train_loop.init_state(cfg, device="cpu")
        out[accum] = train_loop.make_train_step(cfg)(
            state, train_loop.make_batch(cfg, 0, device="cpu"))
    assert abs(float(out[1][1]["loss"]) - float(out[4][1]["loss"])) < ACCUM_ABS
    p1, p4 = (_flat(out[a][0]["params"]) for a in (1, 4))
    err = max(float((p1[k] - p4[k]).abs().max()) for k in p1)
    assert err < ACCUM_ABS, f"accum mismatch {err}"


def test_bf16_accumulator_scales_by_the_rounded_factor():
    """Microbatch gradients 2, 2 and 3 sum to 7 in a bf16 accumulator; the
    reference multiplies by 1/3 rounded to bf16 (0.333984375, a weakly
    typed Python float), giving 2.34375, where torch's f32 product of 1/3
    rounded once would give 2.328125."""
    want = float(jnp.asarray(7.0, jnp.bfloat16) * (1.0 / 3))
    assert want == 2.34375
    assert float(torch.tensor(7.0, dtype=torch.bfloat16) * (1.0 / 3)) \
        == 2.328125
    cfg = load_config("tiny", overrides=["train.accum_steps=3",
                                         "train.accum_dtype=bfloat16"])
    w = torch.zeros(1, dtype=torch.bfloat16).requires_grad_()

    def loss_fn(mb):
        loss = (w.to(torch.float32) * mb["g"]).sum()
        return loss, loss

    grads, full, task = train_loop._accumulate(
        cfg, loss_fn, {"w": w}, {"g": torch.tensor([2.0, 2.0, 3.0])})
    assert grads[0].dtype == torch.float32
    assert float(grads[0]) == want
    assert float(full) == float(task) == 0.0


def test_microbatches_are_consecutive_rows():
    batch = {"tokens": torch.arange(24).reshape(6, 4)}
    mbs = train_loop._microbatch(batch, 3)
    assert [mb["tokens"][:, 0].tolist() for mb in mbs] == [[0, 4], [8, 12],
                                                           [16, 20]]
    with pytest.raises(ValueError, match="accum_steps=4 .* 6 rows"):
        train_loop._microbatch(batch, 4)

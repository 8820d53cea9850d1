"""Port parity for the CNN family's model and data (``models/cnn.py``,
``data/synthetic.cifar_batch``): AlexNet and ResNet20 at smoke width, the
forward (train and eval: logits and new batch-norm stats) and the
gradients of ``ce_loss`` with respect to every leaf against the JAX
reference on the reference's params and batches; XLA's ``"SAME"`` pads
against ``lax.padtype_to_pads``; a stride-2 convolution that symmetric
padding gets wrong; an AlexNet input whose ``fc1`` catches a wrong
flatten order; the batch norm's conventions; ``layer_madds``; the
registry's CNN configs; the CIFAR stream's shapes and determinism.

The convolutions are PyTorch's and XLA's, each with its own algorithm, so
f32 results agree to a relative error of about 1e-6 (bounds below).
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.models import cnn as jax_cnn  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import cnn  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's many small torch ops run on one thread: beside other
    test processes an intra-op thread pool only waits for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

MODELS = ("alexnet", "resnet20")
WIDTH = 0.25                           # the smoke width
BATCH = 8
# f32 bounds, relative to the largest magnitude of the reference's array:
# the convolutions, reductions and batch statistics sum in different orders
# (measured: logits within 3e-6, stats within 4e-7)
LOGITS_RTOL = 2e-5
STATS_RTOL = 2e-5
# Gradients: each leaf's max |diff| within 2e-5 of the largest gradient of
# the model (measured 6.8e-6) and its normwise error within 1e-4 of its own
# norm (measured 2.4e-5: a batch-norm scale's or bias's gradient is a sum
# that mostly cancels, since the next train-mode batch norm removes its
# mean, so its error is large beside its own size)
GRAD_RTOL = 2e-5
GRAD_NORMWISE = 1e-4


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, rtol, what):
    got, want = _np(got).astype(np.float32), _np(want).astype(np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, f"{what}: max |diff| {err} > {rtol} * {scale}"


@functools.lru_cache(maxsize=None)
def _reference_model(name):
    init = jax.jit(jax_cnn.MODELS[name][0],
                   static_argnames=("num_classes", "width"))
    jp, js = init(jax.random.PRNGKey(3), num_classes=10, width=WIDTH)
    b = jax_synthetic.cifar_batch(10, BATCH, 0, 0)
    return jp, js, b


def _model(name):
    """The reference's smoke-width params, stats and a batch, as numpy
    copies."""
    return jax.tree.map(np.array, _reference_model(name))


def _torch(tree):
    return interop.params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_reference(name, train):
    jp, js, b = _model(name)
    fwd = jax.jit(jax_cnn.MODELS[name][1], static_argnums=3)
    jl, jstats = fwd(jp, js, b["images"], train)
    tl, tstats = cnn.MODELS[name][1](_torch(jp), _torch(js),
                                     torch.from_numpy(b["images"]), train)
    _close(tl, jl, LOGITS_RTOL, f"{name} logits")
    jflat, tflat = _flat(jax.tree.map(np.asarray, jstats)), _flat(tstats)
    assert jflat.keys() == tflat.keys()
    for path, v in jflat.items():
        _close(tflat[path], v, STATS_RTOL, f"{name} stats {path}")
        assert not tflat[path].requires_grad
    if not train:
        for path, v in _flat(js).items():
            np.testing.assert_array_equal(_np(tflat[path]), v)


@pytest.mark.parametrize("name", MODELS)
def test_ce_loss_gradients_match_jax_grad(name):
    """d ce_loss / d leaf for every leaf (conv kernels, FC weights and
    biases, batch-norm scales and biases) against ``jax.grad``."""
    jp, js, b = _model(name)
    fwd = jax_cnn.MODELS[name][1]

    def jloss(p):
        logits, _ = fwd(p, js, jnp.asarray(b["images"]), True)
        return jax_cnn.ce_loss(logits, jnp.asarray(b["labels"]))

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jp))
    tp = _torch(jp)
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_()
    logits, _ = cnn.MODELS[name][1](tp, _torch(js),
                                    torch.from_numpy(b["images"]), True)
    loss = cnn.ce_loss(logits, torch.from_numpy(b["labels"]))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    jflat = _flat(jax.tree.map(np.asarray, jg))
    assert jflat.keys() == leaves.keys()
    if name == "resnet20":
        assert any(p.endswith("norm_scale") for p in jflat)
    gmax = max(float(np.max(np.abs(v))) for v in jflat.values())
    for path, g in zip(leaves, grads):
        got, want = _np(g), jflat[path]
        err = float(np.max(np.abs(got - want)))
        assert err <= GRAD_RTOL * gmax, f"{name} grad {path}: {err} > {gmax}"
        nerr = float(np.linalg.norm(got - want))
        assert nerr <= GRAD_NORMWISE * float(np.linalg.norm(want)), \
            f"{name} grad {path}: normwise {nerr}"


def test_same_pads_are_xlas():
    for size in (1, 2, 3, 4, 7, 8, 15, 16, 31, 32, 33):
        for k in (1, 2, 3, 4, 5):
            for stride in (1, 2, 3):
                want = jax.lax.padtype_to_pads((size,), (k,), (stride,),
                                               "SAME")[0]
                assert cnn.same_pads(size, k, stride) == tuple(want), \
                    (size, k, stride)


def test_stride2_conv_is_asymmetric_same():
    """3×3 at stride 2 on 32×32 pads (0, 1) per dim, as XLA does: the
    reference's ``conv`` against the port's, and against a symmetric
    ``padding=1``, which shifts every output."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 6)).astype(np.float32)
    want = np.asarray(jax_cnn.conv(jnp.asarray(x), jnp.asarray(w), 2))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w)
    got = cnn.conv(xt, wt, 2).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 16, 16, 6)
    _close(got, want, 1e-6, "stride-2 SAME")
    sym = torch.nn.functional.conv2d(xt, wt.permute(3, 2, 0, 1), stride=2,
                                     padding=1).permute(0, 2, 3, 1)
    assert float(np.max(np.abs(_np(sym) - want))) > 1.0


def test_resnet20_stride2_blocks_take_the_asymmetric_pad():
    """ResNet20's stride-2 blocks (s1b0, s2b0): their conv1 pads (0, 1),
    their 1×1 ``down`` convs pad nothing."""
    assert cnn.same_pads(32, 3, 2) == (0, 1)
    assert cnn.same_pads(16, 3, 2) == (0, 1)
    assert cnn.same_pads(32, 1, 2) == (0, 0)
    assert cnn.same_pads(16, 1, 2) == (0, 0)
    assert cnn.same_pads(8, 3, 1) == (1, 1)


def test_alexnet_fc1_reads_the_reference_flatten_order():
    """fc1's rows are in (H, W, C) order: with a weight whose rows differ,
    flattening the NCHW activations as (C, H, W) gives other logits; the
    port's forward gives the reference's."""
    jp, js, b = _model("alexnet")
    rng = np.random.default_rng(1)
    jp["fc1"]["w"] = rng.standard_normal(jp["fc1"]["w"].shape).astype(
        np.float32) * 0.05
    jl, _ = jax_cnn.alexnet_forward(jax.tree.map(jnp.asarray, jp), js,
                                    jnp.asarray(b["images"]), True)
    tp = _torch(jp)
    tl, _ = cnn.alexnet_forward(tp, {}, torch.from_numpy(b["images"]), True)
    _close(tl, jl, LOGITS_RTOL, "alexnet logits")
    # the same forward with a channel-major flatten
    x = torch.from_numpy(b["images"]).permute(0, 3, 1, 2)
    h = torch.relu(cnn.conv(x, tp["conv1"]["w"]))
    h = cnn.max_pool(h)
    h = torch.relu(cnn.conv(h, tp["conv2"]["w"]))
    h = cnn.max_pool(h)
    for k in ("conv3", "conv4", "conv5"):
        h = torch.relu(cnn.conv(h, tp[k]["w"]))
    h = cnn.max_pool(h).reshape(h.shape[0], -1)
    for k in ("fc1", "fc2"):
        h = torch.relu(h @ tp[k]["w"] + tp[k]["b"])
    wrong = h @ tp["fc3"]["w"] + tp["fc3"]["b"]
    assert float(np.max(np.abs(_np(wrong) - np.asarray(jl)))) > \
        100 * LOGITS_RTOL * float(np.max(np.abs(np.asarray(jl))))


def test_batch_norm_conventions():
    """Population variance (ddof 0), new = 0.9·old + 0.1·batch with that
    variance, no graph on the new stats; eval uses and returns the stored
    stats."""
    x = torch.tensor([1.0, 2.0, 3.0, 4.0]).reshape(1, 1, 2, 2)
    x.requires_grad_()
    p = {"norm_scale": torch.ones(1), "norm_bias": torch.zeros(1)}
    stats = {"mean": torch.zeros(1), "var": torch.ones(1)}
    y, new = cnn.batch_norm(x, p, stats, True)
    assert float(new["mean"]) == pytest.approx(0.1 * 2.5)
    assert float(new["var"]) == pytest.approx(0.9 + 0.1 * 1.25)
    assert not new["mean"].requires_grad and not new["var"].requires_grad
    np.testing.assert_allclose(
        _np(y).ravel(), (np.arange(1, 5) - 2.5) / np.sqrt(1.25 + 1e-5),
        rtol=1e-6)
    jy, jnew = jax_cnn.batch_norm(jnp.asarray(_np(x).transpose(0, 2, 3, 1)),
                                  jax.tree.map(lambda t: jnp.asarray(_np(t)), p),
                                  jax.tree.map(lambda t: jnp.asarray(_np(t)),
                                               stats), True)
    for k in ("mean", "var"):
        np.testing.assert_allclose(_np(new[k]), np.asarray(jnew[k]), rtol=1e-7)
    y2, same = cnn.batch_norm(x, p, stats, False)
    assert same is stats
    np.testing.assert_allclose(_np(y2).ravel(), np.arange(1, 5) / np.sqrt(
        1 + 1e-5), rtol=1e-6)


def test_ce_loss_and_accuracy_match_reference():
    """The first argmax on ties; the accuracy's mean is the reference's
    bits at batch sizes up to 40."""
    rng = np.random.default_rng(2)
    for batch in (1, 2, 3, 5, 7, 8, 12, 16, 31, 40):
        logits = rng.integers(0, 3, (batch, 10)).astype(np.float32)
        labels = rng.integers(0, 10, (batch,)).astype(np.int32)
        jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
        assert float(cnn.accuracy(tl, torch.from_numpy(labels))) == float(
            jax_cnn.accuracy(jl, jnp.asarray(labels)))
        np.testing.assert_allclose(
            float(cnn.ce_loss(tl, torch.from_numpy(labels))),
            float(jax_cnn.ce_loss(jl, jnp.asarray(labels))), rtol=1e-6)


@pytest.mark.parametrize("width", [WIDTH, 1.0])
@pytest.mark.parametrize("classes", [10, 100])
@pytest.mark.parametrize("name", MODELS)
def test_init_shapes_and_layer_madds_match_reference(name, width, classes):
    """The port's init gives the reference's tree at either width (names,
    nesting, shapes, dtypes; stats of mean 0 and var 1); ``layer_madds``
    gives the reference's floats in the reference's order, the stage-0
    ``conv2`` rule included."""
    jp, js = jax.eval_shape(lambda k: jax_cnn.MODELS[name][0](
        k, num_classes=classes, width=width), jax.random.PRNGKey(0))
    tp, ts = cnn.MODELS[name][0](0, num_classes=classes, width=width,
                                 device="cpu")
    jshapes = {p: (tuple(v.shape), str(v.dtype)) for p, v in _flat(jp).items()}
    tshapes = {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for p, v in _flat(tp).items()}
    assert tshapes == jshapes
    sflat = _flat(ts)
    assert {p: tuple(v.shape) for p, v in sflat.items()} == {
        p: tuple(v.shape) for p, v in _flat(js).items()}
    for p, v in sflat.items():
        assert torch.equal(v, torch.full_like(v, 0.0 if p.endswith("mean")
                                              else 1.0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jp)
    want = jax_cnn.layer_madds(zeros)
    got = cnn.layer_madds(tp)
    assert list(got.items()) == list(want.items())
    if name == "resnet20":
        c = tp["s0b1"]["conv2"]["w"].shape
        assert got["s0b1/conv2/w"] == float(9 * c[2] * c[3] * 16 * 16)


def test_trunc_normal_conv_init_scale():
    """TNVS with the conv fan-in kh·kw·cin: N(0, 1/fan_in) truncated at
    ±sqrt(3/fan_in), whose std is sigma·sqrt(1 − 2aφ(a)/(2Φ(a) − 1)) at
    a = sqrt(3)."""
    import math
    tp, _ = cnn.init_resnet20(5, width=1.0, device="cpu")
    w = tp["s2b1"]["conv1"]["w"]
    fan = 9 * w.shape[2]
    a = math.sqrt(3.0)
    phi = math.exp(-a * a / 2) / math.sqrt(2 * math.pi)
    shrink = math.sqrt(1 - 2 * a * phi / math.erf(a / math.sqrt(2)))
    assert float(w.abs().max()) <= (3.0 / fan) ** 0.5
    assert float(w.std()) == pytest.approx(shrink / fan ** 0.5, rel=0.02)


def test_conv_backward_matches_autograd():
    """The autograd Function's backward (dgrad and wgrad under the cuDNN
    flags) against autograd through ``F.conv2d``."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 4, 9, 9)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 4, 5)).astype(np.float32))
    for stride in (1, 2):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = cnn.conv(xa, wa, stride)
        g = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
        dx, dw = torch.autograd.grad(y, (xa, wa), g)
        xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
        lo, hi = cnn.same_pads(9, 3, stride)
        yb = torch.nn.functional.conv2d(
            torch.nn.functional.pad(xb, (lo, hi, lo, hi)),
            wb.permute(3, 2, 0, 1), stride=stride)
        dxb, dwb = torch.autograd.grad(yb, (xb, wb), g)
        _close(y, yb, 1e-6, "conv")
        _close(dx, dxb, 1e-6, "dgrad")
        _close(dw, dwb, 1e-6, "wgrad")


def test_registry_serves_the_cnn_configs():
    for name in MODELS:
        cfg, jcfg = get_config(name), jax_get_config(name)
        assert cfg.model.family == "cnn" and cfg.model.vocab_size == 10
        assert (cfg.train.remat, cfg.train.accum_steps) == (
            jcfg.train.remat, jcfg.train.accum_steps)
        assert cfg.train.global_batch == 512 and cfg.quant.buff == \
            jcfg.quant.buff
        smoke = get_smoke_config(name)
        assert smoke.model.name == f"{name}-smoke"
        assert smoke.train.global_batch == 16


def test_cifar_batch_shapes_and_determinism():
    a = synthetic.cifar_batch(10, 16, 3, seed=1, device="cpu")
    b = synthetic.cifar_batch(10, 16, 3, seed=1, device="cpu")
    c = synthetic.cifar_batch(10, 16, 4, seed=1, device="cpu")
    assert a["images"].shape == (16, 32, 32, 3)
    assert a["images"].dtype == torch.float32
    assert a["labels"].dtype == torch.int32
    assert int(a["labels"].min()) >= 0 and int(a["labels"].max()) < 10
    assert torch.equal(a["images"], b["images"])
    assert torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["images"], c["images"])
    protos = synthetic.cifar_prototypes(10, device="cpu")
    assert protos is synthetic.cifar_prototypes(10, device="cpu")
    noise = a["images"] - protos[a["labels"].long()]
    assert float(noise.std()) == pytest.approx(1.5, rel=0.05)
    big = synthetic.cifar_batch(100, 4096, 0, device="cpu")["labels"]
    assert int(big.max()) == 99 and int(big.min()) == 0
    # the LM stream's generator is unchanged by the salt
    gen = synthetic._step_generator(1, 3, "cpu")
    assert gen.initial_seed() == 1 * 1_000_003 + 3

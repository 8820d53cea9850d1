"""Port parity for the CNN family's precision switch: the means the
switch takes as XLA takes them (``fixed_point.exact_mean``: the switch's
``sp``, ``fixed_point.sparsity`` and ``_avg_lookback``), and the switch
from the same ResNet20 and AlexNet state, every field bit-equal to the
reference's, ResNet20's small leaves into the ladder whole.
"""
import functools
from fractions import Fraction

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import apply_overrides as jax_apply_overrides  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import controller as jax_controller  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import apply_overrides  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import controller  # noqa: E402
from repro_torch.core import fixed_point as fxp  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's many small torch ops run on one thread: beside other
    test processes an intra-op thread pool only waits for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SWITCH = ["train.adapt_interval=2", "quant.lb_lwr=2"]


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


# ---------------------------------------------------------------------------
# The means of exact sums


def _counts(n):
    return sorted({0, 1, n // 3, n - 1, n})


def _cnn_leaf_sizes():
    """The element counts of every AlexNet and ResNet20 leaf at smoke and
    full width, on CIFAR-10 and CIFAR-100."""
    sizes = set()
    for init, _ in cnn.MODELS.values():
        for width in (0.25, 1.0):
            for classes in (10, 100):
                params, _ = init(0, classes, width, device="cpu")
                sizes |= {leaf.numel() for _, leaf in
                          controller.flatten_with_path(params)}
    return sizes


def _sample_sizes():
    """Every n up to 1024, every CNN leaf size (``_cnn_leaf_sizes``), the
    powers of two up to 2^16 and their neighbours, 70000 and its neighbour,
    1152 (the ResNet20 smoke leaf where the fault showed), and 120 sizes
    below 70000 where dividing by n and multiplying by f32(1/n) round apart
    for one of the counts."""
    sizes = set(range(1, 1025)) | {1152, 69999, 70000} | _cnn_leaf_sizes()
    for e in range(9, 17):
        sizes |= {2 ** e - 1, 2 ** e, 2 ** e + 1}
    apart = []
    for n in range(129, 70000, 7):
        k = np.array(_counts(n), np.float32)
        prod = k * (np.float32(1) / np.float32(n))
        quot = k / np.float32(n)
        if np.any(prod != quot):
            apart.append(n)
    sizes |= set(apart[::max(len(apart) // 120, 1)][:120])
    return sorted(sizes)


def _jnp_means(sizes):
    """jnp.mean of 0/1 masks with each of ``_counts(n)`` ones, n in
    ``sizes``: one compiled program per 64 sizes (a size is a shape)."""
    out = {}
    for start in range(0, len(sizes), 64):
        group = sizes[start:start + 64]

        def f(ks, group=group):
            return [jnp.mean((jnp.arange(n)[None, :] < ks[i][:, None])
                             .astype(jnp.float32), axis=1)
                    for i, n in enumerate(group)]

        ks = np.stack([np.array(_counts(n) + [n] * (5 - len(_counts(n))),
                                np.int32) for n in group])
        for n, m in zip(group, jax.jit(f)(ks)):
            out[n] = np.asarray(m)[:len(_counts(n))]
    return out


def test_exact_mean_is_jnp_mean_on_sampled_sizes():
    """``exact_mean`` of a 0/1 mask equals ``jnp.mean`` bit for bit (XLA
    multiplies the sum by f32(1/n)); ``torch.mean`` divides and differs at
    some of the sizes, 1151 of 1152 among them."""
    sizes = _sample_sizes()
    want = _jnp_means(sizes)
    differ = 0
    for n in sizes:
        ks = _counts(n)
        mask = (torch.arange(n)[None, :] < torch.tensor(ks)[:, None]).to(
            torch.float32)
        got = fxp.exact_mean(mask, dim=1).numpy()
        np.testing.assert_array_equal(got, want[n], err_msg=f"n={n}")
        np.testing.assert_array_equal(fxp.sparsity(mask, axes=1).numpy(),
                                      want[n])
        differ += int(np.any(torch.mean(mask, dim=1).numpy() != want[n]))
    assert differ > 100
    x = torch.zeros(1152)
    x[:1151] = 1.0
    assert float(fxp.exact_mean(x)) == float(jnp.mean(jnp.asarray(x.numpy())))
    assert float(torch.mean(x)) != float(fxp.exact_mean(x))


def test_exact_mean_is_the_reciprocal_product_for_every_size():
    """For every n from 1 to 70000 at six counts, ``exact_mean`` of a 0/1
    mask is f32(k) · (f32(1) / f32(n)): the port against the formula, not
    against XLA, which the test above holds it to at the sampled sizes only
    (a compiled program per size costs about 0.03 s). The masks are strided
    views of one buffer."""
    big = 70000
    buf = torch.cat([torch.ones(big), torch.zeros(big)])
    got, want = [], []
    one = np.float32(1)
    for n in range(1, big + 1):
        d = max(n // 3, 1)
        # rows of n - i·d ones (i = 0..3), then rows of n - 1 and 1 ones
        views = [(torch.as_strided(buf, (4, n), (d, 1), big - n),
                  [max(n - i * d, 0) for i in range(4)])]
        if n >= 2:
            views.append((torch.as_strided(buf, (2, n), (n - 2, 1),
                                           big - n + 1), [n - 1, 1]))
        for v, ks in views:
            got.append(fxp.exact_mean(v, dim=1).numpy())
            want.append(np.array(ks, np.float32) * (one / np.float32(n)))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))


# Tensor counts at which the test below also runs the reference's jitted
# ``_avg_lookback`` (a compile per count): every count up to 16 and the
# larger ones around powers of two
REFERENCE_COUNTS = list(range(1, 17)) + [22, 63, 64, 65, 127, 128, 129, 255,
                                         256, 257, 299, 300]


def test_avg_lookback_is_the_references():
    """``_avg_lookback`` over 1–300 tensors of equal and of mixed integer
    lookbacks, one a tensor as each CNN tensor has: f32(Σ lb) · (f32(1) /
    f32(t)) at every count, and the reference's jitted ``_avg_lookback``
    bit for bit at ``REFERENCE_COUNTS``. (Stacked leaves: the test
    below.)"""
    rng = np.random.default_rng(0)
    ref = jax.jit(jax_controller._avg_lookback)
    for t in range(1, 301):
        for mixed in (False, True):
            lbs = rng.integers(2, 101, t) if mixed else np.full(t, 25)
            got = controller._avg_lookback({
                "tensors": {f"t{i}": {"lb": torch.tensor(lb, dtype=torch.int32)}
                            for i, lb in enumerate(lbs)},
                "loss_hist": torch.zeros(4)})
            assert got.dtype == torch.float32
            rule = np.float32(lbs.sum()) * (np.float32(1) / np.float32(t))
            assert got.numpy() == rule, (t, mixed)
            if t in REFERENCE_COUNTS:
                want = np.asarray(ref({"tensors": {
                    f"t{i}": {"lb": np.int32(lb)} for i, lb in enumerate(lbs)}}))
                assert got.numpy() == want, (t, mixed)


def _lm_lookbacks(rng, layers, tensors, kind):
    if kind == "random":
        return [rng.integers(2, 101, layers) for _ in range(tensors)]
    if kind == "equal":
        return [np.full(layers, rng.integers(2, 60)) for _ in range(tensors)]
    if kind == "small":
        return [rng.integers(2, 12, layers) for _ in range(tensors)]
    # mixed: stacked leaves and single lookbacks, as embed and head beside
    # the layers
    return [rng.integers(2, 101, layers) if i % 3 else
            np.int32(rng.integers(2, 101)) for i in range(tensors)]


@pytest.mark.parametrize("layers,tensors", [
    (28, 7), (28, 9), (28, 2), (3, 5), (2, 7), (16, 7), (7, 10), (3, 22),
    (5, 65)])
def test_avg_lookback_is_the_references_on_stacked_leaves(layers, tensors):
    """LM-shaped states, ``tensors`` leaves stacked over ``layers`` (28 × 7
    as llama3.2-3b's seven dense kernels) with random, equal, small and
    mixed lookbacks, under leaf names in random order: the reference's
    jitted ``_avg_lookback`` bit for bit, the inexact per-layer means
    included (XLA's CPU backend sums them in fused multiply-adds,
    ``fixed_point.fma_f32``). Where a layer count is not a power of two,
    the parent's mean of ``torch.mean``s differs from it in some states."""
    rng = np.random.default_rng(layers * 1000 + tensors)
    ref = jax.jit(jax_controller._avg_lookback)
    plain_differs = 0
    for trial in range(40):
        lbs = _lm_lookbacks(rng, layers, tensors,
                            ("random", "equal", "small", "mixed")[trial % 4])
        names = [f"n{rng.integers(0, 10 ** 6)}/w" for _ in lbs]
        got = controller._avg_lookback({
            "tensors": {nm: {"lb": torch.tensor(lb, dtype=torch.int32)}
                        for nm, lb in zip(names, lbs)},
            "loss_hist": torch.zeros(4)})
        want = np.asarray(ref({"tensors": {
            nm: {"lb": np.asarray(lb, np.int32)}
            for nm, lb in zip(names, lbs)}}))
        assert got.dtype == torch.float32
        assert got.numpy() == want, (trial, lbs)
        plain = torch.mean(torch.stack([
            torch.mean(torch.tensor(lb, dtype=torch.float32)) for lb in lbs]))
        plain_differs += int(plain.numpy() != want)
    if layers & (layers - 1):
        assert plain_differs > 0


def _round_f32(x):
    """The f32 nearest the rational ``x``, ties to even."""
    f = np.float32(float(x))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(v.view(np.uint32)) & 1))


def test_fma_f32_rounds_once():
    """``fma_f32`` is a·b + c rounded once to f32, against exact rational
    arithmetic: on random values, on sums that cancel, and where the f64
    sum falls on an f32 tie the exact value is below (1 + 2^-23 plus
    (1 + 2^-23)(2^-24 − 2^-47)), where rounding the f64 sum to f32 is
    wrong."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal(4000).astype(np.float32)
    b = (rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000)
         ).astype(np.float32)
    c = rng.standard_normal(4000).astype(np.float32)
    c[:1000] = -(a[:1000] * b[:1000]).astype(np.float32)
    one = np.float32(1) + np.float32(2.0 ** -23)
    tie_b = np.float32(2.0 ** -24) * (np.float32(1) - np.float32(2.0 ** -23))
    a = np.concatenate([a, [one, one, -one]]).astype(np.float32)
    b = np.concatenate([b, [tie_b, -tie_b, tie_b]]).astype(np.float32)
    c = np.concatenate([c, [one, -one, -one]]).astype(np.float32)
    got = fxp.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert np.all(twice[-3:] != want[-3:])
    assert got[-3] == one


# ---------------------------------------------------------------------------
# The precision switch


def _switch_state(name, pallas):
    """The reference's smoke init state after two of the port's steps
    (every window of two closed; the steps are held against the
    reference's in ``test_torch_cnn_step.py``), as numpy, and both
    configs."""
    ov = SWITCH + [f"quant.use_pallas={str(pallas).lower()}"]
    jcfg = jax_apply_overrides(jax_smoke(name), ov)
    cfg = apply_overrides(get_smoke_config(name), ov)
    jstate = jax.jit(functools.partial(jax_train_loop.init_state, jcfg))()
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           "cpu")
    step = train_loop.make_train_step(cfg)
    for i in range(2):
        state, _ = step(state, train_loop.make_batch(cfg, i, device="cpu"),
                        step=i)
    npstate = interop.to_numpy({k: v for k, v in state.items() if k != "rng"})
    npstate["rng"] = np.asarray(jstate["rng"])
    return jcfg, cfg, npstate


@pytest.mark.parametrize("name,pallas", [("resnet20", True),
                                         ("resnet20", False),
                                         ("alexnet", True)])
def test_switch_is_the_references(name, pallas, monkeypatch):
    """The same state through ``precision_switch``: wl, fl, lb, res,
    count, norm_sum, grad_sum, sp and the strategy bit-equal to the
    reference's jitted switch, every tensor switched. Under use_pallas the
    ladder sees each leaf of at most ``edf_sample`` elements whole."""
    jcfg, cfg, jstate = _switch_state(name, pallas)
    seen = []
    real = kops._el.edf_ladder_hists

    def spy(w, *args, **kwargs):
        seen.append(tuple(w.shape))
        return real(w, *args, **kwargs)

    monkeypatch.setattr(kops._el, "edf_ladder_hists", spy)
    jout = jax.jit(jax_train_loop.make_precision_switch(jcfg))(
        jax.tree.map(jnp.asarray, jstate))
    state = interop.train_state_from_numpy(jstate, "cpu")
    out = train_loop.make_precision_switch(cfg)(state)
    jt = jax.tree.map(np.asarray, jout["adapt"])
    _assert_same_bits(out["adapt"]["tensors"], jt["tensors"], f"{name} switch")
    assert int(out["adapt"]["strategy"]) == int(jt["strategy"])
    for ts in out["adapt"]["tensors"].values():
        assert int(ts["count"]) == 0
    sizes = {p: int(np.prod(v.shape)) for p, v in _flat(jstate["params"]).items()
             if p in out["adapt"]["tensors"]}
    if pallas:
        want = [(1, min(n, cfg.quant.edf_sample)) for n in sizes.values()]
        assert sorted(seen) == sorted(want)
        assert any(n < cfg.quant.edf_sample for n in sizes.values())
    else:
        assert seen == []
    if name == "resnet20":
        assert sizes["s2b0/conv1/w"] == 1152

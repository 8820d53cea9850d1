"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference's (``repro.models.moe``) on the CPU, in the smoke configs of
mixtral-8x22b and arctic-480b: the same params (carried by ``interop``)
and the same bf16 input, made from a numpy seed.

The routing is held exactly: the chosen experts, their tie order (an
all-zero row gives all-equal logits, which ``jax.lax.top_k`` breaks to the
lower index) and the destination slot of every (token, choice) pair, so
the set of dropped pairs, recomputed from the reference's own formula
(``moe.py:83-91``) in JAX. Values are held within stated tolerances: the
layer's bf16 output within one bf16 ulp of the largest |output| (the
reference computes the expert products in f32 on the CPU, as the port
does there), and each gradient within 1e-2 normwise.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import common, moe  # noqa: E402

ARCHS = ["mixtral-8x22b", "arctic-480b"]
# capacity factor: the registry's 1.25 (few or no drops at this size), one
# that forces drops, and the decode path's dropless routing
CASES = {"registry": (1.25, False), "drops": (0.5, False),
         "dropless": (0.5, True)}
B, S = 2, 24
OUT_ULPS = 1
GRAD_RTOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch, cf):
    jm = dataclasses.replace(jax_get_smoke(arch).model, capacity_factor=cf)
    tm = dataclasses.replace(get_smoke_config(arch).model, capacity_factor=cf)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    return jm, tm


def _params(jm, seed=1):
    p = jax_moe.init_layer(jax.random.PRNGKey(seed), jm, 0)
    # non-zero norm scales, so the norms are exercised
    rng = np.random.default_rng(seed)
    p["pre_norm"] = jnp.asarray(rng.normal(0, 0.1, p["pre_norm"].shape),
                                jnp.float32)
    return p


def _input(jm, zero_rows=()):
    x = np.random.default_rng(2).standard_normal((B, S, jm.d_model))
    x = x.astype(np.float32)
    for b, s in zero_rows:
        x[b, s] = 0.0
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    return xj, interop.tensor_from_numpy(np.asarray(xj), "cpu")


def _reference_routing(p, xj, jm, dropless):
    """The reference's routing of ``xj``, from ``moe.py:66-91`` with g = 1:
    (chosen (T, k), dest (T·k,), cap)."""
    E, k = jm.num_experts, jm.experts_per_token
    h = jax_common.rms_norm(xj, p["pre_norm"], jm.norm_eps)
    T = h.shape[0] * h.shape[1]
    cap = T if dropless else max(int(jm.capacity_factor * k * T / E), 1)
    cap = min(cap, T * k)
    logits = jnp.einsum("td,de->te", h.reshape(T, -1).astype(jnp.float32),
                        p["router"].astype(jnp.float32))
    _, chosen = jax.lax.top_k(logits, k)
    flat_e = chosen.reshape(T * k)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    pos_sel = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    dest = jnp.where(pos_sel < cap, flat_e * cap + pos_sel, E * cap)
    return np.asarray(chosen), np.asarray(dest), cap


def _normwise(got, want, rtol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.linalg.norm((got - want).ravel()))
    assert err <= rtol * max(float(np.linalg.norm(want.ravel())), 1e-30), (
        what, err)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_output_match_the_reference(arch, case):
    cf, dropless = CASES[case]
    jm, tm = _configs(arch, cf)
    p = _params(jm)
    xj, xt = _input(jm, zero_rows=((0, 3), (1, 7)))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    chosen, dest, cap = _reference_routing(p, xj, jm, dropless)
    h = common.rms_norm(xt, tp["pre_norm"], tm.norm_eps)
    weights, tchosen, tdest, tcap = moe.route(h, tp["router"], tm, dropless)
    assert tcap == cap
    np.testing.assert_array_equal(tchosen.numpy(), chosen)
    np.testing.assert_array_equal(tdest.numpy(), dest)
    dropped = int(np.sum(dest == jm.num_experts * cap))
    if case == "drops":
        assert dropped > 0
    if dropless:
        assert dropped == 0
    assert weights.dtype == torch.float32
    np.testing.assert_allclose(weights.sum(-1).numpy(), 1.0, rtol=1e-6)

    want = np.asarray(jax_moe.apply(p, xj, jm, dropless=dropless)
                      ).astype(np.float32)
    got = moe.apply(tp, xt, tm, dropless=dropless)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    tol = OUT_ULPS * 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_all_zero_rows_tie_to_the_lower_experts(arch):
    jm, tm = _configs(arch, 1.25)
    p = _params(jm)
    xj, xt = _input(jm, zero_rows=[(b, s) for b in range(B)
                                   for s in range(0, S, 3)])
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    chosen, _, _ = _reference_routing(p, xj, jm, False)
    h = common.rms_norm(xt, tp["pre_norm"], tm.norm_eps)
    _, tchosen, _, _ = moe.route(h, tp["router"], tm)
    zero = np.zeros((B, S), bool)
    zero[:, ::3] = True
    zero = zero.reshape(-1)
    k = jm.experts_per_token
    np.testing.assert_array_equal(chosen[zero], np.tile(np.arange(k),
                                                        (zero.sum(), 1)))
    np.testing.assert_array_equal(tchosen.numpy(), chosen)


@pytest.mark.parametrize("arch", ARCHS)
def test_nan_row_routes_in_range_as_the_reference(arch):
    """A token whose input holds a NaN (a diverging step) gives a row of
    NaN logits: it is routed to in-range experts as ``jax.lax.top_k``
    routes it, the layer does not raise, and the NaN stays in that token's
    output row, as in the reference's."""
    jm, tm = _configs(arch, 0.5)
    p = _params(jm)
    x = np.random.default_rng(2).standard_normal((B, S, jm.d_model))
    x = x.astype(np.float32)
    x[1, 4, 7] = np.nan
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = interop.tensor_from_numpy(np.asarray(xj), "cpu")
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    chosen, dest, cap = _reference_routing(p, xj, jm, False)
    h = common.rms_norm(xt, tp["pre_norm"], tm.norm_eps)
    _, tchosen, tdest, _ = moe.route(h, tp["router"], tm)
    np.testing.assert_array_equal(tchosen.numpy(), chosen)
    np.testing.assert_array_equal(tdest.numpy(), dest)
    assert tchosen.numpy().max() < jm.num_experts
    want = np.asarray(jax_moe.apply(p, xj, jm)).astype(np.float32)
    got = moe.apply(tp, xt, tm).float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1, 4]).all()
    tol = OUT_ULPS * 2.0 ** -7 * np.nanmax(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_ties_match_lax_top_k(k):
    """Integer-valued logits, so most rows hold ties, -inf entries, signed
    zeros, and rows with NaNs of either sign, which XLA's total order puts
    above +inf (+NaN) or below -inf (-NaN): every index stays in range."""
    rng = np.random.default_rng(k)
    logits = rng.integers(-2, 3, (257, 8)).astype(np.float32)
    logits[5] = -np.inf
    logits[6, :5] = -np.inf
    neg_nan = np.copysign(np.float32(np.nan), np.float32(-1))
    logits[7] = [0.0, -0.0, 0.0, -0.0, -0.0, 0.0, -0.0, 0.0]
    logits[8] = np.nan
    logits[9] = neg_nan
    logits[10, [1, 4]] = np.nan
    logits[11, [0, 6]] = neg_nan
    logits[12] = [np.inf, np.nan, -np.inf, neg_nan, np.nan, 1, -0.0, 0.0]
    logits[13, :] = -np.inf
    logits[13, 3] = neg_nan
    want_v, want_i = jax.lax.top_k(jnp.asarray(logits), k)
    got_v, got_i = moe.top_k(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(np.signbit(got_v.numpy()),
                                  np.signbit(np.asarray(want_v)))


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_load_balance_loss_matches_the_reference(arch):
    jm, tm = _configs(arch, 1.25)
    p = _params(jm)
    xj, xt = _input(jm, zero_rows=((0, 0),))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    want = float(jax_moe.aux_load_balance_loss(p, xj, jm))
    got = moe.aux_load_balance_loss(tp, xt, tm)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("case", ["drops", "dropless"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch, case):
    """d/d(params, x) of Σ r·apply(p, x) for a fixed random r: the router's
    through the top-k softmax weights only, the experts', the norm's, the
    dense residual's (arctic) and the input's."""
    cf, dropless = CASES[case]
    jm, tm = _configs(arch, cf)
    p = _params(jm)
    xj, xt = _input(jm, zero_rows=((0, 3),))
    r = np.random.default_rng(3).standard_normal(xt.shape).astype(np.float32)

    def jloss(p, x):
        y = jax_moe.apply(p, x, jm, dropless=dropless)
        return jnp.sum(y.astype(jnp.float32) * r)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, xj)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_()
    xt.requires_grad_()
    y = moe.apply(tp, xt, tm, dropless=dropless)
    loss = torch.sum(y.float() * torch.from_numpy(r))
    grads = torch.autograd.grad(loss, [*leaves.values(), xt])
    want = _flat(jax.tree.map(np.asarray, jgp))
    assert set(want) == set(leaves)
    for (path, _), g in zip(leaves.items(), grads):
        assert g.dtype == leaves[path].dtype, path
        _normwise(g.float().numpy(), want[path], GRAD_RTOL, path)
    assert float(np.linalg.norm(want["router"])) > 0
    _normwise(grads[-1].float().numpy(), np.asarray(jgx, np.float32),
              GRAD_RTOL, "x")

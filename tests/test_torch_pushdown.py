"""PushDown, PushUp and the adaptation rules of the port against the JAX
package's on the same inputs: ``push_down`` through both of its branches
(the EDF-ladder kernel under ``use_pallas``, 18 probes otherwise) on TNVS,
Gaussian, heavy-tailed and exactly representable weights, and the PushUp
and adaptation functions on a grid of Δs, FL_min, strategy, lb and r.
Integer results must be identical.
"""
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pushdown as jax_pushdown  # noqa: E402
from repro.core import pushup as jax_pushup  # noqa: E402
from repro_torch.core import pushdown, pushup  # noqa: E402

R_UPR, EPS_KL = 150, 1e-2


def _weights(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "tnvs":            # truncated normal, variance scaling
        fan_in = 512
        w = rng.normal(0, fan_in ** -0.5, 4 * n)
        w = w[np.abs(w) <= (3.0 / fan_in) ** 0.5][:n]
    elif kind == "gaussian":
        w = rng.normal(0, 0.3, n)
    elif kind == "heavy_tailed":  # Student t with 2 degrees of freedom
        w = rng.standard_t(2, n) * 0.05
    else:                         # exactly representable on ⟨8, 5⟩
        w = rng.integers(-128, 128, n) / 32.0
    return w.astype(np.float32)


@pytest.fixture(scope="module")
def jax_push_down():
    """The reference's push_down, jitted once per branch."""
    return {p: jax.jit(lambda w, r, p=p: jax_pushdown.push_down(
        w, r, r_upr=R_UPR, eps_kl=EPS_KL, max_wl=32, use_pallas=p))
        for p in (True, False)}


@pytest.mark.parametrize("r", [50, 150])
@pytest.mark.parametrize("kind", ["tnvs", "gaussian", "heavy_tailed",
                                  "exact"])
def test_push_down_matches_both_branches(jax_push_down, kind, r):
    """Three layers (batched in the port, one call each in the reference),
    each through both branches of both packages: one ⟨WL,FL⟩."""
    w = np.stack([_weights(kind, 8192, s) for s in range(3)])
    rs = np.array([r, 50, 150], np.int32)
    want = [tuple(int(v) for v in jax_push_down[True](
        jnp.asarray(w[l]), jnp.int32(rs[l]))) for l in range(3)]
    for l in range(3):
        assert want[l] == tuple(int(v) for v in jax_push_down[False](
            jnp.asarray(w[l]), jnp.int32(rs[l])))
    for use_pallas in (True, False):
        wl, fl = pushdown.push_down(torch.from_numpy(w), torch.from_numpy(rs),
                                    r_upr=R_UPR, eps_kl=EPS_KL, max_wl=32,
                                    use_pallas=use_pallas)
        assert wl.dtype == fl.dtype == torch.int32
        assert list(zip(wl.tolist(), fl.tolist())) == want, use_pallas


@pytest.mark.parametrize("max_wl", [8, 12, 32])
def test_push_down_respects_max_wl(max_wl):
    w = torch.from_numpy(np.stack([_weights("heavy_tailed", 4096, 7)]))
    r = torch.tensor([150], dtype=torch.int32)
    want = jax_pushdown.push_down(jnp.asarray(w[0].numpy()), jnp.int32(150),
                                  r_upr=R_UPR, eps_kl=1e-4, max_wl=max_wl,
                                  use_pallas=False)
    for use_pallas in (True, False):
        wl, fl = pushdown.push_down(w, r, r_upr=R_UPR, eps_kl=1e-4,
                                    max_wl=max_wl, use_pallas=use_pallas)
        assert (int(wl[0]), int(fl[0])) == tuple(int(v) for v in want)
        assert int(wl[0]) <= max_wl


def test_subsample_and_kl_bits():
    x = np.arange(1000, dtype=np.float32)
    got = pushdown.subsample(torch.from_numpy(x).reshape(1, -1), 300)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(
        jax_pushdown.subsample(jnp.asarray(x), 300)))
    assert pushdown.subsample(torch.zeros(2, 5), 9).shape == (2, 5)
    rng = np.random.default_rng(0)
    p, q = (rng.integers(0, 50, (4, R_UPR)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jax.vmap(jax_pushdown.kl_bits)(jnp.asarray(p),
                                                     jnp.asarray(q)))
    got = pushdown.kl_bits(torch.from_numpy(p), torch.from_numpy(q)).numpy()
    # f32 sums of 150 terms in another order and log in another library
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# Δs on both sides of the branches; e·(1 + 5e-7) takes the |log Δs − 1| <
# 1e-6 guard with s2 = 32·log²Δs − 1 ≈ 31.00003, away from an integer
# (Δs = e itself is test_push_up_at_e below).
DS = [0.5, 1.0, 1.0000001, 1.3, 1.999, 2.0, np.e * (1 + 5e-7), 3.0, 7.5,
      40.0, 1e30, np.inf]
FL_MIN = [0, 3, 9, 27]


def _grid():
    ds, fl = np.meshgrid(np.array(DS, np.float32), np.array(FL_MIN))
    wl = np.minimum(fl + np.array([1, 2, 5, 3])[:, None], 32)
    return (ds.ravel().astype(np.float32), fl.ravel().astype(np.int32),
            wl.ravel().astype(np.int32))


@pytest.mark.parametrize("strategy", [0, 1, 2])
@pytest.mark.parametrize("buff", [0, 4])
def test_push_up_matches(strategy, buff):
    ds, fl, wl = _grid()
    st = np.int32(strategy)
    want = jax_pushup.push_up(jnp.asarray(wl), jnp.asarray(fl),
                              jnp.asarray(ds), jnp.asarray(st), buff=buff)
    got = pushup.push_up(torch.from_numpy(wl), torch.from_numpy(fl),
                         torch.from_numpy(ds), torch.tensor(st), buff=buff)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    s1, s2 = pushup.suggestions(torch.from_numpy(ds), torch.from_numpy(fl))
    j1, j2 = jax_pushup.suggestions(jnp.asarray(ds), jnp.asarray(fl))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(j1))
    np.testing.assert_allclose(s2.numpy(), np.asarray(j2), rtol=1e-6)
    np.testing.assert_array_equal(
        pushup.combine(s1, s2, torch.tensor(st)).numpy(),
        np.asarray(jax_pushup.combine(j1, j2, jnp.asarray(st))))


def test_push_up_at_e():
    """At Δs = f32(e) the exact log is 1 − 3.04e-8, nearly halfway
    between the f32 values 1 − 2^-24 and 1: XLA's log and torch's may
    round it to different neighbours (both within their one-ulp
    accuracy), and then s2 = 32·log²Δs − 1 lands on either side of 31,
    and WL = ⌊FL + 1⌋ on either side of 32. Where the two logs agree the
    results must be identical; where they differ by the one ulp, WL by at
    most one (ROADMAP.md, Queue 3)."""
    e = np.float32(np.e)
    tlog = float(torch.log(torch.tensor(e)))
    jlog = float(jnp.log(jnp.float32(e)))
    assert abs(tlog - jlog) <= 2.0 ** -24
    ds = np.full(3, e, np.float32)
    fl = np.zeros(3, np.int32)
    for st in (0, 1, 2):
        want = jax_pushup.push_up(jnp.asarray(fl + 1), jnp.asarray(fl),
                                  jnp.asarray(ds), jnp.int32(st), buff=0)
        got = pushup.push_up(torch.from_numpy(fl + 1), torch.from_numpy(fl),
                             torch.from_numpy(ds), torch.tensor(st), buff=0)
        for g, w in zip(got, want):
            diff = np.abs(g.numpy() - np.asarray(w))
            assert (diff == 0).all() if tlog == jlog else (diff <= 1).all()


@pytest.mark.parametrize("lb_lwr,lb_upr,gamma", [(25, 100, 0.33), (2, 3, 0.33),
                                                 (2, 50, 0.9)])
def test_adapt_lookback_and_resolution_match(lb_lwr, lb_upr, gamma):
    ds = np.array(DS + [0.0, -1.0, np.nan], np.float32)
    for lb in sorted({lb_lwr, (lb_lwr + lb_upr) // 2, lb_upr}):
        lbs = np.full(ds.shape, lb, np.int32)
        want = jax_pushup.adapt_lookback(jnp.asarray(lbs), jnp.asarray(ds),
                                         lb_lwr=lb_lwr, lb_upr=lb_upr,
                                         gamma=gamma)
        got = pushup.adapt_lookback(torch.from_numpy(lbs),
                                    torch.from_numpy(ds), lb_lwr=lb_lwr,
                                    lb_upr=lb_upr, gamma=gamma)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for r in (50, 51, 149, 150):
            rs = np.full(ds.shape, r, np.int32)
            wr = jax_pushup.adapt_resolution(
                jnp.asarray(rs), want, lb_lwr=lb_lwr, lb_upr=lb_upr,
                r_lwr=50, r_upr=150)
            gr = pushup.adapt_resolution(
                torch.from_numpy(rs), got, lb_lwr=lb_lwr, lb_upr=lb_upr,
                r_lwr=50, r_upr=150)
            assert gr.dtype == torch.int32
            np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))


def test_adapt_strategy_and_diversity_match():
    for st, avg, now in itertools.product(
            (0, 1, 2), (2.0, -2.0, 1.5), (2.0, 1.9, -2.5)):
        want = jax_pushup.adapt_strategy(jnp.int32(st), jnp.float32(avg),
                                         jnp.float32(now))
        got = pushup.adapt_strategy(torch.tensor(st, dtype=torch.int32),
                                    torch.tensor(avg), torch.tensor(now))
        assert got.dtype == torch.int32 and int(got) == int(want)
    ns = np.array([3.0, 0.0, 1e-30, 5.0], np.float32)
    gs = np.array([2.0, 0.0, 0.0, 1e-25], np.float32)
    np.testing.assert_array_equal(
        pushup.gradient_diversity(torch.from_numpy(ns),
                                  torch.from_numpy(gs)).numpy(),
        np.asarray(jax_pushup.gradient_diversity(jnp.asarray(ns),
                                                 jnp.asarray(gs))))

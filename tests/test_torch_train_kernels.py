"""Port parity for the training slice's kernels and autograd rules: the
plain versions of the dense-layer backward (dx, dw) and of the flash
backward (dq, dk, dv) against the JAX reference's Pallas kernels run in
interpret mode on the CPU, and the port's autograd Functions against
``jax.grad`` through the reference's custom VJPs.

The CUDA kernels themselves need an H100; ``chip_smoke.py`` holds them
against these plain versions on the card.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.kernels import fxp_matmul as jax_fxp_matmul  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import flash_attention, fxp_matmul, ops, ref  # noqa: E402

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |v| (8-bit significand)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _exact_in(dtype: str, a: np.ndarray) -> np.ndarray:
    """``a`` rounded to ``dtype`` and back, so both packages get the same
    values."""
    if dtype == "bfloat16":
        return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a.astype(np.float32)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got: np.ndarray, want: np.ndarray, dtype: str) -> None:
    if dtype == "bfloat16":
        # f32 sums of exact products in another order can round to the
        # neighbouring bf16 value: at most one bf16 ulp apart
        assert np.all(np.abs(got - want) <= _bf16_ulp(
            np.maximum(np.abs(got), np.abs(want))))
    else:
        # f32 outputs: summation order only
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Dense layer: dx and dw


def _dense_inputs(m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = _exact_in(dtype, rng.normal(0, 1, (m, k)))
    dy = _exact_in(dtype, rng.normal(0, 1, (m, n)))
    wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    return x, dy, wq


@pytest.mark.parametrize("m,k,n", [(7, 67, 33), (130, 257, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matmul_dx_matches_pallas(m, k, n, dtype):
    _, dy, wq = _dense_inputs(m, k, n, dtype)
    scale = np.float32(2.0 ** -6)
    jdy = jnp.asarray(dy, JDT[dtype])
    pallas = _np(jax_fxp_matmul.matmul_dx(jdy, jnp.asarray(wq),
                                          jnp.float32(scale), interpret=True))
    oracle = _np(jax_ref.ref_matmul_dx(jdy, jnp.asarray(wq),
                                       jnp.float32(scale)))
    got = fxp_matmul.plain_dx(torch.from_numpy(dy).to(TDT[dtype]),
                              torch.from_numpy(wq), torch.tensor(scale))
    assert got.dtype == TDT[dtype] and got.shape == (m, k)
    for want in (pallas, oracle):
        _assert_close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("m,k,n", [(7, 67, 33), (130, 257, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matmul_dw_matches_pallas(m, k, n, dtype):
    x, dy, _ = _dense_inputs(m, k, n, dtype)
    jx, jdy = jnp.asarray(x, JDT[dtype]), jnp.asarray(dy, JDT[dtype])
    pallas = _np(jax_fxp_matmul.matmul_dw(jx, jdy, interpret=True))
    oracle = _np(jax_ref.ref_matmul_dw(jx, jdy))
    got = fxp_matmul.plain_dw(torch.from_numpy(x).to(TDT[dtype]),
                              torch.from_numpy(dy).to(TDT[dtype]))
    assert got.dtype == torch.float32 and got.shape == (k, n)
    for want in (pallas, oracle):
        # f32 out from exact products: summation order only
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", [(7, 67, 33), (130, 257, 129)])
def test_fxp_dense_autograd_matches_jax_grad(m, k, n):
    """x, wref and sc gradients of ops.fxp_dense(use_pallas=True) against
    jax.grad through the reference's straight-through custom VJP."""
    x, c, wq = _dense_inputs(m, k, n, "bfloat16", seed=3)
    sc = np.float32(2.0 ** -5)

    def jloss(x_, sc_, wref_):
        y = jax_ops.fxp_dense(x_, jnp.asarray(wq), sc_, wref_,
                              use_pallas=True)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(c))

    jx = jnp.asarray(x, jnp.bfloat16)
    jsc = jnp.asarray(sc, jnp.bfloat16)
    jwref = jnp.zeros((k, n), jnp.bfloat16)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jx, jsc, jwref)

    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tsc = torch.tensor(sc, dtype=torch.bfloat16).requires_grad_()
    twref = torch.zeros((), dtype=torch.bfloat16).expand(k, n).requires_grad_()
    y = ops.fxp_dense(tx, torch.from_numpy(wq), tsc, twref, use_pallas=True)
    loss = torch.sum(y.float() * torch.from_numpy(c))
    gx, gsc, gw = torch.autograd.grad(loss, (tx, tsc, twref))

    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.bfloat16
    assert float(gsc) == 0.0 and float(jg[1]) == 0.0     # scale: exactly 0
    _assert_close(gx.float().numpy(), _np(jg[0]), "bfloat16")
    # dw is an f32 sum rounded once to bf16 in both
    _assert_close(gw.float().numpy(), _np(jg[2]), "bfloat16")


def test_fxp_dense_without_pallas_matches_jax_grad():
    """The plain dequant-then-dot path: autograd against jax.grad, f32."""
    x, c, wq = _dense_inputs(9, 20, 11, "float32", seed=4)
    sc = np.float32(2.0 ** -4)
    jg = jax.grad(lambda x_, w_: jnp.sum(jax_ops.fxp_dense(
        x_, jnp.asarray(wq), jnp.float32(sc), w_) * jnp.asarray(c)),
        argnums=(0, 1))(jnp.asarray(x), jnp.zeros((20, 11), jnp.bfloat16))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.zeros(20, 11, dtype=torch.bfloat16, requires_grad=True)
    y = ops.fxp_dense(tx, torch.from_numpy(wq), torch.tensor(sc), tw)
    gx, gw = torch.autograd.grad(torch.sum(y * torch.from_numpy(c)), (tx, tw))
    np.testing.assert_allclose(gx.numpy(), _np(jg[0]), rtol=1e-5, atol=1e-6)
    _assert_close(gw.float().numpy(), _np(jg[1]), "bfloat16")


# ---------------------------------------------------------------------------
# Flash attention backward

BWD_CASES = [
    # (B, Sq, Skv, H, Hkv, D, causal, window, softcap)
    (2, 21, 21, 6, 2, 16, True, 0, 0.0),       # causal, GQA 24/8 narrowed to 6/2
    (1, 19, 19, 4, 2, 16, True, 5, 2.0),       # window + softcap
    (1, 7, 20, 4, 2, 16, True, 0, 0.0),        # Sq < Skv
    (1, 20, 7, 4, 2, 16, True, 0, 0.0),        # Sq > Skv: 13 rows reach no key
    (1, 23, 9, 4, 4, 16, True, 3, 1.5),        # no-key rows + window + softcap
    (2, 13, 13, 4, 4, 24, False, 0, 0.0),      # non-causal, ragged lengths
]


def _bwd_inputs(B, Sq, Skv, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, shape).astype(np.float32) for shape in
                 ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                  (B, Sq, H, D)))


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_flash_bwd_matches_pallas(case):
    B, Sq, Skv, H, Hkv, D, causal, window, softcap = case
    q, k, v, do = _bwd_inputs(B, Sq, Skv, H, Hkv, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    # bq = bk = 8: several q and kv blocks in every kernel
    o, lse = jax_flash.flash_attention(jq, jk, jv, bq=8, bk=8, interpret=True,
                                       return_lse=True, **kw)
    want = jax_flash.flash_attention_bwd(jq, jk, jv, o, lse, jdo, bq=8, bk=8,
                                         interpret=True, **kw)
    t = [torch.from_numpy(a) for a in (q, k, v, np.array(o),
                                       np.array(lse), do)]
    got = flash_attention.plain_bwd(*t, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        # f32 throughout: summation order only
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()) + 1e-7)
    if causal and Sq > Skv:
        dead = np.arange(Sq) + (Skv - Sq) < 0
        assert np.all(got[0].numpy()[:, dead] == 0.0)


@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_autograd_matches_jax_grad(case):
    """jax.grad through ops.attention(use_pallas=True) (interpret-mode
    forward and backward kernels) against the port's autograd Function."""
    B, Sq, Skv, H, Hkv, D, causal, window, softcap = case
    q, k, v, do = _bwd_inputs(B, Sq, Skv, H, Hkv, D, seed=1)
    kw = dict(causal=causal, window=window, softcap=softcap)

    def jloss(a, b, c):
        o = jax_ops.attention(a, b, c, use_pallas=True, bq=8, bk=8, **kw)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = ops.attention(*leaves, use_pallas=True, **kw)
    got = torch.autograd.grad(torch.sum(o * torch.from_numpy(do)), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()) + 1e-7)


def test_attention_without_pallas_grads_match_ref_attention_grads():
    q, k, v, do = _bwd_inputs(1, 9, 9, 4, 2, 16, seed=2)
    want = jax_ref.ref_attention_grads(*map(jnp.asarray, (q, k, v, do)),
                                       window=4)
    got = ref.ref_attention_grads(*map(torch.from_numpy, (q, k, v, do)),
                                  window=4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_bf16_flash_bwd_dtypes_and_interop_round_trip():
    """bf16 inputs give bf16 gradients; a bf16 tensor crosses to numpy and
    back bit for bit."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _bwd_inputs(1, 10, 10, 4, 2, 16, seed=5))
    o, lse = ref.ref_flash_attention(q, k, v, return_lse=True)
    for g in ref.ref_flash_attention_bwd(q, k, v, o, lse, do):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
    back = interop.tensor_from_numpy(interop.tensor_to_numpy(q), "cpu")
    assert back.dtype == torch.bfloat16 and torch.equal(back, q)


def test_backward_kernels_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: no plain fallback inside them."""
    for fn in (fxp_matmul.matmul_dx, fxp_matmul.matmul_dw):
        fn.launches = 0
    x = torch.ones(3, 8, dtype=torch.bfloat16)
    wq = torch.ones(5, 8, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="CUDA"):
        fxp_matmul.matmul_dx(x, wq, torch.tensor(0.5))
    with pytest.raises(RuntimeError, match="CUDA"):
        fxp_matmul.matmul_dw(x, x)
    q = torch.zeros(1, 4, 2, 8)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention.flash_attention_bwd(q, q, q, q, lse, q)
    assert fxp_matmul.matmul_dx.launches == fxp_matmul.matmul_dw.launches == 0
    assert flash_attention.flash_attention_dq.launches == 0
    assert flash_attention.flash_attention_dkv.launches == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_matmul_dx_dispatch_counters_stay_put_off_the_card(dtype):
    """``matmul_dx`` counts tensor-core launches; a CPU dy of either dtype
    (bf16 would take the tensor-core kernel, f32 the SIMT one) raises
    before any count moves, and the dense layer's backward on the CPU (its
    plain version) moves none."""
    fn = fxp_matmul.matmul_dx
    before = (fn.launches, fn.tc_launches)
    dy = torch.ones(3, 8, dtype=dtype)
    wq = torch.ones(5, 8, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(dy, wq, torch.tensor(0.5))
    x = torch.ones(3, 5, dtype=dtype, requires_grad=True)
    y = ops.fxp_dense(x, wq, torch.tensor(0.5, dtype=dtype), torch.zeros(5, 8),
                      use_pallas=True)
    y.backward(torch.ones_like(y))
    assert x.grad.shape == (3, 5)
    assert (fn.launches, fn.tc_launches) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [4, 37])
def test_fxp_matmul_and_dw_dispatch_counters_stay_put_off_the_card(dtype, m):
    """``fxp_matmul`` counts its tensor-core launches (bf16 x, M > 16) and
    its GEMV launches (M <= 16), ``matmul_dw`` its tensor-core launches
    (bf16); a CPU tensor of either dtype and either side of M = 16 raises
    before any count moves, and the dense layer on the CPU (its plain
    versions, forward and backward) moves none."""
    fns = (fxp_matmul.fxp_matmul, fxp_matmul.matmul_dw)
    counts = lambda: [(f.launches, f.tc_launches, getattr(f, "gemv_launches", 0))
                      for f in fns]
    before = counts()
    x = torch.ones(m, 5, dtype=dtype)
    wq = torch.ones(5, 8, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="CUDA"):
        fxp_matmul.fxp_matmul(x, wq, torch.tensor(0.5, dtype=dtype))
    with pytest.raises(RuntimeError, match="CUDA"):
        fxp_matmul.matmul_dw(x, torch.ones(m, 8, dtype=dtype))
    tx = x.clone().requires_grad_()
    y = ops.fxp_dense(tx, wq, torch.tensor(0.5, dtype=dtype), torch.zeros(5, 8),
                      use_pallas=True)
    y.backward(torch.ones_like(y))
    assert tx.grad.shape == (m, 5)
    assert counts() == before


@pytest.mark.parametrize("shape, offset", [((6, 16), 0), ((6, 13), 0), ((6, 16), 1)])
def test_tma_rows_pads_only_what_tma_cannot_address(shape, offset):
    """The tensor-core wrappers hand TMA rows of a multiple of 8 elements
    from a 16-byte-aligned base: ``_tma_rows`` returns such a tensor itself
    and otherwise a copy padded with zero columns, equal on the first
    columns."""
    flat = torch.arange(shape[0] * shape[1] + offset, dtype=torch.bfloat16)
    a = flat[offset:].view(shape)
    got = fxp_matmul._tma_rows(a)
    aligned = shape[1] % 8 == 0 and a.data_ptr() % 16 == 0
    assert (got is a) == aligned
    assert got.shape[1] % 8 == 0 and got.data_ptr() % 16 == 0
    assert torch.equal(got[:, :shape[1]], a)
    assert not got[:, shape[1]:].any()

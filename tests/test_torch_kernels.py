"""Port parity: the plain versions of the two CUDA kernels against the JAX
reference's Pallas kernels, run in interpret mode on the CPU.

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
from repro_torch.kernels import flash_attention, fxp_matmul, ops, ref  # noqa: E402

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |v| (8-bit significand)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _matmul_inputs(m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    if dtype == "bfloat16":       # values exact in bf16 for both packages
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    return x, wq


@pytest.mark.parametrize("m,k,n", [(7, 67, 33), (130, 257, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fxp_matmul_matches_pallas(m, k, n, dtype):
    x, wq = _matmul_inputs(m, k, n, dtype)
    jdt, tdt = DTYPES[dtype][1:]
    scale = np.float32(2.0 ** -6)
    jx = jnp.asarray(x, jdt)
    pallas = np.asarray(jax_ops.fxp_matmul(jx, jnp.asarray(wq),
                                           jnp.float32(scale), use_pallas=True),
                        np.float32)
    oracle = np.asarray(jax_ref.ref_fxp_matmul(jx, jnp.asarray(wq),
                                               jnp.float32(scale)), np.float32)
    got = ops.fxp_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(wq),
                         torch.tensor(scale), use_pallas=True).float().numpy()
    for want in (pallas, oracle):
        if dtype == "bfloat16":
            # f32 sums in another order can round to the neighbouring bf16
            # value: at most one bf16 ulp apart.
            assert np.all(np.abs(got - want) <= _bf16_ulp(
                np.maximum(np.abs(got), np.abs(want))))
        else:
            # f32 outputs: summation order only, |sum| <= 128·K·max|x|
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


def test_plain_fxp_matmul_out_dtype_f32_from_bf16():
    """bf16 x, f32 out, bf16 scale: the kernel's full type contract."""
    x, wq = _matmul_inputs(33, 100, 40, "bfloat16", seed=1)
    want = np.asarray(jax_fxp_matmul.fxp_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq),
        jnp.asarray(2.0 ** -5, jnp.bfloat16), out_dtype=jnp.float32,
        interpret=True))
    got = fxp_matmul.plain(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(wq),
                           torch.tensor(2.0 ** -5, dtype=torch.bfloat16),
                           out_dtype=torch.float32).numpy()
    assert got.dtype == np.float32
    # f32 outputs; summation order only
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


ATTN_CASES = [
    # (B, Sq, Skv, H, Hkv, D, causal, window, softcap)
    (2, 13, 13, 4, 4, 16, True, 0, 0.0),       # causal
    (2, 13, 13, 4, 4, 16, False, 0, 0.0),      # non-causal
    (1, 17, 17, 6, 3, 32, True, 0, 0.0),       # GQA rep 2
    (1, 17, 17, 6, 2, 32, True, 0, 0.0),       # GQA rep 3
    (2, 19, 19, 4, 2, 16, True, 5, 0.0),       # window
    (2, 19, 19, 4, 2, 16, True, 0, 2.0),       # softcap
    (1, 7, 20, 4, 2, 16, True, 0, 0.0),        # Sq < Skv
    (1, 20, 7, 4, 2, 16, True, 0, 0.0),        # Sq > Skv: 13 rows reach no key
    (1, 20, 7, 4, 4, 16, True, 3, 1.5),        # dead rows + window + softcap
]


def _attn_inputs(B, Sq, Skv, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, Sq, H, D)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, Hkv, D)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_flash_attention_matches_pallas(case):
    B, Sq, Skv, H, Hkv, D, causal, window, softcap = case
    q, k, v = _attn_inputs(B, Sq, Skv, H, Hkv, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    # bq = bk = 8: several q and kv blocks, so the online softmax is exercised
    want = np.asarray(jax_ops.attention(jq, jk, jv, use_pallas=True,
                                        bq=8, bk=8, **kw))
    want_o, want_lse = jax_flash.flash_attention(jq, jk, jv, bq=8, bk=8,
                                                 interpret=True,
                                                 return_lse=True, **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.attention(tq, tk, tv, use_pallas=True, **kw).numpy()
    got_o, got_lse = flash_attention.plain(tq, tk, tv, return_lse=True, **kw)
    # f32 throughout: summation order only
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=1e-5, rtol=1e-6)
    if Sq > Skv and causal:
        dead = np.arange(Sq) + (Skv - Sq) < 0
        assert np.all(got[:, dead] == 0.0)
        assert np.all(got_lse.numpy()[:, :, dead] == -1e30)


def test_plain_attention_without_pallas_is_ref_attention():
    q, k, v = _attn_inputs(1, 9, 9, 4, 2, 16)
    want = np.asarray(jax_ref.ref_attention(*map(jnp.asarray, (q, k, v))))
    got = ops.attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)   # f32 order


def test_cpu_tensors_take_plain_versions_and_kernels_refuse_them():
    fxp_matmul.fxp_matmul.launches = 0
    flash_attention.flash_attention.launches = 0
    x = torch.ones(3, 8, dtype=torch.bfloat16)
    wq = torch.ones(8, 5, dtype=torch.int8)
    y = ops.fxp_matmul(x, wq, torch.tensor(0.5, dtype=torch.bfloat16),
                       use_pallas=True)
    assert torch.equal(y, torch.full((3, 5), 4.0, dtype=torch.bfloat16))
    q = torch.zeros(1, 4, 2, 8)
    ops.attention(q, q, q, use_pallas=True)
    assert fxp_matmul.fxp_matmul.launches == 0
    assert flash_attention.flash_attention.launches == 0
    # the kernel wrappers launch or raise: no plain fallback inside them
    with pytest.raises(RuntimeError, match="CUDA"):
        fxp_matmul.fxp_matmul(x, wq, torch.tensor(0.5))
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention.flash_attention(q, q, q)

"""The three kernels only ``kernels/ops`` reaches, their plain PyTorch
versions against the JAX package's Pallas kernels in interpret mode
(``repro.kernels.ops(use_pallas=True)`` on the CPU), bit for bit:

* ``sr_quantize`` (SR grid values with the noise given): the shapes,
  dtypes and ⟨WL,FL⟩ of ``tests/test_kernels.py``, FL −3…28 and the
  pathological inputs;
* ``int8_matmul`` (W8A8): ragged and aligned ⟨M,K,N⟩ and the largest
  exact sums; the oracle twin ``ref_int8_matmul`` against the reference's
  oracle; the scales' gradients against ``jax.grad`` of
  ``int8_matmul_vjp`` within 1e-5 relative (the sum Σ dy·acc is taken in
  another order);
* ``kl_hist`` (the KL double histogram): n ∈ {100, 4096, 70000} against
  bins ∈ {50, 150, 256} and the pathological inputs; against the
  reference's jnp oracle the counts differ by exactly the elements whose
  bin the two formulas put apart (bin boundaries, and NaN bins, which the
  oracle counts in bin 0).

Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import fxp_matmul as jfm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import int8_matmul as im  # noqa: E402
from repro_torch.kernels import kl_hist as kh  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sr_quantize as sq  # noqa: E402

BF16 = jnp.bfloat16


def _rng(seed):
    return np.random.default_rng(seed)


def _torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (bf16 as ml_dtypes) → a CPU tensor of the same bits."""
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _patho(name):
    return {
        "signed_zeros": np.array([0.0, -0.0] * 320, np.float32),
        "denormals": np.array([1e-42, -3e-41, 5e-44, -1e-45] * 160,
                              np.float32),
        "inf_adjacent": np.array([3.3e38, -3.3e38, 1e30, -1e25] * 160,
                                 np.float32),
        "all_equal": np.full((640,), 0.3, np.float32),
        "all_equal_negative": np.full((640,), -1.75, np.float32),
        "mixed_extremes": np.array([0.0, -0.0, 1e-42, 3.3e38, -3.3e38,
                                    0.5, -0.5, 1.0] * 80, np.float32),
    }[name]


# ---------------------------------------------------------------------------
# sr_quantize


def _sr_pair(x: np.ndarray, u: np.ndarray, wl, fl):
    want = np.asarray(jops.sr_quantize(jnp.asarray(x), jnp.asarray(u), wl, fl,
                                       use_pallas=True))
    got = ops.sr_quantize(_torch(x), _torch(u), wl, fl, use_pallas=True)
    return _numpy(got), want


@pytest.mark.parametrize("shape", [(7,), (128,), (33, 65), (4, 3, 50),
                                   (256, 512)])
@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("wl,fl", [(8, 4), (4, 2), (16, 8), (2, 0)])
def test_sr_quantize_plain_equals_interpret_pallas(shape, dtype, wl, fl):
    rng = _rng(sum(shape) + wl)
    x = (rng.normal(0, 3, shape).astype(np.float32)).astype(dtype)
    u = rng.random(shape, dtype=np.float32)
    got, want = _sr_pair(x, u, wl, fl)
    assert got.dtype == want.dtype == x.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    # the oracle twin without use_pallas is the same function
    plain = ops.sr_quantize(_torch(x), _torch(u), wl, fl)
    np.testing.assert_array_equal(_numpy(plain).view(np.uint8),
                                  np.asarray(jref.ref_sr_quantize(
                                      jnp.asarray(x), jnp.asarray(u), wl, fl))
                                  .view(np.uint8))


@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["f32", "bf16"])
def test_sr_quantize_every_fl(dtype):
    rng = _rng(5)
    x0 = rng.normal(0, 1, (3, 700)).astype(np.float32)
    u = rng.random((3, 700), dtype=np.float32)
    for fl in range(-3, 29):
        x = (x0 * np.float32(2.0 ** (6 - fl))).astype(dtype)
        for wl in (8, 16, 32):
            got, want = _sr_pair(x, u, wl, fl)
            np.testing.assert_array_equal(got.view(np.uint8),
                                          want.view(np.uint8),
                                          err_msg=f"<{wl},{fl}>")


@pytest.mark.parametrize("case", ["signed_zeros", "denormals",
                                  "inf_adjacent", "all_equal",
                                  "all_equal_negative", "mixed_extremes"])
def test_sr_quantize_pathological(case):
    """Bit for bit, but for one difference of arithmetic: XLA's CPU code
    reads a subnormal x as zero and flushes a subnormal product s = x·2^fl
    to zero, the port (and the CUDA kernel) keep both, so where x or s is
    a positive subnormal and u < s (u = 0 here) the reference rounds down
    to 0 and the port up to one step 2^-fl. Those elements, and no other,
    differ; there the port's value is the IEEE one."""
    x = _patho(case)
    u = _rng(9).random(x.shape, dtype=np.float32)
    u[::7] = 0.0
    for wl, fl in ((8, 0), (8, 4), (16, 12), (32, 20)):
        got, want = _sr_pair(x, u, wl, fl)
        s = x.astype(np.float32) * np.float32(2.0 ** fl)
        tiny = np.finfo(np.float32).tiny
        flushed = (((x > 0) & (x < tiny)) | ((s > 0) & (s < tiny))) & (u < s)
        np.testing.assert_array_equal(got.view(np.uint32)[~flushed],
                                      want.view(np.uint32)[~flushed],
                                      err_msg=f"<{wl},{fl}>")
        np.testing.assert_array_equal(want[flushed], 0.0)
        np.testing.assert_array_equal(got[flushed], np.float32(2.0 ** -fl))
        if case == "denormals" and fl == 0:
            assert flushed.any()


def test_sr_quantize_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.zeros(2, 8)
    n0 = sq.sr_quantize.launches
    assert sq.sr_quantize(x, torch.zeros(2, 8), 8, 4).shape == (2, 8)
    assert sq.sr_quantize.launches == n0
    meta = torch.zeros(4, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        sq.sr_quantize(meta, meta, 8, 4)


# ---------------------------------------------------------------------------
# int8_matmul


def _words(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (128, 256, 128),
                                   (48, 72, 36), (509, 1031, 127)])
def test_int8_matmul_plain_equals_interpret_pallas(m, k, n):
    rng = _rng(m + k + n)
    xq, wq = _words(rng, (m, k)), _words(rng, (k, n))
    sx, sw = np.float32(0.02), np.float32(0.3)
    want = np.asarray(jops.int8_matmul(jnp.asarray(xq), jnp.asarray(wq),
                                       jnp.float32(sx), jnp.float32(sw),
                                       use_pallas=True))
    got = ops.int8_matmul(_torch(xq), _torch(wq), torch.tensor(sx),
                          torch.tensor(sw), use_pallas=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel's plain version: f32(acc)·s with s = f32(sx)·f32(sw)
    s = torch.tensor(sx) * torch.tensor(sw)
    np.testing.assert_array_equal(im.int8_matmul(_torch(xq), _torch(wq),
                                                 s).numpy(), want)
    # the oracle twin (acc·sx·sw, two roundings) against the reference's
    oracle = np.asarray(jref.ref_int8_matmul(jnp.asarray(xq), jnp.asarray(wq),
                                             jnp.float32(sx), jnp.float32(sw)))
    np.testing.assert_array_equal(
        ops.int8_matmul(_torch(xq), _torch(wq), torch.tensor(sx),
                        torch.tensor(sw)).numpy(), oracle)


@pytest.mark.parametrize("word", [127, -128])
def test_int8_matmul_largest_sums_are_exact(word):
    xq = np.full((8, 1024), word, np.int8)
    wq = np.full((1024, 8), 127 if word == 127 else -128, np.int8)
    want = np.asarray(jops.int8_matmul(jnp.asarray(xq), jnp.asarray(wq),
                                       jnp.float32(1.0), jnp.float32(1.0),
                                       use_pallas=True))
    got = ops.int8_matmul(_torch(xq), _torch(wq), 1.0, 1.0, use_pallas=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[0, 0]) == float(word) * float(wq[0, 0]) * 1024


def test_int8_matmul_sum_rounds_once_to_f32():
    """127·127·8192 = 132 128 768 is not an f32: both round the int32 sum
    to nearest even (132 128 768 → 132 128 768 ± the f32 spacing of 8)."""
    xq = np.full((4, 8192), 127, np.int8)
    wq = np.full((8192, 4), 127, np.int8)
    acc = ref.ref_int8_matmul_kernel(_torch(xq), _torch(wq),
                                     torch.tensor(1.0))
    assert float(acc[0, 0]) == float(np.float32(127 * 127 * 8192))


@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (37, 100, 21)])
def test_int8_matmul_scale_grads_match_jax(m, k, n):
    rng = _rng(k)
    xq, wq = _words(rng, (m, k)), _words(rng, (k, n))
    dy = rng.normal(0, 1, (m, n)).astype(np.float32)
    sx, sw = np.float32(0.02), np.float32(0.3)

    def f(a, b):
        return jnp.sum(jfm.int8_matmul_vjp(jnp.asarray(xq), jnp.asarray(wq),
                                           a, b, interpret=True)
                       * jnp.asarray(dy))

    want = jax.grad(f, argnums=(0, 1))(jnp.float32(sx), jnp.float32(sw))
    tsx = torch.tensor(sx, requires_grad=True)
    tsw = torch.tensor(sw, requires_grad=True)
    out = ops.int8_matmul(_torch(xq), _torch(wq), tsx, tsw, use_pallas=True)
    got = torch.autograd.grad(out, (tsx, tsw), torch.from_numpy(dy))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    # a bf16 scale gets its gradient in bf16
    bsx = torch.tensor(0.25, dtype=torch.bfloat16, requires_grad=True)
    out = ops.int8_matmul(_torch(xq), _torch(wq), bsx, tsw, use_pallas=True)
    (g,) = torch.autograd.grad(out, (bsx,), torch.from_numpy(dy))
    assert g.dtype == torch.bfloat16


def test_int8_matmul_wrapper_takes_the_plain_version_on_the_cpu():
    xq = torch.ones(3, 5, dtype=torch.int8)
    wq = torch.ones(5, 2, dtype=torch.int8)
    n0 = im.int8_matmul.launches
    out = im.int8_matmul(xq, wq, torch.tensor(0.5))
    assert torch.equal(out, torch.full((3, 2), 2.5))
    assert im.int8_matmul.launches == n0
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        im.int8_matmul(xq.to("meta"), wq.to("meta"), torch.tensor(1.0))


# ---------------------------------------------------------------------------
# kl_hist


def _kl_pair(w: np.ndarray, q: np.ndarray, bins: int):
    want = np.asarray(jops.kl_hist(jnp.asarray(w), jnp.asarray(q), bins,
                                   use_pallas=True))
    got = ops.kl_hist(_torch(w), _torch(q), bins, use_pallas=True)
    return got.numpy(), want


def _oracle_minus_kernel(w: np.ndarray, q: np.ndarray, bins: int):
    """The oracle's counts minus the kernel's, from the elements whose bins
    the two formulas put apart: a kernel bin that is NaN counts nowhere,
    an oracle bin that is NaN counts in bin 0."""
    wt, qt = torch.from_numpy(w), torch.from_numpy(q)
    lo, hi = torch.aminmax(wt)
    span = torch.clamp(hi - lo, min=1e-12)
    diff = np.zeros((2, bins), np.float32)
    moved = 0
    for row, x in enumerate((wt, qt)):
        kern = ref.kl_bins(x, lo, hi, bins)
        orc = torch.floor((x - lo) / span * bins).clamp(0, bins - 1)
        orc = torch.where(torch.isnan(orc), 0.0, orc)
        apart = ~(kern == orc)
        moved += int(apart.sum())
        for b in kern[apart & ~torch.isnan(kern)].long().tolist():
            diff[row, b] -= 1
        for b in orc[apart].long().tolist():
            diff[row, b] += 1
    return diff, moved


@pytest.mark.parametrize("n", [100, 4096, 70000])
@pytest.mark.parametrize("bins", [50, 150, 256])
def test_kl_hist_plain_equals_interpret_pallas(n, bins):
    rng = _rng(n + bins)
    w = rng.normal(0, 1, n).astype(np.float32)
    q = (np.round(w * 8) / 8).astype(np.float32)
    got, want = _kl_pair(w, q, bins)
    assert got.dtype == np.float32 and got.shape == (2, bins)
    np.testing.assert_array_equal(got, want)
    assert got[0].sum() == n and got[1].sum() == n
    # against the jnp oracle: exactly the elements the formulas put apart
    oracle = np.asarray(jref.ref_kl_hist(jnp.asarray(w), jnp.asarray(q),
                                         bins))
    np.testing.assert_array_equal(
        ops.kl_hist(_torch(w), _torch(q), bins).numpy(), oracle)
    diff, _ = _oracle_minus_kernel(w, q, bins)
    np.testing.assert_array_equal(oracle - got, diff)


def test_kl_hist_boundary_elements_differ_from_the_oracle():
    """Elements at bin boundaries, where dividing by the span and
    multiplying by its inverse round to different sides of an integer:
    the kernel's formula (and the Pallas kernel) and the oracle put them
    one bin apart; the counts differ by exactly those elements."""
    bins = 150
    lo, hi = np.float32(-1.3), np.float32(2.9)
    grid = lo + (hi - lo) * np.arange(bins + 1, dtype=np.float32) / bins
    near = np.concatenate([np.nextafter(grid, np.float32(-9)), grid,
                           np.nextafter(grid, np.float32(9))])
    w = np.clip(np.concatenate([near, [lo, hi]]), lo, hi).astype(np.float32)
    q = w[::-1].copy()
    got, want = _kl_pair(w, q, bins)
    np.testing.assert_array_equal(got, want)
    oracle = np.asarray(jref.ref_kl_hist(jnp.asarray(w), jnp.asarray(q), bins))
    diff, apart = _oracle_minus_kernel(w, q, bins)
    np.testing.assert_array_equal(oracle - got, diff)
    assert apart > 0 and not np.array_equal(oracle, got)


@pytest.mark.parametrize("case", ["signed_zeros", "denormals",
                                  "inf_adjacent", "all_equal",
                                  "all_equal_negative", "mixed_extremes"])
@pytest.mark.parametrize("bins", [50, 256])
def test_kl_hist_pathological(case, bins):
    w = _patho(case)
    q = (np.round(w.astype(np.float64) * 8) / 8).astype(np.float32)
    got, want = _kl_pair(w, q, bins)
    np.testing.assert_array_equal(got, want)
    oracle = np.asarray(jref.ref_kl_hist(jnp.asarray(w), jnp.asarray(q), bins))
    np.testing.assert_array_equal(
        ops.kl_hist(_torch(w), _torch(q), bins).numpy(), oracle)
    diff, _ = _oracle_minus_kernel(w, q, bins)
    np.testing.assert_array_equal(oracle - got, diff)
    if case in ("inf_adjacent", "mixed_extremes"):
        # max − min overflows to inf: bins that are NaN count nowhere in
        # the kernel, in bin 0 in the oracle
        assert got.sum() < 2 * w.size and oracle.sum() == 2 * w.size


def test_kl_hist_wrapper_takes_the_plain_version_on_the_cpu():
    w = torch.linspace(-1, 1, 64)
    n0 = kh.kl_hist.launches
    out = kh.kl_hist(w, w, 16)
    assert out.shape == (2, 16) and float(out.sum()) == 128
    assert kh.kl_hist.launches == n0
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        kh.kl_hist(w.to("meta"), w.to("meta"), 16)

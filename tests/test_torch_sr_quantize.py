"""The port's SR int8 words (the plain versions of its CUDA kernels) bit for
bit against the JAX package's fused kernels in interpret mode
(``repro.kernels.ops.sr_quantize_fused_int8(use_pallas=True)``, the
portable stream): flat and stacked leaves, a stack of one layer equal to
the flat leaf, ragged sizes, negative and large seeds, FL −3…28 and the
pathological values of ``tests/test_quantize_differential.py``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, sr_quantize as sq  # noqa: E402

SEEDS = [23, -5, 2 ** 31 - 1, -2 ** 31, 123456789]


def _x(shape, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def _want(x, seed, fl):
    return np.asarray(jops.sr_quantize_fused_int8(
        jnp.asarray(x), jnp.int32(seed), jnp.asarray(fl, jnp.int32),
        use_pallas=True))


def _got(x, seed, fl):
    return ops.sr_quantize_fused_int8(
        torch.from_numpy(x), seed, torch.tensor(fl, dtype=torch.int32),
        use_pallas=True).numpy()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (127,), (511,), (512,), (513,),
                                   (2, 513), (129, 3), (3, 5, 7), (64, 48)])
def test_flat_words_bit_equal(shape, seed):
    x = _x(shape, len(shape) + shape[-1])
    for fl in (0, 4, 10):
        got = _got(x, seed, fl)
        assert got.dtype == np.int8 and got.shape == shape
        np.testing.assert_array_equal(got, _want(x, seed, fl),
                                      err_msg=f"fl {fl}")


@pytest.mark.parametrize("fl", list(range(-3, 29)))
def test_every_fl_bit_equal(fl):
    """Values from 2^-fl-ish up to clipping at every FL the int8 words
    can take, flat and as one layer of a stack."""
    x = _x((3, 700), fl + 100, scale=2.0 ** (6 - fl))
    np.testing.assert_array_equal(_got(x[0], -77, fl), _want(x[0], -77, fl))
    fls = np.array([fl, 0, 28], np.int32)
    np.testing.assert_array_equal(_got(x, 9, fls), _want(x, 9, fls))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("trail", [(1,), (513,), (127, 3), (5, 7, 11),
                                   (64, 48)])
@pytest.mark.parametrize("L", [1, 3, 7])
def test_stacked_words_bit_equal(L, trail, seed):
    x = _x((L,) + trail, L * 31 + sum(trail))
    fls = np.array([0, 10, 28, -3, 4, 7, 2][:L], np.int32)
    got = _got(x, seed, fls)
    assert got.shape == x.shape
    np.testing.assert_array_equal(got, _want(x, seed, fls))
    if L == 1:
        # one layer of a stack is the flat leaf
        np.testing.assert_array_equal(got[0], _got(x[0], seed, int(fls[0])))


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


@pytest.mark.parametrize("fl", [0, 4, 12])
@pytest.mark.parametrize("case", ["signed_zeros", "denormals",
                                  "inf_adjacent", "all_equal",
                                  "all_equal_negative", "mixed_extremes"])
def test_pathological_bit_equal(case, fl):
    x = _patho(case)
    np.testing.assert_array_equal(_got(x, 31, fl), _want(x, 31, fl))
    xs = np.stack([x, -x])
    fls = np.array([fl, 28 - fl], np.int32)
    np.testing.assert_array_equal(_got(xs, -31, fls), _want(xs, -31, fls))


def test_dispatch_and_raises():
    x = torch.from_numpy(_x((2, 8), 0))
    # without use_pallas: the reference's jax.random oracle
    # (tests/test_torch_noise_sr.py holds it bit for bit)
    assert ops.sr_quantize_fused_int8(x, 1, 4).dtype == torch.int8
    # a CPU tensor takes the plain version and counts no launch
    n0 = (sq.sr_quantize_fused_int8.launches,
          sq.sr_quantize_fused_stacked_int8.launches)
    ops.sr_quantize_fused_int8(x, 1, 4, use_pallas=True)
    ops.sr_quantize_fused_int8(x, 1, torch.tensor([4, 5], dtype=torch.int32),
                               use_pallas=True)
    assert (sq.sr_quantize_fused_int8.launches,
            sq.sr_quantize_fused_stacked_int8.launches) == n0


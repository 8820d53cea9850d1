"""The port's plain-PyTorch Threefry stream (``repro_torch/core/threefry.py``)
against jax on the CPU, bit for bit: the hash on random counter pairs, the
key of a seed, ``fold_in`` chains, and ``uniform`` for 1-D, 2-D and stacked
(L, K, N) shapes, whole and drawn in chunks at an offset. The port mirrors
the stream of ``jax_threefry_partitionable=True``, jax 0.9's default.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax._src import prng as jax_prng  # noqa: E402

from repro_torch.core import fixed_point as fxp  # noqa: E402
from repro_torch.core import threefry  # noqa: E402

SEEDS = [0, 1, 2 ** 31 - 1, -5]


def _key(seed):
    """The raw uint32 words of ``jax.random.PRNGKey(seed)`` as ints."""
    k = np.asarray(jax.random.PRNGKey(seed))
    return int(k[0]), int(k[1])


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_the_stream_is_the_partitionable_one():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("hi_zero", [True, False], ids=["hi0", "hi"])
def test_threefry2x32_matches_jax(hi_zero):
    rng = np.random.default_rng(1 + hi_zero)
    x1 = rng.integers(0, 2 ** 32, 4097, dtype=np.uint64).astype(np.uint32)
    if hi_zero:
        x1[:] = 0
    x2 = rng.integers(0, 2 ** 32, 4097, dtype=np.uint64).astype(np.uint32)
    for k1, k2 in ((0, 0), (0x12345678, 0x9ABCDEF0), (2 ** 32 - 1, 7)):
        want = jax_prng.threefry_2x32(
            (jnp.uint32(k1), jnp.uint32(k2)),
            jnp.concatenate([jnp.asarray(x1), jnp.asarray(x2)]))
        o1, o2 = threefry.threefry2x32(
            k1, k2, torch.from_numpy(x1.astype(np.int64)),
            torch.from_numpy(x2.astype(np.int64)))
        got = np.concatenate([o1.numpy(), o2.numpy()])
        np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_from_seed(seed):
    assert threefry.key_from_seed(seed) == _key(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_chains(seed):
    jkey, key = jax.random.PRNGKey(seed), threefry.key_from_seed(seed)
    for data in (0, 3, 2 ** 31 - 1, 12345, 1):
        jkey = jax.random.fold_in(jkey, data)
        key = threefry.fold_in(key, data)
        assert key == tuple(int(v) for v in np.asarray(jkey))


@pytest.mark.parametrize("shape", [(1,), (7,), (1001,), (33, 65), (4, 17, 9),
                                   (3, 64, 96)])
@pytest.mark.parametrize("seed", [0, -5])
def test_uniform_matches_jax(shape, seed):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    key = threefry.fold_in(threefry.key_from_seed(seed), 11)
    want = jax.random.uniform(jkey, shape, jnp.float32)
    got = threefry.uniform(key, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the noise of the reference's fixed_point.uniform_noise_like
    x = torch.zeros(shape)
    np.testing.assert_array_equal(
        _bits(fxp.uniform_noise_like(key, x).numpy()), _bits(want))


@pytest.mark.parametrize("chunk", [1, 100, 4096, 5000])
def test_chunks_at_an_offset_are_slices_of_the_whole(chunk):
    shape = (5, 31, 37)
    key = (123456789, 987654321)
    whole = threefry.uniform(key, shape).reshape(-1)
    total = whole.numel()
    parts = [threefry.uniform(key, shape, offset=s, count=c)
             for s, c in threefry.chunks(total, chunk)]
    assert sum(p.numel() for p in parts) == total
    np.testing.assert_array_equal(torch.cat(parts).numpy(), whole.numpy())
    # one layer of the stack at its flat offset
    n = 31 * 37
    np.testing.assert_array_equal(
        threefry.uniform(key, shape, offset=2 * n, count=n).numpy(),
        whole[2 * n:3 * n].numpy())
    with pytest.raises(ValueError, match="outside"):
        threefry.uniform(key, shape, offset=total - 1, count=2)


def test_counters_past_two_to_the_32():
    """Element i takes the counter pair (i >> 32, i mod 2^32): an index of
    2^32 or more moves the high word, as jax's iota_2x32_shape does."""
    key = (1, 2)
    i = torch.tensor([0, 1, 2 ** 32, 2 ** 32 + 1, 3 * 2 ** 32 + 5])
    o1, o2 = threefry.threefry2x32(*key, i >> 32, i & 0xFFFFFFFF)
    want = jax_prng.threefry2x32_p.bind(
        jnp.uint32(1), jnp.uint32(2),
        jnp.asarray((i >> 32).numpy().astype(np.uint32)),
        jnp.asarray((i & 0xFFFFFFFF).numpy().astype(np.uint32)))
    np.testing.assert_array_equal(o1.numpy(), np.asarray(want[0]).astype(np.int64))
    np.testing.assert_array_equal(o2.numpy(), np.asarray(want[1]).astype(np.int64))
    assert not torch.equal(o1[2], o1[0])

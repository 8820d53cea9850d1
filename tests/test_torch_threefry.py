"""The port's plain-PyTorch Threefry stream (``repro_torch/core/threefry.py``)
against jax on the CPU, bit for bit: the hash on random counter pairs, the
key of a seed, ``fold_in`` chains, and ``uniform`` for 1-D, 2-D and stacked
(L, K, N) shapes, whole and drawn in chunks at an offset; ``split``, raw
32-bit ``random_bits`` and int32 ``randint`` over many seeds and folds;
``categorical`` (gumbel-max) equal to jax's draw except where jax's own
top two perturbed scores lie within 2 f32 ulps (jax's XLA ``log`` and
torch's differ in the last ulp; the test detects and states such a tie).
The port mirrors the stream of ``jax_threefry_partitionable=True``, jax
0.9's default.
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


def _keys():
    """(jax key, port key) pairs over seeds and chains of folds."""
    for seed in SEEDS + [7, 123456]:
        jkey, key = jax.random.PRNGKey(seed), threefry.key_from_seed(seed)
        for data in (0, 5, 2 ** 31 - 1):
            jkey = jax.random.fold_in(jkey, data)
            key = threefry.fold_in(key, data)
            yield jkey, key


@pytest.mark.parametrize("num", [2, 3, 8])
def test_split_matches_jax(num):
    for jkey, key in _keys():
        want = np.asarray(jax.random.split(jkey, num)).astype(np.int64)
        assert threefry.split(key, num) == [tuple(r) for r in want.tolist()]


@pytest.mark.parametrize("shape", [(), (1,), (9,), (5, 33)])
def test_random_bits_match_jax(shape):
    for jkey, key in _keys():
        want = np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
        got = threefry.random_bits(key, shape)
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("bounds", [(0, 2 ** 31 - 1), (-5, 17), (3, 3),
                                    (9, 2), (-2 ** 31, 2 ** 31 - 1),
                                    (0, 1000), (-100, 2 ** 16 + 7)])
@pytest.mark.parametrize("shape", [(), (13,), (4, 6)])
def test_randint_matches_jax(bounds, shape):
    lo, hi = bounds
    for jkey, key in _keys():
        want = np.asarray(jax.random.randint(jkey, shape, lo, hi, jnp.int32))
        got = threefry.randint(key, shape, lo, hi)
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _ulps_apart(a: float, b: float) -> int:
    ia, ib = (int(np.float32(v).view(np.int32)) for v in (a, b))
    return abs(ia - ib)


@pytest.mark.parametrize("vocab", [2, 50, 4096])
def test_categorical_matches_jax(vocab):
    rng = np.random.default_rng(vocab)
    ties = 0
    for jkey, key in _keys():
        logits = (rng.standard_normal((3, vocab)) * 3).astype(np.float32)
        want = np.asarray(jax.random.categorical(jkey, jnp.asarray(logits),
                                                 axis=-1))
        got = threefry.categorical(key, torch.from_numpy(logits)).numpy()
        scores = np.asarray(jax.random.gumbel(jkey, logits.shape)) + logits
        for b in range(logits.shape[0]):
            top2 = np.sort(scores[b])[-2:]
            if _ulps_apart(top2[0], top2[1]) <= 2:
                ties += 1           # a near tie: the ulp of log may decide
                continue
            assert got[b] == want[b], (b, got[b], want[b])
    assert ties <= 1, f"{ties} near ties"


def test_gumbel_is_jax_within_the_ulp_of_log():
    """jax's XLA ``log`` on the CPU is not correctly rounded and torch's
    is, so single gumbel values may differ in the last ulps; they are the
    same draws otherwise."""
    for jkey, key in _keys():
        want = np.asarray(jax.random.gumbel(jkey, (64, 33)))
        got = threefry.gumbel(key, (64, 33)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)

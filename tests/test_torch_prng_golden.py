"""The port's portable SR noise stream against the pinned golden file, with
no JAX: ``uniform_from_index``, ``fold_shard_seed`` and the words the
plain SR quantize versions draw must reproduce
``tests/golden/sr_prng_stream.json`` bit for bit (the reference's
``tests/test_prng_golden.py`` pins the same file for the JAX package).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fixed_point as fxp  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import sr_quantize as sq  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "sr_prng_stream.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _x() -> torch.Tensor:
    """sin(0..39)·4 in f32, the golden file's input."""
    return torch.from_numpy(
        (np.sin(np.arange(40, dtype=np.float32)) * np.float32(4.0))
        .astype(np.float32))


def test_uniform_from_index_pinned(golden):
    want = np.asarray(golden["hash_u24_seed7_first32"], np.int64)
    u = sq.uniform_from_index(7, torch.arange(32))
    assert u.dtype == torch.float32
    np.testing.assert_array_equal((u * (1 << 24)).long().numpy(), want)
    # the plain stream of the kernels is the same function of the index
    np.testing.assert_array_equal(
        (ref.ref_fused_noise(7, 32) * (1 << 24)).long().numpy(), want)
    # an offset shifts the index; the index wraps mod 2^32
    np.testing.assert_array_equal(ref.ref_fused_noise(7, 8, offset=24),
                                  u[24:].numpy())
    np.testing.assert_array_equal(
        sq.uniform_from_index(7, torch.arange(4) + 2 ** 32).numpy(),
        u[:4].numpy())


def test_fold_shard_seed_pinned(golden):
    want = golden["fold_shard_seed123_idx0_7"]
    assert [int(sq.fold_shard_seed(123, i)) for i in range(8)] == want
    got = sq.fold_shard_seed(torch.tensor(123), torch.arange(8))
    assert got.dtype == torch.int32 and got.tolist() == want
    # an int32 seed is its uint32 bit pattern: -1 and 2^32 - 1 agree
    assert int(sq.fold_shard_seed(-1, 5)) == int(sq.fold_shard_seed(
        2 ** 32 - 1, 5))


def test_fused_words_pinned(golden):
    """The float-container words at ⟨8, 4⟩: |x·16| <= 65, so the int8
    words are the same integers."""
    got = sq.plain(_x(), 42, torch.tensor(4, dtype=torch.int32))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(),
                                  golden["fused_words_seed42_wl8_fl4"])
    # the port's quantize with the same noise gives them on the grid
    u = ref.ref_fused_noise(42, 40)
    q = fxp.quantize(_x(), 8, 4, u=u) * 16.0
    np.testing.assert_array_equal(q.numpy(),
                                  golden["fused_words_seed42_wl8_fl4"])


def test_int8_words_pinned(golden):
    got = sq.plain(_x(), 11, torch.tensor(4, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), golden["int8_words_seed11_fl4"])


def test_stacked_words_pinned(golden):
    """Layers x, −x, x/2 at ⟨5,2⟩, ⟨9,5⟩, ⟨13,9⟩: the golden words are
    clipped to each layer's WL, the int8 words to [−128, 127]. Layer 0's
    raw words lie in ±17, layers 1 and 2 reach ±129 and ±1025 inside their
    WL, so clip(int8 words, WL) of layer 0 and the int8 words of layers 1
    and 2 must equal the golden words under those clips."""
    x = _x()
    xs = torch.stack([x, -x, x * 0.5])
    fl = torch.tensor([2, 5, 9], dtype=torch.int32)
    want = np.asarray(golden["stacked_words_seed42_wl_5_9_13_fl_2_5_9"])
    got = sq.plain_stacked(xs, 42, fl).numpy().astype(np.int64)
    np.testing.assert_array_equal(np.clip(got[0], -16, 15), want[0])
    np.testing.assert_array_equal(got[1:], np.clip(want[1:], -128, 127))
    # the float-container words from the same stream, layer by layer at
    # the padded plane's offsets (rows = 1: 512 elements apart)
    for l, (wl, f) in enumerate(((5, 2), (9, 5), (13, 9))):
        u = ref.ref_fused_noise(42, 40, offset=l * 512)
        q = fxp.quantize(xs[l], wl, f, u=u) * float(2 ** f)
        np.testing.assert_array_equal(q.numpy(), want[l])

"""The ``jax.random`` stream of the reference's default quantizer, in plain
PyTorch (no kernel).

The reference's SR noise without the fused kernels is
``jax.random.uniform(key, shape, float32)`` (``fixed_point.py:111``), keyed
per leaf by ``fold_in(step key, path hash)`` (``controller.py:230-235``)
from the step key ``fold_in(PRNGKey(run seed), step)``
(``train/train_loop.py:127``). jax computes it in XLA, outside any Pallas
kernel, with the Threefry-2x32 hash (20 rounds) under
``jax_threefry_partitionable=True``, the default of jax 0.9:

* ``key_from_seed(seed)``: the key (0, seed mod 2^32) of an int32 seed
  (``threefry_seed``, ``jax/_src/prng.py:802-827``);
* ``fold_in(key, data)``: threefry2x32(key, (0, data mod 2^32));
* ``uniform(key, shape)``: element i of the flat shape hashes the counter
  pair (i >> 32, i mod 2^32) to (o1, o2); its bits are o1 ^ o2 and its
  value bitcast((bits >> 9) | 0x3F800000) − 1, at least 0
  (``_threefry_random_bits_partitionable``, prng.py:1184-1200;
  ``_uniform``, random.py:435-475).

Because every element depends only on its own index, ``uniform`` draws any
flat range [offset, offset + count) of a shape by itself: a quantizer
draws one layer or one slice of rows at a time and never holds the noise
of a whole leaf. torch has no uint32 arithmetic on the CPU, so the 32-bit
words live in int64 tensors and are masked to 32 bits where a rotation or
the result needs it, as ``kernels/ref.py`` does for the portable hash:
about 140 elementwise passes over a chunk's int64 words. A key is a pair
of Python ints, each in [0, 2^32).
"""
from __future__ import annotations

import math
from typing import Iterator, Sequence, Tuple

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _as_words(v, device) -> torch.Tensor:
    t = torch.as_tensor(v, device=device)
    return t.to(torch.int64).bitwise_and(_M32)


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds of the counter words (x1, x2) under the
    key (k1, k2), as jax's ``_threefry2x32_lowering``. Ints or int tensors
    (broadcast), each taken mod 2^32; returns two int64 tensors of words in
    [0, 2^32)."""
    device = x1.device if isinstance(x1, torch.Tensor) else None
    k1, k2 = int(k1) & _M32, int(k2) & _M32
    a, b = torch.broadcast_tensors(_as_words(x1, device),
                                   _as_words(x2, device))
    return _rounds(k1, k2, a.clone(), b.clone())


def _rounds(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20 rounds, in place on the int64 words x0 and x1. x1 is masked
    to 32 bits after every round (it is rotated); x0 is only added to and
    XORed into x1, so it is masked once at the end (it stays below 2^37)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    tmp = torch.empty_like(x1)
    x0.add_(ks[0])
    x1.add_(ks[1]).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            torch.bitwise_left_shift(x1, r, out=tmp)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(tmp)
            x1.bitwise_xor_(x0).bitwise_and_(_M32)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0.bitwise_and_(_M32), x1


def key_from_seed(seed) -> Key:
    """``jax.random.PRNGKey(seed)`` of an int32 seed: (0, seed mod 2^32),
    so a negative seed gives 2^32 + seed."""
    return 0, int(seed) & _M32


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    (0, data mod 2^32) under ``key``."""
    o1, o2 = threefry2x32(key[0], key[1], torch.zeros((), dtype=torch.int64),
                          int(data) & _M32)
    return int(o1), int(o2)


def uniform(key: Key, shape: Sequence[int], *, offset: int = 0,
            count: int | None = None, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1), or the flat
    elements [offset, offset + count) of it (a 1-D tensor) when ``count``
    is given: element i takes the counter pair (i >> 32, i mod 2^32)."""
    total = math.prod(shape)
    n = total - offset if count is None else int(count)
    if offset < 0 or n < 0 or offset + n > total:
        raise ValueError(f"elements [{offset}, {offset + n}) outside a shape "
                         f"of {total}")
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    x0 = idx >> 32
    x1 = idx.bitwise_and_(_M32)
    o1, o2 = _rounds(int(key[0]) & _M32, int(key[1]) & _M32, x0, x1)
    bits = o1.bitwise_xor_(o2).bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    u = u.clamp_(min=0.0)
    return u if count is not None else u.reshape(tuple(shape))


def chunks(total: int, size: int) -> Iterator[Tuple[int, int]]:
    """(start, count) of consecutive ranges of at most ``size`` covering
    [0, total)."""
    for start in range(0, total, size):
        yield start, min(size, total - start)

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

The rest of ``jax.random`` that the port replays, all under the same
partitionable Threefry:

* ``split(key, num)``: key i is the hash of the counter pair (0, i)
  (``_threefry_split_foldlike``, prng.py:1156-1161);
* ``random_bits(key, shape)``: the 32-bit words o1 ^ o2 of the counters
  (i >> 32, i mod 2^32) (``_threefry_random_bits_partitionable``);
* ``randint(key, shape, minval, maxval)``: jax's int32 ``_randint``
  (random.py:581-657): split the key, draw higher and lower bits from the
  two halves, and map them into [minval, maxval) by uint32 modular
  arithmetic, wrap-arounds included;
* ``gumbel``/``categorical``: mode "low", the default,
  -log(-log(uniform(key, shape, minval=tiny, maxval=1))), and the argmax
  of gumbel + logits (random.py:1723-1800).

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
from typing import Iterator, List, Sequence, Tuple

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
    (broadcast, keys too: one key per element), each taken mod 2^32;
    returns two int64 tensors of words in [0, 2^32)."""
    device = next((t.device for t in (x1, x2, k1, k2)
                   if isinstance(t, torch.Tensor)), None)
    if isinstance(k1, torch.Tensor) or isinstance(k2, torch.Tensor):
        k1, k2 = _as_words(k1, device), _as_words(k2, device)
    else:
        k1, k2 = int(k1) & _M32, int(k2) & _M32
    a, b = torch.broadcast_tensors(_as_words(x1, device),
                                   _as_words(x2, device))
    if isinstance(k1, torch.Tensor):
        a, b, k1, k2 = torch.broadcast_tensors(a, b, k1, k2)
    return _rounds(k1, k2, a.clone(), b.clone())


def _rounds(k1, k2, x0: torch.Tensor, x1: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20 rounds, in place on the int64 words x0 and x1, under the key
    words k1, k2 (ints, or int64 tensors of x0's shape). x1 is masked to 32
    bits after every round (it is rotated); x0 is only added to and XORed
    into x1, so it is masked once at the end (it stays below 2^37)."""
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


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)``: key i hashes the counter pair
    (0, i)."""
    o1, o2 = threefry2x32(key[0], key[1], torch.zeros(num, dtype=torch.int64),
                          torch.arange(num, dtype=torch.int64))
    return list(zip(o1.tolist(), o2.tolist()))


def random_bits(key: Key, shape: Sequence[int], *, device=None
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: element i of the flat shape
    is o1 ^ o2 of the counter pair (i >> 32, i mod 2^32), as int64 words
    in [0, 2^32)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    o1, o2 = _rounds(int(key[0]) & _M32, int(key[1]) & _M32, idx >> 32,
                     idx.bitwise_and(_M32))
    return o1.bitwise_xor_(o2).reshape(tuple(shape))


def randint_words(higher: torch.Tensor, lower: torch.Tensor, minval: int,
                  maxval: int) -> torch.Tensor:
    """jax's int32 ``_randint`` from its two draws of 32-bit words: the span
    maxval − minval as a uint32 (1 when maxval <= minval), the multiplier
    (2^16 mod span)^2 mod span with the uint32 product wrapping, then
    minval + (((higher mod span)·multiplier + lower mod span) mod 2^32) mod
    span, as int32 (int64 tensor)."""
    lo, hi = -2 ** 31, 2 ** 31 - 1
    minval, out_of_range = min(max(int(minval), lo), hi), int(maxval) > hi
    maxval = min(max(int(maxval), lo), hi)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    if out_of_range and maxval > minval:
        span = (span + 1) & _M32
    if span == 0:       # the whole uint32 range: XLA's x mod 0 is x
        offset = lower.clone()
    else:
        mult = ((2 ** 16 % span) * (2 ** 16 % span)) & _M32
        mult %= span
        offset = (((higher % span) * mult).bitwise_and_(_M32)
                  + lower % span).bitwise_and_(_M32) % span
    out = (offset + minval).bitwise_and_(_M32)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out)


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int, *,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` for int
    bounds, as an int64 tensor of int32 values."""
    k1, k2 = split(key)
    return randint_words(random_bits(k1, shape, device=device),
                         random_bits(k2, shape, device=device), minval, maxval)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """The f32 in [0, 1) of 32-bit words: bitcast((bits >> 9) | 1.0) − 1."""
    f = bits.bitwise_right_shift(9).bitwise_or_(0x3F800000)
    return f.to(torch.int32).view(torch.float32) - 1.0


def gumbel(key: Key, shape: Sequence[int], *, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in mode "low":
    -log(-log(u)) of u = uniform(key, shape, minval=tiny, maxval=1), whose
    affine map f·(1 − tiny) + tiny and floor at tiny are taken in f32."""
    tiny = torch.tensor(torch.finfo(torch.float32).tiny, device=device)
    u = _unit_floats(random_bits(key, shape, device=device))
    u = torch.maximum(tiny, u * (1.0 - tiny) + tiny)
    return -torch.log(-torch.log(u))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the argmax over the
    last axis of gumbel(key, logits.shape) + logits (f32 logits), the
    first index on a tie, as int64."""
    g = gumbel(key, logits.shape, device=logits.device)
    return torch.argmax(g + logits, dim=-1)


def _whole_index(local: torch.Tensor, block_shape, shape, starts
                 ) -> torch.Tensor:
    """Flat indices in a tensor of ``shape`` of the elements whose flat
    indices in its block (of ``block_shape``, at ``starts``) are
    ``local``."""
    rem = local.clone()
    out = torch.zeros_like(local)
    mult = 1
    for d in reversed(range(len(shape))):
        out += (rem % block_shape[d] + starts[d]) * mult
        rem //= block_shape[d]
        mult *= shape[d]
    return out


def uniform(key: Key, shape: Sequence[int], *, offset: int = 0,
            count: int | None = None, device=None,
            place=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1), or the flat
    elements [offset, offset + count) of it (a 1-D tensor) when ``count``
    is given: element i takes the counter pair (i >> 32, i mod 2^32).
    ``place`` = (whole shape, block starts) makes ``shape`` a block of a
    larger tensor: each element then takes the noise of its own index in
    the whole tensor's ``jax.random.uniform``, so a rank's block draws
    the same values as the whole tensor does there."""
    total = math.prod(shape)
    n = total - offset if count is None else int(count)
    if offset < 0 or n < 0 or offset + n > total:
        raise ValueError(f"elements [{offset}, {offset + n}) outside a shape "
                         f"of {total}")
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    if place is not None:
        idx = _whole_index(idx, tuple(shape), tuple(place[0]),
                           tuple(place[1]))
    x0 = idx >> 32
    x1 = idx.bitwise_and_(_M32)
    o1, o2 = _rounds(int(key[0]) & _M32, int(key[1]) & _M32, x0, x1)
    u = _unit_floats(o1.bitwise_xor_(o2)).clamp_(min=0.0)
    return u if count is not None else u.reshape(tuple(shape))


def chunks(total: int, size: int) -> Iterator[Tuple[int, int]]:
    """(start, count) of consecutive ranges of at most ``size`` covering
    [0, total)."""
    for start in range(0, total, size):
        yield start, min(size, total - start)

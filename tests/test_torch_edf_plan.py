"""The plan of the EDF-ladder kernel (``csrc/edf_ladder.cu``, behind
``edf_ladder_hists``), emulated in numpy on the CPU through its mirror in
``kernels/edf_ladder.py``.

* The constants of the mirror are the source's, and a CTA's shared memory
  lets two CTAs share an SM at the ladder PushDown uses.
* The slices cover every element of every layer once, each staged whole or
  in chunks, with the bulk copy on 16-byte boundaries at every offset of
  the tensor and the misaligned edges (under 4 elements each) on the
  element path.
* The narrow rungs' level index q + 2^(wl - 1) lies in its rung's counters
  for every WL ≤ LEVEL_WL and every FL in [−130, 130] (pow2i clamps the
  scale to [2^-126, 2^127]), at every finite and infinite value.
* Each level binned once gives the counts of binning each element.
* q · 2^-fl == q / 2^fl bitwise over the rungs' q ranges.
* The whole kernel emulated from its plan (slices, staging, the cluster's
  min and max in rank order, levels, the per-CTA counters summed) gives the
  plain version's counts bit for bit, and the JAX package's interpret-mode
  kernel's.
"""
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fixed_point as jax_fxp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import pushdown  # noqa: E402
from repro_torch.kernels import edf_ladder as el  # noqa: E402
from repro_torch.kernels._build import CSRC  # noqa: E402

SRC = (CSRC / "edf_ladder.cu").read_text()
LADDER = pushdown.WL_LADDER
R_UPR = 150
F32 = np.float32


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_constants_match_the_source():
    for name in ("CLUSTER", "SLICE", "LEVEL_WL", "LEVELS", "MAX_T",
                 "COUNT_INTS"):
        assert _constant(name) == getattr(el, name), name
    assert _constant("CLUSTER") <= 8            # a portable cluster
    nt = _constant("NT")
    assert nt % 32 == 0 and nt <= 1024
    # dynamic shared memory: the slice (+4 for the staging pad), the level
    # counters, the count table; two CTAs an SM at PushDown's ladder
    _, levels = el.level_plan(LADDER)
    dyn = 4 * (el.SLICE + 4 + levels + (1 + len(LADDER)) * R_UPR)
    static = 8 + 6 * 4 * el.MAX_T + 3 * 4 * (nt // 32) + 12
    assert 2 * (dyn + static + 1024) <= 228 * 1024
    # the largest launch the wrapper lets through fits one CTA
    assert 4 * (el.SLICE + 4 + el.LEVELS + el.COUNT_INTS) + static <= 227 * 1024


def test_level_plan_of_the_ladder():
    off, levels = el.level_plan(LADDER)
    narrow = [wl for wl in LADDER if wl <= el.LEVEL_WL]
    assert narrow == list(range(2, 13))
    assert levels == sum(1 << wl for wl in narrow) <= el.LEVELS
    for t, wl in enumerate(LADDER):
        if wl <= el.LEVEL_WL:
            assert off[t] == sum(1 << w for w in LADDER[:t] if w <= el.LEVEL_WL)
        else:
            assert off[t] == -1                     # WL 13..16, 20, 24, 32
    # a ladder whose narrow rungs overflow the counters bins the rest
    assert el.level_plan((12, 12, 12, 2, 0, 33)) == (
        [0, 4096, -1, -1, -1, -1], 8192)


NS = [0, 1, 5, el.CLUSTER - 1, el.CLUSTER, 127, 4096, 65536, 65541,
      el.CLUSTER * el.SLICE + 3, 200003]


@pytest.mark.parametrize("n", NS)
def test_slices_and_staging_cover_every_element_once(n):
    s = -(-n // el.CLUSTER)
    for L in (1, 3):
        for phase in range(4):
            seen = np.zeros(L * n, np.int64)
            for l in range(L):
                g_row = l * n
                for rank in range(el.CLUSTER):
                    start, end = el.slice_of(n, rank)
                    assert 0 <= start <= end <= n and end - start <= s
                    pieces = el.chunks_of(n, start, end)
                    if s <= el.SLICE:
                        assert pieces == [(start, end)]
                    assert all(c1 - c0 <= el.SLICE for c0, c1 in pieces)
                    for c0, c1 in pieces:
                        a, b, pad = el.stage_split(g_row, c0, c1, phase)
                        assert c0 <= a <= b <= c1 and (b - a) % 4 == 0
                        assert a - c0 < 4 and c1 - b < 4 and 0 <= pad < 4
                        if a < c1:
                            # the bulk part starts on a 16-byte boundary
                            assert (g_row + a) % 4 == phase
                        # and lands on one in shared memory, in the buffer
                        assert (pad + a - c0) % 4 == 0
                        assert pad + (c1 - c0) <= min(s, el.SLICE) + 4
                        # the threads stage the edges: fewer than the CTA has
                        assert (a - c0) + (c1 - b) < _constant("NT")
                        seen[g_row + c0:g_row + c1] += 1
            assert (seen == 1).all()


def test_the_largest_layer_is_sliced_whole():
    """n = 2^31 − 1, the most the wrapper takes: the slices and their
    chunks meet end to start and end at n (the kernel sums the bounds in
    64 bits)."""
    n = 2 ** 31 - 1
    end_prev = 0
    for rank in range(el.CLUSTER):
        start, end = el.slice_of(n, rank)
        assert start == end_prev and end <= n
        pieces = el.chunks_of(n, start, end)
        assert pieces[0][0] == start and pieces[-1][1] == end
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(pieces, pieces[1:]))
        assert all(0 < c1 - c0 <= el.SLICE for c0, c1 in pieces)
        end_prev = end
    assert end_prev == n and end_prev + el.SLICE >= 2 ** 31   # past int32


def test_phase_of_addresses():
    for addr in range(0, 64, 4):
        ph = el.phase_of(addr)
        assert all(((addr + 4 * g) % 16 == 0) == (g % 4 == ph)
                   for g in range(16))


def _pow2i(e) -> np.ndarray:
    e = np.clip(np.asarray(e, np.int64), -126, 127)
    return ((e + 127) << 23).astype(np.uint32).view(F32)


def _recip_pow2i(e) -> np.ndarray:
    e = np.clip(np.asarray(e, np.int64), -126, 127)
    bits = np.where(e == 127, 0x00400000, (127 - e) << 23)
    return bits.astype(np.uint32).view(F32)


def _qmax(wl: int) -> F32:
    """The f32 of the double 2^(wl-1) - 1 (2^31 at WL 32)."""
    return F32(2.0 ** (wl - 1) - 1.0)


def _level(v, s, qmx):
    """The reference's clip(rint(v * s), -qmx - 1, qmx) in f32."""
    with np.errstate(over="ignore", invalid="ignore"):
        return np.clip(np.rint(v * s), F32(-qmx - F32(1.0)), qmx).astype(F32)


def _bins(v, lo, span, rf):
    """The bins, as the kernel's bin_of: clip(floor((v - lo) / span * rf),
    0, rf - 1), -1 for NaN."""
    with np.errstate(over="ignore", invalid="ignore"):
        t = np.floor((v - lo) / span * rf).astype(F32)
        nan = np.isnan(t)
        b = np.clip(np.where(nan, F32(0), t), F32(0), rf - F32(1))
    return np.where(nan, -1, b.astype(np.int64))


EXTREMES = np.array([0.0, -0.0, 1e-45, -1e-45, 1.17549435e-38, 0.5, -0.5,
                     1.5, -2.5, 3.3e38, -3.3e38, 3.4028235e38, -3.4028235e38,
                     np.inf, -np.inf, 2.0 ** 30, -2.0 ** 31], F32)


def test_level_index_in_range_at_every_fl():
    rng = np.random.default_rng(0)
    v = np.concatenate([EXTREMES, rng.normal(0, 1, 4000).astype(F32),
                        (rng.normal(0, 1, 4000) * 1e30).astype(F32)])
    for wl in range(1, el.LEVEL_WL + 1):
        qmx, half = _qmax(wl), 1 << (wl - 1)
        assert qmx == half - 1
        for fl in range(-130, 131):
            q = _level(v, _pow2i(fl), qmx)
            assert not np.isnan(q).any() and (q == np.round(q)).all()
            idx = q.astype(np.int64) + half
            assert idx.min() >= 0 and idx.max() < 2 * half, (wl, fl)
    # WL 32: qmax rounds to 2^31, so its levels would not fit: it bins
    assert _qmax(32) == F32(2.0 ** 31) and el.level_plan((32,))[0] == [-1]


def test_reciprocal_multiply_equals_the_division():
    for wl in list(range(1, 17)) + [20, 24, 32]:
        qmx = _qmax(wl)
        lo_q = -int(qmx) - 1
        q = np.unique(np.concatenate([
            np.arange(max(lo_q, -4096), min(int(qmx), 4096) + 1),
            np.linspace(lo_q, int(qmx), 2001).round()])).astype(F32)
        q = np.concatenate([q, np.array([-0.0], F32)])
        for fl in range(-130, 131):
            with np.errstate(all="ignore"):
                np.testing.assert_array_equal(
                    (q / _pow2i(fl)).view(np.uint32),
                    (q * _recip_pow2i(fl)).view(np.uint32),
                    err_msg=f"wl {wl} fl {fl}")


def _layer_span(w_row):
    """(lo, span, dead) as the cluster finds them: each CTA's min and max
    over its slice, then the ranks' in order; a NaN anywhere kills the
    layer."""
    lo, hi, dead = F32(np.inf), F32(-np.inf), False
    n = w_row.size
    for rank in range(el.CLUSTER):
        start, end = el.slice_of(n, rank)
        part = w_row[start:end]
        dead |= bool(np.isnan(part).any())
        ok = part[~np.isnan(part)]
        if ok.size:
            lo, hi = min(lo, ok.min()), max(hi, ok.max())
    with np.errstate(over="ignore"):
        span = np.maximum(F32(hi - lo), F32(1e-12))
    return F32(lo), F32(span), dead


def test_level_binning_equals_per_element_binning():
    rng = np.random.default_rng(1)
    for scale in (0.02, 1.0, 40.0, 3e37):
        v = (rng.normal(0, 1, 20000) * scale).astype(F32)
        lo, span, _ = _layer_span(v)
        for rf in (F32(50), F32(150)):
            for wl in range(1, el.LEVEL_WL + 1):
                for fl in (-127, -3, 0, wl - 1, 11, 130):
                    q = _level(v, _pow2i(fl), _qmax(wl))
                    per_elem = _bins(q / _pow2i(fl), lo, span, rf)
                    want = np.bincount(per_elem[per_elem >= 0], minlength=150)
                    half = 1 << (wl - 1)
                    lev = np.bincount(q.astype(np.int64) + half,
                                      minlength=2 * half)
                    k = np.nonzero(lev)[0]
                    b = _bins((k - half).astype(F32) * _recip_pow2i(fl), lo,
                              span, rf)
                    got = np.bincount(b[b >= 0], weights=lev[k][b >= 0],
                                      minlength=150)
                    np.testing.assert_array_equal(got, want)


def emulate(w: np.ndarray, fls: np.ndarray, r: np.ndarray, wl_ladder=LADDER,
            r_upr=R_UPR, addr=0) -> np.ndarray:
    """The kernel's counts from its plan: per layer, each CTA stages its
    slice (or its chunks) from the three parts the split gives, counts row 0
    and the wide rungs per element and the narrow rungs per level, bins each
    nonzero level once, and the cluster's counters are summed."""
    L, n = w.shape
    T = len(wl_ladder)
    off, levels = el.level_plan(wl_ladder)
    phase = el.phase_of(addr)
    flat = w.reshape(-1)
    out = np.zeros((L, 1 + T, r_upr), F32)
    with np.errstate(over="ignore", invalid="ignore"):
        for l in range(L):
            _emulate_layer(out, flat, w, fls, r, l, n, wl_ladder, r_upr, off,
                           levels, phase)
    return out


def _emulate_layer(out, flat, w, fls, r, l, n, wl_ladder, r_upr, off, levels,
                   phase):
    T = len(wl_ladder)
    lo, span, dead = _layer_span(w[l])
    if dead:
        return
    rf = F32(min(int(r[l]), r_upr))
    total = np.zeros((1 + T) * r_upr, np.int64)
    for rank in range(el.CLUSTER):
        cnt = np.zeros((1 + T) * r_upr, np.int64)
        lev = np.zeros(levels, np.int64)
        start, end = el.slice_of(n, rank)
        for c0, c1 in el.chunks_of(n, start, end):
            a, b, _ = el.stage_split(l * n, c0, c1, phase)
            g = l * n
            v = np.concatenate([flat[g + c0:g + a], flat[g + a:g + b],
                                flat[g + b:g + c1]])
            bins = _bins(v, lo, span, rf)
            np.add.at(cnt, bins[bins >= 0], 1)
            for t, wl in enumerate(wl_ladder):
                q = _level(v, _pow2i(fls[l, t]), _qmax(wl))
                if off[t] >= 0:
                    idx = q.astype(np.int64) + (1 << (wl - 1))
                    np.add.at(lev, off[t] + idx, 1)
                else:
                    bins = _bins(q * _recip_pow2i(fls[l, t]), lo, span, rf)
                    np.add.at(cnt, (1 + t) * r_upr + bins[bins >= 0], 1)
        for t, wl in enumerate(wl_ladder):
            if off[t] < 0:
                continue
            half = 1 << (wl - 1)
            k = np.nonzero(lev[off[t]:off[t] + 2 * half])[0]
            bins = _bins((k - half).astype(F32) * _recip_pow2i(fls[l, t]),
                         lo, span, rf)
            keep = bins >= 0
            np.add.at(cnt, (1 + t) * r_upr + bins[keep],
                      lev[off[t] + k[keep]])
        total += cnt
    out[l] = total.reshape(1 + T, r_upr).astype(F32)


def _fls(w_row) -> np.ndarray:
    amax = jnp.max(jnp.abs(jnp.asarray(w_row)))
    return np.asarray(jax_fxp.fl_for_wl(amax, jnp.asarray(LADDER, jnp.int32)))


def _interpret(w_row, fls_row, r):
    return np.asarray(jops.edf_ladder_hists(
        jnp.asarray(w_row), jnp.asarray(fls_row), jnp.int32(r),
        wl_ladder=LADDER, r_upr=R_UPR, use_pallas=True))


def _plain(w, fls, r, wl_ladder=LADDER, r_upr=R_UPR):
    return el.plain(torch.from_numpy(w), torch.from_numpy(fls),
                    torch.from_numpy(np.asarray(r, np.int32)),
                    wl_ladder=wl_ladder, r_upr=r_upr).numpy()


@pytest.mark.parametrize("r", [50, 150])
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("n", [1, 5, 127, 4096, 65541])
def test_emulated_kernel_bit_equal(n, L, r):
    rng = np.random.default_rng(n * 7 + L * 3 + r)
    w = (rng.normal(0, 0.05, (L, n)) * (1 + np.arange(L))[:, None]).astype(F32)
    fls = np.stack([_fls(w[l]) for l in range(L)]).astype(np.int32)
    rs = np.array([r, max(r - 13, 1), r][:L], np.int32)
    got = emulate(w, fls, rs, addr=4 * (n % 4))
    np.testing.assert_array_equal(got, _plain(w, fls, rs))
    for l in range(L):
        np.testing.assert_array_equal(got[l], _interpret(w[l], fls[l], rs[l]),
                                      err_msg=f"layer {l}")
    assert (got.sum(axis=2) == n).all()


def _patho(name):
    return {
        "signed_zeros": np.array([0.0, -0.0] * 320, F32),
        "denormals": np.array([1e-42, -3e-41, 5e-44, -1e-45] * 160, F32),
        "inf_adjacent": np.array([3.3e38, -3.3e38, 1e30, -1e25] * 160, F32),
        "all_equal": np.full((640,), 0.3, F32),
        "all_equal_negative": np.full((640,), -1.75, F32),
        "mixed_extremes": np.array([0.0, -0.0, 1e-42, 3.3e38, -3.3e38, 0.5,
                                    -0.5, 1.0] * 80, F32),
    }[name]


@pytest.mark.parametrize("r", [50, 150])
@pytest.mark.parametrize("case", ["signed_zeros", "denormals", "inf_adjacent",
                                  "all_equal", "all_equal_negative",
                                  "mixed_extremes"])
def test_emulated_pathological_bit_equal(case, r):
    """The pathological values of test_torch_edf_ladder.py: near ±3.3e38
    the range-derived FL of WL 2 is −127 (pow2i clamps it), and the bins of
    elements at the max are NaN, counted in no row."""
    w = _patho(case).reshape(1, -1)
    fls = _fls(w[0]).reshape(1, -1).astype(np.int32)
    got = emulate(w, fls, np.array([r], np.int32), addr=12)
    np.testing.assert_array_equal(got, _plain(w, fls, [r]))
    np.testing.assert_array_equal(got[0], _interpret(w[0], fls[0], r))


def test_emulated_near_the_largest_floats():
    rng = np.random.default_rng(3)
    w = np.clip(rng.normal(0, 1e38, (2, 4099)), -3.3e38, 3.3e38).astype(F32)
    fls = np.stack([_fls(w[l]) for l in range(2)]).astype(np.int32)
    assert fls[:, 0].min() == -127
    got = emulate(w, fls, np.array([150, 77], np.int32), addr=8)
    np.testing.assert_array_equal(got, _plain(w, fls, [150, 77]))


def test_emulated_at_hand_set_fls():
    """FLs outside pow2i's range, WL 32's qmax of 2^31, words that clip."""
    rng = np.random.default_rng(4)
    w = (rng.normal(0, 1, (3, 3001)) * 40.0).astype(F32)
    fls = rng.integers(-130, 131, (3, len(LADDER))).astype(np.int32)
    fls[0] = np.arange(len(LADDER)) % 7 * 5 - 6
    fls[1, :4] = (-130, 130, -127, 127)
    got = emulate(w, fls, np.array([50, 150, 99], np.int32), addr=4)
    np.testing.assert_array_equal(got, _plain(w, fls, [50, 150, 99]))
    for l in range(3):
        np.testing.assert_array_equal(got[l], _interpret(w[l], fls[l],
                                                         [50, 150, 99][l]))


def test_a_nan_layer_counts_nothing():
    """A NaN makes the layer's min and max NaN, so every bin is NaN: the
    plain version and the interpret-mode kernel count nothing, and the
    kernel skips the layer; the other layers keep their counts."""
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.05, (2, 1000)).astype(F32)
    w[1, 517] = np.nan
    fls = np.stack([_fls(w[0]), _fls(w[0])]).astype(np.int32)
    got = emulate(w, fls, np.array([150, 150], np.int32))
    want = _plain(w, fls, [150, 150])
    np.testing.assert_array_equal(got, want)
    assert not got[1].any() and (got[0].sum(axis=1) == 1000).all()
    np.testing.assert_array_equal(got[1], _interpret(w[1], fls[1], 150))


def test_other_ladders_and_resolutions():
    """A ladder whose narrow rungs overflow the level counters, WL 1, and
    an r_upr that leaves columns past r[l] empty."""
    ladder = (1, 12, 12, 12, 3, 13, 32)
    rng = np.random.default_rng(6)
    w = rng.normal(0, 0.3, (2, 999)).astype(F32)
    fls = rng.integers(-3, 14, (2, len(ladder))).astype(np.int32)
    got = emulate(w, fls, np.array([7, 64], np.int32), wl_ladder=ladder,
                  r_upr=64)
    np.testing.assert_array_equal(
        got, _plain(w, fls, [7, 64], wl_ladder=ladder, r_upr=64))
    assert not got[0, :, 7:].any()

"""The plan of the float SR grid-value kernel (``csrc/sr_quantize.cu``,
namespace ``grid``, behind ``sr_quantize_fused`` and
``sr_quantize_fused_stacked``), emulated in plain PyTorch and numpy on the
CPU through its mirror in ``kernels/sr_quantize.py``.

* The chunk plan covers every element of every layer exactly once, a chunk
  never crosses a layer, and the persistent grid's CTAs share the chunks
  evenly (element by element at small sizes, by intervals at the large
  ones: L up to 65535, n_l up to the head's 128256·3072).
* The kernel's hash index (``base + g``, base = l·stride − l·n_l in uint32
  arithmetic) is the reference's l·layer_stride(n_l) + e.
* The bulk/element split sends exactly the misaligned heads and tails of a
  chunk (under 16 bytes each), or the whole chunk when x and q cannot be
  aligned together, to the element path.
* The kernel multiplies by the exact reciprocal of 2^fl where the
  reference divides: q / 2^e == q · 2^-e bitwise for every e in
  [−126, 127] and every integer-valued f32 q, ±0, ±inf and NaN, with
  subnormals kept.
* The whole kernel emulated from its plan gives the plain version's bits,
  and the JAX package's interpret-mode kernel's.
"""
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import sr_quantize as sq  # noqa: E402
from repro_torch.kernels._build import CSRC  # noqa: E402

SRC = (CSRC / "sr_quantize.cu").read_text()
GRID = SRC[SRC.index("namespace grid {"):SRC.index("}  // namespace grid")]
C = sq.GRID_CHUNK
H100_SMS = 132
M32 = 0xFFFFFFFF
LS = [1, 3, 28, 65535]
NS = [1, 7, C - 1, C, C + 1, 3072 * 8192, 128256 * 3072]
OUT_SIZE = {torch.float32: 4, torch.bfloat16: 2}


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", GRID).group(1))


def _stride(n_l: int) -> int:
    return -(-n_l // 512) * 512


def _kernel_index(l: int, g: int, n_l: int, stride: int) -> int:
    """The kernel's uint32 index of flat element g of layer l."""
    base = ((l * stride) & M32) - ((l * n_l) & M32)
    return (base + g) & M32


def test_constants_match_the_source():
    assert _constant("CHUNK") == sq.GRID_CHUNK
    assert _constant("CTAS_PER_SM") == sq.GRID_CTAS_PER_SM
    # the ring and the staging slots of two CTAs fit in an SM's 228 KB
    smem = _constant("STAGES") * C * 4 + _constant("SLOTS") * C * 4
    assert sq.GRID_CTAS_PER_SM * (smem + 1024 + 64) <= 228 * 1024


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_l", NS)
@pytest.mark.parametrize("L", LS)
def test_chunks_cover_every_element_once(L, n_l, out_dtype):
    chunk, ctas, cpl = sq.grid_plan(L, n_l, H100_SMS)
    chunks = L * cpl
    assert chunk == C and cpl == -(-n_l // C)
    assert ctas == min(chunks, sq.GRID_CTAS_PER_SM * H100_SMS)
    # CTA b takes chunks b, b + ctas, ...: each chunk once, shares within 1
    mine = [(chunks - 1 - b) // ctas + 1 for b in range(ctas)]
    assert sum(mine) == chunks and max(mine) - min(mine) <= 1
    period, phase = sq.grid_bulk(0, 0, OUT_SIZE[out_dtype])
    assert (period, phase) == (16 // OUT_SIZE[out_dtype], 0)
    stride = _stride(n_l)

    def check(c):
        l, g0, g1 = sq.grid_chunk(c, n_l, cpl)
        assert 0 < g1 - g0 <= C and l * n_l <= g0 and g1 <= (l + 1) * n_l
        assert l == c // cpl
        a, b = sq.grid_split(g0, g1, period, phase)
        assert g0 <= a <= b <= g1 and (b - a) % period == 0
        # torch's allocations are aligned: only a short last chunk of a layer
        # (or a layer start off the period) leaves the bulk part
        assert a - g0 < period and g1 - b < period
        for e in (g0, g1 - 1):
            assert _kernel_index(l, e, n_l, stride) == \
                (l * stride + e - l * n_l) & M32
        return l, g0, g1

    total = L * n_l
    if total <= 1 << 21:
        seen = np.zeros(total, np.int64)
        for c in range(chunks):
            _, g0, g1 = check(c)
            seen[g0:g1] += 1
        assert (seen == 1).all()
        return
    # by intervals: every layer's first chunk starts at l·n_l and its last
    # ends at (l + 1)·n_l; the chunks between meet end to start (all of them
    # in a few layers when a layer has few chunks, runs at both ends else),
    # and a layer holds cpl - 1 whole chunks and a last one of 1..C
    for l in range(L):
        assert sq.grid_chunk(l * cpl, n_l, cpl)[1] == l * n_l
        assert sq.grid_chunk(l * cpl + cpl - 1, n_l, cpl)[2] == (l + 1) * n_l
    assert (cpl - 1) * C < n_l <= cpl * C
    runs = ([range(cpl)] if cpl <= 4096
            else [range(0, 64), range(cpl // 2 - 32, cpl // 2 + 32),
                  range(cpl - 64, cpl)])
    for l in sorted({0, 1, L // 2, L - 1} & set(range(L))):
        for r in runs:
            end = None
            for j in r:
                _, g0, g1 = check(l * cpl + j)
                assert end is None or g0 == end
                end = g1


def _aligned(addr: int, size: int, g: int) -> bool:
    return (addr + size * g) % 16 == 0


# q's offset from a 16-byte boundary: a multiple of its element size
Q_OFFSETS = [(torch.float32, o) for o in (0, 4, 8, 12)] + [
    (torch.bfloat16, o) for o in range(0, 16, 2)]


@pytest.mark.parametrize("out_dtype,q_off", Q_OFFSETS)
def test_split_sends_the_misaligned_edges_to_the_element_path(out_dtype,
                                                              q_off):
    s = OUT_SIZE[out_dtype]
    for x_off in (0, 4, 8, 12):
        x_addr, q_addr = 1 << 20 | x_off, 3 << 20 | q_off
        period, phase = sq.grid_bulk(x_addr, q_addr, s)
        both = [g for g in range(16) if _aligned(x_addr, 4, g)
                and _aligned(q_addr, s, g)]
        if not both:
            assert period == 0
        else:
            assert period == 16 // s and phase == both[0]
        for L, n_l in ((3, 7), (3, C - 1), (2, C + 1), (3, 4100), (4, 1)):
            _, _, cpl = sq.grid_plan(L, n_l, H100_SMS)
            for c in range(L * cpl):
                _, g0, g1 = sq.grid_chunk(c, n_l, cpl)
                a, b = sq.grid_split(g0, g1, period, phase)
                starts = [g for g in range(g0, g1) if _aligned(x_addr, 4, g)
                          and _aligned(q_addr, s, g)]
                if not starts:
                    assert a == b == g1, "no bulk part: all elements"
                    continue
                # a: the first element whose x and q are both aligned; the
                # bulk part whole 16-byte pieces of both; what is left under
                # one piece
                assert a == starts[0] and b - a == (g1 - a) // period * period
                assert ((b - a) * 4) % 16 == 0 and ((b - a) * s) % 16 == 0
                assert a - g0 < period and g1 - b < period
                assert _aligned(x_addr, 4, a) and _aligned(q_addr, s, a)


def _recip_pow2i(e: int) -> np.float32:
    """2^-e for the clamped e of pow2i, from the bits as the kernel builds
    it (2^-127 is the subnormal 0x00400000)."""
    e = min(max(e, -126), 127)
    bits = 0x00400000 if e == 127 else (127 - e) << 23
    return np.array(bits, np.uint32).view(np.float32)[()]


def _pow2i(e: int) -> np.float32:
    e = min(max(e, -126), 127)
    return np.array((e + 127) << 23, np.uint32).view(np.float32)[()]


def test_reciprocal_multiply_equals_the_division():
    rng = np.random.default_rng(5)
    k = np.arange(32)
    q = np.concatenate([
        np.arange(-4096, 4097), 2.0 ** k, 2.0 ** k - 1, 2.0 ** k + 1,
        rng.integers(-2 ** 31, 2 ** 31 + 1, 100000),
        rng.integers(-2 ** 24, 2 ** 24, 20000)]).astype(np.float32)
    q = np.unique(np.concatenate([q, -q]))
    assert (q == np.round(q)).all() and np.abs(q).max() == 2.0 ** 31
    q = np.concatenate([q, np.array([0.0, -0.0, np.inf, -np.inf, np.nan],
                                    np.float32)])
    with np.errstate(all="ignore"):
        for e in range(-126, 128):
            r = _recip_pow2i(e)
            assert r == np.float32(2.0 ** -e) and _pow2i(e) * r == 1.0
            np.testing.assert_array_equal((q / _pow2i(e)).view(np.uint32),
                                          (q * r).view(np.uint32),
                                          err_msg=f"e {e}")
            tq = torch.from_numpy(q)
            np.testing.assert_array_equal(
                (tq / torch.tensor(_pow2i(e))).numpy().view(np.uint32),
                (tq * torch.tensor(r)).numpy().view(np.uint32))
    # clamped FLs: pow2i and its reciprocal stay a pair outside [-126, 127]
    for e in (-300, -127, 128, 500):
        assert _pow2i(e) * _recip_pow2i(e) == 1.0


def _emulate(x: torch.Tensor, seed, wl, fl, out_dtype, x_addr=0, q_addr=0,
             stacked=True):
    """The kernel's output from its plan: every chunk's bulk part and its
    element path, each element from the kernel's index and the reciprocal
    product. ``stacked``: x (L, ...) with (L,) wl and fl, else a flat leaf
    (one layer, stride 0) with 0-dim wl and fl."""
    x2 = x.reshape(x.shape[0], -1) if stacked else x.reshape(1, -1)
    L, n_l = x2.shape
    stride = _stride(n_l) if stacked else 0
    wl, fl = wl.reshape(-1), fl.reshape(-1)
    _, _, cpl = sq.grid_plan(L, n_l, H100_SMS)
    period, phase = sq.grid_bulk(x_addr, q_addr, OUT_SIZE[out_dtype])
    flat = x2.reshape(-1)
    out = torch.full((L * n_l,), float("nan"), dtype=out_dtype)
    for c in range(L * cpl):
        l, g0, g1 = sq.grid_chunk(c, n_l, cpl)
        a, b = sq.grid_split(g0, g1, period, phase)
        scale = torch.tensor(_pow2i(int(fl[l])))
        hi_q = torch.tensor(_pow2i(int(wl[l]) - 1)) - 1.0
        inv = torch.tensor(_recip_pow2i(int(fl[l])))
        for lo, hi in ((g0, a), (a, b), (b, g1)):
            if lo == hi:
                continue
            g = torch.arange(lo, hi, dtype=torch.int64)
            idx = (((l * stride) & M32) - ((l * n_l) & M32) + g) & M32
            u = sq.uniform_from_index(seed, idx)
            s = flat[lo:hi] * scale
            f = torch.floor(s)
            qv = torch.clamp(f + (u < (s - f)).to(torch.float32),
                             -hi_q - 1.0, hi_q)
            out[lo:hi] = (qv * inv).to(out_dtype)
    return out.reshape(x.shape)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


# (out dtype, x's and q's offsets from a 16-byte boundary): aligned, x
# off q, q off x, both off alike
ADDRS = [(torch.float32, (0, 0)), (torch.float32, (4, 0)),
         (torch.float32, (0, 8)), (torch.float32, (12, 12)),
         (torch.bfloat16, (0, 0)), (torch.bfloat16, (4, 0)),
         (torch.bfloat16, (0, 6)), (torch.bfloat16, (12, 6))]


@pytest.mark.parametrize("out_dtype,addrs", ADDRS)
@pytest.mark.parametrize("L,n_l", [(3, 7), (2, C - 1), (2, C + 1),
                                   (3, 4100), (1, 2 * C + 3)])
def test_emulated_kernel_equals_the_plain_version(L, n_l, out_dtype, addrs):
    rng = np.random.default_rng(L * 7 + n_l)
    x = torch.from_numpy(rng.normal(0, 3.0, (L, n_l)).astype(np.float32))
    wl = torch.tensor([8, 32, 2][:L], dtype=torch.int32)
    fl = torch.tensor([4, 28, -3][:L], dtype=torch.int32)
    got = _emulate(x, -12345, wl, fl, out_dtype, *addrs)
    want = sq.plain_grid_stacked(x, -12345, wl, fl, out_dtype=out_dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if L == 1:
        flat = _emulate(x[0], 7, wl[0], fl[0], out_dtype, *addrs,
                        stacked=False)
        np.testing.assert_array_equal(_bits(flat), _bits(sq.plain_grid(
            x[0], 7, wl[0], fl[0], out_dtype=out_dtype)))


@pytest.mark.parametrize("L,trail", [(1, (C + 5,)), (3, (65, 65))])
def test_emulated_kernel_equals_the_interpret_mode_kernel(L, trail):
    rng = np.random.default_rng(L)
    x = rng.normal(0, 3.0, (L,) + trail).astype(np.float32)
    wl = np.array([8, 16, 32][:L], np.int32)
    fl = np.array([10, 0, 20][:L], np.int32)
    got = _emulate(torch.from_numpy(x), 99, torch.from_numpy(wl),
                   torch.from_numpy(fl), torch.float32, 4, 0)
    want = np.asarray(jops.sr_quantize_fused(
        jnp.asarray(x), jnp.int32(99), jnp.asarray(wl), jnp.asarray(fl),
        use_pallas=True))
    if L == 1:
        # a flat leaf of the same elements: stride 0, the same indices
        flat = _emulate(torch.from_numpy(x[0]), 99, torch.tensor(wl[0]),
                        torch.tensor(fl[0]), torch.float32, 0, 8,
                        stacked=False)
        np.testing.assert_array_equal(flat.numpy().view(np.int32),
                                      want[0].view(np.int32))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_pathological_values_through_the_reciprocal():
    """NaN passes the clip, ±inf and the largest finite values clip, the
    signed zeros and the subnormals round: the reciprocal product keeps
    the plain version's bits at every FL's extreme."""
    vals = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                         3.4e38, -3.4e38, 1e-45, -1e-45, 1.17549435e-38,
                         0.49999997, 0.5, 1.5, -2.5, 2.0 ** 30, -2.0 ** 31],
                        dtype=torch.float32)
    x = vals.repeat(4, 1)
    for wl_v, fl_v in ((8, 0), (32, 127), (32, -126), (2, 140), (16, -200)):
        wl = torch.full((4,), wl_v, dtype=torch.int32)
        fl = torch.full((4,), fl_v, dtype=torch.int32)
        for dt in (torch.float32, torch.bfloat16):
            np.testing.assert_array_equal(
                _bits(_emulate(x, 3, wl, fl, dt)),
                _bits(sq.plain_grid_stacked(x, 3, wl, fl, out_dtype=dt)),
                err_msg=f"<{wl_v},{fl_v}> {dt}")

"""The arithmetic of ``fxp_matmul``'s decode GEMV (``csrc/fxp_matmul.cu``,
namespace ``gemv``) and of ``int8_matmul``'s tensor-core kernel
(``csrc/int8_matmul.cu``, namespace ``tc8``), emulated in plain PyTorch and
numpy on the CPU, and the branch predicates of both wrappers.

* The GEMV sums in a fixed f32 order: the k rows of a cluster rank's range
  go round-robin to the CTA's slots, each slot sums its rows in order
  (an FMA of exact products), a warp adds its slots by a shuffle, the CTA
  its 8 warps in order, rank 0 the ranks' partials in rank order, and the
  scale is applied once. The emulation takes the same order from
  ``gemv_plan`` and the source's constants, and is held against the plain
  version and the reference's Pallas kernel in interpret mode within
  ``chip_smoke.check_fxp_matmul``'s bounds.
* The GEMV converts int8 words to f32 by a byte permute into 0x4B0000xx and
  one subtract; emulated bitwise over all 256 words.
* ``int8_matmul_tc``'s producers transpose the staged [k][n] word tile into
  the swizzled K-major layout wgmma reads, in 4 x 4 byte blocks by
  ``__byte_perm``; emulated with the kernel's selectors, thread layout and
  index map, and held equal to wqᵀ on a ragged tile.
"""
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import fxp_matmul as jfm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import fxp_matmul as fm  # noqa: E402
from repro_torch.kernels import int8_matmul as im  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels._build import CSRC  # noqa: E402

FL = 10
GEMV_SRC = (CSRC / "fxp_matmul.cu").read_text()
INT8_SRC = (CSRC / "int8_matmul.cu").read_text()


def _namespace(text: str, name: str) -> str:
    start = text.index(f"namespace {name} {{")
    return text[start:text.index(f"}}  // namespace {name}", start)]


def _constant(body: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", body).group(1))


GEMV = _namespace(GEMV_SRC, "gemv")
WARPS, COLS, ACC = (_constant(GEMV, k) for k in ("WARPS", "COLS", "ACC"))
MAX_M, MAX_CLUSTER = _constant(GEMV, "MAX_M"), _constant(GEMV, "MAX_CLUSTER")


def _slots(mb: int) -> tuple[int, int]:
    """(rows a warp reads at once, slots of a CTA) of the bucket mb, as the
    kernel's ``Shape``: ACC / mb columns a lane (at least 4), 128 a CTA."""
    cpt = max(4, ACC // mb)
    kr = 32 // (COLS // cpt)
    return kr, WARPS * kr


def test_wrapper_constants_are_the_kernels():
    assert (fm.GEMV_MAX_M, fm.GEMV_COLS, fm.GEMV_MAX_CLUSTER) == (
        MAX_M, COLS, MAX_CLUSTER)
    assert [_slots(mb) for mb in (4, 8, 16)] == [(2, 16), (1, 8), (1, 8)]


def emulate_gemv(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """y as the GEMV forms it for bf16 x (every product exact in f32): an
    FMA per row is one rounding of acc + x·w, emulated by an f64 sum
    rounded to f32 (exact before that rounding)."""
    M, K = x.shape
    N = wq.shape[1]
    mb, cs, kc = fm.gemv_plan(M, K, N)
    kr, slots = _slots(mb)
    xf, wf = x.double(), wq.double()
    ranks = []
    for r in range(cs):
        lo, hi = r * kc, min(K, (r + 1) * kc)
        acc = torch.zeros(slots, M, N, dtype=torch.float32)
        for i in range(-(-max(hi - lo, 0) // slots)):
            ks = lo + torch.arange(slots) + slots * i
            valid = ks < hi
            kk = ks.clamp(max=K - 1)
            prod = xf[:, kk].T[:, :, None] * wf[kk][:, None, :]
            acc = torch.where(valid[:, None, None], (acc.double() + prod).float(), acc)
        lanes = acc.view(WARPS, kr, M, N)
        warp = lanes[:, 0] + lanes[:, 1] if kr == 2 else lanes[:, 0]
        cta = warp[0]
        for w in range(1, WARPS):
            cta = cta + warp[w]
        ranks.append(cta)
    tot = ranks[0]
    for part in ranks[1:]:
        tot = tot + part
    return (tot * scale.float()).to(out_dtype)


def _within(got: torch.Tensor, want: torch.Tensor) -> bool:
    """chip_smoke.check_fxp_matmul's bounds: f32 within 1e-5·max|want|;
    bf16 within one bf16 ulp at |want| + 2^-16·max|want|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype == torch.float32:
        return bool((err <= 1e-5 * w.abs().max()).all())
    e = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    return bool((err <= torch.exp2(e - 7) + 2.0 ** -16 * w.abs().max()).all())


@pytest.mark.parametrize("n", [40, 37])
@pytest.mark.parametrize("k", [3072, 8192, 3071])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_gemv_order_within_bounds(m, k, n):
    """The GEMV's sum order against the plain version and the reference's
    ``fxp_matmul`` in interpret mode, bf16 and f32 out, over the decode
    contractions (d_model, d_ff, a ragged one) and narrow N (one ragged),
    where the plan splits K over a cluster of 8."""
    rng = np.random.default_rng(m * 100003 + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    wq = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    scale = torch.tensor(2.0 ** -FL, dtype=torch.bfloat16)
    assert fm.gemv_plan(m, k, n)[1] == 8
    jx = jnp.asarray(interop.tensor_to_numpy(x))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = emulate_gemv(x, wq, scale, dt)
        assert got.dtype == dt
        assert _within(got, fm.plain(x, wq, scale, out_dtype=dt)), dt
        want = jfm.fxp_matmul(jx, jnp.asarray(wq.numpy()), jnp.float32(2.0 ** -FL),
                              out_dtype=jdt, interpret=True)
        assert _within(got, torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(dt)), dt


@pytest.mark.parametrize("m, k, n, cs", [(4, 200, 37, 1), (8, 1000, 300, 4),
                                         (3, 0, 16, 1)])
def test_gemv_order_short_and_empty_k(m, k, n, cs):
    """Plans over few rows (one CTA along K, or a cluster of 4 at M = 8)
    and an empty K (zeros)."""
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    wq = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    scale = torch.tensor(2.0 ** -FL, dtype=torch.bfloat16)
    assert fm.gemv_plan(m, k, n)[1] == cs
    got = emulate_gemv(x, wq, scale, torch.float32)
    assert _within(got, fm.plain(x, wq, scale, out_dtype=torch.float32))
    assert k or not got.any()


def test_gemv_plan_on_the_decode_shapes():
    """The splits llama3.2-3b's decode takes (PERF.md section 6): wq / wo,
    wk / wv, the MLP's gate / up and wo, the LM head."""
    assert fm.gemv_plan(4, 3072, 3072) == (4, 4, 768)
    assert fm.gemv_plan(4, 3072, 1024) == (4, 8, 384)
    assert fm.gemv_plan(4, 3072, 8192) == (4, 2, 1536)
    assert fm.gemv_plan(4, 8192, 3072) == (4, 8, 1024)
    assert fm.gemv_plan(4, 3072, 128256) == (4, 1, 3072)


@pytest.mark.parametrize("m", [1, 4, 5, 8, 9, 16])
def test_gemv_plan_covers_k(m):
    """Every plan: a cluster of 1..8 CTAs, kc a multiple of the bucket's
    slots, the ranks' ranges covering [0, K) with no rank left empty but
    the rounding's, at least 128 rows a CTA when K is split."""
    for k in (0, 1, 31, 255, 256, 3071, 3072, 8192, 100003):
        for n in (1, 37, 128, 3072, 128256):
            mb, cs, kc = fm.gemv_plan(m, k, n)
            assert mb == (4 if m <= 4 else 8 if m <= 8 else 16)
            assert cs in (1, 2, 4, 8) and kc % _slots(mb)[1] == 0
            assert cs * kc >= k and (cs - 1) * kc < max(k, 1)
            assert cs == 1 or k // cs >= 128


def _bytes_le(u: int) -> list:
    return [(u >> (8 * i)) & 0xFF for i in range(4)]


def byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the 8 bytes {y, x} (x the low four)."""
    b = _bytes_le(x) + _bytes_le(y)
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def test_word_conversion_is_exact_for_all_256_words():
    """``words_f32``'s constants read from the source: each word's byte
    with its sign bit flipped, permuted under the magic exponent, minus the
    magic value, is float(w), bitwise, for every int8 word in every byte
    position."""
    body = GEMV_SRC[GEMV_SRC.index("void words_f32("):]
    body = body[:body.index("\n}\n")]
    flip = int(re.search(r"u \^ (0x[0-9A-Fa-f]+)u", body).group(1), 16)
    hi, sel = (int(v, 16) for v in re.search(
        r"__byte_perm\(v, (0x[0-9A-Fa-f]+)u, (0x[0-9A-Fa-f]+)u \+ e\)", body).groups())
    magic = np.float32(float(re.search(r"\) - ([0-9.]+)f;", body).group(1)))
    words = np.arange(-128, 128, dtype=np.int8)
    for e in range(4):
        for w in words:
            u = (int(np.uint8(w.view(np.uint8))) << (8 * e)) | (0x5A << (8 * ((e + 1) % 4)))
            bits = np.uint32(byte_perm(u ^ flip, hi, sel + e))
            f = bits.view(np.float32) - magic
            assert f.dtype == np.float32 and f == np.float32(w), (e, int(w))


# ---------------------------------------------------------------------------
# int8_matmul_tc's transpose

TC8 = _namespace(INT8_SRC, "tc8")
BK, BN = _constant(TC8, "BK"), _constant(TC8, "BN")
_SELECTORS = [int(v, 16) for v in re.findall(
    r"__byte_perm\([a-z0-9\[\]]+, [a-z0-9\[\]]+, (0x[0-9A-Fa-f]+)u\)",
    TC8[TC8.index("void transpose4("):TC8.index("__global__")])]


def transpose4(r):
    """``tc8::transpose4`` with the source's selectors: four rows of four
    bytes in, four columns out."""
    s = _SELECTORS
    t0, t1 = byte_perm(r[0], r[1], s[0]), byte_perm(r[2], r[3], s[1])
    t2, t3 = byte_perm(r[0], r[1], s[2]), byte_perm(r[2], r[3], s[3])
    return [byte_perm(t0, t1, s[4]), byte_perm(t0, t1, s[5]),
            byte_perm(t2, t3, s[6]), byte_perm(t2, t3, s[7])]


def producer_transpose(staged: np.ndarray):
    """The producer warpgroup's step: the staged tile [BK k][BN n] as TMA
    lands it, into the K-major tile wgmma reads (row n at n·BK bytes, its
    16-byte chunk c at (c ^ n % 8)·16). Returns the tile, how often each
    16-byte piece was written, and each warp's load banks and each
    quarter-warp's store positions per instruction."""
    out = np.zeros(BN * BK, np.uint8)
    written = np.zeros(BN * BK // 16, int)
    loads, stores = [], []
    for warp in range(4):
        by_instr = {}
        for lane in range(32):
            g = 32 * (warp % 2) + lane
            for q in range(4):
                c = (2 * q + warp // 2 + lane) % 8
                r = []
                for i in range(16):
                    row = 16 * c + i
                    r.append(int.from_bytes(staged[row, 4 * g:4 * g + 4].tobytes(), "little"))
                    by_instr.setdefault(("ld", q, i), []).append((row * BN + 4 * g) // 4 % 32)
                cols = [transpose4(r[4 * b:4 * b + 4]) for b in range(4)]
                for e in range(4):
                    n = 4 * g + e
                    pos = n * BK + (c ^ (n % 8)) * 16
                    piece = b"".join(cols[b][e].to_bytes(4, "little") for b in range(4))
                    out[pos:pos + 16] = np.frombuffer(piece, np.uint8)
                    written[pos // 16] += 1
                    by_instr.setdefault(("st", q, e, lane // 8), []).append(pos % 128 // 16)
        loads += [v for k, v in by_instr.items() if k[0] == "ld"]
        stores += [v for k, v in by_instr.items() if k[0] == "st"]
    return out, written, loads, stores


def test_int8_transpose_is_wq_transposed():
    """A ragged word tile (100 k x 200 n, zero past the edges as TMA fills
    the box): the transposed, swizzled tile read back by wgmma's index map
    is wqᵀ; every 16-byte piece is written once; a warp's 4-byte loads hit
    32 distinct banks and a quarter-warp's 16-byte stores 8 distinct
    positions of a 128-byte row."""
    assert (BK, BN) == (128, 256) and len(_SELECTORS) == 8
    rng = np.random.default_rng(7)
    wq = rng.integers(-128, 128, (100, 200)).astype(np.int8)
    staged = np.zeros((BK, BN), np.uint8)
    staged[:100, :200] = wq.view(np.uint8)
    tile, written, loads, stores = producer_transpose(staged)
    n = np.arange(BN)[:, None]
    k = np.arange(BK)[None, :]
    read = tile[n * BK + ((k // 16) ^ (n % 8)) * 16 + k % 16].view(np.int8)
    want = np.zeros((BN, BK), np.int8)
    want[:200, :100] = wq.T
    np.testing.assert_array_equal(read, want)
    assert (written == 1).all()
    assert all(len(set(b)) == 32 for b in loads)
    assert all(len(set(p)) == 8 for p in stores)


# ---------------------------------------------------------------------------
# branch predicates and counters


def test_branch_predicates():
    """The GEMV by M alone; ``int8_matmul``'s tensor cores by shape and
    alignment alone, as the C entry refuses what TMA cannot address."""
    assert [fm.takes_gemv(m) for m in (1, 4, 16, 17, 512)] == [True] * 3 + [False] * 2
    tc = im.takes_tensor_cores
    assert tc(3072, 8192, 0, 16) and tc(16, 16, 32, 48)
    assert not tc(3071, 8192, 0, 0) and not tc(3072, 8200, 0, 0)
    assert not tc(3072, 8192, 1, 0) and not tc(3072, 8192, 0, 8)
    assert not tc(0, 16, 0, 0)
    entry = INT8_SRC[INT8_SRC.index("int int8_matmul_tc_launch("):]
    assert "K % 16 != 0 || N % 16 != 0" in entry and "% 16 != 0" in entry


@pytest.mark.parametrize("m", [1, 4, 16])
def test_gemv_and_int8_counters_stay_put_off_the_card(m):
    """A CPU tensor raises in ``fxp_matmul`` before any count moves (at
    every M of the GEMV), and ``int8_matmul`` takes its plain version on
    the CPU, forward and through the ops path's backward, with no count
    moving."""
    f, c = fm.fxp_matmul, im.int8_matmul
    counts = lambda: (f.launches, f.tc_launches, f.gemv_launches,  # noqa: E731
                      c.launches, c.tc_launches)
    before = counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        fm.fxp_matmul(torch.ones(m, 32, dtype=torch.bfloat16),
                      torch.ones(32, 16, dtype=torch.int8),
                      torch.tensor(0.5, dtype=torch.bfloat16))
    gen = torch.Generator().manual_seed(m)
    xq = torch.randint(-128, 128, (m, 32), generator=gen, dtype=torch.int8)
    wq = torch.randint(-128, 128, (32, 16), generator=gen, dtype=torch.int8)
    s = torch.tensor(0.25)
    assert torch.equal(im.int8_matmul(xq, wq, s), im.plain(xq, wq, s))
    sx = torch.tensor(0.5, requires_grad=True)
    sw = torch.tensor(0.25, requires_grad=True)
    y = ops.int8_matmul(xq, wq, sx, sw, use_pallas=True)
    y.sum().backward()
    assert sx.grad is not None and sw.grad is not None
    assert counts() == before

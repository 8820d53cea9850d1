"""The arithmetic of the tensor-core branches of ``fxp_qmatmul``,
``matmul_dx``, ``fxp_matmul`` and ``matmul_dw`` (``csrc/fxp_qmatmul.cu``
``fxp_qmatmul_tc``, ``csrc/fxp_matmul_bwd.cu`` ``matmul_dx_tc`` and
``matmul_dw_tc``, ``csrc/fxp_matmul.cu`` ``fxp_matmul_tc``), emulated in
plain PyTorch on the CPU and held against the port's plain versions and the
reference's Pallas kernels in interpret mode.

The word branches multiply bf16 activations by int8 words held as bf16, and
``matmul_dw_tc`` bf16 activations by bf16 gradients, so every product is
exact in f32. ``wgmma`` sums the 16 products of a k16
chunk and adds them to its f32 accumulator rounded toward zero; every
``PROMOTE`` steps of 64 along the contraction the kernel restarts the
accumulator and adds it into a total with round-to-nearest. The emulation
does the same (each chunk summed in f64, which is exact here, then added to
the accumulator in f64 and truncated to f32), so without a card it shows
that the promotion interval each kernel uses keeps the sums within
``chip_smoke.check_qmatmul``'s and ``check_matmul_bwd``'s bounds: f32
outputs within 1e-5·max|plain|, bf16 outputs within one bf16 ulp +
2^-16·max|plain|. Without promotion the drift toward zero passes the f32
bound at the LM head's contraction (N = 128256), and ``matmul_dw``'s
drift passes it at the registry's microbatch of 32 × 4096 rows.

The flash backward's tensor-core branch (``csrc/flash_attention_bwd.cu``,
``flash_dq_tc`` and ``flash_dkv_tc``) multiplies f32 P and g, split into
bf16 hi + lo, by bf16 K, Q and dO, and restarts its accumulators every
``PROMOTE`` tiles of 64 along the contraction. dkv contracts over the rep·Sq
query rows of a GQA group, dq over the Skv keys; the tests below emulate
both on llama3.2-3b's heads (rep 3, D = 128) with causal attention from a
numpy seed, up to the registry's longest training sequence (4096), and fix
the interval and the need for ``lo``.
"""
import functools
import math
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import fxp_matmul as jfm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels._build import CSRC  # noqa: E402
from repro_torch.kernels.ref import (ref_fxp_matmul, ref_fxp_qdense,  # noqa: E402
                                     ref_matmul_dw, ref_matmul_dx,
                                     ref_qdense_words)

STEP = 64                  # contraction per pipeline step, as the kernels
CHUNK = 16                 # contraction per wgmma


def _kernel_promote(source: str, namespace: str) -> int:
    """The ``PROMOTE`` constant of ``namespace`` in ``csrc/<source>``."""
    text = (CSRC / source).read_text()
    start = text.index(f"namespace {namespace} {{")
    body = text[start:text.index(f"}}  // namespace {namespace}", start)]
    return int(re.search(r"constexpr int PROMOTE = (\d+);", body).group(1))


# Steps between promotions, read from the kernels: tcf::PROMOTE
# (fxp_qmatmul_tc), tcdx::PROMOTE (matmul_dx_tc), tcfw::PROMOTE
# (fxp_matmul_tc) and tcdw::PROMOTE (matmul_dw_tc).
QMATMUL_PROMOTE = _kernel_promote("fxp_qmatmul.cu", "tcf")
DX_PROMOTE = _kernel_promote("fxp_matmul_bwd.cu", "tcdx")
FWD_PROMOTE = _kernel_promote("fxp_matmul.cu", "tcfw")
DW_PROMOTE = _kernel_promote("fxp_matmul_bwd.cu", "tcdw")
TRAIN_M = 2048             # chip_smoke's training rows: 4 x 512
MICROBATCH_M = 32 * 4096   # the registry's llama3.2-3b microbatch (8-way accumulation)
BWD_PROMOTE = _kernel_promote("flash_attention_bwd.cu", "tcb")   # both kernels
FL = 10                    # chip_smoke's FL; words of 0.02·N(0, 1) masters


def _toward_zero(v: torch.Tensor) -> torch.Tensor:
    """f64 ``v`` rounded to f32 toward zero."""
    r = v.to(torch.float32)
    over = r.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def emulate_tc(a: torch.Tensor, b: torch.Tensor, promote) -> torch.Tensor:
    """a (R, C) and b (C, Q) hold exact values whose products are exact in
    f32. Returns the f32 sums over C as the tensor-core branch forms them:
    per k16 chunk an exact sum added into the accumulator toward zero, the
    accumulator promoted into a round-to-nearest total every ``promote``
    steps of 64 (None: never)."""
    R, C = a.shape
    pad = -C % STEP
    a = torch.nn.functional.pad(a.double(), (0, pad))
    b = torch.nn.functional.pad(b.double(), (0, 0, 0, pad))
    n_chunks = (C + pad) // CHUNK
    chunks = torch.einsum("rcj,cjq->crq", a.view(R, n_chunks, CHUNK),
                          b.view(n_chunks, CHUNK, -1))
    per_block = n_chunks if promote is None else promote * STEP // CHUNK
    tot = torch.zeros(chunks.shape[1:], dtype=torch.float32)
    acc = torch.zeros_like(tot)
    for c in range(n_chunks):
        acc = _toward_zero(acc.double() + chunks[c])
        if (c + 1) % per_block == 0 or c == n_chunks - 1:
            tot = tot + acc
            acc = torch.zeros_like(acc)
    return tot


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(torch.bfloat16)


def _within(got: torch.Tensor, want: torch.Tensor) -> bool:
    """chip_smoke's bounds: f32 within 1e-5·max|want|; bf16 within one
    bf16 ulp at |want| + 2^-16·max|want|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype == torch.float32:
        return bool((err <= 1e-5 * w.abs().max()).all())
    e = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    return bool((err <= torch.exp2(e - 7) + 2.0 ** -16 * w.abs().max()).all())


def _qmatmul_case(m, k, n):
    rng = np.random.default_rng(k + n)
    x = _bf16(rng, (m, k))
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.02).astype(np.float32))
    fl = torch.tensor(FL, dtype=torch.int32)
    return x, w, fl


def _emulated_qmatmul(x, w, seed, fl, mode, promote):
    words = ops.qdense_words(w, seed, fl, mode).to(torch.float32)
    return emulate_tc(x.float(), words, promote) * 2.0 ** -int(fl)


def _dx_case(m, k, n):
    rng = np.random.default_rng(3 * n + k)
    dy = _bf16(rng, (m, n))
    wq = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    scale = torch.tensor(2.0 ** -FL, dtype=torch.bfloat16)
    return dy, wq, scale


def _emulated_dx(dy, wq, scale, promote):
    return emulate_tc(dy.float(), wq.float().T, promote) * scale.float()


@pytest.mark.parametrize("mode", [1, 0])
@pytest.mark.parametrize("k", [3072, 8192])
def test_qmatmul_promotion_within_bounds(k, mode):
    """Every training contraction of the forward (K = d_model or d_ff),
    with the words of the port's plain ``qdense_words``."""
    x, w, fl = _qmatmul_case(6, k, 24)
    seed = -(7 * 6 + k)
    got = _emulated_qmatmul(x, w, seed, fl, mode, QMATMUL_PROMOTE)
    for dt in (torch.float32, torch.bfloat16):
        want = ref_fxp_qdense(x, w, seed, fl, mode, out_dtype=dt)
        assert _within(got.to(dt), want), (dt, (got - want.float()).abs().max())


@pytest.mark.parametrize("n", [1024, 3072, 8192, 128256])
def test_dx_promotion_within_bounds(n):
    """Every training contraction of dx (N = d_model, the kv width, d_ff
    and the vocabulary), random int8 words."""
    dy, wq, scale = _dx_case(4, 12, n)
    got = _emulated_dx(dy, wq, scale, DX_PROMOTE)
    want = ref_matmul_dx(dy.float(), wq, scale.float())
    assert _within(got, want), (got - want).abs().max()
    assert _within(got.to(torch.bfloat16), ref_matmul_dx(dy, wq, scale))


def test_without_promotion_the_head_drifts():
    """The mutant that never promotes: at the head's N = 128256 its
    toward-zero drift passes the f32 bound."""
    dy, wq, scale = _dx_case(4, 12, 128256)
    want = ref_matmul_dx(dy.float(), wq, scale.float())
    assert not _within(_emulated_dx(dy, wq, scale, None), want)


@pytest.mark.parametrize("mode", [1, 0])
def test_qmatmul_emulation_matches_interpret_kernel(mode):
    """A small ragged shape against the reference's ``fxp_qmatmul`` in
    interpret mode, f32 and bf16 out."""
    x, w, fl = _qmatmul_case(9, 300, 70)
    seed = 77
    got = _emulated_qmatmul(x, w, seed, fl, mode, QMATMUL_PROMOTE)
    jx = jnp.asarray(interop.tensor_to_numpy(x))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jfm.fxp_qmatmul(jx, jnp.asarray(w.numpy()), jnp.int32(seed),
                               jnp.int32(FL), jnp.int32(mode), out_dtype=jdt,
                               interpret=True)
        want = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(dt)
        assert _within(got.to(dt), want), dt


def test_dx_emulation_matches_interpret_kernel():
    """A small ragged shape against the reference's ``matmul_dx`` in
    interpret mode, f32 and bf16 out."""
    dy, wq, scale = _dx_case(9, 70, 600)
    got = _emulated_dx(dy, wq, scale, DX_PROMOTE)
    jdy = jnp.asarray(interop.tensor_to_numpy(dy))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jfm.matmul_dx(jdy, jnp.asarray(wq.numpy()), jnp.float32(2.0 ** -FL),
                             out_dtype=jdt, interpret=True)
        want = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(dt)
        assert _within(got.to(dt), want), dt


def _fwd_case(m, k, n):
    rng = np.random.default_rng(5 * k + n)
    x = _bf16(rng, (m, k))
    wq = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    scale = torch.tensor(2.0 ** -FL, dtype=torch.bfloat16)
    return x, wq, scale


def _emulated_fwd(x, wq, scale, promote):
    return emulate_tc(x.float(), wq.float(), promote) * scale.float()


def _dw_case(m, k, n):
    rng = np.random.default_rng(m + 7 * k + n)
    return _bf16(rng, (m, k)), _bf16(rng, (m, n))


def _emulated_dw(x, dy, promote):
    return emulate_tc(x.float().T, dy.float(), promote)


@pytest.mark.parametrize("k", [3072, 8192])
def test_fxp_matmul_promotion_within_bounds(k):
    """The forward's training and prefill contractions (K = d_model and
    d_ff), random int8 words: f32 and bf16 out."""
    x, wq, scale = _fwd_case(6, k, 24)
    got = _emulated_fwd(x, wq, scale, FWD_PROMOTE)
    want = ref_fxp_matmul(x.float(), wq, scale.float(), out_dtype=torch.float32)
    assert _within(got, want), (got - want).abs().max()
    assert _within(got.to(torch.bfloat16), ref_fxp_matmul(x, wq, scale))


@pytest.mark.parametrize("m", [TRAIN_M, MICROBATCH_M])
def test_dw_promotion_within_bounds(m):
    """dw's contraction over the rows of a step: chip_smoke's 4 x 512 and
    the registry's microbatch of 32 x 4096, where the accumulation over
    microbatches adds these sums (so remat and accumulation need no other
    interval): f32 out within a quarter of the bound (the rest is left to
    the plain version's own f32 sums), and bf16 out within its bound."""
    x, dy = _dw_case(m, 4, 12)
    got = _emulated_dw(x, dy, DW_PROMOTE)
    want = ref_matmul_dw(x, dy)
    err = (got - want).abs().max()
    assert err <= 0.25 * 1e-5 * want.abs().max(), err
    assert _within(got.to(torch.bfloat16), want.to(torch.bfloat16))


def test_dw_without_promotion_drifts():
    """The mutant that never promotes: over the microbatch's 131072 rows
    its toward-zero drift passes the f32 bound (at M = 2048 it stays within
    it, and the kernel promotes all the same)."""
    x, dy = _dw_case(MICROBATCH_M, 4, 12)
    want = ref_matmul_dw(x, dy)
    assert not _within(_emulated_dw(x, dy, None), want)
    x, dy = _dw_case(TRAIN_M, 4, 12)
    assert _within(_emulated_dw(x, dy, None), ref_matmul_dw(x, dy))


def test_fxp_matmul_without_promotion_stays_within_bounds():
    """The forward's contraction is at most K = 8192: even the mutant that
    never promotes stays within the f32 bound there, so its interval is
    chosen for margin (as fxp_qmatmul_tc's), not forced."""
    x, wq, scale = _fwd_case(6, 8192, 24)
    want = ref_fxp_matmul(x.float(), wq, scale.float(), out_dtype=torch.float32)
    assert _within(_emulated_fwd(x, wq, scale, None), want)


def test_fxp_matmul_emulation_matches_interpret_kernel():
    """A small ragged shape against the reference's ``fxp_matmul`` in
    interpret mode, f32 and bf16 out."""
    x, wq, scale = _fwd_case(9, 300, 70)
    got = _emulated_fwd(x, wq, scale, FWD_PROMOTE)
    jx = jnp.asarray(interop.tensor_to_numpy(x))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jfm.fxp_matmul(jx, jnp.asarray(wq.numpy()), jnp.float32(2.0 ** -FL),
                              out_dtype=jdt, interpret=True)
        want = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(dt)
        assert _within(got.to(dt), want), dt


def test_dw_emulation_matches_interpret_kernel():
    """A small ragged shape (M = 600: the interpret kernel's M steps of 256
    with a tail) against the reference's ``matmul_dw`` in interpret mode,
    f32 out and its bf16 rounding."""
    x, dy = _dw_case(600, 9, 70)
    got = _emulated_dw(x, dy, DW_PROMOTE)
    want = jfm.matmul_dw(jnp.asarray(interop.tensor_to_numpy(x)),
                         jnp.asarray(interop.tensor_to_numpy(dy)), interpret=True)
    want = torch.from_numpy(np.asarray(want))
    assert want.dtype == torch.float32
    assert _within(got, want)
    assert _within(got.to(torch.bfloat16), want.to(torch.bfloat16))


def test_words_of_the_emulation_are_the_prologue_words():
    """The emulated forward reads the words the prologue kernels draw."""
    _, w, fl = _qmatmul_case(1, 67, 33)
    for mode in (1, 0):
        assert torch.equal(ops.qdense_words(w, 5, fl, mode),
                           ref_qdense_words(w, 5, fl, mode))


# ---------------------------------------------------------------------------
# The flash backward: f32 P and g split into bf16 hi + lo

REP, HEAD_DIM = 3, 128     # llama3.2-3b's GQA group and head dim
LONGEST_TRAIN_S = 4096     # the registry's longest training sequence
TILE = 64                  # rows (dkv) or keys (dq) per tile


def emulate_split(a: torch.Tensor, b: torch.Tensor, promote, lo=True):
    """a (R, C) f32, b (C, Q) holding bf16 values, C in the kernel's order.
    Returns the f32 sums over C as the tensor-core branch forms them: a split
    into bf16 hi + lo; per chunk of 16, hi·b then lo·b, each an exact sum
    added into the accumulator toward zero; the accumulator promoted into a
    round-to-nearest total every ``promote`` tiles of 64 (None: never).
    ``lo=False`` is the mutant that drops the low half."""
    hi = a.to(torch.bfloat16).float()
    parts = (hi, (a - hi).to(torch.bfloat16).float()) if lo else (hi,)
    tot = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    acc = torch.zeros_like(tot)
    bd = b.double()
    for c in range(0, a.shape[1], CHUNK):
        for part in parts:
            acc = _toward_zero(acc.double() + part[:, c:c + CHUNK].double()
                               @ bd[c:c + CHUNK])
        if promote is not None and (c + CHUNK) % (promote * TILE) == 0:
            tot, acc = tot + acc, torch.zeros_like(acc)
    return tot + acc


@functools.lru_cache(maxsize=None)
def _causal_attention(S: int):
    """One causal (1, S, REP, HEAD_DIM) query group against one kv head, bf16
    values from a numpy seed: q and dO (REP, S, D), k and v (S, D), and each
    row's lse and delta = dO·o (REP, S), computed in f32 by row blocks."""
    rng = np.random.default_rng(S)
    q, do = (_bf16(rng, (REP, S, HEAD_DIM)).float() for _ in range(2))
    k, v = (_bf16(rng, (S, HEAD_DIM)).float() for _ in range(2))
    scale = 1.0 / math.sqrt(HEAD_DIM)
    lse, delta = torch.empty(REP, S), torch.empty(REP, S)
    keys = torch.arange(S)
    for r in range(REP):
        for r0 in range(0, S, 1024):
            rows = torch.arange(r0, min(r0 + 1024, S))
            s = torch.where(keys[None] <= rows[:, None],
                            q[r, rows] @ k.T * scale, torch.tensor(-1e30))
            lse[r, rows] = torch.logsumexp(s, -1)
            o = torch.exp(s - lse[r, rows, None]) @ v
            delta[r, rows] = (o * do[r, rows]).sum(-1)
    return q, k, v, do, lse, delta, scale


def _p_and_g(s, dp, lse, delta, valid):
    p = torch.where(valid, torch.exp(s - lse), torch.zeros(()))
    return p, p * (dp - delta)


def _dkv_tile0(S: int):
    """dkv's contraction for the first key tile (reached by every row of
    every head): gᵀ and Pᵀ (64 keys, REP·S rows head-major), q and dO rows,
    and the exact dK and dV of the tile."""
    q, k, v, do, lse, delta, scale = _causal_attention(S)
    kt, vt = k[:TILE], v[:TILE]
    valid = torch.arange(TILE)[:, None] <= torch.arange(S)[None]
    p, g = _p_and_g(torch.einsum("kd,rsd->rks", kt, q) * scale,
                    torch.einsum("kd,rsd->rks", vt, do), lse[:, None],
                    delta[:, None], valid[None])
    pt = p.permute(1, 0, 2).reshape(TILE, REP * S)
    gt = g.permute(1, 0, 2).reshape(TILE, REP * S)
    qr, dor = q.reshape(REP * S, HEAD_DIM), do.reshape(REP * S, HEAD_DIM)
    dk = gt.double() @ qr.double() * scale
    dv = pt.double() @ dor.double()
    return (gt, qr, dk, scale), (pt, dor, dv, 1.0)


def _dq_last_rows(S: int):
    """dq's contraction for the last 64 rows of a head (they reach every
    key): g (64 rows, S keys), k, and the exact dQ of the rows."""
    q, k, v, do, lse, delta, scale = _causal_attention(S)
    rows = torch.arange(S - TILE, S)
    valid = torch.arange(S)[None] <= rows[:, None]
    _, g = _p_and_g(q[0, rows] @ k.T * scale, do[0, rows] @ v.T,
                    lse[0, rows, None], delta[0, rows, None], valid)
    return g, k, g.double() @ k.double() * scale, scale


def _sums_within(got: torch.Tensor, exact: torch.Tensor) -> float:
    """max|got − exact| in units of 1e-4·max|exact|: check_flash_bwd's f32
    bound, here on the sums before the output's bf16 rounding."""
    return float((got.double() - exact).abs().max()
                 / (1e-4 * exact.abs().max()))


def _bf16_out_within(got: torch.Tensor, exact: torch.Tensor) -> bool:
    """check_flash_bwd's bf16 bound: one bf16 ulp + 1e-4·max|exact|."""
    w = exact.float()
    err = (got.to(torch.bfloat16).float().double() - exact).abs()
    e = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    return bool((err <= torch.exp2(e - 7).double()
                 + 1e-4 * exact.abs().max()).all())


@pytest.mark.parametrize("seq", [512, LONGEST_TRAIN_S])
def test_flash_dkv_promotion_within_bounds(seq):
    """dK and dV of the key tile every row reaches, at the training shape's
    S = 512 and the registry's longest training S: with the kernel's
    interval the sums stay within a quarter of the f32 bound (the rest is
    left to the plain version's own f32 sums) and the bf16 outputs within
    check_flash_bwd's."""
    for a, b, exact, scale in _dkv_tile0(seq):
        got = emulate_split(a, b, BWD_PROMOTE) * scale
        assert _sums_within(got, exact) <= 0.25, _sums_within(got, exact)
        assert _bf16_out_within(got, exact)


def test_flash_dq_promotion_within_bounds():
    """dQ of the rows that reach every key, at the longest training S (its
    contraction, Skv keys, is a third of dkv's: without promotion its drift
    would stay within the budget too, and the kernel promotes all the
    same)."""
    g, k, exact, scale = _dq_last_rows(LONGEST_TRAIN_S)
    got = emulate_split(g, k, BWD_PROMOTE) * scale
    assert _sums_within(got, exact) <= 0.25
    assert _bf16_out_within(got, exact)


@pytest.mark.parametrize("seq", [512, LONGEST_TRAIN_S])
def test_flash_dkv_without_lo_fails(seq):
    """The mutant that multiplies only the bf16 hi of P and g: its dK and dV
    leave check_flash_bwd's bf16 bound, so the kernels keep lo."""
    for a, b, exact, scale in _dkv_tile0(seq):
        got = emulate_split(a, b, BWD_PROMOTE, lo=False) * scale
        assert not _bf16_out_within(got, exact)


def test_flash_dkv_without_promotion_drifts():
    """The mutant that never promotes: at the longest training S (12288 rows
    of a GQA group) its toward-zero drift alone takes the dK and dV sums
    past a quarter of the f32 bound, the budget the tests above hold the
    kernels to (at S = 8192 it reaches the whole bound); the kernel's
    interval keeps them under a tenth of it."""
    for a, b, exact, scale in _dkv_tile0(LONGEST_TRAIN_S):
        assert _sums_within(emulate_split(a, b, None) * scale, exact) > 0.25
        assert _sums_within(emulate_split(a, b, BWD_PROMOTE) * scale,
                            exact) < 0.1

"""The arithmetic of the tensor-core branches of ``fxp_qmatmul`` and
``matmul_dx`` (``csrc/fxp_qmatmul.cu`` ``fxp_qmatmul_tc``,
``csrc/fxp_matmul_bwd.cu`` ``matmul_dx_tc``), emulated in plain PyTorch on
the CPU and held against the port's plain versions and the reference's
Pallas kernels in interpret mode.

Both branches multiply bf16 activations by int8 words held as bf16, so
every product is exact in f32. ``wgmma`` sums the 16 products of a k16
chunk and adds them to its f32 accumulator rounded toward zero; every
``PROMOTE`` steps of 64 along the contraction the kernel restarts the
accumulator and adds it into a total with round-to-nearest. The emulation
does the same (each chunk summed in f64, which is exact here, then added to
the accumulator in f64 and truncated to f32), so without a card it shows
that the promotion interval each kernel uses keeps the sums within
``chip_smoke.check_qmatmul``'s and ``check_matmul_bwd``'s bounds: f32
outputs within 1e-5·max|plain|, bf16 outputs within one bf16 ulp +
2^-16·max|plain|. Without promotion the drift toward zero passes the f32
bound at the LM head's contraction (N = 128256).
"""
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
from repro_torch.kernels.ref import (ref_fxp_qdense, ref_matmul_dx,  # noqa: E402
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
# (fxp_qmatmul_tc) and tcdx::PROMOTE (matmul_dx_tc).
QMATMUL_PROMOTE = _kernel_promote("fxp_qmatmul.cu", "tcf")
DX_PROMOTE = _kernel_promote("fxp_matmul_bwd.cu", "tcdx")
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


def test_words_of_the_emulation_are_the_prologue_words():
    """The emulated forward reads the words the prologue kernels draw."""
    _, w, fl = _qmatmul_case(1, 67, 33)
    for mode in (1, 0):
        assert torch.equal(ops.qdense_words(w, 5, fl, mode),
                           ref_qdense_words(w, 5, fl, mode))

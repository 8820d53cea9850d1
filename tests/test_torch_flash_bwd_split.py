"""The arithmetic of the flash backward's tensor-core branch
(``csrc/flash_attention_bwd.cu``, ``flash_dq_tc`` and ``flash_dkv_tc``),
emulated in plain PyTorch on the CPU and held against the reference's
Pallas ``flash_attention_bwd`` in interpret mode.

The branch takes bf16 q/k/v/dO. Per tile it forms S = Q Kᵀ and dP = dO Vᵀ
(dq) or Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (dkv) from the bf16 values with wgmma's
f32 sums, which round toward zero after every 16-wide chunk of the
contraction; computes p and g in f32 under the mask; splits each into bf16
hi + lo and adds hi·B and lo·B, chunk by chunk, into f32 accumulators that
restart into round-to-nearest totals every ``PROMOTE`` tiles of the
kernel's loop. The emulation walks the same tiles in the same order (dq:
the key tiles each 64-row warpgroup reaches; dkv: for each 64-key tile the
query tiles of every head of the GQA group that can reach it), so without a
card it shows that the numeric design fits ``chip_smoke.check_flash_bwd``'s
bound for bf16 outputs: |out − reference| <= one bf16 ulp at |reference| +
1e-4·max|reference|.
"""
import math
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels._build import CSRC  # noqa: E402

TILE = 64          # keys per dq tile and per dkv CTA; query rows per dkv tile
CTA_ROWS = 128     # query rows per dq CTA (two warpgroups of 64)
CHUNK = 16         # contraction per wgmma
PROMOTE = int(re.search(
    r"namespace tcb \{.*?constexpr int PROMOTE = (\d+);",
    (CSRC / "flash_attention_bwd.cu").read_text(), re.S).group(1))


def _toward_zero(v: torch.Tensor) -> torch.Tensor:
    """f64 ``v`` rounded to f32 toward zero."""
    r = v.to(torch.float32)
    over = r.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _mma(acc, a, b):
    """acc + a @ b as wgmma forms it (a, b hold bf16 values): per chunk of 16
    along the contraction an exact sum, added to the f32 accumulator toward
    zero."""
    for c in range(0, a.shape[-1], CHUNK):
        part = a[..., c:c + CHUNK].double() @ b[..., c:c + CHUNK, :].double()
        acc = _toward_zero(acc.double() + part)
    return acc


def _mma_split(acc, x, b):
    """acc + x @ b with the f32 ``x`` split into bf16 hi + lo: per chunk of
    16 along the contraction, hi·b then lo·b, each added toward zero."""
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    for c in range(0, x.shape[-1], CHUNK):
        for part in (hi, lo):
            s = part[..., c:c + CHUNK].double() @ b[..., c:c + CHUNK, :].double()
            acc = _toward_zero(acc.double() + s)
    return acc


def _valid(rows, keys, q_offset, causal, window):
    qpos = rows[:, None] + q_offset
    ok = torch.ones(len(rows), len(keys), dtype=torch.bool)
    if causal:
        ok &= keys[None] <= qpos
    if window > 0:
        ok &= keys[None] > qpos - window
    return ok


def _probs(s, dp, lse, delta, valid, scale, softcap):
    """p and g of the kernels' ``probs`` in f32, elementwise."""
    t = s * scale
    if softcap > 0:
        t = softcap * torch.tanh(t / softcap)
    p = torch.where(valid, torch.exp(t - lse), torch.zeros(()))
    g = p * (dp - delta)
    if softcap > 0:
        c = t / softcap
        g = g * (1.0 - c * c)
    return p, g


def emulate_tc_backward(q, k, v, do, lse, delta, *, causal, window, softcap,
                        scale=None, promote=PROMOTE):
    """q/do (B, Sq, H, D), k/v (B, Skv, Hkv, D) bf16; lse/delta (B, H, Sq)
    f32. Returns (dq, dk, dv) in bf16 as the tensor-core branch forms them."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q_offset = Skv - Sq
    qf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, do))   # (B, H, S, D)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))     # (B, Hkv, S, D)
    kr, vr = (t.repeat_interleave(rep, 1) for t in (kf, vf))

    dq = torch.zeros(B, H, Sq, D)
    for c0 in range(0, Sq, CTA_ROWS):
        kv_lo, kv_hi = 0, Skv
        if causal:
            kv_hi = min(Skv, c0 + CTA_ROWS + q_offset)
        if window > 0:
            kv_lo = max(0, c0 + q_offset - window + 1)
        kv_lo = kv_lo // TILE * TILE
        for w0 in range(c0, min(c0 + CTA_ROWS, Sq), TILE):
            rows = torch.arange(w0, min(w0 + TILE, Sq))
            qmin, qmax = w0 + q_offset, w0 + q_offset + TILE - 1
            acc = torch.zeros(B, H, len(rows), D)
            tot = torch.zeros_like(acc)
            done = 0
            for k0 in range(kv_lo, kv_hi, TILE):
                if (causal and k0 > qmax) or \
                        (window > 0 and k0 + TILE - 1 <= qmin - window):
                    continue
                keys = torch.arange(k0, min(k0 + TILE, Skv))
                s = _mma(torch.zeros(B, H, len(rows), len(keys)), qf[:, :, rows],
                         kr[:, :, keys].transpose(-1, -2))
                dp = _mma(torch.zeros_like(s), dof[:, :, rows],
                          vr[:, :, keys].transpose(-1, -2))
                _, g = _probs(s, dp, lse[:, :, rows, None],
                              delta[:, :, rows, None],
                              _valid(rows, keys, q_offset, causal, window),
                              scale, softcap)
                acc = _mma_split(acc, g, kr[:, :, keys])
                done += 1
                if done % promote == 0:
                    tot, acc = tot + acc, torch.zeros_like(acc)
            dq[:, :, rows] = (tot + acc) * scale

    dk = torch.zeros(B, Hkv, Skv, D)
    dv = torch.zeros(B, Hkv, Skv, D)
    for k0 in range(0, Skv, TILE):
        keys = torch.arange(k0, min(k0 + TILE, Skv))
        k1 = int(keys[-1]) + 1
        q_lo, q_hi = 0, Sq
        if causal:
            q_lo = max(0, k0 - q_offset)
        if window > 0:
            q_hi = min(Sq, k1 - 1 + window - q_offset)
        q_lo = q_lo // TILE * TILE
        acc_k = torch.zeros(B, Hkv, len(keys), D)
        acc_v, tot_k, tot_v = (torch.zeros_like(acc_k) for _ in range(3))
        j = 0
        for r in range(rep):
            heads = torch.arange(Hkv) * rep + r
            for q0 in range(q_lo, q_hi, TILE):
                rows = torch.arange(q0, min(q0 + TILE, Sq))
                qt = qf[:, heads][:, :, rows]                      # (B, Hkv, n, D)
                ot = dof[:, heads][:, :, rows]
                st = _mma(torch.zeros(B, Hkv, len(keys), len(rows)),
                          kf[:, :, keys], qt.transpose(-1, -2))
                dpt = _mma(torch.zeros_like(st), vf[:, :, keys],
                           ot.transpose(-1, -2))
                pt, gt = _probs(st, dpt, lse[:, heads][:, :, None, rows],
                                delta[:, heads][:, :, None, rows],
                                _valid(rows, keys, q_offset, causal,
                                       window).T, scale, softcap)
                acc_v = _mma_split(acc_v, pt, ot)
                acc_k = _mma_split(acc_k, gt, qt)
                j += 1
                if j % promote == 0:
                    tot_k, acc_k = tot_k + acc_k, torch.zeros_like(acc_k)
                    tot_v, acc_v = tot_v + acc_v, torch.zeros_like(acc_v)
        dk[:, :, keys] = (tot_k + acc_k) * scale
        dv[:, :, keys] = tot_v + acc_v
    return tuple(t.permute(0, 2, 1, 3).to(torch.bfloat16) for t in (dq, dk, dv))


def _bf16_ulp(t):
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _to_torch(a):
    return torch.from_numpy(np.asarray(a.astype(jnp.float32)))


CASES = [
    # name, B, Sq, Skv, H, Hkv, D, causal, window, softcap
    ("causal GQA rep 3", 1, 192, 192, 3, 1, 128, True, 0, 0.0),
    ("sq<skv", 1, 77, 200, 3, 1, 128, True, 0, 0.0),
    ("window+softcap", 1, 150, 150, 2, 1, 64, True, 37, 30.0),
    ("no-key rows", 1, 100, 60, 2, 2, 128, True, 0, 0.0),
    ("non-causal ragged", 1, 45, 45, 2, 2, 96, False, 0, 0.0),
    ("causal D=64", 2, 130, 130, 2, 1, 64, True, 0, 0.0),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_backward_fits_the_bound(case):
    _, B, Sq, Skv, H, Hkv, D, causal, window, softcap = case
    rng = np.random.default_rng(Sq * 11 + D)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                        (B, Sq, H, D))]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (tq, tk, tv, tdo))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = jax_flash.flash_attention(jq, jk, jv, interpret=True,
                                       return_lse=True, **kw)
    want = jax_flash.flash_attention_bwd(jq, jk, jv, o, lse, jdo,
                                         interpret=True, **kw)
    to = _to_torch(o).to(torch.bfloat16)
    tlse = torch.from_numpy(np.asarray(lse))
    delta = (tdo.float() * to.float()).sum(-1).permute(0, 2, 1)
    got = emulate_tc_backward(tq, tk, tv, tdo, tlse, delta, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = _to_torch(w)
        err = (g.float() - w).abs()
        tol = _bf16_ulp(w) + 1e-4 * w.abs().max()
        assert bool((err <= tol).all()), (name, float(err.max()))
    if causal and Sq > Skv:
        dead = torch.arange(Sq) + (Skv - Sq) < 0
        assert bool((got[0][:, dead] == 0).all())


def _qkvd(Sq, Skv, D, dtype, H=4, Hkv=2):
    return (torch.zeros(1, Sq, H, D, dtype=dtype),
            torch.zeros(1, Skv, Hkv, D, dtype=dtype),
            torch.zeros(1, Skv, Hkv, D, dtype=dtype),
            torch.zeros(1, Sq, H, D, dtype=dtype))


@pytest.mark.parametrize("Sq, Skv, D, dtype, want", [
    (64, 64, 128, torch.bfloat16, True),
    (77, 200, 64, torch.bfloat16, True),
    (45, 45, 96, torch.bfloat16, True),
    (40, 21, 32, torch.bfloat16, True),
    (64, 64, 256, torch.bfloat16, False),     # past the branch's limit
    (33, 40, 72, torch.bfloat16, False),      # not a multiple of 16
    (64, 64, 128, torch.float32, False),
    (0, 64, 128, torch.bfloat16, False),
    (64, 0, 128, torch.bfloat16, False),
])
def test_backward_branch_by_dtype_and_shape(Sq, Skv, D, dtype, want):
    """``flash_attention_dq``/``_dkv`` take the tensor cores for bf16 with a
    head dim that is a multiple of 16 up to 128, at least one query and one
    key, by dtype and shape alone."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.bwd_takes_tensor_cores(*_qkvd(Sq, Skv, D, dtype)) is want


def test_backward_branch_needs_aligned_bases():
    """TMA reads the four inputs: a base off a 16-byte boundary takes the
    SIMT kernel."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _qkvd(64, 64, 128, torch.bfloat16)
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    assert fa.bwd_takes_tensor_cores(q, k, v, do)
    assert not fa.bwd_takes_tensor_cores(q, k, v, shifted)
    assert not fa.bwd_takes_tensor_cores(shifted, k, v, do)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_counters_stay_put_off_the_card(dtype):
    """On CPU tensors of either dtype (bf16 would take the tensor-core
    kernels, f32 the SIMT ones) the wrappers raise before any count moves,
    and attention's backward on the CPU (the plain version) moves none."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    fns = (fa.flash_attention_dq, fa.flash_attention_dkv)
    before = [(f.launches, f.tc_launches) for f in fns]
    q, k, v, do = _qkvd(8, 8, 16, dtype)
    lse = torch.zeros(1, 4, 8)
    for f in fns:
        with pytest.raises(RuntimeError, match="CUDA"):
            f(q, k, v, do, lse, lse)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.attention(*leaves, causal=True, use_pallas=True)
    out.backward(torch.ones_like(out))
    assert all(t.grad is not None for t in leaves)
    assert [(f.launches, f.tc_launches) for f in fns] == before

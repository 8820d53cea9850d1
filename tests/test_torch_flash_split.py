"""The arithmetic of the flash forward's tensor-core branch
(``csrc/flash_attention.cu``, ``flash_fwd_tc``), emulated in plain PyTorch
on the CPU and held against the reference's Pallas ``flash_attention`` in
interpret mode.

The branch takes bf16 q/k/v. Per tile of 64 keys it forms S = Q Kᵀ from
the bf16 values with f32 sums (the products are exact), runs the online
softmax in f32, splits P = exp(S − m) into bf16 P_hi + P_lo and adds both
P_hi V and P_lo V into one f32 accumulator. The emulation does the same
tile by tile, so without a card it shows that the numeric design fits
``chip_smoke.check_flash``'s bound for bf16 outputs: |o − reference| <= one
bf16 ulp at |reference| + 1e-4, and lse within 1e-4.
"""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash  # noqa: E402

BKV = 64           # keys per tile, as the kernel
NEG = -1e30        # lse of a row that no key reaches


def emulate_tc_forward(q, k, v, *, causal, window, softcap, scale=None):
    """q (B, Sq, H, D), k/v (B, Skv, Hkv, D), bf16. Returns o (bf16) and
    lse (B, H, Sq) f32 computed as the tensor-core branch does."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf, kf, vf = (t.float() for t in (q, k, v))
    kf = kf.repeat_interleave(H // Hkv, dim=2)
    vf = vf.repeat_interleave(H // Hkv, dim=2)
    qpos = torch.arange(Sq) + (Skv - Sq)
    m = torch.full((B, H, Sq), -math.inf)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, D))
    qt = qf.permute(0, 2, 1, 3)                              # (B, H, Sq, D)
    for k0 in range(0, Skv, BKV):
        kt = kf[:, k0:k0 + BKV].permute(0, 2, 1, 3)          # (B, H, n, D)
        vt = vf[:, k0:k0 + BKV].permute(0, 2, 1, 3)
        x = (qt @ kt.transpose(-1, -2)) * scale
        if softcap > 0:
            x = softcap * torch.tanh(x / softcap)
        kpos = torch.arange(k0, k0 + kt.shape[2])
        valid = torch.ones(Sq, kt.shape[2], dtype=torch.bool)
        if causal:
            valid &= kpos[None] <= qpos[:, None]
        if window > 0:
            valid &= kpos[None] > qpos[:, None] - window
        x = torch.where(valid, x, torch.tensor(-math.inf))
        m_new = torch.maximum(m, x.amax(-1))
        mu = torch.where(m_new == -math.inf, torch.zeros(()), m_new)
        alpha = torch.exp(m - mu)
        p = torch.exp(x - mu[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        acc = acc * alpha[..., None]
        acc = acc + hi @ vt
        acc = acc + lo @ vt
        m = m_new
    dead = m == -math.inf
    o = torch.where(dead[..., None], torch.zeros(()), acc / l[..., None])
    lse = torch.where(dead, torch.tensor(NEG), m + torch.log(l))
    return o.permute(0, 2, 1, 3).to(torch.bfloat16), lse


def _bf16_ulp(t):
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


CASES = [
    # name, B, Sq, Skv, H, Hkv, D, causal, window, softcap
    ("prefill, 2 heads", 4, 128, 128, 2, 1, 128, True, 0, 0.0),
    ("window+softcap", 1, 150, 150, 2, 1, 64, True, 37, 30.0),
    ("no-key rows", 1, 100, 60, 2, 2, 128, True, 0, 0.0),
    ("non-causal", 1, 45, 45, 2, 2, 96, False, 0, 0.0),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_p_fits_the_bound(case):
    _, B, Sq, Skv, H, Hkv, D, causal, window, softcap = case
    rng = np.random.default_rng(Sq * 7 + D)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = emulate_tc_forward(tq, tk, tv, **kw)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tq, tk, tv))
    want_o, want_lse = jax_flash.flash_attention(jq, jk, jv, interpret=True,
                                                 return_lse=True, **kw)
    want_o = torch.from_numpy(np.asarray(want_o.astype(jnp.float32)))
    want_lse = torch.from_numpy(np.asarray(want_lse))
    err = (o.float() - want_o).abs()
    assert bool((err <= _bf16_ulp(want_o) + 1e-4).all()), err.max()
    assert float((lse - want_lse).abs().max()) <= 1e-4
    if Sq > Skv and causal:
        dead = torch.arange(Sq) + (Skv - Sq) < 0
        assert bool((o[:, dead] == 0).all())
        assert bool((lse[:, :, dead] == NEG).all())

"""Mamba2 block via SSD, state-space duality (counterpart of
``repro/models/ssm.py``, arXiv:2405.21060).

The sequence is split into chunks of length Q: within a chunk the SSD's
attention-like contractions are batched matrix products, and across chunks
a loop over the chunks carries the (H, P, N) state, where the reference
``lax.scan``s. The reference has no Pallas kernel here; its contractions
are XLA's, and the port's are library products (f32, TF32 off).

The SSM dynamics parameters (a_log, dt_bias) and the recurrent state stay
float32; the projections and the conv kernel are AdaPT-quantized leaves,
and so is ``d_skip``, a stacked (L, H) leaf with one ⟨WL,FL⟩ per tensor.

Decode runs the O(1) recurrent form against a persistent (conv, ssm)
state, written in place so that the continuous batcher's CUDA graph can
capture it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import common


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, num_ssm_heads, head_dim, state)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_head_dim
    return d_inner, d_inner // hd, hd, cfg.ssm_state


def init_layer(generator: torch.Generator, cfg: ModelConfig, num_layers: int,
               device=None) -> Dict[str, torch.Tensor]:
    """The reference's distributions and constants, drawn by ``generator``
    (the same distribution, not the same bits)."""
    d = cfg.d_model
    di, nh, hd, n = dims(cfg)
    kw = cfg.ssm_conv_width
    L = (num_layers,) if num_layers > 0 else ()

    def full(shape, value):
        return torch.full(L + shape, value, dtype=torch.float32, device=device)

    # in_proj packs [z (di) | x (di) | B (n) | C (n) | dt (nh)]
    return {
        "in_proj": common.init_dense(generator, L + (d, 2 * di + 2 * n + nh),
                                     device=device),
        "conv_w": common.init_dense(generator, L + (kw, di + 2 * n),
                                    device=device) * (kw ** 0.5),
        "out_proj": common.init_dense(generator, L + (di, d), device=device),
        "a_log": full((nh,), 0.0),        # A = -exp(a_log) = -1
        "dt_bias": full((nh,), -1.0),     # softplus(-1) ≈ 0.31
        "d_skip": full((nh,), 1.0),
        "gate_norm": full((di,), 0.0),
        "pre_norm": full((d,), 0.0),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C), w: (K, C); causal, the K taps summed in order in f32,
    the result in x's dtype."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].to(torch.float32) * w[i].to(torch.float32)
    return out.to(x.dtype)


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    di, nh, hd, n = dims(cfg)
    xbc_end = 2 * di + 2 * n
    return proj[..., :di], proj[..., di:xbc_end], proj[..., xbc_end:]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, d_skip: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x: (b, s, h, p); dt: (b, s, h) f32; a_log, d_skip: (h,);
    B, C: (b, s, n), one group shared across heads. Returns (y (b, s, h, p)
    in x's dtype, the final state (b, h, p, n) f32).

    The reference's einsums are taken as batched products laid out
    (b, nc, h, i, j), so that nothing larger than the (b, nc, h, q, q)
    decay tensor is built."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:  # zero-pad to a chunk multiple: dt = 0 makes the pads no-ops
        def zp(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        y, h_final = ssd_chunked(zp(x), zp(dt), a_log, zp(B), zp(C), d_skip,
                                 chunk)
        return y[:, :s], h_final
    nc = s // q
    f32 = torch.float32
    xf = x.to(f32)
    A = -torch.exp(a_log.to(f32))                             # (h,) negative
    dA = dt * A                                               # (b, s, h)

    xc = xf.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    dAc = dA.reshape(b, nc, q, h)
    Bc = B.to(f32).reshape(b, nc, q, n)
    Cc = C.to(f32).reshape(b, nc, q, n)

    seg = torch.cumsum(dAc, dim=2)                            # (b, nc, q, h)
    segh = seg.permute(0, 1, 3, 2)                            # (b, nc, h, q)

    # intra-chunk (quadratic in q). The reference takes where(causal,
    # exp(rel), 0): above the diagonal rel is a sum of up to q − 1 values
    # of dt > 0, which passes f32's exp range (88.7) at q = 256 with dt
    # near its initial 0.31, and exp's backward multiplies the masked
    # zero gradient by inf there, so the reference's gradients are NaN at
    # full width. Masking before exp gives the same decay matrix, and the
    # same gradients wherever the reference's are finite.
    rel = segh[..., :, None] - segh[..., None, :]             # (b, nc, h, i, j)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(causal, rel, -torch.inf))       # decay matrix
    del rel
    scores = torch.matmul(Cc, Bc.transpose(-1, -2))           # (b, nc, i, j)
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)        # (b, nc, h, j, p)
    y_diag = torch.matmul(L * scores[:, :, None], xdt)        # (b, nc, h, i, p)

    # chunk boundary states
    sdec = torch.exp(seg[:, :, -1:] - seg)                    # (b, nc, q, h)
    wx = (xc * (sdec * dtc)[..., None]).permute(0, 1, 3, 4, 2)  # (b,nc,h,p,j)
    states = torch.matmul(wx, Bc[:, :, None])                 # (b, nc, h, p, n)
    cdec = torch.exp(torch.sum(dAc, dim=2))                   # (b, nc, h)

    # inter-chunk recurrence (a short loop over nc)
    hprev = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * cdec[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                           # (b, nc, h, p, n)

    # off-diagonal: y_i += exp(seg_i) C_i · H_in
    y_off = torch.matmul(Cc[:, :, None], h_in.transpose(-1, -2))
    y_off = y_off * torch.exp(segh)[..., None]                # (b, nc, h, i, p)

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    y = y + xf * d_skip.to(f32)[None, None, :, None]
    return y.to(x.dtype), hprev


def apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
          return_state: bool = False, use_pallas: bool = False):
    """Full-sequence mamba2 block with residual. x: (B, S, D).

    ``return_state=True`` also returns the decode cache as of the last
    position (the prefill's handoff to decode): the last kw − 1 inputs of
    the conv and the SSM state. A prompt shorter than kw − 1 tokens raises
    ``ValueError``: the reference's slice ``xbc_raw[:, s - (kw - 1):]``
    wraps there and gives a cache of the wrong shape."""
    di, nh, hd, n = dims(cfg)
    bsz, s, _ = x.shape
    kw = p["conv_w"].shape[-2]
    if return_state and s < kw - 1:
        raise ValueError(f"a mamba prefill needs at least {kw - 1} tokens "
                         f"(the conv's window less one), got {s}")
    h = common.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    proj = common.dense(h, p["in_proj"], use_pallas=use_pallas)
    z, xbc_raw, dtraw = _split_proj(proj, cfg)
    xbc = common.act_fn(causal_depthwise_conv(xbc_raw, p["conv_w"]), "silu")
    xin = xbc[..., :di]
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = softplus(dtraw.to(torch.float32) + p["dt_bias"].to(torch.float32))
    y, h_final = ssd_chunked(xin.reshape(bsz, s, nh, hd), dt, p["a_log"],
                             B, C, p["d_skip"], cfg.ssm_chunk)
    y = y.reshape(bsz, s, di)
    gate = common.act_fn(z.to(torch.float32), "silu").to(y.dtype)
    y = common.rms_norm(y * gate, p["gate_norm"], cfg.norm_eps)
    out = common.dense(y, p["out_proj"], use_pallas=use_pallas)
    if return_state:
        return x + out, {"conv": xbc_raw[:, s - (kw - 1):], "ssm": h_final}
    return x + out


def init_cache(cfg: ModelConfig, batch: int, num_layers: int,
               dtype=torch.float32, *, device=None) -> Dict[str, torch.Tensor]:
    """Decode-time state: the rolling conv inputs (in ``dtype``) and the
    recurrent SSM state (f32)."""
    di, nh, hd, n = dims(cfg)
    kw = cfg.ssm_conv_width
    L = (num_layers,) if num_layers > 0 else ()
    return {
        "conv": torch.zeros(L + (batch, kw - 1, di + 2 * n), dtype=dtype,
                            device=device),
        "ssm": torch.zeros(L + (batch, nh, hd, n), dtype=torch.float32,
                           device=device),
    }


def apply_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: ModelConfig, cache: Dict[str, torch.Tensor],
                 use_pallas: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step. x: (B, 1, D); cache {"conv": (B, kw − 1,
    C), "ssm": (B, H, P, N)}. The new conv window and SSM state are written
    into the cache tensors IN PLACE (the reference returns new ones) and
    the cache is returned; nothing is copied from the host."""
    di, nh, hd, n = dims(cfg)
    f32 = torch.float32
    h = common.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    proj = common.dense(h, p["in_proj"], use_pallas=use_pallas)
    z, xbc, dtraw = _split_proj(proj, cfg)

    conv_in = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(f32)                                   # (K, C)
    xbc1 = torch.sum(conv_in.to(f32) * w[None], dim=1, keepdim=True)
    xbc1 = common.act_fn(xbc1, "silu").to(x.dtype)
    cache["conv"].copy_(conv_in[:, 1:])

    xin = xbc1[..., :di].reshape(-1, nh, hd).to(f32)          # (B, H, P)
    B_ = xbc1[:, 0, di:di + n].to(f32)                        # (B, N)
    C_ = xbc1[:, 0, di + n:].to(f32)
    dt = softplus(dtraw[:, 0].to(f32) + p["dt_bias"].to(f32))  # (B, H)
    A = -torch.exp(p["a_log"].to(f32))
    dec = torch.exp(dt * A)                                   # (B, H)
    upd = dt[:, :, None, None] * xin[..., None] * B_[:, None, None, :]
    ssm = cache["ssm"]
    ssm.mul_(dec[:, :, None, None]).add_(upd)                 # (B, H, P, N)
    y = torch.matmul(ssm, C_[:, None, :, None])[..., 0]       # (B, H, P)
    y = y + xin * p["d_skip"][None, :, None]
    y = y.reshape(-1, 1, di).to(x.dtype)
    gate = common.act_fn(z.to(f32), "silu").to(y.dtype)
    y = common.rms_norm(y * gate, p["gate_norm"], cfg.norm_eps)
    out = common.dense(y, p["out_proj"], use_pallas=use_pallas)
    return x + out, cache

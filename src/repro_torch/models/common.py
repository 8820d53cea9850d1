"""Shared model building blocks (counterpart of ``repro/models/common.py``):
plain functions over tensors and param dicts. The reference's sharding
annotations are no-ops on one device and are left out."""
from __future__ import annotations

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core import init as weight_init


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.to(torch.float32))).to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return logits
    return cap * torch.tanh(logits / cap)


def act_fn(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    # x * sigmoid(x) in two roundings, as XLA evaluates jax.nn.silu in bf16
    return x * torch.sigmoid(x)


def dense(x: torch.Tensor, w, *, use_pallas: bool = False) -> torch.Tensor:
    """x @ w with f32 accumulation, returned in x's dtype.

    ``w`` is a plain weight (cast to x's dtype first, as the reference's
    ``jnp.dot(x, w.astype(x.dtype))``) or a packed ⟨q8, sc, wref⟩ dict,
    which under ``use_pallas`` goes whole to the fxp matmul (the kernel on
    the card, so no dequantized weight exists in device memory)."""
    if isinstance(w, dict):
        return _dense_quantized(x, w, use_pallas)
    y = torch.matmul(x.to(torch.float32), w.to(x.dtype).to(torch.float32))
    return y.to(x.dtype)


def _dense_quantized(x: torch.Tensor, w: dict, use_pallas: bool
                     ) -> torch.Tensor:
    """Dense over a packed dict; x may be (..., K): leading dims are
    flattened into M for the 2-D kernel."""
    from repro_torch.kernels import ops

    if not fxp.is_packed(w):
        raise TypeError(f"dense: unrecognized weight dict keys {set(w)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if use_pallas:
        y2 = ops.fxp_dense(x2, w["q8"], w["sc"].reshape(()), w["wref"],
                           use_pallas=True, out_dtype=x.dtype)
    else:
        wd = fxp.dequant_packed(w["q8"], w["sc"], w["wref"])
        y2 = torch.matmul(x2.to(torch.float32),
                          wd.to(x.dtype).to(torch.float32)).to(x.dtype)
    return y2.reshape(lead + (y2.shape[-1],))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    half = d // 2
    # log(theta) in f32, as jnp.log of a weakly typed float
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device))
    freq = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32,
                                               device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq        # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if 2 * half < d:  # odd head dim: pass the tail through
        rot = torch.cat([rot, x[..., 2 * half:]], dim=-1)
    return rot.to(x.dtype)


def embed_lookup(table, ids: torch.Tensor, scale_by_dim: bool = False
                 ) -> torch.Tensor:
    """Rows of ``table`` at ``ids``. ``table`` may be a packed dict: its rows
    are gathered before they are dequantized, which gives the bf16 values
    of dequantizing the whole table first without writing that table."""
    idx = ids.to(torch.long)
    if fxp.is_packed(table):
        out = fxp.dequant_packed(table["q8"][idx], table["sc"])
        d = table["q8"].shape[-1]
    else:
        out = table[idx]
        d = table.shape[-1]
    if scale_by_dim:
        out = out * torch.tensor(d ** 0.5, dtype=out.dtype, device=out.device)
    return out


def init_dense(generator: torch.Generator, shape, scale: float = 1.0,
               device=None) -> torch.Tensor:
    return weight_init.tnvs(generator, shape, scale=scale, kind="linear",
                            device=device)


def init_embed(generator: torch.Generator, vocab: int, d: int,
               scale: float = 1.0, device=None) -> torch.Tensor:
    return weight_init.tnvs(generator, (vocab, d), scale=scale, kind="embed",
                            device=device)

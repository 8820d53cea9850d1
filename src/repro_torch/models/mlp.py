"""Gated MLP (SwiGLU / GeGLU) block (counterpart of ``repro/models/mlp.py``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import sharding as shd
from repro_torch.config import ModelConfig
from repro_torch.models import common


def init_layer(generator: torch.Generator, cfg: ModelConfig, num_layers: int,
               d_ff: int | None = None, device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    L = (num_layers,) if num_layers > 0 else ()
    return {
        "wi_gate": common.init_dense(generator, L + (d, f), device=device),
        "wi_up": common.init_dense(generator, L + (d, f), device=device),
        "wo": common.init_dense(generator, L + (f, d), device=device),
        "pre_norm": torch.zeros(L + (d,), dtype=torch.float32, device=device),
    }


def apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
          residual: bool = True, use_pallas: bool = False) -> torch.Tensor:
    """The gated MLP. On a model axis of more than one rank
    (``sharding.model_group``) ``wi_gate``/``wi_up`` are column-parallel
    and ``wo`` row-parallel: each rank computes its block of the hidden
    units, and the output's f32 partials are summed over the ranks."""
    h = common.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    group = shd.model_group()
    if group is not None:
        gate, up = common.column_dense(h, [p["wi_gate"], p["wi_up"]], group)
        act = common.act_fn(gate, cfg.act_fn) * up
        out = common.row_dense(act, p["wo"], group,
                               common.tp_reduce_dtype(act, group))
    else:
        gate = common.dense(h, p["wi_gate"], use_pallas=use_pallas)
        up = common.dense(h, p["wi_up"], use_pallas=use_pallas)
        out = common.dense(common.act_fn(gate, cfg.act_fn) * up, p["wo"],
                           use_pallas=use_pallas)
    if "post_norm" in p:
        out = common.rms_norm(out, p["post_norm"], cfg.norm_eps)
    return x + out if residual else out

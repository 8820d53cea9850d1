"""Mixture-of-Experts FFN (counterpart of ``repro/models/moe.py``): top-k
routing with capacity-bounded dispatch, on one device.

mixtral-8x22b: 8 experts top-2; arctic-480b: 128 experts top-2 *plus* a
parallel dense residual FFN over the same normed input.

The reference splits the tokens into groups of its mesh's data-parallel
size; on one device that is one group, so the capacity, the ranks and the
drop slot are those of ``g = 1``, computed in Python from static shapes.

The router stays float32 and is excluded from AdaPT quantization
(``QuantConfig.exclude``): its gradient reaches it only through the top-k
softmax weights. The expert stacks ``we_*`` are not dense-layer names
(``fixed_point.DENSE_PARAM_NAMES``), so they are always dequantized to
their bf16 values before the layer uses them; the dense residual's
``dense/wi_gate|wi_up|wo`` are, and take the fxp kernels under
``use_pallas``.

Nothing in ``apply`` reads back to the host (no ``.item()``, no boolean
indexing, no ``nonzero``), so the decode step that calls it can be
captured in a CUDA graph.

On a model axis of more than one rank (``sharding.model_group``) the
router is whole on every rank and every rank routes every token. When the
experts divide the axis they are expert-parallel: a rank holds E/size of
each stack and computes its experts' outputs for their slots of the
dispatch buffer; when they do not, each expert is tensor-parallel (the
rank's columns of ``we_gate``/``we_up`` and rows of ``we_down``). Data
parallelism over more than one rank is not ported for this family
(``launch/mesh.check_ported``): there is one dispatch group.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import sharding as shd
from repro_torch.config import ModelConfig
from repro_torch.models import common, mlp


def init_layer(generator: torch.Generator, cfg: ModelConfig, num_layers: int,
               device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    e = cfg.num_experts
    L = (num_layers,) if num_layers > 0 else ()
    p = {
        "router": common.init_dense(generator, L + (d, e), device=device),
        "we_gate": common.init_dense(generator, L + (e, d, f), device=device),
        "we_up": common.init_dense(generator, L + (e, d, f), device=device),
        "we_down": common.init_dense(generator, L + (e, f, d), device=device),
        "pre_norm": torch.zeros(L + (d,), dtype=torch.float32, device=device),
    }
    if cfg.dense_residual_d_ff:
        p["dense"] = mlp.init_layer(generator, cfg, num_layers,
                                    d_ff=cfg.dense_residual_d_ff,
                                    device=device)
    return p


def capacity(tokens: int, cfg: ModelConfig, dropless: bool) -> int:
    """Slots per expert for one group of ``tokens`` (``moe.py:72-79``):
    every token when dropless, else ⌊cf·k·T/E⌋ (at least 1), at most T·k."""
    E, k = cfg.num_experts, cfg.experts_per_token
    cap = tokens if dropless else max(int(cfg.capacity_factor * k * tokens
                                          / E), 1)
    return min(cap, tokens * k)


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of f32 ``x`` in the total order that XLA's TopK sorts by:
    -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN (a float's bits, the
    magnitude bits flipped where the sign is set)."""
    bits = x.detach().to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest logits along the last dim, in
    descending order, as ``jax.lax.top_k`` gives them: by XLA's total order
    of floats (a NaN row still picks k indices in range, and its NaN flows
    on into the weights), ties to the lower index (``torch.topk`` promises
    no order on ties). One max and one first-index pick per choice, the
    same on the CPU and the card."""
    E = logits.shape[-1]
    ar = torch.arange(E, device=logits.device)
    key = _order_key(logits)
    taken = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
    picks = []
    for _ in range(k):
        m = key.masked_fill(taken, torch.iinfo(torch.int32).min).amax(
            -1, keepdim=True)
        idx = torch.where(~taken & (key == m), ar, E).amin(-1, keepdim=True)
        picks.append(idx)
        taken = taken | (ar == idx)
    chosen = torch.cat(picks, dim=-1)
    return torch.gather(logits, -1, chosen), chosen


def expert_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (E, C, K) @ w (E, K, N) per expert with an f32 result, as the
    reference's ``einsum(..., preferred_element_type=float32)`` (``_edot``,
    ``moe.py:33-38``): on the card bf16 operands go to cuBLAS's bf16 GEMM
    with f32 accumulation and an f32 output (nothing is rounded to bf16);
    elsewhere the operands are widened to f32 first, as the reference does
    on the CPU, which gives the same values. The weight leaf is cast to
    a's dtype inside the product, and its gradient cast back."""
    return common._PlainDense.apply(a, w, torch.float32)


def route(h: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
          dropless: bool = False):
    """The routing of ``h`` (B, S, D) in one group: (the softmax weights
    over the k chosen logits (T, k) f32, the chosen experts (T, k), the
    destination slot of each (token, choice) pair (T·k,), token-major with
    k inner, ``E·cap`` for a dropped pair, and ``cap``). A pair's rank is
    the count of earlier pairs that chose its expert
    (``moe.py:83-91``). The logits are an f32 product of f32 operands
    (``common.dense``: the router leaf cast to f32, its gradient cast
    back)."""
    B, S, D = h.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    cap = capacity(T, cfg, dropless)
    logits = common.dense(h.reshape(T, D).to(torch.float32), router)
    top, chosen = top_k(logits, k)
    weights = torch.softmax(top, dim=-1)
    flat_e = chosen.reshape(T * k)
    onehot = torch.nn.functional.one_hot(flat_e, E).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos_sel = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    dest = torch.where(pos_sel < cap, flat_e * cap + pos_sel, E * cap)
    return weights, chosen, dest, cap


def _expert_ffn(p: Dict[str, torch.Tensor], xin: torch.Tensor,
                cfg: ModelConfig, group, ep: bool) -> torch.Tensor:
    """The experts' gated FFN on the dispatch buffer ``xin`` (E, cap, D),
    in xin's dtype. Under expert parallelism (``ep``) the rank computes
    its own experts' slots and leaves zeros at the others'; with TP inside
    each expert (a model ``group`` that does not split the experts)
    ``we_gate``/``we_up`` are column-parallel and ``we_down`` row-parallel,
    its f32 partials summed over the ranks."""
    E, cap, D = xin.shape
    if group is not None and not ep:
        gate, up = common.column_dense(xin, [p["we_gate"], p["we_up"]], group,
                                       torch.float32)
        act = (common.act_fn(gate, cfg.act_fn) * up).to(xin.dtype)
        return common.row_dense(act, p["we_down"], group)
    own = xin
    if ep:
        el = E // group.size
        lo = group.index * el
        own = xin[lo:lo + el]
    gate = expert_product(own, p["we_gate"])
    up = expert_product(own, p["we_up"])
    act = (common.act_fn(gate, cfg.act_fn) * up).to(xin.dtype)
    eout = expert_product(act, p["we_down"]).to(xin.dtype)
    if not ep:
        return eout
    zeros = torch.zeros((), dtype=xin.dtype, device=xin.device)
    return torch.cat([zeros.expand(lo, cap, D), eout,
                      zeros.expand(E - lo - el, cap, D)])


def apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
          dropless: bool = False, use_pallas: bool = False) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) with the residual. Pairs past an expert's
    capacity are dropped, except with ``dropless=True`` (decode: cap = T).
    Dispatch is a scatter-add into (E·cap + 1, D) rows, the last the drop
    slot (the only row two pairs can share); combine gathers each pair's
    row from the experts' output with a zero row appended and sums the k
    rows weighted in f32."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    h = common.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    T = B * S
    weights, _, dest, cap = route(h, p["router"], cfg, dropless)
    group = shd.model_group()
    ep = group is not None and p["we_gate"].shape[-3] * group.size == E
    tokens = h.reshape(T, D)
    if ep:
        # a rank's part of the weights' and the tokens' gradients comes
        # from its own experts' slots: summed over the ranks
        weights, tokens = group.copy(weights), group.copy(tokens)
    tok_rep = tokens[:, None].expand(T, k, D).reshape(T * k, D)
    xin = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    xin = xin.index_add(0, dest, tok_rep)[:E * cap].reshape(E, cap, D)
    eout = _expert_ffn(p, xin, cfg, group, ep)
    zero_row = torch.zeros((1, D), dtype=x.dtype, device=x.device)
    eflat = torch.cat([eout.reshape(E * cap, D), zero_row])
    gathered = eflat[dest].reshape(T, k, D).to(torch.float32)
    out = torch.sum(gathered * weights[..., None], dim=1)
    if ep:
        # each rank's weighted sum of its own pairs (zeros for the others),
        # then the sum over the ranks in f32: for k = 2 the reference's
        # bits, (a + 0) + (0 + b) = a + b
        out = group.reduce(out)
    out = out.reshape(B, S, D).to(x.dtype)
    if "dense" in p:  # arctic: the parallel dense residual FFN on the normed h
        out = out + mlp.apply(p["dense"], h, cfg, residual=False,
                              use_pallas=use_pallas)
    return x + out


def aux_load_balance_loss(p: Dict[str, torch.Tensor], x: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary (``moe.py:131-140``): E · Σ_e
    (the share of tokens whose first choice is e) · (the mean router
    probability of e). The mean over layers is the caller's; the
    reference's training loss does not call it."""
    B, S, D = x.shape
    E = cfg.num_experts
    logits = common.dense(x.reshape(B * S, D).to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    _, chosen = top_k(logits, cfg.experts_per_token)
    frac = torch.mean(torch.nn.functional.one_hot(chosen[:, 0], E).to(
        torch.float32), dim=0)
    return E * torch.sum(frac * torch.mean(probs, dim=0))

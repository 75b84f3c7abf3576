"""Mixture-of-Experts FFN: top-k routing with capacity-based gather
dispatch, ported from `repro.models.moe`.

Every token picks its K experts by router probability (the gates
renormalised over the K); then every expert picks the C tokens with its
highest gates (``C = moe_capacity``), so the expert buffers have fixed
shapes [E, C, D]. A (token, expert) pair past an expert's capacity is
dropped; slots whose gate is 0 (more slots than routed tokens) compute
but add nothing. The Switch aux loss ``E * sum(mean(probs) *
mean(one_hot(top1)))`` balances the load.

The reference also has group-local routing, which it takes only under a
JAX device mesh with several data shards; with no mesh it routes
globally, and so does the port, which has none.

The combine is `index_put_(accumulate=True)`: it sums the E * C slots
into their tokens in a fixed order, so two runs give the same bits on
the card, where `index_add_` adds by atomics in any order.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = common.dtype_of(cfg)
    d, ff, E = cfg.d_model, cfg.expert_ff, cfg.num_experts
    return {"router": common.dense_init(gen, d, (d, E)),
            "wg": common.dense_init(gen, d, (E, d, ff), dt),
            "wu": common.dense_init(gen, d, (E, d, ff), dt),
            "wd": common.dense_init(gen, ff, (E, ff, d), dt)}


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    cap = int(cfg.capacity_factor * num_tokens * cfg.experts_per_token
              / cfg.num_experts)
    return min(num_tokens, max(8, cap))


def route(p: dict, cfg: ModelConfig, xt: torch.Tensor, capacity: int):
    """xt: [T, D]. Returns the router probabilities [T, E] (fp32), each
    token's experts [T, K], and each expert's C tokens [E, C] with their
    gates [E, C] (0 where a slot holds no routed token)."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    gates, eidx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    gate_te = torch.zeros_like(probs).scatter_(1, eidx, gates)
    gval, tok_idx = torch.topk(gate_te.T, capacity, dim=-1)
    return probs, eidx, tok_idx, gval


def kept_pairs(tok_idx: torch.Tensor, gval: torch.Tensor,
               num_tokens: int) -> torch.Tensor:
    """The (token, expert) pairs a routing kept, as a [T, E] bool: expert
    e keeps token t where one of its C slots holds t with a positive
    gate. A routed pair that is not kept was dropped over capacity."""
    kept = torch.zeros((tok_idx.shape[0], num_tokens), dtype=torch.bool,
                       device=tok_idx.device)
    return kept.scatter_(1, tok_idx, gval > 0).T


def moe_ffn(p: dict, cfg: ModelConfig,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux loss, an fp32 scalar)."""
    B, S, D = x.shape
    T, E = B * S, cfg.num_experts
    xt = x.reshape(T, D)
    probs, eidx, tok_idx, gval = route(p, cfg, xt, moe_capacity(cfg, T))

    xe = xt[tok_idx]                                    # [E, C, D]
    g = common.activation(torch.bmm(xe, p["wg"]), cfg.act)
    u = torch.bmm(xe, p["wu"])
    ye = torch.bmm(g * u, p["wd"])                      # [E, C, D]
    # the reference weights by gval * (gval > 0), which is gval: a slot
    # with no routed token has gate 0 and adds nothing
    ye = ye * gval[..., None].to(ye.dtype)
    out = torch.zeros((T, D), dtype=ye.dtype, device=x.device).index_put_(
        (tok_idx.reshape(-1),), ye.reshape(-1, D), accumulate=True)

    me = probs.mean(dim=0)
    ce = F.one_hot(eidx[:, 0], E).float().mean(dim=0)
    aux = E * (me * ce).sum()
    return out.reshape(B, S, D), aux

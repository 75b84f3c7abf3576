"""Mixture-of-Experts FFN: top-k routing with capacity-based gather
dispatch, ported from `repro.models.moe`.

Every token picks its K experts by router probability (the gates
renormalised over the K); then every expert picks the C tokens with its
highest gates (``C = moe_capacity``), so the expert buffers have fixed
shapes [E, C, D]. A (token, expert) pair past an expert's capacity is
dropped; slots whose gate is 0 (more slots than routed tokens) compute
but add nothing. The Switch aux loss ``E * sum(mean(probs) *
mean(one_hot(top1)))`` balances the load.

Group-local routing (`cfg.moe_local_dispatch`, under an activation mesh
whose data axes have several shards that divide the batch:
`_dispatch_shards`): the T tokens split into shard-major groups and
every expert picks its capacity within each group, so the token gather
never crosses the data axis. Without it, or with no mesh, routing is
global.

The combine is `index_put_(accumulate=True)`: it sums the E * C slots
into their tokens in a fixed order, so two runs give the same bits on
the card, where `index_add_` adds by atomics in any order.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
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
    probs, eidx, gate_te = _gate_matrix(p, cfg, xt)
    gval, tok_idx = torch.topk(gate_te.T, capacity, dim=-1)
    return probs, eidx, tok_idx, gval


def _gate_matrix(p: dict, cfg: ModelConfig, xt: torch.Tensor):
    """The router probabilities [T, E], each token's top-k experts [T, K]
    and the dense gate matrix [T, E] (its renormalised top-k gates)."""
    logits = shd.hint(xt.float() @ p["router"], shd.BATCH_AXES, None)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, eidx, torch.zeros_like(probs).scatter_(1, eidx, gates)


def kept_pairs(tok_idx: torch.Tensor, gval: torch.Tensor,
               num_tokens: int) -> torch.Tensor:
    """The (token, expert) pairs a routing kept, as a [T, E] bool: expert
    e keeps token t where one of its C slots holds t with a positive
    gate. A routed pair that is not kept was dropped over capacity."""
    kept = torch.zeros((tok_idx.shape[0], num_tokens), dtype=torch.bool,
                       device=tok_idx.device)
    return kept.scatter_(1, tok_idx, gval > 0).T


def _dispatch_shards(cfg: ModelConfig, batch: int) -> int:
    """Local-dispatch granularity: the data-parallel shard count, so every
    expert selects its capacity per data shard."""
    if not cfg.moe_local_dispatch:
        return 1
    mesh = shd._current_mesh()
    if mesh is None:
        return 1
    n = shd._axis_size(mesh, shd.data_axes(mesh))
    return n if n > 1 and batch % n == 0 else 1


def moe_ffn(p: dict, cfg: ModelConfig,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux loss, an fp32 scalar)."""
    B, S, _ = x.shape
    ns = _dispatch_shards(cfg, B)
    if ns > 1:
        return _moe_dispatch(p, cfg, x, groups=ns, capacity=max(
            8, moe_capacity(cfg, B * S) // ns))
    return _moe_dispatch(p, cfg, x, groups=1,
                         capacity=moe_capacity(cfg, B * S))


def _experts(p: dict, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """The experts' FFN on their buffers xe [E, N, D] -> [E, N, D]."""
    g = common.activation(torch.bmm(xe, p["wg"]), cfg.act)
    return torch.bmm(g * torch.bmm(xe, p["wu"]), p["wd"])


def _moe_dispatch(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  groups: int,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    T, E, C = B * S, cfg.num_experts, capacity
    xt = x.reshape(T, D)
    if groups > 1:
        # group-local routing: experts pick C tokens within each group
        Tl = T // groups
        probs, eidx, gate_te = _gate_matrix(p, cfg, xt)
        g_te = shd.hint(gate_te.reshape(groups, Tl, E), shd.BATCH_AXES,
                        None, None)
        gval, loc_idx = torch.topk(g_te.transpose(1, 2), C, dim=-1)
        tok_idx = loc_idx + (torch.arange(groups, device=x.device)
                             * Tl)[:, None, None]          # [G, E, C]
        # the reference clips the local indices to Tl - 1 (a no-op: top_k
        # over Tl entries) before gathering along the group's tokens
        xe = xt.reshape(groups, Tl, D)[
            torch.arange(groups, device=x.device)[:, None],
            loc_idx.reshape(groups, E * C).clamp(0, Tl - 1)]
        xe = shd.hint(xe.reshape(groups, E, C, D).transpose(0, 1),
                      "model", shd.BATCH_AXES, None, None)   # [E, G, C, D]
        ye = _experts(p, cfg, xe.reshape(E, groups * C, D)).reshape(
            E, groups, C, D)
        ye = ye * gval.transpose(0, 1)[..., None].to(ye.dtype)
        ye = shd.hint(ye, "model", shd.BATCH_AXES, None, None)
        rows = tok_idx.reshape(-1)
        contrib = ye.transpose(0, 1).reshape(groups * E * C, D)
    else:
        # every expert picks its C strongest tokens
        probs, eidx, tok_idx, gval = route(p, cfg, xt, C)
        xe = shd.hint(xt[tok_idx], "model", shd.BATCH_AXES, None)
        ye = _experts(p, cfg, xe)                          # [E, C, D]
        # the reference weights by gval * (gval > 0), which is gval: a
        # slot with no routed token has gate 0 and adds nothing
        ye = shd.hint(ye * gval[..., None].to(ye.dtype), "model",
                      shd.BATCH_AXES, None)
        rows, contrib = tok_idx.reshape(-1), ye.reshape(-1, D)
    out = torch.zeros((T, D), dtype=contrib.dtype,
                      device=x.device).index_put_((rows,), contrib,
                                                  accumulate=True)
    me = probs.mean(dim=0)
    ce = F.one_hot(eidx[:, 0], E).float().mean(dim=0)
    aux = E * (me * ce).sum()
    return out.reshape(B, S, D), aux

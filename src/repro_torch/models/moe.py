"""Mixture-of-Experts FFN: top-k routing with capacity-based gather
dispatch, ported from `repro.models.moe`.

Every token picks its K experts by router probability (the gates
renormalised over the K); then every expert picks the C tokens with its
highest gates (``C = moe_capacity``), so the expert buffers have fixed
shapes [E, C, D]. A (token, expert) pair past an expert's capacity is
dropped; slots whose gate is 0 (more slots than routed tokens) compute
but add nothing. The Switch aux loss ``E * sum(mean(probs) *
mean(one_hot(top1)))`` balances the load.

Routing is global on one card (`cfg.moe_local_dispatch` or not, as in
the reference with no mesh). Group-local routing, where every expert
picks its capacity within each data shard's tokens so the token gather
never crosses the data axes, runs in the sharded step (`_moe_spmd`,
below); `_moe_dispatch(groups=)` computes it on the whole batch, the
reference's form that the tests hold the sharded step to.

The combine is `index_put_(accumulate=True)`: it sums the E * C slots
into their tokens in a fixed order, so two runs give the same bits on
the card, where `index_add_` adds by atomics in any order.

In a sharded step (`_moe_spmd`) a rank holds its data shard's tokens,
the same on every rank of `model`, and, where the spec puts the experts
on `model`, its E / tp experts. The router's logits are gathered over
`model`, and every rank routes its tokens alike. Group-local routing
picks each expert's capacity within the rank's own tokens (one group a
data shard, as the reference groups them) and needs no data collective.
Global routing merges each expert's local top-C over the data axes (the
global top-C lies in their union) and splits the capacity slots over the
data axes, as the reference's hint places the expert buffers: the
tokens reach their slots by a reduce-scatter and the slots' outputs
their tokens by an all-gather. The experts' parts of each token's output
are summed over `model`. Where the step's rows are not split (a decode
of one row) the experts' weights [E, D, F] keep their FSDP shards over
D (`spmd.matmul`): `wg` and `wu` take the rank's part of D and sum the
partial products over the data axes, `wd` gathers its columns of D;
routing, capacity and the dropped pairs are the rows' own, as before.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
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


def moe_ffn(p: dict, cfg: ModelConfig,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux loss, an fp32 scalar)."""
    B, S, _ = x.shape
    if spmd.current() is not None:
        return _moe_spmd(p, cfg, x, spmd.current())
    return _moe_dispatch(p, cfg, x, groups=1,
                         capacity=moe_capacity(cfg, B * S))


def _experts(p: dict, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """The experts' FFN on their buffers xe [E, N, D] -> [E, N, D]."""
    g = common.activation(spmd.matmul(xe, p["wg"]), cfg.act)
    return spmd.matmul(g * spmd.matmul(xe, p["wu"]), p["wd"], cfg.d_model)


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


def _moe_spmd(p: dict, cfg: ModelConfig, x: torch.Tensor,
              ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    """`moe_ffn` in a sharded step on this rank's tokens x [B, S, D] (its
    data shard's rows) and experts (module docstring)."""
    B, S, D = x.shape
    T, E, K = B * S, cfg.num_experts, cfg.experts_per_token
    nd = ctx.nd
    local = cfg.moe_local_dispatch and nd > 1
    C = max(8, moe_capacity(cfg, T * nd) // nd) if local \
        else moe_capacity(cfg, T * nd)
    xt = x.reshape(T, D)
    split_r = spmd.split(p["router"], 1, E)
    split_e = spmd.split(p["wg"], 0, E)
    xm = spmd.to_model(xt) if split_r or split_e else xt
    logits = (xm if split_r else xt).float() @ p["router"]
    if split_r:
        logits = spmd.gather_model(logits, -1)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, K, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    gate_te = torch.zeros_like(probs).scatter_(1, eidx, gates)
    xin = xm if split_e else xt
    if split_e:
        lo, hi = spmd.part(E)
        gate_te = spmd.to_model(gate_te)[:, lo:hi]
    if local or nd == 1:
        gval, tok = torch.topk(gate_te.T, C, dim=-1)           # [El, C]
        ye = _experts(p, cfg, xin[tok])
        ye = ye * gval[..., None].to(ye.dtype)
        rows, contrib = tok.reshape(-1), ye.reshape(-1, D)
    else:
        # each expert's global top-C, from every data shard's local top-C
        kl = min(C, T)
        vals, idx = torch.topk(gate_te.T, kl, dim=-1)          # [El, kl]
        vals = spmd.gather_data(vals, 1)
        idx = spmd.all_gather(idx + ctx.dr * T, ctx.data_group, nd, 1)
        gval, sel = torch.topk(vals, C, dim=-1)
        tok = idx.gather(1, sel)                               # global ids
        Cs = -(-C // nd)
        if Cs * nd != C:   # slots that hold no token: gate 0, token 0
            gval = F.pad(gval, (0, Cs * nd - C))
            tok = F.pad(tok, (0, Cs * nd - C))
        mine = (tok // T) == ctx.dr
        rows = torch.where(mine, tok - ctx.dr * T, 0)
        xe = torch.where(mine[..., None], xin[rows], 0.0)
        xe = spmd.scatter_data(xe, 1)                           # [El, Cs, D]
        ye = _experts(p, cfg, xe)
        ye = ye * gval[:, ctx.dr * Cs:(ctx.dr + 1) * Cs, None].to(ye.dtype)
        ye = spmd.gather_data(ye, 1)                            # [El, C', D]
        contrib = torch.where(mine[..., None], ye, 0.0).reshape(-1, D)
        rows = rows.reshape(-1)
    out = torch.zeros((T, D), dtype=contrib.dtype,
                      device=x.device).index_put_((rows,), contrib,
                                                  accumulate=True)
    if split_e:
        out = spmd.from_model(out)
    me = probs.sum(dim=0)
    ce = F.one_hot(eidx[:, 0], E).float().sum(dim=0)
    if nd > 1:
        me, ce = spmd.data_sum(me), spmd.data_total(ce)
    aux = E * ((me / (T * nd)) * (ce / (T * nd))).sum()
    return out.reshape(B, S, D), aux

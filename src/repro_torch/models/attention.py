"""GQA/MQA attention with sliding-window masks, logit softcaps and
RoPE / M-RoPE; the reference's dense and blockwise (flash-style) plain
attention; a KV cache for prefill / decode serving. Ported from
`repro.models.attention`.

Shapes follow [B, S, H, hd]; GQA groups Hq query heads onto Hkv KV heads
(query head h reads KV head h // (Hq / Hkv)). Dense weights keep the JAX
layout: wq/wk/wv [d, H, hd], wo [H, hd, d].

bf16 follows the reference: the projections and the score product run
in the activations' dtype, the scores are cast to fp32 for the softcap,
mask and softmax, and the probabilities are cast to v's dtype before the
second product.

Under `cfg.use_pallas` the prefill and feature forwards (`attention_train`,
`attention_prefill`) take the hand-written flash-attention kernel
(`kernels/attention`) in place of both `_attend_dense` and
`_attend_blockwise`, which compute the same function: causal, with the
layer's window and `cfg.attn_logit_softcap`, keys at positions 0..S-1 as
those forwards' positions are. Where grad is enabled and an input
requires it (the loss path), the plain attention runs, as the ViT's loss
path does; decode stays plain, one query row against the cache.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.kernels import kernel_route
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.models import common

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = common.dtype_of(cfg)
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": common.dense_init(gen, d, (d, H, hd), dt),
         "wk": common.dense_init(gen, d, (d, Hkv, hd), dt),
         "wv": common.dense_init(gen, d, (d, Hkv, hd), dt),
         "wo": common.dense_init(gen, cfg.q_dim, (H, hd, d), dt)}
    if cfg.qkv_bias:
        z = dict(dtype=dt, device=gen.device)
        p["bq"] = torch.zeros((H, hd), **z)
        p["bk"] = torch.zeros((Hkv, hd), **z)
        p["bv"] = torch.zeros((Hkv, hd), **z)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    return spmd.matmul(x, w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], *w.shape[1:])


def _out_proj(out: torch.Tensor, wo: torch.Tensor, d: int,
              model_sum: bool = False) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul (d: the model width; its
    parts summed over `model` where `model_sum`)."""
    return spmd.matmul(out.reshape(*out.shape[:2], -1),
                       wo.reshape(-1, wo.shape[-1]), d, model_sum)


# the head_dim axis of each attention param (`shard_head_dim` specs may
# put it on `model`)
_HD_DIM = {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "bq": 1, "bk": 1, "bv": 1}


def _whole_hd(p: dict, cfg: ModelConfig) -> dict:
    """`p` with any param split over `model` by head_dim (a
    `shard_head_dim` spec, where the heads do not divide `model`)
    gathered along it: RoPE pairs entries hd / 2 apart, so the heads'
    computation runs whole on every rank."""
    return {k: spmd.gather_model(v, _HD_DIM[k])
            if k in _HD_DIM and spmd.split(v, _HD_DIM[k], cfg.head_dim)
            else v for k, v in p.items()}


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """q, k, v [B, S, H, hd] with RoPE; in a sharded step each holds the
    heads its weight holds (`wq` split over `model` by heads gives this
    rank's H / tp)."""
    split_q = spmd.split(p["wq"], 1, cfg.num_heads)
    split_kv = spmd.split(p["wk"], 1, cfg.num_kv_heads)
    xm = spmd.to_model(x) if split_q or split_kv else x
    q = _proj(xm if split_q else x, p["wq"])
    k = _proj(xm if split_kv else x, p["wk"])
    v = _proj(xm if split_kv else x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = (_hint_heads(cfg, t) for t in (q, k, v))
    if cfg.mrope_sections:
        if positions.dim() == 2:  # [B, S] -> text-only 3-axis positions
            positions = torch.stack([positions] * 3, dim=0)
        q = common.apply_mrope(q, positions, cfg.rope_theta,
                               cfg.mrope_sections)
        k = common.apply_mrope(k, positions, cfg.rope_theta,
                               cfg.mrope_sections)
    else:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _local_kv(cfg: ModelConfig, q, k, v):
    """k and v cut to the KV heads of q's heads, where q holds this rank's
    H / tp query heads and k, v every KV head (the spec replicates the KV
    heads on `model`: gemma2-2b's 4 on 16). A rank's query heads read a
    run of whole KV heads, or one KV head, or (where neither divides the
    other) each its own, gathered. Each rank reads a part of k and v, so
    their gradients are all-reduced over `model` (`to_model`)."""
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq == cfg.num_heads or Hkv != cfg.num_kv_heads:
        return k, v
    k, v = spmd.to_model(k), spmd.to_model(v)
    g = cfg.num_heads // cfg.num_kv_heads
    lo = spmd.part(cfg.num_heads)[0]
    if Hq % g == 0:
        return k[:, :, lo // g:(lo + Hq) // g], v[:, :, lo // g:(lo + Hq) // g]
    if g % Hq == 0:
        return k[:, :, lo // g:lo // g + 1], v[:, :, lo // g:lo // g + 1]
    idx = (lo + torch.arange(Hq, device=q.device)) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _output(p: dict, cfg: ModelConfig, out: torch.Tensor) -> torch.Tensor:
    """The output projection of [B, S, H, hd]: row-parallel, its parts
    summed over `model`, where `wo` is split by heads."""
    return _out_proj(out, p["wo"], cfg.d_model,
                     spmd.split(p["wo"], 0, cfg.num_heads))


def _hint_heads(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    """The reference's layout of q, k or v [B, S, H, hd] under an
    activation mesh: batch over the data axes and heads over `model`,
    or, where the heads do not divide `model` (`attn_batch_shard`), the
    batch over (data x model)."""
    mesh = shd._current_mesh()
    tp = shd.axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    if (cfg.attn_batch_shard and tp > 1 and cfg.num_heads % tp != 0
            and t.shape[0] % (tp * shd._axis_size(mesh, shd.data_axes(mesh)))
            == 0):
        return shd.hint(t, tuple(shd.data_axes(mesh)) + ("model",),
                        None, None, None)
    return shd.hint(t, shd.BATCH_AXES, None, "model", None)


def _inv_sqrt(hd: int) -> Tuple[float, float]:
    """sqrt(hd) and 1 / sqrt(hd), each rounded in fp32 as the reference
    computes them (`jnp.sqrt(jnp.float32(hd))`)."""
    root = np.sqrt(np.float32(hd))
    return float(root), float(np.float32(1.0) / root)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int):
    """Causal (+ optional sliding-window) mask. True = attend."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def _attend_dense(cfg: ModelConfig, q, k, v, q_pos, k_pos,
                  window: int) -> torch.Tensor:
    """Plain attention; q: [B, Sq, Hq, hd], k/v: [B, Sk, Hkv, hd]."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = scores / _inv_sqrt(hd)[0]
    scores = common.softcap(scores, cfg.attn_logit_softcap)
    mask = _mask(q_pos, k_pos, window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, Hq, hd)


def _attend_blockwise(cfg: ModelConfig, q, k, v, q_pos, k_pos,
                      window: int) -> torch.Tensor:
    """Blockwise online-softmax attention, the reference's blocking: q
    blocks of about `attn_q_block` rows, kv blocks of about
    `attn_k_block`, skipping the (q, kv) block pairs that the causal
    test or the sliding window masks whole.

    The blocks are Sq // (Sq // attn_q_block) long, and must split Sq
    (Sk likewise): where they do not, the reshape raises, as the
    reference's does (ROADMAP C.10)."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    bq = min(cfg.attn_q_block, Sq)
    bk = min(cfg.attn_k_block, Sk)
    nq = max(Sq // bq, 1)
    nk = max(Sk // bk, 1)
    bq, bk = Sq // nq, Sk // nk
    qs = q.reshape(B, nq, bq, Hkv, g, hd)
    ks = k.reshape(B, nk, bk, Hkv, hd)
    vs = v.reshape(B, nk, bk, Hkv, hd)
    qpos = q_pos.reshape(nq, bq)
    kpos = k_pos.reshape(nk, bk)
    scale = _inv_sqrt(hd)[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = []
    for qi in range(nq):
        qb = qs[:, qi]
        q_lo, q_hi = qi * bq, (qi + 1) * bq - 1
        acc = torch.zeros((B, Hkv, g, bq, hd), **f32)
        m = torch.full((B, Hkv, g, bq), NEG_INF, **f32)
        l = torch.zeros((B, Hkv, g, bq), **f32)
        for ki in range(nk):
            k_lo, k_hi = ki * bk, (ki + 1) * bk - 1
            if k_lo > q_hi:
                continue  # causal skip
            if window and k_hi < q_lo - window + 1 - bq:
                continue  # sliding-window skip
            kb, vb = ks[:, ki], vs[:, ki]
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, kb).float() * scale
            s = common.softcap(s, cfg.attn_logit_softcap)
            s = torch.where(_mask(qpos[qi], kpos[ki], window), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(vb.dtype), vb)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # [B, bq, Hkv, g, hd]
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, hd).to(q.dtype)


def _index_positions(q_pos: torch.Tensor) -> bool:
    """Whether `q_pos` is q_pos[0] + 0..S-1. The kernel masks by index;
    its causal and window masks depend only on differences of positions,
    so these are the positions on which it computes the plain path's
    function."""
    step = torch.arange(q_pos.shape[0], device=q_pos.device,
                        dtype=q_pos.dtype)
    return torch.equal(q_pos - q_pos[0], step)


def _attend(cfg: ModelConfig, q, k, v, q_pos, window: int) -> torch.Tensor:
    """Causal self-attention over the whole sequence, q_pos = k_pos. The
    kernel takes it only where the positions are consecutive."""
    if kernel_route(cfg.use_pallas, q, k, v) and _index_positions(q_pos):
        return att_ops.flash_attention(
            q, k, v, causal=True, window=window,
            softcap=cfg.attn_logit_softcap, out_dtype=q.dtype)
    if q.shape[1] > cfg.attn_chunk:
        return _attend_blockwise(cfg, q, k, v, q_pos, q_pos, window)
    return _attend_dense(cfg, q, k, v, q_pos, q_pos, window)


def _self_attention(p: dict, cfg: ModelConfig, x, positions, window: int):
    p = _whole_hd(p, cfg)
    pos1d = positions[0] if positions.dim() == 3 else positions
    q, k, v = _project_qkv(p, cfg, x, positions)
    q_pos = pos1d[0] if pos1d.dim() == 2 else pos1d  # per-row positions
    kl, vl = _local_kv(cfg, q, k, v)
    return _output(p, cfg, _attend(cfg, q, kl, vl, q_pos, window)), k, v


def attention_train(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, window: int) -> torch.Tensor:
    """Full-sequence causal self-attention for training and features."""
    return _self_attention(p, cfg, x, positions, window)[0]


# ---------------------------------------------------------------------------
# serving: prefill fills a cache; decode attends one token against it


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, window: int):
    """Returns the output and the cache {k, v} [B, S, Hkv, hd]."""
    y, k, v = _self_attention(p, cfg, x, positions, window)
    return y, {"k": k, "v": v}


def attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict, pos: int, window: int):
    """x: [B, 1, D]; cache k/v: [B, L, Hkv, hd]; pos: the current index.
    Returns the output [B, 1, D] and a new cache holding this token's k
    and v at `pos` (the given cache is left as it is). As the reference's
    `dynamic_update_slice`, a `pos` past the cache writes at its last
    row. A cache of DTensors (a sharded step's) takes `_decode_sharded`."""
    from torch.distributed.tensor import DTensor

    if isinstance(cache["k"], DTensor):
        return _decode_sharded(p, cfg, x, cache, pos, window)
    B = x.shape[0]
    L = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    row = min(max(pos, 0), L - 1)
    k, v = cache["k"].clone(), cache["v"].clone()
    k[:, row] = k_new[:, 0].to(k.dtype)
    v[:, row] = v_new[:, 0].to(v.dtype)
    Hq, hd, Hkv = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k).float()
    scores = scores / _inv_sqrt(hd)[0]
    scores = common.softcap(scores, cfg.attn_logit_softcap)
    k_pos = torch.arange(L, device=x.device)
    mask = k_pos <= pos
    if window:
        mask &= (pos - k_pos) < window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v).reshape(B, 1, Hq, hd)
    return _out_proj(out, p["wo"], cfg.d_model), {"k": k, "v": v}


def _decode_sharded(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    cache: dict, pos: int, window: int):
    """`attention_decode` on a sharded cache, this rank's shard of it
    (`cache_specs`: the batch or, for a batch the data axes do not split,
    the sequence over the data axes; the KV heads or else hd over
    `model`). The token's q, k and v are gathered whole over `model` (one
    row each); the rank writes the k and v it holds, scores its KV heads
    on its hd (summed over `model` where hd is split), and takes the
    softmax over a sequence split over the data axes as a max and a sum
    over them. The heads' outputs go through `wo` as `_output` does."""
    ctx = spmd.current()
    p = _whole_hd(p, cfg)
    local, back = spmd.local(cache)
    k, v = local["k"], local["v"]
    B, Ll, Hc, dc = k.shape
    L = cache["k"].shape[1]
    _, l0, h0, d0 = spmd.offsets(cache["k"])
    Hq, hd, Hkv = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    g = Hq // Hkv
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    if q.shape[2] != Hq:
        q = spmd.all_gather(q, ctx.model_group, ctx.tp, 2)
    if k_new.shape[2] != Hkv:
        k_new = spmd.all_gather(k_new, ctx.model_group, ctx.tp, 2)
        v_new = spmd.all_gather(v_new, ctx.model_group, ctx.tp, 2)
    row = min(max(pos, 0), L - 1)
    k, v = k.clone(), v.clone()
    if l0 <= row < l0 + Ll:
        k[:, row - l0] = k_new[:, 0, h0:h0 + Hc, d0:d0 + dc].to(k.dtype)
        v[:, row - l0] = v_new[:, 0, h0:h0 + Hc, d0:d0 + dc].to(v.dtype)
    qg = q.reshape(B, Hkv, g, hd)[:, h0:h0 + Hc, :, d0:d0 + dc]
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k).float()
    if dc != hd:
        scores = spmd.all_reduce(scores, ctx.model_group)
    scores = scores / _inv_sqrt(hd)[0]
    scores = common.softcap(scores, cfg.attn_logit_softcap)
    k_pos = l0 + torch.arange(Ll, device=x.device)
    mask = k_pos <= pos
    if window:
        mask &= (pos - k_pos) < window
    scores = torch.where(mask, scores, NEG_INF)
    if Ll != L:
        m = spmd.all_reduce(scores.amax(dim=-1, keepdim=True),
                            ctx.data_group, "max")
        e = torch.exp(scores - m)
        probs = (e / spmd.all_reduce(e.sum(dim=-1, keepdim=True),
                                     ctx.data_group)).to(v.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v)
    if Ll != L:
        out = spmd.all_reduce(out, ctx.data_group)
    if dc != hd:
        out = spmd.all_gather(out, ctx.model_group, ctx.tp, 3)
    out = out.reshape(B, 1, Hc * g, hd)     # q heads h0 * g ...
    if Hc == Hkv and spmd.split(p["wo"], 0, Hq):
        lo, hi = spmd.part(Hq)
        out = out[:, :, lo:hi]
    y = _out_proj(out, p["wo"], cfg.d_model, spmd.split(p["wo"], 0, Hq))
    return y, back({"k": k, "v": v})

"""Decoder-LM assembler for all ten LM architectures, ported from
`repro.models.transformer`: the attention LMs (gemma2, granite, qwen1.5,
qwen2-vl, musicgen), the MoE LMs (qwen3-moe, kimi-k2), jamba's hybrid
stack and rwkv6.

Layers form *groups* of g = the architecture's block period (1 for
uniform stacks, 2 for gemma2's local/global alternation, 8 for jamba's
mamba:attention interleave with MoE every other layer). A layer's kind
(attention, mamba or rwkv), its window and whether its FFN is MoE are
those of its offset within its group, as in the reference. The JAX
model stacks each offset's params along a leading [G] axis and scans
over the groups; the port runs the layers as an
unrolled Python loop over a list of per-layer param dicts in layer order
(`bridge.params_from_jax` unstacks a JAX tree in (group, offset) order).
Its decode caches are a list of per-layer dicts: ``{"attn": {"k", "v"}}``
for attention, ``{"mamba": {"h", "conv"}}`` for mamba, ``{s, x_tm, x_cm}``
for rwkv. The MoE layers' router aux losses sum over the layers into
the loss, weighted by `router_aux_coef`. Where a backward will run,
each group's forward runs under `cfg.remat` (`_remat`: activation
checkpointing, as the reference's `jax.checkpoint` of a group body).

Params: ``{"embed": {"tok", "head", "frontend_proj"}, "final_norm",
"blocks": [...]}``; dense weights are [in, out], the JAX layout.

Params may be DTensors placed by `distributed.sharding.param_specs`: in
a sharded step (`distributed.spmd.step`) a layer takes its params at
their use (`spmd.use`: FSDP shards gathered over the data axes, the
`model` placement kept) inside the group body, so remat gathers them
again in its recompute, and the blocks compute on their parts; the
logits stay split over the vocabulary and the loss is reduced over it.
Where the step's rows are not split (a decode of one row) `use` gathers
nothing and the blocks' products run on the weights' FSDP shards
(`spmd.matmul`), moving activations only.

A modality frontend (qwen2-vl's vision stub, musicgen's audio stub)
prepends its projected embeddings (`batch["frontend_embeds"]`) to the
tokens; the loss drops their positions before the head.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.core.freeze_plan import FreezePlan, lm_segments, maybe_stop
from repro_torch.models import attention, common, mamba, mlp, moe, rwkv6


def group_size(cfg: ModelConfig) -> int:
    g = 1
    if cfg.attn_period:
        g = cfg.attn_period
    if cfg.local_global_period:
        g = max(g, cfg.local_global_period)
    if cfg.num_experts and cfg.moe_period > 1:
        g = math.lcm(g, cfg.moe_period)
    assert cfg.num_layers % g == 0, (cfg.name, cfg.num_layers, g)
    return g


def num_groups(cfg: ModelConfig) -> int:
    return cfg.num_layers // group_size(cfg)


# ---------------------------------------------------------------------------
# per-layer blocks


def _init_block(gen: torch.Generator, cfg: ModelConfig, offset: int) -> dict:
    kind = cfg.layer_kind(offset)
    z = dict(dtype=torch.float32, device=gen.device)
    p = {"ln1": torch.zeros(cfg.d_model, **z),
         "ln2": torch.zeros(cfg.d_model, **z)}
    if cfg.post_norms:
        p["ln1_post"] = torch.zeros(cfg.d_model, **z)
        p["ln2_post"] = torch.zeros(cfg.d_model, **z)
    if kind == "attn":
        p["mix"] = attention.init_attention(gen, cfg)
    elif kind == "mamba":
        p["mix"] = mamba.init_mamba(gen, cfg)
    else:
        p["mix"] = rwkv6.init_rwkv_time_mix(gen, cfg)
    if kind == "rwkv":
        p["ffn"] = rwkv6.init_rwkv_channel_mix(gen, cfg)
    elif cfg.layer_is_moe(offset):
        p["ffn"] = moe.init_moe(gen, cfg)
    else:
        p["ffn"] = mlp.init_mlp(gen, cfg)
    return p


def _apply_block(p: dict, cfg: ModelConfig, x: torch.Tensor, offset: int,
                 mode: str, cache: Optional[dict], positions=None, pos=None
                 ) -> Tuple[torch.Tensor, Optional[dict],
                            Optional[torch.Tensor]]:
    """The block at `offset` within its group, in `mode` train | prefill
    | decode. Attention blocks take `positions` [B, S] (train, prefill)
    or the index `pos` (decode). Returns (x, cache_out, aux): cache_out
    is None in train mode, aux the MoE router loss (an fp32 scalar; None
    for a dense FFN)."""
    kind = cfg.layer_kind(offset)
    window = cfg.layer_window(offset)
    aux = None
    p = spmd.use_tree(p)
    back = None
    if mode == "decode" and kind != "attn":
        cache, back = spmd.local(cache)
    x = shd.hint(x, shd.BATCH_AXES, None, None)
    h = common.rms_norm(x, p["ln1"], cfg.norm_eps)
    c = None
    if kind == "attn":
        if mode == "train":
            a = attention.attention_train(p["mix"], cfg, h, positions, window)
        elif mode == "prefill":
            a, kv = attention.attention_prefill(p["mix"], cfg, h, positions,
                                                window)
            c = {"attn": kv}
        else:
            a, kv = attention.attention_decode(p["mix"], cfg, h,
                                               cache["attn"], pos, window)
            c = {"attn": kv}
    elif kind == "mamba":
        if mode == "decode":
            a, st = mamba.mamba_decode(p["mix"], cfg, h, cache["mamba"])
        else:
            a, st = mamba.mamba_train(p["mix"], cfg, h,
                                      return_state=(mode == "prefill"))
        c = {"mamba": st} if st is not None else None
    elif mode == "decode":
        a, c = rwkv6.time_mix_decode(p["mix"], cfg, h, cache)
    else:
        a, c = rwkv6.time_mix_train(p["mix"], cfg, h,
                                    return_state=(mode == "prefill"))
    if cfg.post_norms:
        a = common.rms_norm(a, p["ln1_post"], cfg.norm_eps)
    x = x + a
    h = common.rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind != "rwkv":
        if cfg.layer_is_moe(offset):
            f, aux = moe.moe_ffn(p["ffn"], cfg, h)
        else:
            f = mlp.mlp(p["ffn"], cfg, h)
    elif mode == "decode":
        f, c = rwkv6.channel_mix_decode(p["ffn"], cfg, h, c)
    else:
        f, c = rwkv6.channel_mix_train(p["ffn"], cfg, h, state=c,
                                       return_state=(mode == "prefill"))
    if cfg.post_norms:
        f = common.rms_norm(f, p["ln2_post"], cfg.norm_eps)
    if back is not None:
        c = back(c)
    return x + f, c, aux


# ---------------------------------------------------------------------------
# init


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params, drawn on the generator's device."""
    g = group_size(cfg)
    return {"embed": common.init_embedding(gen, cfg),
            "final_norm": torch.zeros(cfg.d_model, dtype=torch.float32,
                                      device=gen.device),
            "blocks": [_init_block(gen, cfg, i % g)
                       for i in range(cfg.num_layers)]}


# ---------------------------------------------------------------------------
# forward


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


# the ops whose outputs `remat="dots"` keeps: the reference's
# `checkpoint_dots` saves every `dot_general`, which these are in torch
_DOTS = frozenset((torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
                   torch.ops.aten.baddbmm))


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_save_dots)


def _remat(fn, cfg: ModelConfig):
    """A group body with its activations recomputed in the backward, as
    the reference's `_remat` wraps it in `jax.checkpoint` where
    `cfg.scan_layers`: `none` keeps them, `full` keeps none, `dots` keeps
    the matmuls' outputs and recomputes the rest (selective
    checkpointing, the reference's `checkpoint_dots` policy). Only a
    forward that a backward will run through is wrapped; recomputing runs
    the same ops on the same inputs, so the gradient does not change."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots'; got "
                         f"{cfg.remat!r}")
    if not cfg.scan_layers or cfg.remat == "none" or \
            not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=_dots_context)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _run(blocks, cfg: ModelConfig, x, mode: str, caches=None,
         positions=None, pos=None, collect_feats: bool = False):
    """Layers in order, a group of g at a time, from a group boundary.
    Returns (x, caches_out, feats, aux): one feature a group, its last
    layer's output; aux the sum over groups of each group's sum of its
    layers' MoE router losses, the reference's order. In train mode each
    group body runs under `_remat`."""
    g = group_size(cfg)

    def group(x, lo):
        aux, cs = None, []
        for i in range(lo, lo + g):
            x, c, a = _apply_block(blocks[i], cfg, x, i % g, mode,
                                   caches[i] if caches is not None else None,
                                   positions, pos)
            if a is not None:
                aux = a if aux is None else aux + a
            cs.append(c)
        return x, cs, aux

    body = _remat(group, cfg) if mode == "train" else group
    caches_out: List = []
    feats: List = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, len(blocks), g):
        x, cs, a = body(x, lo)
        if a is not None:
            aux = aux + a
        caches_out.extend(cs)
        if collect_feats:
            feats.append(x)
    return x, caches_out, feats, aux


def _embed(params, cfg: ModelConfig, batch: dict, frozen: bool = False):
    emb = maybe_stop(params["embed"], frozen)
    used = {k: spmd.use(emb[k]) for k in ("tok", "frontend_proj")
            if k in emb}
    x = common.embed_tokens(used, cfg, batch["tokens"],
                            batch.get("frontend_embeds"))
    return shd.hint(x, shd.BATCH_AXES, None, None), emb


def _head(embed: dict, cfg: ModelConfig) -> dict:
    """The head's table at its use: the token table where tied."""
    name = "tok" if cfg.tie_embeddings else "head"
    return {name: spmd.use(embed[name])}


def _logits(params, cfg: ModelConfig, x, head=None) -> torch.Tensor:
    x = common.rms_norm(x, spmd.use(params["final_norm"]), cfg.norm_eps)
    return common.lm_logits(_head(head or params["embed"], cfg), cfg, x)


def lm_loss(params, cfg: ModelConfig, batch: dict,
            plan: Optional[FreezePlan] = None) -> Tuple[torch.Tensor, dict]:
    """The value of the JAX loss. batch: tokens [B, S], targets [B, S],
    optional frontend_embeds [B, F, frontend_dim], optional mask [B, S].
    The plan's groups split the layers into segments (`lm_segments`); a
    frozen segment's params are detached, and so is the activation after
    a frozen prefix that starts at a frozen embedding (JAX's
    stop_gradient), so a frozen leaf gets no gradient and, under
    `use_pallas`, that prefix's forwards take the kernels. Returns
    (loss + router_aux_coef * aux, metrics), as JAX does; its gradients
    are JAX's (tests/test_torch_lm_train.py)."""
    x, emb = _embed(params, cfg, batch, bool(plan and plan.embed))
    positions = _positions(x)
    blocks = params["blocks"]
    if plan is None or not any(plan.groups):
        x, _, _, aux = _run(blocks, cfg, x, "train", positions=positions)
    else:
        g = group_size(cfg)
        prefix_stops_grad = plan.embed
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo, hi, frozen in lm_segments(plan):
            seg = maybe_stop(blocks[lo * g:hi * g], frozen)
            x, _, _, a = _run(seg, cfg, x, "train", positions=positions)
            aux = aux + a
            if frozen and prefix_stops_grad:
                x = x.detach()
            else:
                prefix_stops_grad = False
    F = x.shape[1] - batch["tokens"].shape[1]
    if F > 0:
        x = x[:, F:]
    head = emb if cfg.tie_embeddings else params["embed"]
    head = maybe_stop(head, bool(plan and plan.head))
    logits = shd.hint(_logits(params, cfg, x, head), shd.BATCH_AXES, None,
                      "model")
    loss = common.cross_entropy(logits, batch["targets"], batch.get("mask"),
                                vocab=cfg.vocab_size)
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "logits_mean": _mean(logits, cfg)}


def _mean(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The logits' mean; in a sharded step over every rank's part."""
    if spmd.current() is None:
        return logits.mean()
    total = spmd.data_total(spmd.model_total(logits.detach().sum()))
    n = logits.numel() * spmd.nd() * cfg.vocab_size // logits.shape[-1]
    return total / n


def lm_features(params, cfg: ModelConfig, batch: dict) -> List[torch.Tensor]:
    """Per-group hidden states for CKA probes: a list of [B, S, D], one a
    group (frontend prefix included)."""
    x, _ = _embed(params, cfg, batch)
    return _run(params["blocks"], cfg, x, "train", positions=_positions(x),
                collect_feats=True)[2]


# ---------------------------------------------------------------------------
# serving


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device=None) -> List[dict]:
    """Empty decode caches, one dict per layer, on `device` (CUDA unless
    given: `resolve_device`): attention k/v [batch, max_len, Hkv, hd] in
    `dtype`; mamba and rwkv states, O(1) in sequence length and fp32."""
    device = resolve_device(device)
    g = group_size(cfg)
    caches = []
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i % g)
        if kind == "attn":
            caches.append({"attn": attention.init_cache(cfg, batch, max_len,
                                                        dtype, device)})
        elif kind == "mamba":
            caches.append({"mamba": mamba.init_mamba_state(cfg, batch,
                                                           device)})
        else:
            caches.append(rwkv6.init_rwkv_state(cfg, batch, device))
    return caches


def lm_prefill(params, cfg: ModelConfig, batch: dict):
    """Returns (last-position logits [B, V] fp32, caches); attention
    caches span the frontend prefix and the prompt."""
    x, _ = _embed(params, cfg, batch)
    x, caches, _, _ = _run(params["blocks"], cfg, x, "prefill",
                           positions=_positions(x))
    return _logits(params, cfg, x[:, -1:])[:, 0], caches


def lm_decode(params, cfg: ModelConfig, tokens: torch.Tensor, caches, pos):
    """tokens: [B, 1]; pos: the token's position (an int), which the
    attention blocks write and attend at; rwkv blocks do not read it.
    Returns (logits [B, V], caches)."""
    x = common.embed_tokens({"tok": spmd.use(params["embed"]["tok"])}, cfg,
                            tokens)
    x, caches_out, _, _ = _run(params["blocks"], cfg, x, "decode", caches,
                               pos=pos)
    return _logits(params, cfg, x)[:, 0], caches_out


def build(cfg: ModelConfig, device: torch.device):
    from repro_torch.models import Model

    def init(generator):
        params = init_lm(generator, cfg)
        return tree_map(lambda t: t.to(device), params)

    return Model(
        cfg=cfg, device=device, init=init,
        loss=lambda params, batch, plan=None: lm_loss(params, cfg, batch,
                                                      plan),
        features=torch.inference_mode()(
            lambda params, batch: lm_features(params, cfg, batch)),
        num_freeze_units=num_groups(cfg),
        prefill=torch.inference_mode()(
            lambda params, batch: lm_prefill(params, cfg, batch)),
        decode=torch.inference_mode()(
            lambda params, tokens, cache, pos: lm_decode(params, cfg, tokens,
                                                         cache, pos)),
        init_cache=lambda batch, max_len, dtype: init_lm_cache(
            cfg, batch, max_len, dtype, device))

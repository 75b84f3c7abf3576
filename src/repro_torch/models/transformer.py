"""Decoder-LM assembler, ported from `repro.models.transformer` for the
rwkv6 blocks.

The JAX model stacks each group's params along a leading [G] axis and
scans over it; the port runs the layers as an unrolled Python loop over a
list of per-layer param dicts (`bridge.params_from_jax` unstacks a JAX
tree), and its decode caches are a list of per-layer dicts
``{s, x_tm, x_cm}``. Attention, mamba and MoE blocks are not ported yet
and raise (ROADMAP A.9).

Params: ``{"embed": {"tok", "head"}, "final_norm", "blocks": [...]}``;
dense weights are [in, out] and applied as ``x @ W``, the JAX layout.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.freeze_plan import FreezePlan, maybe_stop
from repro_torch.models import common, rwkv6


def group_size(cfg: ModelConfig) -> int:
    """Layers per group: 1. The JAX model's larger groups come from the
    attention/mamba interleave, local/global alternation and MoE periods,
    none of which the port's blocks have yet."""
    return 1


def num_groups(cfg: ModelConfig) -> int:
    return cfg.num_layers // group_size(cfg)


def _require_rwkv(cfg: ModelConfig, i: int) -> None:
    kind = cfg.layer_kind(i)
    if kind != "rwkv":
        raise NotImplementedError(
            f"{cfg.name}: {kind!r} blocks are not ported yet (ROADMAP A.9)")


# ---------------------------------------------------------------------------
# per-layer blocks


def _init_block(gen: torch.Generator, cfg: ModelConfig, i: int) -> dict:
    _require_rwkv(cfg, i)
    z = dict(dtype=torch.float32, device=gen.device)
    return {"ln1": torch.zeros(cfg.d_model, **z),
            "ln2": torch.zeros(cfg.d_model, **z),
            "mix": rwkv6.init_rwkv_time_mix(gen, cfg),
            "ffn": rwkv6.init_rwkv_channel_mix(gen, cfg)}


def _apply_block(p: dict, cfg: ModelConfig, x: torch.Tensor, i: int,
                 mode: str, cache: Optional[dict]
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """One rwkv block in `mode` train | prefill | decode. Returns
    (x, cache_out); cache_out is None in train mode."""
    _require_rwkv(cfg, i)
    h = common.rms_norm(x, p["ln1"], cfg.norm_eps)
    if mode == "decode":
        a, c = rwkv6.time_mix_decode(p["mix"], cfg, h, cache)
    else:
        a, c = rwkv6.time_mix_train(p["mix"], cfg, h,
                                    return_state=(mode == "prefill"))
    x = x + a
    h = common.rms_norm(x, p["ln2"], cfg.norm_eps)
    if mode == "decode":
        f, c = rwkv6.channel_mix_decode(p["ffn"], cfg, h, c)
    else:
        f, c = rwkv6.channel_mix_train(p["ffn"], cfg, h, state=c,
                                       return_state=(mode == "prefill"))
    return x + f, c


# ---------------------------------------------------------------------------
# init


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params, drawn on the generator's device."""
    return {"embed": common.init_embedding(gen, cfg),
            "final_norm": torch.zeros(cfg.d_model, dtype=torch.float32,
                                      device=gen.device),
            "blocks": [_init_block(gen, cfg, i)
                       for i in range(cfg.num_layers)]}


# ---------------------------------------------------------------------------
# forward


def _run(blocks, cfg: ModelConfig, x, mode: str, caches=None,
         collect_feats: bool = False):
    """All layers in order. Returns (x, caches_out, feats)."""
    caches_out: List = []
    feats: List = []
    for i, blk in enumerate(blocks):
        x, c = _apply_block(blk, cfg, x, i, mode,
                            caches[i] if caches is not None else None)
        caches_out.append(c)
        if collect_feats:
            feats.append(x)
    return x, caches_out, feats


def lm_loss(params, cfg: ModelConfig, batch: dict,
            plan: Optional[FreezePlan] = None) -> Tuple[torch.Tensor, dict]:
    """The value of the JAX loss. batch: tokens [B, S], targets [B, S],
    optional mask [B, S]. A frozen group's params are detached, and so is
    the activation after a frozen prefix that starts at a frozen embedding
    (JAX's stop_gradient); gradients of this loss are not held against
    JAX yet."""
    emb = maybe_stop(params["embed"], bool(plan and plan.embed))
    x = common.embed_tokens(emb, cfg, batch["tokens"])
    prefix_stops_grad = bool(plan and plan.embed)
    for i, blk in enumerate(params["blocks"]):
        frozen = bool(plan and plan.groups and plan.groups[i])
        x, _ = _apply_block(maybe_stop(blk, frozen), cfg, x, i, "train", None)
        if frozen and prefix_stops_grad:
            x = x.detach()
        else:
            prefix_stops_grad = False
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = emb if cfg.tie_embeddings else params["embed"]
    head = maybe_stop(head, bool(plan and plan.head))
    logits = common.lm_logits(head, cfg, x)
    loss = common.cross_entropy(logits, batch["targets"], batch.get("mask"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return loss, {"loss": loss, "aux_loss": aux, "logits_mean": logits.mean()}


def lm_features(params, cfg: ModelConfig, batch: dict) -> List[torch.Tensor]:
    """Per-group hidden states for CKA probes: a list of [B, S, D]."""
    x = common.embed_tokens(params["embed"], cfg, batch["tokens"])
    return _run(params["blocks"], cfg, x, "train", collect_feats=True)[2]


# ---------------------------------------------------------------------------
# serving


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device=None) -> List[dict]:
    """Empty decode caches, one dict per layer, on `device` (CUDA unless
    given: `rwkv6.init_rwkv_state`). rwkv states are O(1) in sequence
    length, so `max_len` and `dtype` (attention caches' size and type in
    JAX) do not enter them."""
    for i in range(cfg.num_layers):
        _require_rwkv(cfg, i)
    return [rwkv6.init_rwkv_state(cfg, batch, device)
            for _ in range(cfg.num_layers)]


def lm_prefill(params, cfg: ModelConfig, batch: dict):
    """Returns (last-position logits [B, V] fp32, caches)."""
    x = common.embed_tokens(params["embed"], cfg, batch["tokens"])
    x, caches, _ = _run(params["blocks"], cfg, x, "prefill")
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = common.lm_logits(params["embed"], cfg, x[:, -1:])
    return logits[:, 0], caches


def lm_decode(params, cfg: ModelConfig, tokens: torch.Tensor, caches, pos):
    """tokens: [B, 1]; `pos` (the position, which attention caches need)
    does not enter rwkv blocks. Returns (logits [B, V], caches)."""
    x = common.embed_tokens(params["embed"], cfg, tokens)
    x, caches_out, _ = _run(params["blocks"], cfg, x, "decode", caches)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = common.lm_logits(params["embed"], cfg, x)
    return logits[:, 0], caches_out


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

"""BERT-base encoder classifier — the paper's NLP evaluation model (§V-B2,
20News benchmark), ported from `repro.models.bert`. Unrolled post-LN
encoder; freeze units are the embeddings, each encoder block and the
classifier head. The pooler belongs to no unit and always trains, as
in the reference.

Params layout (the JAX one, so the weights bridge unchanged): a token
table [vocab, d], a position table [MAX_POS, d], dense weights [in, out]
applied as ``x @ W + b``. The blocks reuse the ViT port's attention,
feed-forward and LayerNorm pieces (LN eps 1e-6, GELU in its tanh form).

Token ids stay the integer tensor the batch brought: `F.embedding`
takes int32 and int64 alike, so nothing is cast on the way in. Its
gradient is the dense [vocab, d] table torch's embedding backward
writes; on a CUDA device with at most 3072 ids a batch (the loop's
batches of 16 x 32 tokens have 512) that is one kernel that sums the
repeats of an id in a fixed order and never waits on the host, so a
train step is deterministic and replays from a CUDA graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.freeze_plan import maybe_stop
from repro_torch.models import common
from repro_torch.models.vit import _ln, _ln_p, init_ffn, init_mha, simple_mha

MAX_POS = 512


def init_bert(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params on the CPU, drawn from `generator` in the
    reference's order (tables, pooler, head, then block by block)."""
    d = cfg.d_model
    params = {
        "embed": {
            "tok": common.normal_init(generator, (cfg.vocab_size, d), 0.02),
            "pos": common.normal_init(generator, (MAX_POS, d), 0.02),
            "ln": _ln_p(d)},
        "blocks": [],
        "pooler": {"w": common.dense_init(generator, d, (d, d)),
                   "b": torch.zeros(d)},
        "head": {"w": common.dense_init(generator, d, (d, cfg.num_classes)),
                 "b": torch.zeros(cfg.num_classes)},
    }
    for _ in range(cfg.num_layers):
        params["blocks"].append({
            "attn": init_mha(generator, d), "ln1": _ln_p(d),
            "ffn": init_ffn(generator, d, cfg.d_ff), "ln2": _ln_p(d)})
    return params


def _forward(params, cfg: ModelConfig, tokens, plan, collect=False,
             use_pallas=False):
    S = tokens.shape[1]
    flags = plan.layers if plan is not None else (False,) * (len(params["blocks"]) + 2)
    emb = maybe_stop(params["embed"], flags[0])
    x = F.embedding(tokens, emb["tok"]) + emb["pos"][:S]
    x = _ln(x, emb["ln"])
    prefix_frozen = flags[0]
    if prefix_frozen:
        x = x.detach()
    feats = [x] if collect else []
    for bi, blk in enumerate(params["blocks"]):
        frozen = flags[1 + bi]
        blk = maybe_stop(blk, frozen)
        x = _ln(x + simple_mha(blk["attn"], x, cfg.num_heads,
                               use_pallas=use_pallas), blk["ln1"])
        h = common.activation(x @ blk["ffn"]["w1"] + blk["ffn"]["b1"], "gelu")
        x = _ln(x + (h @ blk["ffn"]["w2"] + blk["ffn"]["b2"]), blk["ln2"])
        if frozen and prefix_frozen:
            x = x.detach()
        else:
            prefix_frozen = False
        if collect:
            feats.append(x)
    pooled = torch.tanh(x[:, 0] @ params["pooler"]["w"] + params["pooler"]["b"])
    head = maybe_stop(params["head"], flags[-1])
    logits = pooled @ head["w"] + head["b"]
    return logits, feats


def build(cfg: ModelConfig, device: torch.device):
    from repro_torch.models import Model

    def loss(params, batch, plan=None):
        logits, _ = _forward(params, cfg, batch["tokens"], plan)
        l = common.cross_entropy(logits, batch["labels"])
        acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        return l, {"loss": l, "acc": acc, "logits": logits}

    @torch.inference_mode()
    def predict(params, batch):
        return _forward(params, cfg, batch["tokens"], None,
                        use_pallas=cfg.use_pallas)[0]

    @torch.inference_mode()
    def features(params, batch):
        return _forward(params, cfg, batch["tokens"], None, collect=True,
                        use_pallas=cfg.use_pallas)[1]

    return Model(cfg=cfg, device=device,
                 init=lambda generator: tree_map(
                     lambda t: t.to(device), init_bert(generator, cfg)),
                 loss=loss, features=features,
                 num_freeze_units=cfg.num_layers + 2, predict=predict)

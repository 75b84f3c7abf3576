"""DeiT-tiny — the paper's vision-transformer evaluation model (§V-A),
ported from `repro.models.vit`. Unrolled pre-LN ViT; freeze units are the
patch embed, each encoder block and the head.

Params layout (the JAX one, so the weights bridge without transposes):
dense weights are [in, out] and applied as ``x @ W + b``. The patch embed,
a stride-p "VALID" convolution over NHWC images in JAX, is a patch reshape
plus one matmul here, with its weight stored as [p*p*3, d] in the (row,
column, channel) order of the JAX HWIO kernel (`bridge.py` reshapes it).
"""
from __future__ import annotations

import torch

from repro_torch import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.freeze_plan import maybe_stop
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.models import common


def simple_mha(p, x, num_heads, causal=False, use_pallas=False):
    """Bidirectional MHA used by ViT/BERT. x: [B, S, D].

    `use_pallas` routes the attention core through the flash-attention
    kernel (repro_torch.kernels.attention), as the JAX model routes it
    through the Pallas kernel; without it the core is the kernel's plain
    version. Forward only: loss paths pass False."""
    B, S, D = x.shape
    hd = D // num_heads
    q = (x @ p["wq"] + p["bq"]).reshape(B, S, num_heads, hd)
    k = (x @ p["wk"] + p["bk"]).reshape(B, S, num_heads, hd)
    v = (x @ p["wv"] + p["bv"]).reshape(B, S, num_heads, hd)
    attend = att_ops.flash_attention if use_pallas else att_ops.attention_plain
    o = attend(q, k, v, causal=causal).to(x.dtype).reshape(B, S, D)
    return o @ p["wo"] + p["bo"]


def init_mha(gen, d):
    z = torch.zeros(d)
    return {"wq": common.dense_init(gen, d, (d, d)), "bq": z,
            "wk": common.dense_init(gen, d, (d, d)), "bk": z.clone(),
            "wv": common.dense_init(gen, d, (d, d)), "bv": z.clone(),
            "wo": common.dense_init(gen, d, (d, d)), "bo": z.clone()}


def init_ffn(gen, d, ff):
    return {"w1": common.dense_init(gen, d, (d, ff)), "b1": torch.zeros(ff),
            "w2": common.dense_init(gen, ff, (ff, d)), "b2": torch.zeros(d)}


def _ln_p(d):
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def _ln(x, p, eps=1e-6):
    return common.layer_norm(x, p["scale"], p["bias"], eps)


def patch_size(cfg: ModelConfig) -> int:
    return 4 if "reduced" in cfg.name else 16


def init_vit(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params on the CPU, drawn from `generator`."""
    d = cfg.d_model
    patch = patch_size(cfg)
    n_patch = (cfg.image_size // patch) ** 2
    params = {
        "patch": {"w": common.dense_init(generator, patch * patch * 3,
                                         (patch * patch * 3, d)),
                  "b": torch.zeros(d)},
        "cls": common.normal_init(generator, (1, 1, d), 0.02),
        "pos": common.normal_init(generator, (1, n_patch + 1, d), 0.02),
        "blocks": [],
        "final_ln": _ln_p(d),
        "head": {"w": common.dense_init(generator, d, (d, cfg.num_classes)),
                 "b": torch.zeros(cfg.num_classes)},
    }
    for _ in range(cfg.num_layers):
        params["blocks"].append({
            "ln1": _ln_p(d), "attn": init_mha(generator, d),
            "ln2": _ln_p(d), "ffn": init_ffn(generator, d, cfg.d_ff)})
    return params


def patches(images: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC images -> [B, (H/p)*(W/p), p*p*C] rows of the patch grid in
    row-major order, each patch flattened as (row, column, channel) — the
    windows a stride-p "VALID" convolution reads (trailing pixels that do
    not fill a patch are dropped, as VALID drops them)."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images[:, :gh * patch, :gw * patch]
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def _forward(params, cfg: ModelConfig, images, plan, collect=False,
             use_pallas=False):
    x = patches(images, patch_size(cfg)) @ params["patch"]["w"] \
        + params["patch"]["b"]
    B = x.shape[0]
    x = torch.cat([params["cls"].expand(B, 1, cfg.d_model), x], dim=1)
    x = x + params["pos"]
    flags = plan.layers if plan is not None else (False,) * (len(params["blocks"]) + 2)
    # unit 0 = patch embed (+cls/pos); units 1..L = blocks; unit L+1 = head
    feats = []
    prefix_frozen = True
    if flags[0]:
        x = x.detach()
    else:
        prefix_frozen = False
    if collect:
        feats.append(x)
    for bi, blk in enumerate(params["blocks"]):
        frozen = flags[1 + bi]
        blk = maybe_stop(blk, frozen)
        x = x + simple_mha(blk["attn"], _ln(x, blk["ln1"]), cfg.num_heads,
                           use_pallas=use_pallas)
        h = _ln(x, blk["ln2"])
        h = common.activation(h @ blk["ffn"]["w1"] + blk["ffn"]["b1"], "gelu")
        x = x + (h @ blk["ffn"]["w2"] + blk["ffn"]["b2"])
        if frozen and prefix_frozen:
            x = x.detach()
        else:
            prefix_frozen = False
        if collect:
            feats.append(x)
    x = _ln(x, params["final_ln"])
    head = maybe_stop(params["head"], flags[-1])
    logits = x[:, 0] @ head["w"] + head["b"]
    return logits, feats


def build(cfg: ModelConfig, device: torch.device):
    from repro_torch.models import Model

    def loss(params, batch, plan=None):
        logits, _ = _forward(params, cfg, batch["images"], plan)
        l = common.cross_entropy(logits, batch["labels"])
        acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        return l, {"loss": l, "acc": acc, "logits": logits}

    @torch.inference_mode()
    def predict(params, batch):
        return _forward(params, cfg, batch["images"], None,
                        use_pallas=cfg.use_pallas)[0]

    @torch.inference_mode()
    def features(params, batch):
        return _forward(params, cfg, batch["images"], None, collect=True,
                        use_pallas=cfg.use_pallas)[1]

    return Model(cfg=cfg, device=device,
                 init=lambda generator: tree_map(
                     lambda t: t.to(device), init_vit(generator, cfg)),
                 loss=loss, features=features,
                 num_freeze_units=cfg.num_layers + 2, predict=predict)

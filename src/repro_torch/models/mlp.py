"""Gated (SwiGLU / GeGLU) feed-forward block, ported from
`repro.models.mlp`: ``act(x Wg) * (x Wu) Wd``, dense weights [in, out].
In a sharded step whose spec splits the hidden dim over `model`, `wg` and
`wu` are column-parallel and `wd` row-parallel, the parts summed over
`model`; a step whose rows are not split keeps their FSDP shards where
they lie (`spmd.matmul`)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.models import common


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = common.dtype_of(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    return {"wg": common.dense_init(gen, d, (d, ff), dt),
            "wu": common.dense_init(gen, d, (d, ff), dt),
            "wd": common.dense_init(gen, ff, (ff, d), dt)}


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    split = spmd.split(p["wd"], 0, cfg.d_ff)
    if split:
        x = spmd.to_model(x)
    g = common.activation(spmd.matmul(x, p["wg"]), cfg.act)
    h = shd.hint(g * spmd.matmul(x, p["wu"]), shd.BATCH_AXES, None, "model")
    return spmd.matmul(h, p["wd"], cfg.d_model, split)

"""Carry the JAX package's ViT params across to the port.

`params_from_jax` takes the params tree of `repro.models.vit.init_vit` as
nested dicts and lists of **numpy** arrays (for example
``jax.tree.map(np.asarray, params)``), so JAX is never needed where the
port runs. The port keeps the JAX layouts — dense weights [in, out] used
as ``x @ W`` — so every leaf crosses unchanged except the patch embed: its
HWIO kernel (p, p, 3, d) becomes the [p*p*3, d] matrix of the port's
patch reshape (repro_torch.models.vit.patches), whose (row, column,
channel) order is the HWIO order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models.vit import patch_size


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's ViT params on `device` from a JAX ViT params tree of
    numpy arrays. Raises if the tree does not fit `cfg`."""
    device = resolve_device(device)
    if cfg.family != "vit":
        raise NotImplementedError(f"no bridge for {cfg.family!r} params yet")
    p, d = patch_size(cfg), cfg.d_model
    w = np.asarray(tree["patch"]["w"])
    if w.shape != (p, p, 3, d) or len(tree["blocks"]) != cfg.num_layers:
        raise ValueError(f"params do not fit {cfg.name}: patch kernel "
                         f"{w.shape}, {len(tree['blocks'])} blocks")
    out = tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                          device=device), tree)
    out["patch"]["w"] = out["patch"]["w"].reshape(p * p * 3, d)
    return out

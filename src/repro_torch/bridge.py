"""Carry the JAX package's params across to the port.

`params_from_jax` takes a params tree of the JAX package as nested dicts,
lists and tuples of **numpy** arrays (for example
``jax.tree.map(np.asarray, params)``), so JAX is never needed where the
port runs. The port keeps the JAX layouts — dense weights [in, out] used
as ``x @ W`` — so leaves cross unchanged, except:

- ViT: every leaf becomes fp32, and the patch embed's HWIO kernel
  (p, p, 3, d) becomes the [p*p*3, d] matrix of the port's patch reshape
  (repro_torch.models.vit.patches), whose (row, column, channel) order is
  the HWIO order.
- CNNs: every leaf becomes fp32; the HWIO convolution kernels and the
  [in, out] head cross unchanged (repro_torch.models.cnn permutes the
  kernels at call time).
- BERT: every leaf becomes fp32 and crosses unchanged (token and
  position tables, [in, out] dense weights).
- LMs: each leaf keeps its own dtype (the rwkv, mamba and MoE inits mix
  fp32 and `param_dtype` leaves), and the blocks, which JAX stacks along a
  leading group axis [G, ...] (``scan_layers``) or keeps as per-group
  lists, become the port's list of per-layer dicts (a MoE layer's expert
  weights [G, E, ...] become [E, ...]).

Trees of the params' structure cross the same way: a gradient tree, as
`jax.grad` returns it, through `params_from_jax` itself, and an AdamW
state (`adamw_state_from_jax`: its step count and both moment trees).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device, tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import bert, cnn
from repro_torch.models.vit import patch_size
from repro_torch.optim import AdamWState


def from_numpy(tree, device):
    """A tree of numpy arrays as tensors on `device`, each in its own
    dtype. numpy has no bfloat16 of its own: a JAX bf16 array arrives as
    an ml_dtypes bfloat16 array, which torch rejects, so it crosses as
    fp32 and is rounded back to bf16 in torch (exact both ways)."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)

    return tree_map(leaf, tree)


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's params on `device` from a JAX params tree of numpy
    arrays. Raises if the tree does not fit `cfg`."""
    device = resolve_device(device)
    if cfg.family == "vit":
        return _vit_params(tree, cfg, device)
    if cfg.family == "cnn":
        return _cnn_params(tree, cfg, device)
    if cfg.family == "encoder":
        return _bert_params(tree, cfg, device)
    if cfg.is_lm:
        return _lm_params(tree, cfg, device)
    raise NotImplementedError(f"no bridge for {cfg.family!r} params yet")


def adamw_state_from_jax(state, cfg: ModelConfig, device=None) -> AdamWState:
    """A JAX `AdamWState` (step, m, v) of numpy arrays as the port's: the
    0-d int32 step and both moment trees, laid out as params."""
    step, m, v = state
    device = resolve_device(device)
    return AdamWState(
        step=torch.as_tensor(np.array(step), dtype=torch.int32,
                             device=device),
        m=params_from_jax(m, cfg, device), v=params_from_jax(v, cfg, device))


def _vit_params(tree: dict, cfg: ModelConfig, device) -> dict:
    p, d = patch_size(cfg), cfg.d_model
    w = np.asarray(tree["patch"]["w"])
    if w.shape != (p, p, 3, d) or len(tree["blocks"]) != cfg.num_layers:
        raise ValueError(f"params do not fit {cfg.name}: patch kernel "
                         f"{w.shape}, {len(tree['blocks'])} blocks")
    out = _fp32(tree, device)
    out["patch"]["w"] = out["patch"]["w"].reshape(p * p * 3, d)
    return out


def _fp32(tree, device):
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=device), tree)


def _cnn_params(tree: dict, cfg: ModelConfig, device) -> dict:
    if cfg.name.startswith("resnet"):
        spec = cnn.resnet_static_spec(cfg)[:-1]
        stem = (7, 7, 3, cnn._resnet_spec(cfg)[1])
    else:
        spec = cnn.mbv2_static_spec(cfg)
        stem = (3, 3, 3, spec[0]["cout"])
    w = np.asarray(tree["units"][0]["conv"])
    if len(tree["units"]) != len(spec) or w.shape != stem:
        raise ValueError(f"params do not fit {cfg.name}: "
                         f"{len(tree['units'])} units (want {len(spec)}), "
                         f"stem kernel {w.shape} (want {stem})")
    return {"units": _fp32(tree["units"], device),
            "head": _fp32(tree["head"], device)}


def _bert_params(tree: dict, cfg: ModelConfig, device) -> dict:
    emb = tree["embed"]
    want = {"tok": (cfg.vocab_size, cfg.d_model),
            "pos": (bert.MAX_POS, cfg.d_model)}
    got = {k: np.asarray(emb[k]).shape for k in want}
    w1 = [np.asarray(b["ffn"]["w1"]).shape for b in tree["blocks"]]
    if got != want or w1 != [(cfg.d_model, cfg.d_ff)] * cfg.num_layers:
        raise ValueError(f"params do not fit {cfg.name}: tables {got} "
                         f"(want {want}), ffn kernels {w1} (want "
                         f"{cfg.num_layers} of {(cfg.d_model, cfg.d_ff)})")
    return _fp32(tree, device)


def _lm_params(tree: dict, cfg: ModelConfig, device) -> dict:
    offsets = tree["blocks"]  # one entry per layer offset within a group
    g = len(offsets)
    if isinstance(offsets[0], dict):  # stacked: leaves [G, ...]
        G = len(np.asarray(tree_leaves(offsets[0])[0]))
        per_group = [[tree_map(lambda a, gi=gi: np.asarray(a)[gi], offsets[o])
                      for o in range(g)] for gi in range(G)]
    else:  # unrolled: offsets[o][gi]
        per_group = [[offsets[o][gi] for o in range(g)]
                     for gi in range(len(offsets[0]))]
    blocks = [blk for group in per_group for blk in group]
    if len(blocks) != cfg.num_layers or \
            np.asarray(tree["embed"]["tok"]).shape != (cfg.vocab_size,
                                                      cfg.d_model):
        raise ValueError(f"params do not fit {cfg.name}: {len(blocks)} "
                         f"layers, token table "
                         f"{np.asarray(tree['embed']['tok']).shape}")
    rest = {k: v for k, v in tree.items() if k != "blocks"}
    return {**from_numpy(rest, device), "blocks": from_numpy(blocks, device)}

"""Freeze-aware optimizers (AdamW, SGD-momentum) on params trees, ported
from `repro.optim.optimizer`.

Every update is out-of-place: it returns new tensors and writes none it
was given, because the params it reads may also be what the inference
server publishes and SimFreeze's reference holds (the JAX arrays are
immutable). The step count is a 0-d int32 tensor.

Leaves of params, grads, moments and masks pair by dict key, as
`jax.tree.map` pairs them, whatever order each dict holds its keys in;
trees with different key sets raise `ValueError`.

- `masks`: a 0/1 multiplier tree. Frozen leaves keep params, m and v
  exactly (no weight decay, no momentum). Note that
  `runtime.train_loop.TrainStepCache` calls the updates *without* masks,
  as the reference does: a frozen unit gets a zero gradient, and AdamW
  still applies weight decay and the decaying first moment to it.
- `state_dtype`: moment storage in another dtype (e.g. "bfloat16").
- global-norm clipping and a cosine-with-warmup schedule included.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tree_leaves, tree_map, tree_unflatten, tree_zip


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    state_dtype: Optional[str] = None  # None = same as param


def global_norm(tree) -> torch.Tensor:
    total = sum(torch.sum(torch.square(leaf.float()))
                for leaf in tree_leaves(tree))
    return torch.sqrt(total + 1e-30)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm, max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _mask(mask, like: torch.Tensor) -> torch.Tensor:
    """A mask leaf (a scalar or a per-group vector) as fp32, shaped to
    broadcast against the param leaf `like`."""
    mk = torch.as_tensor(mask, dtype=torch.float32, device=like.device)
    if 0 < mk.dim() < like.dim():
        mk = mk.reshape(mk.shape + (1,) * (like.dim() - mk.dim()))
    return mk


def adamw_init(params, config: AdamWConfig) -> AdamWState:
    def zeros_like(p):
        dt = getattr(torch, config.state_dtype) if config.state_dtype \
            else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamWState(step=step, m=tree_map(zeros_like, params),
                      v=tree_map(zeros_like, params))


def adamw_update(grads, state: AdamWState, params, config: AdamWConfig,
                 lr_scale=1.0, masks=None):
    """Returns (new_params, new_state). `masks` leaves broadcast against the
    param leaf (scalars or [G]-shaped per-group masks)."""
    if config.clip_norm:
        grads, _ = clip_by_global_norm(grads, config.clip_norm)
    step = state.step + 1
    b1, b2 = config.b1, config.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    lr = config.lr * lr_scale

    def leaf_update(p, g, m, v, mask=None):
        gf, mf, vf = g.float(), m.float(), v.float()
        m_new = b1 * mf + (1 - b1) * gf
        v_new = b2 * vf + (1 - b2) * gf * gf
        upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + config.eps)
        upd = upd + config.weight_decay * p.float()
        if mask is not None:
            mk = _mask(mask, upd)
            upd = upd * mk
            m_new = torch.where(mk > 0, m_new, mf)
            v_new = torch.where(mk > 0, v_new, vf)
        p_new = (p.float() - lr * upd).to(p.dtype)
        return p_new, m_new.to(m.dtype), v_new.to(v.dtype)

    trees = (params, grads, state.m, state.v) + \
        (() if masks is None else (masks,))
    out = [leaf_update(*a) for a in tree_zip(*trees)]
    p_new, m_new, v_new = (tree_unflatten(params, leaves)
                           for leaves in zip(*out))
    return p_new, AdamWState(step=step, m=m_new, v=v_new)


# ---------------------------------------------------------------------------
# SGD momentum (lighter state; used for some edge experiments)


class SGDMState(NamedTuple):
    step: torch.Tensor
    mom: Any


@dataclass(frozen=True)
class SGDMConfig:
    lr: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 1e-4
    clip_norm: float = 0.0


def sgdm_init(params, config: SGDMConfig) -> SGDMState:
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return SGDMState(step=step, mom=tree_map(torch.zeros_like, params))


def sgdm_update(grads, state: SGDMState, params, config: SGDMConfig,
                lr_scale=1.0, masks=None):
    if config.clip_norm:
        grads, _ = clip_by_global_norm(grads, config.clip_norm)
    lr = config.lr * lr_scale

    def leaf(p, g, m, mask=None):
        mf = m.float()
        m_new = config.momentum * mf + (g.float()
                                        + config.weight_decay * p.float())
        upd = m_new
        if mask is not None:
            mk = _mask(mask, upd)
            upd = upd * mk
            m_new = torch.where(mk > 0, m_new, mf)
        return (p.float() - lr * upd).to(p.dtype), m_new.to(m.dtype)

    trees = (params, grads, state.mom) + (() if masks is None else (masks,))
    out = [leaf(*a) for a in tree_zip(*trees)]
    p_new, m_new = (tree_unflatten(params, leaves) for leaves in zip(*out))
    return p_new, SGDMState(step=state.step + 1, mom=m_new)


# ---------------------------------------------------------------------------
# schedule


def cosine_schedule(step, *, base_lr=1.0, warmup: int = 100,
                    total: int = 10_000, min_frac: float = 0.1):
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos

"""Shared building blocks of the paper models: initializers, LayerNorm,
activations and cross-entropy (counterpart of `repro.models.common`).

Params are plain dicts of tensors. Initializers draw from a
`torch.Generator` on the CPU; the caller moves the result to its device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def normal_init(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32) * scale


def dense_init(generator: torch.Generator, fan_in: int, shape) -> torch.Tensor:
    """Normal init scaled by 1/sqrt(fan_in)."""
    return normal_init(generator, shape, 1.0 / math.sqrt(max(fan_in, 1)))


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with the population variance, as the JAX model computes
    it (the eps is the caller's: the ViT uses 1e-6, not torch's 1e-5)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation; torch's default
        # is the exact erf form
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    raise ValueError(kind)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood of `targets`, computed in fp32 with
    the max shifted out first."""
    logits = logits.float()
    m = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = logits - m
    logz = torch.log(torch.exp(shifted).sum(dim=-1))
    picked = shifted.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - picked
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()

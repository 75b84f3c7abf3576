"""Shared building blocks of the ported models: initializers, norms,
activations, token embeddings, LM logits and cross-entropy (counterpart of
`repro.models.common`).

Params are plain dicts of tensors. Initializers draw from a
`torch.Generator` on the generator's own device: the paper models draw on
the CPU and the caller moves the result; the LMs draw on the model's
device, which spares a 3B-param model a trip through host memory.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def normal_init(generator: torch.Generator, shape, scale: float,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """fp32 normal draws times `scale`, then cast to `dtype` (the JAX
    package's order of rounding)."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return x.to(dtype)


def dense_init(generator: torch.Generator, fan_in: int, shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal init scaled by 1/sqrt(fan_in)."""
    return normal_init(generator, shape, 1.0 / math.sqrt(max(fan_in, 1)),
                       dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 with a zero-centred scale (weights ``1 + scale``,
    as the JAX model stores them), cast back to the input dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with the population variance, as the JAX model computes
    it (the eps is the caller's: the ViT uses 1e-6, not torch's 1e-5)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


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


def _no_frontend(cfg: ModelConfig) -> None:
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} modality frontend stub is not "
            "ported yet (ROADMAP A.9)")


def init_embedding(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Token table [V, d] and, untied, the LM head [d, V] in the params'
    dtype."""
    _no_frontend(cfg)
    dt = dtype_of(cfg)
    p = {"tok": normal_init(generator, (cfg.vocab_size, cfg.d_model), 0.02,
                            dt)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(generator, cfg.d_model,
                               (cfg.d_model, cfg.vocab_size), dt)
    return p


def embed_tokens(p: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> [B, S, d] in the table's dtype (tied tables scale
    by sqrt(d), rounded to that dtype first, as in JAX). No frontend
    prefix: the frontend stub is not ported."""
    _no_frontend(cfg)
    x = F.embedding(tokens.long(), p["tok"])
    if cfg.is_lm and cfg.tie_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def lm_logits(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """[B, S, d] -> fp32 logits [B, S, V]; the product runs in the
    activations' dtype and is cast after, as in JAX."""
    logits = x @ (p["tok"].T if cfg.tie_embeddings else p["head"])
    return softcap(logits.float(), cfg.final_logit_softcap)


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

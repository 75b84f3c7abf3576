"""Shared building blocks of the ported models: initializers, norms,
activations, RoPE and M-RoPE, token embeddings with the modality frontend
stub, LM logits and cross-entropy (counterpart of `repro.models.common`).

Params are plain dicts of tensors. Initializers draw from a
`torch.Generator` on the generator's own device: the paper models draw on
the CPU and the caller moves the result; the LMs draw on the model's
device, which spares a 3B-param model a trip through host memory.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import spmd

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


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE for qwen2-vl). The JAX order of rounding: angles and the
# rotation in fp32, then a cast back to the input's dtype.


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd] rotated by fp32 angles [..., S, hd/2] (the same
    angle for every head): the halves of hd are the pairs."""
    angles = angles[..., None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    freqs = torch.from_numpy(rope_freqs(x.shape[-1], theta)).to(x.device)
    return _rotate(x, positions.float()[..., None] * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: [B, S, H, hd]; positions3: [3, B, S]
    (t, h, w position ids); `sections` gives the number of hd/2 frequency
    slots taken from each of the three axes (sum(sections) == hd // 2)."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    sec_id = torch.from_numpy(np.concatenate(
        [np.full(s, i) for i, s in enumerate(sections)])).to(x.device)
    pos_per_slot = positions3.float()[sec_id]  # [hd/2, B, S]
    return _rotate(x, pos_per_slot.movedim(0, -1) * freqs)


def default_mrope_positions(batch: int, seq: int,
                            device=None) -> torch.Tensor:
    """Text-only M-RoPE: the same position on all 3 axes, [3, B, S]."""
    p = torch.arange(seq, device=device)[None, :].expand(batch, seq)
    return torch.stack([p, p, p], dim=0)


# ---------------------------------------------------------------------------
# embedding


def init_embedding(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Token table [V, d], untied the LM head [d, V], and with a modality
    frontend the stub's projection [frontend_dim, d], in the params'
    dtype."""
    dt = dtype_of(cfg)
    p = {"tok": normal_init(generator, (cfg.vocab_size, cfg.d_model), 0.02,
                            dt)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(generator, cfg.d_model,
                               (cfg.d_model, cfg.vocab_size), dt)
    if cfg.frontend != "none":
        p["frontend_proj"] = dense_init(generator, cfg.frontend_dim,
                                        (cfg.frontend_dim, cfg.d_model), dt)
    return p


def embed_tokens(p: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """tokens [B, S] -> [B, S, d] in the table's dtype (tied tables scale
    by sqrt(d), rounded to that dtype first, as in JAX). With a frontend,
    the stub's precomputed patch / frame embeddings [B, F, frontend_dim]
    are projected and prepended: [B, F + S, d]. In a sharded step a table
    split over `model` by the vocabulary looks up the rows it holds and
    the ranks' rows are summed; a projection split by d is gathered."""
    table = p["tok"]
    if spmd.split(table, 0, cfg.vocab_size):
        lo, hi = spmd.part(cfg.vocab_size)
        ids = tokens.long()
        inside = (ids >= lo) & (ids < hi)
        x = F.embedding((ids - lo).clamp(0, hi - lo - 1), table)
        x = spmd.from_model(torch.where(inside[..., None], x, 0.0))
    else:
        x = F.embedding(tokens.long(), table)
    x = spmd.columns(x, cfg.d_model)
    if cfg.is_lm and cfg.tie_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if frontend_embeds is not None and cfg.frontend != "none":
        proj = p["frontend_proj"]
        pre = frontend_embeds.to(x.dtype) @ proj
        if spmd.split(proj, 1, cfg.d_model):
            pre = spmd.gather_model(pre, -1)
        x = torch.cat([pre, x], dim=1)
    return x


def lm_logits(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """[B, S, d] -> fp32 logits [B, S, V]; the product runs in the
    activations' dtype and is cast after, as in JAX. A head split over
    `model` by the vocabulary gives this rank's logits [B, S, V / tp]."""
    head = p["tok"].T if cfg.tie_embeddings else p["head"]
    if spmd.split(head, 1, cfg.vocab_size):
        x = spmd.to_model(x)
    logits = spmd.matmul(x, head)
    return softcap(logits.float(), cfg.final_logit_softcap)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Mean negative log-likelihood of `targets`, computed in fp32 with
    the max shifted out first. In a sharded step, logits split over
    `model` by the vocabulary (fewer than `vocab`) take the max, the sum
    of exponentials and the target's logit as reductions over `model`,
    and a batch split over the data axes gives this rank's share of the
    global mean (`spmd.data_sum` adds the shares)."""
    logits = logits.float()
    split = vocab is not None and logits.shape[-1] != vocab
    m = logits.max(dim=-1, keepdim=True).values.detach()
    if split:
        m = spmd.model_max(m)
    shifted = logits - m
    sumexp = torch.exp(shifted).sum(dim=-1)
    if split:
        sumexp = spmd.from_model(sumexp)
    logz = torch.log(sumexp)
    if split:
        lo, hi = spmd.part(vocab)
        ids = targets.long()
        inside = (ids >= lo) & (ids < hi)
        picked = shifted.gather(-1, (ids - lo).clamp(0, hi - lo - 1)[
            ..., None])[..., 0]
        picked = spmd.from_model(torch.where(inside, picked, 0.0))
    else:
        picked = shifted.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - picked
    n = spmd.nd()
    if mask is not None:
        count = mask.sum()
        if n > 1:
            count = spmd.data_total(count)
            return spmd.data_sum((nll * mask).sum()
                                 / torch.clamp(count, min=1.0))
        return (nll * mask).sum() / torch.clamp(count, min=1.0)
    if n > 1:
        return spmd.data_sum(nll.sum() / (nll.numel() * n))
    return nll.mean()

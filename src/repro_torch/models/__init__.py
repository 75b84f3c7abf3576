"""Model zoo of the port. ``build_model(cfg, device=...)`` returns the
same uniform ``Model`` record as `repro.models.build_model`, with the
device the model's functions run on.

Params stay a separate object — a plain dict of tensors passed as
``predict(params, batch)`` — because the serving path coalesces requests
and publishes new params by params *identity*
(runtime/inference.py)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable                      # (generator) -> params on `device`
    loss: Callable                      # (params, batch, plan) -> (loss, metrics)
    features: Callable                  # (params, batch) -> list of activations
    num_freeze_units: int               # one per unrolled layer (LMs: group)
    prefill: Optional[Callable] = None  # LMs: (params, batch) -> (logits, cache)
    decode: Optional[Callable] = None   # LMs: (params, tokens, cache, pos) -> (logits, cache)
    init_cache: Optional[Callable] = None  # LMs: (batch, max_len, dtype) -> cache
    predict: Optional[Callable] = None  # classifiers: (params, batch) -> logits


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model of `cfg` on `device` (CUDA unless the caller passes
    another; raises when no GPU is present and none was named)."""
    device = resolve_device(device)
    if cfg.is_lm:
        from repro_torch.models import transformer

        return transformer.build(cfg, device)
    if cfg.family == "vit":
        from repro_torch.models import vit

        return vit.build(cfg, device)
    raise NotImplementedError(f"{cfg.family!r} models are not ported yet "
                              f"(ROADMAP A.2: the CNNs and bert-base)")

"""Serving-side helpers of `repro.runtime.train_loop`: host batches to
device tensors, and labeled evaluation. The train-step cache comes with
the fine-tuning slice of the port."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def as_tensor(batch: dict, device) -> dict:
    """Host batch dict -> tensors on `device` (shared by training and
    serving; the counterpart of `as_jnp`)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def evaluate(model, params, batch) -> Tuple[float, np.ndarray]:
    """Returns (accuracy, logits as host numpy) on a labeled batch of
    tensors on the model's device."""
    if model.predict is None:
        raise ValueError("model has no predict()")
    logits = model.predict(params, batch)
    acc = float((logits.argmax(-1) == batch["labels"]).float().mean())
    return acc, logits.cpu().numpy()

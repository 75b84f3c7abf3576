"""Config registry for the paper models: ``get_config(name)`` (full size)
and ``get_reduced(name)`` (CPU-runnable)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import paper_models
from repro_torch.configs.base import ModelConfig

PAPER_MODELS: Dict[str, ModelConfig] = {
    "resnet50": paper_models.RESNET50,
    "mobilenetv2": paper_models.MOBILENETV2,
    "deit-tiny": paper_models.DEIT_TINY,
    "bert-base": paper_models.BERT_BASE,
}

_PAPER_REDUCED = {
    "resnet50": paper_models.resnet_reduced,
    "mobilenetv2": paper_models.mobilenet_reduced,
    "deit-tiny": paper_models.deit_reduced,
    "bert-base": paper_models.bert_reduced,
}


def get_config(name: str) -> ModelConfig:
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    raise KeyError(f"unknown model {name!r}; known: {sorted(PAPER_MODELS)}")


def get_reduced(name: str) -> ModelConfig:
    if name in _PAPER_REDUCED:
        return _PAPER_REDUCED[name]()
    raise KeyError(f"unknown model {name!r}; known: {sorted(_PAPER_REDUCED)}")


__all__ = ["ModelConfig", "PAPER_MODELS", "get_config", "get_reduced"]

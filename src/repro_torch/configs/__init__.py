"""Config registry for the paper models and the ported LMs:
``get_config(name)`` (full size) and ``get_reduced(name)``
(CPU-runnable)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import paper_models, rwkv6_3b
from repro_torch.configs.base import ModelConfig

PAPER_MODELS: Dict[str, ModelConfig] = {
    "resnet50": paper_models.RESNET50,
    "mobilenetv2": paper_models.MOBILENETV2,
    "deit-tiny": paper_models.DEIT_TINY,
    "bert-base": paper_models.BERT_BASE,
}

# the LM architectures ported so far (of the JAX package's ten)
LM_MODELS: Dict[str, ModelConfig] = {
    "rwkv6-3b": rwkv6_3b.CONFIG,
}

_REDUCED = {
    "resnet50": paper_models.resnet_reduced,
    "mobilenetv2": paper_models.mobilenet_reduced,
    "deit-tiny": paper_models.deit_reduced,
    "bert-base": paper_models.bert_reduced,
    "rwkv6-3b": rwkv6_3b.reduced,
}


def get_config(name: str) -> ModelConfig:
    known = {**PAPER_MODELS, **LM_MODELS}
    if name in known:
        return known[name]
    raise KeyError(f"unknown model {name!r}; known: {sorted(known)}")


def get_reduced(name: str) -> ModelConfig:
    if name in _REDUCED:
        return _REDUCED[name]()
    raise KeyError(f"unknown model {name!r}; known: {sorted(_REDUCED)}")


__all__ = ["LM_MODELS", "ModelConfig", "PAPER_MODELS", "get_config", "get_reduced"]

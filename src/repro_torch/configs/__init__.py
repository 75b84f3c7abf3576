"""Config registry for the paper models and the JAX package's ten LM
architectures (`ARCHS`): ``get_config(name)`` (full size),
``get_reduced(name)`` (CPU-runnable), the four LM shapes (`LM_SHAPES`,
``get_shape(name)``) and which (arch, shape) cells run
(`cell_is_applicable`)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (gemma2_2b, gemma2_27b, granite_20b,
                                 jamba_1_5_large_398b, kimi_k2_1t_a32b,
                                 musicgen_medium, paper_models, qwen1_5_32b,
                                 qwen2_vl_72b, qwen3_moe_30b_a3b, rwkv6_3b)
from repro_torch.configs.base import (DECODE_32K, LM_SHAPES, LONG_500K,
                                      PREFILL_32K, TRAIN_4K, ModelConfig,
                                      ShapeConfig)

# the JAX package's ten LM architectures, in its order
# (`repro.configs.ARCHS`)
_LM_MODULES = {
    "qwen2-vl-72b": qwen2_vl_72b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "gemma2-2b": gemma2_2b,
    "granite-20b": granite_20b,
    "gemma2-27b": gemma2_27b,
    "qwen1.5-32b": qwen1_5_32b,
    "rwkv6-3b": rwkv6_3b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "musicgen-medium": musicgen_medium,
}
ARCHS = tuple(_LM_MODULES)

PAPER_MODELS: Dict[str, ModelConfig] = {
    "resnet50": paper_models.RESNET50,
    "mobilenetv2": paper_models.MOBILENETV2,
    "deit-tiny": paper_models.DEIT_TINY,
    "bert-base": paper_models.BERT_BASE,
}

LM_MODELS: Dict[str, ModelConfig] = {
    name: mod.CONFIG for name, mod in _LM_MODULES.items()}

_REDUCED = {
    "resnet50": paper_models.resnet_reduced,
    "mobilenetv2": paper_models.mobilenet_reduced,
    "deit-tiny": paper_models.deit_reduced,
    "bert-base": paper_models.bert_reduced,
    **{name: mod.reduced for name, mod in _LM_MODULES.items()},
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


def get_shape(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """'' if the (arch, shape) cell runs, else a skip reason."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "skip: full quadratic attention at 524288 ctx (DESIGN.md §4)"
    return ""


__all__ = ["ARCHS", "DECODE_32K", "LM_MODELS", "LM_SHAPES", "LONG_500K",
           "ModelConfig", "PAPER_MODELS", "PREFILL_32K", "ShapeConfig",
           "TRAIN_4K", "cell_is_applicable", "get_config", "get_reduced",
           "get_shape"]

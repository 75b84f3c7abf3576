"""Model configuration record for the port (counterpart of
`repro.configs.base`).

Only the fields the paper's own models (ETuner §V-A) read are carried;
the LM-architecture fields arrive with the LM slice of the port."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description of one paper model (CNN, ViT or encoder)."""

    name: str
    family: str  # cnn | vit | encoder
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    act: str = "silu"
    image_size: int = 0
    num_classes: int = 0
    width_mult: float = 1.0
    # route attention forwards through the hand-written flash-attention
    # kernel (repro_torch.kernels.attention); the name follows the JAX
    # config, where it selects the Pallas kernel. Forward only: the loss
    # path keeps the plain attention.
    use_pallas: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

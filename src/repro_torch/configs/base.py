"""Model configuration record for the port (counterpart of
`repro.configs.base`).

Only the fields the ported models read are carried: those of the paper's
own models (ETuner §V-A) and those of the rwkv6 LM path. The fields of
the attention, mamba and MoE LM blocks arrive with those blocks."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description of one paper model (CNN, ViT or encoder)
    or decoder LM (so far only the rwkv6 family)."""

    name: str
    family: str  # cnn | vit | encoder | ssm
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

    # --- decoder LMs ---
    rwkv_head_size: int = 64
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # the activations follow the params' dtype, as in the JAX model, where
    # the embedding table sets it; `dtype` is carried for parity
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    frontend: str = "none"       # none | vision_stub | audio_stub
    final_logit_softcap: float = 0.0
    # the JAX model stacks the layers and scans over them; the port always
    # runs them as a Python loop over per-layer params (the bridge unstacks)
    scan_layers: bool = True
    ssm_chunk: int = 128         # rwkv chunk length of `wkv_chunked`
    # route attention forwards through the hand-written flash-attention
    # kernel (repro_torch.kernels.attention); the name follows the JAX
    # config, where it selects the Pallas kernel. Forward only: the loss
    # path keeps the plain attention. In the rwkv6 time-mix it routes the
    # WKV recurrence through the hand-written WKV6 kernel
    # (repro_torch.kernels.rwkv), where the JAX model always takes its
    # chunked closed form.
    use_pallas: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def is_lm(self) -> bool:
        return self.family in ("dense", "moe", "hybrid", "ssm", "vlm", "audio")

    def layer_kind(self, i: int) -> str:
        """Kind of block at layer index i: 'rwkv' for the ssm family,
        else 'attn' (the port's config carries no mamba interleave yet)."""
        return "rwkv" if self.family == "ssm" else "attn"

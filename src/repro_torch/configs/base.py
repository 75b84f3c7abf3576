"""Model configuration record for the port (counterpart of
`repro.configs.base`).

Carries the fields of the paper's own models (ETuner §V-A) and of the
decoder LMs: the attention, RoPE/M-RoPE, frontend-stub and block-layout
fields of the attention LMs, the rwkv6 fields, and the MoE and hybrid
fields of jamba, qwen3-moe and kimi-k2, and the MoE's group-local
dispatch (`moe_local_dispatch`) and the sharding fields
(`attn_batch_shard`, `shard_head_dim`); `ShapeConfig` and the four LM
shapes; the analytic parameter counts. The reference's `scan_unroll` has
no counterpart: the port's layers are always a Python loop, so an
override of it fails as an unknown field."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape x step-kind) cell of the dry-run matrix."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# the four LM shapes of the JAX package (the same for all ten archs)
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description of one paper model (CNN, ViT or encoder)
    or decoder LM (dense, MoE, hybrid, ssm, vlm or audio)."""

    name: str
    family: str  # cnn | vit | encoder | dense | moe | hybrid | ssm | vlm | audio
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

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1          # MoE layer every `moe_period` layers
    capacity_factor: float = 1.25
    moe_d_ff: int = 0            # expert hidden size (defaults to d_ff)
    router_aux_coef: float = 0.01

    # --- attention flavour ---
    sliding_window: int = 0          # >0: local attention window
    local_global_period: int = 0     # gemma2: local/global every k layers
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0 # gemma2: 30.0
    qkv_bias: bool = False           # qwen1.5 / qwen2
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w)

    # --- hybrid / ssm ---
    attn_period: int = 0         # jamba: 1 attention layer every attn_period
    mamba_state: int = 16
    mamba_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_size: int = 64

    # --- misc ---
    post_norms: bool = False     # gemma2: post-attn / post-ffn norms
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # the activations follow the params' dtype, as in the JAX model, where
    # the embedding table sets it; `dtype` is carried for parity
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # --- modality frontend stub ---
    frontend: str = "none"       # none | vision_stub | audio_stub
    frontend_dim: int = 0        # raw patch / frame embedding dim
    frontend_tokens: int = 0     # prefix tokens supplied by the stub

    # --- execution ---
    # the JAX model stacks the layers and scans over them; the port always
    # runs them as a Python loop over per-layer params (the bridge unstacks)
    scan_layers: bool = True
    # recompute in the backward each group's forward (`full`), all of it
    # but the matmuls' outputs (`dots`), or none of it (`none`)
    remat: str = "full"          # 'none' | 'full' | 'dots'
    attn_chunk: int = 2048       # blockwise attention above this length
    attn_q_block: int = 2048     # blockwise attention q block
    attn_k_block: int = 2048     # blockwise attention kv block
    ssm_chunk: int = 128         # mamba / rwkv chunk length (sequence blocking)
    ssm_dtype: str = "float32"   # mamba state-expansion dtype
    # per-data-shard top-k routing in a sharded step (no global token
    # gather; capacity split per shard): `models.moe._moe_spmd`
    moe_local_dispatch: bool = False
    # batch-shard attention over (data x model) where the heads do not
    # divide the model axis (`models.attention`'s activation hints)
    attn_batch_shard: bool = False
    shard_head_dim: bool = False  # head_dim sharding where heads < model
    subquadratic: bool = False
    # route attention forwards through the hand-written flash-attention
    # kernel (repro_torch.kernels.attention); the name follows the JAX
    # config, where it selects the Pallas kernel. Forward only: where a
    # backward runs through a forward (`kernels.kernel_route`), it keeps
    # the plain path, so a train step takes the kernels only on a frozen
    # prefix behind a frozen embedding. The JAX ViT/BERT route there; the
    # port's decoder LMs route their prefill and feature forwards there
    # too, where the JAX LM always takes `_attend_dense` /
    # `_attend_blockwise`. In the rwkv6 time-mix it routes the WKV
    # recurrence through the hand-written WKV6 kernel
    # (repro_torch.kernels.rwkv), where the JAX model always takes its
    # chunked closed form.
    use_pallas: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ----- derived -----
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_lm(self) -> bool:
        return self.family in ("dense", "moe", "hybrid", "ssm", "vlm", "audio")

    def layer_kind(self, i: int) -> str:
        """Kind of block at layer index i: 'attn' | 'mamba' | 'rwkv'."""
        if self.family == "ssm":
            return "rwkv"
        if self.attn_period:
            # jamba: one attention layer per attn_period, at attn_period // 2
            return "attn" if (i % self.attn_period) == self.attn_period // 2 \
                else "mamba"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if not self.num_experts:
            return False
        return (i % self.moe_period) == (self.moe_period - 1)

    def layer_window(self, i: int) -> int:
        """Sliding window size for layer i (0 = global)."""
        if self.local_global_period and self.sliding_window:
            return self.sliding_window if i % self.local_global_period == 0 \
                else 0
        return self.sliding_window

    def param_count(self) -> int:
        """Analytic parameter count (6ND model FLOPs, memory napkin math);
        -1 for the paper models, whose count comes from their params."""
        if self.family in ("cnn", "vit", "encoder"):
            return -1
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        total = V * d * (1 if self.tie_embeddings else 2)
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    total += self.q_dim + 2 * self.kv_dim
            elif kind == "mamba":
                di = self.mamba_expand * d
                total += d * 2 * di + di * (2 * self.mamba_state + 1) \
                    + self.mamba_conv * di + di * d + di
            elif kind == "rwkv":
                total += 4 * d * d + d * d  # r, k, v, g, o
                total += 2 * d * d // 8     # the decay's low rank (approx.)
            if self.layer_is_moe(i):
                total += self.num_experts * 3 * d * self.expert_ff \
                    + d * self.num_experts
            else:
                total += 3 * d * ff if self.act in ("silu", "gelu") \
                    else 2 * d * ff
            total += 2 * d  # norms
        return total

    def active_param_count(self) -> int:
        """Params a token uses (MoE: its top-k experts only)."""
        total = self.param_count()
        if not self.num_experts:
            return total
        for i in range(self.num_layers):
            if self.layer_is_moe(i):
                total -= (self.num_experts - self.experts_per_token) \
                    * 3 * self.d_model * self.expert_ff
        return total

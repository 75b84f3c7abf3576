"""qwen3-moe-30b-a3b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

48L d_model=2048 32H (GQA kv=4) d_ff=768 (expert hidden) vocab=151936,
MoE 128e top-8 on every layer; head_dim=128.

The same values as `repro.configs.qwen3_moe_30b_a3b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    moe_d_ff=768,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    moe_period=1,
    rope_theta=1_000_000.0,
    act="silu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-moe-30b-a3b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96, moe_d_ff=96,
        vocab_size=256, num_experts=8, experts_per_token=2, remat="none",
    )

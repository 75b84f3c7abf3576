"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE.
[arXiv:2403.19887; hf]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Block structure: one attention layer per 8 (attn_period=8, at offset 4),
MoE every other layer (moe_period=2). SSM layers are Mamba-1 selective SSM
(diagonal A, associative-scan). Sub-quadratic overall => long_500k runs.

The same values as `repro.configs.jamba_1_5_large_398b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_period=2,
    moe_d_ff=24576,
    attn_period=8,
    mamba_state=16,
    mamba_conv=4,
    mamba_expand=2,
    act="silu",
    subquadratic=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="jamba-1.5-large-398b-reduced", num_layers=8, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, moe_d_ff=128,
        vocab_size=256, num_experts=4, experts_per_token=2, mamba_state=4,
        remat="none",
    )

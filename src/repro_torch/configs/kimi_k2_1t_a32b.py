"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table config).
[arXiv:2501.kimi2; unverified]

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (expert hidden) vocab=163840,
MoE 384e top-8. Unverified tier: we follow the assigned table verbatim
(GQA attention, no MLA, no shared expert). At ~1T params (2 TB in bf16)
it fits no single card; the dry run (`launch/dryrun.py`) reports its
bytes per rank on the production meshes.

The same values as `repro.configs.kimi_k2_1t_a32b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    moe_d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    moe_period=1,
    act="silu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="kimi-k2-1t-a32b-reduced", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=96, moe_d_ff=96, vocab_size=256,
        num_experts=8, experts_per_token=2, remat="none",
    )

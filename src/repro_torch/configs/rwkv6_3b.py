"""rwkv6-3b [ssm] — Finch: data-dependent decay linear attention.
[arXiv:2404.05892; hf] The same values as `repro.configs.rwkv6_3b`.

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536; head size 64
(40 heads). Recurrent state is O(1) in sequence length.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,          # d_model / rwkv_head_size
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_size=64,
    act="silu",
    subquadratic=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="rwkv6-3b-reduced", num_layers=3, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, rwkv_head_size=16, d_ff=128,
        vocab_size=256, remat="none",
    )

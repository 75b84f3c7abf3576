"""qwen1.5-32b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B family; hf]

64L d_model=5120 40H (GQA kv=40, i.e. MHA) d_ff=27392 vocab=152064.

The same values as `repro.configs.qwen1_5_32b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    act="silu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen1.5-32b-reduced", num_layers=3, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, remat="none",
    )

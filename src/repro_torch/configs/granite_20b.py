"""granite-20b [dense] — llama-arch code model with MQA (kv=1).
[arXiv:2405.04324; hf]

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
MQA: the single KV head is replicated across tensor-parallel shards
(sharding rule falls back head_dim-sharding for the KV cache).

The same values as `repro.configs.granite_20b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="granite-20b-reduced", num_layers=3, d_model=64, num_heads=4,
        num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256, remat="none",
    )

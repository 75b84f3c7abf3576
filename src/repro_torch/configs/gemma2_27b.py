"""gemma2-27b [dense] — local+global alternating, logit softcap.
[arXiv:2408.00118; hf]

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; head_dim=128
(official gemma2 config keeps H*hd independent of d_model).

The same values as `repro.configs.gemma2_27b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    sliding_window=4096,
    local_global_period=2,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    post_norms=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gemma2-27b-reduced", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        sliding_window=32, remat="none",
    )

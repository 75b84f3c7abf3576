"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000; head_dim=256;
sliding window 4096 on even layers; attn softcap 50, final softcap 30;
GeGLU; tied embeddings.

The same values as `repro.configs.gemma2_2b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
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
        name="gemma2-2b-reduced", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        sliding_window=32, remat="none",
    )

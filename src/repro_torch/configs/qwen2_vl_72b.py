"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
The vision encoder is a STUB: ``input_specs()`` supplies precomputed patch
embeddings (1280-dim, ViT-style) that are projected and prepended to the
token sequence. M-RoPE uses (t, h, w) = (16, 24, 24) sections of head_dim/2.

The same values as `repro.configs.qwen2_vl_72b`. The port's stub takes
the same `frontend_embeds` [B, frontend_tokens, frontend_dim]
(`runtime/serve.py` passes zeros, as the JAX engine does).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    frontend="vision_stub",
    frontend_dim=1280,
    frontend_tokens=256,
    act="silu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-vl-72b-reduced", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        mrope_sections=(2, 3, 3), frontend_dim=48, frontend_tokens=8,
        remat="none",
    )

"""musicgen-medium [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048. The EnCodec
audio frontend is a STUB: ``input_specs()`` supplies the token ids of the
flattened codebook stream plus optional conditioning frame embeddings.

The same values as `repro.configs.musicgen_medium`. The port's stub
takes the same `frontend_embeds` [B, frontend_tokens, frontend_dim]
(`runtime/serve.py` passes zeros, as the JAX engine does).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    frontend="audio_stub",
    frontend_dim=768,
    frontend_tokens=64,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="musicgen-medium-reduced", num_layers=3, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        frontend_dim=48, frontend_tokens=8, remat="none",
    )

"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision;
unverified].

The vision frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings (batch, n_image_tokens, d_model).  A cross-attention layer follows
every 4 self-attention layers (20 cross layers in the 100-layer stack).
"""
from .base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    rope_theta=500_000.0,
    vision=VisionConfig(n_image_tokens=1600, cross_attn_every=5),
    pim_bits=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, param_dtype="float32",
        vision=VisionConfig(n_image_tokens=16, cross_attn_every=5),
    )

"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256. Small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
    pim_bits=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab=256, param_dtype="float32",
    )

"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152. GQA + RoPE [arXiv:2402.19173; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab=49152,
    rope_theta=1_000_000.0,
    pim_bits=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=72, n_heads=6, n_kv_heads=2, head_dim=12,
        d_ff=144, vocab=256, param_dtype="float32",
    )

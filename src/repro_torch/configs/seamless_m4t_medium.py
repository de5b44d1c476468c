"""seamless-m4t-medium [audio]: enc-dec, 12L enc + 12L dec, d_model=1024
16H d_ff=4096 vocab=256206 [arXiv:2308.11596; hf].

The audio/modality frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings (batch, n_frames, d_model) feeding the text/unit encoder
backbone, per the assignment sheet.
"""
from .base import AudioConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium",
    family="encdec",
    n_layers=12,       # encoder layers
    dec_layers=12,     # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    audio=AudioConfig(n_frames=1024),
    pim_bits=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, dec_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256, param_dtype="float32",
        audio=AudioConfig(n_frames=32),
    )

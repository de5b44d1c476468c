"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — Mamba1 architecture [arXiv:2410.05355; unverified].

Attention-free: each request's decode state is a fixed size, whatever its
length."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=65024,
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2, version=1, chunk=256),
    pim_bits=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, vocab=256, param_dtype="float32",
        ssm=SSMConfig(state_dim=4, conv_dim=4, expand=2, version=1, chunk=16),
    )

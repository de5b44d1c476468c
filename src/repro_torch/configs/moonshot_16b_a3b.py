"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) d_ff(expert)=1408
vocab=163840, MoE 64e top-6 + 2 shared (kimi/moonlight)
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=11264,  # dense first layer (moonlight style)
    vocab=163840,
    n_dense_layers=1,
    rope_theta=50_000.0,
    moe=MoEConfig(n_experts=64, n_shared=2, top_k=6, d_ff_expert=1408),
    pim_bits=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, n_dense_layers=1, param_dtype="float32",
        moe=MoEConfig(n_experts=8, n_shared=1, top_k=2, d_ff_expert=32),
    )

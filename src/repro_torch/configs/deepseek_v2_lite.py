"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MLA kv_lora=512, MoE 64 routed top-6 + 2 shared
[arXiv:2405.04434; hf].

64 routed experts (+2 shared), consistent with the 16B total-parameter
budget at d_ff_expert=1408.  Layer 0 is a dense-MLP layer (d_ff=10944), the
rest are MoE, per the HF config.
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # the single dense layer
    vocab=102400,
    n_dense_layers=1,
    moe=MoEConfig(n_experts=64, n_shared=2, top_k=6, d_ff_expert=1408),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    pim_bits=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, n_dense_layers=1, param_dtype="float32",
        moe=MoEConfig(n_experts=8, n_shared=1, top_k=2, d_ff_expert=32),
        mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    )

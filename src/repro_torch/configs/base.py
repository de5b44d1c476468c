"""Model configuration (the port's copy of ``repro.configs.base.ModelConfig``).

Only the fields the port's dense paths read are carried over; their names
and defaults match the JAX package's, so a test can build both configs from
the same keyword arguments.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # the port runs "dense" only
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # PIM-mode (the paper's technique): weight bits for serving; 0 = off.
    pim_bits: int = 0
    param_dtype: str = "bfloat16"
    kv_cache_bits: int = 16  # 16 = param dtype; 8 = int8 cache + f32 scales

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

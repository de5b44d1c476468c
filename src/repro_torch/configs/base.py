"""Model configuration (the port's copy of ``repro.configs.base.ModelConfig``).

Only the fields the port's paths read are carried over; their names and
defaults match the JAX package's, so a test can build both configs from the
same keyword arguments.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    n_shared: int = 2
    top_k: int = 6
    d_ff_expert: int = 1408
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2
    group_tokens: int = 4096  # dispatch-group size (perf knob)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> d_model // 16 (mamba1 only)
    head_dim: int = 64  # mamba2 only
    chunk: int = 256
    version: int = 1  # 1 = Mamba1 selective scan, 2 = Mamba2 SSD


@dataclass(frozen=True)
class VisionConfig:
    """Modality frontend STUB: input_specs provides precomputed embeddings."""

    n_image_tokens: int = 1600
    cross_attn_every: int = 5  # a cross-attn layer after every N self layers


@dataclass(frozen=True)
class AudioConfig:
    """Audio frontend STUB: precomputed frame embeddings feed the encoder."""

    n_frames: int = 1024


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # the port runs "dense", "moe" (GQA or MLA attention), "ssm", "vlm", "encdec"
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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    vision: Optional[VisionConfig] = None
    audio: Optional[AudioConfig] = None
    dec_layers: int = 0  # encdec only
    n_dense_layers: int = 0  # leading non-MoE layers (moe only)
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

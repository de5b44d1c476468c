"""The dense decoder block (twin of the dense parts of ``repro.models.blocks``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

from .attention import attn_decode, attn_init, attn_prefill
from .common import mlp_apply, mlp_init, rmsnorm


def dense_block_init(gen, cfg: ModelConfig, dtype, device, lead=()) -> dict:
    """A block's parameters; ``lead`` prepends stack dims to every leaf."""
    return {
        "ln1": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
        "attn": attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, dtype, device, bias=cfg.qkv_bias, lead=lead),
        "ln2": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device, lead=lead),
    }


def _attn_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta)


def dense_block_prefill(p, x, cache, cfg: ModelConfig):
    """Single-pass prefill: full-seq attention that also fills the KV cache."""
    h, cache = attn_prefill(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cache,
                            **_attn_kw(cfg))
    x = x + h
    return x + mlp_apply(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps)), cache


def dense_block_decode(p, x, cache, pos: int, cfg: ModelConfig):
    h, cache = attn_decode(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cache,
                           pos, **_attn_kw(cfg))
    x = x + h
    return x + mlp_apply(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps)), cache

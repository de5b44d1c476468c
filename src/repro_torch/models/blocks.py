"""The dense decoder block (twin of the dense parts of ``repro.models.blocks``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

from .attention import attn_decode, attn_decode_paged, attn_init, attn_prefill
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


def dense_block_prefill(p, x, cache, cfg: ModelConfig, pages=None):
    """Single-pass prefill: full-seq attention that also fills the KV cache
    (dense, or a paged pool's pages when ``pages`` is given)."""
    h, cache = attn_prefill(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cache,
                            pages=pages, **_attn_kw(cfg))
    x = x + h
    return x + mlp_apply(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps)), cache


def dense_block_decode(p, x, cache, pos: torch.Tensor, cfg: ModelConfig,
                       block_tables=None, page_size=None):
    """One decode step: at the 0-d ``pos`` into a dense cache, or, with
    ``block_tables``, at per-slot positions (B,) into a paged pool."""
    xn = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if block_tables is None:
        h, cache = attn_decode(p["attn"], xn, cache, pos, **_attn_kw(cfg))
    else:
        h, cache = attn_decode_paged(p["attn"], xn, cache, block_tables, pos,
                                     page_size=page_size, **_attn_kw(cfg))
    x = x + h
    return x + mlp_apply(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps)), cache

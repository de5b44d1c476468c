"""Model assembly for the dense family (twin of the dense branches of
``repro.models.lm``).

Parameters keep the JAX package's layout: the layers are ONE stacked tree
with a leading ``L`` dim, and a Python loop over it takes the place of
``lax.scan``.  Slicing a layer out of the stack is a view, so the loop copies
no weights; the cache is written in place (see ``models.attention``).

Public API:
  init_params(cfg, gen, device)            -> params dict
  init_cache(cfg, batch, max_seq, device)  -> cache dict
  prefill(params, cfg, tokens, cache)      -> (logits (B, S, V), cache)
  decode_step(params, cfg, tokens, cache, pos) -> (logits (B, 1, V), cache)
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig

from . import blocks as bk
from .attention import kv_cache_init
from .common import dense_init, dtype_of, embed_lookup, resolve_device, rmsnorm, unembed


def _check_family(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port runs the dense "
            "family (ROADMAP.md lists the others)")


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random parameters drawn from ``gen``, which must live on ``device``
    (None: the card)."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    p: dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dtype, device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.vocab, cfg.d_model), dtype, device).T
    p["layers"] = bk.dense_block_init(gen, cfg, dtype, device, lead=(cfg.n_layers,))
    return p


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> dict:
    _check_family(cfg)
    return {"layers": kv_cache_init(
        batch, max_seq, cfg.n_kv_heads, cfg.head_dim, dtype_of(cfg.param_dtype),
        resolve_device(device), bits=cfg.kv_cache_bits, lead=(cfg.n_layers,))}


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict):
    """Single-pass prefill over the whole prompt (B, S) that fills the decode
    cache for positions 0..S-1.  ``cache`` must be fresh from ``init_cache``.
    Returns (logits (B, S, V), cache)."""
    _check_family(cfg)
    x = embed_lookup(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x, _ = bk.dense_block_prefill(_layer(params["layers"], i), x,
                                      _layer(cache["layers"], i), cfg)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(x, params.get("head", params["embed"])), cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                pos: int):
    """One decode step of tokens (B, 1) at position ``pos``, shared by the
    batch.  Returns (logits (B, 1, V), cache)."""
    _check_family(cfg)
    x = embed_lookup(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x, _ = bk.dense_block_decode(_layer(params["layers"], i), x,
                                     _layer(cache["layers"], i), pos, cfg)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(x, params.get("head", params["embed"])), cache

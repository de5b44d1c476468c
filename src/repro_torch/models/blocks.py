"""The dense decoder block, the MoE block, the SSM block and the gated
cross-attention block (twins of the dense, MoE, SSM and cross parts of
``repro.models.blocks``).

A MoE block is a dense block whose MLP is ``moe_apply``'s experts: it has
a ``moe`` leaf where a dense block has ``mlp``, and the dense block's
cached functions (``dense_block_prefill``, ``dense_block_decode`` with a
dense or a paged cache, ``dense_block_verify``) run either, through
``_ffn``.  Its attention is GQA or, under ``cfg.mla``, MLA
(``models.mla``); the cached functions take ``latent=True`` for an MLA
block, whose cache stack is a latent one (``models.lm.stack_layout``
decides), so an MLA config's leading dense blocks stay GQA, as in the JAX
package.  So the JAX
package's ``moe_block_prefill``, ``moe_block_decode``,
``moe_block_decode_paged`` and ``moe_block_verify`` are the dense
block's.

An SSM block is a Mamba1 layer (``models.mamba``) behind a norm, with a
per-row state of its own (``ssm_cache_init``): a stack of them is a "state"
stack (``models.lm.stack_layout``), with no sequence axis and no pages.
Its prefill writes the state in place (with ``slot``, into one row of the
continuous engine's per-slot state), its decode advances it in place, and
its verify window returns every step's state for the commit."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

from . import mamba as mb
from .attention import (attn_apply, attn_decode, attn_decode_paged, attn_init, attn_prefill,
                        attn_verify)
from .common import mlp_apply, mlp_init, rmsnorm
from .mla import mla_apply, mla_decode, mla_decode_paged, mla_init, mla_prefill, mla_verify
from .moe import moe_apply, moe_init


def _ffn(p, x, cfg: ModelConfig):
    """The block's feed-forward over the normed x: a dense block's SwiGLU
    MLP, or a MoE block's routed and shared experts (their aux losses
    dropped, as the JAX package's cached MoE blocks drop them)."""
    if "moe" in p:
        return moe_apply(p["moe"], x, cfg.moe)[0]
    return mlp_apply(p["mlp"], x)


def dense_block_init(gen, cfg: ModelConfig, dtype, device, lead=()) -> dict:
    """A block's parameters; ``lead`` prepends stack dims to every leaf."""
    return {
        "ln1": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
        "attn": attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, dtype, device, bias=cfg.qkv_bias, lead=lead),
        "ln2": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device, lead=lead),
    }


def attn_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta)


def mla_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, m=cfg.mla, rope_theta=cfg.rope_theta)


def dense_block_apply(p, x, cfg: ModelConfig, causal: bool = True):
    """The block over a whole sequence with no cache (the encoder's layers
    run it with ``causal=False``)."""
    h = attn_apply(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), causal=causal,
                   **attn_kw(cfg))
    x = x + h
    return x + mlp_apply(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))


def self_attn_prefill(p, xn, cache, cfg: ModelConfig, pages=None, latent=False):
    """The prompt's self-attention of the normed xn (B, S, D), filling the
    cache (dense, or a paged pool's ``pages``): GQA's K/V or, ``latent``,
    MLA's latents."""
    if latent:
        return mla_prefill(p, xn, cache, pages=pages, **mla_kw(cfg))
    return attn_prefill(p, xn, cache, pages=pages, **attn_kw(cfg))


def self_attn_decode(p, xn, cache, pos: torch.Tensor, cfg: ModelConfig, block_tables=None,
                     page_size=None, latent=False):
    """One decode step's self-attention of the normed xn (B, 1, D): at the
    0-d ``pos`` into a dense cache, or, with ``block_tables``, at per-slot
    positions (B,) into a paged pool; MLA's absorbed form where ``latent``."""
    if latent:
        if block_tables is None:
            return mla_decode(p, xn, cache, pos, **mla_kw(cfg))
        return mla_decode_paged(p, xn, cache, block_tables, pos, page_size=page_size,
                                **mla_kw(cfg))
    if block_tables is None:
        return attn_decode(p, xn, cache, pos, **attn_kw(cfg))
    return attn_decode_paged(p, xn, cache, block_tables, pos, page_size=page_size,
                             **attn_kw(cfg))


def self_attn_verify(p, xn, cache, pos: torch.Tensor, cfg: ModelConfig, block_tables=None,
                     page_size=None, tree=None, latent=False):
    """A verify window's self-attention of the normed xn (B, T, D) at per-row
    positions ``pos`` (B,) (``attention.attn_verify``, or ``mla.mla_verify``
    where ``latent``)."""
    kw = dict(block_tables=block_tables, page_size=page_size, tree=tree)
    if latent:
        return mla_verify(p, xn, cache, pos, **kw, **mla_kw(cfg))
    return attn_verify(p, xn, cache, pos, **kw, **attn_kw(cfg))


def dense_block_prefill(p, x, cache, cfg: ModelConfig, pages=None, latent=False):
    """Single-pass prefill: full-seq attention that also fills the cache
    (dense, or a paged pool's pages when ``pages`` is given; MLA's latents
    where ``latent``)."""
    h, cache = self_attn_prefill(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cache, cfg,
                                 pages, latent)
    x = x + h
    return x + _ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg), cache


def dense_block_decode(p, x, cache, pos: torch.Tensor, cfg: ModelConfig,
                       block_tables=None, page_size=None, latent=False):
    """One decode step: at the 0-d ``pos`` into a dense cache, or, with
    ``block_tables``, at per-slot positions (B,) into a paged pool."""
    h, cache = self_attn_decode(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cache, pos,
                                cfg, block_tables, page_size, latent)
    x = x + h
    return x + _ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg), cache


def dense_block_verify(p, x, cache, block_tables, pos: torch.Tensor, cfg: ModelConfig,
                       page_size=None, tree=None, latent=False):
    """A window of T tokens x (B, T, D) at per-row positions ``pos`` (B,): a
    dense cache when ``block_tables`` is None, the paged pool otherwise;
    ``tree=(fan, depth)`` verifies a candidate tree.  A MoE block's experts
    act per position, so nothing in them needs rolling back."""
    h, cache = self_attn_verify(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cache, pos,
                                cfg, block_tables, page_size, tree, latent)
    x = x + h
    return x + _ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg), cache


# -------------------------------------------------------------- MoE block ---
def moe_block_init(gen, cfg: ModelConfig, dtype, device, lead=()) -> dict:
    """A MoE block's parameters, its attention MLA's under ``cfg.mla`` and
    GQA's otherwise; ``lead`` prepends stack dims."""
    attn = (mla_init(gen, cfg.d_model, cfg.n_heads, cfg.mla, dtype, device, lead=lead)
            if cfg.mla else
            attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dtype,
                      device, bias=cfg.qkv_bias, lead=lead))
    return {
        "ln1": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
        "attn": attn,
        "ln2": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
        "moe": moe_init(gen, cfg.d_model, cfg.moe, dtype, device, lead=lead),
    }


def moe_block_apply(p, x, cfg: ModelConfig):
    """The block over a whole causal sequence with no cache: (x, aux)."""
    xn = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + (mla_apply(p["attn"], xn, **mla_kw(cfg)) if cfg.mla
             else attn_apply(p["attn"], xn, **attn_kw(cfg)))
    y, aux = moe_apply(p["moe"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.moe)
    return x + y, aux


# -------------------------------------------------------------- SSM block ---
def _mamba(cfg: ModelConfig):
    """The SSM layer's version: the port runs Mamba1; Mamba2 comes with the
    hybrid family."""
    if cfg.ssm.version != 1:
        raise NotImplementedError(f"Mamba{cfg.ssm.version} is not ported yet; the port "
                                  "runs Mamba1 (ROADMAP.md lists the hybrid family)")
    return cfg.ssm


def ssm_block_init(gen, cfg: ModelConfig, dtype, device, lead=()) -> dict:
    """An SSM block's parameters; ``lead`` prepends stack dims."""
    return {"ln": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
            "ssm": mb.mamba1_init(gen, cfg.d_model, _mamba(cfg), dtype, device, lead=lead)}


def ssm_cache_init(cfg: ModelConfig, batch: int, device, lead=()) -> dict:
    """An SSM block's zero state of ``batch`` rows (or slots)."""
    return mb.mamba1_cache_init(batch, cfg.ssm.expand * cfg.d_model, _mamba(cfg), device,
                                lead=lead)


def ssm_block_apply(p, x, cfg: ModelConfig):
    """The block over a whole sequence from a zero state, with no cache."""
    return x + mb.mamba1_apply(p["ssm"], rmsnorm(x, p["ln"], cfg.norm_eps), _mamba(cfg))


def ssm_block_prefill(p, x, cache, cfg: ModelConfig, length=None, slot=None):
    """The prompt x (B, S, D) from the state ``cache``, whose rows the final
    state overwrites in place; ``length`` masks right padding
    (``mamba.mamba1_prefill``).  With ``slot`` (a 0-d integer tensor or an
    int), ``cache`` is the continuous engine's per-slot state: the batch-1
    prompt runs from a zero state, which lands in row ``slot`` (a device
    index, ``index_copy_``), and no other row changes."""
    xin = rmsnorm(x, p["ln"], cfg.norm_eps)
    start = cache if slot is None else {k: torch.zeros_like(v[:1]) for k, v in cache.items()}
    y, new = mb.mamba1_prefill(p["ssm"], xin, start, _mamba(cfg), length=length)
    for k, leaf in cache.items():
        if slot is None:
            leaf.copy_(new[k])
        else:
            at = torch.as_tensor(slot, device=leaf.device).to(torch.int64).reshape(1)
            leaf.index_copy_(0, at, new[k].to(leaf.dtype))
    return x + y, cache


def ssm_block_decode(p, x, cache, cfg: ModelConfig):
    """One token x (B, 1, D), the state advanced in place."""
    y, cache = mb.mamba1_decode(p["ssm"], rmsnorm(x, p["ln"], cfg.norm_eps), cache,
                                _mamba(cfg))
    return x + y, cache


def ssm_block_verify(p, x, cache, cfg: ModelConfig):
    """A window x (B, T, D) from the state ``cache``, left as it is: returns
    (x', every step's state, leaves (B, T, ...), step j after token j)."""
    y, steps = mb.mamba1_verify(p["ssm"], rmsnorm(x, p["ln"], cfg.norm_eps), cache,
                                _mamba(cfg))
    return x + y, steps


# ------------------------------------------------------------ cross block ---
def cross_block_init(gen, cfg: ModelConfig, dtype, device, lead=()) -> dict:
    """Gated cross-attention block (llama-vision style).  Both gates start
    at zero, as in the JAX package, so a fresh block passes x through."""
    return {
        "ln1": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
        "xattn": attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           dtype, device, lead=lead),
        "gate_attn": torch.zeros(lead, dtype=dtype, device=device),
        "ln2": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device, lead=lead),
        "gate_mlp": torch.zeros(lead, dtype=dtype, device=device),
    }


def cross_block_apply(p, x, kv, cfg: ModelConfig):
    """x (B, S, D) attends, without rope or a mask, to ``kv`` (B, Sk, D),
    then an MLP; each branch scaled by ``tanh`` of its 0-d gate, taken in
    the parameter dtype as JAX computes it."""
    h = attn_apply(p["xattn"], rmsnorm(x, p["ln1"], cfg.norm_eps), n_heads=cfg.n_heads,
                   n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim, rope_theta=0.0, causal=False,
                   kv_input=kv)
    x = x + torch.tanh(p["gate_attn"]) * h
    h = mlp_apply(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x + torch.tanh(p["gate_mlp"]) * h

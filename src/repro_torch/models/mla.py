"""Multi-head Latent Attention of DeepSeek-V2 (twin of ``repro.models.mla``).

The cache keeps only each token's latent ``c`` (kv_lora_rank) and its
roped key part ``kr`` (qk_rope_dim): a dense cache is ``(B, S, C)`` /
``(B, S, R)``, a paged pool ``(P, page_size, C)`` / ``(P, page_size, R)``
with page 0 the trash page, as the GQA pool's (``models.attention``).
Prefill expands the latent into per-head K/V and materialises its scores,
as the JAX package does (no ``flash_attention``: q and k are qk_nope +
qk_rope wide, v is v_head_dim).  Decode and verify windows use the
*absorbed* form: W_uk folds into the query and W_uv into the output, the
scores and ``o_lat`` in f32.  The absorbed and expanded forms are the same
function in exact arithmetic; in bf16 they differ by about 1e-3.

As in ``models.attention``, every cache is written IN PLACE (the JAX
package returns new ones), positions are int64 tensors read only by device
ops, so a CUDA graph of a step or window replays at any position.  ``wq``,
``w_dkv`` and ``wo`` go through ``common.linear`` (``pim_matvec`` for
decode-shaped calls); ``w_uk`` (H, C, nope) and ``w_uv`` (H, C, v) are 3-D
leaves, quantized over their C axis, used through ``dq`` and an einsum.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import MLAConfig

from .attention import tree_tensors, tree_valid, write_window
from .common import apply_rope, dense_init, dq, linear


def mla_init(gen, d: int, n_heads: int, m: MLAConfig, dtype, device, lead=()) -> dict:
    qh = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq": dense_init(gen, lead + (d, n_heads * qh), dtype, device),
        "w_dkv": dense_init(gen, lead + (d, m.kv_lora_rank + m.qk_rope_dim), dtype, device),
        "w_uk": dense_init(gen, lead + (n_heads, m.kv_lora_rank, m.qk_nope_dim), dtype, device),
        "w_uv": dense_init(gen, lead + (n_heads, m.kv_lora_rank, m.v_head_dim), dtype, device),
        "wo": dense_init(gen, lead + (n_heads * m.v_head_dim, d), dtype, device),
    }


def mla_cache_init(batch: int, max_seq: int, m: MLAConfig, dtype, device, lead=()) -> dict:
    """The latent cache: (kv_lora_rank + qk_rope_dim) values per token, in
    the parameter dtype (the JAX package gives it no int8 form).  With pages
    for rows and a page's tokens for positions it is the paged pool (the
    JAX package's ``mla_paged_cache_init``), as ``kv_cache_init`` is for
    K/V."""
    return {"c": torch.zeros(lead + (batch, max_seq, m.kv_lora_rank), dtype=dtype, device=device),
            "kr": torch.zeros(lead + (batch, max_seq, m.qk_rope_dim), dtype=dtype, device=device)}


def mla_paged_insert(pool: dict, dense: dict, pages: torch.Tensor, lead: int = 0) -> dict:
    """Scatter a batch-1 dense latent cache into pool pages ``pages`` (n,)
    int64, in place; ``lead`` counts the stack dims both trees share."""
    n, ps = pages.shape[0], pool["c"].shape[lead + 1]
    for name, leaf in pool.items():
        d = dense[name].select(lead, 0)  # lead + (n*ps, C)
        leaf.index_copy_(lead, pages, d.reshape(d.shape[:lead] + (n, ps, d.shape[-1]))
                         .to(leaf.dtype))
    return pool


def _split_q(p, x, n_heads: int, m: MLAConfig):
    q = linear(x, p["wq"]).reshape(x.shape[:2] + (n_heads, m.qk_nope_dim + m.qk_rope_dim))
    return q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]


def _latents(p, x, m: MLAConfig, positions, rope_theta: float):
    """The new tokens' latents (B, T, C) and roped key parts (B, T, R)."""
    ckv = linear(x, p["w_dkv"])
    c, kr = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    return c, apply_rope(kr[:, :, None, :], positions, rope_theta)[:, :, 0, :]


def _scale(m: MLAConfig) -> float:
    return 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)


def mla_prefill(p: dict, x: torch.Tensor, cache: dict, *, n_heads: int, m: MLAConfig,
                rope_theta: float, pages: Optional[torch.Tensor] = None):
    """Full-sequence causal MLA over x (B, S, D) that also writes every
    prompt position's ``c`` and rope-applied ``kr`` into the cache (in
    place), the storage the absorbed decode reads back.  The latent expands
    into per-head K/V; the (B, H, S, S) scores are contracted in the operand
    dtype and softmaxed in f32.

    With ``pages`` (n,) int64 the cache is a paged pool and x is batch-1
    with ``S == n * page_size``: the latents go straight into those pages."""
    b, s, _ = x.shape
    q_nope, q_rope = _split_q(p, x, n_heads, m)
    positions = torch.arange(s, device=x.device)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    c, kr = _latents(p, x, m, positions, rope_theta)
    for name, new in (("c", c), ("kr", kr)):
        leaf = cache[name]
        if pages is None:
            leaf[:, :s] = new
        else:
            leaf.index_copy_(0, pages, new[0].reshape(pages.shape[0], leaf.shape[1], -1)
                             .to(leaf.dtype))
    k_nope = torch.einsum("bsc,hcd->bshd", c, dq(p["w_uk"], c.dtype))
    v = torch.einsum("bsc,hcd->bshd", c, dq(p["w_uv"], c.dtype))
    k = torch.cat([k_nope, kr[:, :, None, :].expand(b, s, n_heads, m.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * _scale(m)
    causal = positions[:, None] >= positions[None, :]
    w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, -1)
    return linear(o, p["wo"]), cache


def mla_apply(p: dict, x: torch.Tensor, *, n_heads: int, m: MLAConfig,
              rope_theta: float) -> torch.Tensor:
    """The full-sequence forward with no cache: ``mla_prefill`` into a
    throwaway one, as the JAX package delegates, so the two cannot drift."""
    b, s, _ = x.shape
    cache = mla_cache_init(b, s, m, x.dtype, x.device)
    return mla_prefill(p, x, cache, n_heads=n_heads, m=m, rope_theta=rope_theta)[0]


def _absorbed(p, x, cc, ckr, q_lat, q_rope, valid, m: MLAConfig):
    """The absorbed attention of queries (B, T, H, C | R) over the latent
    store ``cc`` (B, S, C), ``ckr`` (B, S, R), keys where ``valid`` (B, 1 |
    T, S) broadcasts True: scores and ``o_lat`` in f32, W_uv folded into the
    output, then ``wo``."""
    b, t = x.shape[:2]
    cc32 = cc.to(torch.float32)
    scores = (torch.einsum("bqhc,bkc->bhqk", q_lat.to(torch.float32), cc32)
              + torch.einsum("bqhd,bkd->bhqk", q_rope.to(torch.float32),
                             ckr.to(torch.float32))) * _scale(m)
    w = torch.softmax(scores.masked_fill(~valid[:, None], float("-inf")), dim=-1)
    o_lat = torch.einsum("bhqk,bkc->bqhc", w, cc32)
    o = torch.einsum("bqhc,hcd->bqhd", o_lat, dq(p["w_uv"], torch.float32))
    return linear(o.reshape(b, t, -1).to(x.dtype), p["wo"])


def _window(p, x, cache, posr, write, read, valid, n_heads: int, m: MLAConfig,
            rope_theta: float):
    """The absorbed form both cache layouts and both window kinds share: q
    and the new latents of x (B, T, D) at rope positions ``posr`` (B, T),
    W_uk folded into q, the new ``c``/``kr`` handed to ``write(name, (B, T,
    ...))``, then attention over ``read(name)`` (B, S, ...) under ``valid``
    (B, T, S)."""
    q_nope, q_rope = _split_q(p, x, n_heads, m)
    q_rope = apply_rope(q_rope, posr, rope_theta)
    q_lat = torch.einsum("bqhd,hcd->bqhc", q_nope, dq(p["w_uk"], q_nope.dtype))
    c, kr = _latents(p, x, m, posr, rope_theta)
    write("c", c)
    write("kr", kr)
    return _absorbed(p, x, read("c"), read("kr"), q_lat, q_rope, valid, m), cache


def _paged_read(cache, block_tables):
    """``read(name)``: the slots' pages of a pool leaf in the dense layout
    (B, W*ps, ...), a transient."""
    b, w = block_tables.shape

    def read(name):
        g = cache[name][block_tables]  # (B, W, ps, ...)
        return g.reshape((b, w * g.shape[2]) + g.shape[3:])
    return read


def mla_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor, *, n_heads: int,
               m: MLAConfig, rope_theta: float):
    """One absorbed decode step of x (B, 1, D) at the 0-d int64 ``pos``
    into a dense latent cache (in place): keys past ``pos`` masked."""
    b = x.shape[0]
    slot = pos.reshape(1)

    def write(name, new):
        cache[name].index_copy_(1, slot, new.to(cache[name].dtype))
    s_len = cache["c"].shape[1]
    valid = (torch.arange(s_len, device=x.device) <= pos).expand(b, 1, s_len)
    return _window(p, x, cache, pos.reshape(1, 1).expand(b, 1), write, cache.__getitem__,
                   valid, n_heads, m, rope_theta)


def mla_decode_paged(p: dict, x: torch.Tensor, cache: dict, block_tables: torch.Tensor,
                     pos: torch.Tensor, *, n_heads: int, m: MLAConfig, rope_theta: float,
                     page_size: int):
    """One absorbed decode step of x (B, 1, D) against the paged latent pool
    at per-slot positions ``pos`` (B,) int64: the new rows go to page
    ``block_tables[b, pos[b] // page_size]`` at offset ``pos[b] %
    page_size`` (in place), then the slot's pages are gathered and keys past
    its position masked."""
    page = block_tables.gather(1, (pos // page_size)[:, None])[:, 0]
    off = pos % page_size

    def write(name, new):
        cache[name].index_put_((page, off), new[:, 0].to(cache[name].dtype))
    s_len = block_tables.shape[1] * page_size
    valid = (torch.arange(s_len, device=x.device) <= pos[:, None])[:, None]
    return _window(p, x, cache, pos[:, None], write, _paged_read(cache, block_tables),
                   valid, n_heads, m, rope_theta)


def mla_verify(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor, *, n_heads: int,
               m: MLAConfig, rope_theta: float, block_tables: Optional[torch.Tensor] = None,
               page_size: Optional[int] = None, tree: Optional[tuple] = None):
    """A window of T tokens x (B, T, D) per row at positions ``pos .. pos+T-1``
    (``pos`` (B,) int64) in the absorbed form, against a dense latent cache
    or, with ``block_tables`` (B, W) int64, the paged pool (in place): the
    window's latents are written first (a write past the store dropped on
    a dense cache, sent to the trash page on a paged one), then each query
    attends as ``mla_decode`` at its position does.

    ``tree=(fan, depth)`` makes the window a candidate tree in node order
    (``attention.tree_layout``): the write columns stay ``pos + node``, the
    rope positions become ``pos + dep[node]``, and each query attends to the
    cached prefix and its root path's columns (``attention.tree_valid``).
    Returns (out (B, T, D), cache)."""
    b, t, _ = x.shape
    pos = pos.reshape(b)
    posm = pos[:, None] + torch.arange(t, device=x.device)  # (B, T) write columns
    if tree is None:
        posr = posm
    else:
        dep, vis, _ = tree_tensors(*tree, x.device)
        posr = pos[:, None] + dep
    if block_tables is None:
        s_len = cache["c"].shape[1]

        def write(name, new):
            write_window(cache[name], new, pos, posm)
        read = cache.__getitem__
    else:
        w = block_tables.shape[1]
        s_len = w * page_size
        page = block_tables.gather(1, (posm // page_size).clamp(0, w - 1))
        page = torch.where(posm < s_len, page, 0)  # past the store: the trash page

        def write(name, new):
            cache[name].index_put_((page, posm % page_size), new.to(cache[name].dtype))
        read = _paged_read(cache, block_tables)
    if tree is None:
        valid = torch.arange(s_len, device=x.device) <= posm[..., None]  # (B, T, S)
    else:
        valid = tree_valid(vis, pos, s_len)
    return _window(p, x, cache, posr, write, read, valid, n_heads, m, rope_theta)

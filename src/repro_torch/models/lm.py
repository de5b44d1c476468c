"""Model assembly for the dense family (twin of the dense branches of
``repro.models.lm``).

Parameters keep the JAX package's layout: the layers are ONE stacked tree
with a leading ``L`` dim, and a Python loop over it takes the place of
``lax.scan``.  Slicing a layer out of the stack is a view, so the loop copies
no weights; the cache is written in place (see ``models.attention``).

Public API:
  init_params(cfg, gen, device)            -> params dict
  init_cache(cfg, batch, max_seq, device)  -> cache dict
  init_paged_cache(cfg, batch, max_seq, num_pages, page_size, device)
                                           -> paged cache dict
  prefill(params, cfg, tokens, cache[, length, pages, slot])
                                           -> (logits (B, S, V), cache)
  paged_insert(cfg, paged, dense, slot, pages) -> paged cache
  decode_step(params, cfg, tokens, cache, pos[, page_size])
                                           -> (logits (B, 1, V), cache)
  verify_step(params, cfg, tokens, cache, pos[, page_size, tree])
                                           -> (logits (B, T, V), cache)
  stack_verify_caches(cfg, caches)         -> cache
  commit_verify(cfg, cache, sel)           -> cache
  tree_relocate(cfg, cache, pos, a, cf, fan=, depth=) -> cache
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig

from . import blocks as bk
from .attention import kv_cache_init, paged_kv_insert
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


def init_paged_cache(cfg: ModelConfig, batch: int, max_seq: int, num_pages: int,
                     page_size: int, device=None) -> dict:
    """Paged decode cache: every layer's K/V in a pool of ``num_pages`` pages
    of ``page_size`` tokens shared by the ``batch`` slots, and
    ``block_tables`` (batch, ceil(max_seq / page_size)) int32 mapping each
    slot's logical page i to a pool page id.  ``decode_step`` takes the
    paged path whenever this key is present.  Page 0 is the trash page of
    inactive slots, so ``num_pages - 1`` pages circulate.  The pool is
    ``kv_cache_init``'s layout with pages for rows and a page's tokens for
    positions: (L, P, KV, page_size, D)."""
    _check_family(cfg)
    device = resolve_device(device)
    width = -(-max_seq // page_size)
    return {"block_tables": torch.zeros((batch, width), dtype=torch.int32, device=device),
            "layers": kv_cache_init(
                num_pages, page_size, cfg.n_kv_heads, cfg.head_dim,
                dtype_of(cfg.param_dtype), device, bits=cfg.kv_cache_bits,
                lead=(cfg.n_layers,))}


def paged_insert(cfg: ModelConfig, paged: dict, dense: dict, slot, pages) -> dict:
    """Scatter a freshly prefilled batch-1 dense cache into the paged cache's
    pool pages ``pages`` (n,), in place.  Not on the serving path (the admit
    prefills straight into the pages, ``prefill(pages=)``): the reference the
    direct admit is held against.  ``slot`` addresses per-slot state, which
    the dense family has none of."""
    _check_family(cfg)
    pages = torch.as_tensor(pages, dtype=torch.int64, device=paged["block_tables"].device)
    paged_kv_insert(paged["layers"], dense["layers"], pages, lead=1)
    return paged


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
            length=None, pages=None, slot=None):
    """Single-pass prefill over the whole prompt (B, S) that fills the decode
    cache for positions 0..S-1.  ``cache`` must be fresh from ``init_cache``.
    Returns (logits (B, S, V), cache).

    With ``pages`` (n,) ``cache`` is a paged tree (``init_paged_cache``) and
    ``tokens`` is batch-1 with ``S == n * page_size``: the prompt's K/V go
    straight into those pool pages (the continuous-batching admit).
    ``length`` (the true length of a right-padded prompt) and ``slot`` (the
    per-slot state row) matter to the families with sequential state only;
    the dense family's causal attention needs neither."""
    _check_family(cfg)
    if pages is not None:
        pages = torch.as_tensor(pages, dtype=torch.int64, device=tokens.device)
    x = embed_lookup(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x, _ = bk.dense_block_prefill(_layer(params["layers"], i), x,
                                      _layer(cache["layers"], i), cfg, pages=pages)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(x, params.get("head", params["embed"])), cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                pos, page_size: Optional[int] = None):
    """One decode step of tokens (B, 1).  With a dense cache (``init_cache``)
    ``pos`` is shared by the batch: an int or a 0-d integer tensor on the
    tokens' device (the JAX package takes an int32 scalar).  With a paged
    cache (``init_paged_cache``, told by its ``block_tables`` key) ``pos``
    is a (B,) integer tensor, one position per slot, and ``page_size``, if
    given, must be the pool's.  No value of the device is read on the host,
    so a CUDA graph of the step replays at the positions its tensors hold.
    Returns (logits (B, 1, V), cache)."""
    _check_family(cfg)
    bt, ps = cache.get("block_tables"), None
    if bt is None:
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), pos, dtype=torch.int64, device=tokens.device)
    else:
        ps = cache["layers"]["k"].shape[3]
        if page_size not in (None, ps):
            raise ValueError(f"page_size {page_size} is not the pool's {ps}")
        bt = bt.to(torch.int64)
    pos = pos.to(torch.int64)
    x = embed_lookup(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x, _ = bk.dense_block_decode(_layer(params["layers"], i), x,
                                     _layer(cache["layers"], i), pos, cfg, bt, ps)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(x, params.get("head", params["embed"])), cache


def verify_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict, pos,
                  page_size: Optional[int] = None, tree: Optional[tuple] = None) -> torch.Tensor:
    """``verify_step`` up to the final norm: the window's hidden states
    (B, T, D), the cache written in place.  A caller that needs the logits
    of a few positions only unembeds those."""
    _check_family(cfg)
    bt, ps = cache.get("block_tables"), None
    if bt is not None:
        ps = cache["layers"]["k"].shape[3]
        if page_size not in (None, ps):
            raise ValueError(f"page_size {page_size} is not the pool's {ps}")
        bt = bt.to(torch.int64)
    pos = torch.as_tensor(pos, device=tokens.device).to(torch.int64)
    x = embed_lookup(params["embed"], tokens)
    for i in range(cfg.n_layers):
        x, _ = bk.dense_block_verify(_layer(params["layers"], i), x,
                                     _layer(cache["layers"], i), bt, pos, cfg, ps, tree)
    return rmsnorm(x, params["ln_f"], cfg.norm_eps)


def verify_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict, pos,
                page_size: Optional[int] = None, tree: Optional[tuple] = None):
    """One forward pass over a window of T tokens (B, T) per row at positions
    ``pos .. pos+T-1``, ``pos`` (B,) integers (tokens already cached),
    against a dense cache (``init_cache``) or a paged one (told by its
    ``block_tables`` key; ``page_size``, if given, must be the pool's).
    Every window position's K/V is written in place (the dense family needs
    no commit step: positions past an accepted frontier are masked by later
    queries and written again by the next window), and each query attends
    as ``decode_step`` at its position does.  ``tree=(fan, depth)``
    verifies a fan-of-chains candidate tree of ``T == 1 + fan*depth``
    tokens in node order (``attention.tree_layout``): each chain scores as
    if verified alone, and ``tree_relocate`` moves the accepted chain's
    K/V into the linear columns.  Returns (logits (B, T, V), cache)."""
    x = verify_hidden(params, cfg, tokens, cache, pos, page_size, tree)
    return unembed(x, params.get("head", params["embed"])), cache


def stack_verify_caches(cfg: ModelConfig, caches: list) -> dict:
    """Merge a chain of ``verify_step`` caches (successive windows over
    consecutive positions, each committed into the next, as a draft model's
    single-token steps are) into one cache that ``commit_verify`` commits
    once at any accepted length.  The dense family's windows write their
    K/V in place, so the last cache already holds the whole chain's.  The
    families with per-step state, whose chains concatenate along the
    window's time axis, are not ported."""
    _check_family(cfg)
    return caches[-1]


def commit_verify(cfg: ModelConfig, cache: dict, sel: torch.Tensor) -> dict:
    """Commit a ``verify_step`` cache at each row's accepted step ``sel``
    (B,).  The dense family keeps nothing per step: its window's K/V are
    written in place, and positions past the accepted frontier are masked
    and written again by the next window, so the cache is returned as it
    is.  The families with per-step state are not ported."""
    _check_family(cfg)
    return cache


def tree_relocate(cfg: ModelConfig, cache: dict, pos: torch.Tensor, a: torch.Tensor,
                  cf: torch.Tensor, *, fan: int, depth: int,
                  page_size: Optional[int] = None) -> dict:
    """After a tree window at ``pos`` (B,) accepted ``a`` (B,) proposals of
    chain ``cf`` (B,), copy that chain's K/V (codes and scales of an int8
    cache) from its tree columns ``pos + 1 + cf*depth + i`` to the linear
    columns ``pos + 1 + i``, i < a, where the next window's frontier mask
    expects them; in place, reading nothing on the host.  Every source is
    gathered before any write, so chain 0 is the identity.  On a dense
    cache a step that writes nothing live (i >= a, or a destination past
    the store) writes its source column with the value it holds; on the
    paged pool (told by ``block_tables``; ``page_size``, if given, must be
    the pool's) columns go through the block tables, a source past them
    reads the trash page and such a step writes into it.  The store must
    reach ``fan*depth`` columns past a live row's frontier, or a gather
    reads the wrong rows.  Returns the cache."""
    _check_family(cfg)
    if "block_tables" in cache:
        ps = cache["layers"]["k"].shape[3]
        if page_size not in (None, ps):
            raise ValueError(f"page_size {page_size} is not the pool's {ps}")
    return move_columns(cache, *tree_columns(pos, a, cf, depth))


def tree_columns(pos: torch.Tensor, a: torch.Tensor, cf: torch.Tensor, depth: int) -> tuple:
    """``tree_relocate``'s columns, each (B, depth) int64: the sources
    ``pos + 1 + cf*depth + i``, the destinations ``pos + 1 + i``, and
    whether step i moves (i < a)."""
    steps = torch.arange(depth, device=pos.device)
    pos, a, cf = (t.reshape(-1, 1).to(torch.int64) for t in (pos, a, cf))
    return pos + 1 + cf * depth + steps, pos + 1 + steps, steps < a


def move_columns(cache: dict, src: torch.Tensor, dst: torch.Tensor, ok: torch.Tensor) -> dict:
    """Copy each row's columns ``src`` to ``dst`` where ``ok`` (all (B, n))
    in every leaf of a dense cache or, through its block tables, a paged
    pool, gathering before writing (``tree_relocate``'s rules for the
    steps that move nothing live)."""
    layers = cache["layers"]
    bt = cache.get("block_tables")
    if bt is None:
        seq = layers["k"].shape[3]
        src = src.clamp(0, seq - 1)
        rows = torch.arange(src.shape[0], device=src.device)[:, None].expand_as(src)
        # a step that moves nothing live writes its source back: only a
        # source at its own destination (chain 0) can be another step's
        # destination, so no column takes two values
        at_src = (rows, src)
        at_dst = (rows, torch.where(ok & (dst < seq), dst, src))
    else:
        ps = layers["k"].shape[3]
        bt = bt.to(torch.int64)
        w = bt.shape[1]

        def at(col, live):
            page = bt.gather(1, (col // ps).clamp(0, w - 1))
            return torch.where(live, page, 0), col % ps  # outside: the trash page
        at_src = at(src, src < w * ps)
        at_dst = at(dst, ok & (dst < w * ps))
    for leaf in layers.values():
        # (L, B | P, KV, S | ps, ...): the two index tensors lead the result
        leaf[:, at_dst[0], :, at_dst[1]] = leaf[:, at_src[0], :, at_src[1]]
    return cache

"""Model assembly for the dense, moe, ssm, vlm and encdec families (twin of
those branches of ``repro.models.lm``; the moe family with GQA or MLA
attention, the ssm family with Mamba1 blocks).

Parameters keep the JAX package's layout: a family's layers are stacked
trees with leading dims (the dense family's ``layers`` (L, ...); the moe
family's ``dense_layers`` (n_dense_layers, ...) and MoE ``layers`` (L -
n_dense_layers, ...), each with a cache stack of its own: K/V for GQA
blocks, latents for MLA ones (``stack_layout``); the ssm family's
``layers`` (L, ...) of Mamba1 blocks, whose cache stack is per-row state
(h and the conv tail) with no sequence axis; the vlm's
``groups`` of ``self`` (G, every - 1, ...) dense blocks and one gated
``cross`` block (G, ...) each; the encdec's ``encoder`` and ``decoder``),
and a Python loop over them takes the place of ``lax.scan``.  Slicing a
layer out of a stack is a view, so the loop copies no weights; the cache is
written in place (see ``models.attention``).  The vlm and encdec families
attend, without a cache, to a per-request memory passed as ``extras``
(``image_embeds`` (B, N, D), or ``enc_out`` (B, F, D) = ``encode(frames)``),
whose K/V every call computes anew, as the JAX package does.

Per-step state of a verify window (the ssm family's).  The JAX package's
``verify_step`` returns the state leaves stacked (B, T, ...) in place of
the cache's, and ``commit_verify`` selects each row's accepted step.  Here
the live cache must stay the tensors a captured decode step reads, so
``verify_step`` leaves a state stack's leaves as they are and returns the
live cache's dict with one more key, ``"steps"``: per state stack, per
layer, every step's state, leaves (B, T, ...) (tree windows in node order).
These are the window's own results, new tensors of each call (in a captured
window, memory of its graph's pool), so a draft's chain of one-token windows
keeps each step apart and ``stack_verify_caches`` concatenates them along T.
``commit_verify`` of that cache writes each row's step ``sel`` into the
live leaves, in place, and returns the live cache without the steps; the
callers commit the cache ``verify_step`` (or ``stack_verify_caches``)
returned, and committing a cache without steps raises.

Public API:
  init_params(cfg, gen, device)            -> params dict
  init_cache(cfg, batch, max_seq, device)  -> cache dict
  init_paged_cache(cfg, batch, max_seq, num_pages, page_size, device)
                                           -> paged cache dict
  prefill(params, cfg, tokens, cache[, extras, length, pages, slot])
                                           -> (logits (B, S, V), cache)
  prefill_hidden(...)                      -> (B, S, D) before the unembedding
  paged_insert(cfg, paged, dense, slot, pages) -> paged cache
  decode_step(params, cfg, tokens, cache, pos[, extras, page_size])
                                           -> (logits (B, 1, V), cache)
  verify_step(params, cfg, tokens, cache, pos[, extras, page_size, tree])
                                           -> (logits (B, T, V), cache)
  stack_verify_caches(cfg, caches)         -> cache
  commit_verify(cfg, cache, sel)           -> cache
  tree_relocate(cfg, cache, pos, a, cf, fan=, depth=) -> cache
  encode(params, cfg, frames)              -> (B, F, D) encoder output
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig

from . import blocks as bk
from .attention import attn_apply, attn_init, kv_cache_init, paged_kv_insert
from .common import (dense_init, dtype_of, embed_lookup, mlp_apply, mlp_init, resolve_device,
                     rmsnorm, unembed)
from .mla import mla_cache_init, mla_paged_insert

_FAMILIES = ("dense", "moe", "ssm", "vlm", "encdec")


def check_family(cfg: ModelConfig):
    """Raise NotImplementedError where ``cfg``'s family is not ported; every
    ported family also has its verify window, so speculation's gate (a
    target's config, and a draft's at ``speculate=``) is this one."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port runs the "
            f"{', '.join(_FAMILIES)} families (ROADMAP.md lists the others)")


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def cache_stacks(cfg: ModelConfig) -> tuple:
    """(cache key, leading stack dims) of each of the family's cache stacks:
    the dense family's ``layers``, the moe family's ``layers`` (its MoE
    blocks) and ``dense_layers`` (its leading dense blocks, where it has
    any; the JAX package's ``_pool_leaf_paths`` order), the vlm's
    ``groups_self`` (groups, dense blocks a group), the encdec's
    ``decoder``, the ssm family's ``layers``; each leaf's batch, slot or
    page axis comes right after those dims, and ``stack_layout`` says
    where its sequence axis is, if it has one."""
    check_family(cfg)
    if cfg.family == "vlm":
        return (("groups_self", _groups(cfg)),)
    if cfg.family == "encdec":
        return (("decoder", (cfg.dec_layers,)),)
    if cfg.family == "moe":
        nd = cfg.n_dense_layers
        return (("layers", (cfg.n_layers - nd,)),) + ((("dense_layers", (nd,)),) if nd else ())
    return (("layers", (cfg.n_layers,)),)


def stack_layout(cfg: ModelConfig, key: str) -> str:
    """A cache stack's layout: "state" for the SSM blocks' stack (the ssm
    family's ``layers``), per-row state ``h`` (B, d_in, N) and ``conv`` (B,
    K-1, d_in) with no sequence axis, B the batch or the continuous
    engine's slots, never pages; "latent" for the MLA blocks' stack (the
    moe family's ``layers`` under ``cfg.mla``), whose leaves ``c`` and
    ``kr`` are (B | P, S | ps, C | R); "kv" for every other (GQA K/V (B |
    P, KV, S | ps, D), int8 scales (B | P, KV, S | ps))."""
    if cfg.family == "ssm":
        return "state"
    return "latent" if (cfg.family, key) == ("moe", "layers") and cfg.mla else "kv"


def seq_stacks(cfg: ModelConfig) -> tuple:
    """The stacks of ``cache_stacks`` with a sequence (or page) axis: K/V
    and latents, the ones paged and relocated."""
    return tuple(s for s in cache_stacks(cfg) if stack_layout(cfg, s[0]) != "state")


def state_stacks(cfg: ModelConfig) -> tuple:
    """The stacks of ``cache_stacks`` of per-row state, the ones a verify
    window keeps per step and ``commit_verify`` writes."""
    return tuple(s for s in cache_stacks(cfg) if stack_layout(cfg, s[0]) == "state")


def seq_axis(cfg: ModelConfig, key: str) -> int:
    """The sequence (or page offset) axis of every leaf of stack ``key``,
    counted after its lead dims (``stack_layout``); a state stack has
    none."""
    layout = stack_layout(cfg, key)
    if layout == "state":
        raise ValueError(f"stack {key!r} holds per-row state: it has no sequence axis")
    return 1 if layout == "latent" else 2


def _kv_bits(cfg: ModelConfig, key: str) -> int:
    """A K/V stack's cache bits: ``kv_cache_bits``, but the moe family's
    MoE stack is always the parameter dtype (the JAX package makes it
    without ``bits``; only ``dense_layers`` takes the int8 cache)."""
    return 16 if (cfg.family, key) == ("moe", "layers") else cfg.kv_cache_bits


def _page_size(cfg: ModelConfig, cache: dict, page_size):
    """The paged pool's page size; ``page_size``, if given, must be it.  A
    cache of state stacks only has no pages: ``page_size`` as given."""
    stacks = seq_stacks(cfg)
    if not stacks:
        return page_size
    key, lead = stacks[0]
    ps = next(iter(cache[key].values())).shape[len(lead) + seq_axis(cfg, key)]
    if page_size not in (None, ps):
        raise ValueError(f"page_size {page_size} is not the pool's {ps}")
    return ps


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """The vlm's (groups, dense blocks a group)."""
    every = cfg.vision.cross_attn_every
    return cfg.n_layers // every, every - 1


def _encdec_dec_block_init(gen, cfg: ModelConfig, dtype, device, lead=()) -> dict:
    kw = dict(d=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
              dtype=dtype, device=device, lead=lead)
    return {
        "ln1": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
        "self": attn_init(gen, **kw),
        "ln2": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
        "cross": attn_init(gen, **kw),
        "ln3": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device, lead=lead),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random parameters drawn from ``gen``, which must live on ``device``
    (None: the card)."""
    check_family(cfg)
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    p: dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dtype, device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.vocab, cfg.d_model), dtype, device).T
    if cfg.family == "dense":
        p["layers"] = bk.dense_block_init(gen, cfg, dtype, device, lead=(cfg.n_layers,))
    elif cfg.family == "moe":
        nd = cfg.n_dense_layers
        if nd:
            p["dense_layers"] = bk.dense_block_init(gen, cfg, dtype, device, lead=(nd,))
        p["layers"] = bk.moe_block_init(gen, cfg, dtype, device, lead=(cfg.n_layers - nd,))
    elif cfg.family == "ssm":
        p["layers"] = bk.ssm_block_init(gen, cfg, dtype, device, lead=(cfg.n_layers,))
    elif cfg.family == "vlm":
        g, e = _groups(cfg)
        p["groups"] = {"self": bk.dense_block_init(gen, cfg, dtype, device, lead=(g, e)),
                       "cross": bk.cross_block_init(gen, cfg, dtype, device, lead=(g,))}
    else:
        p["encoder"] = bk.dense_block_init(gen, cfg, dtype, device, lead=(cfg.n_layers,))
        p["decoder"] = _encdec_dec_block_init(gen, cfg, dtype, device, lead=(cfg.dec_layers,))
    return p


def _stack_init(cfg: ModelConfig, key: str, lead: tuple, rows: int, seq: int, device) -> dict:
    """One cache stack of ``rows`` batch rows (or pool pages) of ``seq``
    positions (or a page's): latents (``mla_cache_init``) or K/V
    (``kv_cache_init``) by its layout; a state stack's ``rows`` rows of
    state (``ssm_cache_init``), whatever ``seq``."""
    dtype = dtype_of(cfg.param_dtype)
    layout = stack_layout(cfg, key)
    if layout == "state":
        return bk.ssm_cache_init(cfg, rows, device, lead=lead)
    if layout == "latent":
        return mla_cache_init(rows, seq, cfg.mla, dtype, device, lead=lead)
    return kv_cache_init(rows, seq, cfg.n_kv_heads, cfg.head_dim, dtype, device,
                         bits=_kv_bits(cfg, key), lead=lead)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> dict:
    """The dense decode cache: every stack of ``cache_stacks`` with ``batch``
    rows of ``max_seq`` positions."""
    device = resolve_device(device)
    return {key: _stack_init(cfg, key, lead, batch, max_seq, device)
            for key, lead in cache_stacks(cfg)}


def init_paged_cache(cfg: ModelConfig, batch: int, max_seq: int, num_pages: int,
                     page_size: int, device=None) -> dict:
    """Paged decode cache: every layer's K/V in a pool of ``num_pages`` pages
    of ``page_size`` tokens shared by the ``batch`` slots, and
    ``block_tables`` (batch, ceil(max_seq / page_size)) int32 mapping each
    slot's logical page i to a pool page id.  ``decode_step`` takes the
    paged path whenever this key is present.  Page 0 is the trash page of
    inactive slots, so ``num_pages - 1`` pages circulate.  A pool is its
    stack's dense layout with pages for rows and a page's tokens for
    positions: lead + (P, KV, page_size, D) for K/V, lead + (P, page_size,
    C | R) for latents, one pool a stack of ``cache_stacks``.  A state
    stack has nothing to page: it keeps one row of state per slot, lead +
    (batch, ...), as the JAX package's does."""
    device = resolve_device(device)
    width = -(-max_seq // page_size)
    out = {"block_tables": torch.zeros((batch, width), dtype=torch.int32, device=device)}
    for key, lead in cache_stacks(cfg):
        if stack_layout(cfg, key) == "state":
            out[key] = _stack_init(cfg, key, lead, batch, 0, device)
        else:
            out[key] = _stack_init(cfg, key, lead, num_pages, page_size, device)
    return out


def paged_insert(cfg: ModelConfig, paged: dict, dense: dict, slot, pages) -> dict:
    """Scatter a freshly prefilled batch-1 dense cache into the paged cache's
    pool pages ``pages`` (n,), and copy its state stacks into the per-slot
    row ``slot`` (an int or a 0-d integer tensor), in place.  Not on the
    serving path (the admit prefills straight into the pages and the slot's
    row, ``prefill(pages=, slot=)``): the reference the direct admit is
    held against."""
    dev = paged["block_tables"].device
    pages = torch.as_tensor(pages, dtype=torch.int64, device=dev)
    for key, lead in cache_stacks(cfg):
        layout = stack_layout(cfg, key)
        if layout == "state":
            _copy_slot(paged[key], dense[key], slot, len(lead))
            continue
        insert = mla_paged_insert if layout == "latent" else paged_kv_insert
        insert(paged[key], dense[key], pages, lead=len(lead))
    return paged


def _copy_slot(per_slot: dict, dense: dict, slot, lead: int) -> None:
    """Row 0 of a batch-1 state stack ``dense`` into row ``slot`` of the
    per-slot stack ``per_slot`` (``lead`` stack dims before the row axis),
    in place, through a device index."""
    for name, leaf in per_slot.items():
        at = torch.as_tensor(slot, device=leaf.device).to(torch.int64).reshape(1)
        leaf.index_copy_(lead, at, dense[name].narrow(lead, 0, 1).to(leaf.dtype))


def _dec_block(lp, x, enc, cfg: ModelConfig, self_attn):
    """The encdec decoder block: self-attention (``self_attn(p, xn)`` -> h,
    the cache written in place), cross-attention over the encoder's output
    ``enc`` with no rope and no mask, then the MLP."""
    x = x + self_attn(lp["self"], rmsnorm(x, lp["ln1"], cfg.norm_eps))
    x = x + attn_apply(lp["cross"], rmsnorm(x, lp["ln2"], cfg.norm_eps), n_heads=cfg.n_heads,
                       n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim, rope_theta=0.0,
                       causal=False, kv_input=enc)
    return x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln3"], cfg.norm_eps))


def _stack(params, cfg: ModelConfig, x, cache: dict, extras, dense_body, self_attn,
           state_body=None):
    """Run the family's layers over x with the cache: ``dense_body(lp, x,
    c, latent)`` -> x for a dense block, ``latent`` whether its stack is
    MLA's (``stack_layout``), ``state_body(lp, x, c, key)`` -> x for an
    SSM block of state stack ``key``, ``self_attn(p, xn, c)`` -> h for the
    encdec decoder's self-attention; the vlm's cross blocks attend to
    ``extras["image_embeds"]``, the encdec's to ``extras["enc_out"]``, each
    cast to x's dtype.  The moe family's leading dense blocks run first,
    then its MoE blocks, each through ``dense_body`` (``blocks._ffn``)."""
    if cfg.family in ("dense", "moe", "ssm"):
        for key, (n,) in reversed(cache_stacks(cfg)):
            layout = stack_layout(cfg, key)
            for i in range(n):
                lp, c = _layer(params[key], i), _layer(cache[key], i)
                x = (state_body(lp, x, c, key) if layout == "state"
                     else dense_body(lp, x, c, layout == "latent"))
    elif cfg.family == "vlm":
        img = extras["image_embeds"].to(x.dtype)
        groups, (g, e) = params["groups"], _groups(cfg)
        for j in range(g):
            sp, sc = _layer(groups["self"], j), _layer(cache["groups_self"], j)
            for i in range(e):
                x = dense_body(_layer(sp, i), x, _layer(sc, i), False)
            x = bk.cross_block_apply(_layer(groups["cross"], j), x, img, cfg)
    else:
        enc = extras["enc_out"].to(x.dtype)
        for i in range(cfg.dec_layers):
            c = _layer(cache["decoder"], i)
            x = _dec_block(_layer(params["decoder"], i), x, enc, cfg,
                           lambda p, xn: self_attn(p, xn, c))
    return x


def prefill_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                   extras: Optional[dict] = None, length=None, pages=None,
                   slot=None) -> torch.Tensor:
    """``prefill`` up to the final norm: the prompt's hidden states (B, S,
    D), the cache filled.  A caller that needs the logits of a few
    positions only unembeds those."""
    check_family(cfg)
    if pages is not None:
        pages = torch.as_tensor(pages, dtype=torch.int64, device=tokens.device)
    x = embed_lookup(params["embed"], tokens)
    x = _stack(params, cfg, x, cache, extras,
               lambda lp, h, c, lat: bk.dense_block_prefill(lp, h, c, cfg, pages, lat)[0],
               lambda p, xn, c: bk.self_attn_prefill(p, xn, c, cfg, pages)[0],
               lambda lp, h, c, key: bk.ssm_block_prefill(lp, h, c, cfg, length, slot)[0])
    return rmsnorm(x, params["ln_f"], cfg.norm_eps)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
            extras: Optional[dict] = None, length=None, pages=None, slot=None):
    """Single-pass prefill over the whole prompt (B, S) that fills the decode
    cache for positions 0..S-1.  ``cache`` must be fresh from ``init_cache``.
    ``extras``: the vlm's ``image_embeds`` or the encdec's ``enc_out``, each
    (B, N, D); the dense family ignores them.  Returns (logits (B, S, V),
    cache).

    With ``pages`` (n,) ``cache`` is a paged tree (``init_paged_cache``) and
    ``tokens`` is batch-1 with ``S == n * page_size``: the prompt's K/V go
    straight into those pool pages (the continuous-batching admit).
    ``length`` (the true length of a right-padded prompt, an int or a 0-d
    integer tensor) and ``slot`` (the per-slot state row, the same) matter
    to the ssm family only, whose state is sequential: pad steps are
    masked out of it, and with ``slot`` the prompt runs from a zero state
    that lands in row ``slot`` of the per-slot state
    (``blocks.ssm_block_prefill``); causal attention needs neither.  The
    ssm family's prefill starts from the cache's state, zero when fresh."""
    x = prefill_hidden(params, cfg, tokens, cache, extras, length, pages, slot)
    return unembed(x, params.get("head", params["embed"])), cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                pos, extras: Optional[dict] = None, page_size: Optional[int] = None):
    """One decode step of tokens (B, 1).  With a dense cache (``init_cache``)
    ``pos`` is shared by the batch: an int or a 0-d integer tensor on the
    tokens' device (the JAX package takes an int32 scalar).  With a paged
    cache (``init_paged_cache``, told by its ``block_tables`` key) ``pos``
    is a (B,) integer tensor, one position per slot, and ``page_size``, if
    given, must be the pool's.  ``extras`` as for ``prefill``, row b of
    each the memory of batch row (or slot) b.  No value of the device is
    read on the host, so a CUDA graph of the step replays at the positions
    its tensors hold.  A state stack (the ssm family's) advances each row's
    state in place, whatever ``pos``.  Returns (logits (B, 1, V), cache)."""
    check_family(cfg)
    bt, ps = cache.get("block_tables"), None
    if bt is None:
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), pos, dtype=torch.int64, device=tokens.device)
    else:
        ps = _page_size(cfg, cache, page_size)
        bt = bt.to(torch.int64)
    pos = pos.to(torch.int64)
    x = embed_lookup(params["embed"], tokens)
    x = _stack(params, cfg, x, cache, extras,
               lambda lp, h, c, lat: bk.dense_block_decode(lp, h, c, pos, cfg, bt, ps, lat)[0],
               lambda p, xn, c: bk.self_attn_decode(p, xn, c, pos, cfg, bt, ps)[0],
               lambda lp, h, c, key: bk.ssm_block_decode(lp, h, c, cfg)[0])
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(x, params.get("head", params["embed"])), cache


def _tree_to_chains(x: torch.Tensor, fan: int, depth: int) -> torch.Tensor:
    """A node-order tree window (B, 1 + fan*depth, ...) as a batch of chains
    (B*fan, 1 + depth, ...), the shared root before each, so a per-row
    recurrence runs every chain as an ordinary window (row b*fan + f:
    chain f of row b)."""
    b = x.shape[0]
    root = x[:, None, :1].expand((b, fan, 1) + x.shape[2:])
    chains = x[:, 1:].reshape((b, fan, depth) + x.shape[2:])
    return torch.cat([root, chains], dim=2).reshape((b * fan, 1 + depth) + x.shape[2:])


def _chains_to_tree(y: torch.Tensor, fan: int, depth: int) -> torch.Tensor:
    """The inverse of ``_tree_to_chains``: (B*fan, 1 + depth, ...) -> node
    order (B, 1 + fan*depth, ...).  A row's chains start from one state
    with one token, so chain 0's root stands for node 0."""
    b = y.shape[0] // fan
    y = y.reshape((b, fan, 1 + depth) + y.shape[2:])
    return torch.cat([y[:, 0, :1], y[:, :, 1:].reshape((b, fan * depth) + y.shape[3:])], dim=1)


def _verify(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict, pos, extras,
            page_size, tree) -> tuple:
    """``verify_step`` up to the final norm: (the window's hidden states,
    the verify cache)."""
    check_family(cfg)
    bt, ps = cache.get("block_tables"), None
    if bt is not None:
        ps = _page_size(cfg, cache, page_size)
        bt = bt.to(torch.int64)
    pos = torch.as_tensor(pos, device=tokens.device).to(torch.int64)
    steps: dict = {}
    # the ssm family's stack is all SSM blocks: a tree runs as chains throughout
    chains = tree is not None and cfg.family == "ssm"

    def state_body(lp, h, c, key):
        if chains:  # the batch's state, one copy per chain
            c = {name: leaf.repeat_interleave(tree[0], dim=0) for name, leaf in c.items()}
        h, st = bk.ssm_block_verify(lp, h, c, cfg)
        if chains:
            st = {name: _chains_to_tree(leaf, *tree) for name, leaf in st.items()}
        steps.setdefault(key, []).append(st)
        return h

    x = embed_lookup(params["embed"], tokens)
    if chains:
        x = _tree_to_chains(x, *tree)
    x = _stack(params, cfg, x, cache, extras,
               lambda lp, h, c, lat: bk.dense_block_verify(lp, h, c, bt, pos, cfg, ps, tree,
                                                             lat)[0],
               lambda p, xn, c: bk.self_attn_verify(p, xn, c, pos, cfg, bt, ps, tree)[0],
               state_body)
    if chains:
        x = _chains_to_tree(x, *tree)
    return rmsnorm(x, params["ln_f"], cfg.norm_eps), dict(cache, steps=steps) if steps else cache


def verify_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict, pos,
                  extras: Optional[dict] = None, page_size: Optional[int] = None,
                  tree: Optional[tuple] = None) -> torch.Tensor:
    """``verify_step`` up to the final norm: the window's hidden states
    (B, T, D), the cache written in place (a state stack's per-step states
    are dropped: nothing commits them).  A caller that needs the logits of
    a few positions only unembeds those."""
    return _verify(params, cfg, tokens, cache, pos, extras, page_size, tree)[0]


def verify_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict, pos,
                extras: Optional[dict] = None, page_size: Optional[int] = None,
                tree: Optional[tuple] = None):
    """One forward pass over a window of T tokens (B, T) per row at positions
    ``pos .. pos+T-1``, ``pos`` (B,) integers (tokens already cached),
    against a dense cache (``init_cache``) or a paged one (told by its
    ``block_tables`` key; ``page_size``, if given, must be the pool's).
    Every window position's K/V (or MLA latents) is written in place (these
    families need no commit step: positions past an accepted frontier are
    masked by later queries and written again by the next window; a MoE
    block's experts act per position), and each query attends as
    ``decode_step`` at its position does.  ``extras`` as for
    ``decode_step``.  ``tree=(fan, depth)`` verifies a fan-of-chains
    candidate tree of ``T == 1 + fan*depth`` tokens in node order
    (``attention.tree_layout``) in every self-attention: each chain scores
    as if verified alone, and ``tree_relocate`` moves the accepted chain's
    K/V or latents into the linear columns.  A cross block attends from
    every window row to the request's memory, with no positions and no
    mask, as in a decode step.  An SSM block runs the window from each
    row's state step by step, as ``decode_step`` would, and leaves the
    state as it is: its per-step states come back under the returned
    cache's ``"steps"`` for ``commit_verify`` (the module docstring); under
    ``tree`` each chain runs as a window of its own from the row's state
    (``_tree_to_chains``), its steps kept in node order.  Returns (logits
    (B, T, V), the verify cache: ``cache`` itself where the family has no
    state stack)."""
    x, vcache = _verify(params, cfg, tokens, cache, pos, extras, page_size, tree)
    return unembed(x, params.get("head", params["embed"])), vcache


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """The encdec family's encoder pass over frame embeddings (B, F, D), cast
    to the parameter dtype: non-causal dense blocks with rope, no cache and
    no final norm.  Serving runs it once a request and passes the result as
    ``extras["enc_out"]``."""
    if cfg.family != "encdec":
        raise ValueError(f"encode runs the encdec family, not {cfg.family!r}")
    x = frames.to(dtype_of(cfg.param_dtype))
    for i in range(cfg.n_layers):
        x = bk.dense_block_apply(_layer(params["encoder"], i), x, cfg, causal=False)
    return x


def stack_verify_caches(cfg: ModelConfig, caches: list) -> dict:
    """Merge a chain of ``verify_step`` caches (successive windows over
    consecutive positions, each committed into the next, as a draft model's
    single-token steps are) into one cache that ``commit_verify`` commits
    once at any accepted length.  K/V and latents are written in place, so
    the last cache already holds the whole chain's; a state stack's
    per-step states concatenate along the time axis (the last cache itself
    where the family has none)."""
    check_family(cfg)
    if not state_stacks(cfg):
        return caches[-1]
    steps = {key: [{name: torch.cat([c["steps"][key][i][name] for c in caches], dim=1)
                    for name in layer}
                   for i, layer in enumerate(caches[-1]["steps"][key])]
             for key, _ in state_stacks(cfg)}
    return dict(caches[-1], steps=steps)


def commit_verify(cfg: ModelConfig, cache: dict, sel: torch.Tensor) -> dict:
    """Commit a ``verify_step`` (or ``stack_verify_caches``) cache at each
    row's accepted step ``sel`` (B,): every state stack's live leaves take,
    row by row, the state after step ``sel`` (a device gather, in place),
    and the live cache is returned without the steps.  K/V and latents keep
    nothing per step (positions past the accepted frontier are masked and
    written again by the next window), so a family without a state stack
    gets its cache back as it is.  Raises ValueError for a cache of a state
    family that holds no steps (the live cache, not the window's)."""
    check_family(cfg)
    stacks = state_stacks(cfg)
    if not stacks:
        return cache
    if "steps" not in cache:
        raise ValueError("commit_verify takes the cache verify_step (or stack_verify_caches) "
                         "returned, which holds the window's per-step states")
    sel = sel.to(torch.int64)
    for key, lead in stacks:
        for i, step in enumerate(cache["steps"][key]):
            for name, leaf in cache[key].items():
                live = leaf.view((-1,) + leaf.shape[len(lead):])[i]  # (B, ...)
                s = step[name]  # (B, T, ...)
                b, t = s.shape[:2]
                at = torch.arange(b, device=sel.device) * t + sel
                torch.index_select(s.reshape((b * t,) + s.shape[2:]), 0, at, out=live)
    return {k: v for k, v in cache.items() if k != "steps"}


def tree_relocate(cfg: ModelConfig, cache: dict, pos: torch.Tensor, a: torch.Tensor,
                  cf: torch.Tensor, *, fan: int, depth: int,
                  page_size: Optional[int] = None) -> dict:
    """After a tree window at ``pos`` (B,) accepted ``a`` (B,) proposals of
    chain ``cf`` (B,), copy that chain's K/V (codes and scales of an int8
    cache) or latents, in every stack of ``cache_stacks``, from its tree
    columns ``pos + 1 + cf*depth + i`` to the linear
    columns ``pos + 1 + i``, i < a, where the next window's frontier mask
    expects them; in place, reading nothing on the host.  Every source is
    gathered before any write, so chain 0 is the identity.  On a dense
    cache a step that writes nothing live (i >= a, or a destination past
    the store) writes its source column with the value it holds; on the
    paged pool (told by ``block_tables``; ``page_size``, if given, must be
    the pool's) columns go through the block tables, a source past them
    reads the trash page and such a step writes into it.  The store must
    reach ``fan*depth`` columns past a live row's frontier, or a gather
    reads the wrong rows.  A state stack has no columns: ``commit_verify``
    at the kept node's step commits it.  Returns the cache."""
    check_family(cfg)
    if "block_tables" in cache:
        _page_size(cfg, cache, page_size)
    return move_columns(cfg, cache, *tree_columns(pos, a, cf, depth))


def tree_columns(pos: torch.Tensor, a: torch.Tensor, cf: torch.Tensor, depth: int) -> tuple:
    """``tree_relocate``'s columns, each (B, depth) int64: the sources
    ``pos + 1 + cf*depth + i``, the destinations ``pos + 1 + i``, and
    whether step i moves (i < a)."""
    steps = torch.arange(depth, device=pos.device)
    pos, a, cf = (t.reshape(-1, 1).to(torch.int64) for t in (pos, a, cf))
    return pos + 1 + cf * depth + steps, pos + 1 + steps, steps < a


def move_columns(cfg: ModelConfig, cache: dict, src: torch.Tensor, dst: torch.Tensor,
                 ok: torch.Tensor) -> dict:
    """Copy each row's columns ``src`` to ``dst`` where ``ok`` (all (B, n))
    in every leaf of every stack of ``cache_stacks(cfg)`` of a dense cache
    or, through its block tables, a paged pool, gathering before writing
    (``tree_relocate``'s rules for the steps that move nothing live).  A
    stack's lead dims are flattened into one view, so every leaf is moved
    as (lead, B | P, KV, S | ps, ...), a latent one (lead, B | P, S | ps,
    C) viewed with one head (``stack_layout``).  State stacks have no
    columns and are left as they are."""
    stacks = seq_stacks(cfg)
    if not stacks:
        return cache
    key, lead = stacks[0]
    # the store's columns, or the page size
    seq = next(iter(cache[key].values())).shape[len(lead) + seq_axis(cfg, key)]
    bt = cache.get("block_tables")
    if bt is None:
        src = src.clamp(0, seq - 1)
        rows = torch.arange(src.shape[0], device=src.device)[:, None].expand_as(src)
        # a step that moves nothing live writes its source back: only a
        # source at its own destination (chain 0) can be another step's
        # destination, so no column takes two values
        at_src = (rows, src)
        at_dst = (rows, torch.where(ok & (dst < seq), dst, src))
    else:
        ps = seq
        bt = bt.to(torch.int64)
        w = bt.shape[1]

        def at(col, live):
            page = bt.gather(1, (col // ps).clamp(0, w - 1))
            return torch.where(live, page, 0), col % ps  # outside: the trash page
        at_src = at(src, src < w * ps)
        at_dst = at(dst, ok & (dst < w * ps))
    for key, lead in stacks:
        latent = stack_layout(cfg, key) == "latent"
        for leaf in cache[key].values():
            flat = leaf.view((-1,) + leaf.shape[len(lead):])  # in place: a view, never a copy
            if latent:  # (lead, B | P, 1, S | ps, C)
                flat = flat.unsqueeze(2)
            # (lead, B | P, KV, S | ps, ...): the two index tensors lead the result
            flat[:, at_dst[0], :, at_dst[1]] = flat[:, at_src[0], :, at_src[1]]
    return cache

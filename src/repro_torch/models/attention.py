"""GQA attention for the dense slices: prefill and decode with a cache.

Twin of the dense-cache parts of ``repro.models.attention``.  Prefill over
more than CHUNKED_THRESHOLD keys streams them through the online-softmax
kernel ``flash_attention`` (``_chunked_attention``); shorter prompts attend
directly, as in the JAX package.  The cache is
head-major ``(B, KV, S, D)``, in the parameter dtype or as int8 codes with a
per-token f32 scale.  Unlike the JAX package, which returns a new cache,
``attn_prefill`` and ``attn_decode`` write the cache IN PLACE and return the
same dict: a decode step then copies nothing but the new token's K/V.
A decode step's position is a 0-d int64 tensor on the cache's device, read
only by device ops, so a CUDA graph of the step replays at any position.

The paged cache (the continuous-batching engine's) is a pool of pages
``(P, KV, page_size, D)`` shared by all batch slots; a slot's block table
maps its logical page i (positions ``[i*page_size, (i+1)*page_size)``) to a
pool page, and page 0 is the trash page of inactive slots.  A paged decode
step takes one position per slot, a (B,) int64 tensor, and scatters and
gathers through the block tables with device ops only.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attn import flash_attention_gqa

from .common import apply_rope, dense_init, linear

CHUNKED_THRESHOLD = 8192


def attn_init(gen, d: int, n_heads: int, n_kv: int, head_dim: int, dtype,
              device, bias: bool = False, lead=()) -> dict:
    p = {
        "wq": dense_init(gen, lead + (d, n_heads * head_dim), dtype, device),
        "wk": dense_init(gen, lead + (d, n_kv * head_dim), dtype, device),
        "wv": dense_init(gen, lead + (d, n_kv * head_dim), dtype, device),
        "wo": dense_init(gen, lead + (n_heads * head_dim, d), dtype, device),
    }
    if bias:
        p["bq"] = torch.zeros(lead + (n_heads * head_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros(lead + (n_kv * head_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros(lead + (n_kv * head_dim,), dtype=dtype, device=device)
    return p


def _split_heads(x, n, d):
    return x.reshape(x.shape[:-1] + (n, d))


def _qkv(p, x, n_heads, n_kv, head_dim):
    q = _split_heads(linear(x, p["wq"], p.get("bq")), n_heads, head_dim)
    k = _split_heads(linear(x, p["wk"], p.get("bk")), n_kv, head_dim)
    v = _split_heads(linear(x, p["wv"], p.get("bv")), n_kv, head_dim)
    return q, k, v


def _direct_attention(q, k, v, causal: bool, q_offset: int = 0):
    """q: (B,Sq,KV,G,D); k,v: (B,Sk,KV,D).  Scores are contracted in the
    operand dtype, then softmaxed in f32, as in the JAX package."""
    sq, d = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(d)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(qi < ki, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", w, v)


def _chunked_attention(q, k, v, causal: bool):
    """Online softmax over KV blocks, no (Sq, Sk) scores in memory.
    q: (B,Sq,KV,G,D); k,v: (B,Sk,KV,D).  The CUDA kernel ``flash_attention``
    on the card; on CPU tensors its plain version, the JAX package's
    ``_chunked_attention`` at its default chunk."""
    return flash_attention_gqa(q, k, v, causal=causal)


def kv_cache_init(batch: int, max_seq: int, n_kv: int, head_dim: int, dtype,
                  device, bits: int = 16, lead=()) -> dict:
    """Head-major cache (B, KV, S, D); ``bits=8``: int8 codes + per-token
    f32 scales."""
    shape = lead + (batch, n_kv, max_seq, head_dim)
    if bits == 8:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _quant_kv(x):
    """(..., D) -> int8 codes + per-token scale over the last axis."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    codes = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def _dequant_kv(codes, scale, dtype):
    return codes.to(dtype) * scale[..., None].to(dtype)


def attn_prefill(p: dict, x: torch.Tensor, cache: dict, *, n_heads: int,
                 n_kv: int, head_dim: int, rope_theta: float = 0.0,
                 pages: Optional[torch.Tensor] = None):
    """Full-sequence causal attention over the prompt x (B, S, D) that also
    writes all S prompt tokens' K/V into the cache (in place).  With an int8
    cache the prompt attends against the quantize->dequantize K/V, exactly
    what later decode steps read back.  Over more than CHUNKED_THRESHOLD keys
    the attention is ``_chunked_attention``, else ``_direct_attention``.

    With ``pages`` (n,) int64 the cache is a paged pool
    (``lm.init_paged_cache`` leaves), x is batch-1 with ``S == n *
    page_size``, and the prompt's K/V (codes and scales for an int8 cache)
    go straight into those pool pages.  The attention itself reads the fresh
    k/v, never the pool."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    if rope_theta:
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    k_t = k.transpose(1, 2)  # (B, KV, S, D) — the cache layout
    v_t = v.transpose(1, 2)
    if pages is None:
        def write(name, t):
            cache[name][:, :, :s] = t
    else:
        n, ps = pages.shape[0], cache["k"].shape[2]

        def write(name, t):  # (1, KV, n*ps, ...) -> pool pages (n, KV, ps, ...)
            t = t[0].reshape((t.shape[1], n, ps) + t.shape[3:]).transpose(0, 1)
            cache[name].index_copy_(0, pages, t.to(cache[name].dtype))
    if "k_scale" in cache:
        k_codes, k_sc = _quant_kv(k_t)
        v_codes, v_sc = _quant_kv(v_t)
        for name, new in (("k", k_codes), ("v", v_codes), ("k_scale", k_sc),
                          ("v_scale", v_sc)):
            write(name, new)
        k = _dequant_kv(k_codes, k_sc, x.dtype).transpose(1, 2)
        v = _dequant_kv(v_codes, v_sc, x.dtype).transpose(1, 2)
    else:
        write("k", k_t)
        write("v", v_t)
    g = n_heads // n_kv
    qg = q.reshape(b, s, n_kv, g, head_dim)
    if k.shape[1] > CHUNKED_THRESHOLD:
        o = _chunked_attention(qg, k, v, causal=True)
    else:
        o = _direct_attention(qg, k, v, causal=True)
    return linear(o.reshape(b, s, n_heads * head_dim), p["wo"]), cache


def bmm_f32(a, b):
    """Batched a @ b with f32 outputs.  On the card the operands stay in
    their storage dtype (``aten::bmm.dtype``, the JAX package's
    preferred_element_type=f32): no f32 copy of the cache is formed.  That
    overload has no CPU kernel, so CPU tensors are widened first: a
    bf16 x bf16 product is exact in f32, so both forms sum the same
    products."""
    if a.dtype == torch.float32 or a.device.type != "cuda":
        return torch.bmm(a.to(torch.float32), b.to(torch.float32))
    return torch.bmm(a, b, out_dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def key_chunk(s_len: int) -> int:
    """The keys whose p.v products one tensor-core sum takes on the card: the
    divisor of the cache length in [128, 512] nearest 256 (so the chunks
    are views of the cache), or 0 where it has none."""
    divisors = [c for c in range(128, 513) if s_len % c == 0 and s_len // c >= 2]
    return min(divisors, key=lambda c: abs(c - 256), default=0)


def pv_f32(w, v):
    """w (N, G, S) @ v (N, S, D) with f32 outputs.  On the card the keys go
    in chunks of ``key_chunk(S)``: the tensor cores sum each chunk's exact
    bf16 products and the chunks' sums join in f32 adds, so a long cache's
    sum keeps f32's accuracy (one tensor-core sum over 16K keys drifts by
    about 2e-5 of the output).  v is only viewed, never copied."""
    n, g, s = w.shape
    chunk = key_chunk(s) if w.device.type == "cuda" and w.dtype != torch.float32 else 0
    if not chunk or not v.is_contiguous():
        return bmm_f32(w, v)
    c, d = s // chunk, v.shape[-1]
    wc = w.reshape(n, g, c, chunk).transpose(1, 2).reshape(n * c, g, chunk)
    return bmm_f32(wc, v.reshape(n * c, chunk, d)).reshape(n, c, g, d).sum(dim=1)


def decode_attention(q, ck, cv, pos: torch.Tensor) -> torch.Tensor:
    """One decode step's attention: q (B, KV, G, D) over the cache ck, cv
    (B, KV, S, D), keys past ``pos`` masked: a 0-d tensor shared by the
    batch, or one position per row, (B,).  q is cast to the cache dtype,
    scores and softmax are f32, the weights are cast back to the cache
    dtype before p.v, as in the JAX package.  Returns (B, KV, G, D) f32."""
    b, kv, g, d = q.shape
    s_len = ck.shape[2]
    qg = q.to(ck.dtype).reshape(b * kv, g, d)
    s = bmm_f32(qg, ck.reshape(b * kv, s_len, d).transpose(1, 2)) / math.sqrt(d)
    valid = torch.arange(s_len, device=q.device) <= pos.reshape(-1, 1, 1, 1)
    s = s.reshape(b, kv, g, s_len).masked_fill(~valid, float("-inf"))
    w = torch.softmax(s, dim=-1).reshape(b * kv, g, s_len)
    o = pv_f32(w.to(cv.dtype), cv.reshape(b * kv, s_len, d))
    return o.reshape(b, kv, g, d)


def _attn_decode(p, x, cache, pos, write, read, *, n_heads, n_kv, head_dim, rope_theta):
    """The decode step both cache layouts share: q/k/v of x (B, 1, D), rope
    at ``pos`` (0-d or (B,)), the new K/V (int8 codes and scales for an int8
    cache) handed to ``write(name, (B, KV, 1, ...))``, attention over
    ``read(name)`` (B, KV, S, ...) with keys past ``pos`` masked, then wo."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    if rope_theta:
        pvec = pos.reshape(-1, 1).expand(b, 1)
        q = apply_rope(q, pvec, rope_theta)
        k = apply_rope(k, pvec, rope_theta)
    k_t = k.transpose(1, 2)  # (B, KV, 1, D)
    v_t = v.transpose(1, 2)
    if "k_scale" in cache:
        k_codes, k_sc = _quant_kv(k_t)
        v_codes, v_sc = _quant_kv(v_t)
        for name, new in (("k", k_codes), ("v", v_codes), ("k_scale", k_sc),
                          ("v_scale", v_sc)):
            write(name, new)
        ck = _dequant_kv(read("k"), read("k_scale"), x.dtype)
        cv = _dequant_kv(read("v"), read("v_scale"), x.dtype)
    else:
        write("k", k_t)
        write("v", v_t)
        ck, cv = read("k"), read("v")
    o = decode_attention(q.reshape(b, n_kv, n_heads // n_kv, head_dim), ck, cv, pos)
    o = o.reshape(b, 1, n_heads * head_dim).to(x.dtype)
    return linear(o, p["wo"]), cache


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor, *,
                n_heads: int, n_kv: int, head_dim: int, rope_theta: float = 0.0):
    """One decode step of x (B, 1, D) at position ``pos``, a 0-d int64
    tensor on x's device (tokens already cached): write its K/V into slot
    ``pos`` of the cache (in place), attend over the whole store with
    positions past ``pos`` masked, accumulate in f32."""
    slot = pos.reshape(1)

    def write(name, new):
        cache[name].index_copy_(2, slot, new)
    return _attn_decode(p, x, cache, pos, write, cache.__getitem__, n_heads=n_heads,
                        n_kv=n_kv, head_dim=head_dim, rope_theta=rope_theta)


# ------------------------------------------------------------ paged cache ---
# The pool (P, KV, page_size, D) is ``kv_cache_init``'s layout with pages for
# rows and a page's tokens for positions; page 0 is the trash page of
# inactive slots.


def paged_kv_insert(pool: dict, dense: dict, pages: torch.Tensor, lead: int = 0) -> dict:
    """Scatter a batch-1 dense cache (filled by ``attn_prefill``) into pool
    pages ``pages`` (n,) int64, in place.  ``lead`` counts leading stack
    dims shared by both trees; the dense seq length must be ``n *
    page_size``."""
    n, ps = pages.shape[0], pool["k"].shape[lead + 2]
    for name, leaf in pool.items():
        d = dense[name].select(lead, 0)  # lead + (KV, n*ps, ...)
        d = d.reshape(d.shape[:lead + 1] + (n, ps) + d.shape[lead + 2:])
        leaf.index_copy_(lead, pages, d.movedim(lead + 1, lead).to(leaf.dtype))
    return pool


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """The slots' pages of one pool leaf (P, KV, ps, ...) in the dense
    head-major layout (B, KV, W*ps, ...), block tables (B, W) int64.  A
    transient: only the pool persists."""
    b, w = block_tables.shape
    g = pool[block_tables]  # (B, W, KV, ps, ...)
    return g.transpose(1, 2).reshape((b, g.shape[2], w * g.shape[3]) + g.shape[4:])


def attn_decode_paged(p: dict, x: torch.Tensor, cache: dict, block_tables: torch.Tensor,
                      pos: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
                      rope_theta: float = 0.0, page_size: int):
    """One decode step of x (B, 1, D) against the paged pool: slot b's new
    K/V go to page ``block_tables[b, pos[b] // page_size]`` at offset
    ``pos[b] % page_size`` (in place, ``index_put_``), then the slot's pages
    are gathered into the dense layout and attended with keys past its own
    position masked.  ``block_tables`` (B, W) and ``pos`` (B,) are int64
    tensors on x's device; nothing is read on the host."""
    page = block_tables.gather(1, (pos // page_size)[:, None])
    heads = torch.arange(n_kv, device=x.device)
    where = (page, heads[None, :], (pos % page_size)[:, None])  # (B, KV) rows of the pool

    def write(name, new):
        cache[name].index_put_(where, new[:, :, 0])

    def read(name):
        return gather_pages(cache[name], block_tables)
    return _attn_decode(p, x, cache, pos, write, read, n_heads=n_heads, n_kv=n_kv,
                        head_dim=head_dim, rope_theta=rope_theta)

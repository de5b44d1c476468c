"""GQA attention for the dense decode slice: prefill and decode with a cache.

Twin of the dense-cache parts of ``repro.models.attention``.  The cache is
head-major ``(B, KV, S, D)``, in the parameter dtype or as int8 codes with a
per-token f32 scale.  Unlike the JAX package, which returns a new cache,
``attn_prefill`` and ``attn_decode`` write the cache IN PLACE and return the
same dict: a decode step then copies nothing but the new token's K/V.
"""
from __future__ import annotations

import math

import torch

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
                 n_kv: int, head_dim: int, rope_theta: float = 0.0):
    """Full-sequence causal attention over the prompt x (B, S, D) that also
    writes all S prompt tokens' K/V into the cache (in place).  With an int8
    cache the prompt attends against the quantize->dequantize K/V, exactly
    what later decode steps read back."""
    b, s, _ = x.shape
    if s > CHUNKED_THRESHOLD:
        raise NotImplementedError(
            f"prefill over {s} > {CHUNKED_THRESHOLD} keys needs the chunked "
            "(online-softmax) attention, a later slice of the port (ROADMAP.md)")
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    if rope_theta:
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    k_t = k.transpose(1, 2)  # (B, KV, S, D) — the cache layout
    v_t = v.transpose(1, 2)
    if "k_scale" in cache:
        k_codes, k_sc = _quant_kv(k_t)
        v_codes, v_sc = _quant_kv(v_t)
        cache["k"][:, :, :s] = k_codes
        cache["v"][:, :, :s] = v_codes
        cache["k_scale"][:, :, :s] = k_sc
        cache["v_scale"][:, :, :s] = v_sc
        k = _dequant_kv(k_codes, k_sc, x.dtype).transpose(1, 2)
        v = _dequant_kv(v_codes, v_sc, x.dtype).transpose(1, 2)
    else:
        cache["k"][:, :, :s] = k_t
        cache["v"][:, :, :s] = v_t
    g = n_heads // n_kv
    o = _direct_attention(q.reshape(b, s, n_kv, g, head_dim), k, v, causal=True)
    return linear(o.reshape(b, s, n_heads * head_dim), p["wo"]), cache


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos: int, *,
                n_heads: int, n_kv: int, head_dim: int, rope_theta: float = 0.0):
    """One decode step of x (B, 1, D) at position ``pos`` (tokens already
    cached): write its K/V into the cache (in place), attend over the whole
    store with positions past ``pos`` masked, accumulate in f32."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    if rope_theta:
        pvec = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pvec, rope_theta)
        k = apply_rope(k, pvec, rope_theta)
    k_t = k.transpose(1, 2)  # (B, KV, 1, D)
    v_t = v.transpose(1, 2)
    if "k_scale" in cache:
        k_codes, k_sc = _quant_kv(k_t)
        v_codes, v_sc = _quant_kv(v_t)
        cache["k"][:, :, pos:pos + 1] = k_codes
        cache["v"][:, :, pos:pos + 1] = v_codes
        cache["k_scale"][:, :, pos:pos + 1] = k_sc
        cache["v_scale"][:, :, pos:pos + 1] = v_sc
        ck = _dequant_kv(cache["k"], cache["k_scale"], x.dtype)
        cv = _dequant_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"][:, :, pos:pos + 1] = k_t
        cache["v"][:, :, pos:pos + 1] = v_t
        ck, cv = cache["k"], cache["v"]
    g = n_heads // n_kv
    # Operands stay in the cache dtype; the products are summed in f32 (the
    # JAX package's preferred_element_type=f32).
    qg = q.reshape(b, 1, n_kv, g, head_dim).to(ck.dtype)
    s = torch.einsum("bqhgd,bhkd->bhgqk", qg.to(torch.float32), ck.to(torch.float32))
    s = s / math.sqrt(head_dim)
    valid = torch.arange(ck.shape[2], device=x.device) <= pos
    s = s.masked_fill(~valid, float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bqhgd", w.to(cv.dtype).to(torch.float32),
                     cv.to(torch.float32))
    o = o.reshape(b, 1, n_heads * head_dim).to(x.dtype)
    return linear(o, p["wo"]), cache

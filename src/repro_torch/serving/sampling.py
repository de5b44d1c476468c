"""Sampled decoding: counter-derived per-row keys and the temperature/top-k
warp (twin of the parts of ``repro.serving.sampling`` that ``generate``
needs).

The keys ARE the JAX package's keys.  ``jax.random``'s default generator is
threefry2x32, a pure function of 32-bit integers; it is written out here in
torch integer ops (int64 tensors holding values masked to 32 bits), with no
generator state.  A key is a (..., 2) int64 tensor of the two 32-bit words
of ``jax.random.PRNGKey``'s key data, and every draw is keyed by
``(base key, stream tag, row, draw index)`` through ``fold_in`` as in the
JAX package.  So a draw is a pure function of those integers: a CUDA graph
can replay it with the draw index in a device tensor, and the port's sampled
tokens can be held against the JAX package's token for token.

``sample_rows`` draws as ``jax.random.categorical`` does by default: 32
random bits per logit (the "partitionable" threefry counters, the default
of the JAX release the reference runs on), a uniform in [tiny, 1) from
their top 23 bits, gumbel noise ``-log(-log(u))``, and the argmax of noise
plus warped logits.
"""
from __future__ import annotations

import torch

TAG_TOKEN = 0   # plain per-token sampling stream
TAG_WINDOW = 1  # speculative verify-window stream

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000
_F32_MANTISSA = 23


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the counter pair (x1, x2) under the key
    (k1, k2): 20 rounds, a key injection after every 4.  Every argument
    holds 32-bit values in an int64 tensor (or a Python int); they
    broadcast.  Returns the two output words, masked to 32 bits."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def prng_key(seed, device=None) -> torch.Tensor:
    """The key data of ``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor.
    ``seed`` is an int (taken mod 2**32, as the JAX package takes it without
    64-bit mode) or the key data itself: any 2 integers, e.g. the uint32
    array ``PRNGKey`` returns."""
    if isinstance(seed, int):
        seed = (0, seed)
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([int(word) for word in seed])
    key = seed.to(device=device, dtype=torch.int64).reshape(-1)
    if key.numel() != 2:
        raise ValueError(f"a key is 2 words of key data, got {key.numel()}")
    return key & MASK32


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter (0, data) under
    ``key``.  key (..., 2); data an int or an integer tensor that broadcasts
    against key's leading dims.  Returns (..., 2) int64."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK32
    else:
        data = int(data) & MASK32
    return torch.stack(threefry2x32(key[..., 0], key[..., 1], 0, data), dim=-1)


def row_keys(base: torch.Tensor, rids: torch.Tensor, tag: int) -> torch.Tensor:
    """The draw-independent part of ``draw_keys``:
    ``fold_in(fold_in(base, tag), rid)`` per row, (B, 2)."""
    return fold_in(fold_in(base, tag), rids)


def draw_keys(base: torch.Tensor, rids: torch.Tensor, idx, tag: int) -> torch.Tensor:
    """Per-row keys for draw ``idx`` of stream ``tag``:
    ``fold_in(fold_in(fold_in(base, tag), rid), idx)`` per row.  ``rids``
    (B,) request ids; ``idx`` an int, a 0-d tensor or (B,) per-row draw
    counters.  Returns (B, 2) int64."""
    return fold_in(row_keys(base, rids, tag), idx)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` for each row's key: the hash of the
    counters (0, j), j < n, its two words xor-ed.  keys (B, 2) -> (B, n)
    int64 holding 32-bit values."""
    j = torch.arange(n, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[:, :1], keys[:, 1:], 0, j)
    return y1 ^ y2


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in f32 for each row's key: the top
    23 random bits as the mantissa of a float in [1, 2), minus 1.  (B, n)
    f32 in [0, 1)."""
    bits = (random_bits(keys, n) >> (32 - _F32_MANTISSA)) | _F32_ONE_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` in its default ("low") mode for each
    row's key: ``-log(-log(u))`` with u = max(tiny, uniform + tiny), JAX's
    uniform in [tiny, 1) (its span, 1 - tiny, is 1 in f32).  (B, n) f32."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp_min(uniform(keys, n) + tiny, tiny)
    return -torch.log(-torch.log(u))


def warp_logits(logits: torch.Tensor, temperature, top_k: int) -> torch.Tensor:
    """Temperature/top-k warped logits (f32, last axis = vocab): the logits
    over max(temperature, 1e-6), every logit under the k-th largest set to
    -inf (ties with it kept); ``top_k`` of 0, or of the vocabulary or more,
    keeps them all.  ``temperature`` is a float or a 0-d tensor on the
    logits' device."""
    t = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    lg = logits.to(torch.float32) / torch.clamp_min(t, 1e-6)
    top_k = min(top_k, lg.shape[-1])
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    return lg


def sample_rows(logits: torch.Tensor, keys, *, greedy: bool, temperature,
                top_k: int) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 tokens, one independent key per row
    (``keys`` (B, 2) from ``draw_keys``; ignored when greedy): the argmax of
    the logits, or of gumbel noise plus the warped logits (the first
    index among equals, as in JAX)."""
    if greedy:
        return logits.argmax(dim=-1).to(torch.int32)
    lg = warp_logits(logits, temperature, top_k)
    return (gumbel(keys, lg.shape[-1]) + lg).argmax(dim=-1).to(torch.int32)

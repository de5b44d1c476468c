"""Sampled decoding: counter-derived per-row keys, the temperature/top-k
warp, and the rejection-sampling verification of a speculative window, a
linear one or a tree of candidate chains (twin of ``repro.serving.sampling``).

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
plus warped logits.  ``split`` is ``jax.random.split`` on the same
counters: the key of part i is the hash of the counter (0, i), which is
``fold_in(key, i)``.

Verification (``acceptance_probs``, ``residual_dist``, ``rejection_sample``,
``typical_accept_sample``, ``tree_reject_sample``) works on whole batches of
static shape, so a
captured window replays it: every row's uniforms and its final categorical
draw come from its window key, as each row of the JAX package's ``vmap``
draws them.
"""
from __future__ import annotations

from typing import Optional

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


def split(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.split(key)`` for each row's key (threefry in JAX's
    partitionable mode, its default): part i is the hash of the counter
    (0, i), i.e. ``fold_in(key, i)``.  keys (..., 2) -> two (..., 2)."""
    return fold_in(keys, 0), fold_in(keys, 1)


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` for each row: the argmax of
    gumbel noise plus the (B, V) logits (-inf never drawn; the first index
    among equals).  Returns (B,) int32."""
    return (gumbel(keys, logits.shape[-1]) + logits).argmax(dim=-1).to(torch.int32)


def _take(dist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """dist (B, k, V) at idx (B, k): (B, k)."""
    return dist.gather(-1, idx.to(torch.int64)[..., None])[..., 0]


def _row(dist: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """dist (B, n, V) at per-row position j (B,): (B, V)."""
    return dist.gather(1, j.to(torch.int64)[:, None, None].expand(-1, 1, dist.shape[-1]))[:, 0]


def acceptance_probs(drafts: torch.Tensor, q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``min(1, p(d)/q(d))`` per proposal, (B, k) in [0, 1].  drafts (B, k);
    q (B, k, V) the proposals' distributions; p (B, k+1, V) the target's
    (position k, the bonus position, unused).  Where q(d) is 0 the ratio is
    1 if p(d) > 0 else 0."""
    k = drafts.shape[1]
    qd, pd = _take(q, drafts), _take(p[:, :k], drafts)
    return torch.where(qd > 0.0, torch.clamp_max(pd / torch.clamp_min(qd, 1e-38), 1.0),
                       (pd > 0.0).to(torch.float32))


def residual_dist(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The normalised rejection residual ``max(p - q, 0)`` over the last axis;
    ``p`` itself where the residual has no mass (p == q)."""
    r = torch.clamp_min(p - q, 0.0)
    s = r.sum(dim=-1, keepdim=True)
    return torch.where(s > 0.0, r / torch.clamp_min(s, 1e-38), p)


def _kcap(kcap, b: int, k: int, device) -> torch.Tensor:
    if kcap is None:
        return torch.full((b,), k, dtype=torch.int64, device=device)
    return kcap.to(torch.int64)


def _emitted(drafts: torch.Tensor, a: torch.Tensor, final: torch.Tensor) -> torch.Tensor:
    """(B, k+1): the first ``a`` proposals, then the final draw repeated."""
    k = drafts.shape[1]
    padded = torch.cat([drafts, drafts[:, -1:]], dim=1)
    at = torch.arange(k + 1, device=drafts.device)[None] < a[:, None]
    return torch.where(at, padded, final[:, None]).to(torch.int32)


def rejection_sample(keys: torch.Tensor, drafts: torch.Tensor, q: torch.Tensor,
                     p: torch.Tensor, *, kcap: Optional[torch.Tensor] = None,
                     n_draws: Optional[int] = None):
    """Rejection-sampling verification of a window of proposals, each row on
    its own window key (``keys`` (B, 2)).  ``drafts`` (B, k); ``q`` (B, k, V)
    the distributions they came from (one-hot for a deterministic
    proposer); ``p`` (B, k+1, V) the target's warped distributions.
    Proposal i is accepted when ``u_i * q(d_i) < p(d_i)``, u_i the i-th of
    ``n_draws`` (static, >= k; default k) uniforms of the first half of the
    row key, so a row's uniforms do not depend on k; ``kcap`` (B,) forces a
    rejection at and past each row's cap.  The first rejection is redrawn
    from the residual at its position, full acceptance draws the bonus from
    ``p[kcap]``: a categorical on the key's second half.  Returns (tokens
    (B, k+1) int32, a (B,) int64): the row emits ``tokens[:, :a+1]``."""
    b, k = drafts.shape
    nd = k if n_draws is None else int(n_draws)
    kc = _kcap(kcap, b, k, drafts.device)
    q, p = q.to(torch.float32), p.to(torch.float32)
    ku, kf = split(keys)
    u = uniform(ku, nd)[:, :k]
    at = torch.arange(k, device=drafts.device)[None]
    acc = ((u * _take(q, drafts) < _take(p[:, :k], drafts)) & (at < kc[:, None]))
    a = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)
    j = torch.clamp(torch.minimum(a, kc - 1), 0, k - 1)  # the residual's position
    dist = torch.where((a == kc)[:, None], _row(p, torch.clamp_max(kc, k)),
                       residual_dist(_row(p, j), _row(q, j)))
    return _emitted(drafts, a, categorical(kf, torch.log(dist))), a


def typical_accept_sample(keys: torch.Tensor, drafts: torch.Tensor, p: torch.Tensor, *,
                          kcap: Optional[torch.Tensor] = None, eps: float = 0.3,
                          delta: float = 0.09):
    """Typical (entropy-band) acceptance, the lossy mode: proposal i is
    accepted iff ``p_i(d_i) > min(eps, delta * exp(-H(p_i)))``; the token
    after the accepted prefix is drawn from ``p[a]`` with the second half of
    the row key.  Layout and ``kcap`` as ``rejection_sample``'s."""
    b, k = drafts.shape
    kc = _kcap(kcap, b, k, drafts.device)
    p = p.to(torch.float32)
    _, kf = split(keys)
    pk = p[:, :k]
    ent = -torch.xlogy(pk, pk).sum(dim=-1)
    thr = torch.clamp_max(delta * torch.exp(-ent), eps)
    at = torch.arange(k, device=drafts.device)[None]
    acc = (_take(pk, drafts) > thr) & (at < kc[:, None])
    a = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)
    return _emitted(drafts, a, categorical(kf, torch.log(_row(p, a)))), a


def tree_reject_sample(keys: torch.Tensor, chains: torch.Tensor, p_nodes: torch.Tensor, *,
                       kcap: Optional[torch.Tensor] = None):
    """Exact rejection-sampling verification of a tree window of point-mass
    proposals (the n-gram proposer's chains), each row on its own window key
    (``keys`` (B, 2)).  ``chains`` (B, F, D): chain f's step i is node ``1 +
    f*D + i`` of the window, node 0 the current token; ``p_nodes`` (B, 1 +
    F*D, V) the target's warped distributions in node order.

    The chains' heads are tried in order at the root: head f is accepted
    when its uniform is below its mass in the current root distribution,
    which, on a rejection, loses the head's mass and is renormalised in
    f32 (a duplicate head is rejected: its mass is gone).  The first
    accepted head picks its chain, whose later steps are verified as
    ``rejection_sample`` verifies a window; a rejection draws from that
    node's residual (its distribution without the rejected token), full
    acceptance the bonus from the last accepted node's distribution, and
    no accepted head from the root's residual.  The output is distributed
    as plain sampling from ``p`` is.  ``kcap`` (B,) caps each row's
    accepted depth (0: a plain draw from the root).  The draws are fixed in
    shape, the key's first half giving ``F + D - 1`` uniforms (heads, then
    steps 2..D), its second half one categorical, so a row's stream does
    not depend on its cap.  Returns (tokens (B, D+1) int32, a (B,) int64,
    cf (B,) int64, the kept chain, 0 where nothing was accepted): the row
    emits ``tokens[:, :a+1]``."""
    b, nf, nd = chains.shape
    dev = chains.device
    kc = _kcap(kcap, b, nd, dev)
    p = p_nodes.to(torch.float32)
    ch = chains.to(torch.int64)
    ku, kf = split(keys)
    u = uniform(ku, max(nf + nd - 1, nf))  # its prefix is the reference's (F + D - 1,) draw
    uh, uc = u[:, :nf], u[:, nf:nf + nd - 1]
    p_cur = p[:, 0]
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    cf = torch.zeros((b,), dtype=torch.int64, device=dev)
    for f in range(nf):
        h = ch[:, f, :1]
        tried = ~done & (kc >= 1)
        acc = tried & (uh[:, f] < p_cur.gather(1, h)[:, 0])
        pz = p_cur.scatter(1, h, 0.0)
        s = pz.sum(dim=-1, keepdim=True)
        p_rej = torch.where(s > 0.0, pz / torch.clamp_min(s, 1e-38), p_cur)
        p_cur = torch.where((tried & ~acc)[:, None], p_rej, p_cur)
        cf = torch.where(acc, f, cf)
        done = done | acc
    rows = torch.arange(b, device=dev)[:, None]
    chain = ch.gather(1, cf[:, None, None].expand(b, 1, nd))[:, 0]  # (B, D)
    base = 1 + cf * nd
    # the chain's step j (j = 2..D) is verified against node base + j - 2
    j = torch.arange(2, nd + 1, device=dev)[None]
    pdj = p[rows, base[:, None] + j - 2, chain[:, 1:]]  # (B, D-1)
    accj = ((uc < pdj) & (j <= kc[:, None])).to(torch.int64)
    a = torch.where(done, 1 + torch.cumprod(accj, dim=1).sum(dim=1), 0)
    cap = torch.clamp_max(kc, nd)
    last = _row(p, torch.clamp(base + a - 1, 0, p.shape[1] - 1))
    rejected = chain.gather(1, a.clamp(0, nd - 1)[:, None])
    onehot = torch.zeros_like(last).scatter_(1, rejected, 1.0)
    dist = torch.where((a == 0)[:, None], p_cur,
                       torch.where((a == cap)[:, None], last, residual_dist(last, onehot)))
    return _emitted(chain, a, categorical(kf, torch.log(dist))), a, cf

"""Speculative multi-token decode: one weight stream per verify window of
``k + 1`` tokens, which emits the accepted proposals and one more token
(twin of ``repro.serving.speculative``).

Proposals come from the n-gram proposer or from a draft model.  The n-gram
proposer matches the trailing ``ngram_n`` tokens of a row's history (prompt
and every emission) against its earlier positions and proposes the ``k``
tokens that followed the most recent match, else repeats the last token.  A
draft model (``draft_propose``) runs ``k + 1`` single-token steps on a cache
of its own, dense on the fixed engine and paged on the continuous one (its
pool shares the target's block tables), proposing its argmax or, sampled, a
draw from its warped distribution, whose probabilities go to the rejection
sampler.  The target runs the window once (``models.verify_step``) and
accepts, per row, the longest prefix of proposals its greedy argmax agrees
with (``greedy_accept``), or, sampled, by rejection sampling against its
warped distribution (``sampling.rejection_sample``, exact) or by the entropy
band (``sampling.typical_accept_sample``, lossy).  Greedy speculation emits
the tokens plain greedy decoding does, whatever the proposer.

Tree drafts (``SpecConfig(tree_fan=F)``, n-gram proposals, exact
acceptance) verify ``F`` candidate chains of depth ``k`` that share the
current token in one window of ``1 + F*k`` nodes (``propose_ngram_tree``;
``models.verify_step(tree=(F, k))``'s shared-prefix mask).  The window
keeps one chain: greedy, the longest matching prefix over the chains
(``greedy_tree_accept``); sampled, sequential elimination of the chains'
heads and then the chosen chain's rejection sampling
(``sampling.tree_reject_sample``, exact).  ``models.tree_relocate`` then
moves the kept chain's K/V from its tree columns to the linear ones, so a
dense store carries ``F*k`` columns past ``max_seq``, and a paged one
provisions them.

The adaptive controller keeps a per-row acceptance EMA: the fixed engine
caps acceptance at ``_ctrl_k``'s width of the EMA inside each window (the
window stays ``k`` wide), the continuous engine re-picks the round's width
from the EMA on the host (``adaptive_k_host``) and runs its width-0 rounds
as plain decode chunks, probing host-side (``propose_first_host``).

Every ported family speculates: a vlm or encdec window, the draft model's
steps included, reads the rows' (or slots') ``extras``, the static buffers
their engine holds; a moe window routes each row's tokens as one dispatch
group; an ssm window runs each row's recurrence step by step from its state
and returns every step's state (a tree window runs each chain from a copy
of the row's state), and the commit writes the kept step into the live
state in place.  The caches are built, zeroed and relocated over every
stack of ``models.lm.cache_stacks``, K/V, MLA latents or per-row state
(``models.lm.stack_layout``; a state stack has no columns to widen or
relocate).  Every commit takes the cache the window returned
(``verify_step``'s, or a draft chain's ``stack_verify_caches``), which
holds the per-step states.

Everything here runs on tensors of static shape: a window never reads a
value of the device on the host, so on the card each window, the draft
model's steps included, is one replay of a captured program.
``spec_window`` is one iteration of the JAX package's fixed-engine loop
(``_spec_generate_body``) on ``SpecState``'s buffers, ``spec_chunk_step``
one iteration of its continuous-engine scan (``_spec_chunk_body``) on
``ChunkState``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import (commit_verify, init_cache, prefill, stack_verify_caches,
                                 tree_relocate, verify_step)
from repro_torch.models.attention import tree_tensors
from repro_torch.models.lm import cache_stacks, check_family, seq_axis, stack_layout

from .sampling import (TAG_TOKEN, TAG_WINDOW, categorical, fold_in, prng_key, rejection_sample,
                       row_keys, sample_rows, split, tree_reject_sample, typical_accept_sample,
                       warp_logits)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Static speculation settings (hashable: a captured window is kept per
    config).  ``k`` proposals a window (the window is ``k + 1`` wide);
    ``mode`` "ngram" or "draft"; ``ngram_n`` the proposer's match length;
    ``adaptive`` the acceptance-EMA controller with coefficient
    ``ctrl_alpha``, initial estimate ``ctrl_init`` and modelled cost
    ``ctrl_cost`` of one more window position relative to a decode step;
    ``tree_fan`` > 0 tree drafts; ``accept`` "exact" (rejection sampling)
    or "typical" (entropy band ``typical_eps``/``typical_delta``, lossy).
    Tree drafts take the n-gram proposer and exact acceptance, and no
    adaptive controller."""

    k: int = 4
    mode: str = "ngram"
    ngram_n: int = 2
    adaptive: bool = False
    ctrl_alpha: float = 0.5
    ctrl_init: float = 0.0
    ctrl_cost: float = 0.18
    tree_fan: int = 0
    accept: str = "exact"
    typical_eps: float = 0.3
    typical_delta: float = 0.09

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculation needs k >= 1, got {self.k}")
        if self.mode not in ("ngram", "draft"):
            raise ValueError(f"mode must be ngram|draft, got {self.mode!r}")
        if self.ngram_n < 1:
            raise ValueError(f"ngram_n must be >= 1, got {self.ngram_n}")
        if self.accept not in ("exact", "typical"):
            raise ValueError(f"accept must be exact|typical, got {self.accept!r}")
        if self.tree_fan < 0:
            raise ValueError(f"tree_fan must be >= 0, got {self.tree_fan}")
        if self.tree_fan:
            if self.mode != "ngram":
                raise ValueError("tree drafts need mode='ngram' (the draft model proposes "
                                 "one chain)")
            if self.adaptive:
                raise ValueError("tree_fan and adaptive are exclusive (the controller "
                                 "schedules linear windows)")
            if self.accept != "exact":
                raise ValueError("tree verification is exact rejection sampling; "
                                 "accept='typical' is linear-only")
        if not 0.0 < self.ctrl_alpha <= 1.0:
            raise ValueError(f"ctrl_alpha in (0, 1], got {self.ctrl_alpha}")
        if self.ctrl_cost <= 0.0:
            raise ValueError(f"ctrl_cost must be > 0, got {self.ctrl_cost}")


def as_spec(speculate, cfg: ModelConfig,
            draft_cfg: Optional[ModelConfig] = None) -> Optional[SpecConfig]:
    """An engine's ``speculate=``: a SpecConfig, or an int ``k``; None, no
    speculation.  Raises NotImplementedError where ``cfg``'s family, or,
    when the windows take a draft model, ``draft_cfg``'s, has no verify
    window: every ported family has one (``models.lm.check_family``)."""
    if speculate is None:
        return None
    spec = speculate if isinstance(speculate, SpecConfig) else SpecConfig(k=int(speculate))
    check_family(cfg)
    if spec.mode == "draft" and draft_cfg is not None:
        check_family(draft_cfg)
    return spec


# -------------------------------------------------------------- controller --
def ctrl_buckets(k: int) -> tuple:
    """The candidate window widths {0, 1, 2, 4, ..., k}."""
    bs, b = [0], 1
    while b < k:
        bs.append(b)
        b *= 2
    bs.append(k)
    return tuple(dict.fromkeys(bs))


def _ctrl_gain(e, b: int):
    """Expected tokens of a width-``b`` window at per-draft acceptance ``e``:
    ``1 + e + ... + e^b`` (numpy or torch)."""
    g, p = 1.0 + 0.0 * e, 1.0 + 0.0 * e
    for _ in range(b):
        p = p * e
        g = g + p
    return g


def adaptive_k_host(ema: np.ndarray, live: np.ndarray, spec: SpecConfig) -> int:
    """The round's width: the bucket that maximises the live slots' expected
    tokens over the window's cost; ties, and an empty batch, give the
    smaller width."""
    if not bool(np.any(live)):
        return 0
    e = np.clip(ema[live].astype(np.float64), 0.0, 1.0)
    best_s, best_b = -1.0, 0
    for b in ctrl_buckets(spec.k):
        s = float(np.sum(_ctrl_gain(e, b))) / (1.0 + spec.ctrl_cost * b)
        if s > best_s + 1e-12:
            best_s, best_b = s, b
    return best_b


def _ctrl_k(ema: torch.Tensor, live: torch.Tensor, k: int, cost: float) -> torch.Tensor:
    """Device twin of ``adaptive_k_host`` in f32, a 0-d int64 tensor (the
    first maximum: the smaller width on ties)."""
    e = torch.where(live, ema.clamp(0.0, 1.0), 0.0)
    buckets = ctrl_buckets(k)
    scores = torch.stack([torch.where(live, _ctrl_gain(e, b), 0.0).sum() / (1.0 + cost * b)
                          for b in buckets])
    widths = torch.stack([torch.full((), b, dtype=torch.int64, device=ema.device)
                          for b in buckets])
    return widths.index_select(0, scores.argmax().reshape(1)).reshape(())


def _ctrl_probe(lg0: torch.Tensor, d1: torch.Tensor, *, greedy: bool, temperature,
                top_k: int) -> torch.Tensor:
    """The chance the would-be first proposal ``d1`` is accepted, from the
    window's first logits (B, V): argmax agreement, or ``p_0(d1)``."""
    if greedy:
        return (lg0.argmax(dim=-1) == d1).to(torch.float32)
    p0 = torch.softmax(warp_logits(lg0, temperature, top_k), dim=-1)
    return p0.gather(1, d1.to(torch.int64)[:, None])[:, 0]


def _ctrl_update(ema, live, a, k_window, phat0, alpha: float) -> torch.Tensor:
    """One EMA step: ``a / (a + 1)`` accepted of a real window (1 when all
    were), the probe at width 0; done rows keep theirs."""
    af = a.to(torch.float32)
    r = torch.where(a >= k_window, 1.0, af / (af + 1.0))
    if isinstance(k_window, torch.Tensor):
        r = torch.where(k_window == 0, phat0, r)
    elif k_window == 0:
        r = phat0
    return torch.where(live, (1.0 - alpha) * ema + alpha * r, ema)


# ---------------------------------------------------------------- proposer --
def _ngram_matches(hist: torch.Tensor, hlen: torch.Tensor, fan: int, n: int):
    """Starts of the ``fan`` most recent earlier occurrences of each row's
    trailing ``n``-gram in ``hist`` (B, W) of live length ``hlen`` (B,),
    most recent first, -1 past the last (B, fan); and the last live token
    (B, 1)."""
    b, w = hist.shape
    ar = torch.arange(w, device=hist.device)
    gi = hlen[:, None] - n + ar[:n]
    gram = hist.gather(1, gi.clamp(0, w - 1))
    match = torch.ones((b, w), dtype=torch.bool, device=hist.device)
    for i in range(n):
        # the window starting at q sees hist[q + i]; past the end, no match
        shifted = torch.cat([hist[:, i:], torch.full_like(hist[:, :i], -1)], dim=1)
        match = match & (shifted == gram[:, i:i + 1])
    q = ar[None]
    valid = match & (q <= hlen[:, None] - n - 1)  # strictly earlier windows
    j = torch.where(valid, q, -1).topk(fan, dim=1).values
    last = hist.gather(1, (hlen - 1).clamp(0, w - 1)[:, None])
    return j, last


def propose_ngram(hist: torch.Tensor, hlen: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Prompt-lookup proposals (B, k) int32: the ``k`` tokens after the most
    recent earlier occurrence of each row's trailing ``n``-gram; positions
    past the live end, and rows without a match, repeat the last token."""
    return propose_ngram_tree(hist, hlen, 1, k, n)[:, 0]


def propose_ngram_tree(hist: torch.Tensor, hlen: torch.Tensor, fan: int, depth: int,
                       n: int) -> torch.Tensor:
    """Prompt-lookup chains (B, fan, depth) int32: chain f holds the
    ``depth`` tokens after the f-th most recent earlier occurrence of each
    row's trailing ``n``-gram, so chain 0 is ``propose_ngram``'s proposal;
    positions past the live end, and chains without a match, repeat the
    last token."""
    w = hist.shape[1]
    hlen = hlen.to(torch.int64)
    j, last = _ngram_matches(hist, hlen, fan, n)
    src = j[:, :, None] + n + torch.arange(depth, device=hist.device)  # (B, F, D)
    prop = hist.gather(1, src.clamp(0, w - 1).reshape(-1, fan * depth)).reshape(src.shape)
    use = (j >= 0)[:, :, None] & (src < hlen[:, None, None])
    return torch.where(use, prop, last[:, :, None]).to(torch.int32)


def propose_first_host(hist_row: np.ndarray, hlen: int, n: int) -> int:
    """Host twin of ``propose_ngram``'s first proposal for one row: the
    token after the most recent earlier occurrence of the trailing
    ``n``-gram, else the last token."""
    if hlen >= n + 1:
        h = hist_row[:hlen]
        gram = h[hlen - n:]
        win = np.lib.stride_tricks.sliding_window_view(h, n)
        hits = np.nonzero((win[: hlen - n] == gram).all(axis=1))[0]
        if hits.size:
            return int(h[hits[-1] + n])
    return int(hist_row[max(hlen - 1, 0)])


def draft_propose(draft_params, draft_cfg: ModelConfig, dcache: dict, tok: torch.Tensor,
                  pos: torch.Tensor, k: int, *, wkeys=None, greedy: bool = True, temperature=1.0,
                  top_k: int = 0, extras: Optional[dict] = None):
    """A draft model's proposals (the JAX package's ``_draft_propose``):
    ``k + 1`` single-token ``verify_step``s at ``pos + i`` on the draft's
    cache ``dcache`` consume the whole window ``[tok, d_1 .. d_k]`` (the
    last step eats ``d_k``, so every accepted length leaves the cache a
    state).  Greedy, each proposal is the draft's argmax; sampled, a draw
    from its warped distribution with the row's window key folded with
    ``3 + i``, whose probabilities are returned.  ``dcache`` is dense (the
    fixed engine) or paged (the continuous engine, through its block
    tables at per-slot positions ``pos`` (B,)); ``k == 0`` still runs the
    step that consumes ``tok``.  The draft reads the target's ``extras``
    (a vlm or encdec draft attends to the rows' memory; a dense one ignores
    them).  Reads nothing on the host.  Returns
    (drafts (B, k) int32, q (B, k, V) f32 or None when greedy, the chain's
    cache for ``commit_verify``)."""
    b = tok.shape[0]
    zero = torch.zeros((b,), dtype=torch.int64, device=tok.device)
    dc, t, ds, qs, vcs = dcache, tok, [], [], []
    for i in range(k + 1):
        lg, vc = verify_step(draft_params, draft_cfg, t, dc, pos + i, extras)
        vcs.append(vc)
        dc = commit_verify(draft_cfg, vc, zero)
        if i < k:
            last = lg[:, -1]
            if greedy:
                t = last.argmax(dim=-1).to(torch.int32)[:, None]
            else:
                wl = warp_logits(last, temperature, top_k)
                t = categorical(fold_in(wkeys, 3 + i), wl)[:, None]
                qs.append(torch.softmax(wl, dim=-1))
            ds.append(t)
    drafts = (torch.cat(ds, dim=1) if ds
              else torch.zeros((b, 0), dtype=torch.int32, device=tok.device))
    return (drafts, torch.stack(qs, dim=1) if qs else None,
            stack_verify_caches(draft_cfg, vcs))


# -------------------------------------------------------------- acceptance --
def greedy_accept(window: torch.Tensor, logits: torch.Tensor):
    """Longest matching prefix: ``window`` (B, k+1) the current token and k
    proposals, ``logits`` (B, k+1, V).  Returns (g (B, k+1) int32, the
    target's argmax after each window prefix; a (B,) int64, the accepted
    proposals): the row emits ``g[:, :a+1]``."""
    g = logits.argmax(dim=-1).to(torch.int32)
    match = (window[:, 1:] == g[:, :-1]).to(torch.int64)
    return g, torch.cumprod(match, dim=1).sum(dim=1)


def greedy_tree_accept(chains: torch.Tensor, logits: torch.Tensor, *,
                       kcap: Optional[torch.Tensor] = None):
    """Greedy acceptance of a tree window: per chain, the longest prefix whose
    tokens are the argmax at their predecessor node; the window keeps the
    chain of the longest (ties: the lowest index, the linear proposer's),
    at most ``kcap`` (B,) long.  ``chains`` (B, F, D); ``logits`` (B, 1 +
    F*D, V) in node order.  Returns (tokens (B, D+1) int32, a (B,) int64,
    cf (B,) int64), laid out as ``sampling.tree_reject_sample``'s: the row
    emits ``tokens[:, :a+1]``, the accepted proposals and the argmax at the
    deepest accepted node."""
    b, fan, depth = chains.shape
    g = logits.argmax(dim=-1)  # (B, 1+F*D)
    _, _, pred = tree_tensors(fan, depth, chains.device)
    match = (chains.to(torch.int64) == g[:, pred]).to(torch.int64)  # (B, F, D)
    af = torch.cumprod(match, dim=2).sum(dim=2)  # (B, F)
    if kcap is not None:
        af = torch.minimum(af, kcap.to(torch.int64)[:, None])
    a, cf = af.max(dim=1).values, af.argmax(dim=1)
    ch = chains.gather(1, cf[:, None, None].expand(b, 1, depth))[:, 0]  # (B, D)
    last = torch.where(a > 0, cf * depth + a, 0)
    bonus = g.gather(1, last[:, None]).to(torch.int32)
    padded = torch.cat([ch, ch[:, -1:]], dim=1)
    at = torch.arange(depth + 1, device=chains.device)[None] < a[:, None]
    return torch.where(at, padded, bonus), a, cf


def _accept(window, drafts, lg, *, greedy: bool, temperature, top_k: int, wkeys, q=None,
            kcap=None, n_draws=None, accept: str = "exact", typical_eps: float = 0.3,
            typical_delta: float = 0.09):
    """One linear window's verification: greedy, rejection-sampled or
    typical.  ``q`` (B, k, V) is the proposals' distribution (a draft
    model's), None for the n-gram proposer's point masses.  Returns (g, a),
    the row emitting ``g[:, :a+1]``.  ``kcap``/``n_draws``: the fixed
    engine's adaptive cap (the window stays ``k`` wide).  A width-0 window
    is one plain draw on the window key's second half."""
    if greedy:
        g, a = greedy_accept(window, lg)
        return g, a if kcap is None else torch.minimum(a, kcap)
    if drafts.shape[1] == 0:
        _, kf = split(wkeys)
        t0 = categorical(kf, warp_logits(lg[:, 0], temperature, top_k))
        return t0[:, None], torch.zeros(lg.shape[0], dtype=torch.int64, device=lg.device)
    p = torch.softmax(warp_logits(lg, temperature, top_k), dim=-1)
    if accept == "typical":
        return typical_accept_sample(wkeys, drafts, p, kcap=kcap, eps=typical_eps,
                                     delta=typical_delta)
    if q is None:
        q = torch.zeros(drafts.shape + (lg.shape[-1],), dtype=torch.float32, device=lg.device)
        q.scatter_(2, drafts.to(torch.int64)[..., None], 1.0)
    return rejection_sample(wkeys, drafts, q, p, kcap=kcap, n_draws=n_draws)


def _verify_kw(spec: SpecConfig) -> dict:
    return dict(accept=spec.accept, typical_eps=spec.typical_eps,
                typical_delta=spec.typical_delta)


def _last_emitted(g: torch.Tensor, m: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Each row's new current token: ``g[m - 1]``, or ``tok`` where m is 0."""
    at = torch.clamp_min(m - 1, 0)[:, None]
    return torch.where((m > 0)[:, None], g.gather(1, at), tok)


# ---------------------------------------------------------- the fixed engine --
class SpecState:
    """The static buffers of one batch's speculative generation of model
    ``cfg``: the dense cache (shared with the batch's ``DecodeState``, whose
    extras buffers the windows read too), the current token
    (B, 1) int32, the emitted count, window counter (B,) int64 and
    acceptance EMA (B,) f32, each row's window-stream key (B, 2), the
    temperature, the history and the output (B, max_seq + 1) int32 (column
    max_seq takes the writes the reference drops), and the prompt length,
    the token budget and the window counts: int64 views of ``ints``.  With
    a draft model (``draft_cfg``), its dense cache for windows of ``k``
    proposals (``draft_cache(k)``): ``max_seq + k`` positions, so that the
    chain's read-back of the positions it writes past the last token stays
    inside the store.  Tree windows of ``fan`` > 1 chains of depth ``k``
    run on a dense cache of their own (``tree_cache(fan, k)``): ``max_seq +
    fan*k`` positions, so that the relocation's gathers from the tree
    columns past the last token stay inside the store; its state stacks
    are the batch's own."""

    def __init__(self, cfg: ModelConfig, batch: int, max_seq: int, cache: dict, device,
                 draft_cfg: Optional[ModelConfig] = None):
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.cfg = cfg
        self.max_seq = max_seq
        self.cache = cache
        self.draft_cfg = draft_cfg
        self._dcaches: dict[int, dict] = {}
        self._tcaches: dict[tuple, dict] = {}
        self.tok = zeros((batch, 1), torch.int32)
        self.n_em = zeros((batch,), torch.int64)
        self.wctr = zeros((batch,), torch.int64)
        self.ema = zeros((batch,), torch.float32)
        self.wkeys = zeros((batch, 2), torch.int64)
        self.temperature = zeros((), torch.float32)
        self.hist = zeros((batch, max_seq + 1), torch.int32)
        self.out = zeros((batch, max_seq + 1), torch.int32)
        self.ints = zeros((4,), torch.int64)
        self.s, self.n_new, self.steps, self.live_steps = (self.ints[i] for i in range(4))

    def draft_cache(self, k: int) -> dict:
        """The draft model's cache for windows of ``k`` proposals (made at
        first use and kept: a captured window reads it)."""
        if k not in self._dcaches:
            self._dcaches[k] = init_cache(self.draft_cfg, self.tok.shape[0], self.max_seq + k,
                                          self.tok.device)
        return self._dcaches[k]

    def tree_cache(self, fan: int, k: int) -> dict:
        """The target's cache for tree windows of ``fan`` chains of depth
        ``k`` (made at first use and kept: a captured window reads it).  A
        one-chain tree is the linear window, whose relocation is the
        identity and gathers nothing past the window: it runs on the
        batch's own cache, so it is linear speculation bit for bit.  A state
        stack has no sequence axis: the tree cache shares the batch's."""
        if fan == 1:
            return self.cache
        if (fan, k) not in self._tcaches:
            # every stack, its leaves' sequence axis (``seq_axis`` after the lead
            # dims) widened
            self._tcaches[fan, k] = {}
            for key, lead in cache_stacks(self.cfg):
                if stack_layout(self.cfg, key) == "state":
                    self._tcaches[fan, k][key] = self.cache[key]
                    continue
                ax = len(lead) + seq_axis(self.cfg, key)
                self._tcaches[fan, k][key] = {
                    name: torch.zeros(leaf.shape[:ax] + (self.max_seq + fan * k,)
                                      + leaf.shape[ax + 1:], dtype=leaf.dtype, device=leaf.device)
                    for name, leaf in self.cache[key].items()}
        return self._tcaches[fan, k]

    def reset(self) -> None:
        """A state a window may run from (the capture's warm-up): one prompt
        token, nothing left to emit."""
        self.ints.zero_()
        self.s.fill_(1)
        self.n_em.fill_(1)

    def start(self, params, prompt: torch.Tensor, key, temperature,
              n_new: int, *, greedy: bool, top_k: int, ctrl_init: float, draft_params=None,
              k: int = 0, tree_fan: int = 0, extras: Optional[dict] = None) -> None:
        """Zero the cache, prefill ``prompt`` (B, S) with the batch's
        ``extras`` (the static buffers the windows read, already written)
        and draw token 0 from its last logits (``draw_keys(key, row, 0,
        TAG_TOKEN)``), as plain ``generate`` does; then the history is the
        prompt and token 0.  With ``draft_params``, zero the draft's cache
        for ``k`` proposals and prefill the prompt into it too, with the
        same extras.  With ``tree_fan``, the cache is ``tree_cache(tree_fan,
        k)``.  Every stack of ``cache_stacks`` is zeroed."""
        cache = self.tree_cache(tree_fan, k) if tree_fan else self.cache
        _zero_stacks(self.cfg, cache)
        logits, _ = prefill(params, self.cfg, prompt, cache, extras)
        if draft_params is not None:
            dcache = self.draft_cache(k)
            _zero_stacks(self.draft_cfg, dcache)
            prefill(draft_params, self.draft_cfg, prompt, dcache, extras)
        b, s = prompt.shape
        base = prng_key(0 if key is None else key, prompt.device)
        rids = torch.arange(b, device=prompt.device)
        keys = None if greedy else fold_in(row_keys(base, rids, TAG_TOKEN), 0)
        self.temperature.fill_(temperature)
        tok = sample_rows(logits[:, -1], keys, greedy=greedy, temperature=self.temperature,
                          top_k=top_k)
        self.tok.copy_(tok[:, None])
        self.hist.zero_()
        self.hist[:, :s] = prompt
        self.hist[:, s] = tok
        self.out.zero_()
        self.out[:, 0] = tok
        self.n_em.fill_(1)
        self.wctr.zero_()
        self.ema.fill_(ctrl_init)
        self.wkeys.copy_(row_keys(base, rids, TAG_WINDOW))
        self.ints.copy_(torch.tensor([s, n_new, 0, 0], device=prompt.device))


def _zero_stacks(cfg: ModelConfig, cache: dict) -> None:
    """Every leaf of every stack of ``cache_stacks(cfg)`` zeroed, in
    place (a fresh ``init_cache``'s)."""
    for key, _ in cache_stacks(cfg):
        for leaf in cache[key].values():
            leaf.zero_()


def spec_window(params, cfg: ModelConfig, st: SpecState, *, spec: SpecConfig, greedy: bool,
                top_k: int, draft_params=None, extras: Optional[dict] = None) -> None:
    """One window of the fixed engine (an iteration of the JAX package's
    ``_spec_generate_body`` loop) on ``st``'s buffers: propose ``k``
    tokens per row, from its history or, in draft mode, by the draft model
    (``draft_params``) on ``st.draft_cache(k)``, verify the window at the
    row's position against the dense cache, accept (capped at ``_ctrl_k``
    under the adaptive controller, whose EMA then takes the window's
    observation), and write each live row's emissions to its output and
    history.  A row that has its ``n_new`` tokens emits nothing; its
    window's writes land at or past its last position, or are dropped past
    the store.  Under ``spec.tree_fan`` the window is a tree of chains of
    depth ``k`` on ``st.tree_cache(tree_fan, k)`` (``_spec_tree_generate_body``):
    the kept chain is relocated to the linear columns before the commit.
    ``extras``: the batch's extras buffers (each leaf (B, ...)), which the
    target's window and the draft's steps read."""
    b, k, ms = st.tok.shape[0], spec.k, st.max_seq
    dev = st.tok.device
    live = st.n_em < st.n_new
    pos = st.s - 1 + st.n_em
    wkeys = None if greedy else fold_in(st.wkeys, st.wctr)
    if spec.tree_fan:
        fan = spec.tree_fan
        chains = propose_ngram_tree(st.hist[:, :ms], st.s + st.n_em, fan, k, spec.ngram_n)
        g, a, cf, vc = _tree_verify(params, cfg, st.tree_cache(fan, k), st.tok, chains, pos,
                                    greedy=greedy, temperature=st.temperature, top_k=top_k,
                                    wkeys=wkeys, extras=extras)
        m = torch.where(live, torch.minimum(a + 1, st.n_new - st.n_em), 0)
        _emit_window(st, g, m, live)
        _tree_commit(cfg, vc, pos, m, cf, fan, k)
        return
    if spec.mode == "draft":
        drafts, q, dstack = draft_propose(
            draft_params, st.draft_cfg, st.draft_cache(k), st.tok, pos, k, wkeys=wkeys,
            greedy=greedy, temperature=st.temperature, top_k=top_k, extras=extras)
    else:
        drafts, q = propose_ngram(st.hist[:, :ms], st.s + st.n_em, k, spec.ngram_n), None
    window = torch.cat([st.tok, drafts], dim=1)
    lg, cache = verify_step(params, cfg, window, st.cache, pos, extras)
    if spec.adaptive:
        keff = _ctrl_k(st.ema, live, k, spec.ctrl_cost)
        kcap = keff.expand(b)
    else:
        keff, kcap = k, None
    g, a = _accept(window, drafts, lg, greedy=greedy, temperature=st.temperature, top_k=top_k,
                   wkeys=wkeys, q=q, kcap=kcap, n_draws=k, **_verify_kw(spec))
    if spec.adaptive:
        phat0 = _ctrl_probe(lg[:, 0], drafts[:, 0], greedy=greedy, temperature=st.temperature,
                            top_k=top_k)
        st.ema.copy_(_ctrl_update(st.ema, live, a, keff, phat0, spec.ctrl_alpha))
    m = torch.where(live, torch.minimum(a + 1, st.n_new - st.n_em), 0)
    sel = torch.clamp_min(m - 1, 0)
    commit_verify(cfg, cache, sel)
    if spec.mode == "draft":
        commit_verify(st.draft_cfg, dstack, sel)
    _emit_window(st, g, m, live)


def _emit_window(st: SpecState, g: torch.Tensor, m: torch.Tensor, live: torch.Tensor) -> None:
    """A fixed-engine window's end: each row's ``m`` emissions ``g`` (B, w)
    to its output and history, its current token, and the counters."""
    b, w = g.shape
    ms = st.max_seq
    j = torch.arange(w, device=g.device)[None]
    emit = j < m[:, None]
    cols = st.n_em[:, None] + j
    rows = torch.arange(b, device=g.device)[:, None].expand(b, w)
    st.out[rows, torch.where(emit, cols, ms)] = g
    st.hist[rows, torch.where(emit, st.s + cols, ms)] = g
    st.tok.copy_(_last_emitted(g, m, st.tok))
    st.n_em += m
    st.wctr += live
    st.steps += live.any()
    st.live_steps += live.sum()


def _tree_verify(params, cfg: ModelConfig, cache: dict, tok: torch.Tensor, chains: torch.Tensor,
                 pos: torch.Tensor, *, greedy: bool, temperature, top_k: int, wkeys,
                 extras: Optional[dict] = None):
    """A tree window: the current token and the chains (B, F, D) in node
    order, verified at ``pos`` (B,) against ``cache`` (dense or paged) with
    the rows' ``extras``, then accepted greedily or by
    ``tree_reject_sample``.  Returns (g (B, D+1), a, cf, the verify cache
    for ``_tree_commit``)."""
    b, fan, depth = chains.shape
    window = torch.cat([tok, chains.reshape(b, fan * depth)], dim=1)
    lg, vc = verify_step(params, cfg, window, cache, pos, extras, tree=(fan, depth))
    if greedy:
        return (*greedy_tree_accept(chains, lg), vc)
    return (*tree_reject_sample(wkeys, chains,
                                torch.softmax(warp_logits(lg, temperature, top_k), dim=-1)), vc)


def _tree_commit(cfg: ModelConfig, cache: dict, pos: torch.Tensor, m: torch.Tensor,
                 cf: torch.Tensor, fan: int, depth: int) -> None:
    """A tree window's commit of its verify cache ``cache``: the ``m - 1``
    kept proposals of chain ``cf`` relocated to the linear columns, then
    ``commit_verify`` at the deepest kept node (node order)."""
    acc = torch.clamp_min(m - 1, 0)
    tree_relocate(cfg, cache, pos, acc, cf, fan=fan, depth=depth)
    commit_verify(cfg, cache, torch.where(acc > 0, cf * depth + acc, 0))


# ----------------------------------------------------- the continuous engine --
def spec_chunk_step(params, cfg: ModelConfig, st, stops: torch.Tensor, emits: torch.Tensor,
                    ms: torch.Tensor, *, k: int, spec: SpecConfig, greedy: bool, top_k: int,
                    pad_id: int, draft_params=None, extras: Optional[dict] = None) -> None:
    """One iteration of the JAX package's speculative chunk
    (``_spec_chunk_body``) at the round's width ``k`` on ``ChunkState``
    ``st``: every slot proposes ``k`` tokens from its history or, in draft
    mode, by the draft model (``draft_params``) on the draft pool
    ``st.dcache`` through the block tables both pools share, the window is
    verified against the paged pool at the slot's position, accepted
    emissions stop at the budget and just after a stop token (``stops``),
    and the slot's emissions (``pad_id`` past its count) and count go to row
    ``st.it`` of ``emits`` (chunk, B, k+1) and ``ms`` (chunk, B).  A done
    slot emits nothing and keeps its window counter; its writes land in its
    own pages or the trash page.  Under ``spec.tree_fan`` the window is a
    tree of chains of depth ``k`` (``_spec_tree_chunk_body``): the kept
    chain's K/V are relocated through the block tables, whose pages must
    reach ``tree_fan * k`` positions past each live slot's frontier.
    ``extras``: the per-slot extras buffers (each leaf (B, ...)), which the
    target's window and the draft's steps read, each slot its own row."""
    b = st.tok.shape[0]
    dev = st.tok.device
    w = st.hist.shape[1] - 1  # column w takes the writes the reference drops
    live = ~st.done
    wkeys = None if greedy else fold_in(st.wkeys, st.wctr)
    fan = spec.tree_fan
    if fan:
        chains = propose_ngram_tree(st.hist[:, :w], st.pos + 1, fan, k, spec.ngram_n)
        g, a, cf, vc = _tree_verify(params, cfg, st.cache, st.tok, chains, st.pos,
                                    greedy=greedy, temperature=st.temperature, top_k=top_k,
                                    wkeys=wkeys, extras=extras)
    else:
        if spec.mode == "draft":
            drafts, q, dstack = draft_propose(
                draft_params, st.draft_cfg, st.dcache, st.tok, st.pos, k, wkeys=wkeys,
                greedy=greedy, temperature=st.temperature, top_k=top_k, extras=extras)
        else:
            drafts, q = propose_ngram(st.hist[:, :w], st.pos + 1, k, spec.ngram_n), None
        window = torch.cat([st.tok, drafts], dim=1)
        lg, vc = verify_step(params, cfg, window, st.cache, st.pos, extras)
        g, a = _accept(window, drafts, lg, greedy=greedy, temperature=st.temperature,
                       top_k=top_k, wkeys=wkeys, q=q, **_verify_kw(spec))
    if spec.adaptive:
        phat0 = _ctrl_probe(lg[:, 0], drafts[:, 0], greedy=greedy, temperature=st.temperature,
                            top_k=top_k)
        st.ema.copy_(_ctrl_update(st.ema, live, a, k, phat0, spec.ctrl_alpha))
    m = torch.minimum(a + 1, st.max_new - st.n_out)
    # a stop token inside the window ends it there: the stop is emitted,
    # nothing after it reaches the output, the history or the token
    j = torch.arange(k + 1, device=dev)[None]
    hit = (g[:, :, None] == stops[:, None, :]).any(dim=-1) & (j < m[:, None])
    any_hit = hit.any(dim=1)
    m = torch.where(any_hit, hit.to(torch.int32).argmax(dim=1) + 1, m)
    m = torch.where(live, m, 0)
    emit_mask = j < m[:, None]
    rows = torch.arange(b, device=dev)[:, None].expand(b, k + 1)
    st.hist[rows, torch.where(emit_mask, st.pos[:, None] + 1 + j, w)] = g
    st.tok.copy_(_last_emitted(g, m, st.tok))
    if fan:
        _tree_commit(cfg, vc, st.pos, m, cf, fan, k)
    else:
        sel = torch.clamp_min(m - 1, 0)
        commit_verify(cfg, vc, sel)
        if spec.mode == "draft":
            commit_verify(st.draft_cfg, dstack, sel)
    st.pos += m
    st.n_out += m
    st.done |= (live & any_hit) | (st.n_out >= st.max_new)
    row = st.it.reshape(1)
    emits.index_copy_(0, row, torch.where(emit_mask, g, pad_id)[None])
    ms.index_copy_(0, row, m[None])
    st.wctr += live
    st.it += 1

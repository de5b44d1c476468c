"""Port parity: ``ContinuousBatchingEngine(prefix_cache=True)`` of reduced
qwen2-1.5b against the JAX package's, at tests/test_prefix_cache.py's
geometry (2 slots, 4-token pages, chunk 3), on a shuffled pool.

The scheduler and the cache must make the same decisions: the same events
(admits with their cached and prefilled tokens and copy-on-write forks,
preemptions, decodes, finishes), the same per-round counters (free, retained
and in-use pages, prefix-hit tokens), hits, forks, evictions and peak pages.
Tokens are compared margin-aware (``torch_helpers.assert_serve_match``,
logit tolerance 1e-4 over the temperature): a hit's tail window runs
``verify_step`` where a miss runs ``prefill``, and the port's linears and
sums differ from JAX's by ~1e-6.  Then the dense cases of
tests/test_prefix_cache.py that need no policy or chaos, and the admits'
functions on static buffers against ``admit_prefill``.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ChunkState, ContinuousBatchingEngine, Request, admit_miss, admit_prefill, prng_key)

from torch_helpers import (  # noqa: E402
    CPU, assert_serve_match, reduced_model, serve_deciding, serve_events)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

LOGIT_TOL = 1e-4
PS = 4
GEOMETRY = dict(slots=2, max_seq=24, page_size=PS, chunk=3, num_pages=20, page_alloc_seed=1,
                pim_bits=8)
MODES = {"greedy": {}, "sampled": dict(greedy=False, temperature=0.8, top_k=8)}
KEY = 5
COUNTERS = ("round", "free_pages", "retained_pages", "pages_in_use", "prefix_hit_tokens",
            "queued")


def _trace(vocab, seed=0):
    """(prompt, max_new) of a trace with every kind of admit: a miss that
    registers its pages; partial hits on two pages and on one; a
    page-aligned prompt and its repeat (a full hit, so a copy-on-write
    fork), and an unrelated prompt."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, vocab, 10).astype(np.int32)
    p = rng.integers(0, vocab, 8).astype(np.int32)
    return [(a, 6), (np.concatenate([a[:8], rng.integers(0, vocab, 3)]), 5),
            (p, 6), (p.copy(), 7), (np.concatenate([a[:4], rng.integers(0, vocab, 5)]), 4),
            (rng.integers(0, vocab, 7).astype(np.int32), 5)]


def _requests(cls, trace):
    return [cls(prompt=p.copy(), max_new=m) for p, m in trace]


def _counters(report):
    return [{k: c[k] for k in COUNTERS} for c in report.counters]


@functools.lru_cache(maxsize=None)
def _jax_serve(mode_name, num_pages):
    """The JAX engine's cached serve of the trace, once per process."""
    jcfg, jparams, _, _ = reduced_model()
    jeng = JaxEngine(jcfg, jparams, prefix_cache=True, **{**GEOMETRY, "num_pages": num_pages})
    rep = jeng.serve_detailed(_requests(JaxRequest, _trace(jcfg.vocab)),
                              key=jax.random.PRNGKey(KEY), **MODES[mode_name])
    return jeng, rep


def _port_serve(mode_name, num_pages, cls=ContinuousBatchingEngine, prefix_cache=True):
    _, _, tcfg, tparams = reduced_model()
    eng = cls(tcfg, tparams, prefix_cache=prefix_cache, device="cpu",
              **{**GEOMETRY, "num_pages": num_pages})
    trace = _trace(tcfg.vocab)
    rep = eng.serve_detailed(_requests(Request, trace), key=KEY, **MODES[mode_name])
    return eng, rep, [p for p, _ in trace]


def _assert_matches_jax(jeng, jrep, eng, rep, prompts, mode, msg):
    assert serve_events(rep) == serve_events(jrep), msg
    assert _counters(rep) == _counters(jrep), msg
    assert (rep.rounds, rep.prefix_hits, rep.prefix_hit_tokens, rep.prefill_tokens,
            rep.cow_forks, rep.evictions, eng.peak_pages_in_use, eng.preemptions,
            eng.decode_chunk_iters) == (
        jrep.rounds, jrep.prefix_hits, jrep.prefix_hit_tokens, jrep.prefill_tokens,
        jrep.cow_forks, jrep.evictions, jeng.peak_pages_in_use, jeng.preemptions,
        jeng.decode_chunk_iters), msg
    at = serve_deciding(eng.params, eng.cfg, prompts, rep.outputs, mode, KEY)
    assert_serve_match(jrep.outputs, rep.outputs, at, LOGIT_TOL / mode.get("temperature", 1.0),
                       msg=msg)
    eng.assert_quiescent()


@pytest.mark.parametrize("mode_name", list(MODES))
def test_cached_serve_matches_jax(mode_name):
    """Events, counters, page ids, hits, forks and (margin-aware) tokens as
    the JAX engine's; the trace's structure gives the hits: three partial
    hits or full hits at least, one fork, and the prefilled tokens are the
    prompts' less the hit tokens."""
    jeng, jrep = _jax_serve(mode_name, GEOMETRY["num_pages"])
    eng, rep, prompts = _port_serve(mode_name, GEOMETRY["num_pages"])
    _assert_matches_jax(jeng, jrep, eng, rep, prompts, MODES[mode_name], mode_name)
    admits = [e for ev in serve_events(rep) for e in ev if e["name"] == "admit"]
    assert rep.prefix_hits == sum(e["cached_tokens"] > 0 for e in admits) >= 3
    assert rep.cow_forks == sum(e["cow"] for e in admits) == 1
    assert rep.prefix_hit_tokens == sum(e["cached_tokens"] for e in admits)
    assert rep.prefill_tokens == sum(len(p) for p in prompts) - rep.prefix_hit_tokens
    assert [len(t) for t in rep.outputs] == [m for _, m in _trace(eng.cfg.vocab)]


def test_tight_pool_evicts_and_preempts_as_jax():
    """A pool of 7 pages: retained pages are evicted and slots preempted, as
    in the JAX engine; the pool is quiescent after, every page free or
    retained exactly once; tokens margin-aware against JAX's and against
    the port's uncached serve on a roomy pool."""
    jeng, jrep = _jax_serve("greedy", 7)
    eng, rep, prompts = _port_serve("greedy", 7)
    assert rep.evictions > 0 and eng.preemptions > 0
    _assert_matches_jax(jeng, jrep, eng, rep, prompts, MODES["greedy"], "tight pool")
    pool = eng._pool
    assert len(pool.free) + len(pool.lru) == eng.num_pages - 1
    assert set(pool.lru) <= pool.cached
    _, uncached, _ = _port_serve("greedy", GEOMETRY["num_pages"], prefix_cache=False)
    at = serve_deciding(eng.params, eng.cfg, prompts, rep.outputs, MODES["greedy"], KEY)
    assert_serve_match(uncached.outputs, rep.outputs, at, LOGIT_TOL, msg="cached vs uncached")


class _Watched(ContinuousBatchingEngine):
    """Records around each cached admit (whether another slot was live,
    whether a byte of its pages changed)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.touched = []

    def _admit_cached(self, slot, *args):
        others = sorted({p for s, pages in enumerate(self._slot_pages) if s != slot
                         and self._slot_req[s] >= 0 for p in pages})
        before = [leaf[:, others].clone() for leaf in self._state.cache["layers"].values()]
        tok = super()._admit_cached(slot, *args)
        after = [leaf[:, others] for leaf in self._state.cache["layers"].values()]
        self.touched.append((bool(others),
                             any(not torch.equal(a, b) for a, b in zip(after, before))))
        return tok


class _Unmasked(_Watched):
    """The planted fault: the tail window runs with every slot's block-table
    row in place, so the other rows' window writes land in live pages."""

    def _window_table(self, slot):
        return self._bt.copy()


def test_cow_fork_isolation_with_a_live_sibling():
    """Two requests with one page-aligned prompt, sampled: the second
    aliases every page and forks the last; their tokens differ (per-rid
    draws), each margin-aware equal to the uncached serve; no cached admit
    changes a byte of another live slot's pages.  With the other rows'
    block-table rows left in place (the planted fault) the window writes
    into a live sibling's pages."""
    _, _, tcfg, tparams = reduced_model()
    row = np.random.default_rng(3).integers(0, tcfg.vocab, 2 * PS).astype(np.int32)
    reqs = [Request(prompt=row.copy(), max_new=6) for _ in range(2)]
    mode = MODES["sampled"]
    want = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY).serve(
        reqs, key=KEY, **mode)
    eng = _Watched(tcfg, tparams, prefix_cache=True, device="cpu", **GEOMETRY)
    got = eng.serve(reqs, key=KEY, **mode)
    assert eng.prefix_hits == 1 and eng.cow_forks == 1
    assert not np.array_equal(got[0], got[1])
    at = serve_deciding(eng.params, tcfg, [row, row], got, mode, KEY)
    assert_serve_match(want, got, at, LOGIT_TOL / mode["temperature"])
    assert eng.touched == [(True, False)]  # a live sibling, untouched
    eng.assert_quiescent()
    faulted = _Unmasked(tcfg, tparams, prefix_cache=True, device="cpu", **GEOMETRY)
    faulted.serve(reqs, key=KEY, **mode)
    assert faulted.touched == [(True, True)]


def test_miss_admit_on_static_buffers_equals_admit_prefill():
    """``admit_miss`` on a ``ChunkState``'s buffers (what the card replays)
    gives the token and pool pages of ``admit_prefill`` with plain
    arguments, bit for bit, greedy and sampled."""
    _, _, tcfg, tparams = reduced_model()
    spad, pages, length, rid = 12, [7, 2, 9], 10, 3
    toks = np.zeros((1, spad), np.int32)
    toks[0, :length] = np.random.default_rng(4).integers(0, tcfg.vocab, length)
    base = prng_key(KEY)
    for mode in MODES.values():
        greedy, top_k = mode.get("greedy", True), mode.get("top_k", 0)
        st = ChunkState(tcfg, 2, 24, 12, PS, 3, CPU)
        st.base.copy_(base)
        st.temperature.fill_(mode.get("temperature", 1.0))
        a = st.admit(spad)
        a.prompt.copy_(torch.from_numpy(toks))
        a.ints.copy_(torch.tensor([*pages, length, rid]))
        admit_miss(tparams, tcfg, st, a, greedy=greedy, top_k=top_k)
        ref = ChunkState(tcfg, 2, 24, 12, PS, 3, CPU)
        tok = admit_prefill(tparams, tcfg, ref.cache, torch.from_numpy(toks), length, 0,
                            torch.tensor(pages), rid, base, mode.get("temperature", 1.0),
                            greedy=greedy, top_k=top_k)
        assert torch.equal(a.tok, tok)
        for name, leaf in ref.cache["layers"].items():
            assert torch.equal(st.cache["layers"][name], leaf), name
            assert leaf[:, pages].abs().sum() > 0 and not leaf[:, [0, 1]].any(), name

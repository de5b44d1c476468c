"""Port parity: tree drafts (``SpecConfig(tree_fan=2, k=2)``, n-gram chains)
on both engines, reduced qwen2-1.5b against the JAX package's on the same
prompts, keys, seeds and geometry.

The fixed engine's greedy tokens are held margin-aware at 1e-4 against
JAX's and against the port's own plain greedy decoding
(``torch_helpers.assert_greedy_match``; the port's decode linears run
``pim_matvec``'s plain version, the JAX package's ``x @ dq(w)``); sampled
tokens, drawn from the JAX package's window keys, equal, and so does
``spec_stats``.  The continuous engine decides as JAX's does: the same
events, round counters (``eff_k`` the round's depth, halved by the
ladder's ``halve_k`` under a ``VirtualClock``), window counts and pages,
with a preempting pool and with the prefix cache on; ``debug_check_hist``
holds in every serve.  A fan-1 tree is linear speculation token for token
on both engines, and the same key gives the same sampled tokens on both.
The untrained model mostly repeats tokens, so chain 0 wins most windows:
the prompts are chosen so that a later chain is kept and relocated too
(recorded through ``speculative.tree_relocate``).  A relocation whose
sources are one column late leaves the cache of plain decoding, where the
sound one stays within the bar.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import ChaosConfig as JaxChaosConfig  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxCB  # noqa: E402
from repro.serving import FaultInjector as JaxInjector  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ResiliencePolicy as JaxPolicy  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import SpecConfig as JaxSpec  # noqa: E402
from repro.serving import VirtualClock as JaxClock  # noqa: E402
from repro.serving.resilience import LadderConfig as JaxLadder  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ChaosConfig, ContinuousBatchingEngine, FaultInjector, LadderConfig, Request,
    ResiliencePolicy, ServingEngine, SpecConfig, VirtualClock, speculative)

from torch_helpers import (  # noqa: E402,F401
    assert_greedy_match, assert_serve_match, one_thread, prompt, reduced_model, serve_deciding,
    serve_events)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

LOGIT_TOL = 1e-4
TREE = dict(k=2, tree_fan=2)
MAX_SEQ, N_NEW = 28, 18
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)
GEOMETRY = dict(slots=2, max_seq=24, page_size=4, chunk=3, page_alloc_seed=1, pim_bits=8)
SHAPES = ((5, 4), (7, 6), (3, 3), (9, 5), (4, 7))  # (prompt length, max_new)
# (prompt seed, key): the greedy prompts' tokens mod 5, and the sampled
# prompts and key, under which a window keeps chain 1 of the tree
FIXED = {"greedy": (5, None), "sampled": (7, 1)}


@pytest.fixture
def relocations(monkeypatch):
    """Every (accepted, kept chain) pair the engines relocate."""
    seen, sound = [], speculative.tree_relocate

    def recorded(cfg, cache, pos, a, cf, **kw):
        seen.append((a.clone(), cf.clone()))
        return sound(cfg, cache, pos, a, cf, **kw)
    monkeypatch.setattr(speculative, "tree_relocate", recorded)
    return seen


def _later_chains(seen):
    """Relocations that kept a chain other than 0 and moved something."""
    return sum(int(((a > 0) & (cf > 0)).sum()) for a, cf in seen)


def _fixed_prompts(vocab, name):
    toks = prompt(3, 6, vocab, seed=FIXED[name][0])
    return toks % 5 if name == "greedy" else toks


@pytest.mark.parametrize("name", sorted(FIXED))
def test_tree_generate_matches_jax(name, relocations):
    jcfg, jparams, tcfg, tparams = reduced_model()
    jeng = JaxEngine(jcfg, jparams, max_seq=MAX_SEQ, pim_bits=8)
    eng = ServingEngine(tcfg, tparams, max_seq=MAX_SEQ, pim_bits=8, device="cpu")
    toks = _fixed_prompts(tcfg.vocab, name)
    mode = {} if name == "greedy" else dict(SAMPLED, key=FIXED[name][1])
    jmode = {k: jax.random.PRNGKey(v) if k == "key" else v for k, v in mode.items()}
    want = np.asarray(jeng.generate(toks, N_NEW, speculate=JaxSpec(**TREE), **jmode))
    got = eng.generate(torch.from_numpy(toks), N_NEW, speculate=SpecConfig(**TREE), **mode)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert eng.spec_stats == jeng.spec_stats and eng.spec_stats["tree_fan"] == 2
    assert eng.spec_stats["verify_steps"] < N_NEW - 1  # windows accepted proposals
    assert _later_chains(relocations) > 0
    if mode:
        np.testing.assert_array_equal(got.numpy(), want)
        return
    at = serve_deciding(eng.params, eng.cfg, list(toks), list(got.numpy()), {}, 0)
    assert_greedy_match(want, got.numpy(), at, LOGIT_TOL, msg=name)
    plain = eng.generate(torch.from_numpy(toks), N_NEW)
    assert_greedy_match(plain.numpy(), got.numpy(), at, LOGIT_TOL, msg=f"{name} vs plain")


def test_fan1_is_linear_speculation_on_both_engines():
    """``SpecConfig(k=3, tree_fan=1)`` emits linear ``k=3`` speculation's
    tokens, token for token, on the fixed and the continuous engine."""
    _, _, tcfg, tparams = reduced_model()
    toks = torch.from_numpy(prompt(3, 6, tcfg.vocab, seed=4) % 5)
    fan1, lin = SpecConfig(k=3, tree_fan=1), SpecConfig(k=3)
    eng = ServingEngine(tcfg, tparams, max_seq=32, pim_bits=8, device="cpu")
    assert torch.equal(eng.generate(toks, 16, speculate=fan1), eng.generate(toks, 16,
                                                                             speculate=lin))
    kw = dict(slots=2, max_seq=32, page_size=4, chunk=3, pim_bits=8, device="cpu")
    outs = [ContinuousBatchingEngine(tcfg, tparams, speculate=sp, **kw).generate(toks, 16)
            for sp in (fan1, lin)]
    assert torch.equal(*outs)


def _serve_prompts(seed=3):
    """Prompts of 5 tokens' vocabulary; under seed 3 the greedy serve keeps
    chain 1 in some windows."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 5, size=n).astype(np.int32) for n, _ in SHAPES]


def _requests(cls, prompts, budgets):
    return [cls(prompt=p.copy(), max_new=m) for p, m in zip(prompts, budgets)]


def _engines(clock=False, **geo):
    jcfg, jparams, tcfg, tparams = reduced_model()
    g = {**GEOMETRY, **geo}
    jeng = JaxCB(jcfg, jparams, speculate=JaxSpec(**TREE), clock=JaxClock() if clock else None,
                 **g)
    eng = ContinuousBatchingEngine(tcfg, tparams, speculate=SpecConfig(**TREE), device="cpu",
                                   clock=VirtualClock() if clock else None, **g)
    eng.debug_check_hist = True
    return jeng, eng


def _counters(report, times=False):
    return [{k: v for k, v in c.items() if times or k != "ts"} for c in report.counters]


def _check(jeng, jrep, eng, rep, prompts, mode, msg, times=False):
    assert serve_events(rep) == serve_events(jrep), msg
    assert _counters(rep, times) == _counters(jrep, times), msg
    assert (rep.rounds, eng.decode_chunk_iters, eng.spec_emitted, eng.spec_live_steps,
            eng.peak_pages_in_use, eng.preemptions, rep.prefill_tokens) == (
        jrep.rounds, jeng.decode_chunk_iters, jeng.spec_emitted, jeng.spec_live_steps,
        jeng.peak_pages_in_use, jeng.preemptions, jrep.prefill_tokens), msg
    if mode:
        for w, g in zip(jrep.outputs, rep.outputs):
            np.testing.assert_array_equal(g, w, err_msg=msg)
    else:
        at = serve_deciding(eng.params, eng.cfg, prompts, rep.outputs, mode, 0)
        assert_serve_match(jrep.outputs, rep.outputs, at, LOGIT_TOL, msg=msg)
    eng.assert_quiescent()


SERVES = {
    "greedy": ({}, {}),
    "sampled": (SAMPLED, {}),
    # a pool below two slots' worst case: top-ups preempt mid-speculation
    "preempting": (SAMPLED, dict(max_seq=32, num_pages=11)),
}


@pytest.mark.parametrize("name", sorted(SERVES))
def test_tree_serve_matches_jax(name, relocations):
    mode, geo = SERVES[name]
    jeng, eng = _engines(**geo)
    shapes = SHAPES if not geo else tuple((n, m + 6) for n, m in SHAPES)
    prompts = _serve_prompts()
    budgets = [m for _, m in shapes]
    key = 3
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets),
                               key=jax.random.PRNGKey(key), **mode)
    rep = eng.serve_detailed(_requests(Request, prompts, budgets), key=key, **mode)
    _check(jeng, jrep, eng, rep, prompts, mode, name)
    assert eng.spec_emitted > eng.spec_live_steps > 0, name  # windows accepted proposals
    assert {c["eff_k"] for c in rep.counters} == {TREE["k"]}
    assert eng._store_seq == eng.max_seq + 4 and eng.width == eng._store_seq // 4
    if geo:
        assert eng.preemptions > 0
    if name == "greedy":
        assert _later_chains(relocations) > 0


def test_prefix_cache_stays_on_under_tree_speculation():
    """Shared prompt pages are hit, forked and evicted as JAX's engine does
    (tests/test_torch_spec_serving.py's trace), the tail windows linear."""
    jeng, eng = _engines(prefix_cache=True, num_pages=20)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 5, 10).astype(np.int32)
    p = rng.integers(0, 5, 8).astype(np.int32)
    trace = [(a, 6), (np.concatenate([a[:8], rng.integers(0, 5, 3)]), 5), (p, 6),
             (p.copy(), 7), (rng.integers(0, 5, 7).astype(np.int32), 5)]
    prompts, budgets = [t for t, _ in trace], [m for _, m in trace]
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets),
                               key=jax.random.PRNGKey(3), **SAMPLED)
    rep = eng.serve_detailed(_requests(Request, prompts, budgets), key=3, **SAMPLED)
    _check(jeng, jrep, eng, rep, prompts, SAMPLED, "prefix cache")
    assert (rep.prefix_hits, rep.prefix_hit_tokens, rep.cow_forks) == (
        jrep.prefix_hits, jrep.prefix_hit_tokens, jrep.cow_forks)
    assert rep.prefix_hits >= 2 and rep.cow_forks == 1


def test_ladder_halves_the_depth_as_jax():
    """Stragglers lift the ladder through ``halve_k`` (depth 1, fan kept)
    and ``no_spec`` (plain rounds that keep the history warm), and it
    recovers: statuses, events with times, round counters and ladder trace
    equal JAX's under a ``VirtualClock``; greedy tokens margin-aware."""
    jeng, eng = _engines(clock=True)
    prompts = _serve_prompts(seed=1)
    budgets = [m + 4 for _, m in SHAPES]
    chaos = dict(straggle_rounds=(0, 1, 2))
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets),
                               chaos=JaxInjector(JaxChaosConfig(**chaos)),
                               policy=JaxPolicy(round_time=1.0, ladder=JaxLadder(cooldown=1)))
    rep = eng.serve_detailed(_requests(Request, prompts, budgets),
                             chaos=FaultInjector(ChaosConfig(**chaos)),
                             policy=ResiliencePolicy(round_time=1.0,
                                                     ladder=LadderConfig(cooldown=1)))
    _check(jeng, jrep, eng, rep, prompts, {}, "ladder", times=True)
    assert [tuple(t) for t in rep.ladder_trace] == [tuple(t) for t in jrep.ladder_trace]
    assert {2, 1, 0} <= {c["eff_k"] for c in rep.counters}


def test_long_horizon_paged_relocation_and_cross_engine_keys():
    """24 tokens on 4-token pages: kept chains cross page boundaries again
    and again, and the greedy serve stays within the bar of the plain paged
    engine; sampled, the same key gives the fixed and the continuous
    engine the same tokens."""
    _, _, tcfg, tparams = reduced_model()
    toks = prompt(2, 8, tcfg.vocab, seed=1) % 5
    kw = dict(slots=2, max_seq=40, page_size=4, chunk=3, pim_bits=8, device="cpu")
    reqs = [Request(prompt=row, max_new=24) for row in toks]
    want = ContinuousBatchingEngine(tcfg, tparams, **kw).serve(reqs)
    eng = ContinuousBatchingEngine(tcfg, tparams, speculate=SpecConfig(**TREE), **kw)
    eng.debug_check_hist = True
    got = eng.serve(reqs)
    at = serve_deciding(eng.params, tcfg, list(toks), got, {}, 0)
    assert_serve_match(want, got, at, LOGIT_TOL, msg="long horizon")
    fixed = ServingEngine(tcfg, tparams, max_seq=40, pim_bits=8, device="cpu")
    sampled = dict(SAMPLED, key=11)
    a = fixed.generate(torch.from_numpy(toks), 24, speculate=SpecConfig(**TREE), **sampled)
    b = eng.generate(torch.from_numpy(toks), 24, **sampled)
    assert torch.equal(a, b)


def _late_sources(cfg, cache, pos, a, cf, *, fan, depth, page_size=None):
    """The planted fault: the relocation's sources one column late."""
    src, dst, ok = lm.tree_columns(pos, a, cf, depth)
    return lm.move_columns(cfg, cache, src + 1, dst, ok)


def test_planted_late_relocation_is_flagged(monkeypatch):
    """After a greedy tree generation the live columns of the tree cache are
    plain decoding's K/V within 1e-4; with the relocation's sources one
    column late they are not (the tokens alone may not show it: the
    untrained model repeats one token)."""
    _, _, tcfg, tparams = reduced_model()
    toks = torch.from_numpy(_fixed_prompts(tcfg.vocab, "greedy"))
    spec = SpecConfig(**TREE)

    def live_columns(engine, generate):
        out = generate()
        n = toks.shape[1] + N_NEW - 1  # the positions the generation consumed
        cache = (engine.spec_state(3).tree_cache(2, 2) if engine.spec_stats
                 else engine.state(3).cache)
        return out, {k: v[:, :, :, :n].clone() for k, v in cache["layers"].items()}

    plain_eng = ServingEngine(tcfg, tparams, max_seq=MAX_SEQ, pim_bits=8, device="cpu")
    plain, want = live_columns(plain_eng, lambda: plain_eng.generate(toks, N_NEW))
    errs = {}
    for name in ("sound", "late"):
        if name == "late":
            monkeypatch.setattr(speculative, "tree_relocate", _late_sources)
        eng = ServingEngine(tcfg, tparams, max_seq=MAX_SEQ, pim_bits=8, device="cpu")
        out, got = live_columns(eng, lambda: eng.generate(toks, N_NEW, speculate=spec))
        errs[name] = max(float((got[k] - want[k]).abs().max()) for k in want)
        if name == "sound":
            assert torch.equal(out, plain)
    assert errs["sound"] <= LOGIT_TOL < errs["late"], errs

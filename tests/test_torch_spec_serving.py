"""Port parity: ``ContinuousBatchingEngine(speculate=)``, n-gram speculative
decoding on the paged continuous engine, of reduced qwen2-1.5b against the
JAX package's, on the same traces, keys, seeds and geometry (2 slots,
4-token pages, chunk 3).

The scheduler must decide alike: the same events (admits, preemptions,
decode rounds with their tokens, finishes), the same round counters with
each round's window width ``eff_k`` (the adaptive controller's picks
included), the same window counts (``spec_emitted``, ``spec_live_steps``,
``decode_chunk_iters``) and pages.  Greedy tokens are held margin-aware at
1e-4 (``torch_helpers.assert_serve_match``); sampled ones, drawn from the
JAX package's window keys, equal.  Under a ``VirtualClock`` the resilience
tier's ladder walks the speculating engine through ``halve_k`` and
``no_spec`` as the JAX package's does, and a supervisor's crash replay
writes snapshots whose live ``wctr``/``acc_ema`` make their JSON byte-equal
to JAX's.  ``debug_check_hist`` holds in every serve: each live slot's
history is its prompt and every emitted token after each speculative round.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import ChaosConfig as JaxChaosConfig  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import FaultInjector as JaxInjector  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ResiliencePolicy as JaxPolicy  # noqa: E402
from repro.serving import ServingSupervisor as JaxSupervisor  # noqa: E402
from repro.serving import SpecConfig as JaxSpec  # noqa: E402
from repro.serving import VirtualClock as JaxClock  # noqa: E402
from repro.serving.resilience import LadderConfig as JaxLadder  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ChaosConfig, ContinuousBatchingEngine, FaultInjector, LadderConfig, Request,
    ResiliencePolicy, ServingSupervisor, SpecConfig, VirtualClock)

from torch_helpers import (  # noqa: E402,F401
    assert_serve_match, one_thread, reduced_model, serve_deciding, serve_events)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

LOGIT_TOL = 1e-4
GEOMETRY = dict(slots=2, max_seq=24, page_size=4, chunk=3, page_alloc_seed=1, pim_bits=8)
SHAPES = ((5, 4), (7, 6), (3, 3), (9, 5), (4, 7))  # (prompt length, max_new)
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)
KEY = 11


def _prompts(vocab, shapes=SHAPES, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n, _ in shapes]


def _requests(cls, prompts, budgets):
    return [cls(prompt=p.copy(), max_new=m) for p, m in zip(prompts, budgets)]


def _engines(spec, clock=False, **geo):
    jcfg, jparams, tcfg, tparams = reduced_model()
    g = {**GEOMETRY, **geo}
    jeng = JaxEngine(jcfg, jparams, speculate=JaxSpec(**spec),
                     clock=JaxClock() if clock else None, **g)
    eng = ContinuousBatchingEngine(tcfg, tparams, speculate=SpecConfig(**spec), device="cpu",
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
    assert all(t.dtype == np.int32 for t in rep.outputs)
    if mode:
        for w, g in zip(jrep.outputs, rep.outputs):
            np.testing.assert_array_equal(g, w, err_msg=msg)
    else:
        at = serve_deciding(eng.params, eng.cfg, prompts, rep.outputs, mode, KEY)
        assert_serve_match(jrep.outputs, rep.outputs, at, LOGIT_TOL, msg=msg)
    eng.assert_quiescent()


SERVES = {
    "greedy": (dict(k=3), {}, {}),
    "sampled": (dict(k=3), SAMPLED, {}),
    "typical": (dict(k=2, accept="typical"), SAMPLED, {}),
    "adaptive_greedy": (dict(k=4, adaptive=True), {}, {}),
    "adaptive_sampled": (dict(k=4, adaptive=True, ctrl_init=0.5), SAMPLED, {}),
    # a pool below two slots' worst case: top-ups preempt mid-speculation
    "preempting": (dict(k=3), SAMPLED, dict(max_seq=32, num_pages=9)),
}


@pytest.mark.parametrize("name", sorted(SERVES))
def test_speculative_serve_matches_jax(name):
    spec, mode, geo = SERVES[name]
    jeng, eng = _engines(spec, **geo)
    shapes = SHAPES if not geo else tuple((n, m + 6) for n, m in SHAPES)
    prompts = _prompts(eng.cfg.vocab, shapes)
    budgets = [m for _, m in shapes]
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets),
                               key=jax.random.PRNGKey(KEY), **mode)
    rep = eng.serve_detailed(_requests(Request, prompts, budgets), key=KEY, **mode)
    _check(jeng, jrep, eng, rep, prompts, mode, name)
    widths = {c["eff_k"] for c in rep.counters}
    assert eng.spec_emitted > eng.spec_live_steps > 0, name  # windows accepted proposals
    if spec.get("adaptive"):
        assert 0 in widths and widths - {0}, widths  # plain rounds and windows
    else:
        assert widths == {spec["k"]}, widths
    if geo:
        assert eng.preemptions > 0


def _shared_prefix_trace(vocab, seed=0):
    """Prompts sharing pages: a miss, partial hits, a full hit (a
    copy-on-write fork) and an unrelated prompt (tests/test_torch_prefix_serving.py's)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, vocab, 10).astype(np.int32)
    p = rng.integers(0, vocab, 8).astype(np.int32)
    return [(a, 6), (np.concatenate([a[:8], rng.integers(0, vocab, 3)]), 5),
            (p, 6), (p.copy(), 7), (np.concatenate([a[:4], rng.integers(0, vocab, 5)]), 4),
            (rng.integers(0, vocab, 7).astype(np.int32), 5)]


def test_prefix_cache_stays_on_under_ngram_speculation():
    """In n-gram mode the prefix cache keeps serving hits (the JAX package
    turns it off only for a draft model's pool)."""
    jeng, eng = _engines(dict(k=3), prefix_cache=True, num_pages=20)
    trace = _shared_prefix_trace(eng.cfg.vocab)
    prompts, budgets = [p for p, _ in trace], [m for _, m in trace]
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets),
                               key=jax.random.PRNGKey(KEY), **SAMPLED)
    rep = eng.serve_detailed(_requests(Request, prompts, budgets), key=KEY, **SAMPLED)
    _check(jeng, jrep, eng, rep, prompts, SAMPLED, "prefix cache")
    assert (rep.prefix_hits, rep.prefix_hit_tokens, rep.cow_forks) == (
        jrep.prefix_hits, jrep.prefix_hit_tokens, jrep.cow_forks)
    assert rep.prefix_hits >= 3 and rep.cow_forks == 1


def test_ladder_halves_then_drops_the_window_as_jax():
    """Stragglers in the first rounds lift the ladder through ``halve_k``
    (width k // 2) and ``no_spec`` (plain rounds that keep the history
    warm) and it recovers: under a ``VirtualClock`` the statuses, events
    with times, round counters, ladder trace and snapshots equal the JAX
    package's, and greedy tokens hold margin-aware."""
    spec = dict(k=4)
    jeng, eng = _engines(spec, clock=True)
    prompts = _prompts(eng.cfg.vocab)
    budgets = [m + 4 for _, m in SHAPES]
    chaos = dict(straggle_rounds=(0, 1, 2))
    jsnaps, snaps = [], []
    jrep = jeng.serve_detailed(
        _requests(JaxRequest, prompts, budgets), chaos=JaxInjector(JaxChaosConfig(**chaos)),
        policy=JaxPolicy(round_time=1.0, ladder=JaxLadder(cooldown=1),
                         snapshot_sink=lambda s: jsnaps.append(s.to_json())),
        key=jax.random.PRNGKey(KEY))
    rep = eng.serve_detailed(
        _requests(Request, prompts, budgets), chaos=FaultInjector(ChaosConfig(**chaos)),
        policy=ResiliencePolicy(round_time=1.0, ladder=LadderConfig(cooldown=1),
                                snapshot_sink=lambda s: snaps.append(s.to_json())),
        key=KEY)
    _check(jeng, jrep, eng, rep, prompts, {}, "ladder", times=True)
    assert [tuple(t) for t in rep.ladder_trace] == [tuple(t) for t in jrep.ladder_trace]
    assert [(r.t_admit, r.t_done) for r in rep.records] == [
        (r.t_admit, r.t_done) for r in jrep.records]
    assert rep.max_ladder_level >= 2
    widths = [c["eff_k"] for c in rep.counters]
    assert {spec["k"], spec["k"] // 2, 0} <= set(widths), widths
    assert snaps == jsnaps and snaps


@pytest.mark.parametrize("resume_mode", ["prefill", "recompute"])
def test_crash_replay_resumes_the_window_stream_as_jax(resume_mode):
    """Adaptive sampled speculation under the supervisor with two scripted
    crashes: the same restarts, events and tokens as the JAX package's, and
    every snapshot's JSON byte-equal to JAX's, the in-flight requests'
    ``wctr`` and ``acc_ema`` the engine's live values."""
    spec = dict(k=4, adaptive=True, ctrl_init=0.5)
    jeng, eng = _engines(spec, clock=True)
    prompts = _prompts(eng.cfg.vocab, seed=3)
    budgets = [m + 4 for _, m in SHAPES]
    jsnaps, snaps = [], []
    kw = dict(round_time=1.0, resume_mode=resume_mode)
    jsup = JaxSupervisor(jeng, policy=JaxPolicy(snapshot_sink=lambda s: jsnaps.append(
        s.to_json()), **kw), chaos=JaxInjector(JaxChaosConfig(crash_rounds=(1, 3))),
        clock=jeng._clock)
    sup = ServingSupervisor(eng, policy=ResiliencePolicy(snapshot_sink=lambda s: snaps.append(
        s.to_json()), **kw), chaos=FaultInjector(ChaosConfig(crash_rounds=(1, 3))),
        clock=eng._clock)
    jrep = jsup.run(_requests(JaxRequest, prompts, budgets), key=jax.random.PRNGKey(KEY),
                    **SAMPLED)
    rep = sup.run(_requests(Request, prompts, budgets), key=KEY, **SAMPLED)
    assert rep.restarts == jrep.restarts == 2
    _check(jeng, jrep, eng, rep, prompts, SAMPLED, resume_mode, times=True)
    assert snaps == jsnaps and snaps
    live = [v for s in snaps for v in json.loads(s)["inflight"].values()]
    assert any(v["wctr"] > 0 for v in live) and len({v["acc_ema"] for v in live}) > 2


class _Desynced(ContinuousBatchingEngine):
    """A planted fault: the second round's upload loses one slot's last
    emitted token from its history."""

    def _load(self):
        self._loads = getattr(self, "_loads", 0) + 1
        if self._loads == 2:
            slot = int(np.flatnonzero(~self._done)[0])
            self._hist[slot, self._plen[slot] + self._n_out[slot] - 1] += 1
        super()._load()


def test_debug_check_hist_flags_a_desynced_history():
    _, _, tcfg, tparams = reduced_model()
    eng = _Desynced(tcfg, tparams, speculate=3, device="cpu", **GEOMETRY)
    eng.debug_check_hist = True
    reqs = _requests(Request, _prompts(tcfg.vocab), [m for _, m in SHAPES])
    with pytest.raises(AssertionError, match="history desync"):
        eng.serve(reqs)

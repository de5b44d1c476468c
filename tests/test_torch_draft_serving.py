"""Port parity: draft-model speculation on the continuous engine,
``ContinuousBatchingEngine(speculate=SpecConfig(mode="draft"), draft_cfg=,
draft_params=)``, of reduced qwen2-1.5b against the JAX package's and the
port's own dense engine, on the same traces, keys, seeds and geometry (2
slots, 4-token pages, chunk 3).  The draft's K/V live in a pool of their
own under the target's block tables.

Against JAX the scheduler must decide alike (events, round counters,
window counts, pages); greedy tokens are held margin-aware at 1e-4
(``torch_helpers.assert_serve_match``), sampled ones equal.  Against the
fixed engine's dense draft cache, sampled tokens are equal (the key of a
draw does not depend on the cache's layout), also for a request that uses
the whole ``max_seq`` budget, where the draft's read-back runs past the
frontier into the reserved positions.  A pool small enough to reissue
freed pages or to preempt mid-speculation leaves no ghost state in either
pool.  The prefix cache stays off in draft mode; the ladder's ``no_spec``
rounds leave the draft pool unwritten, as the JAX package's do; a
recompute crash replay equals the undisturbed serve.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import ChaosConfig as JaxChaosConfig  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import FaultInjector as JaxInjector  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ResiliencePolicy as JaxPolicy  # noqa: E402
from repro.serving import SpecConfig as JaxSpec  # noqa: E402
from repro.serving import VirtualClock as JaxClock  # noqa: E402
from repro.serving.resilience import LadderConfig as JaxLadder  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ChaosConfig, ContinuousBatchingEngine, FaultInjector, LadderConfig, Request,
    ResiliencePolicy, ServingEngine, ServingSupervisor, SpecConfig, VirtualClock)

from torch_helpers import (  # noqa: E402,F401
    assert_serve_match, one_thread, prompt, reduced_model, serve_deciding, serve_events)
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


def _draft(cfg, params, bits):
    return dict(draft_cfg=cfg, draft_params=params, draft_pim_bits=bits)


def _engine(spec=None, bits=4, **geo):
    """The port's continuous engine (draft mode unless ``spec`` is None)."""
    _, _, tcfg, tparams = reduced_model()
    kw = {} if spec is None else dict(speculate=SpecConfig(mode="draft", **spec),
                                      **_draft(tcfg, tparams, bits))
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **{**GEOMETRY, **geo}, **kw)
    eng.debug_check_hist = spec is not None
    return eng


def _jax_engine(spec, bits=4, clock=False, **geo):
    jcfg, jparams, _, _ = reduced_model()
    return JaxEngine(jcfg, jparams, speculate=JaxSpec(mode="draft", **spec),
                     clock=JaxClock() if clock else None, **_draft(jcfg, jparams, bits),
                     **{**GEOMETRY, **geo})


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
    "greedy_int4": (dict(k=3), 4, {}, {}),
    "sampled_int4": (dict(k=3), 4, SAMPLED, {}),
    # a pool below two slots' worst case: top-ups preempt mid-speculation
    "preempting": (dict(k=3), 4, SAMPLED, dict(max_seq=32, num_pages=9)),
}


@pytest.mark.parametrize("name", sorted(SERVES))
def test_draft_serve_matches_jax(name):
    spec, bits, mode, geo = SERVES[name]
    jeng, eng = _jax_engine(spec, bits, **geo), _engine(spec, bits, **geo)
    shapes = SHAPES if not geo else tuple((n, m + 6) for n, m in SHAPES)
    prompts = _prompts(eng.cfg.vocab, shapes)
    budgets = [m for _, m in shapes]
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets),
                               key=jax.random.PRNGKey(KEY), **mode)
    rep = eng.serve_detailed(_requests(Request, prompts, budgets), key=KEY, **mode)
    _check(jeng, jrep, eng, rep, prompts, mode, name)
    assert eng.spec_emitted > eng.spec_live_steps > 0, name  # windows accepted proposals
    if geo:
        assert eng.preemptions > 0
    # both pools carry k positions (whole pages) past max_seq
    assert eng.width * eng.page_size == eng.max_seq + -(-spec["k"] // 4) * 4
    assert eng._state.dcache["block_tables"] is eng._state.cache["block_tables"]


def test_greedy_parity_with_the_plain_paged_engine():
    """A self-draft serve against the plain paged engine's, margin-aware;
    the self-draft accepts every proposal it is allowed."""
    plain, eng = _engine(), _engine(dict(k=3), bits=8)
    prompts = _prompts(plain.cfg.vocab)
    budgets = [m for _, m in SHAPES]
    want = plain.serve(_requests(Request, prompts, budgets))
    got = eng.serve(_requests(Request, prompts, budgets))
    at = serve_deciding(eng.params, eng.cfg, prompts, got, {}, KEY)
    assert_serve_match(want, got, at, LOGIT_TOL)
    assert eng.spec_emitted > 2 * eng.spec_live_steps


@pytest.mark.parametrize("max_seq", [32, 16], ids=["inside", "at_max_seq"])
def test_sampled_dense_equals_paged_and_jax(max_seq):
    """Sampled draft speculation on the same key: the fixed engine's dense
    draft cache and the continuous engine's paged pool give the same tokens,
    and so does the JAX package's continuous engine.  At 8 prompt + 8 new ==
    max_seq 16 the chain reads back the positions past the frontier."""
    jcfg, jparams, tcfg, tparams = reduced_model()
    spec, n_new = dict(k=3, mode="draft"), 8 if max_seq == 16 else 7
    toks = prompt(2, 8, tcfg.vocab, seed=1)
    dense = ServingEngine(tcfg, tparams, max_seq=max_seq, device="cpu", **_draft(tcfg, tparams, 0))
    want = dense.generate(torch.from_numpy(toks), n_new, speculate=SpecConfig(**spec), key=KEY,
                          **SAMPLED).numpy()
    geo = dict(slots=2, max_seq=max_seq, page_size=4, chunk=3)
    paged = ContinuousBatchingEngine(tcfg, tparams, speculate=SpecConfig(**spec), device="cpu",
                                     **_draft(tcfg, tparams, 0), **geo)
    got = paged.generate(torch.from_numpy(toks), n_new, key=KEY, **SAMPLED).numpy()
    np.testing.assert_array_equal(got, want)
    jeng = JaxEngine(jcfg, jparams, speculate=JaxSpec(**spec), **_draft(jcfg, jparams, 0), **geo)
    jgot = np.asarray(jeng.generate(toks, n_new, key=jax.random.PRNGKey(KEY), **SAMPLED))
    np.testing.assert_array_equal(got, jgot)


def test_freed_page_reissue_leaves_no_ghost_state():
    """A pool small enough that freed pages are reissued, in both pools at
    once: every request equals its solo run on the fixed engine's dense
    draft cache (sampled, same key and request id), and no page stays in
    use."""
    _, _, tcfg, tparams = reduced_model()
    rng = np.random.default_rng(3)
    spec = SpecConfig(k=3, mode="draft")
    shapes = [(6, 6), (5, 7), (8, 4), (7, 5), (4, 8), (6, 5)]
    reqs = [Request(prompt=rng.integers(0, tcfg.vocab, size=n).astype(np.int32), max_new=m,
                    rid=0) for n, m in shapes]
    eng = ContinuousBatchingEngine(tcfg, tparams, slots=2, max_seq=20, page_size=4,
                                   num_pages=11, chunk=3, page_alloc_seed=5, speculate=spec,
                                   device="cpu", **_draft(tcfg, tparams, 4))
    outs = eng.serve(reqs, key=KEY, **SAMPLED)
    dense = ServingEngine(tcfg, tparams, max_seq=20, device="cpu", **_draft(tcfg, tparams, 4))
    for i, (r, got) in enumerate(zip(reqs, outs)):
        want = dense.generate(torch.from_numpy(r.prompt)[None], r.max_new, speculate=spec,
                              key=KEY, **SAMPLED)[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"request {i}")
    # the trace needs more pages than the pool holds: freed pages are reissued
    assert sum(-(-(n + m) // 4) for n, m in shapes) > eng.num_pages - 1
    assert eng.pages_in_use() == 0


def test_preemption_mid_speculation_equals_the_unpreempted_serve():
    """Recompute preemption of a slot mid-speculation frees its pages in
    both pools; the replayed request's tokens equal the big pool's."""
    _, _, tcfg, tparams = reduced_model()
    kw = dict(slots=2, max_seq=32, page_size=4, chunk=4, speculate=SpecConfig(k=3, mode="draft"),
              device="cpu", **_draft(tcfg, tparams, 4))
    prompts = prompt(2, 8, tcfg.vocab, seed=1)
    big = ContinuousBatchingEngine(tcfg, tparams, **kw)
    want = big.serve(_requests(Request, list(prompts), [16, 16]), key=KEY, **SAMPLED)
    small = ContinuousBatchingEngine(tcfg, tparams, num_pages=11, **kw)
    got = small.serve(_requests(Request, list(prompts), [16, 16]), key=KEY, **SAMPLED)
    assert small.preemptions > 0 and big.preemptions == 0
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_draft_mode_needs_a_draft_on_both_engines():
    _, _, tcfg, tparams = reduced_model()
    with pytest.raises(ValueError, match="draft_cfg/draft_params"):
        ContinuousBatchingEngine(tcfg, tparams, slots=1, max_seq=16, page_size=4, device="cpu",
                                 speculate=SpecConfig(mode="draft"))
    with pytest.raises(ValueError, match="draft_cfg/draft_params"):
        ContinuousBatchingEngine(tcfg, tparams, slots=1, max_seq=16, page_size=4, device="cpu",
                                 speculate=SpecConfig(mode="draft"), draft_cfg=tcfg)
    eng = ServingEngine(tcfg, tparams, max_seq=16, device="cpu", draft_params=tparams)
    with pytest.raises(ValueError, match="draft_cfg/draft_params"):
        eng.generate(torch.from_numpy(prompt(1, 4, tcfg.vocab)), 2,
                     speculate=SpecConfig(k=2, mode="draft"))


def test_prefix_cache_stays_off_in_draft_mode():
    """Prompts that share pages: no hit, no fork, and the tokens of the same
    serve without the prefix cache."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, 10).astype(np.int32)
    prompts = [a, np.concatenate([a[:8], rng.integers(0, 256, 3).astype(np.int32)]), a.copy()]
    budgets = [6, 5, 4]
    cached = _engine(dict(k=3), prefix_cache=True, num_pages=20)
    rep = cached.serve_detailed(_requests(Request, prompts, budgets), key=KEY, **SAMPLED)
    assert (rep.prefix_hits, rep.prefix_hit_tokens, rep.cow_forks) == (0, 0, 0)
    assert rep.prefill_tokens == sum(len(p) for p in prompts)
    want = _engine(dict(k=3), num_pages=20).serve(_requests(Request, prompts, budgets), key=KEY,
                                                  **SAMPLED)
    for w, g in zip(want, rep.outputs):
        np.testing.assert_array_equal(g, w)


def test_ladder_no_spec_rounds_leave_the_draft_pool_as_jax_does():
    """Stragglers lift the ladder through ``halve_k`` and ``no_spec``: plain
    rounds write the target's pool only, and the draft's later windows read
    what it held before them, as in the JAX package: events with times,
    round counters and sampled tokens equal JAX's under a ``VirtualClock``."""
    spec = dict(k=4)
    jeng = _jax_engine(spec, clock=True)
    eng = _engine(spec)
    eng._clock = VirtualClock()
    prompts = _prompts(eng.cfg.vocab)
    budgets = [m + 4 for _, m in SHAPES]
    chaos = dict(straggle_rounds=(0, 1, 2))
    jrep = jeng.serve_detailed(
        _requests(JaxRequest, prompts, budgets), chaos=JaxInjector(JaxChaosConfig(**chaos)),
        policy=JaxPolicy(round_time=1.0, ladder=JaxLadder(cooldown=1)),
        key=jax.random.PRNGKey(KEY), **SAMPLED)
    rep = eng.serve_detailed(
        _requests(Request, prompts, budgets), chaos=FaultInjector(ChaosConfig(**chaos)),
        policy=ResiliencePolicy(round_time=1.0, ladder=LadderConfig(cooldown=1)), key=KEY,
        **SAMPLED)
    _check(jeng, jrep, eng, rep, prompts, SAMPLED, "ladder", times=True)
    widths = [c["eff_k"] for c in rep.counters]
    assert {spec["k"], spec["k"] // 2, 0} <= set(widths), widths


def test_recompute_crash_replay_equals_the_undisturbed_serve():
    """A supervisor's crash replay (``resume_mode="recompute"``) re-admits
    the in-flight requests into both pools: the tokens of the undisturbed
    serve."""
    eng = _engine(dict(k=3))
    prompts = _prompts(eng.cfg.vocab, seed=3)
    budgets = [m + 4 for _, m in SHAPES]
    want = eng.serve(_requests(Request, prompts, budgets), key=KEY, **SAMPLED)
    sup = ServingSupervisor(eng, policy=ResiliencePolicy(resume_mode="recompute"),
                            chaos=FaultInjector(ChaosConfig(crash_rounds=(1, 3))))
    rep = sup.run(_requests(Request, prompts, budgets), key=KEY, **SAMPLED)
    assert rep.restarts == 2
    for w, g in zip(want, rep.outputs):
        np.testing.assert_array_equal(g, w)
    eng.assert_quiescent()

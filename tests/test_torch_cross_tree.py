"""Port parity: speculation on the continuous engine for the vlm and encdec
families (llama-3.2-vision-90b, seamless-m4t-medium), reduced, int8, each
request with its own extras, against the JAX package's engine on the same
traces, keys, seeds and geometry (2 slots, 4-token pages, chunk 3).

The vlm's gates are planted at 0.5 (``torch_helpers.cross_model``).  The
scheduler must decide alike: the same events, round counters (``eff_k``
included), window counts and pages; greedy tokens margin-aware at 1e-4
(``torch_helpers.assert_serve_match``), sampled ones, drawn from the JAX
package's window keys, equal.  n-gram (greedy, rejection-sampled), the
self-draft (the target's own int8 tree, whose
pool the admits prefill with the request's extras) and tree windows of fan
2.  Then the port alone: speculative serves emit plain greedy decoding's
tokens (as the JAX package's ``test_spec_*_parity_all_families``; the
adaptive controller's among them), a
window reads its own slot's extras (swap two requests' extras and their
tokens swap), and the prefix cache, a recompute crash replay, a preempting
pool and the degradation ladder keep working under speculation with
extras.  ``debug_check_hist`` holds in every speculative serve.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import ChaosConfig as JaxChaosConfig  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxCB  # noqa: E402
from repro.serving import FaultInjector as JaxInjector  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ResiliencePolicy as JaxPolicy  # noqa: E402
from repro.serving import SpecConfig as JaxSpec  # noqa: E402
from repro.serving import VirtualClock as JaxClock  # noqa: E402
from repro.serving.resilience import LadderConfig as JaxLadder  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ChaosConfig, ContinuousBatchingEngine, FaultInjector, LadderConfig, Request,
    ResiliencePolicy, ServingEngine, ServingSupervisor, SpecConfig, VirtualClock, speculative)

from torch_helpers import (  # noqa: E402,F401
    ENCDEC, VLM, assert_serve_match, cross_extras, cross_model, one_thread, serve_deciding,
    serve_events)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = [VLM, ENCDEC]
LOGIT_TOL = 1e-4
GEOMETRY = dict(slots=2, max_seq=24, page_size=4, chunk=3, page_alloc_seed=1, pim_bits=8)
SHAPES = ((5, 4), (7, 6), (3, 5), (9, 5))  # (prompt length, max_new): 4 over 2 slots
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)
KEY = 3
SERVES = {"greedy": (dict(k=3), {}), "sampled": (dict(k=3), SAMPLED),
          "draft_greedy": (dict(k=3, mode="draft"), {}),
          "tree_greedy": (dict(k=2, tree_fan=2), {}),
          "tree_sampled": (dict(k=2, tree_fan=2), SAMPLED)}
# The matrix split over the families (the fixed-engine tests run every mode
# on both): the self-draft and greedy tree windows on the vlm, whose dense
# stack has two lead dims, linear sampled windows on the encdec.  The
# adaptive controller's host-side widths are the dense family's code
# (tests/test_torch_spec_serving.py); here they are held against plain greedy
# decoding (``test_speculative_serves_emit_plain_greedy_tokens``).
SERVE_CASES = [(VLM, "greedy"), (VLM, "draft_greedy"), (VLM, "tree_greedy"),
               (VLM, "tree_sampled"), (ENCDEC, "greedy"), (ENCDEC, "sampled"),
               (ENCDEC, "tree_sampled")]


@pytest.fixture
def relocations(monkeypatch):
    """Every (accepted, kept chain) pair the engines relocate."""
    seen, sound = [], speculative.tree_relocate

    def recorded(cfg, cache, pos, a, cf, **kw):
        seen.append((a.clone(), cf.clone()))
        return sound(cfg, cache, pos, a, cf, **kw)
    monkeypatch.setattr(speculative, "tree_relocate", recorded)
    return seen


@functools.lru_cache(maxsize=None)
def _trace(arch, seed=0):
    """Prompts of a 5-token vocabulary (the n-gram proposer finds matches),
    budgets and each request's extras (no batch dim)."""
    jcfg, jparams, _, _ = cross_model(arch)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 5, size=n).astype(np.int32) for n, _ in SHAPES]
    ex = cross_extras(jcfg, jparams, len(SHAPES), seed=seed + 30)
    return prompts, [m for _, m in SHAPES], [{k: v[i] for k, v in ex.items()}
                                             for i in range(len(SHAPES))]


def _requests(cls, prompts, budgets, extras):
    return [cls(prompt=p.copy(), max_new=m, extras=e) for p, m, e in zip(prompts, budgets, extras)]


def _engines(arch, spec, clock=False, **geo):
    jcfg, jparams, tcfg, tparams = cross_model(arch)
    g = {**GEOMETRY, **geo}
    draft = {}
    if spec.get("mode") == "draft":
        draft = dict(draft_cfg=jcfg, draft_params=jparams, draft_pim_bits=8)
    jeng = JaxCB(jcfg, jparams, speculate=JaxSpec(**spec), clock=JaxClock() if clock else None,
                 **draft, **g)
    if draft:
        draft = dict(draft_cfg=tcfg, draft_params=tparams, draft_pim_bits=8)
    eng = ContinuousBatchingEngine(tcfg, tparams, speculate=SpecConfig(**spec), device="cpu",
                                   clock=VirtualClock() if clock else None, **draft, **g)
    eng.debug_check_hist = True
    return jeng, eng


def _counters(report, times=False):
    return [{k: v for k, v in c.items() if times or k != "ts"} for c in report.counters]


def _check(jeng, jrep, eng, rep, trace, mode, msg, times=False):
    prompts, _, extras = trace
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
        at = serve_deciding(eng.params, eng.cfg, prompts, rep.outputs, mode, KEY, extras)
        assert_serve_match(jrep.outputs, rep.outputs, at, LOGIT_TOL, msg=msg)
    eng.assert_quiescent()


@pytest.mark.parametrize("arch,name", SERVE_CASES)
def test_speculative_serve_matches_jax(arch, name, relocations):
    """Four requests over two slots (a freed slot takes the next request's
    extras): the JAX package's events, counters, window counts, pages and
    tokens; every window accepted or tree window relocated as JAX's did."""
    spec, mode = SERVES[name]
    jeng, eng = _engines(arch, spec)
    trace = _trace(arch)
    jrep = jeng.serve_detailed(_requests(JaxRequest, *trace), key=jax.random.PRNGKey(KEY), **mode)
    rep = eng.serve_detailed(_requests(Request, *trace), key=KEY, **mode)
    _check(jeng, jrep, eng, rep, trace, mode, f"{arch} {name}")
    assert eng.spec_live_steps > 0
    if spec.get("tree_fan"):
        assert relocations and {c["eff_k"] for c in rep.counters} == {spec["k"]}
    if spec.get("mode") == "draft":  # a self-draft accepts its proposals
        assert eng.spec_emitted > 2 * eng.spec_live_steps


@pytest.mark.parametrize("arch", FAMILIES)
def test_speculative_serves_emit_plain_greedy_tokens(arch):
    """As the JAX package's ``test_spec_continuous_engine_parity_all_families``:
    n-gram windows of k = 4, the adaptive controller's (plain rounds of
    width 0 among them) and tree windows of fan 2 emit the plain continuous
    engine's greedy tokens, and each request those of its solo fixed-batch
    run (margin-aware at 1e-4)."""
    _, _, tcfg, tparams = cross_model(arch)
    trace = _trace(arch, seed=1)
    prompts, budgets, extras = trace
    plain = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY).serve(
        _requests(Request, *trace))
    solo = ServingEngine(tcfg, tparams, max_seq=24, pim_bits=8, device="cpu")
    dense = [solo.generate(torch.from_numpy(p[None]), m,
                           extras={k: v[None] for k, v in e.items()})[0].numpy()
             for p, m, e in zip(prompts, budgets, extras)]
    for spec in (SpecConfig(k=4), SpecConfig(k=4, adaptive=True, ctrl_init=1.0),
                 SpecConfig(k=2, tree_fan=2)):
        eng = ContinuousBatchingEngine(tcfg, tparams, speculate=spec, device="cpu", **GEOMETRY)
        eng.debug_check_hist = True
        rep = eng.serve_detailed(_requests(Request, *trace))
        got = rep.outputs
        if spec.adaptive:  # the controller re-picks the width as the EMA falls
            assert len({c["eff_k"] for c in rep.counters}) > 1, arch
        at = serve_deciding(eng.params, tcfg, prompts, got, {}, 0, extras)
        assert_serve_match(plain, got, at, LOGIT_TOL, msg=f"{arch} {spec} vs plain")
        assert_serve_match(dense, got, at, LOGIT_TOL, msg=f"{arch} {spec} vs solo")
        assert [len(t) for t in got] == budgets and eng.spec_live_steps > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_extras_follow_their_slot_under_speculation(arch):
    """Two requests with one prompt and different extras, then the same two
    with their extras swapped: under linear and tree windows (greedy) the
    two outputs differ, and swap with the extras; each is its request's
    solo speculative serve's."""
    _, _, tcfg, tparams = cross_model(arch)
    prompts, _, extras = _trace(arch, seed=2)
    p = prompts[1]
    for spec in (SpecConfig(k=3), SpecConfig(k=2, tree_fan=2)):
        eng = ContinuousBatchingEngine(tcfg, tparams, speculate=spec, device="cpu", **GEOMETRY)
        a = eng.serve([Request(prompt=p, max_new=8, extras=e) for e in extras[:2]])
        b = eng.serve([Request(prompt=p, max_new=8, extras=e) for e in extras[1::-1]])
        alone = [eng.serve([Request(prompt=p, max_new=8, extras=e)])[0] for e in extras[:2]]
        assert not np.array_equal(a[0], a[1]), spec  # the extras move the tokens
        assert np.array_equal(b[0], a[1]) and np.array_equal(b[1], a[0]), spec
        assert all(np.array_equal(x, y) for x, y in zip(a, alone)), spec


def test_prefix_cache_crash_replay_and_preemption_under_speculation():
    """The vlm trace, sampled n-gram windows: with ``prefix_cache=True`` a
    repeated prompt hits only under its own extras, as in the JAX
    package's engine (events, counters and tokens equal); two scripted
    crashes replayed by recompute, and a pool small enough to preempt,
    give the undisturbed serve's tokens exactly."""
    spec = dict(k=3)
    prompts, budgets, extras = _trace(VLM, seed=3)
    prompts = prompts[:3] + [prompts[1].copy(), prompts[1].copy()]
    budgets = budgets[:3] + [4, 4]
    extras = extras[:3] + [extras[1], extras[0]]
    trace = (prompts, budgets, extras)
    jeng, eng = _engines(VLM, spec, prefix_cache=True)
    jrep = jeng.serve_detailed(_requests(JaxRequest, *trace), key=jax.random.PRNGKey(KEY),
                               **SAMPLED)
    rep = eng.serve_detailed(_requests(Request, *trace), key=KEY, **SAMPLED)
    _check(jeng, jrep, eng, rep, trace, SAMPLED, "prefix cache")
    cached = [e["cached_tokens"] for rec in rep.records for e in rec.events
              if e["name"] == "admit"]
    assert cached[3] > 0 and cached[4] == 0 and rep.prefix_hits == 1
    _, _, tcfg, tparams = cross_model(VLM)
    want = ContinuousBatchingEngine(tcfg, tparams, speculate=SpecConfig(**spec), device="cpu",
                                    **GEOMETRY).serve(_requests(Request, *trace), key=KEY,
                                                      **SAMPLED)
    crashed = ContinuousBatchingEngine(tcfg, tparams, speculate=SpecConfig(**spec),
                                       device="cpu", **GEOMETRY)
    sup = ServingSupervisor(crashed, policy=ResiliencePolicy(resume_mode="recompute"),
                            chaos=FaultInjector(ChaosConfig(crash_rounds=(1, 3))))
    got = sup.run(_requests(Request, *trace), key=KEY, **SAMPLED)
    assert got.restarts == 2
    assert all(np.array_equal(a, b) for a, b in zip(got.outputs, want))
    small = ContinuousBatchingEngine(tcfg, tparams, speculate=SpecConfig(**spec), device="cpu",
                                     **dict(GEOMETRY, num_pages=5))
    out = small.serve(_requests(Request, *trace), key=KEY, **SAMPLED)
    assert small.preemptions > 0
    assert all(np.array_equal(a, b) for a, b in zip(out, want))


def test_ladder_halves_then_drops_the_window_as_jax():
    """The encdec trace with stragglers in the first rounds: the ladder lifts
    through ``halve_k`` and ``no_spec`` and recovers; under a
    ``VirtualClock`` the events with times, round counters and ladder trace
    equal the JAX package's, greedy tokens margin-aware."""
    spec = dict(k=4)
    jeng, eng = _engines(ENCDEC, spec, clock=True)
    prompts, budgets, extras = _trace(ENCDEC)
    trace = (prompts, [m + 4 for m in budgets], extras)
    chaos = dict(straggle_rounds=(0, 1, 2))
    jrep = jeng.serve_detailed(_requests(JaxRequest, *trace),
                               chaos=JaxInjector(JaxChaosConfig(**chaos)),
                               policy=JaxPolicy(round_time=1.0, ladder=JaxLadder(cooldown=1)))
    rep = eng.serve_detailed(_requests(Request, *trace),
                             chaos=FaultInjector(ChaosConfig(**chaos)),
                             policy=ResiliencePolicy(round_time=1.0,
                                                     ladder=LadderConfig(cooldown=1)))
    _check(jeng, jrep, eng, rep, trace, {}, "ladder", times=True)
    assert [tuple(t) for t in rep.ladder_trace] == [tuple(t) for t in jrep.ladder_trace]
    assert {spec["k"], spec["k"] // 2, 0} <= {c["eff_k"] for c in rep.counters}

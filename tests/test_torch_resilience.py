"""Port parity: ``ContinuousBatchingEngine.serve_detailed`` under a
``ResiliencePolicy`` and seeded chaos, and the ``ServingSupervisor``'s crash
replay, of reduced qwen2-1.5b against the JAX package's, at
tests/test_chaos.py's geometry (2 slots, 4-token pages, chunk 3).

Under a ``VirtualClock`` and ``policy.round_time`` both packages' serves are
deterministic, so the scheduler must decide alike: the same statuses and
reasons, the same events with their times, the same round counters (with
the speculation width ``eff_k``, 0 without speculation), retries, sheds,
rejects, squeezed pages, injected latency, ladder trace, SLO attainment,
goodput, and the same snapshot JSON round by round.  Tokens are compared
margin-aware (``torch_helpers.assert_serve_match``, logit tolerance 1e-4
over the temperature): the port's decode linears run ``pim_matvec``'s plain
version and its prefill ``x @ dq(w)``, whose sums differ from JAX's by
~1e-6.  Then the port's own bars: transient faults, the ladder and
recompute replay give the undisturbed serve's tokens exactly; prefill
replay gives them up to near-ties (a resumed admit prefills tokens that the
undisturbed run decoded).
"""
import dataclasses
import json
import shutil

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
from repro.serving import VirtualClock as JaxClock  # noqa: E402
from repro.serving.resilience import LadderConfig as JaxLadder  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ChaosConfig, ContinuousBatchingEngine, EngineCrash, FaultInjector, LadderConfig, Request,
    ResiliencePolicy, ServingSupervisor, VirtualClock, load_snapshot)

from torch_helpers import (  # noqa: E402,F401
    assert_serve_match, one_thread, reduced_model, serve_deciding)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

LOGIT_TOL = 1e-4
GEOMETRY = dict(slots=2, max_seq=24, page_size=4, chunk=3, pim_bits=8)
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)
KEY = 7


def _trace(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(k)).astype(np.int32) for k in rng.integers(5, 10, n)]


def _requests(cls, prompts, max_new=8, **fields):
    """One request per prompt; ``fields[name]`` is a list of per-request
    values of that field (None: the default)."""
    out = []
    for i, p in enumerate(prompts):
        kw = {k: v[i] for k, v in fields.items() if v[i] is not None}
        out.append(cls(prompt=p.copy(), max_new=max_new, **kw))
    return out


def _engines(num_pages=None, **geo):
    jcfg, jparams, tcfg, tparams = reduced_model()
    g = {**GEOMETRY, **geo}
    if num_pages is not None:
        g["num_pages"] = num_pages
    jeng = JaxEngine(jcfg, jparams, clock=JaxClock(), **g)
    eng = ContinuousBatchingEngine(tcfg, tparams, clock=VirtualClock(), device="cpu", **g)
    return jeng, eng


def _policies(**kw):
    """(JAX policy, port policy, their snapshot JSON lists) with ``kw``."""
    jsnaps, snaps = [], []
    ladder = kw.pop("ladder", {})
    jpol = JaxPolicy(snapshot_sink=lambda s: jsnaps.append(s.to_json()),
                     ladder=JaxLadder(**ladder), **kw)
    pol = ResiliencePolicy(snapshot_sink=lambda s: snaps.append(s.to_json()),
                           ladder=LadderConfig(**ladder), **kw)
    return jpol, pol, jsnaps, snaps


def _counters(report):
    return list(report.counters)


def _facts(report):
    return {"statuses": [(r.status, r.reason) for r in report.records],
            "events": [r.events for r in report.records],
            "times": [(r.t_admit, r.t_first, r.t_done, r.met_deadline) for r in report.records],
            "counters": _counters(report),
            "numbers": (report.rounds, report.retries, report.straggle_s, report.squeezed_pages,
                        report.sheds, report.rejects, report.restarts,
                        report.max_ladder_level, report.slo_attainment(),
                        report.goodput_tokens(), report.prefill_tokens),
            "ladder": [tuple(t) for t in report.ladder_trace],
            "failures": [(f.host, f.at_step, f.kind) for f in report.failures]}


def _without_tokens(snaps):
    """Snapshot JSON with each token list replaced by its length."""
    out = []
    for s in snaps:
        d = json.loads(s)
        d["finished"] = {k: len(v) for k, v in d["finished"].items()}
        for v in d["inflight"].values():
            v["emitted"] = len(v["emitted"])
        out.append(d)
    return out


def _check(jrep, rep, jsnaps, snaps, eng, prompts, mode, msg):
    assert _facts(rep) == _facts(jrep), msg
    at = serve_deciding(eng.params, eng.cfg, prompts, rep.outputs, mode, KEY)
    diverged = assert_serve_match(jrep.outputs, rep.outputs, at,
                                  LOGIT_TOL / mode.get("temperature", 1.0), msg=msg)
    assert len(snaps) == len(jsnaps) and snaps, msg
    if diverged:
        assert _without_tokens(snaps) == _without_tokens(jsnaps), msg
    else:
        assert snaps == jsnaps, msg
    assert all(t.dtype == np.int32 for t in rep.outputs)


CASES = {
    # sheds by deadline, a late arrival, a bounded queue, a corrupt payload
    # and an oversized one; stragglers and chunk faults with their retries
    "policy": dict(
        fields=dict(deadline=[None, 30.0, 1.5, None, 4.0, None],
                    arrival=[None, None, None, 2.5, None, None],
                    slo=[1, 2, 0, 1, 1, 2]),
        chaos=dict(seed=4, fault_rate=0.3, straggle_rate=0.3, straggle_s=0.25,
                   corrupt_rids=(5,)),
        policy=dict(round_time=1.0, max_queue=4, ladder=dict(cooldown=2)),
        oversized=1, mode={}),
    # page squeezes on a tight pool (preemption), sampled, the ladder's shed rung
    "squeeze": dict(
        fields=dict(slo=[1, 0, 1, 1, 0, 1]),
        chaos=dict(seed=2, squeeze_rate=0.6, squeeze_frac=0.9, straggle_rounds=(0, 1, 2)),
        policy=dict(round_time=0.5, ladder=dict(cooldown=2, protect_slo=1)),
        geo=dict(max_seq=32, num_pages=10), max_new=16, mode=SAMPLED),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_policy_and_chaos_serve_matches_jax(name):
    case = CASES[name]
    jeng, eng = _engines(**case.get("geo", {}))
    prompts = _trace(eng.cfg.vocab)
    reqs = _requests(Request, prompts, case.get("max_new", 8), **case["fields"])
    jreqs = _requests(JaxRequest, prompts, case.get("max_new", 8), **case["fields"])
    if case.get("oversized") is not None:
        i = case["oversized"]
        reqs[i] = dataclasses.replace(reqs[i], max_new=100)
        jreqs[i] = dataclasses.replace(jreqs[i], max_new=100)
    jpol, pol, jsnaps, snaps = _policies(**case["policy"])
    mode = case["mode"]
    jrep = jeng.serve_detailed(jreqs, policy=jpol, chaos=JaxInjector(JaxChaosConfig(
        **case["chaos"])), key=jax.random.PRNGKey(KEY), **mode)
    inj = FaultInjector(ChaosConfig(**case["chaos"]))
    rep = eng.serve_detailed(reqs, policy=pol, chaos=inj, key=KEY, **mode)
    _check(jrep, rep, jsnaps, snaps, eng, prompts, mode, name)
    statuses = {r.status for r in rep.records}
    assert "done" in statuses and (statuses - {"done"}), statuses
    assert rep.max_ladder_level > 0
    if name == "policy":
        assert rep.retries > 0 and rep.straggle_s > 0 and rep.rejects == 2
        assert {r.reason for r in rep.records} >= {"deadline", "corrupt"}
    else:
        assert rep.squeezed_pages > 0 and eng.preemptions > 0
        assert any(r.reason == "ladder" for r in rep.records)
    eng.assert_quiescent()


def _supervised(mod_engine, eng, chaos_cfg, policy_kw, reqs, mode, key, **sup_kw):
    clk = eng._clock if isinstance(eng._clock, (VirtualClock, JaxClock)) else None
    if mod_engine == "jax":
        sup = JaxSupervisor(eng, policy=JaxPolicy(**policy_kw),
                            chaos=JaxInjector(JaxChaosConfig(**chaos_cfg)), clock=clk, **sup_kw)
    else:
        sup = ServingSupervisor(eng, policy=ResiliencePolicy(**policy_kw),
                                chaos=FaultInjector(ChaosConfig(**chaos_cfg)), clock=clk,
                                **sup_kw)
    return sup.run(reqs, key=key, **mode), sup


@pytest.mark.parametrize("resume_mode", ["prefill", "recompute"])
def test_crash_replay_matches_jax(resume_mode):
    """Two scripted crashes under the supervisor, sampled: the same
    restarts, failures, events (a resumed admit prefills the prompt and all
    but the last emitted token) and snapshots as the JAX package's."""
    jeng, eng = _engines()
    prompts = _trace(eng.cfg.vocab, seed=3)
    pol = dict(round_time=1.0, resume_mode=resume_mode)
    chaos_cfg = dict(crash_rounds=(1, 3))
    jrep, _ = _supervised("jax", jeng, chaos_cfg, pol, _requests(JaxRequest, prompts, 10),
                          SAMPLED, jax.random.PRNGKey(KEY))
    rep, _ = _supervised("torch", eng, chaos_cfg, pol, _requests(Request, prompts, 10),
                         SAMPLED, KEY)
    assert rep.restarts == 2 and all(f.kind.startswith("crash:injected") for f in rep.failures)
    resumed = [e["prefilled_tokens"] - len(p) for r, p in zip(rep.records, prompts)
               for e in r.events if e["name"] == "admit"]
    assert any(resumed) == (resume_mode == "prefill"), resumed
    jsnap, snap = jeng.last_snapshot.to_json(), eng.last_snapshot.to_json()
    _check(jrep, rep, [jsnap], [snap], eng, prompts, SAMPLED, resume_mode)


def test_snapshot_file_resumes_across_packages(tmp_path):
    """A crash with no restart leaves the snapshot file; a fresh engine of
    either package resumes from a copy of it, and the two finish the trace
    alike (statuses, events, counters, tokens, final snapshot)."""
    for first in ("jax", "torch"):
        crashed = str(tmp_path / f"{first}.snap")
        jeng, eng = _engines()
        prompts = _trace(eng.cfg.vocab, seed=5)
        e, cls, key = {"jax": (jeng, JaxRequest, jax.random.PRNGKey(KEY)),
                       "torch": (eng, Request, KEY)}[first]
        with pytest.raises(Exception, match="injected engine crash"):
            _supervised(first, e, dict(crash_rounds=(2,)), dict(round_time=1.0),
                        _requests(cls, prompts, 10), {}, key, max_restarts=0,
                        snapshot_path=crashed)
        assert load_snapshot(crashed).inflight
        jfresh, fresh = _engines()
        reps = []
        for who, e, cls, key, sup_cls, pol_cls in (
                ("jax", jfresh, JaxRequest, jax.random.PRNGKey(KEY), JaxSupervisor, JaxPolicy),
                ("torch", fresh, Request, KEY, ServingSupervisor, ResiliencePolicy)):
            path = str(tmp_path / f"{first}-{who}.snap")
            shutil.copy(crashed, path)
            reps.append(sup_cls(e, policy=pol_cls(round_time=1.0), snapshot_path=path,
                                clock=e._clock).run(_requests(cls, prompts, 10), key=key))
        jrep, rep = reps
        assert all(r.status == "done" for r in rep.records) and rep.rounds > 0
        _check(jrep, rep, [jfresh.last_snapshot.to_json()], [fresh.last_snapshot.to_json()],
               fresh, prompts, {}, f"written by {first}")


# ---- the port's own bars ---------------------------------------------------------
def _port(**geo):
    _, _, tcfg, tparams = reduced_model()
    return ContinuousBatchingEngine(tcfg, tparams, device="cpu", **{**GEOMETRY, **geo})


def _same(want, got, msg=""):
    assert len(want) == len(got), msg
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"{msg} request {i}")


@pytest.mark.parametrize("mode", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_transient_chaos_keeps_every_token(mode):
    """Chunk faults, stragglers and squeezes on a tight pool: each request's
    tokens equal the undisturbed serve's exactly."""
    prompts = _trace(101, seed=8)
    geo = dict(max_seq=32, num_pages=11)
    want = _port(**geo).serve(_requests(Request, prompts, 12), key=KEY, **mode)
    eng = _port(**geo)
    inj = FaultInjector(ChaosConfig(seed=2, fault_rate=0.3, straggle_rate=0.3,
                                    squeeze_rate=0.5, squeeze_frac=0.7))
    rep = eng.serve_detailed(_requests(Request, prompts, 12), chaos=inj, key=KEY, **mode)
    assert all(r.status == "done" for r in rep.records)
    _same(want, rep.outputs)
    counts = inj.counts
    assert counts.get("chunk", 0) == rep.retries > 0 and counts.get("squeeze", 0) > 0
    assert counts.get("straggle", 0) > 0 and eng.preemptions > 0
    eng.assert_quiescent()


def test_halved_chunk_keeps_every_token():
    """Stragglers at rounds 0 and 1 lift the ladder to ``halve_chunk`` and
    on; the halved rounds run fewer chunk steps on the same buffers and
    read only their rows, and the tokens are the undisturbed serve's."""
    prompts = _trace(101, seed=9, n=4)
    geo = dict(chunk=4, max_seq=32)
    want_eng = _port(**geo)
    want = want_eng.serve(_requests(Request, prompts, 14), key=KEY, **SAMPLED)
    eng = _port(**geo)
    rep = eng.serve_detailed(_requests(Request, prompts, 14), key=KEY, **SAMPLED,
                             chaos=FaultInjector(ChaosConfig(straggle_rounds=(0, 1))),
                             policy=ResiliencePolicy(ladder=LadderConfig(cooldown=2)))
    _same(want, rep.outputs)
    halved = [c["round"] for c in rep.counters if 1 <= _rung(rep.ladder_trace, c["round"])]
    assert halved and rep.max_ladder_level == 2
    assert any(r == "recovered" for _, _, r in rep.ladder_trace)
    assert eng.decode_chunk_iters < want_eng.decode_chunk_iters + 2 * len(halved)
    assert eng.decode_chunk_iters == sum(2 if c["round"] in halved else 4 for c in rep.counters)


def _rung(trace, rnd):
    """The ladder's rung during round ``rnd`` (set by the rounds before)."""
    level = 0
    for r, lvl, _ in trace:
        if r < rnd:
            level = lvl
    return level


def test_supervisor_replay_both_modes_and_fresh_engine_from_disk(tmp_path):
    """Crash replay: recompute gives the undisturbed tokens exactly, prefill
    up to near-ties (LOGIT_TOL); a fresh engine resumes from the snapshot
    file; the restarts equal the scripted crashes and every failure is an
    injected one."""
    prompts = _trace(101, seed=10)
    eng0 = _port()
    want = eng0.serve(_requests(Request, prompts, 10), key=KEY, **SAMPLED)
    for resume_mode in ("recompute", "prefill"):
        eng = _port()
        rep, sup = _supervised("torch", eng, dict(crash_rounds=(1, 3)),
                               dict(resume_mode=resume_mode), _requests(Request, prompts, 10),
                               SAMPLED, KEY)
        assert rep.restarts == 2 == sup.restarts
        assert [f.kind for f in rep.failures] == [
            "crash:injected engine crash at round 1", "crash:injected engine crash at round 1"]
        if resume_mode == "recompute":
            _same(want, rep.outputs, resume_mode)
        else:
            at = serve_deciding(eng.params, eng.cfg, prompts, rep.outputs, SAMPLED, KEY)
            assert_serve_match(want, rep.outputs, at, LOGIT_TOL / SAMPLED["temperature"])
            assert eng.prefill_tokens > sum(len(p) for p in prompts)
        eng.assert_quiescent()
    path = str(tmp_path / "serve.snap")
    with pytest.raises(EngineCrash):
        _supervised("torch", _port(), dict(crash_rounds=(2,)), {},
                    _requests(Request, prompts, 10), SAMPLED, KEY, max_restarts=0,
                    snapshot_path=path)
    assert load_snapshot(path).inflight
    fresh = _port()
    rep = ServingSupervisor(fresh, snapshot_path=path).run(_requests(Request, prompts, 10),
                                                           key=KEY, **SAMPLED)
    at = serve_deciding(fresh.params, fresh.cfg, prompts, rep.outputs, SAMPLED, KEY)
    assert_serve_match(want, rep.outputs, at, LOGIT_TOL / SAMPLED["temperature"])
    assert all(r.status == "done" for r in rep.records)


def test_exhaustion_poison_and_strict_sweep(monkeypatch):
    """Retries exhausted become a crash (with a snapshot left); restarts past
    ``max_restarts`` raise; an escaped crash poisons the pool until the next
    serve, whose ``_reset`` zeroes the kept buffers without making new ones;
    a dropped request raises under the strict sweep, is coerced when the
    serve opts out, and raises without a policy."""
    prompts = _trace(101, seed=11, n=4)
    eng = _port()
    with pytest.raises(EngineCrash, match="retries exhausted"):
        eng.serve_detailed(_requests(Request, prompts), policy=ResiliencePolicy(max_retries=2),
                           chaos=FaultInjector(ChaosConfig(fault_rounds=tuple(range(10)))))
    assert eng.last_snapshot is not None
    with pytest.raises(AssertionError, match="poisoned"):
        eng.assert_quiescent()
    state, cache = eng._state, eng._state.cache["layers"]["k"]
    want = _port().serve(_requests(Request, prompts))
    _same(want, eng.serve(_requests(Request, prompts)))
    assert eng._state is state and eng._state.cache["layers"]["k"] is cache
    eng.assert_quiescent()
    sup = ServingSupervisor(_port(), chaos=FaultInjector(ChaosConfig(crash_rate=1.0)),
                            max_restarts=3)
    with pytest.raises(EngineCrash):
        sup.run(_requests(Request, prompts))
    assert sup.restarts == 4
    monkeypatch.setenv("REPRO_STRICT_SERVE", "1")
    eng._debug_drop_rids = {1}
    with pytest.raises(RuntimeError, match="scheduler dropped requests"):
        eng.serve_detailed(_requests(Request, prompts), policy=ResiliencePolicy())
    eng.strict_pending = False
    rep = eng.serve_detailed(_requests(Request, prompts), policy=ResiliencePolicy())
    assert [(r.status, r.reason) for r in rep.records][:2] == [("done", ""),
                                                               ("done", "coerced-pending")]
    with pytest.raises(RuntimeError, match="scheduler dropped requests"):
        eng.serve_detailed(_requests(Request, prompts))


def test_oom_shed_with_a_policy_and_raise_without():
    """Prompts that can never fit a pool of one page: without a policy the
    serve raises, with one both are shed as "oom" and the pool is
    quiescent; a policy rejects an oversized request that raises without."""
    prompts = _trace(101, seed=12, n=2)
    prompts = [np.concatenate([p, p])[:8] for p in prompts]
    eng = _port(max_seq=16, num_pages=2)
    with pytest.raises(RuntimeError, match="page pool too small"):
        eng.serve(_requests(Request, prompts, 4))
    rep = eng.serve_detailed(_requests(Request, prompts, 4), policy=ResiliencePolicy())
    assert [(r.status, r.reason) for r in rep.records] == [("shed", "oom")] * 2
    assert rep.sheds == 2
    eng.assert_quiescent()
    big = _requests(Request, prompts, 40)
    with pytest.raises(ValueError, match="max_seq"):
        eng.serve(big)
    rep = eng.serve_detailed(big, policy=ResiliencePolicy())
    assert [r.status for r in rep.records] == ["rejected"] * 2 and rep.rejects == 2


def _shared_prefix(vocab, n_new=6):
    """tests/test_prefix_cache.py's ``_shared_prefix_requests`` for two rows."""
    rng = np.random.default_rng(13)
    reqs = []
    for i, row in enumerate(rng.integers(0, vocab, (2, 8)).astype(np.int32)):
        reqs.append(Request(prompt=row.copy(), max_new=n_new))
        tail = row.copy()
        tail[-2:] = (tail[-2:] + 1 + i) % vocab
        reqs.append(Request(prompt=tail, max_new=n_new))
    return reqs


def test_prefix_cache_crash_replay_and_squeeze():
    """tests/test_prefix_cache.py's crash replay (a resumed admit probes and
    registers nothing; the replay rebuilds pool and trie) and squeeze cases
    on a cached engine: tokens as the uncached serve's (margin-aware, a
    hit's window and a miss's prefill differing by ~1e-7), pools quiescent."""
    geo = dict(max_seq=24, num_pages=20)
    reqs = _shared_prefix(101)
    prompts = [r.prompt for r in reqs]
    want = _port(**geo).serve(reqs, key=KEY, **SAMPLED)
    eng = _port(prefix_cache=True, **geo)
    rep, _ = _supervised("torch", eng, dict(crash_rounds=(1,)), {}, reqs, SAMPLED, KEY)
    assert rep.restarts == 1 and all(r.status == "done" for r in rep.records)
    at = serve_deciding(eng.params, eng.cfg, prompts, rep.outputs, SAMPLED, KEY)
    assert_serve_match(want, rep.outputs, at, LOGIT_TOL / SAMPLED["temperature"])
    eng.assert_quiescent()
    reqs8 = _shared_prefix(101, n_new=8)
    want8 = _port(**geo).serve(reqs8)
    tight = _port(prefix_cache=True, **{**geo, "num_pages": 12})
    rep = tight.serve_detailed(reqs8, chaos=FaultInjector(ChaosConfig(
        squeeze_rounds=(1, 2), squeeze_frac=0.5)))
    assert rep.squeezed_pages > 0 and tight.prefix_hits > 0
    at = serve_deciding(tight.params, tight.cfg, [r.prompt for r in reqs8], rep.outputs, {},
                        KEY)
    assert_serve_match(want8, [r.tokens for r in rep.records], at, LOGIT_TOL)
    tight.assert_quiescent()

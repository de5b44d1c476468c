"""Port parity: ``ReplicaRouter`` over the port's continuous engines against
the JAX package's router, on tests/test_router_trace.py's fleet trace (two
system-prompt groups of three requests, each group sharing its first pages
and perturbing its tail), reduced qwen2-1.5b, 4-token pages.

``route`` is host-side planning over shadow prefix tries and must assign
every request as the JAX package's does, with the same affinity hits.
Routed tokens equal a solo port engine's: exactly with the prefix cache
off (every replica runs the solo engine's arithmetic on the same
(request id, counter) keys), margin-aware with it on (a request that hits
on its replica may have missed solo; a hit's window and a miss's prefill
differ by ~1e-7 on the CPU).  And ``tools/trace_export.py`` renders the
port's solo and router reports, under a ``VirtualClock``, into traces that
pass ``validate_trace`` and equal the JAX package's, its speculation-width
(``eff_k``) counter track included.
"""
import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import ReplicaRouter as JaxRouter  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ResiliencePolicy as JaxPolicy  # noqa: E402
from repro.serving import VirtualClock as JaxClock  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine, ReplicaRouter, Request, ResiliencePolicy, VirtualClock)

from torch_helpers import (  # noqa: E402,F401
    assert_serve_match, one_thread, reduced_model, serve_deciding)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
GEOMETRY = dict(slots=2, max_seq=24, page_size=4, chunk=3, num_pages=20, pim_bits=8)
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)
KEY = 3
LOGIT_TOL = 1e-4


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


trace_export = _load_tool("trace_export")


def _fleet(cls, vocab, n_per_group=3, n_new=5):
    rows = np.random.default_rng(1).integers(0, vocab, (2, 8)).astype(np.int32)
    reqs = []
    for g in range(2):
        for j in range(n_per_group):
            tail = rows[g].copy()
            if j:
                tail[-2:] = (tail[-2:] + j) % vocab
            reqs.append(cls(prompt=tail, max_new=n_new))
    return reqs


def _port(prefix_cache=True, clock=None):
    _, _, tcfg, tparams = reduced_model()
    return ContinuousBatchingEngine(tcfg, tparams, prefix_cache=prefix_cache, clock=clock,
                                    device="cpu", **GEOMETRY)


def _jax(clock=None):
    jcfg, jparams, _, _ = reduced_model()
    return JaxEngine(jcfg, jparams, prefix_cache=True, clock=clock, **GEOMETRY)


def test_route_assignments_and_affinity_equal_jax():
    _, _, tcfg, _ = reduced_model()
    ports, jaxes = [_port() for _ in range(3)], [_jax() for _ in range(3)]
    for shape in ((3, 5), (4, 3)):
        reqs, jreqs = _fleet(Request, tcfg.vocab, *shape), _fleet(JaxRequest, tcfg.vocab, *shape)
        extra = [Request(prompt=np.arange(1, 12, dtype=np.int32), max_new=9)]
        jextra = [JaxRequest(prompt=np.arange(1, 12, dtype=np.int32), max_new=9)]
        for n in (1, 2, 3):
            assert (ReplicaRouter(ports[:n]).route(reqs + extra)
                    == JaxRouter(jaxes[:n]).route(jreqs + jextra))
    assign = ReplicaRouter(ports[:2]).route(reqs)
    groups = len(reqs) // 2
    assert len(set(assign[:groups])) == 1 and len(set(assign[groups:])) == 1
    assert assign[0] != assign[groups]
    with pytest.raises(ValueError, match="at least one"):
        ReplicaRouter([])
    other = ContinuousBatchingEngine(tcfg, reduced_model()[3], device="cpu",
                                     **{**GEOMETRY, "page_size": 8})
    with pytest.raises(ValueError, match="page_size"):
        ReplicaRouter([ports[0], other])


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["uncached", "cached"])
def test_router_tokens_match_a_solo_engine(prefix_cache):
    _, _, tcfg, _ = reduced_model()
    reqs = _fleet(Request, tcfg.vocab)
    prompts = [r.prompt for r in reqs]
    jrep = JaxRouter([_jax(), _jax()]).serve_detailed(_fleet(JaxRequest, tcfg.vocab))
    for mode in ({}, SAMPLED):
        solo = _port(prefix_cache)
        want = solo.serve(reqs, key=KEY, **mode)
        rep = ReplicaRouter([_port(prefix_cache), _port(prefix_cache)]).serve_detailed(
            reqs, key=KEY, **mode)
        assert len(rep.done()) == len(reqs)
        assert [getattr(r, "replica") for r in rep.records] == rep.assignments
        if prefix_cache:
            at = serve_deciding(solo.params, tcfg, prompts, rep.outputs, mode, KEY)
            assert_serve_match(want, rep.outputs, at, LOGIT_TOL / mode.get("temperature", 1.0))
            assert rep.affinity_hits == 4 and rep.prefix_hits >= 4
        else:
            for w, g in zip(want, rep.outputs):
                np.testing.assert_array_equal(g, w)
            assert rep.prefix_hits == 0
    if prefix_cache:
        assert (rep.assignments, rep.affinity_hits, rep.prefix_hits, rep.prefix_hit_tokens,
                rep.prefill_tokens, rep.cow_forks) == (
            jrep.assignments, jrep.affinity_hits, jrep.prefix_hits, jrep.prefix_hit_tokens,
            jrep.prefill_tokens, jrep.cow_forks)


def _dump(trace):
    """A trace as sorted JSON."""
    return json.dumps(trace_export._jsonable(trace), sort_keys=True)


def test_trace_export_of_port_reports_equals_jax_s(tmp_path):
    _, _, tcfg, _ = reduced_model()
    reqs, jreqs = _fleet(Request, tcfg.vocab), _fleet(JaxRequest, tcfg.vocab)
    pol, jpol = ResiliencePolicy(round_time=0.5), JaxPolicy(round_time=0.5)
    solo = trace_export.report_to_trace(
        _port(clock=VirtualClock()).serve_detailed(reqs, policy=pol))
    jsolo = trace_export.report_to_trace(
        _jax(clock=JaxClock()).serve_detailed(jreqs, policy=jpol, key=jax.random.PRNGKey(0)))
    assert trace_export.validate_trace(json.loads(_dump(solo))) > len(reqs)
    assert _dump(solo) == _dump(jsolo)
    names = {e["name"].split()[0] for e in solo["traceEvents"]}
    assert {"admit", "decode", "finish", "free_pages", "retries"} <= names
    router = ReplicaRouter([_port(clock=VirtualClock()) for _ in range(2)])
    jrouter = JaxRouter([_jax(clock=JaxClock()) for _ in range(2)])
    rtrace = trace_export.router_report_to_trace(router.serve_detailed(reqs, policy=pol))
    jtrace = trace_export.router_report_to_trace(jrouter.serve_detailed(jreqs, policy=jpol))
    assert _dump(rtrace) == _dump(jtrace)
    path = tmp_path / "router.trace.json"
    n = trace_export.write_trace(rtrace, str(path))
    assert trace_export.validate_trace(json.loads(path.read_text())) == n
    assert {e["pid"] for e in rtrace["traceEvents"]} == {0, 1}

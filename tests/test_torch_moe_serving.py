"""Port parity for serving the moe family: reduced moonshot-v1-16b-a3b, int8
weights, on both engines, against the JAX package's engines.

Greedy tokens compare margin-aware at 1e-4 (``torch_helpers.
assert_greedy_match``; the port's decode linears run ``pim_matvec``'s plain
version, the JAX package's ``x @ dq(w)``), sampled ones exactly: the draws
are keyed per (row or request, draw index) as the JAX package keys them.
A request's routing is a function of its own row (each row a dispatch
group), so each request's tokens are also those of its solo run.  The moe
family takes no prefix hit, as in the JAX package.  Its speculation is held
in ``tests/test_torch_moe_spec.py``.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import ContinuousBatchingEngine as JaxBatchingEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.models import init_cache, prefill  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ChaosConfig, ContinuousBatchingEngine, FaultInjector, Request, ResiliencePolicy,
    ServingEngine, ServingSupervisor)

from torch_helpers import (  # noqa: E402,F401
    CPU, assert_greedy_match, assert_serve_match, moe_model, one_thread, prompt,
    serve_deciding, serve_events)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)
KEY = 5
GEOMETRY = dict(slots=2, max_seq=24, page_size=4, chunk=3, page_alloc_seed=1, pim_bits=8)
SHAPES = ((5, 4), (7, 6), (3, 3), (9, 5), (6, 4))  # (prompt length, max_new): 5 over 2 slots


@functools.lru_cache(maxsize=None)
def _engines():
    jcfg, jparams, tcfg, tparams = moe_model()
    return (JaxEngine(jcfg, jparams, max_seq=16, pim_bits=8),
            ServingEngine(tcfg, tparams, max_seq=16, pim_bits=8, device="cpu"))


def _trace(seed=0):
    jcfg = moe_model()[0]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32) for n, _ in SHAPES]
    return prompts, [m for _, m in SHAPES]


def _requests(cls, prompts, budgets, **kw):
    return [cls(prompt=p, max_new=m, **kw) for p, m in zip(prompts, budgets)]


def _solo(prompts, budgets, mode):
    """Each request alone on the fixed engine, its request id as the row's
    key id (request r's draws are row r's of a batch of r + 1 copies)."""
    eng = _engines()[1]
    return [eng.generate(torch.from_numpy(np.repeat(p[None], r + 1, axis=0)), m, key=KEY,
                         **mode)[r].numpy()
            for r, (p, m) in enumerate(zip(prompts, budgets))]


# ---------------------------------------------------------- fixed batch -----
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_generate_matches_jax(mode):
    """``ServingEngine.generate`` (3 x 6, 8 new, int8): greedy margin-aware
    against the JAX package's, sampled key for key.  Not against the
    per-token ``generate_reference``: its one-token prompt steps route
    each token alone, where the prefill's 6-token group has a capacity of
    2 and drops pairs (in both packages)."""
    jeng, eng = _engines()
    toks = prompt(3, 6, jeng.cfg.vocab, seed=12)
    kw = {} if mode == "greedy" else dict(SAMPLED)
    want = np.asarray(jeng.generate(jnp.asarray(toks), 8, key=jax.random.PRNGKey(KEY), **kw))
    got = eng.generate(torch.from_numpy(toks), 8, key=KEY, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 8)
    if mode == "sampled":
        np.testing.assert_array_equal(got.numpy(), want)
        return

    def at(row, j):
        seq = np.concatenate([toks[row], got[row, :j].numpy()])[None]
        logits, _ = prefill(eng.params, eng.cfg, torch.from_numpy(seq),
                            init_cache(eng.cfg, 1, seq.shape[1], CPU))
        return logits[0, -1].numpy()
    assert_greedy_match(want, got.numpy(), at, TOL, msg="moe")


# ---------------------------------------------------------- continuous ------
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_serve_matches_jax_and_solo_runs(mode):
    """Five requests over two slots of 4-token pages on a shuffled pool:
    the JAX package's events, counters and pages, tokens margin-aware
    (sampled: exactly), and each request the tokens of its solo run."""
    jcfg, jparams, tcfg, tparams = moe_model()
    prompts, budgets = _trace()
    kw = {} if mode == "greedy" else dict(SAMPLED)
    jeng = JaxBatchingEngine(jcfg, jparams, **GEOMETRY)
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets),
                               key=jax.random.PRNGKey(KEY), **kw)
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    rep = eng.serve_detailed(_requests(Request, prompts, budgets), key=KEY, **kw)
    assert serve_events(rep) == serve_events(jrep)
    assert (rep.rounds, eng.decode_chunk_iters, eng.peak_pages_in_use) == (
        jrep.rounds, jeng.decode_chunk_iters, jeng.peak_pages_in_use)
    at = serve_deciding(eng.params, tcfg, prompts, rep.outputs, kw or {"greedy": True}, KEY)
    if mode == "sampled":
        assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, jrep.outputs))
    else:
        assert_serve_match(jrep.outputs, rep.outputs, at, TOL, msg="moe")
    assert_serve_match(_solo(prompts, budgets, kw), rep.outputs, at, TOL, msg="moe solo")
    assert [len(t) for t in rep.outputs] == budgets and eng.pages_in_use() == 0


def test_preemption_gives_the_unpreempted_tokens():
    """A pool of 9 pages for two requests of 20 new tokens: the younger is
    preempted and recomputed, the events are the JAX package's, and the
    tokens equal an unpreempted run's exactly."""
    jcfg, jparams, tcfg, tparams = moe_model()
    geo = dict(slots=2, max_seq=32, page_size=4, chunk=4, pim_bits=8)
    prompts = [prompt(1, 8, jcfg.vocab, seed=s)[0] for s in (1, 2)]
    jeng = JaxBatchingEngine(jcfg, jparams, num_pages=9, **geo)
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, [20, 20]),
                               key=jax.random.PRNGKey(KEY), **SAMPLED)
    eng = ContinuousBatchingEngine(tcfg, tparams, num_pages=9, device="cpu", **geo)
    rep = eng.serve_detailed(_requests(Request, prompts, [20, 20]), key=KEY, **SAMPLED)
    assert eng.preemptions == jeng.preemptions > 0
    assert serve_events(rep) == serve_events(jrep)
    assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, jrep.outputs))
    roomy = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **geo)
    want = roomy.serve(_requests(Request, prompts, [20, 20]), key=KEY, **SAMPLED)
    assert roomy.preemptions == 0
    assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, want))


def test_recompute_crash_replay_equals_the_undisturbed_serve():
    """Two scripted crashes under the supervisor, recompute replay: every
    request re-admitted over its prompt and emitted tokens, the tokens those
    of the undisturbed serve exactly."""
    _, _, tcfg, tparams = moe_model()
    prompts, budgets = _trace(seed=3)
    want = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY).serve(
        _requests(Request, prompts, budgets), key=KEY, **SAMPLED)
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    sup = ServingSupervisor(eng, policy=ResiliencePolicy(resume_mode="recompute"),
                            chaos=FaultInjector(ChaosConfig(crash_rounds=(1, 3))))
    rep = sup.run(_requests(Request, prompts, budgets), key=KEY, **SAMPLED)
    assert rep.restarts == 2
    assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, want))
    eng.assert_quiescent()


def test_the_prefix_cache_takes_no_hit():
    """``prefix_cache=True`` on a repeated prompt: the moe family is not
    among the prefix families, so, as in the JAX package, nothing is cached
    or hit, the events are the JAX package's and the tokens the uncached
    serve's."""
    jcfg, jparams, tcfg, tparams = moe_model()
    base = np.random.default_rng(30).integers(0, jcfg.vocab, size=9).astype(np.int32)
    prompts, budgets = [base, base, base], [3, 3, 3]
    geo = dict(GEOMETRY, slots=1)
    jeng = JaxBatchingEngine(jcfg, jparams, prefix_cache=True, **geo)
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets))
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", prefix_cache=True, **geo)
    rep = eng.serve_detailed(_requests(Request, prompts, budgets))
    assert serve_events(rep) == serve_events(jrep)
    cached = [e["cached_tokens"] for rec in rep.records for e in rec.events
              if e["name"] == "admit"]
    assert cached == [0, 0, 0] and eng.prefix_hits == jeng.prefix_hits == 0
    plain = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **geo).serve(
        _requests(Request, prompts, budgets))
    assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, plain))

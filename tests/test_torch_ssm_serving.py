"""Port parity for serving the ssm family: reduced falcon-mamba-7b, int8, on
both engines against the JAX package's on the same weights, requests, key,
seed and geometry.

The continuous engine keeps one row of state per slot beside its block
tables: each admit prefills the page-padded prompt from a zero state into
its slot's row, the prompt's true length masking the pads out of it
(``admit_miss`` passes the slot), and no other row changes.  Events,
counters and pages are the JAX package's; greedy tokens compare
margin-aware at 1e-4 (``torch_helpers.assert_serve_match``: the port's
decode linears run ``pim_matvec``'s plain version, the JAX package's ``x @
dq(w)``), sampled ones exactly.  Each request also gives its solo run's
tokens, preemption the unpreempted tokens, and the prefix cache no hit (the
ssm family is not a prefix family, in either package).
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
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ChaosConfig, ContinuousBatchingEngine, FaultInjector, Request, ResiliencePolicy,
    ServingEngine, ServingSupervisor)
from repro_torch.serving.engine import admit_miss, admit_prefill, decode_chunk_step  # noqa: E402

from torch_helpers import (  # noqa: E402,F401
    CPU, assert_greedy_match, assert_serve_match, one_thread, prompt, reduced_model,
    serve_deciding, serve_events)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

SSM = "falcon-mamba-7b"
TOL = 1e-4
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)
KEY = 5
GEOMETRY = dict(slots=2, max_seq=24, page_size=4, chunk=3, page_alloc_seed=1, pim_bits=8)
SHAPES = ((5, 4), (7, 6), (3, 3), (9, 5), (4, 7))  # the JAX package's staggered trace


def _model():
    return reduced_model(arch=SSM)


@functools.lru_cache(maxsize=None)
def _engines():
    jcfg, jparams, tcfg, tparams = _model()
    return (JaxEngine(jcfg, jparams, max_seq=24, pim_bits=8),
            ServingEngine(tcfg, tparams, max_seq=24, pim_bits=8, device="cpu"))


def _trace(seed=0):
    rng = np.random.default_rng(seed)
    vocab = _model()[0].vocab
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n, _ in SHAPES], [
        m for _, m in SHAPES]


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
    """``ServingEngine.generate`` (3 x 6, 10 new, int8): greedy margin-aware
    against the JAX package's and the per-token ``generate_reference`` (its
    prompt runs through decode steps, the engine's through the chunked
    prefill), sampled key for key."""
    jeng, eng = _engines()
    toks = prompt(3, 6, jeng.cfg.vocab, seed=12)
    kw = {} if mode == "greedy" else dict(SAMPLED)
    want = np.asarray(jeng.generate(jnp.asarray(toks), 10, key=jax.random.PRNGKey(KEY), **kw))
    got = eng.generate(torch.from_numpy(toks), 10, key=KEY, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 10)
    if mode == "sampled":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    at = serve_deciding(eng.params, eng.cfg, list(toks), list(got.numpy()), {}, KEY)
    assert_greedy_match(want, got.numpy(), at, TOL, msg="ssm")
    ref = eng.generate_reference(torch.from_numpy(toks), 10, key=KEY)
    assert_greedy_match(ref.numpy(), got.numpy(), at, TOL, msg="ssm reference")


# ---------------------------------------------------------- continuous ------
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_staggered_serve_matches_jax_and_solo_runs(mode):
    """The JAX package's staggered trace (5 requests of 3-9 prompt tokens,
    none a page multiple, over 2 slots of 4-token pages on a shuffled
    pool): its events, counters and pages, tokens margin-aware (sampled:
    exactly), and each request the tokens of its solo run; the pool never
    needs the dense worst case."""
    jcfg, jparams, tcfg, tparams = _model()
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
    assert eng.peak_pages_in_use < eng.slots * eng.width
    at = serve_deciding(eng.params, tcfg, prompts, rep.outputs, kw or {"greedy": True}, KEY)
    if mode == "sampled":
        assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, jrep.outputs))
    else:
        assert_serve_match(jrep.outputs, rep.outputs, at, TOL, msg="ssm")
    assert_serve_match(_solo(prompts, budgets, kw), rep.outputs, at, TOL, msg="ssm solo")
    assert [len(t) for t in rep.outputs] == budgets and eng.pages_in_use() == 0


def test_preemption_gives_the_unpreempted_tokens():
    """A pool of 9 pages for two requests of 20 new tokens: the younger is
    preempted and re-admitted, its state row rewritten from zero by its
    prefill; the events are the JAX package's, and the tokens equal an
    unpreempted run's exactly."""
    jcfg, jparams, tcfg, tparams = _model()
    geo = dict(slots=2, max_seq=32, page_size=4, chunk=4, pim_bits=8)
    prompts = [prompt(1, 7, jcfg.vocab, seed=s)[0] for s in (1, 2)]
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
    request admitted again from its prompt into a zero state row, the
    tokens those of the undisturbed serve exactly."""
    _, _, tcfg, tparams = _model()
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
    """``prefix_cache=True`` on a repeated 8-token prompt (two whole pages):
    the ssm family is not among the prefix families, so, as in the JAX
    package, nothing is cached or hit, the events are the JAX package's and
    the tokens the uncached serve's."""
    jcfg, jparams, tcfg, tparams = _model()
    base = np.random.default_rng(30).integers(0, jcfg.vocab, size=8).astype(np.int32)
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


# ------------------------------------------------- the per-slot state rows --
def _served_engine():
    """An int8 engine after one serve, its per-slot state filled at random."""
    _, _, tcfg, tparams = _model()
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    prompts, budgets = _trace()
    eng.serve(_requests(Request, prompts[:2], budgets[:2]))
    gen = torch.Generator().manual_seed(4)
    with torch.inference_mode():  # the engine's buffers are inference tensors
        for leaf in eng._state.cache["layers"].values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    return eng


def test_admit_miss_writes_its_slot_row_only():
    """``admit_miss`` on the static buffers with ``a.slot`` = 1, a 7-token
    prompt padded to 8 (``a.length`` 7): row 1 of the per-slot state is the
    one ``admit_prefill`` writes when told the slot, bit for bit, and equals
    a prefill of the 7 tokens alone within 1e-6; row 0 is left bit for bit,
    and so is every row of the pool for a slot the admit is not told."""
    eng = _served_engine()
    st, cfg = eng._state, eng.cfg
    state = st.cache["layers"]
    before = {k: v.clone() for k, v in state.items()}
    toks = prompt(1, 7, cfg.vocab, seed=8)
    with torch.inference_mode():
        a = st.admit(8)
        a.prompt.copy_(torch.from_numpy(np.pad(toks, ((0, 0), (0, 1)))))
        a.ints.copy_(torch.tensor([1, 2, 7, 0]))
        a.slot.fill_(1)
        admit_miss(eng.params, cfg, st, a, greedy=True, top_k=0)
        got = {k: v.clone() for k, v in state.items()}
        for k, v in state.items():
            v.copy_(before[k])
        admit_prefill(eng.params, cfg, st.cache, a.prompt, a.length, a.slot, a.pages, a.rid,
                      st.base, st.temperature, greedy=True, top_k=0)
    for k, v in state.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(v[:, 0], before[k][:, 0]), k
        assert not torch.equal(v[:, 1], before[k][:, 1]), k
    alone = lm.init_cache(cfg, 1, 8, CPU)
    lm.prefill(eng.params, cfg, torch.from_numpy(toks), alone)
    for k, v in state.items():
        np.testing.assert_allclose(v[:, 1].numpy(), alone["layers"][k][:, 0].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_a_chunk_steps_warm_up_leaves_the_slots_state():
    """A chunk step captured in the middle of a serve first runs once as a
    warm-up, which advances every slot's state: ``_round_reset`` (the
    warm-up's reset) stashes the per-slot state and the round's ``_load``
    writes it back, bit for bit, once; a later serve's ``_reset`` drops a
    stash left by a failed warm-up."""
    eng = _served_engine()
    state = eng._state.cache["layers"]
    before = {k: v.clone() for k, v in state.items()}
    with torch.inference_mode():
        eng._round_reset()
        decode_chunk_step(eng.params, eng.cfg, eng._state, eng._state.stops(0), greedy=True,
                          top_k=0, pad_id=0)
        assert not all(torch.equal(before[k], v) for k, v in state.items())
        eng._load()
    assert all(torch.equal(before[k], v) for k, v in state.items())
    assert eng._state._stash == []
    with torch.inference_mode():
        eng._round_reset()
    assert eng._state._stash
    eng.serve(_requests(Request, *[x[:1] for x in _trace()]))
    assert eng._state._stash == []

"""Port parity for serving the vlm and encdec families: per-request extras on
both engines (llama-3.2-vision-90b's image embeds, seamless-m4t-medium's
encoder output), reduced, int8 weights, against the JAX package.

The vlm's gates are planted at 0.5 (``torch_helpers.cross_model``), so a
request's image moves its tokens.  Greedy tokens compare margin-aware at
1e-4 (``torch_helpers.assert_greedy_match``), sampled ones exactly: the
draws are keyed per (row or request, draw index) as the JAX package keys
them.  The engines keep their extras in static buffers (a captured step
reads the memory it was captured on), so the tests also hold a second call
to the first's buffers: a fixed-batch ``generate`` must follow its own
extras, and a freed slot must take its next request's.
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
    CPU, ENCDEC, VLM, assert_greedy_match, assert_serve_match, cross_extras, cross_model,
    one_thread, prompt, serve_deciding, serve_events)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = [VLM, ENCDEC]
TOL = 1e-4
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)
KEY = 5
GEOMETRY = dict(slots=2, max_seq=24, page_size=4, chunk=3, page_alloc_seed=1, pim_bits=8)
SHAPES = ((5, 4), (7, 6), (3, 3), (9, 5), (6, 4))  # (prompt length, max_new): 5 over 2 slots


@functools.lru_cache(maxsize=None)
def _engines(arch):
    jcfg, jparams, tcfg, tparams = cross_model(arch)
    return (JaxEngine(jcfg, jparams, max_seq=16, pim_bits=8),
            ServingEngine(tcfg, tparams, max_seq=16, pim_bits=8, device="cpu"))


def _trace(arch, seed=0):
    """The requests' prompts, budgets and extras (each without a batch dim)."""
    jcfg, jparams, _, _ = cross_model(arch)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32) for n, _ in SHAPES]
    ex = cross_extras(jcfg, jparams, len(SHAPES), seed=seed + 20)
    extras = [{k: v[i] for k, v in ex.items()} for i in range(len(SHAPES))]
    return prompts, [m for _, m in SHAPES], extras


def _requests(cls, prompts, budgets, extras, **kw):
    return [cls(prompt=p, max_new=m, extras=e, **kw) for p, m, e in zip(prompts, budgets, extras)]


def _solo(arch, prompts, budgets, extras, mode):
    """Each request alone on the fixed engine, batch 1, with its own extras
    and its request id as the row's key id (row 0 of a batch of one keys as
    rid 0, so the draws are re-keyed through a batch padded to the rid)."""
    _, eng = _engines(arch)
    out = []
    for r, (p, m, e) in enumerate(zip(prompts, budgets, extras)):
        b = r + 1  # request r's draws are row r's of a batch of r + 1 rows
        toks = torch.from_numpy(np.repeat(p[None], b, axis=0))
        ex = {k: np.repeat(v[None], b, axis=0) for k, v in e.items()}
        out.append(eng.generate(toks, m, extras=ex, key=KEY, **mode)[r].numpy())
    return out


# ---------------------------------------------------------- fixed batch -----
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_with_extras_matches_jax(arch, mode):
    """``ServingEngine.generate`` (2 x 6, 8 new, int8) with per-row extras:
    greedy margin-aware against the JAX package's and the port's own
    per-token ``generate_reference``, sampled key for key."""
    jeng, eng = _engines(arch)
    jcfg = jeng.cfg
    ex = cross_extras(jcfg, cross_model(arch)[1], 2, seed=11)
    toks = prompt(2, 6, jcfg.vocab, seed=12)
    kw = {} if mode == "greedy" else dict(SAMPLED)
    want = np.asarray(jeng.generate(jnp.asarray(toks), 8, extras=ex,
                                    key=jax.random.PRNGKey(KEY), **kw))
    got = eng.generate(torch.from_numpy(toks), 8, extras=ex, key=KEY, **kw)
    assert got.dtype == torch.int32
    if mode == "sampled":
        np.testing.assert_array_equal(got.numpy(), want)
        return

    def at(row, j):
        seq = np.concatenate([toks[row], got[row, :j].numpy()])[None]
        logits, _ = prefill(eng.params, eng.cfg, torch.from_numpy(seq),
                            init_cache(eng.cfg, 1, seq.shape[1], CPU),
                            {k: torch.from_numpy(v[row:row + 1]) for k, v in ex.items()})
        return logits[0, -1].numpy()
    assert_greedy_match(want, got.numpy(), at, TOL, msg=arch)
    ref = eng.generate_reference(torch.from_numpy(toks), 8, extras=ex, key=KEY)
    assert_greedy_match(ref.numpy(), got.numpy(), at, TOL, msg=f"{arch} reference")


@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_follows_each_calls_extras(arch):
    """The batch's extras live in a static buffer the step reads: a second
    call with other extras on the same engine gives a fresh engine's tokens
    for them, not the first call's (sampled, so the rows' draws differ)."""
    jcfg, _, tcfg, tparams = cross_model(arch)
    eng = ServingEngine(tcfg, tparams, max_seq=16, pim_bits=8, device="cpu")
    toks = torch.from_numpy(prompt(2, 6, jcfg.vocab, seed=13))
    a, b = (cross_extras(jcfg, cross_model(arch)[1], 2, seed=s) for s in (14, 15))
    first = eng.generate(toks, 8, extras=a, key=KEY, **SAMPLED)
    second = eng.generate(toks, 8, extras=b, key=KEY, **SAMPLED)
    fresh = _engines(arch)[1].generate(toks, 8, extras=b, key=KEY, **SAMPLED)
    assert torch.equal(second, fresh) and not torch.equal(first, second)


# ---------------------------------------------------------- continuous ------
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_with_extras_matches_jax_and_solo_runs(arch, mode):
    """Five requests over two slots of 4-token pages on a shuffled pool, each
    with its own extras, so freed slots take new ones: the JAX package's
    events, counters and pages, tokens margin-aware (sampled: exactly), and
    each request the tokens of its solo fixed-batch run."""
    jcfg, jparams, tcfg, tparams = cross_model(arch)
    prompts, budgets, extras = _trace(arch)
    kw = {} if mode == "greedy" else dict(SAMPLED)
    jeng = JaxBatchingEngine(jcfg, jparams, **GEOMETRY)
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets, extras),
                               key=jax.random.PRNGKey(KEY), **kw)
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    rep = eng.serve_detailed(_requests(Request, prompts, budgets, extras), key=KEY, **kw)
    assert serve_events(rep) == serve_events(jrep)
    assert (rep.rounds, eng.decode_chunk_iters, eng.peak_pages_in_use) == (
        jrep.rounds, jeng.decode_chunk_iters, jeng.peak_pages_in_use)
    at = serve_deciding(eng.params, tcfg, prompts, rep.outputs,
                        kw or {"greedy": True}, KEY, extras)
    if mode == "sampled":
        assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, jrep.outputs))
    else:
        assert_serve_match(jrep.outputs, rep.outputs, at, TOL, msg=arch)
    solo = _solo(arch, prompts, budgets, extras, kw)
    assert_serve_match(solo, rep.outputs, at, TOL, msg=f"{arch} solo")
    assert [len(t) for t in rep.outputs] == budgets and eng.pages_in_use() == 0


def test_continuous_generate_takes_batched_extras():
    """``ContinuousBatchingEngine.generate``: row i of the batched extras is
    request i's, as in the JAX package."""
    jcfg, jparams, tcfg, tparams = cross_model(VLM)
    ex = cross_extras(jcfg, jparams, 3, seed=16)
    toks = prompt(3, 5, jcfg.vocab, seed=17)
    want = JaxBatchingEngine(jcfg, jparams, **GEOMETRY).generate(
        toks, 4, extras=ex, key=jax.random.PRNGKey(KEY), **SAMPLED)
    got = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY).generate(
        torch.from_numpy(toks), 4, extras=ex, key=KEY, **SAMPLED)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefix_hit_only_under_the_same_extras(arch):
    """With ``prefix_cache=True`` a repeated prompt hits its pages only
    under the same extras (one trie root per extras fingerprint): the
    events (``cached_tokens``) and counters are the JAX package's, and the
    tokens those of the uncached serve."""
    jcfg, jparams, tcfg, tparams = cross_model(arch)
    rng = np.random.default_rng(30)
    base = rng.integers(0, jcfg.vocab, size=9).astype(np.int32)
    ex = cross_extras(jcfg, jparams, 2, seed=31)
    own, other = ({k: v[i] for k, v in ex.items()} for i in range(2))
    prompts, budgets = [base, base, base], [3, 3, 3]
    extras = [own, own, other]
    geo = dict(GEOMETRY, slots=1)
    jeng = JaxBatchingEngine(jcfg, jparams, prefix_cache=True, **geo)
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets, extras))
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", prefix_cache=True, **geo)
    rep = eng.serve_detailed(_requests(Request, prompts, budgets, extras))
    assert serve_events(rep) == serve_events(jrep)
    cached = [e["cached_tokens"] for rec in rep.records for e in rec.events
              if e["name"] == "admit"]
    assert cached[0] == 0 and cached[1] > 0 and cached[2] == 0
    assert (eng.prefix_hits, eng.prefix_hit_tokens) == (jeng.prefix_hits, jeng.prefix_hit_tokens)
    plain = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **geo).serve(
        _requests(Request, prompts, budgets, extras))
    at = serve_deciding(eng.params, tcfg, prompts, rep.outputs, {"greedy": True}, 0, extras)
    assert_serve_match(plain, rep.outputs, at, TOL, msg=arch)


def test_mixed_extras_structures_raise():
    """Every request of a trace shares one extras structure (the chunk step
    is one captured program), as the JAX package requires."""
    _, _, tcfg, tparams = cross_model(VLM)
    prompts, budgets, extras = _trace(VLM)
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    for bad in (None, {"other": extras[1]["image_embeds"]}):
        reqs = _requests(Request, prompts[:2], budgets[:2], [extras[0], bad])
        with pytest.raises(ValueError, match="same extras structure"):
            eng.serve(reqs)


def test_recompute_crash_replay_equals_the_undisturbed_serve():
    """Two scripted crashes under the supervisor on the vlm trace, recompute
    replay: every request re-admitted with its own extras, the tokens those
    of the undisturbed serve exactly."""
    _, _, tcfg, tparams = cross_model(VLM)
    prompts, budgets, extras = _trace(VLM, seed=3)
    want = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY).serve(
        _requests(Request, prompts, budgets, extras), key=KEY, **SAMPLED)
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    sup = ServingSupervisor(eng, policy=ResiliencePolicy(resume_mode="recompute"),
                            chaos=FaultInjector(ChaosConfig(crash_rounds=(1, 3))))
    rep = sup.run(_requests(Request, prompts, budgets, extras), key=KEY, **SAMPLED)
    assert rep.restarts == 2
    assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, want))
    eng.assert_quiescent()


@pytest.mark.parametrize("arch", FAMILIES)
def test_admit_unembeds_only_its_last_position(arch):
    """An uncached admit unembeds only the true prompt end (no (S, vocab)
    logits, no dequantized head): its row of logits is the full prefill's
    within 1e-5 (the untied int8 head as a one-row linear), and greedy, its
    token that row's argmax."""
    from repro_torch.models import prefill_hidden
    from repro_torch.models.common import unembed
    from repro_torch.serving import admit_prefill, prng_key

    jcfg, jparams, tcfg, tparams = cross_model(arch)
    _, eng = _engines(arch)
    ex = {k: torch.from_numpy(v[:1]) for k, v in cross_extras(jcfg, jparams, 1, seed=18).items()}
    toks = torch.from_numpy(prompt(1, 8, jcfg.vocab, seed=19))
    full, _ = prefill(eng.params, tcfg, toks, init_cache(tcfg, 1, 8, CPU), ex)
    x = prefill_hidden(eng.params, tcfg, toks, init_cache(tcfg, 1, 8, CPU), ex)
    one = unembed(x[:, 5:6], eng.params["head"])
    np.testing.assert_allclose(one[0, 0].numpy(), full[0, 5].numpy(), rtol=1e-5, atol=1e-5)
    cache = init_cache(tcfg, 1, 8, CPU)
    tok = admit_prefill(eng.params, tcfg, cache, toks, 6, None, None, 0, prng_key(0), 1.0, ex,
                        greedy=True, top_k=0)
    assert int(tok) == int(full[0, 5].argmax())

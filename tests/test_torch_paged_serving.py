"""Port parity: ``ContinuousBatchingEngine.serve`` of reduced qwen2-1.5b
against the JAX package's, on the same requests, key, seed and geometry.

The scheduler must make the same decisions: the same admit, preempt, decode
and finish events (slot, round, tokens), the same rounds, chunk iterations,
page counts and peak pages.  Tokens are compared margin-aware
(``torch_helpers.assert_serve_match``): a request's tokens agree up to a
first mismatch where the top-2 gap of the deciding values is within the
two paths' logit tolerance, 1e-4 (the port's decode linears run
``pim_matvec``'s plain version, the JAX package's ``x @ dq(w)``; the logits
differ by ~1e-6), over the temperature when sampled (gumbel + warped
logits).  The untrained model repeats one token under greedy decoding, so
sampled serving carries the weight here and greedy tokens are the weaker
check; stop tokens are chosen as first occurrences in a sampled run.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jax_attention  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch.kernels import flash_attn  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine, Request, ServingEngine, SpecConfig)

from torch_helpers import (  # noqa: E402
    assert_serve_match, prompt, reduced_model, serve_deciding, serve_events)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

LOGIT_TOL = 1e-4
GEOMETRY = dict(slots=2, max_seq=24, page_size=4, chunk=3, page_alloc_seed=1, pim_bits=8)
SHAPES = ((5, 4), (7, 6), (3, 3), (9, 5), (4, 7))  # (prompt length, max_new)
MODES = {"greedy": {}, "t1": dict(greedy=False, temperature=1.0, top_k=0),
         "t07_k8": dict(greedy=False, temperature=0.7, top_k=8)}
KEY = 11


def _prompts(vocab, shapes=SHAPES, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n, _ in shapes]


def _requests(cls, prompts, budgets, stops=None):
    stops = stops or [()] * len(prompts)
    return [cls(prompt=p, max_new=m, stop_tokens=s) for p, m, s in zip(prompts, budgets, stops)]


def _counters(report, keys=("round", "free_pages", "pages_in_use", "queued")):
    return [{k: c[k] for k in keys} for c in report.counters]


def _tol(mode):
    return LOGIT_TOL / mode.get("temperature", 1.0)


def _check_against_jax(jeng, jrep, eng, rep, prompts, mode, msg):
    assert serve_events(rep) == serve_events(jrep), msg
    assert _counters(rep) == _counters(jrep), msg
    assert (rep.rounds, eng.decode_chunk_iters, eng.peak_pages_in_use, eng.preemptions,
            rep.prefill_tokens) == (jrep.rounds, jeng.decode_chunk_iters,
                                    jeng.peak_pages_in_use, jeng.preemptions,
                                    jrep.prefill_tokens), msg
    assert all(t.dtype == np.int32 for t in rep.outputs)
    at = serve_deciding(eng.params, eng.cfg, prompts, rep.outputs, mode, KEY)
    return assert_serve_match(jrep.outputs, rep.outputs, at, _tol(mode), msg=msg)


@functools.lru_cache(maxsize=None)
def _jax_serve(mode_name, kv_bits=16):
    """The JAX engine's staggered serve, once per process and mode."""
    jcfg, jparams, _, _ = reduced_model(kv_cache_bits=kv_bits)
    jeng = JaxEngine(jcfg, jparams, **GEOMETRY)
    prompts = _prompts(jcfg.vocab)
    rep = jeng.serve_detailed(_requests(JaxRequest, prompts, [m for _, m in SHAPES]),
                              key=jax.random.PRNGKey(KEY), **MODES[mode_name])
    return jeng, rep


@pytest.mark.parametrize("mode_name,kv_bits", [("greedy", 16), ("t1", 16), ("t07_k8", 16),
                                               ("greedy", 8)])
def test_staggered_serve_matches_jax(mode_name, kv_bits):
    """Five requests of mixed, non-page-multiple lengths over two slots, on a
    shuffled pool: the JAX package's events, pages and (margin-aware)
    tokens."""
    jeng, jrep = _jax_serve(mode_name, kv_bits)
    _, _, tcfg, tparams = reduced_model(kv_cache_bits=kv_bits)
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    prompts = _prompts(tcfg.vocab)
    rep = eng.serve_detailed(_requests(Request, prompts, [m for _, m in SHAPES]),
                             key=KEY, **MODES[mode_name])
    _check_against_jax(jeng, jrep, eng, rep, prompts, MODES[mode_name], mode_name)
    assert [len(t) for t in rep.outputs] == [m for _, m in SHAPES]
    assert eng.peak_pages_in_use < eng.slots * eng.width
    assert eng.pages_in_use() == 0
    eng.assert_quiescent()
    assert eng.last_report is rep and rep.done() == list(range(len(SHAPES)))
    assert all(t is not None for t in rep.latencies())


def test_bf16_serve_with_the_int8_cache_matches_the_dense_engine():
    """bf16 weights and the int8 cache (JAX's CPU backend cannot decode bf16):
    each request's sampled tokens equal the port's dense engine's run of it
    alone as batch row 0 (its draws keyed by rid 0 there too), within the
    bf16 logit tolerance."""
    _, _, tcfg, tparams = reduced_model(param_dtype="bfloat16", kv_cache_bits=8)
    mode = MODES["t1"]
    prompts = _prompts(tcfg.vocab)
    budgets = [m for _, m in SHAPES]
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    dense = ServingEngine(tcfg, tparams, max_seq=GEOMETRY["max_seq"], pim_bits=8, device="cpu")
    for r, (p, m) in enumerate(zip(prompts, budgets)):
        got = eng.serve([Request(prompt=p, max_new=m, rid=0)], key=KEY, **mode)[0]
        want = dense.generate(torch.from_numpy(p)[None], m, key=KEY, **mode)[0].numpy()
        at = serve_deciding(eng.params, tcfg, [p], [got], mode, KEY)
        assert_serve_match([want], [got], at, 1e-2 / mode["temperature"], msg=f"request {r}")


def test_preemption_gives_the_unpreempted_tokens():
    """A pool of 9 pages for two requests of 20 new tokens: the younger is
    preempted (recomputed from scratch), the events are the JAX package's,
    and the tokens equal an unpreempted run's exactly."""
    mode = MODES["t1"]
    geo = dict(slots=2, max_seq=32, page_size=4, chunk=4, pim_bits=8)
    jcfg, jparams, tcfg, tparams = reduced_model()
    prompts = [prompt(1, 8, jcfg.vocab, seed=s)[0] for s in (1, 2)]
    jeng = JaxEngine(jcfg, jparams, num_pages=9, **geo)
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, [20, 20]),
                               key=jax.random.PRNGKey(KEY), **mode)
    eng = ContinuousBatchingEngine(tcfg, tparams, num_pages=9, device="cpu", **geo)
    rep = eng.serve_detailed(_requests(Request, prompts, [20, 20]), key=KEY, **mode)
    assert eng.preemptions > 0
    assert any(e["name"] == "preempt" for ev in serve_events(rep) for e in ev)
    _check_against_jax(jeng, jrep, eng, rep, prompts, mode, "preempted")
    roomy = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **geo)
    want = roomy.serve(_requests(Request, prompts, [20, 20]), key=KEY, **mode)
    assert roomy.preemptions == 0
    for w, g in zip(want, rep.outputs):
        np.testing.assert_array_equal(g, w)


def _first_occurrence(tokens, at_least=1):
    """(index, token) of the first token at or after ``at_least`` that does
    not occur earlier in ``tokens``."""
    for j in range(at_least, len(tokens)):
        if tokens[j] not in tokens[:j]:
            return j, int(tokens[j])
    raise AssertionError(f"no first occurrence after {at_least} in {tokens}")


def test_stop_tokens():
    """Stops chosen as first occurrences in the unstopped sampled run: a stop
    ends the request at that token (two requests stop in the same chunk, one
    of them with a second stop that never fires); a stop at exactly the
    last emission ends it once; a stop that is the prompt's last token does
    not fire; ``max_new=1`` retires at admit.  Events as JAX's."""
    mode = MODES["t1"]
    geo = dict(slots=3, max_seq=24, page_size=4, chunk=6, page_alloc_seed=3, pim_bits=8)
    jcfg, jparams, tcfg, tparams = reduced_model()
    shapes = ((6, 8), (5, 8), (7, 6), (4, 6), (6, 1))
    prompts = _prompts(tcfg.vocab, shapes, seed=4)
    budgets = [m for _, m in shapes]
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **geo)
    free = eng.serve(_requests(Request, prompts, budgets), key=KEY, **mode)
    j0, s0 = _first_occurrence(free[0], 2)
    j1, s1 = _first_occurrence(free[1], 1)
    j3, s3 = _first_occurrence(free[3], 1)
    budgets[3] = j3 + 1  # the stop lands on the last emission
    in_prompt = int(prompts[2][-1])
    assert in_prompt not in free[2]
    never = next(t for t in range(tcfg.vocab) if t not in free[1])
    stops = [(s0,), (never, s1), (in_prompt,), (s3,), (int(free[4][0]),)]
    rep = eng.serve_detailed(_requests(Request, prompts, budgets, stops), key=KEY, **mode)
    want = [free[0][:j0 + 1], free[1][:j1 + 1], free[2], free[3][:j3 + 1], free[4]]
    for w, g in zip(want, rep.outputs):
        np.testing.assert_array_equal(g, w)
    finish = {r: [e for e in ev if e["name"] == "finish"] for r, ev in enumerate(serve_events(rep))}
    assert all(len(f) == 1 for f in finish.values())
    assert len(rep.outputs[4]) == 1 and not any(e["name"] == "decode" for e in
                                               serve_events(rep)[4])
    jeng = JaxEngine(jcfg, jparams, **geo)
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets, stops),
                               key=jax.random.PRNGKey(KEY), **mode)
    _check_against_jax(jeng, jrep, eng, rep, prompts, mode, "stops")
    assert eng.pages_in_use() == 0


def test_generate_and_sampled_rows_match_the_dense_engine():
    """``generate`` serves each row as a request whose id is its row, so its
    tokens, greedy and sampled, are the dense engine's of the same batch
    (margin-aware); a stop token pads the rest of its row with ``pad_id``."""
    _, _, tcfg, tparams = reduced_model()
    toks = prompt(3, 6, tcfg.vocab, seed=7)
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    dense = ServingEngine(tcfg, tparams, max_seq=GEOMETRY["max_seq"], pim_bits=8, device="cpu")
    for mode in (MODES["greedy"], MODES["t07_k8"]):
        got = eng.generate(torch.from_numpy(toks), 7, key=KEY, **mode)
        assert got.dtype == torch.int32 and tuple(got.shape) == (3, 7)
        want = dense.generate(torch.from_numpy(toks), 7, key=KEY, **mode).numpy()
        at = serve_deciding(eng.params, tcfg, list(toks), got.numpy(), mode, KEY)
        assert_serve_match(list(want), list(got.numpy()), at, _tol(mode))
    j, stop = _first_occurrence(list(got[0].numpy()), 1)
    stopped = eng.generate(torch.from_numpy(toks), 7, key=KEY, stop_tokens=(stop,), **mode)
    assert torch.equal(stopped[0, :j + 1], got[0, :j + 1])
    assert bool((stopped[0, j + 1:] == eng.pad_id).all())


def test_tokens_do_not_depend_on_the_chunk_or_a_previous_serve():
    """Sampled draws are keyed per (request, counter): another chunk gives the
    same tokens, and so does a serve after other serves on the same engine,
    whose kept cache and buffers are zeroed in between."""
    _, _, tcfg, tparams = reduced_model()
    prompts = _prompts(tcfg.vocab)
    reqs = _requests(Request, prompts, [m for _, m in SHAPES])
    mode = MODES["t07_k8"]
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    first = eng.serve(reqs, key=KEY, **mode)
    eng.serve(_requests(Request, _prompts(tcfg.vocab, seed=5), [m for _, m in SHAPES],
                        [(1, 2)] * len(SHAPES)), key=KEY + 1)
    again = eng.serve(reqs, key=KEY, **mode)
    other = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **{**GEOMETRY, "chunk": 2})
    for a, b, c in zip(first, again, other.serve(reqs, key=KEY, **mode)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_chunk_step_follows_a_replaced_parameter_leaf():
    """On the CPU the chunk step is made anew at each serve on the current
    parameters: after a new ``down`` scale leaf (every layer's MLP output
    30 times larger) the serve equals a fresh engine's on the new tree.
    (On the card the kept graphs are dropped and captured again by
    ``CapturedSteps``, which both engines share: ``chip_smoke.py`` phase 8's
    stale-graph check.)"""
    _, _, tcfg, tparams = reduced_model()
    reqs = _requests(Request, _prompts(tcfg.vocab), [m for _, m in SHAPES])
    mode = MODES["t1"]
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    first = eng.serve(reqs, key=KEY, **mode)
    eng._reset(reqs, 0)
    assert eng.chunk_step(0, greedy=False, top_k=3).args[0] is eng.params
    assert eng.chunk_step(0, greedy=True, top_k=3).keywords["top_k"] == 0
    down = eng.params["layers"]["mlp"]["down"]
    down["scale"] = down["scale"] * 30
    got = eng.serve(reqs, key=KEY, **mode)
    fresh = ContinuousBatchingEngine(tcfg, eng.params, device="cpu",
                                     **{**GEOMETRY, "pim_bits": 0})
    want = fresh.serve(reqs, key=KEY, **mode)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert any(not np.array_equal(a, b) for a, b in zip(first, got))


def test_guards():
    """Oversized and empty requests, a pool too small to admit, double
    frees, overdraws and leaks raise; so does each option not ported yet."""
    _, _, tcfg, tparams = reduced_model()
    p = prompt(1, 8, tcfg.vocab)[0]
    eng = ContinuousBatchingEngine(tcfg, tparams, slots=1, max_seq=16, page_size=4,
                                   device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.serve([Request(prompt=p, max_new=100)])
    with pytest.raises(ValueError, match="max_new >= 1"):
        eng.serve([Request(prompt=p, max_new=0)])
    small = ContinuousBatchingEngine(tcfg, tparams, slots=1, max_seq=16, page_size=4,
                                     num_pages=2, device="cpu")
    with pytest.raises(RuntimeError, match="too small to admit"):
        small.serve([Request(prompt=p, max_new=2)])
    with pytest.raises(AssertionError, match="poisoned"):
        small.assert_quiescent()
    eng._reset([], 0)
    pages = eng._alloc_pages(2)
    eng._free_pages(pages)
    with pytest.raises(ValueError, match="double-free"):
        eng._free_pages(pages)
    with pytest.raises(RuntimeError, match="overdraw"):
        eng._alloc_pages(eng.num_pages)
    eng._alloc_pages(1)
    with pytest.raises(AssertionError, match="page leak"):
        eng.assert_quiescent()
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7 "):
        ContinuousBatchingEngine(tcfg, tparams, slots=1, max_seq=16, device="cpu",
                                 mesh=object())
    tree = ContinuousBatchingEngine(tcfg, tparams, slots=1, max_seq=16, device="cpu",
                                    speculate=SpecConfig(tree_fan=2))
    assert tree.spec.tree_fan == 2 and tree._store_seq == tree.max_seq + 8
    with pytest.raises(ValueError, match="draft_cfg/draft_params"):
        ContinuousBatchingEngine(tcfg, tparams, slots=1, max_seq=16, device="cpu",
                                 speculate=SpecConfig(mode="draft"))
    for option in (dict(draft_cfg=tcfg), dict(draft_params=tparams), dict(draft_pim_bits=8),
                   dict(draft_cfg=tcfg, draft_params=tparams,
                        speculate=SpecConfig(k=3, mode="draft"))):
        ContinuousBatchingEngine(tcfg, tparams, slots=1, max_seq=16, device="cpu", **option)
    # the dense family ignores extras, as the JAX package's dense branches do
    plain = eng.serve([Request(prompt=p, max_new=2)])
    with_image = eng.serve([Request(prompt=p, max_new=2, extras={"image": np.zeros(3)})])
    assert all(np.array_equal(a, b) for a, b in zip(plain, with_image))
    assert torch.equal(eng.generate(torch.from_numpy(p)[None], 2, extras={"image": None}),
                       eng.generate(torch.from_numpy(p)[None], 2))


def test_long_admit_goes_through_flash_attention(monkeypatch):
    """A prompt past CHUNKED_THRESHOLD (lowered in both packages, as in
    tests/test_torch_long_prefill.py) is admitted through
    ``_chunked_attention`` -> ``flash_attention_gqa``, once a layer; the
    serve's events and tokens are the JAX package's."""
    monkeypatch.setattr(jax_attention, "CHUNKED_THRESHOLD", 32)
    monkeypatch.setattr(attention, "CHUNKED_THRESHOLD", 32)
    monkeypatch.setattr(flash_attn, "KV_CHUNK", 24)
    jax.clear_caches()
    try:
        jcfg, jparams, tcfg, tparams = reduced_model()
        jcfg = jcfg.replace(kv_chunk=24)
        calls = []
        fn = attention.flash_attention_gqa

        def spy(q, k, v, **kw):
            calls.append(tuple(k.shape))
            return fn(q, k, v, **kw)
        monkeypatch.setattr(attention, "flash_attention_gqa", spy)
        geo = dict(slots=2, max_seq=56, page_size=4, chunk=4, page_alloc_seed=2, pim_bits=8)
        shapes = ((45, 6), (5, 6))
        prompts = _prompts(tcfg.vocab, shapes, seed=6)
        mode = MODES["t1"]
        eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **geo)
        rep = eng.serve_detailed(_requests(Request, prompts, [6, 6]), key=KEY, **mode)
        assert calls == [(1, 48, tcfg.n_kv_heads, tcfg.head_dim)] * tcfg.n_layers
        jeng = JaxEngine(jcfg, jparams, **geo)
        jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, [6, 6]),
                                   key=jax.random.PRNGKey(KEY), **mode)
        _check_against_jax(jeng, jrep, eng, rep, prompts, mode, "long admit")
    finally:
        jax.clear_caches()

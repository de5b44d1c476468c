"""Port parity for serving and speculation on the moe family: reduced
deepseek-v2-lite-16b (MLA attention, a latent cache) and reduced
moonshot-v1-16b-a3b (GQA attention), int8, on both engines, against the
JAX package's engines on the same weights, prompts, keys and geometry.

Plain serving on deepseek, then speculation on both configs: n-gram
windows (greedy and rejection-sampled), the target's int8 tree as
its own draft, tree windows of fan 2, and windows wider than 6 tokens a
row.  A row's window is one dispatch group, whose capacity may drop (token,
expert) pairs that one-token steps keep (in both packages; at the reduced
config's 8 experts, top 2, already at 5 tokens), so the windows are held
against the JAX package's, not against plain decoding: sampled tokens and
``spec_stats`` (or the serve's events, counters and window counts)
equal, greedy tokens margin-aware at 1e-4 (``torch_helpers.
assert_greedy_match``).  A moe model drafts for another moe model, and a
draft config of an unported family is refused at ``speculate=``.
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
from repro.serving import SpecConfig as JaxSpec  # noqa: E402
from repro.serving import quantize_tree as jax_quantize_tree  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine, Request, ServingEngine, SpecConfig, quantize_tree)

from torch_helpers import (  # noqa: E402,F401
    MOE, assert_greedy_match, assert_serve_match, one_thread, prompt, reduced_model,
    serve_deciding, serve_events)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

MLA = "deepseek-v2-lite-16b"  # the moe family with MLA attention

TOL = 1e-4
KEY = 5
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)
MAX_SEQ, N_NEW, B = 28, 14, 2
GEOMETRY = dict(slots=2, max_seq=24, page_size=4, chunk=3, page_alloc_seed=1)
SHAPES = ((5, 6), (7, 6), (3, 5), (9, 4))  # (prompt length, max_new): 4 over 2 slots


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(jax cfg, jax int8 tree, port cfg, port int8 tree) of reduced ``arch``."""
    jcfg, jparams, tcfg, tparams = reduced_model(arch=arch)
    return jcfg, jax_quantize_tree(jparams, bits=8), tcfg, quantize_tree(tparams, bits=8)


@functools.lru_cache(maxsize=None)
def _engines(arch):
    """The JAX package's fixed engine and the port's, int8, each with the
    target's own int8 tree as its draft."""
    jcfg, jq, tcfg, tq = _trees(arch)
    return (JaxEngine(jcfg, jq, max_seq=MAX_SEQ, draft_cfg=jcfg, draft_params=jq),
            ServingEngine(tcfg, tq, max_seq=MAX_SEQ, draft_cfg=tcfg, draft_params=tq,
                          device="cpu"))


def _greedy_match(eng, toks, want, got, msg):
    at = serve_deciding(eng.params, eng.cfg, list(toks), list(got), {}, KEY)
    assert_greedy_match(want, got, at, TOL, msg=msg)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_mla_generate_matches_jax(mode):
    """Plain ``ServingEngine.generate`` on deepseek (2 x 6, 14 new): the JAX
    package's tokens, greedy margin-aware, sampled key for key."""
    jeng, eng = _engines(MLA)
    toks = prompt(B, 6, jeng.cfg.vocab, seed=12)
    kw = {} if mode == "greedy" else SAMPLED
    want = np.asarray(jeng.generate(jnp.asarray(toks), N_NEW, key=jax.random.PRNGKey(KEY), **kw))
    got = eng.generate(torch.from_numpy(toks), N_NEW, key=KEY, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, N_NEW)
    if kw:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _greedy_match(eng, toks, want, got.numpy(), "deepseek plain")


CASES = {"sampled": (dict(k=4), SAMPLED),
         "draft_greedy": (dict(k=3, mode="draft"), {}),
         "draft_sampled": (dict(k=3, mode="draft"), SAMPLED),
         "tree_greedy": (dict(k=2, tree_fan=2), {}),
         "wide_sampled": (dict(k=8), SAMPLED), "wide_tree_greedy": (dict(k=3, tree_fan=3), {})}
# the matrix split over the two configs, each mode on one at least (the
# adaptive controller reads no family, and is held on the dense family)
GENERATE_CASES = ([(MLA, name) for name in ("sampled", "draft_greedy", "tree_greedy",
                                            "wide_tree_greedy")]
                  + [(MOE, name) for name in ("draft_sampled", "tree_greedy", "wide_sampled")])


@pytest.mark.parametrize("arch,name", GENERATE_CASES)
def test_speculative_generate_matches_jax(arch, name):
    """``generate(speculate=)`` on the fixed engine, prompts of a 7-token
    vocabulary (the n-gram proposer finds matches): the JAX package's
    tokens and ``spec_stats``; the wide cases' windows are 9 and 10 tokens
    a row, past the 6 a dispatch group keeps whole on the card."""
    spec, mode = CASES[name]
    jeng, eng = _engines(arch)
    toks = prompt(B, 6, jeng.cfg.vocab, seed=4) % 7
    want = np.asarray(jeng.generate(toks, N_NEW, speculate=JaxSpec(**spec),
                                    key=jax.random.PRNGKey(KEY), **mode))
    got = eng.generate(torch.from_numpy(toks), N_NEW, speculate=SpecConfig(**spec), key=KEY,
                       **mode)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert eng.spec_stats == jeng.spec_stats, name
    if mode:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _greedy_match(eng, toks, want, got.numpy(), f"{arch} {name}")
    if spec.get("mode") == "draft" and not mode:  # a self-draft accepts its proposals
        assert eng.spec_stats["verify_steps"] == -(-(N_NEW - 1) // (spec["k"] + 1))


def _trace(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, min(vocab, 7), size=n).astype(np.int32) for n, _ in SHAPES],
            [m for _, m in SHAPES])


def _requests(cls, prompts, budgets):
    return [cls(prompt=p.copy(), max_new=m) for p, m in zip(prompts, budgets)]


SERVES = {"plain_sampled": (None, SAMPLED),
          "greedy": (dict(k=3), {}), "sampled": (dict(k=3), SAMPLED),
          "draft_greedy": (dict(k=3, mode="draft"), {}),
          "tree_greedy": (dict(k=2, tree_fan=2), {}), "wide_sampled": (dict(k=7), SAMPLED)}
SERVE_CASES = ([(MLA, name) for name in ("plain_sampled", "sampled", "draft_greedy",
                                         "tree_greedy", "wide_sampled")]
               + [(MOE, "greedy")])


@pytest.mark.parametrize("arch,name", SERVE_CASES)
def test_serve_matches_jax(arch, name):
    """``ContinuousBatchingEngine.serve_detailed`` of four requests over two
    slots of 4-token pages on a shuffled pool, plain or speculative: the
    JAX package's events, rounds, chunk iterations, window counts and
    pages; tokens margin-aware (sampled: equal)."""
    spec, mode = SERVES[name]
    jcfg, jq, tcfg, tq = _trees(arch)
    prompts, budgets = _trace(jcfg.vocab)
    jkw = {} if spec is None else dict(speculate=JaxSpec(**spec), draft_cfg=jcfg, draft_params=jq)
    tkw = {} if spec is None else dict(speculate=SpecConfig(**spec), draft_cfg=tcfg,
                                       draft_params=tq)
    jeng = JaxBatchingEngine(jcfg, jq, **jkw, **GEOMETRY)
    eng = ContinuousBatchingEngine(tcfg, tq, device="cpu", **tkw, **GEOMETRY)
    eng.debug_check_hist = spec is not None
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets),
                               key=jax.random.PRNGKey(KEY), **mode)
    rep = eng.serve_detailed(_requests(Request, prompts, budgets), key=KEY, **mode)
    assert serve_events(rep) == serve_events(jrep)
    assert (rep.rounds, eng.decode_chunk_iters, eng.spec_emitted, eng.spec_live_steps,
            eng.peak_pages_in_use) == (jrep.rounds, jeng.decode_chunk_iters, jeng.spec_emitted,
                                       jeng.spec_live_steps, jeng.peak_pages_in_use)
    if mode:
        assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, jrep.outputs))
    else:
        at = serve_deciding(eng.params, tcfg, prompts, rep.outputs, {"greedy": True}, KEY)
        assert_serve_match(jrep.outputs, rep.outputs, at, TOL, msg=f"{arch} {name}")
    assert [len(t) for t in rep.outputs] == budgets
    eng.assert_quiescent()


def test_mla_takes_no_prefix_hit():
    """``prefix_cache=True`` on deepseek, one prompt three times: as in the
    JAX package nothing is cached or hit (absorbed decode and expanded
    prefill differ), the events are JAX's and the tokens the uncached
    serve's."""
    jcfg, jq, tcfg, tq = _trees(MLA)
    base = np.random.default_rng(30).integers(0, jcfg.vocab, size=9).astype(np.int32)
    prompts, budgets = [base, base, base], [3, 3, 3]
    geo = dict(GEOMETRY, slots=1)
    jeng = JaxBatchingEngine(jcfg, jq, prefix_cache=True, **geo)
    jrep = jeng.serve_detailed(_requests(JaxRequest, prompts, budgets))
    eng = ContinuousBatchingEngine(tcfg, tq, device="cpu", prefix_cache=True, **geo)
    rep = eng.serve_detailed(_requests(Request, prompts, budgets))
    assert serve_events(rep) == serve_events(jrep)
    assert eng.prefix_hits == jeng.prefix_hits == 0
    plain = ContinuousBatchingEngine(tcfg, tq, device="cpu", **geo).serve(
        _requests(Request, prompts, budgets))
    assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, plain))


def test_a_moe_model_drafts_for_another():
    """moonshot's windows proposed by deepseek's int8 tree (the two reduced
    configs share a vocabulary): the JAX package's tokens and
    ``spec_stats``; the continuous engine serves with it, its draft pool a
    latent pool beside the target's K/V pool."""
    jt, jtq, tt, ttq = _trees(MOE)
    jd, jdq, td, tdq = _trees(MLA)
    spec = dict(k=3, mode="draft")
    toks = prompt(B, 6, jt.vocab, seed=4) % 7
    jeng = JaxEngine(jt, jtq, max_seq=MAX_SEQ, draft_cfg=jd, draft_params=jdq)
    eng = ServingEngine(tt, ttq, max_seq=MAX_SEQ, draft_cfg=td, draft_params=tdq, device="cpu")
    want = np.asarray(jeng.generate(toks, N_NEW, speculate=JaxSpec(**spec),
                                    key=jax.random.PRNGKey(KEY), **SAMPLED))
    got = eng.generate(torch.from_numpy(toks), N_NEW, speculate=SpecConfig(**spec), key=KEY,
                       **SAMPLED)
    np.testing.assert_array_equal(got.numpy(), want)
    assert eng.spec_stats == jeng.spec_stats
    tb = ContinuousBatchingEngine(tt, ttq, speculate=SpecConfig(**spec), draft_cfg=td,
                                  draft_params=tdq, device="cpu", **GEOMETRY)
    tb.serve([Request(prompt=toks[0], max_new=2)])
    assert set(tb._state.dcache["layers"]) == {"c", "kr"} and "k" in tb._state.cache["layers"]


def test_speculate_refuses_a_draft_of_an_unported_family():
    """``speculate=`` accepts the moe family, target and draft, and raises
    NotImplementedError at once where the draft model's family is not
    ported (a hybrid config), on both engines; an n-gram window ignores the
    draft config."""
    _, _, tcfg, tq = _trees(MLA)
    hybrid = ModelConfig(arch_id="hybrid", family="hybrid", n_layers=1, d_model=8, n_heads=1,
                         n_kv_heads=1, d_ff=8, vocab=tcfg.vocab)
    draft = SpecConfig(k=2, mode="draft")
    toks = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="'hybrid' is not ported"):
        ContinuousBatchingEngine(tcfg, tq, slots=1, max_seq=8, device="cpu", speculate=draft,
                                 draft_cfg=hybrid, draft_params={})
    eng = ServingEngine(tcfg, tq, max_seq=12, device="cpu", draft_cfg=hybrid, draft_params={})
    with pytest.raises(NotImplementedError, match="'hybrid' is not ported"):
        eng.generate(toks, 3, speculate=draft)
    assert eng.generate(toks, 3, speculate=2).shape == (1, 3)

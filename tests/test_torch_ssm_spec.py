"""Port parity for speculation on the ssm family: reduced falcon-mamba-7b,
int8, n-gram windows, the target's tree at int4 as its draft (the JAX
package's ``test_spec_draft_mode_mismatched_draft_still_exact``) and tree
windows of fan 2, on both engines, against the JAX package's engines on the
same weights, prompts, keys and geometry.

A window runs each row's recurrence step by step from its state and
returns every step's state; the commit writes the accepted step into the
live state in place (a tree window's chains each from a copy of the row's
state, its steps in node order; a draft's chain of one-token windows
concatenated and committed again).  Sampled tokens and ``spec_stats`` (or
the serve's events and counters) equal the JAX package's; greedy tokens
compare margin-aware at 1e-4, and equal plain greedy decoding's the same
way.  A commit one step late is caught: its tokens leave plain greedy
decoding's.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import ContinuousBatchingEngine as JaxBatchingEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import SpecConfig as JaxSpec  # noqa: E402
from repro.serving import quantize_tree as jax_quantize_tree  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine, Request, ServingEngine, SpecConfig, quantize_tree)
from repro_torch.serving import speculative  # noqa: E402

from torch_helpers import (  # noqa: E402,F401
    assert_greedy_match, assert_serve_match, one_thread, prompt, reduced_model, serve_deciding,
    serve_events)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

SSM = "falcon-mamba-7b"
TOL = 1e-4
KEY = 5
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)
MAX_SEQ, N_NEW, B = 28, 14, 2
GEOMETRY = dict(slots=2, max_seq=24, page_size=4, chunk=3, page_alloc_seed=1)
SHAPES = ((5, 6), (7, 6), (3, 5), (9, 4))  # (prompt length, max_new): 4 over 2 slots


@functools.lru_cache(maxsize=None)
def _trees():
    """(jax cfg, jax int8 tree, jax int4 tree, port cfg, port int8 tree,
    port int4 tree)."""
    jcfg, jparams, tcfg, tparams = reduced_model(arch=SSM)
    return (jcfg, jax_quantize_tree(jparams, bits=8), jax_quantize_tree(jparams, bits=4),
            tcfg, quantize_tree(tparams, bits=8), quantize_tree(tparams, bits=4))


@functools.lru_cache(maxsize=None)
def _engines():
    """The JAX package's fixed engine and the port's, int8, each with the
    target's int4 tree as its draft."""
    jcfg, j8, j4, tcfg, t8, t4 = _trees()
    return (JaxEngine(jcfg, j8, max_seq=MAX_SEQ, draft_cfg=jcfg, draft_params=j4),
            ServingEngine(tcfg, t8, max_seq=MAX_SEQ, draft_cfg=tcfg, draft_params=t4,
                          device="cpu"))


def _toks(seed=4):
    """Prompts of a 7-token vocabulary, so the n-gram proposer finds matches."""
    return prompt(B, 6, _trees()[0].vocab, seed=seed) % 7


def _greedy_match(eng, toks, want, got, msg):
    at = serve_deciding(eng.params, eng.cfg, list(toks), list(got), {}, KEY)
    assert_greedy_match(want, got, at, TOL, msg=msg)


CASES = {"ngram_greedy": (dict(k=3), {}), "ngram_sampled": (dict(k=4), SAMPLED),
         "draft_greedy": (dict(k=3, mode="draft"), {}),
         "draft_sampled": (dict(k=3, mode="draft"), SAMPLED),
         "tree_greedy": (dict(k=2, tree_fan=2), {}), "tree_sampled": (dict(k=3, tree_fan=2),
                                                                       SAMPLED)}


@pytest.mark.parametrize("name", list(CASES))
def test_speculative_generate_matches_jax(name):
    """``generate(speculate=)`` on the fixed engine (2 x 6, 14 new): the JAX
    package's tokens and ``spec_stats``; greedy, plain greedy decoding's
    tokens too, whatever the draft."""
    spec, mode = CASES[name]
    jeng, eng = _engines()
    toks = _toks()
    want = np.asarray(jeng.generate(toks, N_NEW, speculate=JaxSpec(**spec),
                                    key=jax.random.PRNGKey(KEY), **mode))
    got = eng.generate(torch.from_numpy(toks), N_NEW, speculate=SpecConfig(**spec), key=KEY,
                       **mode)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert eng.spec_stats == jeng.spec_stats, name
    if mode:
        np.testing.assert_array_equal(got.numpy(), want)
        return
    _greedy_match(eng, toks, want, got.numpy(), name)
    plain = eng.generate(torch.from_numpy(toks), N_NEW, key=KEY)
    _greedy_match(eng, toks, plain.numpy(), got.numpy(), f"{name} vs plain")


def _late_commit(cfg, cache, sel):
    """``commit_verify`` one step late where the window has that step."""
    steps = cache.get("steps")
    if steps:
        t = next(iter(steps.values()))[0]["h"].shape[1]
        sel = torch.clamp(sel + 1, max=t - 1)
    return lm.commit_verify(cfg, cache, sel)


@pytest.mark.parametrize("spec", [dict(k=3), dict(k=2, tree_fan=2)], ids=["linear", "tree"])
def test_a_late_commit_is_caught(spec, monkeypatch):
    """A planted commit at ``sel + 1`` (the fixed engine's windows, eager on
    the CPU) advances a row's state past its accepted tokens: the greedy
    tokens leave plain greedy decoding's, where the sound commit keeps
    them."""
    _, eng = _engines()
    toks = _toks()
    plain = eng.generate(torch.from_numpy(toks), N_NEW, key=KEY).numpy()
    sound = eng.generate(torch.from_numpy(toks), N_NEW, speculate=SpecConfig(**spec)).numpy()
    _greedy_match(eng, toks, plain, sound, "sound")
    monkeypatch.setattr(speculative, "commit_verify", _late_commit)
    late = eng.generate(torch.from_numpy(toks), N_NEW, speculate=SpecConfig(**spec)).numpy()
    assert not np.array_equal(late, plain)
    with pytest.raises(AssertionError, match="diverges"):
        _greedy_match(eng, toks, plain, late, "late")


SERVE_CASES = {"ngram_greedy": (dict(k=3), {}), "ngram_sampled": (dict(k=2), SAMPLED),
               "draft_greedy": (dict(k=2, mode="draft"), {}),
               "tree_greedy": (dict(k=2, tree_fan=2), {}),
               "tree_sampled": (dict(k=2, tree_fan=2), SAMPLED)}


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_speculative_serve_matches_jax(name):
    """``ContinuousBatchingEngine(speculate=)``: 4 requests of mixed prompt
    lengths over 2 slots of 4-token pages, each admit's state row
    length-masked: the JAX package's events, counters, window counts and
    tokens (greedy margin-aware, and plain greedy serving's too)."""
    spec, mode = SERVE_CASES[name]
    jcfg, j8, j4, tcfg, t8, t4 = _trees()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 7, size=n).astype(np.int32) for n, _ in SHAPES]
    budgets = [m for _, m in SHAPES]
    jeng = JaxBatchingEngine(jcfg, j8, speculate=JaxSpec(**spec), draft_cfg=jcfg,
                             draft_params=j4, **GEOMETRY)
    jrep = jeng.serve_detailed([JaxRequest(prompt=p, max_new=m) for p, m in zip(prompts, budgets)],
                               key=jax.random.PRNGKey(KEY), **mode)
    eng = ContinuousBatchingEngine(tcfg, t8, speculate=SpecConfig(**spec), draft_cfg=tcfg,
                                   draft_params=t4, device="cpu", **GEOMETRY)
    rep = eng.serve_detailed([Request(prompt=p, max_new=m) for p, m in zip(prompts, budgets)],
                             key=KEY, **mode)
    assert serve_events(rep) == serve_events(jrep)
    assert (eng.decode_chunk_iters, eng.spec_emitted, eng.spec_live_steps,
            eng.peak_pages_in_use) == (jeng.decode_chunk_iters, jeng.spec_emitted,
                                       jeng.spec_live_steps, jeng.peak_pages_in_use)
    at = serve_deciding(t8, tcfg, prompts, rep.outputs, mode or {"greedy": True}, KEY)
    if mode:
        assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, jrep.outputs))
        return
    assert_serve_match(jrep.outputs, rep.outputs, at, TOL, msg=name)
    plain = ContinuousBatchingEngine(tcfg, t8, device="cpu", **GEOMETRY).serve(
        [Request(prompt=p, max_new=m) for p, m in zip(prompts, budgets)])
    assert_serve_match(plain, rep.outputs, at, TOL, msg=f"{name} vs plain")

"""Port parity: ``ServingEngine.generate(speculate=)``, n-gram speculative
decoding on the fixed-batch engine, of reduced qwen2-1.5b against the JAX
package's on the same prompts, key and weights.

Greedy windows (k 1 and 4, and the adaptive controller, whose window stays
k wide while acceptance is capped) are held margin-aware at 1e-4
(``torch_helpers.assert_greedy_match``: the port's decode linears run
``pim_matvec``'s plain version, the JAX package's ``x @ dq(w)``, ~1e-6
apart), and against the port's own plain greedy ``generate`` at the same
bar.  Sampled windows, rejection-sampled (T 0.8, top-k 8) and typical, draw
from the JAX package's window keys, so their tokens are held equal, and so
is ``spec_stats`` (windows run, live row windows).  A stop token inside a
window masks what follows it, as in plain decoding.  The untrained model
repeats tokens, which prompt lookup accepts: every case accepts proposals.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import SpecConfig as JaxSpec  # noqa: E402
from repro_torch.serving import ServingEngine, SpecConfig  # noqa: E402

from torch_helpers import (  # noqa: E402,F401
    assert_greedy_match, one_thread, prompt, reduced_model, serve_deciding)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

LOGIT_TOL = 1e-4
MAX_SEQ, N_NEW, KEY = 28, 18, 5
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)
CASES = {"greedy_k1": (dict(k=1), {}), "greedy_k4": (dict(k=4), {}),
         "adaptive_greedy": (dict(k=4, adaptive=True), {}),
         "sampled_exact": (dict(k=4), SAMPLED),
         "sampled_typical": (dict(k=3, accept="typical"), SAMPLED)}


def _engines():
    jcfg, jparams, tcfg, tparams = reduced_model()
    return (JaxEngine(jcfg, jparams, max_seq=MAX_SEQ, pim_bits=8),
            ServingEngine(tcfg, tparams, max_seq=MAX_SEQ, pim_bits=8, device="cpu"))


def _prompts(vocab):
    return prompt(3, 6, vocab, seed=4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_speculative_generate_matches_jax(name):
    spec, mode = CASES[name]
    jeng, eng = _engines()
    toks = _prompts(eng.cfg.vocab)
    want = np.asarray(jeng.generate(toks, N_NEW, speculate=JaxSpec(**spec),
                                    key=jax.random.PRNGKey(KEY), **mode))
    got = eng.generate(torch.from_numpy(toks), N_NEW, speculate=SpecConfig(**spec), key=KEY,
                       **mode)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert eng.spec_stats == jeng.spec_stats, name
    assert eng.spec_stats["verify_steps"] < N_NEW - 1  # windows accepted proposals
    if mode:
        np.testing.assert_array_equal(got.numpy(), want)
        return
    at = serve_deciding(eng.params, eng.cfg, list(toks), list(got.numpy()), {}, KEY)
    assert_greedy_match(want, got.numpy(), at, LOGIT_TOL, msg=name)
    plain = eng.generate(torch.from_numpy(toks), N_NEW)
    assert_greedy_match(plain.numpy(), got.numpy(), at, LOGIT_TOL, msg=f"{name} vs plain")


def test_stop_token_inside_a_window_masks_what_follows():
    """A stop token chosen as a first occurrence mid-generation in a sampled
    run: both packages mask every later token of its row, whichever window
    emitted it."""
    jeng, eng = _engines()
    toks = _prompts(eng.cfg.vocab)
    spec = dict(k=4)
    free = eng.generate(torch.from_numpy(toks), N_NEW, speculate=SpecConfig(**spec), key=KEY,
                        **SAMPLED).numpy()
    row = free[0]
    stop = next(int(t) for j, t in enumerate(row) if j >= 3 and t not in row[:j])
    want = np.asarray(jeng.generate(toks, N_NEW, speculate=JaxSpec(**spec), stop_tokens=(stop,),
                                    pad_id=-1, key=jax.random.PRNGKey(KEY), **SAMPLED))
    got = eng.generate(torch.from_numpy(toks), N_NEW, speculate=SpecConfig(**spec),
                       stop_tokens=(stop,), pad_id=-1, key=KEY, **SAMPLED).numpy()
    np.testing.assert_array_equal(got, want)
    j = int(np.flatnonzero(row == stop)[0])
    assert (got[0, j + 1:] == -1).all() and got[0, j] == stop


def test_window_state_is_reused_and_n_new_edges():
    """The same engine's buffers serve calls of other lengths, batches and
    configurations in turn; n_new of 0 and 1 run no window."""
    _, eng = _engines()
    toks = torch.from_numpy(_prompts(eng.cfg.vocab))
    first = eng.generate(toks, N_NEW, speculate=4)
    eng.generate(toks[:1], 5, speculate=SpecConfig(k=2, adaptive=True), key=1, **SAMPLED)
    assert torch.equal(eng.generate(toks, N_NEW, speculate=4), first)
    assert eng.generate(toks, 0, speculate=4).shape == (3, 0)
    one = eng.generate(toks, 1, speculate=4)
    assert torch.equal(one, first[:, :1]) and eng.spec_stats["verify_steps"] == 0

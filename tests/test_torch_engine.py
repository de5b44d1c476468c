"""Port parity: greedy ``ServingEngine.generate`` of reduced qwen2-1.5b emits
the JAX package's tokens, and its own ``generate_reference``'s.

The port's decode linears run ``pim_matvec``'s plain version on the CPU (f32
sums of the unscaled codes, then the scale), the JAX package's the overlay
``x @ dq(w)``: the logits differ by ~1e-6, so an argmax may flip at a
near-tie of the untrained model.  Tokens are compared margin-aware: rows
must agree up to a first mismatch whose top-2 logit margin is within 1e-4.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import mask_after_stop as jax_mask_after_stop  # noqa: E402
from repro_torch.models import init_cache, prefill  # noqa: E402
from repro_torch.serving import ServingEngine, mask_after_stop  # noqa: E402

from torch_helpers import CPU, assert_greedy_match, prompt, reduced_model  # noqa: E402

LOGIT_TOL = 1e-4


def _logits_at(eng, toks, got):
    """logits_at(row, j): the port's logits that choose token j of ``row``
    after the prompt and the row's first j emitted tokens."""
    def at(row, j):
        seq = np.concatenate([toks[row], got[row, :j]])[None]
        cache = init_cache(eng.cfg, 1, seq.shape[1], CPU)
        logits, _ = prefill(eng.params, eng.cfg, torch.from_numpy(seq), cache)
        return logits[0, -1].numpy()
    return at


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_generate_matches_jax_and_reference(bits):
    jcfg, jparams, tcfg, tparams = reduced_model()
    toks = prompt(3, 8, jcfg.vocab)
    jeng = JaxEngine(jcfg, jparams, max_seq=32, pim_bits=bits)
    eng = ServingEngine(tcfg, tparams, max_seq=32, pim_bits=bits, device="cpu")
    want = np.asarray(jeng.generate(jnp.asarray(toks), n_new=6))
    got = eng.generate(torch.from_numpy(toks), n_new=6).numpy()
    at = _logits_at(eng, toks, got)
    assert got.shape == (3, 6)
    assert_greedy_match(want, got, at, LOGIT_TOL, msg="jax vs port")
    ref = eng.generate_reference(torch.from_numpy(toks), n_new=6).numpy()
    assert_greedy_match(got, ref, at, LOGIT_TOL, msg="generate vs reference")

    # stop tokens: everything after a row's first stop token becomes pad_id
    stop = (int(got[0, 2]),)
    want_s = np.asarray(jeng.generate(jnp.asarray(toks), n_new=6,
                                      stop_tokens=stop, pad_id=7))
    got_s = eng.generate(torch.from_numpy(toks), n_new=6, stop_tokens=stop,
                         pad_id=7).numpy()
    np.testing.assert_array_equal(
        got_s, mask_after_stop(torch.from_numpy(got), stop, 7).numpy())
    assert_greedy_match(want_s, got_s, at, LOGIT_TOL, msg="with stop tokens")


def test_mask_after_stop_matches_jax():
    toks = np.random.default_rng(3).integers(0, 6, (4, 9), dtype=np.int32)
    for stops in [(), (2,), (1, 4)]:
        want = np.asarray(jax_mask_after_stop(jnp.asarray(toks), stops, pad_id=-1))
        got = mask_after_stop(torch.from_numpy(toks), stops, pad_id=-1).numpy()
        np.testing.assert_array_equal(got, want)


def test_generate_guards():
    _, _, tcfg, tparams = reduced_model()
    eng = ServingEngine(tcfg, tparams, max_seq=12, pim_bits=8, device="cpu")
    toks = torch.from_numpy(prompt(2, 8, tcfg.vocab))
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(toks, n_new=5)
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate_reference(toks, n_new=5)
    with pytest.raises(NotImplementedError):
        eng.generate(toks, n_new=2, greedy=False)
    with pytest.raises(NotImplementedError):
        eng.generate(toks, n_new=2, speculate=2)
    with pytest.raises(NotImplementedError):
        ServingEngine(tcfg, tparams, max_seq=12, device="cpu", mesh=object())
    assert eng.generate(toks, n_new=0).shape == (2, 0)

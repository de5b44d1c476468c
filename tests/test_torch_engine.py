"""Port parity: ``ServingEngine.generate`` of reduced qwen2-1.5b emits the
JAX package's tokens, greedy and sampled with the same key, and its own
``generate_reference``'s.

The port's decode linears run ``pim_matvec``'s plain version on the CPU (f32
sums of the unscaled codes, then the scale), the JAX package's the overlay
``x @ dq(w)``: the logits differ by ~1e-6, so an argmax may flip at a
near-tie of the untrained model.  Tokens are compared margin-aware: rows
must agree up to a first mismatch whose top-2 logit margin is within 1e-4
(sampled: the top-2 gap of gumbel + warped logits, within 1e-4 over the
temperature).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import mask_after_stop as jax_mask_after_stop  # noqa: E402
from repro_torch.models import decode_step, init_cache, prefill  # noqa: E402
from repro_torch.serving import ServingEngine, mask_after_stop, quantize_tree  # noqa: E402
from repro_torch.serving.sampling import (  # noqa: E402
    TAG_TOKEN, draw_keys, gumbel, prng_key, warp_logits)

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
        eng.generate(toks, n_new=2, extras={"image": None})
    with pytest.raises(NotImplementedError):
        eng.generate_reference(toks, n_new=2, extras={"image": None})
    with pytest.raises(NotImplementedError):
        eng.generate(toks, n_new=2, speculate=2)
    with pytest.raises(NotImplementedError):
        ServingEngine(tcfg, tparams, max_seq=12, device="cpu", mesh=object())
    assert eng.generate(toks, n_new=0).shape == (2, 0)


@pytest.mark.parametrize("n_new", [0, 3])
def test_generated_tokens_are_int32_as_in_jax(n_new):
    """Both engines return int32 tokens, the empty result included; the
    port's decode loop feeds them back to its int32-indexed embedding."""
    jcfg, jparams, tcfg, tparams = reduced_model()
    toks = prompt(2, 8, jcfg.vocab)
    jeng = JaxEngine(jcfg, jparams, max_seq=16, pim_bits=8)
    eng = ServingEngine(tcfg, tparams, max_seq=16, pim_bits=8, device="cpu")
    want = np.asarray(jeng.generate(jnp.asarray(toks), n_new=n_new))
    got = eng.generate(torch.from_numpy(toks), n_new=n_new)
    ref = eng.generate_reference(torch.from_numpy(toks), n_new=n_new)
    assert want.dtype == np.int32
    assert got.dtype == ref.dtype == torch.int32
    assert got.shape == ref.shape == want.shape == (2, n_new)


def test_decode_step_takes_int32_and_int64_ids_alike():
    _, _, tcfg, tparams = reduced_model()
    toks = torch.from_numpy(prompt(2, 1, tcfg.vocab))
    out = {}
    for dtype in (torch.int32, torch.int64):
        cache = init_cache(tcfg, 2, 4, CPU)
        out[dtype], _ = decode_step(tparams, tcfg, toks.to(dtype), cache, 0)
    torch.testing.assert_close(out[torch.int32], out[torch.int64], rtol=0, atol=0)


# ---- sampled decoding and the step the engine keeps ---------------------------
TEMPERATURE, TOP_K = 0.7, 8


def _perturbed_at(eng, toks, got, key):
    """perturbed_at(row, j): the port's warped logits that chose token j of
    ``row`` plus that draw's gumbel noise (row id ``row``, draw index j) —
    the values whose argmax is the sampled token."""
    logits_at = _logits_at(eng, toks, got)
    base = prng_key(key)

    def at(row, j):
        keys = draw_keys(base, torch.tensor([row]), j, TAG_TOKEN)
        lg = torch.from_numpy(logits_at(row, j))[None]
        warped = warp_logits(lg, TEMPERATURE, TOP_K)
        return (warped + gumbel(keys, lg.shape[-1]))[0].numpy()
    return at


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_sampled_generate_matches_jax_and_reference(bits):
    """The same key gives the JAX package's tokens: rows agree up to a first
    mismatch whose top-2 gap of gumbel + warped logits is within the logit
    tolerance over the temperature."""
    jcfg, jparams, tcfg, tparams = reduced_model()
    toks = prompt(3, 8, jcfg.vocab)
    key = jax.random.PRNGKey(4 + bits)
    jeng = JaxEngine(jcfg, jparams, max_seq=32, pim_bits=bits)
    eng = ServingEngine(tcfg, tparams, max_seq=32, pim_bits=bits, device="cpu")
    kw = dict(greedy=False, temperature=TEMPERATURE, top_k=TOP_K)
    want = np.asarray(jeng.generate(jnp.asarray(toks), n_new=6, key=key, **kw))
    got = eng.generate(torch.from_numpy(toks), n_new=6, key=np.asarray(key), **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 6)
    got = got.numpy()
    at = _perturbed_at(eng, toks, got, np.asarray(key))
    tol = LOGIT_TOL / TEMPERATURE
    assert_greedy_match(want, got, at, tol, msg="sampled: jax vs port")
    ref = eng.generate_reference(torch.from_numpy(toks), n_new=6, key=np.asarray(key), **kw)
    assert_greedy_match(got, ref.numpy(), at, tol, msg="sampled: generate vs reference")


def test_sampled_generate_is_a_function_of_the_key():
    """Same key, same tokens (an int seed names PRNGKey(seed)'s key); another
    key, other tokens; the default key is PRNGKey(0)'s."""
    _, _, tcfg, tparams = reduced_model()
    eng = ServingEngine(tcfg, tparams, max_seq=32, pim_bits=8, device="cpu")
    toks = torch.from_numpy(prompt(3, 8, tcfg.vocab))
    kw = dict(n_new=8, greedy=False, temperature=TEMPERATURE, top_k=TOP_K)
    a = eng.generate(toks, key=5, **kw)
    assert torch.equal(a, eng.generate(toks, key=np.asarray(jax.random.PRNGKey(5)), **kw))
    assert not torch.equal(a, eng.generate(toks, key=6, **kw))
    assert torch.equal(eng.generate(toks, **kw), eng.generate(toks, key=0, **kw))
    c = eng.generate(toks, n_new=8, greedy=False, temperature=1.3, key=6)
    assert c.shape == (3, 8) and int(c.max()) < tcfg.vocab


@pytest.mark.parametrize("greedy", [True, False])
def test_a_row_does_not_depend_on_its_neighbours(greedy):
    """Row 0's tokens are the same whatever rows 1 and 2 hold: its draws are
    keyed by its row id and draw index only."""
    _, _, tcfg, tparams = reduced_model()
    eng = ServingEngine(tcfg, tparams, max_seq=24, pim_bits=8, device="cpu")
    toks = prompt(3, 8, tcfg.vocab)
    other = toks.copy()
    other[1:] = prompt(2, 8, tcfg.vocab, seed=9)
    kw = dict(n_new=8, greedy=greedy, temperature=TEMPERATURE, top_k=TOP_K, key=3)
    a = eng.generate(torch.from_numpy(toks), **kw)
    b = eng.generate(torch.from_numpy(other), **kw)
    assert torch.equal(a[0], b[0])
    assert not torch.equal(a[1:], b[1:])


def test_reused_buffers_give_a_fresh_engines_tokens():
    """The engine keeps its cache across calls: a short prompt after a long
    one decodes as on a fresh engine (the cache is zeroed before prefill)."""
    _, _, tcfg, tparams = reduced_model()
    long_p = torch.from_numpy(prompt(2, 14, tcfg.vocab, seed=3))
    short_p = torch.from_numpy(prompt(2, 4, tcfg.vocab, seed=4))
    for kv_bits in (16, 8):
        cfg = tcfg.replace(kv_cache_bits=kv_bits)
        eng = ServingEngine(cfg, tparams, max_seq=24, pim_bits=8, device="cpu")
        eng.generate(long_p, n_new=8)
        got = eng.generate(short_p, n_new=8, greedy=False, key=2)
        fresh = ServingEngine(cfg, tparams, max_seq=24, pim_bits=8, device="cpu")
        assert torch.equal(got, fresh.generate(short_p, n_new=8, greedy=False, key=2))
        assert torch.equal(eng.state(2).logits, fresh.state(2).logits)


def test_new_params_drop_the_kept_step():
    """The step follows the engine's parameters: on the CPU it is made anew
    at each call on the current tree (greedy steps take no top-k), and a
    new ``down`` leaf, and then a whole new tree, change the output to that
    of a fresh engine on the new weights.  (On the card the engine keeps
    each captured step and captures it again after such a change:
    ``chip_smoke.py`` phase 8.)"""
    _, _, tcfg, tparams = reduced_model()
    _, _, _, other = reduced_model(seed=1)
    toks = torch.from_numpy(prompt(2, 8, tcfg.vocab))
    eng = ServingEngine(tcfg, tparams, max_seq=24, pim_bits=8, device="cpu")
    kw = dict(greedy=False, top_k=TOP_K)
    assert eng.step(2, **kw).keywords == dict(greedy=False, top_k=TOP_K)
    assert eng.step(2, greedy=True, top_k=TOP_K).keywords == dict(greedy=True, top_k=0)
    assert eng.step(2, **kw).args[0] is eng.params
    sampled = dict(n_new=6, greedy=False, temperature=TEMPERATURE, top_k=TOP_K, key=1)
    first = eng.generate(toks, **sampled)
    first_logits = eng.state(2).logits.clone()

    new_tree = quantize_tree(other, 8)
    eng.params["layers"]["mlp"]["down"] = new_tree["layers"]["mlp"]["down"]
    want_tree = quantize_tree(tparams, 8)
    want_tree["layers"]["mlp"]["down"] = new_tree["layers"]["mlp"]["down"]
    for params in (want_tree, new_tree):
        if params is new_tree:
            eng.params = new_tree
            assert eng.step(2, **kw).args[0] is new_tree
        got = eng.generate(toks, **sampled)
        fresh = ServingEngine(tcfg, params, max_seq=24, device="cpu")
        assert torch.equal(got, fresh.generate(toks, **sampled))
        assert torch.equal(eng.state(2).logits, fresh.state(2).logits)
        assert not torch.equal(eng.state(2).logits, first_logits)
    assert not torch.equal(got, first)

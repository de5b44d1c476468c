"""Port parity: the primitives of n-gram speculative decoding
(``repro_torch.serving.speculative`` and the verification half of
``repro_torch.serving.sampling``) against their JAX twins, on numpy-seeded
inputs.

Integers are equal: ``split``'s keys and the bits drawn from them, the
n-gram proposals, greedy acceptance, the controller's widths, and every
token and accepted count.  Floats (acceptance probabilities, residuals, the
controller's EMA and probe) are within 1e-6: both packages compute them in
f32, with reductions over the vocabulary in different orders.  The
reference's property cases run at a few seeds: a proposal distribution
equal to the target's accepts everything, one disjoint from it reduces to
sampling the target.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import sampling as jsamp  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro_torch.serving import sampling as tsamp  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402

from torch_helpers import one_thread  # noqa: E402,F401
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

FLOAT_TOL = 1e-6
SEEDS = (0, 1, 2)


def _key_data(k):
    return np.asarray(jax.random.key_data(k) if jnp.issubdtype(k.dtype, jax.dtypes.prng_key)
                      else k, np.int64)


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def _dists(rng, b, n, v, sharp=1.0):
    """(B, n, V) f32 distributions with a few exact zeros."""
    x = rng.gamma(sharp, size=(b, n, v))
    x[rng.random((b, n, v)) < 0.15] = 0.0
    x[..., 0] += 1e-3
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _window_keys(seed, b):
    jkeys = jsamp.draw_keys(jax.random.PRNGKey(seed), jnp.arange(b, dtype=jnp.int32), 3,
                            jsamp.TAG_WINDOW)
    tkeys = tsamp.draw_keys(tsamp.prng_key(seed), torch.arange(b), 3, tsamp.TAG_WINDOW)
    np.testing.assert_array_equal(tkeys.numpy(), _key_data(jkeys))
    return jkeys, tkeys


@pytest.mark.parametrize("seed", SEEDS)
def test_split_keys_and_bits_equal_jax(seed):
    """``split`` is ``jax.random.split`` on threefry (JAX 0.9's default,
    partitionable counters): both halves, and the bits and uniforms drawn
    from them."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (5, 2), dtype=np.uint64).astype(np.uint32)
    for row in words:
        jk = jax.random.wrap_key_data(jnp.asarray(row)) if hasattr(jax.random, "wrap_key_data") \
            else jnp.asarray(row)
        ja, jb = jax.random.split(jk)
        ta, tb = tsamp.split(torch.from_numpy(row.astype(np.int64))[None])
        np.testing.assert_array_equal(ta[0].numpy(), _key_data(ja))
        np.testing.assert_array_equal(tb[0].numpy(), _key_data(jb))
        np.testing.assert_array_equal(
            tsamp.random_bits(tb, 33)[0].numpy(),
            np.asarray(jax.random.bits(jb, (33,)), np.int64))
        np.testing.assert_array_equal(tsamp.uniform(ta, 7)[0].numpy(),
                                      np.asarray(jax.random.uniform(ja, (7,))))


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_equals_jax(seed):
    """A draw on log-probabilities with exact zeros (-inf), row keys."""
    rng = np.random.default_rng(seed)
    with np.errstate(divide="ignore"):
        lp = np.log(_dists(rng, 4, 1, 40)[:, 0])
    jkeys, tkeys = _window_keys(seed, 4)
    want = np.asarray(jax.vmap(jax.random.categorical)(jkeys, jnp.asarray(lp)))
    np.testing.assert_array_equal(tsamp.categorical(tkeys, _t(lp)).numpy(), want)


def _hist(seed, b=6, w=24, vocab=4):
    """Short-vocabulary histories, so trailing n-grams recur."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, vocab, (b, w)).astype(np.int32)
    hlen = rng.integers(1, w + 1, b).astype(np.int32)
    hlen[0], hlen[1] = 1, w  # the shortest and the full history
    return hist, hlen


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k,n", [(1, 1), (4, 2), (7, 3)])
def test_propose_ngram_and_first_host_equal_jax(seed, k, n):
    hist, hlen = _hist(seed)
    want = np.asarray(jspec.propose_ngram(jnp.asarray(hist), jnp.asarray(hlen), k, n))
    got = tspec.propose_ngram(_t(hist), _t(hlen, torch.int64), k, n).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    for row in range(hist.shape[0]):
        first = tspec.propose_first_host(hist[row], int(hlen[row]), n)
        assert first == jspec.propose_first_host(hist[row], int(hlen[row]), n) == got[row, 0]


def test_propose_ngram_reference_cases():
    """tests/test_speculative.py's cases: the most recent earlier match, the
    continuation past the live end padded with the last token, and the
    fallback that repeats it."""
    cases = [([1, 3, 4, 9, 3, 4, 7, 2, 3, 4, 0, 0], 10, 3, [7, 2, 3]),
             ([2, 5, 2, 5, 0, 0, 0, 0], 4, 4, [2, 5, 5, 5]),
             ([5, 6, 7, 8, 0, 0, 0, 0], 4, 3, [8, 8, 8])]
    for hist, hlen, k, want in cases:
        got = tspec.propose_ngram(torch.tensor([hist], dtype=torch.int32),
                                  torch.tensor([hlen]), k, 2)
        assert got.tolist() == [want]
        assert tspec.propose_first_host(np.asarray(hist), hlen, 2) == want[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_greedy_accept_equals_jax(seed):
    """Windows whose proposals agree with the argmax for a random prefix."""
    rng = np.random.default_rng(seed)
    b, k, v = 5, 4, 11
    logits = rng.standard_normal((b, k + 1, v)).astype(np.float32)
    g = logits.argmax(-1)
    window = rng.integers(0, v, (b, k + 1)).astype(np.int32)
    for row in range(b):
        agree = rng.integers(0, k + 1)
        window[row, 1:1 + agree] = g[row, :agree]
    jg, ja = jspec.greedy_accept(jnp.asarray(window), jnp.asarray(logits))
    tg, ta = tspec.greedy_accept(_t(window), _t(logits))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert sorted(set(ta.tolist())) != [0]


def test_controller_widths_equal_jax():
    """``ctrl_buckets``, and ``adaptive_k_host`` and its device twin
    ``_ctrl_k`` over EMAs and liveness, with the tie and empty-batch
    rules: ties take the smaller width, no live slot gives 0."""
    for k in (1, 2, 3, 4, 7, 8):
        assert tspec.ctrl_buckets(k) == jspec.ctrl_buckets(k)
    rng = np.random.default_rng(5)
    cases = [(np.zeros(4), np.ones(4, bool)), (np.ones(4), np.zeros(4, bool)),
             (np.full(3, 0.5), np.ones(3, bool))]
    cases += [(rng.random(4), rng.random(4) < 0.7) for _ in range(12)]
    for k, cost in ((4, 0.18), (7, 0.05), (2, 1.0)):
        jcfg, tcfg = jspec.SpecConfig(k=k, ctrl_cost=cost), tspec.SpecConfig(k=k, ctrl_cost=cost)
        for ema, live in cases:
            ema = ema.astype(np.float32)
            want = jspec.adaptive_k_host(ema, live, jcfg)
            assert tspec.adaptive_k_host(ema, live, tcfg) == want
            dev = int(tspec._ctrl_k(_t(ema), _t(live), k, cost))
            assert dev == int(jspec._ctrl_k(jnp.asarray(ema), jnp.asarray(live), k, cost))
            if live.any():
                assert dev == want
    assert tspec.adaptive_k_host(np.ones(2, np.float32), np.zeros(2, bool), tcfg) == 0


@pytest.mark.parametrize("greedy", [True, False])
def test_ctrl_probe_and_update_equal_jax(greedy):
    rng = np.random.default_rng(7)
    b, v, k = 6, 30, 4
    lg0 = rng.standard_normal((b, v)).astype(np.float32) * 2
    d1 = rng.integers(0, v, b).astype(np.int32)
    d1[:2] = lg0[:2].argmax(-1)
    jp = jspec._ctrl_probe(jnp.asarray(lg0), jnp.asarray(d1), greedy=greedy, temperature=0.8,
                           top_k=8)
    tp = tspec._ctrl_probe(_t(lg0), _t(d1), greedy=greedy, temperature=0.8, top_k=8)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=FLOAT_TOL, rtol=0)
    ema = rng.random(b).astype(np.float32)
    live = np.array([1, 1, 0, 1, 1, 1], bool)
    a = np.array([0, 4, 2, 1, 3, 4], np.int32)
    for kw in (k, 0, 2):
        want = jspec._ctrl_update(jnp.asarray(ema), jnp.asarray(live), jnp.asarray(a), kw,
                                  jp, 0.5)
        got = tspec._ctrl_update(_t(ema), _t(live), _t(a, torch.int64), kw, tp, 0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLOAT_TOL, rtol=0)
        keff = torch.tensor(kw)
        np.testing.assert_allclose(
            tspec._ctrl_update(_t(ema), _t(live), _t(a, torch.int64), keff, tp, 0.5).numpy(),
            np.asarray(want), atol=FLOAT_TOL, rtol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_acceptance_probs_and_residual_equal_jax(seed):
    rng = np.random.default_rng(seed)
    b, k, v = 4, 3, 17
    q, p = _dists(rng, b, k, v), _dists(rng, b, k + 1, v, sharp=0.5)
    drafts = rng.integers(0, v, (b, k)).astype(np.int32)
    want = np.asarray(jsamp.acceptance_probs(jnp.asarray(drafts), jnp.asarray(q), jnp.asarray(p)))
    got = tsamp.acceptance_probs(_t(drafts), _t(q), _t(p)).numpy()
    np.testing.assert_allclose(got, want, atol=FLOAT_TOL, rtol=0)
    assert (q == 0).any() and set(np.unique(got)) - {0.0, 1.0}
    for pp, qq in ((p[:, :k], q), (p[:, :k], p[:, :k])):
        np.testing.assert_allclose(tsamp.residual_dist(_t(pp), _t(qq)).numpy(),
                                   np.asarray(jsamp.residual_dist(jnp.asarray(pp),
                                                                  jnp.asarray(qq))),
                                   atol=FLOAT_TOL, rtol=0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("capped", [False, True])
def test_rejection_sample_equals_jax(seed, capped):
    """Per-row window keys, random and one-hot proposals, with ``kcap``
    (0 to k) and ``n_draws`` > k or without: tokens and accepted counts
    equal."""
    rng = np.random.default_rng(seed)
    b, k, v = 8, 4, 23
    p = _dists(rng, b, k + 1, v, sharp=0.3)
    drafts = np.stack([rng.choice(v, k, p=None) for _ in range(b)]).astype(np.int32)
    drafts[:4] = p[:4, :k].argmax(-1)  # likely accepted
    for q in (_dists(rng, b, k, v), np.eye(v, dtype=np.float32)[drafts]):
        kcap = rng.integers(0, k + 1, b).astype(np.int32) if capped else None
        n_draws = 7 if capped else None
        jkeys, tkeys = _window_keys(seed, b)
        jt, ja = jsamp.rejection_sample(
            jkeys, jnp.asarray(drafts), jnp.asarray(q), jnp.asarray(p),
            kcap=None if kcap is None else jnp.asarray(kcap), n_draws=n_draws)
        tt, ta = tsamp.rejection_sample(tkeys, _t(drafts), _t(q), _t(p),
                                        kcap=None if kcap is None else _t(kcap, torch.int64),
                                        n_draws=n_draws)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert tt.dtype == torch.int32


@pytest.mark.parametrize("seed", SEEDS)
def test_typical_accept_sample_equals_jax(seed):
    rng = np.random.default_rng(seed)
    b, k, v = 8, 3, 19
    p = _dists(rng, b, k + 1, v, sharp=0.2)
    drafts = rng.integers(0, v, (b, k)).astype(np.int32)
    drafts[:5] = p[:5, :k].argmax(-1)
    for kcap in (None, rng.integers(0, k + 1, b).astype(np.int32)):
        jkeys, tkeys = _window_keys(seed, b)
        jt, ja = jsamp.typical_accept_sample(
            jkeys, jnp.asarray(drafts), jnp.asarray(p),
            kcap=None if kcap is None else jnp.asarray(kcap), eps=0.3, delta=0.09)
        tt, ta = tsamp.typical_accept_sample(
            tkeys, _t(drafts), _t(p), kcap=None if kcap is None else _t(kcap, torch.int64),
            eps=0.3, delta=0.09)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ta.max() > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_rejection_q_equals_p_accepts_everything(seed):
    rng = np.random.default_rng(seed)
    b, k, v = 4, 3, 16
    p = _dists(rng, b, k + 1, v)
    drafts = np.stack([rng.choice(np.flatnonzero(p[r, 0] > 0), k) for r in range(b)])
    drafts = drafts.astype(np.int32)
    for r in range(b):  # every proposal in q's support
        for i in range(k):
            if p[r, i, drafts[r, i]] == 0:
                drafts[r, i] = int(p[r, i].argmax())
    _, tkeys = _window_keys(seed, b)
    toks, a = tsamp.rejection_sample(tkeys, _t(drafts), _t(p[:, :k]), _t(p))
    assert a.tolist() == [k] * b
    np.testing.assert_array_equal(toks[:, :k].numpy(), drafts)


@pytest.mark.parametrize("seed", SEEDS)
def test_rejection_disjoint_support_reduces_to_target(seed):
    """q's support disjoint from p's: nothing is accepted and the emitted
    token lies in p's support."""
    v, b, k = 12, 64, 3
    rng = np.random.default_rng(seed)
    p_row = np.concatenate([np.zeros(v // 2), rng.gamma(1.0, size=v // 2) + 1e-9])
    p_row /= p_row.sum()
    q_row = np.concatenate([np.ones(v // 2) / (v // 2), np.zeros(v // 2)])
    p = np.tile(p_row, (b, k + 1, 1)).astype(np.float32)
    q = np.tile(q_row, (b, k, 1)).astype(np.float32)
    drafts = rng.integers(0, v // 2, (b, k)).astype(np.int32)
    _, tkeys = _window_keys(seed, b)
    toks, a = tsamp.rejection_sample(tkeys, _t(drafts), _t(q), _t(p))
    assert a.tolist() == [0] * b
    assert (p_row[toks[:, 0].numpy()] > 0).all()


@pytest.mark.parametrize("accept", ["exact", "typical"])
def test_accept_equals_jax_with_a_cap_and_at_width_zero(accept):
    """``_accept`` on one set of window logits: greedy (capped), sampled
    with one-hot proposals, and a width-0 window's plain draw."""
    rng = np.random.default_rng(11)
    b, k, v = 5, 3, 29
    lg = (rng.standard_normal((b, k + 1, v)) * 3).astype(np.float32)
    drafts = rng.integers(0, v, (b, k)).astype(np.int32)
    drafts[:3] = lg[:3, :k].argmax(-1)
    tok = rng.integers(0, v, (b, 1)).astype(np.int32)
    window = np.concatenate([tok, drafts], 1)
    kcap = np.array([0, 1, 3, 2, 3], np.int32)
    jkeys, tkeys = _window_keys(2, b)
    mode = dict(temperature=0.8, top_k=8)
    for greedy, width in ((True, k), (False, k), (False, 0)):
        jd, td = jnp.asarray(drafts[:, :width]), _t(drafts[:, :width])
        want = jspec._accept(jnp.asarray(window[:, :width + 1]), jd, jnp.asarray(lg),
                             greedy=greedy, wkeys=jkeys, q=None, kcap=jnp.asarray(kcap),
                             n_draws=k, accept=accept, **mode)
        got = tspec._accept(_t(window[:, :width + 1]), td, _t(lg), greedy=greedy, wkeys=tkeys,
                            kcap=_t(kcap, torch.int64), n_draws=k, accept=accept, **mode)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

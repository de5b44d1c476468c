"""Port parity: the primitives of tree drafts against their JAX twins, on
numpy-seeded inputs and reduced qwen2-1.5b.

Integers are equal: the n-gram matches and chains (chain 0 is the linear
proposer's proposal), the tree layout and its attention mask, greedy tree
acceptance and every token, accepted count and kept chain of
``tree_reject_sample`` on the JAX package's window keys (over dominant
chains, heads with no mass, duplicate heads and caps of 0, 1 and D).  The
tree window (``attn_verify``/``verify_step(tree=)``) and ``tree_relocate``
are held against JAX's on dense and paged caches at the tolerances of
tests/test_torch_verify.py (f32 1e-5; int8 caches codes within one step,
1e-3), pools everywhere but the trash page.  bf16 windows, which JAX's CPU
backend cannot run, are held against the port's own linear window: a fan-1
tree is the linear window and chain 0 of any tree scores as an equal-width
linear window does, bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jax_attention  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serving import sampling as jsamp  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.serving import sampling as tsamp  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402

from torch_helpers import CPU, one_thread, prompt, reduced_model  # noqa: E402,F401
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

SEEDS = (0, 1, 2)
PS, WIDTH, PAGES, B = 4, 6, 24, 3  # page size, pages a row, pool pages, rows
SEQ = PS * WIDTH
FAN, DEPTH = 2, 3
T = 1 + FAN * DEPTH


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def _key_data(k):
    return np.asarray(jax.random.key_data(k) if jnp.issubdtype(k.dtype, jax.dtypes.prng_key)
                      else k, np.int64)


def _window_keys(seed, b):
    jkeys = jsamp.draw_keys(jax.random.PRNGKey(seed), jnp.arange(b, dtype=jnp.int32), 3,
                            jsamp.TAG_WINDOW)
    tkeys = tsamp.draw_keys(tsamp.prng_key(seed), torch.arange(b), 3, tsamp.TAG_WINDOW)
    np.testing.assert_array_equal(tkeys.numpy(), _key_data(jkeys))
    return jkeys, tkeys


def _hist(seed, b=6, w=24, vocab=3):
    """Short-vocabulary histories, so trailing n-grams recur several times."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, vocab, (b, w)).astype(np.int32)
    hlen = rng.integers(1, w + 1, b).astype(np.int32)
    hlen[0], hlen[1] = 1, w  # the shortest and the full history
    return hist, hlen


# ---------------------------------------------------------------- proposer --
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fan,depth,n", [(1, 3, 2), (3, 2, 1), (4, 4, 3)])
def test_tree_proposals_equal_jax(seed, fan, depth, n):
    """``_ngram_matches`` (the fan most recent matches, descending, -1 past
    the last) and ``propose_ngram_tree`` equal JAX's; chain 0 is
    ``propose_ngram``'s proposal."""
    hist, hlen = _hist(seed)
    jj, jlast = jspec._ngram_matches(jnp.asarray(hist), jnp.asarray(hlen), fan, n)
    tj, tlast = tspec._ngram_matches(_t(hist), _t(hlen, torch.int64), fan, n)
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    want = np.asarray(jspec.propose_ngram_tree(jnp.asarray(hist), jnp.asarray(hlen), fan,
                                               depth, n))
    got = tspec.propose_ngram_tree(_t(hist), _t(hlen, torch.int64), fan, depth, n)
    assert got.dtype == torch.int32 and tuple(got.shape) == (hist.shape[0], fan, depth)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got[:, 0].numpy(), tspec.propose_ngram(_t(hist), _t(hlen, torch.int64), depth, n).numpy())
    if fan > 1 and n == 1:
        assert (tj[:, 1] >= 0).any()  # second matches exist


def test_tree_proposer_reference_cases():
    """tests/test_tree_spec.py's cases: chain 0 the linear proposer's, two
    matches with different continuations most recent first, and the
    fallback repeating the last token."""
    hist = torch.tensor([[5, 9, 5, 9, 5, 0, 0, 0], [1, 2, 3, 1, 2, 3, 1, 0]], dtype=torch.int32)
    hlen = torch.tensor([5, 7])
    tree = tspec.propose_ngram_tree(hist, hlen, 2, 3, 2)
    assert torch.equal(tree[:, 0], tspec.propose_ngram(hist, hlen, 3, 2))
    hist = torch.tensor([[7, 8, 3, 7, 8, 4, 7, 8, 0, 0]], dtype=torch.int32)
    assert tspec.propose_ngram_tree(hist, torch.tensor([8]), 2, 1, 2)[0, :, 0].tolist() == [4, 3]
    hist = torch.tensor([[1, 2, 3, 4, 5, 0, 0, 0]], dtype=torch.int32)
    assert (tspec.propose_ngram_tree(hist, torch.tensor([5]), 2, 2, 2) == 5).all()


# ------------------------------------------------------------------ layout --
@pytest.mark.parametrize("fan,depth", [(1, 4), (2, 2), (3, 3), (4, 1)])
def test_tree_layout_and_mask_equal_jax(fan, depth):
    """``tree_layout``'s depths and visibility, their device form with the
    chains' predecessor nodes, and the (B, T, S) mask of rows whose windows
    start inside, at the end of and past a store equal JAX's; a fan-1
    tree's mask is the linear window's frontier mask, boolean for
    boolean."""
    dep, vis = attention.tree_layout(fan, depth)
    jdep, jvis = jax_attention.tree_layout(fan, depth)
    np.testing.assert_array_equal(dep, jdep)
    np.testing.assert_array_equal(vis, jvis)
    tdep, tvis, tpred = attention.tree_tensors(fan, depth, "cpu")
    assert tdep.dtype == torch.int64 and tvis.dtype == torch.bool
    # the predecessor of chain f's step i (greedy_tree_accept's table)
    assert tpred.tolist() == [[f * depth + i if i else 0 for i in range(depth)]
                              for f in range(fan)]
    assert attention.tree_tensors(fan, depth, CPU)[0] is tdep  # made once and kept
    np.testing.assert_array_equal(tvis.numpy(), vis)
    t = 1 + fan * depth
    pos = np.array([0, 5, 14, 16])
    want = np.asarray(jax_attention._tree_valid(vis, jnp.asarray(pos), t, 16))
    got = attention.tree_valid(tvis, _t(pos), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    if fan == 1:
        front = pos[:, None] + np.arange(t)
        np.testing.assert_array_equal(got.numpy(), np.arange(16) <= front[..., None])


# -------------------------------------------------------------- acceptance --
def _onehot_logits(tokens, vocab=16, scale=10.0):
    return (scale * np.eye(vocab, dtype=np.float32)[np.asarray(tokens)]).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_greedy_tree_accept_equals_jax(seed):
    """Random chains whose prefixes agree with the argmax at their
    predecessor nodes, with and without a cap: tokens, accepted counts and
    kept chains equal (ties: the lowest chain)."""
    rng = np.random.default_rng(seed)
    b, fan, depth, v = 8, 3, 4, 7
    logits = rng.standard_normal((b, 1 + fan * depth, v)).astype(np.float32)
    g = logits.argmax(-1)
    chains = rng.integers(0, v, (b, fan, depth)).astype(np.int32)
    for row in range(b):
        for f in range(fan):
            for i in range(rng.integers(0, depth + 1)):
                chains[row, f, i] = g[row, 0 if i == 0 else f * depth + i]
    chains[0, 1] = chains[0, 0]  # a duplicate chain: a tie, kept as chain 0
    for kcap in (None, rng.integers(0, depth + 1, b).astype(np.int32)):
        jt, ja, jcf = jspec.greedy_tree_accept(
            jnp.asarray(chains), jnp.asarray(logits),
            kcap=None if kcap is None else jnp.asarray(kcap))
        tt, ta, tcf = tspec.greedy_tree_accept(_t(chains), _t(logits),
                                               kcap=None if kcap is None else _t(kcap))
        assert tt.dtype == torch.int32
        for got, want in ((tt, jt), (ta, ja), (tcf, jcf)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert len(set(ta.tolist())) > 1 and tcf.max() > 0


def test_greedy_tree_accept_reference_cases():
    chains = torch.tensor([[[5, 9], [4, 6]]], dtype=torch.int32)
    toks, a, cf = tspec.greedy_tree_accept(chains, _t(_onehot_logits([[4, 9, 7, 6, 8]])))
    assert (int(a[0]), int(cf[0]), toks[0].tolist()) == (2, 1, [4, 6, 8])
    chains = torch.tensor([[[4, 9], [4, 6]]], dtype=torch.int32)
    lg = _t(_onehot_logits([[4, 1, 2, 3, 5]]))
    toks, a, cf = tspec.greedy_tree_accept(chains, lg)
    assert (int(a[0]), int(cf[0]), toks[0, :2].tolist()) == (1, 0, [4, 1])
    assert int(tspec.greedy_tree_accept(chains, lg, kcap=torch.tensor([0]))[1][0]) == 0


def _tree_dists(rng, b, fan, depth, v, chains):
    """(B, 1+F*D, V) distributions with exact zeros; rows 0-1 put nearly all
    the mass on one chain's path (row 0 chain 1, row 1 chain 0), row 2 none
    on any head, row 3 has duplicate heads."""
    x = rng.gamma(0.3, size=(b, 1 + fan * depth, v))
    x[rng.random(x.shape) < 0.2] = 0.0
    x[..., 0] += 1e-3
    p = x / x.sum(-1, keepdims=True)
    for row, f in ((0, 1), (1, 0)):
        p[row, 0] = 0.0
        p[row, 0, chains[row, f, 0]] = 1.0
        for i in range(depth):
            nxt = chains[row, f, i + 1] if i + 1 < depth else (i + 3) % v
            p[row, 1 + f * depth + i] = 0.0
            p[row, 1 + f * depth + i, nxt] = 1.0
    p[2, 0, chains[2, :, 0]] = 0.0
    p[2, 0] /= p[2, 0].sum()
    chains[3, 1, 0] = chains[3, 0, 0]
    return p.astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cap", ["none", "mixed"])
def test_tree_reject_sample_equals_jax(seed, cap):
    """Per-row window keys over dominant chains, heads with no mass and
    duplicate heads, uncapped or with caps of 0, 1 and D: tokens, accepted
    counts and kept chains equal JAX's."""
    rng = np.random.default_rng(seed)
    b, fan, depth, v = 8, 3, 3, 11
    chains = rng.integers(0, v, (b, fan, depth)).astype(np.int32)
    p = _tree_dists(rng, b, fan, depth, v, chains)
    for row in range(4, b):  # some heads carry mass: accepted at times
        chains[row, rng.integers(0, fan), 0] = p[row, 0].argmax()
    kcap = None if cap == "none" else np.array([depth, 1, 0, depth, 0, 1, depth, 1], np.int32)
    jkeys, tkeys = _window_keys(seed, b)
    jt, ja, jcf = jsamp.tree_reject_sample(jkeys, jnp.asarray(chains), jnp.asarray(p),
                                           kcap=None if kcap is None else jnp.asarray(kcap))
    tt, ta, tcf = tsamp.tree_reject_sample(tkeys, _t(chains), _t(p),
                                           kcap=None if kcap is None else _t(kcap))
    assert tt.dtype == torch.int32
    for got, want in ((tt, jt), (ta, ja), (tcf, jcf)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kcap is None:
        assert (int(ta[0]), int(tcf[0])) == (depth, 1) and int(ta[1]) == depth
        assert int(ta[2]) == 0 and int(tt[2, 0]) not in chains[2, :, 0]
    else:
        assert (ta <= _t(kcap).long()).all() and int(ta[2]) == 0


def test_tree_reject_sample_reference_cases():
    """tests/test_tree_spec.py's: mass on chain 1's path accepts it whole
    with the bonus; no mass on either head rejects both, and a cap of 0
    draws the root's own distribution."""
    chains = torch.tensor([[[5, 9], [4, 6]]], dtype=torch.int32)
    p = torch.softmax(_t(_onehot_logits([[4, 9, 7, 6, 8]], scale=30.0)), -1)
    toks, a, cf = tsamp.tree_reject_sample(tsamp.fold_in(tsamp.prng_key(0), torch.tensor([0])),
                                           chains, p)
    assert (int(a[0]), int(cf[0]), toks[0].tolist()) == (2, 1, [4, 6, 8])
    p = torch.softmax(_t(_onehot_logits([[7, 1, 1, 1, 1]], scale=30.0)), -1)
    for seed in range(4):
        keys = tsamp.fold_in(tsamp.prng_key(seed), torch.tensor([0]))
        toks, a, _ = tsamp.tree_reject_sample(keys, chains, p)
        assert int(a[0]) == 0 and int(toks[0, 0]) not in (5, 4)
        toks, a, _ = tsamp.tree_reject_sample(keys, chains, p, kcap=torch.tensor([0]))
        assert int(a[0]) == 0 and int(toks[0, 0]) == 7


# ---------------------------------------------------------- the tree window --
def _block_tables(seed=0):
    rng = np.random.default_rng(seed)
    return rng.permutation(np.arange(1, PAGES))[:B * WIDTH].reshape(B, WIDTH).astype(np.int32)


def _tol(kv_bits):
    return 1e-5 if kv_bits == 16 else 1e-3


def _assert_caches_close(got, want, kv_bits, paged):
    for name in want:
        g = got[name]
        g = np.asarray(g.float() if g.dtype != torch.int8 else g)
        w = np.asarray(want[name]).astype(g.dtype)
        if paged:  # the trash page holds whichever duplicate write came last
            g, w = g[:, 1:], w[:, 1:]
        if name in ("k", "v") and kv_bits == 8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, name
        else:
            np.testing.assert_allclose(g, w, rtol=_tol(kv_bits), atol=_tol(kv_bits),
                                       err_msg=name)


def _prefilled(jcfg, jparams, tcfg, tparams, paged, lens):
    """Both packages' caches (the JAX one None without ``jparams``) after
    each row's prompt (``lens``) was prefilled (paged: into its block-table
    row's pages, the block tables set)."""
    bt = _block_tables(7)
    jc = None
    if paged:
        if jparams is not None:
            jc = jax_lm.init_paged_cache(jcfg, B, SEQ, PAGES, PS)
        tc = lm.init_paged_cache(tcfg, B, SEQ, PAGES, PS, CPU)
    else:
        if jparams is not None:
            jc = jax_lm.init_cache(jcfg, B, SEQ)
        tc = lm.init_cache(tcfg, B, SEQ, CPU)
    for row, n in enumerate(lens):
        spad = -(-n // PS) * PS
        toks = np.zeros((1, spad), np.int32)
        toks[0, :n] = prompt(1, n, tcfg.vocab, seed=20 + row)
        if paged:
            if jc is not None:
                _, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jc, length=jnp.int32(n),
                                       pages=jnp.asarray(bt[row, :spad // PS]),
                                       slot=jnp.int32(row))
            lm.prefill(tparams, tcfg, torch.from_numpy(toks), tc, length=n,
                       pages=bt[row, :spad // PS], slot=row)
        else:
            if jc is not None:
                j1 = jax_lm.init_cache(jcfg, 1, SEQ)
                _, j1 = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks[:, :n]), j1)
                jc = {"layers": {k: v.at[:, row].set(j1["layers"][k][:, 0])
                                 for k, v in jc["layers"].items()}}
            t1 = lm.init_cache(tcfg, 1, SEQ, CPU)
            lm.prefill(tparams, tcfg, torch.from_numpy(toks[:, :n]), t1)
            for k, v in tc["layers"].items():
                v[:, row] = t1["layers"][k][:, 0]
    if paged:
        if jc is not None:
            jc["block_tables"] = jnp.asarray(bt)
        tc["block_tables"].copy_(torch.from_numpy(bt))
    return jc, tc


def _pool(tree):
    return {k: v for k, v in tree["layers"].items()}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_tree_window_and_relocation_match_jax(kv_bits, paged):
    """``verify_step(tree=(2, 3))`` over prefilled rows (the last one's tree
    columns run past the store), then ``tree_relocate`` with chain 0 kept
    (the identity), nothing accepted (a no-op) and chain 1's two steps
    moved across a page boundary: logits and caches within the tolerance of
    JAX's after each."""
    jcfg, jparams, tcfg, tparams = reduced_model(kv_cache_bits=kv_bits)
    lens = (3, 6, SEQ - 4)
    jc, tc = _prefilled(jcfg, jparams, tcfg, tparams, paged, lens)
    pos = np.array(lens)
    toks = prompt(B, T, jcfg.vocab, seed=9)
    kw = dict(page_size=PS) if paged else {}
    jl, jc = jax_lm.verify_step(jparams, jcfg, jnp.asarray(toks), jc, jnp.asarray(pos, jnp.int32),
                                tree=(FAN, DEPTH), **kw)
    tl, got = lm.verify_step(tparams, tcfg, torch.from_numpy(toks), tc, torch.from_numpy(pos),
                             tree=(FAN, DEPTH), **kw)
    assert got is tc
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=_tol(kv_bits),
                               atol=_tol(kv_bits))
    _assert_caches_close(_pool(tc), _pool(jc), kv_bits, paged)
    before = {k: v.clone() for k, v in _pool(tc).items()}
    for a, cf in (([DEPTH, 0, 0], [0, 0, 0]), ([0, 2, 0], [1, 1, 1])):
        jc = jax_lm.tree_relocate(jcfg, jc, jnp.asarray(pos, jnp.int32),
                                  jnp.asarray(a, jnp.int32), jnp.asarray(cf, jnp.int32),
                                  fan=FAN, depth=DEPTH, page_size=PS if paged else 0)
        out = lm.tree_relocate(tcfg, tc, torch.from_numpy(pos), torch.tensor(a),
                               torch.tensor(cf), fan=FAN, depth=DEPTH, **kw)
        assert out is tc
        _assert_caches_close(_pool(tc), _pool(jc), kv_bits, paged)
    # row 1's chain-1 columns 10, 11 (page 2) moved to 7, 8 (pages 1 | 2),
    # byte for byte; nothing else changed (the trash page aside)
    bt = tc["block_tables"].long() if paged else None
    moved = {}
    for dst, src in ((7, 10), (8, 11)):
        at = ((bt[1, dst // PS], dst % PS), (bt[1, src // PS], src % PS)) if paged \
            else ((1, dst), (1, src))
        moved[at[0]] = at[1]
    for name, leaf in _pool(tc).items():
        want = before[name].clone()
        for (dp, dc), (sp, sc) in moved.items():
            want[:, dp, :, dc] = before[name][:, sp, :, sc]
        if paged:
            leaf, want = leaf[:, 1:], want[:, 1:]
        assert torch.equal(leaf, want), name


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("dtype,kv_bits", [("float32", 16), ("bfloat16", 16), ("bfloat16", 8)])
def test_fan1_and_chain0_equal_the_linear_window(dtype, kv_bits, paged):
    """On the port's own windows (bf16 included): a fan-1 tree of depth 6
    is the linear window of 7 tokens (logits and caches ``torch.equal``),
    and chain 0 of a (2, 3) tree scores as an equal-width linear window
    whose first 4 tokens are the root and chain 0 (its first 4 logits
    ``torch.equal``)."""
    _, _, tcfg, tparams = reduced_model(param_dtype=dtype, kv_cache_bits=kv_bits)
    lens = (3, 6, 9)
    toks = torch.from_numpy(prompt(B, T, tcfg.vocab, seed=12))
    kw = dict(page_size=PS) if paged else {}
    runs = {}
    for name, tree in (("linear", None), ("fan1", (1, T - 1)), ("tree", (FAN, DEPTH))):
        _, tc = _prefilled(None, None, tcfg, tparams, paged, lens)
        window = toks.clone()
        if name == "tree":  # chain 1 differs from the linear tail
            window[:, 1 + DEPTH:] = (window[:, 1 + DEPTH:] + 1) % tcfg.vocab
        logits, _ = lm.verify_step(tparams, tcfg, window, tc, torch.tensor(lens), tree=tree,
                                   **kw)
        runs[name] = (logits, tc)
    lin, lc = runs["linear"]
    assert torch.equal(runs["fan1"][0], lin)
    for k, v in lc["layers"].items():
        assert torch.equal(runs["fan1"][1]["layers"][k], v), k
    assert torch.equal(runs["tree"][0][:, :1 + DEPTH], lin[:, :1 + DEPTH])
    assert not torch.equal(runs["tree"][0], lin)

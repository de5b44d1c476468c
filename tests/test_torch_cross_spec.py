"""Port parity: speculation's primitives and the fixed-batch engine on the
vlm and encdec families (llama-3.2-vision-90b's groups of dense blocks and
gated cross blocks, seamless-m4t-medium's decoder), reduced, against the
JAX package on the same weights, extras, prompts and keys.

The vlm's gates are planted at 0.5 (``torch_helpers.cross_model``): at the
reference's zero init its image moves nothing.  ``verify_step(tree=(2,
2))`` and ``tree_relocate`` are held against JAX's on random dense and
paged caches (block tables a permutation of the pool), every leaf of the
family's K/V stack (``groups_self`` with its two lead dims, ``decoder``):
logits and f32 caches within 1e-5, pools everywhere but the trash page;
on bf16 and int8 caches (codes and scales) the relocation alone equals
JAX's bit for bit and moves chain 1's columns and nothing else.
``draft_propose`` with extras (a self-draft at int8) equals JAX's
``_draft_propose``: proposals equal, ``q`` within 1e-6.  On the engine,
greedy tokens are held margin-aware at 1e-4 against JAX's and against the
port's own plain greedy decoding (``torch_helpers.assert_greedy_match``:
the port's decode linears run ``pim_matvec``'s plain version, the JAX
package's ``x @ dq(w)``); sampled ones, drawn from the JAX package's window
keys, equal, and so does ``spec_stats``.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import lm as jax_lm  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import SpecConfig as JaxSpec  # noqa: E402
from repro.serving import quantize_tree as jax_quantize_tree  # noqa: E402
from repro.serving import speculative as jax_speculative  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ServingEngine, SpecConfig, draft_propose, quantize_tree)

from torch_helpers import (  # noqa: E402,F401
    ENCDEC, VLM, assert_greedy_match, cross_extras, cross_model, one_thread, prompt,
    reduced_pair, serve_deciding)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = [VLM, ENCDEC]
STACK = {VLM: "groups_self", ENCDEC: "decoder"}
LOGIT_TOL = 1e-4
Q_TOL = 1e-6
PS, WIDTH, PAGES, B = 4, 6, 16, 2  # page size, pages a row, pool pages, rows
SEQ = PS * WIDTH
FAN, DEPTH = 2, 2
T = 1 + FAN * DEPTH
POS = np.array([5, SEQ - 3])  # row 1's tree columns run past the store
MAX_SEQ, N_NEW, KEY = 28, 14, 5
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)


def _t(ex):
    return {k: torch.from_numpy(v) for k, v in ex.items()}


def _tol(kv_bits):
    return 1e-5 if kv_bits == 16 else 1e-3


def _random_caches(jcfg, tcfg, paged, kv_bits, seed=1):
    """The same random cache in both packages: every leaf of the family's
    K/V stack (int8 codes and positive scales for ``kv_bits`` 8), dense (B,
    SEQ) rows or a pool of PAGES pages under shuffled block tables."""
    if paged:
        jc = jax_lm.init_paged_cache(jcfg, B, SEQ, PAGES, PS)
        bt = np.random.default_rng(2).permutation(np.arange(1, PAGES))[:B * WIDTH]
        bt = bt.reshape(B, WIDTH).astype(np.int32)
    else:
        jc = jax_lm.init_cache(jcfg, B, SEQ)
    rng = np.random.default_rng(seed)
    key = STACK[jcfg.arch_id]
    leaves = {}
    for name, leaf in jc[key].items():
        if kv_bits == 8 and not name.endswith("_scale"):
            leaves[name] = rng.integers(-127, 128, leaf.shape).astype(np.int8)
        elif name.endswith("_scale"):
            leaves[name] = rng.uniform(0.01, 0.05, leaf.shape).astype(np.float32)
        else:
            leaves[name] = rng.standard_normal(leaf.shape).astype(np.float32)
    jc = {key: {k: jnp.asarray(v) for k, v in leaves.items()}}
    tc = {key: {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}}
    if paged:
        jc["block_tables"] = jnp.asarray(bt)
        tc["block_tables"] = torch.from_numpy(bt)
    return jc, tc


def _assert_caches_close(got, want, kv_bits, paged, lead):
    for name in want:
        g = got[name]
        g = np.asarray(g.float() if g.dtype != torch.int8 else g)
        w = np.asarray(want[name]).astype(g.dtype)
        if paged:  # the trash page holds whichever duplicate write came last
            g, w = g[(slice(None),) * lead + (slice(1, None),)], \
                w[(slice(None),) * lead + (slice(1, None),)]
        if name in ("k", "v") and kv_bits == 8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, name
        else:
            np.testing.assert_allclose(g, w, rtol=_tol(kv_bits), atol=_tol(kv_bits),
                                       err_msg=name)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_tree_window_matches_jax(arch, paged):
    """``verify_step(tree=(2, 2))`` with the rows' extras over a random f32
    cache, then ``tree_relocate`` with chain 0 kept (the identity) and
    chain 1's two steps moved, row 1's sources past the store: logits and
    every leaf of the stack within 1e-5 of JAX's after each."""
    jcfg, jparams, tcfg, tparams = cross_model(arch)
    (key, lead), = lm.cache_stacks(tcfg)
    jc, tc = _random_caches(jcfg, tcfg, paged, 16)
    ex = cross_extras(jcfg, jparams, B, seed=3)
    toks = prompt(B, T, jcfg.vocab, seed=9)
    kw = dict(page_size=PS) if paged else {}
    jl, jc = jax_lm.verify_step(jparams, jcfg, jnp.asarray(toks), jc, jnp.asarray(POS, jnp.int32),
                                ex, tree=(FAN, DEPTH), **kw)
    tl, got = lm.verify_step(tparams, tcfg, torch.from_numpy(toks), tc, torch.from_numpy(POS),
                             _t(ex), tree=(FAN, DEPTH), **kw)
    assert got is tc and tuple(tl.shape) == (B, T, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=_tol(16), atol=_tol(16))
    _assert_caches_close(tc[key], jc[key], 16, paged, len(lead))
    for a, cf in (([DEPTH, DEPTH], [0, 0]), ([2, 2], [1, 1])):
        jc = jax_lm.tree_relocate(jcfg, jc, jnp.asarray(POS, jnp.int32),
                                  jnp.asarray(a, jnp.int32), jnp.asarray(cf, jnp.int32),
                                  fan=FAN, depth=DEPTH, page_size=PS if paged else 0)
        assert lm.tree_relocate(tcfg, tc, torch.from_numpy(POS), torch.tensor(a),
                                torch.tensor(cf), fan=FAN, depth=DEPTH, **kw) is tc
        _assert_caches_close(tc[key], jc[key], 16, paged, len(lead))
    # the second chain's window logits differ from the first's: the mask
    # keeps the chains apart
    assert not torch.allclose(tl[:, 1:1 + DEPTH], tl[:, 1 + DEPTH:])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_tree_relocate_matches_jax_leaf_for_leaf(arch, kv, paged):
    """``tree_relocate`` on a random bf16 or int8 cache (codes and scales):
    chain 0 kept (the identity), nothing accepted, then chain 1's two steps
    moved, row 1's sources past the store: every leaf of ``groups_self``
    (two lead dims) or ``decoder`` equal to JAX's after each, bit for bit
    (a move computes nothing); the last moves exactly the chain's columns
    across every lead dim, row 1's taking the store's last column (dense)
    or the trash page's (paged), as in the reference."""
    over = dict(param_dtype="bfloat16") if kv == "bf16" else dict(kv_cache_bits=8)
    jcfg, tcfg = reduced_pair(arch, **over)
    (key, lead), = lm.cache_stacks(tcfg)
    n = len(lead)
    jc, tc = _random_caches(jcfg, tcfg, paged, 8 if kv == "int8" else 16)
    if kv == "bf16":
        jc[key] = {k: v.astype(jnp.bfloat16) for k, v in jc[key].items()}
        tc[key] = {k: v.to(torch.bfloat16) for k, v in tc[key].items()}
    kw = dict(page_size=PS) if paged else {}
    before = {k: v.clone() for k, v in tc[key].items()}
    for a, cf in (([DEPTH, DEPTH], [0, 0]), ([0, 0], [1, 1]), ([2, 2], [1, 1])):
        jc = jax_lm.tree_relocate(jcfg, jc, jnp.asarray(POS, jnp.int32),
                                  jnp.asarray(a, jnp.int32), jnp.asarray(cf, jnp.int32),
                                  fan=FAN, depth=DEPTH, page_size=PS if paged else 0)
        assert lm.tree_relocate(tcfg, tc, torch.from_numpy(POS), torch.tensor(a),
                                torch.tensor(cf), fan=FAN, depth=DEPTH, **kw) is tc
        for name, leaf in tc[key].items():
            got, want = leaf.float().numpy(), np.asarray(jc[key][name]).astype(np.float32)
            if paged:  # the trash page holds whichever duplicate write came last
                got, want = got[(slice(None),) * n + (slice(1, None),)], \
                    want[(slice(None),) * n + (slice(1, None),)]
            np.testing.assert_array_equal(got, want, err_msg=f"{name} a={a} cf={cf}")
    bt = tc["block_tables"].long() if paged else None

    def at(row, col):
        if paged:
            return (int(bt[row, col // PS]), col % PS) if col < SEQ else (0, col % PS)
        return row, min(col, SEQ - 1)
    moved = {at(r, int(POS[r]) + 1 + i): at(r, int(POS[r]) + 1 + DEPTH + i)
             for r in range(B) for i in range(DEPTH)}
    idx = (slice(None),) * n
    for name, leaf in tc[key].items():
        want = before[name].clone()
        for (dr, dc), (sr, sc) in moved.items():
            want[idx + (dr, slice(None), dc)] = before[name][idx + (sr, slice(None), sc)]
        if paged:
            leaf, want = leaf[idx + (slice(1, None),)], want[idx + (slice(1, None),)]
        assert torch.equal(leaf, want), name
        assert not torch.equal(leaf, before[name][idx + (slice(1, None),)] if paged
                               else before[name]), name


# one program, not op by op: eager, the vlm's chain takes seconds
_jax_draft_propose = jax.jit(jax_speculative._draft_propose, static_argnums=(1, 6),
                             static_argnames=("page_size", "greedy", "top_k"))


@pytest.mark.parametrize("arch,paged,greedy", [(VLM, True, False), (ENCDEC, False, True)],
                         ids=["vlm-paged-sampled", "encdec-dense-greedy"])
def test_draft_propose_with_extras_matches_jax(arch, paged, greedy):
    """The self-draft's chain of k + 1 = 4 steps with the rows' extras at
    per-row positions: proposals equal JAX's ``_draft_propose``, ``q``
    within 1e-6, every leaf of the chain's cache within 1e-5; sampled, the
    same chain on other rows' extras proposes from other distributions (the
    draft reads them)."""
    k = 3
    jcfg, jparams, tcfg, tparams = cross_model(arch)
    (key, lead), = lm.cache_stacks(tcfg)
    jdraft, tdraft = jax_quantize_tree(jparams, 8), quantize_tree(tparams, 8)
    jc, tc = _random_caches(jcfg, tcfg, paged, 16)
    ex = cross_extras(jcfg, jparams, B, seed=4)
    pos = np.array([3, 9])
    tok = prompt(B, 1, jcfg.vocab, seed=3)
    keys = np.random.default_rng(4).integers(0, 2 ** 32, (B, 2), dtype=np.uint32)
    mode = {} if greedy else dict(temperature=0.8, top_k=8)
    jd, jq, jstack = _jax_draft_propose(
        jdraft, jcfg, jc, jnp.asarray(tok), jnp.asarray(pos, jnp.int32), ex, k,
        page_size=PS if paged else 0, wkeys=None if greedy else jnp.asarray(keys),
        greedy=greedy, **mode)
    twkeys = None if greedy else torch.from_numpy(keys.astype(np.int64))
    clean = {name: v.clone() for name, v in tc[key].items()}
    td, tq, tstack = draft_propose(tdraft, tcfg, tc, torch.from_numpy(tok), torch.from_numpy(pos),
                                   k, wkeys=twkeys, greedy=greedy, extras=_t(ex), **mode)
    assert td.dtype == torch.int32 and tuple(td.shape) == (B, k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tstack is tc
    _assert_caches_close(tc[key], jstack[key], 16, paged, len(lead))
    rolled = {name: np.roll(v, 1, axis=0) for name, v in ex.items()}
    for name, v in tc[key].items():
        v.copy_(clean[name])
    _, tq2, _ = draft_propose(tdraft, tcfg, tc, torch.from_numpy(tok), torch.from_numpy(pos), k,
                              wkeys=twkeys, greedy=greedy, extras=_t(rolled), **mode)
    if greedy:
        assert tq is None and jq is None
        return
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=Q_TOL, atol=Q_TOL)
    assert (tq2 - tq).abs().max() > 1e-3


# ---------------------------------------------------------- the fixed engine --
CASES = {"greedy": (dict(k=4), {}), "adaptive_greedy": (dict(k=4, adaptive=True), {}),
         "sampled_exact": (dict(k=4), SAMPLED),
         "sampled_typical": (dict(k=3, accept="typical"), SAMPLED),
         "draft_greedy": (dict(k=3, mode="draft"), {}),
         "tree_sampled": (dict(k=2, tree_fan=2), SAMPLED)}


@functools.lru_cache(maxsize=None)
def _engines(arch):
    """The JAX package's engine and the port's, int8, each with the target's
    own int8 tree as its draft (the tree is shared: ``draft_pim_bits=0``)."""
    jcfg, jparams, tcfg, tparams = cross_model(arch)
    jq, tq = jax_quantize_tree(jparams, 8), quantize_tree(tparams, 8)
    return (JaxEngine(jcfg, jq, max_seq=MAX_SEQ, draft_cfg=jcfg, draft_params=jq),
            ServingEngine(tcfg, tq, max_seq=MAX_SEQ, draft_cfg=tcfg, draft_params=tq,
                          device="cpu"))


def _inputs(arch):
    jcfg, jparams, _, _ = cross_model(arch)
    return (prompt(B, 6, jcfg.vocab, seed=4) % 7,
            cross_extras(jcfg, jparams, B, seed=11))


# every mode on the vlm; the encdec's typical and self-draft windows are the
# same code on another stack (its draft chain is held above)
GENERATE_CASES = [(arch, name) for arch in FAMILIES for name in sorted(CASES)
                  if arch == VLM or name not in ("sampled_typical", "draft_greedy")]


@pytest.mark.parametrize("arch,name", GENERATE_CASES)
def test_speculative_generate_matches_jax(arch, name):
    """``generate(speculate=)`` with per-row extras: n-gram (greedy,
    adaptive, rejection-sampled, typical), the self-draft and tree windows
    of fan 2, each against the JAX package's engine on the same key;
    ``spec_stats`` equal; greedy also against the port's plain greedy
    decoding, and the self-draft accepts every proposal."""
    spec, mode = CASES[name]
    jeng, eng = _engines(arch)
    toks, ex = _inputs(arch)
    want = np.asarray(jeng.generate(toks, N_NEW, extras=ex, speculate=JaxSpec(**spec),
                                    key=jax.random.PRNGKey(KEY), **mode))
    got = eng.generate(torch.from_numpy(toks), N_NEW, extras=ex, speculate=SpecConfig(**spec),
                       key=KEY, **mode)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert eng.spec_stats == jeng.spec_stats, name
    if spec.get("mode") == "draft" and not mode:
        assert eng.spec_stats["verify_steps"] == -(-(N_NEW - 1) // (spec["k"] + 1))
    if mode:
        np.testing.assert_array_equal(got.numpy(), want)
        return
    rows = [{k: v[r] for k, v in ex.items()} for r in range(B)]
    at = serve_deciding(eng.params, eng.cfg, list(toks), list(got.numpy()), {}, KEY, rows)
    assert_greedy_match(want, got.numpy(), at, LOGIT_TOL, msg=f"{arch} {name}")
    plain = eng.generate(torch.from_numpy(toks), N_NEW, extras=ex)
    assert_greedy_match(plain.numpy(), got.numpy(), at, LOGIT_TOL, msg=f"{arch} {name} vs plain")


@pytest.mark.parametrize("arch", FAMILIES)
def test_windows_read_each_calls_extras(arch):
    """The windows read the batch's static extras buffers: a second call with
    the rows' extras swapped on the same engine swaps the rows' tokens (the
    same prompt in both rows, greedy, linear and tree windows), and the
    first call's extras again give its tokens again."""
    _, eng = _engines(arch)
    toks, ex = _inputs(arch)
    toks = torch.from_numpy(np.repeat(toks[:1], B, axis=0))
    swapped = {k: v[::-1].copy() for k, v in ex.items()}
    for spec in (SpecConfig(k=4), SpecConfig(k=2, tree_fan=2)):
        first = eng.generate(toks, N_NEW, extras=ex, speculate=spec)
        second = eng.generate(toks, N_NEW, extras=swapped, speculate=spec)
        assert not torch.equal(first[0], first[1]), spec  # the extras move the tokens
        assert torch.equal(second, first.flip(0)), spec
        assert torch.equal(eng.generate(toks, N_NEW, extras=ex, speculate=spec), first), spec

"""Port parity: draft-model speculation's primitives and the fixed-batch
engine, ``ServingEngine.generate(speculate=SpecConfig(mode="draft"))``, of
reduced qwen2-1.5b against the JAX package's on the same bridged weights,
prompts and keys.  The draft is the target's own tree, as in the JAX
package's tests: at ``draft_pim_bits=8`` a self-draft, at 4 a coarser one.

``draft_propose`` is held against JAX's ``_draft_propose`` on random dense
and paged caches (block tables a permutation of the pool): the proposals
equal, the draft's distributions ``q`` within 1e-6, and the caches the
chain leaves within 1e-5 (but the paged pool's trash page, which several
rows write).  On the engine a self-draft accepts every proposal and emits
plain greedy decoding's tokens; greedy tokens are held against JAX's
margin-aware at 1e-4 (``torch_helpers.assert_greedy_match``: the port's
decode linears run ``pim_matvec``'s plain version, the JAX package's
``x @ dq(w)``), sampled ones, drawn from the JAX package's window keys,
equal, and so is ``spec_stats``.
"""
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
    CPU, assert_greedy_match, one_thread, prompt, reduced_model, serve_deciding)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

LOGIT_TOL = 1e-4
Q_TOL = 1e-6
CACHE_TOL = 1e-5
PS, WIDTH, PAGES, B = 4, 6, 24, 3  # page size, pages a row, pool pages, rows
SEQ = PS * WIDTH
POS = np.array([3, 8, 13])  # per-row positions of the chain's first step
MAX_SEQ, N_NEW, KEY = 28, 14, 5
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)


def _random_layers(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _caches(jcfg, tcfg, paged):
    """The same random cache in both packages: dense (B, SEQ) rows, or a
    pool of PAGES pages under random block tables."""
    if paged:
        jc = jax_lm.init_paged_cache(jcfg, B, SEQ, PAGES, PS)
        bt = np.random.default_rng(2).permutation(np.arange(1, PAGES))[:B * WIDTH]
        bt = bt.reshape(B, WIDTH).astype(np.int32)
    else:
        jc = jax_lm.init_cache(jcfg, B, SEQ)
    layers = _random_layers({k: v.shape for k, v in jc["layers"].items()}, seed=1)
    jc = {"layers": {k: jnp.asarray(v) for k, v in layers.items()}}
    tc = {"layers": {k: torch.from_numpy(v.copy()) for k, v in layers.items()}}
    if paged:
        jc["block_tables"] = jnp.asarray(bt)
        tc["block_tables"] = torch.from_numpy(bt)
    return jc, tc


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("k", [0, 3])
def test_draft_propose_matches_jax(k, greedy, paged):
    """The chain of ``k + 1`` single-token steps at per-row positions:
    proposals equal, ``q`` within 1e-6 (None when greedy), the chain's
    cache within 1e-5 of JAX's; ``k == 0`` still writes the step that
    consumes the current token."""
    jcfg, jparams, tcfg, tparams = reduced_model()
    jdraft, tdraft = jax_quantize_tree(jparams, 8), quantize_tree(tparams, 8)
    jc, tc = _caches(jcfg, tcfg, paged)
    before = {k_: v.clone() for k_, v in tc["layers"].items()}
    tok = prompt(B, 1, jcfg.vocab, seed=3)
    keys = np.random.default_rng(4).integers(0, 2 ** 32, (B, 2), dtype=np.uint32)
    mode = {} if greedy else dict(temperature=0.8, top_k=8)
    jd, jq, jstack = jax_speculative._draft_propose(
        jdraft, jcfg, jc, jnp.asarray(tok), jnp.asarray(POS, jnp.int32), None, k,
        page_size=PS if paged else 0, wkeys=None if greedy else jnp.asarray(keys),
        greedy=greedy, **mode)
    td, tq, tstack = draft_propose(
        tdraft, tcfg, tc, torch.from_numpy(tok), torch.from_numpy(POS), k,
        wkeys=None if greedy else torch.from_numpy(keys.astype(np.int64)), greedy=greedy,
        **mode)
    assert td.dtype == torch.int32 and tuple(td.shape) == (B, k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if greedy or not k:
        assert tq is None and jq is None
    else:
        assert tq.dtype == torch.float32 and tuple(tq.shape) == (B, k, jcfg.vocab)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=Q_TOL, atol=Q_TOL)
    assert tstack is tc  # the dense family's chain writes in place
    for name, leaf in tc["layers"].items():
        got, want = leaf.numpy(), np.asarray(jstack["layers"][name])
        if paged:  # the trash page holds whichever duplicate write came last
            got, want = got[:, 1:], want[:, 1:]
        np.testing.assert_allclose(got, want, rtol=CACHE_TOL, atol=CACHE_TOL, err_msg=name)
        assert not torch.equal(leaf, before[name]), name  # the chain wrote


def test_stack_verify_caches_is_the_chains_last_cache():
    """Dense: the last cache of the chain (JAX's takes its leaves too);
    the hybrid family is not ported (the ssm family's chain is held in
    tests/test_torch_ssm.py)."""
    jcfg, _, tcfg, _ = reduced_model()
    chain = [lm.init_cache(tcfg, 1, 4, CPU) for _ in range(3)]
    assert lm.stack_verify_caches(tcfg, chain) is chain[-1]
    jchain = [jax_lm.init_cache(jcfg, 1, 4) for _ in range(3)]
    assert jax_lm.stack_verify_caches(jcfg, jchain)["layers"] is jchain[-1]["layers"]
    with pytest.raises(NotImplementedError):
        lm.stack_verify_caches(tcfg.replace(family="hybrid"), chain)


def _engines(bits):
    jcfg, jparams, tcfg, tparams = reduced_model()
    kw = dict(max_seq=MAX_SEQ, pim_bits=8, draft_pim_bits=bits)
    return (JaxEngine(jcfg, jparams, draft_cfg=jcfg, draft_params=jparams, **kw),
            ServingEngine(tcfg, tparams, draft_cfg=tcfg, draft_params=tparams, device="cpu",
                          **kw))


def _prompts(vocab):
    return prompt(2, 8, vocab, seed=6)


def test_self_draft_accepts_every_proposal():
    """Draft == target (both int8): every window emits its k + 1 tokens
    (the last one capped by the budget), the tokens are plain greedy
    decoding's, and JAX's windows and tokens are the same."""
    jeng, eng = _engines(8)
    toks = _prompts(eng.cfg.vocab)
    spec = dict(k=3, mode="draft")
    plain = eng.generate(torch.from_numpy(toks), 9)
    got = eng.generate(torch.from_numpy(toks), 9, speculate=SpecConfig(**spec))
    assert torch.equal(got, plain)
    assert eng.spec_stats["emitted_per_step"] == pytest.approx(4.0)
    assert eng.spec_stats["mode"] == "draft"
    want = np.asarray(jeng.generate(toks, 9, speculate=JaxSpec(**spec)))
    assert eng.spec_stats == jeng.spec_stats
    at = serve_deciding(eng.params, eng.cfg, list(toks), list(got.numpy()), {}, KEY)
    assert_greedy_match(want, got.numpy(), at, LOGIT_TOL)


CASES = {"int4_greedy": (4, dict(k=3), {}), "int4_sampled": (4, dict(k=4), SAMPLED),
         "int4_adaptive_sampled": (4, dict(k=3, adaptive=True, ctrl_init=0.5), SAMPLED)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_draft_generate_matches_jax(name):
    """An int4 draft (and under the adaptive controller, whose probe is the
    draft's first proposal): greedy tokens margin-aware at 1e-4 against JAX's and the
    port's plain greedy decoding; sampled tokens equal to JAX's on the same
    key; ``spec_stats`` equal."""
    bits, spec, mode = CASES[name]
    jeng, eng = _engines(bits)
    toks = _prompts(eng.cfg.vocab)
    want = np.asarray(jeng.generate(toks, N_NEW, speculate=JaxSpec(mode="draft", **spec),
                                    key=jax.random.PRNGKey(KEY), **mode))
    got = eng.generate(torch.from_numpy(toks), N_NEW, speculate=SpecConfig(mode="draft", **spec),
                       key=KEY, **mode)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert eng.spec_stats == jeng.spec_stats, name
    if mode:
        np.testing.assert_array_equal(got.numpy(), want)
        return
    at = serve_deciding(eng.params, eng.cfg, list(toks), list(got.numpy()), {}, KEY)
    assert_greedy_match(want, got.numpy(), at, LOGIT_TOL, msg=name)
    plain = eng.generate(torch.from_numpy(toks), N_NEW)
    assert_greedy_match(plain.numpy(), got.numpy(), at, LOGIT_TOL, msg=f"{name} vs plain")


def test_draft_caches_are_kept_per_width_and_follow_the_draft():
    """The engine keeps one draft cache per window width, each made before
    its first window and reused: runs of k 3, 2 and 3 again repeat
    themselves.  A replaced draft tree is what the next window proposes
    with: an int4 draft's windows after an int8 one's are the int4
    engine's."""
    _, eng = _engines(8)
    _, eng4 = _engines(4)
    toks = torch.from_numpy(_prompts(eng.cfg.vocab))
    spec3, spec2 = SpecConfig(k=3, mode="draft"), SpecConfig(k=2, mode="draft")
    first = eng.generate(toks, N_NEW, speculate=spec3, key=KEY, **SAMPLED)
    eng.generate(toks, N_NEW, speculate=spec2, key=KEY, **SAMPLED)
    assert torch.equal(eng.generate(toks, N_NEW, speculate=spec3, key=KEY, **SAMPLED), first)
    st = eng.spec_state(2)
    assert set(st._dcaches) == {2, 3}
    assert st.draft_cache(3)["layers"]["k"].shape[3] == MAX_SEQ + 3  # (L, B, KV, S, D)
    eng.draft_params = eng4.draft_params
    got = eng.generate(toks, N_NEW, speculate=spec3, key=KEY, **SAMPLED)
    assert torch.equal(got, eng4.generate(toks, N_NEW, speculate=spec3, key=KEY, **SAMPLED))
    assert eng.spec_stats == eng4.spec_stats

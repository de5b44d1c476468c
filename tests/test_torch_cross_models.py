"""Port parity for the vlm and encdec families' models: llama-3.2-vision-90b
(groups of dense blocks and a gated cross-attention block over image embeds)
and seamless-m4t-medium (a non-causal encoder, and decoder blocks that
cross-attend to its output), reduced, against the JAX package on the same
weights and the same seeded numpy extras.

The vlm's gates are planted at ``torch_helpers.GATE`` (0.5) in the numpy
tree both packages take: the reference initialises them to 0, where
``tanh(0) * h`` makes every cross block pass x through, so no test at the
init could see the image (``test_zero_gates_make_the_image_inert`` pins
that limit of the oracle in both packages).  Logits compare at rtol = atol
= 1e-4 (f32; the port's decode linears run ``pim_matvec``'s plain version,
the JAX package's ``x @ dq(w)``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import encode as jax_encode  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serving import quantize_tree as jax_quantize_tree  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.models import attention, encode, lm  # noqa: E402
from repro_torch.models.draw import layerwise_params, quantized_params  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine, ServingEngine, quantize_tree  # noqa: E402

from torch_helpers import (  # noqa: E402,F401
    CPU, ENCDEC, GATE, VLM, cross_extras, cross_model, one_thread, prompt)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = [VLM, ENCDEC]
TOL = 1e-4
PS, PAGES, LENS = 4, 12, (5, 10)  # page size, pool pages, the two slots' prompt lengths
WIDTH = 4  # block-table width: 16 positions a slot


def _fields(cfg):
    return dataclasses.asdict(cfg)  # nested configs as plain dicts


def _quantized(arch, bits, **overrides):
    jcfg, jparams, tcfg, tparams = cross_model(arch, **overrides)
    if bits:
        jparams = jax_quantize_tree(jparams, bits=bits)
        tparams = quantize_tree(tparams, bits=bits)
    return jcfg, jparams, tcfg, tparams


def _t(ex):
    return {k: torch.from_numpy(v) for k, v in ex.items()}


# ---------------------------------------------------------------- registry ---
@pytest.mark.parametrize("arch", FAMILIES)
def test_registry_configs_equal_the_reference(arch):
    """Every field of the two new configs, full and reduced, nested vision
    and audio configs included, equals the reference's; the registry holds
    its nine ids (moonshot-v1-16b-a3b since the moe slice,
    deepseek-v2-lite-16b since MLA's, falcon-mamba-7b since the ssm
    slice's) in the reference's order."""
    for mine, want in ((get_config(arch), jax_get_config(arch)),
                       (get_reduced(arch), jax_get_reduced(arch))):
        got = _fields(mine)
        ref = {k: v for k, v in _fields(want).items() if k in got}
        assert got == ref, arch
    assert ARCH_IDS == [a for a in JAX_ARCH_IDS if a in ARCH_IDS] and len(ARCH_IDS) == 9
    assert get_config(VLM).vision.cross_attn_every == 5 and get_config(ENCDEC).dec_layers == 12


# ---------------------------------------------------------------- attn_apply -
@pytest.mark.parametrize("cross,causal,rope", [(False, True, True), (False, False, True),
                                               (False, True, False), (True, False, False),
                                               (True, True, True)])
def test_attn_apply_matches_jax(cross, causal, rope):
    """``attn_apply`` forward: self- or cross-attention (7 queries over 11
    keys), causal or not, rope or none, GQA 4 over 2."""
    rng = np.random.default_rng(3)
    d, h, kv, hd = 32, 4, 2, 8
    p = {name: (rng.standard_normal(shape) * 0.2).astype(np.float32)
         for name, shape in (("wq", (d, h * hd)), ("wk", (d, kv * hd)), ("wv", (d, kv * hd)),
                             ("wo", (h * hd, d)))}
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    mem = rng.standard_normal((2, 11, d)).astype(np.float32) if cross else None
    kw = dict(n_heads=h, n_kv=kv, head_dim=hd, rope_theta=10_000.0 if rope else 0.0,
              causal=causal)
    want = jax_attention.attn_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                    kv_input=None if mem is None else jnp.asarray(mem), **kw)
    got = attention.attn_apply(_t(p), torch.from_numpy(x),
                               kv_input=None if mem is None else torch.from_numpy(mem), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_attn_apply_past_the_threshold_streams_the_keys(monkeypatch):
    """Past CHUNKED_THRESHOLD keys (lowered in both packages) a
    cross-attention goes through ``_chunked_attention``, as the JAX
    package's does."""
    import jax

    monkeypatch.setattr(jax_attention, "CHUNKED_THRESHOLD", 8)
    monkeypatch.setattr(attention, "CHUNKED_THRESHOLD", 8)
    jax.clear_caches()
    seen = []
    chunked = attention._chunked_attention
    monkeypatch.setattr(attention, "_chunked_attention",
                        lambda *a: seen.append(a[1].shape) or chunked(*a))
    rng = np.random.default_rng(4)
    p = {name: (rng.standard_normal((16, 16)) * 0.2).astype(np.float32)
         for name in ("wq", "wk", "wv", "wo")}
    x, mem = (rng.standard_normal((1, n, 16)).astype(np.float32) for n in (3, 600))
    kw = dict(n_heads=2, n_kv=2, head_dim=8, causal=False)
    want = jax_attention.attn_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                    kv_input=jnp.asarray(mem), **kw)
    got = attention.attn_apply(_t(p), torch.from_numpy(x), kv_input=torch.from_numpy(mem), **kw)
    jax.clear_caches()
    assert seen == [(1, 600, 2, 8)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- encoder ----
def test_encode_matches_jax():
    jcfg, jparams, tcfg, tparams = cross_model(ENCDEC)
    frames = np.random.default_rng(5).standard_normal(
        (2, jcfg.audio.n_frames, jcfg.d_model)).astype(np.float32)
    want = jax_encode(jparams, jcfg, jnp.asarray(frames))
    got = encode(tparams, tcfg, torch.from_numpy(frames))
    assert got.dtype == torch.float32 and tuple(got.shape) == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="encdec"):
        encode(cross_model(VLM)[3], get_reduced(VLM), torch.from_numpy(frames))


# ---------------------------------------------------------------- logits -----
@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_jax(arch, bits):
    """Prefill (2 x 8) and one decode step against a dense cache, each with
    the rows' own extras."""
    jcfg, jparams, tcfg, tparams = _quantized(arch, bits)
    b, s, max_seq = 2, 8, 12
    ex = cross_extras(jcfg, cross_model(arch)[1], b)
    toks, nxt = prompt(b, s, jcfg.vocab), prompt(b, 1, jcfg.vocab, seed=2)
    jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jax_lm.init_cache(jcfg, b, max_seq),
                            ex)
    jd, _ = jax_lm.decode_step(jparams, jcfg, jnp.asarray(nxt), jc, jnp.int32(s), ex)
    tl, tc = lm.prefill(tparams, tcfg, torch.from_numpy(toks), lm.init_cache(tcfg, b, max_seq, CPU),
                        _t(ex))
    td, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc, s, _t(ex))
    assert tuple(tl.shape) == (b, s, jcfg.vocab) and tuple(td.shape) == (b, 1, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)


def test_swapped_image_embeds_follow_their_rows():
    """With planted gates, each row's logits depend on its own image: two
    rows' embeds swapped swap the rows' logits (the sequences are equal) and
    change them.  The reference's own per-request test runs at the zero
    init, where this cannot be seen."""
    jcfg, jparams, tcfg, tparams = cross_model(VLM)
    ex = cross_extras(jcfg, jparams, 2)["image_embeds"]
    toks = np.repeat(prompt(1, 6, jcfg.vocab), 2, axis=0)

    def logits(img):
        out, _ = lm.prefill(tparams, tcfg, torch.from_numpy(toks),
                            lm.init_cache(tcfg, 2, 6, CPU), {"image_embeds": torch.from_numpy(img)})
        return out
    a, b = logits(ex), logits(ex[::-1].copy())
    assert torch.equal(a[0], b[1]) and torch.equal(a[1], b[0])
    assert (a[0] - a[1]).abs().max().item() > 1e-3


def test_zero_gates_make_the_image_inert():
    """The limit of the oracle: at the reference's init (both gates 0) the
    image moves no logit in either package."""
    jcfg, jparams, tcfg, tparams = cross_model(VLM, gate=0.0)
    toks = prompt(2, 6, jcfg.vocab)
    outs = []
    for seed in (2, 3):
        ex = cross_extras(jcfg, jparams, 2, seed=seed)
        jl, _ = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jax_lm.init_cache(jcfg, 2, 6), ex)
        tl, _ = lm.prefill(tparams, tcfg, torch.from_numpy(toks), lm.init_cache(tcfg, 2, 6, CPU),
                           _t(ex))
        outs.append((np.asarray(jl), tl))
    assert np.array_equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


# ------------------------------------------------------------ paged cache ----
def _block_tables(seed=3):
    perm = np.random.default_rng(seed).permutation(np.arange(1, PAGES))
    return perm[:len(LENS) * WIDTH].reshape(len(LENS), WIDTH).astype(np.int32)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_paged_admit_and_decode_match_jax_and_dense(arch, bits):
    """Each slot's prompt prefilled into its pages (``prefill(pages=)``) with
    its own extras; then one paged decode step at per-slot positions over a
    permuted pool: the logits of the admits and of the step are the JAX
    package's, the pools equal ``paged_insert`` of dense prefills bit for
    bit, and each slot's step equals a dense decode of its own."""
    jcfg, jparams, tcfg, tparams = _quantized(arch, bits)
    ex = cross_extras(jcfg, cross_model(arch)[1], len(LENS), seed=6)
    bt = _block_tables()
    ((key, _),) = lm.cache_stacks(tcfg)
    jc = jax_lm.init_paged_cache(jcfg, len(LENS), WIDTH * PS, PAGES, PS)
    tc = lm.init_paged_cache(tcfg, len(LENS), WIDTH * PS, PAGES, PS, CPU)
    ref = lm.init_paged_cache(tcfg, len(LENS), WIDTH * PS, PAGES, PS, CPU)
    for slot, length in enumerate(LENS):
        spad = -(-length // PS) * PS
        toks = np.zeros((1, spad), np.int32)
        toks[0, :length] = prompt(1, length, jcfg.vocab, seed=10 + slot)
        row = {k: v[slot:slot + 1] for k, v in ex.items()}
        pages = bt[slot, :spad // PS]
        jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jc, row,
                                length=jnp.int32(length), pages=jnp.asarray(pages),
                                slot=jnp.int32(slot))
        tl, _ = lm.prefill(tparams, tcfg, torch.from_numpy(toks), tc, _t(row), length=length,
                           pages=pages, slot=slot)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
        dense = lm.init_cache(tcfg, 1, spad, CPU)
        lm.prefill(tparams, tcfg, torch.from_numpy(toks), dense, _t(row))
        lm.paged_insert(tcfg, ref, dense, slot, pages)
    for name, leaf in ref[key].items():
        assert torch.equal(leaf, tc[key][name]), name
    jc["block_tables"] = jnp.asarray(bt)
    tc["block_tables"].copy_(torch.from_numpy(bt))
    nxt, pos = prompt(len(LENS), 1, jcfg.vocab, seed=5), np.array(LENS)
    jd, _ = jax_lm.decode_step(jparams, jcfg, jnp.asarray(nxt), jc, jnp.asarray(pos, jnp.int32),
                               ex, page_size=PS)
    td, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc, torch.from_numpy(pos),
                           _t(ex), page_size=PS)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)
    for slot, length in enumerate(LENS):
        row = {k: torch.from_numpy(v[slot:slot + 1]) for k, v in ex.items()}
        dense = lm.init_cache(tcfg, 1, WIDTH * PS, CPU)
        lm.prefill(tparams, tcfg, torch.from_numpy(prompt(1, length, jcfg.vocab, seed=10 + slot)),
                   dense, row)
        dl, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt[slot:slot + 1]), dense, length,
                               row)
        np.testing.assert_allclose(td[slot].numpy(), dl[0].numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_verify_step_matches_jax(arch, paged):
    """A 3-token window at per-row positions (``tree=None``) on a dense cache
    and through a paged pool's block tables, int8 weights: logits within the
    tolerance of the JAX package's."""
    jcfg, jparams, tcfg, tparams = _quantized(arch, 8)
    b, t = 2, 3
    ex = cross_extras(jcfg, cross_model(arch)[1], b, seed=7)
    toks = prompt(b, 6, jcfg.vocab, seed=8)
    pos = np.array([6, 3])
    if paged:
        bt = _block_tables(seed=9)
        jc = jax_lm.init_paged_cache(jcfg, b, WIDTH * PS, PAGES, PS)
        tc = lm.init_paged_cache(tcfg, b, WIDTH * PS, PAGES, PS, CPU)
        jc["block_tables"] = jnp.asarray(bt)
        tc["block_tables"].copy_(torch.from_numpy(bt))
        kw = dict(page_size=PS)
    else:
        jc = jax_lm.init_cache(jcfg, b, 12)
        tc = lm.init_cache(tcfg, b, 12, CPU)
        kw = {}
    # the cached prefix: one window over each row's first tokens
    first = np.zeros((b, 6), np.int32)
    first[:] = toks
    jl0, jc = jax_lm.verify_step(jparams, jcfg, jnp.asarray(first), jc, jnp.zeros(b, jnp.int32),
                                 ex, **kw)
    tl0, tc = lm.verify_step(tparams, tcfg, torch.from_numpy(first), tc, torch.zeros(b), _t(ex),
                             **kw)
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), rtol=TOL, atol=TOL)
    win = prompt(b, t, jcfg.vocab, seed=9)
    jl, _ = jax_lm.verify_step(jparams, jcfg, jnp.asarray(win), jc, jnp.asarray(pos, jnp.int32),
                               ex, **kw)
    tl, got = lm.verify_step(tparams, tcfg, torch.from_numpy(win), tc, torch.from_numpy(pos),
                             _t(ex), **kw)
    assert got is tc and tuple(tl.shape) == (b, t, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_speculation_cache_steps_refuse_these_families(arch):
    """These families' speculation steps no longer refuse (ROADMAP section
    1, item 5): ``stack_verify_caches`` and ``commit_verify`` pass the
    cache through, as JAX's do for them (the same leaves back);
    ``tree_relocate`` with nothing accepted leaves the cache as it was; a
    fan-1 tree window is the linear window bit for bit; and both engines
    take ``speculate=`` (tests/test_torch_cross_spec.py and
    tests/test_torch_cross_tree.py hold them against the JAX package)."""
    jcfg, jparams, tcfg, tparams = cross_model(arch)
    ((key, _),) = lm.cache_stacks(tcfg)
    chain = [lm.init_cache(tcfg, 1, 8, CPU) for _ in range(3)]
    jchain = [jax_lm.init_cache(jcfg, 1, 8) for _ in range(3)]
    one = torch.zeros(1, dtype=torch.int64)
    assert lm.stack_verify_caches(tcfg, chain) is chain[-1]
    assert jax_lm.stack_verify_caches(jcfg, jchain)[key] is jchain[-1][key]
    assert lm.commit_verify(tcfg, chain[0], one) is chain[0]
    assert jax_lm.commit_verify(jcfg, jchain[0], jnp.zeros(1, jnp.int32))[key] is jchain[0][key]
    ex = _t(cross_extras(jcfg, jparams, 1, seed=7))
    toks = torch.from_numpy(prompt(1, 3, jcfg.vocab, seed=8))
    lin, lc = lm.verify_step(tparams, tcfg, toks, lm.init_cache(tcfg, 1, 8, CPU), one, ex)
    tree, tc = lm.verify_step(tparams, tcfg, toks, lm.init_cache(tcfg, 1, 8, CPU), one, ex,
                              tree=(1, 2))
    assert torch.equal(tree, lin)
    before = {k: v.clone() for k, v in tc[key].items()}
    assert lm.tree_relocate(tcfg, tc, one, one, one + 1, fan=2, depth=1) is tc
    for name, leaf in tc[key].items():
        assert torch.equal(leaf, before[name]) and torch.equal(leaf, lc[key][name]), name
    prompt2 = torch.from_numpy(prompt(1, 4, jcfg.vocab, seed=9))
    ex2 = {k: v for k, v in cross_extras(jcfg, jparams, 1, seed=10).items()}
    eng = ServingEngine(tcfg, tparams, max_seq=12, device="cpu")
    assert eng.generate(prompt2, 4, extras=ex2, speculate=2).shape == (1, 4)
    cb = ContinuousBatchingEngine(tcfg, tparams, slots=1, max_seq=12, device="cpu",
                                  speculate=2)
    assert cb.generate(prompt2, 4, extras=ex2).shape == (1, 4)


# ---------------------------------------------------------------- weights ----
def test_bridge_round_trips_nested_stacks_and_gates():
    """The vlm's nested stacks ((G, every - 1, ...) and (G, ...)) and its
    1-D stacked gates, and the encdec's two stacks, cross the bridge and
    back unchanged, a single block's 0-d gates too."""
    for arch in FAMILIES:
        _, jparams, _, tparams = cross_model(arch)
        back = params_from_numpy(params_to_numpy(tparams), CPU)

        def pairs(a, b):
            for k in a:
                if isinstance(a[k], dict):
                    yield from pairs(a[k], b[k])
                else:
                    yield a[k], b[k]
        assert all(torch.equal(x, y) for x, y in pairs(tparams, back))
        if arch == VLM:
            gates = tparams["groups"]["cross"]["gate_attn"]
            assert tuple(gates.shape) == (1,) and gates.item() == GATE
            one = params_from_numpy({"g": np.float32(GATE)}, CPU)["g"]
            assert one.dim() == 0 and one.item() == GATE


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_slice_by_slice_draw_equals_quantize_of_the_layerwise_draw(arch, bits):
    """``quantized_params`` (each (K, N) slice drawn and quantized as it is
    drawn) is ``quantize_tree(layerwise_params(...))`` bit for bit from the
    same generator, bf16, the vlm's two stack dims and the untied head
    included."""
    cfg = get_reduced(arch).replace(param_dtype="bfloat16")
    want = quantize_tree(layerwise_params(cfg, torch.Generator().manual_seed(3)), bits)
    got = quantized_params(cfg, torch.Generator().manual_seed(3), bits)

    def leaves(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{path}/{k}")
            else:
                yield f"{path}/{k}", v
    w, g = dict(leaves(want)), dict(leaves(got))
    assert w.keys() == g.keys() and "/head/codes" in g
    bad = [p for p in w if not (torch.equal(w[p], g[p]) and w[p].stride() == g[p].stride())]
    assert not bad, bad


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(2, 33, 70), (64, 301)])
def test_dq_in_column_blocks_equals_the_whole_leaf(shape, bits, monkeypatch):
    """``dq`` into bf16 forms its f32 products a block of columns at a time
    (``DQ_BLOCK_BYTES``; the vlm's head would need 4.2 GB of them at once):
    bit for bit the whole leaf's cast, stacked and odd-K int4 leaves
    included."""
    from repro_torch.models import common

    w = (0.02 * torch.randn(shape, generator=torch.Generator().manual_seed(2))).to(torch.bfloat16)
    q = quantize_tree({"w": w}, bits)["w"]
    want = common.dq(q).to(torch.bfloat16)  # the f32 products of the whole leaf, then cast
    monkeypatch.setattr(common, "DQ_BLOCK_BYTES", 4 * 7 * int(np.prod(shape[:-1])))
    got = common.dq(q, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)

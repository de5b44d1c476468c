"""Port parity for deepseek-v2-lite-16b's MLA attention: the reduced config
(one dense GQA layer, then two MoE layers whose attention is MLA, kv_lora
32, rope 8) against the JAX package on the same weights, carried through
the bridge.

``models.mla``'s functions are held against ``repro.models.mla``'s on
random dense and paged latent caches (block tables a permutation of the
pool): outputs and f32 caches within 1e-5, pools everywhere but the trash
page.  The model's prefill, decode and verify windows (linear and
``tree=(2, 2)``) compare at 1e-4 in f32 (the port's decode linears run
``pim_matvec``'s plain version, the JAX package's ``x @ dq(w)``).  The
cache has a latent stack (``layers``: ``c``, ``kr``) and a GQA K/V stack
(``dense_layers``, int8 under ``kv_cache_bits=8``); ``tree_relocate`` and
``move_columns`` move both, bit for bit as JAX's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.serving import quantize_tree as jax_quantize_tree  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import blocks, lm, mla  # noqa: E402
from repro_torch.models.draw import layerwise_params, quantized_params  # noqa: E402
from repro_torch.serving import quantize_tree  # noqa: E402

from torch_helpers import CPU, one_thread, prompt, reduced_model, to_numpy  # noqa: E402,F401
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

MLA = "deepseek-v2-lite-16b"  # the moe family with MLA attention

TOL = 1e-4
FN_TOL = 1e-5
PS, WIDTH, PAGES, B = 4, 6, 16, 2  # page size, pages a row, pool pages, rows
SEQ = PS * WIDTH
POS = np.array([5, SEQ - 3])  # row 1's window runs past the store
FAN, DEPTH = 2, 2
T = 1 + FAN * DEPTH


def _model(bits=0, **over):
    jcfg, jparams, tcfg, tparams = reduced_model(arch=MLA, **over)
    if bits:
        jparams, tparams = jax_quantize_tree(jparams, bits=bits), quantize_tree(tparams, bits=bits)
    return jcfg, jparams, tcfg, tparams


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        elif v is not None:
            yield f"{path}/{k}", v


def _close(got, want, tol, paged=False, lead=0, msg=""):
    g = got.float().numpy() if got.dtype != torch.int8 else got.numpy()
    w = np.asarray(want).astype(g.dtype)
    if paged:  # the trash page holds whichever duplicate write came last
        g, w = g[(slice(None),) * lead + (slice(1, None),)], w[(slice(None),) * lead
                                                               + (slice(1, None),)]
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=msg)


def test_registry_config_equals_the_reference():
    """Every field of deepseek-v2-lite-16b, full and reduced, its nested
    ``MoEConfig`` and ``MLAConfig`` included, equals the reference's; the
    cache's MoE stack is a latent one, its dense stack K/V."""
    for mine, want in ((get_config(MLA), jax_get_config(MLA)),
                       (get_reduced(MLA), jax_get_reduced(MLA))):
        got = dataclasses.asdict(mine)
        assert got == {k: v for k, v in dataclasses.asdict(want).items() if k in got}
    full = get_config(MLA)
    assert (full.n_layers, full.d_model, full.mla.kv_lora_rank, full.mla.qk_rope_dim,
            full.moe.n_experts, full.vocab) == (27, 2048, 512, 64, 64, 102400)
    assert lm.cache_stacks(full) == (("layers", (26,)), ("dense_layers", (1,)))
    assert [lm.stack_layout(full, k) for k, _ in lm.cache_stacks(full)] == ["latent", "kv"]
    assert [lm.seq_axis(full, k) for k, _ in lm.cache_stacks(full)] == [1, 2]


@pytest.mark.parametrize("bits", [0, 8])
def test_bridge_carries_the_mla_tree(bits):
    """The tree, the MoE blocks' MLA leaves (3-D ``w_uk`` / ``w_uv``) among
    them, crosses the bridge both ways with ``init_params``' layout; its
    quantized form (``w_uk`` / ``w_uv`` quantized over their lora axis) is
    the JAX package's ``quantize_tree`` leaf for leaf."""
    _, jparams, tcfg, tparams = _model()
    meta = dict(_leaves(lm.init_params(tcfg, torch.Generator(), device="meta")))
    got = dict(_leaves(tparams))
    assert {p: (tuple(v.shape), v.dtype) for p, v in got.items()} == {
        p: (tuple(v.shape), v.dtype) for p, v in meta.items()}
    assert tuple(got["/layers/attn/w_uk"].shape) == (2, 4, 32, 16)
    assert tuple(got["/layers/attn/w_dkv"].shape) == (2, 64, 40)
    assert "/dense_layers/attn/wk" in got and "/layers/attn/wk" not in got
    if bits:
        got = dict(_leaves(quantize_tree(tparams, bits=bits)))
        want = dict(_leaves(to_numpy(jax_quantize_tree(jparams, bits=bits))))
        assert "/layers/attn/w_uk/codes" in got and tuple(got["/layers/attn/w_uv/scale"].shape) == (
            2, 4, 1, 16)
    else:
        back = dict(_leaves(params_from_numpy(params_to_numpy(tparams), CPU)))
        assert all(torch.equal(back[p], got[p]) for p in got)
        want = dict(_leaves(to_numpy(jparams)))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[p].numpy(), want[p]) for p in got)


@pytest.mark.parametrize("bits", [8, 4])
def test_slice_by_slice_draw_equals_quantize_of_the_layerwise_draw(bits):
    """``quantized_params`` of the MLA config (every (K, N) slice of the 4-D
    ``w_uk`` / ``w_uv`` stacks drawn and quantized as it is drawn) is
    ``quantize_tree(layerwise_params(...))`` bit for bit."""
    cfg = get_reduced(MLA).replace(param_dtype="bfloat16")
    want = dict(_leaves(quantize_tree(layerwise_params(cfg, torch.Generator().manual_seed(3)),
                                      bits)))
    got = dict(_leaves(quantized_params(cfg, torch.Generator().manual_seed(3), bits)))
    assert want.keys() == got.keys() and "/layers/attn/w_uk/codes" in got
    bad = [p for p in want if not (torch.equal(want[p], got[p])
                                   and want[p].stride() == got[p].stride())]
    assert not bad, bad


def _layer_params(tparams, jparams):
    """MoE layer 0's MLA params in both packages."""
    return (jax.tree.map(lambda a: a[0], jparams["layers"]["attn"]),
            lm._layer(tparams["layers"]["attn"], 0))


def _random_latents(cfg, paged, seed=1):
    """The same random latent cache in both packages: dense (B, SEQ) rows, or
    a pool of PAGES pages under shuffled block tables (B, WIDTH)."""
    m = cfg.mla
    rows, seq = (PAGES, PS) if paged else (B, SEQ)
    rng = np.random.default_rng(seed)
    leaves = {"c": rng.standard_normal((rows, seq, m.kv_lora_rank)).astype(np.float32),
              "kr": rng.standard_normal((rows, seq, m.qk_rope_dim)).astype(np.float32)}
    bt = np.random.default_rng(2).permutation(np.arange(1, PAGES))[:B * WIDTH]
    bt = bt.reshape(B, WIDTH).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in leaves.items()},
            {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}, bt)


CASES = ["decode", "verify", "tree"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("case", CASES)
def test_mla_functions_match_jax(case, paged):
    """``mla_decode`` / ``mla_decode_paged`` and ``mla_verify`` (linear, and
    ``tree=(2, 2)``) of one MoE layer over a random latent cache, row 1's
    window past the store (dropped on a dense cache, the trash page on a
    paged one): outputs and every latent within 1e-5 of JAX's, the cache
    written in place (f32 weights: the model test quantizes them)."""
    jcfg, jparams, tcfg, tparams = _model()
    jp, tp = _layer_params(tparams, jparams)
    kw = dict(n_heads=tcfg.n_heads, m=tcfg.mla, rope_theta=tcfg.rope_theta)
    jkw = dict(n_heads=jcfg.n_heads, m=jcfg.mla, rope_theta=jcfg.rope_theta)
    jc, tc, bt = _random_latents(tcfg, paged)
    t = 1 if case == "decode" else T
    x = np.random.default_rng(7).standard_normal((B, t, tcfg.d_model)).astype(np.float32)
    pos = np.array([5, 9]) if case == "decode" else POS
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    tree = (FAN, DEPTH) if case == "tree" else None
    if case == "decode" and not paged:  # a dense decode step shares one position
        tpos = torch.tensor(pos[0])
        jo, jc = jax_mla.mla_decode(jp, jnp.asarray(x), jc, int(pos[0]), **jkw)
        to, got = mla.mla_decode(tp, tx, tc, tpos, **kw)
    elif case == "decode":
        jo, jc = jax_mla.mla_decode_paged(jp, jnp.asarray(x), jc, jnp.asarray(bt),
                                          jnp.asarray(pos, jnp.int32), page_size=PS, **jkw)
        to, got = mla.mla_decode_paged(tp, tx, tc, torch.from_numpy(bt).long(), tpos,
                                       page_size=PS, **kw)
    else:
        pkw = dict(block_tables=jnp.asarray(bt), page_size=PS) if paged else {}
        jo, jc = jax_mla.mla_verify(jp, jnp.asarray(x), jc, jnp.asarray(pos, jnp.int32),
                                    tree=tree, **pkw, **jkw)
        pkw = dict(block_tables=torch.from_numpy(bt).long(), page_size=PS) if paged else {}
        to, got = mla.mla_verify(tp, tx, tc, tpos, tree=tree, **pkw, **kw)
    assert got is tc and tuple(to.shape) == (B, t, tcfg.d_model)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=FN_TOL, atol=FN_TOL)
    for name in ("c", "kr"):
        _close(tc[name], jc[name], FN_TOL, paged, msg=name)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mla_prefill_and_apply_match_jax(paged):
    """``mla_prefill`` of 2 x 8 (the expanded form) into a dense cache, or
    batch-1 rows straight into their pool pages (``pages=``): outputs and
    latents within 1e-5 of JAX's; ``mla_apply`` and ``moe_block_apply``
    under MLA too."""
    jcfg, jparams, tcfg, tparams = _model()
    jp, tp = _layer_params(tparams, jparams)
    kw = dict(n_heads=tcfg.n_heads, m=tcfg.mla, rope_theta=tcfg.rope_theta)
    s = 2 * PS
    x = np.random.default_rng(8).standard_normal((B, s, tcfg.d_model)).astype(np.float32)
    if paged:
        jc, tc, bt = _random_latents(tcfg, True)
        for r in range(B):
            pages = bt[r, :s // PS]
            jo, jc = jax_mla.mla_prefill(jp, jnp.asarray(x[r:r + 1]), jc, pages=jnp.asarray(pages),
                                         **kw)
            to, _ = mla.mla_prefill(tp, torch.from_numpy(x[r:r + 1]), tc,
                                    pages=torch.from_numpy(pages).long(), **kw)
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=FN_TOL, atol=FN_TOL)
    else:
        jo, jc = jax_mla.mla_prefill(jp, jnp.asarray(x), jax_mla.mla_cache_init(B, SEQ, jcfg.mla,
                                                                                 jnp.float32),
                                     **kw)
        tc = mla.mla_cache_init(B, SEQ, tcfg.mla, torch.float32, CPU)
        to, _ = mla.mla_prefill(tp, torch.from_numpy(x), tc, **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=FN_TOL, atol=FN_TOL)
        np.testing.assert_allclose(mla.mla_apply(tp, torch.from_numpy(x), **kw).numpy(),
                                   np.asarray(jax_mla.mla_apply(jp, jnp.asarray(x), **kw)),
                                   rtol=FN_TOL, atol=FN_TOL)
        jl = jax.tree.map(lambda a: a[0], jparams["layers"])
        (jy, _), (ty, _) = (jax_blocks.moe_block_apply(jl, jnp.asarray(x), jcfg),
                            blocks.moe_block_apply(lm._layer(tparams["layers"], 0),
                                                   torch.from_numpy(x), tcfg))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=FN_TOL, atol=FN_TOL)
    for name in ("c", "kr"):
        _close(tc[name], jc[name], FN_TOL, paged, msg=name)


@pytest.mark.parametrize("bits,kv_bits", [(0, 16), (8, 8)])
def test_model_prefill_decode_and_windows_match_jax(bits, kv_bits):
    """The model: prefill (2 x 9), two decode steps, then a linear window of
    5 and a tree window of fan 2 x depth 2 at per-row positions, against a
    dense cache: logits and both stacks' caches within 1e-4 of JAX's (1e-3
    with the int8 K/V cache of the dense layer)."""
    jcfg, jparams, tcfg, tparams = _model(bits, kv_cache_bits=kv_bits)
    tol = TOL if kv_bits == 16 else 1e-3
    b, s, max_seq = 2, 9, 20
    toks = prompt(b, s, jcfg.vocab)
    jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jax_lm.init_cache(jcfg, b, max_seq))
    tl, tc = lm.prefill(tparams, tcfg, torch.from_numpy(toks), lm.init_cache(tcfg, b, max_seq,
                                                                             CPU))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    for i in range(2):
        nxt = prompt(b, 1, jcfg.vocab, seed=2 + i)
        jd, jc = jax_lm.decode_step(jparams, jcfg, jnp.asarray(nxt), jc, jnp.int32(s + i))
        td, tc = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc, s + i)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol, atol=tol)
    pos = np.array([s + 2, s + 1])
    for tree in (None, (FAN, DEPTH)):
        win = prompt(b, T, jcfg.vocab, seed=9)
        jv, jc = jax_lm.verify_step(jparams, jcfg, jnp.asarray(win), jc,
                                    jnp.asarray(pos, jnp.int32), tree=tree)
        tv, tc = lm.verify_step(tparams, tcfg, torch.from_numpy(win), tc, torch.from_numpy(pos),
                                tree=tree)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=tol, atol=tol)
    assert {n: t.dtype for n, t in tc["layers"].items()} == {"c": torch.float32,
                                                            "kr": torch.float32}
    for key, _ in lm.cache_stacks(tcfg):
        for name, leaf in tc[key].items():
            np.testing.assert_allclose(leaf.float().numpy(), np.asarray(jc[key][name], np.float32),
                                       rtol=tol, atol=tol, err_msg=f"{key}/{name}")


def test_paged_admit_and_decode_match_jax_and_dense():
    """Each slot's prompt prefilled into its pages, then one paged decode
    step at per-slot positions over a permuted pool, int8 weights: the
    logits are JAX's, both stacks' pools (latent and K/V) equal
    ``paged_insert`` of dense prefills bit for bit, and each slot's step
    equals a dense decode of its own."""
    jcfg, jparams, tcfg, tparams = _model(8)
    lens, pages_n, width = (5, 10), 12, 4
    bt = np.random.default_rng(3).permutation(np.arange(1, pages_n))[:2 * width]
    bt = bt.reshape(2, width).astype(np.int32)
    jc = jax_lm.init_paged_cache(jcfg, 2, width * PS, pages_n, PS)
    tc = lm.init_paged_cache(tcfg, 2, width * PS, pages_n, PS, CPU)
    ref = lm.init_paged_cache(tcfg, 2, width * PS, pages_n, PS, CPU)
    assert {k: set(v) for k, v in tc.items() if k != "block_tables"} == {
        "layers": {"c", "kr"}, "dense_layers": {"k", "v"}}
    for slot, length in enumerate(lens):
        spad = -(-length // PS) * PS
        toks = np.zeros((1, spad), np.int32)
        toks[0, :length] = prompt(1, length, jcfg.vocab, seed=10 + slot)
        pages = bt[slot, :spad // PS]
        jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jc, length=jnp.int32(length),
                                pages=jnp.asarray(pages), slot=jnp.int32(slot))
        tl, _ = lm.prefill(tparams, tcfg, torch.from_numpy(toks), tc, length=length,
                           pages=pages, slot=slot)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
        dense = lm.init_cache(tcfg, 1, spad, CPU)
        lm.prefill(tparams, tcfg, torch.from_numpy(toks), dense)
        lm.paged_insert(tcfg, ref, dense, slot, pages)
    for key, _ in lm.cache_stacks(tcfg):
        for name, leaf in ref[key].items():
            assert torch.equal(leaf, tc[key][name]), (key, name)
    jc["block_tables"] = jnp.asarray(bt)
    tc["block_tables"].copy_(torch.from_numpy(bt))
    nxt, pos = prompt(2, 1, jcfg.vocab, seed=5), np.array(lens)
    jd, _ = jax_lm.decode_step(jparams, jcfg, jnp.asarray(nxt), jc, jnp.asarray(pos, jnp.int32),
                               page_size=PS)
    td, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc, torch.from_numpy(pos),
                           page_size=PS)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)
    for slot, length in enumerate(lens):
        dense = lm.init_cache(tcfg, 1, width * PS, CPU)
        lm.prefill(tparams, tcfg, torch.from_numpy(prompt(1, length, jcfg.vocab, seed=10 + slot)),
                   dense)
        dl, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt[slot:slot + 1]), dense, length)
        np.testing.assert_allclose(td[slot].numpy(), dl[0].numpy(), rtol=TOL, atol=TOL)


def test_int8_cache_leaves_the_latents_in_the_parameter_dtype():
    """``kv_cache_bits=8`` on bf16 parameters: in both packages, dense and
    paged, ``dense_layers`` holds int8 codes and f32 scales while the MLA
    ``layers`` keep bf16 latents, leaf for leaf the same shapes."""
    jcfg, tcfg = (c.replace(param_dtype="bfloat16", kv_cache_bits=8)
                  for c in (jax_get_reduced(MLA), get_reduced(MLA)))
    for jc, tc in ((jax_lm.init_cache(jcfg, 2, 8), lm.init_cache(tcfg, 2, 8, CPU)),
                   (jax_lm.init_paged_cache(jcfg, 2, 8, 5, 4),
                    lm.init_paged_cache(tcfg, 2, 8, 5, 4, CPU))):
        got = {p: (tuple(v.shape), str(v.dtype).split(".")[-1]) for p, v in _leaves(tc)}
        want = {p: (tuple(v.shape), str(v.dtype)) for p, v in _leaves(jc)}
        assert got == want
        assert {p: got[p][1] for p in got if p.startswith("/layers/")} == {
            "/layers/c": "bfloat16", "/layers/kr": "bfloat16"}
        assert got["/dense_layers/k"][1] == "int8"


def _random_cache(jcfg, paged, kv_bits, seed=4):
    """The same random cache of the model in both packages, every leaf of
    both stacks (int8 codes and positive scales in the int8 K/V stack),
    dense (B, SEQ) rows or a pool of PAGES pages under shuffled tables."""
    if paged:
        jc = jax_lm.init_paged_cache(jcfg, B, SEQ, PAGES, PS)
        bt = np.random.default_rng(2).permutation(np.arange(1, PAGES))[:B * WIDTH]
        jc["block_tables"] = jnp.asarray(bt.reshape(B, WIDTH).astype(np.int32))
    else:
        jc = jax_lm.init_cache(jcfg, B, SEQ)
    rng = np.random.default_rng(seed)
    tc = {}
    for key, tree in jc.items():
        if key == "block_tables":
            tc[key] = torch.from_numpy(np.asarray(tree).copy())
            continue
        leaves = {}
        for name, leaf in tree.items():
            if leaf.dtype == jnp.int8:
                leaves[name] = rng.integers(-127, 128, leaf.shape).astype(np.int8)
            elif name.endswith("_scale"):
                leaves[name] = rng.uniform(0.01, 0.05, leaf.shape).astype(np.float32)
            else:
                leaves[name] = rng.standard_normal(leaf.shape).astype(np.float32)
        jc[key] = {k: jnp.asarray(v).astype(tree[k].dtype) for k, v in leaves.items()}
        tc[key] = {k: torch.from_numpy(v.copy()).to(_torch_dtype(tree[k].dtype))
                   for k, v in leaves.items()}
    return jc, tc


def _torch_dtype(dt):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[str(dt)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv", ["f32", "bf16+int8"])
def test_tree_relocate_moves_latents_and_kv_as_jax(kv, paged):
    """``tree_relocate`` on a random cache of both stacks, the latent
    ``layers`` and the K/V ``dense_layers`` (f32, or bf16 latents beside an
    int8 K/V stack with its scales): chain 0 kept, nothing accepted, then
    chain 1's two steps moved, row 1's sources past the store; every leaf
    equal to JAX's after each, bit for bit (a move computes nothing), and
    the last moves chain 1's columns and nothing else.  ``move_columns``,
    which it calls, reads each stack's sequence axis from its layout."""
    over = {} if kv == "f32" else dict(param_dtype="bfloat16", kv_cache_bits=8)
    jcfg, tcfg = jax_get_reduced(MLA).replace(**over), get_reduced(MLA).replace(**over)
    jc, tc = _random_cache(jcfg, paged, 8)
    kw = dict(page_size=PS) if paged else {}
    before = {k: {n: v.clone() for n, v in tc[k].items()} for k, _ in lm.cache_stacks(tcfg)}
    for a, cf in (([DEPTH, DEPTH], [0, 0]), ([0, 0], [1, 1]), ([2, 2], [1, 1])):
        jc = jax_lm.tree_relocate(jcfg, jc, jnp.asarray(POS, jnp.int32),
                                  jnp.asarray(a, jnp.int32), jnp.asarray(cf, jnp.int32),
                                  fan=FAN, depth=DEPTH, page_size=PS if paged else 0)
        assert lm.tree_relocate(tcfg, tc, torch.from_numpy(POS), torch.tensor(a),
                                torch.tensor(cf), fan=FAN, depth=DEPTH, **kw) is tc
        for key, _ in lm.cache_stacks(tcfg):
            for name, leaf in tc[key].items():
                got = leaf.float().numpy()
                want = np.asarray(jc[key][name]).astype(np.float32)
                if paged:  # the trash page holds whichever duplicate write came last
                    got, want = got[:, 1:], want[:, 1:]
                np.testing.assert_array_equal(got, want, err_msg=f"{key}/{name} a={a} cf={cf}")
    bt = tc["block_tables"].long() if paged else None

    def at(row, col):
        if paged:
            return (int(bt[row, col // PS]), col % PS) if col < SEQ else (0, col % PS)
        return row, min(col, SEQ - 1)
    moved = {at(r, int(POS[r]) + 1 + i): at(r, int(POS[r]) + 1 + DEPTH + i)
             for r in range(B) for i in range(DEPTH)}
    for key, _ in lm.cache_stacks(tcfg):
        heads = (slice(None),) * (lm.seq_axis(tcfg, key) - 1)  # K/V leaves' head axis
        for name, leaf in tc[key].items():
            want = before[key][name].clone()
            for (dr, dc), (sr, sc) in moved.items():
                want[(slice(None), dr) + heads + (dc,)] = before[key][name][
                    (slice(None), sr) + heads + (sc,)]
            if paged:
                leaf, want = leaf[:, 1:], want[:, 1:]
            assert torch.equal(leaf, want), (key, name)


def test_page_size_reads_the_latent_pool_and_kv_paths_refuse_it():
    """The paged pool's page size is read from the first stack, the latent
    one, at its own sequence axis; a wrong ``page_size`` raises.  A K/V-only
    path handed a latent stack raises rather than compute."""
    tcfg = get_reduced(MLA)
    pool = lm.init_paged_cache(tcfg, 2, 16, 9, 4, CPU)
    assert lm._page_size(tcfg, pool, None) == 4
    with pytest.raises(ValueError, match="page_size 8"):
        lm._page_size(tcfg, pool, 8)
    dense = lm.init_cache(tcfg, 1, 8, CPU)
    with pytest.raises(KeyError):
        lm.paged_kv_insert(pool["layers"], dense["layers"], torch.tensor([1, 2]), lead=1)

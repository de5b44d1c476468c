"""Port parity for the moe family's model: reduced moonshot-v1-16b-a3b (one
dense layer, then two MoE layers of 8 experts, top 2, one shared expert)
against the JAX package on the same weights, carried through the bridge.

Logits compare at rtol = atol = 1e-4 in f32 (the port's decode linears run
``pim_matvec``'s plain version, the JAX package's ``x @ dq(w)``), 1e-3 with
the int8 KV cache.  The model has two K/V stacks, ``dense_layers`` and the
MoE ``layers``; the JAX package makes the MoE stack without ``bits``, so
under ``kv_cache_bits=8`` only ``dense_layers`` is int8 and the MoE stack
stays in the parameter dtype, in both packages.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serving import quantize_tree as jax_quantize_tree  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.draw import layerwise_params, quantized_params  # noqa: E402
from repro_torch.serving import quantize_tree  # noqa: E402

from torch_helpers import CPU, MOE, moe_model, one_thread, prompt  # noqa: E402,F401
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
KV8_TOL = 1e-3
PS, PAGES, LENS = 4, 12, (5, 10)  # page size, pool pages, the two slots' prompt lengths
WIDTH = 4  # block-table width: 16 positions a slot


def _quantized(bits, kv_bits=16):
    jcfg, jparams, tcfg, tparams = moe_model()
    jcfg, tcfg = jcfg.replace(kv_cache_bits=kv_bits), tcfg.replace(kv_cache_bits=kv_bits)
    if bits:
        jparams = jax_quantize_tree(jparams, bits=bits)
        tparams = quantize_tree(tparams, bits=bits)
    return jcfg, jparams, tcfg, tparams


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        elif v is not None:
            yield f"{path}/{k}", v


def test_registry_config_equals_the_reference():
    """Every field of moonshot-v1-16b-a3b, full and reduced, its nested
    ``MoEConfig`` included, equals the reference's."""
    for mine, want in ((get_config(MOE), jax_get_config(MOE)),
                       (get_reduced(MOE), jax_get_reduced(MOE))):
        got = dataclasses.asdict(mine)
        assert got == {k: v for k, v in dataclasses.asdict(want).items() if k in got}
    full = get_config(MOE)
    assert (full.family, full.n_layers, full.n_dense_layers, full.moe.n_experts,
            full.moe.top_k, full.moe.n_shared, full.vocab) == ("moe", 48, 1, 64, 6, 2, 163840)
    assert lm.cache_stacks(full) == (("layers", (47,)), ("dense_layers", (1,)))


def test_bridge_carries_the_moe_tree():
    """The tree (``dense_layers``, the MoE ``layers`` with their f32 router,
    4-D expert stacks and shared experts) crosses the bridge both ways
    unchanged, with the layout ``init_params`` makes."""
    _, jparams, tcfg, tparams = moe_model()
    meta = dict(_leaves(lm.init_params(tcfg, torch.Generator(), device="meta")))
    got = dict(_leaves(tparams))
    assert {p: (tuple(v.shape), v.dtype) for p, v in got.items()} == {
        p: (tuple(v.shape), v.dtype) for p, v in meta.items()}
    assert got["/layers/moe/router"].dtype == torch.float32
    assert tuple(got["/layers/moe/gate"].shape) == (2, 8, 64, 32)
    back = dict(_leaves(params_from_numpy(params_to_numpy(tparams), CPU)))
    assert all(torch.equal(back[p], got[p]) for p in got)
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    assert all(np.array_equal(got[p].numpy(), want[p]) for p in got)


@pytest.mark.parametrize("bits,kv_bits", [(0, 16), (8, 16), (4, 16), (8, 8)])
def test_prefill_and_decode_match_jax(bits, kv_bits):
    """Prefill (2 x 9) and two decode steps against a dense cache."""
    jcfg, jparams, tcfg, tparams = _quantized(bits, kv_bits)
    tol = TOL if kv_bits == 16 else KV8_TOL
    b, s, max_seq = 2, 9, 12
    toks = prompt(b, s, jcfg.vocab)
    jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jax_lm.init_cache(jcfg, b, max_seq))
    tl, tc = lm.prefill(tparams, tcfg, torch.from_numpy(toks), lm.init_cache(tcfg, b, max_seq,
                                                                             CPU))
    assert tuple(tl.shape) == (b, s, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    for i in range(2):
        nxt = prompt(b, 1, jcfg.vocab, seed=2 + i)
        jd, jc = jax_lm.decode_step(jparams, jcfg, jnp.asarray(nxt), jc, jnp.int32(s + i))
        td, tc = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc, s + i)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol, atol=tol)
    for key, _ in lm.cache_stacks(tcfg):
        for name, leaf in tc[key].items():
            np.testing.assert_allclose(leaf.float().numpy(), np.asarray(jc[key][name], np.float32),
                                       rtol=tol, atol=tol, err_msg=f"{key}/{name}")


def _block_tables(seed=3):
    perm = np.random.default_rng(seed).permutation(np.arange(1, PAGES))
    return perm[:len(LENS) * WIDTH].reshape(len(LENS), WIDTH).astype(np.int32)


@pytest.mark.parametrize("bits", [0, 8])
def test_paged_admit_and_decode_match_jax_and_dense(bits):
    """Each slot's prompt prefilled into its pages (``prefill(pages=)``), then
    one paged decode step at per-slot positions over a permuted pool: the
    logits are the JAX package's, both stacks' pools equal ``paged_insert``
    of dense prefills bit for bit, and each slot's step equals a dense
    decode of its own."""
    jcfg, jparams, tcfg, tparams = _quantized(bits)
    bt = _block_tables()
    jc = jax_lm.init_paged_cache(jcfg, len(LENS), WIDTH * PS, PAGES, PS)
    tc = lm.init_paged_cache(tcfg, len(LENS), WIDTH * PS, PAGES, PS, CPU)
    ref = lm.init_paged_cache(tcfg, len(LENS), WIDTH * PS, PAGES, PS, CPU)
    assert set(tc) == set(jc) == {"block_tables", "layers", "dense_layers"}
    for slot, length in enumerate(LENS):
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
    nxt, pos = prompt(len(LENS), 1, jcfg.vocab, seed=5), np.array(LENS)
    jd, _ = jax_lm.decode_step(jparams, jcfg, jnp.asarray(nxt), jc, jnp.asarray(pos, jnp.int32),
                               page_size=PS)
    td, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc, torch.from_numpy(pos),
                           page_size=PS)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)
    for slot, length in enumerate(LENS):
        dense = lm.init_cache(tcfg, 1, WIDTH * PS, CPU)
        lm.prefill(tparams, tcfg, torch.from_numpy(prompt(1, length, jcfg.vocab, seed=10 + slot)),
                   dense)
        dl, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt[slot:slot + 1]), dense, length)
        np.testing.assert_allclose(td[slot].numpy(), dl[0].numpy(), rtol=TOL, atol=TOL)


def test_int8_cache_covers_the_dense_stack_only():
    """``kv_cache_bits=8`` on bf16 parameters: in both packages, dense and
    paged, ``dense_layers`` holds int8 codes and f32 scales while the MoE
    ``layers`` stay bf16 K/V (the reference's moe stack ignores the bits),
    leaf for leaf the same shapes."""
    jcfg, _, tcfg, _ = moe_model()
    jcfg = jcfg.replace(param_dtype="bfloat16", kv_cache_bits=8)
    tcfg = tcfg.replace(param_dtype="bfloat16", kv_cache_bits=8)
    for jc, tc in ((jax_lm.init_cache(jcfg, 2, 8), lm.init_cache(tcfg, 2, 8, CPU)),
                   (jax_lm.init_paged_cache(jcfg, 2, 8, 5, 4),
                    lm.init_paged_cache(tcfg, 2, 8, 5, 4, CPU))):
        got = {p: (tuple(v.shape), str(v.dtype).split(".")[-1]) for p, v in _leaves(tc)}
        want = {p: (tuple(v.shape), str(v.dtype)) for p, v in _leaves(jc)}
        assert got == want
        assert {got[p][1] for p in got if p.startswith("/layers/")} == {"bfloat16"}
        assert got["/dense_layers/k"][1] == "int8" and got["/dense_layers/k_scale"][1] == "float32"


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_of_the_expert_stacks_equals_jax(bits):
    """``quantize_tree`` of the 4-D expert stacks (L, E, K, N), the shared
    experts and the dense layer: codes, scales and markers leaf for leaf the
    JAX package's; the f32 router stays dense."""
    _, jparams, _, tparams = moe_model()
    want = dict(_leaves(jax.tree.map(np.asarray, jax_quantize_tree(jparams, bits=bits))))
    got = dict(_leaves(quantize_tree(tparams, bits=bits)))
    assert got.keys() == want.keys() and "/layers/moe/gate/codes" in got
    for p in got:
        assert tuple(got[p].shape) == want[p].shape and np.array_equal(got[p].numpy(), want[p]), p
    assert got["/layers/moe/router"].dtype == torch.float32
    assert tuple(got["/layers/moe/down/scale"].shape) == (2, 8, 1, 64)


@pytest.mark.parametrize("bits", [8, 4])
def test_slice_by_slice_draw_equals_quantize_of_the_layerwise_draw(bits):
    """``quantized_params`` (each (K, N) slice of every (L, E, K, N) expert
    stack drawn and quantized as it is drawn) is ``quantize_tree(
    layerwise_params(...))`` bit for bit from the same generator, bf16, the
    f32 router drawn as it is."""
    cfg = get_reduced(MOE).replace(param_dtype="bfloat16")
    want = dict(_leaves(quantize_tree(layerwise_params(cfg, torch.Generator().manual_seed(3)),
                                      bits)))
    got = dict(_leaves(quantized_params(cfg, torch.Generator().manual_seed(3), bits)))
    assert want.keys() == got.keys() and "/layers/moe/up/codes" in got
    bad = [p for p in want if not (torch.equal(want[p], got[p])
                                   and want[p].stride() == got[p].stride())]
    assert not bad, bad
    assert got["/layers/moe/router"].dtype == torch.float32

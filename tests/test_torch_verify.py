"""Port parity: the verify window of reduced qwen2-1.5b against the JAX package
— ``attention.attn_verify``, ``blocks.dense_block_verify`` and
``lm.verify_step`` — on dense and paged caches (block tables that are random
permutations of the pool, one position per row, writes past the store).

Tolerances: f32 outputs and logits within 1e-5 of JAX's (the same
operations summed in another order); with the int8 cache a K/V value near a
rounding edge can land one code apart, so codes within one step and
outputs within 1e-3 (as tests/test_torch_model.py).  Caches are compared
everywhere but the paged pool's trash page, which several rows write at the
same offsets in an order neither package fixes.  JAX's CPU backend has no
bf16 x bf16 -> f32 dot, so bf16 windows are held against the port's own
dense decode path, within 1e-2 (an ulp of bf16 at logits of about 1).
Taking the window's queries in blocks changes no bit.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jax_attention  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.models import attention, blocks, lm  # noqa: E402

from torch_helpers import CPU, prompt, reduced_model  # noqa: E402

PS, WIDTH, PAGES, B, T = 4, 5, 24, 3, 6  # page size, pages a row, pool pages, rows, window
SEQ = PS * WIDTH
POS = np.array([3, 8, SEQ - 4])  # inside a page, at a page edge, past the store at the end


def _tol(kv_bits):
    return 1e-5 if kv_bits == 16 else 1e-3


def _block_tables(seed=0):
    rng = np.random.default_rng(seed)
    return rng.permutation(np.arange(1, PAGES))[:B * WIDTH].reshape(B, WIDTH).astype(np.int32)


def _random_cache(shapes, kv_bits, seed):
    """Random leaves for a cache of the given (name -> shape): normal values,
    or int8 codes with small positive scales."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if kv_bits == 8 and name in ("k", "v"):
            out[name] = rng.integers(-127, 128, shape).astype(np.int8)
        elif kv_bits == 8:
            out[name] = (np.abs(rng.standard_normal(shape)) * 0.01).astype(np.float32)
        else:
            out[name] = rng.standard_normal(shape).astype(np.float32)
    return out


def _layer_cache(jcfg, kv_bits, paged, seed=1):
    if paged:
        tree = jax_attention.paged_kv_cache_init(PAGES, PS, jcfg.n_kv_heads, jcfg.head_dim,
                                                 jnp.float32, bits=kv_bits)
    else:
        tree = jax.tree.map(lambda a: a[0], jax_lm.init_cache(
            jcfg.replace(kv_cache_bits=kv_bits), B, SEQ)["layers"])
    return _random_cache({k: v.shape for k, v in tree.items()}, kv_bits, seed)


def _assert_caches_close(got, want, kv_bits, paged, tol=1e-5):
    for name in want:
        g = np.asarray(got[name].float() if got[name].dtype != torch.int8 else got[name])
        w = np.asarray(want[name]).astype(g.dtype)
        if paged:  # the trash page holds whichever duplicate write came last
            g, w = g[1:], w[1:]
        if name in ("k", "v") and kv_bits == 8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, name
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


def _attn_kw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_attn_verify_matches_jax(kv_bits, paged):
    """One layer's window of T tokens at per-row positions: output within the
    tolerance of JAX's; the window's K/V written where JAX writes them, the
    last row's writes past the store dropped (dense) or sent to the trash
    page (paged), and nothing else changed."""
    jcfg, jparams, tcfg, tparams = reduced_model(kv_cache_bits=kv_bits)
    jlayer = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tlayer = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    x = np.random.default_rng(2).standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    cache = _layer_cache(jcfg, kv_bits, paged)
    bt = _block_tables(3)
    kw = dict(block_tables=jnp.asarray(bt), page_size=PS) if paged else {}
    jo, jc = jax_attention.attn_verify(jlayer, jnp.asarray(x),
                                       {k: jnp.asarray(v) for k, v in cache.items()},
                                       jnp.asarray(POS, jnp.int32), **kw, **_attn_kw(jcfg))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tkw = dict(block_tables=torch.from_numpy(bt).long(), page_size=PS) if paged else {}
    to, got = attention.attn_verify(tlayer, torch.from_numpy(x), tcache,
                                    torch.from_numpy(POS), **tkw, **_attn_kw(tcfg))
    assert got is tcache  # in place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=_tol(kv_bits),
                               atol=_tol(kv_bits))
    _assert_caches_close(tcache, jc, kv_bits, paged)
    # where the window wrote: (row or page, position or offset) pairs
    written = set()
    for b in range(B):
        for p in POS[b] + np.arange(T):
            if paged:
                written.add((bt[b, p // PS], p % PS) if p < SEQ else (0, p % PS))
            elif p < SEQ:
                written.add((b, p))
    for name, leaf in tcache.items():
        diff = leaf.numpy() != cache[name]  # (B | P, KV, S | ps[, D])
        diff = diff.reshape(diff.shape[:3] + (-1,)).any(axis=(1, 3))
        assert {tuple(r) for r in np.argwhere(diff)} <= written, name
    if not paged:  # the last row's window ran past the store: those writes dropped
        assert int(POS[-1]) + T > SEQ


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_dense_block_verify_matches_jax(kv_bits, paged):
    """One block (norms, the window's attention, the MLP) on the same random
    caches as above: output and caches within the tolerance of JAX's."""
    jcfg, jparams, tcfg, tparams = reduced_model(kv_cache_bits=kv_bits)
    jlayer = jax.tree.map(lambda a: a[0], jparams["layers"])
    tlayer = lm._layer(tparams["layers"], 0)
    x = np.random.default_rng(4).standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    cache = _layer_cache(jcfg, kv_bits, paged, seed=5)
    bt = _block_tables(6)
    jo, jc = jax_blocks.dense_block_verify(
        jlayer, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(bt) if paged else None, jnp.asarray(POS, jnp.int32), jcfg, PS)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    to, _ = blocks.dense_block_verify(tlayer, torch.from_numpy(x), tcache,
                                      torch.from_numpy(bt).long() if paged else None,
                                      torch.from_numpy(POS), tcfg, PS if paged else None)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=_tol(kv_bits),
                               atol=_tol(kv_bits))
    _assert_caches_close(tcache, jc, kv_bits, paged)


def _prefilled(jcfg, jparams, tcfg, tparams, paged, lens=(3, 8, 12)):
    """Both packages' caches after each row's prompt (``lens``) was prefilled
    (paged: into its block-table row's pages), and the block tables."""
    bt = _block_tables(7)
    if paged:
        jc = jax_lm.init_paged_cache(jcfg, B, SEQ, PAGES, PS)
        tc = lm.init_paged_cache(tcfg, B, SEQ, PAGES, PS, CPU)
    else:
        jc = jax_lm.init_cache(jcfg, B, SEQ)
        tc = lm.init_cache(tcfg, B, SEQ, CPU)
    for row, n in enumerate(lens):
        spad = -(-n // PS) * PS
        toks = np.zeros((1, spad), np.int32)
        toks[0, :n] = prompt(1, n, jcfg.vocab, seed=20 + row)
        if paged:
            _, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jc, length=jnp.int32(n),
                                   pages=jnp.asarray(bt[row, :spad // PS]), slot=jnp.int32(row))
            lm.prefill(tparams, tcfg, torch.from_numpy(toks), tc, length=n,
                       pages=bt[row, :spad // PS], slot=row)
        else:  # each row's prompt into a batch-1 cache, copied into its row
            j1 = jax_lm.init_cache(jcfg, 1, SEQ)
            _, j1 = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks[:, :n]), j1)
            jc = {"layers": {k: v.at[:, row].set(j1["layers"][k][:, 0])
                             for k, v in jc["layers"].items()}}
            t1 = lm.init_cache(tcfg, 1, SEQ, CPU)
            lm.prefill(tparams, tcfg, torch.from_numpy(toks[:, :n]), t1)
            for k, v in tc["layers"].items():
                v[:, row] = t1["layers"][k][:, 0]
    if paged:
        jc["block_tables"] = jnp.asarray(bt)
        tc["block_tables"].copy_(torch.from_numpy(bt))
    return jc, tc, np.array(lens)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_verify_step_matches_jax(kv_bits, paged):
    """``verify_step`` over prefilled rows, a window of T tokens each at its
    row's length (the last row's window runs past the store): logits (B, T,
    V) and caches within the tolerance of JAX's."""
    jcfg, jparams, tcfg, tparams = reduced_model(kv_cache_bits=kv_bits)
    jc, tc, pos = _prefilled(jcfg, jparams, tcfg, tparams, paged, lens=(3, 8, SEQ - 3))
    toks = prompt(B, T, jcfg.vocab, seed=9)
    jl, jc = jax_lm.verify_step(jparams, jcfg, jnp.asarray(toks), jc, jnp.asarray(pos, jnp.int32),
                                page_size=PS if paged else 0)
    tl, got = lm.verify_step(tparams, tcfg, torch.from_numpy(toks), tc, torch.from_numpy(pos),
                             page_size=PS if paged else None)
    assert got is tc and tuple(tl.shape) == (B, T, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=_tol(kv_bits),
                               atol=_tol(kv_bits))
    _assert_caches_close({k: v.flatten(0, 1) for k, v in tc["layers"].items()},
                         {k: np.asarray(v).reshape((-1,) + v.shape[2:])
                          for k, v in jc["layers"].items()}, kv_bits, False)
    if paged:
        with pytest.raises(ValueError, match="page_size"):
            lm.verify_step(tparams, tcfg, torch.from_numpy(toks), tc, torch.from_numpy(pos),
                           page_size=PS + 1)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("dtype,kv_bits", [("float32", 16), ("bfloat16", 16), ("bfloat16", 8)])
def test_blocked_window_equals_the_unblocked_one(dtype, kv_bits, paged, monkeypatch):
    """The window's queries all, one, two or four at a time (VERIFY_SCORES_BYTES
    lowered to that many queries' scores): outputs and caches equal bit for
    bit (each query's arithmetic does not depend on its block)."""
    _, _, tcfg, tparams = reduced_model(param_dtype=dtype, kv_cache_bits=kv_bits)
    tlayer = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((B, T, tcfg.d_model), generator=gen).to(tparams["embed"].dtype)
    kw = dict(block_tables=torch.from_numpy(_block_tables(9)).long(), page_size=PS) \
        if paged else {}
    runs = []
    for block in (T, 1, 2, 4):
        cache = {k: torch.from_numpy(v) for k, v in _random_cache(
            {k: v.shape for k, v in lm.init_paged_cache(tcfg, B, SEQ, PAGES, PS, CPU)["layers"]
             .items()} if paged else
            {k: v.shape[1:] for k, v in lm.init_cache(tcfg, B, SEQ, CPU)["layers"].items()},
            kv_bits, seed=10).items()}
        if paged:
            cache = {k: v[0] for k, v in cache.items()}
        cache = {k: v.to(tparams["embed"].dtype) if v.dtype == torch.float32
                 and "scale" not in k else v for k, v in cache.items()}
        monkeypatch.setattr(attention, "VERIFY_SCORES_BYTES", B * tcfg.n_heads * SEQ * 4 * block)
        out, _ = attention.attn_verify(tlayer, x, cache, torch.from_numpy(POS), **kw,
                                       **_attn_kw(tcfg))
        runs.append((out, cache))
    for out, cache in runs[1:]:
        assert torch.equal(out, runs[0][0])
        for name in cache:
            assert torch.equal(cache[name], runs[0][1][name]), name


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_bf16_window_matches_the_dense_decode_path(kv_bits, paged):
    """bf16 weights: each window position's logits equal, within 1e-2, the
    port's own dense ``decode_step`` of that row's tokens one at a time."""
    jcfg, jparams, tcfg, tparams = reduced_model(param_dtype="bfloat16", kv_cache_bits=kv_bits)
    _, tc, pos = _prefilled(jcfg, jparams, tcfg, tparams, paged)
    toks = prompt(B, T, jcfg.vocab, seed=11)
    tl, _ = lm.verify_step(tparams, tcfg, torch.from_numpy(toks), tc, torch.from_numpy(pos))
    for row, n in enumerate(pos):
        dense = lm.init_cache(tcfg, 1, SEQ, CPU)
        lm.prefill(tparams, tcfg, torch.from_numpy(prompt(1, int(n), jcfg.vocab, seed=20 + row)),
                   dense)
        for t in range(T):
            dl, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(toks[row:row + 1, t:t + 1]),
                                   dense, int(n) + t)
            np.testing.assert_allclose(tl[row, t].float().numpy(), dl[0, 0].float().numpy(),
                                       rtol=1e-2, atol=1e-2, err_msg=f"row {row} t {t}")

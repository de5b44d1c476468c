"""Port parity: the paged KV cache of reduced qwen2-1.5b against the JAX
package — ``paged_kv_insert``/``paged_insert``, ``attn_prefill(pages=)``
(through ``prefill(pages=, slot=)``), ``attn_decode_paged`` and the paged
``decode_step`` — on block tables that are random permutations of the pool
and with one position per slot.

Tolerances: f32 logits and attention outputs within 1e-5 of JAX's (the same
operations summed in another order), pools equal where they are copies.
With the int8 cache a K/V value within 1e-7 of a rounding edge can land one
code apart in the two packages: codes within one step, logits within 1e-3
(as tests/test_torch_model.py); in bf16, where the K/V values themselves
differ by an ulp, codes within two steps.  JAX's CPU backend cannot run a bf16 x bf16
-> f32 dot, so bf16 decode is held against the port's own dense path, within
1e-2 (an ulp of bf16 at the untrained model's logits of about 1); bf16
prefill logits against JAX's within 1e-2 too.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jax_attention  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.kernels import flash_attn  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.models.attention import decode_attention  # noqa: E402

from torch_helpers import CPU, prompt, reduced_model  # noqa: E402

PS, WIDTH, PAGES = 4, 4, 20  # page size, pages per slot, pool pages
LENS = (3, 9, 13)  # prompt lengths per slot: inside, at and past page edges


def _tol(dtype, kv_bits):
    return 1e-2 if dtype == "bfloat16" else 1e-5 if kv_bits == 16 else 1e-3


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _block_tables(seed=0, batch=len(LENS)):
    """Distinct pool pages for every slot, a random permutation of 1..P-1."""
    rng = np.random.default_rng(seed)
    return rng.permutation(np.arange(1, PAGES))[:batch * WIDTH].reshape(batch, WIDTH).astype(
        np.int32)


def _assert_pools_close(got, want, kv_bits, tol):
    steps = 2 if tol == _tol("bfloat16", kv_bits) else 1
    for name in want:
        g, w = _f32(got[name]), _f32(want[name])
        if name in ("k", "v") and kv_bits == 8:
            assert np.abs(g - w).max() <= steps, name  # codes apart at a rounding edge
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


def _admit_all(jcfg, jparams, tcfg, tparams, bt):
    """Prefill each slot's prompt (LENS, padded to pages) straight into its
    pages in both packages; returns the two paged caches and the logits."""
    jc = jax_lm.init_paged_cache(jcfg, len(LENS), WIDTH * PS, PAGES, PS)
    tc = lm.init_paged_cache(tcfg, len(LENS), WIDTH * PS, PAGES, PS, CPU)
    logits = []
    for slot, length in enumerate(LENS):
        spad = -(-length // PS) * PS
        toks = np.zeros((1, spad), np.int32)
        toks[0, :length] = prompt(1, length, jcfg.vocab, seed=10 + slot)
        pages = bt[slot, :spad // PS]
        jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jc, length=jnp.int32(length),
                                pages=jnp.asarray(pages), slot=jnp.int32(slot))
        tl, _ = lm.prefill(tparams, tcfg, torch.from_numpy(toks), tc, length=length,
                           pages=pages, slot=slot)
        logits.append((jl, tl))
    jc["block_tables"] = jnp.asarray(bt)
    tc["block_tables"].copy_(torch.from_numpy(bt))
    return jc, tc, logits


@pytest.mark.parametrize("dtype,kv_bits", [("float32", 16), ("float32", 8),
                                           ("bfloat16", 16), ("bfloat16", 8)])
def test_prefill_into_pages_matches_jax_and_paged_insert(dtype, kv_bits):
    """``prefill(pages=, slot=)`` writes the JAX package's pools (logits and
    K/V within the tolerance), and equals the port's own ``prefill`` on a
    batch-1 dense cache followed by ``paged_insert``, bit for bit."""
    jcfg, jparams, tcfg, tparams = reduced_model(param_dtype=dtype, kv_cache_bits=kv_bits)
    tol = _tol(dtype, kv_bits)
    bt = _block_tables()
    jc, tc, logits = _admit_all(jcfg, jparams, tcfg, tparams, bt)
    for jl, tl in logits:
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=tol, atol=tol)
    _assert_pools_close(tc["layers"], jc["layers"], kv_bits, tol)

    ref = lm.init_paged_cache(tcfg, len(LENS), WIDTH * PS, PAGES, PS, CPU)
    for slot, length in enumerate(LENS):
        spad = -(-length // PS) * PS
        toks = np.zeros((1, spad), np.int32)
        toks[0, :length] = prompt(1, length, jcfg.vocab, seed=10 + slot)
        dense = lm.init_cache(tcfg, 1, spad, CPU)
        dl, _ = lm.prefill(tparams, tcfg, torch.from_numpy(toks), dense)
        lm.paged_insert(tcfg, ref, dense, slot, bt[slot, :spad // PS])
        assert torch.equal(dl, logits[slot][1])
    for name, leaf in ref["layers"].items():
        assert torch.equal(leaf, tc["layers"][name]), name


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_paged_insert_matches_jax(kv_bits):
    """``paged_insert`` (stacked layers) and ``paged_kv_insert`` (one layer)
    scatter a dense batch-1 cache into the same pool pages as the JAX
    package's: pools equal."""
    jcfg, _, tcfg, _ = reduced_model(kv_cache_bits=kv_bits)
    rng = np.random.default_rng(3)
    n = 3
    pages = _block_tables(seed=4)[0, :n]

    def rand(tree):
        return {k: rng.standard_normal(v.shape).astype(np.float32) * 50 if v.dtype != jnp.int8
                else rng.integers(-127, 128, v.shape).astype(np.int8) for k, v in tree.items()}

    dense = rand(jax_lm.init_cache(jcfg, 1, n * PS)["layers"])
    pool = rand(jax_lm.init_paged_cache(jcfg, 1, WIDTH * PS, PAGES, PS)["layers"])
    want = jax_lm.paged_insert(jcfg, {"layers": {k: jnp.asarray(v) for k, v in pool.items()}},
                               {"layers": {k: jnp.asarray(v) for k, v in dense.items()}},
                               0, jnp.asarray(pages))
    tpaged = {"block_tables": torch.zeros((1, WIDTH), dtype=torch.int32),
              "layers": {k: torch.from_numpy(v.copy()) for k, v in pool.items()}}
    got = lm.paged_insert(tcfg, tpaged, {"layers": {k: torch.from_numpy(v) for k, v in
                                                    dense.items()}}, 0, pages)
    assert got is tpaged  # in place
    for name in pool:
        np.testing.assert_array_equal(got["layers"][name].numpy(), np.asarray(want["layers"][name]))
    one = {k: v[1] for k, v in pool.items()}
    want1 = jax_attention.paged_kv_insert({k: jnp.asarray(v) for k, v in one.items()},
                                          {k: jnp.asarray(v[1]) for k, v in dense.items()},
                                          jnp.asarray(pages))
    got1 = attention.paged_kv_insert({k: torch.from_numpy(v.copy()) for k, v in one.items()},
                                     {k: torch.from_numpy(v[1]) for k, v in dense.items()},
                                     torch.from_numpy(pages).long())
    for name in one:
        np.testing.assert_array_equal(got1[name].numpy(), np.asarray(want1[name]))


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_attn_decode_paged_matches_jax(kv_bits):
    """One layer's ``attn_decode_paged`` on a random pool: output within
    1e-5 of JAX's, and the new tokens' K/V scattered into the same rows of
    the same pages (per-slot positions at a page's first and last offset
    and inside one)."""
    jcfg, jparams, tcfg, tparams = reduced_model(kv_cache_bits=kv_bits)
    rng = np.random.default_rng(5)
    bt = _block_tables(seed=6)
    pos = np.array([PS, 2 * PS - 1, 10])
    jlayer = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tlayer = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    x = rng.standard_normal((len(LENS), 1, jcfg.d_model)).astype(np.float32)
    pool = jax_attention.paged_kv_cache_init(PAGES, PS, jcfg.n_kv_heads, jcfg.head_dim,
                                             jnp.float32, bits=kv_bits)
    pool = {k: (rng.standard_normal(v.shape).astype(np.float32) if v.dtype != jnp.int8 else
                rng.integers(-127, 128, v.shape).astype(np.int8)) for k, v in pool.items()}
    if kv_bits == 8:
        pool = {k: np.abs(v) * 0.01 if "scale" in k else v for k, v in pool.items()}
    kw = dict(n_heads=jcfg.n_heads, n_kv=jcfg.n_kv_heads, head_dim=jcfg.head_dim,
              rope_theta=jcfg.rope_theta, page_size=PS)
    jo, jpool = jax_attention.attn_decode_paged(
        jlayer, jnp.asarray(x), {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(bt), jnp.asarray(pos, jnp.int32), **kw)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    to, _ = attention.attn_decode_paged(tlayer, torch.from_numpy(x), tpool,
                                        torch.from_numpy(bt).long(), torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    _assert_pools_close(tpool, jpool, kv_bits, 1e-5)
    written = [(bt[b, pos[b] // PS], pos[b] % PS) for b in range(len(LENS))]
    for name, leaf in tpool.items():  # only the new tokens' rows changed
        diff = (leaf.numpy() != pool[name]).any(axis=1)  # (P, ps[, D])
        changed = np.argwhere(diff.reshape(PAGES, PS, -1).any(axis=-1))
        assert {tuple(r) for r in changed} <= set(written), name


@pytest.mark.parametrize("dtype,kv_bits", [("float32", 16), ("float32", 8),
                                           ("bfloat16", 16), ("bfloat16", 8)])
def test_paged_decode_step_matches_jax_and_dense(dtype, kv_bits):
    """The paged ``decode_step`` with one position per slot: logits within
    the tolerance of JAX's (f32; JAX cannot decode bf16 on the CPU) and of
    the port's dense ``decode_step`` of each slot alone at its position."""
    jcfg, jparams, tcfg, tparams = reduced_model(param_dtype=dtype, kv_cache_bits=kv_bits)
    tol = _tol(dtype, kv_bits)
    bt = _block_tables(seed=2)
    jc, tc, _ = _admit_all(jcfg, jparams, tcfg, tparams, bt)
    nxt = prompt(len(LENS), 1, jcfg.vocab, seed=5)
    pos = np.array(LENS)
    td, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc, torch.from_numpy(pos),
                           page_size=PS)
    if dtype == "float32":
        jd, _ = jax_lm.decode_step(jparams, jcfg, jnp.asarray(nxt), jc,
                                   jnp.asarray(pos, jnp.int32), page_size=PS)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol, atol=tol)
    for slot, length in enumerate(LENS):
        dense = lm.init_cache(tcfg, 1, WIDTH * PS, CPU)
        lm.prefill(tparams, tcfg, torch.from_numpy(prompt(1, length, jcfg.vocab,
                                                          seed=10 + slot)), dense)
        dl, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt[slot:slot + 1]), dense,
                               length)
        np.testing.assert_allclose(_f32(td[slot]), _f32(dl[0]), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="page_size"):
        lm.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc, torch.from_numpy(pos),
                       page_size=PS + 1)


def test_decode_attention_takes_a_shared_or_a_per_row_position():
    """The dense path's 0-d position and the same position given per row
    mask the same keys: outputs equal bit for bit; rows at other positions
    differ."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((3, 2, 6, 16), generator=gen)
    ck, cv = (torch.randn((3, 2, 24, 16), generator=gen) for _ in range(2))
    shared = decode_attention(q, ck, cv, torch.tensor(9))
    assert torch.equal(shared, decode_attention(q, ck, cv, torch.full((3,), 9)))
    mixed = decode_attention(q, ck, cv, torch.tensor([9, 4, 9]))
    assert torch.equal(mixed[[0, 2]], shared[[0, 2]]) and not torch.equal(mixed[1], shared[1])


@pytest.fixture
def long_prompts(monkeypatch):
    """CHUNKED_THRESHOLD lowered in both packages (as in
    tests/test_torch_long_prefill.py), JAX's compile caches cleared."""
    monkeypatch.setattr(jax_attention, "CHUNKED_THRESHOLD", 32)
    monkeypatch.setattr(attention, "CHUNKED_THRESHOLD", 32)
    monkeypatch.setattr(flash_attn, "KV_CHUNK", 24)
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_long_prefill_into_pages_goes_through_flash_attention(long_prompts, monkeypatch):
    """A prompt past the threshold admitted into pages attends through
    ``_chunked_attention`` -> ``flash_attention_gqa`` on the fresh k/v, once
    a layer: logits and pools within 1e-5 of JAX's."""
    jcfg, jparams, tcfg, tparams = reduced_model()
    jcfg = jcfg.replace(kv_chunk=24)
    calls = []
    fn = attention.flash_attention_gqa

    def spy(q, k, v, **kw):
        calls.append(tuple(k.shape))
        return fn(q, k, v, **kw)
    monkeypatch.setattr(attention, "flash_attention_gqa", spy)
    n, length = 16, 61
    pages = np.random.default_rng(8).permutation(np.arange(1, n + 2))[:n].astype(np.int32)
    toks = np.zeros((1, n * PS), np.int32)
    toks[0, :length] = prompt(1, length, jcfg.vocab, seed=9)
    jc = jax_lm.init_paged_cache(jcfg, 1, n * PS, n + 2, PS)
    tc = lm.init_paged_cache(tcfg, 1, n * PS, n + 2, PS, CPU)
    jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jc, length=jnp.int32(length),
                            pages=jnp.asarray(pages), slot=jnp.int32(0))
    tl, _ = lm.prefill(tparams, tcfg, torch.from_numpy(toks), tc, length=length, pages=pages,
                       slot=0)
    assert calls == [(1, n * PS, tcfg.n_kv_heads, tcfg.head_dim)] * tcfg.n_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    _assert_pools_close(tc["layers"], jc["layers"], 16, 1e-5)

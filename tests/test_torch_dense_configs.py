"""Port parity for the rest of the dense family: llama3.2-3b (GQA group 3,
tied head), starcoder2-7b (group 3 at reduced size, head_dim 12, untied
head) and starcoder2-15b (group 2 at reduced size, untied head), each
reduced, against the JAX package on the same weights.

The registry's four dense configs equal the reference's field for field,
full and reduced.  Logits compare at rtol = atol = 1e-5 (f32, the same
operations summed in another order; the port's decode linears, the untied
head's included, run ``pim_matvec``'s plain version, the JAX package's
``x @ dq(w)``) and at 1e-3 with the int8 KV cache, whose codes may land one
apart at a rounding edge (``tests/test_torch_model.py``).  Greedy tokens
compare margin-aware at 1e-4 (``torch_helpers.assert_greedy_match``),
sampled ones exactly (the same keys), ``spec_stats`` exactly.  A two-row
speculative window of k = 2 has 6 rows, so the untied head runs through
``pim_matvec`` inside it.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.models.attention import _chunked_attention as jax_chunked  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxBatchingEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import SpecConfig as JaxSpec  # noqa: E402
from repro.serving import quantize_tree as jax_quantize_tree  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.kernels import flash_attention_plain  # noqa: E402
from repro_torch.models import decode_step, init_cache, init_params, prefill  # noqa: E402
from repro_torch.quant import quantize_symmetric  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine, Request, ServingEngine, SpecConfig, quantize_tree)

from torch_helpers import (  # noqa: E402,F401
    CPU, assert_greedy_match, assert_serve_match, one_thread, prompt, reduced_model,
    serve_deciding, serve_events)
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

DENSE = ["qwen2-1.5b", "starcoder2-7b", "llama3.2-3b", "starcoder2-15b"]
NEW = ["llama3.2-3b", "starcoder2-7b", "starcoder2-15b"]
LOGIT_TOL = 1e-4
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)
KEY = 5
SERVE_GEOMETRY = dict(slots=2, max_seq=24, page_size=4, chunk=3, page_alloc_seed=1, pim_bits=8)
SERVE_SHAPES = ((5, 4), (7, 6), (3, 3), (9, 5))  # (prompt length, max_new)


# ---------------------------------------------------------------- registry ---
@pytest.mark.parametrize("arch", DENSE)
def test_registry_configs_equal_the_reference(arch):
    """Every field of the port's ``ModelConfig``, full and reduced, equals the
    reference's; the port serves the dense ids in the reference's order."""
    for mine, want in ((get_config(arch), jax_get_config(arch)),
                       (get_reduced(arch), jax_get_reduced(arch))):
        for field in mine.__dataclass_fields__:
            assert getattr(mine, field) == getattr(want, field), (arch, field)
    assert ARCH_IDS[:len(DENSE)] == [a for a in JAX_ARCH_IDS if a in DENSE] == DENSE
    assert ARCH_IDS == [a for a in JAX_ARCH_IDS if a in ARCH_IDS]


def test_registry_refuses_an_unported_family():
    assert set(JAX_ARCH_IDS) - set(ARCH_IDS)
    for arch in set(JAX_ARCH_IDS) - set(ARCH_IDS):
        with pytest.raises(KeyError):
            get_config(arch)
        with pytest.raises(KeyError):
            get_reduced(arch)


# ---------------------------------------------------------- repairs' tests ---
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", ["starcoder2-7b", "starcoder2-15b"])
def test_untied_head_quantizes_to_contiguous_codes_and_scales(arch, bits):
    """``init_params`` draws the untied head as the transpose of a (vocab, d)
    draw, a strided view; the kernel takes contiguous codes and scales only,
    so every quantized leaf must come out contiguous, the head's included,
    with the values of the head's own contiguous copy."""
    cfg = get_reduced(arch)
    assert not cfg.tie_embeddings
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    assert not params["head"].is_contiguous()
    q = quantize_tree(params, bits)

    def leaves(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{path}/{k}")
            elif k in ("codes", "scale"):
                yield f"{path}/{k}", v
    seen = dict(leaves(q))
    assert "/head/codes" in seen and len(seen) == 2 * 8
    bad = [p for p, t in seen.items() if not t.is_contiguous()]
    assert not bad, bad
    want = quantize_tree({"head": params["head"].contiguous()}, bits)["head"]
    assert all(torch.equal(q["head"][k], want[k]) for k in want)


def _whole_leaf(leaf, bits):
    """The whole stacked leaf quantized at once (the form before the slices):
    scales over axis -2, int4 codes zero-padded to an even K and packed."""
    qt = quantize_symmetric(leaf.to(torch.float32), bits=bits, axis=-2)
    codes = qt.codes
    if bits == 4:
        if codes.shape[-2] % 2:
            codes = torch.cat([codes, torch.zeros_like(codes[..., :1, :])], dim=-2)
        codes = ((codes[..., 0::2, :] & 0xF) | ((codes[..., 1::2, :] & 0xF) << 4)).to(torch.int8)
    return codes, qt.scale


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(3, 2, 33, 10), (4, 64, 48), (9, 10)])
def test_quantize_tree_by_slices_equals_the_whole_leaf(shape, bits):
    """``quantize_tree`` quantizes a stacked leaf one (K, N) slice at a time:
    bit for bit the whole leaf's codes and scales, odd K included, in
    contiguous tensors; a strided leaf gives the same as its copy."""
    gen = torch.Generator().manual_seed(1)
    w = (0.02 * torch.randn(shape, generator=gen)).to(torch.bfloat16)
    w[..., 3] = 0  # an all-zero column: scale 1
    got = quantize_tree({"w": w}, bits)["w"]
    codes, scale = _whole_leaf(w, bits)
    assert torch.equal(got["codes"], codes) and torch.equal(got["scale"], scale)
    assert got["codes"].is_contiguous() and got["scale"].is_contiguous()
    if bits == 4:
        assert ("nibbles_odd" if shape[-2] % 2 else "nibbles") in got
    strided = quantize_tree({"w": w.transpose(-1, -2).contiguous().transpose(-1, -2)}, bits)["w"]
    assert all(torch.equal(strided[k], got[k]) for k in got)


# ---------------------------------------------------------------- logits -----
@pytest.mark.parametrize("bits,kv_bits", [(0, 16), (8, 16), (4, 8)])
@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_match_jax(arch, bits, kv_bits):
    _logits_match(arch, bits, kv_bits)


def _logits_match(arch, bits, kv_bits, **overrides):
    jcfg, jparams, tcfg, tparams = reduced_model(arch=arch, kv_cache_bits=kv_bits, **overrides)
    if bits:
        jparams = jax_quantize_tree(jparams, bits=bits)
        tparams = quantize_tree(tparams, bits=bits)
    b, s, max_seq = 2, 8, 12
    toks, nxt = prompt(b, s, jcfg.vocab), prompt(b, 1, jcfg.vocab, seed=2)
    jl, jcache = jax_prefill(jparams, jcfg, jnp.asarray(toks), jax_init_cache(jcfg, b, max_seq))
    jd, _ = jax_decode_step(jparams, jcfg, jnp.asarray(nxt), jcache, jnp.int32(s))
    tl, tcache = prefill(tparams, tcfg, torch.from_numpy(toks), init_cache(tcfg, b, max_seq, CPU))
    td, _ = decode_step(tparams, tcfg, torch.from_numpy(nxt), tcache, s)
    tol = 1e-5 if kv_bits == 16 else 1e-3
    assert tuple(tl.shape) == (b, s, jcfg.vocab) and tuple(td.shape) == (b, 1, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch,group", [("starcoder2-7b", 9), ("starcoder2-15b", 12)])
def test_full_configs_gqa_groups_match_jax(arch, group):
    """The full configs' groups of 9 and 12 query heads a KV head (the
    reduced ones have 3 and 2): the reduced model with ``2 * group`` heads
    over 2 KV heads, int8 weights and the int8 cache."""
    _logits_match(arch, 8, 8, n_heads=2 * group)


@pytest.mark.parametrize("group", [3, 9, 12])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_at_the_groups_matches_jax(group, causal):
    """``flash_attention``'s plain version (the long prefill's attention)
    against the JAX package's ``_chunked_attention`` at the dense family's
    groups, a ragged length, f32 within 1e-6."""
    rng = np.random.default_rng(group)
    q = rng.standard_normal((1, 37, 2, group, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 37, 2, 16)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                  kv_chunk=16))
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ generation -----
@functools.lru_cache(maxsize=None)
def _engines(arch, bits):
    jcfg, jparams, tcfg, tparams = reduced_model(arch=arch)
    return (JaxEngine(jcfg, jparams, max_seq=32, pim_bits=bits),
            ServingEngine(tcfg, tparams, max_seq=32, pim_bits=bits, device="cpu"))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", NEW)
def test_generate_matches_jax(arch, bits):
    """Greedy tokens margin-aware, sampled tokens (the same key) equal."""
    jeng, eng = _engines(arch, bits)
    toks = prompt(3, 8, eng.cfg.vocab)
    want = np.asarray(jeng.generate(jnp.asarray(toks), n_new=6))
    got = eng.generate(torch.from_numpy(toks), n_new=6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 6)
    at = serve_deciding(eng.params, eng.cfg, list(toks), list(got.numpy()), {}, KEY)
    assert_greedy_match(want, got.numpy(), at, LOGIT_TOL, msg=f"{arch} int{bits}")
    want = np.asarray(jeng.generate(jnp.asarray(toks), n_new=6, key=jax.random.PRNGKey(KEY),
                                    **SAMPLED))
    got = eng.generate(torch.from_numpy(toks), n_new=6, key=KEY, **SAMPLED)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", NEW)
def test_speculative_generate_matches_jax(arch):
    """Greedy n-gram windows at k = 2 on two rows (6 rows a window, the
    untied head through ``pim_matvec``): tokens margin-aware, and
    ``spec_stats`` equal to the reference's; the untrained model repeats
    tokens, so some windows accept proposals."""
    jeng, eng = _engines(arch, 8)
    toks = prompt(2, 6, eng.cfg.vocab, seed=4)
    want = np.asarray(jeng.generate(toks, 20, speculate=JaxSpec(k=2)))
    got = eng.generate(torch.from_numpy(toks), 20, speculate=SpecConfig(k=2))
    at = serve_deciding(eng.params, eng.cfg, list(toks), list(got.numpy()), {}, KEY)
    assert_greedy_match(want, got.numpy(), at, LOGIT_TOL, msg=arch)
    assert eng.spec_stats == jeng.spec_stats, arch
    assert eng.spec_stats["acceptance_per_live_row"] > 1  # proposals were accepted


@pytest.mark.parametrize("arch", NEW)
def test_continuous_serve_matches_jax(arch):
    """Four requests of mixed lengths over two slots of 4-token pages on a
    shuffled pool, sampled: the reference's events, counters, pages and
    (margin-aware) tokens."""
    jcfg, jparams, tcfg, tparams = reduced_model(arch=arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32) for n, _ in SERVE_SHAPES]
    budgets = [m for _, m in SERVE_SHAPES]
    mode = dict(greedy=False, temperature=1.0, top_k=0)
    jeng = JaxBatchingEngine(jcfg, jparams, **SERVE_GEOMETRY)
    jrep = jeng.serve_detailed([JaxRequest(prompt=p, max_new=m) for p, m in zip(prompts, budgets)],
                               key=jax.random.PRNGKey(KEY), **mode)
    eng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **SERVE_GEOMETRY)
    rep = eng.serve_detailed([Request(prompt=p, max_new=m) for p, m in zip(prompts, budgets)],
                             key=KEY, **mode)
    assert serve_events(rep) == serve_events(jrep)
    assert (rep.rounds, eng.decode_chunk_iters, eng.peak_pages_in_use, eng.preemptions) == (
        jrep.rounds, jeng.decode_chunk_iters, jeng.peak_pages_in_use, jeng.preemptions)
    at = serve_deciding(eng.params, tcfg, prompts, rep.outputs, mode, KEY)
    assert_serve_match(jrep.outputs, rep.outputs, at, LOGIT_TOL, msg=arch)
    assert [len(t) for t in rep.outputs] == budgets and eng.pages_in_use() == 0

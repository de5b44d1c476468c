"""Port parity: the long-prompt prefill.  Above ``CHUNKED_THRESHOLD`` keys
both packages' ``attn_prefill`` take the chunked (online-softmax) attention;
the port's goes through ``flash_attention_gqa`` (the CUDA kernel on the
card, its plain version here).  The threshold is lowered in BOTH packages'
attention modules so that reduced qwen2-1.5b takes that path on a 64-token
prompt, and a chunk of 24 keys (JAX's ``cfg.kv_chunk``, the port's
``flash_attn.KV_CHUNK``) makes the plain version walk 4 chunks of 16 keys (24
does not divide 64: the largest divisor below it takes over).

Tolerances as in tests/test_torch_model.py: logits within 1e-5 with the
reduced config's f32 cache, 1e-3 with the int8 cache (a K/V value at a
rounding edge can land one code apart); greedy tokens equal wherever the top-2
margin exceeds 1e-4 (tests/test_torch_engine.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jax_attention  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.kernels import flash_attn  # noqa: E402
from repro_torch.models import attention, init_cache, prefill  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

from torch_helpers import CPU, assert_greedy_match, prompt, reduced_model  # noqa: E402
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

SEQ, THRESHOLD, KV_CHUNK = 64, 32, 24


@pytest.fixture
def long_prompts(monkeypatch):
    """A lower CHUNKED_THRESHOLD in both packages and the port's plain chunk
    at KV_CHUNK (JAX's comes from its config); JAX's compile caches are
    cleared on both sides, so no program traced under the other threshold
    is reused."""
    monkeypatch.setattr(jax_attention, "CHUNKED_THRESHOLD", THRESHOLD)
    monkeypatch.setattr(attention, "CHUNKED_THRESHOLD", THRESHOLD)
    monkeypatch.setattr(flash_attn, "KV_CHUNK", KV_CHUNK)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _spy(monkeypatch, name):
    """Count the calls of ``attention.<name>`` (the port's model module)."""
    calls = []
    fn = getattr(attention, name)

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return fn(*args, **kw)
    monkeypatch.setattr(attention, name, spy)
    return calls


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_long_prefill_matches_jax(kv_bits, long_prompts, monkeypatch):
    jcfg, jparams, tcfg, tparams = reduced_model(kv_cache_bits=kv_bits)
    jcfg = jcfg.replace(kv_chunk=KV_CHUNK)
    b, max_seq = 2, SEQ + 4
    toks = prompt(b, SEQ, jcfg.vocab)
    flash = _spy(monkeypatch, "flash_attention_gqa")
    direct = _spy(monkeypatch, "_direct_attention")

    jl, _ = jax_prefill(jparams, jcfg, jnp.asarray(toks), jax_init_cache(jcfg, b, max_seq))
    tl, _ = prefill(tparams, tcfg, torch.from_numpy(toks), init_cache(tcfg, b, max_seq, CPU))

    g = tcfg.n_heads // tcfg.n_kv_heads
    assert flash == [(b, SEQ, tcfg.n_kv_heads, g, tcfg.head_dim)] * tcfg.n_layers
    assert direct == []
    tol = 1e-5 if kv_bits == 16 else 1e-3
    assert tuple(tl.shape) == (b, SEQ, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)


def test_short_prefill_still_attends_directly(monkeypatch):
    """At the real threshold a 64-token prompt never reaches the kernel."""
    _, _, tcfg, tparams = reduced_model()
    flash = _spy(monkeypatch, "flash_attention_gqa")
    direct = _spy(monkeypatch, "_direct_attention")
    toks = prompt(1, SEQ, tcfg.vocab)
    prefill(tparams, tcfg, torch.from_numpy(toks), init_cache(tcfg, 1, SEQ, CPU))
    assert flash == [] and len(direct) == tcfg.n_layers


def test_long_prompt_greedy_matches_jax(long_prompts, monkeypatch):
    jcfg, jparams, tcfg, tparams = reduced_model()
    jcfg = jcfg.replace(kv_chunk=KV_CHUNK)
    toks = prompt(2, SEQ, jcfg.vocab, seed=4)
    flash = _spy(monkeypatch, "flash_attention_gqa")
    jeng = JaxEngine(jcfg, jparams, max_seq=SEQ + 4, pim_bits=8)
    eng = ServingEngine(tcfg, tparams, max_seq=SEQ + 4, pim_bits=8, device="cpu")
    want = np.asarray(jeng.generate(jnp.asarray(toks), n_new=4))
    got = eng.generate(torch.from_numpy(toks), n_new=4).numpy()
    assert got.shape == (2, 4) and len(flash) == tcfg.n_layers

    def logits_at(row, j):
        seq = np.concatenate([toks[row], got[row, :j]])[None]
        logits, _ = prefill(eng.params, eng.cfg, torch.from_numpy(seq),
                            init_cache(eng.cfg, 1, seq.shape[1], CPU))
        return logits[0, -1].numpy()
    assert_greedy_match(want, got, logits_at, 1e-4, msg="jax vs port, long prompt")

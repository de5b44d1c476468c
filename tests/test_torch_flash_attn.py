"""Port parity: ``flash_attention`` (its plain version, and the wrappers on
CPU tensors) against the JAX package's naive oracle ``flash_attention_ref``
and its model-side twin ``_chunked_attention``.  The Pallas kernel itself
does not run on this JAX (``pl.load`` is gone), so the JAX side is always one
of those two.

Tolerances: against the naive oracle, the JAX kernel test's own (f32 2e-5;
bf16 3e-2, atol 10x), since the online softmax rescales where the oracle
normalises once.  Against ``_chunked_attention``, which the plain version
mirrors line for line, f32 within 1e-6 (the same operations, summed in
another order by another library) and bf16 equal up to one bf16 ulp (two f32
results that close round to the same or to adjacent bf16 values).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attn import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.models.attention import _chunked_attention as jax_chunked  # noqa: E402
from repro_torch.kernels import flash_attention, flash_attention_gqa, flash_attention_plain  # noqa: E402
from repro_torch.kernels import flash_attn as port_flash  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attention_ref  # noqa: E402


def _bhsd(bh, sq, sk, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(dtype)
                 for shape in ((bh, sq, d), (bh, sk, d), (bh, sk, d)))


def _gqa(b, sq, sk, kvh, g, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, kvh, g, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32))


def _bf16_ulp(x):
    """One bf16 ulp at the magnitude of each value of ``x`` (f32 numpy)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.ldexp(np.float32(1.0), np.floor(np.log2(mag)).astype(np.int32) - 7)


# tests/test_flash_attn.py's (BH, Sq, Sk, D); the Pallas tile sizes are gone.
SHAPES = [(2, 64, 64, 32), (4, 128, 128, 16), (1, 256, 256, 64), (2, 64, 128, 32)]


@pytest.mark.parametrize("bh,sq,sk,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_ref(bh, sq, sk, d, causal):
    """Causal with Sq != Sk is top-left aligned in both packages."""
    q, k, v = _bhsd(bh, sq, sk, d, seed=sq + sk)
    want = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_allclose(flash_attention_ref(*t, causal=causal).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    got = flash_attention(*t, causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == (bh, sq, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
def test_flash_attention_dtypes(dtype, tol):
    q, k, v = _bhsd(2, 128, 128, 32, seed=9)
    want = np.asarray(jax_flash_ref(*(jnp.asarray(a, jnp.dtype(str(dtype).split(".")[1]))
                                      for a in (q, k, v)), causal=True), np.float32)
    got = flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol * 10)


# (B, Sq, Sk, KV, G, D, kv_chunk): G > 1 throughout; chunks that divide Sk,
# that do not (the largest divisor takes over), one chunk, and Sq != Sk.
GQA = [(2, 96, 96, 2, 3, 16, 32), (2, 96, 96, 2, 3, 16, 40), (1, 70, 70, 2, 2, 32, 512),
       (1, 64, 64, 1, 4, 16, 7), (2, 40, 72, 2, 2, 16, 16)]


@pytest.mark.parametrize("b,sq,sk,kvh,g,d,chunk", GQA)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_chunked_attention(b, sq, sk, kvh, g, d, chunk, causal,
                                              monkeypatch):
    """The wrapper on CPU tensors is the plain version at the module's
    KV_CHUNK, set here to ``chunk``."""
    monkeypatch.setattr(port_flash, "KV_CHUNK", chunk)
    q, k, v = _gqa(b, sq, sk, kvh, g, d, seed=sq * g + chunk)
    want = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                  kv_chunk=chunk))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = flash_attention_plain(*t, causal=causal, kv_chunk=chunk)
    assert tuple(got.shape) == (b, sq, kvh, g, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        flash_attention_gqa(*t, causal=causal).numpy(), got.numpy())

    wb = np.asarray(jax_chunked(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal,
                                kv_chunk=chunk).astype(jnp.float32))
    gb = flash_attention_gqa(*(a.to(torch.bfloat16) for a in t), causal=causal)
    assert gb.dtype == torch.bfloat16
    gb = gb.float().numpy()
    ulp = _bf16_ulp(np.maximum(np.abs(gb), np.abs(wb)))
    assert np.all(np.abs(gb - wb) <= ulp), np.abs(gb - wb).max()


def test_plain_takes_a_strided_cache_view(monkeypatch):
    """The int8 cache path attends over transposed (B, KV, S, D) views."""
    monkeypatch.setattr(port_flash, "KV_CHUNK", 16)
    q, k, v = _gqa(1, 48, 48, 2, 3, 16, seed=5)
    kt = torch.from_numpy(np.ascontiguousarray(k.transpose(0, 2, 1, 3))).transpose(1, 2)
    vt = torch.from_numpy(np.ascontiguousarray(v.transpose(0, 2, 1, 3))).transpose(1, 2)
    assert not kt.is_contiguous()
    got = flash_attention_gqa(torch.from_numpy(q), kt, vt, causal=True)
    want = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                                  kv_chunk=16))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_no_nan_where_whole_chunks_are_masked():
    """Causal with 8-key chunks: the early rows see nothing of most chunks,
    whose scores are all -inf; the guards keep every output finite."""
    q, k, v = _gqa(1, 64, 64, 1, 2, 16, seed=3)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = flash_attention_plain(*t, causal=True, kv_chunk=8)
    assert bool(torch.isfinite(got).all())
    want = np.asarray(jax_chunked(*(jnp.asarray(a) for a in (q, k, v)), True, kv_chunk=8))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    row0 = v[0, 0, 0]  # query 0 sees key 0 alone
    np.testing.assert_allclose(got[0, 0, 0].numpy(), np.stack([row0, row0]), rtol=1e-6)


def test_wrappers_run_the_plain_version_on_cpu_without_launching():
    flash_attention.launches = 0
    q, k, v = (torch.from_numpy(a) for a in _bhsd(2, 32, 32, 16, seed=1))
    flash_attention(q, k, v)
    flash_attention_gqa(q[:, :, None, None], k[:, :, None], v[:, :, None], causal=False)
    assert flash_attention.launches == 0


def test_wrappers_reject_what_the_contract_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _gqa(1, 8, 8, 2, 2, 16, seed=2))
    with pytest.raises(ValueError, match=r"\(BH, S, D\)"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match=r"\(B, Sq, KV, G, D\)"):
        flash_attention_gqa(q[:, :, 0], k, v, causal=True)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_gqa(q, k[..., :8], v[..., :8], causal=True)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_gqa(q, k, v[:, :4], causal=True)
    with pytest.raises(ValueError, match="no keys"):
        flash_attention_gqa(q, k[:, :0], v[:, :0], causal=True)
    with pytest.raises(TypeError, match="dtypes"):
        flash_attention_gqa(q.half(), k.half(), v.half(), causal=True)
    with pytest.raises(TypeError, match="dtypes"):
        flash_attention_gqa(q, k.bfloat16(), v, causal=True)
    with pytest.raises(TypeError, match="dtypes"):
        flash_attention(q[:, :, 0, 0].long(), k[:, :, 0].long(), v[:, :, 0].long())
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention_gqa(q.to("meta"), k.to("meta"), v.to("meta"), causal=True)
    with pytest.raises(ValueError, match="on cpu"):
        flash_attention_gqa(q, k.to("meta"), v, causal=True)

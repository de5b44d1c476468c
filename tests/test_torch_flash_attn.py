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
import functools
import importlib.util
import math
from pathlib import Path

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


def test_check_aligned_takes_the_model_layouts_and_rejects_odd_steps():
    """The bf16 route's rule (checked on CUDA tensors only): 16-byte aligned
    pointers, strides in multiples of 8 elements except the last and those
    of size-1 dims."""
    q = torch.zeros((1, 64, 2, 6, 128), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 64, 128), dtype=torch.bfloat16).transpose(1, 2)  # a cache view
    v = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16)
    port_flash._check_aligned(q, k, v)
    port_flash._check_aligned(q[:, :, :1, :1], k[:, :, :1], v[:, :, :1])
    odd = torch.zeros((1, 64, 2, 129), dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="multiples of 8"):
        port_flash._check_aligned(q, odd, v)
    shifted = torch.zeros(64 * 2 * 128 + 1, dtype=torch.bfloat16)[1:].view(1, 64, 2, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        port_flash._check_aligned(q, k, shifted)


@functools.cache
def _chip_smoke():
    """chip_smoke.py as a module, for its bars (it runs nothing on import),
    loaded once."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mma_route(q, k, v, *, causal, split_p):
    """The CUDA bf16 route's arithmetic, emulated on the CPU: bf16 inputs
    (exact in f32), f32 scores scaled after the product, an online softmax
    over tiles of KV_TILE_BF16 keys, p.v with p either split into bf16 hi
    and lo halves (``split_p``, what the kernel does) or rounded once to
    bf16 (what SDPA does), f32 accumulation; the output rounded to bf16.
    Its exponents are the kernel's: ``exp2f(fmaf(s, log2e, -m * log2e))``,
    the fma formed in f64 (the f32 product is exact there) and rounded once."""
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    qf, kf, vf = (t.float() for t in (q, k, v))
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    m = torch.full((b, kvh, g, sq), float("-inf"))
    l = torch.zeros((b, kvh, g, sq))
    acc = torch.zeros((b, kvh, g, sq, d))
    qi = torch.arange(sq)[:, None]
    for k0 in range(0, sk, port_flash.KV_TILE_BF16):
        kj, vj = kf[:, k0:k0 + port_flash.KV_TILE_BF16], vf[:, k0:k0 + port_flash.KV_TILE_BF16]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kj) * scale
        if causal:
            s = s.masked_fill(k0 + torch.arange(kj.shape[1])[None, :] > qi, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp2((m - m_use) * log2e)
        base = (m_use * log2e)[..., None]
        p = torch.exp2((s.double() * log2e.double() - base.double()).float())
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        pv = torch.einsum("bhgqk,bkhd->bhgqd", hi, vj)
        if split_p:
            pv = pv + torch.einsum("bhgqk,bkhd->bhgqd", (p - hi).bfloat16().float(), vj)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(torch.bfloat16)


# chip_smoke.py's FLASH_BHSD as (B, Sq, Sk, KV, G, D), and a ragged length at
# the model's heads.
MMA_SHAPES = [(bh, sq, sk, 1, 1, d) for bh, sq, sk, d in SHAPES] + [(1, 1000, 1000, 2, 6, 128)]


@pytest.mark.parametrize("split_p", [True, False], ids=["split_p", "single_bf16_p"])
@pytest.mark.parametrize("shape", MMA_SHAPES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_mma_route_arithmetic_within_the_bf16_bar(shape, causal, split_p):
    """The bf16 route's design holds chip_smoke.py's bar (``within_bf16_ulp``:
    KERNEL_TOL plus one bf16 ulp) against ``flash_attention_plain`` only
    with p split: a single bf16 p must break it (over these cases it uses
    3.5-13x the bar, the split at most 0.95)."""
    b, sq, sk, kvh, g, d = shape
    rng = np.random.default_rng(sq + 7 * sk + g)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
               for s in ((b, sq, kvh, g, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    ok, err, share, _ = _chip_smoke().within_bf16_ulp(
        _mma_route(q, k, v, causal=causal, split_p=split_p),
        flash_attention_plain(q, k, v, causal=causal))
    if split_p:
        assert ok, (err, share)
    else:
        assert not ok, f"a single bf16 p stayed within the bar ({share:.3g} of it)"

"""Port parity: ``pim_matmul`` (its plain version, and the wrapper on CPU
tensors) against the JAX package's Pallas kernel in interpret mode, on the
pad-to-tile shapes of tests/test_kernels.py, and the port's ``ref`` oracles
against the JAX package's.  Tolerance rtol 1e-5, atol 1e-4: f32 sums of the
same products in another order."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.pim_matmul import pim_matmul as jax_pim_matmul  # noqa: E402
from repro.quant import pack_int4 as jax_pack_int4  # noqa: E402
from repro.quant import quantize_symmetric as jax_quantize  # noqa: E402
from repro_torch.kernels import pim_matmul, pim_matmul_plain, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)


def _case(m, k, n, bits, seed):
    """numpy inputs + the JAX quantized weight (packed for int4)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    q = jax_quantize(jnp.asarray(w), bits=bits, axis=0)
    codes = q.codes if bits == 8 else jax_pack_int4(q.codes)
    return x, np.array(codes), np.array(q.scale)


def _jax(x, codes, scale, bits, tiles, **ep):
    """The Pallas kernel in interpret mode on the same inputs."""
    bm, bn, bk = tiles
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in ep.items()}
    return np.asarray(jax_pim_matmul(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale),
                                     bits=bits, bm=bm, bn=bn, bk=bk, interpret=True, **kw))


def _port(x, codes, scale, bits, **ep):
    """(plain, wrapper) outputs of the port on CPU tensors."""
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in ep.items()}
    args = (torch.from_numpy(x), torch.from_numpy(codes), torch.from_numpy(scale))
    return (pim_matmul_plain(*args, bits=bits, **kw).numpy(),
            pim_matmul(*args, bits=bits, **kw).numpy())


# Pad-to-tile shapes: multiples of the tiles, and shapes that are not
# (the JAX kernel pads those; the CUDA kernel masks them).
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (8, 32, 16, 8, 16, 16),
    (16, 128, 64, 8, 32, 32),
    (32, 256, 128, 16, 128, 64),
    (4, 64, 8, 4, 8, 64),  # M <= 8, one K tile
    (9, 100, 30, 8, 16, 32),  # multiples of no tile
    (20, 70, 40, 16, 32, 64),
])
def test_pim_matmul_int8_matches_jax(m, k, n, bm, bn, bk):
    x, codes, scale = _case(m, k, n, 8, seed=m + k + n)
    want = _jax(x, codes, scale, 8, (bm, bn, bk))
    for got in _port(x, codes, scale, 8):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("m,k,n,bk", [(8, 64, 16, 32), (16, 128, 32, 64),
                                      (3, 100, 24, 32), (17, 66, 20, 16)])
def test_pim_matmul_int4_matches_jax(m, k, n, bk):
    x, codes, scale = _case(m, k, n, 4, seed=7)
    want = _jax(x, codes, scale, 4, (8, 16, bk))
    for got in _port(x, codes, scale, 4):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("activation", ["none", "relu", "silu", "gelu"])
def test_pim_matmul_fused_epilogue_matches_jax(activation, bits):
    """scale x bias + activation + residual, gelu in its tanh form, on a
    shape that pads in every dimension."""
    m, k, n = 12, 48, 20
    x, codes, scale = _case(m, k, n, bits, seed=3)
    rng = np.random.default_rng(9)
    ep = dict(bias=rng.standard_normal((n,)).astype(np.float32),
              residual=rng.standard_normal((m, n)).astype(np.float32),
              activation=activation)
    want = _jax(x, codes, scale, bits, (8, 16, 32), **ep)
    for got in _port(x, codes, scale, bits, **ep):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_pim_matmul_bf16_matches_jax(bits):
    """bf16 x (and bias, residual): both packages widen it to f32 exactly,
    so the port meets the JAX kernel at the f32 tolerance, and the JAX
    oracle (dequantize first) at its own test's 2e-2."""
    m, k, n = 16, 64, 32
    x, codes, scale = _case(m, k, n, bits, seed=5)
    rng = np.random.default_rng(6)
    b = rng.standard_normal((n,)).astype(np.float32)
    r = rng.standard_normal((m, n)).astype(np.float32)
    want = np.asarray(jax_pim_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(codes), jnp.asarray(scale), bits=bits,
        bias=jnp.asarray(b, jnp.bfloat16), residual=jnp.asarray(r, jnp.bfloat16),
        bm=16, bn=32, bk=32, interpret=True))
    bf = torch.bfloat16
    args = (torch.from_numpy(x).to(bf), torch.from_numpy(codes), torch.from_numpy(scale))
    kw = dict(bits=bits, bias=torch.from_numpy(b).to(bf), residual=torch.from_numpy(r).to(bf))
    for fn in (pim_matmul_plain, pim_matmul):
        np.testing.assert_allclose(fn(*args, **kw).numpy(), want, **TOL)
    oracle = jax_ref.pim_matmul_int8_ref if bits == 8 else jax_ref.pim_matmul_int4_ref
    want_ref = np.asarray(oracle(jnp.asarray(x, jnp.bfloat16), jnp.asarray(codes),
                                 jnp.asarray(scale)))
    got = pim_matmul(*args, bits=bits).numpy()
    np.testing.assert_allclose(got, want_ref, rtol=2e-2, atol=2e-1)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(8, 64, 16), (5, 34, 7)])
def test_ref_oracles_match_jax(bits, m, k, n):
    x, codes, scale = _case(m, k, n, bits, seed=11)
    name = "pim_matmul_int8_ref" if bits == 8 else "pim_matmul_int4_ref"
    want = np.asarray(getattr(jax_ref, name)(jnp.asarray(x), jnp.asarray(codes),
                                             jnp.asarray(scale)))
    got = getattr(ref, name)(torch.from_numpy(x), torch.from_numpy(codes),
                             torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The kernel's plain version scales after the sum: the same function.
    plain = pim_matmul_plain(torch.from_numpy(x), torch.from_numpy(codes),
                             torch.from_numpy(scale), bits=bits)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


@pytest.mark.parametrize("bad", ["bits", "codes8", "codes4", "activation", "rank"])
def test_pim_matmul_rejects_what_jax_asserts(bad):
    x, codes, scale = (torch.from_numpy(a) for a in _case(12, 32, 16, 8, seed=0))
    kw = dict(bits=8, activation="none")
    if bad == "bits":
        kw["bits"] = 2
    elif bad == "codes8":
        codes = codes[:16]  # K/2 rows at bits=8
    elif bad == "codes4":
        kw["bits"] = 4  # K rows at bits=4
    elif bad == "activation":
        kw["activation"] = "tanh"
    else:
        x = x[None]
    with pytest.raises(ValueError):
        pim_matmul(x, codes, scale, **kw)


def test_pim_matmul_takes_no_tpu_tiling_switches():
    """bm/bn/bk/interpret steer the TPU kernel; the port has no such knobs."""
    x, codes, scale = (torch.from_numpy(a) for a in _case(4, 32, 16, 8, seed=0))
    for kw in ({"bm": 8}, {"interpret": True}):
        with pytest.raises(TypeError):
            pim_matmul(x, codes, scale, bits=8, **kw)


def test_pim_matmul_counts_kernel_launches_only():
    """A CPU call runs the plain version and launches nothing; a tensor on a
    device that is neither CPU nor CUDA is refused, never computed."""
    x, codes, scale = (torch.from_numpy(a) for a in _case(12, 32, 16, 8, seed=1))
    before = pim_matmul.launches
    pim_matmul(x, codes, scale, bits=8)
    assert pim_matmul.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        pim_matmul(x.to("meta"), codes.to("meta"), scale.to("meta"), bits=8)
    assert pim_matmul.launches == before

"""Port parity: ``pim_matvec`` (its plain version, and the wrapper on CPU
tensors) against the JAX package's Pallas kernel in interpret mode, on the
parameter grid of tests/test_decode_fastpath.py, and the decode-shaped
``linear`` that routes through it.  Tolerance rtol 1e-5, atol 1e-4: f32 sums
of the same products in another order."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.pim_matvec import pim_matvec as jax_pim_matvec  # noqa: E402
from repro.models import common as jc  # noqa: E402
from repro.quant import pack_int4 as jax_pack_int4  # noqa: E402
from repro.quant import quantize_symmetric as jax_quantize  # noqa: E402
from repro.serving import quantize_tree as jax_quantize_tree  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import pim_matvec, pim_matvec_plain  # noqa: E402
from repro_torch.kernels.pim_matvec import split_rows  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402

from torch_helpers import CPU, to_numpy  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)


def _case(m, k, n, bits, seed):
    """numpy inputs + the JAX quantized weight (packed for int4)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    q = jax_quantize(jnp.asarray(w), bits=bits, axis=0)
    codes = q.codes if bits == 8 else jax_pack_int4(q.codes)
    return x, np.array(codes), np.array(q.scale)


def _both(x, codes, scale, bits, **ep):
    """(plain, wrapper) outputs of the port on CPU tensors."""
    t = {k: None if v is None else torch.from_numpy(v) for k, v in ep.items()
         if k != "activation"}
    args = (torch.from_numpy(x), torch.from_numpy(codes), torch.from_numpy(scale))
    kw = dict(bits=bits, activation=ep.get("activation", "none"), **t)
    return pim_matvec_plain(*args, **kw).numpy(), pim_matvec(*args, **kw).numpy()


@pytest.mark.parametrize("m,k,n,bn,bk", [
    (1, 64, 32, 16, 16),
    (4, 128, 64, 64, 64),
    (8, 256, 128, 128, 512),
    (2, 96, 100, 32, 64),
    (3, 50, 30, 16, 16),
])
def test_pim_matvec_int8_matches_jax(m, k, n, bn, bk):
    x, codes, scale = _case(m, k, n, 8, seed=m + k + n)
    want = np.asarray(jax_pim_matvec(jnp.asarray(x), jnp.asarray(codes),
                                     jnp.asarray(scale), bits=8, bn=bn, bk=bk,
                                     interpret=True))
    for got in _both(x, codes, scale, 8):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("m,k,n,bk", [(1, 64, 16, 32), (4, 128, 32, 64),
                                      (2, 100, 48, 64)])
def test_pim_matvec_int4_matches_jax(m, k, n, bk):
    x, codes, scale = _case(m, k, n, 4, seed=7)
    want = np.asarray(jax_pim_matvec(jnp.asarray(x), jnp.asarray(codes),
                                     jnp.asarray(scale), bits=4, bn=16, bk=bk,
                                     interpret=True))
    for got in _both(x, codes, scale, 4):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("activation", ["none", "relu", "silu", "gelu"])
def test_pim_matvec_fused_epilogue_matches_jax(activation, bits):
    """scale x bias + activation + residual, gelu in its tanh form."""
    m, k, n = 4, 64, 48
    x, codes, scale = _case(m, k, n, bits, seed=3)
    rng = np.random.default_rng(9)
    bias = rng.standard_normal((n,)).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    want = np.asarray(jax_pim_matvec(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale), bits=bits,
        bias=jnp.asarray(bias), activation=activation, residual=jnp.asarray(res),
        bn=16, bk=32, interpret=True))
    for got in _both(x, codes, scale, bits, bias=bias, residual=res,
                     activation=activation):
        np.testing.assert_allclose(got, want, **TOL)


def test_pim_matvec_rejects_large_m():
    x, codes, scale = _case(16, 32, 16, 8, seed=0)
    with pytest.raises(ValueError, match="decode-shaped"):
        pim_matvec(torch.from_numpy(x), torch.from_numpy(codes),
                   torch.from_numpy(scale), bits=8)


@pytest.mark.parametrize("bad", ["bits", "codes", "activation"])
def test_pim_matvec_rejects_bad_arguments(bad):
    x, codes, scale = (torch.from_numpy(a) for a in _case(2, 32, 16, 8, seed=0))
    kw = dict(bits=8, activation="none")
    if bad == "bits":
        kw["bits"] = 2
    elif bad == "codes":
        codes = codes[:16]
    else:
        kw["activation"] = "tanh"
    with pytest.raises(ValueError):
        pim_matvec(x, codes, scale, **kw)


@pytest.mark.parametrize("rows,n", [(1536, 256), (1536, 1536), (768, 8960),
                                    (8960, 1536), (17, 24)])
def test_split_rows_covers_every_row_once(rows, n):
    """The kernel's K split: every code row in exactly one split, none
    empty."""
    splits, per = split_rows(rows, n, sm_count=132)
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < rows <= splits * per


@pytest.fixture(scope="module", autouse=True)
def jax_force():
    """The JAX package's ``linear`` dispatch forced to its kernel (interpret
    mode) for this module; a mode change clears JAX's compile caches, so it
    is set once.  The direct ``pim_matvec`` calls do not read it."""
    prev = jc.set_matvec_dispatch("force")
    try:
        yield
    finally:
        jc.set_matvec_dispatch(prev)


@pytest.mark.parametrize("bits,kdim", [(8, 64), (4, 64), (4, 33)])
def test_linear_auto_matches_jax_force(bits, kdim):
    """Decode-shaped: the port's "auto" (pim_matvec's plain version on CPU)
    against the JAX package's kernel in interpret mode, with the odd-K
    ``nibbles_odd`` pad column and the cast back to x's dtype."""
    w = np.random.default_rng(2).standard_normal((kdim, 24)).astype(np.float32)
    jq = jax_quantize_tree({"w": jnp.asarray(w)}, bits=bits)["w"]
    tq = params_from_numpy(to_numpy(jq), CPU)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, kdim)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    want = np.asarray(jc.linear(jnp.asarray(x), jq, jnp.asarray(b)))
    got = tc.linear(torch.from_numpy(x), tq, torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)

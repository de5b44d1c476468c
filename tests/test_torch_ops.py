"""Port parity: the packed kernel entry point ``repro_torch.kernels.ops``
(``quantize_for_pim``, ``pim_dense``, ``pim_matvec_dense``) and
``quant.dequantize`` against the JAX package's, on the same numpy inputs;
the slice as a whole on every linear of reduced qwen2-1.5b.  Codes and
scales must be equal; outputs within rtol 1e-5, atol 1e-4 (f32 sums of the
same products in another order)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.quant import dequantize as jax_dequantize  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.quant import dequantize  # noqa: E402

from torch_helpers import reduced_model  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)
# The seven linears of a dense layer, with the bias each takes.
LINEARS = (("attn", "wq", "bq"), ("attn", "wk", "bk"), ("attn", "wv", "bv"),
           ("attn", "wo", None), ("mlp", "gate", None), ("mlp", "up", None),
           ("mlp", "down", None))


def _weight(k, n, seed):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    w[:, 1] = 0.0  # an all-zero column: scale 1.0
    return w


def _both_quantized(w, bits):
    return (jax_ops.quantize_for_pim(jnp.asarray(w), bits=bits),
            ops.quantize_for_pim(torch.from_numpy(w), bits=bits))


def _assert_same_quantized(jq, tq):
    np.testing.assert_array_equal(np.asarray(jq.codes), tq.codes.numpy())
    np.testing.assert_array_equal(np.asarray(jq.scale), tq.scale.numpy())
    assert (tq.bits, tq.packed, tq.shape) == (jq.bits, jq.packed, tuple(jq.shape))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n", [(64, 48), (34, 16)])
def test_quantize_for_pim_matches_jax(bits, k, n):
    """Codes (nibble-packed at int4) and scales equal; ``packed``, ``bits``
    and ``shape`` as JAX's."""
    jq, tq = _both_quantized(_weight(k, n, seed=k + bits), bits)
    _assert_same_quantized(jq, tq)
    assert tq.shape == (k, n)


def test_quantize_for_pim_int4_rejects_odd_k():
    w = _weight(33, 8, seed=0)
    with pytest.raises(ValueError, match="even K"):
        jax_ops.quantize_for_pim(jnp.asarray(w), bits=4)
    with pytest.raises(ValueError, match="even K"):
        ops.quantize_for_pim(torch.from_numpy(w), bits=4)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_matches_jax(bits):
    """codes x scale in f32, unpacking nibbles first: bit for bit."""
    jq, tq = _both_quantized(_weight(40, 24, seed=2), bits)
    want = np.asarray(jax_dequantize(jq))
    got = dequantize(tq)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("epilogue", ["plain", "bias_gelu", "bias_silu_residual"])
def test_pim_dense_matches_jax(bits, epilogue):
    m, k, n = 24, 96, 40
    jq, tq = _both_quantized(_weight(k, n, seed=4), bits)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ep = {"plain": {},
          "bias_gelu": dict(bias=rng.standard_normal((n,)).astype(np.float32),
                            activation="gelu"),
          "bias_silu_residual": dict(bias=rng.standard_normal((n,)).astype(np.float32),
                                     residual=rng.standard_normal((m, n)).astype(np.float32),
                                     activation="silu")}[epilogue]
    want = np.asarray(jax_ops.pim_dense(
        jnp.asarray(x), jq, **{key: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                               for key, v in ep.items()}))
    got = ops.pim_dense(torch.from_numpy(x), tq,
                        **{key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                           for key, v in ep.items()})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_pim_matvec_dense_matches_jax(bits):
    m, k, n = 4, 64, 48
    jq, tq = _both_quantized(_weight(k, n, seed=6), bits)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    r = rng.standard_normal((m, n)).astype(np.float32)
    want = np.asarray(jax_ops.pim_matvec_dense(
        jnp.asarray(x), jq, bias=jnp.asarray(b), activation="relu", residual=jnp.asarray(r)))
    got = ops.pim_matvec_dense(torch.from_numpy(x), tq, bias=torch.from_numpy(b),
                               activation="relu", residual=torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_entry_point_on_every_linear_of_reduced_qwen2_matches_jax(bits):
    """The slice as a whole: every layer's seven weights of reduced
    qwen2-1.5b (JAX's parameters, carried across by the bridge) through
    ``quantize_for_pim`` and ``pim_dense`` at M = 2 x 16 rows, wq/wk/wv with
    a seeded bias (the model's own are zeros)."""
    _, jparams, tcfg, tparams = reduced_model()
    rng = np.random.default_rng(8)
    xs = {k: rng.standard_normal((2 * 16, k)).astype(np.float32)
          for k in (tcfg.d_model, tcfg.n_heads * tcfg.head_dim, tcfg.d_ff)}
    checked = 0
    for i in range(tcfg.n_layers):
        for group, name, bname in LINEARS:
            jw = jparams["layers"][group][name][i]
            tw = tparams["layers"][group][name][i]
            jq = jax_ops.quantize_for_pim(jw, bits=bits)
            tq = ops.quantize_for_pim(tw, bits=bits)
            _assert_same_quantized(jq, tq)
            k, n = tq.shape
            b = None if bname is None else rng.standard_normal((n,)).astype(np.float32)
            want = np.asarray(jax_ops.pim_dense(
                jnp.asarray(xs[k]), jq, bias=None if b is None else jnp.asarray(b)))
            got = ops.pim_dense(torch.from_numpy(xs[k]), tq,
                                bias=None if b is None else torch.from_numpy(b))
            np.testing.assert_allclose(got.numpy(), want, **TOL,
                                       err_msg=f"layer {i} {name} bits={bits}")
            checked += 1
    assert checked == tcfg.n_layers * len(LINEARS)

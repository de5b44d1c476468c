"""Port parity: ``models.common`` against the JAX package — the overlay
``linear``, ``dq``/``weight_shape``, ``rmsnorm``, the interleaved RoPE, the
MLP and the tied unembedding.  (The decode-shaped ``linear`` is held against
the JAX kernel in test_torch_pim_matvec.py.)  Tolerance rtol 1e-5, atol 1e-5
in f32 unless stated."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import common as jc  # noqa: E402
from repro.serving import quantize_tree as jax_quantize_tree  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402

from torch_helpers import CPU, to_numpy  # noqa: E402


def _quantized(kdim, n, bits, seed=2):
    w = np.random.default_rng(seed).standard_normal((kdim, n)).astype(np.float32)
    jq = jax_quantize_tree({"w": jnp.asarray(w)}, bits=bits)["w"]
    return jq, params_from_numpy(to_numpy(jq), CPU)


@pytest.mark.parametrize("bits,kdim", [(8, 64), (4, 64), (4, 33)])
@pytest.mark.parametrize("rows", [2, 12])
def test_linear_off_matches_jax_off(bits, kdim, rows):
    """The overlay path ``x @ dq(w)`` + bias, decode-shaped and not.  The
    JAX package's "auto" takes it on the CPU (its kernel runs only on a
    TPU there), so only the port's mode is set."""
    assert jax.default_backend() != "tpu"
    jq, tq = _quantized(kdim, 24, bits)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((rows, kdim)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    want = np.asarray(jc.linear(jnp.asarray(x), jq, jnp.asarray(b)))
    prev = tc.set_matvec_dispatch("off")
    try:
        got = tc.linear(torch.from_numpy(x), tq, torch.from_numpy(b)).numpy()
    finally:
        tc.set_matvec_dispatch(prev)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_set_matvec_dispatch_rejects_unknown_mode():
    with pytest.raises(ValueError, match="auto|off|force"):
        tc.set_matvec_dispatch("sometimes")


def test_set_matvec_dispatch_force_is_auto():
    """"force" (the JAX package's name for its off-TPU kernel mode) is
    stored as "auto": the port has one kernel route."""
    prev = tc.set_matvec_dispatch("force")
    try:
        assert tc.set_matvec_dispatch("force") == "auto"
    finally:
        tc.set_matvec_dispatch(prev)


@pytest.mark.parametrize("bits,kdim", [(8, 40), (4, 40), (4, 33)])
def test_dq_and_weight_shape_match_jax(bits, kdim):
    jq, tq = _quantized(kdim, 16, bits)
    assert tc.weight_shape(tq) == tuple(jc.weight_shape(jq))
    np.testing.assert_array_equal(tc.dq(tq).numpy(), np.asarray(jc.dq(jq)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    g = rng.standard_normal((64,)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jc.rmsnorm(jnp.asarray(x, jdt), jnp.asarray(g, jdt), 1e-5)
    got = tc.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), 1e-5)
    tol = 1e-6 if dtype == "float32" else 1e-2  # bf16: one rounding step
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("positions_shape", ["batched", "shared"])
def test_apply_rope_matches_jax(positions_shape):
    """Interleaved pairs (0::2, 1::2), theta as qwen2-1.5b's."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 200, (2, 5)) if positions_shape == "batched"
           else np.arange(5)).astype(np.int32)
    want = jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    got = tc.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mlp_and_unembed_match_jax():
    """SwiGLU on dense weights, and the tied (V, D) table rule."""
    rng = np.random.default_rng(8)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("gate", (32, 48)), ("up", (32, 48)), ("down", (48, 32)))}
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    table = rng.standard_normal((100, 32)).astype(np.float32)
    want = jc.unembed(jc.mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x)),
                      jnp.asarray(table))
    got = tc.unembed(tc.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                  torch.from_numpy(x)), torch.from_numpy(table))
    assert tuple(got.shape) == (2, 3, 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

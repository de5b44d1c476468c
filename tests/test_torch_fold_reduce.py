"""Port parity: ``fold_reduce`` (its plain version, the wrapper on CPU
tensors and ``ops.fold_sum``) against the JAX package's Pallas kernel in
interpret mode and its ``ref`` oracle, bit for bit.  The inputs mix signs
and magnitudes over many orders, so a sum taken in another association
order gives other bits (checked below)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.fold_reduce import fold_reduce as jax_fold_reduce  # noqa: E402
from repro_torch.kernels import fold_reduce, fold_reduce_plain, ops, ref  # noqa: E402


def _x(rows, q, seed):
    rng = np.random.default_rng(seed)
    mag = np.exp(4.0 * rng.standard_normal((rows, q)))
    return (rng.standard_normal((rows, q)) * mag).astype(np.float32)


def _port(x):
    """The port's plain version, wrapper, entry point and oracle on CPU
    tensors."""
    t = torch.from_numpy(x)
    return [fold_reduce_plain(t), fold_reduce(t), ops.fold_sum(t), ref.fold_reduce_ref(t)]


@pytest.mark.parametrize("q", [1, 2, 8, 64, 256])
@pytest.mark.parametrize("rows", [4, 256, 512])
def test_fold_reduce_matches_jax_bit_for_bit(q, rows):
    x = _x(rows, q, seed=rows + q)
    want = np.asarray(jax_fold_reduce(jnp.asarray(x), br=min(rows, 64), interpret=True))
    np.testing.assert_array_equal(np.asarray(jax_ref.fold_reduce_ref(jnp.asarray(x))), want)
    for got in _port(x):
        assert got.dtype == torch.float32 and tuple(got.shape) == (rows,)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows", [1, 7, 300])
def test_fold_reduce_takes_rows_that_fill_no_tile(rows):
    """The JAX kernel's rows % br == 0 is its block shape, not the function:
    the port takes any number of rows, held against the oracle."""
    x = _x(rows, 128, seed=rows)
    want = np.asarray(jax_ref.fold_reduce_ref(jnp.asarray(x)))
    for got in _port(x):
        np.testing.assert_array_equal(got.numpy(), want)


def test_fold_reduce_widens_bf16_on_load_as_jax_does():
    x = _x(64, 32, seed=3)
    want = np.asarray(jax_ops.fold_sum(jnp.asarray(x, jnp.bfloat16), br=16))
    got = fold_reduce(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fold_order_is_visible_in_the_bits():
    """The inputs above can tell association orders apart: adjacent pairs
    (another tree over the same values) and torch.sum differ from the fold."""
    x = torch.from_numpy(_x(256, 64, seed=4))
    fold = fold_reduce(x)
    adj = x
    while adj.shape[1] > 1:
        adj = adj[:, 0::2] + adj[:, 1::2]
    assert not torch.equal(fold, adj[:, 0])
    assert not torch.equal(fold, x.sum(-1))
    torch.testing.assert_close(fold, x.sum(-1), rtol=1e-4, atol=1e-2 * float(x.abs().max()))


@pytest.mark.parametrize("q", [0, 3, 12])
def test_fold_reduce_rejects_q_not_a_power_of_two(q):
    x = np.ones((4, q), np.float32)
    if q:  # the JAX kernel's assert; at q = 0 its power-of-two test passes
        with pytest.raises(AssertionError):
            jax_fold_reduce(jnp.asarray(x), interpret=True)
    for fn in (fold_reduce_plain, fold_reduce, ops.fold_sum, ref.fold_reduce_ref):
        with pytest.raises(ValueError, match="power of two"):
            fn(torch.from_numpy(x))


def test_fold_reduce_counts_kernel_launches_only():
    x = torch.from_numpy(_x(8, 16, seed=5))
    before = fold_reduce.launches
    fold_reduce(x)
    ops.fold_sum(x)
    assert fold_reduce.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        fold_reduce(x.to("meta"))
    assert fold_reduce.launches == before

"""Port parity: ``repro_torch.serving.sampling`` draws the JAX package's
random numbers.

The keys, the 32-bit random bits and the uniforms are integer functions of
the key and must be equal exactly.  The gumbel noise is ``-log(-log(u))`` in
f32, where the two libraries' ``log`` round differently: the port's must be
within one f32 ulp of max(|g|, 1) of the exact value (the outer log of a
value near 1 carries the inner log's rounding as an absolute error of that
size), and within two of JAX's.  Sampled tokens must be equal wherever the
top-2 gap of gumbel + warped logits exceeds 1e-5, far above that rounding.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import sampling as jsampling  # noqa: E402
from repro.serving.engine import sample_logits as jax_sample_logits  # noqa: E402
from repro_torch.serving import sample_logits, sampling  # noqa: E402

SEEDS = (0, 7, 2**31 - 1, -1)
DRAWS = (0, 1, 31, 2**31 - 1)
ROWS = 5
GAP = 1e-5


def jax_keys(seed, idx, tag):
    return jsampling.draw_keys(jax.random.PRNGKey(seed), jnp.arange(ROWS, dtype=jnp.int32),
                               idx, tag)


def as_torch(keys):
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("tag", [sampling.TAG_TOKEN, sampling.TAG_WINDOW])
@pytest.mark.parametrize("seed", SEEDS)
def test_draw_keys_equal_jax_key_data(seed, tag):
    base = sampling.prng_key(seed)
    np.testing.assert_array_equal(base.numpy(), np.asarray(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(sampling.prng_key(np.asarray(jax.random.PRNGKey(seed))),
                                  base)
    rids = torch.arange(ROWS)
    for idx in DRAWS:
        got = sampling.draw_keys(base, rids, torch.tensor(idx), tag)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_keys(seed, idx, tag)))
        assert torch.equal(got, sampling.draw_keys(base, rids, idx, tag))
    per_row = np.array([3, 0, 9, 2**31 - 1, 17], np.int32)
    want = jsampling.draw_keys(jax.random.PRNGKey(seed), jnp.arange(ROWS, dtype=jnp.int32),
                               jnp.asarray(per_row), tag)
    got = sampling.draw_keys(base, rids, torch.from_numpy(per_row), tag)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("data", [0, 1, 12345, 2**32 - 1])
def test_fold_in_equals_jax(data):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.fold_in(key, data))
    np.testing.assert_array_equal(sampling.fold_in(sampling.prng_key(11), data).numpy(), want)


@pytest.mark.parametrize("n", [1, 7, 256, 1000])
def test_random_bits_and_uniform_equal_jax(n):
    keys = jax_keys(3, 5, sampling.TAG_TOKEN)
    bits = np.stack([np.asarray(jax.random.bits(k, (n,))) for k in keys])
    uni = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    np.testing.assert_array_equal(sampling.random_bits(as_torch(keys), n).numpy(),
                                  bits.astype(np.int64))
    got = sampling.uniform(as_torch(keys), n).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, uni)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gumbel_within_one_ulp(seed):
    """The port's gumbel is within one ulp of max(|g|, 1) of the exact
    -log(-log(u)) of the same (bit-identical) uniform.  JAX's f32 log on
    the CPU is off by up to 1.14 ulp against an f64 log on these inputs,
    so the two libraries' noise may differ by two such ulps, never more."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 16)
    n = 4096
    want = np.stack([np.asarray(jax.random.gumbel(k, (n,))) for k in keys])
    tkeys = as_torch(jax.random.key_data(keys))
    got = sampling.gumbel(tkeys, n).numpy()
    tiny = np.finfo(np.float32).tiny
    u = np.maximum(sampling.uniform(tkeys, n).numpy() + tiny, tiny).astype(np.float64)
    exact = -np.log(-np.log(u))
    ulp = np.spacing(np.maximum(np.abs(exact), 1.0).astype(np.float32))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert (np.abs(got - exact) <= ulp).all(), (np.abs(got - exact) / ulp).max()
    assert (np.abs(got - want) <= 2 * ulp).all(), (np.abs(got - want) / ulp).max()


def _tied_logits(b, v, seed):
    """Logits on a grid of quarter steps, so that many are tied."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-12, 12, (b, v)) / 4.0).astype(np.float32)


@pytest.mark.parametrize("temperature", [0.7, 1.0, 1e-9])
@pytest.mark.parametrize("top_k", [0, 1, 5, 64, 67])
def test_warp_logits_equal_jax(top_k, temperature):
    """Ties at the k-th value are kept in both; top_k >= vocab keeps all."""
    lg = _tied_logits(4, 64, seed=top_k)
    want = np.asarray(jsampling.warp_logits(jnp.asarray(lg), jnp.float32(temperature), top_k))
    got = sampling.warp_logits(torch.from_numpy(lg), temperature, top_k)
    np.testing.assert_array_equal(got.numpy(), want)
    t = torch.tensor(temperature, dtype=torch.float32)
    np.testing.assert_array_equal(sampling.warp_logits(torch.from_numpy(lg), t, top_k).numpy(),
                                  want)


def _perturbed_gap(keys, lg, temperature, top_k):
    """Per row, the gap between the two largest gumbel + warped logits (JAX's)."""
    warped = np.asarray(jsampling.warp_logits(jnp.asarray(lg), jnp.float32(temperature), top_k))
    noise = np.stack([np.asarray(jax.random.gumbel(k, (lg.shape[-1],))) for k in keys])
    top = np.sort(noise + warped, axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0]


@pytest.mark.parametrize("top_k", [0, 8, 300])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_rows_equal_jax_where_the_draw_is_not_a_near_tie(seed, top_k):
    b, v, temperature = 64, 256, 0.8
    lg = np.random.default_rng(seed).normal(0, 2, (b, v)).astype(np.float32)
    keys = jsampling.draw_keys(jax.random.PRNGKey(seed), jnp.arange(b, dtype=jnp.int32), 4,
                               sampling.TAG_TOKEN)
    want = np.asarray(jsampling.sample_rows(jnp.asarray(lg), keys, greedy=False,
                                            temperature=jnp.float32(temperature), top_k=top_k))
    got = sampling.sample_rows(torch.from_numpy(lg), as_torch(keys), greedy=False,
                               temperature=temperature, top_k=top_k)
    assert got.dtype == torch.int32 and got.shape == (b,)
    clear = _perturbed_gap(keys, lg, temperature, top_k) > GAP
    assert clear.sum() >= b - 2
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    greedy = sampling.sample_rows(torch.from_numpy(lg), None, greedy=True,
                                  temperature=temperature, top_k=top_k)
    np.testing.assert_array_equal(greedy.numpy(), lg.argmax(-1))


@pytest.mark.parametrize("greedy", [True, False])
def test_sample_logits_equal_jax(greedy):
    """One key for the whole (B, S, V) batch, as the JAX helper draws it."""
    lg = np.random.default_rng(5).normal(0, 2, (3, 2, 128)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax_sample_logits(jnp.asarray(lg), key, greedy=greedy,
                                        temperature=jnp.float32(0.9), top_k=16))
    got = sample_logits(torch.from_numpy(lg), np.asarray(key), greedy=greedy,
                        temperature=0.9, top_k=16)
    assert got.dtype == torch.int32 and got.shape == (3, 2)
    noise = np.asarray(jax.random.gumbel(key, lg.shape))
    warped = np.asarray(jsampling.warp_logits(jnp.asarray(lg), jnp.float32(0.9), 16))
    top = np.sort(noise + warped if not greedy else lg, axis=-1)[..., -2:]
    clear = top[..., 1] - top[..., 0] > GAP
    assert clear.all()
    np.testing.assert_array_equal(got.numpy(), want)

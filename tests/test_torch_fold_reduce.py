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
from repro_torch.kernels.fold_reduce import plan  # noqa: E402


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


# The CUDA kernel's decomposition of the fold (csrc/fold_reduce.cu), emulated
# level by level on the CPU in its index mapping: element i = V * (l + k L) + j
# sits at slot j of lane l's k-th vector, L = S * T lanes a row (T threads
# in each of S CTAs).  An H100 has 132 SMs; the plan depends on it only
# through the cluster split.
SM_COUNT = 132
EMULATED_Q = (1, 2, 4, 64, 128, 256, 4096, 32768)
FOLD_SHAPES = ((6144, 128), (48, 32768))  # chip_smoke.py's fold_sum shapes


def _brev(r, bits):
    return int(format(r, f"0{bits}b")[::-1], 2) if bits else 0


def _own_list(a):
    """(rows, E, L, V) -> (rows, L, V): each lane folds its E vectors, slot
    by slot; up to 8 by halving in registers, beyond in bit-reversed reading
    order, 8 at a time as adjacent pairs, merged on a stack."""
    e = a.shape[1]
    if e <= 8:
        h = e // 2
        while h:
            a = a[:, :h] + a[:, h:2 * h]
            h //= 2
        return a[:, 0]
    bits = e.bit_length() - 1
    stack = []
    for c in range(e // 8):
        v = [a[:, _brev(8 * c + u, bits)] for u in range(8)]
        w = 1
        while w < 8:
            for u in range(0, 8, 2 * w):
                v[u] = v[u] + v[u + w]
            w *= 2
        acc = v[0]
        cc = c
        while cc & 1:
            acc = stack.pop() + acc
            cc >>= 1
        stack.append(acc)
    return stack[0]


def _pair_down(a, d, mispair):
    """Lanes t < d of the last-but-one axis add lane t + d (the others keep
    theirs); ``mispair`` pairs lane 2t with 2t + 1 instead."""
    a = a.clone()
    if mispair:
        a[:, :d] = a[:, 0:2 * d:2] + a[:, 1:2 * d:2]
    else:
        a[:, :d] = a[:, :d] + a[:, d:2 * d]
    return a


def emulate_fold(x, itemsize, mispair_level=None):
    """The kernel's arithmetic on (rows, q) x (f32 values; ``itemsize`` the
    card's element size, which sets the plan): own list, cross-CTA levels
    (distributed shared memory), cross-warp levels (shared memory), shuffle
    levels (__shfl_down_sync within segments of min(T, 32) lanes), in-register
    levels.  ``mispair_level`` (an index into the lane levels, top first)
    plants a fault there.  Returns (rows,) f32."""
    rows, q = x.shape
    pl = plan(rows, q, itemsize, SM_COUNT)
    v, t, s, e = pl
    assert v * t * s * e == q
    a = _own_list(x.reshape(rows, e, s * t, v))           # (rows, L, V)
    lane_levels = []
    a = a.reshape(rows, s, t, v)
    d = s // 2
    while d:                                               # across CTAs: rank r + d
        lane_levels.append(d)
        a = _pair_down(a, d, len(lane_levels) - 1 == mispair_level)
        d //= 2
    a = a[:, 0]                                            # CTA rank 0: (rows, T, V)
    d = t // 2
    while d >= 32:                                         # across warps
        lane_levels.append(d)
        a = _pair_down(a, d, len(lane_levels) - 1 == mispair_level)
        d //= 2
    width = min(t, 32)
    a = a[:, :width]
    d = width // 2
    while d:                                               # shuffles: src t + d inside the segment
        lane_levels.append(d)
        if len(lane_levels) - 1 == mispair_level:
            a = _pair_down(a, d, True)
        else:
            src = torch.tensor([i + d if i + d < width else i for i in range(width)])
            a = a + a[:, src]
        d //= 2
    a = a[:, 0]                                            # lane 0: (rows, V)
    h = v // 2
    while h:                                               # in registers
        a = a[:, :h] + a[:, h:2 * h]
        h //= 2
    return a[:, 0]


def _emulation_cases():
    return ([(rows, q) for rows, q in FOLD_SHAPES]
            + [(3, q) for q in EMULATED_Q] + [(1, 32768), (300, 32768)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,q", _emulation_cases())
def test_kernel_decomposition_is_bit_identical(rows, q, dtype):
    """The CUDA kernel's split of the levels (own list, cluster, warps,
    shuffles, registers, as planned for an H100), emulated with f32 adds,
    equals fold_reduce_plain and the JAX package's Pallas kernel bit for bit."""
    x = torch.from_numpy(_x(rows, q, seed=rows * 7 + q))
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    got = emulate_fold(x.to(torch.float32), x.element_size())
    assert torch.equal(got, fold_reduce_plain(x))
    jx = jnp.asarray(x.to(torch.float32).numpy()).astype(jnp.dtype(dtype))
    want = np.asarray(jax_fold_reduce(jx, br=64 if rows % 64 == 0 else rows, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows,q,level", [(6144, 128, 0), (48, 32768, 0), (48, 32768, 3),
                                          (3, 4096, 2)])
def test_kernel_decomposition_catches_a_mispaired_level(rows, q, level):
    """One lane level that pairs adjacent lanes (2t, 2t + 1) instead of t and
    t + d gives other bits: the comparison above would catch it."""
    x = torch.from_numpy(_x(rows, q, seed=q + level))
    assert torch.equal(emulate_fold(x, 4), fold_reduce_plain(x))
    assert not torch.equal(emulate_fold(x, 4, mispair_level=level), fold_reduce_plain(x))

"""Port parity, the PiCaSO bit-level machine: ``repro_torch.core``'s ISA,
bit-plane conversions, FA/S ALU, Booth multiplier, OpMux folds and
binary-hopping network against ``repro.core``'s, on the CPU.

The same seeded numpy inputs go through both packages, and every integer,
op-code and bit plane must be equal, with its dtype: no tolerance.  The
reference's own cases (``tests/test_core_alu.py``) are mirrored against
their integer oracles too.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import OpCode  # noqa: E402
from torch_helpers import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

OPS = [OpCode.ADD, OpCode.SUB, OpCode.CPX, OpCode.CPY]


def _rand_ints(rng, n, width):
    lo, hi = -(1 << (width - 1)), 1 << (width - 1)
    return rng.integers(lo, hi, size=n, dtype=np.int64)


def _equal(got, want):
    """A port tensor equal to a JAX array: values, shape and dtype."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _bits(rng, shape):
    return rng.integers(0, 2, size=shape).astype(np.uint8)


# ------------------------------------------------------------------- isa ----
def test_booth_decode_and_every_encoder_configuration():
    pairs = np.random.default_rng(0).integers(0, 4, size=64).astype(np.int32)
    _equal(core.booth_decode(torch.from_numpy(pairs)), jcore.booth_decode(jnp.asarray(pairs)))
    assert [int(v) for v in core.booth_decode(torch.tensor([0b00, 0b01, 0b10, 0b11]))] == [
        OpCode.CPX, OpCode.ADD, OpCode.SUB, OpCode.CPX]
    for conf in range(8):
        _equal(core.encode(conf, torch.from_numpy(pairs)), jcore.encode(conf, jnp.asarray(pairs)))


# ---------------------------------------------------------------- bitops ----
EDGES = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**31, 2**32 + 5, -2**31 - 1, 2**40 - 3],
                 dtype=np.int64)


@pytest.mark.parametrize("width", list(range(1, 35)))
def test_to_bits_from_bits_sign_extend(width):
    """Widths 1 to 32 (and 33, 34 for ``to_bits``), the width's and int32's
    edges and values past int32, which both packages wrap to int32 first;
    ``from_bits`` over those planes and random ones."""
    rng = np.random.default_rng(width)
    lo, hi = -(1 << (width - 1)), 1 << (width - 1)
    vals = np.concatenate([_rand_ints(rng, 40, width), [lo, hi - 1, lo + 1, hi], EDGES])
    bits = core.to_bits(torch.from_numpy(vals), width)
    _equal(bits, jcore.to_bits(vals, width))
    assert torch.equal(core.corner_turn(torch.from_numpy(vals), width), bits)
    if width > 32:
        with pytest.raises(ValueError):
            core.from_bits(bits)
        return
    planes = np.concatenate([bits.numpy(), _bits(rng, (64, width))])
    for signed in (True, False):
        got = core.from_bits(torch.from_numpy(planes), signed=signed)
        _equal(got, jcore.from_bits(jnp.asarray(planes), signed=signed))
        assert torch.equal(core.corner_turn_inverse(torch.from_numpy(planes), signed=signed), got)
    in_range = vals[(vals >= lo) & (vals < hi)]
    np.testing.assert_array_equal(core.from_bits(core.to_bits(torch.from_numpy(in_range),
                                                              width)).numpy(), in_range)
    for to in (max(width - 1, 1), width + 3):
        _equal(core.sign_extend_bits(torch.from_numpy(planes), to),
               jcore.sign_extend_bits(jnp.asarray(planes), to))


@settings(max_examples=25, deadline=None)
@given(st.integers(-(2**15), 2**15 - 1), st.integers(2, 8))
def test_bits_roundtrip(v, extra):
    width = 16
    bits = core.to_bits(torch.tensor([v]), width)
    assert int(core.from_bits(bits)[0]) == v
    ext = core.sign_extend_bits(bits, width + extra)
    assert int(core.from_bits(ext)[0]) == v


# ------------------------------------------------------------------- ALU ----
@pytest.mark.parametrize("width", [4, 8, 16])
@pytest.mark.parametrize("op", OPS)
def test_serial_alu_ops(width, op):
    rng = np.random.default_rng(width * 10 + int(op))
    x, y = _rand_ints(rng, 64, width), _rand_ints(rng, 64, width)
    xb, yb = core.to_bits(torch.from_numpy(x), width), core.to_bits(torch.from_numpy(y), width)
    ops = np.full((64,), int(op), dtype=np.int32)
    s, c = core.serial_alu(xb, yb, torch.from_numpy(ops))
    js, jc = jcore.serial_alu(jnp.asarray(xb.numpy()), jnp.asarray(yb.numpy()), jnp.asarray(ops))
    _equal(s, js)
    _equal(c, jc)
    mod = 1 << width
    want = {OpCode.ADD: x + y, OpCode.SUB: x - y, OpCode.CPX: x, OpCode.CPY: y}[op]
    np.testing.assert_array_equal(core.from_bits(s).numpy() % mod, want % mod)


def test_serial_alu_per_lane_op_codes():
    """Per-lane op-codes (as Booth's encoder issues them) work in one pass."""
    width = 8
    s, _ = core.serial_alu(core.to_bits(torch.tensor([10] * 4), width),
                           core.to_bits(torch.tensor([3] * 4), width),
                           torch.tensor([int(o) for o in OPS], dtype=torch.int32))
    np.testing.assert_array_equal(core.from_bits(s).numpy(), [13, 7, 10, 3])
    rng = np.random.default_rng(5)
    xb, yb = _bits(rng, (96, 12)), _bits(rng, (96, 12))
    ops = rng.integers(0, 4, size=96).astype(np.int32)
    s, c = core.serial_alu(torch.from_numpy(xb), torch.from_numpy(yb), torch.from_numpy(ops))
    js, jc = jcore.serial_alu(jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(ops))
    _equal(s, js)
    _equal(c, jc)
    assert core.alu_cycles(12) == jcore.alu_cycles(12) and core.alu_cycles(5, 1) == 5


# ----------------------------------------------------------------- Booth ----
@pytest.mark.parametrize("width", [4, 6, 8, 12, 16])
def test_booth_multiply_matches_jax_and_the_integer_product(width):
    rng = np.random.default_rng(width)
    x, y = _rand_ints(rng, 128, width), _rand_ints(rng, 128, width)
    xb, yb = core.to_bits(torch.from_numpy(x), width), core.to_bits(torch.from_numpy(y), width)
    if width in (4, 8, 16):
        _equal(core.booth_multiply_bits(xb, yb),
               jcore.booth_multiply_bits(jnp.asarray(xb.numpy()), jnp.asarray(yb.numpy())))
    np.testing.assert_array_equal(core.booth_multiply(x, y, width).numpy(), x * y)
    assert core.booth_cycles(width) == jcore.booth_cycles(width)


@settings(max_examples=30, deadline=None)
@given(st.integers(-128, 127), st.integers(-128, 127))
def test_booth_multiply_property(a, b):
    assert int(core.booth_multiply(torch.tensor([a]), torch.tensor([b]), 8)[0]) == a * b


@pytest.mark.parametrize("width", [4, 8, 16])
def test_booth_nop_fraction(width):
    """A 0-d float32 equal to JAX's; near half on random multipliers (§V-B)."""
    y = _rand_ints(np.random.default_rng(7), 4096, width)
    got = core.booth_nop_fraction(torch.from_numpy(y), width)
    assert got.dtype == torch.float32 and got.dim() == 0
    want = jcore.booth_nop_fraction(jnp.asarray(y), width)
    assert got.item() == float(want)
    assert 0.40 < got.item() < 0.60


# ----------------------------------------------------------------- OpMux ----
@pytest.mark.parametrize("block", [8, 16, 32])
@pytest.mark.parametrize("pattern", ["a", "b"])
def test_fold_operand_and_fold_reduce_block(block, pattern):
    levels = int(np.log2(block))
    for level in range(1, levels + 1):
        np.testing.assert_array_equal(core.fold_source_index(block, level, pattern),
                                      jcore.fold_source_index(block, level, pattern))
    rng = np.random.default_rng(block)
    width = 16  # headroom included
    vals = rng.integers(-200, 200, size=block)
    bits = core.to_bits(torch.from_numpy(vals), width)
    jbits = jnp.asarray(bits.numpy())
    stacked = _bits(rng, (3, block, 9))  # (blocks, PEs, width), as the simulator folds
    for level in range(1, levels + 1):
        _equal(core.fold_operand(bits, level, pattern), jcore.fold_operand(jbits, level, pattern))
        _equal(core.fold_operand(torch.from_numpy(stacked), level, pattern),
               jcore.fold_operand(jnp.asarray(stacked), level, pattern))
    out = core.fold_reduce_block(bits, pattern=pattern)
    _equal(out, jcore.fold_reduce_block(jbits, pattern=pattern))
    assert int(core.from_bits(out)[0]) == int(vals.sum())
    assert core.opmux.fold_reduce_cycles(block, width) == jcore.opmux.fold_reduce_cycles(
        block, width)


def test_fold_source_index_table3_and_errors():
    """A-FOLD-1..4 for a 16-PE block (Table III: H2, Q2, HQ2, HHQ2), Fig 2(b)."""
    assert list(core.fold_source_index(16, 1)[:8]) == list(range(8, 16))
    assert list(core.fold_source_index(16, 4)[:1]) == [1]
    assert all(s == -1 for s in core.fold_source_index(16, 4)[1:])
    assert list(core.fold_source_index(8, 1, pattern="b")[::2]) == [1, 3, 5, 7]
    with pytest.raises(ValueError, match="too deep"):
        core.fold_source_index(16, 5)
    with pytest.raises(ValueError, match="pattern"):
        core.fold_source_index(16, 1, pattern="c")
    y = core.fold_operand(core.to_bits(torch.arange(16), 8), 1)
    np.testing.assert_array_equal(core.from_bits(y[8:]).numpy(), np.zeros(8))
    np.testing.assert_array_equal(core.from_bits(y[:8]).numpy(), np.arange(8, 16))


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(-100, 100), min_size=16, max_size=16))
def test_fold_reduce_property(vals):
    out = core.fold_reduce_block(core.to_bits(torch.tensor(vals), 16))
    assert int(core.from_bits(out)[0]) == sum(vals)


# --------------------------------------------------------------- network ----
def test_node_roles_match_jax():
    for n in range(1, 17):
        for level in range(5):
            assert core.node_roles(n, level) == jcore.node_roles(n, level), (n, level)
    roles = core.node_roles(8, 1)
    assert roles[0] == "R" and roles[2] == "T" and roles[1] == "P"
    for n in (1, 2, 3, 16, 48, 4032):
        assert core.network_levels(n) == jcore.network_levels(n)
        assert core.network.network_jump_cycles(n) == jcore.network.network_jump_cycles(n)


@pytest.mark.parametrize("n_blocks", [2, 3, 4, 5, 7, 8, 11, 16])
def test_network_reduce_bits(n_blocks):
    """Block counts from 2 to 16: the same state as JAX's, the input
    left as it was and a new tensor returned; powers of two sum exactly."""
    rng = np.random.default_rng(n_blocks)
    vals = rng.integers(-1000, 1000, size=n_blocks)
    bits = core.to_bits(torch.from_numpy(vals), 20)
    before = bits.clone()
    out = core.network_reduce_bits(bits)
    _equal(out, jcore.network_reduce_bits(jnp.asarray(bits.numpy())))
    assert torch.equal(bits, before) and out.data_ptr() != bits.data_ptr()
    if n_blocks & (n_blocks - 1) == 0:
        assert int(core.from_bits(out)[0]) == int(vals.sum())


def test_network_reduce_leaves_a_view_unchanged():
    """The simulator hands a view of its register file to the network."""
    rf = core.to_bits(torch.arange(-8, 8).reshape(8, 2), 12).permute(0, 2, 1)  # (8, 12, 2)
    before = rf.clone()
    lane0 = rf[:, :, 0]
    out = core.network_reduce_bits(lane0)
    assert torch.equal(rf, before)
    assert int(core.from_bits(out)[0]) == int(torch.arange(-8, 8).reshape(8, 2)[:, 0].sum())

"""Port parity, the PiCaSO array simulator: ``repro_torch.core``'s
``PicasoArray``, ``simulate_dot_product``, ``simulate_matvec`` and
``matvec_cycles`` against ``repro.core``'s, on the CPU.

The same seeded numpy inputs drive both packages' arrays instruction by
instruction: the whole register file and the cycle counter must be equal
after each step.  The dot products and the matvec must give the same values
and cycles, and the oracle's limits must show in both packages alike: a
block count that is not a power of two drops the blocks past the last
power of two from the network's sum, and an accumulator wider than 32 bits
raises.  Each JAX simulator call compiles its scans, so the JAX runs are
made once per module and kept.
"""
import numpy as np
import pytest
from hypothesis import given, strategies as st

torch = pytest.importorskip("torch")

from repro.core import OpCode as JOpCode  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core import mapping as jmapping  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core.bitops import sign_extend_bits as jsign_extend  # noqa: E402
from repro_torch.core import OpCode, costmodel as cm, mapping, simulator  # noqa: E402
from repro_torch.core.bitops import sign_extend_bits  # noqa: E402
from torch_helpers import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = torch.device("cpu")
RF_DEPTH = 96
# (name, method, args): x at 0, w at 8, their sum at 16 and difference at
# 24, the product at 32 sign-extended to 21 bits (16 + 4 guard bits + 1),
# folded and sent over the network; a second product at 56 accumulated as a
# row; 12-bit values at 80 folded by pattern (b).
PROGRAM = (
    ("write x", "write_operands", (0, "x", 8)),
    ("write w", "write_operands", (8, "w", 8)),
    ("add", "alu_op", ("ADD", 0, 8, 16, 8)),
    ("sub", "alu_op", ("SUB", 0, 8, 24, 8)),
    ("mult", "mult", (0, 8, 32, 8)),
    ("extend", "extend", (32, 16, 21)),
    ("fold", "fold_accumulate", (32, 21)),
    ("network", "network_accumulate", (32, 21)),
    ("mult 2", "mult", (8, 0, 56, 8)),
    ("extend 2", "extend", (56, 16, 21)),
    ("accumulate row", "accumulate_row", (56, 21)),
    ("write v", "write_operands", (80, "v", 12)),
    ("fold b", "fold_accumulate", (80, 12, "b")),
)
N_BLOCKS = (4, 3)  # a power of two, and a count the network reduces short


def _operands(n_blocks):
    rng = np.random.default_rng(n_blocks)
    return {"x": rng.integers(-128, 128, size=(n_blocks, 16)),
            "w": rng.integers(-128, 128, size=(n_blocks, 16)),
            "v": rng.integers(-120, 120, size=(n_blocks, 16))}


def _run(arr, step, operands, jax_side):
    _, method, args = step
    if method == "extend":
        addr, cur, to = args
        extend = jsign_extend if jax_side else sign_extend_bits
        arr._store(addr, extend(arr._slice(addr, cur), to))
        return
    if method == "write_operands":
        addr, key, width = args
        values = operands[key]
        arr.write_operands(addr, values if jax_side else torch.from_numpy(values), width)
        return
    if method == "alu_op":
        args = ((JOpCode if jax_side else OpCode)[args[0]],) + args[1:]
    getattr(arr, method)(*args)


@pytest.fixture(scope="module")
def jax_states():
    """Each step's register file and cycle count in the JAX package's array."""
    out = {}
    for n_blocks in N_BLOCKS:
        arr = jsim.PicasoArray(n_blocks=n_blocks, rf_depth=RF_DEPTH)
        ops = _operands(n_blocks)
        for step in PROGRAM:
            _run(arr, step, ops, True)
            out[n_blocks, step[0]] = (np.asarray(arr.rf), arr.cycles)
    return out


@pytest.mark.parametrize("n_blocks", N_BLOCKS)
@pytest.mark.parametrize("upto", range(len(PROGRAM)), ids=[s[0] for s in PROGRAM])
def test_picaso_array_instruction_by_instruction(jax_states, n_blocks, upto):
    arr = simulator.PicasoArray(n_blocks=n_blocks, rf_depth=RF_DEPTH, device="cpu")
    assert arr.rf.dtype == torch.uint8 and arr.num_pes == 16 * n_blocks
    ops = _operands(n_blocks)
    for step in PROGRAM[:upto + 1]:
        _run(arr, step, ops, False)
    rf, cycles = jax_states[n_blocks, PROGRAM[upto][0]]
    np.testing.assert_array_equal(arr.rf.numpy(), rf)
    assert arr.rf.dtype == torch.uint8 and arr.cycles == cycles


def test_picaso_array_reads_and_values():
    """The values the program leaves, against int64 oracles."""
    n_blocks = 4
    arr = simulator.PicasoArray(n_blocks=n_blocks, rf_depth=RF_DEPTH, device=CPU)
    ops = _operands(n_blocks)
    for step in PROGRAM:
        _run(arr, step, ops, False)
    x, w, v = ops["x"], ops["w"], ops["v"]
    wrap8 = lambda a: (a + 128) % 256 - 128  # noqa: E731
    np.testing.assert_array_equal(arr.read_operands(16, 8).numpy(), wrap8(x + w))
    np.testing.assert_array_equal(arr.read_operands(24, 8).numpy(), wrap8(x - w))
    assert int(arr.result_scalar(32, 21)) == int((x * w).sum())
    assert int(arr.result_scalar(56, 21)) == int((x * w).sum())
    # the network's transmitters at level 0 (odd blocks) keep their own sums
    np.testing.assert_array_equal(arr.read_operands(32, 21)[1::2, 0].numpy(),
                                  (x * w).sum(1)[1::2])
    np.testing.assert_array_equal(arr.read_operands(80, 12)[:, 0].numpy(), v.sum(1))
    assert arr.read_operands(0, 8, signed=False).dtype == torch.int32


DOT_CASES = [(16, 8), (32, 8), (64, 8), (128, 8), (16, 4)]


@pytest.fixture(scope="module")
def jax_dots():
    out = {}
    for q, width in DOT_CASES:
        rng = np.random.default_rng(q + width)
        lo, hi = -(1 << (width - 1)), 1 << (width - 1)
        x, w = rng.integers(lo, hi, size=q), rng.integers(lo, hi, size=q)
        out[q, width] = (x, w, jsim.simulate_dot_product(x, w, width))
    return out


@pytest.mark.parametrize("q,width", DOT_CASES)
def test_simulate_dot_product(jax_dots, q, width):
    x, w, want = jax_dots[q, width]
    got = simulator.simulate_dot_product(x, w, width, device="cpu")
    assert got == want
    assert got[0] == int(np.dot(x.astype(np.int64), w.astype(np.int64)))
    acc_w = 2 * width + cm.log2i(q) + 1
    assert got[1] == cm.mult_cycles_overlay(width) + cm.accum_cycles_picaso(q, acc_w)


def test_oracle_limit_blocks_past_a_power_of_two_are_dropped():
    """48 values are 3 blocks: the network runs int(log2(3)) = 1 level, so
    block 2's sum is never added, in both packages alike (the cycle model
    charges log2i(48) = 6, two network jumps).  If either package is fixed
    one day, this test shows it."""
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, size=48)
    w = rng.integers(-128, 128, size=48)
    want = jsim.simulate_dot_product(x, w, 8)
    got = simulator.simulate_dot_product(x, w, 8, device="cpu")
    assert got == want == (-19366, 308)
    assert int(np.dot(x, w)) == -17676 != got[0]


def test_oracle_limit_accumulators_past_32_bits_raise():
    """16-bit operands at q = 32 need a 38-bit accumulator: from_bits
    refuses it in both packages."""
    rng = np.random.default_rng(1)
    x = rng.integers(-2**15, 2**15, size=32)
    w = rng.integers(-2**15, 2**15, size=32)
    with pytest.raises(ValueError, match="up to 32"):
        jsim.simulate_dot_product(x, w, 16)
    with pytest.raises(ValueError, match="up to 32"):
        simulator.simulate_dot_product(x, w, 16, device="cpu")


def test_simulate_matvec():
    rng = np.random.default_rng(11)
    w = rng.integers(-128, 128, size=(4, 64))
    x = rng.integers(-128, 128, size=64)
    vals, cycles = mapping.simulate_matvec(w, x, 8, device="cpu")
    jvals, jcycles = jmapping.simulate_matvec(w, x, 8)
    assert vals.dtype == jvals.dtype == np.int64
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(vals, w.astype(np.int64) @ x.astype(np.int64))
    assert cycles == jcycles == mapping.matvec_cycles(4, 64, 8, total_pes=256)


@pytest.mark.parametrize("booth_avg", [False, True])
def test_matvec_cycles_over_the_property_grid(booth_avg):
    for m in range(1, 65):
        for k in (32, 64, 128, 256, 512, 1024, 2048):
            for n in (4, 8, 16, 32):
                for total in (k, 4 * k, 64_512, 32_768, max(m * k, k)):
                    assert mapping.matvec_cycles(m, k, n, total, booth_avg) == \
                        jmapping.matvec_cycles(m, k, n, total, booth_avg), (m, k, n, total)


@given(m=st.integers(1, 64), k=st.integers(1, 7).map(lambda e: 2**e * 16),
       n=st.sampled_from([4, 8, 16, 32]))
def test_matvec_cycles_scales_with_waves(m, k, n):
    one = mapping.matvec_cycles(1, k, n, total_pes=k)
    assert mapping.matvec_cycles(m, k, n, total_pes=k) == m * one
    assert jcm.accum_cycles_picaso(k, n) == cm.accum_cycles_picaso(k, n)

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
from repro_torch.kernels.pim_matvec import (  # noqa: E402
    MAX_CLUSTER, MMA_N, STAGE_BYTES, X_PAD, XS_BYTES, plan, staged_k)
from repro_torch.models import common as tc  # noqa: E402
from repro_torch.quant import unpack_int4  # noqa: E402

from torch_helpers import CPU, ldmatrix_x4, mma_m16n8k16, to_numpy  # noqa: E402
from torch_helpers import bf16_from_bits as _bf16  # noqa: E402
from torch_helpers import widen_int4 as _widen_int4  # noqa: E402
from torch_helpers import widen_int8 as _widen_int8  # noqa: E402
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

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


# qwen2-1.5b's seven decode linears, (K, N): wq, wk, wv, wo, gate, up, down.
QWEN2_LINEARS = {"wq": (1536, 1536), "wk": (1536, 256), "wv": (1536, 256),
                 "wo": (1536, 1536), "gate": (1536, 8960), "up": (1536, 8960),
                 "down": (8960, 1536)}
SM_COUNT = 132  # an H100 SXM
DECODE_M = 4  # the decode path's batch


def _check_plan(k, n, m, bits, sm_count, x_planes=1):
    """The kernel's plan for an (M, K) x (K, N) product: a cluster of at
    most 8 that divides the grid, every code row in exactly one CTA's K
    slice (none empty), every column and x row covered, the staged x chunk
    within the kernel's shared memory.  Returns the plan."""
    rows = k * bits // 8
    pl = plan(rows, n, m, bits, sm_count, x_planes)
    grid = (pl.cluster, pl.col_tiles, pl.m_groups)
    assert 1 <= pl.cluster <= MAX_CLUSTER and grid[0] % pl.cluster == 0
    covered = np.zeros(rows, np.int64)
    for rank in range(pl.cluster):
        lo, hi = rank * pl.rows_per_cta, min((rank + 1) * pl.rows_per_cta, rows)
        assert lo < hi, f"rank {rank} has an empty K slice"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert pl.tile_n in (32, 64, 128) and pl.col_tiles * pl.tile_n >= n > (pl.col_tiles - 1) * pl.tile_n
    assert pl.m_rows in (1, 2, 4, 8) and pl.m_groups * pl.m_rows >= m > (pl.m_groups - 1) * pl.m_rows
    assert 1 <= pl.chunk_rows <= pl.rows_per_cta
    assert pl.stage_rows % 16 == 0 and 16 <= pl.stage_rows and pl.stage_rows * pl.tile_n <= STAGE_BYTES
    assert x_planes * MMA_N * (staged_k(pl.chunk_rows, pl.stage_rows, bits) + X_PAD) * 2 <= XS_BYTES
    assert pl.ctas == pl.cluster * pl.col_tiles * pl.m_groups
    return pl


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", list(QWEN2_LINEARS))
def test_plan_covers_every_row_once_at_full_width(name, bits):
    """The plan at qwen2-1.5b's seven decode linears and the decode path's
    M = 4, for bf16 x (the path's) and f32 x: every code row once, and
    enough CTAs for every SM of an H100."""
    k, n = QWEN2_LINEARS[name]
    for x_planes in (1, 3):
        pl = _check_plan(k, n, DECODE_M, bits, SM_COUNT, x_planes)
        assert pl.ctas >= SM_COUNT, pl


@pytest.mark.parametrize("k,n,m", [(34, 24, 1), (100, 30, 3), (192, 100, 8), (64, 32, 5),
                                   (1536, 1536, 1), (8960, 256, 8), (2, 16, 2)])
@pytest.mark.parametrize("bits", [8, 4])
def test_plan_covers_every_row_once(k, n, m, bits):
    """Small and ragged shapes, and full-width ones at other M."""
    for x_planes in (1, 3):
        _check_plan(k, n, m, bits, SM_COUNT, x_planes)


def test_code_widening_is_exact():
    """Every int8 code in every byte of a register widens to its exact value
    (int8 through the 2^23 magic and bf16's high half), and every int4
    nibble too (through the bf16 magic): the kernel's A operands are the
    codes, exactly."""
    codes = np.arange(-128, 128, dtype=np.int8)
    for slot in range(4):
        reg = codes.view(np.uint8).astype(np.uint32) << np.uint32(8 * slot)
        np.testing.assert_array_equal(_widen_int8(reg)[slot], codes.astype(np.float32))
        unpacked = unpack_int4(torch.from_numpy(codes.copy()).reshape(1, -1)).numpy()
        lo, hi = _widen_int4(reg)[slot]
        np.testing.assert_array_equal(lo, unpacked[0].astype(np.float32))
        np.testing.assert_array_equal(hi, unpacked[1].astype(np.float32))


@pytest.mark.parametrize("bits", [8, 4])
def test_tensor_core_step_maps_codes_and_x(bits):
    """One warp's step of the kernel, emulated lane by lane in its index
    mapping: ldmatrix.trans of a 16-row x 32-column unit of codes (int8 rows,
    or packed int4 rows), the widening into A fragments, x's B fragments from
    the staged bf16 rows, two (int8) or four (int4) mma.m16n8k16, and D's
    lanes back to (column, x row): the 32 columns x 8 x rows of
    x @ codes for that unit."""
    rng = np.random.default_rng(bits)
    rows = 16
    codes = rng.integers(-128 if bits == 8 else -8, 128 if bits == 8 else 8,
                         size=(rows * (8 // bits), 32)).astype(np.int8)
    packed = codes if bits == 8 else jax_pack_int4(jnp.asarray(codes))
    tile = np.asarray(packed).view(np.uint8)
    x = rng.standard_normal((8, codes.shape[0])).astype(np.float32)
    xs = _bf16((x.view(np.uint32) >> np.uint32(16)).astype(np.uint16))  # bf16 x, truncated
    # mrow / mcol of the kernel, unit 0, warp column group 0
    regs = ldmatrix_x4(tile.view(np.uint16),
                       lambda L: (((L >> 3) & 1) * 8 + (L & 7), (L >> 4) * 8), trans=True)
    acc = np.zeros((2, 32, 4))
    if bits == 8:
        a = np.zeros((2, 32, 4, 2))
        for grp, (r_lo, r_hi) in enumerate(((0, 1), (2, 3))):
            for reg, slot in ((r_lo, 0), (r_hi, 2)):
                b0, b1, b2, b3 = _widen_int8(regs[:, reg])
                a[grp, :, slot] = np.stack([b0, b2], 1)      # column 2g: k, k + 1
                a[grp, :, slot + 1] = np.stack([b1, b3], 1)  # column 2g + 1
        bfrag = np.zeros((32, 2, 2))
        for i in range(32):
            t, g = i % 4, i // 4
            bfrag[i, 0] = xs[g, 2 * t:2 * t + 2]
            bfrag[i, 1] = xs[g, 2 * t + 8:2 * t + 10]
        for grp in range(2):
            acc[grp] += mma_m16n8k16(a[grp], bfrag)
    else:
        a = np.zeros((4, 32, 4, 2))
        for r in range(4):
            for j, (lo, hi) in enumerate(_widen_int4(regs[:, r])):
                a[r, :, j] = np.stack([lo, hi], 1)
        b_lo, b_hi = np.zeros((32, 2, 2)), np.zeros((32, 2, 2))
        for i in range(32):
            t, g = i % 4, i // 4
            b_lo[i] = xs[g, 4 * t:4 * t + 4].reshape(2, 2)
            b_hi[i] = xs[g, 16 + 4 * t:16 + 4 * t + 4].reshape(2, 2)
        acc[0] += mma_m16n8k16(a[0], b_lo) + mma_m16n8k16(a[1], b_hi)
        acc[1] += mma_m16n8k16(a[2], b_lo) + mma_m16n8k16(a[3], b_hi)
    got = np.zeros((8, 32))
    for grp in range(2):
        for i in range(32):
            t, g = i % 4, i // 4
            for reg in range(4):
                got[2 * t + (reg & 1), grp * 16 + 2 * g + (reg >> 1)] = acc[grp, i, reg]
    want = xs.astype(np.float64) @ codes.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


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

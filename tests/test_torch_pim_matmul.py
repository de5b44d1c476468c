"""Port parity: ``pim_matmul`` (its plain version, and the wrapper on CPU
tensors) against the JAX package's Pallas kernel in interpret mode, on the
pad-to-tile shapes of tests/test_kernels.py, and the port's ``ref`` oracles
against the JAX package's.  Tolerance rtol 1e-5, atol 1e-4: f32 sums of the
same products in another order."""
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.pim_matmul import pim_matmul as jax_pim_matmul  # noqa: E402
from repro.quant import pack_int4 as jax_pack_int4  # noqa: E402
from repro.quant import quantize_symmetric as jax_quantize  # noqa: E402
from repro_torch.kernels import pim_matmul, pim_matmul_plain, ref  # noqa: E402

from torch_helpers import (  # noqa: E402
    bf16_bits, bf16_from_bits, bf16_pair, ldmatrix_x4, mma_m16n8k16, widen_int4_row,
    widen_int8_row)

mm = importlib.import_module("repro_torch.kernels.pim_matmul")

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


# ---- The tensor-core kernel's plan and arithmetic (csrc/pim_gemm.cuh) ------
# qwen2-1.5b's prefill linears (K, N): wq/wo, wk/wv, gate/up, down; and the
# ragged shapes chip_smoke.py holds the kernel to, with their M.
QWEN2_SHAPES = {"wq": (1536, 1536), "wk": (1536, 256), "gate": (1536, 8960),
                "down": (8960, 1536)}
RAGGED = {"ragged130": (130, 1000, 300), "ragged7": (7, 1000, 300)}
SM_COUNT = 132  # an H100 SXM
SMEM_MAX = 232448  # shared memory a block may have (pim_gemm.cuh:kSmemMax)
PLAN_CASES = ([(name, m, k, n) for name, (k, n) in QWEN2_SHAPES.items() for m in (9, 512)]
              + [(name, m, k, n) for name, (m, k, n) in RAGGED.items()])


def _smem(pl, code_stages, code_bytes, x_stages):
    """pim_gemm.cuh:smem_bytes for a plan."""
    ring = (code_stages * code_bytes + x_stages * pl.tile_m * (mm.STAGE_K + 8) * 2
            + 3 * mm.STAGE_K * (pl.tile_n + 8) * 2)
    return max(ring, pl.tile_m * (pl.tile_n + 4) * 4)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name,m,k,n", PLAN_CASES)
def test_plan_covers_every_output_and_k_once(name, m, k, n, bits):
    """The bf16 plan: a CTA shape the kernel is built for; every x row, every
    column and every K value in exactly one tile, row tile, column tile and
    cluster rank's slice (whole 32-K stages, none empty); every output row
    finished by exactly one rank of its cluster; shared memory within the
    block's limit for both kernels (B = 8 planes for the bit-plane one); and,
    at the prefill's M = 512, a CTA for every SM."""
    pl = mm.plan(m, k, n, bits, torch.bfloat16, SM_COUNT)
    assert (pl.tile_n, pl.tile_m) in mm.TILES and pl.cluster in mm.CLUSTERS
    assert pl.k_per_cta % mm.STAGE_K == 0 and pl.tile_m % pl.cluster == 0
    k_seen = np.zeros(k, np.int64)
    for lo, hi in pl.k_slices(k):
        assert lo < hi, f"an empty K slice: {pl}"
        k_seen[lo:hi] += 1
    assert (k_seen == 1).all()
    rows, cols = np.zeros(m, np.int64), np.zeros(n, np.int64)
    for r in range(pl.row_tiles):
        owners = np.zeros(pl.tile_m, np.int64)
        for rank in range(pl.cluster):
            share = pl.tile_m // pl.cluster
            owners[rank * share:(rank + 1) * share] += 1
        assert (owners == 1).all()
        rows[r * pl.tile_m:(r + 1) * pl.tile_m] += 1
    for c in range(pl.col_tiles):
        cols[c * pl.tile_n:(c + 1) * pl.tile_n] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert pl.row_tiles * pl.tile_m < m + pl.tile_m and pl.col_tiles * pl.tile_n < n + pl.tile_n
    rows_per_stage = mm.STAGE_K // 2 if bits == 4 else mm.STAGE_K
    assert _smem(pl, 3, rows_per_stage * (pl.tile_n + 16), 5) <= SMEM_MAX
    assert _smem(pl, 2, 8 * mm.STAGE_K * (pl.tile_n + 16), 4) <= SMEM_MAX
    if m == 512:
        assert pl.ctas >= SM_COUNT, pl


def test_plan_f32_x_is_the_cuda_core_routes():
    """f32 x keeps the first port's CUDA-core body: 64 x 64 tiles, all of K."""
    pl = mm.plan(512, 8960, 1536, 8, torch.float32, SM_COUNT)
    assert (pl.tile_n, pl.tile_m, pl.cluster) == (64, 64, 1)
    assert pl.k_slices(8960) == [(0, 8960)]


@pytest.mark.parametrize("m", [1, 9, 512])
def test_plan_is_one_the_launcher_runs_at_every_k(m):
    """At every K of 1 to 300 stages of 32 values (and K one past each),
    against 256, 896 and 1536 columns, the bf16 plan meets the launcher's
    pim_gemm.cuh:plan_ok: a cluster of 1, 2, 4 or 8 dividing the tile's
    rows, and every rank's K slice non-empty and whole stages.  K = 896
    (qwen2-0.5b's width) is 28 stages, which 8 ranks of 4 cannot split with
    a stage for each."""
    for k_stages in range(1, 301):
        for k in (k_stages * mm.STAGE_K, k_stages * mm.STAGE_K + 1):
            for n in (256, 896, 1536):
                pl = mm.plan(m, k, n, 8, torch.bfloat16, SM_COUNT)
                assert pl.cluster in (1, 2, 4, 8), (m, k, n, pl)
                assert pl.tile_m % pl.cluster == 0, (m, k, n, pl)
                assert pl.k_per_cta >= mm.STAGE_K and pl.k_per_cta % mm.STAGE_K == 0
                assert pl.cluster * pl.k_per_cta >= k > (pl.cluster - 1) * pl.k_per_cta, \
                    (m, k, n, pl)


def _word(codes4):
    """Four int8 codes as the little-endian uint32 word the kernel reads."""
    return np.asarray(codes4, np.int8).view(np.uint32)[0]


@pytest.mark.parametrize("bits", [8, 4])
def test_tensor_core_step_maps_codes_and_x(bits):
    """One warp's k16 step of the shared main loop, emulated lane by lane in
    its index mapping (warp 0 of a 64-column x 32-row warp tile): the stage's
    code words widened along their rows into the bf16 tile [k][n]
    (widen_int8_row, or widen_int4_row's two K rows a packed row), A's
    fragments from it by ldmatrix.trans, B's from x's [m][k] rows by
    ldmatrix, mma.m16n8k16 per 16-column group and 8-row group, and D's lanes
    back to (x row, column): x @ codes for those 64 columns and 32 rows."""
    rng = np.random.default_rng(bits)
    lo_code, hi_code = (-128, 128) if bits == 8 else (-8, 8)
    codes = rng.integers(lo_code, hi_code, size=(16, 64)).astype(np.int8)
    stored = codes if bits == 8 else np.asarray(jax_pack_int4(jnp.asarray(codes)))
    # The widening, word by word, into the bf16 tile (uint16 bit patterns).
    tile = np.zeros((16, 64), np.uint16)
    for row in range(stored.shape[0]):
        for c in range(0, 64, 4):
            word = _word(stored[row, c:c + 4])
            if bits == 8:
                outs = [(row, widen_int8_row(word))]
            else:
                lo, hi = widen_int4_row(word)
                outs = [(2 * row, lo), (2 * row + 1, hi)]
            for r, (p01, p23) in outs:
                for q, reg in enumerate((p01, p23)):
                    tile[r, c + 2 * q] = np.uint16(reg & np.uint32(0xFFFF))
                    tile[r, c + 2 * q + 1] = np.uint16(reg >> np.uint32(16))
    np.testing.assert_array_equal(bf16_from_bits(tile), codes.astype(np.float32))
    x = rng.standard_normal((32, 16)).astype(np.float32)
    xs16 = bf16_bits(x)
    # Lane L's rows, as the kernel computes them (wn = wm = 0).
    a_k = lambda L: ((L >> 4) & 1) * 8 + (L & 7)  # noqa: E731
    a_n = lambda L: ((L >> 3) & 1) * 8  # noqa: E731
    b_m = lambda L: ((L >> 4) & 1) * 8 + (L & 7)  # noqa: E731
    b_k = lambda L: ((L >> 3) & 1) * 8  # noqa: E731
    b = np.zeros((4, 32, 2, 2))
    for j in range(0, 4, 2):
        r = ldmatrix_x4(xs16, lambda L: (b_m(L) + j * 8, b_k(L)))
        b[j, :, 0], b[j, :, 1] = bf16_pair(r[:, 0]), bf16_pair(r[:, 1])
        b[j + 1, :, 0], b[j + 1, :, 1] = bf16_pair(r[:, 2]), bf16_pair(r[:, 3])
    got = np.zeros((32, 64))
    for i in range(4):
        regs = ldmatrix_x4(tile, lambda L: (a_k(L), a_n(L) + i * 16), trans=True)
        a = np.stack([bf16_pair(regs[:, q]) for q in range(4)], 1)
        for j in range(4):
            d = mma_m16n8k16(a, b[j])
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for reg in range(4):
                    got[j * 8 + 2 * t + (reg & 1), i * 16 + g + (reg >> 1) * 8] = d[lane, reg]
    want = bf16_from_bits(xs16).astype(np.float64) @ codes.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def _emulate_kernel_sums(x, codes, pl):
    """The kernel's f32 sums for bf16 x (M, K) and integer codes (K, N) under
    plan ``pl``: within each cluster rank's K slice, every 16 K values'
    products summed (exactly, then rounded to f32, as the tensor cores sum
    them from zero) and joined to the running sum by an f32 add, in K order;
    then the ranks' partial sums added in rank order in f32."""
    xs = torch.from_numpy(x).to(torch.bfloat16).to(torch.float64)
    w = torch.from_numpy(codes.astype(np.float64))
    k = x.shape[1]
    out = None
    for lo, hi in pl.k_slices(k):
        acc = torch.zeros((x.shape[0], codes.shape[1]), dtype=torch.float32)
        for k0 in range(lo, hi, 16):
            part = (xs[:, k0:k0 + 16] @ w[k0:k0 + 16]).to(torch.float32)
            acc = acc + part
        out = acc if out is None else out + acc
    return out


@pytest.mark.parametrize("cluster_of", ["plan", "one"])
def test_join_order_within_kernel_tol_at_full_depth(cluster_of):
    """down's K = 8,960 with int8 codes of a seeded weight and bf16 x: the
    kernel's order of f32 joins (16-K tensor-core sums joined in K order,
    ranks in rank order), emulated, stays within rtol 1e-5, atol 1e-4 of
    ``pim_matmul_plain`` (the f32 product) after the scale, on the plan's
    cluster split and on one CTA over all of K."""
    m, k, n = 4, 8960, 64
    rng = np.random.default_rng(8960)
    x = rng.standard_normal((m, k)).astype(np.float32) * 4
    q = jax_quantize(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.02),
                     bits=8, axis=0)
    codes, scale = np.array(q.codes), np.array(q.scale)
    pl = mm.plan(512, k, n, 8, torch.bfloat16, SM_COUNT)
    if cluster_of == "one":
        pl = pl._replace(cluster=1, k_per_cta=k)
    got = _emulate_kernel_sums(x, codes, pl) * torch.from_numpy(scale).reshape(1, -1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = pim_matmul_plain(xb, torch.from_numpy(codes), torch.from_numpy(scale), bits=8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)

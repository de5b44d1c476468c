"""PIM matmul for any M: epilogue-fused matmul on quantized weights.

Twin of ``repro.kernels.pim_matmul`` (the Pallas kernel ``_mm_kernel``).  x
(M, K) meets a (K, N) weight stored as int8 codes or int4 nibbles; the codes
are widened where they are loaded, the sum runs in f32, and the epilogue
(scale, bias, activation, residual) runs before the single store.  The CUDA
kernel is ``csrc/pim_matmul.cu``.  At the prefill shapes it is bounded by
operations, not bytes (at M = 512 a code byte feeds 512 multiply-adds), and
int8/int4 codes and bf16 x are exact in bf16, so for bf16 x the multiply-adds
run on the tensor cores (``mma.sync``, f32 accumulation) in the main loop of
``csrc/pim_gemm.cuh``: codes and x stream through a ``cp.async`` ring, each
stage's codes are widened once per CTA into a bf16 tile, each stage's sums
join f32 running sums, and the CTAs of a cluster split K and add their
partial tiles in rank order.  ``plan`` chooses the tile height and the
cluster from the shape.  f32 x keeps the first port's f32 CUDA-core body
(64 x 64 tiles, no split of K).  ``bitplane_matmul`` runs the same main loop
on codes formed from bit-planes, with the same plan, and so agrees with this
kernel bit for bit.

``pim_matmul_plain`` is its plain PyTorch version.  ``pim_matmul`` takes it
only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .build import load
from .epilogue import ACTIVATION_IDS
from .pim_matvec import _sm_count, check_contract, check_cuda_operands, pim_matvec_plain

STAGE_K = 32  # K values a ring stage holds; stage and cluster bounds are multiples
# The CTA shapes (weight columns, x rows) the bf16 kernels are built for,
# with the CTAs of each an SM holds at once (registers and shared memory),
# the time of one 32-K stage of each while the SMs are full, and the fixed
# time of a wave of them (the ring's fill, the cluster's reduction, the
# epilogue), in µs: fitted to device times of every plan at qwen2-1.5b's
# prefill shapes on an H100 (scripts/probe_matmul_plans.py).  They model the
# packed kernel: the bit-plane one, whose ring holds B planes, fits fewer
# CTAs on an SM (one at B = 8), but takes the same plan so that the two
# agree bit for bit.
TILES = ((256, 128), (128, 128), (128, 64), (128, 32), (128, 16))
CTAS_PER_SM = {(256, 128): 1, (128, 128): 2, (128, 64): 3, (128, 32): 4, (128, 16): 4}
STAGE_US = {(256, 128): 1.28, (128, 128): 1.16, (128, 64): 1.6, (128, 32): 1.0, (128, 16): 1.0}
WAVE_US = {(256, 128): 10.0, (128, 128): 12.0, (128, 64): 12.0, (128, 32): 7.2, (128, 16): 8.0}
CLUSTERS = (1, 2, 4, 8)  # CTAs of a cluster, splitting K
F32_TILE = 64  # the f32 route's fixed tile (rows and columns)

# pim_matvec and pim_matmul compute one function at different M, so their
# plain version is one: the unscaled code matmul in f32, then the epilogue.
pim_matmul_plain = pim_matvec_plain


class Plan(NamedTuple):
    """How the kernel covers an (M, K) x (K, N) product."""
    tile_m: int     # x rows a CTA covers
    tile_n: int     # weight columns a CTA covers
    cluster: int    # CTAs of a cluster, splitting K
    k_per_cta: int  # K values of each CTA's slice (the last may be short)
    row_tiles: int
    col_tiles: int

    @property
    def ctas(self) -> int:
        return self.cluster * self.row_tiles * self.col_tiles

    def k_slices(self, k: int):
        """Each cluster rank's K values, [start, stop)."""
        return [(r * self.k_per_cta, min(k, (r + 1) * self.k_per_cta))
                for r in range(self.cluster)]

    def joins(self, k: int):
        """The K values at which each rank's stage sums join its running sums
        (the end of each stage), rank by rank."""
        return [list(range(lo + STAGE_K, hi, STAGE_K)) + [hi] for lo, hi in self.k_slices(k)]


def candidates(m: int, k: int, n: int):
    """Every bf16 plan the kernels can run for x (m, k) and a (k, n) weight:
    each of the TILES no taller than m's power of two (16 at least), with
    each cluster of CLUSTERS that splits K's 32-K stages into equal slices
    (the last may be short) with a stage for every rank: the kernel's
    reduction runs over exactly ``cluster`` ranks (pim_gemm.cuh:plan_ok)."""
    k_stages = -(-k // STAGE_K)
    tallest = max(16, 1 << max(0, m - 1).bit_length())
    for tile_n, tile_m in TILES:
        if tile_m > tallest:
            continue
        for cluster in CLUSTERS:
            per = -(-k_stages // cluster)
            if (cluster - 1) * per >= k_stages:
                continue
            yield Plan(tile_m, tile_n, cluster, per * STAGE_K, -(-m // tile_m), -(-n // tile_n))


def plan(m: int, k: int, n: int, bits: int, x_dtype: torch.dtype, sm_count: int) -> Plan:
    """The kernel's plan for x (m, k) and a (k, n) weight at ``bits``.

    f32 x: the CUDA-core route's fixed 64 x 64 tiles, one CTA over all of K.
    bf16 x: of the ``candidates``, the one of least modelled time, waves of
    CTAs over the SMs (CTAS_PER_SM each) times each CTA's stages at STAGE_US
    plus WAVE_US; where some plan gives every SM a CTA, only those.  Ties go
    to fewer CTAs.  The plan does not depend on ``bits`` beyond its checks,
    so the packed and the bit-plane kernels, at any bits, get the same one."""
    if m < 1 or k < 1 or n < 1:
        raise ValueError(f"pim_matmul plan: empty product ({m}, {k}) x ({k}, {n})")
    if not 1 <= bits <= 8:
        raise ValueError(f"pim_matmul plan: bits={bits}")
    if x_dtype != torch.bfloat16:
        return Plan(F32_TILE, F32_TILE, 1, -(-k // STAGE_K) * STAGE_K, -(-m // F32_TILE),
                    -(-n // F32_TILE))

    def modelled(pl: Plan):
        tile = (pl.tile_n, pl.tile_m)
        waves = -(-pl.ctas // (sm_count * CTAS_PER_SM[tile]))
        us = waves * (pl.k_per_cta // STAGE_K * STAGE_US[tile] + WAVE_US[tile])
        return pl.ctas < sm_count, us, pl.ctas

    return min(candidates(m, k, n), key=modelled)


_plan_cached = functools.lru_cache(maxsize=None)(plan)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("pim_matmul").pim_matmul_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, i, p, i, p, i, i, i, i, i, i, i, i, i, p]
    fn.restype = i
    return fn


def packed_plan(x_shape, codes_shape, bits: int, x_dtype: torch.dtype, sm_count: int) -> Plan:
    """The plan of x (M, K) against packed codes (K or K/2 rows, N) at
    ``bits``: ``plan`` at (M, K, N), cached per shape."""
    return _plan_cached(x_shape[0], x_shape[1], codes_shape[1], bits, x_dtype, sm_count)


def pim_matmul(
    x: torch.Tensor,
    w_codes: torch.Tensor,
    scale: torch.Tensor,
    *,
    bits: int = 8,
    bias: torch.Tensor | None = None,
    activation: str = "none",
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """x (M, K) @ quantized w -> (M, N) f32, epilogue fused; any M.

    bits=8: ``w_codes`` is (K, N) int8.  bits=4: ``w_codes`` is the
    nibble-packed (K//2, N) int8 from ``quant.pack_int4``.
    ``scale``: (1, N) or (N,) f32 per-output-channel scale.  ``bias``: (N,)
    or (1, N); ``residual``: (M, N); ``activation``: none|relu|silu|gelu.
    On the card x, bias and residual may be f32 or bf16.
    """
    check_contract("pim_matmul", x, w_codes, bits, activation)
    if x.device.type == "cpu":
        return pim_matmul_plain(x, w_codes, scale, bits=bits, bias=bias,
                                activation=activation, residual=residual)
    bias = check_cuda_operands("pim_matmul", x, w_codes, scale, bias, residual)
    pl = packed_plan(x.shape, w_codes.shape, bits, x.dtype, _sm_count(x.device.index))
    (m, k_dim), n = x.shape, w_codes.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    bf16 = torch.bfloat16
    err = _launcher()(
        x.data_ptr(), int(x.dtype == bf16), w_codes.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        int(bias is not None and bias.dtype == bf16),
        None if residual is None else residual.data_ptr(),
        int(residual is not None and residual.dtype == bf16),
        out.data_ptr(), m, k_dim, n, bits, ACTIVATION_IDS[activation], pl.tile_n, pl.tile_m,
        pl.cluster, pl.k_per_cta, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pim_matmul kernel launch failed: CUDA error {err}")
    pim_matmul.launches += 1
    return out


# Kernel launches since the last reset (a plain int: set it to 0 to reset).
pim_matmul.launches = 0

"""Bit-plane-decomposed matmul: the PIM-semantic form of the quantized dense
layer, with the fused epilogue.

Twin of ``repro.kernels.bitplane`` (the Pallas kernel ``_bitplane_kernel``):
the quantized weight is stored as B one-bit planes (B, K, N), LSB first and
two's complement, and the product is sum_b w_b * (x @ plane_b) with w_b = 2^b
and the sign plane's weight -2^(B-1) — PiCaSO's bit-serial MAC in spatial
form — followed by the epilogue (scale, bias, activation, residual).  The
CUDA kernel is ``csrc/bitplane_matmul.cu``.  It is bounded by the planes'
bytes (one a bit, 8x the int8 codes at B = 8).  For bf16 x the planes
stream in by 16-byte ``cp.async``, each word of four weights becomes four
int8 codes (the plane bytes shifted into place, then sign-extended from B
bits), and from there it is ``pim_matmul``'s main loop on the tensor cores,
with ``pim_matmul``'s plan at the same bits: the bit-plane path equals the
packed one bit for bit.  f32 x keeps the first port's CUDA-core body, the
twin of ``pim_matmul``'s.

``bitplane_matmul_plain`` is its plain PyTorch version, plane by plane as
the TPU kernel computes it.  ``bitplane_matmul`` takes it only for tensors
on the CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import load
from .epilogue import ACTIVATION_IDS, apply_epilogue
from .pim_matmul import Plan, _plan_cached
from .pim_matvec import _sm_count, check_cuda_operands

MAX_BITS = 8


def _check(x, planes, activation: str) -> None:
    """Raise on what the kernel does not take: x (M, K), planes (B, K, N)
    with 1 <= B <= 8, a known activation."""
    if x.dim() != 2 or planes.dim() != 3:
        raise ValueError(f"bitplane_matmul: x {tuple(x.shape)} must be 2-D and planes "
                         f"{tuple(planes.shape)} 3-D")
    if not 1 <= planes.shape[0] <= MAX_BITS:
        raise ValueError(f"bitplane_matmul: {planes.shape[0]} planes; 1 to {MAX_BITS}")
    if planes.shape[1] != x.shape[1]:
        raise ValueError(f"bitplane_matmul: planes {tuple(planes.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if activation not in ACTIVATION_IDS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"one of {sorted(ACTIVATION_IDS)}")


def bitplane_matmul_plain(x, planes, scale, *, bias=None, activation: str = "none",
                          residual=None) -> torch.Tensor:
    """The plain version: one f32 product per plane, weighted and summed in
    plane order, then the fused epilogue's order (scale [+ bias] ->
    activation [+ residual])."""
    _check(x, planes, activation)
    bits = planes.shape[0]
    xf = x.to(torch.float32)
    acc = torch.zeros((x.shape[0], planes.shape[2]), dtype=torch.float32, device=x.device)
    for b in range(bits):
        weight = float(2 ** b) if b < bits - 1 else float(-(2 ** b))
        acc = acc + weight * (xf @ planes[b].to(torch.float32))
    bias = None if bias is None else bias.to(torch.float32).reshape(1, -1)
    res = None if residual is None else residual.to(torch.float32)
    return apply_epilogue(acc, scale.to(torch.float32).reshape(1, -1), bias, res, activation)


def planes_plan(x_shape, planes_shape, x_dtype: torch.dtype, sm_count: int) -> Plan:
    """The plan of x (M, K) against planes (B, K, N): ``pim_matmul``'s plan at
    (M, K, N) and bits B, the plan the packed kernel takes at those bits."""
    bits, k, n = planes_shape
    return _plan_cached(x_shape[0], k, n, bits, x_dtype, sm_count)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("bitplane_matmul").bitplane_matmul_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, i, p, p, i, p, i, p, i, i, i, i, i, i, i, i, p]
    fn.restype = i
    return fn


def bitplane_matmul(
    x: torch.Tensor,
    planes: torch.Tensor,
    scale: torch.Tensor,
    *,
    bias: torch.Tensor | None = None,
    activation: str = "none",
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """x (M, K) @ bit-planes (B, K, N) * scale -> (M, N) f32, epilogue fused.

    ``planes``: int8 in {0, 1}, LSB first, from ``quant.to_bitplanes``;
    1 <= B <= 8.  ``scale``: (1, N) or (N,) f32.  ``bias``: (N,) or (1, N);
    ``residual``: (M, N); ``activation``: none|relu|silu|gelu.  On the card
    x, bias and residual may be f32 or bf16.
    """
    _check(x, planes, activation)
    if x.device.type == "cpu":
        return bitplane_matmul_plain(x, planes, scale, bias=bias, activation=activation,
                                     residual=residual)
    # planes[0] is a (K, N) view: the shared checks read N from its columns.
    bias = check_cuda_operands("bitplane_matmul", x, planes[0], scale, bias, residual)
    if not planes.is_contiguous():
        raise ValueError("bitplane_matmul: planes must be contiguous")
    pl = planes_plan(x.shape, planes.shape, x.dtype, _sm_count(x.device.index))
    bits, k_dim, n = planes.shape
    m = x.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    bf16 = torch.bfloat16
    err = _launcher()(
        x.data_ptr(), int(x.dtype == bf16), planes.data_ptr(), bits, scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        int(bias is not None and bias.dtype == bf16),
        None if residual is None else residual.data_ptr(),
        int(residual is not None and residual.dtype == bf16),
        out.data_ptr(), m, k_dim, n, ACTIVATION_IDS[activation], pl.tile_n, pl.tile_m,
        pl.cluster, pl.k_per_cta, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bitplane_matmul kernel launch failed: CUDA error {err}")
    bitplane_matmul.launches += 1
    return out


# Kernel launches since the last reset (a plain int: set it to 0 to reset).
bitplane_matmul.launches = 0

"""Plain-torch oracles of the PIM kernels (twins of the JAX package's
``kernels/ref.py``).  The packed matmul's dequantize the weight first
(codes x scale), then run one f32 matmul; the kernels scale after the sum
instead, so the two agree to f32 rounding, not bit for bit.  The fold's
oracle keeps the kernel's association order, so it agrees bit for bit."""
from __future__ import annotations

import torch

from repro_torch.quant import unpack_int4


def pim_matmul_int8_ref(x: torch.Tensor, w_codes: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """f32(M,K) @ dequant(int8 (K,N), scale (1,N)) -> f32 (M,N)."""
    w = w_codes.to(torch.float32) * scale
    return x.to(torch.float32) @ w


def pim_matmul_int4_ref(x: torch.Tensor, w_packed: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Nibble-packed variant: w_packed (K//2, N) int8 (low nibble = even K)."""
    w = unpack_int4(w_packed).to(torch.float32) * scale
    return x.to(torch.float32) @ w


def bitplane_matmul_ref(x: torch.Tensor, planes: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Bit-plane-decomposed matmul (the PIM-semantic form).

    planes: (B, K, N) in {0,1}; two's complement, LSB-first.
    out = sum_b weight_b * (x @ plane_b) * scale — one 'bit-serial step' per
    plane, mirroring how a PiCaSO PE consumes the striped operand.
    """
    bits = planes.shape[0]
    xf = x.to(torch.float32)
    acc = torch.zeros((x.shape[0], planes.shape[2]), dtype=torch.float32, device=x.device)
    for b in range(bits):
        weight = float(2 ** b) if b < bits - 1 else float(-(2 ** b))
        acc = acc + weight * (xf @ planes[b].to(torch.float32))
    return acc * scale


def fold_reduce_ref(x: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis (the OpMux fold tree computes exactly this).

    Uses the same halve-and-add association order as the kernel so float
    results are bit-identical.
    """
    q = x.shape[-1]
    if q < 1 or q & (q - 1):
        raise ValueError(f"q={q} must be a power of two")
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]

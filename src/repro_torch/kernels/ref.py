"""Plain-torch oracles of the packed PIM matmul (twins of the JAX package's
``kernels/ref.py``): dequantize the weight first (codes x scale), then one
f32 matmul.  The kernels scale after the sum instead, so the two agree to
f32 rounding, not bit for bit."""
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

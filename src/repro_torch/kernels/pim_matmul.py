"""PIM matmul for any M: epilogue-fused matmul on quantized weights.

Twin of ``repro.kernels.pim_matmul`` (the Pallas kernel ``_mm_kernel``).  x
(M, K) meets a (K, N) weight stored as int8 codes or int4 nibbles; the codes
are widened to f32 where they are loaded, the sum runs in f32, and the
epilogue (scale, bias, activation, residual) runs before the single store.
The CUDA kernel is ``csrc/pim_matmul.cu``: one 64 x 64 output tile per
block, a loop over K inside the block in place of the TPU's sequential K
grid axis, f32 multiply-adds on the CUDA cores.  At the prefill shapes it is
bounded by operations, not bytes (at M = 512 a code byte feeds 512
multiply-adds, far above the ~20 operations per byte where the H100's f32
units become the limit), so the design keeps each staged value in shared
memory for 64 uses and each thread's 4 x 4 outputs in registers; the ragged
edges are masked in the kernel, with no padded copies.  For bf16 x the
card's least time is set by the same multiply-adds on the bf16 tensor cores
(989 TFLOP/s, 15x the f32 rate this design runs at); that route is later
work (ROADMAP.md).

``pim_matmul_plain`` is its plain PyTorch version.  ``pim_matmul`` takes it
only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import load
from .epilogue import ACTIVATION_IDS
from .pim_matvec import check_contract, check_cuda_operands, pim_matvec_plain

BLOCK_K = 32  # K values per shared-memory stage of the kernel (kBlockK)

# pim_matvec and pim_matmul compute one function at different M, so their
# plain version is one: the unscaled code matmul in f32, then the epilogue.
pim_matmul_plain = pim_matvec_plain


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("pim_matmul").pim_matmul_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, i, p, i, p, i, i, i, i, i, p]
    fn.restype = i
    return fn


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
    (m, k_dim), n = x.shape, w_codes.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    bf16 = torch.bfloat16
    err = _launcher()(
        x.data_ptr(), int(x.dtype == bf16), w_codes.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        int(bias is not None and bias.dtype == bf16),
        None if residual is None else residual.data_ptr(),
        int(residual is not None and residual.dtype == bf16),
        out.data_ptr(), m, k_dim, n, bits, ACTIVATION_IDS[activation],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pim_matmul kernel launch failed: CUDA error {err}")
    pim_matmul.launches += 1
    return out


# Kernel launches since the last reset (a plain int: set it to 0 to reset).
pim_matmul.launches = 0

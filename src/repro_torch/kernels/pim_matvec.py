"""Decode-shaped PIM matvec: epilogue-fused GEMV on quantized weights.

Twin of ``repro.kernels.pim_matvec``.  M <= 8 rows of activations meet a
(K, N) quantized weight: the product is pure weight streaming, so the kernel
reads the packed codes once, widens them next to the multiply and runs the
epilogue (scale, bias, activation, residual) before its single store.  The
CUDA kernel is ``csrc/pim_matvec.cu``; ``pim_matvec_plain`` is its plain
PyTorch version (the twin of ``repro.kernels.ref.pim_matvec_ref``).

``pim_matvec`` takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.quant import unpack_int4

from .build import load
from .epilogue import ACTIVATION_IDS, apply_epilogue

MAX_M = 8  # decode-shaped
_FLOAT_TYPES = (torch.float32, torch.bfloat16)
_BLOCK_N = 256  # columns per block of the kernel's first pass (kBlockN)
_MIN_ROWS_PER_SPLIT = 16  # code rows a block sums at least
_BLOCKS_PER_SM = 4  # first-pass blocks the K split aims for, per SM


def pim_matvec_plain(x, w_codes, scale, *, bits: int = 8, bias=None,
                     activation: str = "none", residual=None) -> torch.Tensor:
    """The plain version: unscaled code matmul in f32, then the fused
    epilogue's order (scale [+ bias] -> activation [+ residual])."""
    w = (w_codes if bits == 8 else unpack_int4(w_codes)).to(torch.float32)
    acc = x.to(torch.float32) @ w
    bias = None if bias is None else bias.to(torch.float32).reshape(1, -1)
    res = None if residual is None else residual.to(torch.float32)
    return apply_epilogue(acc, scale.to(torch.float32).reshape(1, -1), bias, res,
                          activation)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("pim_matvec").pim_matvec_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, i, p, i, p, p, i, i, i, i, i, i, i, p]
    fn.restype = i
    return fn


def split_rows(rows: int, n: int, sm_count: int) -> tuple[int, int]:
    """(splits, rows_per_split) of the kernel's K split: enough first-pass
    blocks to give every SM a few, each summing at least a few code rows."""
    col_blocks = -(-n // _BLOCK_N)
    want = -(-_BLOCKS_PER_SM * sm_count // col_blocks)
    splits = max(1, min(want, rows // _MIN_ROWS_PER_SPLIT))
    per = -(-rows // splits)
    return -(-rows // per), per


def _check_cuda(name, t, dtypes, device, shape=None):
    if t.device != device:
        raise ValueError(f"pim_matvec: {name} is on {t.device}, x on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"pim_matvec: {name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"pim_matvec: {name} must be contiguous")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"pim_matvec: {name} shape {tuple(t.shape)} != {shape}")


def pim_matvec(
    x: torch.Tensor,
    w_codes: torch.Tensor,
    scale: torch.Tensor,
    *,
    bits: int = 8,
    bias: torch.Tensor | None = None,
    activation: str = "none",
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """x (M≤8, K) @ quantized w -> (M, N) f32, epilogue fused.

    bits=8: ``w_codes`` is (K, N) int8.  bits=4: ``w_codes`` is the
    nibble-packed (K//2, N) int8 from ``quant.pack_int4``.
    ``scale``: (1, N) or (N,) f32 per-output-channel scale.  ``bias``: (N,)
    or (1, N); ``residual``: (M, N); ``activation``: none|relu|silu|gelu.
    On the card x, bias and residual may be f32 or bf16.
    """
    m, k_dim = x.shape
    if m > MAX_M:
        raise ValueError(f"pim_matvec is decode-shaped (M <= {MAX_M}); "
                         f"got M={m} — use pim_matmul")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    k_w, n = w_codes.shape
    if k_w * (8 // bits) != k_dim:
        raise ValueError(f"codes {tuple(w_codes.shape)} at bits={bits} do not "
                         f"match x {tuple(x.shape)}")
    if activation not in ACTIVATION_IDS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"one of {sorted(ACTIVATION_IDS)}")
    if x.device.type == "cpu":
        return pim_matvec_plain(x, w_codes, scale, bits=bits, bias=bias,
                                activation=activation, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"pim_matvec runs on cpu or cuda tensors, not {x.device}")

    dev = x.device
    if bias is not None:
        bias = bias.reshape(-1)
    _check_cuda("x", x, _FLOAT_TYPES, dev)
    _check_cuda("w_codes", w_codes, (torch.int8,), dev)
    _check_cuda("scale", scale, (torch.float32,), dev)
    if scale.numel() != n:
        raise ValueError(f"pim_matvec: scale has {scale.numel()} values, N={n}")
    if bias is not None:
        _check_cuda("bias", bias, _FLOAT_TYPES, dev, (n,))
    if residual is not None:
        _check_cuda("residual", residual, _FLOAT_TYPES, dev, (m, n))

    splits, per = split_rows(k_w, n, _sm_count(dev.index))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
    bf16 = torch.bfloat16
    err = _launcher()(
        x.data_ptr(), int(x.dtype == bf16), w_codes.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        int(bias is not None and bias.dtype == bf16),
        None if residual is None else residual.data_ptr(),
        int(residual is not None and residual.dtype == bf16),
        partial.data_ptr(), out.data_ptr(), m, k_dim, n, bits,
        ACTIVATION_IDS[activation], splits, per,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pim_matvec kernel launch failed: CUDA error {err}")
    pim_matvec.launches += 1
    return out


# Kernel launches since the last reset (a plain int: set it to 0 to reset).
pim_matvec.launches = 0

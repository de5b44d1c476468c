"""Shared functional building blocks: init, norms, RoPE, PIM-aware linear.

Twin of ``repro.models.common``, over the same parameter layout: a quantized
weight is a dict ``{"codes", "scale"[, "nibbles" | "nibbles_odd"]}`` of
tensors, and layer stacks keep their leading dims.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.pim_matvec import MAX_M, pim_matvec


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card, and raises
    where there is none (pass ``device="cpu"`` to run on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def dense_init(gen: torch.Generator, shape, dtype, device, scale: float = 0.02):
    return (scale * torch.randn(shape, generator=gen, device=device,
                                dtype=torch.float32)).to(dtype)


# ------------------------------------------------------------ PIM linear ----
# Decode-shaped (M <= MATVEC_MAX_M rows) quantized matmuls route through the
# epilogue-fused kernels.pim_matvec instead of the overlay path:
#   "auto"  — through pim_matvec: its CUDA kernel on CUDA tensors, its plain
#             version on CPU tensors
#   "off"   — always the overlay path ``x @ dq(w)``
# "force" is accepted as another name for "auto": the JAX package needs it to
# run its kernel off-TPU, and callers port one to one.
MATVEC_MAX_M = MAX_M
_MATVEC_DISPATCH = "auto"


def matvec_dispatch() -> str:
    """The current pim_matvec dispatch mode ("auto" or "off")."""
    return _MATVEC_DISPATCH


def set_matvec_dispatch(mode: str) -> str:
    """Set the pim_matvec dispatch mode; returns the previous mode."""
    global _MATVEC_DISPATCH
    if mode not in ("auto", "off", "force"):
        raise ValueError(f"matvec dispatch must be auto|off|force, got {mode!r}")
    prev, _MATVEC_DISPATCH = _MATVEC_DISPATCH, "auto" if mode == "force" else mode
    return prev


def _linear_matvec(x: torch.Tensor, w: dict, b) -> torch.Tensor:
    """Route a decode-shaped quantized linear through kernels.pim_matvec
    (bias fused into the kernel epilogue)."""
    bits = 4 if ("nibbles" in w or "nibbles_odd" in w) else 8
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if "nibbles_odd" in w:
        # The packed weight carries one zero pad row (odd true K); a zero
        # activation column keeps the contraction aligned and contributes 0.
        x2 = F.pad(x2, (0, 1))
    n = w["codes"].shape[-1]
    y = pim_matvec(x2.contiguous(), w["codes"], w["scale"].reshape(1, n),
                   bits=bits, bias=b)
    return y.reshape(lead + (n,)).to(x.dtype)


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Matmul against a dense weight or a PIM-quantized leaf.

    A PIM leaf is ``{"codes": int8 (..., K, N), "scale": f32}`` produced by
    ``serving.quantize_tree``.  Decode-shaped calls (<= MATVEC_MAX_M
    activation rows, 2-D weight) go through the epilogue-fused
    kernels.pim_matvec (the 'overhaul' path) unless the dispatch mode is
    "off"; the rest dequantize at the matmul operand (the 'overlay' path).
    """
    if isinstance(w, dict) and "codes" in w:
        if (w["codes"].dim() == 2 and _MATVEC_DISPATCH != "off"
                and math.prod(x.shape[:-1]) <= MATVEC_MAX_M):
            return _linear_matvec(x, w, b)  # bias fused in the epilogue
        y = x @ dq(w, x.dtype)
    else:
        y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def weight_shape(w) -> tuple:
    if isinstance(w, dict) and "codes" in w:
        s = tuple(w["codes"].shape)
        if "nibbles" in w:  # int4: two K rows per byte
            return s[:-2] + (2 * s[-2], s[-1])
        if "nibbles_odd" in w:  # int4, odd true K: last byte's high nibble is pad
            return s[:-2] + (2 * s[-2] - 1, s[-1])
        return s
    return tuple(w.shape)


# The most bytes of f32 products ``dq`` forms at once on its way to a
# narrower dtype: llama-3.2-vision-90b's (8,192 x 128,256) head would
# otherwise need 4.2 GB of them beside its 2.1 GB bf16 result.
DQ_BLOCK_BYTES = 1 << 28


def dq(w, dtype=None) -> torch.Tensor:
    """Densify a weight leaf (dequantize PIM codes) for matmul use.

    Handles nibble-packed int4 ('nibbles' marker): two K rows per byte,
    unpacked with sign extension.  The 'nibbles_odd' marker flags an odd
    true K: the zero pad row added by ``serving.quantize_tree`` before
    packing is dropped after unpacking.  The JAX package splits this into
    ``dq`` and ``_dq_local``, which differ only by the tensor-parallel
    all-gather; they are one function here until the port's
    tensor-parallel slice.  Into another ``dtype`` than the scales' the
    products are formed a block of columns at a time (at most
    DQ_BLOCK_BYTES of them), each element rounded as a whole-leaf cast
    rounds it.
    """
    if isinstance(w, dict) and "codes" in w:
        codes = w["codes"]
        if "nibbles" in w or "nibbles_odd" in w:
            lo = ((codes & 0xF) ^ 8) - 8
            hi = (((codes >> 4) & 0xF) ^ 8) - 8
            k2 = codes.shape[-2]
            stacked = torch.stack([lo, hi], dim=-2)  # (..., K//2, 2, N)
            codes = stacked.reshape(codes.shape[:-2] + (2 * k2, codes.shape[-1]))
            if "nibbles_odd" in w:
                codes = codes[..., :-1, :]
        scale = w["scale"]
        n = codes.shape[-1]
        per = max(1, DQ_BLOCK_BYTES // (4 * max(1, codes[..., 0].numel())))
        if dtype is None or dtype == scale.dtype:
            return codes.to(scale.dtype) * scale
        out = torch.empty(codes.shape, dtype=dtype, device=codes.device)
        for c in range(0, n, per):
            out[..., c:c + per] = codes[..., c:c + per].to(scale.dtype) * scale[..., c:c + per]
        return out
    return w.to(dtype) if dtype is not None else w


# ------------------------------------------------------------------ norms ---
def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 normalize, cast back to x's dtype, then scale by g (JAX's order)."""
    x32 = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * g.to(x.dtype)


# ------------------------------------------------------------------- RoPE ---
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,).  Rotates the interleaved
    pairs (x[..., 0::2], x[..., 1::2]), not the half-split convention."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (B?, S, D/2)
    while ang.dim() < x.dim():
        ang = ang.unsqueeze(-2) if ang.dim() == x.dim() - 1 else ang.unsqueeze(0)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------------- MLP ----
def mlp_init(gen, d: int, d_ff: int, dtype, device, lead=()) -> dict:
    return {
        "gate": dense_init(gen, lead + (d, d_ff), dtype, device),
        "up": dense_init(gen, lead + (d, d_ff), dtype, device),
        "down": dense_init(gen, lead + (d_ff, d), dtype, device),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP."""
    return linear(F.silu(linear(x, p["gate"])) * linear(x, p["up"]), p["down"])


# ------------------------------------------------------------- embeddings ---
def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def unembed(x: torch.Tensor, table_or_w) -> torch.Tensor:
    """Logits. ``table_or_w``: (V, D) tied table or (D, V) head weight."""
    if isinstance(table_or_w, dict) and "codes" in table_or_w:
        return linear(x, table_or_w)
    if table_or_w.shape[0] > table_or_w.shape[1]:  # (V, D) tied
        return x @ table_or_w.T
    return x @ table_or_w

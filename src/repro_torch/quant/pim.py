"""Which leaves of a parameter tree go to PIM storage, and a weight's
quantization one (K, N) slice at a time.

``serving.quantize_tree`` quantizes a tree it is given; the slice-wise draw
``models.draw.quantized_params`` quantizes each slice as it draws it.  Both
decide by ``should_quantize`` and fill the leaf by ``quantize_slices``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .quantize import pack_int4, quantize_symmetric

# Leaves that stay dense: norms/gains/biases/scalars, router (accuracy-
# critical and tiny), conv kernels, SSM dynamics params.
DENSE_KEYS = {"ln", "ln1", "ln2", "ln3", "ln_f", "conv_w", "conv_b", "A_log",
              "dt_bias", "D", "router", "gate_attn", "gate_mlp",
              "bq", "bk", "bv", "scale"}


def should_quantize(name: str, leaf: torch.Tensor) -> bool:
    if name in DENSE_KEYS or leaf.dim() < 2:
        return False
    # embed tables are gathered, not matmul'd — keep dense (tied heads too).
    if name == "embed":
        return False
    return leaf.shape[-1] >= 8 and leaf.shape[-2] >= 8


def _quantize_slice(w: torch.Tensor, bits: int):
    """One (K, N) weight's codes (int4: nibble-packed, a zero pad row first
    where K is odd) and its (1, N) scales."""
    q = quantize_symmetric(w.to(torch.float32), bits=bits, axis=-2)
    codes = q.codes
    if bits == 4:
        if codes.shape[0] % 2:
            codes = torch.cat([codes, torch.zeros_like(codes[:1])])
        codes = pack_int4(codes)
    return codes, q.scale


def quantize_slices(lead: tuple, k: int, n: int, slice_of: Callable, bits: int, device):
    """The quantized leaf of a (lead..., K, N) weight whose (K, N) slice at
    each index of ``lead`` is ``slice_of(idx)``, asked for one at a time in
    ``np.ndindex`` order, into contiguous codes and scales made first: the
    scales are per output column over K, so each slice is independent and
    the result is the whole leaf's bit for bit, with one slice's f32 copy
    and temporaries at a time.  A caller may draw each slice as it is asked
    for and drop it after (``models.draw.quantized_params``)."""
    rows = k if bits != 4 else -(-k // 2)
    codes = torch.empty(lead + (rows, n), dtype=torch.int8, device=device)
    scale = torch.empty(lead + (1, n), dtype=torch.float32, device=device)
    for idx in np.ndindex(*lead):
        codes[idx], scale[idx] = _quantize_slice(slice_of(idx), bits)
    if bits != 4:
        return {"codes": codes, "scale": scale}
    marker = "nibbles_odd" if k % 2 else "nibbles"
    return {"codes": codes, "scale": scale,
            marker: torch.zeros(lead, dtype=torch.int8, device=device)}

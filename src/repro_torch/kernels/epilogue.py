"""The fused epilogue shared by the PIM matmul kernels, in plain PyTorch.

``apply_epilogue`` is the per-output tail a naive lowering runs as separate
passes after the matmul: channel scale, bias, activation, residual.  The
CUDA kernels run the same steps in ``csrc/epilogue.cuh`` before their single
store; this module is the plain version they are held against.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# ``jax.nn.gelu`` defaults to the tanh approximation; so does this table.
ACTIVATIONS = {
    "none": lambda y: y,
    "relu": torch.relu,
    "silu": F.silu,
    "gelu": lambda y: F.gelu(y, approximate="tanh"),
}

# Activation ids as the CUDA epilogue (csrc/epilogue.cuh) numbers them.
ACTIVATION_IDS = {"none": 0, "relu": 1, "silu": 2, "gelu": 3}


def apply_epilogue(acc, scale, bias, residual, activation: str):
    """acc * scale [+ bias] -> activation -> [+ residual], all in f32."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"one of {sorted(ACTIVATIONS)}")
    y = acc * scale
    if bias is not None:
        y = y + bias
    y = ACTIVATIONS[activation](y)
    if residual is not None:
        y = y + residual
    return y

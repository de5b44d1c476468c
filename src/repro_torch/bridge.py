"""Carry a parameter tree between the JAX package and the port, through numpy.

The port keeps the JAX package's parameter layout (nested dicts, stacked
layers, quantized leaves ``{"codes", "scale"[, marker]}``), so the bridge is
a leaf-by-leaf copy.  The caller converts a JAX tree to numpy
(``jax.tree.map(np.asarray, tree)``); this module never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import resolve_device


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays -> the same tree of tensors on ``device``
    (None: the card).  Quantized and marker leaves are copied like any
    other; ``None`` leaves stay ``None``."""
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return None if t is None else _to_tensor(t, device)

    return conv(tree)


def params_to_numpy(tree):
    """Inverse of ``params_from_numpy``.  bf16 leaves come back as float32
    (a lossless widening: numpy has no bf16 of its own)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if t is None:
            return None
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    return conv(tree)

"""OpMux-style folding reduction: halve-and-add over the last axis.

Twin of ``repro.kernels.fold_reduce`` (the Pallas kernel ``_fold_kernel``):
(rows, q) -> (rows,) f32 by log2(q) levels, at each of which element i
becomes x[i] + x[i + h] — the spatial analogue of the paper's A-FOLD passes.
The association order is the contract: the CUDA kernel
(``csrc/fold_reduce.cu``) and the plain version agree bit for bit, which
``torch.sum`` (another order) does not.

``fold_reduce`` takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .build import load
from .pim_matvec import _sm_count

FOLD_THREADS = 256  # threads a CTA of the kernel has (kThreads)
MAX_CLUSTER = 4  # CTAs a row at most (kMaxCluster)


class Plan(NamedTuple):
    """How ``fold_reduce_launch`` splits a row of q elements: V elements a
    16-byte vector, T threads of a row in a CTA, S CTAs of a row (a cluster),
    E vectors a lane; V * T * S * E = q.  Lane l = rank * T + t holds the
    row's vectors l, l + T S, l + 2 T S, ..."""
    v: int
    t: int
    s: int
    e: int


def plan(rows: int, q: int, itemsize: int, sm_count: int) -> Plan:
    """The kernel's split of a row: 16-byte vectors (fewer elements where q
    is shorter), up to FOLD_THREADS threads a row, and, where a row still
    leaves each lane several vectors and the rows are too few to give every
    SM a CTA, a cluster of up to MAX_CLUSTER CTAs on each row."""
    v = min(q, 16 // itemsize)
    lanes = q // v
    t = min(lanes, FOLD_THREADS)
    e = lanes // t
    s = 1
    while t == FOLD_THREADS and s < MAX_CLUSTER and s < e and rows * s < sm_count:
        s *= 2
    return Plan(v, t, s, e // s)


def _check(x) -> None:
    """Raise on what the JAX package's kernel asserts: (rows, q), q a power
    of two."""
    if x.dim() != 2:
        raise ValueError(f"fold_reduce: x {tuple(x.shape)} must be (rows, q)")
    q = x.shape[1]
    if q < 1 or q & (q - 1):
        raise ValueError(f"fold_reduce: q={q} must be a power of two")


def fold_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: widen to f32, then the halving levels in the
    kernel's order."""
    _check(x)
    x = x.to(torch.float32)
    h = x.shape[1]
    while h > 1:
        h //= 2
        x = x[:, :h] + x[:, h:2 * h]
    return x[:, 0].clone()  # at q = 1 the column would alias an f32 input


_plan_cached = functools.lru_cache(maxsize=None)(plan)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("fold_reduce").fold_reduce_launch
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, i, p, ctypes.c_longlong, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def fold_reduce(x: torch.Tensor) -> torch.Tensor:
    """Fold-sum the last axis of ``x`` (rows, q) -> (rows,) f32; q a power of
    two.  On the card x may be f32 or bf16 (widened on load)."""
    _check(x)
    if x.device.type == "cpu":
        return fold_reduce_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"fold_reduce runs on cpu or cuda tensors, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fold_reduce: x dtype {x.dtype} not in (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("fold_reduce: x must be contiguous")
    rows, q = x.shape
    pl = _plan_cached(rows, q, x.element_size(), _sm_count(x.device.index))
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    err = _launcher()(x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(), rows, q,
                      *(n.bit_length() - 1 for n in pl),
                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fold_reduce kernel launch failed: CUDA error {err}")
    fold_reduce.launches += 1
    return out


# Kernel launches since the last reset (a plain int: set it to 0 to reset).
fold_reduce.launches = 0

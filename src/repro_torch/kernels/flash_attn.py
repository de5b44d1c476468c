"""Flash attention: softmax(q k^T / sqrt(D)) v online over KV blocks.

Twin of ``repro.kernels.flash_attn`` (the Pallas kernel ``_flash_kernel``)
and of the model's ``_chunked_attention``: the keys stream through the
kernel in tiles with a running (max, denominator, accumulator) triple per
query row, so no (Sq, Sk) score tensor reaches device memory.  The CUDA
kernel is ``csrc/flash_attn.cu``; ``flash_attention_plain`` is its plain
PyTorch version, line for line the JAX package's ``_chunked_attention``;
``flash_attention_ref`` is the naive oracle (the full softmax).

Two layouts, one kernel:
  flash_attention(q, k, v)      q (BH, Sq, D), k/v (BH, Sk, D): the Pallas contract
  flash_attention_gqa(q, k, v)  q (B, Sq, KV, G, D), k/v (B, Sk, KV, D): the
                                model's grouped-query layout; query head (kv, g)
                                reads KV head kv
``flash_attention`` is ``flash_attention_gqa`` on the zero-copy view
(BH, S, 1, 1, D).  Causal masking is top-left aligned: query i sees keys
0..i, as in both JAX versions.  The output is in q's dtype.

The kernel takes one of two routes, chosen by the dtype alone: bf16 runs on
the tensor cores (``mma.sync``, K/V tiles of KV_TILE_BF16 keys through a
``cp.async`` ring, p split into two bf16 halves so that p.v keeps the plain
version's f32 p); f32 runs on the CUDA cores in tiles of KV_TILE keys.

The wrappers take the plain version only for tensors on the CPU; for a CUDA
tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import load

KV_CHUNK = 512  # the plain version's keys per chunk (the JAX package's KV_CHUNK)
KV_TILE = 32  # the f32 route's keys per shared-memory tile (kBKV)
KV_TILE_BF16 = 64  # the bf16 route's keys per shared-memory tile (kMmaBKV)
HEAD_DIMS = (16, 32, 64, 128)  # the head widths the kernel is compiled for
_FLOAT_TYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, causal: bool, kv_chunk: int = KV_CHUNK):
    """Online softmax over KV chunks of ``kv_chunk`` keys (the largest
    divisor of Sk at most that), in f32.  q: (B,Sq,KV,G,D); k,v: (B,Sk,KV,D)
    -> (B,Sq,KV,G,D) in v's dtype."""
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    c = min(kv_chunk, sk)
    while sk % c:  # fall back to the largest divisor (defensive)
        c -= 1
    n_chunks = sk // c
    kc = k.reshape(b, n_chunks, c, kvh, d).transpose(0, 1)
    vc = v.reshape(b, n_chunks, c, kvh, d).transpose(0, 1)

    f32 = dict(dtype=torch.float32, device=q.device)
    qf = q.to(torch.float32)
    scale = 1.0 / torch.sqrt(torch.full((), float(d), **f32))  # f32, as jnp.sqrt(d)
    qi = torch.arange(sq, device=q.device)[:, None]
    neg_inf = torch.full((), float("-inf"), **f32)

    m = torch.full((b, kvh, g, sq), float("-inf"), **f32)
    l = torch.zeros((b, kvh, g, sq), **f32)
    acc = torch.zeros((b, sq, kvh, g, d), **f32)
    for j in range(n_chunks):
        kj, vj = kc[j], vc[j]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kj.to(torch.float32)) * scale
        if causal:
            ki = j * c + torch.arange(c, device=q.device)[None, :]
            s = torch.where(qi >= ki, s, neg_inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # Guard fully-masked rows (all -inf) against NaNs.
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe, neg_inf))
        corr = torch.where(torch.isfinite(corr), corr, 0.0)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bqhgd", p, vj.to(torch.float32))
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.to(v.dtype)


def flash_attention_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """The naive oracle on (BH, S, D): the full f32 softmax."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) / (d ** 0.5)
    if causal:
        sq, sk = s.shape[-2:]
        mask = (torch.arange(sq, device=s.device)[:, None]
                >= torch.arange(sk, device=s.device)[None, :])
        s = torch.where(mask, s, float("-inf"))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.to(torch.float32)).to(q.dtype)


def _check(q, k, v) -> None:
    """Raise on what no layout of the contract takes: ranks, shapes, devices
    and dtypes (f32 or bf16, the same for q, k and v)."""
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention_gqa: q {tuple(q.shape)} must be (B, Sq, KV, G, D) "
                         f"and k {tuple(k.shape)}, v {tuple(v.shape)} (B, Sk, KV, D)")
    b, _, kvh, _, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, kvh, d):
        raise ValueError(f"flash_attention_gqa: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k.shape[1] < 1:
        raise ValueError("flash_attention_gqa: no keys to attend to (Sk = 0)")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_gqa: q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_gqa runs on cpu or cuda tensors, not {q.device}")
    if q.dtype not in _FLOAT_TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_gqa: q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        f"all three must be one of {_FLOAT_TYPES}")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("flash_attn").flash_attn_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, ll, ll,
                   i, ctypes.c_float, p]
    fn.restype = i
    return fn


def _check_aligned(q, k, v) -> None:
    """The bf16 route copies rows with 16-byte ``cp.async``: every pointer
    16-byte aligned, and every stride but the last a multiple of 8 elements
    (a dim of size 1 never steps, so its stride does not count)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(n > 1 and st % 8 for n, st in zip(t.shape[:-1],
                                                                       t.stride()[:-1])):
            raise ValueError(f"flash_attention_gqa: bf16 {name} must start 16-byte aligned "
                             f"and step in multiples of 8 elements; it has strides "
                             f"{t.stride()} at {t.data_ptr():#x}")


def flash_attention_gqa(q, k, v, *, causal: bool):
    """Attention of q (B, Sq, KV, G, D) over k, v (B, Sk, KV, D) ->
    (B, Sq, KV, G, D) in q's dtype, any Sq and Sk.  On the card D is one of
    HEAD_DIMS and each tensor's last dim has stride 1 (the others may be
    strided, e.g. a transposed cache view); bf16 tensors must also meet
    ``_check_aligned``.  CPU tensors take the plain version in chunks of
    KV_CHUNK keys; the kernel tiles with KV_TILE_BF16 (bf16) or KV_TILE (f32)
    keys."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, kv_chunk=KV_CHUNK)
    b, sq, kvh, g, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_gqa: head dim {d} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_gqa: the last dim of q, k and v must have stride 1")
    if q.dtype == torch.bfloat16:
        _check_aligned(q, k, v)
    out = torch.empty((b, sq, kvh, g, d), dtype=q.dtype, device=q.device)
    if sq == 0:
        return out
    scale = float(1.0 / torch.sqrt(torch.tensor(float(d))))  # the plain version's f32 scale
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      int(q.dtype == torch.bfloat16), b, sq, k.shape[1], kvh, g, d,
                      *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], int(causal), scale,
                      torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """The Pallas contract: q (BH, Sq, D), k/v (BH, Sk, D) -> (BH, Sq, D) in
    q's dtype.  The Pallas kernel's ``bq``/``bkv`` were its VMEM block shape,
    and it asserted Sq % bq == 0 and Sk % bkv == 0; the CUDA kernel's tiles
    are fixed by what fits an SM's registers and shared memory and it masks
    the ragged edges itself, so any Sq and Sk work and neither is an
    argument.  ``interpret`` has no counterpart: CPU tensors take the plain
    version."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be (BH, S, D)")
    out = flash_attention_gqa(q[:, :, None, None], k[:, :, None], v[:, :, None], causal=causal)
    return out[:, :, 0, 0]


# Kernel launches since the last reset (a plain int: set it to 0 to reset);
# both layouts and both routes count here.
flash_attention.launches = 0

"""The Mamba1 block (selective scan): twin of the Mamba1 half of
``repro.models.mamba``.  Mamba2 (SSD) comes with the hybrid family.

A layer's decode state is per batch row (or per slot of the continuous
engine): ``h`` (B, d_in, N) f32, the SSM state, and ``conv`` (B, K-1,
d_in) f32, the causal conv's tail.  ``mamba1_decode`` writes both in place,
as the attention blocks write their caches; ``mamba1_prefill`` and
``mamba1_verify`` return new state, which the block writes (prefill) or the
verify window's commit selects a step of (``models.lm.commit_verify``).

The JAX package's prefill scans a chunk with ``lax.associative_scan``,
which torch lacks.  Here every recurrence, prefill's included, runs step by
step, ``h = h * dA + dBx``, in the association of ``mamba1_decode``: the
prefill's state differs from the JAX package's by float association only
(held to a stated f32 tolerance), and a verify window's per-step states are
decode's, step for step.  Chunking still bounds the materialised (tokens x
d_in x N) tensors to one chunk.  Pad steps of a right-padded prompt
(``length=``) carry dt = 0, so the state passes through them unchanged, and
the conv tail is gathered at ``length`` on the device: a captured admit
reads no value on the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig

from .common import dense_init, linear, weight_shape


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ------------------------------------------------------------------ conv ----
def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None, length=None):
    """Depthwise causal conv over the sequence.  x: (B, S, C), w: (C, K),
    state: (B, K-1, C), cast to x's dtype before use.  Returns (out, the
    conv tail): the last K-1 inputs, or with ``length`` (an int or a 0-d
    integer tensor, <= S) those as of that many real tokens, gathered on
    the device, so pads never enter the carried tail."""
    k = w.shape[-1]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[:, i] for i in range(k))
    if k <= 1:
        return out, pad
    if length is None:
        return out, xp[:, -(k - 1):]
    start = torch.as_tensor(length, device=x.device).to(torch.int64).reshape(()).clamp(0, s)
    return out, xp.index_select(1, start + torch.arange(k - 1, device=x.device))


# ---------------------------------------------------------------- Mamba 1 ---
def mamba1_init(gen, d: int, s: SSMConfig, dtype, device, lead=()) -> dict:
    """A Mamba1 layer's parameters (the JAX package's ``mamba1_init``
    leaves and values: ``A_log`` = log(1..N) and ``D`` = 1 in f32,
    ``dt_bias`` softplus^-1(0.01) in the parameter dtype); ``lead``
    prepends stack dims to every leaf."""
    d_in = s.expand * d
    dt_rank = s.dt_rank or d // 16
    n = s.state_dim
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
    return {
        "in_proj": dense_init(gen, lead + (d, 2 * d_in), dtype, device),
        "conv_w": dense_init(gen, lead + (d_in, s.conv_dim), dtype, device, scale=0.5),
        "conv_b": torch.zeros(lead + (d_in,), dtype=dtype, device=device),
        "x_proj": dense_init(gen, lead + (d_in, dt_rank + 2 * n), dtype, device),
        "dt_proj": dense_init(gen, lead + (dt_rank, d_in), dtype, device),
        "dt_bias": torch.full(lead + (d_in,), -4.6, dtype=dtype, device=device),
        "A_log": a_log.expand(lead + (d_in, n)).contiguous(),
        "D": torch.ones(lead + (d_in,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, lead + (d_in, d), dtype, device),
    }


def mamba1_cache_init(batch: int, d_in: int, s: SSMConfig, device, lead=()) -> dict:
    """Zero state of ``batch`` rows: ``h`` (B, d_in, N) and ``conv`` (B,
    K-1, d_in), both f32; ``lead`` prepends stack dims."""
    return {
        "h": torch.zeros(lead + (batch, d_in, s.state_dim), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, s.conv_dim - 1, d_in), dtype=torch.float32,
                            device=device),
    }


def _selective(p: dict, xs: torch.Tensor, n: int):
    """The input-dependent SSM parameters of the conv'd input xs (B, L,
    d_in): dt (B, L, d_in) f32 (softplus of ``dt_proj`` + ``dt_bias``
    widened to f32), B and C (B, L, N) f32."""
    dbc = linear(xs, p["x_proj"])
    dt_rank = weight_shape(p["dt_proj"])[0]
    # the dt columns are a strided view (row stride dt_rank + 2N): a copy
    # where ``linear`` hands them to pim_matvec, which takes contiguous x
    dt = _softplus(linear(dbc[..., :dt_rank], p["dt_proj"]) + p["dt_bias"].to(torch.float32))
    bmat = dbc[..., dt_rank:dt_rank + n].to(torch.float32)
    cmat = dbc[..., dt_rank + n:].to(torch.float32)
    return dt.to(torch.float32), bmat, cmat


def _discretize(p: dict, dtf: torch.Tensor, xs: torch.Tensor, bmat: torch.Tensor):
    """dA = exp(dt * A) and dBx = dt * x * B, each (B, L, d_in, N) f32, of
    dt (B, L, d_in) f32 and x (B, L, d_in)."""
    a = -torch.exp(p["A_log"])  # (d_in, N)
    da = torch.exp(dtf[..., None] * a)
    dbx = (dtf * xs.to(torch.float32))[..., None] * bmat[:, :, None, :]
    return da, dbx


def _ssm_scan(da: torch.Tensor, dbx: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Every state of the recurrence ``h = h * dA + dBx`` from ``h0`` (B,
    d_in, N) over dA, dBx (B, L, d_in, N): (B, L, d_in, N), step by step in
    ``mamba1_decode``'s association (a product, then a sum)."""
    hs = torch.empty_like(dbx)
    h = h0
    for t in range(da.shape[1]):
        torch.mul(h, da[:, t], out=hs[:, t])
        hs[:, t] += dbx[:, t]
        h = hs[:, t]
    return hs


def _out(p: dict, hs, cmat, xs, z, dtype):
    """y = (C . h + D x) * silu(z), cast to ``dtype`` before the gate, then
    ``out_proj``; hs (B, L, d_in, N), cmat (B, L, N), xs and z (B, L,
    d_in)."""
    y = torch.einsum("blcn,bln->blc", hs, cmat) + p["D"] * xs.to(torch.float32)
    return linear(y.to(dtype) * F.silu(z), p["out_proj"])


def mamba1_prefill(p: dict, x: torch.Tensor, cache: dict, s: SSMConfig, length=None):
    """Full-sequence Mamba1 of x (B, S, D) from the state ``cache`` that
    also returns the final state, ``{"h", "conv"}`` (new tensors, f32).
    ``length`` (an int or a 0-d integer tensor) treats positions >= length
    as right padding: their dt is 0, so the state passes through, and the
    conv tail is taken at ``length``, so the state equals an unpadded
    prefill's.  The sequence is padded to whole chunks of ``s.chunk`` (at
    most S) steps, each chunk's projections one matmul."""
    b, seq, _ = x.shape
    n = s.state_dim
    chunk = min(s.chunk, seq)
    pad = -seq % chunk
    xs, z = linear(x, p["in_proj"]).chunk(2, dim=-1)
    xs, conv = _causal_conv(xs, p["conv_w"], cache["conv"], length=length)
    conv = conv.to(cache["conv"].dtype)
    xs = F.silu(xs + p["conv_b"])
    mask = torch.ones((b, seq), dtype=torch.float32, device=x.device)
    if length is not None:
        at = torch.arange(seq, device=x.device)[None]
        mask = mask * (at < torch.as_tensor(length, device=x.device)).to(torch.float32)
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad))
    h, ys = cache["h"], []
    for c in range(0, seq + pad, chunk):
        xc = xs[:, c:c + chunk]
        dt, bmat, cmat = _selective(p, xc, n)
        da, dbx = _discretize(p, dt * mask[:, c:c + chunk, None], xc, bmat)
        hs = _ssm_scan(da, dbx, h)
        h = hs[:, -1]
        y = torch.einsum("blcn,bln->blc", hs, cmat) + p["D"] * xc.to(torch.float32)
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :seq] * F.silu(z)
    return linear(y, p["out_proj"]), {"h": h, "conv": conv}


def mamba1_apply(p: dict, x: torch.Tensor, s: SSMConfig) -> torch.Tensor:
    """Full-sequence Mamba1 of x (B, S, D) from a zero state."""
    d_in = weight_shape(p["dt_proj"])[1]
    y, _ = mamba1_prefill(p, x, mamba1_cache_init(x.shape[0], d_in, s, x.device), s)
    return y


def mamba1_decode(p: dict, x: torch.Tensor, cache: dict, s: SSMConfig):
    """One token x (B, 1, D): the state ``cache`` advanced in place (the
    conv tail cast back to f32).  Returns (y (B, 1, D), cache)."""
    xs, z = linear(x, p["in_proj"]).chunk(2, dim=-1)
    xs, conv = _causal_conv(xs, p["conv_w"], cache["conv"])
    xs = F.silu(xs + p["conv_b"])
    dt, bmat, cmat = _selective(p, xs, s.state_dim)
    da, dbx = _discretize(p, dt, xs, bmat)
    h = cache["h"]
    h.mul_(da[:, 0]).add_(dbx[:, 0])
    cache["conv"].copy_(conv)
    return _out(p, h[:, None], cmat, xs, z, x.dtype), cache


def _conv_step_states(xp: torch.Tensor, t: int, k: int, dtype) -> torch.Tensor:
    """Per-step conv tails of a T-token window: ``xp`` is the conv input
    with its carry, ``cat([carry, x])`` (B, T+K-1, C); the tail after token
    j is ``xp[:, j+1 : j+K]``, what ``_causal_conv`` carries after j+1
    single steps.  Returns (B, T, K-1, C) in ``dtype``."""
    if k <= 1:
        return torch.zeros((xp.shape[0], t, 0, xp.shape[2]), dtype=dtype, device=xp.device)
    return torch.stack([xp[:, j + 1:j + k] for j in range(t)], dim=1).to(dtype)


def mamba1_verify(p: dict, x: torch.Tensor, cache: dict, s: SSMConfig):
    """A T-token window x (B, T, D) from the state ``cache``, which it
    leaves as it is: the per-token recurrence of T ``mamba1_decode`` steps,
    in their association, so greedy verification reproduces decode's
    tokens.  Returns (y (B, T, D), every step's state ``{"h": (B, T, d_in,
    N), "conv": (B, T, K-1, d_in)}``, step j the state after token j), from
    which ``models.lm.commit_verify`` selects each row's accepted step."""
    t = x.shape[1]
    k = p["conv_w"].shape[-1]
    xs, z = linear(x, p["in_proj"]).chunk(2, dim=-1)
    xp = torch.cat([cache["conv"].to(xs.dtype), xs], dim=1)
    conv_states = _conv_step_states(xp, t, k, cache["conv"].dtype)
    xs, _ = _causal_conv(xs, p["conv_w"], cache["conv"])
    xs = F.silu(xs + p["conv_b"])
    dt, bmat, cmat = _selective(p, xs, s.state_dim)
    da, dbx = _discretize(p, dt, xs, bmat)
    hs = _ssm_scan(da, dbx, cache["h"])
    return _out(p, hs, cmat, xs, z, x.dtype), {"h": hs, "conv": conv_states}

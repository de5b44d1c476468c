"""Mixture-of-Experts with capacity dispatch (twin of ``repro.models.moe``).

Each row of tokens is a dispatch group (a row longer than ``group_tokens``
is split into equal groups where its length divides), so a token's expert
buffer position and its capacity drop depend on its own row alone.  The
router is f32; each token takes its ``top_k`` experts, their
probabilities renormalised.  A (token, slot) pair's position in its
expert's buffer counts the earlier pairs of its group that chose the same
expert (in (token, slot) order), and a pair past the capacity C is
dropped.  Every expert's SwiGLU runs over its whole buffer with the stack
dequantized (``dq``) in x's dtype, as the JAX package does; the shared
experts are an MLP of ``n_shared * d_ff_expert`` through ``linear``.

Dispatch and combine are indexed where the JAX package contracts one-hot
tensors: each (e, row, c) buffer slot receives at most one token, so a
scatter into an (E * B * C + 1, D) buffer (the last row the trash slot of
dropped pairs) and a gather back are the one-hot einsums' values exactly,
in static shapes (no host read, so a decode step captures).  The top-k
combine sums over the fixed k axis in f32.  ``moe_apply_onehot`` is the
JAX package's einsums transcribed, the oracle the indexed form is held
against.

Public API:
  moe_init(gen, d, cfg, dtype, device, lead=()) -> params
  route(p, x, cfg)                              -> Routing
  moe_apply(p, x, cfg)                          -> (y, aux)
  moe_apply_onehot(p, x, cfg)                   -> (y, aux, keep)
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig

from .common import dense_init, dq, mlp_apply, mlp_init

GROUP_TOKENS = 4096  # default dispatch-group size (cfg.group_tokens overrides)


def moe_init(gen, d: int, cfg: MoEConfig, dtype, device, lead=()) -> dict:
    """The router (f32 whatever ``dtype``), the experts' stacks (E, d, f) /
    (E, f, d) and the shared experts' MLP; ``lead`` prepends stack dims."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": dense_init(gen, lead + (d, e), torch.float32, device),
        "gate": dense_init(gen, lead + (e, d, f), dtype, device),
        "up": dense_init(gen, lead + (e, d, f), dtype, device),
        "down": dense_init(gen, lead + (e, f, d), dtype, device),
    }
    if cfg.n_shared:
        p["shared"] = mlp_init(gen, d, cfg.n_shared * f, dtype, device, lead=lead)
    return p


def _capacity(sg: int, cfg: MoEConfig) -> int:
    c = int(sg * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, cfg.top_k)


def _groups(x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x (B, S, D) as its dispatch groups: a row longer than the group
    budget is split into ceil(S / budget) equal groups where that count
    divides S, and otherwise stays one group (with its larger capacity)."""
    b, s, d = x.shape
    gt = cfg.group_tokens or GROUP_TOKENS
    if s > gt:
        n = -(-s // gt)
        if s % n == 0:
            return x.reshape(b * n, s // n, d)
    return x


class Routing(NamedTuple):
    logits: torch.Tensor  # (B, S, E) f32 router logits
    probs: torch.Tensor   # (B, S, E) their softmax
    top_p: torch.Tensor   # (B, S, k) the chosen experts' renormalised probabilities
    top_i: torch.Tensor   # (B, S, k) int64 the chosen experts
    pos: torch.Tensor     # (B, S, k) int64 each pair's position in its expert's buffer
    keep: torch.Tensor    # (B, S, k) bool: pos < cap
    cap: int              # the capacity C of a group of S tokens


def route(p: dict, x: torch.Tensor, cfg: MoEConfig) -> Routing:
    """Routing of x (B, S, D), each row one dispatch group (``_groups``
    already applied): f32 router logits and softmax, top-k, the positions
    by a cumulative count over the flattened (S, k) order, and the pairs
    within capacity."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = x.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    sel = (top_i.reshape(b, s * k, 1) == torch.arange(e, device=x.device)).to(torch.int32)
    pos = (sel.cumsum(1) - 1).gather(2, top_i.reshape(b, s * k, 1)).reshape(b, s, k)
    cap = _capacity(s, cfg)
    return Routing(logits, probs, top_p, top_i, pos, pos < cap, cap)


def _aux(r: Routing, cfg: MoEConfig) -> dict:
    """GShard load-balance and router z losses."""
    e = cfg.n_experts
    me = r.probs.mean(dim=(0, 1))  # mean router probability per expert
    counts = torch.zeros(r.probs.shape, dtype=torch.float32, device=r.probs.device)
    counts.scatter_(-1, r.top_i, 1.0)  # each token's k experts are distinct
    ce = counts.mean(dim=(0, 1))  # fraction of tokens per expert
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    return {"load_balance": lb, "router_z": z,
            "aux_total": cfg.aux_loss * lb + cfg.router_z_loss * z}


def _experts(p: dict, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its buffer xe (E, rows, D), each stack
    dequantized whole in xe's dtype."""
    dt = xe.dtype
    h = F.silu(torch.bmm(xe, dq(p["gate"], dt))) * torch.bmm(xe, dq(p["up"], dt))
    return torch.bmm(h, dq(p["down"], dt))


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig) -> tuple[torch.Tensor, dict]:
    """x (B, S, D) -> (y (B, S, D), aux) with the load-balance and z losses.

    The (token, slot) pairs within capacity are scattered into their
    experts' buffers, (E, B, C) slots of one flat buffer whose last row
    takes the dropped pairs; each pair's expert output is gathered back in
    f32 (zero where dropped) and weighted by its probability, summed over
    the k slots, cast to x's dtype; then the shared experts are added."""
    b0, s0, d = x.shape
    xg = _groups(x, cfg)
    b, s, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(p, xg, cfg)
    rows = torch.arange(b, device=x.device).reshape(b, 1, 1)
    slot = torch.where(r.keep, (r.top_i * b + rows) * r.cap + r.pos, e * b * r.cap)
    slot = slot.reshape(-1)
    buf = xg.new_zeros((e * b * r.cap + 1, d))
    buf.index_copy_(0, slot, xg.unsqueeze(2).expand(b, s, k, d).reshape(-1, d))
    ye = _experts(p, buf[:-1].view(e, b * r.cap, d)).reshape(-1, d)
    got = ye.index_select(0, slot.clamp_max(e * b * r.cap - 1)).to(torch.float32)
    got = torch.where(r.keep.reshape(-1, 1), got, 0.0).reshape(b, s, k, d)
    y = (r.top_p.unsqueeze(-1) * got).sum(dim=2).to(x.dtype)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xg)
    return y.reshape(b0, s0, d), _aux(r, cfg)


def moe_apply_onehot(p: dict, x: torch.Tensor,
                     cfg: MoEConfig) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """The JAX package's ``moe_apply`` transcribed einsum for einsum: the
    one-hot selection, the f32 cumulative sum of positions, the dispatch
    tensor (B, S, E, C), the experts over it and the one-hot gather of the
    combine.  The oracle ``moe_apply`` is held against (its dispatch alone
    is B * S * E * C floats).  Returns (y, aux, keep (B', S', k) of the
    dispatch groups)."""
    b0, s0, d = x.shape
    x = _groups(x, cfg)
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(s, cfg)
    logits = x.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    sel = F.one_hot(top_i, e).to(torch.float32)  # (B, S, k, E)
    sel_flat = sel.reshape(b, s * k, e)
    pos_in_e = torch.cumsum(sel_flat, dim=1) - 1.0
    pos = torch.einsum("bte,bte->bt", pos_in_e, sel_flat).reshape(b, s, k)
    keep = (pos < cap).to(torch.float32)
    pos_oh = F.one_hot(pos.to(torch.int64).clamp(0, cap), cap + 1)[..., :cap]
    pos_oh = pos_oh.to(torch.float32) * keep[..., None]
    disp = torch.einsum("bske,bskc->bsec", sel, pos_oh)
    xe = torch.einsum("bsd,bsec->ebcd", x.to(torch.float32), disp).to(x.dtype)
    ye = _experts(p, xe.reshape(e, b * cap, d)).reshape(e, b, cap, d)
    ye_g = torch.einsum("ebcd,bske,bskc->bskd", ye.to(torch.float32), sel, pos_oh)
    y = torch.einsum("bsk,bskd->bsd", top_p, ye_g).to(x.dtype)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x)
    me = probs.mean(dim=(0, 1))
    ce = sel.sum(2).mean(dim=(0, 1))
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = {"load_balance": lb, "router_z": z,
           "aux_total": cfg.aux_loss * lb + cfg.router_z_loss * z}
    return y.reshape(b0, s0, d), aux, keep > 0

"""Serving with PIM-quantized weights: the fixed-batch greedy engine.

Twin of ``repro.serving.engine``'s ``quantize_tree`` and ``ServingEngine``.
``quantize_tree`` turns every large matmul weight into
``{"codes": int8, "scale": f32}`` (int4: nibble-packed codes plus a marker
leaf); at decode time each of those weights is streamed once per step by
the ``pim_matvec`` kernel.  ``ServingEngine.generate`` runs a single-pass
prefill and then one ``decode_step`` per new token in a Python loop, where
the JAX package runs one compiled program; ``generate_reference`` is the
per-token loop (prompt included), the parity oracle.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models.common import resolve_device
from repro_torch.quant import quantize_symmetric

# Leaves that stay dense: norms/gains/biases/scalars, router (accuracy-
# critical and tiny), conv kernels, SSM dynamics params.
_DENSE_KEYS = {"ln", "ln1", "ln2", "ln3", "ln_f", "conv_w", "conv_b", "A_log",
               "dt_bias", "D", "router", "gate_attn", "gate_mlp",
               "bq", "bk", "bv", "scale"}

# Metadata leaves — markers, not shipped storage: int4 packing flags and the
# tensor-parallel shard tag.
_MARKER_KEYS = ("nibbles", "nibbles_odd", "tp")


def _should_quantize(name: str, leaf: torch.Tensor) -> bool:
    if name in _DENSE_KEYS or leaf.dim() < 2:
        return False
    # embed tables are gathered, not matmul'd — keep dense (tied heads too).
    if name == "embed":
        return False
    return leaf.shape[-1] >= 8 and leaf.shape[-2] >= 8


def _quantize_leaf(leaf: torch.Tensor, bits: int):
    q = quantize_symmetric(leaf.to(torch.float32), bits=bits, axis=-2)
    if bits != 4:
        return {"codes": q.codes, "scale": q.scale}
    codes = q.codes
    odd = codes.shape[-2] % 2
    if odd:
        codes = torch.cat([codes, torch.zeros_like(codes[..., :1, :])], dim=-2)
    lo = codes[..., 0::2, :] & 0xF
    hi = codes[..., 1::2, :] & 0xF
    packed = (lo | (hi << 4)).to(torch.int8)
    marker = "nibbles_odd" if odd else "nibbles"
    return {"codes": packed, "scale": q.scale,
            marker: torch.zeros(packed.shape[:-2], dtype=torch.int8,
                                device=packed.device)}


def quantize_tree(params, bits: int = 8):
    """Convert matmul weights to PIM storage. Quantizes the last two dims
    (per-output-channel scales), keeping any leading stack dims.

    bits=4 packs two codes per byte along the K (contraction) dim.  An odd K
    is zero-padded by one code row before packing and flagged with the
    ``nibbles_odd`` marker, so ``dq``/``weight_shape`` drop the pad row.
    The marker leaf carries the leading stack dims."""

    def conv(name, leaf):
        if isinstance(leaf, dict):
            return {k: conv(k, v) for k, v in leaf.items()}
        if leaf is None or not _should_quantize(name, leaf):
            return leaf
        return _quantize_leaf(leaf, bits)

    return conv("", params)


def pim_bytes(params) -> int:
    """Device bytes of a (possibly quantized) parameter tree; the marker
    leaves are metadata and do not count."""
    total = 0
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            total += pim_bytes(leaf)
        elif leaf is not None and name not in _MARKER_KEYS:
            total += leaf.numel() * leaf.element_size()
    return total


def mask_after_stop(tokens: torch.Tensor, stop_tokens: Sequence[int],
                    pad_id: int = 0) -> torch.Tensor:
    """Replace every token emitted *after* a row's first stop token with
    ``pad_id`` (the stop token itself is kept).  tokens: (B, N)."""
    stop_tokens = tuple(stop_tokens)
    if not stop_tokens:
        return tokens
    hit = torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    for s in stop_tokens:
        hit = hit | (tokens == s)
    h = hit.to(torch.int32)
    stopped_before = (torch.cumsum(h, dim=1) - h) > 0
    return torch.where(stopped_before, torch.full_like(tokens, pad_id), tokens)


class ServingEngine:
    """Fixed-batch greedy engine: single-pass prefill, then one decode step
    per new token.  ``device=None`` means the card."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int,
                 pim_bits: int = 0, device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel decode (mesh=) is a later slice of the port "
                "(ROADMAP.md)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = quantize_tree(params, pim_bits) if pim_bits else params
        self.max_seq = max_seq

    def _check(self, prompt_tokens, n_new: int, greedy: bool):
        if not greedy:
            raise NotImplementedError(
                "sampled decoding (greedy=False) is a later slice of the port "
                "(ROADMAP.md)")
        s = prompt_tokens.shape[1]
        if s + n_new > self.max_seq:
            raise ValueError(
                f"prompt ({s}) + n_new ({n_new}) exceeds max_seq "
                f"({self.max_seq}); cache writes past max_seq would fail")
        return torch.as_tensor(prompt_tokens, device=self.device)

    @torch.inference_mode()
    def generate(self, prompt_tokens, n_new: int, greedy: bool = True,
                 stop_tokens: Sequence[int] = (), pad_id: int = 0,
                 speculate=None) -> torch.Tensor:
        """Greedy generation of ``n_new`` tokens for the whole batch
        (B, S) -> (B, n_new) int32.  ``tok0`` comes from the prefill logits, then
        ``n_new - 1`` decode steps each emit one more.  ``stop_tokens``
        masks every token a row emits after its first stop token with
        ``pad_id`` (the stop token itself is kept)."""
        if speculate is not None:
            raise NotImplementedError(
                "speculative decoding is a later slice of the port (ROADMAP.md)")
        prompt = self._check(prompt_tokens, n_new, greedy)
        b, s = prompt.shape
        if n_new == 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=self.device)
        cache = init_cache(self.cfg, b, self.max_seq, self.device)
        logits, cache = prefill(self.params, self.cfg, prompt, cache)
        return mask_after_stop(self._decode(logits, cache, s, n_new),
                               stop_tokens, pad_id)

    @torch.inference_mode()
    def generate_reference(self, prompt_tokens, n_new: int, greedy: bool = True,
                           stop_tokens: Sequence[int] = (),
                           pad_id: int = 0) -> torch.Tensor:
        """The per-token loop: one ``decode_step`` per prompt AND per
        generated token — the parity oracle for ``generate``."""
        prompt = self._check(prompt_tokens, n_new, greedy)
        b, s = prompt.shape
        if n_new == 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=self.device)
        cache = init_cache(self.cfg, b, self.max_seq, self.device)
        logits: Optional[torch.Tensor] = None
        for i in range(s):
            logits, cache = decode_step(self.params, self.cfg, prompt[:, i:i + 1],
                                        cache, i)
        return mask_after_stop(self._decode(logits, cache, s, n_new),
                               stop_tokens, pad_id)

    def _decode(self, logits, cache, s: int, n_new: int) -> torch.Tensor:
        """Emit tok0 from the prompt's last logits, then run ``n_new - 1``
        decode steps from position ``s`` on, each emitting one int32 token
        (the JAX package's token dtype)."""
        tok = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
        out = [tok]
        for i in range(n_new - 1):
            logits, cache = decode_step(self.params, self.cfg, tok, cache, s + i)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
            out.append(tok)
        return torch.cat(out, dim=1)

"""Seeded random weights at full size, drawn a slice at a time.

``init_params`` draws each stacked leaf whole in f32, which does not fit
the card for the larger configs (starcoder2-15b's stacked ``gate`` is 24 GB
in f32).  ``layerwise_params`` draws the same tree one (K, N) slice at a
time; ``quantized_params`` draws the same values and quantizes each slice
as it is drawn, so the bf16 tree never exists whole (llama-3.2-vision-90b's
16 groups are 137 GB in bf16 and 68 GB at int8).  Both draw every weight
as N(0, 0.02) from ``gen`` (on the device the tree is made on), in the
order of ``init_params``' tree, norms one, biases and gates zero, and an
untied head as ``init_params`` lays it out, the transpose of a (vocab, d)
draw; an SSM block's dynamics as ``init_params`` sets them (``A_log`` =
log(1..N), ``D`` = 1, ``dt_bias`` = -4.6, its conv drawn at scale 0.5); the two give equal values from equal generators:
``quantized_params(cfg, gen, bits)`` is ``quantize_tree(layerwise_params(
cfg, gen), bits)`` bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.quant import quantize_slices, should_quantize

from .lm import init_params

_ONES = ("ln", "ln1", "ln2", "ln3", "ln_f", "D")
_ZEROS = ("bq", "bk", "bv", "gate_attn", "gate_mlp", "conv_b")
_SCALES = {"conv_w": 0.5}  # every other weight: 0.02


def _draw(gen, shape, dtype, scale=0.02):
    return torch.randn(shape, generator=gen, device=gen.device).mul_(scale).to(dtype)


def _walk(cfg: ModelConfig, gen, weight):
    """``init_params``' tree for ``cfg`` on ``gen``'s device, each leaf made
    in tree order: norms, biases and gates filled, the embedding drawn
    whole, and every other leaf ``weight(name, meta, slice_of)``, where
    ``slice_of(idx)`` draws the (K, N) slice at an index of its leading
    dims (the untied head's whole transposed view at ``()``)."""
    dev = gen.device

    def fill(name, meta):
        if name in _ONES:
            return torch.ones(meta.shape, dtype=meta.dtype, device=dev)
        if name in _ZEROS:
            return torch.zeros(meta.shape, dtype=meta.dtype, device=dev)
        if name == "dt_bias":
            return torch.full(meta.shape, -4.6, dtype=meta.dtype, device=dev)
        if name == "A_log":
            n = meta.shape[-1]
            a_log = torch.log(torch.arange(1, n + 1, dtype=meta.dtype, device=dev))
            return a_log.expand(meta.shape).contiguous()
        if name == "embed":
            return _draw(gen, meta.shape, meta.dtype)
        if name == "head":
            return weight(name, meta, lambda idx: _draw(gen, meta.shape[::-1], meta.dtype).T)
        scale = _SCALES.get(name, 0.02)
        return weight(name, meta, lambda idx: _draw(gen, meta.shape[-2:], meta.dtype, scale))

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else fill(k, v) for k, v in tree.items()}
    return walk(init_params(cfg, torch.Generator(), device="meta"))


def _stacked(meta, slice_of, device) -> torch.Tensor:
    """The leaf of ``meta``'s shape made of its drawn (K, N) slices; a 2-D
    leaf (the head, a view of one draw) as it is drawn."""
    if meta.dim() == 2:
        return slice_of(())
    out = torch.empty(meta.shape, dtype=meta.dtype, device=device)
    for idx in np.ndindex(*meta.shape[:-2]):
        out[idx] = slice_of(idx)
    return out


def layerwise_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """``init_params``' tree, every weight drawn one (K, N) slice at a time
    into its preallocated stack."""
    return _walk(cfg, gen, lambda name, meta, slice_of: _stacked(meta, slice_of, gen.device))


def quantized_params(cfg: ModelConfig, gen: torch.Generator, bits: int) -> dict:
    """``quantize_tree(layerwise_params(cfg, gen), bits)``, each weight's
    slices drawn and quantized one at a time (``quantize_slices``); a leaf
    ``quantize_tree`` keeps dense is drawn as ``layerwise_params`` draws
    it."""
    def weight(name, meta, slice_of):
        if not should_quantize(name, meta):
            return _stacked(meta, slice_of, gen.device)
        return quantize_slices(tuple(meta.shape[:-2]), *meta.shape[-2:], slice_of, bits,
                               gen.device)
    return _walk(cfg, gen, weight)

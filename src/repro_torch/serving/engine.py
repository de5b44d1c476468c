"""Serving with PIM-quantized weights: the fixed-batch engine.

Twin of ``repro.serving.engine``'s ``quantize_tree``, ``sample_logits`` and
``ServingEngine``.  ``quantize_tree`` turns every large matmul weight into
``{"codes": int8, "scale": f32}`` (int4: nibble-packed codes plus a marker
leaf); at decode time each of those weights is streamed once per step by
the ``pim_matvec`` kernel.

``ServingEngine.generate`` is the JAX package's one program
(``_generate_body``) for the dense family: an eager prefill, then
``n_new - 1`` runs of ONE step function, ``decode_and_emit`` (decode one
token, sample the next, write it at the draw index, advance the position
and the index).  The step works on static buffers (``DecodeState``), so on
the card the engine captures it once in a CUDA graph and each decode step is
one replay; on the CPU the same function runs eagerly.  Sampled draws are
keyed per row and per draw index with the JAX package's own keys
(``serving.sampling``).  ``generate_reference`` is the per-token loop
(prompt included), the parity oracle.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, decode_step, init_cache, prefill
from repro_torch.models.common import dtype_of, resolve_device
from repro_torch.quant import quantize_symmetric

from .sampling import (TAG_TOKEN, draw_keys, fold_in, gumbel, prng_key, row_keys,
                       sample_rows, warp_logits)

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


def sample_logits(logits: torch.Tensor, key, *, greedy: bool, temperature,
                  top_k: int) -> torch.Tensor:
    """logits (..., V) -> int32 token ids (...): greedy argmax, or
    temperature/top-k categorical sampling with ONE key (``prng_key``'s
    argument) for the whole batch, as ``jax.random.categorical(key, warped,
    axis=-1)`` draws it.  The engine's decode loop uses ``sample_rows`` with
    per-row keys instead; this stays as the one-shot helper."""
    if greedy:
        return logits.argmax(dim=-1).to(torch.int32)
    lg = warp_logits(logits, temperature, top_k)
    noise = gumbel(prng_key(key, lg.device)[None], lg.numel()).reshape(lg.shape)
    return (noise + lg).argmax(dim=-1).to(torch.int32)


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


def _tensors(tree):
    for leaf in tree.values():
        if isinstance(leaf, dict):
            yield from _tensors(leaf)
        elif isinstance(leaf, torch.Tensor):
            yield leaf


class DecodeState:
    """The static buffers of one batch's generation, in device memory that a
    captured step reads on every replay: the cache, the last token (B, 1)
    int32, the position and the draw index (0-d int64), each row's key of
    the token stream (B, 2), the temperature (0-d f32), the tokens emitted
    so far (B, max_seq) int32 (column j holds draw j), and the last logits
    (B, V)."""

    def __init__(self, cfg: ModelConfig, batch: int, max_seq: int, device):
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.cache = init_cache(cfg, batch, max_seq, device)
        self.tok = zeros((batch, 1), torch.int32)
        self.pos = zeros((), torch.int64)
        self.idx = zeros((), torch.int64)
        self.keys = zeros((batch, 2), torch.int64)
        self.temperature = zeros((), torch.float32)
        self.out = zeros((batch, max_seq), torch.int32)
        self.logits = zeros((batch, cfg.vocab), dtype_of(cfg.param_dtype))

    def start(self, params, cfg: ModelConfig, prompt: torch.Tensor, key, temperature,
              *, greedy: bool, top_k: int) -> None:
        """Zero the cache (a fresh ``init_cache``'s), prefill ``prompt``
        (B, S) and emit draw 0 from its last logits; the position is then S
        and the draw index 1.  ``key``: ``prng_key``'s argument, None for
        ``PRNGKey(0)``'s key data."""
        for leaf in self.cache["layers"].values():
            leaf.zero_()
        logits, _ = prefill(params, cfg, prompt, self.cache)
        b, s = prompt.shape
        base = prng_key(0 if key is None else key, prompt.device)
        self.keys.copy_(row_keys(base, torch.arange(b, device=prompt.device), TAG_TOKEN))
        self.temperature.fill_(temperature)
        self.pos.fill_(s)
        self.idx.zero_()
        self.logits.copy_(logits[:, -1])
        _emit(self, greedy=greedy, top_k=top_k)


def _emit(st: DecodeState, *, greedy: bool, top_k: int) -> None:
    """Draw token ``st.idx`` of every row from ``st.logits`` (key
    ``fold_in(row key, idx)``), write it to ``st.out`` and ``st.tok``, and
    advance the draw index."""
    keys = None if greedy else fold_in(st.keys, st.idx)
    tok = sample_rows(st.logits, keys, greedy=greedy, temperature=st.temperature,
                      top_k=top_k)
    st.tok.copy_(tok[:, None])
    st.out.index_copy_(1, st.idx.reshape(1), st.tok)
    st.idx += 1


def decode_and_emit(params, cfg: ModelConfig, st: DecodeState, *, greedy: bool,
                    top_k: int) -> None:
    """The step ``generate`` runs ``n_new - 1`` times: decode ``st.tok`` at
    ``st.pos``, keep its logits, advance the position, then emit the next
    draw.  It reads and writes only ``st``'s buffers and the parameters,
    so a CUDA graph of it replays the whole step."""
    logits, _ = decode_step(params, cfg, st.tok, st.cache, st.pos)
    st.logits.copy_(logits[:, -1])
    st.pos += 1
    _emit(st, greedy=greedy, top_k=top_k)


class ServingEngine:
    """Fixed-batch engine: single-pass prefill, then one decode step per new
    token, each step one CUDA graph replay on the card.  ``device=None``
    means the card."""

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
        self._states: dict[int, DecodeState] = {}
        self._steps: dict[tuple, Callable[[], None]] = {}
        self._steps_params: Optional[tuple] = None
        self._pools: dict[int, tuple] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def _check(self, prompt_tokens, n_new: int, extras, speculate=None):
        if extras is not None:
            raise NotImplementedError(
                "extras (vlm / encdec inputs) come with the other families, a "
                "later slice of the port (ROADMAP.md)")
        if speculate is not None:
            raise NotImplementedError(
                "speculative decoding is a later slice of the port (ROADMAP.md)")
        s = prompt_tokens.shape[1]
        if s + n_new > self.max_seq:
            raise ValueError(
                f"prompt ({s}) + n_new ({n_new}) exceeds max_seq "
                f"({self.max_seq}); cache writes past max_seq would fail")
        return torch.as_tensor(prompt_tokens, device=self.device)

    def state(self, batch: int) -> DecodeState:
        """The engine's static buffers for a batch of ``batch`` rows (made at
        first use and kept: its captured steps read them)."""
        if batch not in self._states:
            self._states[batch] = DecodeState(self.cfg, batch, self.max_seq, self.device)
        return self._states[batch]

    def step(self, batch: int, *, greedy: bool, top_k: int):
        """The decode step of ``batch`` rows as a call with no arguments.  On
        the CPU, ``decode_and_emit`` on the current parameters.  On the card,
        one replay of its CUDA graph, captured at the first call for this
        batch, sampling mode and dispatch mode into the pool of the batch's
        buffers (its steps never run at the same time), and captured again
        once any parameter leaf has been replaced (a graph reads the memory
        it was captured on)."""
        top_k = 0 if greedy else int(top_k)
        st = self.state(batch)
        run = functools.partial(decode_and_emit, self.params, self.cfg, st,
                                greedy=bool(greedy), top_k=top_k)
        if self.device.type != "cuda":
            return run
        leaves = tuple((t.data_ptr(), t.dtype, tuple(t.shape), t.stride())
                       for t in _tensors(self.params))
        if leaves != self._steps_params:
            self._steps.clear()
            self._steps_params = leaves
        key = (batch, bool(greedy), top_k, common.matvec_dispatch())
        if key not in self._steps:
            if batch not in self._pools:
                self._pools[batch] = torch.cuda.graph_pool_handle()
            self._warm_up(st, run)
            self._steps[key] = self._capture(run, self._pools[batch]).replay
        return self._steps[key]

    def _warm_up(self, st: DecodeState, run) -> None:
        """Run the step once outside the capture, on the capture's stream:
        kernel builds and loads, cuBLAS handles and workspaces, the
        allocator.  It writes ``st``, which ``DecodeState.start`` resets."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        st.pos.zero_()
        st.idx.zero_()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            run()
        torch.cuda.current_stream(self.device).wait_stream(self._stream)

    def _capture(self, run, pool) -> torch.cuda.CUDAGraph:
        """Capture one call of ``run`` into the memory pool ``pool`` (the
        kernels it launches are recorded, not run).  A failed capture
        raises."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=self._stream):
            run()
        return graph

    @torch.inference_mode()
    def generate(self, prompt_tokens, n_new: int, extras: Optional[dict] = None,
                 greedy: bool = True, temperature: float = 1.0, top_k: int = 0,
                 key=None, stop_tokens: Sequence[int] = (), pad_id: int = 0,
                 speculate=None) -> torch.Tensor:
        """Generate ``n_new`` tokens for the whole batch, (B, S) -> (B,
        n_new) int32.  Draw 0 comes from the prefill logits, then ``n_new -
        1`` decode steps each emit one more (``step``).  greedy=False
        samples with ``temperature`` and optional ``top_k`` filtering, draw
        i of row r keyed by ``draw_keys(key, r, i, TAG_TOKEN)``; ``key`` is
        ``jax.random.PRNGKey``'s key data or an int seed (None:
        ``PRNGKey(0)``), so the draws are the JAX package's.
        ``stop_tokens`` masks every token a row emits after its first stop
        token with ``pad_id`` (the stop token itself is kept)."""
        prompt = self._check(prompt_tokens, n_new, extras, speculate)
        b = prompt.shape[0]
        if n_new == 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=self.device)
        step = self.step(b, greedy=greedy, top_k=top_k)
        st = self.state(b)
        st.start(self.params, self.cfg, prompt, key, temperature, greedy=greedy, top_k=top_k)
        for _ in range(n_new - 1):
            step()
        return mask_after_stop(st.out[:, :n_new].clone(), stop_tokens, pad_id)

    @torch.inference_mode()
    def generate_reference(self, prompt_tokens, n_new: int,
                           extras: Optional[dict] = None, greedy: bool = True,
                           temperature: float = 1.0, top_k: int = 0, key=None,
                           stop_tokens: Sequence[int] = (),
                           pad_id: int = 0) -> torch.Tensor:
        """The per-token loop: one eager ``decode_step`` per prompt AND per
        generated token, each sampled with ``draw_keys`` of the same
        ``(key, row, draw index)`` as ``generate`` — the parity oracle."""
        prompt = self._check(prompt_tokens, n_new, extras)
        b, s = prompt.shape
        if n_new == 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=self.device)
        cache = init_cache(self.cfg, b, self.max_seq, self.device)
        base = prng_key(0 if key is None else key, self.device)
        rids = torch.arange(b, device=self.device)

        def draw(logits, idx):
            keys = None if greedy else draw_keys(base, rids, idx, TAG_TOKEN)
            return sample_rows(logits[:, -1], keys, greedy=greedy,
                               temperature=temperature, top_k=top_k)[:, None]

        logits: Optional[torch.Tensor] = None
        for i in range(s):
            logits, cache = decode_step(self.params, self.cfg, prompt[:, i:i + 1],
                                        cache, i)
        out = [draw(logits, 0)]
        for j in range(n_new - 1):
            logits, cache = decode_step(self.params, self.cfg, out[-1], cache, s + j)
            out.append(draw(logits, j + 1))
        return mask_after_stop(torch.cat(out, dim=1), stop_tokens, pad_id)

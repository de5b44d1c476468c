"""Serving with PIM-quantized weights: the fixed-batch engine and the
continuous-batching engine over a paged KV cache.

Twin of ``repro.serving.engine``'s ``quantize_tree``, ``sample_logits``,
``ServingEngine``, ``Request`` and ``ContinuousBatchingEngine`` (the dense
family, without speculation, the prefix cache, a resilience policy or a
mesh).  ``quantize_tree`` turns every large matmul weight into
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

``ContinuousBatchingEngine.serve`` schedules requests on the host in numpy,
as the reference does, and runs each round's decode chunk (the reference's
``_decode_chunk_body`` scan) as ``chunk`` runs of ``decode_chunk_step`` on
static buffers (``ChunkState``): on the card each run is one replay of a
graph kept by ``CapturedSteps``, the capture helper both engines share.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, decode_step, init_cache, init_paged_cache, prefill
from repro_torch.models.common import dtype_of, resolve_device
from repro_torch.quant import quantize_symmetric

from .prefix import PagePool
from .resilience import RequestRecord, ServeReport
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


# Options of the JAX package's engines that the port does not run yet, and the
# ROADMAP.md item (section 1) that brings each.
_LATER = {"mesh": "item 7 (tensor-parallel decode)",
          "speculate": "item 4 (speculative decoding)",
          "draft_cfg": "item 4 (speculative decoding)",
          "draft_params": "item 4 (speculative decoding)",
          "draft_pim_bits": "item 4 (speculative decoding)",
          "prefix_cache": "item 2b (the prefix cache)",
          "extras": "item 5 (the vlm and encdec families)",
          "policy": "item 2c (the resilience tier)",
          "chaos": "item 2c (the resilience tier)",
          "resume": "item 2c (the resilience tier)",
          "heartbeat": "item 2c (the resilience tier)"}


def _unported(**options) -> None:
    """Raise NotImplementedError for the first option given a value (not
    None, False or 0), naming the ROADMAP item that ports it."""
    for name, value in options.items():
        if value is not None and value is not False and value != 0:
            raise NotImplementedError(
                f"{name}= is not ported yet: ROADMAP.md section 1, {_LATER[name]}")


class CapturedSteps:
    """The step functions an engine keeps as CUDA graphs on the card.

    ``get`` returns a step as a call with no arguments: on the CPU the step
    function itself (nothing is kept); on the card one replay of its graph,
    captured at the first call for its key and the matvec dispatch mode.
    Before a capture the step runs once on a side stream (kernel builds and
    loads, cuBLAS handles and workspaces, the allocator), after ``reset``
    has put its buffers where a run may start.  The graphs of one buffer set
    (``pool_key``) share one graph memory pool, since their steps never run
    at the same time.  A graph reads the memory it was captured on, so every
    kept step is dropped when any parameter leaf's pointer, dtype, shape or
    stride changes.  A failed capture raises."""

    def __init__(self, device: torch.device):
        self.device = device
        self._steps: dict[tuple, Callable[[], None]] = {}
        self._params: Optional[tuple] = None
        self._pools: dict = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def get(self, params, key: tuple, pool_key, run: Callable[[], None],
            reset: Callable[[], object]) -> Callable[[], None]:
        if self.device.type != "cuda":
            return run
        leaves = tuple((t.data_ptr(), t.dtype, tuple(t.shape), t.stride())
                       for t in _tensors(params))
        if leaves != self._params:
            self._steps.clear()
            self._params = leaves
        key = key + (common.matvec_dispatch(),)
        if key not in self._steps:
            if pool_key not in self._pools:
                self._pools[pool_key] = torch.cuda.graph_pool_handle()
            self._warm_up(run, reset)
            self._steps[key] = self._capture(run, self._pools[pool_key]).replay
        return self._steps[key]

    def _warm_up(self, run, reset) -> None:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        reset()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            run()
        torch.cuda.current_stream(self.device).wait_stream(self._stream)

    def _capture(self, run, pool) -> torch.cuda.CUDAGraph:
        """Capture one call of ``run`` into the memory pool ``pool`` (the
        kernels it launches are recorded, not run)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=self._stream):
            run()
        return graph


class ServingEngine:
    """Fixed-batch engine: single-pass prefill, then one decode step per new
    token, each step one CUDA graph replay on the card.  ``device=None``
    means the card."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int,
                 pim_bits: int = 0, device=None, mesh=None):
        _unported(mesh=mesh)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = quantize_tree(params, pim_bits) if pim_bits else params
        self.max_seq = max_seq
        self._states: dict[int, DecodeState] = {}
        self.graphs = CapturedSteps(self.device)

    def _check(self, prompt_tokens, n_new: int, extras, speculate=None):
        _unported(extras=extras, speculate=speculate)
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
        """The decode step of ``batch`` rows as a call with no arguments
        (``CapturedSteps.get``): ``decode_and_emit`` on the current
        parameters, kept on the card per batch, sampling mode and dispatch
        mode, one graph memory pool per batch's buffers.  Its warm-up writes
        the buffers, which ``DecodeState.start`` resets."""
        top_k = 0 if greedy else int(top_k)
        st = self.state(batch)
        run = functools.partial(decode_and_emit, self.params, self.cfg, st,
                                greedy=bool(greedy), top_k=top_k)

        def reset():
            st.pos.zero_()
            st.idx.zero_()
        return self.graphs.get(self.params, (batch, bool(greedy), top_k), batch, run, reset)

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


# ===================================================== continuous batching ==
@dataclasses.dataclass
class Request:
    """One generation request for ``ContinuousBatchingEngine.serve``.
    ``rid`` keys the request's sampled draws (default: its index in the
    trace).  ``arrival``, ``deadline`` and ``slo`` matter under a resilience
    policy only (ROADMAP.md section 1, item 2c); ``extras`` must be None
    until the families that take them are ported."""

    prompt: np.ndarray  # (len,) int32 token ids
    max_new: int  # emit at most this many tokens (>= 1)
    stop_tokens: tuple = ()  # retire early after emitting any of these
    extras: Optional[dict] = None
    arrival: float = 0.0
    deadline: Optional[float] = None
    slo: int = 1
    rid: Optional[int] = None


def admit_prefill(params, cfg: ModelConfig, cache: dict, prompt: torch.Tensor,
                  length: int, slot: int, pages: torch.Tensor, rid: int,
                  key: torch.Tensor, temperature, *, greedy: bool, top_k: int) -> torch.Tensor:
    """Admit one request (the JAX package's ``_admit_body``): a batch-1
    prefill of the page-padded ``prompt`` (1, S) straight into the slot's
    pool pages, then draw 0 from the logits at the true prompt end with the
    request's ``(rid, 0)`` key.  Returns the token, a 0-d int32 tensor."""
    logits, _ = prefill(params, cfg, prompt, cache, length=length, pages=pages, slot=slot)
    keys = None if greedy else draw_keys(
        key, torch.tensor([rid], device=prompt.device), 0, TAG_TOKEN)
    return sample_rows(logits[:, length - 1], keys, greedy=greedy,
                       temperature=temperature, top_k=top_k)[0]


class ChunkState:
    """The static buffers of the continuous engine's decode chunk, in device
    memory that a captured chunk step reads on every replay: the paged cache
    (pools and block tables); per slot the current token (B, 1) int32, the
    position, emitted count and draw budget (B,) int64, the done flag (B,)
    bool and the row key of its token stream (B, 2); the temperature (0-d
    f32); the iteration within the round (0-d int64); the round's emissions
    and liveness, (chunk, B); and the stop tokens, (B, n) int32 for each
    number n of stop columns a trace needs."""

    def __init__(self, cfg: ModelConfig, slots: int, store_seq: int, num_pages: int,
                 page_size: int, chunk: int, device):
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.cache = init_paged_cache(cfg, slots, store_seq, num_pages, page_size, device)
        self.tok = zeros((slots, 1), torch.int32)
        self.pos = zeros((slots,), torch.int64)
        self.n_out = zeros((slots,), torch.int64)
        self.max_new = zeros((slots,), torch.int64)
        self.done = zeros((slots,), torch.bool)
        self.keys = zeros((slots, 2), torch.int64)
        self.temperature = zeros((), torch.float32)
        self.it = zeros((), torch.int64)
        self.emits = zeros((chunk, slots), torch.int32)
        self.lives = zeros((chunk, slots), torch.bool)
        self._stops: dict[int, torch.Tensor] = {}

    def stops(self, n: int) -> torch.Tensor:
        if n not in self._stops:
            self._stops[n] = torch.full((self.tok.shape[0], n), -1, dtype=torch.int32,
                                        device=self.tok.device)
        return self._stops[n]

    def zero_(self) -> None:
        """Every buffer as a fresh state holds it (the reference makes a fresh
        cache for every serve; a captured step must keep its memory)."""
        for t in (*self.cache["layers"].values(), self.cache["block_tables"], self.tok,
                  self.pos, self.n_out, self.max_new, self.done, self.keys,
                  self.temperature, self.it, self.emits, self.lives):
            t.zero_()
        for t in self._stops.values():
            t.fill_(-1)


def decode_chunk_step(params, cfg: ModelConfig, st: ChunkState, stops: torch.Tensor, *,
                      greedy: bool, top_k: int, pad_id: int) -> None:
    """One iteration of the JAX package's decode chunk (``_decode_chunk_body``)
    on ``st``'s buffers: decode every slot's token at its own position
    (paged), draw the next with ``draw_keys(key, rid, n_out)``, write it
    (``pad_id`` for a done slot) and the slot's liveness to row ``st.it`` of
    the round's emissions, advance the live slots' position and count, and
    mark done the slots that emitted a stop token (``stops``) or reached
    their budget.  Done and inactive slots keep stepping; their writes land
    in their own pages or the trash page, and their emissions are masked."""
    logits, _ = decode_step(params, cfg, st.tok, st.cache, st.pos)
    keys = None if greedy else fold_in(st.keys, st.n_out)
    nxt = sample_rows(logits[:, -1], keys, greedy=greedy, temperature=st.temperature,
                      top_k=top_k)
    live = ~st.done
    emit = torch.where(live, nxt, pad_id)
    row = st.it.reshape(1)
    st.emits.index_copy_(0, row, emit[None])
    st.lives.index_copy_(0, row, live[None])
    st.pos += live
    st.n_out += live
    hit = (emit[:, None] == stops).any(dim=1)
    st.done |= (live & hit) | (st.n_out >= st.max_new)
    st.tok.copy_(emit[:, None])
    st.it += 1


class ContinuousBatchingEngine:
    """Continuous-batching scheduler over a paged KV cache (twin of the JAX
    package's, for the dense family, without a resilience policy,
    speculation, the prefix cache or a mesh).

    ``slots`` is the decode batch width; ``num_pages`` bounds the cache
    (pages of ``page_size`` tokens, page 0 the trash page; default: every
    slot's worst case); ``max_seq`` caps one request's ``prompt + max_new``;
    ``chunk`` is the number of decode steps between host scheduling points.
    ``page_alloc_seed`` shuffles the free list, so block tables are random
    permutations of the pool (and the JAX package's, for the same seed).
    ``clock`` is a 0-arg monotonic-seconds callable (``time.monotonic``).

    The host schedules in numpy as the reference does.  Each round: admit
    queued requests into free slots while pages last (an eager batch-1
    prefill into the slot's pages, ``admit_prefill``), retire what finished
    at admit, extend every live slot's pages to cover the chunk (``_top_up``,
    preempting the youngest when the pool runs dry), copy the block tables
    and per-slot arrays into the static buffers (``ChunkState``), run
    ``chunk`` chunk steps (``decode_chunk_step``), each one replay of a CUDA
    graph on the card, and read the buffers back once.

    The cache and buffers are made at the first serve and kept, zeroed at
    every later one: a captured step reads the memory it was captured on
    (the reference makes a fresh cache each serve)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int, max_seq: int,
                 page_size: int = 8, num_pages: Optional[int] = None, chunk: int = 8,
                 pim_bits: int = 0, pad_id: int = 0, page_alloc_seed: Optional[int] = None,
                 mesh=None, speculate=None, draft_cfg: Optional[ModelConfig] = None,
                 draft_params=None, draft_pim_bits: int = 0, clock=None,
                 prefix_cache: bool = False, device=None):
        _unported(mesh=mesh, speculate=speculate, draft_cfg=draft_cfg,
                  draft_params=draft_params, draft_pim_bits=draft_pim_bits,
                  prefix_cache=prefix_cache)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = quantize_tree(params, pim_bits) if pim_bits else params
        self._clock = clock if clock is not None else time.monotonic
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.max_seq = -(-int(max_seq) // self.page_size) * self.page_size
        self.width = self.max_seq // self.page_size
        self.num_pages = int(num_pages) if num_pages is not None else self.slots * self.width + 1
        self.chunk = int(chunk)
        self.pad_id = int(pad_id)
        self._rng = (np.random.default_rng(page_alloc_seed)
                     if page_alloc_seed is not None else None)
        self._state: Optional[ChunkState] = None
        self.graphs = CapturedSteps(self.device)
        self._pool_poisoned = False
        self._records = None
        self._now = lambda: 0.0
        self.last_report: Optional[ServeReport] = None
        self.prefill_tokens = 0
        self.peak_pages_in_use = 0
        self.preemptions = 0
        # chunk iterations run: each streams the weights once, so emitted
        # tokens over decode_chunk_iters is the weight-stream amortisation
        self.decode_chunk_iters = 0

    # ------------------------------------------------------------- helpers --
    def _spad(self, length: int) -> int:
        """Prompt length padded up to a whole number of pages."""
        ps = self.page_size
        return max(ps, -(-length // ps) * ps)

    def pages_in_use(self) -> int:
        """Pages with live block-table references."""
        return self._pool.in_use()

    def _alloc_pages(self, n: int) -> list[int]:
        return self._pool.alloc(n)

    def _free_pages(self, pages: list[int]) -> None:
        for p in pages:
            self._pool.release(p)

    def assert_quiescent(self) -> None:
        """With no live slots, every page is unreferenced and on the free
        list exactly once (``PagePool.assert_quiescent``).  A serve that
        ended mid-round leaves the pool poisoned until the next serve."""
        if self._pool_poisoned:
            raise AssertionError(
                "page pool poisoned: a serve trace aborted mid-round, so allocator "
                "state is mid-flight, not quiescent; start a new serve (or _reset) "
                "before asserting invariants")
        self._pool.assert_quiescent()

    def chunk_step(self, n_stops: int, *, greedy: bool, top_k: int):
        """The chunk step as a call with no arguments (``CapturedSteps.get``):
        ``decode_chunk_step`` on the current parameters, kept on the card
        per (slots, greedy, top_k, n_stops) and dispatch mode, all in one
        graph memory pool.  Its warm-up writes the buffers, which every
        round's ``_load`` overwrites; with a zeroed state its cache writes
        land in the trash page."""
        st = self._state
        top_k = 0 if greedy else int(top_k)
        run = functools.partial(decode_chunk_step, self.params, self.cfg, st, st.stops(n_stops),
                                greedy=bool(greedy), top_k=top_k, pad_id=self.pad_id)
        return self.graphs.get(self.params, (self.slots, bool(greedy), top_k, n_stops),
                               "chunk", run, st.it.zero_)

    # ------------------------------------------------------------ lifecycle --
    @torch.inference_mode()
    def _reset(self, requests, n_stops: int) -> None:
        b, w = self.slots, self.width
        if self._state is None:
            self._state = ChunkState(self.cfg, b, self.max_seq, self.num_pages,
                                     self.page_size, self.chunk, self.device)
        else:
            self._state.zero_()
        self._pool = PagePool(self.num_pages, rng=self._rng)
        self._pool_poisoned = False
        self._bt = np.zeros((b, w), np.int32)
        self._pos = np.zeros(b, np.int64)
        self._n_out = np.zeros(b, np.int64)
        self._done = np.ones(b, bool)  # inactive slots are "done"
        self._max_new = np.zeros(b, np.int64)
        self._stops = np.full((b, n_stops), -1, np.int32)
        self._tok = np.zeros((b, 1), np.int32)
        self._keys = np.zeros((b, 2), np.int64)  # row key of each slot's draws
        self._slot_req = [-1] * b
        self._slot_pages: list[list[int]] = [[] for _ in range(b)]
        self._admit_seq = [-1] * b
        self._seq = 0
        self._outputs = [[] for _ in requests]
        self._queue = deque(range(len(requests)))

    def _admit_page_need(self, req) -> int:
        """Pages the admit allocates: the padded prompt's.  Admission is
        optimistic (the first chunk's growth is not counted): if the round's
        ``_top_up`` then finds the pool dry, the youngest slot yields."""
        return self._spad(len(req.prompt)) // self.page_size

    def _admit(self, requests, slot: int, ridx: int, key: torch.Tensor, greedy: bool,
               temperature, top_k: int) -> dict:
        """Admit request ``ridx`` into ``slot`` (the uncached admit): its
        padded prompt's pages, an eager ``admit_prefill`` into them, and its
        first token (draw 0).  Returns the admit event's fields."""
        req = requests[ridx]
        length = len(req.prompt)
        rid = ridx if req.rid is None else int(req.rid)
        spad = self._spad(length)
        pages = self._pool.alloc(spad // self.page_size)
        self._bt[slot, :] = 0
        self._bt[slot, : len(pages)] = pages
        prompt = np.zeros((1, spad), np.int32)
        prompt[0, :length] = np.asarray(req.prompt, np.int32)
        tok0 = int(admit_prefill(
            self.params, self.cfg, self._state.cache,
            torch.from_numpy(prompt).to(self.device), length, slot,
            torch.tensor(pages, dtype=torch.int64, device=self.device), rid, key,
            temperature, greedy=greedy, top_k=top_k))
        self.prefill_tokens += length
        stops = tuple(req.stop_tokens)
        self._outputs[ridx] = [tok0]
        self._pos[slot] = length
        self._n_out[slot] = 1
        self._max_new[slot] = req.max_new
        self._stops[slot, :] = -1
        self._stops[slot, : len(stops)] = stops
        self._tok[slot, 0] = tok0
        self._keys[slot] = row_keys(key, torch.tensor([rid], device=self.device),
                                    TAG_TOKEN)[0].cpu().numpy()
        self._done[slot] = req.max_new <= 1 or tok0 in stops
        self._slot_req[slot] = ridx
        self._slot_pages[slot] = list(pages)
        self._admit_seq[slot] = self._seq
        self._seq += 1
        return {"cached_tokens": 0, "prefilled_tokens": length, "cow": False}

    def _retire(self, slot: int) -> None:
        self._free_pages(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._slot_req[slot] = -1
        self._admit_seq[slot] = -1
        self._bt[slot, :] = 0
        self._pos[slot] = 0
        self._n_out[slot] = 0
        self._max_new[slot] = 0
        self._stops[slot, :] = -1
        self._keys[slot] = 0
        self._done[slot] = True

    def _preempt_slot(self, victim: int) -> None:
        """Recompute preemption: requeue ``victim``'s request at the queue
        head and free its pages.  Progress is discarded; the replay is exact
        (draws are (rid, counter)-keyed)."""
        ridx = self._slot_req[victim]
        self._outputs[ridx].clear()
        self._queue.appendleft(ridx)
        self._retire(victim)
        self.preemptions += 1
        if self._records is not None:
            self._records[ridx].events.append(
                {"name": "preempt", "ts": self._now(), "slot": victim})

    def _top_up(self, requests, slot: int) -> None:
        """Extend the slot's block table to cover the next chunk's writes.
        If the pool runs dry, younger live requests are preempted, unless
        this slot is the youngest: then it yields (requeues itself), so the
        eldest always progresses and two requests cannot evict each other
        forever."""
        req = requests[self._slot_req[slot]]
        ps = self.page_size
        length = len(req.prompt)
        # the chunk's live writes reach pos + chunk - 1, at most the last live
        # position length + max_new - 2; the prefill covered spad - 1
        last = min(int(self._pos[slot]) + self.chunk - 1, length + req.max_new - 2)
        need = max(last, self._spad(length) - 1) // ps + 1
        have = len(self._slot_pages[slot])
        if need <= have:
            return
        while self._pool.available() < need - have:
            live = [s for s in range(self.slots) if self._slot_req[s] >= 0]
            youngest = max(live, key=lambda s: self._admit_seq[s])
            if youngest != slot:
                self._preempt_slot(youngest)
                continue
            if len(live) == 1:
                raise RuntimeError(
                    f"page pool exhausted ({self.num_pages} pages of {ps} tokens) "
                    "with a single live request; increase num_pages")
            self._preempt_slot(slot)
            return
        pages = self._alloc_pages(need - have)
        self._bt[slot, have:need] = pages
        self._slot_pages[slot].extend(pages)

    def _load(self) -> None:
        """Round start: the host's block tables and per-slot arrays into the
        static buffers, and the iteration back to row 0."""
        st = self._state
        for buf, host in ((st.cache["block_tables"], self._bt), (st.tok, self._tok),
                          (st.pos, self._pos), (st.n_out, self._n_out),
                          (st.max_new, self._max_new), (st.done, self._done),
                          (st.keys, self._keys), (st.stops(self._stops.shape[1]), self._stops)):
            buf.copy_(torch.from_numpy(host))
        st.it.zero_()

    def _read(self) -> tuple:
        """Round end: the emissions, liveness and per-slot carry, on the host."""
        st = self._state
        return tuple(t.to("cpu", copy=True).numpy() for t in (st.emits, st.lives, st.tok,
                                                              st.pos, st.n_out, st.done))

    # --------------------------------------------------------------- serve --
    def serve(self, requests: Sequence[Request], *, greedy: bool = True,
              temperature: float = 1.0, top_k: int = 0, key=None, policy=None,
              chaos=None) -> list[np.ndarray]:
        """Run every request through the scheduler; returns one int32 array of
        emitted tokens per request (at most ``max_new``; ending at the stop
        token if one fired).  Draws are keyed per (request id, counter), so
        a request's sampled tokens do not depend on its slot, the chunk or
        the page allocation, and equal the dense engine's for the batch row
        whose index is the request's id.  ``key``: ``prng_key``'s argument
        (None: ``PRNGKey(0)``).  The report is kept on ``last_report``."""
        report = self.serve_detailed(requests, greedy=greedy, temperature=temperature,
                                     top_k=top_k, key=key, policy=policy, chaos=chaos)
        return [r.tokens for r in report.records]

    def _finish(self, requests, records, slot: int, t: float) -> None:
        """Retire a finished slot, stamping its completion time ``t`` (the
        round interpolated to the iteration it finished in) on its record."""
        ridx = self._slot_req[slot]
        rec = records[ridx]
        rec.tokens = np.asarray(self._outputs[ridx], np.int32)
        rec.status = "done"
        rec.t_done = t
        rec.events.append({"name": "finish", "ts": t, "tokens": len(rec.tokens)})
        dl = requests[ridx].deadline
        rec.met_deadline = None if dl is None else bool(t <= dl)
        self._retire(slot)

    @torch.inference_mode()
    def serve_detailed(self, requests: Sequence[Request], *, greedy: bool = True,
                       temperature: float = 1.0, top_k: int = 0, key=None, policy=None,
                       chaos=None, resume=None, heartbeat=None) -> ServeReport:
        """``serve`` with its ``ServeReport``: per-request outcomes, times
        (engine-clock seconds from this call's start) and events, and one
        counter sample per round.  Without a policy: an invalid request
        raises, and so does a scheduler that loses one."""
        _unported(policy=policy, chaos=chaos, resume=resume, heartbeat=heartbeat)
        for r in requests:
            _unported(extras=r.extras)
            if len(r.prompt) < 1 or r.max_new < 1:
                raise ValueError("requests need len(prompt) >= 1, max_new >= 1")
            if len(r.prompt) + r.max_new > self.max_seq:
                raise ValueError(f"prompt ({len(r.prompt)}) + max_new ({r.max_new}) "
                                 f"exceeds max_seq ({self.max_seq})")
        base = prng_key(0 if key is None else key, self.device)
        greedy, top_k = bool(greedy), 0 if greedy else int(top_k)
        n_stops = max((len(r.stop_tokens) for r in requests), default=0)
        self._reset(requests, n_stops)
        self._state.temperature.fill_(temperature)
        step = self.chunk_step(n_stops, greedy=greedy, top_k=top_k)
        self.peak_pages_in_use = self.decode_chunk_iters = self.prefill_tokens = 0
        records = [RequestRecord() for _ in requests]
        report = ServeReport(records=records)
        clock = self._clock
        t0 = clock()

        def now() -> float:
            return clock() - t0

        self._records, self._now = records, now
        rnd = 0
        self._pool_poisoned = True  # until the round loop completes
        while self._queue or any(r >= 0 for r in self._slot_req):
            # ---- admit queued requests into free slots while pages last
            admitted_any = False
            for slot in range(self.slots):
                if self._slot_req[slot] >= 0:
                    continue
                if not self._queue or (self._pool.available()
                                       < self._admit_page_need(requests[self._queue[0]])):
                    break
                ridx = self._queue.popleft()
                info = self._admit(requests, slot, ridx, base, greedy, temperature, top_k)
                rec = records[ridx]
                rec.slot = slot
                if rec.t_admit is None:
                    rec.t_admit = rec.t_first = now()
                rec.events.append({"name": "admit", "ts": now(), "slot": slot,
                                   "round": rnd, **info})
                admitted_any = True
            # retire what finished at admit (max_new == 1, or a stop at draw 0)
            t_adm = now()
            for slot in range(self.slots):
                if self._slot_req[slot] >= 0 and self._done[slot]:
                    self._finish(requests, records, slot, t_adm)
            live = [s for s in range(self.slots) if self._slot_req[s] >= 0]
            if not live:
                if self._queue and not admitted_any:
                    raise RuntimeError(
                        "page pool too small to admit request with prompt "
                        f"{len(requests[self._queue[0]].prompt)} tokens; increase num_pages")
                rnd += 1
                continue
            for s in live:
                if self._slot_req[s] >= 0:  # an earlier top-up may have preempted it
                    self._top_up(requests, s)
            self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use())
            # ---- the chunk: one replay per iteration, one read-back per round
            n0 = self._n_out.copy()
            t_round_start = now()
            self._load()
            self.decode_chunk_iters += self.chunk
            for _ in range(self.chunk):
                step()
            emits, lives, self._tok, self._pos, self._n_out, self._done = self._read()
            for t in range(self.chunk):
                for slot in range(self.slots):
                    if lives[t, slot] and self._slot_req[slot] >= 0:
                        self._outputs[self._slot_req[slot]].append(int(emits[t, slot]))
            t_end = now()
            for slot in live:
                ridx = self._slot_req[slot]
                if ridx >= 0:
                    records[ridx].events.append(
                        {"name": "decode", "ts": t_round_start, "dur": t_end - t_round_start,
                         "round": rnd, "tokens": int(self._n_out[slot] - n0[slot])})
            for slot in range(self.slots):
                if self._slot_req[slot] >= 0 and self._done[slot]:
                    liv = np.flatnonzero(lives[:, slot])
                    fin_it = int(liv[-1]) if liv.size else self.chunk - 1
                    t_slot = t_round_start + (fin_it + 1) / self.chunk * (t_end - t_round_start)
                    self._finish(requests, records, slot, t_slot)
            report.counters.append({"ts": t_end, "round": rnd,
                                    "free_pages": len(self._pool.free),
                                    "pages_in_use": self.pages_in_use(),
                                    "queued": len(self._queue)})
            rnd += 1
        self._pool_poisoned = False
        report.rounds = rnd
        dropped = [i for i, rec in enumerate(records) if rec.status == "pending"]
        if dropped:
            raise RuntimeError(f"scheduler dropped requests {dropped}: still pending after "
                               "the serve loop — every request must end done")
        report.prefill_tokens = self.prefill_tokens
        self.assert_quiescent()
        self.last_report = report
        return report

    def generate(self, prompt_tokens, n_new: int, *, extras: Optional[dict] = None,
                 greedy: bool = True, temperature: float = 1.0, top_k: int = 0, key=None,
                 stop_tokens: Sequence[int] = ()) -> torch.Tensor:
        """The fixed-batch API over the scheduler: each row of
        ``prompt_tokens`` (B, S) becomes a Request; rows that retire early
        are padded with ``pad_id``.  Returns (B, n_new) int32 on the
        engine's device."""
        _unported(extras=extras)
        prompts = np.asarray(torch.as_tensor(prompt_tokens).cpu(), np.int32)
        reqs = [Request(prompt=row, max_new=int(n_new), stop_tokens=tuple(stop_tokens))
                for row in prompts]
        outs = self.serve(reqs, greedy=greedy, temperature=temperature, top_k=top_k, key=key)
        full = np.full((len(reqs), int(n_new)), self.pad_id, np.int32)
        for i, o in enumerate(outs):
            full[i, : len(o)] = o
        return torch.from_numpy(full).to(self.device)

"""Serving with PIM-quantized weights: the fixed-batch engine and the
continuous-batching engine over a paged KV cache.

Twin of ``repro.serving.engine``'s ``quantize_tree``, ``sample_logits``,
``ServingEngine``, ``Request`` and ``ContinuousBatchingEngine`` (the dense,
moe, ssm, vlm and encdec families, the last two with per-request extras;
n-gram, tree and draft-model speculation for all; the prefix cache for all
but moe and ssm, as in the JAX package; the resilience tier; no mesh).  ``quantize_tree``
turns every large matmul weight into ``{"codes": int8, "scale": f32}``
(int4: nibble-packed codes plus a marker leaf); at decode time each of
those weights is streamed once per step by the ``pim_matvec`` kernel.

``ServingEngine.generate`` is the JAX package's one program
(``_generate_body``): an eager prefill, then
``n_new - 1`` runs of ONE step function, ``decode_and_emit`` (decode one
token, sample the next, write it at the draw index, advance the position
and the index).  The step works on static buffers (``DecodeState``), so on
the card the engine captures it once in a CUDA graph and each decode step is
one replay; on the CPU the same function runs eagerly.  Sampled draws are
keyed per row and per draw index with the JAX package's own keys
(``serving.sampling``).  ``generate_reference`` is the per-token loop
(prompt included), the parity oracle.  With ``speculate=`` each verify
window (``speculative.spec_window``) is one replay instead, a draft model's
steps or a tree window's relocation included, and the host reads the rows'
emitted counts only between runs of windows that the slowest row needs
anyway.

``ContinuousBatchingEngine.serve`` schedules requests on the host in numpy,
as the reference does, and runs each round's decode chunk (the reference's
``_decode_chunk_body`` scan) as ``chunk`` runs of ``decode_chunk_step`` on
static buffers (``ChunkState``): on the card each run is one replay of a
graph kept by ``CapturedSteps``, the capture helper both engines share.
Each admit is one replay too: an uncached admit (``admit_miss``, a batch-1
prefill into the slot's pages) kept per padded prompt length, and a cached
one (``admit_cached``, one ``verify_step`` window over the prompt's tail
after the prefix cache aliased its first pages) kept per window width.
Under a ``ResiliencePolicy`` (``serving.resilience``) ``serve_detailed``
retries, sheds, rejects and degrades on the host and snapshots each round;
a crash-replayed request is re-admitted by the same captured admit over its
prompt and emitted tokens.  With ``speculate=`` a round of width k > 0 runs
``speculative.spec_chunk_step`` (one replay per iteration, captured per
width) and a round of width 0 the plain chunk step.  A draft model keeps
its K/V in a pool of its own that shares the target's block tables, so one
page allocator serves both and every admit prefills both.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import os
import time
from collections import OrderedDict, deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.models import (common, decode_step, init_cache, init_paged_cache, prefill,
                                 prefill_hidden, verify_hidden)
from repro_torch.models.lm import seq_stacks, state_stacks
from repro_torch.models.attention import CHUNKED_THRESHOLD, tree_tensors
from repro_torch.models.common import dtype_of, resolve_device, unembed
from repro_torch.quant import quantize_slices, should_quantize

from .chaos import ChunkFault, EngineCrash
from .prefix import PagePool, PrefixTrie, chunk_keys, extras_fingerprint
from .resilience import (DegradationLadder, InflightState, LadderConfig, RequestRecord,
                         ResiliencePolicy, ServeReport, ServeSnapshot)
from .sampling import (TAG_TOKEN, TAG_WINDOW, draw_keys, fold_in, gumbel, prng_key,
                       row_keys, sample_rows, warp_logits)
from .speculative import (SpecConfig, SpecState, adaptive_k_host, as_spec, propose_first_host,
                          spec_chunk_step, spec_window)

# Metadata leaves — markers, not shipped storage: int4 packing flags and the
# tensor-parallel shard tag.
_MARKER_KEYS = ("nibbles", "nibbles_odd", "tp")


def _quantize_leaf(leaf: torch.Tensor, bits: int):
    """Quantize a (..., K, N) leaf one (K, N) slice at a time along its
    leading dims (``quantize_slices``; a layer of starcoder2-15b's ``gate``
    is 0.6 GB in f32, the stack 24 GB).  The leaf's strides do not matter:
    an untied head is a transposed view."""
    return quantize_slices(tuple(leaf.shape[:-2]), *leaf.shape[-2:], leaf.__getitem__, bits,
                           leaf.device)


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
        if leaf is None or not should_quantize(name, leaf):
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


def _tree_map(fn, tree):
    """``fn`` of every leaf of a dict tree; None leaves stay None."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def extras_structure(extras):
    """The tree structure of a request's extras (None, or nested keys): what
    every request of one trace must share, as under ``jax.tree.structure``."""
    if isinstance(extras, dict):
        return tuple(sorted((k, extras_structure(v)) for k, v in extras.items()))
    return None if extras is None else "leaf"


def _extras_on(extras, device):
    """Extras (a dict tree of tensors or numpy arrays) as tensors on
    ``device``, in their own dtypes; None stays None."""
    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return params_from_numpy({"v": np.asarray(v)}, device)["v"]
    return _tree_map(conv, extras)


def _extras_key(extras) -> Optional[tuple]:
    """What a captured step that reads static extras buffers is kept by: the
    buffers' paths, shapes and dtypes (None without extras)."""
    if extras is None:
        return None
    out = []

    def walk(tree, path):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif v is not None:
                out.append((path + (k,), tuple(v.shape), str(v.dtype)))
    walk(extras, ())
    return tuple(out)


class ExtrasBuffers:
    """Static extras buffers kept per ``_extras_key`` (a captured step reads
    the memory it was captured on): ``get(extras)`` returns the buffers of
    ``extras``' shapes and dtypes with ``lead`` dims first, made at first
    use (zeros), or None for None."""

    def __init__(self, device, lead=()):
        self.device, self.lead = device, tuple(lead)
        self._bufs: dict = {}

    def get(self, extras) -> Optional[dict]:
        if extras is None:
            return None
        meta = _extras_on(extras, "meta")  # shapes and torch dtypes, no data
        key = _extras_key(meta)
        if key not in self._bufs:
            self._bufs[key] = _tree_map(
                lambda v: torch.zeros(self.lead + tuple(v.shape), dtype=v.dtype,
                                      device=self.device), meta)
        return self._bufs[key]

    def zero_(self) -> None:
        for bufs in self._bufs.values():
            for t in _tensors(bufs):
                t.zero_()


def _copy_tree(dst: dict, src: dict) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst``, in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_tree(dst[k], v)
        elif v is not None:
            dst[k].copy_(v)


class DecodeState:
    """The static buffers of one batch's generation, in device memory that a
    captured step reads on every replay: the cache, the last token (B, 1)
    int32, the position and the draw index (0-d int64), each row's key of
    the token stream (B, 2), the temperature (0-d f32), the tokens emitted
    so far (B, max_seq) int32 (column j holds draw j), the last logits
    (B, V), and the batch's extras (``extras``: per shapes and dtypes, the
    rows' image embeds or encoder output, which ``start`` copies in)."""

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
        self.extras = ExtrasBuffers(device)

    def start(self, params, cfg: ModelConfig, prompt: torch.Tensor, key, temperature,
              *, greedy: bool, top_k: int, extras: Optional[dict] = None) -> None:
        """Zero the cache (a fresh ``init_cache``'s), copy ``extras`` (each
        leaf (B, ...)) into the static buffers of their shapes and dtypes,
        prefill ``prompt`` (B, S) and emit draw 0 from its last logits; the
        position is then S and the draw index 1.  ``key``: ``prng_key``'s
        argument, None for ``PRNGKey(0)``'s key data."""
        for leaf in _tensors(self.cache):
            leaf.zero_()
        ex = self.extras.get(extras)
        if ex is not None:
            _copy_tree(ex, _extras_on(extras, prompt.device))
        logits, _ = prefill(params, cfg, prompt, self.cache, ex)
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
                    top_k: int, extras: Optional[dict] = None) -> None:
    """The step ``generate`` runs ``n_new - 1`` times: decode ``st.tok`` at
    ``st.pos`` (with ``extras``, the batch's extras buffers of ``st``),
    keep its logits, advance the position, then emit the next draw.  It
    reads and writes only ``st``'s buffers and the parameters, so a CUDA
    graph of it replays the whole step."""
    logits, _ = decode_step(params, cfg, st.tok, st.cache, st.pos, extras)
    st.logits.copy_(logits[:, -1])
    st.pos += 1
    _emit(st, greedy=greedy, top_k=top_k)


# Options of the JAX package's engines that the port does not run yet, and the
# ROADMAP.md item (section 1) that brings each.
_LATER = {"mesh": "item 7 (tensor-parallel decode)"}


def _unported(**options) -> None:
    """Raise NotImplementedError for the first option given a value (not
    None, False or 0), naming the ROADMAP item that ports it."""
    for name, value in options.items():
        if value is not None and value is not False and value != 0:
            raise NotImplementedError(
                f"{name}= is not ported yet: ROADMAP.md section 1, {_LATER[name]}")


_NO_DRAFT = "speculate mode='draft' needs the engine constructed with draft_cfg/draft_params"


@contextlib.contextmanager
def gc_paused():
    """Python's cycle collector off for the block, as it was after: a CUDA
    graph that a collected cycle frees while another graph is being
    captured invalidates that capture (``cudaErrorStreamCaptureInvalidated``),
    and ``torch.cuda.graph`` no longer collects before it begins."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _draft_params(draft_params, bits: int):
    """The draft model's parameters, quantized when ``bits`` is non-zero."""
    return quantize_tree(draft_params, bits) if draft_params is not None and bits else draft_params


class CapturedSteps:
    """The step functions an engine keeps as CUDA graphs on the card.

    ``get`` returns a step as a call with no arguments: on the CPU the step
    function itself (nothing is kept); on the card one replay of its graph,
    captured at the first call for its key and the matvec dispatch mode.
    Before a capture the step runs once on a side stream (kernel builds and
    loads, cuBLAS handles and workspaces, the allocator), after ``reset``
    has put its buffers where a run may start.  The graphs of one buffer set
    (``pool_key``) share one graph memory pool, since their steps never run
    at the same time and every output they keep lies in those buffers.  A
    graph reads the memory it was captured on, so every kept step is
    dropped when any parameter leaf's pointer, dtype, shape or stride
    changes.  Of the steps got with ``bounded=True`` at most ``capacity``
    are kept, the least recently used dropped first.  A failed capture
    raises."""

    def __init__(self, device: torch.device, capacity: Optional[int] = None):
        self.device = device
        self.capacity = capacity
        self._steps: dict[tuple, Callable[[], None]] = {}
        self._bounded: OrderedDict = OrderedDict()  # bounded keys, least recent first
        self._params: Optional[tuple] = None
        self._pools: dict = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def __len__(self) -> int:
        return len(self._steps)

    def get(self, params, key: tuple, pool_key, run: Callable[[], None],
            reset: Callable[[], object], bounded: bool = False) -> Callable[[], None]:
        if self.device.type != "cuda":
            return run
        leaves = tuple((t.data_ptr(), t.dtype, tuple(t.shape), t.stride())
                       for t in _tensors(params))
        if leaves != self._params:
            self._steps.clear()
            self._bounded.clear()
            self._params = leaves
        key = key + (common.matvec_dispatch(),)
        if key not in self._steps:
            if pool_key not in self._pools:
                self._pools[pool_key] = torch.cuda.graph_pool_handle()
            self._warm_up(run, reset)
            self._steps[key] = self._capture(run, self._pools[pool_key]).replay
            if bounded:
                self._bounded[key] = None
                while len(self._bounded) > self.capacity:
                    del self._steps[self._bounded.popitem(last=False)[0]]
        elif bounded:
            self._bounded.move_to_end(key)
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
        with gc_paused(), torch.cuda.graph(graph, pool=pool, stream=self._stream):
            run()
        return graph


class ServingEngine:
    """Fixed-batch engine: single-pass prefill, then one decode step per new
    token, or one verify window per several under ``speculate=``, each one
    CUDA graph replay on the card.  ``device=None`` means the card.
    ``draft_cfg``/``draft_params`` (quantized at ``draft_pim_bits`` when
    non-zero) are the draft model of ``SpecConfig(mode="draft")``.
    ``spec_stats`` holds the realised acceptance of the last speculative
    ``generate``."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int,
                 pim_bits: int = 0, device=None, mesh=None,
                 draft_cfg: Optional[ModelConfig] = None, draft_params=None,
                 draft_pim_bits: int = 0):
        _unported(mesh=mesh)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = quantize_tree(params, pim_bits) if pim_bits else params
        self.draft_cfg = draft_cfg
        self.draft_params = _draft_params(draft_params, draft_pim_bits)
        self.max_seq = max_seq
        self._states: dict[int, DecodeState] = {}
        self._spec_states: dict[int, SpecState] = {}
        self.graphs = CapturedSteps(self.device)
        self.spec_stats: Optional[dict] = None

    def _check(self, prompt_tokens, n_new: int):
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

    def step(self, batch: int, *, greedy: bool, top_k: int, extras: Optional[dict] = None):
        """The decode step of ``batch`` rows as a call with no arguments
        (``CapturedSteps.get``): ``decode_and_emit`` on the current
        parameters and the batch's extras buffers of ``extras``' shapes and
        dtypes, kept on the card per batch, sampling mode, extras shapes
        and dtypes and dispatch mode, one graph memory pool per batch's
        buffers.  Its warm-up writes the buffers, which
        ``DecodeState.start`` resets."""
        top_k = 0 if greedy else int(top_k)
        st = self.state(batch)
        ex = st.extras.get(extras)
        run = functools.partial(decode_and_emit, self.params, self.cfg, st,
                                greedy=bool(greedy), top_k=top_k,
                                **({} if ex is None else {"extras": ex}))

        def reset():
            st.pos.zero_()
            st.idx.zero_()
        return self.graphs.get(self._weights(), (batch, bool(greedy), top_k, _extras_key(ex)),
                               batch, run, reset)

    def _weights(self) -> dict:
        """Every parameter leaf a kept step may read, the draft's included:
        the tree whose leaves ``CapturedSteps`` watches."""
        return {"params": self.params, "draft": self.draft_params}

    def spec_state(self, batch: int) -> SpecState:
        """The speculative buffers of a batch of ``batch`` rows, on the cache
        of ``state(batch)`` (made at first use and kept)."""
        if batch not in self._spec_states:
            self._spec_states[batch] = SpecState(self.cfg, batch, self.max_seq,
                                                 self.state(batch).cache, self.device,
                                                 self.draft_cfg)
        return self._spec_states[batch]

    def spec_step(self, batch: int, spec: SpecConfig, *, greedy: bool, top_k: int,
                  extras: Optional[dict] = None):
        """One verify window of ``batch`` rows as a call with no arguments:
        ``spec_window`` on the current parameters (the draft's too) and the
        batch's extras buffers of ``extras``' shapes and dtypes (those of
        ``state(batch)``, which plain decode steps read), kept on the card
        per (batch, spec, greedy, top_k, extras shapes and dtypes) and
        dispatch mode, in the graph memory pool of the batch's decode step.
        Its warm-up writes the buffers, which ``SpecState.start`` resets; a
        draft model's cache, or a tree window's cache and tables, are made
        before it."""
        top_k = 0 if greedy else int(top_k)
        st = self.spec_state(batch)
        ex = self.state(batch).extras.get(extras)
        if spec.mode == "draft":
            st.draft_cache(spec.k)
        if spec.tree_fan:
            st.tree_cache(spec.tree_fan, spec.k)
            tree_tensors(spec.tree_fan, spec.k, self.device)
        run = functools.partial(spec_window, self.params, self.cfg, st, spec=spec,
                                greedy=bool(greedy), top_k=top_k, draft_params=self.draft_params,
                                extras=ex)
        return self.graphs.get(self._weights(),
                               ("spec", batch, spec, bool(greedy), top_k, _extras_key(ex)), batch,
                               run, st.reset)

    def _generate_speculative(self, prompt: torch.Tensor, n_new: int, spec: SpecConfig, *,
                              greedy: bool, temperature: float, top_k: int, key,
                              extras: Optional[dict] = None) -> torch.Tensor:
        """The JAX package's ``_spec_generate_body``: prefill and draw 0, then
        verify windows until every row has ``n_new`` tokens.  Each row emits
        at most ``k + 1`` tokens a window, so the host reads the emitted
        counts, runs the windows the slowest row needs at least, and reads
        again: no window runs past the reference's loop.  ``extras`` are
        copied into the batch's static buffers before the prefill, and
        every window reads them there."""
        b = prompt.shape[0]
        steps = live_steps = 0
        toks = torch.zeros((b, 0), dtype=torch.int32, device=self.device)
        if n_new:
            step = self.spec_step(b, spec, greedy=greedy, top_k=top_k, extras=extras)
            st = self.spec_state(b)
            ex = self.state(b).extras.get(extras)
            if ex is not None:
                _copy_tree(ex, extras)
            st.start(self.params, prompt, key, temperature, n_new, greedy=greedy,
                     top_k=0 if greedy else int(top_k), ctrl_init=spec.ctrl_init,
                     draft_params=self.draft_params if spec.mode == "draft" else None,
                     k=spec.k, tree_fan=spec.tree_fan, extras=ex)
            while True:
                left = n_new - int(st.n_em.min())
                if left <= 0:
                    break
                for _ in range(-(-left // (spec.k + 1))):
                    step()
            toks = st.out[:, :n_new].clone()
            steps, live_steps = int(st.steps), int(st.live_steps)
        # a window streams the weights once for the whole batch: tokens a row
        # over windows is the amortisation, tokens over live row windows the
        # proposer's acceptance
        self.spec_stats = {
            "k": spec.k, "mode": spec.mode, "greedy": greedy, "adaptive": spec.adaptive,
            "tree_fan": spec.tree_fan, "accept": spec.accept, "verify_steps": steps,
            "live_row_steps": live_steps,
            "emitted_per_step": (n_new - 1) / steps if steps else 0.0,
            "acceptance_per_live_row": b * (n_new - 1) / live_steps if live_steps else 0.0}
        return toks

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
        token with ``pad_id`` (the stop token itself is kept).

        ``speculate`` (a ``SpecConfig`` or an int ``k``, n-gram proposals;
        ``mode="draft"``: the engine's draft model's) verifies ``k``
        proposals and the current token in one window a step
        (``_generate_speculative``; ``tree_fan=F``: F n-gram chains of
        depth ``k`` in one tree window): greedy tokens are plain greedy
        decoding's; sampled ones are rejection-sampled (or typical-accepted)
        with ``draw_keys(key, row, window, TAG_WINDOW)``, as the JAX
        package draws them."""
        prompt = self._check(prompt_tokens, n_new)
        extras = _extras_on(extras, self.device)
        spec = as_spec(speculate, self.cfg, self.draft_cfg)
        if spec is not None and spec.mode == "draft" and (
                self.draft_params is None or self.draft_cfg is None):
            raise ValueError(_NO_DRAFT)
        if spec is not None:
            toks = self._generate_speculative(prompt, n_new, spec, greedy=bool(greedy),
                                              temperature=temperature, top_k=top_k, key=key,
                                              extras=extras)
            return mask_after_stop(toks, stop_tokens, pad_id)
        b = prompt.shape[0]
        if n_new == 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=self.device)
        step = self.step(b, greedy=greedy, top_k=top_k, extras=extras)
        st = self.state(b)
        st.start(self.params, self.cfg, prompt, key, temperature, greedy=greedy, top_k=top_k,
                 extras=extras)
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
        prompt = self._check(prompt_tokens, n_new)
        extras = _extras_on(extras, self.device)
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
                                        cache, i, extras)
        out = [draw(logits, 0)]
        for j in range(n_new - 1):
            logits, cache = decode_step(self.params, self.cfg, out[-1], cache, s + j, extras)
            out.append(draw(logits, j + 1))
        return mask_after_stop(torch.cat(out, dim=1), stop_tokens, pad_id)


# ===================================================== continuous batching ==
@dataclasses.dataclass
class Request:
    """One generation request for ``ContinuousBatchingEngine.serve``.
    ``rid`` keys the request's sampled draws (default: its index in the
    trace).  Under a ``ResiliencePolicy`` a request is not admitted before
    its ``arrival``, is shed from the queue past its ``deadline``, and the
    lower its ``slo`` class the sooner it is shed.  ``extras`` are the
    request's own model inputs without a batch dim (the vlm's
    ``image_embeds`` (N, D), the encdec's ``enc_out`` (F, D)); every request
    of a trace shares one extras structure, or all pass None."""

    prompt: np.ndarray  # (len,) int32 token ids
    max_new: int  # emit at most this many tokens (>= 1)
    stop_tokens: tuple = ()  # retire early after emitting any of these
    extras: Optional[dict] = None
    arrival: float = 0.0
    deadline: Optional[float] = None
    slo: int = 1
    rid: Optional[int] = None


def admit_prefill(params, cfg: ModelConfig, cache: dict, prompt: torch.Tensor,
                  length, slot, pages: torch.Tensor, rid, key: torch.Tensor, temperature,
                  extras: Optional[dict] = None, *, greedy: bool, top_k: int) -> torch.Tensor:
    """Admit one request (the JAX package's ``_admit_body``): a batch-1
    prefill of the page-padded ``prompt`` (1, S) straight into the slot's
    pool pages, with the request's ``extras`` (each leaf (1, ...)), then
    draw 0 from the logits at the true prompt end with the request's
    ``(rid, 0)`` key; only that position is unembedded (an untied head as a
    one-row linear), so no (S, vocab) logits or dequantized head are
    formed.  ``length`` and ``rid`` are ints or 0-d int64 tensors on the
    prompt's device; with tensors nothing is read on the host, so a CUDA
    graph of the admit replays for any of them.  Returns the token, a 0-d
    int32 tensor."""
    x = prefill_hidden(params, cfg, prompt, cache, extras, length=length, pages=pages,
                       slot=slot)
    at = torch.as_tensor(length, device=prompt.device).reshape(1) - 1
    logits = unembed(x.index_select(1, at), params.get("head", params["embed"]))
    keys = None if greedy else draw_keys(
        key, torch.as_tensor(rid, device=prompt.device).reshape(1), 0, TAG_TOKEN)
    return sample_rows(logits[:, 0], keys, greedy=greedy, temperature=temperature,
                       top_k=top_k)[0]


def tail_verify(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
                slot: torch.Tensor, rid: torch.Tensor, sample_at: torch.Tensor, key: torch.Tensor,
                temperature, extras: Optional[dict] = None, *, greedy: bool,
                top_k: int) -> torch.Tensor:
    """A cached admit's tail (the JAX package's ``_tail_verify_body``): ONE
    ``verify_step`` window over the unmatched tail of a prompt whose first
    pages the prefix cache aliased.  ``tokens`` (slots, T) is zero but for
    the admitted slot's row (its padded tail), ``pos`` (slots,) zero but
    for the slot's tail start; the caller zeroes every other slot's
    block-table row, so their window writes land in the trash page.  Draw 0
    comes from the logits at window position ``sample_at`` (the true
    prompt end) of row ``slot``, with the request's ``(rid, 0)`` key; only
    that position is unembedded.  ``extras``: every slot's, each leaf
    (slots, ...).  The index arguments are 0-d int64 tensors, read by
    device ops only.  Returns the token, a 0-d int32 tensor."""
    x = verify_hidden(params, cfg, tokens, cache, pos, extras)
    x = x.index_select(0, slot.reshape(1)).index_select(1, sample_at.reshape(1))  # (1, 1, D)
    logits = unembed(x, params.get("head", params["embed"]))[:, 0]
    keys = None if greedy else draw_keys(key, rid.reshape(1), 0, TAG_TOKEN)
    return sample_rows(logits, keys, greedy=greedy, temperature=temperature, top_k=top_k)[0]


def _copy_page(cache: dict, src: int, dst: int, keys) -> None:
    """Copy-on-write fork on the device: pool page ``src`` into ``dst``
    across every paged leaf (``keys`` from ``seq_stacks``; K/V or latent,
    the page axis right after the lead dims; per-slot state has no pages),
    in place."""
    for name, lead in keys:
        at = (slice(None),) * len(lead)
        for leaf in cache[name].values():
            leaf[at + (dst,)] = leaf[at + (src,)]


class AdmitState:
    """The static buffers of one uncached admit of a prompt padded to
    ``spad`` positions: the prompt (1, spad) int32; its pages (spad /
    page_size,), the true length and the request id, int64 views of one
    tensor ``ints`` the host fills with one copy; the admitted slot (0-d
    int64), whose row of the per-slot extras the prefill reads; and the
    first token (0-d int32), which the admit writes."""

    def __init__(self, spad: int, page_size: int, device):
        n = spad // page_size
        self.prompt = torch.zeros((1, spad), dtype=torch.int32, device=device)
        self.ints = torch.zeros((n + 2,), dtype=torch.int64, device=device)
        self.pages, self.length, self.rid = self.ints[:n], self.ints[n], self.ints[n + 1]
        self.slot = torch.zeros((), dtype=torch.int64, device=device)
        self.tok = torch.zeros((), dtype=torch.int32, device=device)


class WindowState:
    """The static buffers of one cached admit's tail window of ``width``
    positions over every slot: the tokens (slots, width) int32; each slot's
    window start (slots,), the admitted slot, the window position of the
    draw and the request id, int64 views of one tensor ``ints``; and the
    first token (0-d int32), which the admit writes."""

    def __init__(self, slots: int, width: int, device):
        self.tokens = torch.zeros((slots, width), dtype=torch.int32, device=device)
        self.ints = torch.zeros((slots + 3,), dtype=torch.int64, device=device)
        self.pos, self.slot, self.sample_at, self.rid = (
            self.ints[:slots], self.ints[slots], self.ints[slots + 1], self.ints[slots + 2])
        self.tok = torch.zeros((), dtype=torch.int32, device=device)


class ChunkState:
    """The static buffers of the continuous engine, in device memory that a
    captured chunk step or admit reads on every replay: the paged cache
    (pools and block tables); per slot the current token (B, 1) int32, the
    position, emitted count and draw budget (B,) int64, the done flag (B,)
    bool and the row key of its token stream (B, 2); the serve's base key
    (2,) int64 and temperature (0-d f32); the iteration within the round
    (0-d int64); the round's emissions and liveness, (chunk, B); the stop
    tokens, (B, n) int32 for each number n of stop columns a trace needs;
    the admits' buffers, an ``AdmitState`` per padded prompt length and a
    ``WindowState`` per tail window width; and speculation's: per slot the
    history (B, store_seq + 1) int32 (the last column takes the writes the
    reference drops), the window counter (B,) int64, the acceptance EMA
    (B,) f32 and the row key of its window stream (B, 2), and per window
    width k the round's emissions (chunk, B, k+1) int32 and counts (chunk,
    B) int64; the per-slot extras (``extras``: per shapes and dtypes, each
    leaf (B, ...), a request's row written at its admit).  With a draft
    model (``draft_cfg``), its pool ``dcache``: the target pool's geometry,
    storage of its own, and the target's block tables as the same tensor,
    so that one upload serves both pools.  The per-slot state of a state
    stack (the ssm family's, in either pool) is what a chunk step's warm-up
    would advance for every slot: ``stash_states`` keeps a copy that
    ``restore_states`` writes back."""

    def __init__(self, cfg: ModelConfig, slots: int, store_seq: int, num_pages: int,
                 page_size: int, chunk: int, device, draft_cfg: Optional[ModelConfig] = None):
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.cache = init_paged_cache(cfg, slots, store_seq, num_pages, page_size, device)
        self._cfg = cfg
        self.page_size = page_size
        self.extras = ExtrasBuffers(device, lead=(slots,))
        self.draft_cfg = draft_cfg
        self.dcache = None
        if draft_cfg is not None:
            self.dcache = init_paged_cache(draft_cfg, slots, store_seq, num_pages, page_size,
                                           device)
            self.dcache["block_tables"] = self.cache["block_tables"]
        self.tok = zeros((slots, 1), torch.int32)
        self.pos = zeros((slots,), torch.int64)
        self.n_out = zeros((slots,), torch.int64)
        self.max_new = zeros((slots,), torch.int64)
        self.done = zeros((slots,), torch.bool)
        self.keys = zeros((slots, 2), torch.int64)
        self.base = zeros((2,), torch.int64)
        self.temperature = zeros((), torch.float32)
        self.it = zeros((), torch.int64)
        self.emits = zeros((chunk, slots), torch.int32)
        self.lives = zeros((chunk, slots), torch.bool)
        self.hist = zeros((slots, store_seq + 1), torch.int32)
        self.wctr = zeros((slots,), torch.int64)
        self.ema = zeros((slots,), torch.float32)
        self.wkeys = zeros((slots, 2), torch.int64)
        self._stops: dict[int, torch.Tensor] = {}
        self._admits: dict[int, AdmitState] = {}
        self._windows: dict[int, WindowState] = {}
        self._spec: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._stash: list[tuple[torch.Tensor, torch.Tensor]] = []

    def _state_leaves(self):
        for cfg, cache in ((self._cfg, self.cache), (self.draft_cfg, self.dcache)):
            if cache is not None:
                for key, _ in state_stacks(cfg):
                    yield from cache[key].values()

    def stash_states(self) -> None:
        """Keep a copy of every per-slot state leaf (both pools'), for
        ``restore_states``."""
        self._stash = [(leaf, leaf.clone()) for leaf in self._state_leaves()]

    def restore_states(self) -> None:
        """Write the stashed state back, if any, and drop the copy."""
        for leaf, kept in self._stash:
            leaf.copy_(kept)
        self._stash = []

    def stops(self, n: int) -> torch.Tensor:
        if n not in self._stops:
            self._stops[n] = torch.full((self.tok.shape[0], n), -1, dtype=torch.int32,
                                        device=self.tok.device)
        return self._stops[n]

    def admit(self, spad: int) -> AdmitState:
        if spad not in self._admits:
            self._admits[spad] = AdmitState(spad, self.page_size, self.tok.device)
        return self._admits[spad]

    def window(self, width: int) -> WindowState:
        if width not in self._windows:
            self._windows[width] = WindowState(self.tok.shape[0], width, self.tok.device)
        return self._windows[width]

    def spec(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The emissions and counts of a round of width-``k`` windows."""
        if k not in self._spec:
            chunk, slots = self.emits.shape
            self._spec[k] = (torch.zeros((chunk, slots, k + 1), dtype=torch.int32,
                                         device=self.tok.device),
                             torch.zeros((chunk, slots), dtype=torch.int64,
                                         device=self.tok.device))
        return self._spec[k]

    def zero_(self) -> None:
        """Every buffer as a fresh state holds it (the reference makes a fresh
        cache for every serve; a captured step must keep its memory)."""
        pools = (self.cache, self.dcache) if self.dcache is not None else (self.cache,)
        for t in (*(t for c in pools for t in _tensors(c)), self.tok,
                  self.pos, self.n_out, self.max_new, self.done, self.keys, self.base,
                  self.temperature, self.it, self.emits, self.lives, self.hist, self.wctr,
                  self.ema, self.wkeys, *(t for pair in self._spec.values() for t in pair)):
            t.zero_()
        for t in self._stops.values():
            t.fill_(-1)
        self.extras.zero_()
        self._stash = []


def decode_chunk_step(params, cfg: ModelConfig, st: ChunkState, stops: torch.Tensor, *,
                      greedy: bool, top_k: int, pad_id: int,
                      extras: Optional[dict] = None) -> None:
    """One iteration of the JAX package's decode chunk (``_decode_chunk_body``)
    on ``st``'s buffers: decode every slot's token at its own position
    (paged), draw the next with ``draw_keys(key, rid, n_out)``, write it
    (``pad_id`` for a done slot) and the slot's liveness to row ``st.it`` of
    the round's emissions, advance the live slots' position and count, and
    mark done the slots that emitted a stop token (``stops``) or reached
    their budget.  Done and inactive slots keep stepping; their writes land
    in their own pages or the trash page, and their emissions are masked.
    ``extras``: the per-slot extras buffers of ``st``."""
    logits, _ = decode_step(params, cfg, st.tok, st.cache, st.pos, extras)
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


def admit_miss(params, cfg: ModelConfig, st: ChunkState, a: AdmitState, *, greedy: bool,
               top_k: int, draft_params=None, extras: Optional[dict] = None) -> None:
    """An uncached admit on static buffers: ``admit_prefill`` of ``a``'s
    prompt into ``a``'s pages of ``st``'s pool and into row ``a.slot`` of
    its per-slot state (the prompt's true length ``a.length`` masking the
    pads out of it), with row ``a.slot`` of the per-slot ``extras``
    (buffers of ``st``), draw 0 with ``st``'s base key and temperature, the
    token written to ``a.tok``.  With a draft model (``draft_params``) the
    prompt is prefilled into the same page ids and slot row of the draft
    pool too, with the same row of extras; the token always comes from the
    target."""
    ex = _tree_map(lambda t: t.index_select(0, a.slot.reshape(1)), extras)
    a.tok.copy_(admit_prefill(params, cfg, st.cache, a.prompt, a.length, a.slot, a.pages,
                              a.rid, st.base, st.temperature, ex, greedy=greedy, top_k=top_k))
    if draft_params is not None:
        prefill(draft_params, st.draft_cfg, a.prompt, st.dcache, ex, length=a.length,
                pages=a.pages, slot=a.slot)


def admit_cached(params, cfg: ModelConfig, st: ChunkState, w: WindowState, *, greedy: bool,
                 top_k: int, extras: Optional[dict] = None) -> None:
    """A cached admit on static buffers: ``tail_verify`` of ``w``'s window
    against ``st``'s pool through the block tables in ``st`` (every row but
    the admitted slot's zeroed by the host), with the per-slot ``extras``,
    the token written to ``w.tok``."""
    w.tok.copy_(tail_verify(params, cfg, st.cache, w.tokens, w.pos, w.slot, w.rid, w.sample_at,
                            st.base, st.temperature, extras, greedy=greedy, top_k=top_k))


# Families whose admit prefill and tail window compute the same function of
# the prompt, so a prefix-cache hit is the answer a miss would give (the JAX
# package's ``_PREFIX_FAMILIES``; the ssm family's per-slot state is not in
# the shared pages).
_PREFIX_FAMILIES = ("dense", "vlm", "encdec")
# The most admit graphs (uncached admits per padded prompt length, cached
# admits per tail window width) an engine keeps on the card; the least
# recently used is dropped first.  At 16-token pages, 1,024 positions give 64
# padded lengths, 16,400 give 1,025.
MAX_ADMIT_GRAPHS = 64


class ContinuousBatchingEngine:
    """Continuous-batching scheduler over a paged KV cache (twin of the JAX
    package's, for the dense, moe, ssm, vlm and encdec families, with
    n-gram, tree and draft-model speculation, the prefix cache (never hit
    on moe, MLA included, or ssm) and the resilience tier, without a
    mesh).  The ssm family's per-slot state lives beside the pool, one row
    a slot, which each admit rewrites from zero.  A request's ``extras`` are written
    into its slot's row of the per-slot buffers at its admit
    (``_set_slot_extras``), which the chunk steps and admits read.

    ``slots`` is the decode batch width; ``num_pages`` bounds the cache
    (pages of ``page_size`` tokens, page 0 the trash page; default: every
    slot's worst case); ``max_seq`` caps one request's ``prompt + max_new``;
    ``chunk`` is the number of decode steps between host scheduling points.
    ``page_alloc_seed`` shuffles the free list, so block tables are random
    permutations of the pool (and the JAX package's, for the same seed).
    ``clock`` is a 0-arg monotonic-seconds callable (``time.monotonic``).
    ``prefix_cache=True`` shares the K/V pages of prompt prefixes between
    requests of one serve (``serving.prefix``).  ``speculate`` (a
    ``SpecConfig`` or an int ``k``, n-gram proposals) makes each chunk
    iteration a verify window over every slot (``spec_chunk_step``), each
    slot advancing by its own accepted length; under ``adaptive=True`` the
    host picks each round's width from the slots' acceptance EMAs, and a
    width-0 round is a plain chunk whose emissions the host probes.  After a
    serve ``spec_emitted / spec_live_steps`` is the window acceptance and
    ``decode_chunk_iters`` the weight streams paid.  ``SpecConfig(mode=
    "draft")`` proposes with the draft model ``draft_cfg``/``draft_params``
    (quantized at ``draft_pim_bits`` when non-zero), whose K/V live in a
    pool of their own under the target's block tables: every request's
    pages hold both, and every admit prefills both.  Both pools then carry
    ``k`` positions (whole pages) past ``max_seq``, which the top-up
    provisions so that the draft's read-back of its chain stays in the
    request's pages; the prefix cache stays off (the draft pool has no
    trie).  ``SpecConfig(tree_fan=F)`` verifies F n-gram chains of depth
    ``k`` in one tree window an iteration; the pool carries ``F*k``
    positions (whole pages) past ``max_seq``, which the top-up provisions
    so that the relocation's gathers from the tree columns stay in the
    request's pages.

    The host schedules in numpy as the reference does.  Each round: admit
    queued requests into free slots while pages last, retire what finished
    at admit, extend every live slot's pages to cover the chunk (``_top_up``,
    preempting the youngest when the pool runs dry), copy the block tables
    and per-slot arrays into the static buffers (``ChunkState``), run
    ``chunk`` chunk steps (``decode_chunk_step``), and read the buffers back
    once.  An uncached admit prefills the page-padded prompt into the
    slot's pages (``admit_miss``) and, under the prefix cache, registers its
    full pages in the trie; a cached one aliases the matched pages (forking
    the last copy-on-write when every prompt page matched) and runs one
    verify window over the rest (``admit_cached``).  On the card every
    chunk step and every admit is one replay of a CUDA graph, but for an
    admit of more than CHUNKED_THRESHOLD positions, which runs eagerly; at
    most MAX_ADMIT_GRAPHS admit graphs are kept.

    ``serve_detailed(policy=, chaos=, resume=, heartbeat=)`` runs the
    resilience tier (``serving.resilience``): retries of injected chunk
    faults, deadline, queue, ladder and out-of-memory sheds, payload
    rejects, the degradation ladder (a halved chunk is fewer replays of the
    same chunk step), a ``ServeSnapshot`` each round (``last_snapshot``),
    and resumption from one: an in-flight request is re-admitted by one
    prefill over its prompt and emitted tokens, its draw counter resumed.

    The cache and buffers are made at the first serve and kept, zeroed at
    every later one: a captured step reads the memory it was captured on
    (the reference makes a fresh cache each serve)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int, max_seq: int,
                 page_size: int = 8, num_pages: Optional[int] = None, chunk: int = 8,
                 pim_bits: int = 0, pad_id: int = 0, page_alloc_seed: Optional[int] = None,
                 mesh=None, speculate=None, draft_cfg: Optional[ModelConfig] = None,
                 draft_params=None, draft_pim_bits: int = 0, clock=None,
                 prefix_cache: bool = False, device=None):
        self.spec = as_spec(speculate, cfg, draft_cfg)
        self._draft_mode = self.spec is not None and self.spec.mode == "draft"
        if self._draft_mode and (draft_params is None or draft_cfg is None):
            raise ValueError(_NO_DRAFT)
        _unported(mesh=mesh)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = quantize_tree(params, pim_bits) if pim_bits else params
        self.draft_cfg = draft_cfg
        self.draft_params = _draft_params(draft_params, draft_pim_bits)
        self._clock = clock if clock is not None else time.monotonic
        self.last_snapshot: Optional[ServeSnapshot] = None  # the latest (crash recovery)
        self.last_round = -1
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.max_seq = -(-int(max_seq) // self.page_size) * self.page_size
        # Draft mode: the draft chain reads back the window positions it
        # writes, so both pools carry k positions (whole pages) past
        # max_seq, where a request of the full budget still has pages.  Tree
        # mode: the relocation gathers the kept chain from tree columns up
        # to fan*k past the frontier, which must be the request's pages (a
        # gather through the trash page would corrupt committed positions).
        if self._draft_mode:
            reserve = self.spec.k
        elif self.spec is not None and self.spec.tree_fan:
            reserve = self.spec.tree_fan * self.spec.k
        else:
            reserve = 0
        self._store_seq = self.max_seq + -(-reserve // self.page_size) * self.page_size
        self.width = self._store_seq // self.page_size
        self.num_pages = int(num_pages) if num_pages is not None else self.slots * self.width + 1
        self.chunk = int(chunk)
        self.pad_id = int(pad_id)
        self._rng = (np.random.default_rng(page_alloc_seed)
                     if page_alloc_seed is not None else None)
        self._state: Optional[ChunkState] = None
        self._slot_ex: Optional[dict] = None  # the serve's per-slot extras buffers
        self._ex_key: Optional[tuple] = None  # their leaves' shapes and dtypes
        self.graphs = CapturedSteps(self.device, capacity=MAX_ADMIT_GRAPHS)
        # Only families whose tail window computes what their prefill does
        # share pages; for the others the cache stays off.
        self.prefix_cache = bool(prefix_cache)
        self._prefix_on = (self.prefix_cache and cfg.family in _PREFIX_FAMILIES
                           and not self._draft_mode)
        # The strict pending sweep of a serve under a policy: None defers to
        # the REPRO_STRICT_SERVE environment variable; a bool decides.
        self.strict_pending: Optional[bool] = None
        # Test hook: request indices the admission loop drops, a scheduler
        # bug on purpose, so that the strict sweep's detection is testable.
        self._debug_drop_rids: set[int] = set()
        self._pool_poisoned = False
        self._records = None
        self._now = lambda: 0.0
        self.last_report: Optional[ServeReport] = None
        self.prefix_hits = 0        # cached admits (at least one page aliased)
        self.prefix_hit_tokens = 0  # prompt tokens served from aliased pages
        self.cow_forks = 0          # copy-on-write page forks
        self.prefill_tokens = 0     # prompt tokens computed
        self.peak_pages_in_use = 0
        self.preemptions = 0
        # chunk iterations run: each streams the weights once, so emitted
        # tokens over decode_chunk_iters is the weight-stream amortisation
        self.decode_chunk_iters = 0
        self.spec_emitted = 0     # tokens emitted by verify windows
        self.spec_live_steps = 0  # live (slot, iteration) verify windows
        # Test switch: after every speculative round each live slot's history
        # must be its prompt and every emitted token (AssertionError if not).
        self.debug_check_hist = False

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

    def _kept(self, key: tuple, run, reset, bounded: bool = False):
        """``run`` as a call with no arguments (``CapturedSteps.get``): on the
        card one replay of its graph, every graph of the engine in one
        graph memory pool."""
        return self.graphs.get({"params": self.params, "draft": self.draft_params}, key, "serve",
                               run, reset, bounded)

    def _round_reset(self) -> None:
        """Where a chunk step's warm-up may run in the middle of a serve: every
        block-table row (both pools') zeroed, so its cache writes land in the
        trash page, and the per-slot state stashed; the round's ``_load``
        then overwrites every buffer it wrote and restores the state."""
        self._state.it.zero_()
        self._state.cache["block_tables"].zero_()
        self._state.stash_states()

    def chunk_step(self, n_stops: int, *, greedy: bool, top_k: int):
        """The chunk step: ``decode_chunk_step`` on the current parameters,
        kept on the card per (slots, greedy, top_k, n_stops) and dispatch
        mode.  Got before a round's ``_load`` (``_round_reset``)."""
        st = self._state
        top_k = 0 if greedy else int(top_k)
        run = functools.partial(decode_chunk_step, self.params, self.cfg, st, st.stops(n_stops),
                                greedy=bool(greedy), top_k=top_k, pad_id=self.pad_id,
                                extras=self._slot_ex)
        return self._kept((self.slots, bool(greedy), top_k, n_stops, self._ex_key), run,
                          self._round_reset)

    def spec_chunk(self, k: int, n_stops: int, *, greedy: bool, top_k: int):
        """One iteration of a round of width-``k`` windows (tree windows of
        chains of depth ``k`` under ``tree_fan``): ``spec_chunk_step`` on
        the current parameters and the per-slot extras buffers, kept on the
        card per (slots, k, tree_fan, greedy, top_k, n_stops, extras shapes
        and dtypes) and dispatch mode.  Got before a round's ``_load``
        (``_round_reset``)."""
        st = self._state
        top_k = 0 if greedy else int(top_k)
        fan = self.spec.tree_fan
        if fan:
            tree_tensors(fan, k, self.device)
        emits, ms = st.spec(k)
        run = functools.partial(spec_chunk_step, self.params, self.cfg, st, st.stops(n_stops),
                                emits, ms, k=k, spec=self.spec, greedy=bool(greedy),
                                top_k=top_k, pad_id=self.pad_id,
                                draft_params=self.draft_params if self._draft_mode else None,
                                extras=self._slot_ex)
        return self._kept(("spec", self.slots, k, fan, bool(greedy), top_k, n_stops,
                           self._ex_key), run, self._round_reset)

    def admit_step(self, spad: int, *, greedy: bool, top_k: int):
        """The uncached admit of a prompt padded to ``spad`` positions:
        ``admit_miss`` on the buffers ``ChunkState.admit(spad)``, kept on the
        card per (spad, greedy, top_k) and dispatch mode among at most
        MAX_ADMIT_GRAPHS admit graphs; past CHUNKED_THRESHOLD positions it
        runs eagerly (its attention is ``flash_attention``).  Its warm-up's
        pages are all 0, so it writes only the trash page."""
        st = self._state
        a = st.admit(spad)
        top_k = 0 if greedy else int(top_k)
        run = functools.partial(admit_miss, self.params, self.cfg, st, a, greedy=bool(greedy),
                                top_k=top_k, extras=self._slot_ex,
                                draft_params=self.draft_params if self._draft_mode else None)
        if spad > CHUNKED_THRESHOLD:
            return run

        def reset():
            a.ints.zero_()
            a.length.fill_(1)
        return self._kept(("admit", spad, bool(greedy), top_k, self._ex_key), run, reset,
                          bounded=True)

    def verify_window(self, width: int, *, greedy: bool, top_k: int):
        """The cached admit of a tail window ``width`` positions wide:
        ``admit_cached`` on the buffers ``ChunkState.window(width)``, kept
        like ``admit_step``'s graphs.  Its warm-up runs with every
        block-table row zeroed, so it writes only the trash page."""
        st = self._state
        w = st.window(width)
        top_k = 0 if greedy else int(top_k)
        run = functools.partial(admit_cached, self.params, self.cfg, st, w, greedy=bool(greedy),
                                top_k=top_k, extras=self._slot_ex)
        if width > CHUNKED_THRESHOLD:
            return run

        def reset():
            w.ints.zero_()
            w.tokens.zero_()
            st.cache["block_tables"].zero_()
        return self._kept(("window", width, bool(greedy), top_k, self._ex_key), run, reset,
                          bounded=True)

    # ------------------------------------------------------------ lifecycle --
    @torch.inference_mode()
    def _reset(self, requests, n_stops: int) -> None:
        b, w = self.slots, self.width
        if self._state is None:
            self._state = ChunkState(self.cfg, b, self._store_seq, self.num_pages,
                                     self.page_size, self.chunk, self.device,
                                     self.draft_cfg if self._draft_mode else None)
        else:
            self._state.zero_()
        # the per-slot extras of the trace's structure, zeroed: a request's
        # row is written at its admit (``_set_slot_extras``)
        self._slot_ex = self._state.extras.get(requests[0].extras if len(requests) else None)
        self._ex_key = _extras_key(self._slot_ex)
        # The trie's pages are valid against this serve's pool only, so both
        # start afresh: prefixes are shared within one serve's trace.
        self._trie = PrefixTrie() if self._prefix_on else None
        self._pool = PagePool(self.num_pages, rng=self._rng,
                              on_evict=self._trie.drop_page if self._trie is not None else None)
        self._pool_poisoned = False
        self._bt = np.zeros((b, w), np.int32)
        self._pos = np.zeros(b, np.int64)
        self._n_out = np.zeros(b, np.int64)
        self._done = np.ones(b, bool)  # inactive slots are "done"
        self._max_new = np.zeros(b, np.int64)
        self._stops = np.full((b, n_stops), -1, np.int32)
        self._tok = np.zeros((b, 1), np.int32)
        self._keys = np.zeros((b, 2), np.int64)  # row key of each slot's draws
        # speculation: each slot's prompt length, window counter, window-stream
        # row key, acceptance EMA (carried through snapshots), probation flag
        # (a freshly admitted slot's first round is short), and history
        # (prompt + emissions), rewritten whole at every admit
        self._plen = np.zeros(b, np.int64)
        self._wctr = np.zeros(b, np.int64)
        self._wkeys = np.zeros((b, 2), np.int64)
        self._acc_ema = np.zeros(b, np.float32)
        self._ctrl_fresh = np.zeros(b, bool)
        self._hist = np.zeros((b, self.max_seq), np.int32)
        self._slot_req = [-1] * b
        self._slot_pages: list[list[int]] = [[] for _ in range(b)]
        self._admit_seq = [-1] * b
        self._seq = 0
        self._outputs = [[] for _ in requests]
        self._queue = deque(range(len(requests)))

    def _set_slot_extras(self, slot: int, extras: Optional[dict]) -> None:
        """Write a request's extras into its slot's row of the per-slot
        buffers that the chunk steps and admits read (in place)."""
        if extras is None:
            return
        _copy_tree(_tree_map(lambda t: t[slot], self._slot_ex),
                   _extras_on(extras, self.device))

    def _prefix_probe(self, req, resume) -> tuple:
        """(chunk keys, extras fingerprint, matched trie pages) of a fresh
        request under the prefix cache; ``([], None, [])`` without it, and
        for a resumed admit (``resume``), whose sequence holds emitted
        tokens and is replayed through the full prefill.  Changes no
        refcount and no LRU order, so the admission gate and ``_admit`` can
        both call it."""
        if not self._prefix_on or resume is not None:
            return [], None, []
        keys = chunk_keys(np.asarray(req.prompt, np.int32), self.page_size)
        fp = extras_fingerprint(req.extras)
        return keys, fp, self._trie.match(keys, fp)

    def _admit_page_need(self, req, resume) -> tuple[int, list[int]]:
        """(fresh pages the admit allocates, trie pages it aliases): the
        admission gate's probe.  A resumed admit prefills its prompt and
        all but its last emitted token.  Admission is optimistic (the first
        chunk's growth is not counted): if the round's ``_top_up`` then
        finds the pool dry, the youngest slot yields."""
        length = len(req.prompt) + (len(resume.emitted) - 1 if resume else 0)
        total = self._spad(length) // self.page_size
        _, _, matched = self._prefix_probe(req, resume)
        if matched and len(matched) == total and length == total * self.page_size:
            return 1, matched  # a full-prefix hit: only the fork of the last page is fresh
        return total - len(matched), matched

    def _window_table(self, slot: int) -> np.ndarray:
        """The block tables a cached admit's window runs with: the admitted
        slot's row, every other row zeroed (their window writes land in the
        trash page, not in live pages)."""
        bt = np.zeros_like(self._bt)
        bt[slot] = self._bt[slot]
        return bt

    def _admit_uncached(self, slot: int, seq: np.ndarray, spad: int, pages: list[int], rid: int,
                        greedy: bool, top_k: int) -> int:
        """The miss: ``admit_step``'s replay (or run) on the prompt padded to
        ``spad``, its pages and the slot's extras; returns draw 0.  The slot
        is set first: a warm-up before a capture prefills into that slot's
        row of the per-slot state, which the admit then writes again."""
        a = self._state.admit(spad)
        a.slot.fill_(slot)
        step = self.admit_step(spad, greedy=greedy, top_k=top_k)
        prompt = np.zeros((1, spad), np.int32)
        prompt[0, :len(seq)] = seq
        a.prompt.copy_(torch.from_numpy(prompt))
        a.ints.copy_(torch.from_numpy(np.array([*pages, len(seq), rid], np.int64)))
        step()
        return int(a.tok)

    def _admit_cached(self, slot: int, seq: np.ndarray, tail_start: int, spad: int, rid: int,
                      greedy: bool, top_k: int) -> int:
        """The hit: one window over positions ``tail_start .. spad - 1`` of
        ``slot`` (``verify_window``'s replay or run), the block tables in
        ``ChunkState`` replaced by ``_window_table`` until the round's
        ``_load``; returns draw 0."""
        width = spad - tail_start
        step = self.verify_window(width, greedy=greedy, top_k=top_k)
        st = self._state
        w = st.window(width)
        tokens = np.zeros((self.slots, width), np.int32)
        tokens[slot, :len(seq) - tail_start] = seq[tail_start:]
        ints = np.zeros(self.slots + 3, np.int64)
        ints[slot] = tail_start
        ints[self.slots:] = (slot, len(seq) - 1 - tail_start, rid)
        st.cache["block_tables"].copy_(torch.from_numpy(self._window_table(slot)))
        w.tokens.copy_(torch.from_numpy(tokens))
        w.ints.copy_(torch.from_numpy(ints))
        step()
        return int(w.tok)

    def _admit(self, requests, slot: int, ridx: int, greedy: bool, top_k: int,
               resume: Optional[InflightState] = None) -> dict:
        """Admit request ``ridx`` into ``slot``; returns the admit event's
        fields (``cached_tokens``, ``prefilled_tokens``, ``cow``).

        A prefix-trie hit aliases the matched pages into the slot's block
        table (a reference each) and computes only the unmatched tail, in
        one verify window that draws the first token at the true prompt end
        with the same ``(rid, 0)`` key as a miss.  A full-prefix hit still
        runs the last prompt position for its logits, and that write lands
        in the last matched page, which the trie and perhaps live siblings
        read: that page is forked copy-on-write first.  A miss prefills the
        padded prompt into fresh pages and, under the prefix cache, then
        registers the prompt's full pages in the trie.

        With ``resume`` (crash replay, ``resume_mode="prefill"``) the request
        is re-admitted mid-stream: one prefill over ``prompt +
        emitted[:-1]`` (the same admit as a miss's, at that length) rebuilds
        its pages, its draw 0 is thrown away, the last emission becomes the
        slot's token and the draw counter resumes at ``len(emitted)``, so
        the ``(rid, counter)`` keys continue the stream the crashed run was
        drawing from.  It probes and registers nothing in the trie."""
        req = requests[ridx]
        ps = self.page_size
        length = len(req.prompt)
        rid = ridx if req.rid is None else int(req.rid)
        emitted = [int(t) for t in resume.emitted] if resume is not None else []
        m = len(emitted)
        seq = np.asarray(req.prompt, np.int32)
        if m:
            seq = np.concatenate([seq, np.asarray(emitted[:-1], np.int32)])
        n = len(seq)  # length + m - 1 when resuming
        spad = self._spad(n)
        total = spad // ps
        self._set_slot_extras(slot, req.extras)
        keys, fp, matched = self._prefix_probe(req, resume)
        cow = False
        if matched and len(matched) == total and n == total * ps:
            # every prompt position is cached, but position L - 1's logits
            # are still needed and its K/V write lands in the last matched page
            for p in matched:
                self._pool.acquire(p)
            fork = self._pool.alloc(1)[0]
            _copy_page(self._state.cache, matched[-1], fork, seq_stacks(self.cfg))
            self._pool.release(matched[-1])
            pages = matched[:-1] + [fork]
            tail_start = n - 1
            cow = True
            self.cow_forks += 1
        elif matched:
            for p in matched:
                self._pool.acquire(p)
            pages = matched + self._pool.alloc(total - len(matched))
            tail_start = len(matched) * ps
        else:
            pages = self._pool.alloc(total)
            tail_start = 0
        self._bt[slot, :] = 0
        self._bt[slot, : len(pages)] = pages
        if matched:
            tok0 = self._admit_cached(slot, seq, tail_start, spad, rid, greedy, top_k)
            self.prefix_hits += 1
            self.prefix_hit_tokens += tail_start
        else:
            tok0 = self._admit_uncached(slot, seq, spad, pages, rid, greedy, top_k)
            if self._prefix_on and resume is None:
                # a miss's full pages hold final positions (decode writes
                # start at L) computed as any later miss would compute them
                self._trie.insert(keys, fp, pages, on_new=self._pool.mark_cached)
        self.prefill_tokens += n - tail_start
        if not m:
            emitted = [tok0]  # a fresh admit's draw 0 is emission 0
        stops = tuple(req.stop_tokens)
        self._outputs[ridx] = list(emitted)
        self._pos[slot] = length + len(emitted) - 1
        self._n_out[slot] = len(emitted)
        self._max_new[slot] = req.max_new
        self._stops[slot, :] = -1
        self._stops[slot, : len(stops)] = stops
        self._tok[slot, 0] = emitted[-1]
        rids = torch.tensor([rid], device=self.device)
        self._keys[slot] = row_keys(self._state.base, rids, TAG_TOKEN)[0].cpu().numpy()
        self._hist[slot, :] = 0
        self._hist[slot, :length] = np.asarray(req.prompt, np.int32)
        self._hist[slot, length: length + len(emitted)] = emitted
        self._plen[slot] = length
        self._wctr[slot] = int(resume.wctr) if resume is not None else 0
        self._acc_ema[slot] = (float(resume.acc_ema) if resume is not None
                               else self.spec.ctrl_init if self.spec is not None else 0.0)
        self._ctrl_fresh[slot] = True
        if self.spec is not None:
            self._wkeys[slot] = row_keys(self._state.base, rids, TAG_WINDOW)[0].cpu().numpy()
        self._done[slot] = len(emitted) >= req.max_new or emitted[-1] in stops
        self._slot_req[slot] = ridx
        self._slot_pages[slot] = list(pages)
        self._admit_seq[slot] = self._seq
        self._seq += 1
        return {"cached_tokens": tail_start, "prefilled_tokens": n - tail_start, "cow": cow}

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
        self._wctr[slot] = 0
        self._wkeys[slot] = 0
        self._acc_ema[slot] = 0.0
        self._ctrl_fresh[slot] = False
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

    def _top_up(self, requests, slot: int, eff_chunk: Optional[int] = None,
                eff_k: Optional[int] = None) -> None:
        """Extend the slot's block table to cover the consumed positions of the
        round's ``eff_chunk`` iterations of width ``eff_k`` (None: plain
        steps; by default the engine's ``chunk`` and ``spec.k``; the ladder
        and the controller may cut them).  A window's writes past the
        consumed frontier need no page: they land in the trash page and are
        written again before anything reads them.  If the pool runs dry,
        younger live requests are preempted, unless this slot is the
        youngest: then it yields (requeues itself), so the eldest always
        progresses and two requests cannot evict each other forever."""
        req = requests[self._slot_req[slot]]
        ps = self.page_size
        length = len(req.prompt)
        chunk = self.chunk if eff_chunk is None else eff_chunk
        k = (self.spec.k if self.spec is not None else None) if eff_chunk is None else eff_k
        # the round's live writes reach pos + chunk * (k + 1) - 1, at most the
        # last live position length + max_new - 2; the prefill covered spad - 1.
        # A draft chain reads back up to k positions past that, which must be
        # the request's pages, not the trash page the target's writes past it
        # may go to (the pools carry them past max_seq); a tree relocation
        # gathers from up to fan * k positions past it.
        adv = chunk * (k + 1 if k is not None else 1)
        cap = length + req.max_new - 2
        if self._draft_mode and k is not None:
            cap = min(cap + k, self._store_seq - 1)
        fan = self.spec.tree_fan if self.spec is not None else 0
        if fan and k is not None:
            adv = chunk * (k + 1) + fan * k
            cap = min(cap + fan * k, self._store_seq - 1)
        last = min(int(self._pos[slot]) + adv - 1, cap)
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
        static buffers, the iteration back to row 0, and the per-slot state
        as it was before a warm-up (``_round_reset``)."""
        st = self._state
        st.restore_states()
        for buf, host in ((st.cache["block_tables"], self._bt), (st.tok, self._tok),
                          (st.pos, self._pos), (st.n_out, self._n_out),
                          (st.max_new, self._max_new), (st.done, self._done),
                          (st.keys, self._keys), (st.stops(self._stops.shape[1]), self._stops)):
            buf.copy_(torch.from_numpy(host))
        if self.spec is not None:
            for buf, host in ((st.hist[:, :self.max_seq], self._hist), (st.wctr, self._wctr),
                              (st.ema, self._acc_ema), (st.wkeys, self._wkeys)):
                buf.copy_(torch.from_numpy(host))
        st.it.zero_()

    def _read(self, n: int, k: Optional[int] = None) -> tuple:
        """Round end: the emissions of the round's ``n`` chunk steps (rows
        past ``n`` hold an earlier round's), their liveness (plain steps) or
        counts (windows of width ``k``), the per-slot carry, and after
        windows the history, window counters and EMAs, on the host."""
        st = self._state
        if k is None:
            out = (st.emits[:n], st.lives[:n])
        else:
            emits, ms = st.spec(k)
            out = (emits[:n], ms[:n])
        out += (st.tok, st.pos, st.n_out, st.done)
        if k is not None:
            out += (st.hist[:, :self.max_seq], st.wctr, st.ema)
        return tuple(t.to("cpu", copy=True).numpy() for t in out)

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
        (None: ``PRNGKey(0)``).  ``policy`` and ``chaos`` go to
        ``serve_detailed``; without a policy an invalid request raises and
        faults propagate.  The report is kept on ``last_report``."""
        report = self.serve_detailed(requests, greedy=greedy, temperature=temperature,
                                     top_k=top_k, key=key, policy=policy, chaos=chaos)
        return [r.tokens for r in report.records]

    def _shed(self, records, report, ridx: int, reason: str) -> None:
        rec = records[ridx]
        rec.status, rec.reason = "shed", reason
        rec.tokens = np.asarray(self._outputs[ridx], np.int32)
        rec.events.append({"name": "shed", "ts": self._now(), "reason": reason})
        report.sheds += 1

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

    def _take_snapshot(self, records, policy, rnd: int) -> ServeSnapshot:
        """The host-side recovery point: finished outputs, each in-flight
        request's emissions (in admit order) and the queue.  No device state:
        a resumed admit recomputes the pages."""
        live = sorted((s for s in range(self.slots) if self._slot_req[s] >= 0),
                      key=lambda s: self._admit_seq[s])
        inflight = {}
        for s in live:
            ridx = self._slot_req[s]
            inflight[ridx] = InflightState(emitted=[int(t) for t in self._outputs[ridx]],
                                           wctr=int(self._wctr[s]), t_admit=records[ridx].t_admit,
                                           t_first=records[ridx].t_first,
                                           acc_ema=float(self._acc_ema[s]))
        snap = ServeSnapshot(
            finished={i: [int(t) for t in self._outputs[i]] for i, r in enumerate(records)
                      if r.status == "done"},
            inflight=inflight, queued=list(self._queue),
            closed={i: (r.status, r.reason) for i, r in enumerate(records)
                    if r.status in ("shed", "rejected")},
            round=rnd)
        self.last_snapshot = snap
        if policy is not None and policy.snapshot_sink is not None:
            policy.snapshot_sink(snap)
        return snap

    @torch.inference_mode()
    def serve_detailed(self, requests: Sequence[Request], *, greedy: bool = True,
                       temperature: float = 1.0, top_k: int = 0, key=None,
                       policy: Optional[ResiliencePolicy] = None, chaos=None,
                       resume: Optional[ServeSnapshot] = None, heartbeat=None) -> ServeReport:
        """``serve`` with its ``ServeReport``: per-request outcomes, times
        (engine-clock seconds from this call's start, plus the skew of
        injected latency, retry backoff and ``policy.round_time`` a round)
        and events, the resilience counters, and one counter sample per
        round.

        ``policy`` (``resilience.ResiliencePolicy``) turns on admission
        validation (invalid or corrupt payloads become "rejected" instead of
        raising), deadline, queue and ladder sheds, retries of transient
        ``ChunkFault``s with backoff, the degradation ladder and a snapshot
        every ``snapshot_every`` rounds.  ``chaos`` (a
        ``chaos.FaultInjector``) injects seeded failures at the scheduling
        boundaries; chaos without a policy gets ``ResiliencePolicy()``.
        ``resume`` replays a ``ServeSnapshot``: finished and closed requests
        keep their outcome; in-flight ones are re-admitted mid-stream
        (``resume_mode="prefill"``) or requeued from scratch
        (``"recompute"``, and always without a policy).  ``heartbeat`` is
        called once a round (the supervisor's liveness signal).  On an
        ``EngineCrash`` (injected, retries exhausted, or a failed chunk step
        under a policy) the latest snapshot stays on ``last_snapshot``.
        Without a policy an invalid request raises, and so does a scheduler
        that loses one."""
        if chaos is not None and policy is None:
            policy = ResiliencePolicy()
        hardened = policy is not None
        ex_struct = extras_structure(requests[0].extras) if len(requests) else None
        records = [RequestRecord() for _ in requests]
        rejected_upfront: set[int] = set()
        for i, r in enumerate(requests):
            bad = None
            if len(r.prompt) < 1 or r.max_new < 1:
                bad = "requests need len(prompt) >= 1, max_new >= 1"
            elif len(r.prompt) + r.max_new > self.max_seq:
                bad = (f"prompt ({len(r.prompt)}) + max_new ({r.max_new}) "
                       f"exceeds max_seq ({self.max_seq})")
            if bad is not None:
                if not hardened:
                    raise ValueError(bad)
                records[i].status, records[i].reason = "rejected", bad
                rejected_upfront.add(i)
                continue
            if extras_structure(r.extras) != ex_struct:
                raise ValueError("all requests in a trace must share the same extras structure "
                                 "(the chunk step is one captured program)")
        base = prng_key(0 if key is None else key, self.device)
        greedy, top_k = bool(greedy), 0 if greedy else int(top_k)
        n_stops = max((len(r.stop_tokens) for r in requests), default=0)
        self._reset(requests, n_stops)
        self._state.temperature.fill_(temperature)
        self._state.base.copy_(base)
        self.peak_pages_in_use = self.decode_chunk_iters = self.prefill_tokens = 0
        self.spec_emitted = self.spec_live_steps = 0
        self.prefix_hits = self.prefix_hit_tokens = self.cow_forks = 0
        report = ServeReport(records=records)
        report.rejects += len(rejected_upfront)
        clock = self._clock
        t0 = clock()
        skew = 0.0  # injected latency + retry backoff + round time

        def now() -> float:
            return (clock() - t0) + skew

        self._records, self._now = records, now
        ladder = DegradationLadder(policy.ladder if hardened else LadderConfig(enabled=False),
                                   has_spec=self.spec is not None)
        # ---- resume: restore finished and closed outcomes, rebuild the queue
        resume_inflight: dict[int, InflightState] = {}
        if resume is not None:
            for ridx, toks in resume.finished.items():
                records[ridx].status = "done"
                records[ridx].tokens = np.asarray(toks, np.int32)
                self._outputs[ridx] = [int(t) for t in toks]
            for ridx, (status, reason) in resume.closed.items():
                if ridx in rejected_upfront:
                    continue  # rejected (and counted) again above
                records[ridx].status, records[ridx].reason = status, reason
                if status == "shed":
                    report.sheds += 1
                else:
                    report.rejects += 1
            if hardened and policy.resume_mode == "prefill":
                resume_inflight = dict(resume.inflight)
                for ridx, st in resume.inflight.items():
                    records[ridx].t_admit = st.t_admit
                    records[ridx].t_first = st.t_first
            # "recompute" (or no policy): in-flight requests start again from
            # scratch, as recompute preemption does
            self._queue = deque(list(resume.inflight)
                                + [r for r in resume.queued if r not in rejected_upfront])
        else:
            self._queue = deque(i for i in range(len(requests)) if i not in rejected_upfront)
        self.last_snapshot = None
        snap_every = policy.snapshot_every if hardened else 0
        if snap_every:
            self._take_snapshot(records, policy, -1)

        rnd = 0
        self._pool_poisoned = True  # until the round loop completes
        while self._queue or any(r >= 0 for r in self._slot_req):
            self.last_round = rnd
            if heartbeat is not None:
                heartbeat()
            if chaos is not None:
                chaos.crash(rnd)  # raises EngineCrash; the supervisor replays
            retries_before, preempt_before, sheds_round = report.retries, self.preemptions, 0
            # ---- queue management: deadline, bounded-queue and ladder sheds
            if hardened:
                t = now()
                if policy.shed_expired:
                    for ridx in list(self._queue):
                        dl = requests[ridx].deadline
                        if dl is not None and t > dl:
                            self._queue.remove(ridx)
                            self._shed(records, report, ridx, "deadline")
                            sheds_round += 1
                if policy.max_queue is not None:
                    while len(self._queue) > policy.max_queue:
                        q = list(self._queue)
                        # the lowest SLO class first; ties shed the youngest
                        i = min(range(len(q)), key=lambda j: (requests[q[j]].slo, -j))
                        self._queue.remove(q[i])
                        self._shed(records, report, q[i], "queue")
                        sheds_round += 1
                if ladder.shedding():
                    for ridx in list(self._queue):
                        if requests[ridx].slo < ladder.cfg.protect_slo:
                            self._queue.remove(ridx)
                            self._shed(records, report, ridx, "ladder")
                            sheds_round += 1
            # ---- admit queued requests into free slots while pages last
            admitted_any = blocked = False
            for slot in range(self.slots):
                if blocked or self._slot_req[slot] >= 0:
                    continue
                while self._queue:
                    ridx = self._queue[0]
                    if ridx in self._debug_drop_rids:
                        self._queue.popleft()  # the test hook's lost request
                        continue
                    req = requests[ridx]
                    if hardened and req.arrival > now():
                        blocked = True  # FIFO: an unarrived head waits
                        break
                    prompt = np.asarray(req.prompt)
                    if chaos is not None:
                        prompt = chaos.corrupt_request(prompt, ridx, rnd)
                    if hardened and policy.validate:
                        arr = np.asarray(prompt)
                        if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= self.cfg.vocab):
                            self._queue.popleft()
                            records[ridx].status, records[ridx].reason = "rejected", "corrupt"
                            report.rejects += 1
                            continue  # the slot is still free: try the next head
                    rs = resume_inflight.pop(ridx, None)
                    need, reserve = self._admit_page_need(req, rs)
                    if self._pool.available(reserve) < need:
                        if rs is not None:
                            resume_inflight[ridx] = rs  # again next round
                        blocked = True
                        break
                    self._queue.popleft()
                    info = self._admit(requests, slot, ridx, greedy, top_k, resume=rs)
                    rec = records[ridx]
                    rec.slot = slot
                    if rec.t_admit is None:
                        rec.t_admit = rec.t_first = now()
                    rec.events.append({"name": "admit", "ts": now(), "slot": slot,
                                       "round": rnd, **info})
                    admitted_any = True
                    break
            # retire what finished at admit (max_new == 1, or a stop at draw 0)
            t_adm = now()
            for slot in range(self.slots):
                if self._slot_req[slot] >= 0 and self._done[slot]:
                    self._finish(requests, records, slot, t_adm)
            live = [s for s in range(self.slots) if self._slot_req[s] >= 0]
            if not live:
                if self._queue and not admitted_any:
                    head = self._queue[0]
                    if hardened and requests[head].arrival > now():
                        # idle until the head arrives; deterministic time moves
                        skew += policy.round_time or policy.backoff_s
                    elif hardened:
                        self._queue.popleft()
                        self._shed(records, report, head, "oom")
                    else:
                        raise RuntimeError(
                            "page pool too small to admit request with prompt "
                            f"{len(requests[head].prompt)} tokens; increase num_pages")
                rnd += 1
                continue
            eff_chunk, eff_k = self._round_width(ladder)
            spec_on = eff_k is not None
            # ---- page top-up, under injected pool pressure
            withheld: Optional[list[int]] = []
            if chaos is not None:
                n_w = chaos.squeeze_pages(len(self._pool.free), rnd)
                if n_w:
                    # from the free list only: retained cache pages stay
                    # evictable, so a squeeze squeezes the cache first
                    withheld = self._pool.free[-n_w:]
                    del self._pool.free[-n_w:]
                    report.squeezed_pages += n_w

            def top_ups():
                for s in live:
                    if self._slot_req[s] >= 0:  # an earlier top-up may have preempted it
                        self._top_up(requests, s, eff_chunk, eff_k)

            try:
                top_ups()
            except RuntimeError:
                if withheld:
                    # the squeeze alone exhausted the pool: give the pages back
                    self._pool.free.extend(withheld)
                    withheld = []
                    try:
                        top_ups()
                    except RuntimeError:
                        if not hardened:
                            raise
                        withheld = None
                elif hardened:
                    withheld = None
                else:
                    raise
            if withheld is None:
                # the pool is too small for the one live request left: shed it
                s0 = next(s for s in range(self.slots) if self._slot_req[s] >= 0)
                self._shed(records, report, self._slot_req[s0], "oom")
                self._retire(s0)
                rnd += 1
                continue
            if withheld:
                self._pool.free.extend(withheld)
            self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use())
            # ---- transient chunk faults: retry with (virtual) backoff
            lag = 0.0
            if chaos is not None:
                attempt = 0
                while True:
                    try:
                        chaos.chunk_fault(rnd)
                        break
                    except ChunkFault as e:
                        report.retries += 1
                        if attempt >= policy.max_retries:
                            raise EngineCrash(f"chunk retries exhausted: {e}") from e
                        skew += policy.backoff_s * (2.0 ** attempt)
                        attempt += 1
                lag = chaos.chunk_latency(rnd)
                skew += lag
                report.straggle_s += lag
            # ---- the chunk: one replay per iteration, one read-back per round
            n0 = self._n_out.copy()
            t_round_start = now()
            self.decode_chunk_iters += eff_chunk
            try:
                if spec_on:
                    step = self.spec_chunk(eff_k, n_stops, greedy=greedy, top_k=top_k)
                else:
                    step = self.chunk_step(n_stops, greedy=greedy, top_k=top_k)
                self._load()
                for _ in range(eff_chunk):
                    step()
                emits, lives, self._tok, self._pos, self._n_out, self._done, *spec_out = (
                    self._read(eff_chunk, eff_k))
            except (ChunkFault, EngineCrash):
                raise
            except Exception as e:
                if hardened:
                    # a chunk step failed mid-round: a crash, which the
                    # supervisor recovers from the last snapshot
                    raise EngineCrash(f"chunk execution failed: {e}") from e
                raise
            if spec_on:
                self._spec_emissions(emits, lives, *spec_out)
                lives = lives > 0  # a window's count: the slot was live
            else:
                self._plain_emissions(emits, lives, n0)
            if hardened:
                skew += policy.round_time
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
                    fin_it = int(liv[-1]) if liv.size else eff_chunk - 1
                    t_slot = t_round_start + (fin_it + 1) / eff_chunk * (t_end - t_round_start)
                    self._finish(requests, records, slot, t_slot)
            report.counters.append({"ts": t_end, "round": rnd,
                                    "free_pages": len(self._pool.free),
                                    "retained_pages": len(self._pool.lru),
                                    "pages_in_use": self.pages_in_use(),
                                    "prefix_hit_tokens": self.prefix_hit_tokens,
                                    "eff_k": int(eff_k) if spec_on else 0,
                                    "queued": len(self._queue), "retries": report.retries})
            # ---- ladder signals and the snapshot
            if hardened:
                bad = []
                if report.retries > retries_before:
                    bad.append("retries")
                if self.preemptions > preempt_before:
                    bad.append("preempt")
                if sheds_round:
                    bad.append("shed")
                if self._pool.available() / max(1, self.num_pages - 1) < ladder.cfg.free_frac:
                    bad.append("pressure")
                if lag > 0:
                    bad.append("straggle")
                ladder.update(rnd, bool(bad), "+".join(bad))
                if snap_every and rnd % snap_every == 0:
                    self._take_snapshot(records, policy, rnd)
            rnd += 1
        self._pool_poisoned = False
        report.rounds = rnd
        report.ladder_trace = list(ladder.trace)
        report.max_ladder_level = max((lvl for _, lvl, _ in ladder.trace), default=0)
        dropped = [i for i, rec in enumerate(records) if rec.status == "pending"]
        if dropped:
            # A pending record is a request the scheduler lost.  Under a policy
            # a server may prefer an answer to an exception (strict_pending
            # False, or REPRO_STRICT_SERVE unset): the records say so.
            strict = (self.strict_pending if self.strict_pending is not None
                      else os.environ.get("REPRO_STRICT_SERVE", "") not in ("", "0", "false"))
            if strict or not hardened:
                raise RuntimeError(f"scheduler dropped requests {dropped}: still pending after "
                                   "the serve loop — every request must end done/shed/rejected")
            for i in dropped:
                records[i].status, records[i].reason = "done", "coerced-pending"
        report.prefix_hits = self.prefix_hits
        report.prefix_hit_tokens = self.prefix_hit_tokens
        report.prefill_tokens = self.prefill_tokens
        report.cow_forks = self.cow_forks
        report.evictions = self._pool.evictions
        self.assert_quiescent()
        if snap_every:
            self._take_snapshot(records, policy, rnd)
        self.last_report = report
        return report

    def _round_width(self, ladder: DegradationLadder) -> tuple[int, Optional[int]]:
        """The round's (chunk iterations, window width; None for plain steps):
        the ladder's rung, and under the adaptive controller ``min(rung,
        adaptive_k_host)`` over the live slots' EMAs.  An adaptive round
        ends where the longest remaining budget (with a queue, the shortest)
        is covered, lasts 2 iterations while a slot is on probation, and is
        rounded down to a power of two; at width 0 it is a plain chunk."""
        eff_chunk, eff_k = ladder.params(self.chunk, self.spec.k if self.spec is not None else None)
        if eff_k is None or not self.spec.adaptive:
            return eff_chunk, eff_k
        alive = np.asarray([self._slot_req[s] >= 0 and not self._done[s]
                            for s in range(self.slots)])
        eff_k = min(eff_k, adaptive_k_host(self._acc_ema, alive, self.spec))
        left = [int(self._max_new[s] - self._n_out[s]) for s in range(self.slots) if alive[s]]
        rem = max(left, default=1)
        if self._queue:
            rem = min(rem, min(left, default=rem))
        if eff_k > 0:
            eff_chunk = min(eff_chunk, -(-rem // (eff_k + 1)))
            if alive.any() and self._ctrl_fresh[alive].any():
                eff_chunk = min(eff_chunk, 2)
        else:
            eff_k = None
            eff_chunk = min(eff_chunk, rem)
        self._ctrl_fresh[alive] = False
        eff_chunk = max(1, eff_chunk)
        if eff_chunk < self.chunk:
            eff_chunk = 1 << (eff_chunk.bit_length() - 1)
        return eff_chunk, eff_k

    def _spec_emissions(self, emits, ms, hist, wctr, ema) -> None:
        """A speculative round's read-back into the host state: each live
        window's first ``ms`` emissions to its request, the slots' history,
        window counters and EMAs (``debug_check_hist`` audits the
        history)."""
        self._hist, self._wctr, self._acc_ema = hist, wctr, ema
        for t in range(ms.shape[0]):
            for slot in range(self.slots):
                m = int(ms[t, slot])
                if m and self._slot_req[slot] >= 0:
                    self._outputs[self._slot_req[slot]].extend(int(x) for x in emits[t, slot, :m])
                    self.spec_emitted += m
                    self.spec_live_steps += 1
        if self.debug_check_hist:
            for slot in range(self.slots):
                ridx = self._slot_req[slot]
                if ridx < 0:
                    continue
                out = self._outputs[ridx]
                pl = int(self._plen[slot])
                got = self._hist[slot, pl: pl + len(out)]
                if not np.array_equal(got, np.asarray(out, np.int32)):
                    raise AssertionError(
                        f"n-gram history desync on slot {slot} (request {ridx}): hist "
                        f"emissions {got.tolist()} != outputs {out}")

    def _plain_emissions(self, emits, lives, n0) -> None:
        """A plain round's emissions to their requests.  A speculating engine
        also extends the slots' history, and under the adaptive controller
        updates each EMA with whether the emitted token is the proposer's
        first guess: the acceptance a window's probe would measure."""
        cnt = n0.copy()
        for t in range(emits.shape[0]):
            for slot in range(self.slots):
                if lives[t, slot] and self._slot_req[slot] >= 0:
                    tv = int(emits[t, slot])
                    self._outputs[self._slot_req[slot]].append(tv)
                    if self.spec is None:
                        continue
                    hl = int(self._plen[slot] + cnt[slot])
                    if self.spec.adaptive:
                        pred = propose_first_host(self._hist[slot], hl, self.spec.ngram_n)
                        al = self.spec.ctrl_alpha
                        self._acc_ema[slot] = ((1.0 - al) * self._acc_ema[slot]
                                               + al * float(pred == tv))
                    self._hist[slot, hl] = tv
                    cnt[slot] += 1

    def generate(self, prompt_tokens, n_new: int, *, extras: Optional[dict] = None,
                 greedy: bool = True, temperature: float = 1.0, top_k: int = 0, key=None,
                 stop_tokens: Sequence[int] = ()) -> torch.Tensor:
        """The fixed-batch API over the scheduler: each row of
        ``prompt_tokens`` (B, S) becomes a Request; rows that retire early
        are padded with ``pad_id``.  Row i of ``extras`` (each leaf (B, ...),
        batched as ``ServingEngine.generate``'s) becomes request i's.
        Returns (B, n_new) int32 on the engine's device."""
        prompts = np.asarray(torch.as_tensor(prompt_tokens).cpu(), np.int32)
        reqs = [Request(prompt=row, max_new=int(n_new), stop_tokens=tuple(stop_tokens),
                        extras=_tree_map(lambda a: a[i], extras))
                for i, row in enumerate(prompts)]
        outs = self.serve(reqs, greedy=greedy, temperature=temperature, top_k=top_k, key=key)
        full = np.full((len(reqs), int(n_new)), self.pad_id, np.int32)
        for i, o in enumerate(outs):
            full[i, : len(o)] = o
        return torch.from_numpy(full).to(self.device)

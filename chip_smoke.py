#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card and check its kernels.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Five paths run, at qwen2-1.5b's full width (28 layers, bf16, random
weights from a seeded generator on the card):

* decoding from PIM-quantized weights: ``serving.quantize_tree`` ->
  ``models.prefill`` -> ``models.decode_step`` -> ``ServingEngine.generate``,
  every decode-time linear through the hand-written CUDA kernel
  ``pim_matvec``; each decode step, sampling included, is one replay of a
  CUDA graph the engine captured;
* the packed kernel entry point ``repro_torch.kernels`` (``ops``): every
  layer's seven float weights through ``quantize_for_pim``, then
  ``pim_dense`` (the CUDA kernel ``pim_matmul``) on a prefill's 4 x 128 rows
  and ``pim_matvec_dense`` on 4 of them;
* the bit-plane half of that entry point: the same weights through
  ``pim_dense_bitplane`` (the CUDA kernel ``bitplane_matmul``) on the same
  rows, and ``fold_sum`` (the CUDA kernel ``fold_reduce``) on a prefill's
  attention-score folds and a decode step's 32K-key denominator;
* the long-prompt path: ``ServingEngine.generate`` on a 16,384-token
  prompt, past the model's 8,192-key threshold, so every layer's prefill
  attention runs the hand-written CUDA kernel ``flash_attention``;
* continuous batching: ``ContinuousBatchingEngine.serve`` over a paged KV
  cache, every decode linear of every chunk step through ``pim_matvec``,
  each chunk step one replay of a captured CUDA graph, a prompt past 8,192
  tokens admitted through ``flash_attention``.

Phases:

1. the card's name and power limit; the kernels build, one ``nvcc`` per
   source, all at once (set-up);
2. each kernel against its plain PyTorch version, rtol 1e-5, atol 1e-4:
   ``pim_matvec`` at the decode path's full-width shapes (int8 and int4,
   M in {1, 4, 8}, every epilogue, f32 and bf16 inputs, one odd-K int4
   weight); the build report of the two kernels slice 6 redesigned
   (``pim_matvec``, ``fold_reduce``: ptxas's registers and spills, the plan
   each of qwen2-1.5b's shapes gets); ``pim_matmul`` at
   the seven linears' shapes with M in {9, 512}
   at ragged shapes that are multiples of no tile (one with M <= 8), and at
   K = 896 and 576, whose stages no cluster of 8 splits evenly, the
   same grid of bits, epilogues and dtypes; the build report of the two
   kernels slice 7 redesigned (``pim_matmul``, ``bitplane_matmul``: HMMA
   instructions in every bf16 variant from ``cuobjdump -sass``, which must
   be more than 0, ptxas's registers and spills, the plan each of
   qwen2-1.5b's shapes gets at M = 9 and 512; one call of each, and one
   ``pim_matvec`` call, must launch exactly one kernel: traced in phase 8's
   profiler session, the run's only one);
3. the decode path: 4 requests of 128 prompt tokens, 32 new tokens, int8
   weights.  ``pim_matvec``'s launch count must be 7 x 28 x 31 and
   ``pim_matmul``'s 0 (prefill stays ``x @ dq(w)``).  A decode step is a
   graph replay, which runs no Python and so moves no counter: the same
   generation runs again in phase 8's profiler session, with every counter
   set to 0 just before it and read just after, and its launches are the
   kernels of each wrapper in that run's trace; the counters' account (the
   launches read around the step's capture times the replays, plus the
   eager launches, ``counted_launches``) must equal them, and the line
   says so.  The teacher-forced
   decode logits must agree with the overlay path (``x @ dq(w)``, dispatch
   "off") within LOGIT_TOL; greedy tokens must agree with the overlay path's
   wherever the top-2 margin exceeds the two paths' difference.  A shorter
   int4 generation is checked the same way; ``flash_attention`` must
   launch 0 times (a 128-token prefill attends directly).  The same path in
   f32 must give the logits of its plain version (every decode linear through
   ``pim_matvec_plain`` on the card) within PATH_TOL, and a planted fault
   (one layer's ``down`` loses its last DROPPED_ROWS K rows) must fail that
   check;
4. the entry point, at bits 8 and then 4: ``pim_matmul`` must launch
   exactly 7 x 28 times per pass and every output agree with
   ``pim_matmul_plain`` within KERNEL_TOL; a planted fault (one layer's
   ``down`` loses its last FAULT_K_ROWS K rows) must fail that check;
   ``pim_matvec_dense`` on 4 rows against ``pim_matvec_plain``;
5. times on the card with CUDA events over CUDA-graph replays (device
   time, free of the host's issue rate): per shape, kernel / bound (the
   larger of the bytes at the HBM rate and the multiply-adds at the bf16
   tensor cores' rate, x being bf16; the f32 CUDA-core term beside it) /
   plain / overlay yardstick (``torch.matmul`` on a pre-dequantized bf16 weight: it
   reads 2 bytes a weight where the kernels read 1 or 0.5) / library
   (``torch._weight_int8pack_mm``, int8 only), cycling through all 28
   layers' weights so no weight is timed out of L2; ``pim_matvec`` at the
   decode path's M = 4 and ``pim_matmul`` at the prefill's M = 512; and, at
   each bit width, one pass of each kernel's 196 launches in the path's
   order, with the achieved TFLOP/s and share of the bound beside it.  The
   kernels are also timed as an eager loop issues them;
6. the bit-plane entry point: ``bitplane_matmul`` against its plain version
   over the grid of phase 2's ``pim_matmul`` cases (planes at bits 8 and 4),
   and bit for bit (``torch.equal``) against ``pim_matmul`` on the same
   weights' packed codes over that grid; then at bits 8 and then 4,
   ``pim_dense_bitplane`` on all 196 weights at 512 rows, exactly 196
   launches per pass, every output within KERNEL_TOL of
   ``bitplane_matmul_plain`` on the same planes and equal bit for bit to
   the packed path ``pim_dense``; a planted fault (layer n/2's ``down``
   loses its sign plane in 32 K rows) must fail the first check; each width
   timed like phase 5
   (bound: the planes' bytes; no library call computes the function).
   ``fold_reduce`` bit-identical (``torch.equal``) to its plain version over
   q in FOLD_Q x rows in FOLD_ROWS, f32 and bf16, where a plain twin with
   one level in another association order must fail; ``fold_sum`` at
   FOLD_SHAPES with its launch count; times beside the byte bound, the
   plain version and ``torch.sum``;
7. the long prompt, where ``flash_attention`` takes bf16 to the tensor
   cores (``mma.sync``) and f32 to the CUDA cores: the built library's SASS
   must hold HMMA instructions in every bf16 kernel (``cuobjdump -sass``;
   ptxas's registers and spills beside them); (a) ``flash_attention``
   against its plain version over FLASH_BHSD (tests/test_flash_attn.py's
   shapes, through the (BH, S, D) entry point) and FLASH_LENGTHS at the
   model's heads (ragged 1,000 and 8,193, and 16,384; also with k/v as
   transposed cache views), causal and not, f32 within KERNEL_TOL and bf16
   within that plus one bf16 ulp; a planted fault per route (the last KV
   tile dropped, f32 and bf16) must fail, and a bf16 k whose key stride is
   no multiple of 8 must raise ValueError; (b) ``ServingEngine.generate``
   on 1 x 16,384 seeded tokens for 16 new ones, int8 weights: exactly 28
   ``flash_attention`` launches, all on a bf16 q, and 7 x 28 x 15
   ``pim_matvec`` launches (counted in phase 8 as phase 3's), int32 tokens, the
   host-clock time to first
   token and decode ms per step at 16,384 cached tokens; then each of the
   28 layers' own q, k, v through the kernel and the plain version, every
   layer within the bf16 bar; (c) the same prefill in f32 against the same
   prefill with attention through ``flash_attention_plain`` on the card
   within LONG_PATH_TOL, where a planted fault (layer n/2's attention loses
   its last KV tile) must fail; one layer's bf16 decode attention over the
   long path's cache, kept in bf16 with f32 outputs: its scores and its p.v
   (on the same weights) within DECODE_ATTN_TOL of the form that copied the
   cache to f32, no f32 copy in its peak memory; (d) times per layer call
   and per prefill
   (28 calls): kernel (with its achieved TFLOP/s and share of the bound),
   bound (the causal multiply-adds at the bf16 tensor cores' rate; bytes
   and the f32 CUDA-core term beside it), plain version and
   ``scaled_dot_product_attention`` as the library yardstick;
8. the captured decode step: (a) on the short path at int8 and int4, greedy
   and sampled (SAMPLED: temperature 0.8, top-k 50, a fixed key), and (b)
   on the long path, greedy, the captured ``generate`` must equal an eager
   loop of the same step function (``decode_and_emit``) from the same
   prefill, tokens and last-step logits (``torch.equal``); sampled tokens
   must differ from greedy ones; (c) one torch.profiler session
   (``repro_torch.tracing``) traces one replay of each captured step:
   exactly 7 x 28 ``pim_matvec`` kernels, no ``flash_attention`` kernel
   and no host operator inside it; and the counted generations of phases 3
   and 7, whose tokens must equal those phases' (``check_counted``); (d) after a
   generation the stacked ``down`` codes leaf is replaced by a new tensor
   with one layer's codes changed: the next generation's logits must
   differ from the previous ones and equal a fresh engine's on the new
   tree; (e) decode ms a step on the host clock in TIMING_ROUNDS rounds
   alternating eager / captured / captured sampled, short and long path,
   with the SM clock after each round, and the device-busy share of a
   captured step (``tracing.busy_share``: the device busy time of its
   traced replay over the median host-clock step of those rounds).
9. continuous batching (run after phase 7; its counted serves are windows
   of phase 8's profiler session, read after it): (a) a staggered trace of
   ten seeded requests (prompts of 17-300 tokens, no page multiple; 8-64
   new tokens; two stop at a token first emitted mid-chunk in their solo
   run) on 4 slots of 16-token pages, chunk 8, 512 positions, int8 weights,
   a shuffled pool: the captured serve ``torch.equal`` to the same serve
   with the chunk step run eagerly (``EagerEngine``: tokens, events, peak
   pages), the pool quiescent and empty after it, each request's tokens
   against its solo batch-1 ``ServingEngine.generate`` with a first
   divergence only where the dense top-2 logit gap is within PAGED_BAR, and
   the traced ``pim_matvec`` kernels of the counted serve 196 x
   ``decode_chunk_iters`` (the counters' capture x replays account equal to
   them); (b) the same trace on a pool small enough that ``_top_up``
   preempts: preemptions, and tokens ``torch.equal`` to (a)'s; (c) sampled
   (SAMPLED): the same tokens at chunk 3 as at chunk 8, request 0 against
   the dense engine's sampled row 0 within PAGED_BAR over the temperature;
   (d) phase 7's long prompt beside a short one on 2 slots: exactly 28
   ``flash_attention`` launches, all on a bf16 q, at the long admit, and
   tokens against phase 7's dense long path (margin-aware); (e) in
   SERVE_ROUNDS alternating rounds of the captured and the eager serve:
   chunk step ms an iteration (CUDA events), emitted tokens/s, host ms a
   round outside the chunk steps and of it the admits'; one traced replay
   of the paged chunk step against the dense captured step at the same 4
   rows and 512 positions (their device time differs by the gathers and
   scatters); (f) a planted fault, the decode attention's mask off by one,
   must change (a)'s eager serve and fail the comparison with the dense
   runs at PAGED_BAR (the sound runs' largest gap and the fault's gaps are
   printed beside the bar).

Then the ``kernels`` JSON line, and last the device line.  Any failure exits
non-zero; so does a host with no card, and a directory without the package.
"""
import concurrent.futures
import contextlib
import functools
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.bitplane import bitplane_matmul, bitplane_matmul_plain  # noqa: E402
from repro_torch.kernels.flash_attn import (  # noqa: E402
    KV_TILE, KV_TILE_BF16, flash_attention, flash_attention_gqa, flash_attention_plain)
from repro_torch.kernels.fold_reduce import fold_reduce, fold_reduce_plain  # noqa: E402
from repro_torch.kernels.fold_reduce import plan as fold_plan  # noqa: E402
from repro_torch.kernels.pim_matmul import pim_matmul, pim_matmul_plain  # noqa: E402
from repro_torch.kernels.pim_matmul import plan as matmul_plan  # noqa: E402
from repro_torch.kernels.pim_matvec import pim_matvec, pim_matvec_plain  # noqa: E402
from repro_torch.kernels.pim_matvec import plan as matvec_plan  # noqa: E402
from repro_torch.models import (  # noqa: E402
    attention, common, decode_step, init_cache, init_params, prefill)
from repro_torch.quant import (  # noqa: E402
    QuantizedTensor, dequantize, quantize_symmetric, to_bitplanes)
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine, DecodeState, Request, ServingEngine, decode_and_emit,
    decode_chunk_step, quantize_tree)
from repro_torch.serving.sampling import TAG_TOKEN, draw_keys, gumbel, prng_key, warp_logits  # noqa: E402

SEED = 20260
KERNELS = ("pim_matvec", "pim_matmul", "bitplane_matmul", "fold_reduce", "flash_attn")
BATCH, PROMPT, N_NEW, N_NEW_INT4 = 4, 128, 32, 8
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)  # f32 sums of the same products, reordered
# Full-width bf16 logits, kernel path vs overlay path, max over all 4 x 32 x
# 151936 of them: both paths round every linear's output to bf16, but the
# overlay's weights are bf16-rounded before the product, so activations
# differ by about an ulp at every one of 28 layers.  A narrow 28-layer bf16
# model on the CPU gave 0.03 over 1/70 as many logits; the H100 gave 0.154
# with cuBLAS's reduced-precision bf16 reductions on (now off, below).
# This check catches gross faults only: the planted fault of against_plain
# (1% of one layer's `down` product dropped) moved these logits by 0.23 on
# the H100, under it.  PATH_TOL below catches that fault.
LOGIT_TOL = 0.25
# Full-width f32 logits, kernel path vs the same path with every decode
# linear through pim_matvec_plain on the card: the two differ only in the
# order of f32 sums inside each linear.  The H100 gave 1.1e-5; the planted
# fault gave 0.17.
PATH_TOL = 1e-3
# The planted fault of the f32 path check: layer n/2's `down` loses its last
# 86 of 8,960 K rows, the rows the last K split of the two-pass kernel
# covered (88 splits of 102 rows on 132 SMs), kept at that size.
DROPPED_ROWS = 86
# One bf16 layer's decode attention over the long path's cache, the cache
# kept in bf16 against the form that copied it to f32: each contraction
# sums the same exact products in another order, within 1e-5 of its largest
# value.
DECODE_ATTN_TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
TIME_BUDGET_S = 1.0  # about this long per measurement, at most `reps` passes
PREFILL_ROWS = BATCH * PROMPT  # one prefill's rows: what pim_dense is held at
PREFILL_PASS = f"one prefill's linears at {BATCH} x {PROMPT} tokens"
MATMUL_ROWS = (9, PREFILL_ROWS)  # just past pim_matvec's M <= 8, and a prefill
RAGGED = ((130, 1000, 300), (7, 1000, 300))  # (M, K, N): multiples of no tile
# (M, K, N) whose K stages no cluster of 8 CTAs splits with a stage for each:
# qwen2-0.5b's width (28 stages) and 18 stages, whose last rank is short.
ODD_STAGES = ((9, 896, 896), (9, 576, 896))
# The planted fault of the packed entry point: layer n/2's `down` loses its
# last 32 K rows (the first port's K tile, kept at that size).
FAULT_K_ROWS = 32
FOLD_Q = (1, 2, 32, 64, 128, 1024, 32768)  # one row per warp lane up to one per block
FOLD_ROWS = (1, 7, 300, 6144)
# fold_sum's shapes on the card: one prefill's 512 query rows x 12 heads over
# head_dim 128, and one decode step's 4 x 12 query rows over a 32K-key
# denominator.
FOLD_SHAPES = ((PREFILL_ROWS * 12, 128), (BATCH * 12, 32768))
# Phase 7: one long prompt, past the model's CHUNKED_THRESHOLD (8,192 keys),
# so every layer's prefill attention is one flash_attention launch.
LONG_PROMPT, LONG_NEW = 16384, 16
# flash_attention's grid: tests/test_flash_attn.py's (BH, Sq, Sk, D), run
# through the (BH, S, D) entry point; then ragged lengths (multiples of no
# tile) and the long prompt at the model's heads (KV 2, G 6, D 128).
FLASH_BHSD = ((2, 64, 64, 32), (4, 128, 128, 16), (1, 256, 256, 64), (2, 64, 128, 32))
FLASH_LENGTHS = (1000, 8193, LONG_PROMPT)
# Full-width f32 prefill logits of the long prompt, kernel path vs the same
# path with every layer's attention through flash_attention_plain on the
# card: the two differ only in the order of f32 sums inside the attention.
# With random weights each query row's attention is a near-uniform average
# over up to 16K keys, which cancels to ~1e-2 and so carries ~1e-4 relative
# rounding into the residual stream: the H100 gave 6.0e-5 and 6.8e-5 (two
# runs) over the rows compared.  The planted fault (one layer loses 32 of
# 16,384 keys, 0.2% of its softmax weight) gave 5.4e-4 and 5.5e-4, in the 32
# rows it touches only: PATH_TOL (1e-3) cannot see it, 2e-4 sits about 3x
# from both.
LONG_PATH_TOL = 2e-4
# Phase 8: the captured decode step.  Sampled decoding at temperature 0.8 and
# top-k 50 from a fixed key; the stale-graph check's generations; rounds of
# the alternating timing.
GREEDY = {"greedy": True}
SAMPLED = {"greedy": False, "temperature": 0.8, "top_k": 50, "key": SEED}
STALE_NEW, TIMING_ROUNDS = 4, 4
LINEARS = (("attn", "wq", "bq"), ("attn", "wk", "bk"), ("attn", "wv", "bv"),
           ("attn", "wo", None), ("mlp", "gate", None), ("mlp", "up", None),
           ("mlp", "down", None))


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    # The plain versions and the overlay reference sum in f32, as the JAX
    # package's preferred_element_type=f32 does: no TF32, no bf16 reductions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(build.build, KERNELS))  # one nvcc per source, at once
    print(f"build: {time.perf_counter() - t0:.1f} s -> {', '.join(lib.name for lib in libs)}")
    for lib in libs:
        print(lib.with_name(lib.name + ".log").read_text(), file=sys.stderr)

    cfg = get_config("qwen2-1.5b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    eng8 = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW, pim_bits=8, device=dev)
    eng4 = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW, pim_bits=4, device=dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen, device=dev)
    # The entry point's phases draw from a generator of their own, so the
    # decode path's inputs do not depend on them.
    gen_mm = torch.Generator(device=dev).manual_seed(SEED + 1)

    # ---- 2. kernel vs plain ------------------------------------------------
    max_err = kernel_vs_plain(pim_matvec, pim_matvec_plain, matvec_cases(eng8, eng4), gen)
    max_err = max(max_err, odd_k_case(gen))
    print(f"pim_matvec vs plain: max |err| {max_err:.3g} within rtol "
          f"{KERNEL_TOL['rtol']} atol {KERNEL_TOL['atol']}")
    # The checks this slice added draw from a generator of their own, so the
    # other phases' inputs do not depend on them.
    gen_new = torch.Generator(device=dev).manual_seed(SEED + 4)
    print(json.dumps(redesign_build_report(eng8, eng4)))
    mm_cases = matmul_cases(params, gen_mm)
    mm_err = kernel_vs_plain(pim_matmul, pim_matmul_plain, mm_cases, gen_mm)
    print(f"pim_matmul vs plain: max |err| {mm_err:.3g} within rtol "
          f"{KERNEL_TOL['rtol']} atol {KERNEL_TOL['atol']} over "
          f"{32 * len(mm_cases)} cases")
    # The checks of the slice that redesigned pim_matmul and bitplane_matmul
    # draw from a generator of their own.
    gen_mm2 = torch.Generator(device=dev).manual_seed(SEED + 5)
    qv = engine_weights(eng8, 8)[0][1][0]
    xv = torch.randn((BATCH, qv.shape[0]), generator=gen_new, device=dev).to(torch.bfloat16)
    mm_build, one_calls = matmul_build_report(
        gen_mm2, lambda: pim_matvec(xv, qv.codes, qv.scale, bits=8))
    print(json.dumps(mm_build))

    # ---- 3. the decode path --------------------------------------------------
    # Each decode step is one replay of a captured step, which runs no Python:
    # its launches are counted in phase 8, where the same generation runs
    # in the profiler's session (``counted_generation``).
    graphs8, graphs4 = count_captures(eng8), count_captures(eng4)
    eng8.generate(prompt, 2)  # warm-up: library load, allocator, the step's capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng8.generate(prompt, N_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng8.generate(prompt, 1)  # prefill and tok0 only
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    decode_s = (t_gen - t_prefill) / (N_NEW - 1)
    check(tuple(toks.shape) == (BATCH, N_NEW), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token ids out of range")

    diff8, t_gen_off, lo8 = against_overlay(eng8, prompt, toks, N_NEW, "int8")
    decode_off_s = (t_gen_off - t_prefill) / (N_NEW - 1)
    print(json.dumps({"path": "qwen2-1.5b int8 generate", "batch": BATCH,
                      "prompt": PROMPT, "n_new": N_NEW,
                      "launches": "counted in phase 8 (counted_generation)",
                      "generate_s": t_gen, "prefill_s": t_prefill,
                      "decode_ms_per_step": decode_s * 1e3,
                      "decode_tokens_per_s": BATCH / decode_s,
                      "overlay_decode_ms_per_step": decode_off_s * 1e3,
                      "max_abs_logit_diff_vs_overlay": diff8}))

    eng4.generate(prompt, 2)  # warm-up: the int4 step's capture
    toks4 = eng4.generate(prompt, N_NEW_INT4)
    diff4, _, _ = against_overlay(eng4, prompt, toks4, N_NEW_INT4, "int4")
    print(json.dumps({"path": "qwen2-1.5b int4 generate", "n_new": N_NEW_INT4,
                      "launches": "counted in phase 8 (counted_generation)",
                      "max_abs_logit_diff_vs_overlay": diff4}))
    against_plain(eng8, gen, prompt, toks, lo8)

    # ---- 4. the entry point ----------------------------------------------------
    mm_weights, entry = entry_point(params, gen_mm)
    print(json.dumps(entry))
    mm_err = max(mm_err, entry["max_abs_err"])

    # ---- 5. times ------------------------------------------------------------
    mv_weights = {bits: engine_weights(eng, bits) for eng, bits in ((eng8, 8), (eng4, 4))}
    shapes, steps = timings(pim_matvec, pim_matvec_plain, BATCH, mv_weights, gen,
                            "one decode step", library=library_calls)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for row in shapes:
        pl = matvec_plan(row["K"] * row["bits"] // 8, row["N"], BATCH, row["bits"], sms)
        row["plan"] = {"tile_n": pl.tile_n, "cluster": pl.cluster, "ctas": pl.ctas}
        print(json.dumps(row))
    print(json.dumps({"decode_step_launches": steps}))
    step = steps[8]
    mm_shapes, mm_passes = timings(pim_matmul, pim_matmul_plain, PREFILL_ROWS, mm_weights, gen_mm,
                                   PREFILL_PASS, library=library_calls)
    for row in mm_shapes:
        print(json.dumps(row))
    print(json.dumps({"prefill_pass_launches": mm_passes}))
    mm_pass = mm_passes[8]
    del mm_weights

    # ---- 6. the bit-plane entry point ------------------------------------------
    # A generator of its own, so the earlier phases' inputs do not depend on it.
    gen_bp = torch.Generator(device=dev).manual_seed(SEED + 2)
    bp_err = kernel_vs_plain(bitplane_matmul, bitplane_matmul_plain,
                             bitplane_cases(params, gen_bp), gen_bp)
    print(f"bitplane_matmul vs plain: max |err| {bp_err:.3g} within rtol "
          f"{KERNEL_TOL['rtol']} atol {KERNEL_TOL['atol']}")
    n_equal = bitplane_equals_packed(params, gen_mm2)
    print(f"bitplane_matmul bit-identical to pim_matmul over {n_equal} cases of the kernel grid")
    bp_entry, bp_passes = bitplane_entry_point(params, gen_bp)
    print(json.dumps(bp_entry))
    bp_err = max(bp_err, bp_entry["max_abs_err"])
    fold = fold_phase(gen_bp)

    # ---- 7. the long prompt through flash_attention ------------------------------
    gen_fa = torch.Generator(device=dev).manual_seed(SEED + 3)
    fa_build = flash_build_report()
    print(json.dumps(fa_build))
    fa_check = flash_vs_plain(cfg, gen_fa)
    print(json.dumps(fa_check))
    decode_attention_check(cfg, gen_new)
    long_path, long_prompt, long_eng, graphs_long, long_toks = long_prompt_path(cfg, params,
                                                                               gen_fa)
    print(json.dumps(long_path))

    # ---- 9. continuous batching on the paged cache ---------------------------------
    # Its counted serves are windows of phase 8's profiler session, the run's
    # only one: ``ServingPhase.finish`` reads them after it.
    gen_serve = torch.Generator(device=dev).manual_seed(SEED + 6)
    serving = ServingPhase(cfg, eng8, long_eng, long_prompt, long_toks, gen_serve)
    serve_windows = serving.run()

    # ---- 8. the captured decode step ---------------------------------------------
    counted, traced = captured_phase(
        cfg, eng8, eng4, long_eng, prompt, long_prompt, one_calls,
        {"int8": (graphs8, toks, N_NEW), "int4": (graphs4, toks4, N_NEW_INT4),
         "long": (graphs_long, long_toks, LONG_NEW)}, serve_windows)
    served = serving.finish(traced)
    del params, eng8, eng4, long_eng, graphs8, graphs4, graphs_long, one_calls, long_toks
    del serving, serve_windows, traced
    gc.collect()  # the counted captures hold each engine in a cycle
    torch.cuda.empty_cache()
    long_against_plain(cfg, gen_fa, long_prompt)
    fa_times = flash_timings(cfg, gen_fa)
    print(json.dumps(fa_times))
    print(json.dumps({"kernels": [{
        "name": "pim_matvec", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pim_matvec.cu",
        "replaces": "src/repro/kernels/pim_matvec.py:40",
        "launches": counted["int8"]["traced"]["pim_matvec"] + sum(
            t["pim_matvec"] for t in served.values()),
        "launches_by_path": {"int8 generate": counted["int8"]["traced"]["pim_matvec"],
                             **{k: t["pim_matvec"] for k, t in served.items()}},
        "launches_counted_as": counted["int8"]["counted_as"], "max_abs_err": max_err,
        "ms": step["kernel_ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
        "library_ms": step["library_ms"], "overlay_ms": step["overlay_ms"],
        "eager_ms": step["kernel_eager_ms"], "per": step["per"],
    }, {
        "name": "pim_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pim_matmul.cu",
        "replaces": "src/repro/kernels/pim_matmul.py:42",
        "launches": sum(entry["pim_matmul_launches"].values()),
        "launches_per_pass": entry["pim_matmul_launches"], "max_abs_err": mm_err,
        "ms": mm_pass["kernel_ms"], "plain_ms": mm_pass["plain_ms"],
        "bound_ms": mm_pass["bound_ms"], "bound_by": mm_pass["bound_by"],
        "library_ms": mm_pass["library_ms"], "overlay_ms": mm_pass["overlay_ms"],
        "eager_ms": mm_pass["kernel_eager_ms"], "per": mm_pass["per"],
    }, {
        "name": "bitplane_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitplane_matmul.cu",
        "replaces": "src/repro/kernels/bitplane.py:35",
        "launches": sum(bp_entry["bitplane_matmul_launches"].values()),
        "launches_per_pass": bp_entry["bitplane_matmul_launches"], "max_abs_err": bp_err,
        "ms": bp_passes[8]["kernel_ms"], "plain_ms": bp_passes[8]["plain_ms"],
        "bound_ms": bp_passes[8]["bound_ms"], "bound_by": bp_passes[8]["bound_by"],
        "library_ms": None, "library_note": "no single PyTorch call computes it",
        "overlay_ms": bp_passes[8]["overlay_ms"], "bits4": _measured(bp_passes[4]),
        "per": bp_passes[8]["per"],
    }, {
        "name": "fold_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fold_reduce.cu",
        "replaces": "src/repro/kernels/fold_reduce.py:21",
        "launches": fold["launches"], "max_abs_err": fold["max_abs_err"],
        "ms": fold["kernel_ms"], "plain_ms": fold["plain_ms"],
        "bound_ms": fold["bound_ms"], "bound_by": "bytes",
        "library_ms": fold["library_ms"], "library_note": "torch.sum(x, -1), another order",
        "per": fold["per"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn.py:26",
        "launches": counted["long"]["traced"]["flash_attention"]
        + served["long serve"]["flash_attention"],
        "launches_by_path": {"long generate": counted["long"]["traced"]["flash_attention"],
                             "long serve": served["long serve"]["flash_attention"]},
        "launches_counted_as": counted["long"]["counted_as"],
        "max_abs_err": fa_check["max_abs_err"],
        "bf16_tol_share": fa_check["bf16_tol_share"],
        "ms": fa_times["kernel_ms"], "plain_ms": fa_times["plain_ms"],
        "bound_ms": fa_times["bound_ms"], "bound_by": fa_times["bound_by"],
        "library_ms": fa_times["library_ms"], "library_note": fa_times["library_note"],
        "per_layer": _measured(fa_times["per_layer"]), "per": fa_times["per"],
    }]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# Numbers a timing dict computes from its measured times or the data sheet.
COMPUTED_KEYS = {"f32_cuda_core_ms", "kernel_tflop_per_s", "kernel_bound_share"}


def _measured(times):
    """A timing dict without its computed terms (``COMPUTED_KEYS``): they stay
    on the timing lines and out of the kernels line, whose one computed
    number is ``bound_ms``."""
    return {key: v for key, v in times.items() if key not in COMPUTED_KEYS}


def _ptxas(name, label):
    """Registers and spills of each kernel in ``csrc/<name>.cu``'s build log
    (``-Xptxas -v``), keyed by ``label(mangled name)`` (None skips it)."""
    lib = build.library_path(name)
    out = {}
    for entry in lib.with_name(lib.name + ".log").read_text().split("Compiling entry function")[1:]:
        key = label(entry.split("'")[1])
        regs = re.search(r"Used (\d+) registers", entry)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        if key and regs:
            out[key] = {"registers": int(regs[1]),
                        "spill_store_bytes": int(spills[1]) if spills else None,
                        "spill_load_bytes": int(spills[2]) if spills else None}
    return out


def _matvec_label(mangled):
    found = re.search(r"pim_matvec_kernelILi(\d+)ELi(\d+)ELi(\d+)E", mangled)
    return found and f"bits {found[1]}, x {'bf16' if found[2] == '1' else 'f32'}, tile {found[3]}"


def _fold_label(mangled):
    found = re.search(r"fold_reduce_kernelI(f|13__nv_bfloat16)E", mangled)
    return found and ("f32" if found[1] == "f" else "bf16")


def redesign_build_report(eng8, eng4):
    """The two kernels slice 6 redesigned: ptxas's registers and spills for
    each built variant; the plan (tile, cluster, CTAs) ``pim_matvec``'s
    planner gives each of qwen2-1.5b's decode linears at bits 8 and 4 (M =
    BATCH, bf16 x) and ``fold_reduce``'s at FOLD_SHAPES.  (The kernels one
    ``pim_matvec`` call launches are traced with ``matmul_build_report``'s
    calls, in phase 8.)"""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {}
    for eng, bits in ((eng8, 8), (eng4, 4)):
        for name, qs, _ in engine_weights(eng, bits):
            k, n = qs[0].shape
            pl = matvec_plan(qs[0].codes.shape[0], n, BATCH, bits, sms)
            plans[f"{name} ({k} x {n}) bits {bits}"] = {
                "tile_n": pl.tile_n, "cluster": pl.cluster, "ctas": pl.ctas,
                "m_rows": pl.m_rows, "rows_per_cta": pl.rows_per_cta}
    folds = {f"({rows}, {q}) {label}": fold_plan(rows, q, size, sms)._asdict()
             for rows, q in FOLD_SHAPES for label, size in (("f32", 4), ("bf16", 2))}
    return {"check": "pim_matvec and fold_reduce build",
            "pim_matvec_ptxas": _ptxas("pim_matvec", _matvec_label),
            "fold_reduce_ptxas": _ptxas("fold_reduce", _fold_label),
            "pim_matvec_plans": plans, "fold_reduce_plans": folds}


def _sass_hmma(name, label):
    """HMMA (tensor-core MMA) instructions in each kernel of the built
    ``csrc/<name>.cu`` (``cuobjdump -sass``), keyed by ``label(mangled
    name)`` (None skips it)."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    hmma = {}
    for section in sass.split("Function : ")[1:]:
        key = label(section.split(None, 1)[0])
        if key:
            hmma[key] = section.count("HMMA")
    return hmma


def _gemm_label(mangled):
    """'bits 8, 128 x 64' for pim_matmul's bf16 kernels, '128 x 64' for
    bitplane_matmul's (tile columns x x rows), 'f32 ...' for the f32 bodies."""
    found = re.search(r"(pim_matmul|bitplane_matmul)_mma_kernelI(?:Li(\d+)E)?"
                      r"Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if found:
        wn, wm, fn, fm = (int(v) for v in found.groups()[2:])
        tile = f"{16 * fn * wn} x {8 * fm * wm}"
        return f"bits {found[2]}, {tile}" if found[2] else tile
    found = re.search(r"(?:pim_matmul|bitplane_matmul)_f32_kernelI(?:Li(\d+)E)?", mangled)
    return found and ("f32" + (f" bits {found[1]}" if found[1] else ""))


def matmul_build_report(gen, matvec_call):
    """The two kernels slice 7 redesigned, ``pim_matmul`` and
    ``bitplane_matmul``: the HMMA instructions in every bf16 variant (more
    than 0 each) and ptxas's registers and spills; the plan (CTA tile,
    cluster, CTAs) each of qwen2-1.5b's prefill shapes gets at M = 9 and M =
    PREFILL_ROWS, and each ODD_STAGES shape (the same for both kernels at
    any bits).  Returns (the report, {name: one call} of each and of
    ``pim_matvec`` (``matvec_call``), warmed up): phase 8's profiler
    session traces them (``one_call_check``)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hmma = {name: _sass_hmma(name, _gemm_label) for name in ("pim_matmul", "bitplane_matmul")}
    for name, counts in hmma.items():
        bf16 = {key: v for key, v in counts.items() if not key.startswith("f32")}
        check(len(bf16) == 5 * (2 if name == "pim_matmul" else 1) and min(bf16.values()) > 0,
              f"{name}: a bf16 kernel without HMMA instructions: {counts}")
    shapes = {"wq/wo": (1536, 1536), "wk/wv": (1536, 256), "gate/up": (1536, 8960),
              "down": (8960, 1536)}
    cases = [(f"{label} ({k} x {n}) M={m}", m, k, n) for label, (k, n) in shapes.items()
             for m in MATMUL_ROWS]
    cases += [(f"({k} x {n}) M={m}", m, k, n) for m, k, n in ODD_STAGES]
    plans = {}
    for label, m, k, n in cases:
        pl = matmul_plan(m, k, n, 8, torch.bfloat16, sms)
        plans[label] = {"tile": [pl.tile_n, pl.tile_m], "cluster": pl.cluster,
                        "ctas": pl.ctas, "k_per_cta": pl.k_per_cta}
    dev = gen.device
    q = ops.quantize_for_pim(0.02 * torch.randn((8960, 1536), generator=gen, device=dev), 8)
    planes = to_bitplanes(quantize_symmetric(0.02 * torch.randn((8960, 1536), generator=gen,
                                                                device=dev), 8).codes, 8)
    x = torch.randn((PREFILL_ROWS, 8960), generator=gen, device=dev).to(torch.bfloat16)
    calls = {"pim_matvec": matvec_call,
             "pim_matmul": lambda: pim_matmul(x, q.codes, q.scale, bits=8),
             "bitplane_matmul": lambda: bitplane_matmul(x, planes, q.scale)}
    for call in calls.values():
        call()  # warm-up
    torch.cuda.synchronize()
    return {"check": "pim_matmul and bitplane_matmul build", "hmma_instructions": hmma,
            "pim_matmul_ptxas": _ptxas("pim_matmul", _gemm_label),
            "bitplane_matmul_ptxas": _ptxas("bitplane_matmul", _gemm_label),
            "plans": plans}, calls


def one_call_check(traced, calls):
    """Each of ``calls`` (traced as a segment "<name> call") launched exactly
    one kernel, its own (a kernel belongs to the call whose name it holds)."""
    per_call = {name: traced[f"{name} call"].kernels for name in calls}
    for name, kernels in per_call.items():
        check(len(kernels) == 1 and f"{name}_" in kernels[0],
              f"one {name} call launched {kernels}, expected one {name} kernel")
    print(json.dumps({"check": "one call of each kernel, traced", "kernels_per_call": per_call}))


def bitplane_equals_packed(params, gen):
    """The bit-plane path against the packed path, bit for bit
    (``torch.equal``), over phase 2's kernel grid: each weight quantized at
    bits 8 and 4, ``bitplane_matmul`` on its planes and ``pim_matmul`` on its
    packed codes, the same x (f32 and bf16), every activation, with and
    without bias and residual.  Returns the number of cases."""
    dev = gen.device
    cases = 0
    for bits in (8, 4):
        for label, ms, w in matmul_weights(params, gen, bits):
            q = quantize_symmetric(w, bits)
            planes, packed = to_bitplanes(q.codes, bits), ops.quantize_for_pim(w, bits)
            k, n = w.shape
            for m in ms:
                x32 = torch.randn((m, k), generator=gen, device=dev)
                b32 = torch.randn((n,), generator=gen, device=dev)
                r32 = torch.randn((m, n), generator=gen, device=dev)
                for dtype in (torch.float32, torch.bfloat16):
                    x, b, r = x32.to(dtype), b32.to(dtype), r32.to(dtype)
                    for act in ("none", "relu", "silu", "gelu"):
                        for bias, res in ((None, None), (b, None), (None, r), (b, r)):
                            kw = dict(bias=bias, activation=act, residual=res)
                            got = bitplane_matmul(x, planes, q.scale, **kw)
                            want = pim_matmul(x, packed.codes, packed.scale, bits=bits, **kw)
                            torch.cuda.synchronize()
                            check(torch.equal(got, want),
                                  f"bitplane_matmul {label} bits={bits} M={m} {dtype} {act} "
                                  f"bias={bias is not None} residual={res is not None}: not "
                                  f"bit-identical to pim_matmul (max diff "
                                  f"{(got - want).abs().max().item():.3g})")
                            cases += 1
    return cases


def decode_attention_check(cfg, gen):
    """One bf16 layer's decode attention over the long path's cache
    (LONG_PROMPT + LONG_NEW slots, the query at position LONG_PROMPT), the
    cache kept in bf16 with f32 outputs (``attention.decode_attention``),
    against the form that copied the cache to f32.  Each contraction sums
    the same exact bf16 products in another order: the scores q.k, and p.v
    on the same bf16 weights, must agree within DECODE_ATTN_TOL of their
    largest value.  End to end the two forms differ by more, since both
    round the softmax weights to bf16 (as the JAX package does) and a
    last-bit difference in a score can move a weight's rounding by one bf16
    ulp: that difference and the count of such weights are reported.  The
    call's peak memory above its inputs (after a warm-up call, which leaves
    cuBLAS's workspace allocated) must stay under half of one f32 copy of K:
    no such copy is formed.  Device time of both forms per layer call (CUDA
    graph replays).  Prints its report."""
    dev = gen.device
    kv, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    slots, pos = LONG_PROMPT + LONG_NEW, LONG_PROMPT
    q = torch.randn((1, kv, g, d), generator=gen, device=dev).to(torch.bfloat16)
    ck, cv = (torch.randn((1, kv, slots, d), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    valid = torch.arange(slots, device=dev) <= pos

    def f32_copy_form(weights=None):
        s = torch.einsum("bhgd,bhkd->bhgk", q.to(torch.float32), ck.to(torch.float32)) / math.sqrt(d)
        w = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1).to(cv.dtype)
        w = w if weights is None else weights
        return s, w, torch.einsum("bhgk,bhkd->bhgd", w.to(torch.float32), cv.to(torch.float32))

    s_old, w_old, want = f32_copy_form()
    pos_t = torch.tensor(pos, device=dev)  # a decode step's position is a device tensor
    attention.decode_attention(q, ck, cv, pos_t)  # warm-up: cuBLAS's workspace
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = attention.decode_attention(q, ck, cv, pos_t)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    # The bf16-cache form's two contractions, step by step.
    s_new = attention.bmm_f32(q.reshape(kv, g, d), ck.reshape(kv, slots, d).transpose(1, 2))
    s_new = (s_new / math.sqrt(d)).reshape(s_old.shape)
    w_new = torch.softmax(s_new.masked_fill(~valid, float("-inf")), dim=-1).to(cv.dtype)
    pv_new = attention.pv_f32(w_new.reshape(kv, g, slots), cv.reshape(kv, slots, d))
    _, _, pv_old = f32_copy_form(w_new)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    scores_rel = rel(s_new[..., valid], s_old[..., valid])
    pv_rel = rel(pv_new.reshape(pv_old.shape), pv_old)
    end_rel = rel(got, want)
    f32_copy = ck.numel() * 4
    report = {"check": "bf16 decode attention, cache kept in bf16 vs copied to f32",
              "cache_slots": slots, "position": pos, "tol": DECODE_ATTN_TOL,
              "scores_max_abs_diff_over_max_abs": scores_rel,
              "pv_same_weights_max_abs_diff_over_max_abs": pv_rel,
              "end_to_end_max_abs_diff_over_max_abs": end_rel,
              "step_by_step_bit_identical": torch.equal(got, pv_new.reshape(got.shape)),
              "weights_rounded_differently": int((w_new != w_old).sum()),
              "weights": int(valid.sum()) * kv * g,
              "peak_bytes_above_inputs": extra, "f32_copy_of_k_bytes": f32_copy,
              "bf16_cache_ms": _time_ms([lambda: attention.decode_attention(q, ck, cv, pos_t)], 50),
              "f32_copy_ms": _time_ms([lambda: f32_copy_form()[2]], 50),
              "per": "one layer's decode attention at (B 1, KV 2, G 6, D 128); device time "
                     "(CUDA graph replay)"}
    print(json.dumps(report))
    check(got.dtype == torch.float32 and got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"decode_attention gave {got.dtype} {tuple(got.shape)}")
    check(scores_rel <= DECODE_ATTN_TOL and pv_rel <= DECODE_ATTN_TOL,
          f"decode attention in bf16 vs the f32-copy form: scores {scores_rel:.3g}, p.v on the "
          f"same weights {pv_rel:.3g} of the largest value > {DECODE_ATTN_TOL}")
    check(extra < f32_copy // 2, f"decode attention allocated {extra} bytes above its inputs, "
          f"against {f32_copy} for an f32 copy of K")
    return report


def within_tol(got, ref):
    """(every output finite and within KERNEL_TOL of ``ref``, max |err|)."""
    err = (got - ref).abs()
    ok = bool((err <= KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * ref.abs()).all())
    return bool(torch.isfinite(got).all()) and ok, err.max().item()


def _packed_case(label, m, q):
    """A case of ``kernel_vs_plain`` for the packed kernels: (label, M, K, N,
    operands after x, fixed keywords)."""
    return (label, m, *q.shape, (q.codes, q.scale), {"bits": q.bits})


def matvec_cases(eng8, eng4):
    """``pim_matvec``'s cases: every linear of the decode path, layer 0,
    bits 8 and 4, M in {1, 4, 8}."""
    return [_packed_case(name, m, qs[0]) for eng, bits in ((eng8, 8), (eng4, 4))
            for name, qs, _ in engine_weights(eng, bits) for m in (1, 4, 8)]


def matmul_weights(params, gen, bits):
    """(label, float weight) of the kernels' grids at ``bits``: the seven
    linears' layer-0 weights, then random weights at the RAGGED and
    ODD_STAGES shapes (M in MATMUL_ROWS for the first, the shape's own M for
    the rest)."""
    out = [(name, MATMUL_ROWS, params["layers"][group][name][0]) for group, name, _ in LINEARS]
    for m, k, n in RAGGED + ODD_STAGES:
        out.append((f"K={k} N={n}", (m,),
                    0.02 * torch.randn((k, n), generator=gen, device=gen.device)))
    return out


def matmul_cases(params, gen):
    """``pim_matmul``'s cases: the seven linears' layer-0 weights through
    ``ops.quantize_for_pim`` with M in MATMUL_ROWS, and random weights at
    the RAGGED and ODD_STAGES shapes; bits 8 and 4."""
    return [_packed_case(label, m, ops.quantize_for_pim(w, bits)) for bits in (8, 4)
            for label, ms, w in matmul_weights(params, gen, bits) for m in ms]


def bitplane_cases(params, gen):
    """``bitplane_matmul``'s cases: the grid of ``matmul_cases``, each weight
    quantized at ``bits`` and decomposed into its bit-planes."""
    cases = []
    for bits in (8, 4):
        for label, ms, w in matmul_weights(params, gen, bits):
            q = quantize_symmetric(w, bits)
            planes = to_bitplanes(q.codes, bits)
            cases += [(f"{label} bits={bits}", m, *q.shape, (planes, q.scale), {}) for m in ms]
    return cases


def kernel_vs_plain(kernel, plain, cases, gen) -> float:
    """``kernel`` against ``plain`` on every (label, M, K, N, operands,
    keywords) of ``cases``: f32 and bf16 inputs, every activation, with and
    without bias and residual.  Returns the max |err|."""
    max_err = 0.0
    dev = gen.device
    for label, m, k, n, operands, fixed in cases:
        x32 = torch.randn((m, k), generator=gen, device=dev)
        b32 = torch.randn((n,), generator=gen, device=dev)
        r32 = torch.randn((m, n), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x, b, r = x32.to(dtype), b32.to(dtype), r32.to(dtype)
            for act in ("none", "relu", "silu", "gelu"):
                for bias, res in ((None, None), (b, None), (None, r), (b, r)):
                    kw = dict(fixed, bias=bias, activation=act, residual=res)
                    got = kernel(x, *operands, **kw)
                    ref = plain(x, *operands, **kw)
                    torch.cuda.synchronize()
                    ok, err = within_tol(got, ref)
                    check(ok, f"{kernel.__name__} {label} {fixed} M={m} "
                          f"{dtype} {act} bias={bias is not None} "
                          f"residual={res is not None}: max err {err:.3g}")
                    max_err = max(max_err, err)
    return max_err


def odd_k_case(gen) -> float:
    """An odd-K int4 weight (``nibbles_odd``) through ``linear``: the zero pad
    column, against the plain version and the overlay path."""
    dev = gen.device
    w = 0.02 * torch.randn((1535, 1536), generator=gen, device=dev)
    q = quantize_tree({"w": w}, bits=4)["w"]
    check("nibbles_odd" in q, "odd K did not pack as nibbles_odd")
    x = torch.randn((1, 4, 1535), generator=gen, device=dev)
    b = torch.randn((1536,), generator=gen, device=dev)
    got = common.linear(x, q, b)
    ref = pim_matvec_plain(torch.nn.functional.pad(x.reshape(4, 1535), (0, 1)),
                           q["codes"], q["scale"], bits=4, bias=b).reshape(1, 4, 1536)
    prev = common.set_matvec_dispatch("off")
    try:
        overlay = common.linear(x, q, b)
    finally:
        common.set_matvec_dispatch(prev)
    torch.cuda.synchronize()
    ok, err = within_tol(got, ref)
    check(ok, f"odd-K int4 linear vs plain: max err {err:.3g}")
    check(bool(torch.allclose(got, overlay, rtol=1e-4, atol=1e-4)),
          f"odd-K int4 linear vs overlay: max err {(got - overlay).abs().max().item():.3g}")
    return err


def forced_logits(eng, prompt, toks, n_new):
    """(B, n_new, V) f32: the logits that chose each emitted token, with the
    emitted tokens fed back (teacher-forced), under the current dispatch."""
    cfg = eng.cfg
    with torch.inference_mode():
        cache = init_cache(cfg, toks.shape[0], eng.max_seq, eng.device)
        logits, cache = prefill(eng.params, cfg, prompt, cache)
        out = [logits[:, -1].float()]
        for i in range(n_new - 1):
            logits, cache = decode_step(eng.params, cfg, toks[:, i:i + 1], cache,
                                        prompt.shape[1] + i)
            out.append(logits[:, -1].float())
    return torch.stack(out, dim=1)


def against_overlay(eng, prompt, toks, n_new, label):
    """Hold the kernel path's generation against the overlay path's.

    Returns (max |logit difference|, seconds of the overlay generation, the
    overlay path's teacher-forced logits)."""
    lk = forced_logits(eng, prompt, toks, n_new)
    prev = common.set_matvec_dispatch("off")
    try:
        lo = forced_logits(eng, prompt, toks, n_new)
        eng.generate(prompt, 2)  # warm-up: the overlay step's own capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks_off = eng.generate(prompt, n_new)
        torch.cuda.synchronize()
        t_off = time.perf_counter() - t0
    finally:
        common.set_matvec_dispatch(prev)
    check(bool(torch.isfinite(lk).all()), f"{label}: non-finite logits")
    dpos = (lk - lo).abs().amax(dim=-1)  # (B, n_new)
    diff = dpos.max().item()
    check(diff <= LOGIT_TOL, f"{label}: decode logits differ from the overlay "
          f"path by {diff:.4g} > {LOGIT_TOL}")
    # Where the two generations first part, both saw the same prefix, so the
    # two argmaxes can differ only if the kernel path's top-2 margin there is
    # within twice the two paths' largest logit difference at that position.
    top2 = lk.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = 0
    for row in range(toks.shape[0]):
        mism = (toks[row] != toks_off[row]).nonzero()
        if mism.numel() == 0:
            agree += n_new
            continue
        j = int(mism[0, 0])
        agree += j
        check(margin[row, j].item() <= 2 * dpos[row, j].item(),
              f"{label}: row {row} differs from the overlay path at token {j} "
              f"with top-2 margin {margin[row, j].item():.4g} > twice the "
              f"logit difference {dpos[row, j].item():.4g}")
    print(json.dumps({"check": f"{label} vs overlay", "max_abs_logit_diff": diff,
                      "mean_abs_logit_diff": (lk - lo).abs().mean().item(),
                      "logit_std": lk.std().item(),
                      "tokens_agreeing_before_first_flip": agree,
                      "tokens": toks.numel()}))
    return diff, t_off, lo


@contextlib.contextmanager
def decode_linears_through(fn):
    """Route the decode linears through ``fn`` in place of the wrapper."""
    prev, common.pim_matvec = common.pim_matvec, fn
    try:
        yield
    finally:
        common.pim_matvec = prev


def dropped_split(n_layers, layer, index):
    """The wrapper with one planted fault: in linear ``index`` (of LINEARS)
    of ``layer``, the last DROPPED_ROWS K rows add nothing (the activations
    they multiply are zeroed).  Counts decode calls, so it holds for a
    prefill (which makes none) and then decode steps."""
    calls = 0

    def faulty(x, w_codes, scale, *, bits=8, **kw):
        nonlocal calls
        if calls % (n_layers * len(LINEARS)) == layer * len(LINEARS) + index:
            x = x.clone()
            x[:, -DROPPED_ROWS:] = 0
        calls += 1
        return pim_matvec(x, w_codes, scale, bits=bits, **kw)
    return faulty


def against_plain(eng8, gen, prompt, toks, lo8):
    """The int8 path at full width in f32, kernel vs plain version: the
    teacher-forced logits through the kernel against the same path with
    every decode linear through ``pim_matvec_plain`` on the card, within
    PATH_TOL.  Then a planted fault (layer n/2's ``down`` loses its last K
    split) must fail that check; its size under the bf16 overlay check is
    printed beside LOGIT_TOL."""
    cfg = eng8.cfg.replace(param_dtype="float32")
    eng = ServingEngine(cfg, init_params(cfg, gen, device=gen.device),
                        max_seq=eng8.max_seq, pim_bits=8, device=gen.device)
    lk = forced_logits(eng, prompt, toks, N_NEW)
    with decode_linears_through(pim_matvec_plain):
        lp = forced_logits(eng, prompt, toks, N_NEW)
    down = [name for _, name, _ in LINEARS].index("down")
    with decode_linears_through(dropped_split(cfg.n_layers, cfg.n_layers // 2, down)):
        lf = forced_logits(eng, prompt, toks, N_NEW)
    with decode_linears_through(dropped_split(cfg.n_layers, cfg.n_layers // 2, down)):
        lf8 = forced_logits(eng8, prompt, toks, N_NEW)
    diff = (lk - lp).abs().max().item()
    fault = (lf - lp).abs().max().item()
    fault8 = (lf8 - lo8).abs().max().item()
    print(json.dumps({"check": "int8 f32 kernel path vs plain path",
                      "max_abs_logit_diff": diff, "tol": PATH_TOL,
                      "logit_std": lp.std().item(),
                      "planted_fault": f"layer {cfg.n_layers // 2} down: last {DROPPED_ROWS} K rows dropped",
                      "planted_fault_f32_diff_vs_plain": fault,
                      "planted_fault_bf16_diff_vs_overlay": fault8,
                      "logit_tol": LOGIT_TOL}))
    check(bool(torch.isfinite(lk).all()), "f32 path: non-finite logits")
    check(diff <= PATH_TOL, f"f32 path: kernel logits differ from the plain "
          f"version's by {diff:.4g} > {PATH_TOL}")
    check(fault > PATH_TOL, f"the planted fault moved the f32 logits by only "
          f"{fault:.4g} <= {PATH_TOL}: the check cannot see it")


def _linear_params(params, i):
    """Layer ``i``'s seven float weights and their biases (None where the
    linear has none), in path order."""
    layer = params["layers"]
    return [(name, layer[group][name][i], None if bname is None else layer[group][bname][i])
            for group, name, bname in LINEARS]


def entry_point(params, gen):
    """The packed entry point at full width, bits 8 and then 4: every
    layer's seven float weights through ``ops.quantize_for_pim``, then
    ``ops.pim_dense`` on a seeded (512, K) bf16 activation, each output held
    against ``pim_matmul_plain`` within KERNEL_TOL, and ``ops.pim_matvec_dense``
    on its first 4 rows against ``pim_matvec_plain``.  ``wq``/``wk``/``wv``
    get a seeded bias of their widths (the model's own are zeros, which
    would check nothing).  Each pass must launch ``pim_matmul`` and
    ``pim_matvec`` 196 times.  Then a planted fault — layer n/2's ``down``
    loses its last FAULT_K_ROWS K rows (the activations they multiply are
    zeroed) — must fail the same check.

    Returns ({bits: [(name, [QuantizedTensor per layer], [bias per
    layer])]} for the timings, a report)."""
    dev = gen.device
    n_layers = params["layers"]["attn"]["wq"].shape[0]
    widths = {w.shape[0] for _, w, _ in _linear_params(params, 0)}
    xs = {k: torch.randn((PREFILL_ROWS, k), generator=gen, device=dev).to(torch.bfloat16)
          for k in sorted(widths)}
    biases = {name: torch.randn(w.shape[1:], generator=gen, device=dev).to(torch.bfloat16)
              for name, w, b in _linear_params(params, 0) if b is not None}
    weights, report = {}, {"check": "entry point at full width vs plain",
                           "rows": PREFILL_ROWS, "pim_matmul_launches": {},
                           "pim_matvec_launches": {}}
    max_err = vec_err = 0.0
    for bits in (8, 4):
        qs = [[(name, ops.quantize_for_pim(w, bits), biases.get(name))
               for name, w, _ in _linear_params(params, i)] for i in range(n_layers)]
        torch.cuda.synchronize()
        pim_matmul.launches = pim_matvec.launches = 0
        for i, layer in enumerate(qs):
            for name, q, b in layer:
                x = xs[q.shape[0]]
                got = ops.pim_dense(x, q, bias=b)
                got_vec = ops.pim_matvec_dense(x[:4], q, bias=b)
                ref = pim_matmul_plain(x, q.codes, q.scale, bits=bits, bias=b)
                ref_vec = pim_matvec_plain(x[:4], q.codes, q.scale, bits=bits, bias=b)
                torch.cuda.synchronize()
                ok, err = within_tol(got, ref)
                check(ok, f"pim_dense layer {i} {name} bits={bits}: max err {err:.3g}")
                ok, err_vec = within_tol(got_vec, ref_vec)
                check(ok, f"pim_matvec_dense layer {i} {name} bits={bits}: max err "
                      f"{err_vec:.3g}")
                max_err, vec_err = max(max_err, err), max(vec_err, err_vec)
        torch.cuda.synchronize()
        want = n_layers * len(LINEARS)
        for kernel in (pim_matmul, pim_matvec):
            check(kernel.launches == want, f"entry point bits={bits}: {kernel.__name__} "
                  f"launched {kernel.launches} times, expected {want}")
            report[f"{kernel.__name__}_launches"][bits] = kernel.launches
        weights[bits] = [(name, [layer[j][1] for layer in qs], [layer[j][2] for layer in qs])
                         for j, (_, name, _) in enumerate(LINEARS)]

    layer, down = n_layers // 2, [name for _, name, _ in LINEARS].index("down")
    q = weights[8][down][1][layer]
    x = xs[q.shape[0]]
    faulty = x.clone()
    faulty[:, -FAULT_K_ROWS:] = 0
    ok, fault_err = within_tol(ops.pim_dense(faulty, q),
                               pim_matmul_plain(x, q.codes, q.scale, bits=8))
    check(not ok, f"the planted fault moved pim_dense's output by only "
          f"{fault_err:.3g}: the check cannot see it")
    report.update({"max_abs_err": max_err, "pim_matvec_dense_max_abs_err": vec_err,
                   "tol": KERNEL_TOL,
                   "planted_fault": f"layer {layer} down, bits 8: last {FAULT_K_ROWS} of "
                                    f"{q.shape[0]} K rows dropped",
                   "planted_fault_max_abs_err": fault_err})
    return weights, report


def engine_weights(eng, bits):
    """The engine's quantized linears for the timings: [(name, [QuantizedTensor
    per layer], [bias per layer])]."""
    out = []
    for group, name, bname in LINEARS:
        lw = eng.params["layers"][group]
        codes, scale = lw[name]["codes"], lw[name]["scale"]
        qs = [QuantizedTensor(c, sc, bits, packed=bits == 4) for c, sc in zip(codes, scale)]
        out.append((name, qs, [None] * len(qs) if bname is None else list(lw[bname])))
    return out


def _bound_terms_ms(m, k, n, weight_bytes, bias_bytes):
    """(bytes term, operations term, f32 CUDA-core term) of the least time,
    in ms, for bf16 x: the bytes the function must move (the weight's codes
    or planes, scale, x, bias, f32 out, each once) over the HBM rate; its
    multiply-adds over the card's peak rate for their type, bf16 on the
    tensor cores (int8 and int4 codes are exact in bf16 and a bf16 product
    is exact in f32); and the same multiply-adds over the f32 rate outside
    the tensor cores, the rate the current ``pim_matmul`` and
    ``bitplane_matmul`` designs run at: a note on those designs, not a bound
    (data-sheet peaks)."""
    moved = weight_bytes + 4 * n + m * k * 2 + bias_bytes + 4 * m * n
    ops_ = 2 * m * k * n
    return (moved / HBM_BYTES_PER_S * 1e3, ops_ / BF16_TC_FLOP_PER_S * 1e3,
            ops_ / F32_FLOP_PER_S * 1e3)


def _time_ms(calls, reps, graph=True):
    """Mean ms per call over up to ``reps`` passes through ``calls`` (fewer
    where one pass takes long, to stay near TIME_BUDGET_S), with CUDA events,
    after one warm-up pass.  ``graph=True`` captures one pass in a CUDA
    graph and replays it, so the host's issue rate is out of the
    measurement (device time); ``graph=False`` times the eager Python loop,
    which is what the paths pay today."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for c in calls:
        c()
    end.record()
    torch.cuda.synchronize()
    reps = max(1, min(reps, int(TIME_BUDGET_S * 1e3 / max(start.elapsed_time(end), 1e-3))))
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for c in calls:
                c()
        g.replay()
        run = g.replay
    else:
        def run():
            for c in calls:
                c()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def library_calls(x, qs):
    """One PyTorch call per layer computing the int8 kernels' function:
    ``torch._weight_int8pack_mm(x, codes^T, scale)`` = (x @ codes) * scale
    in x's dtype (the scale cast to it), without the bias (wq/wk/wv add it
    in a second call, left out).  The port never calls it.  Checked once
    against the plain version; returns (calls, None), or (None, the error)
    where this PyTorch has no CUDA kernel for it."""
    lib = [(q.codes.T.contiguous(), q.scale.reshape(-1).to(x.dtype)) for q in qs]
    try:
        got = torch._weight_int8pack_mm(x, *lib[0]).float()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0]}"
    ref = pim_matvec_plain(x, qs[0].codes, qs[0].scale, bits=8)
    check(bool(torch.allclose(got, ref, rtol=1e-2, atol=1e-2)),
          f"_weight_int8pack_mm vs plain: max err {(got - ref).abs().max().item():.3g}")
    return [functools.partial(torch._weight_int8pack_mm, x, c, s) for c, s in lib], None


def _bind_codes(q, bits):
    """A packed kernel's operands for ``timings``: (operands after x, fixed
    keywords, the weight's QuantizedTensor, the weight's bytes)."""
    k, n = q.shape
    return (q.codes, q.scale), {"bits": bits}, q, k * n * bits // 8


def _bind_planes(weight, bits):
    """``bitplane_matmul``'s operands for ``timings``: one byte per plane and
    weight."""
    planes, q = weight
    k, n = q.shape
    return (planes, q.scale), {}, q, bits * k * n


def timings(kernel, plain, m, weights, gen, what, bind=_bind_codes, library=None):
    """Per-shape times of ``kernel`` at M = ``m`` with bf16 inputs, cycling
    through all layers' weights (``weights``: {bits: [(name, [weight per
    layer], [bias per layer])]}, each weight bound to the kernel's operands
    by ``bind``); then, per bits, one pass of every launch in path order
    (layer-major).  ``library(x, qs)`` gives one PyTorch call per layer that
    computes the same function (or None and why), timed at bits 8."""
    dev = gen.device
    rows, passes = [], {}
    for bits, linears in weights.items():
        n_layers, n_linears = len(linears[0][1]), len(linears)
        step = {"kernel": [], "plain": [], "overlay": [], "library": []}
        step_bytes = step_ops = step_f32 = 0.0
        for name, ws, bs in linears:
            bound = [bind(w, bits) for w in ws]
            k, n = bound[0][2].shape
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            calls = {
                "kernel": [functools.partial(kernel, x, *args, bias=b, **kw)
                           for (args, kw, _, _), b in zip(bound, bs)],
                "plain": [functools.partial(plain, x, *args, bias=b, **kw)
                          for (args, kw, _, _), b in zip(bound, bs)],
                "overlay": [functools.partial(torch.matmul, x, dequantize(q).to(torch.bfloat16))
                            for _, _, q, _ in bound],
            }
            lib_err = library_us = None
            if library is not None and bits == 8:
                calls["library"], lib_err = library(x, [q for _, _, q, _ in bound])
                if calls["library"] is not None:
                    library_us = _time_ms(calls["library"], 20) * 1e3
            by_bytes, by_ops, by_f32 = _bound_terms_ms(m, k, n, bound[0][3],
                                                       0 if bs[0] is None else 2 * n)
            kernel_us = _time_ms(calls["kernel"], 20) * 1e3
            rows.append({"kernel": kernel.__name__, "shape": name, "K": k, "N": n,
                         "bits": bits, "M": m, "kernel_us": kernel_us,
                         "kernel_tflop_per_s": 2 * m * k * n / kernel_us / 1e6,
                         "kernel_bound_share": max(by_bytes, by_ops) * 1e3 / kernel_us,
                         "bound_us": max(by_bytes, by_ops) * 1e3,
                         "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                         "f32_cuda_core_us": by_f32 * 1e3,
                         "plain_us": _time_ms(calls["plain"], 5) * 1e3,
                         "overlay_yardstick_us": _time_ms(calls["overlay"], 20) * 1e3,
                         "library_us": library_us, "library_error": lib_err,
                         "kernel_eager_us": _time_ms(calls["kernel"], 5, graph=False) * 1e3})
            for key in step:
                step[key].append(calls.get(key))
            step_bytes += by_bytes * n_layers
            step_ops += by_ops * n_layers
            step_f32 += by_f32 * n_layers

        n_calls = n_layers * n_linears

        def step_ms(key, reps, graph=True):  # layer-major, the linears in path order
            order = [step[key][j][i] for i in range(n_layers) for j in range(n_linears)]
            return _time_ms(order, reps, graph) * n_calls

        kernel_ms = step_ms("kernel", 20)
        passes[bits] = {
            "per": f"{what}: {n_calls} launches ({n_layers} layers x {n_linears} "
                   f"linears), M={m}, bits {bits}, bf16 x; device time (CUDA graph replay)",
            "kernel_ms": kernel_ms, "plain_ms": step_ms("plain", 5),
            "overlay_ms": step_ms("overlay", 20),
            "library_ms": (None if None in step["library"] else step_ms("library", 20)),
            "kernel_eager_ms": step_ms("kernel", 5, graph=False),
            "bound_ms": max(step_bytes, step_ops),
            "bound_by": "bytes" if step_bytes >= step_ops else "operations",
            "f32_cuda_core_ms": step_f32,
            "kernel_tflop_per_s": step_ops * BF16_TC_FLOP_PER_S / kernel_ms / 1e12,
            "kernel_bound_share": max(step_bytes, step_ops) / kernel_ms}
    return rows, passes


def bitplane_entry_point(params, gen):
    """The bit-plane entry point at full width, bits 8 and then 4: every
    layer's seven float weights through ``ops.pim_dense_bitplane`` on a
    seeded (512, K) bf16 activation, ``wq``/``wk``/``wv`` with a seeded bias,
    each output held within KERNEL_TOL of ``bitplane_matmul_plain`` on the
    same planes and equal bit for bit (``torch.equal``) to the packed path
    ``ops.pim_dense(x, ops.quantize_for_pim(w, bits))``.  Each pass must launch
    ``bitplane_matmul`` 196 times.  Then a planted fault — the sign plane of
    layer n/2's ``down`` cleared in its last 32 K rows — must fail the check
    against the plain version.  Each width is timed (``timings``: the bound
    counts the planes' bytes, and no PyTorch call computes the function, so
    there is no library time) and its planes freed before the next.

    Returns (a report, {bits: the pass's times})."""
    dev = gen.device
    n_layers = params["layers"]["attn"]["wq"].shape[0]
    widths = {w.shape[0] for _, w, _ in _linear_params(params, 0)}
    xs = {k: torch.randn((PREFILL_ROWS, k), generator=gen, device=dev).to(torch.bfloat16)
          for k in sorted(widths)}
    biases = {name: torch.randn(w.shape[1:], generator=gen, device=dev).to(torch.bfloat16)
              for name, w, b in _linear_params(params, 0) if b is not None}
    report = {"check": "bit-plane entry point at full width vs plain and vs packed",
              "rows": PREFILL_ROWS, "bitplane_matmul_launches": {}}
    max_err = packed_err = 0.0
    passes = {}
    for bits in (8, 4):
        layers = []
        torch.cuda.synchronize()
        bitplane_matmul.launches = 0
        for i in range(n_layers):
            layer = []
            for name, w, _ in _linear_params(params, i):
                b, x = biases.get(name), xs[w.shape[0]]
                got = ops.pim_dense_bitplane(x, w, bits, bias=b)
                q = quantize_symmetric(w, bits)
                planes = to_bitplanes(q.codes, bits)
                ref = bitplane_matmul_plain(x, planes, q.scale, bias=b)
                packed = ops.pim_dense(x, ops.quantize_for_pim(w, bits), bias=b)
                torch.cuda.synchronize()
                ok, err = within_tol(got, ref)
                check(ok, f"pim_dense_bitplane layer {i} {name} bits={bits} vs plain: "
                      f"max err {err:.3g}")
                err_packed = (got - packed).abs().max().item()
                check(torch.equal(got, packed), f"pim_dense_bitplane layer {i} {name} "
                      f"bits={bits} is not bit-identical to pim_dense: max diff {err_packed:.3g}")
                max_err, packed_err = max(max_err, err), max(packed_err, err_packed)
                layer.append((name, planes, q, b))
            layers.append(layer)
        torch.cuda.synchronize()
        want = n_layers * len(LINEARS)
        check(bitplane_matmul.launches == want, f"bit-plane entry point bits={bits}: "
              f"bitplane_matmul launched {bitplane_matmul.launches} times, expected {want}")
        report["bitplane_matmul_launches"][bits] = bitplane_matmul.launches

        if bits == 8:
            fault_layer = n_layers // 2
            _, planes, q, _ = layers[fault_layer][[name for _, name, _ in LINEARS].index("down")]
            faulty = planes.clone()
            faulty[-1, -32:] = 0
            x = xs[planes.shape[1]]
            ok, fault_err = within_tol(bitplane_matmul(x, faulty, q.scale),
                                       bitplane_matmul_plain(x, planes, q.scale))
            check(not ok, f"the planted fault moved bitplane_matmul's output by only "
                  f"{fault_err:.3g}: the check cannot see it")
            report.update({"planted_fault": f"layer {fault_layer} down, bits 8: sign plane "
                                            f"cleared in the last 32 of {planes.shape[1]} K rows",
                           "planted_fault_max_abs_err": fault_err})

        weights = [(name, [layer[j][1:3] for layer in layers], [layer[j][3] for layer in layers])
                   for j, (_, name, _) in enumerate(LINEARS)]
        del layers
        rows, timed = timings(bitplane_matmul, bitplane_matmul_plain, PREFILL_ROWS,
                              {bits: weights}, gen, PREFILL_PASS, bind=_bind_planes)
        for row in rows:
            print(json.dumps(row))
        passes[bits] = timed[bits]
        print(json.dumps({f"bitplane_prefill_pass_bits{bits}": passes[bits]}))
        del weights
        torch.cuda.empty_cache()
    report.update({"max_abs_err": max_err, "packed_path_max_abs_diff": packed_err,
                   "packed_path": "bit for bit (torch.equal)", "tol": KERNEL_TOL})
    return report, passes


def _fold_input(rows, q, dtype, gen):
    """Values of mixed sign over many orders of magnitude, so that an
    association order other than the fold's changes the bits."""
    dev = gen.device
    mag = torch.exp(4.0 * torch.randn((rows, q), generator=gen, device=dev))
    return (torch.randn((rows, q), generator=gen, device=dev) * mag).to(dtype)


def _fold_adjacent_top(x):
    """A deliberately wrong plain twin: the top level pairs adjacent elements
    (the same values, summed as another tree), the rest as the fold."""
    x = x.to(torch.float32)
    if x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    return fold_reduce_plain(x)


def fold_phase(gen):
    """``fold_reduce`` against its plain version, ``torch.equal`` (bit for
    bit), over FOLD_Q x FOLD_ROWS in f32 and bf16; a planted fault (a plain
    twin whose top level pairs adjacent elements) must fail that check at
    fold_sum's shapes; ``ops.fold_sum`` on the card at FOLD_SHAPES, with its
    launch count; then times per shape, cycling through 28 inputs (one per
    layer) so that nothing is timed out of L2: kernel, bound (bytes), plain
    version and ``torch.sum`` (another association order, timed only)."""
    max_err, caught = 0.0, 0
    for q in FOLD_Q:
        for rows in FOLD_ROWS:
            for dtype in (torch.float32, torch.bfloat16):
                x = _fold_input(rows, q, dtype, gen)
                got, ref = fold_reduce(x), fold_reduce_plain(x)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                check(torch.equal(got, ref) and tuple(got.shape) == (rows,),
                      f"fold_reduce q={q} rows={rows} {dtype}: not bit-identical to the "
                      f"plain version (max err {err:.3g})")
                max_err = max(max_err, err)
                caught += not torch.equal(got, _fold_adjacent_top(x))
    report = {"check": "fold_reduce vs plain, bit for bit",
              "cases": 2 * len(FOLD_Q) * len(FOLD_ROWS), "max_abs_err": max_err,
              "planted_fault": "plain twin whose top level pairs adjacent elements",
              "planted_fault_caught_in_cases": caught}

    xs = [_fold_input(rows, q, torch.float32, gen) for rows, q in FOLD_SHAPES]
    torch.cuda.synchronize()
    fold_reduce.launches = 0
    outs = [ops.fold_sum(x) for x in xs]
    torch.cuda.synchronize()
    launches = fold_reduce.launches
    check(launches == len(FOLD_SHAPES), f"fold_sum launched fold_reduce {launches} times, "
          f"expected {len(FOLD_SHAPES)}")
    for (rows, q), x, out in zip(FOLD_SHAPES, xs, outs):
        check(tuple(out.shape) == (rows,) and bool(torch.isfinite(out).all()),
              f"fold_sum ({rows}, {q}): shape {tuple(out.shape)} or non-finite values")
        check(torch.equal(out, fold_reduce_plain(x)),
              f"fold_sum ({rows}, {q}) differs from the plain version")
        fault = _fold_adjacent_top(x)
        check(not torch.equal(out, fault), f"fold_sum ({rows}, {q}): the planted fault "
              "gives the same bits: the check cannot see it")
        report[f"planted_fault_max_abs_err_{rows}x{q}"] = (out - fault).abs().max().item()
        report[f"torch_sum_bit_identical_{rows}x{q}"] = torch.equal(out, x.sum(-1))

    shapes, totals = [], {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for rows, q in FOLD_SHAPES:
        ins = [_fold_input(rows, q, torch.float32, gen) for _ in range(28)]

        def us(fn, *args):
            return _time_ms([functools.partial(fn, x, *args) for x in ins], 20) * 1e3

        row = {"kernel": "fold_reduce", "rows": rows, "q": q, "dtype": "float32",
               "plan": fold_plan(rows, q, 4, torch.cuda.get_device_properties(0).multi_processor_count)._asdict(),
               "kernel_us": us(fold_reduce),
               "bound_us": (rows * q * 4 + rows * 4) / HBM_BYTES_PER_S * 1e6, "bound_by": "bytes",
               "plain_us": us(fold_reduce_plain), "library_us": us(torch.sum, -1)}
        shapes.append(row)
        print(json.dumps(row))
        for key in totals:
            totals[key] += row[key.replace("_ms", "_us")] / 1e3
        del ins
    report.update(launches=launches, shapes=shapes, **totals,
                  per=f"one fold_sum at each of {[list(s) for s in FOLD_SHAPES]}, f32; "
                      "device time (CUDA graph replay)")
    print(json.dumps({key: v for key, v in report.items() if key != "shapes"}))
    return report


def within_bf16_ulp(got, ref):
    """(every output finite and within KERNEL_TOL plus one bf16 ulp of
    ``ref``, max |err|, the largest share of that tolerance used, and the
    (got, ref) pair that uses it).  Both
    sides compute in f32 and round once to bf16: two f32 results within
    KERNEL_TOL round to bf16 values at most that plus one ulp (at the larger
    magnitude of the two) apart.  One ulp alone is too tight where a row's
    weighted sum cancels to near 0: there an f32 difference of 1e-6 is many
    ulps of the tiny result."""
    g, r = got.float(), ref.float()
    _, e = torch.frexp(torch.maximum(g.abs(), r.abs()).clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)  # 2^(floor(log2 |x|) - 7)
    tol = KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * r.abs() + ulp
    err = (g - r).abs()
    ok = bool(torch.isfinite(g).all()) and bool((err <= tol).all())
    share = err / tol
    worst = int(share.argmax())
    return ok, err.max().item(), share.max().item(), (g.flatten()[worst].item(),
                                                       r.flatten()[worst].item())


def flash_build_report():
    """What the compiler made of the bf16 route: the HMMA (tensor-core MMA)
    instructions in each head dim's ``flash_attn_mma_kernel`` in the built
    library's SASS (``cuobjdump -sass``), which must be more than 0, and
    ptxas's registers and spills for it (``-Xptxas -v``, the build log)."""
    lib = build.library_path("flash_attn")
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    hmma = {}
    for section in sass.split("Function : ")[1:]:
        key = _flash_label(section.split(None, 1)[0])
        if key:
            hmma[key] = section.count("HMMA")
    for d in (16, 32, 64, 128):
        check(hmma.get(f"bf16 D={d}", 0) > 0, f"no HMMA in the bf16 flash kernel at D={d}: {hmma}")
    return {"check": "flash_attention build", "hmma_instructions": hmma,
            "ptxas": _ptxas("flash_attn", _flash_label)}


def _flash_label(mangled):
    found = re.search(r"flash_attn_(mma_)?kernelILi(\d+)E", mangled)
    return found and f"{'bf16' if found[1] else 'f32'} D={found[2]}"


def flash_vs_plain(cfg, gen):
    """``flash_attention`` against ``flash_attention_plain`` on the card over
    FLASH_BHSD (through the (BH, S, D) entry point) and FLASH_LENGTHS at the
    model's heads (through ``flash_attention_gqa``, also with k and v as the
    int8 cache's transposed views), causal and not, f32 within KERNEL_TOL
    and bf16 within that plus one bf16 ulp (``within_bf16_ulp``).  Then a planted
    fault per route, the kernel told to stop one tile short at the long
    prompt's shape (its last KV_TILE keys cut off in f32, KV_TILE_BF16 in
    bf16), must fail that route's check; and a bf16 k whose key stride is no
    multiple of 8 elements must raise ValueError."""
    dev = gen.device
    heads = (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
    cases = ([(bh, sq, sk, 1, 1, d) for bh, sq, sk, d in FLASH_BHSD]
             + [(1, s, s, *heads) for s in FLASH_LENGTHS])
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bf16_share, bf16_worst, n = 0.0, None, 0
    for b, sq, sk, kvh, g, d in cases:
        q32 = torch.randn((b, sq, kvh, g, d), generator=gen, device=dev)
        k32 = torch.randn((b, sk, kvh, d), generator=gen, device=dev)
        v32 = torch.randn((b, sk, kvh, d), generator=gen, device=dev)
        for dtype in errs:
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            for causal in (True, False):
                ref = flash_attention_plain(q, k, v, causal=causal)
                if kvh == g == 1:
                    outs = {"(BH, S, D)": flash_attention(q[:, :, 0, 0], k[:, :, 0], v[:, :, 0],
                                                          causal=causal)[:, :, None, None]}
                else:
                    kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (k, v))
                    outs = {"gqa": flash_attention_gqa(q, k, v, causal=causal),
                            "gqa, k/v transposed views": flash_attention_gqa(q, kt, vt,
                                                                              causal=causal)}
                torch.cuda.synchronize()
                for layout, got in outs.items():
                    worst = ""
                    if dtype == torch.float32:
                        ok, err = within_tol(got, ref)
                    else:
                        ok, err, share, pair = within_bf16_ulp(got, ref)
                        if share >= bf16_share:
                            bf16_share = share
                            bf16_worst = {"case": [b, sq, sk, kvh, g, d], "layout": layout,
                                          "causal": causal, "got": pair[0], "ref": pair[1]}
                        worst = f", {share:.3g} of the tolerance at (got, ref) = {pair}"
                    check(ok and got.dtype == dtype and got.shape == ref.shape,
                          f"flash_attention {layout} {(b, sq, sk, kvh, g, d)} {dtype} "
                          f"causal={causal}: max err {err:.3g}{worst}")
                    errs[dtype] = max(errs[dtype], err)
                    n += 1
                del ref, outs
    # The planted faults, on the last case's inputs: one per route.
    q, k, v = q32, k32, v32
    ok, fault_err = within_tol(flash_attention_gqa(q, k[:, :-KV_TILE], v[:, :-KV_TILE], causal=True),
                               flash_attention_plain(q, k, v, causal=True))
    check(not ok, f"the planted fault moved flash_attention's output by only "
          f"{fault_err:.3g}: the check cannot see it")
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    ok, bf16_fault_err, bf16_fault_share, _ = within_bf16_ulp(
        flash_attention_gqa(q, k[:, :-KV_TILE_BF16], v[:, :-KV_TILE_BF16], causal=True),
        flash_attention_plain(q, k, v, causal=True))
    check(not ok, f"the bf16 planted fault moved flash_attention's output by only "
          f"{bf16_fault_err:.3g} ({bf16_fault_share:.3g} of the bar): the check cannot see it")
    # The bf16 route copies 16-byte rows: a key stride that is not a multiple
    # of 8 elements must raise, not fall back.
    odd = torch.zeros(k.shape[:-1] + (k.shape[-1] + 1,), dtype=k.dtype, device=dev)[..., :-1]
    try:
        flash_attention_gqa(q, odd, v, causal=True)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    check(refused is not None, f"flash_attention_gqa took a bf16 k with strides {odd.stride()}")
    return {"check": "flash_attention vs plain", "cases": n,
            "max_abs_err": max(errs.values()), "f32_max_abs_err": errs[torch.float32],
            "bf16_max_abs_err": errs[torch.bfloat16], "bf16_tol_share": bf16_share,
            "bf16_worst": bf16_worst, "tol": {"float32": KERNEL_TOL,
                    "bfloat16": "the f32 tolerance plus one bf16 ulp at the output's magnitude"},
            "planted_fault": f"{tuple(q.shape)} f32 causal: the last {KV_TILE} keys (one "
                             "kernel tile) dropped",
            "planted_fault_max_abs_err": fault_err,
            "bf16_planted_fault": f"{tuple(q.shape)} bf16 causal: the last {KV_TILE_BF16} keys "
                                  "(one kernel tile) dropped",
            "bf16_planted_fault_max_abs_err": bf16_fault_err,
            "bf16_planted_fault_tol_share": bf16_fault_share,
            "misaligned_bf16_k": {"strides": list(odd.stride()), "raised": refused}}


def long_prompt_path(cfg, params, gen):
    """The long-prompt path: ``ServingEngine.generate`` on one seeded prompt
    of LONG_PROMPT tokens for LONG_NEW new tokens, int8 weights, bf16 cache.
    Prints the host-clock time to first token (a second, 1-token
    generation) and the decode ms per step at LONG_PROMPT cached tokens.
    Then a third prefill sends each layer's own q, k, v through both the
    kernel and ``flash_attention_plain``: every layer must be within the
    bf16 bar (``within_bf16_ulp``).  Its launches are counted in phase 8,
    where the same generation runs in the profiler's session
    (``counted_generation``).

    Returns (a report, the prompt, the engine, its counted captures, the
    tokens)."""
    dev = gen.device
    eng = ServingEngine(cfg, params, max_seq=LONG_PROMPT + LONG_NEW, pim_bits=8, device=dev)
    graphs = count_captures(eng)
    prompt = torch.randint(0, cfg.vocab, (1, LONG_PROMPT), generator=gen, device=dev)
    eng.generate(prompt, 1)  # warm-up: the long shapes' first library calls, the step's capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng.generate(prompt, LONG_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.generate(prompt, 1)  # prefill and tok0 only
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    check(tuple(toks.shape) == (1, LONG_NEW), f"long path tokens shape {tuple(toks.shape)}")
    check(toks.dtype == torch.int32, f"long path tokens are {toks.dtype}, not int32")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "long path token ids out of range")

    # Each layer's own q, k, v through the kernel and the plain version.
    layers = []

    def against_plain_per_layer(q, k, v, **kw):
        got = flash_attention_gqa(q, k, v, **kw)
        ok, err, share, pair = within_bf16_ulp(got, flash_attention_plain(q, k, v, **kw))
        layers.append({"layer": len(layers), "ok": ok, "dtype": str(q.dtype), "max_abs_err": err,
                       "tol_share": share, "worst_pair": pair})
        return got

    with attention_through(against_plain_per_layer):
        eng.generate(prompt, 1)
    torch.cuda.synchronize()
    worst = max(layers, key=lambda r: r["tol_share"])
    per_layer = {"check": "bf16 long prefill, each layer's attention vs plain on its own q, k, v",
                 "layers": len(layers), "worst_layer": worst,
                 "tol": "the f32 tolerance plus one bf16 ulp (within_bf16_ulp)"}
    print(json.dumps(per_layer))
    check(len(layers) == cfg.n_layers, f"{len(layers)} layers checked, expected {cfg.n_layers}")
    bad = [r for r in layers if not r["ok"] or r["dtype"] != "torch.bfloat16"]
    check(not bad, f"long-prompt layers outside the bf16 bar of the plain version: {bad}")
    return {"path": "qwen2-1.5b int8 generate, long prompt", "batch": 1,
            "prompt": LONG_PROMPT, "n_new": LONG_NEW,
            "launches": "counted in phase 8 (counted_generation)",
            "generate_s": t_gen, "time_to_first_token_s": t_first,
            "decode_ms_per_step": (t_gen - t_first) / (LONG_NEW - 1) * 1e3,
            "layers_vs_plain_worst_tol_share": worst["tol_share"]}, prompt, eng, graphs, toks


@contextlib.contextmanager
def attention_through(fn):
    """Route the model's long-prompt attention through ``fn`` in place of
    the wrapper."""
    prev, attention.flash_attention_gqa = attention.flash_attention_gqa, fn
    try:
        yield
    finally:
        attention.flash_attention_gqa = prev


def dropped_kv_tile(n_layers, layer):
    """The wrapper with one planted fault: ``layer``'s attention loses its
    last KV tile (the kernel sees KV_TILE fewer keys)."""
    calls = 0

    def faulty(q, k, v, **kw):
        nonlocal calls
        if calls % n_layers == layer:
            k, v = k[:, :-KV_TILE], v[:, :-KV_TILE]
        calls += 1
        return flash_attention_gqa(q, k, v, **kw)
    return faulty


def long_against_plain(cfg, gen, prompt):
    """The long-prompt path at full width in f32, kernel vs plain version:
    the prefill logits of ``prompt`` through the kernel against the same
    prefill with every layer's attention through ``flash_attention_plain``
    on the card, within LONG_PATH_TOL.  Then a planted fault (layer n/2's
    attention loses its last KV tile) must fail that check.  One prefill's
    f32 logits are 10 GB: only the rows at every 1,024th position and the
    last 64 are kept, each prefill's logits freed before the next."""
    dev = gen.device
    cfg32 = cfg.replace(param_dtype="float32")
    eng = ServingEngine(cfg32, init_params(cfg32, gen, device=dev),
                        max_seq=LONG_PROMPT + LONG_NEW, pim_bits=8, device=dev)
    rows = torch.tensor(sorted(set(range(0, LONG_PROMPT, 1024))
                               | set(range(max(0, LONG_PROMPT - 64), LONG_PROMPT))), device=dev)

    def prefill_rows():
        with torch.inference_mode():
            cache = init_cache(cfg32, 1, eng.max_seq, dev)
            logits, _ = prefill(eng.params, cfg32, prompt, cache)
            out = logits[0].index_select(0, rows)
            del logits, cache
        return out

    flash_attention.launches = 0
    lk = prefill_rows()
    with attention_through(flash_attention_plain):
        lp = prefill_rows()
    with attention_through(dropped_kv_tile(cfg.n_layers, cfg.n_layers // 2)):
        lf = prefill_rows()
    torch.cuda.synchronize()
    check(flash_attention.launches == 2 * cfg.n_layers, f"the f32 long prefills launched "
          f"flash_attention {flash_attention.launches} times, expected {2 * cfg.n_layers}")
    diff = (lk - lp).abs().max().item()
    fault = (lf - lp).abs().max().item()
    report = {"check": "f32 long prefill, kernel path vs plain path", "prompt": LONG_PROMPT,
              "rows_compared": rows.numel(), "max_abs_logit_diff": diff,
              "tol": LONG_PATH_TOL, "logit_std": lp.std().item(),
              "planted_fault": f"layer {cfg.n_layers // 2} attention: last {KV_TILE} keys "
                               "dropped",
              "planted_fault_max_abs_logit_diff": fault,
              "planted_fault_rows_moved": int(((lf - lp).abs().amax(-1) > diff).sum())}
    print(json.dumps(report))
    check(bool(torch.isfinite(lk).all()), "f32 long path: non-finite logits")
    check(diff <= LONG_PATH_TOL, f"f32 long path: kernel logits differ from the plain "
          f"version's by {diff:.4g} > {LONG_PATH_TOL}")
    check(fault > LONG_PATH_TOL, f"the planted fault moved the f32 long-path logits by only "
          f"{fault:.4g} <= {LONG_PATH_TOL}: the check cannot see it")
    return report


def flash_timings(cfg, gen):
    """Device times at the long prefill's attention, bf16, causal: one
    layer's call (replayed alone) and one prefill's 28 calls, each on its own
    seeded q, k, v, so that a pass reads 1.9 GB and nothing stays in L2.
    Kernel, plain version and the yardstick ``scaled_dot_product_attention``
    (``is_causal``, ``enable_gqa``; the port never calls it) on the same
    inputs, beside the bound: the larger of the bytes (q, k, v read once,
    the output written once) at the HBM rate and the useful causal
    multiply-adds at the bf16 tensor cores' rate; the f32 CUDA-core term, the
    rate the f32 route runs at, beside it (a note, not a bound).  The
    kernel's achieved TFLOP/s count the useful causal FLOP only (not the
    split p's third product, nor the masked half of the diagonal tiles); its
    bound share is bound / kernel time."""
    dev = gen.device
    b, s, kvh, d = 1, LONG_PROMPT, cfg.n_kv_heads, cfg.head_dim
    h = cfg.n_heads
    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls = {"kernel": [], "plain": [], "library": []}
    for _ in range(cfg.n_layers):
        q = torch.randn((b, s, kvh, h // kvh, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, s, kvh, d), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        calls["kernel"].append(functools.partial(flash_attention_gqa, q, k, v, causal=True))
        calls["plain"].append(functools.partial(flash_attention_plain, q, k, v, causal=True))
        calls["library"].append(functools.partial(
            sdpa, q.reshape(b, s, h, d).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True))
    ref = calls["plain"][0]()
    lib = calls["library"][0]().transpose(1, 2).reshape(ref.shape)
    torch.cuda.synchronize()
    lib_diff = (lib.float() - ref.float()).abs().max().item()
    check(lib_diff < 0.05, f"scaled_dot_product_attention vs plain: max diff {lib_diff:.3g}")
    del ref, lib
    pairs = s * (s + 1) // 2  # (query, key) pairs query i >= key j
    flops = 4 * d * pairs * h * b  # q.k and p.v, a multiply and an add each
    by_bytes = 2 * d * b * (2 * s * h + 2 * s * kvh) / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_TC_FLOP_PER_S * 1e3
    per_layer = {f"{key}_ms": _time_ms(fns[:1], 20) for key, fns in calls.items()}
    per_prefill = {f"{key}_ms": _time_ms(fns, 3) * cfg.n_layers for key, fns in calls.items()}
    n = cfg.n_layers
    per_layer.update(bound_ms=max(by_bytes, by_ops), bytes_ms=by_bytes, operations_ms=by_ops,
                     f32_cuda_core_ms=flops / F32_FLOP_PER_S * 1e3,
                     kernel_tflop_per_s=flops / per_layer["kernel_ms"] / 1e9,
                     kernel_bound_share=max(by_bytes, by_ops) / per_layer["kernel_ms"])
    return {"timing": "flash_attention at the long prefill", "shape": [b, s, kvh, h // kvh, d],
            **per_prefill, "bound_ms": max(by_bytes, by_ops) * n,
            "kernel_tflop_per_s": flops * n / per_prefill["kernel_ms"] / 1e9,
            "kernel_bound_share": max(by_bytes, by_ops) * n / per_prefill["kernel_ms"],
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes_ms": by_bytes * n, "f32_cuda_core_ms": flops / F32_FLOP_PER_S * 1e3 * n,
            "library_note": "scaled_dot_product_attention(is_causal, enable_gqa), bf16; "
                            f"max diff vs plain {lib_diff:.3g}",
            "per_layer": per_layer,
            "per": f"one long prefill's attention: {n} launches at (B, S, KV, G, D) = "
                   f"{(b, s, kvh, h // kvh, d)}, causal, bf16; device time (CUDA graph replay)"}


# ---- 8. the captured decode step ------------------------------------------------
KERNEL_FNS = (pim_matvec, pim_matmul, bitplane_matmul, fold_reduce, flash_attention)
# What each wrapper's kernels' names hold, in a profiler trace.
KERNEL_TAGS = {"pim_matvec": "pim_matvec_kernel", "pim_matmul": "pim_matmul_",
               "bitplane_matmul": "bitplane_matmul_", "fold_reduce": "fold_reduce_kernel",
               "flash_attention": "flash_attn_"}
TRACE = Path(__file__).resolve().parent / "build" / "traces" / "segments.json"


def launch_counts():
    return {kernel.__name__: kernel.launches for kernel in KERNEL_FNS}


class CountedGraph:
    """A captured decode step whose replays are counted, with the kernels'
    launch counters read around its capture (``launches``): the wrappers
    count as the step is captured, and a replay runs no Python, so it
    counts nothing."""

    def __init__(self, graph, launches):
        self.graph, self.launches, self.replays = graph, launches, 0

    def replay(self):
        self.replays += 1
        self.graph.replay()


def count_captures(eng):
    """From now on, each step ``eng`` captures (a decode step, or a chunk step
    of the continuous engine) is a ``CountedGraph``, added to the list
    returned."""
    graphs, capture = [], eng.graphs._capture

    def counted(run, pool):
        before = launch_counts()
        graph = capture(run, pool)
        after = launch_counts()
        graphs.append(CountedGraph(graph, {k: after[k] - before[k] for k in after}))
        return graphs[-1]

    eng.graphs._capture = counted
    return graphs


def counted_launches(graphs, fn):
    """Run ``fn`` with every counter set to 0 first and read just after: each
    kernel's launches in it are the wrappers' counts (eager launches) plus,
    for each captured step of ``graphs``, its launches at capture times its
    replays in ``fn``: the cross-check of the traced count
    (``counted_generation``).  No step may be captured inside ``fn`` (warm
    up first).  Returns (fn's result, launches, how they were counted)."""
    n_graphs, replays = len(graphs), [g.replays for g in graphs]
    for kernel in KERNEL_FNS:
        kernel.launches = 0
    result = fn()
    torch.cuda.synchronize()
    check(len(graphs) == n_graphs, "a decode step was captured inside a counted run")
    launches, eager = launch_counts(), launch_counts()
    counted_as = []
    for g, r0 in zip(graphs, replays):
        if g.replays > r0:
            for k, c in g.launches.items():
                launches[k] += c * (g.replays - r0)
            counted_as.append(f"{g.launches} per replay (read around the capture) x "
                              f"{g.replays - r0} replays")
    counted_as.append(f"eager launches (the wrappers' counters): {eager}")
    return result, launches, "; ".join(counted_as)


def traced_kernels(window):
    """The kernels of each of KERNEL_FNS in a traced window, by name."""
    return {name: sum(tag in k for k in window.kernels) for name, tag in KERNEL_TAGS.items()}


def counted_generation(graphs, generate, out):
    """A traced window's call: ``generate()`` with every launch counter set to
    0 just before it and read just after (``counted_launches``), its
    tokens, counters and their account kept in ``out``.  The window's
    trace gives the launches that ran on the device (``check_counted``)."""
    def run():
        out["tokens"], out["counters"], out["counters_as"] = counted_launches(graphs, generate)
    return run


def same_tokens(a, b) -> bool:
    """Equal tokens: two tensors, or two serves' lists of arrays."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def check_counted(label, window, out, toks, want):
    """The launches of one counted generation: the kernels of each wrapper
    in its window of the trace must be ``want``, equal the counters'
    account (capture x replays plus eager launches), and the tokens must
    equal ``toks``, the same generation's earlier, untraced, tokens."""
    traced = traced_kernels(window)
    out["traced"] = traced
    out["counted_as"] = (f"{label}: the kernels of each wrapper in this run's profiler trace "
                         f"of the generation; cross-check, the counters: {out['counters_as']}")
    check(traced == want, f"{label}: launches {traced} in the trace, expected {want}")
    check(out["counters"] == traced, f"{label}: the counters give {out['counters']}, "
          f"the trace {traced} ({out['counters_as']})")
    check(same_tokens(out["tokens"], toks), f"{label}: the traced generation's tokens differ "
          "from the same generation's earlier ones")
    return {"path": label, "launches": traced, "launches_counted_as": out["counted_as"]}


def captured_vs_eager(eng, prompt, n_new, label, *, greedy, temperature=1.0, top_k=0, key=None):
    """(a)/(b): ``eng.generate`` (each decode step one replay of the captured
    step) against an eager loop of the same step function,
    ``decode_and_emit``, from the same prefill on buffers of its own: the
    tokens and the last step's logits must be equal (``torch.equal``)."""
    b = prompt.shape[0]
    kw = dict(greedy=greedy, top_k=top_k)
    with torch.inference_mode():
        toks = eng.generate(prompt, n_new, temperature=temperature, key=key, **kw)
        logits = eng.state(b).logits.clone()
        st = DecodeState(eng.cfg, b, eng.max_seq, prompt.device)
        st.start(eng.params, eng.cfg, prompt, key, temperature, **kw)
        for _ in range(n_new - 1):
            decode_and_emit(eng.params, eng.cfg, st, **kw)
        eager = st.out[:, :n_new].clone()
        torch.cuda.synchronize()
    same_toks, same_logits = torch.equal(toks, eager), torch.equal(logits, st.logits)
    report = {"case": label, "tokens": toks.numel(), "tokens_equal": same_toks,
              "last_logits_equal": same_logits,
              "tokens_differing": int((toks != eager).sum()),
              "last_logits_max_abs_diff": (logits.float() - st.logits.float()).abs().max().item()}
    check(toks.dtype == torch.int32 and bool(((toks >= 0) & (toks < eng.cfg.vocab)).all()),
          f"{label}: captured tokens {toks.dtype} out of range")
    check(same_toks and same_logits, f"{label}: the captured generate differs from the eager "
          f"loop of the same step: {report}")
    return report, toks


def stale_graph_check(cfg, eng, prompt):
    """(d): after a generation, the stacked ``down`` codes leaf is replaced by
    a new tensor in which layer n/2's codes are negated: the next
    generation's last logits must differ from the previous ones and equal
    those of a fresh engine on the new tree (a captured step reads the
    memory it was captured on, so the engine must capture again).  The old
    leaf is put back after."""
    b, n_new, layer = prompt.shape[0], STALE_NEW, cfg.n_layers // 2
    down = eng.params["layers"]["mlp"]["down"]
    old = down["codes"]
    with torch.inference_mode():
        eng.generate(prompt, n_new)
        before = eng.state(b).logits.clone()
        new = old.clone()
        new[layer] = -old[layer]
        down["codes"] = new
        try:
            toks = eng.generate(prompt, n_new)
            after = eng.state(b).logits.clone()
            fresh = ServingEngine(cfg, eng.params, max_seq=eng.max_seq, device=eng.device)
            toks_fresh = fresh.generate(prompt, n_new)
            fresh_logits = fresh.state(b).logits.clone()
        finally:
            down["codes"] = old
        torch.cuda.synchronize()
    report = {"check": "stale-graph: a new down codes leaf after a generation",
              "planted_change": f"layer {layer} down codes negated, in a new tensor",
              "logits_changed": not torch.equal(after, before),
              "max_abs_logit_change": (after.float() - before.float()).abs().max().item(),
              "equal_to_fresh_engine": torch.equal(after, fresh_logits)
              and torch.equal(toks, toks_fresh)}
    check(report["logits_changed"], f"the engine replayed a step captured on the old weights: {report}")
    check(report["equal_to_fresh_engine"], f"after a new leaf the engine differs from a fresh "
          f"engine on the new tree: {report}")
    return report


def timing_pairs(eng, prompt, n_new, label):
    """(e): decode ms a step on the host clock, in rounds that alternate an
    eager loop of ``decode_and_emit`` on buffers of its own, the captured
    greedy step, and the captured sampled step (SAMPLED), each from its own
    prefill (not timed).  Returns the rounds and their medians."""
    b = prompt.shape[0]
    cfg = eng.cfg
    eager_st = DecodeState(cfg, b, eng.max_seq, prompt.device)
    runs = {"eager_ms": (eager_st, functools.partial(decode_and_emit, eng.params, cfg, eager_st,
                                                     greedy=True, top_k=0), GREEDY),
            "captured_ms": (eng.state(b), eng.step(b, greedy=True, top_k=0), GREEDY),
            "captured_sampled_ms": (eng.state(b), eng.step(b, greedy=False,
                                                           top_k=SAMPLED["top_k"]), SAMPLED)}

    def ms(st, step, mode):
        st.start(eng.params, cfg, prompt, mode.get("key"), mode.get("temperature", 1.0),
                 greedy=mode["greedy"], top_k=mode.get("top_k", 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_new - 1):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (n_new - 1)

    rounds = []
    for _ in range(TIMING_ROUNDS):
        rounds.append({key: ms(*run) for key, run in runs.items()})
        rounds[-1]["sm_clock_mhz"] = tracing.sm_clock_mhz()
    medians = {key: sorted(r[key] for r in rounds)[len(rounds) // 2] for key in runs}
    return {"timing": f"{label}: decode ms a step, host clock, alternating rounds of eager / "
                      "captured / captured sampled, each over "
                      f"{n_new - 1} steps from its own prefill",
            "rounds": rounds, "medians": medians,
            "sampling_ms": medians["captured_sampled_ms"] - medians["captured_ms"],
            "sampling_share": (medians["captured_sampled_ms"] - medians["captured_ms"])
            / medians["captured_ms"]}


def captured_phase(cfg, eng8, eng4, long_eng, prompt, long_prompt, one_calls, paths, extra):
    """Phase 8: the captured decode step, (a) to (e) of the module's
    docstring, and in the same profiler session phase 2's one-call traces,
    the counted generations of phases 3 and 7 (``counted_generation``) and
    phase 9's windows ``extra`` [(label, set-up, fn)].  ``paths``: {"int8" |
    "int4" | "long": (the engine's counted captures, the tokens of its
    earlier generation, its n_new)}.  Returns ({path: its launches, traced,
    and their account}, the traced windows)."""
    cases = []
    with torch.inference_mode():
        for eng, bits in ((eng8, 8), (eng4, 4)):
            greedy_toks = None
            for mode_label, mode in (("greedy", GREEDY), ("sampled", SAMPLED)):
                rep, toks = captured_vs_eager(eng, prompt, N_NEW, f"int{bits} {mode_label}, "
                                              f"{BATCH} x {PROMPT}", **mode)
                cases.append(rep)
                if greedy_toks is None:
                    greedy_toks = toks
            check(not torch.equal(toks, greedy_toks), f"int{bits}: sampled tokens equal the "
                  "greedy ones: nothing was sampled")
        rep, _ = captured_vs_eager(long_eng, long_prompt, LONG_NEW,
                                   f"int8 greedy, 1 x {LONG_PROMPT}", **GREEDY)
        cases.append(rep)
    for rep in cases:
        print(json.dumps({"check": "captured generate vs eager loop", **rep}))
    print(json.dumps(stale_graph_check(cfg, eng8, prompt)))
    with torch.inference_mode():
        timed = {"int8": timing_pairs(eng8, prompt, N_NEW, f"int8, {BATCH} x {PROMPT}"),
                 "long": timing_pairs(long_eng, long_prompt, LONG_NEW, f"int8, 1 x {LONG_PROMPT}")}
        for timing in timed.values():
            print(json.dumps(timing))

        def replays(eng, prompt, mode, n):
            b = prompt.shape[0]
            step = eng.step(b, greedy=mode["greedy"], top_k=mode.get("top_k", 0))

            def setup():
                eng.state(b).start(eng.params, eng.cfg, prompt, mode.get("key"),
                                   mode.get("temperature", 1.0), greedy=mode["greedy"],
                                   top_k=mode.get("top_k", 0))

            def run():
                for _ in range(n):
                    step()
            return setup, run

        segments = [(f"{name} call", None, fn) for name, fn in one_calls.items()]
        steps = {"int8 greedy step": (eng8, prompt, GREEDY, 1),
                 "int8 sampled step": (eng8, prompt, SAMPLED, 1),
                 "long greedy step": (long_eng, long_prompt, GREEDY, 1)}
        segments += [(label, *replays(*args)) for label, args in steps.items()]
        # The main paths' generations, counted: the steps they replay are
        # captured already (``replays`` above, and int4's here).
        eng4.step(BATCH, greedy=True, top_k=0)
        seen = []  # the dtype of each q the long prefill's attention saw

        def noting_dtype(q, k, v, **kw):
            seen.append(q.dtype)
            return flash_attention_gqa(q, k, v, **kw)

        def long_generation():
            with attention_through(noting_dtype):
                return long_eng.generate(long_prompt, LONG_NEW)

        counted = {label: {} for label in paths}
        for label, gen_fn in (("int8", lambda: eng8.generate(prompt, N_NEW)),
                              ("int4", lambda: eng4.generate(prompt, N_NEW_INT4)),
                              ("long", long_generation)):
            segments.append((f"{label} generate, counted", None,
                             counted_generation(paths[label][0], gen_fn, counted[label])))
        traced = tracing.trace_windows(segments + list(extra), TRACE)
    one_call_check(traced, one_calls)
    per_step = len(LINEARS) * cfg.n_layers
    for label, (_, toks, n_new) in paths.items():
        want = dict.fromkeys(KERNEL_TAGS, 0)
        want["pim_matvec"] = per_step * (n_new - 1)
        want["flash_attention"] = cfg.n_layers if label == "long" else 0
        print(json.dumps(check_counted(f"{label} generate, counted",
                                       traced[f"{label} generate, counted"],
                                       counted[label], toks, want)))
    check(seen == [torch.bfloat16] * cfg.n_layers, f"long-prompt attention saw q dtypes {seen}, "
          f"expected {cfg.n_layers} x bf16 (the tensor-core route)")
    per_replay = {}
    for label in ("int8 greedy step", "int8 sampled step", "long greedy step"):
        window = traced[label]
        kernels = traced_kernels(window)
        per_replay[label] = {"kernels": len(window.kernels), "pim_matvec": kernels["pim_matvec"],
                             "flash_attention": kernels["flash_attention"],
                             "host_ops": window.host_ops,
                             "device_busy_us": tracing.busy_us(window.device)}
        check(kernels["pim_matvec"] == per_step and kernels["flash_attention"] == 0
              and window.host_ops == 0,
              f"one replay of the {label}: {per_replay[label]}, expected {per_step} pim_matvec "
              "kernels, no flash_attention kernel and no host operator")
    busy = {}
    for label, path, key in (("int8 greedy step", "int8", "captured_ms"),
                             ("int8 sampled step", "int8", "captured_sampled_ms"),
                             ("long greedy step", "long", "captured_ms")):
        step_ms = timed[path]["medians"][key]
        busy[label] = {"device_busy_ms": per_replay[label]["device_busy_us"] / 1e3,
                       "step_ms": step_ms,
                       "device_busy_share": tracing.busy_share(traced[label], 1, step_ms * 1e3)}
    print(json.dumps({"check": "phase 8: the captured decode step", "per_replay_trace": per_replay,
                      "captured_launches": {label: [g.launches for g in graphs]
                                            for label, (graphs, _, _) in paths.items()},
                      "busy_share": busy}))
    return counted, traced


# ---- 9. continuous batching on the paged cache -------------------------------------
# (a): ten seeded requests over 4 slots of 16-token pages, 8 decode steps a
# round, the free list shuffled from SEED; prompts of 17-300 tokens (no page
# multiple), 8-64 new tokens; two requests stop at a token first emitted
# mid-chunk in their solo run.
SERVE = dict(slots=4, page_size=16, chunk=8, max_seq=512, page_alloc_seed=SEED)
SERVE_REQUESTS, SERVE_PROMPTS, SERVE_NEW, SERVE_STOPPED = 10, (17, 300), (8, 64), 2
SERVE_ROUNDS = 3  # alternating rounds of (e): captured, then eager
# (d): the long prompt of phase 7 admitted beside a short one.
LONG_SERVE = dict(slots=2, page_size=16, chunk=8, max_seq=LONG_PROMPT + LONG_NEW)
LONG_SERVE_SHORT = 200
# Paged against dense at full width, bf16: both paths round every linear's
# output to bf16, but the admit prefills the page-padded prompt (a longer
# matmul than the dense prefill's), a chunk step runs pim_matvec at M = 4
# slots where a solo run has M = 1, and the paged attention contracts over
# the gathered pages: the logits differ by about a bf16 ulp.  A request may
# first diverge from its solo dense run only where the dense run's top-2
# logit gap (gumbel + warped logits when sampled, over the temperature) is
# within PAGED_BAR: two bf16 ulps of the top logits here (which lie in
# [4, 8) on the seeded weights, ulp 2^-5).  On the H100 the sound serves
# diverged at gaps of at most 0.03125 (one ulp), and the planted fault of
# (f) at gaps of 0.03125 to 0.28125, six of its nine above this bar (a bar
# of 0.25 would flag one).
PAGED_BAR = 2 ** -4


class TimedEngine(ContinuousBatchingEngine):
    """The engine with a CUDA event pair around each round's chunk steps
    (``spans``): from the round's first step to its last, on the device; and
    the host time of its admits (``admit_s``; an admit ends reading its
    first token, so its device work is done)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.spans, self.admit_s = [], 0.0

    def _admit(self, *args, **kw):
        t0 = time.perf_counter()
        info = super()._admit(*args, **kw)
        self.admit_s += time.perf_counter() - t0
        return info

    def _load(self):
        super()._load()
        self.spans.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
        self.spans[-1][0].record()

    def _read(self):
        self.spans[-1][1].record()
        return super()._read()

    def timed_serve(self, requests, **mode):
        """``serve`` on the host clock: (outputs, wall s, device ms of the
        chunk steps, chunk iterations, rounds, emitted tokens)."""
        self.spans, self.admit_s = [], 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.serve(requests, **mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, {"wall_s": wall, "steps_ms": sum(a.elapsed_time(b) for a, b in self.spans),
                     "admit_s": self.admit_s, "iters": self.decode_chunk_iters,
                     "rounds": len(self.spans), "tokens": sum(len(o) for o in out)}


class EagerEngine(TimedEngine):
    """The same engine with its chunk step run eagerly (no graph): the
    reference the captured serve is held against, bit for bit."""

    def chunk_step(self, n_stops, *, greedy, top_k):
        st = self._state
        return functools.partial(decode_chunk_step, self.params, self.cfg, st, st.stops(n_stops),
                                 greedy=bool(greedy), top_k=0 if greedy else int(top_k),
                                 pad_id=self.pad_id)


@contextlib.contextmanager
def mask_off_by_one():
    """The planted fault of (f): every decode attention masks the keys past
    pos - 1, hiding each new token's own key."""
    prev = attention.decode_attention
    attention.decode_attention = lambda q, ck, cv, pos: prev(q, ck, cv, pos - 1)
    try:
        yield
    finally:
        attention.decode_attention = prev


def timing_row(t):
    """A timed serve's numbers: chunk step ms an iteration (device, CUDA
    events), emitted tokens/s (host clock), host ms a round outside the
    chunk steps (admits, top-up, copies, read-back) and of that the admits'."""
    return {"step_ms_per_iter": t["steps_ms"] / t["iters"],
            "tokens_per_s": t["tokens"] / t["wall_s"],
            "host_ms_per_round_outside_steps": (t["wall_s"] * 1e3 - t["steps_ms"]) / t["rounds"],
            "admit_ms_per_round": t["admit_s"] * 1e3 / t["rounds"],
            "wall_s": t["wall_s"], "rounds": t["rounds"], "iters": t["iters"],
            "tokens": t["tokens"]}


def events_of(report):
    """Each request's events without their times: what the scheduler did."""
    return [[{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in rec.events]
            for rec in report.records]


def top2_gap(values) -> float:
    top = torch.topk(values.float(), 2).values
    return (top[0] - top[1]).item()


def expected_length(dense, budget, stops):
    """The length of a request's output given its solo dense tokens: through
    the first stop token, else its budget."""
    hits = [j for j, t in enumerate(dense[:budget]) if int(t) in stops]
    return hits[0] + 1 if hits else budget


def divergences(got, dense, lengths, gap_at):
    """Each request's first divergence from its solo dense run's first
    ``lengths`` tokens: the token, and ``gap_at(r, j)``, the dense run's
    top-2 gap there; or, where every shared token agrees, the lengths when
    they differ."""
    out = []
    for r, (g, d, n) in enumerate(zip(got, dense, lengths)):
        d = np.asarray(d[:n])
        m = min(len(g), len(d))
        diff = np.flatnonzero(g[:m] != d[:m])
        if diff.size:
            j = int(diff[0])
            out.append({"request": r, "token": j, "dense_top2_gap": gap_at(r, j)})
        elif len(g) != len(d):
            out.append({"request": r, "emitted": len(g), "dense_length": len(d)})
    return out


def beyond(div, bar) -> bool:
    """Whether a divergence fails the margin-aware comparison at ``bar``."""
    return "dense_top2_gap" not in div or div["dense_top2_gap"] > bar


def paged_vs_dense(label, got, dense, lengths, gap_at, bar):
    """Each request's tokens against its solo dense run's: the first
    divergence, if any, only where the dense run's top-2 gap is within
    ``bar``; with none, the lengths agree.  Returns the report."""
    diverged = divergences(got, dense, lengths, gap_at)
    for div in diverged:
        check(not beyond(div, bar), f"{label}: request {div['request']} diverges from its "
              f"dense run beyond the bar {bar}: {div}")
    return {"check": f"{label}: paged serve vs solo dense generate", "requests": len(got),
            "diverged": len(diverged), "divergences": diverged, "bar": bar}


def largest_gap(rep, scale=1.0) -> float:
    """The largest dense top-2 gap (times ``scale``) at which a sound serve
    diverged; 0 where none did."""
    return max((d["dense_top2_gap"] * scale for d in rep["divergences"]), default=0.0)


class ServingPhase:
    """Phase 9: ``ContinuousBatchingEngine.serve`` at full width, (a) to (f) of
    the module's docstring.  ``run`` does everything but the counting, and
    returns the windows phase 8's profiler session traces; ``finish`` reads
    them."""

    def __init__(self, cfg, eng8, long_eng, long_prompt, long_toks, gen):
        self.cfg, self.dev, self.gen = cfg, gen.device, gen
        self.params = eng8.params  # int8 weights, shared with the dense engine
        self.long_eng, self.long_prompt, self.long_toks = long_eng, long_prompt, long_toks
        self.solo = ServingEngine(cfg, self.params, max_seq=SERVE["max_seq"], device=self.dev)

    def _dense(self, prompt, n, mode=GREEDY):
        toks = self.solo.generate(torch.from_numpy(prompt)[None].to(self.dev), n, **mode)
        return toks[0].cpu().numpy()

    def _gap(self, eng, prompt, j, mode=GREEDY):
        """The top-2 gap of the values that chose token j of ``eng``'s run of
        ``prompt`` (batch row 0): logits, or gumbel + warped logits."""
        eng.generate(prompt, j + 1, **mode)
        logits = eng.state(1).logits[0:1].float()
        if mode["greedy"]:
            return top2_gap(logits[0])
        keys = draw_keys(prng_key(mode["key"], self.dev), torch.tensor([0], device=self.dev), j,
                         TAG_TOKEN)
        lg = warp_logits(logits, mode["temperature"], mode["top_k"])
        return top2_gap((lg + gumbel(keys, lg.shape[-1]))[0])

    def _trace(self):
        gen, cfg = self.gen, self.cfg
        lens = torch.randint(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1, (SERVE_REQUESTS,),
                             generator=gen, device=self.dev).tolist()
        lens = [n + 1 if n % SERVE["page_size"] == 0 else n for n in lens]
        news = torch.randint(SERVE_NEW[0], SERVE_NEW[1] + 1, (SERVE_REQUESTS,), generator=gen,
                             device=self.dev).tolist()
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen, device=self.dev)
                   .cpu().numpy().astype(np.int32) for n in lens]
        return prompts, news

    def run(self):
        cfg, dev, chunk = self.cfg, self.dev, SERVE["chunk"]
        report = {"check": "phase 9: ContinuousBatchingEngine.serve, qwen2-1.5b int8"}
        prompts, news = self._trace()
        with torch.inference_mode():
            dense = [self._dense(p, n) for p, n in zip(prompts, news)]
        # two requests stop at a token first emitted mid-chunk in their solo run
        stops = [()] * SERVE_REQUESTS
        for r, d in enumerate(dense):
            firsts = [j for j in range(1, len(d)) if int(d[j]) not in d[:j].tolist()
                      and (j - 1) % chunk != chunk - 1]
            if firsts and sum(map(bool, stops)) < SERVE_STOPPED:
                stops[r] = (int(d[firsts[0]]),)
        check(sum(map(bool, stops)) == SERVE_STOPPED, f"only {sum(map(bool, stops))} solo runs "
              "emit a token mid-chunk that they did not emit before: no stop tokens to plant")
        reqs = [Request(prompt=p, max_new=n, stop_tokens=s)
                for p, n, s in zip(prompts, news, stops)]
        self.reqs = reqs
        report["trace"] = {"prompt_lengths": [len(p) for p in prompts], "max_new": news,
                           "stops": {r: s[0] for r, s in enumerate(stops) if s}}
        lengths = [expected_length(d, n, s) for d, n, s in zip(dense, news, stops)]

        # (a) captured equals eager, paged matches dense, pool invariants
        self.eng = eng = TimedEngine(cfg, self.params, device=dev, **SERVE)
        self.graphs = count_captures(eng)
        eager = EagerEngine(cfg, self.params, device=dev, **SERVE)
        self.out = eng.serve(reqs)  # warm-up: kernel loads, the chunk step's capture
        rep_c = eng.last_report
        out_e = eager.serve(reqs)
        rep_e = eager.last_report
        same = {"tokens_equal": same_tokens(self.out, out_e),
                "events_equal": events_of(rep_c) == events_of(rep_e),
                "peak_pages": [eng.peak_pages_in_use, eager.peak_pages_in_use],
                "preemptions": [eng.preemptions, eager.preemptions],
                "rounds": rep_c.rounds, "decode_chunk_iters": eng.decode_chunk_iters,
                "tokens": sum(len(o) for o in self.out)}
        report["captured_vs_eager"] = same
        check(same["tokens_equal"] and same["events_equal"]
              and eng.peak_pages_in_use == eager.peak_pages_in_use,
              f"(a) the captured serve differs from the eager one: {same}")
        for e in (eng, eager):
            e.assert_quiescent()
            check(e.pages_in_use() == 0, f"(a) {e.pages_in_use()} pages in use after the serve")
        check([len(o) for o in self.out] == lengths, f"(a) output lengths "
              f"{[len(o) for o in self.out]}, the dense runs and stops give {lengths}")
        with torch.inference_mode():
            report["paged_vs_dense"] = paged_vs_dense(
                "(a) greedy", self.out, dense, lengths,
                lambda r, j: self._gap(self.solo, torch.from_numpy(prompts[r])[None].to(dev), j),
                PAGED_BAR)

        # (e) times: alternating rounds of the captured and the eager serve
        rounds = []
        for _ in range(SERVE_ROUNDS):
            row = {}
            for name, e in (("captured", eng), ("eager", eager)):
                out, t = e.timed_serve(reqs)
                check(same_tokens(out, self.out), f"(e) a {name} serve's tokens changed")
                row[name] = timing_row(t)
            row["sm_clock_mhz"] = tracing.sm_clock_mhz()
            rounds.append(row)
        report["timing_rounds"] = rounds
        report["timing_medians"] = {
            name: {k: sorted(r[name][k] for r in rounds)[len(rounds) // 2]
                   for k in ("step_ms_per_iter", "tokens_per_s", "host_ms_per_round_outside_steps",
                             "admit_ms_per_round")}
            for name in ("captured", "eager")}
        report["timing_medians"]["captured_over_eager_step"] = (
            report["timing_medians"]["captured"]["step_ms_per_iter"]
            / report["timing_medians"]["eager"]["step_ms_per_iter"])

        # (b) preemption: a pool too small for the trace's peak
        need = max(-(-(len(p) + n) // SERVE["page_size"]) for p, n in zip(prompts, news))
        small = max(need + 2, eng.peak_pages_in_use // 2)
        pre = ContinuousBatchingEngine(cfg, self.params, device=dev,
                                       **{**SERVE, "num_pages": small})
        out_b = pre.serve(reqs)
        report["preemption"] = {"num_pages": small, "peak_pages_a": eng.peak_pages_in_use,
                                "preemptions": pre.preemptions,
                                "tokens_equal_a": same_tokens(out_b, self.out)}
        check(pre.preemptions > 0, f"(b) no preemption with {small} pages")
        check(report["preemption"]["tokens_equal_a"],
              f"(b) preempted tokens differ from (a)'s: {report['preemption']}")
        pre.assert_quiescent()
        del pre

        # (c) sampled: independent of the chunk; request 0 (rid 0) as the dense row 0
        out_c = eng.serve(reqs, **SAMPLED)
        other = ContinuousBatchingEngine(cfg, self.params, device=dev, **{**SERVE, "chunk": 3})
        out_c3 = other.serve(reqs, **SAMPLED)
        check(same_tokens(out_c, out_c3), "(c) the sampled serve depends on the chunk")
        check(not same_tokens(out_c, self.out), "(c) sampled tokens equal greedy ones")
        del other
        with torch.inference_mode():
            d0 = self._dense(prompts[0], news[0], SAMPLED)
            report["sampled"] = {"chunk_3_equal": True, **paged_vs_dense(
                "(c) sampled, request 0", out_c[:1], [d0],
                [expected_length(d0, news[0], stops[0])],
                lambda r, j: self._gap(self.solo, torch.from_numpy(prompts[0])[None].to(dev), j,
                                       SAMPLED), PAGED_BAR / SAMPLED["temperature"])}

        # (f) the planted fault: the eager serve with the mask off by one,
        # held against the captured serve and against the dense runs
        with mask_off_by_one():
            out_f = eager.serve(reqs)
        caught = not same_tokens(out_f, self.out)
        with torch.inference_mode():
            faulted = divergences(
                out_f, dense, lengths,
                lambda r, j: self._gap(self.solo, torch.from_numpy(prompts[r])[None].to(dev), j))
        gaps = sorted(d["dense_top2_gap"] for d in faulted if "dense_top2_gap" in d)
        flagged = sum(beyond(d, PAGED_BAR) for d in faulted)
        report["planted_fault"] = {
            "fault": "decode attention masks keys past pos - 1",
            "caught_by_captured_vs_eager": caught,
            "requests_changed": sum(not np.array_equal(a, b) for a, b in zip(out_f, self.out)),
            "paged_vs_dense": {"diverged": len(faulted), "beyond_bar": flagged,
                               "bar": PAGED_BAR, "dense_top2_gaps": gaps,
                               "divergences": faulted}}
        print("phase 9 (f) planted fault: " + json.dumps(report["planted_fault"]), flush=True)
        check(caught, "(f) the planted fault (mask off by one) went unnoticed by captured vs eager")
        check(flagged > 0, f"(f) the faulted serve passes paged vs dense at the bar {PAGED_BAR}: "
              f"{report['planted_fault']['paged_vs_dense']}")
        del eager

        # (d) the long admit beside a short one
        short = torch.randint(0, cfg.vocab, (LONG_SERVE_SHORT,), generator=self.gen,
                              device=dev).cpu().numpy().astype(np.int32)
        self.long_reqs = [Request(prompt=self.long_prompt[0].cpu().numpy().astype(np.int32),
                                  max_new=LONG_NEW),
                          Request(prompt=short, max_new=LONG_NEW)]
        self.long_serve = TimedEngine(cfg, self.long_eng.params, device=dev, **LONG_SERVE)
        self.long_graphs = count_captures(self.long_serve)
        self.long_out = self.long_serve.serve(self.long_reqs)  # warm-up and capture
        out, t = self.long_serve.timed_serve(self.long_reqs)
        check(same_tokens(out, self.long_out), "(d) a second long serve's tokens changed")
        report["long"] = timing_row(t)
        self.long_serve.assert_quiescent()
        with torch.inference_mode():
            dense_short = self._dense(short, LONG_NEW)
            report["long"].update(paged_vs_dense(
                "(d) long admit", self.long_out,
                [self.long_toks[0].cpu().numpy(), dense_short], [LONG_NEW, LONG_NEW],
                lambda r, j: self._gap(self.long_eng, self.long_prompt, j) if r == 0 else
                self._gap(self.solo, torch.from_numpy(short)[None].to(dev), j), PAGED_BAR))
        sound = max(largest_gap(report["paged_vs_dense"]),
                    largest_gap(report["sampled"], SAMPLED["temperature"]),
                    largest_gap(report["long"]))
        report["bar"] = {"bar": PAGED_BAR, "sound_largest_gap": sound,
                         "fault_smallest_gap": gaps[0] if gaps else None,
                         "fault_beyond_bar": flagged,
                         "fault_diverged": len(report["planted_fault"]["paged_vs_dense"]
                                               ["divergences"])}
        print("phase 9 bar: " + json.dumps(report["bar"]), flush=True)
        self.report = report
        return self.windows()

    def windows(self):
        """Phase 8's session traces: the counted serves of (a) and (d), one
        paged chunk step at 4 slots, and the dense captured step at the same
        4 rows over the same 512 positions."""
        eng, n_stops = self.eng, max(len(r.stop_tokens) for r in self.reqs)
        self.counted = {"serve": {}, "long serve": {}}
        self.seen = []

        def noting_dtype(q, k, v, **kw):
            self.seen.append(q.dtype)
            return flash_attention_gqa(q, k, v, **kw)

        def serve_a():
            out = eng.serve(self.reqs)
            self.counted["serve"]["iters"] = eng.decode_chunk_iters
            return out

        def serve_d():
            with attention_through(noting_dtype):
                out = self.long_serve.serve(self.long_reqs)
            self.counted["long serve"]["iters"] = self.long_serve.decode_chunk_iters
            return out

        paged_step = eng.chunk_step(n_stops, greedy=True, top_k=0)
        dense_step = self.solo.step(SERVE["slots"], greedy=True, top_k=0)
        rows = torch.randint(0, self.cfg.vocab, (SERVE["slots"], PROMPT), generator=self.gen,
                             device=self.dev)

        def paged_setup():
            eng._reset(self.reqs, n_stops)

        def dense_setup():
            with torch.inference_mode():
                self.solo.state(SERVE["slots"]).start(self.params, self.cfg, rows, None, 1.0,
                                                      greedy=True, top_k=0)
        return [("serve, counted", None, counted_generation(self.graphs, serve_a,
                                                            self.counted["serve"])),
                ("long serve, counted", None, counted_generation(self.long_graphs, serve_d,
                                                                 self.counted["long serve"])),
                ("paged chunk step", paged_setup, paged_step),
                ("dense step, 4 rows", dense_setup, dense_step)]

    def finish(self, traced):
        """Phase 9's launches from the trace, and its report."""
        per_step = len(LINEARS) * self.cfg.n_layers
        launches = {}
        for label, toks, flash in (("serve", self.out, 0),
                                   ("long serve", self.long_out, self.cfg.n_layers)):
            out = self.counted[label]
            want = dict.fromkeys(KERNEL_TAGS, 0)
            want["pim_matvec"] = per_step * out["iters"]
            want["flash_attention"] = flash
            launches[label] = check_counted(f"{label}, counted", traced[f"{label}, counted"],
                                            out, toks, want)
            launches[label]["decode_chunk_iters"] = out["iters"]
        check(self.seen == [torch.bfloat16] * self.cfg.n_layers, f"the long admit's attention "
              f"saw q dtypes {self.seen}, expected {self.cfg.n_layers} x bf16")
        steps = {}
        for label in ("paged chunk step", "dense step, 4 rows"):
            window = traced[label]
            kernels = traced_kernels(window)
            steps[label] = {"kernels": len(window.kernels), "pim_matvec": kernels["pim_matvec"],
                            "host_ops": window.host_ops,
                            "device_busy_us": tracing.busy_us(window.device)}
            check(kernels["pim_matvec"] == per_step and window.host_ops == 0,
                  f"one replay of the {label}: {steps[label]}")
        steps["paged_minus_dense_us"] = (steps["paged chunk step"]["device_busy_us"]
                                         - steps["dense step, 4 rows"]["device_busy_us"])
        self.report["launches"] = launches
        self.report["one_step_trace"] = steps
        print(json.dumps(self.report))
        return {label: out["traced"] for label, out in self.counted.items()}


if __name__ == "__main__":
    sys.exit(main())

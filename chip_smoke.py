#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card and check its kernels.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Nine paths run, at qwen2-1.5b's full width (28 layers, bf16, random
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
  each chunk step and each admit one replay of a captured CUDA graph, a
  prompt past 8,192 tokens admitted eagerly through ``flash_attention``;
* the prefix cache: the same engine with ``prefix_cache=True`` on requests
  that share prompt prefixes, a hit's tail one verify window (through
  ``pim_matvec`` when it is one row a slot);
* the resilience tier: ``serve_detailed`` under a ``ResiliencePolicy`` with
  seeded fault injection, crash replay by the ``ServingSupervisor`` (a
  resumed admit is the same captured admit, or past 8,192 positions the
  eager one through ``flash_attention``), and the ``ReplicaRouter``;
* n-gram speculative decoding on both engines (``speculate=SpecConfig``):
  each verify window one replay of a captured program, windows of at most
  8 rows (one row a slot and k + 1 positions) through ``pim_matvec``, wider
  ones through ``x @ dq(w)``, the adaptive controller's width-0 rounds the
  plain captured chunk step;
* tree drafts on both engines (``SpecConfig(tree_fan=F)``): F n-gram
  chains verified in one window under a shared-prefix mask, the kept
  chain's K/V relocated to the linear columns inside the same captured
  program, on a dense store and through the block tables of a paged one.

Then the rest of the dense family, llama3.2-3b, starcoder2-7b and
starcoder2-15b, each at its full width (and depth, but starcoder2-15b at
20 of its 40 layers) through the same decoding path, and the int8 KV cache on qwen2-1.5b's serving path; then
the vlm and encdec families, seamless-m4t-medium (a non-causal encoder, a
decoder that cross-attends to its output) at full width and depth and
llama-3.2-vision-90b (groups of four dense blocks and a gated
cross-attention block over image embeds) at full width and 4 of its 20
groups (16 before phase 18, 8 before phase 19), through both engines with
per-request extras; then the moe family: moonshot-v1-16b-a3b (GQA
attention) at full width and 8 of its 48 layers, and deepseek-v2-lite-16b
(MLA attention over a latent cache, absorbed decode and verify windows) at
full width and 10 of its 27 layers (all 27 before phase 20), through both
engines, speculation included;
then the ssm family: falcon-mamba-7b (Mamba1 blocks with per-row recurrent
state, no attention) at full width and all 64 layers, through both engines,
speculation included.

Besides, the paper's own machine runs at the paper's array sizes (no
model): PiCaSO's bit-serial PE array (``repro_torch.core``), the Alveo
U55's 64,512 PEs, the Virtex-7 485's 32,768 as one dot-product row, and the
paper's tables.

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
   (``repro_torch.tracing``, which reads the session's events from the
   profiler's results, no Chrome trace) traces one replay of each captured step:
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
9. continuous batching (run after phase 7; its counted long serve and two
   traced steps are windows of phase 8's profiler session, read after
   it): (a) a staggered trace of
   ten seeded requests (prompts of 17-300 tokens, no page multiple; 8-64
   new tokens; two stop at a token first emitted mid-chunk in their solo
   run) on 4 slots of 16-token pages, chunk 8, 512 positions, int8 weights,
   a shuffled pool: the captured serve (every chunk step and every admit
   one graph replay) ``torch.equal`` to the same serve with the chunk step
   and the admits run eagerly (``EagerEngine``: tokens, events, peak
   pages), the pool quiescent and empty after it; for three padded lengths
   of the trace, greedy and sampled, one captured admit against
   ``admit_prefill`` on the same inputs (token and the pool pages it
   wrote, ``torch.equal``); each request's tokens
   against its solo batch-1 ``ServingEngine.generate`` with a first
   divergence only where the dense top-2 logit gap is within PAGED_BAR, and
   the counted serve's ``pim_matvec`` launches by the counters (capture x
   replays) 196 x ``decode_chunk_iters``, its tokens (a)'s; (b) the same trace on a pool small enough that ``_top_up``
   preempts: preemptions, and tokens ``torch.equal`` to (a)'s; (c) sampled
   (SAMPLED): the same tokens at chunk 3 as at chunk 8, request 0 against
   the dense engine's sampled row 0 within PAGED_BAR over the temperature;
   (d) phase 7's long prompt beside a short one on 2 slots: exactly 28
   ``flash_attention`` launches, all on a bf16 q, at the long admit (the
   counted serve traced, the counters' account equal to the trace), and
   tokens against phase 7's dense long path (margin-aware; that admit,
   past CHUNKED_THRESHOLD, runs eagerly); (e) in SERVE_ROUNDS alternating
   rounds of the captured and the eager serve: chunk step ms an iteration
   (CUDA events), emitted tokens/s, host ms a round outside the chunk
   steps and of it the admits', admit ms by padded length, captured and
   eager, and the graphs captured and kept and what their captures cost;
   one traced replay
   of the paged chunk step against the dense captured step at the same 4
   rows and 512 positions (their device time differs by the gathers and
   scatters); (f) a planted fault, the decode attention's mask off by one,
   must change (a)'s eager serve and fail the comparison with the dense
   runs at PAGED_BAR (the sound runs' largest gap and the fault's gaps are
   printed beside the bar).
10. the shared-prefix serve (its counted serve read by the counters, outside
   phase 8's profiler session): ``prefix_cache=True`` on 12 seeded
   requests (PREFIX_TRACE: 8 share a 512-token system prompt, each with a
   tail of its own; 2 repeat one page-aligned 256-token prompt, so the
   second is a full hit and forks its last page copy-on-write; 2 unrelated)
   on 4 slots of 16-token pages, chunk 8, 1,024 positions, int8 weights, a
   shuffled pool: (a) the captured serve ``torch.equal`` to the eager one
   (tokens, events with their cached and prefilled tokens and forks, round
   counters, peak pages, hits, forks); (b) against the same trace served
   with ``prefix_cache=False``, request by request, a first divergence only
   where the uncached run's top-2 gap (a dense prefill of the prompt and
   its tokens so far) is within HIT_BAR (LOGIT_TOL: a hit's window keeps
   f32 attention scores, a miss's prefill rounds them to bf16; the count
   beyond PAGED_BAR is reported beside it); hits, hit tokens and forks as
   the trace's structure dictates, prefilled tokens the uncached count less
   the hit tokens; (c) the same sampled (SAMPLED), at HIT_BAR over the
   temperature, where a choice's margin is the least of the top-2 gap of
   gumbel + warped logits and the top-k cut's margins (``_gap``); (d) on a
   pool of PREFIX_SMALL_POOL pages: retained pages evicted, slots
   preempted, the pool quiescent after, tokens against (b)'s uncached ones
   at HIT_BAR; (e) a planted fault, the tail window run with every slot's
   block-table row in place (the other rows' window writes land in live
   pages), must fail (b)'s or (c)'s comparison, and its hits must write
   bytes of another live slot's pages where the sound engine's never do;
   (f) in PREFIX_ROUNDS alternating rounds of the cached and the uncached
   captured serve: tokens/s, host ms a round outside the chunk steps, hit
   and miss admit ms; (g) the counted serve's ``pim_matvec`` launches by the
   counters 196 x (chunk iterations + full-hit windows), whose 4 rows go
   through it, its tokens (a)'s;
   (h) for three hits, the first token's logits through the tail window,
   through the request's own miss prefill and through a prefill with f32
   activations: their largest and RMS differences (the window's top 8
   within HIT_BAR of the f32 prefill's).
11. the resilience tier on phase 9's engine and trace (its counted serve read
   by the counters, outside phase 8's profiler session): (a) a default ``ResiliencePolicy``
   and no chaos gives the no-policy serve (tokens ``torch.equal``; events
   with their times and round counters equal under a ``VirtualClock``);
   (b) scripted chunk faults, stragglers and squeezes, greedy (CHAOS_SCRIPTED),
   then all of them at rates, sampled (CHAOS_COMBINED): every request done
   and ``torch.equal`` to the undisturbed serve, each injected kind fired,
   retries, squeezed pages and injected latency equal to the injector's
   log; (c) stragglers lift the degradation ladder to ``halve_chunk`` and
   it recovers: tokens ``torch.equal``, the chunk iterations the rounds'
   halved and full chunks; (d) ``ServingSupervisor`` crash replay at
   CRASH_ROUNDS, greedy and sampled: ``resume_mode="recompute"``
   ``torch.equal``, ``"prefill"`` margin-aware at HIT_BAR (a resumed admit
   prefills, with bf16 attention scores, tokens the undisturbed run
   decoded with f32 ones; the count beyond PAGED_BAR beside it), restarts
   equal to the scripted crashes, every ``FailureEvent`` an injected crash;
   (e) a crash with no restart, then a fresh engine (its own graphs, the
   same parameters) resumed from the snapshot file, at the bar of (d);
   (f) a crash during phase 9(d)'s long serve: the resumed long admit
   launches exactly 28 ``flash_attention`` kernels, tokens at HIT_BAR;
   (g) ``ReplicaRouter`` over two engines on phase 10's trace: assignments
   equal ``route``'s, tokens against the solo engine at HIT_BAR with the
   prefix cache on and ``torch.equal`` with it off; (h) a planted fault, a
   resumed admit's draw counter one short, must fail (d)'s sampled check;
   (i) in RESILIENCE_ROUNDS alternating rounds, host ms a round and tokens/s
   with no policy, with per-round snapshots in memory and to disk (fsync),
   and sampled undisturbed against combined chaos; the crash's recovery
   cost (resumed admits' ms, extra prefill tokens); the counted ladder
   serve's ``pim_matvec`` launches by the counters 196 x
   ``decode_chunk_iters``, halved rounds included, its tokens phase 9's.
12. n-gram speculative decoding at k = SPEC_K (after phase 11; its launches
   come from the counters: each captured window's launches read around its
   capture, times its replays): (a) the fixed engine on phase 3's 4 x 128
   prompts, 32 new tokens: greedy, sampled exact (SAMPLED), typical and
   adaptive greedy windows (20 rows, through ``x @ dq(w)``: no
   ``pim_matvec`` launch), each ``torch.equal`` to the same generation
   with every window run eagerly (tokens, windows), greedy ones
   against plain greedy decoding of the same batch at HIT_BAR (a window's
   logits are another bf16 arithmetic than a decode step's: the count
   beyond PAGED_BAR beside it); batch 1 (5-row windows): ``pim_matvec``
   launched 196 x windows, and whether its tokens equal plain batch-1
   decoding; (b) the continuous engine on phase 9's engine geometry and
   trace, greedy and sampled, then the adaptive controller from an
   optimistic start (SPEC_ADAPTIVE; its rounds' widths; ``pim_matvec``
   launched 196 x the iterations of its width-0 and 8-row rounds), then
   phase 10's trace with ``prefix_cache=True``: each
   captured serve ``torch.equal`` to the eager one (tokens, events, peak
   pages; the eager twins serve each trace's first 4 requests at
   SPEC_EAGER_NEW new tokens), greedy ones against phase 9's solo dense
   runs at HIT_BAR;
   CHAOS_SCRIPTED's transient faults with the ladder off ``torch.equal``
   to the undisturbed serve, stragglers lifting the ladder through
   ``halve_k`` and ``no_spec``, and a supervisor's recompute crash replay
   ``torch.equal``; (c) a planted fault, greedy acceptance taking one
   proposal more than matched, must fail the comparison with plain greedy
   decoding at HIT_BAR; (d) window ms at each width and plain step ms at 4
   rows and 1 (CUDA events over replays, alternating rounds), and in
   alternating rounds phase 9's plain serve against the speculative and
   adaptive serves, greedy and sampled: tokens/s, chunk-iteration ms,
   emitted tokens an iteration; graphs captured and their capture cost.
13. draft-model speculation at k = SPEC_K (after phase 12; counters, not the
   profiler), the draft qwen2-1.5b itself: the target's int8 tree (a
   self-draft) or the same weights' int4 tree.  (a) the fixed engine at
   1 x 128, 32 new, int8 self-draft, greedy, window by window: every
   window accepts all it may, or each rejection sits where the plain
   run's top-2 gap is within PAGED_BAR (their count reported), tokens
   ``torch.equal`` to plain batch-1 decoding, ``pim_matvec`` launched
   196 x (k + 2) a window (k + 1 one-row draft steps and the 5-row
   verify); (b) phase 3's 4 x 128 prompts, 32 new: int8 self-draft and
   int4 draft, greedy and sampled, the int4 sampled run ``torch.equal``
   to an eager loop of windows (at 16 new), greedy ones against plain
   greedy decoding at HIT_BAR (the count beyond PAGED_BAR beside it),
   acceptance,
   ``pim_matvec`` 196 x (k + 1) a window (the 4-row draft steps; the
   20-row verify runs ``x @ dq(w)``); (c) the continuous engine on phase
   9's engine geometry and trace with the int4 draft, greedy against
   phase 9's solo dense runs at HIT_BAR, ``pim_matvec`` 196 x (k + 1) an
   iteration; on the trace's first 4 requests at SPEC_EAGER_NEW new
   tokens: greedy captured ``torch.equal`` to eager, sampled, phase 9's
   small pool (preemption) ``torch.equal``, a recompute crash replay
   ``torch.equal``; ``prefix_cache=True`` serving no hit; (d) a planted fault,
   the draft chain one position off, must lower (a)'s acceptance; (e)
   device ms of a draft step (int8, int4; 1 and 4 rows), of windows at
   k = 1, 2, 4 (int4 draft, 4 rows) and of (a)'s window against the plain
   step, then (c)'s tokens/s against phase 9's plain serve, in alternating
   rounds.
14. tree drafts (after phase 13; counters, not the profiler): (a) the
   fixed engine at 1 x 128, 32 new, ``SpecConfig(k=3, tree_fan=2)`` (7-row
   windows), greedy: captured ``torch.equal`` to an eager loop of
   windows, tokens against plain batch-1 decoding (a divergence only at a
   plain top-2 gap within PAGED_BAR, the count reported), ``tree_fan=1``
   equal to linear k = 3, ``pim_matvec`` 196 a window; (b) planted chains:
   the prompt prefilled into a dense store and into a paged pool of
   8-token pages under a shuffled block table (the window's columns cross
   a page boundary), a fan-3 x depth-3 window whose chain 2 holds plain
   greedy decoding's next three tokens, ``greedy_tree_accept`` must keep
   chain 2 whole (or reject only at a plain gap within PAGED_BAR),
   ``tree_relocate``'s linear columns byte-equal to the tree columns they
   came from and every other column unchanged, then 8 decode steps on from
   the relocated cache within HIT_BAR of plain decoding (logits and
   tokens); a planted fault, the relocation's sources one column late,
   must fail both the byte check and the continuation; (c) phase 3's
   4 x 128 prompts, 32 new, ``SpecConfig(k=2, tree_fan=2)`` (20-row
   windows, no ``pim_matvec``): greedy against plain greedy decoding at
   HIT_BAR, sampled captured ``torch.equal`` to an eager loop of windows
   at 16 new, and the continuous engine on the same key: equal tokens, or
   a first divergence where the fixed engine's draw was a near-tie (its
   margin, the draw's top-2 gap or the top-k cut's as phase 10 takes it,
   within HIT_BAR over the temperature); (d) the continuous
   engine on phase 9's engine geometry and trace, greedy and sampled,
   captured ``torch.equal`` to eager on the trace's first 4 requests at
   SPEC_EAGER_NEW new tokens (tokens, events, peak pages), greedy
   against phase 9's solo dense runs at HIT_BAR, phase 9's small pool
   (preemption) ``torch.equal``, phase 10's repeated prompt with
   ``prefix_cache=True`` (one hit), a recompute crash replay
   ``torch.equal``; (e) device ms of the batch-1 tree window against the
   linear k = 3 window and the plain step, and of the batch-4 tree window
   against the linear k = 4 window and the plain step (CUDA events over
   replays, alternating rounds), then (d)'s tokens/s against phase 9's
   plain serve, acceptance, and the first timed tree serve's launches (0).
15. the PiCaSO machine (``repro_torch.core``) at the paper's array sizes,
   on inputs from ``np.random.default_rng(SEED + 5)``: (a) each bit-level
   function (``to_bits``/``from_bits``/``sign_extend_bits``, the Booth
   decoder and Op-Encoder, ``serial_alu``, ``booth_multiply_bits``,
   ``booth_nop_fraction``, ``fold_operand``/``fold_reduce_block``,
   ``network_reduce_bits`` at 2 to 2,048 blocks) on CUDA tensors
   ``torch.equal`` to the same function on the CPU; (b) the Alveo U55's
   whole array, ``PicasoArray(n_blocks=4032)`` (64,512 PEs, 1,024-bit
   register files): two sets of 8-bit operands, ``alu_op`` ADD and SUB,
   ``mult``, ``fold_accumulate`` at 20 bits, every PE against an int64
   oracle, each block's lane 0 ``torch.equal`` to ``fold_sum`` (the
   ``fold_reduce`` kernel, counted) over the same products in f32, the
   cycles against ``costmodel``; (c) the Virtex-7 485's whole array as one
   row, ``simulate_dot_product`` at q = 32,768 (2,048 blocks, 32-bit
   accumulator) against numpy's int64 dot product and
   ``mult_cycles_overlay(8) + accum_cycles_picaso(32768, 32)``; (d)
   ``simulate_matvec`` at 16 x 2,048 against ``W @ x`` and
   ``matvec_cycles``; (e) ``paper_tables.ALL`` on the card: every row's
   name and ``derived`` equal to the CPU run's; (f) a planted fault, one
   product bit of one PE flipped between ``mult`` and ``fold_accumulate``,
   caught by (b)'s oracle and by the ``fold_sum`` comparison; (g) ms of
   (b)'s ``mult`` and ``fold_accumulate``, of (c), and the tables'
   ``us_per_call`` (the cycle counts are the paper's model, not this
   card's).
16. the dense family (after phase 15): (h) phase 9's trace served greedy
   with ``kv_cache_bits=8``, captured ``torch.equal`` to ``EagerEngine`` on
   the trace's first 5 requests at SPEC_EAGER_NEW new tokens, the fifth
   admitted into a freed slot (the whole trace before phase 17),
   each request against the bf16-cache serve at HIT_BAR (the count beyond
   PAGED_BAR beside it), its launches counted (196 x chunk iterations), a
   4 x 128 int8-cache ``generate`` captured against eager, and the
   int8-cache step's ms beside the bf16 one's; then for each of FAMILY,
   one at a time, at full width and FAMILY_LAYERS deep, its weights drawn
   on the card layer by layer
   (``layerwise_params``) and quantized at int8, the bf16 tree dropped:
   (a) a captured ``generate`` on 4 x 128 prompts, 32 new, greedy and
   sampled, ``torch.equal`` to the eager loop of ``decode_and_emit``; (b)
   over (a)'s first FAMILY_CHECK_NEW greedy tokens, as (c), against the
   overlay path (``against_overlay``), margin-aware, the
   logits below what (c)'s planted fault does to them (FAMILY_F32_LAYERS'
   comment says why not LOGIT_TOL); (c) the f32 path at full width and
   FAMILY_F32_LAYERS layers against its plain twin within PATH_TOL, a
   planted fault (layer n/2's ``down`` loses its last K split) caught; (d)
   ``pim_matvec`` launches 7 x layers (+ 1 for an untied head) a step,
   from the counters, and each call's plan: an untied head on the
   kernel's chunked bf16 route; (e) captured ms a step (CUDA events,
   alternating rounds) beside the weight-stream floor and the SM clock,
   and the device ms of the step's ``pim_matvec`` calls alone;
   (f) ``pim_matvec`` against its plain version at each of the config's
   weight shapes and its (d, vocab) one, bits 8 and 4, M in {1, 4, 8},
   with a planted fault, the last x chunk of every CTA slice dropped; (g)
   ``flash_attention_gqa`` against plain at the config's (KV, G, 128),
   Sq = Sk of 2,048 and 1,000, and one layer's ``decode_attention`` over a
   4 x 2,048 cache against its f32 form; the peak memory of each config.
17. the vlm and encdec families (after phase 16), for each of CROSS, one at
   a time, its int8 tree drawn and quantized on the card one (K, N) slice
   at a time (``quantized_params``; the vlm at CROSS_VLM_GROUPS of its 20
   groups, its cross blocks' gates planted in CROSS_GATES), seeded extras
   (the vlm's image embeds, the encdec's frames through ``encode`` on the
   card): (a) a captured ``generate`` on 4 x 128 prompts, 32 new,
   greedy and sampled, ``torch.equal`` to the eager loop; (b) as phase 16 (b), over
   (a)'s first CROSS_CHECK_NEW greedy tokens, against the overlay path
   (the vlm's run eagerly: a captured overlay step would keep its
   dequantized head) within CROSS_OVERLAY_TOL, which a planted fault
   (CROSS_FAULT: the encdec's middle decoder block's ``down`` loses its
   last K split, the vlm's head its last chunk of K rows) must exceed; (c)
   the f32 path at full width and
   CROSS_F32's depth against its plain twin within PATH_TOL, with the
   planted fault of each row's extras rolled to the next row; (d)
   ``pim_matvec`` launches a step (529 for the vlm, 109 for the encdec:
   a cross block's K and V and the encoder see a row per key, ``x @
   dq(w)``), and none in the encoder pass or the cross K/V, by the
   counters; (e) the continuous engine (``prefix_cache=True``) on
   CROSS_TRACE over 2 slots: captured ``torch.equal`` to ``EagerEngine``
   on the trace's first CROSS_EAGER requests (the hit among them; the
   counted serve too), each miss ``torch.equal`` to itself served alone on
   the same geometry,
   each request against its solo ``generate`` margin-aware at the family's
   CROSS_SOLO_BARS (the encdec's PAGED_BAR, the hit HIT_BAR; the vlm's
   from its recorded sound divergences), one prefix hit under the same extras and
   none under other extras, launches per_step x (iterations + full hits)
   + 1 an uncached admit (its head unembeds one position);
   (f) planted faults on the same engines: a ``generate`` that leaves the
   static extras buffer as the previous call left it (``stale_extras``),
   and admits that write their extras into the next slot
   (``admits_into_next_slot``), each caught against the sound output of
   the same graphs; (g) captured ms a step beside
   the weight-stream floor, the cross K/V recomputation's and the step's
   ``pim_matvec`` calls' ms, the head's; (h) ``pim_matvec`` against plain
   at the config's shapes, (d, CROSS_SMALL_N) and the head's (d, vocab),
   with the head's last CROSS_TAIL columns checked alone and a planted
   fault (those columns zeroed) caught, and where the head is chunked the
   dropped-chunk fault; then speculation on the same int8 tree, every
   window at most 8 rows (``pim_matvec``): (i) the fixed engine at 1 x 128,
   CROSS_SPEC_NEW new, n-gram k = 4 (5-row windows), greedy and sampled,
   captured ``torch.equal`` to an eager loop of windows (over the first
   CROSS_SPEC_EAGER_NEW tokens, as in (k)), greedy against
   plain batch-1 decoding margin-aware at the family's CROSS_SPEC_BARS
   (the encdec's HIT_BAR, the count beyond PAGED_BAR beside it; the vlm's
   0.75), 529 / 109 ``pim_matvec`` a window by the counters (on the short
   captured run); (j) the int8 tree as its own draft at k = 4,
   window by window: every window accepts all it may, or each rejection
   sits at a plain top-2 gap within the bar; (k + 2) x 529 / 109 launches
   a window; (k) tree windows ``SpecConfig(k=3, tree_fan=2)`` (7 rows):
   captured ``torch.equal`` to eager, against plain at the bar, fan 1 equal
   to linear k = 3, 529 / 109 a window; (l) phase 14 (b)'s planted chains
   (``PlantedChains``) at fan 2 x depth 3 on a dense store and a paged pool
   of CROSS_PLANT_PS-token pages under a shuffled block table, every K/V
   stack's lead dims (the vlm's ``groups_self`` two), the continuation and
   the late relocation held at CROSS_PLANT_BARS; (m) the continuous engine
   on (e)'s CROSS_SPEC_REQUESTS (one prompt: a miss, its prefix hit, and a
   miss under other extras admitted into a freed slot) at
   CROSS_SPEC_SERVE_NEW new, with
   n-gram windows of k = 3 (2 x 4 rows), greedy and sampled, then tree
   windows of fan 2 x depth 1 (2 x 3 rows), greedy: captured
   ``torch.equal`` to ``EagerEngine``, greedy against each request's solo
   run at CROSS_SOLO_BARS, the launches counted, and under n-gram windows
   ``admits_into_next_slot`` and ``stale_extras`` caught;
   (n) device ms of the batch-1 plain step and of the n-gram, self-draft and
   tree windows (CUDA events, alternating rounds), and with the tokens a
   window emitted in (i)-(k), batch-1 tokens/s over plain.  Phase 13 (c)'s sampled,
   preempted and crashed draft serves run the trace's first 4 requests to
   make room for it.  Every phase prints a ``wall:`` line, the run's
   seconds at its start, and phase 8 the seconds of its sections, its
   profiler session's stages among them.

18. the moe family (after phase 17): MOE_ARCH, moonshot-v1-16b-a3b, at
   full width and MOE_LAYERS (8) of its 48 layers (all 48 before phase
   19, 12 before phase 20), drawn and quantized on the card one (K, N)
   slice at a time (``quantized_params``, int8): (a) ``moe_apply`` against
   ``moe_apply_onehot`` (the reference's one-hot einsums transcribed) on one
   f32 MoE layer at full width, BATCH rows of one token (nothing dropped)
   and BATCH rows of MOE_PLANT_S tokens with expert 0 planted in every
   token's top 6 (capacity drops counted equal, at least the planted
   number), ``pim_matvec`` against plain at its shapes (K 2,048 / 2,816 /
   11,264, N 2,048 / 2,816 / 11,264 / 163,840) and ``flash_attention`` at
   (KV 16, G 1, D 128); (b) a captured ``generate`` on 4 x 128 prompts, 32
   new, greedy (its launches counted: 7 x layers + 1 ``pim_matvec`` a step,
   the MoE layers' routed experts ``x @ dq(w)``) and sampled (their eager
   twins cut to pay for phase 19, which holds the family's), the captured
   step's ms beside the weight-stream floor and the floor of the experts a
   step can route to, and one MoE layer's ``moe_apply`` alone, times the
   MoE layers, as its share; (e) the continuous engine
   (``prefix_cache=True``) on MOE_TRACE over 2 slots: each request served
   alone, then the trace counted (a step's calls x chunk iterations + one
   head row an admit), each request ``torch.equal`` to itself served
   alone, no prefix hit, captured ``torch.equal`` to ``EagerEngine`` on
   the first MOE_EAGER requests, each request against its solo
   ``generate`` at PAGED_BAR, beside the logits of one request's decode
   steps at batch 1 against batch 2; (f) ``kv_cache_bits=8``: the dense
   layer's K/V int8 and the MoE layers' bf16 in the dense cache and a
   paged pool, one captured step ``torch.equal`` to eager; (g) a batch-1
   n-gram speculative ``generate`` (windows of k + 1 = 5 rows through
   ``pim_matvec``), captured ``torch.equal`` to eager, launches counted,
   against plain greedy decoding at HIT_BAR; (d) the bf16 kernel path
   against the overlay path within MOE_OVERLAY_TOL, which a planted fault
   (the dense layer's ``down`` losing its last K split) must exceed; (c)
   the f32 path at MOE_F32_LAYERS layers against its plain twin within
   PATH_TOL, a shared expert's ``down`` losing its last K split as the
   planted fault.
19. deepseek-v2-lite-16b (after phase 18), MLA attention, at full width and
   10 of its 27 layers (all 27, and (b)'s eager twins, before phase 20),
   int8, through phase 18's (b) to (f) with each bar of its own: (a) one f32 MLA layer at full width,
   ``mla_decode`` and ``mla_verify`` (k = 4, and a tree of fan 2 x depth
   2: the absorbed form) within MLA_FORMS_TOL of ``mla_prefill`` (the
   expanded form) at the same positions, the paged pool under a permuted
   block table bit for bit the dense store, and ``pim_matvec`` against
   plain at its shapes (K 2,048 / 10,944 / 2,816 / 1,408, N 3,072 / 576 /
   2,048 / 10,944 / 2,816 / 102,400); (b) 164 ``pim_matvec`` a step (7 +
   26 x 6 + 1), the floors checked against the config's widths; (e) the
   solo runs at MLA_SOLO_BAR, with the batch witness: one request's decode
   steps at batch 1 and as row 0 of 2 from equal caches, at bf16 and at
   f32 over the same codes (the f32 pair within PATH_TOL), each layer
   part's row 0 at both batches, and which of a MoE layer's operations
   change row 0's bits with the batch; (f) the latent pools bf16 beside the dense
   layer's int8 K/V; (d) within MLA_OVERLAY_TOL; (g) speculation on the
   moe family, each window at most 6 tokens a row (one dispatch group that
   drops nothing a one-token step keeps): on the fixed engine at batch 1
   (``WindowChecks``: n-gram windows of k = 4 greedy and sampled, the int8
   tree as its own draft, a tree of fan 2 x depth 2, each captured
   ``torch.equal`` to eager with its launches counted and against plain
   greedy decoding at HIT_BAR; chains planted on a dense store and a paged
   pool and relocated across the latent and K/V stacks; the windows' ms),
   at BATCH rows (n-gram windows of 20 rows through ``x @ dq(w)``), and on
   the continuous engine (n-gram, self-draft and tree windows over 2
   slots: captured ``torch.equal`` to eager, launches counted, each
   request against its solo run at HIT_BAR).
20. falcon-mamba-7b (after phase 19), the ssm family: Mamba1 blocks with
   per-row recurrent state and no attention, at full width and all 64
   layers, int8 (``SsmPhase``): (a) one f32 Mamba1 layer at full width,
   the chunked prefill (4 x 128, and 293 real tokens padded to 300 under
   ``length``) against as many ``mamba1_decode`` steps within KERNEL_TOL,
   ``mamba1_verify``'s per-step states (k = 4, and a tree of fan 2 x
   depth 3 run as chains) against decode steps along each path (bit for
   bit, or the largest difference, within KERNEL_TOL), and ``pim_matvec``
   against plain at its shapes (K 256 / 4,096 / 8,192, N 288 / 4,096 /
   8,192 / 16,384 / 65,024); (b) the captured generate greedy and sampled
   ``torch.equal`` to eager, 257 ``pim_matvec`` a step (4 x 64 + the
   head), the step's ms beside its weight-stream floor (checked against
   the config's widths) and each call's plan; (e) the continuous engine
   with ``prefix_cache=True`` on 2 slots, five requests of prompts that
   are no whole number of pages (each admit masks its pads out of its
   state row): each request ``torch.equal`` to itself served alone, no
   prefix hit, captured ``torch.equal`` to eager, launches counted, each
   against its solo run at SSM_SOLO_BAR; (f) speculation in windows of at
   most 8 rows: at batch 1 n-gram windows of k = 4 (greedy, sampled), the
   int4 tree as the int8 tree's draft, a tree of fan 2 x depth 3, and at
   4 rows n-gram windows of k = 1, each captured ``torch.equal`` to
   eager with its launches counted and greedy against plain greedy
   decoding at HIT_BAR; planted windows of plain's tokens committed at
   the accepted step against decoding those tokens (and one step late,
   which must fail), at bf16 over 64 layers and at f32 over 4; the
   windows' ms; the continuous engine under n-gram, int4 self-draft and
   tree windows (captured == eager, launches counted, against the solo
   runs at HIT_BAR); (d) the bf16 kernel path against the overlay path
   within SSM_OVERLAY_TOL, which layer 0's ``out_proj`` losing its last K
   split must exceed; (c) the f32 path at 4 layers against its plain twin
   within PATH_TOL.

``python3 chip_smoke.py --overlay-depths`` runs phase 17 (b) for the vlm at
1, 2 and 4 groups.

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
from repro_torch import core as picaso  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.core import costmodel as pcm, mapping as pmapping  # noqa: E402
from repro_torch.core import paper_tables, simulator as psim  # noqa: E402
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
    attention, blocks, common, decode_step, encode, init_cache, init_paged_cache, init_params, lm, mla,
    moe, prefill, tree_relocate, verify_hidden, verify_step)
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models.common import unembed  # noqa: E402
from repro_torch.models.draw import layerwise_params, quantized_params  # noqa: E402
from repro_torch.quant import (  # noqa: E402
    QuantizedTensor, dequantize, quantize_symmetric, to_bitplanes)
from repro_torch.serving import (  # noqa: E402
    ChaosConfig, ChunkState, ContinuousBatchingEngine, DecodeState, EngineCrash, FaultInjector,
    LadderConfig, ReplicaRouter, Request, ResiliencePolicy, ServingEngine, ServingSupervisor,
    SpecConfig, VirtualClock, admit_prefill, decode_and_emit, load_snapshot, pim_bytes,
    quantize_tree, sampling, save_snapshot, speculative)
from repro_torch.serving import engine as serving_engine  # noqa: E402
from repro_torch.serving.engine import gc_paused  # noqa: E402
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
TIME_BUDGET_S = 0.5  # about this long per measurement, at most `reps` passes (was 1.0)
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
STALE_NEW, TIMING_ROUNDS = 4, 2  # 4 rounds before phase 16
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
    start = time.perf_counter()

    def wall(phase):
        """The run's host seconds so far, printed where ``phase`` starts."""
        print(f"wall: {time.perf_counter() - start:.1f} s at {phase}", flush=True)

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

    wall("phase 2")
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
    del mm_cases
    # The checks of the slice that redesigned pim_matmul and bitplane_matmul
    # draw from a generator of their own.
    gen_mm2 = torch.Generator(device=dev).manual_seed(SEED + 5)
    qv = engine_weights(eng8, 8)[0][1][0]
    xv = torch.randn((BATCH, qv.shape[0]), generator=gen_new, device=dev).to(torch.bfloat16)
    mm_build, one_calls = matmul_build_report(
        gen_mm2, lambda: pim_matvec(xv, qv.codes, qv.scale, bits=8))
    print(json.dumps(mm_build))

    wall("phase 3")
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
    del lo8

    wall("phase 4")
    # ---- 4. the entry point ----------------------------------------------------
    mm_weights, entry = entry_point(params, gen_mm)
    print(json.dumps(entry))
    mm_err = max(mm_err, entry["max_abs_err"])

    wall("phase 5")
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
    del mm_weights, mv_weights  # views of the engines' codes: they would outlive them

    wall("phase 6")
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

    wall("phase 7")
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

    wall("phase 9")
    # ---- 9. continuous batching on the paged cache ---------------------------------
    # Its counted long serve and two steps are windows of phase 8's profiler
    # session, the run's only one: ``ServingPhase.finish`` reads them after it.
    gen_serve = torch.Generator(device=dev).manual_seed(SEED + 6)
    serving = ServingPhase(cfg, eng8, long_eng, long_prompt, long_toks, gen_serve)
    serve_windows = serving.run()

    wall("phase 10")
    # ---- 10. the shared-prefix serve -----------------------------------------------
    prefix_phase = PrefixPhase(cfg, eng8.params, dev)
    prefix_phase.run()

    wall("phase 11")
    # ---- 11. the resilience tier -----------------------------------------------------
    resilience = ResiliencePhase(cfg, serving, prefix_phase)
    resilience.run()

    wall("phase 12")
    # ---- 12. n-gram speculative decoding ---------------------------------------------
    spec_launches = SpecPhase(cfg, eng8.params, prompt, toks, serving, prefix_phase).run()

    wall("phase 13")
    # ---- 13. draft-model speculation --------------------------------------------------
    spec_launches.update(DraftPhase(cfg, eng8.params, eng4.params, prompt, serving,
                                    prefix_phase).run())

    wall("phase 14")
    # ---- 14. tree drafts ----------------------------------------------------------------
    spec_launches.update(TreePhase(cfg, eng8.params, prompt, toks, serving, prefix_phase).run())

    wall("phase 8")
    # ---- 8. the captured decode step ---------------------------------------------
    counted, traced = captured_phase(
        cfg, eng8, eng4, long_eng, prompt, long_prompt, one_calls,
        {"int8": (graphs8, toks, N_NEW), "int4": (graphs4, toks4, N_NEW_INT4),
         "long": (graphs_long, long_toks, LONG_NEW)}, serve_windows)
    served = {**serving.finish(traced), **prefix_phase.finish(), **resilience.finish()}
    resumed_flash = resilience.long_resumed_flash
    # phase 16 (h)'s inputs: the int8 tree, phase 9's trace and its bf16-cache tokens
    kv_inputs = (eng8.params, serving.reqs, serving.out, prompt)
    del params, eng8, eng4, long_eng, graphs8, graphs4, graphs_long, one_calls, long_toks
    del serving, prefix_phase, resilience, serve_windows, traced
    gc.collect()  # the counted captures hold each engine in a cycle
    torch.cuda.empty_cache()
    wall("phase 7: the long prefill against plain")
    long_against_plain(cfg, gen_fa, long_prompt)
    wall("phase 7: flash_attention's times")
    fa_times = flash_timings(cfg, gen_fa)
    print(json.dumps(fa_times))

    wall("phase 15")
    # ---- 15. the PiCaSO machine ----------------------------------------------------------
    picaso_launches = PicasoPhase(dev).run()

    wall("phase 16")
    # ---- 16. the rest of the dense family ------------------------------------------------
    family = FamilyPhase(dev, kv_inputs)
    del kv_inputs  # the phase drops qwen2-1.5b's tree after (h)
    family = family.run()

    wall("phase 17")
    # ---- 17. the vlm and encdec families -------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 17: {torch.cuda.memory_allocated()} bytes allocated before it", flush=True)
    family.update(CrossPhase(dev).run())

    wall("phase 18")
    # ---- 18. the moe family ----------------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    family.update(MoePhase(dev).run())

    wall("phase 19")
    # ---- 19. deepseek-v2-lite-16b: MLA, and speculation on the moe family ----------------
    gc.collect()
    torch.cuda.empty_cache()
    family.update(MlaPhase(dev).run())

    wall("phase 20")
    # ---- 20. falcon-mamba-7b: the ssm family, and speculation on it ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    family.update(SsmPhase(dev).run())
    print(json.dumps({"kernels": [{
        "name": "pim_matvec", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pim_matvec.cu",
        "replaces": "src/repro/kernels/pim_matvec.py:40",
        "launches": counted["int8"]["traced"]["pim_matvec"] + sum(
            t["pim_matvec"] for t in (*served.values(), *spec_launches.values(),
                                      *family.values())),
        "launches_by_path": {"int8 generate": counted["int8"]["traced"]["pim_matvec"],
                             **{k: t["pim_matvec"] for k, t in served.items()},
                             **{f"{k} (counters)": t["pim_matvec"]
                                for k, t in (*spec_launches.items(), *family.items())}},
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
        "launches": fold["launches"] + picaso_launches,
        "launches_by_path": {"fold_sum (phase 6)": fold["launches"],
                             "PiCaSO U55 array, block sums (phase 15 (b))": picaso_launches},
        "max_abs_err": fold["max_abs_err"],
        "ms": fold["kernel_ms"], "plain_ms": fold["plain_ms"],
        "bound_ms": fold["bound_ms"], "bound_by": "bytes",
        "library_ms": fold["library_ms"], "library_note": "torch.sum(x, -1), another order",
        "per": fold["per"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn.py:26",
        "launches": counted["long"]["traced"]["flash_attention"]
        + served["long serve"]["flash_attention"] + resumed_flash,
        "launches_by_path": {"long generate": counted["long"]["traced"]["flash_attention"],
                             "long serve": served["long serve"]["flash_attention"],
                             "long serve, resumed admit (counter)": resumed_flash,
                             **{f"{k} (counters)": t["flash_attention"]
                                for k, t in family.items()}},
        "launches_counted_as": counted["long"]["counted_as"],
        "max_abs_err": fa_check["max_abs_err"],
        "bf16_tol_share": fa_check["bf16_tol_share"],
        "ms": fa_times["kernel_ms"], "plain_ms": fa_times["plain_ms"],
        "bound_ms": fa_times["bound_ms"], "bound_by": fa_times["bound_by"],
        "library_ms": fa_times["library_ms"], "library_note": fa_times["library_note"],
        "per_layer": _measured(fa_times["per_layer"]), "per": fa_times["per"],
    }]}))
    wall("the end")
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


def decode_attention_check(cfg, gen, batch=1, slots=LONG_PROMPT + LONG_NEW, pos=LONG_PROMPT):
    """One bf16 layer's decode attention over ``batch`` rows of a cache of
    ``slots`` positions (by default the long path's: LONG_PROMPT + LONG_NEW
    slots, the query at position LONG_PROMPT), the cache kept in bf16 with
    f32 outputs (``attention.decode_attention``),
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
    q = torch.randn((batch, kv, g, d), generator=gen, device=dev).to(torch.bfloat16)
    ck, cv = (torch.randn((batch, kv, slots, d), generator=gen, device=dev).to(torch.bfloat16)
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
    n = batch * kv
    s_new = attention.bmm_f32(q.reshape(n, g, d), ck.reshape(n, slots, d).transpose(1, 2))
    s_new = (s_new / math.sqrt(d)).reshape(s_old.shape)
    w_new = torch.softmax(s_new.masked_fill(~valid, float("-inf")), dim=-1).to(cv.dtype)
    pv_new = attention.pv_f32(w_new.reshape(n, g, slots), cv.reshape(n, slots, d))
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
              "weights": int(valid.sum()) * batch * kv * g,
              "peak_bytes_above_inputs": extra, "f32_copy_of_k_bytes": f32_copy,
              "bf16_cache_ms": _time_ms([lambda: attention.decode_attention(q, ck, cv, pos_t)], 50),
              "f32_copy_ms": _time_ms([lambda: f32_copy_form()[2]], 50),
              "per": f"one layer's decode attention at (B {batch}, KV {kv}, G {g}, D {d}); "
                     "device time (CUDA graph replay)"}
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


def forced_logits(eng, prompt, toks, n_new, extras=None):
    """(B, n_new, V) f32: the logits that chose each emitted token, with the
    emitted tokens fed back (teacher-forced), under the current dispatch;
    ``extras``: the rows' image embeds or encoder output, where the model
    takes them."""
    cfg = eng.cfg
    with torch.inference_mode():
        cache = init_cache(cfg, toks.shape[0], eng.max_seq, eng.device)
        logits, cache = prefill(eng.params, cfg, prompt, cache, extras)
        out = [logits[:, -1].float()]
        for i in range(n_new - 1):
            logits, cache = decode_step(eng.params, cfg, toks[:, i:i + 1], cache,
                                        prompt.shape[1] + i, extras)
            out.append(logits[:, -1].float())
    return torch.stack(out, dim=1)


def against_overlay(eng, prompt, toks, n_new, label, tol=LOGIT_TOL, extras=None,
                    capture=True):
    """Hold the kernel path's generation against the overlay path's: the
    logits within ``tol``, and the tokens margin-aware.  With ``capture``
    False the overlay generation runs eagerly, on an engine of its own over
    the same parameters (a captured overlay step would keep a dequantized
    copy of the largest weight in its graph pool).

    Returns (max |logit difference|, seconds of the overlay generation, the
    overlay path's teacher-forced logits)."""
    lk = forced_logits(eng, prompt, toks, n_new, extras)
    prev = common.set_matvec_dispatch("off")
    try:
        lo = forced_logits(eng, prompt, toks, n_new, extras)
        off = eng if capture else EagerServingEngine(eng.cfg, eng.params, max_seq=eng.max_seq,
                                                     device=eng.device)
        if capture:
            off.generate(prompt, 2, extras=extras)  # warm-up: the overlay step's own capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks_off = off.generate(prompt, n_new, extras=extras)
        torch.cuda.synchronize()
        t_off = time.perf_counter() - t0
    finally:
        common.set_matvec_dispatch(prev)
    check(bool(torch.isfinite(lk).all()), f"{label}: non-finite logits")
    dpos = (lk - lo).abs().amax(dim=-1)  # (B, n_new)
    diff = dpos.max().item()
    check(diff <= tol, f"{label}: decode logits differ from the overlay "
          f"path by {diff:.4g} > {tol}")
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
    print(json.dumps({"check": f"{label} vs overlay", "max_abs_logit_diff": diff, "tol": tol,
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


# The decode-step linears of a vlm cross block and an encdec decoder block
# that run pim_matvec (their other linears, the cross-attention's K and V,
# see one row per key: x @ dq(w)).
CROSS_BLOCK_LINEARS = (("xattn", "wq"), ("xattn", "wo"), ("mlp", "gate"), ("mlp", "up"),
                       ("mlp", "down"))
DEC_BLOCK_LINEARS = (("self", "wq"), ("self", "wk"), ("self", "wv"), ("self", "wo"),
                     ("cross", "wq"), ("cross", "wo"), ("mlp", "gate"), ("mlp", "up"),
                     ("mlp", "down"))
# A MoE block's shared experts (its routed experts' (E, K, N) stacks run
# x @ dq(w), as in the JAX package).
MOE_SHARED_LINEARS = (("moe", "shared", "gate"), ("moe", "shared", "up"),
                      ("moe", "shared", "down"))
# An MLA block's attention linears (its 3-D ``w_uk`` / ``w_uv`` run dq and an
# einsum, as in the JAX package).
MLA_LINEARS = (("attn", "wq"), ("attn", "w_dkv"), ("attn", "wo"))
# An SSM block's Mamba1 linears, in call order (its conv, dt_bias, A_log
# and D stay dense).
SSM_LINEARS = (("ssm", "in_proj"), ("ssm", "x_proj"), ("ssm", "dt_proj"), ("ssm", "out_proj"))


def step_calls(cfg):
    """The weights of one decode step's ``pim_matvec`` calls in call order,
    as paths into the parameter tree (stack indices included): each dense
    layer's seven linears; the moe family's dense layers, then each MoE
    layer's four attention linears (an MLA layer's three) and its shared
    experts' three (the routed experts' 3-D stacks run ``x @ dq(w)``); the
    vlm's groups of
    dense blocks and a cross block; the encdec's decoder blocks; the ssm
    family's four Mamba1 linears a layer; then an untied head."""
    dense = [(group, name) for group, name, _ in LINEARS]
    if cfg.family == "moe":
        nd = cfg.n_dense_layers
        attn = list(MLA_LINEARS) if cfg.mla else dense[:4]
        out = [("dense_layers", i, *w) for i in range(nd) for w in dense]
        out += [("layers", i, *w) for i in range(cfg.n_layers - nd)
                for w in attn + list(MOE_SHARED_LINEARS)]
    elif cfg.family == "vlm":
        every = cfg.vision.cross_attn_every
        out = []
        for j in range(cfg.n_layers // every):
            out += [("groups", "self", j, i, *w) for i in range(every - 1) for w in dense]
            out += [("groups", "cross", j, *w) for w in CROSS_BLOCK_LINEARS]
    elif cfg.family == "encdec":
        out = [("decoder", i, *w) for i in range(cfg.dec_layers) for w in DEC_BLOCK_LINEARS]
    elif cfg.family == "ssm":
        out = [("layers", i, *w) for i in range(cfg.n_layers) for w in SSM_LINEARS]
    else:
        out = [("layers", i, *w) for i in range(cfg.n_layers) for w in dense]
    return out + ([] if cfg.tie_embeddings else [("head",)])


def weight_at(params, path):
    """The quantized weight at a ``step_calls`` path: its codes and scales
    (views of the stacks)."""
    node, idx = params, ()
    for part in path:
        if isinstance(part, int):
            idx += (part,)
        else:
            node = node[part]
    return {k: v[idx] for k, v in node.items()}


def matvec_calls_per_step(cfg):
    """``pim_matvec`` calls of one decode step (``step_calls``)."""
    return len(step_calls(cfg))


def dropped_call(per_step, index, rows):
    """The wrapper with one planted fault: in call ``index`` of each decode
    step of ``per_step`` calls, the last ``rows`` K rows add nothing (the
    activations they multiply are zeroed).  Counts decode calls, so it
    holds for a prefill (which makes none) and then decode steps."""
    calls = 0

    def faulty(x, w_codes, scale, *, bits=8, **kw):
        nonlocal calls
        if calls % per_step == index:
            x = x.clone()
            x[:, -rows:] = 0
        calls += 1
        return pim_matvec(x, w_codes, scale, bits=bits, **kw)
    return faulty


def middle_down(cfg):
    """The ``step_calls`` index of layer n/2's ``down``: a dense block's MLP's,
    a MoE block's shared experts', or an SSM block's ``out_proj``."""
    i = cfg.n_layers // 2
    if cfg.family == "ssm":
        return step_calls(cfg).index(("layers", i, *SSM_LINEARS[3]))
    if cfg.family == "moe" and i >= cfg.n_dense_layers:
        path = ("layers", i - cfg.n_dense_layers, *MOE_SHARED_LINEARS[2])
    else:
        path = ("dense_layers" if cfg.family == "moe" else "layers", i, "mlp", "down")
    return step_calls(cfg).index(path)


def dropped_middle_down(cfg, rows):
    """``dropped_call`` at layer n/2's ``down`` (``middle_down``)."""
    return dropped_call(matvec_calls_per_step(cfg), middle_down(cfg), rows)


def against_plain(eng8, gen, prompt, toks, lo8):
    """The int8 path at full width in f32, kernel vs plain version
    (``plain_path_check``), on a model of its own drawn from ``gen``."""
    cfg = eng8.cfg.replace(param_dtype="float32")
    eng = ServingEngine(cfg, init_params(cfg, gen, device=gen.device),
                        max_seq=eng8.max_seq, pim_bits=8, device=gen.device)
    plain_path_check(eng, eng8, prompt, toks, lo8, "int8 f32 kernel path vs plain path")


def plain_path_check(eng, eng8, prompt, toks, lo8, label, rows=DROPPED_ROWS):
    """The f32 engine ``eng``'s teacher-forced logits through the kernel
    against the same path with every decode linear through
    ``pim_matvec_plain`` on the card, within PATH_TOL.  Then a planted
    fault (layer n/2's ``down`` loses its last ``rows`` K rows) must fail
    that check; its size under the bf16 overlay check (``eng8``'s logits
    against ``lo8``, the overlay path's) is printed beside LOGIT_TOL.
    Returns the report."""
    cfg, cfg8, n_new = eng.cfg, eng8.cfg, toks.shape[1]
    lk = forced_logits(eng, prompt, toks, n_new)
    with decode_linears_through(pim_matvec_plain):
        lp = forced_logits(eng, prompt, toks, n_new)
    with decode_linears_through(dropped_middle_down(cfg, rows)):
        lf = forced_logits(eng, prompt, toks, n_new)
    with decode_linears_through(dropped_middle_down(cfg8, rows)):
        lf8 = forced_logits(eng8, prompt, toks, n_new)
    diff = (lk - lp).abs().max().item()
    fault = (lf - lp).abs().max().item()
    fault8 = (lf8 - lo8).abs().max().item()
    report = {"check": label, "layers": cfg.n_layers,
              "max_abs_logit_diff": diff, "tol": PATH_TOL,
              "logit_std": lp.std().item(),
              "planted_fault": f"layer {cfg.n_layers // 2} down: last {rows} K rows dropped",
              "planted_fault_f32_diff_vs_plain": fault,
              "planted_fault_bf16_diff_vs_overlay": fault8,
              "planted_fault_bf16_layers": cfg8.n_layers,
              "logit_tol": LOGIT_TOL}
    print(json.dumps(report))
    check(bool(torch.isfinite(lk).all()), f"{label}: non-finite logits")
    check(diff <= PATH_TOL, f"{label}: kernel logits differ from the plain "
          f"version's by {diff:.4g} > {PATH_TOL}")
    check(fault > PATH_TOL, f"{label}: the planted fault moved the f32 logits by only "
          f"{fault:.4g} <= {PATH_TOL}: the check cannot see it")
    return report


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
        with gc_paused(), torch.cuda.graph(g):
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


def launch_counts():
    return {kernel.__name__: kernel.launches for kernel in KERNEL_FNS}


class CountedGraph:
    """A captured step whose replays are counted, with the kernels' launch
    counters read around its capture (``launches``): the wrappers count as
    the step is captured, and a replay runs no Python, so it counts
    nothing.  ``capture_s``: host seconds of its warm-up and capture."""

    def __init__(self, graph, launches, capture_s):
        self.graph, self.launches, self.replays = graph, launches, 0
        self.capture_s = capture_s

    def replay(self):
        self.replays += 1
        self.graph.replay()


def count_captures(eng):
    """From now on, each step ``eng`` captures (a decode step, or a chunk step
    or an admit of the continuous engine) is a ``CountedGraph``, added to
    the list returned."""
    graphs, capture, warm_up = [], eng.graphs._capture, eng.graphs._warm_up
    started = []

    def timed_warm_up(run, reset):
        torch.cuda.synchronize()
        started.append(time.perf_counter())
        warm_up(run, reset)

    def counted(run, pool):
        before = launch_counts()
        graph = capture(run, pool)
        after = launch_counts()
        torch.cuda.synchronize()
        graphs.append(CountedGraph(graph, {k: after[k] - before[k] for k in after},
                                   time.perf_counter() - started.pop()))
        return graphs[-1]

    eng.graphs._warm_up, eng.graphs._capture = timed_warm_up, counted
    return graphs


def capture_report(eng, graphs):
    """How many steps ``eng`` captured (``count_captures``' list) and keeps,
    and what their warm-ups and captures cost on the host clock."""
    times = [g.capture_s for g in graphs]
    return {"captured": len(graphs), "kept": len(eng.graphs),
            "capture_s_total": sum(times), "capture_ms_median":
            sorted(times)[len(times) // 2] * 1e3 if times else None,
            "capture_ms_max": max(times, default=0.0) * 1e3}


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


def check_counters(label, out, toks, want):
    """``check_counted`` for a counted generation run outside the profiler
    session: the counters' account must be ``want`` and the tokens
    ``toks``."""
    check(out["counters"] == want, f"{label}: the counters give {out['counters']}, expected "
          f"{want} ({out['counters_as']})")
    check(same_tokens(out["tokens"], toks), f"{label}: the counted generation's tokens differ "
          "from the same generation's earlier ones")
    return {"path": label, "launches": out["counters"], "launches_counted_as": out["counters_as"]}


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


def captured_vs_eager(eng, prompt, n_new, label, *, greedy, temperature=1.0, top_k=0, key=None,
                      extras=None, toks=None):
    """(a)/(b): ``eng.generate`` (each decode step one replay of the captured
    step) against an eager loop of the same step function,
    ``decode_and_emit``, from the same prefill on buffers of its own (the
    rows' ``extras`` copied into them too): the tokens and the last step's
    logits must be equal (``torch.equal``).  ``toks``: the tokens of that
    ``generate``, where the caller has just run it (its last logits still in
    the engine's state)."""
    b = prompt.shape[0]
    kw = dict(greedy=greedy, top_k=top_k)
    with torch.inference_mode():
        if toks is None:
            toks = eng.generate(prompt, n_new, temperature=temperature, key=key,
                                extras=extras, **kw)
        logits = eng.state(b).logits.clone()
        st = DecodeState(eng.cfg, b, eng.max_seq, prompt.device)
        st.start(eng.params, eng.cfg, prompt, key, temperature, extras=extras, **kw)
        for _ in range(n_new - 1):
            decode_and_emit(eng.params, eng.cfg, st, extras=st.extras.get(extras), **kw)
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
    cases, sections, t0 = [], {}, time.perf_counter()
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
    sections["captured_vs_eager_and_stale_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
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

        sections["timing_rounds_s"] = time.perf_counter() - t0
        counted = {label: {} for label in paths}
        for label, gen_fn in (("int8", lambda: eng8.generate(prompt, N_NEW)),
                              ("int4", lambda: eng4.generate(prompt, N_NEW_INT4)),
                              ("long", long_generation)):
            segments.append((f"{label} generate, counted", None,
                             counted_generation(paths[label][0], gen_fn, counted[label])))
        trace_s = {}
        traced = tracing.trace_windows(segments + list(extra), times=trace_s)
    sections["profiler_session"] = trace_s
    print(json.dumps({"phase 8 sections": sections}), flush=True)
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
SERVE_ROUNDS = 1  # rounds of (e): captured, then eager (3 before phase 16)
# (e)'s captured serve when its admits ran eagerly, as PERF.md records it
# (NVIDIA H100 80GB HBM3 at 700 W): the yardstick the captured admits are
# reported beside.
BEFORE_CAPTURED_ADMITS = {"host_ms_per_round_outside_steps": 41.7, "tokens_per_s": 261}
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
    the host time of its admits (``admit_s``, and each admit's padded length,
    ms and whether the prefix cache served it in ``admits``; an admit ends
    reading its first token, so its device work is done)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.spans, self.admit_s, self.admits = [], 0.0, []

    def _admit(self, requests, slot, ridx, *args, **kw):
        t0 = time.perf_counter()
        info = super()._admit(requests, slot, ridx, *args, **kw)
        dt = time.perf_counter() - t0
        self.admit_s += dt
        self.admits.append((self._spad(len(requests[ridx].prompt)), dt * 1e3,
                            info["cached_tokens"] > 0))
        return info

    def _load(self):
        super()._load()
        self.spans.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
        self.spans[-1][0].record()

    def _read(self, n, k=None):
        self.spans[-1][1].record()
        return super()._read(n, k)

    def timed_serve(self, requests, **mode):
        """``serve`` on the host clock: (outputs, wall s, device ms of the
        chunk steps, chunk iterations, rounds, emitted tokens)."""
        self.spans, self.admit_s, self.admits = [], 0.0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.serve(requests, **mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, {"wall_s": wall, "steps_ms": sum(a.elapsed_time(b) for a, b in self.spans),
                     "admit_s": self.admit_s, "iters": self.decode_chunk_iters,
                     "rounds": len(self.spans), "tokens": sum(len(o) for o in out)}


class EagerEngine(TimedEngine):
    """The same engine with its chunk step and its admits run eagerly (no
    graph): the reference the captured serve is held against, bit for
    bit."""

    def _kept(self, key, run, reset, bounded=False):
        return run


def admit_ms_by_length(admits):
    """Median admit ms per padded prompt length of ``TimedEngine.admits``
    rows (spad, ms, hit)."""
    by = {}
    for spad, ms, _ in admits:
        by.setdefault(spad, []).append(ms)
    return {spad: sorted(v)[len(v) // 2] for spad, v in sorted(by.items())}


def admits_against_plain(eng, prompts):
    """(a): for three padded lengths of the trace (the shortest, the median
    and the longest), ``eng``'s captured admit (one replay of
    ``admit_step``'s graph) against ``admit_prefill`` on the same inputs
    into a pool of its own, greedy and sampled: the token and every pool
    page it wrote, ``torch.equal``.  The pages are the pool's last ones."""
    st, cfg, dev, ps = eng._state, eng.cfg, eng.device, eng.page_size
    ref = ChunkState(cfg, eng.slots, eng.max_seq, eng.num_pages, ps, eng.chunk, dev)
    spads = sorted({eng._spad(len(p)) for p in prompts})
    rows = []
    with torch.inference_mode():
        for spad in (spads[0], spads[len(spads) // 2], spads[-1]):
            p = next(p for p in prompts if eng._spad(len(p)) == spad)
            pages = list(range(eng.num_pages - spad // ps, eng.num_pages))
            prompt = torch.zeros((1, spad), dtype=torch.int32, device=dev)
            prompt[0, :len(p)] = torch.from_numpy(p).to(dev)
            for label, mode in (("greedy", GREEDY), ("sampled", SAMPLED)):
                greedy, top_k = mode["greedy"], mode.get("top_k", 0)
                base = prng_key(mode.get("key", 0), dev)
                for state in (st, ref):
                    state.base.copy_(base)
                    state.temperature.fill_(mode.get("temperature", 1.0))
                step = eng.admit_step(spad, greedy=greedy, top_k=top_k)
                a = st.admit(spad)
                a.prompt.copy_(prompt)
                a.ints.copy_(torch.tensor([*pages, len(p), 7], device=dev))
                step()
                want = admit_prefill(eng.params, cfg, ref.cache, prompt, len(p), 0,
                                     torch.tensor(pages, device=dev), 7, ref.base,
                                     ref.temperature, greedy=greedy, top_k=top_k)
                same_pages = all(torch.equal(leaf[:, pages], ref.cache["layers"][name][:, pages])
                                 for name, leaf in st.cache["layers"].items())
                rows.append({"spad": spad, "prompt": len(p), "mode": label,
                             "token_equal": torch.equal(a.tok, want),
                             "pages_equal": same_pages})
                check(rows[-1]["token_equal"] and same_pages,
                      f"the captured admit differs from admit_prefill: {rows[-1]}")
    return rows


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
        self.prompts, self.dense, self.lengths = prompts, dense, lengths

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
        report["admit_vs_plain"] = admits_against_plain(eng, prompts)
        check([len(o) for o in self.out] == lengths, f"(a) output lengths "
              f"{[len(o) for o in self.out]}, the dense runs and stops give {lengths}")
        with torch.inference_mode():
            report["paged_vs_dense"] = paged_vs_dense(
                "(a) greedy", self.out, dense, lengths,
                lambda r, j: self._gap(self.solo, torch.from_numpy(prompts[r])[None].to(dev), j),
                PAGED_BAR)

        # (e) times: alternating rounds of the captured and the eager serve
        rounds, admits = [], {"captured": [], "eager": []}
        for _ in range(SERVE_ROUNDS):
            row = {}
            for name, e in (("captured", eng), ("eager", eager)):
                out, t = e.timed_serve(reqs)
                check(same_tokens(out, self.out), f"(e) a {name} serve's tokens changed")
                row[name] = timing_row(t)
                admits[name] += e.admits
            row["sm_clock_mhz"] = tracing.sm_clock_mhz()
            rounds.append(row)
        report["timing_rounds"] = rounds
        by_length = {name: admit_ms_by_length(a) for name, a in admits.items()}
        report["admit_ms_by_padded_length"] = {
            spad: {"captured": ms, "eager": by_length["eager"][spad]}
            for spad, ms in by_length["captured"].items()}
        report["timing_medians"] = {
            name: {k: sorted(r[name][k] for r in rounds)[len(rounds) // 2]
                   for k in ("step_ms_per_iter", "tokens_per_s", "host_ms_per_round_outside_steps",
                             "admit_ms_per_round")}
            for name in ("captured", "eager")}
        report["timing_medians"]["captured_over_eager_step"] = (
            report["timing_medians"]["captured"]["step_ms_per_iter"]
            / report["timing_medians"]["eager"]["step_ms_per_iter"])
        report["timing_medians"]["before_captured_admits"] = BEFORE_CAPTURED_ADMITS
        report["graphs"] = capture_report(eng, self.graphs)

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
        self.out_sampled = out_c = eng.serve(reqs, **SAMPLED)
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
        print(json.dumps(report), flush=True)
        self.report = report
        return self.windows()

    def windows(self):
        """The counted serve of (a), run here (its launches by the
        counters); then phase 8's session traces: the counted serve of
        (d), one paged chunk step at 4 slots, and the dense captured step
        at the same 4 rows over the same 512 positions."""
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
        counted_generation(self.graphs, serve_a, self.counted["serve"])()

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
        return [("long serve, counted", None, counted_generation(self.long_graphs, serve_d,
                                                                 self.counted["long serve"])),
                ("paged chunk step", paged_setup, paged_step),
                ("dense step, 4 rows", dense_setup, dense_step)]

    def finish(self, traced):
        """Phase 9's launches, (a)'s from the counters and (d)'s from the
        trace, and its report."""
        per_step = len(LINEARS) * self.cfg.n_layers
        launches = {}
        for label, toks, flash in (("serve", self.out, 0),
                                   ("long serve", self.long_out, self.cfg.n_layers)):
            out = self.counted[label]
            want = dict.fromkeys(KERNEL_TAGS, 0)
            want["pim_matvec"] = per_step * out["iters"]
            want["flash_attention"] = flash
            if label == "serve":
                launches[label] = check_counters(f"{label}, counted", out, toks, want)
            else:
                launches[label] = check_counted(f"{label}, counted",
                                                traced[f"{label}, counted"], out, toks, want)
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
        print(json.dumps({"check": "phase 9: launches and one traced step", "launches": launches,
                          "one_step_trace": steps}))
        return {"serve": self.counted["serve"]["counters"],
                "long serve": self.counted["long serve"]["traced"]}



# ---- 10. the shared-prefix serve ------------------------------------------------------
PREFIX_SERVE = dict(slots=4, page_size=16, chunk=8, max_seq=1024, page_alloc_seed=SEED)
# (shared system prompt, requests that share it, their tails' lengths), (the
# repeated page-aligned prompt, its requests), (unrelated requests, their
# lengths), new tokens a request: drawn by numpy from SEED + 10.
PREFIX_TRACE = dict(system=512, shared=8, tails=(20, 200), repeated=256, repeats=2,
                    unrelated=2, unrelated_len=(100, 300), new=(16, 64))
# (d): small enough that retained pages are evicted and slots preempted (a
# request needs at most 49 pages here).
PREFIX_SMALL_POOL = 60
PREFIX_ROUNDS = 2  # alternating rounds of (f): cached, then uncached (3 before phase 16)
# Hits against misses: a hit's tail runs the verify window, whose attention
# keeps f32 scores as a decode step does, where a miss's prefill rounds its
# scores to bf16 (the JAX package's arithmetic).  Through 28 layers the two
# sound paths' first-token logits differ by up to about 0.14 on the H100,
# each as far from an f32 prefill as the other ((h) prints them); PAGED_BAR,
# the bar of one arithmetic at two shapes, sits below that.  Two sound bf16
# paths of different arithmetic are held at LOGIT_TOL, as in phase 3.  The
# planted fault of (e) must be flagged beyond it; (b) to (d) also report
# their divergences beyond PAGED_BAR.
HIT_BAR = LOGIT_TOL
HIT_LOGIT_REQUESTS = (1, 4, 9)  # (h): three hits, windows of 5, 4 and 10 pages


def prefix_trace(vocab):
    """Phase 10's requests in queue order, and what the prefix cache must
    do with them: (requests, expected hits, hit tokens, forks).  The first
    request of the system prompt and of the repeated prompt miss and
    register their full pages; every later one of the system prompt hits
    its 32 pages; the repeat hits every page (a full hit: its tail is the
    last position, and its last page is forked)."""
    t = PREFIX_TRACE
    sizes = np.random.default_rng(SEED + 10)  # lengths first: the schedule needs no vocab
    tails = sizes.integers(t["tails"][0], t["tails"][1] + 1, t["shared"])
    others = sizes.integers(t["unrelated_len"][0], t["unrelated_len"][1] + 1, t["unrelated"])
    news = sizes.integers(t["new"][0], t["new"][1] + 1, t["shared"] + t["repeats"]
                          + t["unrelated"])
    rng = np.random.default_rng(SEED + 11)
    system = rng.integers(0, vocab, t["system"])
    repeated = rng.integers(0, vocab, t["repeated"])
    shared = [np.concatenate([system, rng.integers(0, vocab, n)]) for n in tails]
    unrelated = [rng.integers(0, vocab, n) for n in others]
    prompts = [shared[0], shared[1], repeated, unrelated[0], shared[2], shared[3], repeated,
               shared[4], unrelated[1], shared[5], shared[6], shared[7]]
    reqs = [Request(prompt=p.astype(np.int32), max_new=int(n)) for p, n in zip(prompts, news)]
    hits = t["shared"] - 1 + t["repeats"] - 1
    hit_tokens = (t["shared"] - 1) * t["system"] + (t["repeats"] - 1) * (t["repeated"] - 1)
    return reqs, hits, hit_tokens, t["repeats"] - 1


class WatchedEngine(TimedEngine):
    """Records around each cached admit whether a byte of another live slot's
    pages changed (``touched``)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.touched = []

    def _admit_cached(self, slot, *args):
        others = sorted({p for s, pages in enumerate(self._slot_pages)
                         if s != slot and self._slot_req[s] >= 0 for p in pages})
        leaves = list(self._state.cache["layers"].values())
        before = [leaf[:, others].clone() for leaf in leaves]
        tok = super()._admit_cached(slot, *args)
        self.touched.append(any(not torch.equal(leaf[:, others], b)
                                for leaf, b in zip(leaves, before)))
        return tok


class UnmaskedEngine(WatchedEngine):
    """The planted fault of (e): the tail window runs with every slot's
    block-table row in place."""

    def _window_table(self, slot):
        return self._bt.copy()


def serve_facts(eng, rep):
    """What a serve decided: events without times, round counters without
    times, peak pages and the prefix cache's counters."""
    return {"events": events_of(rep),
            "counters": [{k: v for k, v in c.items() if k != "ts"} for c in rep.counters],
            "peak_pages": eng.peak_pages_in_use, "preemptions": eng.preemptions,
            "prefix_hits": rep.prefix_hits, "prefix_hit_tokens": rep.prefix_hit_tokens,
            "prefill_tokens": rep.prefill_tokens, "cow_forks": rep.cow_forks,
            "evictions": rep.evictions}


class PrefixPhase:
    """Phase 10: the shared-prefix serve, (a) to (g) of the module's
    docstring.  ``run`` does everything but the counting and returns the
    window phase 8's profiler session traces; ``finish`` reads it."""

    def __init__(self, cfg, params, dev):
        self.cfg, self.params, self.dev = cfg, params, dev
        self.cuts = []  # divergences where the top-k cut decided (``_gap``)

    def _gap(self, prompt, toks, j, mode, rid):
        """The margin of the choice of token j after ``prompt`` and
        ``toks[:j]``, from a dense prefill: the top-2 gap of the logits, or,
        sampled, the least of the top-2 gap of gumbel + warped logits of
        draw (rid, j) and the top-k cut's margins over the temperature: the
        winner's logit above the first one cut, and for each cut token whose
        gumbel + logit would beat the winner if it were kept, the k-th logit
        above its own (logits an ulp apart move tokens across the cut, and
        at top-k 50 of 151,936 dozens lie within an ulp of it)."""
        seq = torch.from_numpy(np.concatenate([prompt, np.asarray(toks[:j], np.int32)]))
        seq = seq[None].to(self.dev)
        logits, _ = prefill(self.params, self.cfg, seq, init_cache(self.cfg, 1, seq.shape[1],
                                                                   self.dev))
        lg = logits[0, -1:].float()
        if mode["greedy"]:
            return top2_gap(lg[0])
        t, k = mode["temperature"], mode["top_k"]
        keys = draw_keys(prng_key(mode["key"], self.dev), torch.tensor([rid], device=self.dev),
                         j, TAG_TOKEN)
        lg, noise = lg[0], gumbel(keys, lg.shape[-1])[0]
        values = warp_logits(lg[None], t, k)[0] + noise
        gap = top2_gap(values)
        kth, first_cut = torch.topk(lg, k + 1).values[k - 1:]
        cut = (lg[values.argmax()] - first_cut) / t
        entering = (lg < kth) & (lg / t + noise > values.max())
        if bool(entering.any()):
            cut = torch.minimum(cut, (kth - lg[entering].max()) / t)
        if cut.item() < gap:
            self.cuts.append({"request": rid, "token": j, "top2_gap": gap,
                              "cut_margin": cut.item()})
            gap = cut.item()
        return gap

    def _against_uncached(self, label, got, want, mode=GREEDY, check_bar=True):
        """Each request's tokens against the uncached serve's, margin-aware at
        HIT_BAR (over the temperature when sampled), with the count beyond
        PAGED_BAR beside it; returns the report."""
        t = mode.get("temperature", 1.0)
        bar = HIT_BAR / t
        with torch.inference_mode():
            div = divergences(got, want, [len(w) for w in want],
                              lambda r, j: self._gap(self.reqs[r].prompt, want[r], j, mode, r))
        rep = {"check": f"{label}: cached vs uncached serve", "requests": len(got),
               "diverged": len(div), "beyond_bar": sum(beyond(d, bar) for d in div),
               "beyond_paged_bar": sum(beyond(d, PAGED_BAR / t) for d in div),
               "divergences": div, "bar": bar}
        print(f"phase 10 {label}: " + json.dumps(rep), flush=True)
        if check_bar:
            for d in div:
                check(not beyond(d, bar), f"{label}: request {d['request']} diverges from the "
                      f"uncached serve beyond the bar {bar}: {d}")
        return rep

    def _first_token_logits(self):
        """(h): for HIT_LOGIT_REQUESTS, the first token's logits three ways:
        the hit's tail window over the system prompt's pages as the first
        request's prefill wrote them, the request's own miss prefill, and a
        prefill of the same int8 weights with f32 activations; the largest
        and RMS differences over the vocabulary and over the f32 top 8."""
        cfg, dev, ps = self.cfg, self.dev, PREFIX_SERVE["page_size"]
        system = PREFIX_TRACE["system"]
        cfg32 = cfg.replace(param_dtype="float32")

        def widened(tree):
            return {k: widened(v) if isinstance(v, dict) else
                    v.float() if v.dtype == torch.bfloat16 else v for k, v in tree.items()}
        params32 = widened(self.params)

        def padded(prompt):
            spad = -(-len(prompt) // ps) * ps
            toks = torch.zeros((1, spad), dtype=torch.int32, device=dev)
            toks[0, :len(prompt)] = torch.from_numpy(prompt).to(dev)
            return toks

        rows = []
        with torch.inference_mode():
            first = padded(self.reqs[0].prompt)
            for r in HIT_LOGIT_REQUESTS:
                prompt = self.reqs[r].prompt
                n, toks = len(prompt), padded(prompt)
                st = ChunkState(cfg, PREFIX_SERVE["slots"], PREFIX_SERVE["max_seq"],
                                4 * PREFIX_SERVE["max_seq"] // ps, ps, 1, dev)
                logits, _ = prefill(self.params, cfg, toks, st.cache,
                                    pages=torch.arange(1, toks.shape[1] // ps + 1, device=dev))
                miss = logits[0, n - 1].float()
                off = toks.shape[1] // ps + 1  # the first request's pages, then the tail's
                prefill(self.params, cfg, first, st.cache,
                        pages=torch.arange(off, off + first.shape[1] // ps, device=dev))
                tail = off + first.shape[1] // ps
                row_pages = list(range(off, off + system // ps)) + list(
                    range(tail, tail + (toks.shape[1] - system) // ps))
                st.cache["block_tables"][0, :len(row_pages)] = torch.tensor(row_pages, device=dev)
                window = torch.zeros((PREFIX_SERVE["slots"], toks.shape[1] - system),
                                     dtype=torch.int32, device=dev)
                window[0] = toks[0, system:]
                pos = torch.zeros(PREFIX_SERVE["slots"], dtype=torch.int64, device=dev)
                pos[0] = system
                x = verify_hidden(self.params, cfg, window, st.cache, pos)
                hit = unembed(x[0:1, n - 1 - system:n - system], self.params["embed"])[0, 0]
                hit = hit.float()
                exact, _ = prefill(params32, cfg32, toks[:, :n], init_cache(cfg32, 1, n, dev))
                exact = exact[0, n - 1]
                top = torch.topk(exact, 8).indices

                def diff(a, b, idx=slice(None)):
                    d = a[idx] - b[idx]
                    return {"max": d.abs().max().item(), "rms": d.pow(2).mean().sqrt().item()}
                rows.append({"request": r, "prompt": n, "window": toks.shape[1] - system,
                             "hit_minus_miss": diff(hit, miss),
                             "hit_minus_f32": diff(hit, exact), "miss_minus_f32": diff(miss, exact),
                             "top8_hit_minus_f32": diff(hit, exact, top),
                             "top8_miss_minus_f32": diff(miss, exact, top),
                             "f32_top2": exact[top[:2]].tolist()})
                check(rows[-1]["top8_hit_minus_f32"]["max"] <= HIT_BAR,
                      f"(h) a hit's first-token logits are far from the f32 prefill's: {rows[-1]}")
        del params32
        return rows

    def run(self):
        cfg, dev = self.cfg, self.dev
        report = {"check": "phase 10: the shared-prefix serve, qwen2-1.5b int8, prefix_cache=True"}
        reqs, hits, hit_tokens, forks = prefix_trace(cfg.vocab)
        self.reqs = reqs
        report["trace"] = {"prompt_lengths": [len(r.prompt) for r in reqs],
                           "max_new": [r.max_new for r in reqs], "expected_hits": hits,
                           "expected_hit_tokens": hit_tokens, "expected_forks": forks}

        # (a) captured equals eager
        self.eng = eng = TimedEngine(cfg, self.params, prefix_cache=True, device=dev,
                                     **PREFIX_SERVE)
        self.graphs = count_captures(eng)
        eager = EagerEngine(cfg, self.params, prefix_cache=True, device=dev, **PREFIX_SERVE)
        self.out = eng.serve(reqs)  # warm-up: the captures
        facts = serve_facts(eng, eng.last_report)
        out_e = eager.serve(reqs)
        same = {"tokens_equal": same_tokens(self.out, out_e),
                "facts_equal": facts == serve_facts(eager, eager.last_report),
                **{k: v for k, v in facts.items() if k not in ("events", "counters")}}
        report["captured_vs_eager"] = same
        check(same["tokens_equal"] and same["facts_equal"],
              f"(a) the captured cached serve differs from the eager one: {same}")
        eng.assert_quiescent()
        del eager

        # (b) against the uncached serve; the trace's structure
        self.uncached = TimedEngine(cfg, self.params, device=dev, **PREFIX_SERVE)
        self.uncached_graphs = count_captures(self.uncached)
        self.out_u = self.uncached.serve(reqs)
        rep, rep_u = eng.last_report, self.uncached.last_report
        counts = {"prefix_hits": rep.prefix_hits, "prefix_hit_tokens": rep.prefix_hit_tokens,
                  "cow_forks": rep.cow_forks, "prefill_tokens": rep.prefill_tokens,
                  "uncached_prefill_tokens": rep_u.prefill_tokens,
                  "retained_pages_at_end": rep.counters[-1]["retained_pages"]}
        report["structure"] = counts
        check((rep.prefix_hits, rep.prefix_hit_tokens, rep.cow_forks) == (hits, hit_tokens, forks)
              and rep.prefill_tokens == rep_u.prefill_tokens - rep.prefix_hit_tokens
              and rep_u.prefill_tokens == sum(len(r.prompt) for r in reqs)
              and rep_u.prefix_hits == 0, f"(b) the prefix cache's counters {counts}, expected "
              f"hits {hits}, hit tokens {hit_tokens}, forks {forks}")
        report["against_uncached"] = self._against_uncached("(b) greedy", self.out, self.out_u)

        # (c) sampled
        out_s = eng.serve(reqs, **SAMPLED)
        out_su = self.uncached.serve(reqs, **SAMPLED)
        check(not same_tokens(out_s, self.out), "(c) sampled tokens equal greedy ones")
        report["sampled"] = self._against_uncached("(c) sampled", out_s, out_su, SAMPLED)

        # (d) a small pool: eviction of retained pages and preemption
        small = ContinuousBatchingEngine(cfg, self.params, prefix_cache=True, device=dev,
                                         **{**PREFIX_SERVE, "num_pages": PREFIX_SMALL_POOL})
        out_d = small.serve(reqs)
        rep_d = small.last_report
        report["small_pool"] = {"num_pages": PREFIX_SMALL_POOL, "evictions": rep_d.evictions,
                                "preemptions": small.preemptions,
                                "prefix_hits": rep_d.prefix_hits,
                                **self._against_uncached("(d) small pool", out_d, self.out_u)}
        check(rep_d.evictions > 0 and small.preemptions > 0, f"(d) {PREFIX_SMALL_POOL} pages "
              f"evicted {rep_d.evictions} retained pages and preempted {small.preemptions} times")
        small.assert_quiescent()
        del small

        # (e) the planted fault: the other rows' block-table rows left in place,
        # greedy and sampled; beside it the sound engine, both watched
        sound = WatchedEngine(cfg, self.params, prefix_cache=True, device=dev, **PREFIX_SERVE)
        check(same_tokens(sound.serve(reqs), self.out), "(e) the watched engine's tokens differ")
        faulted = UnmaskedEngine(cfg, self.params, prefix_cache=True, device=dev, **PREFIX_SERVE)
        fault = {"fault": "the tail window runs with every slot's block-table row in place"}
        for label, mode, cached, uncached in (("greedy", GREEDY, self.out, self.out_u),
                                              ("sampled", SAMPLED, out_s, out_su)):
            out_f = faulted.serve(reqs, **mode)
            fault[label] = {
                "requests_changed": sum(not np.array_equal(a, b) for a, b in zip(out_f, cached)),
                **self._against_uncached(f"(e) planted fault, {label}", out_f, uncached, mode,
                                         check_bar=False)}
        fault["hits_writing_live_pages"] = {"sound": sum(sound.touched),
                                            "faulted": sum(faulted.touched),
                                            "hits": len(sound.touched)}
        report["planted_fault"] = fault
        print("phase 10 (e) planted fault: " + json.dumps(fault), flush=True)
        check(not any(sound.touched) and any(faulted.touched), "(e) hits that wrote another live "
              f"slot's pages: {fault['hits_writing_live_pages']}")
        check(fault["greedy"]["beyond_bar"] + fault["sampled"]["beyond_bar"] > 0,
              f"(e) the planted fault passes cached vs uncached at the bar {HIT_BAR}: {fault}")
        del faulted, sound

        # (h) first-token logits of three hits: window, miss prefill, f32 prefill
        report["first_token_logits"] = self._first_token_logits()

        # (f) times: alternating rounds of the cached and the uncached serve
        rounds, admits = [], []
        for _ in range(PREFIX_ROUNDS):
            row = {}
            for name, e, want in (("cached", eng, self.out), ("uncached", self.uncached,
                                                                self.out_u)):
                out, t = e.timed_serve(reqs)
                check(same_tokens(out, want), f"(f) a {name} serve's tokens changed")
                row[name] = timing_row(t)
                admits += [(name, a) for a in e.admits]
            row["sm_clock_mhz"] = tracing.sm_clock_mhz()
            rounds.append(row)
        report["timing_rounds"] = rounds
        medians = {name: {k: sorted(r[name][k] for r in rounds)[len(rounds) // 2]
                          for k in ("step_ms_per_iter", "tokens_per_s",
                                    "host_ms_per_round_outside_steps", "admit_ms_per_round")}
                   for name in ("cached", "uncached")}
        groups = {"hit (cached serve)": [ms for n, (_, ms, hit) in admits if n == "cached" and hit],
                  "miss (cached serve)": [ms for n, (_, ms, hit) in admits
                                          if n == "cached" and not hit],
                  "miss (uncached serve)": [ms for n, (_, ms, _) in admits if n == "uncached"]}
        medians["admit_ms_median"] = {k: sorted(v)[len(v) // 2] for k, v in groups.items()}
        medians["admits_timed"] = {k: len(v) for k, v in groups.items()}
        report["timing_medians"] = medians
        report["graphs"] = {"cached": capture_report(eng, self.graphs),
                            "uncached": capture_report(self.uncached, self.uncached_graphs)}
        report["top_k_cut_decided"] = self.cuts
        print(json.dumps(report), flush=True)
        self.report = report
        self.counted_serve()

    def counted_serve(self):
        """The cached serve once more, its launches counted."""
        self.counted = {}

        def serve():
            out = self.eng.serve(self.reqs)
            self.counted["iters"] = self.eng.decode_chunk_iters
            self.counted["full_hits"] = self.eng.last_report.cow_forks
            return out
        counted_generation(self.graphs, serve, self.counted)()

    def finish(self):
        """Phase 10's launches from the counters, and its report."""
        out = self.counted
        want = dict.fromkeys(KERNEL_TAGS, 0)
        want["pim_matvec"] = len(LINEARS) * self.cfg.n_layers * (out["iters"] + out["full_hits"])
        launches = check_counters("prefix serve, counted", out, self.out, want)
        launches.update(decode_chunk_iters=out["iters"], full_hit_windows=out["full_hits"])
        print(json.dumps({"check": "phase 10: launches", **launches}))
        return {"prefix serve": out["counters"]}


# ---- 11. the resilience tier ------------------------------------------------------------
# Phase 9's engine (4 slots of 16-token pages, chunk 8, 512 positions) and
# trace.  (b): scripted transient faults (site calls), greedy; then all of
# them at rates, sampled.  A squeeze withholds 95% of the free list for a round.
CHAOS_SCRIPTED = dict(fault_rounds=(1, 4), straggle_rounds=(2, 5), squeeze_rounds=(1, 3, 6),
                      squeeze_frac=0.95)
CHAOS_COMBINED = dict(seed=SEED, fault_rate=0.3, straggle_rate=0.3, squeeze_rate=0.4,
                      squeeze_frac=0.95)
# (c): stragglers in rounds 0 and 1 lift the ladder to halve_chunk, then to
# shed_low_slo (no request of the trace is below its class); two clean rounds
# bring it down a rung.
LADDER_STRAGGLES, LADDER_COOLDOWN = (0, 1), 2
CRASH_ROUNDS = (2, 5)  # (d): the supervisor's scripted crashes (calls of the crash site)
DISK_CRASH_ROUND = 3   # (e): the crash that takes the engine object with it
RESILIENCE_ROUNDS = 2  # alternating rounds of (i) (3 before phase 16)
SNAPSHOT = Path(__file__).resolve().parent / "build" / "snapshots" / "serve.snap"


def replay_margin(params, cfg, prompt, want, got, j, mode, rid):
    """How far a replay's token ``got[j]`` is from being a sound choice where
    the undisturbed run chose ``want[j]`` after ``prompt`` and
    ``want[:j]``, in the units of the choice's values (logits, or warped
    logits plus the gumbel noise of draw (rid, j)), from a dense prefill.
    Greedy: the winner's logit above the alternative's.  Sampled (scores
    ``s`` = logit / t + noise, the top-k cut at the k-th logit): the least
    of (A) the alternative overtaking the winner, ``s[win] - s[alt]``, and,
    if it lies outside the top k, entering it, ``(k-th - logit[alt]) / t``,
    the larger of the two; (B) the winner leaving the top k,
    ``(logit[win] - first cut) / t``, with the alternative then the best of
    the rest, the larger of the two.  A replay whose logits moved by up to
    ``bar`` can only choose an alternative within ``bar / t``; one drawn
    with another key usually cannot.  The margin is negative where the
    dense prefill itself prefers the replay's token."""
    dev = params["embed"].device
    seq = torch.from_numpy(np.concatenate([prompt, np.asarray(want[:j], np.int32)]))[None]
    logits, _ = prefill(params, cfg, seq.to(dev), init_cache(cfg, 1, seq.shape[1], dev))
    lg = logits[0, -1].float()
    win, alt = int(want[j]), int(got[j])
    if mode["greedy"]:
        return (lg[win] - lg[alt]).item()
    t, k = mode["temperature"], mode["top_k"]
    keys = draw_keys(prng_key(mode["key"], dev), torch.tensor([rid], device=dev), j, TAG_TOKEN)
    score = lg / t + gumbel(keys, lg.shape[-1])[0]
    top = torch.topk(lg, k + 1)
    kth, first_cut = top.values[k - 1], top.values[k]
    overtake = (score[win] - score[alt]).item()
    if lg[alt] < kth:
        overtake = max(overtake, ((kth - lg[alt]) / t).item())
    rest = [i for i in top.indices.tolist() if i != win]  # the top k once the winner left
    leave = max(((lg[win] - first_cut) / t).item(), (score[rest].max() - score[alt]).item())
    return min(overtake, leave)


def replay_divergences(got, want, margin_at):
    """Each request's first divergence from the undisturbed tokens ``want``:
    the token and ``margin_at(r, j)`` (``replay_margin``); or, where every
    shared token agrees, the lengths when they differ."""
    out = []
    for r, (g, w) in enumerate(zip(got, want)):
        m = min(len(g), len(w))
        diff = np.flatnonzero(np.asarray(g[:m]) != np.asarray(w[:m]))
        if diff.size:
            j = int(diff[0])
            out.append({"request": r, "token": j, "margin": margin_at(r, j)})
        elif len(g) != len(w):
            out.append({"request": r, "emitted": len(g), "undisturbed": len(w)})
    return out


@contextlib.contextmanager
def admits_recorded(eng, off_by_one=False):
    """Each admit of ``eng`` inside, as a dict: resumed or not, prompt and
    prefilled lengths, host ms (an admit ends reading its token) and
    ``flash_attention`` launches (an admit past CHUNKED_THRESHOLD runs
    eagerly, so the counter sees them).  ``off_by_one``: the planted fault
    of (h), a resumed admit's draw counter one short (``_n_out = m - 1``)."""
    rows, admit = [], eng._admit

    def recorded(requests, slot, ridx, *args, resume=None, **kw):
        flash0, t0 = flash_attention.launches, time.perf_counter()
        info = admit(requests, slot, ridx, *args, resume=resume, **kw)
        rows.append({"resumed": resume is not None, "prompt": len(requests[ridx].prompt),
                     "prefilled": info["prefilled_tokens"],
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "flash_attention": flash_attention.launches - flash0})
        if off_by_one and resume is not None:
            eng._n_out[slot] -= 1
        return info
    eng._admit = recorded
    try:
        yield rows
    finally:
        del eng._admit


def injected_only(failures, inj):
    """Whether every failure a supervisor recorded is a crash the injector
    fired, one for one: a crash of any other cause (a failed chunk step, a
    sticky CUDA error) must fail the run, not be replayed away."""
    fired = [f"crash:injected engine crash at round {f.round}" for f in inj.log
             if f.site == "crash"]
    return [f.kind for f in failures] == fired


class ResiliencePhase:
    """Phase 11: the resilience tier on phase 9's engine and trace, (a) to (i)
    of the module's docstring.  ``run`` does everything but the counting and
    returns the window phase 8's profiler session traces; ``finish`` reads
    it."""

    def __init__(self, cfg, serving, prefix):
        self.cfg, self.serving, self.prefix = cfg, serving, prefix
        self.dev, self.params = serving.dev, serving.params

    def _against(self, label, got, want, reqs, mode=GREEDY, bar=HIT_BAR, check_bar=True):
        """Each request's tokens against the undisturbed serve's: a first
        divergence only where the replay's token is within ``bar`` of the
        undisturbed choice (over the temperature when sampled;
        ``replay_margin``), with the count beyond PAGED_BAR beside it, and
        no request past its budget."""
        t = mode.get("temperature", 1.0)
        with torch.inference_mode():
            div = replay_divergences(got, want, lambda r, j: replay_margin(
                self.params, self.cfg, reqs[r].prompt, want[r], got[r], j, mode, r))

        def past(d, b):
            return "margin" not in d or d["margin"] > b
        rep = {"check": f"{label}: against the undisturbed serve", "requests": len(got),
               "diverged": len(div), "beyond_bar": sum(past(d, bar / t) for d in div),
               "beyond_paged_bar": sum(past(d, PAGED_BAR / t) for d in div),
               "over_budget": sum(len(g) > r.max_new for g, r in zip(got, reqs)),
               "divergences": div, "bar": bar / t}
        print(f"phase 11 {label}: " + json.dumps(rep), flush=True)
        if check_bar:
            check(rep["beyond_bar"] == rep["over_budget"] == 0,
                  f"{label}: diverges beyond the bar {bar / t}: {rep}")
        return rep

    def _equal(self, label, rep, want):
        """Every request done, its tokens ``torch.equal`` to ``want``'s."""
        check(all(r.status == "done" for r in rep.records),
              f"{label}: statuses {[(r.status, r.reason) for r in rep.records]}")
        check(same_tokens(rep.outputs, want), f"{label}: tokens differ from the undisturbed serve")

    def _supervised(self, eng, reqs, mode, resume_mode, crash_rounds=CRASH_ROUNDS, **kw):
        """A ``ServingSupervisor`` run with scripted crashes: the restarts equal
        them, and every failure is an injected one."""
        inj = FaultInjector(ChaosConfig(crash_rounds=crash_rounds))
        sup = ServingSupervisor(eng, policy=ResiliencePolicy(resume_mode=resume_mode), chaos=inj,
                                **kw)
        rep = sup.run(reqs, **mode)
        check(rep.restarts == len(crash_rounds), f"{rep.restarts} restarts for the scripted "
              f"crashes {crash_rounds}")
        check(injected_only(rep.failures, inj), f"failures that no injection explains: "
              f"{[f.kind for f in rep.failures]}, injected {inj.log}")
        eng.assert_quiescent()
        return rep

    def run(self):
        cfg, dev, serving = self.cfg, self.dev, self.serving
        eng, reqs = serving.eng, serving.reqs
        report = {"check": "phase 11: the resilience tier, qwen2-1.5b int8, phase 9's engine "
                           "and trace"}
        t_phase = time.perf_counter()

        # (a) a policy and no chaos: the no-policy serve, events equal under a VirtualClock
        eng._clock = VirtualClock()
        try:
            plain = eng.serve_detailed(reqs)
            hardened = eng.serve_detailed(reqs, policy=ResiliencePolicy())
        finally:
            eng._clock = time.monotonic
        self.base_prefill = plain.prefill_tokens
        same = {"tokens_equal": same_tokens(hardened.outputs, serving.out)
                and same_tokens(plain.outputs, serving.out),
                "events_equal": [r.events for r in hardened.records]
                == [r.events for r in plain.records],
                "counters_equal": hardened.counters == plain.counters,
                "snapshot_finished": len(eng.last_snapshot.finished),
                "rounds": hardened.rounds}
        report["policy_without_chaos"] = same
        check(same["tokens_equal"] and same["events_equal"] and same["counters_equal"]
              and same["snapshot_finished"] == len(reqs), f"(a) a policy alone changed the "
              f"serve: {same}")

        # (b) transient faults, scripted greedy and combined sampled
        report["transient"] = []
        for label, chaos_kw, mode, want in (
                ("(b) scripted, greedy", CHAOS_SCRIPTED, GREEDY, serving.out),
                ("(b) combined, sampled", CHAOS_COMBINED, SAMPLED, serving.out_sampled)):
            inj = FaultInjector(ChaosConfig(**chaos_kw))
            pre0 = eng.preemptions
            rep = eng.serve_detailed(reqs, chaos=inj, **mode)
            self._equal(label, rep, want)
            counts = inj.counts
            squeezed = sum(int(f.detail.split()[0]) for f in inj.log if f.site == "squeeze")
            row = {"case": label, "injected": counts, "retries": rep.retries,
                   "squeezed_pages": rep.squeezed_pages, "straggle_s": rep.straggle_s,
                   "preemptions": eng.preemptions - pre0, "rounds": rep.rounds,
                   "max_ladder_level": rep.max_ladder_level}
            report["transient"].append(row)
            check(all(counts.get(s, 0) > 0 for s in ("chunk", "straggle", "squeeze"))
                  and rep.retries == counts["chunk"] and rep.squeezed_pages == squeezed
                  and math.isclose(rep.straggle_s, counts["straggle"] * inj.cfg.straggle_s),
                  f"{label}: the report's counts disagree with the injector's log: {row}")
            eng.assert_quiescent()

        # (c) the ladder reaches halve_chunk and recovers
        rep = eng.serve_detailed(reqs, chaos=FaultInjector(ChaosConfig(
            straggle_rounds=LADDER_STRAGGLES)), policy=ResiliencePolicy(
            ladder=LadderConfig(cooldown=LADDER_COOLDOWN)))
        self._equal("(c) ladder", rep, serving.out)
        halved = self._halved_rounds(rep)
        iters = sum(SERVE["chunk"] // 2 if c["round"] in halved else SERVE["chunk"]
                    for c in rep.counters)
        report["ladder"] = {"trace": rep.ladder_trace, "max_level": rep.max_ladder_level,
                            "halved_rounds": sorted(halved), "rounds": rep.rounds,
                            "decode_chunk_iters": eng.decode_chunk_iters}
        check(halved and any(r == "recovered" for _, _, r in rep.ladder_trace)
              and eng.decode_chunk_iters == iters, f"(c) the ladder: {report['ladder']}, "
              f"expected {iters} chunk iterations")

        # (d) crash replay by the supervisor: recompute exact, prefill at HIT_BAR
        report["crash_replay"] = {}
        with admits_recorded(eng) as admits:
            for mode_name, mode, want in (("greedy", GREEDY, serving.out),
                                          ("sampled", SAMPLED, serving.out_sampled)):
                rep = self._supervised(eng, reqs, mode, "recompute")
                self._equal(f"(d) recompute, {mode_name}", rep, want)
                start = len(admits)
                rep = self._supervised(eng, reqs, mode, "prefill")
                check(all(r.status == "done" for r in rep.records), "(d) prefill replay: "
                      f"{[(r.status, r.reason) for r in rep.records]}")
                resumed = [a for a in admits[start:] if a["resumed"]]
                report["crash_replay"][mode_name] = {
                    "restarts": rep.restarts, "failures": [f.kind for f in rep.failures],
                    "resumed_admits": len(resumed),
                    "resumed_extra_tokens": sum(a["prefilled"] - a["prompt"] for a in resumed),
                    **self._against(f"(d) prefill replay, {mode_name}", rep.outputs, want,
                                    reqs, mode)}
                check(resumed, "(d) no in-flight request was resumed mid-stream")
                if mode_name == "greedy":
                    self.recovery = {"resumed": resumed, "prefill_tokens": sum(
                        a["prefilled"] for a in admits[start:]), "fresh_admit_ms": sorted(
                        a["ms"] for a in admits[start:] if not a["resumed"])}

        # (e) a fresh engine resumes from the snapshot file
        SNAPSHOT.parent.mkdir(parents=True, exist_ok=True)
        SNAPSHOT.unlink(missing_ok=True)
        inj = FaultInjector(ChaosConfig(crash_rounds=(DISK_CRASH_ROUND,)))
        first = ServingSupervisor(eng, chaos=inj, max_restarts=0, snapshot_path=str(SNAPSHOT))
        try:
            first.run(reqs)
            check(False, "(e) the scripted crash did not fire")
        except EngineCrash:
            pass
        check(injected_only(first.failures, inj), f"(e) failures {first.failures}")
        snap = load_snapshot(str(SNAPSHOT))
        check(snap is not None and snap.inflight, "(e) no in-flight request in the snapshot file")
        fresh = TimedEngine(cfg, self.params, device=dev, **SERVE)
        graphs = count_captures(fresh)
        check(fresh.params is eng.params, "(e) the fresh engine does not share the parameters")
        rep = ServingSupervisor(fresh, snapshot_path=str(SNAPSHOT)).run(reqs)
        check(all(r.status == "done" for r in rep.records), "(e) the resumed trace left "
              f"requests unfinished: {[(r.status, r.reason) for r in rep.records]}")
        report["fresh_engine_from_disk"] = {
            "snapshot_round": snap.round, "inflight": sorted(snap.inflight),
            "finished": sorted(snap.finished), "graphs": capture_report(fresh, graphs),
            **self._against("(e) fresh engine from disk", rep.outputs, serving.out, reqs)}
        fresh.assert_quiescent()
        del fresh, graphs

        # (f) a crash during the long serve: the resumed long admit through flash_attention
        long_eng = serving.long_serve
        with admits_recorded(long_eng) as admits:
            rep = self._supervised(long_eng, serving.long_reqs, GREEDY, "prefill",
                                   crash_rounds=(1,))
        long_resumed = [a for a in admits if a["resumed"] and a["prompt"] == LONG_PROMPT]
        self.long_resumed_flash = sum(a["flash_attention"] for a in long_resumed)
        report["long_crash"] = {"admits": admits, **self._against(
            "(f) long serve, crash replay", rep.outputs, serving.long_out, serving.long_reqs)}
        check(len(long_resumed) == 1 and self.long_resumed_flash == cfg.n_layers,
              f"(f) the resumed long admit: {long_resumed}, expected one with "
              f"{cfg.n_layers} flash_attention launches")

        # (g) the router over two engines on phase 10's trace, cache on and off
        trace = self.prefix.reqs
        report["router"] = {}
        for label, cached, first_eng, want in (("cached", True, self.prefix.eng, self.prefix.out),
                                               ("uncached", False, self.prefix.uncached,
                                                self.prefix.out_u)):
            second = TimedEngine(cfg, self.params, prefix_cache=cached, device=dev,
                                 **PREFIX_SERVE)
            router = ReplicaRouter([first_eng, second])
            assign = router.route(trace)
            rep = router.serve_detailed(trace)
            check(rep.assignments == assign and len(set(assign)) == 2, f"(g) {label}: "
                  f"assignments {rep.assignments}, route gave {assign}")
            row = {"assignments": assign, "affinity_hits": rep.affinity_hits,
                   "prefix_hits": rep.prefix_hits, "prefill_tokens": rep.prefill_tokens}
            if cached:
                row.update(self._against("(g) router, cached", rep.outputs, want, trace))
            else:
                self._equal("(g) router, uncached", rep, want)
            report["router"][label] = row
            del second, router

        # (h) the planted fault: a resumed admit's draw counter one short
        with admits_recorded(eng, off_by_one=True):
            rep = self._supervised(eng, reqs, SAMPLED, "prefill")
        fault = self._against("(h) planted fault, sampled prefill replay", rep.outputs,
                              serving.out_sampled, reqs, SAMPLED, check_bar=False)
        report["planted_fault"] = {"fault": "a resumed admit's draw counter is m - 1", **fault}
        check(fault["beyond_bar"] > 0, f"(h) the planted fault passes the replay check: {fault}")

        # (i) times
        report["timing"] = self._timings(eng, reqs)
        report["phase_s"] = time.perf_counter() - t_phase
        print(json.dumps(report), flush=True)
        self.report = report
        self.counted_serve()

    @staticmethod
    def _halved_rounds(rep):
        """The rounds that ran a halved chunk: a rung is set by the rounds
        before."""
        out = set()
        for c in rep.counters:
            level = 0
            for r, lvl, _ in rep.ladder_trace:
                if r < c["round"]:
                    level = lvl
            if level >= 1:
                out.add(c["round"])
        return out

    def _timings(self, eng, reqs):
        """(i): alternating rounds of phase 9's serve with no policy, with a
        policy snapshotting each round in memory and to disk (fsync), and
        the sampled serve undisturbed and under combined chaos; the crash's
        recovery cost from (d)."""
        def to_disk(snap):
            save_snapshot(str(SNAPSHOT), snap)
        runs = {"no policy": {}, "policy, snapshots in memory": {"policy": ResiliencePolicy()},
                "policy, snapshots to disk": {"policy": ResiliencePolicy(snapshot_sink=to_disk)},
                "sampled": SAMPLED, "sampled, combined chaos": None}
        rounds = []
        for _ in range(RESILIENCE_ROUNDS):
            row = {}
            for name, kw in runs.items():
                if kw is None:
                    kw = {"chaos": FaultInjector(ChaosConfig(**CHAOS_COMBINED)), **SAMPLED}
                out, t = eng.timed_serve(reqs, **kw)
                want = self.serving.out_sampled if name.startswith("sampled") else self.serving.out
                check(same_tokens(out, want), f"(i) the timed serve {name!r} changed its tokens")
                row[name] = timing_row(t)
            row["sm_clock_mhz"] = tracing.sm_clock_mhz()
            rounds.append(row)
        medians = {name: {k: sorted(r[name][k] for r in rounds)[len(rounds) // 2]
                          for k in ("tokens_per_s", "host_ms_per_round_outside_steps",
                                    "step_ms_per_iter")} for name in runs}
        rec = self.recovery
        resumed_ms = sorted(a["ms"] for a in rec["resumed"])
        fresh_ms = rec["fresh_admit_ms"]
        return {"rounds": rounds, "medians": medians, "recovery": {
            "resumed_admits": len(resumed_ms), "resumed_admit_ms": resumed_ms,
            "resumed_admit_ms_total": sum(resumed_ms),
            "fresh_admit_ms_median": fresh_ms[len(fresh_ms) // 2] if fresh_ms else None,
            "resumed_prefill_tokens": sum(a["prefilled"] for a in rec["resumed"]),
            "extra_prefill_tokens": rec["prefill_tokens"] - self.base_prefill}}

    def counted_serve(self):
        """The ladder serve of (c) once more, its launches counted."""
        eng, self.counted = self.serving.eng, {}

        def serve():
            rep = eng.serve_detailed(self.serving.reqs, chaos=FaultInjector(ChaosConfig(
                straggle_rounds=LADDER_STRAGGLES)), policy=ResiliencePolicy(
                ladder=LadderConfig(cooldown=LADDER_COOLDOWN)))
            self.counted["iters"] = eng.decode_chunk_iters
            self.counted["halved_rounds"] = len(self._halved_rounds(rep))
            return rep.outputs
        counted_generation(self.serving.graphs, serve, self.counted)()

    def finish(self):
        """Phase 11's launches from the counters, and its report."""
        out = self.counted
        want = dict.fromkeys(KERNEL_TAGS, 0)
        want["pim_matvec"] = len(LINEARS) * self.cfg.n_layers * out["iters"]
        launches = check_counters("ladder serve, counted", out, self.serving.out, want)
        launches.update(decode_chunk_iters=out["iters"], halved_rounds=out["halved_rounds"],
                        resumed_long_admit_flash_attention=self.long_resumed_flash)
        print(json.dumps({"check": "phase 11: launches", **launches}))
        return {"ladder serve": out["counters"]}


# ---- 12. n-gram speculative decoding ---------------------------------------------------
# (a) the fixed engine on phase 3's prompts and budget, (b) the continuous engine
# on phase 9's and phase 10's traces, all at k = SPEC_K.
SPEC_K = 4
SPEC_WIDTHS = (1, 2, 4)   # (d): window ms at 4 rows, each width
SPEC_TIME_REPS = 16       # (d): replays a timed window or step, per round
SPEC_ROUNDS = 2           # (d): alternating rounds of plain steps and windows (was 3)
SPEC_SERVE_ROUNDS = 1     # (d): rounds of plain and speculative serves (2 before phase 16)
# (b): the continuous engine's controller starts optimistic (an acceptance
# estimate of 1), so its first rounds run k-wide windows and it narrows them
# as it measures; from the default estimate of 0 it would stay at width 0 on
# text whose proposals it never sees accepted.
SPEC_ADAPTIVE = dict(k=SPEC_K, adaptive=True, ctrl_init=1.0)
# (b), and phase 14 (d): the eager twins serve the trace's first requests at
# this budget (an eager window runs op by op: the whole trace eagerly took
# 5-10 s a serve; they served it whole before phase 16).
SPEC_EAGER_NEW = 16


@contextlib.contextmanager
def greedy_accept_one_more():
    """The planted fault of (c): greedy acceptance takes one proposal more
    than matched (never more than k)."""
    sound = speculative.greedy_accept

    def faulted(window, logits):
        g, a = sound(window, logits)
        return g, torch.clamp_max(a + 1, window.shape[1] - 1)
    speculative.greedy_accept = faulted
    try:
        yield
    finally:
        speculative.greedy_accept = sound


def first_requests(reqs, n=SERVE["slots"]):
    """The trace's first ``n`` requests at a budget of at most
    SPEC_EAGER_NEW new tokens, their stops kept."""
    return [Request(prompt=r.prompt, max_new=min(r.max_new, SPEC_EAGER_NEW),
                    stop_tokens=r.stop_tokens) for r in reqs[:n]]


def plain_gap(eng, prompt, r, j, extras=None):
    """The top-2 gap of the plain captured run's logits that chose token j
    of row r (the same batch and extras, ``eng``'s decode step)."""
    eng.generate(prompt, j + 1, extras=extras)
    return top2_gap(eng.state(prompt.shape[0]).logits[r])


def spec_vs_plain(name, label, eng, prompt, got, want, check_bar=True, bar=HIT_BAR, extras=None):
    """Greedy speculation against plain greedy decoding of the same batch:
    a first divergence only where the plain run's top-2 gap is within
    ``bar``, the count beyond PAGED_BAR beside it."""
    got_l, want_l = list(got.cpu().numpy()), list(want.cpu().numpy())
    with torch.inference_mode():
        div = divergences(got_l, want_l, [len(w) for w in want_l],
                          lambda r, j: plain_gap(eng, prompt, r, j, extras))
    rep = {"check": f"{label}: against plain greedy decoding", "rows": len(got_l),
           "equal": torch.equal(got, want), "diverged": len(div),
           "beyond_bar": sum(beyond(d, bar) for d in div),
           "beyond_paged_bar": sum(beyond(d, PAGED_BAR) for d in div),
           "divergences": div, "bar": bar}
    print(f"{name} {label}: " + json.dumps(rep), flush=True)
    if check_bar:
        check(rep["beyond_bar"] == 0, f"{label}: diverges from plain greedy decoding beyond "
                                      f"the bar {bar}: {rep}")
    return rep


class EagerServingEngine(ServingEngine):
    """The fixed engine with every step and window run eagerly (no graph),
    on buffers of its own: the reference a captured generation is held
    against, bit for bit."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.graphs.get = lambda params, key, pool_key, run, reset, bounded=False: run


class RecordedWidths:
    """The rounds' (chunk iterations, window width) of ``eng``, as
    ``_round_width`` picks them."""

    def __init__(self, eng):
        self.rounds, pick = [], eng._round_width

        def recorded(ladder):
            self.rounds.append(pick(ladder))
            return self.rounds[-1]
        eng._round_width = recorded


class SpecPhase:
    """Phase 12: n-gram speculative decoding on both engines, (a) to (d) of
    the module's docstring."""

    NAME = "phase 12"

    def __init__(self, cfg, params, prompt, toks, serving, prefix):
        self.cfg, self.params, self.prompt, self.toks = cfg, params, prompt, toks
        self.serving, self.prefix, self.dev = serving, prefix, prompt.device
        self.per_step = len(LINEARS) * cfg.n_layers

    # ---- (a) the fixed engine ----------------------------------------------------------
    def _plain_gap(self, eng, prompt, r, j):
        return plain_gap(eng, prompt, r, j)

    def _against_plain(self, label, eng, prompt, got, want, check_bar=True):
        return spec_vs_plain(self.NAME, label, eng, prompt, got, want, check_bar)

    def fixed(self, report):
        cfg, dev, prompt = self.cfg, self.dev, self.prompt
        eng = ServingEngine(cfg, self.params, max_seq=PROMPT + N_NEW, device=dev)
        eager = EagerServingEngine(cfg, self.params, max_seq=PROMPT + N_NEW, device=dev)
        self.fixed_eng, self.fixed_graphs = eng, count_captures(eng)
        plain = eng.generate(prompt, N_NEW)
        check(torch.equal(plain, self.toks), "(a) the plain generate differs from phase 3's")
        spec = SpecConfig(k=SPEC_K)
        cases = (("greedy", spec, GREEDY), ("sampled exact", spec, SAMPLED),
                 ("typical", SpecConfig(k=SPEC_K, accept="typical"), SAMPLED),
                 ("adaptive greedy", SpecConfig(k=SPEC_K, adaptive=True), GREEDY))
        rows = []
        for label, sp, mode in cases:
            got = eng.generate(prompt, N_NEW, speculate=sp, **mode)
            want = eager.generate(prompt, N_NEW, speculate=sp, **mode)
            row = {"case": label, "batch": BATCH, "window_rows": BATCH * (sp.k + 1),
                   "tokens_equal_eager": torch.equal(got, want),
                   "windows_equal_eager": eng.spec_stats == eager.spec_stats,
                   "spec_stats": dict(eng.spec_stats)}
            check(got.dtype == torch.int32 and bool(((got >= 0) & (got < cfg.vocab)).all()),
                  f"(a) {label}: tokens {got.dtype} out of range")
            check(row["tokens_equal_eager"] and row["windows_equal_eager"],
                  f"(a) {label}: the captured windows differ from the eager ones: {row}")
            if mode["greedy"]:
                row["vs_plain"] = self._against_plain(f"(a) {label}", eng, prompt, got, plain)
            rows.append(row)
            if label == "greedy":
                self.fixed_greedy = got

        # batch 1: a 5-row window, through pim_matvec
        p1 = prompt[:1]
        plain1 = eng.generate(p1, N_NEW)
        got1 = eng.generate(p1, N_NEW, speculate=spec)
        check(torch.equal(got1, eager.generate(p1, N_NEW, speculate=spec))
              and eng.spec_stats == eager.spec_stats,
              "(a) batch 1: the captured windows differ from the eager ones")
        _, launches, counted_as = counted_launches(
            self.fixed_graphs, lambda: eng.generate(p1, N_NEW, speculate=spec))
        windows = eng.spec_stats["verify_steps"]
        want = dict.fromkeys(launches, 0)
        want["pim_matvec"] = self.per_step * windows
        check(launches == want, f"(a) batch 1: launches {launches}, expected {want} "
                                f"({windows} windows of {spec.k + 1} rows)")
        row1 = {"case": "greedy, batch 1", "batch": 1, "window_rows": spec.k + 1,
                "tokens_equal_eager": True, "spec_stats": dict(eng.spec_stats),
                "launches": launches, "launches_counted_as": counted_as,
                "vs_plain": self._against_plain("(a) greedy, batch 1", eng, p1, got1, plain1)}
        row1["equal_to_plain_batch_1"] = torch.equal(got1, plain1)
        rows.append(row1)
        self.launches["fixed engine, batch 1 windows"] = launches
        # batch 4 at k = 4: 20-row windows through x @ dq(w), no pim_matvec
        _, launches4, _ = counted_launches(
            self.fixed_graphs, lambda: eng.generate(prompt, N_NEW, speculate=spec))
        check(launches4 == dict.fromkeys(launches4, 0), f"(a) batch 4, k = {SPEC_K}: launches "
              f"{launches4}, expected none (20-row windows go through x @ dq(w))")
        report["fixed"] = rows
        del eager

        # (c) the planted fault: greedy acceptance one proposal too many
        with greedy_accept_one_more():
            faulty = ServingEngine(cfg, self.params, max_seq=PROMPT + N_NEW, device=dev)
            bad = faulty.generate(prompt, N_NEW, speculate=spec)
        fault = self._against_plain("(c) planted fault", eng, prompt, bad, plain,
                                    check_bar=False)
        report["planted_fault"] = {"fault": "greedy_accept accepts one proposal more than "
                                            "matched", "rows_changed": int(
                                       (bad != self.fixed_greedy).any(dim=1).sum()), **fault}
        check(fault["beyond_bar"] > 0, f"(c) the planted fault passes against plain decoding: "
                                       f"{report['planted_fault']}")
        del faulty

    @torch.inference_mode()
    def window_times(self, report):
        """(d): ms a window at each width (CUDA events over replays) against
        the plain captured step, at 4 rows and at 1, in alternating rounds."""
        eng, cfg, prompt = self.fixed_eng, self.cfg, self.prompt
        runs, plain_of = {}, {}
        for b in (BATCH, 1):
            p = prompt[:b]
            plain_of[b] = f"plain step, {b} rows"
            runs[plain_of[b]] = (
                eng.step(b, greedy=True, top_k=0), functools.partial(
                    eng.state(b).start, self.params, cfg, p, None, 1.0, greedy=True, top_k=0),
                b, b)
            for k in (SPEC_WIDTHS if b == BATCH else (SPEC_K,)):
                sp = SpecConfig(k=k)
                runs[f"window k={k}, {b} x {k + 1} rows"] = (
                    eng.spec_step(b, sp, greedy=True, top_k=0), functools.partial(
                        eng.spec_state(b).start, self.params, p, None, 1.0, N_NEW,
                        greedy=True, top_k=0, ctrl_init=0.0), b * (k + 1), b)

        def ms(step, start):
            start()
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(SPEC_TIME_REPS):
                step()
            z.record()
            z.synchronize()
            return a.elapsed_time(z) / SPEC_TIME_REPS

        rounds = []
        for _ in range(SPEC_ROUNDS):
            rounds.append({name: ms(step, start) for name, (step, start, _, _) in runs.items()})
            rounds[-1]["sm_clock_mhz"] = tracing.sm_clock_mhz()
        med = {name: sorted(r[name] for r in rounds)[len(rounds) // 2] for name in runs}
        rows = []
        for name, (_, _, m, b) in runs.items():
            rows.append({"run": name, "rows": m,
                         "linears_through": ("pim_matvec" if m <= common.MATVEC_MAX_M
                                             else "x @ dq(w)"),
                         "ms": med[name], "over_plain_step": med[name] / med[plain_of[b]]})
        report["window_ms"] = {"timing": "device ms a replay, CUDA events over "
                                         f"{SPEC_TIME_REPS} replays, median of {SPEC_ROUNDS} "
                                         "alternating rounds", "rows": rows, "rounds": rounds}

    # ---- (b) the continuous engine -----------------------------------------------------
    def _engines(self, spec, **kw):
        geo = {**SERVE, **kw}
        eng = TimedEngine(self.cfg, self.params, speculate=spec, device=self.dev, **geo)
        eng.debug_check_hist = True
        eager = EagerEngine(self.cfg, self.params, speculate=spec, device=self.dev, **geo)
        return eng, count_captures(eng), eager

    def _captured_vs_eager(self, label, eng, eager, reqs, mode=GREEDY, first=False):
        """``eng``'s serve of ``reqs`` (returned, with its numbers) against
        ``eager``'s (tokens, events, peak pages): of the same requests, or
        with ``first`` of the trace's first requests at SPEC_EAGER_NEW
        (``first_requests``), served by both engines again."""
        out = eng.serve(reqs, **mode)
        rep = eng.last_report
        same = {"case": label, "rounds": rep.rounds, "decode_chunk_iters": eng.decode_chunk_iters,
                "spec_emitted": eng.spec_emitted, "spec_live_steps": eng.spec_live_steps,
                "tokens": sum(len(o) for o in out),
                "eff_k_by_round": [c["eff_k"] for c in rep.counters],
                "prefix_hits": rep.prefix_hits, "prefix_hit_tokens": rep.prefix_hit_tokens,
                "cow_forks": rep.cow_forks}
        same["acceptance"] = eng.spec_emitted / max(1, eng.spec_live_steps)
        same["tokens_per_chunk_iter"] = same["tokens"] / max(1, eng.decode_chunk_iters)
        twin, got = reqs, out
        if first:
            twin = first_requests(reqs)
            got, rep = eng.serve(twin, **mode), eng.last_report
            same["eager_twin"] = (f"the first {len(twin)} requests, at most {SPEC_EAGER_NEW} "
                                  "new tokens each")
        out_e = eager.serve(twin, **mode)
        same.update(tokens_equal=same_tokens(got, out_e),
                    events_equal=events_of(rep) == events_of(eager.last_report),
                    peak_pages=[eng.peak_pages_in_use, eager.peak_pages_in_use])
        check(same["tokens_equal"] and same["events_equal"]
              and eng.peak_pages_in_use == eager.peak_pages_in_use,
              f"{self.NAME} {label}: the captured serve differs from the eager one: {same}")
        eng.assert_quiescent()
        return out, same

    def _against_dense(self, label, out):
        """Greedy speculation against phase 9's solo dense runs at HIT_BAR."""
        sv = self.serving
        with torch.inference_mode():
            rep = paged_vs_dense(label, out, sv.dense, sv.lengths, lambda r, j: sv._gap(
                sv.solo, torch.from_numpy(sv.prompts[r])[None].to(self.dev), j), HIT_BAR)
        rep["beyond_paged_bar"] = sum(beyond(d, PAGED_BAR) for d in rep["divergences"])
        rep["requests_equal_plain_serve"] = sum(
            np.array_equal(a, b) for a, b in zip(out, sv.out))
        print(f"{self.NAME} {label}: " + json.dumps(rep), flush=True)
        return rep

    def continuous(self, report):
        sv, reqs = self.serving, self.serving.reqs
        rows = []
        spec = SpecConfig(k=SPEC_K)
        eng, graphs, eager = self._engines(spec)
        self.serve_eng, self.serve_graphs = eng, graphs
        self.out, same = self._captured_vs_eager("greedy", eng, eager, reqs, first=True)
        same["vs_dense"] = self._against_dense("(b) greedy speculation", self.out)
        rows.append(same)
        self.out_sampled, same = self._captured_vs_eager("sampled", eng, eager, reqs, SAMPLED,
                                                         first=True)
        check(not same_tokens(self.out_sampled, self.out), "(b) sampled tokens equal greedy ones")
        rows.append(same)
        del eager

        # the adaptive controller: widths per round, k = 0 rounds plain
        aeng, agraphs, aeager = self._engines(SpecConfig(**SPEC_ADAPTIVE))
        widths = RecordedWidths(aeng)
        out_a, same = self._captured_vs_eager("adaptive greedy", aeng, aeager, reqs, first=True)
        same["vs_dense"] = self._against_dense("(b) adaptive greedy speculation", out_a)
        rows.append(same)
        del aeager
        widths.rounds.clear()
        _, launches, counted_as = counted_launches(agraphs, lambda: aeng.serve(reqs))
        via = sum(c for c, k in widths.rounds
                  if k is None or SERVE["slots"] * (k + 1) <= common.MATVEC_MAX_M)
        want = dict.fromkeys(launches, 0)
        want["pim_matvec"] = self.per_step * via
        check(launches == want, f"(b) adaptive serve: launches {launches}, expected {want} "
                                f"from its rounds {widths.rounds}")
        check(via > 0, f"(b) adaptive serve: no round of width 0 or of <= 8 rows {widths.rounds}")
        self.launches["continuous engine, adaptive serve"] = launches
        report["adaptive_launches"] = {"launches": launches, "counted_as": counted_as,
                                       "rounds_chunk_and_width": widths.rounds,
                                       "iterations_through_pim_matvec": via}
        self.adaptive = (aeng, agraphs)

        # the prefix cache stays on under n-gram speculation
        peng, pgraphs, peager = self._engines(spec, prefix_cache=True, **PREFIX_SERVE)
        out_p, same = self._captured_vs_eager("prefix cache, greedy", peng, peager,
                                              self.prefix.reqs, first=True)
        check(same["prefix_hits"] > 0, "(b) no prefix hit under speculation")
        rows.append(same)
        report["continuous"] = rows
        report["graphs"] = {"fixed engine": capture_report(self.fixed_eng, self.fixed_graphs),
                            "serve, k = 4": capture_report(eng, graphs),
                            "serve, adaptive": capture_report(aeng, agraphs),
                            "serve, prefix cache": capture_report(peng, pgraphs)}
        del peng, peager, pgraphs

        # the resilience tier: transient faults, the has_spec ladder, a crash
        inj = FaultInjector(ChaosConfig(**CHAOS_SCRIPTED))
        rep = eng.serve_detailed(reqs, chaos=inj, policy=ResiliencePolicy(
            ladder=LadderConfig(enabled=False)))
        transient = {"injected": inj.counts, "retries": rep.retries,
                     "squeezed_pages": rep.squeezed_pages,
                     "tokens_equal": same_tokens(rep.outputs, self.out)}
        check(all(r.status == "done" for r in rep.records) and transient["tokens_equal"],
              f"(b) transient faults changed the speculative serve: {transient}")
        rep = eng.serve_detailed(reqs, chaos=FaultInjector(ChaosConfig(
            straggle_rounds=LADDER_STRAGGLES)), policy=ResiliencePolicy(
            ladder=LadderConfig(cooldown=LADDER_COOLDOWN)))
        ladder = {"trace": rep.ladder_trace, "max_level": rep.max_ladder_level,
                  "eff_k_by_round": [c["eff_k"] for c in rep.counters],
                  "tokens_equal": same_tokens(rep.outputs, self.out),
                  "vs_dense": self._against_dense("(b) ladder", rep.outputs)}
        check(all(r.status == "done" for r in rep.records)
              and {SPEC_K // 2, 0} <= set(ladder["eff_k_by_round"]),
              f"(b) the ladder did not halve and drop the window: {ladder}")
        inj, snaps = FaultInjector(ChaosConfig(crash_rounds=(CRASH_ROUNDS[0],))), []
        rep = ServingSupervisor(eng, policy=ResiliencePolicy(
            resume_mode="recompute", snapshot_sink=snaps.append), chaos=inj).run(reqs)
        wctrs = [st.wctr for snap in snaps for st in snap.inflight.values()]
        crash = {"restarts": rep.restarts, "failures": [f.kind for f in rep.failures],
                 "tokens_equal": same_tokens(rep.outputs, self.out), "snapshots": len(snaps),
                 "inflight_wctr_max": max(wctrs, default=0)}
        check(rep.restarts == 1 and injected_only(rep.failures, inj) and crash["tokens_equal"]
              and crash["inflight_wctr_max"] > 0,
              f"(b) recompute crash replay of the speculative serve: {crash}")
        eng.assert_quiescent()
        report["resilience"] = {"transient, ladder off": transient, "ladder": ladder,
                                "crash replay, recompute": crash}

    def serve_times(self, report):
        """(d): alternating rounds of phase 9's plain serve and the speculative
        serve, greedy and sampled, and the adaptive serve: tokens/s (host
        clock), chunk-iteration ms (CUDA events), emitted tokens an
        iteration."""
        plain, spec, (adaptive, _) = self.serving.eng, self.serve_eng, self.adaptive
        runs = {"plain": (plain, GREEDY, self.serving.out),
                "speculative": (spec, GREEDY, self.out),
                "adaptive": (adaptive, GREEDY, None),
                "plain, sampled": (plain, SAMPLED, self.serving.out_sampled),
                "speculative, sampled": (spec, SAMPLED, self.out_sampled)}
        rounds = []
        for _ in range(SPEC_SERVE_ROUNDS):
            row = {}
            for name, (e, mode, want) in runs.items():
                out, t = e.timed_serve(self.serving.reqs, **mode)
                if want is not None:
                    check(same_tokens(out, want), f"(d) the timed serve {name!r} changed")
                row[name] = {**timing_row(t), "tokens_per_chunk_iter": t["tokens"] / t["iters"]}
            row["sm_clock_mhz"] = tracing.sm_clock_mhz()
            rounds.append(row)
        med = {name: {k: sorted(r[name][k] for r in rounds)[len(rounds) // 2]
                      for k in ("tokens_per_s", "step_ms_per_iter", "tokens_per_chunk_iter",
                                "host_ms_per_round_outside_steps")} for name in runs}
        for a, b in (("speculative", "plain"), ("speculative, sampled", "plain, sampled"),
                     ("adaptive", "plain")):
            med[a]["tokens_per_s_over_plain"] = med[a]["tokens_per_s"] / med[b]["tokens_per_s"]
        report["serve_times"] = {"rounds": rounds, "medians": med}

    def run(self):
        report = {"check": "phase 12: n-gram speculative decoding, qwen2-1.5b int8",
                  "section_s": {}}
        t0 = time.perf_counter()
        self.launches = {}
        for part in (self.fixed, self.window_times, self.continuous, self.serve_times):
            t = time.perf_counter()
            part(report)
            report["section_s"][part.__name__] = time.perf_counter() - t
        report["launches"] = self.launches
        report["phase_s"] = time.perf_counter() - t0
        print(json.dumps(report), flush=True)
        return self.launches


# ---- 13. draft-model speculation -------------------------------------------------------
# The draft is qwen2-1.5b itself: the target's int8 tree (a self-draft) or the
# same weights' int4 tree (eng4's), both at k = SPEC_K.  (a) and (d) run the
# fixed engine at batch 1, (b) at phase 3's batch, (c) the continuous engine
# on phase 9's trace.
DRAFT_ROUNDS = 2  # (e): alternating rounds of steps and windows (3 before phase 16)
DRAFT_SERVE_ROUNDS = 1  # (e): rounds of serves (3 before phase 15, 2 before phase 16)
DRAFT_TIME_REPS = 8  # (e): replays a timed step or window, per round
DRAFT_EAGER_NEW = 16  # (b): the eager twins' budget (an eager window runs k + 2
                      # forward passes op by op); (c)'s is SPEC_EAGER_NEW


@contextlib.contextmanager
def draft_reads_one_off():
    """The planted fault of (d): the draft chain runs one position past the
    window's, reading and writing its cache at ``pos + i + 1``."""
    sound = speculative.draft_propose

    def faulted(draft_params, draft_cfg, dcache, tok, pos, k, **kw):
        return sound(draft_params, draft_cfg, dcache, tok, pos + 1, k, **kw)
    speculative.draft_propose = faulted
    try:
        yield
    finally:
        speculative.draft_propose = sound


class DraftPhase(SpecPhase):
    """Phase 13: draft-model speculation on both engines, (a) to (e) of the
    module's docstring."""

    NAME = "phase 13"

    def __init__(self, cfg, params8, params4, prompt, serving, prefix):
        super().__init__(cfg, params8, prompt, None, serving, prefix)
        self.drafts = {8: params8, 4: params4}
        self.spec = SpecConfig(k=SPEC_K, mode="draft")

    def _fixed(self, bits, cls=ServingEngine):
        return cls(self.cfg, self.params, max_seq=PROMPT + N_NEW, device=self.dev,
                   draft_cfg=self.cfg, draft_params=self.drafts[bits])

    def _engines(self, spec, **kw):
        return super()._engines(spec, draft_cfg=self.cfg, draft_params=self.drafts[4], **kw)

    @torch.inference_mode()
    def _windows(self, eng, prompt):
        """One batch-1 generation window by window, the emitted count read
        after each: [(tokens before, tokens emitted)], and the tokens."""
        k = self.spec.k
        step = eng.spec_step(1, self.spec, greedy=True, top_k=0)
        st = eng.spec_state(1)
        st.start(eng.params, prompt, None, 1.0, N_NEW, greedy=True, top_k=0,
                 ctrl_init=0.0, draft_params=eng.draft_params, k=k)
        rows, n = [], 1
        while n < N_NEW:
            step()
            m = int(st.n_em[0]) - n
            rows.append((n, m))
            n += m
        return rows, st.out[:, :N_NEW].clone()

    def _acceptance(self, eng, prompt, plain, label):
        """Windows that accepted fewer proposals than the budget allowed, each
        with the plain run's top-2 gap at the token the target chose there."""
        k = self.spec.k
        rows, toks = self._windows(eng, prompt)
        short = [(n, m) for n, m in rows if m < min(k + 1, N_NEW - n)]
        with torch.inference_mode():
            rejected = [{"token": n + m - 1, "plain_top2_gap": self._plain_gap(
                self.eng8, prompt, 0, n + m - 1)} for n, m in short]
        rep = {"check": f"{label}: acceptance, batch 1, k = {k}", "windows": len(rows),
               "full_windows": len(rows) - len(short),
               "tokens_per_window": (N_NEW - 1) / len(rows),
               "emitted_by_window": [m for _, m in rows], "rejections": rejected,
               "rejections_beyond_paged_bar": sum(r["plain_top2_gap"] > PAGED_BAR
                                                  for r in rejected),
               "tokens_equal_plain_batch_1": torch.equal(toks, plain)}
        print(f"{self.NAME} {label}: " + json.dumps(rep), flush=True)
        return rep

    # ---- (a) full acceptance, (b) the fixed engine ----------------------------------------
    def fixed(self, report):
        cfg, prompt, k = self.cfg, self.prompt, self.spec.k
        self.eng8, self.eng4 = self._fixed(8), self._fixed(4)
        self.graphs8 = count_captures(self.eng8)
        p1 = prompt[:1]
        self.plain1 = self.eng8.generate(p1, N_NEW)
        acc = self._acceptance(self.eng8, p1, self.plain1, "(a) int8 self-draft")
        got1, launches, counted_as = counted_launches(
            self.graphs8, lambda: self.eng8.generate(p1, N_NEW, speculate=self.spec))
        acc["tokens_equal_plain_batch_1"] &= torch.equal(got1, self.plain1)
        check(acc["tokens_equal_plain_batch_1"], f"(a) the self-draft's tokens differ from "
                                                 f"plain batch-1 greedy decoding: {acc}")
        check(acc["rejections_beyond_paged_bar"] == 0, f"(a) the self-draft rejected a "
              f"proposal where the plain run's top-2 gap exceeds {PAGED_BAR}: {acc}")
        windows = self.eng8.spec_stats["verify_steps"]
        want = dict.fromkeys(launches, 0)
        want["pim_matvec"] = self.per_step * (k + 2) * windows
        check(windows == acc["windows"] and launches == want,
              f"(a) launches {launches}, expected {want}: {windows} windows of {k + 1} one-row "
              f"draft steps and a {k + 1}-row verify")
        acc.update(launches=launches, launches_counted_as=counted_as,
                   spec_stats=dict(self.eng8.spec_stats))
        report["full_acceptance"] = acc
        self.launches["draft, fixed engine, batch 1 (self-draft)"] = launches

        plain = self.eng8.generate(prompt, N_NEW)
        eager4 = self._fixed(4, EagerServingEngine)
        rows, greedy = [], {}
        for bits, eng in ((8, self.eng8), (4, self.eng4)):
            for label, mode in (("greedy", GREEDY), ("sampled", SAMPLED)):
                name = f"int{bits} draft, {label}"
                got = eng.generate(prompt, N_NEW, speculate=self.spec, **mode)
                check(got.dtype == torch.int32 and bool(((got >= 0) & (got < cfg.vocab)).all()),
                      f"(b) {name}: tokens {got.dtype} out of range")
                row = {"case": name, "batch": BATCH, "spec_stats": dict(eng.spec_stats),
                       "tokens_per_window": eng.spec_stats["acceptance_per_live_row"]}
                if mode["greedy"]:
                    # greedy tokens are the verify's whatever the draft: a repeat
                    # of the int8 draft's tokens needs no second comparison
                    same = bits == 4 and torch.equal(got, greedy[8])
                    row["tokens_equal_int8_draft"] = same
                    if not same:
                        row["vs_plain"] = self._against_plain(f"(b) {name}", eng, prompt, got,
                                                              plain)
                    greedy[bits] = got
                if bits == 4 and not mode["greedy"]:
                    short = eng.generate(prompt, DRAFT_EAGER_NEW, speculate=self.spec, **mode)
                    stats = dict(eng.spec_stats)
                    want = eager4.generate(prompt, DRAFT_EAGER_NEW, speculate=self.spec, **mode)
                    row["eager_new_tokens"] = DRAFT_EAGER_NEW
                    row["tokens_equal_eager"] = torch.equal(short, want)
                    row["windows_equal_eager"] = stats == eager4.spec_stats
                    check(torch.equal(short, got[:, :DRAFT_EAGER_NEW]),
                          f"(b) {name}: {DRAFT_EAGER_NEW} tokens differ from the first of "
                          f"{N_NEW}")
                    check(row["tokens_equal_eager"] and row["windows_equal_eager"],
                          f"(b) {name}: the captured windows differ from the eager ones: {row}")
                rows.append(row)
        del eager4
        _, launches4, _ = counted_launches(
            self.graphs8, lambda: self.eng8.generate(prompt, N_NEW, speculate=self.spec))
        windows = self.eng8.spec_stats["verify_steps"]
        want = dict.fromkeys(launches4, 0)
        want["pim_matvec"] = self.per_step * (k + 1) * windows
        check(launches4 == want, f"(b) batch {BATCH}: launches {launches4}, expected {want} "
              f"({windows} windows of {k + 1} {BATCH}-row draft steps; the "
              f"{BATCH * (k + 1)}-row verify through x @ dq(w))")
        report["fixed"] = rows
        report["fixed_launches"] = launches4
        self.launches["draft, fixed engine, batch 4 (self-draft)"] = launches4

    # ---- (c) the continuous engine -------------------------------------------------------
    def continuous(self, report):
        sv, reqs, dev = self.serving, self.serving.reqs, self.dev
        # built with the prefix cache asked for: draft mode keeps it off
        eng, graphs, eager = self._engines(self.spec, prefix_cache=True)
        self.serve_eng, self.serve_graphs = eng, graphs
        self.out = eng.serve(reqs)
        rep = eng.last_report
        eng.assert_quiescent()
        rows = [{"case": "(c) int4 draft, greedy", "rounds": rep.rounds,
                 "decode_chunk_iters": eng.decode_chunk_iters,
                 "tokens": sum(len(o) for o in self.out),
                 "acceptance": eng.spec_emitted / max(1, eng.spec_live_steps),
                 "peak_pages": eng.peak_pages_in_use,
                 "vs_dense": self._against_dense("(c) int4 draft, greedy", self.out)}]
        # the eager twin serves the trace's first requests at a cut budget: an
        # eager iteration runs k + 2 forward passes op by op; the sampled, the
        # preempted and the crashed serves run those requests too (they served
        # the whole trace before phase 17)
        sub = first_requests(reqs)
        sub_out, same = self._captured_vs_eager("(c) int4 draft, greedy, first requests", eng,
                                                eager, sub)
        rows.append(same)
        del eager
        out_s = eng.serve(sub, **SAMPLED)
        eng.assert_quiescent()
        check(not same_tokens(out_s, sub_out), "(c) sampled tokens equal greedy ones")
        rows.append({"case": "(c) int4 draft, sampled", "rounds": eng.last_report.rounds,
                     "decode_chunk_iters": eng.decode_chunk_iters,
                     "tokens": sum(len(o) for o in out_s),
                     "acceptance": eng.spec_emitted / max(1, eng.spec_live_steps)})
        report["continuous"] = rows

        # the prefix cache stays off: phase 10's repeated prompt, twice
        preqs = [Request(prompt=self.prefix.reqs[i].prompt, max_new=8) for i in (2, 6)]
        check(np.array_equal(preqs[0].prompt, preqs[1].prompt), "(c) no repeated prompt")
        prep = eng.serve_detailed(preqs)
        report["prefix_cache"] = {"hits": prep.prefix_hits, "cow_forks": prep.cow_forks,
                                  "prefill_tokens": prep.prefill_tokens,
                                  "prompt_tokens": sum(len(r.prompt) for r in preqs)}
        check(prep.prefix_hits == prep.cow_forks == 0
              and prep.prefill_tokens == report["prefix_cache"]["prompt_tokens"],
              f"(c) the prefix cache served a draft-mode request: {report['prefix_cache']}")

        small = sv.report["preemption"]["num_pages"]
        pre = ContinuousBatchingEngine(self.cfg, self.params, speculate=self.spec, device=dev,
                                       draft_cfg=self.cfg, draft_params=self.drafts[4],
                                       **{**SERVE, "num_pages": small})
        out_p = pre.serve(sub)
        report["preemption"] = {"num_pages": small, "requests": len(sub),
                                "preemptions": pre.preemptions,
                                "tokens_equal": same_tokens(out_p, sub_out)}
        check(pre.preemptions > 0 and report["preemption"]["tokens_equal"],
              f"(c) the preempted draft serve: {report['preemption']}")
        pre.assert_quiescent()
        del pre

        # round 1: a draft serve of these requests takes two rounds
        inj = FaultInjector(ChaosConfig(crash_rounds=(1,)))
        rep = ServingSupervisor(eng, policy=ResiliencePolicy(resume_mode="recompute"),
                                chaos=inj).run(sub)
        crash = {"requests": len(sub), "restarts": rep.restarts,
                 "failures": [f.kind for f in rep.failures],
                 "tokens_equal": same_tokens(rep.outputs, sub_out)}
        check(rep.restarts == 1 and injected_only(rep.failures, inj) and crash["tokens_equal"],
              f"(c) recompute crash replay of the draft serve: {crash}")
        eng.assert_quiescent()
        report["crash_replay_recompute"] = crash

    # ---- (d) the planted fault -----------------------------------------------------------
    def planted_fault(self, report):
        with draft_reads_one_off():
            faulty = self._fixed(8)
            acc = self._acceptance(faulty, self.prompt[:1], self.plain1, "(d) planted fault")
        del faulty
        report["planted_fault"] = {"fault": "the draft chain runs at pos + i + 1", **acc}
        check(acc["full_windows"] < acc["windows"] and acc["tokens_per_window"]
              < report["full_acceptance"]["tokens_per_window"],
              f"(d) the planted fault keeps the self-draft's full acceptance: {acc}")

    # ---- (e) times -----------------------------------------------------------------------
    def _draft_step(self, eng, b):
        """One single-token draft step of ``b`` rows on the draft cache of
        ``eng``'s k-wide windows, as a call with no arguments."""
        st, k = eng.spec_state(b), self.spec.k
        dcache = st.draft_cache(k)

        def run():
            speculative.draft_propose(eng.draft_params, self.cfg, dcache, st.tok,
                                      st.s - 1 + st.n_em, 0)
        return eng.graphs.get(eng._weights(), ("draft step", b, k), b, run, st.reset)

    def _spec_start(self, eng, prompt, k):
        return functools.partial(eng.spec_state(prompt.shape[0]).start, self.params,
                                 prompt, None, 1.0, N_NEW, greedy=True, top_k=0, ctrl_init=0.0,
                                 draft_params=eng.draft_params, k=k)

    @torch.inference_mode()
    def times(self, report):
        """Device ms of a draft step (int8 and int4, 1 and 4 rows), of a
        window at k = 1, 2 and 4 (int4 draft, 4 rows) and of the batch-1
        self-draft window, against the plain step (CUDA events over replays,
        alternating rounds); then tokens/s of (c)'s serve against phase 9's
        plain serve."""
        runs, k = {}, self.spec.k
        for b in (1, BATCH):
            p = self.prompt[:b]
            runs[f"plain step, {b} rows"] = (
                self.eng8.step(b, greedy=True, top_k=0), functools.partial(
                    self.eng8.state(b).start, self.params, self.cfg, p, None, 1.0, greedy=True,
                    top_k=0))
            for bits, eng in ((8, self.eng8), (4, self.eng4)):
                runs[f"draft step int{bits}, {b} rows"] = (self._draft_step(eng, b),
                                                          self._spec_start(eng, p, k))
        for kk in SPEC_WIDTHS:
            runs[f"window int4 draft k={kk}, {BATCH} rows"] = (
                self.eng4.spec_step(BATCH, SpecConfig(k=kk, mode="draft"), greedy=True,
                                    top_k=0), self._spec_start(self.eng4, self.prompt, kk))
        for b in (BATCH, 1):
            runs[f"window int8 self-draft k={k}, {b} rows"] = (
                self.eng8.spec_step(b, self.spec, greedy=True, top_k=0),
                self._spec_start(self.eng8, self.prompt[:b], k))

        def ms(step, start):
            start()
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(DRAFT_TIME_REPS):
                step()
            z.record()
            z.synchronize()
            return a.elapsed_time(z) / DRAFT_TIME_REPS

        rounds = []
        for _ in range(DRAFT_ROUNDS):
            rounds.append({name: ms(*run) for name, run in runs.items()})
            rounds[-1]["sm_clock_mhz"] = tracing.sm_clock_mhz()
        med = {name: sorted(r[name] for r in rounds)[len(rounds) // 2] for name in runs}
        plain4 = med[f"plain step, {BATCH} rows"]
        report["step_and_window_ms"] = {
            "timing": f"device ms a replay, CUDA events over {DRAFT_TIME_REPS} replays, median "
                      f"of {DRAFT_ROUNDS} alternating rounds",
            "medians": {name: {"ms": v, "over_plain_step_4_rows": v / plain4}
                        for name, v in med.items()}, "rounds": rounds}

        plain, draft = self.serving.eng, self.serve_eng
        serves = {"plain": (plain, self.serving.out), "int4 draft": (draft, self.out)}
        srounds = []
        for i in range(DRAFT_SERVE_ROUNDS):
            row = {}
            for name, (e, want) in serves.items():
                if i or e is plain:
                    out, t = e.timed_serve(self.serving.reqs)
                else:  # (c)'s launches: the first timed draft serve's
                    (out, t), launches, counted_as = counted_launches(
                        self.serve_graphs, lambda: e.timed_serve(self.serving.reqs))
                    want_l = dict.fromkeys(launches, 0)
                    want_l["pim_matvec"] = self.per_step * (k + 1) * t["iters"]
                    check(launches == want_l, f"(c) serve: launches {launches}, expected "
                          f"{want_l} ({t['iters']} iterations of {k + 1} {SERVE['slots']}-row "
                          f"draft steps; the {SERVE['slots'] * (k + 1)}-row verify through "
                          "x @ dq(w))")
                    report["serve_launches"] = {"launches": launches, "counted_as": counted_as,
                                                "decode_chunk_iters": t["iters"]}
                    self.launches["draft, continuous engine, serve"] = launches
                check(same_tokens(out, want), f"(e) the timed serve {name!r} changed")
                row[name] = {**timing_row(t), "tokens_per_chunk_iter": t["tokens"] / t["iters"]}
            row["sm_clock_mhz"] = tracing.sm_clock_mhz()
            srounds.append(row)
        smed = {name: {key: sorted(r[name][key] for r in srounds)[len(srounds) // 2]
                       for key in ("tokens_per_s", "step_ms_per_iter", "tokens_per_chunk_iter",
                                   "host_ms_per_round_outside_steps")} for name in serves}
        smed["int4 draft"]["tokens_per_s_over_plain"] = (smed["int4 draft"]["tokens_per_s"]
                                                         / smed["plain"]["tokens_per_s"])
        smed["int4 draft"]["acceptance"] = draft.spec_emitted / max(1, draft.spec_live_steps)
        report["serve_times"] = {"rounds": srounds, "medians": smed}
        report["graphs"] = {"fixed engine, int8 self-draft": capture_report(self.eng8,
                                                                             self.graphs8),
                            "serve, int4 draft": capture_report(draft, self.serve_graphs)}

    def run(self):
        report = {"check": "phase 13: draft-model speculation, qwen2-1.5b int8, drafts int8 "
                           "(self) and int4", "section_s": {}}
        t0 = time.perf_counter()
        self.launches = {}
        for part in (self.fixed, self.continuous, self.planted_fault, self.times):
            t = time.perf_counter()
            part(report)
            report["section_s"][part.__name__] = time.perf_counter() - t
        report["launches"] = self.launches
        report["phase_s"] = time.perf_counter() - t0
        print(json.dumps(report), flush=True)
        return self.launches


# ---- 14. tree drafts -------------------------------------------------------------------
# (a) the fixed engine at batch 1, fan 2 x depth 3 (7-row windows, through
# pim_matvec); (b) planted chains at full width, fan 3 x depth 3, dense and
# paged; (c) the fixed engine at phase 3's batch, fan 2 x depth 2 (20-row
# windows); (d) the continuous engine on phase 9's trace, fan 2 x depth 2;
# (e) times.
TREE_SPEC1 = dict(k=3, tree_fan=2)   # (a): 1 + 2 x 3 = 7 rows
TREE_SPEC4 = dict(k=2, tree_fan=2)   # (c), (d): 4 x (1 + 2 x 2) = 20 rows
TREE_PLANT = (3, 3)                  # (b): fan 3, depth 3; chain 2 holds the plain tokens
TREE_PLANT_PS = 8                    # (b): the paged pool's page size: the window's
                                     # columns 128..137 cross a page boundary
TREE_CONTINUE = 8                    # (b): decode steps on from the relocated cache
TREE_EAGER_NEW = 16                  # (c): the eager twin's and the cross-engine budget
TREE_ROUNDS = 2                      # (e): alternating rounds of steps and windows (was 3)
TREE_SERVE_ROUNDS = 1                # (e): rounds of plain and tree serves (2 before phase 16)


def late_sources(cfg, cache, pos, a, cf, *, fan, depth, page_size=None):
    """The planted fault of (b): the relocation gathers each kept step one
    column late."""
    src, dst, ok = lm.tree_columns(pos, a, cf, depth)
    return lm.move_columns(cfg, cache, src + 1, dst, ok)


def draw_margins(lg, keys, logdist, a, cf, depth, temperature, top_k):
    """Each row's margin of a tree window's final draw, in warped logits: the
    least of the top-2 gap of gumbel noise plus the warped logits it drew
    from (eliminated or cut tokens out) and the top-k cut's margins, as
    phase 10's ``_gap`` takes them.  ``lg`` (B, T, V) the window's logits,
    ``keys``/``logdist`` the categorical's arguments, ``a``/``cf`` the
    window's acceptance: the draw came from node ``cf*depth + a`` (0 when
    nothing was accepted)."""
    b, _, v = lg.shape
    node = torch.where(a > 0, cf * depth + a, 0)
    lgn = lg[torch.arange(b, device=lg.device), node].float()
    noise = gumbel(keys, v)
    values = torch.where(logdist > float("-inf"), lgn / temperature + noise, float("-inf"))
    margins = []
    for r in range(b):
        gap = top2_gap(values[r])
        kth, first_cut = torch.topk(lgn[r], top_k + 1).values[top_k - 1:]
        cut = ((lgn[r, values[r].argmax()] - first_cut) / temperature).item()
        entering = (lgn[r] < kth) & (lgn[r] / temperature + noise[r] > values[r].max())
        if bool(entering.any()):
            cut = min(cut, ((kth - lgn[r][entering].max()) / temperature).item())
        margins.append(min(gap, cut))
    return margins


@contextlib.contextmanager
def recorded_tree_draws(log, temperature, top_k):
    """Each eager tree window's final draws: ``draw_margins`` per row
    appended to ``log``, one list a window."""
    seen = {}
    verify, accept, draw = (speculative.verify_step, speculative.tree_reject_sample,
                            sampling.categorical)

    def verify_rec(*args, **kw):
        seen["lg"], cache = verify(*args, **kw)
        return seen["lg"], cache

    def draw_rec(keys, logits):
        seen["keys"], seen["logdist"] = keys, logits
        return draw(keys, logits)

    def accept_rec(keys, chains, p, **kw):
        toks, a, cf = accept(keys, chains, p, **kw)
        log.append(draw_margins(seen["lg"], seen["keys"], seen["logdist"], a, cf,
                                chains.shape[2], temperature, top_k))
        return toks, a, cf
    speculative.verify_step, speculative.tree_reject_sample = verify_rec, accept_rec
    sampling.categorical = draw_rec
    try:
        yield
    finally:
        speculative.verify_step, speculative.tree_reject_sample = verify, accept
        sampling.categorical = draw


def _bytes(t):
    return t.contiguous().view(torch.uint8)


class PlantedChains:
    """Phase 14 (b), and phase 17 (l) for the vlm and encdec families: a
    window of ``fan`` chains of ``depth`` tokens after the batch-1
    ``prompt`` (1, S), whose last chain holds plain greedy decoding's next
    ``depth`` tokens (``plain`` (1, n), its first token the window's root),
    on a dense store and on a paged pool of ``page_size``-token pages under a
    shuffled block table (with ``extras``, each leaf (1, ...)).  ``steps``
    decode steps continue from each relocated cache.  The chain
    must be kept whole (or rejected only where the plain run's top-2 gap is
    within ``reject_bar``); ``tree_relocate``'s linear columns byte-equal to the
    tree columns they came from, across every K/V stack of
    ``lm.cache_stacks`` and its lead dims, every other column unchanged;
    the decode steps on from the relocated cache within ``bar``
    of plain decoding (logits and tokens); and the relocation with late
    sources (``late_sources``) flagged by both.  The eager plain steps the
    continuation is held against must give plain greedy decoding's tokens:
    exactly with ``tie_bar`` None, else with a first divergence only at a
    top-2 gap within ``tie_bar`` (their store is another length, so
    attention sums in another order; the vlm broke such a tie)."""

    def __init__(self, cfg, params, prompt, plain, *, fan=TREE_PLANT[0], depth=TREE_PLANT[1],
                 page_size=TREE_PLANT_PS, extras=None, bar=HIT_BAR, tie_bar=None,
                 reject_bar=PAGED_BAR,
                 steps=TREE_CONTINUE, name="phase 14", label="(b)"):
        self.cfg, self.params, self.prompt, self.plain = cfg, params, prompt, plain
        self.fan, self.depth, self.ps, self.extras, self.bar = fan, depth, page_size, extras, bar
        self.tie_bar, self.reject_bar, self.steps = tie_bar, reject_bar, steps
        self.name, self.label, self.dev = name, label, prompt.device
        self.s = prompt.shape[1]

    def _caches(self, store):
        """A dense cache of ``store`` positions and a paged pool of
        ``page_size``-token pages under a shuffled block table, each with the
        prompt prefilled."""
        cfg, dev, p1, ps = self.cfg, self.dev, self.prompt, self.ps
        dense = init_cache(cfg, 1, store, dev)
        prefill(self.params, cfg, p1, dense, self.extras)
        width = -(-store // ps)
        paged = init_paged_cache(cfg, 1, width * ps, width + 1, ps, dev)
        gen = torch.Generator(device="cpu").manual_seed(SEED + 14)
        bt = (torch.randperm(width, generator=gen) + 1).to(dev)
        paged["block_tables"].copy_(bt[None])
        spad = -(-self.s // ps) * ps
        tokens = torch.zeros((1, spad), dtype=p1.dtype, device=dev)
        tokens[:, :self.s] = p1
        prefill(self.params, cfg, tokens, paged, self.extras, length=self.s,
                pages=bt[:spad // ps])
        return {"dense": dense, "paged": paged}

    def _leaves(self, cache):
        """(stack key, leaf name, the leaf with its stack's lead dims
        flattened into one: (LL, B | P, KV, S | ps, ...), a view; a latent
        leaf (LL, B | P, S | ps, C) with a head axis of one)."""
        for key, lead in lm.cache_stacks(self.cfg):
            latent = lm.stack_layout(self.cfg, key) == "latent"
            for name, leaf in cache[key].items():
                flat = leaf.view((-1,) + leaf.shape[len(lead):])
                yield key, name, flat.unsqueeze(2) if latent else flat

    def _columns(self, cache, cols):
        """Each leaf's columns ``cols`` of row 0 (dense) or through the block
        table (paged), as bytes: {(key, name): (LL, n, KV, ...) uint8}."""
        bt = cache.get("block_tables")
        cols = torch.as_tensor(cols, device=self.dev)
        out = {}
        for key, name, leaf in self._leaves(cache):
            if bt is None:
                t = leaf[:, 0][:, :, cols].transpose(1, 2)
            else:
                ps = leaf.shape[3]
                t = leaf[:, bt[0, cols // ps].long(), :, cols % ps]
            out[key, name] = _bytes(t)
        return out

    def _snapshot(self, cache):
        return {(key, name): leaf.clone() for key, name, leaf in self._leaves(cache)}

    def _restore(self, cache, before):
        for key, name, leaf in self._leaves(cache):
            leaf.copy_(before[key, name])

    def _unchanged_but(self, cache, before, cols):
        """Whether every column of ``cache`` but ``cols`` holds the bytes of
        the snapshot ``before`` (a paged pool's trash page aside)."""
        bt = cache.get("block_tables")
        cols = torch.as_tensor(cols, dtype=torch.int64, device=self.dev)
        for key, name, leaf in self._leaves(cache):
            want = before[key, name].clone()
            if bt is None:
                want[:, :, :, cols] = leaf[:, :, :, cols]
            else:
                ps = leaf.shape[3]
                at = (bt[0, cols // ps].long(), cols % ps)
                want[:, at[0], :, at[1]] = leaf[:, at[0], :, at[1]]
                want, leaf = want[:, 1:], leaf[:, 1:]
            if not torch.equal(_bytes(want), _bytes(leaf)):
                return False
        return True

    def _continue(self, cache, toks, first):
        """Decode ``toks`` (plain tokens) one at a time from position
        ``first`` on: the logits after each, (n, V) f32."""
        out = []
        for i, t in enumerate(toks):
            tok = torch.tensor([[int(t)]], dtype=torch.int32, device=self.dev)
            pos = first + i
            if "block_tables" in cache:
                pos = torch.tensor([pos], device=self.dev)
            lg, _ = decode_step(self.params, self.cfg, tok, cache, pos, self.extras)
            out.append(lg[0, -1].float())
        return torch.stack(out)

    def run(self):
        cfg, dev, fan, depth, bar, s = self.cfg, self.dev, self.fan, self.depth, self.bar, self.s
        steps = self.steps
        t = self.plain[0].tolist()
        store = s + len(t) + fan * depth
        rows = {}
        with torch.inference_mode():
            # the plain run's logits after t0 .. t_{depth + steps}, one
            # eager decode step each
            ref_cache = init_cache(cfg, 1, store, dev)
            prefill(self.params, cfg, self.prompt, ref_cache, self.extras)
            ref = self._continue(ref_cache, t[:depth + steps + 1], s)
            del ref_cache
            ref_toks = [int(x) for x in ref.argmax(-1)]
            apart = next((j for j, (x, y) in enumerate(zip(ref_toks, t[1:])) if x != y), None)
            rows["eager_plain_steps"] = {"first_divergence": apart, "top2_gap_there": (
                None if apart is None else top2_gap(ref[apart])), "bar": self.tie_bar}
            check(apart is None or self.tie_bar is not None
                  and rows["eager_plain_steps"]["top2_gap_there"] <= self.tie_bar,
                  f"{self.label} the eager plain steps' tokens leave plain greedy decoding's "
                  f"beyond a near-tie: {rows['eager_plain_steps']}")
            chains = torch.tensor([[[(t[1 + i] + 1 + f) % cfg.vocab for i in range(depth)]
                                    for f in range(fan - 1)] + [t[1:1 + depth]]],
                                  dtype=torch.int32, device=dev)
            window = torch.cat([torch.tensor([[t[0]]], dtype=torch.int32, device=dev),
                                chains.reshape(1, -1)], dim=1)
            pos = torch.tensor([s], device=dev)
            tree_cols = [s + 1 + (fan - 1) * depth + i for i in range(depth)]
            lin_cols = [s + 1 + i for i in range(depth)]
            for layout, cache in self._caches(store).items():
                lg, _ = verify_step(self.params, cfg, window, cache, pos, self.extras,
                                    tree=(fan, depth))
                g, a, cf = speculative.greedy_tree_accept(chains, lg)
                a, cf = int(a[0]), int(cf[0])
                row = {"accepted": a, "kept_chain": cf, "emitted": g[0, :a + 1].tolist(),
                       "plain": t[1:depth + 2]}
                if a < depth:  # a rejection: only where the plain run's gap is a near-tie
                    row["rejected_at_plain_top2_gap"] = top2_gap(ref[a])
                check(a == depth and cf == fan - 1 or (
                    row.get("rejected_at_plain_top2_gap", math.inf) <= self.reject_bar
                    and (a == 0 or cf == fan - 1)),
                    f"{self.label} {layout}: the planted chain {fan - 1} was not accepted: {row}")
                before = self._snapshot(cache)
                src = self._columns(cache, tree_cols[:a])
                for fault in (False, True):
                    if fault:  # back to the window's state, then the late relocation
                        self._restore(cache, before)
                        late_sources(cfg, cache, pos, torch.tensor([a], device=dev),
                                     torch.tensor([cf], device=dev), fan=fan, depth=depth)
                    else:
                        tree_relocate(cfg, cache, pos, torch.tensor([a], device=dev),
                                      torch.tensor([cf], device=dev), fan=fan, depth=depth)
                    moved = self._columns(cache, lin_cols[:a])
                    unchanged = self._unchanged_but(cache, before, lin_cols[:a])
                    byte_equal = all(torch.equal(moved[n], src[n]) for n in src)
                    cont = self._continue(cache, t[a + 1:a + 1 + steps], s + a + 1)
                    want = ref[a + 1:a + 1 + steps]
                    diff = (cont - want).abs().max().item()
                    toks = [int(x) for x in cont.argmax(-1)]
                    plain_next = t[a + 2:a + 2 + steps]
                    div = next((j for j in range(steps) if toks[j] != plain_next[j]),
                               None)
                    gap = None if div is None else top2_gap(want[div])
                    res = {"relocated_bytes_equal_tree_columns": byte_equal,
                           "other_columns_unchanged": unchanged,
                           "continued_max_abs_logit_diff": diff,
                           "continued_tokens_equal_plain": div is None,
                           "first_divergence": div, "plain_top2_gap_there": gap}
                    res["within_bar"] = diff <= bar and (gap is None or gap <= bar)
                    if fault:
                        res["flagged_by_bytes"] = not byte_equal
                        res["flagged_by_continuation"] = not res["within_bar"]
                        check(res["flagged_by_bytes"] and res["flagged_by_continuation"],
                              f"{self.label} {layout}: the late relocation passes: {res}")
                        row["planted_fault"] = res
                    else:
                        check(byte_equal and unchanged and res["within_bar"],
                              f"{self.label} {layout}: the relocation of chain {cf}: {res}")
                        row["relocation"] = res
                rows[layout] = row
                print(f"{self.name} {self.label} {layout}: " + json.dumps(row), flush=True)
        return {"fan": fan, "depth": depth, "page_size": self.ps, "bar": bar,
                "tie_bar": self.tie_bar, "reject_bar": self.reject_bar, **rows}


class TreePhase(SpecPhase):
    """Phase 14: tree drafts on both engines, (a) to (e) of the module's
    docstring."""

    NAME = "phase 14"

    # ---- (a) the fixed engine at batch 1 ---------------------------------------------------
    def batch1(self, report):
        cfg, dev, p1 = self.cfg, self.dev, self.prompt[:1]
        spec = SpecConfig(**TREE_SPEC1)
        self.eng = eng = ServingEngine(cfg, self.params, max_seq=PROMPT + N_NEW, device=dev)
        self.graphs = count_captures(eng)
        self.eager = EagerServingEngine(cfg, self.params, max_seq=PROMPT + N_NEW, device=dev)
        self.plain1 = eng.generate(p1, N_NEW)
        got = eng.generate(p1, N_NEW, speculate=spec)
        stats = dict(eng.spec_stats)
        want = self.eager.generate(p1, N_NEW, speculate=spec)
        row = {"case": "greedy, batch 1, fan 2 x depth 3", "window_rows": 1 + 2 * 3,
               "tokens_equal_eager": torch.equal(got, want),
               "windows_equal_eager": stats == self.eager.spec_stats, "spec_stats": stats}
        check(row["tokens_equal_eager"] and row["windows_equal_eager"],
              f"(a) the captured tree windows differ from the eager ones: {row}")
        vs = self._against_plain("(a) batch 1", eng, p1, got, self.plain1, check_bar=False)
        row["vs_plain_batch_1"] = vs
        check(vs["beyond_paged_bar"] == 0, f"(a) batch-1 tree tokens leave plain batch-1 "
              f"decoding beyond the bar {PAGED_BAR}: {vs}")
        fan1 = eng.generate(p1, N_NEW, speculate=SpecConfig(k=3, tree_fan=1))
        linear = eng.generate(p1, N_NEW, speculate=SpecConfig(k=3))
        row["fan_1_equal_linear_k_3"] = torch.equal(fan1, linear)
        check(row["fan_1_equal_linear_k_3"], "(a) tree_fan=1, k=3 differs from linear k=3")
        _, launches, counted_as = counted_launches(
            self.graphs, lambda: eng.generate(p1, N_NEW, speculate=spec))
        windows = eng.spec_stats["verify_steps"]
        want_l = dict.fromkeys(launches, 0)
        want_l["pim_matvec"] = self.per_step * windows
        check(launches == want_l, f"(a) launches {launches}, expected {want_l} ({windows} "
                                  "7-row tree windows)")
        row.update(launches=launches, launches_counted_as=counted_as,
                   pim_matvec_per_window=launches["pim_matvec"] // max(1, windows))
        report["batch_1"] = row
        self.launches["tree, fixed engine, batch 1 windows"] = launches

    # ---- (b) planted chains ----------------------------------------------------------------
    def planted(self, report):
        report["planted_chains"] = PlantedChains(
            self.cfg, self.params, self.prompt[:1], self.plain1, name=self.NAME).run()

    # ---- (c) the fixed engine at batch 4 ---------------------------------------------------
    def _eager_windows(self, spec, n_new, mode):
        """The eager engine's windows one at a time: tokens, and per window
        the rows' emitted counts before and after and the margin of each
        row's final draw (``recorded_tree_draws``)."""
        eng, b = self.eager, self.prompt.shape[0]
        step = eng.spec_step(b, spec, greedy=False, top_k=mode["top_k"])
        st = eng.spec_state(b)
        st.start(self.params, self.prompt, mode["key"], mode["temperature"], n_new,
                 greedy=False, top_k=mode["top_k"], ctrl_init=0.0, k=spec.k,
                 tree_fan=spec.tree_fan)
        log, windows = [], []
        with recorded_tree_draws(log, mode["temperature"], mode["top_k"]):
            while int(st.n_em.min()) < n_new:
                before = st.n_em.tolist()
                step()
                windows.append((before, st.n_em.tolist(), log[-1]))
        return st.out[:, :n_new].clone(), windows

    @staticmethod
    def _draw_gap(windows, r, j):
        """The margin of the draw that emitted token j of row r: a window's
        final draw; None where j was an accepted proposal."""
        for before, after, gaps in windows:
            if before[r] <= j < after[r]:
                return gaps[r] if j == after[r] - 1 else None
        return None

    def batch4(self, report):
        cfg, dev, prompt = self.cfg, self.dev, self.prompt
        spec = SpecConfig(**TREE_SPEC4)
        eng = self.eng
        got = eng.generate(prompt, N_NEW, speculate=spec)
        row = {"case": "greedy, batch 4, fan 2 x depth 2", "window_rows": BATCH * 5,
               "spec_stats": dict(eng.spec_stats),
               "vs_plain": self._against_plain("(c) greedy", eng, prompt, got, self.toks)}
        _, launches, _ = counted_launches(
            self.graphs, lambda: eng.generate(prompt, N_NEW, speculate=spec))
        check(launches == dict.fromkeys(launches, 0), f"(c) launches {launches}, expected "
              "none (20-row windows go through x @ dq(w))")
        self.launches["tree, fixed engine, batch 4 windows"] = launches
        mode = {k: v for k, v in SAMPLED.items() if k != "greedy"}
        got_s = eng.generate(prompt, TREE_EAGER_NEW, speculate=spec, **SAMPLED)
        stats = dict(eng.spec_stats)
        with torch.inference_mode():
            want, windows = self._eager_windows(spec, TREE_EAGER_NEW, mode)
        sampled = {"case": "sampled, batch 4", "n_new": TREE_EAGER_NEW,
                   "tokens_equal_eager": torch.equal(got_s, want),
                   "windows_equal_eager": stats["verify_steps"] == len(windows),
                   "spec_stats": stats}
        check(sampled["tokens_equal_eager"] and sampled["windows_equal_eager"],
              f"(c) the captured sampled tree windows differ from the eager ones: {sampled}")
        cont = ContinuousBatchingEngine(cfg, self.params, speculate=spec, device=dev,
                                        **{**SERVE, "max_seq": PROMPT + N_NEW})
        got_c = cont.generate(prompt, TREE_EAGER_NEW, **SAMPLED)
        bar = HIT_BAR / SAMPLED["temperature"]
        divs = []
        for r in range(BATCH):
            diff = torch.nonzero(got_c[r] != got_s[r]).flatten().tolist()
            if diff:
                divs.append({"row": r, "token": diff[0],
                             "draw_margin": self._draw_gap(windows, r, diff[0])})
        sampled["continuous_engine"] = {
            "rows_equal": BATCH - len(divs), "divergences": divs, "bar": bar,
            "beyond_bar": sum(d["draw_margin"] is None or d["draw_margin"] > bar
                              for d in divs)}
        check(sampled["continuous_engine"]["beyond_bar"] == 0, f"(c) the continuous engine's "
              f"sampled tree tokens leave the fixed engine's beyond a near-tie: {sampled}")
        report["batch_4"] = [row, sampled]
        del cont

    # ---- (d) the continuous engine ---------------------------------------------------------
    def continuous(self, report):
        sv, reqs = self.serving, self.serving.reqs
        spec = SpecConfig(**TREE_SPEC4)
        eng, graphs, eager = self._engines(spec)
        self.serve_eng, self.serve_graphs = eng, graphs
        self.out, same = self._captured_vs_eager("greedy", eng, eager, reqs, first=True)
        same["vs_dense"] = self._against_dense("(d) tree greedy", self.out)
        rows = [same]
        self.out_sampled, same = self._captured_vs_eager("sampled", eng, eager, reqs, SAMPLED,
                                                         first=True)
        check(not same_tokens(self.out_sampled, self.out), "(d) sampled tokens equal greedy ones")
        rows.append(same)
        del eager
        small = sv.report["preemption"]["num_pages"]
        pre = ContinuousBatchingEngine(self.cfg, self.params, speculate=spec, device=self.dev,
                                       **{**SERVE, "num_pages": small})
        out_p = pre.serve(reqs)
        report["preemption"] = {"num_pages": small, "preemptions": pre.preemptions,
                                "tokens_equal": same_tokens(out_p, self.out)}
        check(pre.preemptions > 0 and report["preemption"]["tokens_equal"],
              f"(d) the preempted tree serve: {report['preemption']}")
        pre.assert_quiescent()
        del pre
        # the prefix cache stays on: phase 10's repeated prompt, twice
        preqs = [Request(prompt=self.prefix.reqs[i].prompt, max_new=8) for i in (2, 6)]
        check(np.array_equal(preqs[0].prompt, preqs[1].prompt), "(d) no repeated prompt")
        peng = ContinuousBatchingEngine(self.cfg, self.params, speculate=spec, device=self.dev,
                                        prefix_cache=True, **SERVE)
        peng.debug_check_hist = True
        prep = peng.serve_detailed(preqs)
        out_u = eng.serve(preqs)
        report["prefix_cache"] = {"hits": prep.prefix_hits, "hit_tokens": prep.prefix_hit_tokens,
                                  "cow_forks": prep.cow_forks,
                                  "prompt_tokens": len(preqs[0].prompt),
                                  "tokens_equal_uncached": same_tokens(prep.outputs, out_u)}
        check(prep.prefix_hits == 1 and prep.prefix_hit_tokens > 0,
              f"(d) the repeated prompt did not hit: {report['prefix_cache']}")
        peng.assert_quiescent()
        del peng
        inj = FaultInjector(ChaosConfig(crash_rounds=(CRASH_ROUNDS[0],)))
        rep = ServingSupervisor(eng, policy=ResiliencePolicy(resume_mode="recompute"),
                                chaos=inj).run(reqs)
        crash = {"restarts": rep.restarts, "failures": [f.kind for f in rep.failures],
                 "tokens_equal": same_tokens(rep.outputs, self.out)}
        check(rep.restarts == 1 and injected_only(rep.failures, inj) and crash["tokens_equal"],
              f"(d) recompute crash replay of the tree serve: {crash}")
        eng.assert_quiescent()
        report["crash_replay_recompute"] = crash
        report["continuous"] = rows

    # ---- (e) times -------------------------------------------------------------------------
    @torch.inference_mode()
    def times(self, report):
        eng, cfg = self.eng, self.cfg
        runs = {}
        for b in (1, BATCH):
            p = self.prompt[:b]
            runs[f"plain step, {b} rows"] = (
                eng.step(b, greedy=True, top_k=0), functools.partial(
                    eng.state(b).start, self.params, cfg, p, None, 1.0, greedy=True, top_k=0),
                b)
            specs = ((TREE_SPEC1, dict(k=3)) if b == 1 else (TREE_SPEC4, dict(k=SPEC_K)))
            for sp in specs:
                spec = SpecConfig(**sp)
                name = (f"tree window fan {spec.tree_fan} x k {spec.k}" if spec.tree_fan
                        else f"linear window k {spec.k}")
                runs[f"{name}, {b} rows"] = (
                    eng.spec_step(b, spec, greedy=True, top_k=0), functools.partial(
                        eng.spec_state(b).start, self.params, p, None, 1.0, N_NEW,
                        greedy=True, top_k=0, ctrl_init=0.0, k=spec.k, tree_fan=spec.tree_fan),
                    b * (1 + max(1, spec.tree_fan) * spec.k))

        def ms(step, start):
            start()
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(SPEC_TIME_REPS):
                step()
            z.record()
            z.synchronize()
            return a.elapsed_time(z) / SPEC_TIME_REPS

        rounds = []
        for _ in range(TREE_ROUNDS):
            rounds.append({name: ms(step, start) for name, (step, start, _) in runs.items()})
            rounds[-1]["sm_clock_mhz"] = tracing.sm_clock_mhz()
        med = {name: sorted(r[name] for r in rounds)[len(rounds) // 2] for name in runs}
        rows = []
        for name, (_, _, m) in runs.items():
            b = 1 if name.endswith(" 1 rows") else BATCH
            rows.append({"run": name, "rows": m,
                         "linears_through": ("pim_matvec" if m <= common.MATVEC_MAX_M
                                             else "x @ dq(w)"),
                         "ms": med[name], "over_plain_step": med[name] / med[
                             f"plain step, {b} rows"]})
        report["window_ms"] = {"timing": "device ms a replay, CUDA events over "
                                         f"{SPEC_TIME_REPS} replays, median of {TREE_ROUNDS} "
                                         "alternating rounds", "rows": rows, "rounds": rounds}

        plain, tree = self.serving.eng, self.serve_eng
        serves = {"plain": (plain, self.serving.out), "tree": (tree, self.out)}
        srounds = []
        for i in range(TREE_SERVE_ROUNDS):
            row = {}
            for name, (e, want) in serves.items():
                if i or e is plain:
                    out, t = e.timed_serve(self.serving.reqs)
                else:  # (d)'s launches: the first timed tree serve's
                    (out, t), launches, counted_as = counted_launches(
                        self.serve_graphs, lambda: e.timed_serve(self.serving.reqs))
                    check(launches == dict.fromkeys(launches, 0), f"(d) serve: launches "
                          f"{launches}, expected none (20-row tree windows and admits go "
                          "through x @ dq(w))")
                    report["serve_launches"] = {"launches": launches, "counted_as": counted_as,
                                                "decode_chunk_iters": t["iters"]}
                    self.launches["tree, continuous engine, serve"] = launches
                check(same_tokens(out, want), f"(e) the timed serve {name!r} changed")
                row[name] = {**timing_row(t), "tokens_per_chunk_iter": t["tokens"] / t["iters"]}
            row["sm_clock_mhz"] = tracing.sm_clock_mhz()
            srounds.append(row)
        smed = {name: {key: sorted(r[name][key] for r in srounds)[len(srounds) // 2]
                       for key in ("tokens_per_s", "step_ms_per_iter", "tokens_per_chunk_iter",
                                   "host_ms_per_round_outside_steps")} for name in serves}
        smed["tree"]["tokens_per_s_over_plain"] = (smed["tree"]["tokens_per_s"]
                                                   / smed["plain"]["tokens_per_s"])
        smed["tree"]["acceptance"] = tree.spec_emitted / max(1, tree.spec_live_steps)
        report["serve_times"] = {"rounds": srounds, "medians": smed}
        report["graphs"] = {"fixed engine": capture_report(self.eng, self.graphs),
                            "serve": capture_report(tree, self.serve_graphs)}

    def run(self):
        report = {"check": "phase 14: tree drafts, qwen2-1.5b int8", "section_s": {}}
        t0 = time.perf_counter()
        self.launches = {}
        for part in (self.batch1, self.planted, self.batch4, self.continuous, self.times):
            t = time.perf_counter()
            part(report)
            report["section_s"][part.__name__] = time.perf_counter() - t
        report["launches"] = self.launches
        report["phase_s"] = time.perf_counter() - t0
        print(json.dumps(report), flush=True)
        del self.eager
        return self.launches



# ---- 15. the PiCaSO machine ----------------------------------------------------------
# The paper's own machine (repro_torch.core) at the paper's array sizes: the
# Alveo U55's whole PiCaSO array (scalability.max_array("picaso", ALVEO_U55):
# 252 tiles, 64,512 PEs = 4,032 blocks of 16) and the Virtex-7 485's whole
# array (32,768 PEs) as one dot-product row.  Every check is exact.
PICASO_U55_BLOCKS = 4032
PICASO_V7_Q = 32768
PICASO_MATVEC = (16, 2048)
PICASO_NET_BLOCKS = (2, 3, 5, 16, 48, 100, 1000, 2048)  # (a): any count, as the reference
PICASO_LANES = 4096  # (a): lanes of the ALU, Booth and fold checks
PICASO_ACC = 2 * 8 + 4  # (b): 16-bit products and log2(16) guard bits for the folds
PICASO_FAULT = (1234, 5, 3)  # (f): block, lane, product bit flipped


class PicasoPhase:
    """Phase 15 on ``dev`` (the card), its inputs from one numpy generator;
    (a) holds each bit-level function on ``dev`` against the CPU."""

    def __init__(self, dev):
        self.dev = dev
        self.rng = np.random.default_rng(SEED + 5)

    def _ints(self, shape, width):
        return torch.from_numpy(self.rng.integers(-(1 << (width - 1)), 1 << (width - 1),
                                                  size=shape))

    def _bits(self, shape):
        return torch.from_numpy(self.rng.integers(0, 2, size=shape).astype(np.uint8))

    def same(self, label, fn, *args):
        """``fn`` on ``dev`` equal (values, dtype and shape) to ``fn`` on the
        CPU, for the same CPU inputs."""
        on = [a.to(self.dev) if isinstance(a, torch.Tensor) else a for a in args]
        got, want = fn(*on), fn(*args)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, w in zip(got, want):
            check(g.device.type == self.dev.type and g.dtype == w.dtype
                  and torch.equal(g.cpu(), w), f"phase 15 (a) {label}: the card differs from "
                  "the CPU")
        self.cases += 1

    def bit_level(self, report):
        """(a) each bit-level function on the card against the CPU."""
        self.cases = 0
        edges = torch.tensor([0, 1, -1, 2**31 - 1, -2**31, 2**31, 2**32 + 5, -2**31 - 1])
        for width in range(1, 35):
            vals = torch.cat([self._ints(4096, min(width, 32)), edges])
            self.same(f"to_bits {width}", picaso.to_bits, vals, width)
            if width <= 32:
                planes = self._bits((4096, width))
                for signed in (True, False):
                    self.same(f"from_bits {width}", picaso.from_bits, planes, signed)
                self.same(f"sign_extend_bits {width}", picaso.sign_extend_bits, planes,
                          width + 3)
        pairs = torch.from_numpy(self.rng.integers(0, 4, size=PICASO_LANES).astype(np.int32))
        self.same("booth_decode", picaso.booth_decode, pairs)
        for conf in range(8):
            self.same(f"encode {conf:#05b}", picaso.encode, conf, pairs)
        ops = torch.from_numpy(self.rng.integers(0, 4, size=PICASO_LANES).astype(np.int32))
        for width in (4, 8, 16, 32):
            self.same(f"serial_alu {width}", picaso.serial_alu, self._bits((PICASO_LANES, width)),
                      self._bits((PICASO_LANES, width)), ops)
        for width in (4, 8, 16):
            self.same(f"booth_multiply_bits {width}", picaso.booth_multiply_bits,
                      self._bits((PICASO_LANES, width)), self._bits((PICASO_LANES, width)))
            self.same(f"booth_nop_fraction {width}", picaso.booth_nop_fraction,
                      self._ints(PICASO_LANES, width), width)
        for block in (8, 16, 32):
            for pattern in ("a", "b"):
                a_bits = picaso.to_bits(self._ints((256, block), 12), 16)
                for level in range(1, block.bit_length()):
                    self.same(f"fold_operand {block} {level} {pattern}", picaso.fold_operand,
                              a_bits, level, pattern)
                self.same(f"fold_reduce_block {block} {pattern}", picaso.fold_reduce_block,
                          a_bits[0], pattern)
        for n in PICASO_NET_BLOCKS:
            bits = picaso.to_bits(self._ints(n, 11), 24)
            on = bits.to(self.dev)
            got = picaso.network_reduce_bits(on)
            check(torch.equal(got.cpu(), picaso.network_reduce_bits(bits))
                  and torch.equal(on.cpu(), bits), f"phase 15 (a) network_reduce_bits {n}: "
                  "the card differs from the CPU, or its input changed")
            self.cases += 1
        report["bit_level"] = {"cases": self.cases, "network_blocks": list(PICASO_NET_BLOCKS),
                               "equal": True}

    def u55(self, report, fault=None):
        """(b) the U55's whole array: every PE against an int64 oracle, each
        block's lane 0 against ``fold_sum``, the cycles against the model.
        With ``fault`` (block, lane, bit) one product bit is flipped before
        the folds; returns what each check saw."""
        arr = psim.PicasoArray(n_blocks=PICASO_U55_BLOCKS, device=self.dev)
        rng = np.random.default_rng(SEED + 5)  # the same operands for (b) and (f)
        x, w = (torch.from_numpy(rng.integers(-128, 128, size=(PICASO_U55_BLOCKS, 16)))
                .to(self.dev) for _ in range(2))
        times = {}

        def timed(name, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3

        arr.write_operands(0, x, 8)
        arr.write_operands(8, w, 8)
        timed("alu_op ADD", arr.alu_op, picaso.OpCode.ADD, 0, 8, 16, 8)
        timed("alu_op SUB", arr.alu_op, picaso.OpCode.SUB, 0, 8, 24, 8)
        timed("mult", arr.mult, 0, 8, 32, 8)
        if fault is not None:
            b, lane, bit = fault
            arr.rf[b, lane, 32 + bit] ^= 1
        arr._store(32, picaso.sign_extend_bits(arr._slice(32, 16), PICASO_ACC))
        prod = arr.read_operands(32, PICASO_ACC).long()
        timed("fold_accumulate", arr.fold_accumulate, 32, PICASO_ACC)

        wrap8 = lambda v: (v + 128) % 256 - 128  # noqa: E731
        want = x * w
        for level in range(1, 5):  # the folds of pattern (a), in int64
            span = 16 >> level
            want[:, :span] += want[:, span:2 * span]
        folded = arr.read_operands(32, PICASO_ACC).long()
        seen = {"add": torch.equal(arr.read_operands(16, 8).long(), wrap8(x + w)),
                "sub": torch.equal(arr.read_operands(24, 8).long(), wrap8(x - w)),
                "product": torch.equal(prod, x * w),
                "folds": torch.equal(folded, want),
                "pes_off": int((folded != want).sum())}
        fold_reduce.launches = 0
        sums = ops.fold_sum((x * w).to(torch.float32))
        torch.cuda.synchronize()
        launches = fold_reduce.launches
        seen["fold_sum"] = torch.equal(folded[:, 0].to(torch.float32), sums)
        seen["cycles"] = arr.cycles
        want_cycles = (2 * pcm.add_sub_cycles(8) + pcm.mult_cycles_overlay(8)
                       + 4 * PICASO_ACC)  # the 4N fold term of accum_cycles_picaso
        if fault is None:
            check(all(seen[k] for k in ("add", "sub", "product", "folds", "fold_sum")),
                  f"phase 15 (b) the U55 array: {seen}")
            check(arr.cycles == want_cycles, f"phase 15 (b) cycles {arr.cycles}, "
                  f"model {want_cycles}")
            check(launches == 1, f"phase 15 (b) fold_sum launched fold_reduce {launches} times")
            report["u55"] = {"pes": arr.num_pes, "blocks": arr.n_blocks,
                             "rf_bytes": arr.rf.numel(), "acc_width": PICASO_ACC,
                             "cycles": arr.cycles, "model_cycles": want_cycles,
                             "fold_reduce_launches": launches, "ms": times, **seen}
            self.launches = launches
        del arr
        return seen

    def v7_row(self, report):
        """(c) the Virtex-7 485's whole array as one dot-product row."""
        x = self.rng.integers(-128, 128, size=PICASO_V7_Q)
        w = self.rng.integers(-128, 128, size=PICASO_V7_Q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val, cycles = psim.simulate_dot_product(x, w, 8, device=self.dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = int(np.dot(x.astype(np.int64), w.astype(np.int64)))
        acc = 2 * 8 + pcm.log2i(PICASO_V7_Q) + 1  # 32 bits at q = 32,768: from_bits' most
        want_cycles = pcm.mult_cycles_overlay(8) + pcm.accum_cycles_picaso(PICASO_V7_Q, acc)
        check(val == want and cycles == want_cycles, f"phase 15 (c) q={PICASO_V7_Q}: "
              f"{val}, {cycles} cycles; numpy {want}, model {want_cycles}")
        report["v7_row"] = {"q": PICASO_V7_Q, "blocks": PICASO_V7_Q // 16, "acc_width": acc,
                            "value": val, "numpy": want, "cycles": cycles,
                            "model_cycles": want_cycles, "ms": ms}

    def matvec(self, report):
        """(d) W (16, 2048) @ x, a row per wave."""
        m, k = PICASO_MATVEC
        wm = self.rng.integers(-128, 128, size=(m, k))
        x = self.rng.integers(-128, 128, size=k)
        t0 = time.perf_counter()
        vals, cycles = pmapping.simulate_matvec(wm, x, 8, device=self.dev)
        ms = (time.perf_counter() - t0) * 1e3
        want = wm.astype(np.int64) @ x.astype(np.int64)
        want_cycles = pmapping.matvec_cycles(m, k, 8, total_pes=m * k)
        check(np.array_equal(vals, want) and cycles == want_cycles,
              f"phase 15 (d) matvec {m} x {k}: {cycles} cycles, model {want_cycles}")
        report["matvec"] = {"shape": [m, k], "equal": True, "cycles": cycles,
                            "model_cycles": want_cycles, "ms": ms}

    def tables(self, report):
        """(e) every table row on the card equal to the CPU run's."""
        rows = {f.__name__: f(device=self.dev) for f in paper_tables.ALL}
        cpu = {f.__name__: f(device="cpu") for f in paper_tables.ALL}
        for name in rows:
            check([(r[0], r[2]) for r in rows[name]] == [(r[0], r[2]) for r in cpu[name]],
                  f"phase 15 (e) {name}: the card's rows differ from the CPU's")
        report["tables"] = {"rows": sum(len(r) for r in rows.values()), "equal_to_cpu": True,
                            "us_per_call": {r[0]: r[1] for rs in rows.values() for r in rs
                                            if r[1] > 0}}

    def planted_fault(self, report):
        """(f) one flipped product bit: both checks of (b) must see it."""
        seen = self.u55(report, fault=PICASO_FAULT)
        check(not seen["folds"] and not seen["fold_sum"], f"phase 15 (f) the planted fault "
              f"at {PICASO_FAULT} passed: {seen}")
        report["planted_fault"] = {"flipped": dict(zip(("block", "lane", "bit"), PICASO_FAULT)),
                                   "caught_by_oracle": not seen["folds"],
                                   "pes_off": seen["pes_off"],
                                   "caught_by_fold_sum": not seen["fold_sum"]}

    def run(self):
        report = {"check": "phase 15: the PiCaSO machine at the paper's array sizes (cycles "
                           "are the paper's model, not this card's)", "section_s": {}}
        t0 = time.perf_counter()
        for part in (self.bit_level, self.u55, self.v7_row, self.matvec, self.tables,
                     self.planted_fault):
            t = time.perf_counter()
            part(report)
            report["section_s"][part.__name__] = time.perf_counter() - t
        report["phase_s"] = time.perf_counter() - t0
        print(json.dumps(report), flush=True)
        return self.launches


# ---- 16. the rest of the dense family -------------------------------------------------
# The reference's other dense configs, one at a time, at full width and depth,
# seeded random weights at pim_bits=8 (each on a generator of its own,
# SEED + 7 + its index); then (h) the int8 KV cache on qwen2-1.5b.
FAMILY = ("llama3.2-3b", "starcoder2-7b", "starcoder2-15b")
# Every config at full width; starcoder2-15b at 20 of its 40 layers (40
# before phase 18, whose time the cut pays for with phase 17's), the others
# at full depth.
FAMILY_LAYERS = {"starcoder2-15b": 20}
# (c): the f32 path at full width but this many layers: the whole f32 model
# (40.5 / 88.0 GB for starcoder2-7b / -15b) does not fit beside the rest.
FAMILY_F32_LAYERS = 4
# (b): the bf16 kernel path against the overlay path at full depth.
# LOGIT_TOL (0.25) was set on qwen2-1.5b, whose sound paths differ by 0.16
# at a logit spread of 0.78.  The overlay rounds every weight to bf16, and
# on these wider random-weight models every layer amplifies that rounding
# (a linear of N(0, 0.02) weights over more than 2,500 inputs has a gain
# above one): on the H100 the sound paths differed by 0.32-0.33, 0.47-0.49
# and 0.64-0.68 at logit spreads of 1.11, 1.36 and 1.57, while the same
# kernels agree with their plain twins to 3e-5 in f32 ((c)).  So the logits are held
# below what (c)'s planted fault (layer n/2's `down` loses its last K
# split) does to this same comparison, with LOGIT_TOL printed beside.
FAMILY_ROUNDS = 2  # (e): alternating rounds of the greedy and sampled step (3 before phase 17)
FAMILY_CHECK_NEW = 16  # (b), (c): the first tokens of (a)'s greedy generation, teacher-forced
FAMILY_FLASH = (2048, 1000)  # (g): Sq = Sk, at the config's (KV, G, D)
FAMILY_CACHE = 2048  # (g): decode attention over BATCH rows of this many positions,
FAMILY_CACHE_POS = 1536  # the query at this one (the keys past it masked)
FAMILY_M = (1, 4, 8)  # (f): x rows of the kernel cases


def stream_bytes(eng):
    """The bytes a decode step must stream at least: every quantized layer
    weight's codes and scales, the biases and norms, and the unembedding
    (an untied head's codes and scales, or the whole tied bf16 table)."""
    p = eng.params
    return (pim_bytes(p["layers"]) + pim_bytes({"head": p.get("head", p["embed"])})
            + p["ln_f"].numel() * p["ln_f"].element_size())


def step_routes(eng, prompt, toks, sms):
    """Each ``pim_matvec`` call of one eager decode step: its weight's code
    rows and columns, x's dtype and the kernel's plan for them (chunked
    where x is staged in more than one chunk per CTA slice)."""
    calls = []

    def noting(x, w_codes, scale, *, bits=8, **kw):
        calls.append((x.shape[0], *w_codes.shape, bits, x.dtype))
        return pim_matvec(x, w_codes, scale, bits=bits, **kw)
    with decode_linears_through(noting):
        forced_logits(eng, prompt, toks, 2)  # the prefill makes no call, the step all
    routes = []
    for m, rows, n, bits, dtype in calls:
        pl = matvec_plan(rows, n, m, bits, sms, 1 if dtype == torch.bfloat16 else 3)
        routes.append({"rows": rows, "N": n, "M": m, "x": str(dtype).split(".")[-1],
                       "chunk_rows": pl.chunk_rows, "rows_per_cta": pl.rows_per_cta,
                       "cluster": pl.cluster, "col_tiles": pl.col_tiles,
                       "chunks": -(-pl.rows_per_cta // pl.chunk_rows),
                       "chunked": pl.chunk_rows < pl.rows_per_cta})
    return routes


def last_chunks(k, n, m, bits, sms):
    """The code rows of the last x chunk of each CTA slice of a (k, n) weight
    at m bf16 x rows (``pim_matvec.plan``): the rows a kernel that dropped
    its last chunk would leave out."""
    pl = matvec_plan(k, n, m, bits, sms, 1)
    out = []
    for lo in range(0, k, pl.rows_per_cta):
        hi = min(lo + pl.rows_per_cta, k)
        out.append((lo + (-(-(hi - lo) // pl.chunk_rows) - 1) * pl.chunk_rows, hi))
    return pl, out


def family_kernel_cases(cfg, gen, extra=(), chunk_fault=True):
    """(f): ``pim_matvec`` against ``pim_matvec_plain`` on each of the
    config's weight shapes (the seven linears where it has attention, the
    (K, N) of ``extra``, and
    its (d, vocab) unembedding, the tied table's as a quantized weight
    too), random weights at bits 8 and 4, M in FAMILY_M, f32 and bf16 x
    (``kernel_vs_plain``).  Then, with ``chunk_fault``, the planted fault:
    the kernel on x whose last chunk of every CTA slice of the (d, vocab)
    weight is zeroed (as if the chunk loop stopped one chunk short), bf16,
    M = BATCH, must fail the check.  Returns the report and the (d, vocab)
    weight at int8."""
    dev, sms = gen.device, torch.cuda.get_device_properties(0).multi_processor_count
    shapes = []
    for group, name, _ in LINEARS if cfg.n_heads else ():
        k, n = {"wq": (cfg.d_model, cfg.q_dim), "wk": (cfg.d_model, cfg.kv_dim),
                "wv": (cfg.d_model, cfg.kv_dim), "wo": (cfg.q_dim, cfg.d_model),
                "gate": (cfg.d_model, cfg.d_ff), "up": (cfg.d_model, cfg.d_ff),
                "down": (cfg.d_ff, cfg.d_model)}[name]
        if (k, n) not in shapes:
            shapes.append((k, n))
    shapes += [tuple(e) for e in extra] + [(cfg.d_model, cfg.vocab)]
    cases, head = [], {}
    for k, n in shapes:
        w = 0.02 * torch.randn((k, n), generator=gen, device=dev)
        for bits in (8, 4):
            q = ops.quantize_for_pim(w, bits)
            cases += [_packed_case(f"{k} x {n}", m, q) for m in FAMILY_M]
            head[bits] = q
        del w
    max_err = kernel_vs_plain(pim_matvec, pim_matvec_plain, cases, gen)
    chunked = []  # (K, N, M, bits) of the cases whose bf16 x the kernel stages in chunks
    for _, m, k, n, (codes, _), fixed in cases:
        pl = matvec_plan(codes.shape[0], n, m, fixed["bits"], sms, 1)
        if pl.chunk_rows < pl.rows_per_cta:
            chunked.append([k, n, m, fixed["bits"]])
    q = head[8]
    k, n = q.shape
    pl, dropped = last_chunks(k, n, BATCH, 8, sms)
    report = {"shapes": [list(s) for s in shapes], "cases": 32 * len(cases),
              "max_abs_err": max_err, "tol": KERNEL_TOL,
              "chunked_bf16_cases_K_N_M_bits": chunked}
    if not chunk_fault:
        return report, q
    check(pl.chunk_rows < pl.rows_per_cta, f"(f) the {k} x {n} weight is not chunked: {pl}")
    x = torch.randn((BATCH, k), generator=gen, device=dev).to(torch.bfloat16)
    faulty = x.clone()
    for lo, hi in dropped:
        faulty[:, lo:hi] = 0
    ok, fault_err = within_tol(pim_matvec(faulty, q.codes, q.scale, bits=8),
                               pim_matvec_plain(x, q.codes, q.scale, bits=8))
    check(not ok, f"(f) the dropped last chunk moved pim_matvec's output by only "
          f"{fault_err:.3g}: the check cannot see it")
    return {**report,
            "planted_fault": f"{k} x {n} int8, bf16 x, M = {BATCH}: the last chunk of each CTA "
                             f"slice dropped, code rows {dropped} (plan: {pl.cluster} CTAs of "
                             f"{pl.rows_per_cta} rows in chunks of {pl.chunk_rows})",
            "planted_fault_max_abs_err": fault_err}, q


def family_attention(cfg, gen):
    """(g): ``flash_attention_gqa`` against ``flash_attention_plain`` at the
    config's (KV, G, D), f32 within KERNEL_TOL and bf16 within that plus one
    ulp, causal and not, at Sq = Sk in FAMILY_FLASH; then one bf16 layer's
    ``decode_attention`` over BATCH rows of FAMILY_CACHE positions against
    its f32-copy form (``decode_attention_check``)."""
    dev = gen.device
    kv, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    share, n = 0.0, 0
    for s in FAMILY_FLASH:
        q32 = torch.randn((1, s, kv, g, d), generator=gen, device=dev)
        k32, v32 = (torch.randn((1, s, kv, d), generator=gen, device=dev) for _ in range(2))
        for dtype in errs:
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            for causal in (True, False):
                got = flash_attention_gqa(q, k, v, causal=causal)
                ref = flash_attention_plain(q, k, v, causal=causal)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    ok, err = within_tol(got, ref)
                else:
                    ok, err, sh, _ = within_bf16_ulp(got, ref)
                    share = max(share, sh)
                check(ok and got.dtype == dtype and got.shape == ref.shape,
                      f"(g) flash_attention {(1, s, s, kv, g, d)} {dtype} causal={causal}: "
                      f"max err {err:.3g}")
                errs[dtype] = max(errs[dtype], err)
                n += 1
    dec = decode_attention_check(cfg, gen, batch=BATCH, slots=FAMILY_CACHE,
                                 pos=FAMILY_CACHE_POS)
    return {"heads": {"kv": kv, "group": g, "head_dim": d}, "lengths": list(FAMILY_FLASH),
            "flash_cases": n, "f32_max_abs_err": errs[torch.float32],
            "bf16_max_abs_err": errs[torch.bfloat16], "bf16_tol_share": share,
            "decode_attention": {k: dec[k] for k in (
                "scores_max_abs_diff_over_max_abs", "pv_same_weights_max_abs_diff_over_max_abs",
                "end_to_end_max_abs_diff_over_max_abs", "bf16_cache_ms", "f32_copy_ms")}}


def step_kernels_ms(eng, gen):
    """Device ms of one decode step's ``pim_matvec`` calls alone, back to
    back in a CUDA graph (``_time_ms``): every layer's seven linears and an
    untied head on the engine's own codes, x of BATCH seeded bf16 rows."""
    cfg, p, dev = eng.cfg, eng.params, gen.device
    xs = {k: torch.randn((BATCH, k), generator=gen, device=dev).to(torch.bfloat16)
          for k in (cfg.d_model, cfg.q_dim, cfg.d_ff)}
    weights = [p["layers"][group][name] for group, name, _ in LINEARS]
    calls = [functools.partial(pim_matvec, xs[w["codes"].shape[1]], w["codes"][i],
                               w["scale"][i], bits=8)
             for i in range(cfg.n_layers) for w in weights]
    if "head" in p:
        calls.append(functools.partial(pim_matvec, xs[cfg.d_model], p["head"]["codes"],
                                       p["head"]["scale"], bits=8))
    return _time_ms(calls, 20) * len(calls)


def step_ms(engines, prompt, n_new, rounds, extras=None):
    """Captured decode ms a step of each of ``engines`` ({label: (engine,
    mode)}), device time (CUDA events over n_new - 1 replays from a
    prefill that is not timed, with the rows' ``extras``), in ``rounds``
    alternating rounds; the SM clock after each round.  Returns (medians,
    rounds)."""
    b, out = prompt.shape[0], []
    for _ in range(rounds):
        row = {}
        for label, (eng, mode) in engines.items():
            greedy, top_k = mode["greedy"], mode.get("top_k", 0)
            step = eng.step(b, greedy=greedy, top_k=top_k, extras=extras)
            eng.state(b).start(eng.params, eng.cfg, prompt, mode.get("key"),
                               mode.get("temperature", 1.0), greedy=greedy, top_k=top_k,
                               extras=extras)
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n_new - 1):
                step()
            z.record()
            z.synchronize()
            row[label] = a.elapsed_time(z) / (n_new - 1)
        row["sm_clock_mhz"] = tracing.sm_clock_mhz()
        out.append(row)
    return {label: sorted(r[label] for r in out)[len(out) // 2] for label in engines}, out


class FamilyPhase:
    """Phase 16: (h) the int8 KV cache on qwen2-1.5b, from phase 9's trace and
    bf16-cache serve (``kv``: the int8 parameters, the requests, their
    tokens, phase 3's prompt), then (a) to (g) for each of FAMILY."""

    def __init__(self, dev, kv):
        self.dev, self.kv = dev, kv
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.launches = {}

    def int8_kv(self, report):
        """(h): phase 9's trace served greedy with ``kv_cache_bits=8``."""
        params, reqs, want, prompt = self.kv
        dev, cfg = self.dev, get_config("qwen2-1.5b")
        cfg8 = cfg.replace(kv_cache_bits=8)
        eng = TimedEngine(cfg8, params, device=dev, **SERVE)
        graphs = count_captures(eng)
        eager = EagerEngine(cfg8, params, device=dev, **SERVE)
        out = eng.serve(reqs)
        iters, tokens = eng.decode_chunk_iters, sum(len(o) for o in out)
        # the eager twin serves the trace's first requests at a cut budget (it
        # served the whole trace before phase 17): one more than the slots,
        # so the last admit lands in a freed slot
        sub = first_requests(reqs, SERVE["slots"] + 1)
        out_c = eng.serve(sub)
        out_e = eager.serve(sub)
        same = {"tokens_equal": same_tokens(out_c, out_e),
                "events_equal": events_of(eng.last_report) == events_of(eager.last_report),
                "peak_pages": [eng.peak_pages_in_use, eager.peak_pages_in_use],
                "eager_twin": f"the first {len(sub)} requests on {SERVE['slots']} slots, at "
                              f"most {SPEC_EAGER_NEW} new tokens each",
                "decode_chunk_iters": iters, "tokens": tokens}
        check(same["tokens_equal"] and same["events_equal"]
              and eng.peak_pages_in_use == eager.peak_pages_in_use,
              f"(h) the int8-cache serve, captured, differs from the eager one: {same}")
        del eager

        def gap_at(r, j):  # the bf16-cache path's top-2 gap before token j
            seq = np.concatenate([reqs[r].prompt, np.asarray(want[r][:j], np.int32)])
            seq = torch.from_numpy(seq)[None].to(dev)
            logits, _ = prefill(params, cfg, seq, init_cache(cfg, 1, seq.shape[1], dev))
            return top2_gap(logits[0, -1])
        with torch.inference_mode():
            vs = paged_vs_dense("(h) int8 cache vs the bf16-cache serve", out, want,
                                [len(w) for w in want], gap_at, HIT_BAR)
        vs["beyond_paged_bar"] = sum(beyond(d, PAGED_BAR) for d in vs["divergences"])
        _, launches, counted_as = counted_launches(graphs, lambda: eng.serve(reqs))
        expect = dict.fromkeys(launches, 0)
        expect["pim_matvec"] = matvec_calls_per_step(cfg) * eng.decode_chunk_iters
        check(launches == expect and eng.decode_chunk_iters == iters,
              f"(h) int8-cache serve: launches {launches}, expected {expect}")
        self.launches["phase 16 (h) int8-cache serve"] = launches
        del eng, graphs
        geng = ServingEngine(cfg8, params, max_seq=PROMPT + N_NEW, device=dev)
        beng = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW, device=dev)
        with torch.inference_mode():
            gen_rep, _ = captured_vs_eager(geng, prompt, N_NEW, f"qwen2-1.5b int8, int8 KV "
                                           f"cache, greedy, {BATCH} x {PROMPT}", **GREEDY)
            beng.generate(prompt, 2)  # the bf16-cache step's capture
            med, rounds = step_ms({"bf16_cache_ms": (beng, GREEDY),
                                   "int8_cache_ms": (geng, GREEDY)}, prompt, N_NEW,
                                  FAMILY_ROUNDS)
        report["int8_kv_cache"] = {
            "serve_captured_vs_eager": same, "serve_vs_bf16_cache": vs,
            "serve_launches": {"launches": launches, "counted_as": counted_as},
            "generate_captured_vs_eager": gen_rep,
            "step_ms": {**med, "int8_over_bf16": med["int8_cache_ms"] / med["bf16_cache_ms"],
                        "rounds": rounds,
                        "timing": f"device ms a captured greedy step at {BATCH} x {PROMPT}, "
                                  f"CUDA events over {N_NEW - 1} replays, median of "
                                  f"{FAMILY_ROUNDS} alternating rounds"}}
        print("phase 16 (h): " + json.dumps(report["int8_kv_cache"]), flush=True)

    def config(self, arch, seed):
        """(a) to (g) for one config at full width, FAMILY_LAYERS deep."""
        dev, cfg = self.dev, get_config(arch)
        cfg = cfg.replace(n_layers=FAMILY_LAYERS.get(arch, cfg.n_layers))
        gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = layerwise_params(cfg, gen)
        eng = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW, pim_bits=8, device=dev)
        del params  # the bf16 tree: the engine holds the quantized one
        gc.collect()
        torch.cuda.synchronize()
        rep = {"layers": cfg.n_layers, "d_model": cfg.d_model,
               "heads": [cfg.n_heads, cfg.n_kv_heads], "group": cfg.n_heads // cfg.n_kv_heads,
               "d_ff": cfg.d_ff, "vocab": cfg.vocab, "tied": cfg.tie_embeddings,
               "weights_s": time.perf_counter() - t0,
               "peak_bytes_drawing_and_quantizing": torch.cuda.max_memory_allocated(),
               "section_s": {}}
        prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen, device=dev)
        per_step = matvec_calls_per_step(cfg)
        graphs = count_captures(eng)

        t = time.perf_counter()  # (a) captured against eager, greedy and sampled
        with torch.inference_mode():
            greedy, toks = captured_vs_eager(eng, prompt, N_NEW, f"{arch} int8 greedy, "
                                             f"{BATCH} x {PROMPT}", **GREEDY)
            sampled, stoks = captured_vs_eager(eng, prompt, N_NEW, f"{arch} int8 sampled, "
                                               f"{BATCH} x {PROMPT}", **SAMPLED)
        check(not torch.equal(stoks, toks), f"(a) {arch}: sampled tokens equal greedy ones")
        rep["captured_vs_eager"] = [greedy, sampled]
        rep["section_s"]["a"] = time.perf_counter() - t

        t = time.perf_counter()  # (d) launches of the main path, and the step's routes
        _, launches, counted_as = counted_launches(graphs, lambda: eng.generate(prompt, N_NEW))
        expect = dict.fromkeys(launches, 0)
        expect["pim_matvec"] = per_step * (N_NEW - 1)
        check(launches == expect, f"(d) {arch}: launches {launches}, expected {expect}")
        check(all(g.launches["pim_matvec"] == per_step for g in graphs),
              f"(d) {arch}: captured steps launch {[g.launches for g in graphs]}, expected "
              f"{per_step} pim_matvec each")
        self.launches[f"phase 16 {arch} generate"] = launches
        routes = step_routes(eng, prompt, toks, self.sms)
        check(len(routes) == per_step, f"(d) {arch}: {len(routes)} pim_matvec calls a step")
        if not cfg.tie_embeddings:
            head = routes[-1]
            check((head["rows"], head["N"], head["x"]) == (cfg.d_model, cfg.vocab, "bfloat16")
                  and head["chunked"], f"(d) {arch}: the head's call {head} is not on the "
                  "chunked bf16 route")
        rep["launches"] = {"launches": launches, "per_step": per_step,
                           "counted_as": counted_as,
                           "step_routes": {f"{r['rows']} x {r['N']}": r for r in routes}}
        rep["section_s"]["d"] = time.perf_counter() - t

        t = time.perf_counter()  # (b) the kernel path against the overlay path
        ftoks = toks[:, :FAMILY_CHECK_NEW]
        diff, _, lo = against_overlay(eng, prompt, ftoks, FAMILY_CHECK_NEW, f"{arch} int8",
                                      tol=math.inf)
        rep["section_s"]["b"] = time.perf_counter() - t

        t = time.perf_counter()  # (c) the f32 path, FAMILY_F32_LAYERS deep, against plain
        cfg32 = cfg.replace(n_layers=FAMILY_F32_LAYERS, param_dtype="float32")
        eng32 = ServingEngine(cfg32, layerwise_params(cfg32, gen), max_seq=PROMPT + N_NEW,
                              pim_bits=8, device=dev)
        pl = matvec_plan(cfg.d_ff, cfg.d_model, BATCH, 8, self.sms)
        rows = cfg.d_ff - (pl.cluster - 1) * pl.rows_per_cta  # down's last K split
        rep["f32_path"] = plain_path_check(eng32, eng, prompt, ftoks, lo,
                                           f"{arch} int8 f32 kernel path vs plain path, "
                                           f"{FAMILY_F32_LAYERS} layers", rows)
        del eng32, lo
        fault8 = rep["f32_path"]["planted_fault_bf16_diff_vs_overlay"]
        rep["overlay"] = {"max_abs_logit_diff": diff, "bar": "below the planted fault's",
                          "planted_fault_max_abs_logit_diff": fault8, "logit_tol": LOGIT_TOL}
        check(diff < fault8, f"(b) {arch}: the kernel path differs from the overlay path by "
              f"{diff:.4g}, no less than the planted fault's {fault8:.4g}")
        rep["section_s"]["c"] = time.perf_counter() - t

        t = time.perf_counter()  # (e) ms a step beside the weight-stream floor
        with torch.inference_mode():
            med, rounds = step_ms({"captured_ms": (eng, GREEDY),
                                   "captured_sampled_ms": (eng, SAMPLED)},
                                  prompt, N_NEW, FAMILY_ROUNDS)
        floor_ms = stream_bytes(eng) / HBM_BYTES_PER_S * 1e3
        kernel_ms = step_kernels_ms(eng, gen)
        rep["step"] = {**med, "stream_bytes": stream_bytes(eng), "floor_ms": floor_ms,
                       "floor_share": floor_ms / med["captured_ms"],
                       "pim_matvec_ms": kernel_ms, "pim_matvec_share": kernel_ms
                       / med["captured_ms"], "pim_matvec_over_floor": kernel_ms / floor_ms,
                       "rounds": rounds,
                       "timing": f"device ms a captured step at {BATCH} x {PROMPT}, CUDA "
                                 f"events over {N_NEW - 1} replays, median of {FAMILY_ROUNDS} "
                                 "alternating rounds; floor: the stream at 3.35 TB/s"}
        rep["section_s"]["e"] = time.perf_counter() - t
        del eng, graphs
        gc.collect()
        torch.cuda.empty_cache()

        t = time.perf_counter()  # (f) the kernel at the new shapes
        rep["kernel_vs_plain"], _ = family_kernel_cases(cfg, gen)
        rep["section_s"]["f"] = time.perf_counter() - t
        rep["peak_bytes"] = torch.cuda.max_memory_allocated()  # before (g) resets it
        t = time.perf_counter()  # (g) attention at the config's group
        rep["attention"] = family_attention(cfg, gen)
        rep["section_s"]["g"] = time.perf_counter() - t
        check(rep["peak_bytes"] < torch.cuda.get_device_properties(0).total_memory,
              f"{arch}: peak {rep['peak_bytes']} bytes")
        print(f"phase 16 {arch}: " + json.dumps(rep), flush=True)
        return rep

    def run(self):
        report = {"check": "phase 16: the dense family at full width, int8 weights, "
                           "and the int8 KV cache", "configs": {}, "section_s": {}}
        t0 = time.perf_counter()
        self.int8_kv(report)
        self.kv = None  # qwen2-1.5b's tree goes before the larger models
        report["section_s"]["h"] = time.perf_counter() - t0
        for i, arch in enumerate(FAMILY):
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            rep = self.config(arch, SEED + 7 + i)
            report["configs"][arch] = {
                "captured_equal_eager": all(r["tokens_equal"] and r["last_logits_equal"]
                                            for r in rep["captured_vs_eager"]),
                "overlay_max_abs_logit_diff": rep["overlay"]["max_abs_logit_diff"],
                "overlay_planted_fault": rep["overlay"]["planted_fault_max_abs_logit_diff"],
                "f32_path_max_abs_logit_diff": rep["f32_path"]["max_abs_logit_diff"],
                "f32_path_planted_fault": rep["f32_path"]["planted_fault_f32_diff_vs_plain"],
                "pim_matvec_per_step": rep["launches"]["per_step"],
                "pim_matvec": rep["launches"]["launches"]["pim_matvec"],
                "kernel_max_abs_err": rep["kernel_vs_plain"]["max_abs_err"],
                "kernel_planted_fault": rep["kernel_vs_plain"]["planted_fault_max_abs_err"],
                "flash_max_abs_err": {"f32": rep["attention"]["f32_max_abs_err"],
                                      "bf16": rep["attention"]["bf16_max_abs_err"]},
                "step_ms": rep["step"]["captured_ms"],
                "sampled_step_ms": rep["step"]["captured_sampled_ms"],
                "floor_ms": rep["step"]["floor_ms"], "floor_share": rep["step"]["floor_share"],
                "pim_matvec_ms": rep["step"]["pim_matvec_ms"],
                "sm_clock_mhz": [r["sm_clock_mhz"] for r in rep["step"]["rounds"]],
                "peak_bytes": rep["peak_bytes"]}
            report["section_s"][arch] = time.perf_counter() - t
        report["phase_s"] = time.perf_counter() - t0
        print(json.dumps(report), flush=True)
        return self.launches


# ---- 17. the vlm and encdec families ---------------------------------------------------
# seamless-m4t-medium at full width and depth; llama-3.2-vision-90b at full
# width and CROSS_VLM_GROUPS of its 20 groups: all 20 are 88.7 GB at int8,
# more than the card holds.  4 groups run every check of its path; they were
# 16 before phase 18 and 8 before phase 19, whose times the cuts pay for.
# Each on a generator of its own (SEED + 10 + its
# index), weights drawn and quantized one (K, N) slice at a time
# (``quantized_params``), the vlm's gates planted (CROSS_GATES): its init's
# zero gates would make every cross block pass x through, whatever the image.
CROSS = ("seamless-m4t-medium", "llama-3.2-vision-90b")
CROSS_VLM_GROUPS = 4
CROSS_GATES = (0.5, 1.0)  # each gate of each cross block uniform in this range, seeded
# (c): the f32 path at full width, reduced depth: one vlm group, two encoder
# and two decoder layers (the f32 vlm group alone is 17 GB).
CROSS_F32 = {"vlm": dict(n_layers=5), "encdec": dict(n_layers=2, dec_layers=2)}
CROSS_ROUNDS = 1  # (g): rounds of the captured greedy and sampled step (2 at first)
CROSS_CHECK_NEW = 8  # (b), (c): the first tokens of (a)'s greedy generation, teacher-forced
# (b): the bar of the kernel path's distance from the overlay path, and the
# planted fault (``CrossPhase._faults``) that must exceed it.  The encdec
# keeps LOGIT_TOL.  The vlm's two sound bf16 arithmetics drift apart with
# depth, 0.27 / 0.52 / 1.20-1.27 at 1 / 4 / 16 groups on the H100
# (``--overlay-depths``, PERF.md section 6), where a middle ``down``'s
# dropped K split moves the logits by only 1.41 and the head's dropped last
# chunk by 4.9.
CROSS_OVERLAY_TOL = {"encdec": LOGIT_TOL, "vlm": 1.5}
CROSS_FAULT = {"encdec": "middle down", "vlm": "head"}
# (e): the solo top-2 gap up to which a paged request's first divergence from
# its solo run is sound.  The encdec keeps qwen2-1.5b's PAGED_BAR and
# HIT_BAR; the vlm's sound divergences sat at solo gaps 0.09-0.56 on the
# H100 (PERF.md section 6).
CROSS_SOLO_BARS = {"encdec": {"miss": PAGED_BAR, "hit": HIT_BAR},
                   "vlm": {"miss": 0.75, "hit": 0.75}}
# (e): six requests over two slots (a freed slot takes a new image), mixed
# prompt lengths and budgets; request 3 repeats request 1's prompt and extras
# (a prefix hit), request 5 its prompt under other extras (no hit); request 2
# stops at the first new token its solo run emits mid-way.
CROSS_SERVE = dict(slots=2, page_size=16, chunk=8, max_seq=160, page_alloc_seed=SEED)
CROSS_TRACE = ((100, 10), (128, 12), (37, 10), (128, 8), (64, 10), (128, 8))
CROSS_HIT, CROSS_MISS, CROSS_STOPPED = 3, 5, 2
# (e), (f): the counted serve, the eager twin and the next-slot fault serve
# the trace's first 4 requests (request 2 admitted into a freed slot,
# request 3 the hit); the whole trace before PR 29.
CROSS_EAGER = 4
# (i)-(n): speculation on these families.  Every window is at most 8 rows,
# so each of its linears runs pim_matvec (a wider vlm window would
# dequantize all 71.6 GB of codes through x @ dq(w)): at batch 1 an n-gram or
# self-draft window of k = 4 (5 rows) and a tree of fan 2 x depth 3 (7 rows,
# also (l)'s planted shape); on the continuous engine's 2 slots n-gram k = 3
# (8 rows) and a tree of fan 2 x depth 1 (6 rows).
CROSS_SPEC = dict(k=4)
CROSS_TREE = dict(k=3, tree_fan=2)
CROSS_SERVE_SPEC = {"n-gram": dict(k=3), "tree": dict(k=1, tree_fan=2)}
CROSS_SPEC_NEW = 16  # (i)-(l): batch-1 tokens; the eager twins' CROSS_SPEC_EAGER_NEW
CROSS_PLANT_PS = 4   # (l): the paged pool's pages: the window's columns 129..135 cross one
# (m): the trace's three requests of one 128-token prompt, at most
# CROSS_SPEC_SERVE_NEW new tokens each: request 1, its prefix hit (3) and the
# same prompt under other extras (5, a miss admitted into a freed slot); one
# padded length, so each engine captures one admit.  (i), (k): the eager
# twins' tokens (an eager vlm window runs op by op, ~0.3 s).
CROSS_SPEC_REQUESTS = (1, CROSS_HIT, CROSS_MISS)
CROSS_SPEC_EAGER_NEW = 6
CROSS_SPEC_SERVE_NEW = 4  # (m)'s budget a request
# (i)-(l): the plain top-2 gap within which a greedy window's first
# divergence from plain batch-1 decoding, a rejected self-draft proposal or
# a relocated chain's continuation is sound.  The encdec keeps HIT_BAR (the
# count beyond PAGED_BAR reported beside it); the vlm the 0.75 its (e) holds,
# set from its recorded sound divergences between two bf16 arithmetics (PR
# 28: 0.09-0.56 on the H100, PERF.md section 6).
CROSS_SPEC_BARS = {"encdec": HIT_BAR, "vlm": 0.75}
# (l): the bar of the continuation from a relocated planted chain, set from
# the sound readings and the late relocation's in PR 29's first run on the
# H100 (probe29a, PERF.md section 6): the encdec 0.016 / 0.023 against
# 0.235 / 0.231, the vlm 0.42 / 0.66 against 7.2 / 7.0 (dense / paged).
CROSS_PLANT_BARS = {"encdec": PAGED_BAR, "vlm": 1.5}
CROSS_PLANT_STEPS = 4  # (l): decode steps on from a relocated cache (probe29a's ran 8)
CROSS_SPEC_REPS, CROSS_SPEC_ROUNDS = 4, 2  # (n): replays a timed window, alternating rounds
CROSS_TAIL = 14  # (h): the head's last columns, checked on their own (256,206 % 16)
CROSS_SMALL_N = 1030  # (h): a small N with N % 16 != 0


@contextlib.contextmanager
def stale_extras():
    """A planted fault of (f): no call refreshes the engines' static extras
    buffers, so a captured step reads the previous call's."""
    prev, serving_engine._copy_tree = serving_engine._copy_tree, lambda dst, src: None
    try:
        yield
    finally:
        serving_engine._copy_tree = prev


@contextlib.contextmanager
def admits_into_next_slot(eng):
    """A planted fault of (f): ``eng``'s admits write their request's extras
    into the next slot's row."""
    sound = eng._set_slot_extras
    eng._set_slot_extras = lambda slot, extras: sound((slot + 1) % eng.slots, extras)
    try:
        yield
    finally:
        del eng._set_slot_extras


def cross_stream_bytes(eng):
    """The bytes a decode step reads at least: every weight of the decoder
    stack (the vlm's groups, cross K/V included; the encdec's decoder, not
    its encoder; the moe family's dense and MoE layers, every expert), the
    head and the final norm."""
    p = eng.params
    return pim_bytes({k: v for k, v in p.items() if k not in ("embed", "encoder")})


class WindowChecks:
    """Speculation's windows on the fixed engine at batch 1, for phase 17
    (i)-(l) and (n) and phase 19 (g): n-gram windows greedy and sampled and
    the int8 tree as its own draft, tree windows, each captured against
    eager with its launches counted and greedy against plain greedy
    decoding; planted chains (``PlantedChains``); and the windows' device
    ms.  A subclass sets the class attributes and ``_took``."""

    PHASE = "phase 17"
    SPEC, TREE = CROSS_SPEC, CROSS_TREE  # the linear windows' and the trees' SpecConfig
    SPEC_NEW, EAGER_NEW = CROSS_SPEC_NEW, CROSS_SPEC_EAGER_NEW
    PLANT_PS, PLANT_STEPS = CROSS_PLANT_PS, CROSS_PLANT_STEPS
    REPS, ROUNDS = CROSS_SPEC_REPS, CROSS_SPEC_ROUNDS
    SECTIONS = dict(ngram="i", draft="j", tree="k", plant="l", times="n")

    def spec_bar(self, cfg):
        return CROSS_SPEC_BARS[cfg.family]

    def plant_bar(self, cfg):
        return CROSS_PLANT_BARS[cfg.family]

    @staticmethod
    def window_rows(sp):
        """A batch-1 window's rows under ``sp``: its tokens (a tree's nodes)."""
        return 1 + sp.k * max(sp.tree_fan, 1)

    @torch.inference_mode()
    def _spec_start(self, eng, spec, prompt, ex, n_new):
        """``eng``'s batch-1 speculative buffers from ``prompt``'s prefill with
        the extras ``ex`` copied into the batch's static buffers, greedy, as
        ``generate`` starts them."""
        exb = eng.state(1).extras.get(ex)
        if ex is not None:
            serving_engine._copy_tree(exb, ex)
        eng.spec_state(1).start(eng.params, prompt, None, 1.0, n_new, greedy=True,
                                top_k=0, ctrl_init=0.0, k=spec.k, tree_fan=spec.tree_fan,
                                draft_params=eng.draft_params if spec.mode == "draft" else None,
                                extras=exb)

    def _vs_plain(self, label, eng, prompt, got, plain, ex, bar):
        return spec_vs_plain(f"{self.PHASE} {eng.cfg.arch_id}", label, eng, prompt, got, plain,
                             bar=bar, extras=ex)

    @torch.inference_mode()
    def _windows(self, eng, spec, prompt, ex, n_new):
        """One batch-1 generation window by window: [(tokens before, tokens
        emitted)] and the tokens."""
        step = eng.spec_step(1, spec, greedy=True, top_k=0, extras=ex)
        self._spec_start(eng, spec, prompt, ex, n_new)
        st, rows, n = eng.spec_state(1), [], 1
        while n < n_new:
            step()
            m = int(st.n_em[0]) - n
            rows.append((n, m))
            n += m
        return rows, st.out[:, :n_new].clone()

    def speculation(self, rep, cfg, params, prompt, ex):
        """The fixed engine at batch 1 (SECTIONS' n-gram, self-draft, tree and
        planted windows), and the window times, on the batch-1 ``prompt``
        (1, S) with the extras ``ex`` (each leaf (1, ...), or None); the
        target's int8 tree is its own draft."""
        dev, arch, n, sec = self.dev, cfg.arch_id, self.SPEC_NEW, self.SECTIONS
        bar, per_step = self.spec_bar(cfg), matvec_calls_per_step(cfg)
        kw = dict(max_seq=PROMPT + N_NEW, device=dev, draft_cfg=cfg, draft_params=params)
        eng, eager = ServingEngine(cfg, params, **kw), EagerServingEngine(cfg, params, **kw)
        graphs = count_captures(eng)
        out = {"bar": bar, "n_new": n}
        spec, tree = SpecConfig(**self.SPEC), SpecConfig(**self.TREE)
        draft = SpecConfig(**self.SPEC, mode="draft")

        def eager_twin(label, sp, mode, got):
            """The first EAGER_NEW tokens again, captured (their launches
            counted: ``per_step`` a window) and eager: ``torch.equal``, and
            the captured ones ``got``'s first."""
            m = self.EAGER_NEW
            short, launches, counted_as = counted_launches(
                graphs, lambda: eng.generate(prompt, m, extras=ex, speculate=sp, **mode))
            stats = dict(eng.spec_stats)
            want = eager.generate(prompt, m, extras=ex, speculate=sp, **mode)
            row = {"eager_new": m, "tokens_equal_eager": torch.equal(short, want),
                   "windows_equal_eager": stats == eager.spec_stats,
                   "launches": launches, "launches_counted_as": counted_as,
                   "windows_counted": stats["verify_steps"]}
            check(torch.equal(short, got[:, :m]), f"{label} {arch}: {m} tokens differ from the "
                  f"first of {n}")
            check(row["tokens_equal_eager"] and row["windows_equal_eager"],
                  f"{label} {arch}: the captured windows differ from the eager ones: {row}")
            check(launches == expect(launches, per_step * stats["verify_steps"]),
                  f"{label} {arch}: launches {launches}, expected {per_step} pim_matvec x "
                  f"{stats['verify_steps']} windows")
            return row

        def expect(launches, calls):
            want = dict.fromkeys(launches, 0)
            want["pim_matvec"] = calls
            return want

        t = time.perf_counter()  # n-gram windows of k + 1 rows
        plain = eng.generate(prompt, n, extras=ex)
        rows = []
        for label, mode in (("greedy", GREEDY), ("sampled", SAMPLED)):
            got = eng.generate(prompt, n, extras=ex, speculate=spec, **mode)
            row = {"case": f"n-gram k={spec.k}, {label}", "window_rows": spec.k + 1,
                   "spec_stats": dict(eng.spec_stats)}
            check(got.dtype == torch.int32 and bool(((got >= 0) & (got < cfg.vocab)).all()),
                  f"({sec['ngram']}) {arch} {label}: tokens {got.dtype} out of range")
            row.update(eager_twin(f"({sec['ngram']}) {label}", spec, mode, got))
            if mode["greedy"]:
                row["vs_plain_batch_1"] = self._vs_plain(f"({sec['ngram']}) {label}", eng,
                                                         prompt, got, plain, ex, bar)
            rows.append(row)
        self.launches[f"{self.PHASE} {arch} n-gram windows, batch 1"] = rows[0]["launches"]
        out["ngram"] = {"cases": rows, "pim_matvec_per_window": per_step}
        self._took(rep, sec["ngram"], t)

        t = time.perf_counter()  # the int8 tree as its own draft, window by window
        with torch.inference_mode():  # captured before the count
            eng.spec_step(1, draft, greedy=True, top_k=0, extras=ex)
        (wins, toks), launches, counted_as = counted_launches(
            graphs, lambda: self._windows(eng, draft, prompt, ex, n))
        short = [(j, m) for j, m in wins if m < min(draft.k + 1, n - j)]
        with torch.inference_mode():
            rejected = [{"token": j + m - 1, "plain_top2_gap": plain_gap(
                eng, prompt, 0, j + m - 1, ex)} for j, m in short]
        acc = {"windows": len(wins), "full_windows": len(wins) - len(short),
               "emitted_by_window": [m for _, m in wins], "rejections": rejected,
               "rejections_beyond_bar": sum(r["plain_top2_gap"] > bar for r in rejected),
               "rejections_beyond_paged_bar": sum(r["plain_top2_gap"] > PAGED_BAR
                                                  for r in rejected)}
        acc["vs_plain_batch_1"] = self._vs_plain(f"({sec['draft']}) self-draft", eng, prompt,
                                                 toks, plain, ex, bar)
        check(acc["rejections_beyond_bar"] == 0, f"({sec['draft']}) {arch}: the self-draft "
              f"rejected a proposal where the plain run's top-2 gap exceeds {bar}: {acc}")
        check(launches == expect(launches, per_step * (draft.k + 2) * len(wins)),
              f"({sec['draft']}) {arch}: launches {launches}, expected {per_step} pim_matvec x "
              f"{draft.k + 2} x {len(wins)} windows ({draft.k + 1} one-row draft steps and a "
              f"{draft.k + 1}-row verify)")
        self.launches[f"{self.PHASE} {arch} self-draft windows, batch 1"] = launches
        out["self_draft"] = {**acc, "launches": launches, "launches_counted_as": counted_as}
        self._took(rep, sec["draft"], t)

        t = time.perf_counter()  # tree windows of 1 + fan x depth rows
        got = eng.generate(prompt, n, extras=ex, speculate=tree)
        row = {"case": f"fan {tree.tree_fan} x depth {tree.k}",
               "window_rows": 1 + tree.tree_fan * tree.k, "spec_stats": dict(eng.spec_stats),
               **eager_twin(f"({sec['tree']})", tree, GREEDY, got)}
        row["vs_plain_batch_1"] = self._vs_plain(f"({sec['tree']}) tree", eng, prompt, got,
                                                 plain, ex, bar)
        fan1 = eng.generate(prompt, n, extras=ex, speculate=SpecConfig(k=tree.k, tree_fan=1))
        linear = eng.generate(prompt, n, extras=ex, speculate=SpecConfig(k=tree.k))
        row["fan_1_equal_linear"] = torch.equal(fan1, linear)
        check(row["fan_1_equal_linear"], f"({sec['tree']}) {arch}: tree_fan=1 differs from "
              f"linear k={tree.k}")
        self.launches[f"{self.PHASE} {arch} tree windows, batch 1"] = row["launches"]
        out["tree"] = row
        del eager
        self._took(rep, sec["tree"], t)

        t = time.perf_counter()  # planted chains on a dense store and a paged pool
        out["planted_chains"] = PlantedChains(
            cfg, params, prompt, plain, fan=tree.tree_fan, depth=tree.k,
            page_size=self.PLANT_PS, extras=ex, bar=self.plant_bar(cfg), tie_bar=bar,
            reject_bar=bar, steps=self.PLANT_STEPS, name=f"{self.PHASE} {arch}",
            label=f"({sec['plant']})").run()
        self._took(rep, sec["plant"], t)

        t = time.perf_counter()  # window ms against the plain step, batch 1
        out["window_ms"] = self.window_times(eng, prompt, ex, (spec, draft, tree), {
            spec: rows[0]["spec_stats"], tree: out["tree"]["spec_stats"],
            draft: {"emitted_per_step": (n - 1) / len(wins)}})
        self._took(rep, sec["times"], t)
        del eng, graphs
        rep["speculation"] = out

    @torch.inference_mode()
    def window_times(self, eng, prompt, ex, specs, stats):
        """Device ms a replay of the batch-1 plain step and of each of
        ``specs``' windows, CUDA events over REPS replays, in ROUNDS
        alternating rounds, each run from its own prefill
        once before the rounds (a window's work does not depend on what it
        accepts; none passes the store); and with the tokens a window each
        emitted in the n-gram, self-draft and tree sections (``stats``),
        batch-1 tokens/s over plain."""
        cfg = eng.cfg
        eng.state(1).start(eng.params, cfg, prompt, None, 1.0, greedy=True, top_k=0, extras=ex)
        runs = {"plain step": (eng.step(1, greedy=True, top_k=0, extras=ex), 1, 1.0)}
        for sp in specs:
            name = (f"tree window fan {sp.tree_fan} x depth {sp.k}" if sp.tree_fan
                    else f"{sp.mode} window k={sp.k}")
            runs[name] = (eng.spec_step(1, sp, greedy=True, top_k=0, extras=ex),
                          self.window_rows(sp), stats[sp]["emitted_per_step"])
            if sp.mode == "draft" or sp.tree_fan:  # their own caches: a start each
                self._spec_start(eng, sp, prompt, ex, N_NEW)
        # the n-gram window shares the plain step's cache, which the starts
        # above filled with the same prompt: its own start after them
        self._spec_start(eng, specs[0], prompt, ex, N_NEW)

        def ms(step):
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(self.REPS):
                step()
            z.record()
            z.synchronize()
            return a.elapsed_time(z) / self.REPS

        rounds = []
        for _ in range(self.ROUNDS):
            rounds.append({name: ms(step) for name, (step, _, _) in runs.items()})
            rounds[-1]["sm_clock_mhz"] = tracing.sm_clock_mhz()
        med = {name: sorted(r[name] for r in rounds)[len(rounds) // 2] for name in runs}
        return {"timing": f"device ms a replay at batch 1, CUDA events over {self.REPS} "
                          f"replays, median of {self.ROUNDS} alternating rounds (a draft "
                          "window holds its k + 1 one-row draft steps); tokens/s over plain: "
                          "the tokens a window emitted over its ms, against one a plain step",
                "rows": [{"run": name, "rows": r, "ms": med[name],
                          "over_plain_step": med[name] / med["plain step"],
                          "tokens_per_window": tok,
                          "tokens_per_s_over_plain": tok * med["plain step"] / med[name]}
                         for name, (_, r, tok) in runs.items()], "rounds": rounds}


class CrossPhase(WindowChecks):
    """Phase 17: for each of CROSS, (a) to (h) of the module's docstring."""

    def __init__(self, dev):
        self.dev, self.launches = dev, {}
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count

    def _took(self, rep, section, t0):
        """Record a section's seconds, and print them as it ends."""
        rep["section_s"][section] = time.perf_counter() - t0
        print(f"phase 17 {rep['arch']} ({section}): {rep['section_s'][section]:.1f} s", flush=True)

    def _config(self, arch, groups=CROSS_VLM_GROUPS):
        cfg = get_config(arch)
        if cfg.family == "vlm":
            cfg = cfg.replace(n_layers=groups * cfg.vision.cross_attn_every)
        return cfg

    def _extras(self, cfg, params, gen, batch):
        """Seeded extras of ``batch`` rows: the vlm's image embeds (a stub of
        the vision tower, as in the JAX package), or the encdec's frames
        through ``encode`` on the card (counted: it launches no kernel)."""
        if cfg.family == "vlm":
            n = cfg.vision.n_image_tokens
            return {"image_embeds": torch.randn((batch, n, cfg.d_model), generator=gen,
                                                device=self.dev).to(torch.bfloat16)}
        frames = torch.randn((batch, cfg.audio.n_frames, cfg.d_model), generator=gen,
                             device=self.dev)
        with torch.inference_mode():
            enc, launches, _ = counted_launches([], lambda: encode(params, cfg, frames))
        check(not any(launches.values()), f"the encoder pass launched {launches}")
        self.encode_launches = launches
        return {"enc_out": enc}

    def _weights(self, cfg, gen):
        params = quantized_params(cfg, gen, 8)
        if cfg.family == "vlm":
            lo, hi = CROSS_GATES
            for name in ("gate_attn", "gate_mlp"):
                g = params["groups"]["cross"][name]
                g.copy_(lo + (hi - lo) * torch.rand(g.shape, generator=gen, device=self.dev))
        return params

    def _kv_calls(self, eng, ex):
        """One decode step's cross-attention K/V recomputation: every cross
        block's ``linear`` of wk and wv over the batch's memory."""
        cfg = eng.cfg
        if cfg.family == "vlm":
            mem, paths = ex["image_embeds"], [
                ("groups", "cross", j, "xattn", w)
                for j in range(cfg.n_layers // cfg.vision.cross_attn_every) for w in ("wk", "wv")]
        else:
            mem, paths = ex["enc_out"], [("decoder", i, "cross", w)
                                         for i in range(cfg.dec_layers) for w in ("wk", "wv")]
        return [functools.partial(common.linear, mem, weight_at(eng.params, path))
                for path in paths]

    def _faults(self, cfg):
        """(b)'s planted faults, each a decode call whose last K split (where
        the plan splits K over a cluster) or last chunk of K rows is
        dropped, as {name: (call index, K rows)}: the middle ungated block's
        ``down`` (dense or decoder), the last one's, and the head's."""
        calls = step_calls(cfg)

        def split(i):  # the last K split, or the last chunk of an unsplit K
            k, n = (cfg.d_model, cfg.vocab) if calls[i] == ("head",) else (cfg.d_ff, cfg.d_model)
            pl = matvec_plan(k, n, BATCH, 8, self.sms)
            if pl.cluster > 1:
                return i, k - (pl.cluster - 1) * pl.rows_per_cta
            return i, k - (k - 1) // pl.chunk_rows * pl.chunk_rows
        downs = [i for i, c in enumerate(calls) if c[-1] == "down" and "cross" not in c]
        return {"middle down": split(max(i for i in downs if i <= len(calls) // 2)),
                "last down": split(downs[-1]), "head": split(len(calls) - 1)}

    def overlay(self, eng, prompt, toks, ex, tol, faults=None):
        """(b): the kernel path against the overlay path over the
        teacher-forced ``toks`` (the vlm's overlay generation eager: a
        captured overlay step would keep its dequantized head), within
        ``tol``, and the planted faults ``faults`` (default: the family's
        CROSS_FAULT), the first past ``tol``.  Returns (the report, each
        fault's distance from the overlay path)."""
        cfg = eng.cfg
        n, per_step, calls = toks.shape[1], matvec_calls_per_step(cfg), step_calls(cfg)
        diff, _, lo = against_overlay(eng, prompt, toks, n, f"{cfg.arch_id} int8", tol=tol,
                                      extras=ex, capture=cfg.family != "vlm")
        every = self._faults(cfg)
        faults = faults or (CROSS_FAULT[cfg.family],)
        dist = {}
        for name in faults:
            with decode_linears_through(dropped_call(per_step, *every[name])):
                dist[name] = (forced_logits(eng, prompt, toks, n, ex) - lo).abs().max().item()
        rep = {"max_abs_logit_diff": diff, "tol": tol, "planted_faults": {
            name: {"call": f"{every[name][0]} of {per_step} ({calls[every[name][0]]})",
                   "k_rows_dropped": every[name][1], "max_abs_logit_diff": dist[name]}
            for name in faults}}
        first = faults[0]
        rep.update(planted_fault=f"{first}: " + rep["planted_faults"][first]["call"],
                   planted_fault_max_abs_logit_diff=dist[first])
        if math.isfinite(tol):
            check(dist[first] > tol, f"(b) {cfg.arch_id}: the planted fault ({first}) moved the "
                  f"logits by {dist[first]:.4g}, within the bar {tol}: the check cannot see it")
        return rep, dist

    def serve(self, rep, cfg, params, gen):
        """(e) and the slot fault of (f)."""
        dev, b = self.dev, len(CROSS_TRACE)
        laps, t = {}, [time.perf_counter()]

        def lap(part):  # the seconds of (e)'s parts, for the run's time budget
            torch.cuda.synchronize()
            laps[part], t[0] = time.perf_counter() - t[0], time.perf_counter()
        ex = self._extras(cfg, params, gen, b)
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen, device=dev).cpu().numpy()
                   .astype(np.int32) for n, _ in CROSS_TRACE]
        prompts[CROSS_HIT] = prompts[CROSS_MISS] = prompts[1]
        budgets = [m for _, m in CROSS_TRACE]
        rows = [{k: v[r] for k, v in ex.items()} for r in range(b)]
        rows[CROSS_HIT] = rows[1]
        solo = ServingEngine(cfg, params, max_seq=CROSS_SERVE["max_seq"], device=dev)
        with torch.inference_mode():  # the hit's prompt and extras are request 1's
            dense = [None if r == CROSS_HIT else solo.generate(
                torch.from_numpy(p)[None].to(dev), m,
                extras={k: v[None] for k, v in e.items()})[0].cpu().numpy()
                for r, (p, m, e) in enumerate(zip(prompts, budgets, rows))]
        dense[CROSS_HIT] = dense[1][:budgets[CROSS_HIT]]
        del solo
        lap("solo generates")
        d = dense[CROSS_STOPPED]  # the first new token nearest the middle of its solo run
        j = min((j for j in range(1, len(d)) if d[j] not in d[:j]),
                key=lambda j: abs(j - len(d) // 2), default=0)
        stops = [()] * b
        stops[CROSS_STOPPED] = (int(d[j]),)
        reqs = [Request(prompt=p, max_new=m, stop_tokens=st, extras=e)
                for p, m, st, e in zip(prompts, budgets, stops, rows)]
        lengths = [expected_length(dn, m, st) for dn, m, st in zip(dense, budgets, stops)]
        eng = TimedEngine(cfg, params, prefix_cache=True, device=dev, **CROSS_SERVE)
        graphs = count_captures(eng)
        eager = EagerEngine(cfg, params, prefix_cache=True, device=dev, **CROSS_SERVE)
        out = eng.serve(reqs)
        lap("captured serve")
        report = eng.last_report
        admits = {r: [e for e in rec.events if e["name"] == "admit"]
                  for r, rec in enumerate(report.records)}
        cached = [a[0]["cached_tokens"] for a in admits.values()]
        check(report.prefix_hits == 1 and cached[CROSS_HIT] > 0 and cached[CROSS_MISS] == 0,
              f"(e) {cfg.arch_id}: the prefix cache did not hit only under the same extras: "
              f"{cached}")
        # The trace's first CROSS_EAGER requests (request 2 admitted into a
        # freed slot, request 3 the hit) counted, then served eagerly: the
        # captured serve must be the eager one bit for bit.
        first = reqs[:CROSS_EAGER]
        out_f, launches, counted_as = counted_launches(graphs, lambda: eng.serve(first))
        rep_f = eng.last_report
        # a step's calls an iteration and a full hit's window; an uncached
        # admit unembeds its last position through the untied head
        misses_n = sum(e["cached_tokens"] == 0 for rec in rep_f.records
                       for e in rec.events if e["name"] == "admit")
        expect = dict.fromkeys(launches, 0)
        expect["pim_matvec"] = (matvec_calls_per_step(cfg) * (eng.decode_chunk_iters
                                                              + eng.cow_forks)
                                + (0 if cfg.tie_embeddings else misses_n))
        check(launches == expect, f"(e) {cfg.arch_id} serve: launches {launches}, expected "
              f"{expect}")
        self.launches[f"phase 17 {cfg.arch_id} serve"] = launches
        lap("counted serve")
        out_e = eager.serve(first)
        lap("eager serve")
        same = {"requests": len(first), "tokens_equal": same_tokens(out_f, out_e),
                "events_equal": events_of(rep_f) == events_of(eager.last_report),
                "peak_pages": [eng.peak_pages_in_use, eager.peak_pages_in_use],
                "rounds": rep_f.rounds, "decode_chunk_iters": eng.decode_chunk_iters,
                "tokens": sum(len(o) for o in out_f), "prefix_hits": rep_f.prefix_hits,
                "cow_forks": rep_f.cow_forks, "whole_trace_cached_tokens": cached,
                "whole_trace_rounds": report.rounds}
        check(same["tokens_equal"] and same["events_equal"] and rep_f.prefix_hits == 1
              and eng.peak_pages_in_use == eager.peak_pages_in_use
              and same_tokens(out_f, out[:CROSS_EAGER]),
              f"(e) {cfg.arch_id}: the captured serve differs from the eager one: {same}")
        del eager
        # each miss served alone on the same engine (its graphs kept), then
        # the planted fault
        misses = [r for r in range(b) if r != CROSS_HIT]
        out_a = {r: eng.serve([reqs[r]])[0] for r in misses}
        lap("each miss served alone")
        with admits_into_next_slot(eng):
            out_w = eng.serve(first)
        lap("planted next-slot serve")
        del eng, graphs
        gc.collect()
        torch.cuda.empty_cache()

        def gap_at(r, j):  # the solo run's top-2 gap before token j
            seq = np.concatenate([prompts[r], dense[r][:j]])
            seq = torch.from_numpy(seq)[None].to(dev)
            logits, _ = prefill(params, cfg, seq, init_cache(cfg, 1, seq.shape[1], dev),
                                {k: v[None] for k, v in rows[r].items()})
            return top2_gap(logits[0, -1])
        # Against the solo runs, margin-aware at the family's CROSS_SOLO_BARS
        # (ROADMAP section 3).  Each miss is held exactly against itself
        # served alone on the same geometry: its tokens may not depend on its
        # slot or its slot-mates.
        bars = CROSS_SOLO_BARS[cfg.family]
        with torch.inference_mode():
            vs = paged_vs_dense(f"(e) {cfg.arch_id} misses", [out[r] for r in misses],
                                [dense[r] for r in misses], [lengths[r] for r in misses],
                                lambda r, j: gap_at(misses[r], j), bars["miss"])
            hit = paged_vs_dense(f"(e) {cfg.arch_id} the hit", [out[CROSS_HIT]],
                                 [dense[CROSS_HIT]], [lengths[CROSS_HIT]],
                                 lambda r, j: gap_at(CROSS_HIT, j), bars["hit"])
        lap("vs solo")
        for v in (vs, hit):
            v["beyond_paged_bar"] = sum(beyond(dv, PAGED_BAR) for dv in v["divergences"])
        apart = [r for r in misses if not np.array_equal(out_a[r], out[r])]
        check(not apart, f"(e) {cfg.arch_id}: requests {apart} differ from themselves served "
              "alone")
        # the sound and the faulty serve replay the same graphs on the same
        # inputs: any token apart is the fault's
        caught = sum(not np.array_equal(a, w) for a, w in zip(out_f, out_w))
        check(caught > 0, f"(f) {cfg.arch_id}: the admit writing into the next slot went "
              "unseen")
        rep["serve"] = {"captured_vs_eager": same, "vs_solo_misses": vs, "vs_solo_hit": hit,
                        "bars": bars, "misses_equal_served_alone": len(misses),
                        "launches": {"launches": launches, "counted_as": counted_as},
                        "stop": {"request": CROSS_STOPPED, "token": stops[CROSS_STOPPED][0],
                                 "emitted": len(out[CROSS_STOPPED])},
                        "planted_next_slot": {"requests": len(first),
                                              "requests_differing": caught},
                        "section_s": laps}
        # what (m) serves again under speculation
        self.trace = {"reqs": reqs, "dense": dense, "lengths": lengths, "gap_at": gap_at}

    # ---- (m): speculation on the continuous engine (WindowChecks: (i)-(l), (n)) ----------
    def spec_serves(self, rep, cfg, params):
        """(m): the continuous engine on (e)'s CROSS_SPEC_REQUESTS under
        n-gram windows (2 slots x 4 = 8 rows), then tree windows (2 x 3 = 6
        rows)."""
        dev, arch, tr = self.dev, cfg.arch_id, self.trace
        idx = CROSS_SPEC_REQUESTS
        dense = [tr["dense"][i] for i in idx]
        bars, per_step = CROSS_SOLO_BARS[cfg.family], matvec_calls_per_step(cfg)
        first = [Request(prompt=r.prompt, max_new=min(r.max_new, CROSS_SPEC_SERVE_NEW),
                         stop_tokens=r.stop_tokens, extras=r.extras)
                 for r in (tr["reqs"][i] for i in idx)]
        lengths = [expected_length(d, f.max_new, f.stop_tokens) for d, f in zip(dense, first)]
        hit = idx.index(CROSS_HIT)
        misses = [r for r in range(len(first)) if r != hit]

        def gap_at(r, j):
            return tr["gap_at"](idx[r], j)
        out = {"bars": bars, "requests": list(idx), "max_new": CROSS_SPEC_SERVE_NEW}
        for name, sp in CROSS_SERVE_SPEC.items():
            spec = SpecConfig(**sp)
            geo = dict(prefix_cache=True, speculate=spec, device=dev, **CROSS_SERVE)
            eng, eager = TimedEngine(cfg, params, **geo), EagerEngine(cfg, params, **geo)
            graphs = count_captures(eng)
            row = {"window_rows": CROSS_SERVE["slots"] * (1 + spec.k * max(spec.tree_fan, 1))}
            modes = (("greedy", GREEDY), ("sampled", SAMPLED)) if name == "n-gram" else (
                ("greedy", GREEDY),)
            for label, mode in modes:
                got = eng.serve(first, **mode)
                events, hits = events_of(eng.last_report), eng.last_report.prefix_hits
                want = eager.serve(first, **mode)
                same = {"tokens_equal": same_tokens(got, want),
                        "events_equal": events == events_of(eager.last_report),
                        "prefix_hits": hits, "windows": eng.spec_live_steps}
                check(same["tokens_equal"] and same["events_equal"] and hits == 1,
                      f"(m) {arch} {name} {label}: the captured serve differs from the eager "
                      f"one, or hit other than once: {same}")
                row[f"{label}_equal_eager"] = same
                if label == "greedy":
                    sound = got
            with torch.inference_mode():  # against each request's solo run
                row["vs_solo_misses"] = paged_vs_dense(
                    f"(m) {arch} {name} misses", [sound[r] for r in misses],
                    [dense[r] for r in misses], [lengths[r] for r in misses],
                    lambda r, j: gap_at(misses[r], j), bars["miss"])
                row["vs_solo_hit"] = paged_vs_dense(
                    f"(m) {arch} {name} the hit", [sound[hit]], [dense[hit]], [lengths[hit]],
                    lambda r, j: gap_at(hit, j), bars["hit"])
            del eager
            _, launches, counted_as = counted_launches(graphs, lambda: eng.serve(first))
            misses_n = sum(e["cached_tokens"] == 0 for rec in eng.last_report.records
                           for e in rec.events if e["name"] == "admit")
            want = dict.fromkeys(launches, 0)
            want["pim_matvec"] = (per_step * (eng.decode_chunk_iters + eng.cow_forks)
                                  + (0 if cfg.tie_embeddings else misses_n))
            check(launches == want, f"(m) {arch} {name}: launches {launches}, expected {want}")
            self.launches[f"phase 17 {arch} {name} serve"] = launches
            row["launches"] = {"launches": launches, "counted_as": counted_as,
                               "iterations": eng.decode_chunk_iters}
            if name == "n-gram":  # the planted faults, against the same graphs' sound output
                faults = {}
                with admits_into_next_slot(eng):
                    faults["admits_into_next_slot"] = eng.serve(first)
                with stale_extras():
                    faults["stale_extras"] = eng.serve(first)
                row["planted_faults"] = {
                    f: sum(not np.array_equal(x, y) for x, y in zip(sound, o))
                    for f, o in faults.items()}
                for f, caught in row["planted_faults"].items():
                    check(caught > 0, f"(m) {arch}: the planted fault {f} went unseen under "
                                      "speculation")
            out[name] = row
            del eng, graphs
            gc.collect()
            torch.cuda.empty_cache()
        rep["spec_serves"] = out

    def config(self, arch, seed):
        """(a) to (n) for one config."""
        dev, cfg = self.dev, self._config(arch)
        gen = torch.Generator(device=dev).manual_seed(seed)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = self._weights(cfg, gen)
        torch.cuda.synchronize()
        eng = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW, device=dev)
        per_step = matvec_calls_per_step(cfg)
        rep = {"arch": arch, "layers": cfg.n_layers, "dec_layers": cfg.dec_layers,
               "d_model": cfg.d_model,
               "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim,
               "d_ff": cfg.d_ff, "vocab": cfg.vocab, "weights_s": time.perf_counter() - t0,
               "int8_bytes": pim_bytes(params),
               "peak_bytes_drawing": torch.cuda.max_memory_allocated(), "section_s": {}}
        if cfg.family == "vlm":
            rep["groups"] = f"{CROSS_VLM_GROUPS} of {get_config(arch).n_layers // 5}"
            rep["gates"] = [params["groups"]["cross"][n].float().cpu().tolist()
                            for n in ("gate_attn", "gate_mlp")]
        print(f"phase 17 {arch} (weights): {rep['weights_s']:.1f} s, "
              f"{rep['int8_bytes']} bytes, peak {rep['peak_bytes_drawing']}", flush=True)
        prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen, device=dev)
        ex = self._extras(cfg, params, gen, BATCH)
        graphs = count_captures(eng)

        t = time.perf_counter()  # (a) captured against eager, greedy and sampled
        with torch.inference_mode():
            greedy, toks = captured_vs_eager(eng, prompt, N_NEW, f"{arch} int8 greedy, "
                                             f"{BATCH} x {PROMPT}", extras=ex, **GREEDY)
            sampled, stoks = captured_vs_eager(eng, prompt, N_NEW, f"{arch} int8 sampled, "
                                               f"{BATCH} x {PROMPT}", extras=ex, **SAMPLED)
        check(not torch.equal(stoks, toks), f"(a) {arch}: sampled tokens equal greedy ones")
        rep["captured_vs_eager"] = [greedy, sampled]
        self._took(rep, "a", t)

        t = time.perf_counter()  # (d) launches: the step's, the encoder's, the cross K/V's
        _, launches, counted_as = counted_launches(
            graphs, lambda: eng.generate(prompt, N_NEW, extras=ex))
        expect = dict.fromkeys(launches, 0)
        expect["pim_matvec"] = per_step * (N_NEW - 1)
        check(launches == expect, f"(d) {arch}: launches {launches}, expected {expect}")
        check(all(g.launches["pim_matvec"] == per_step for g in graphs),
              f"(d) {arch}: captured steps launch {[g.launches for g in graphs]}, expected "
              f"{per_step} pim_matvec each")
        kv_calls = self._kv_calls(eng, ex)
        with torch.inference_mode():
            _, kv_launches, _ = counted_launches([], lambda: [c() for c in kv_calls])
        check(not any(kv_launches.values()), f"(d) {arch}: the cross K/V launched {kv_launches}")
        self.launches[f"phase 17 {arch} generate"] = launches
        rep["launches"] = {"launches": launches, "per_step": per_step, "counted_as": counted_as,
                           "cross_kv_linears": {"calls": len(kv_calls),
                                                "launches": kv_launches}}
        if cfg.family == "encdec":
            rep["launches"]["encoder_pass"] = self.encode_launches
        self._took(rep, "d", t)

        t = time.perf_counter()  # (b) the kernel path against the overlay path
        ftoks = toks[:, :CROSS_CHECK_NEW]
        rep["overlay"], _ = self.overlay(eng, prompt, ftoks, ex, CROSS_OVERLAY_TOL[cfg.family])
        self._took(rep, "b", t)

        t = time.perf_counter()  # (f) the stale-extras replay
        # A second call's extras replayed (and held against the eager loop),
        # the first call's again, then the second's with the buffer left
        # unrefreshed: the same graphs on the first call's extras.
        ex2 = self._extras(cfg, params, gen, BATCH)
        with torch.inference_mode():
            sound, want2 = captured_vs_eager(eng, prompt, STALE_NEW, f"{arch} int8 greedy, "
                                             "second extras", extras=ex2, **GREEDY)
            logits2 = eng.state(BATCH).logits.clone()
            eng.generate(prompt, STALE_NEW, extras=ex)
            with stale_extras():
                got2 = eng.generate(prompt, STALE_NEW, extras=ex2)
            stale2 = eng.state(BATCH).logits
            caught = not torch.equal(stale2, logits2)
            stale_diff = (stale2.float() - logits2.float()).abs().max().item()
        check(caught, f"(f) {arch}: a replay on the previous call's extras went unseen")
        rep["planted_stale_extras"] = {"second_call_captured_vs_eager": sound,
                                       "stale_tokens_differing": int((got2 != want2).sum()),
                                       "last_logits_max_abs_diff": stale_diff}
        del logits2
        self._took(rep, "f_stale", t)

        t = time.perf_counter()  # (g) ms a step, the cross K/V's share, the head
        with torch.inference_mode():
            med, rounds = step_ms({"captured_ms": (eng, GREEDY),
                                   "captured_sampled_ms": (eng, SAMPLED)},
                                  prompt, N_NEW, CROSS_ROUNDS, extras=ex)
            kv_ms = _time_ms(kv_calls, 20) * len(kv_calls)
            mv = [weight_at(eng.params, c) for c in step_calls(cfg)]
            xs = {k: torch.randn((BATCH, k), generator=gen, device=dev).to(torch.bfloat16)
                  for k in {w["codes"].shape[0] for w in mv}}
            mv_ms = _time_ms([functools.partial(pim_matvec, xs[w["codes"].shape[0]], w["codes"],
                                                w["scale"], bits=8) for w in mv], 20) * len(mv)
            head = eng.params["head"]
            head_ms = _time_ms([functools.partial(pim_matvec, xs[cfg.d_model], head["codes"],
                                                  head["scale"], bits=8)], 50)
        floor_ms = cross_stream_bytes(eng) / HBM_BYTES_PER_S * 1e3
        head_floor = pim_bytes({"head": head}) / HBM_BYTES_PER_S * 1e3
        rep["step"] = {**med, "stream_bytes": cross_stream_bytes(eng), "floor_ms": floor_ms,
                       "floor_share": floor_ms / med["captured_ms"],
                       "pim_matvec_ms": mv_ms, "pim_matvec_share": mv_ms / med["captured_ms"],
                       "cross_kv_ms": kv_ms, "cross_kv_share": kv_ms / med["captured_ms"],
                       "head_ms": head_ms, "head_floor_ms": head_floor,
                       "head_over_floor": head_ms / head_floor,
                       "head_route": {"N": cfg.vocab, "N_mod_16": cfg.vocab % 16},
                       "rounds": rounds,
                       "timing": f"device ms a captured step at {BATCH} x {PROMPT}, CUDA events "
                                 f"over {N_NEW - 1} replays, median of {CROSS_ROUNDS} alternating "
                                 "rounds; floor: the stream at 3.35 TB/s; the cross K/V, the "
                                 "step's pim_matvec calls and the head alone in CUDA graphs"}
        self._took(rep, "g", t)

        ex1 = {k: v[:1].clone() for k, v in ex.items()}
        del eng, graphs, ex, ex2, kv_calls, mv, head
        gc.collect()
        torch.cuda.empty_cache()

        t = time.perf_counter()  # (e) the continuous engine, and its planted fault
        self.serve(rep, cfg, params, gen)
        self._took(rep, "e", t)
        self.speculation(rep, cfg, params, prompt[:1], ex1)  # (i)-(l), (n)
        gc.collect()  # the counted captures hold each engine in a cycle
        torch.cuda.empty_cache()
        t = time.perf_counter()  # (m) the continuous engine under speculation
        self.spec_serves(rep, cfg, params)
        self._took(rep, "m", t)
        self.trace = None  # its solo-gap closure holds the int8 tree
        rep["peak_bytes"] = torch.cuda.max_memory_allocated()
        del params
        gc.collect()
        torch.cuda.empty_cache()

        t = time.perf_counter()  # (c) the f32 path at reduced depth against plain
        cfg32 = cfg.replace(param_dtype="float32", **CROSS_F32[cfg.family])
        eng32 = ServingEngine(cfg32, self._weights(cfg32, gen), max_seq=PROMPT + N_NEW,
                              device=dev)
        ex32 = self._extras(cfg32, eng32.params, gen, BATCH)
        lk = forced_logits(eng32, prompt, ftoks, CROSS_CHECK_NEW, ex32)
        with decode_linears_through(pim_matvec_plain):
            lp = forced_logits(eng32, prompt, ftoks, CROSS_CHECK_NEW, ex32)
        rolled = {k: v.roll(1, dims=0) for k, v in ex32.items()}
        lf = forced_logits(eng32, prompt, ftoks, CROSS_CHECK_NEW, rolled)
        diff32, fault32 = (lk - lp).abs().max().item(), (lf - lp).abs().max().item()
        rep["f32_path"] = {"layers": cfg32.n_layers, "dec_layers": cfg32.dec_layers,
                           "max_abs_logit_diff": diff32, "tol": PATH_TOL,
                           "logit_std": lp.std().item(),
                           "planted_fault": "each row's extras rolled to the next row",
                           "planted_fault_max_abs_logit_diff": fault32}
        check(bool(torch.isfinite(lk).all()) and diff32 <= PATH_TOL,
              f"(c) {arch}: the f32 kernel path differs from plain by {diff32:.4g}")
        check(fault32 > PATH_TOL, f"(c) {arch}: rolled extras moved the f32 logits by only "
              f"{fault32:.4g} <= {PATH_TOL}: the check cannot see them")
        del eng32, ex32, rolled, lk, lp, lf
        gc.collect()
        torch.cuda.empty_cache()
        self._took(rep, "c", t)

        t = time.perf_counter()  # (h) the kernel at the config's shapes, the unaligned head
        k, n = cfg.d_model, cfg.vocab
        pl = matvec_plan(k, n, BATCH, 8, self.sms)
        rep["kernel_vs_plain"], q = family_kernel_cases(
            cfg, gen, extra=[(cfg.d_model, CROSS_SMALL_N)],
            chunk_fault=pl.chunk_rows < pl.rows_per_cta)
        x = torch.randn((BATCH, k), generator=gen, device=dev).to(torch.bfloat16)
        ref = pim_matvec_plain(x, q.codes, q.scale, bits=8)
        ok, tail_err = within_tol(pim_matvec(x, q.codes, q.scale, bits=8)[:, -CROSS_TAIL:],
                                  ref[:, -CROSS_TAIL:])
        check(ok, f"(h) {arch}: the head's last {CROSS_TAIL} columns differ from plain by "
              f"{tail_err:.3g}")
        faulty = ref.clone()
        faulty[:, -CROSS_TAIL:] = 0
        fault_ok, fault_err = within_tol(faulty[:, -CROSS_TAIL:], ref[:, -CROSS_TAIL:])
        check(not fault_ok, f"(h) {arch}: the tail check passes the plain output with its last "
              f"{CROSS_TAIL} columns zeroed")
        rep["kernel_vs_plain"].update(tail={"columns": CROSS_TAIL, "max_abs_err": tail_err,
                                            "planted_fault": "the plain output's last columns "
                                                             "zeroed",
                                            "planted_fault_max_abs_err": fault_err},
                                      head_plan={"tile_n": pl.tile_n, "cluster": pl.cluster,
                                                 "chunked": pl.chunk_rows < pl.rows_per_cta})
        self._took(rep, "h", t)
        check(rep["peak_bytes"] < torch.cuda.get_device_properties(0).total_memory,
              f"{arch}: peak {rep['peak_bytes']} bytes")
        print(f"phase 17 {arch}: " + json.dumps(rep), flush=True)
        return rep

    def run(self):
        report = {"check": "phase 17: the vlm and encdec families at full width, int8 weights, "
                           "per-request extras and speculation on both engines", "configs": {},
                  "section_s": {}}
        t0 = time.perf_counter()
        for i, arch in enumerate(CROSS):
            t = time.perf_counter()
            rep = self.config(arch, SEED + 10 + i)
            report["configs"][arch] = {
                "layers": rep["layers"], "dec_layers": rep["dec_layers"],
                "captured_equal_eager": all(r["tokens_equal"] and r["last_logits_equal"]
                                            for r in rep["captured_vs_eager"]),
                "pim_matvec_per_step": rep["launches"]["per_step"],
                "pim_matvec": rep["launches"]["launches"]["pim_matvec"],
                "overlay_max_abs_logit_diff": rep["overlay"]["max_abs_logit_diff"],
                "overlay_planted_fault": rep["overlay"]["planted_fault_max_abs_logit_diff"],
                "f32_path_max_abs_logit_diff": rep["f32_path"]["max_abs_logit_diff"],
                "f32_path_planted_fault": rep["f32_path"]["planted_fault_max_abs_logit_diff"],
                "serve_equal_eager": rep["serve"]["captured_vs_eager"]["tokens_equal"],
                "serve_cached_tokens":
                    rep["serve"]["captured_vs_eager"]["whole_trace_cached_tokens"],
                "stale_extras_caught": rep["planted_stale_extras"]["last_logits_max_abs_diff"],
                "next_slot_caught": rep["serve"]["planted_next_slot"]["requests_differing"],
                "kernel_max_abs_err": rep["kernel_vs_plain"]["max_abs_err"],
                "kernel_tail_err": rep["kernel_vs_plain"]["tail"]["max_abs_err"],
                "step_ms": rep["step"]["captured_ms"],
                "sampled_step_ms": rep["step"]["captured_sampled_ms"],
                "floor_ms": rep["step"]["floor_ms"], "cross_kv_ms": rep["step"]["cross_kv_ms"],
                "cross_kv_share": rep["step"]["cross_kv_share"],
                "head_ms": rep["step"]["head_ms"], "head_floor_ms": rep["step"]["head_floor_ms"],
                "pim_matvec_ms": rep["step"]["pim_matvec_ms"],
                "sm_clock_mhz": [r["sm_clock_mhz"] for r in rep["step"]["rounds"]],
                "peak_bytes": rep["peak_bytes"], "speculation": spec_summary(rep)}
            report["section_s"][arch] = time.perf_counter() - t
        report["phase_s"] = time.perf_counter() - t0
        print(json.dumps(report), flush=True)
        return self.launches


def spec_summary(rep):
    """Phase 17 (i)-(n)'s numbers of one config's report."""
    sp, sv = rep["speculation"], rep["spec_serves"]
    return {"bar": sp["bar"],
            "ngram_equal_eager": all(r["tokens_equal_eager"] for r in sp["ngram"]["cases"]),
            "ngram_vs_plain": sp["ngram"]["cases"][0]["vs_plain_batch_1"]["divergences"],
            "ngram_windows": sp["ngram"]["cases"][0]["spec_stats"]["verify_steps"],
            "ngram_pim_matvec": [sp["ngram"]["cases"][0]["launches"]["pim_matvec"],
                                 sp["ngram"]["cases"][0]["windows_counted"]],
            "self_draft_full_windows": [sp["self_draft"]["full_windows"],
                                        sp["self_draft"]["windows"]],
            "self_draft_rejections": sp["self_draft"]["rejections"],
            "self_draft_pim_matvec": sp["self_draft"]["launches"]["pim_matvec"],
            "tree_equal_eager": sp["tree"]["tokens_equal_eager"],
            "tree_pim_matvec": [sp["tree"]["launches"]["pim_matvec"],
                                sp["tree"]["windows_counted"]],
            "planted": {layout: {"accepted": r["accepted"], "kept_chain": r["kept_chain"],
                                 "sound": r["relocation"]["continued_max_abs_logit_diff"],
                                 "late": r["planted_fault"]["continued_max_abs_logit_diff"]}
                        for layout, r in sp["planted_chains"].items()
                        if layout in ("dense", "paged")},
            "window_ms": {r["run"]: r["ms"] for r in sp["window_ms"]["rows"]},
            "tokens_per_s_over_plain": {r["run"]: r["tokens_per_s_over_plain"]
                                        for r in sp["window_ms"]["rows"]},
            "serves": {name: {"launches": sv[name]["launches"]["launches"]["pim_matvec"],
                              "planted_faults": sv[name].get("planted_faults")}
                       for name in CROSS_SERVE_SPEC}}


# ---- 18. the moe family -------------------------------------------------------------------
# moonshot-v1-16b-a3b at full width and MOE_LAYERS of its 48 layers, drawn and
# quantized one (K, N) slice at a time (``quantized_params``, int8), on a
# generator of its own (SEED + 12).  Its routed experts run x @ dq(w) over
# every expert's whole stack, as in the JAX package; its attention and shared
# experts, its dense first layer and its untied head pim_matvec.
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_LAYERS = 8  # of its 48: all 48 before phase 19, 12 before phase 20 (the cuts pay for them)
MOE_F32_LAYERS = 4  # (c): the dense first layer and three MoE layers
MOE_CHECK_NEW = 8  # (c), (d): the first tokens of (b)'s greedy generation, teacher-forced
MOE_TIME_STEPS = 4  # (b): captured replays timed, greedy and sampled
# (d): the bar of the bf16 kernel path's distance from the overlay path, and
# the planted fault that must exceed it.  Phase 16's bar (the distance (c)'s
# planted fault makes) does not hold here: on the H100 at all 48 layers the
# sound paths differed by 0.474 where (c)'s fault, a middle shared expert's
# ``down`` losing its last K split (352 of 2,816 rows), moved them by 0.450;
# the dense first layer's ``down`` losing its last K split (1,408 of 11,264
# rows) moved them by 1.96, the head's last 256 / 512 K rows by 1.73 / 2.81
# (PERF.md section 6).  So the bar is a constant, about twice the sound
# distance, and the dense layer's fault must pass it.
MOE_OVERLAY_TOL = 1.0
# (a): added to the router's column 0 of the planted case, whose x has a
# positive mean: every token takes expert 0, whose capacity at 128 tokens a
# row is 15, so at least 113 pairs a row are dropped.
MOE_PLANT, MOE_PLANT_S = 0.05, 128
# (e): four requests over two slots, every prompt a whole number of pages (a
# padded prompt routes its pad tokens within its group, so its capacity is
# not that of a solo prefill of the prompt); request MOE_REPEAT repeats
# request 0's prompt, which the prefix cache must not hit on this family.
MOE_SERVE = dict(slots=2, page_size=16, chunk=4, max_seq=160, page_alloc_seed=SEED)
MOE_TRACE = ((128, 5), (64, 4), (96, 5), (128, 4))
MOE_REPEAT = 3
MOE_EAGER, MOE_EAGER_NEW = 2, 4  # (e): the eager twin's requests and budget
# (g): a batch-1 n-gram speculative generate of MOE_SPEC_NEW tokens, windows
# of k + 1 = 5 rows (one dispatch group of capacity 6: nothing a one-token
# step keeps is dropped), captured against eager on its first
# MOE_SPEC_EAGER_NEW tokens.
MOE_SPEC = dict(k=4)
MOE_SPEC_NEW, MOE_SPEC_EAGER_NEW = 16, 6


class MoePhase:
    """Phase 18: (a) to (g) of the module's docstring for MOE_ARCH at
    MOE_LAYERS layers.  ``MlaPhase`` runs the same sections for phase 19.
    ``EAGER_TWINS``: (b)'s generations held against their eager loops
    (phase 18's were cut to pay for phase 19, which holds the moe family's
    there); ``SOLO_BAR``: (e)'s bar against the solo runs."""

    NAME, ARCH, LAYERS, SEED_OFFSET = "phase 18", MOE_ARCH, MOE_LAYERS, 12
    OVERLAY_TOL, EAGER_TWINS, SOLO_BAR = MOE_OVERLAY_TOL, False, PAGED_BAR

    def __init__(self, dev):
        self.dev, self.launches = dev, {}
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count

    def _took(self, rep, section, t0):
        rep["section_s"][section] = time.perf_counter() - t0
        print(f"{self.NAME} ({section}): {rep['section_s'][section]:.1f} s", flush=True)

    def moe_layer(self, cfg, gen):
        """(a): ``moe_apply`` (index dispatch) against ``moe_apply_onehot`` (the
        JAX package's one-hot einsums transcribed) on one f32 MoE layer at
        full width: BATCH rows of one token (nothing dropped), and BATCH rows
        of MOE_PLANT_S tokens with expert 0 planted in every token's top k:
        the kept pairs equal, the drops counted equal and past the planted
        floor, y within KERNEL_TOL, the aux losses within it."""
        dev, m = self.dev, cfg.moe
        p = moe.moe_init(gen, cfg.d_model, m, torch.float32, dev)
        planted = dict(p, router=p["router"].clone())
        planted["router"][:, 0] += MOE_PLANT
        cases = {
            f"{BATCH} x 1": (p, torch.randn((BATCH, 1, cfg.d_model), generator=gen, device=dev)),
            f"{BATCH} x {MOE_PLANT_S}, expert 0 planted": (planted, 0.5 + torch.randn(
                (BATCH, MOE_PLANT_S, cfg.d_model), generator=gen, device=dev))}
        out = {}
        for name, (pp, x) in cases.items():
            with torch.inference_mode():
                y, aux = moe.moe_apply(pp, x, m)
                yo, auxo, keep = moe.moe_apply_onehot(pp, x, m)
                r = moe.route(pp, x, m)
            torch.cuda.synchronize()
            ok, err = within_tol(y, yo)
            aux_err = max(abs(aux[k].item() - auxo[k].item()) for k in aux)
            out[name] = {"capacity": r.cap, "drops": int((~r.keep).sum()),
                         "onehot_drops": int((~keep).sum()), "max_abs_err": err,
                         "aux_max_abs_err": aux_err, "tol": KERNEL_TOL}
            check(ok and torch.equal(r.keep, keep) and aux_err <= KERNEL_TOL["atol"],
                  f"(a) moe_apply {name}: against the one-hot form {out[name]}")
        one, many = out.values()
        floor = BATCH * (MOE_PLANT_S - many["capacity"])
        check(one["drops"] == 0 and many["drops"] >= floor,
              f"(a) moe_apply drops {one['drops']} / {many['drops']}, expected 0 / >= {floor}")
        return out

    def layer_checks(self, rep, cfg, gen):
        """(a): ``moe_apply`` (``moe_layer``), ``pim_matvec`` and
        ``flash_attention`` at the config's shapes."""
        fs = cfg.moe.n_shared * cfg.moe.d_ff_expert
        rep["moe_apply"] = self.moe_layer(cfg, gen)
        pl = matvec_plan(cfg.d_model, cfg.vocab, BATCH, 8, self.sms)
        rep["kernel_vs_plain"], _ = family_kernel_cases(
            cfg, gen, extra=[(cfg.d_model, fs), (fs, cfg.d_model)],
            chunk_fault=pl.chunk_rows < pl.rows_per_cta)
        rep["attention"] = family_attention(cfg, gen)

    def serve(self, rep, cfg, params, eng, gen):
        """(e): MOE_TRACE on the continuous engine with ``prefix_cache=True``:
        each request served alone first (its graphs captured), then the
        trace counted; each request's tokens ``torch.equal`` to its own
        served alone, no prefix hit, captured == ``EagerEngine`` on the first
        MOE_EAGER requests at MOE_EAGER_NEW new, and each request against
        its solo ``generate`` (``eng``, batch 1) at SOLO_BAR, beside the
        logits of request 0's decode steps at batch 1 against batch 2.
        Keeps the trace, the solo runs and their gaps in ``self.trace``
        for (g)."""
        dev, per_step, arch = self.dev, matvec_calls_per_step(cfg), cfg.arch_id
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen, device=dev).cpu().numpy()
                   .astype(np.int32) for n, _ in MOE_TRACE]
        prompts[MOE_REPEAT] = prompts[0]
        budgets = [m for _, m in MOE_TRACE]
        reqs = [Request(prompt=p, max_new=m) for p, m in zip(prompts, budgets)]
        ce = ContinuousBatchingEngine(cfg, params, prefix_cache=True, device=dev, **MOE_SERVE)
        graphs = count_captures(ce)
        alone = [ce.serve([r])[0] for r in reqs]
        out, launches, counted_as = counted_launches(graphs, lambda: ce.serve(reqs))
        report, iters = ce.last_report, ce.decode_chunk_iters
        cached = [e["cached_tokens"] for rec in report.records for e in rec.events
                  if e["name"] == "admit"]
        check(report.prefix_hits == 0 and not any(cached),
              f"(e) {arch}: the prefix cache hit on moe: {cached}")
        # a step's calls an iteration; an admit unembeds its last position
        # through the untied head
        expect = dict.fromkeys(launches, 0)
        expect["pim_matvec"] = per_step * iters + len(reqs)
        check(launches == expect, f"(e) {arch} serve: launches {launches}, expected {expect}")
        self.launches[f"{self.NAME} {arch} serve"] = launches
        apart = [r for r in range(len(reqs)) if not np.array_equal(alone[r], out[r])]
        check(not apart, f"(e) {arch}: requests {apart} differ from themselves served alone")
        first = [Request(prompt=r.prompt, max_new=MOE_EAGER_NEW) for r in reqs[:MOE_EAGER]]
        out_c = ce.serve(first)
        events_c = events_of(ce.last_report)
        eager = EagerEngine(cfg, params, prefix_cache=True, device=dev, **MOE_SERVE)
        out_e = eager.serve(first)
        check(same_tokens(out_c, out_e) and events_c == events_of(eager.last_report),
              f"(e) {arch}: the captured serve differs from the eager one")
        del eager, ce, graphs
        with torch.inference_mode():
            dense = [eng.generate(torch.from_numpy(p)[None].to(dev), m)[0].cpu().numpy()
                     for p, m in zip(prompts, budgets)]

        def gap_at(r, j):  # the solo run's top-2 gap before token j
            seq = torch.from_numpy(np.concatenate([prompts[r], dense[r][:j]]))[None].to(dev)
            logits, _ = prefill(params, cfg, seq, init_cache(cfg, 1, seq.shape[1], dev))
            return top2_gap(logits[0, -1])
        with torch.inference_mode():
            vs = paged_vs_dense(f"(e) {arch}", out, dense, budgets, gap_at, self.SOLO_BAR)
            # the same decode steps at batch 1 and as row 0 of a batch of 2, the
            # arithmetic the serve's 2 slots and the solo run differ by
            p0, t0 = (torch.from_numpy(a)[None].to(dev) for a in (prompts[0], dense[0]))
            vs["batch_1_vs_2_max_abs_logit_diff"] = (
                forced_logits(eng, p0, t0, budgets[0])
                - forced_logits(eng, p0.repeat(2, 1), t0.repeat(2, 1), budgets[0])[:1]
            ).abs().max().item()
        self.trace = {"reqs": reqs, "dense": dense, "gap_at": gap_at}
        rep["serve"] = {"requests": len(reqs), "rounds": report.rounds,
                        "decode_chunk_iters": iters, "tokens": sum(len(o) for o in out),
                        "cached_tokens": cached,
                        "prefix_hits": report.prefix_hits, "equal_served_alone": len(reqs),
                        "captured_equal_eager": {"requests": MOE_EAGER, "new": MOE_EAGER_NEW},
                        "vs_solo": vs,
                        "launches": {"launches": launches, "counted_as": counted_as}}

    def int8_cache(self, rep, cfg, params, prompt):
        """(f): ``kv_cache_bits=8``: the dense first layer's K/V int8 with f32
        scales, the MoE layers' stack in the parameter dtype, bf16 (the JAX
        package makes it without bits: GQA K/V, or MLA latents), in the
        fixed engine's cache and a paged pool; one captured step
        ``torch.equal`` to its eager twin."""
        dev, cfg8, arch = self.dev, cfg.replace(kv_cache_bits=8), cfg.arch_id
        eng8 = ServingEngine(cfg8, params, max_seq=PROMPT + N_NEW, device=dev)
        kv, _ = captured_vs_eager(eng8, prompt, 2, f"{arch} int8 KV cache, one captured "
                                  "step", **GREEDY)
        pool = init_paged_cache(cfg8, MOE_SERVE["slots"], 32, 3, MOE_SERVE["page_size"], dev)
        dtypes = {where: {key: {n: str(t.dtype).split(".")[-1] for n, t in c[key].items()}
                          for key, _ in lm.cache_stacks(cfg8)}
                  for where, c in (("dense", eng8.state(BATCH).cache), ("paged", pool))}
        moe_leaves = ("c", "kr") if lm.stack_layout(cfg8, "layers") == "latent" else ("k", "v")
        for where, d in dtypes.items():
            check(d["dense_layers"] == {"k": "int8", "v": "int8", "k_scale": "float32",
                                        "v_scale": "float32"}
                  and d["layers"] == dict.fromkeys(moe_leaves, "bfloat16"),
                  f"(f) {arch} int8 KV cache ({where}): {d}")
        rep["int8_kv_cache"] = {"captured_vs_eager": kv, "dtypes": dtypes}

    def speculation_checks(self, rep, cfg, params, prompt):
        """(g): one batch-1 n-gram speculative ``generate`` (MOE_SPEC), its
        first MOE_SPEC_EAGER_NEW tokens captured (launches counted: a
        step's ``pim_matvec`` calls a window) and ``torch.equal`` to
        ``EagerServingEngine``'s; greedy against plain greedy decoding at
        HIT_BAR."""
        dev, arch, per_step = self.dev, cfg.arch_id, matvec_calls_per_step(cfg)
        p1, spec = prompt[:1], SpecConfig(**MOE_SPEC)
        eng = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW, device=dev)
        graphs = count_captures(eng)
        with torch.inference_mode():
            plain = eng.generate(p1, MOE_SPEC_NEW)
            got = eng.generate(p1, MOE_SPEC_NEW, speculate=spec)
            short, launches, counted_as = counted_launches(
                graphs, lambda: eng.generate(p1, MOE_SPEC_EAGER_NEW, speculate=spec))
            windows = eng.spec_stats["verify_steps"]
            eager = EagerServingEngine(cfg, params, max_seq=PROMPT + N_NEW, device=dev)
            want = eager.generate(p1, MOE_SPEC_EAGER_NEW, speculate=spec)
        row = {"case": f"n-gram k={spec.k}, batch 1, greedy", "window_rows": spec.k + 1,
               "spec_stats": dict(eng.spec_stats), "eager_new": MOE_SPEC_EAGER_NEW,
               "tokens_equal_eager": torch.equal(short, want),
               "windows_equal_eager": eng.spec_stats == eager.spec_stats,
               "launches": launches, "launches_counted_as": counted_as,
               "windows_counted": windows}
        check(torch.equal(short, got[:, :MOE_SPEC_EAGER_NEW]) and row["tokens_equal_eager"]
              and row["windows_equal_eager"], f"(g) {arch}: the captured windows differ from "
              f"the eager ones, or from the first of the longer run: {row}")
        expect = dict.fromkeys(launches, 0)
        expect["pim_matvec"] = per_step * windows
        check(launches == expect, f"(g) {arch}: launches {launches}, expected {expect}")
        self.launches[f"{self.NAME} {arch} n-gram windows, batch 1"] = launches
        row["vs_plain_batch_1"] = spec_vs_plain(f"{self.NAME} {arch}", "(g) n-gram", eng, p1,
                                                got, plain)
        rep["speculation"] = row

    def run(self):
        dev, cfg = self.dev, get_config(self.ARCH).replace(n_layers=self.LAYERS)
        gen = torch.Generator(device=dev).manual_seed(SEED + self.SEED_OFFSET)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m, fs, arch = cfg.moe, cfg.moe.n_shared * cfg.moe.d_ff_expert, cfg.arch_id
        rep = {"check": f"{self.NAME}: {arch} at full width, {cfg.n_layers} of "
                        f"{get_config(arch).n_layers} layers, int8 weights",
               "arch": arch, "layers": cfg.n_layers, "dense_layers": cfg.n_dense_layers,
               "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
               "attention_kind": "MLA" if cfg.mla else "GQA",
               "experts": [m.n_experts, m.top_k, m.n_shared, m.d_ff_expert], "d_ff": cfg.d_ff,
               "vocab": cfg.vocab, "section_s": {}}

        t = time.perf_counter()  # (a) the layer and the kernel at the config's shapes
        self.layer_checks(rep, cfg, gen)
        gc.collect()
        torch.cuda.empty_cache()
        self._took(rep, "a", t)

        t = time.perf_counter()
        params = quantized_params(cfg, gen, 8)
        torch.cuda.synchronize()
        rep.update(weights_s=time.perf_counter() - t, int8_bytes=pim_bytes(params),
                   peak_bytes_drawing=torch.cuda.max_memory_allocated())
        print(f"{self.NAME} (weights): {rep['weights_s']:.1f} s, {rep['int8_bytes']} bytes",
              flush=True)
        eng = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW, device=dev)
        prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen, device=dev)
        per_step = matvec_calls_per_step(cfg)
        n_moe = cfg.n_layers - cfg.n_dense_layers
        attn_calls = len(MLA_LINEARS) if cfg.mla else 4
        want_calls = 7 * cfg.n_dense_layers + (attn_calls + len(MOE_SHARED_LINEARS)) * n_moe + 1
        check(per_step == want_calls, f"{arch}: {per_step} pim_matvec calls a step, "
              f"the code makes {want_calls}")
        graphs = count_captures(eng)

        t = time.perf_counter()  # (b) the fixed engine: counted, captured against eager
        laps, lap_t = {}, [t]

        def lap(part):
            torch.cuda.synchronize()
            laps[part], lap_t[0] = time.perf_counter() - lap_t[0], time.perf_counter()
        with torch.inference_mode():
            eng.generate(prompt, 2)  # warm-up: the greedy step's capture
            lap("warm-up and capture")
            toks, launches, counted_as = counted_launches(graphs,
                                                          lambda: eng.generate(prompt, N_NEW))
            lap("counted greedy generate")
            if self.EAGER_TWINS:
                rep["captured_vs_eager"] = [captured_vs_eager(
                    eng, prompt, N_NEW, f"{arch} int8 greedy, {BATCH} x {PROMPT}", toks=toks,
                    **GREEDY)[0]]
                lap("eager greedy twin")
                sampled, stoks = captured_vs_eager(eng, prompt, N_NEW, f"{arch} int8 sampled, "
                                                   f"{BATCH} x {PROMPT}", **SAMPLED)
                rep["captured_vs_eager"].append(sampled)
                lap("sampled generate and eager twin")
            else:
                stoks = eng.generate(prompt, N_NEW, **SAMPLED)
                lap("sampled generate")
        check(not torch.equal(stoks, toks), f"(b) {arch}: sampled tokens equal greedy ones")
        expect = dict.fromkeys(launches, 0)
        expect["pim_matvec"] = per_step * (N_NEW - 1)
        check(launches == expect, f"(b) {arch}: launches {launches}, expected {expect}")
        check(all(g.launches["pim_matvec"] == per_step for g in graphs),
              f"(b) {arch}: captured steps launch {[g.launches for g in graphs]}, expected "
              f"{per_step} pim_matvec each")
        self.launches[f"{self.NAME} {arch} generate"] = launches
        rep["launches"] = {"launches": launches, "per_step": per_step, "counted_as": counted_as}
        with torch.inference_mode():
            med, rounds = step_ms({"captured_ms": (eng, GREEDY),
                                   "captured_sampled_ms": (eng, SAMPLED)},
                                  prompt, MOE_TIME_STEPS + 1, 1)
            layer = lm._layer(params["layers"], 0)["moe"]
            xm = torch.randn((BATCH, 1, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
            moe_ms = _time_ms([functools.partial(moe.moe_apply, layer, xm, m)], 20)
        lap("timing")
        experts = pim_bytes({n: params["layers"]["moe"][n] for n in ("gate", "up", "down")})
        stream = cross_stream_bytes(eng)
        routed_experts = min(m.n_experts, BATCH * m.top_k)
        routed = stream - experts * (1 - routed_experts / m.n_experts)
        rep["step"] = {**med, "stream_bytes": stream,
                       "floor_ms": stream / HBM_BYTES_PER_S * 1e3,
                       "routed_floor_ms": routed / HBM_BYTES_PER_S * 1e3,
                       "moe_apply_ms_a_layer": moe_ms, "moe_apply_ms_a_step": moe_ms * n_moe,
                       "moe_apply_share": moe_ms * n_moe / med["captured_ms"],
                       "rounds": rounds,
                       "timing": f"device ms a captured step at {BATCH} x {PROMPT}, CUDA events "
                                 f"over {MOE_TIME_STEPS} replays; moe_apply of MoE layer 0 at "
                                 f"{BATCH} x 1 alone in a CUDA graph, times {n_moe}; floor: every "
                                 "code and scale at 3.35 TB/s; routed floor: only the "
                                 f"{routed_experts} experts a step can route to, of each MoE "
                                 "layer"}
        rep["step"].update(self.floors_reckoned(cfg, rep["step"]))
        rep["step"]["peak_bytes"] = torch.cuda.max_memory_allocated()
        rep["section_b_s"] = laps
        print(f"{self.NAME} (b): " + json.dumps({"launches": launches, "step": rep["step"],
                                                 "laps": laps}), flush=True)
        self._took(rep, "b", t)

        t = time.perf_counter()  # (e) the continuous engine
        self.serve(rep, cfg, params, eng, gen)
        self._took(rep, "e", t)
        t = time.perf_counter()  # (f) the int8 KV cache
        with torch.inference_mode():
            self.int8_cache(rep, cfg, params, prompt)
        self._took(rep, "f", t)
        gc.collect()  # the counted captures hold each engine in a cycle
        torch.cuda.empty_cache()
        t = time.perf_counter()  # (g) speculation
        self.speculation_checks(rep, cfg, params, prompt)
        gc.collect()
        torch.cuda.empty_cache()
        self._took(rep, "g", t)

        t = time.perf_counter()  # (d) the bf16 kernel path against the overlay path
        ftoks = toks[:, :MOE_CHECK_NEW]
        diff, _, lo = against_overlay(eng, prompt, ftoks, MOE_CHECK_NEW, f"{arch} int8",
                                      tol=self.OVERLAY_TOL, capture=False)
        pl = matvec_plan(cfg.d_ff, cfg.d_model, BATCH, 8, self.sms)
        down = step_calls(cfg).index(("dense_layers", 0, "mlp", "down"))
        down_rows = cfg.d_ff - (pl.cluster - 1) * pl.rows_per_cta  # its last K split
        with decode_linears_through(dropped_call(per_step, down, down_rows)):
            fault = (forced_logits(eng, prompt, ftoks, MOE_CHECK_NEW) - lo).abs().max().item()
        check(fault > self.OVERLAY_TOL, f"(d) {arch}: the dense layer's down, its last "
              f"{down_rows} K rows dropped, moved the logits by {fault:.4g}, within the bar "
              f"{self.OVERLAY_TOL}")
        self._took(rep, "d", t)

        t = time.perf_counter()  # (c) the f32 path, MOE_F32_LAYERS deep, against plain
        cfg32 = cfg.replace(n_layers=MOE_F32_LAYERS, param_dtype="float32")
        eng32 = ServingEngine(cfg32, quantized_params(cfg32, gen, 8), max_seq=PROMPT + N_NEW,
                              device=dev)
        pl = matvec_plan(fs, cfg.d_model, BATCH, 8, self.sms)
        rows = (fs - (pl.cluster - 1) * pl.rows_per_cta if pl.cluster > 1
                else fs - (fs - 1) // pl.chunk_rows * pl.chunk_rows)  # shared down's last K split
        rep["f32_path"] = plain_path_check(eng32, eng, prompt, ftoks, lo,
                                           f"{arch} int8 f32 kernel path vs plain path, "
                                           f"{MOE_F32_LAYERS} layers", rows)
        del eng32, lo
        rep["overlay"] = {"max_abs_logit_diff": diff, "bar": self.OVERLAY_TOL,
                          "planted_fault": f"the dense layer's down: its last {down_rows} K "
                                           "rows dropped",
                          "planted_fault_max_abs_logit_diff": fault,
                          "shared_down_fault_max_abs_logit_diff":
                              rep["f32_path"]["planted_fault_bf16_diff_vs_overlay"],
                          "logit_tol": LOGIT_TOL}
        gc.collect()
        torch.cuda.empty_cache()
        self._took(rep, "c", t)
        rep["peak_bytes"] = torch.cuda.max_memory_allocated()
        check(rep["peak_bytes"] < torch.cuda.get_device_properties(0).total_memory,
              f"{arch}: peak {rep['peak_bytes']} bytes")
        self.trace = None  # its solo-gap closure holds the int8 tree
        del eng, graphs, params
        gc.collect()
        torch.cuda.empty_cache()
        rep["phase_s"] = time.perf_counter() - t0
        print(json.dumps(rep), flush=True)
        return self.launches

    def floors_reckoned(self, cfg, step):
        """Nothing to add for phase 18 (``MlaPhase`` checks its floors)."""
        return {}


# ---- 19. deepseek-v2-lite-16b: MLA, and speculation on the moe family ------------------------
# deepseek-v2-lite-16b at full width and MLA_LAYERS of its 27 layers, int8, on a generator
# of its own (SEED + 13), through MoePhase's (b) to (f) and its own (a) and
# (g).  Its MoE layers attend through MLA: their cache is a latent pool
# (kv_lora 512 + rope 64 a token, bf16 also under kv_cache_bits=8), their
# decode and verify windows the absorbed form.
MLA_ARCH = "deepseek-v2-lite-16b"
# Of its 27 layers (one dense, then MoE): all 27 before phase 20, whose time
# this cut and (b) without its eager twins pay for ((g) holds captured
# against eager on the same model).
MLA_LAYERS = 10
# (a): one f32 MLA layer at full width over BATCH rows: MLA_PREFIX positions
# prefilled into a store of MLA_STORE (MLA_PS-token pages in the pool), then
# a decode step, a linear window of k + 1 = 5 and a tree of fan 2 x depth 2 at
# MLA_PREFIX, each against the expanded prefill's outputs at the same
# positions.  The two forms sum the same products in another order: on the
# CPU at this width they differ by 1.2e-7 at outputs up to 1.5.
MLA_PREFIX, MLA_STORE, MLA_PS = 120, 128, 16
MLA_FORMS_TOL = 1e-5
# (a): the shapes pim_matvec sees on this config beyond the dense linears':
# MLA's wq (2,048 x 3,072) and w_dkv (2,048 x 576), the shared experts
# (2,048 x 2,816 and back), and a routed expert's down (1,408 x 2,048).
MLA_KERNEL_EXTRA = ((2048, 3072), (2048, 576), (2048, 2816), (2816, 2048), (1408, 2048))
# (d): the bf16 kernel path against the overlay path, set as phase 18 sets
# its bar.  On the H100 (PERF.md section 6) the sound paths differed by
# 0.967 at 27 layers, each about 0.65-0.69 from the same int8 model at f32
# ((e)'s batch witness), so two sound bf16 paths may differ by up to ~1.4;
# the dense layer's ``down`` losing its last K split moved them by 4.03.
# A shared expert's ``down`` fault (1.04) lies inside that drift here, and
# (c) catches it at f32.
MLA_OVERLAY_TOL = 2.0
# (e): the bar of a paged request's first divergence from its solo run.  On
# the H100 (PERF.md section 6) every request of the trace first diverged
# at a solo top-2 gap of 0.078-0.22, beyond PAGED_BAR.  The batch witness
# shows why: of a MoE layer's step only the absorbed form's f32 einsums
# change row 0 with the batch (by ~1e-6), a bf16 cast before ``wo`` makes
# that one ulp in a later layer, and 25 layers grow it to 0.18 in the
# logits, so a sound divergence may sit at a gap up to twice that; at f32
# the two batches agree within 4e-6.  Two bf16 arithmetics are held at
# HIT_BAR, as in phase 10.
MLA_SOLO_BAR = HIT_BAR
# (g): speculation.  Every window is at most 6 tokens a row, one dispatch
# group of capacity 6, which drops no (token, expert) pair a one-token step
# keeps; wider windows are held against the JAX package on the CPU.  The
# fixed engine at batch 1 (WindowChecks): n-gram and self-draft windows of
# k = 4, a tree of fan 2 x depth 2; at BATCH rows, n-gram windows of k = 4
# (20 rows: x @ dq(w)); the continuous engine (MOE_SERVE's 2 slots) on
# MOE_TRACE's first MLA_SERVE_REQUESTS under each of MLA_SERVE_SPEC.
MLA_SPEC, MLA_TREE = dict(k=4), dict(k=2, tree_fan=2)
MLA_SPEC_NEW, MLA_SPEC_EAGER_NEW = 10, 6
MLA_PLANT_PS, MLA_PLANT_STEPS = 4, 4
# The bar of the decode steps on from a relocated planted chain against
# plain decoding's: on the H100 (PERF.md section 6) the sound relocation's
# continuation differed by 0.19-0.41, the late relocation's (the planted
# fault) by 1.88-1.91.  A window's rows and a plain step reach the same
# f32 einsums at other widths, as two batches do ((e)'s batch witness), and
# each bf16 run stays ~0.7 from f32, so sound runs differ by well under
# 1.4 and the fault lies beyond that.
MLA_PLANT_BAR = 1.0
MLA_SPEC_REPS, MLA_SPEC_ROUNDS = 2, 1  # window times: a window is one step of ~150 ms
MLA_SERVE_SPEC = {"n-gram": dict(k=4), "self-draft": dict(k=2, mode="draft"),
                  "tree": dict(k=2, tree_fan=2)}
MLA_SERVE_REQUESTS = 2


def widened(tree) -> dict:
    """``tree`` with every bf16 leaf in f32 and every other leaf (int8 codes,
    f32 scales, the f32 router) as it is: the same int8 model at f32."""
    return {k: widened(v) if isinstance(v, dict) else (
        v.float() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 else v)
        for k, v in tree.items()}


def repeated(cfg, cache, b: int) -> dict:
    """A batch-1 dense cache's row repeated to ``b`` rows (the cache itself
    at 1)."""
    return cache if b == 1 else {key: {name: torch.cat([leaf] * b, dim=len(lead))
                                       for name, leaf in cache[key].items()}
                                 for key, lead in lm.cache_stacks(cfg)}


@contextlib.contextmanager
def recorded(module, names, sink):
    """Within the block, each call of ``module``'s functions ``names`` appends
    (name, row 0 of its output (of its first output, for a tuple) in f32)
    to ``sink``."""
    saved = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            sink.append((name, (out[0] if isinstance(out, tuple) else out)[:1].float()))
            return out
        return call
    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


class MlaPhase(WindowChecks, MoePhase):
    """Phase 19: MoePhase's (b) to (f) for MLA_ARCH at MLA_LAYERS layers, with
    (a) the MLA layer's checks and (g) speculation on both engines."""

    NAME, ARCH, LAYERS, SEED_OFFSET = "phase 19", MLA_ARCH, MLA_LAYERS, 13
    OVERLAY_TOL, EAGER_TWINS, SOLO_BAR = MLA_OVERLAY_TOL, False, MLA_SOLO_BAR
    PHASE = "phase 19"
    SPEC, TREE, SPEC_NEW, EAGER_NEW = MLA_SPEC, MLA_TREE, MLA_SPEC_NEW, MLA_SPEC_EAGER_NEW
    PLANT_PS, PLANT_STEPS = MLA_PLANT_PS, MLA_PLANT_STEPS
    REPS, ROUNDS = MLA_SPEC_REPS, MLA_SPEC_ROUNDS
    SECTIONS = dict(ngram="g n-gram", draft="g self-draft", tree="g tree",
                    plant="g planted", times="g times")

    def spec_bar(self, cfg):
        return HIT_BAR

    def plant_bar(self, cfg):
        return MLA_PLANT_BAR

    def serve(self, rep, cfg, params, eng, gen):
        """(e): ``MoePhase.serve``, then ``batch_witness``."""
        super().serve(rep, cfg, params, eng, gen)
        with torch.inference_mode():
            rep["serve"]["batch_witness"] = self.batch_witness(cfg, params, eng)

    def batch_witness(self, cfg, params, eng):
        """(e): why a request's decode steps at batch 1 and as row 0 of a batch
        of 2 part, the arithmetic by which (e)'s 2 slots and its solo runs
        differ (both prefill at batch 1).  Request 0's teacher-forced decode
        steps after its batch-1 prefill (``forced_rows``) at both batches,
        at bf16 and at f32 over the same int8 codes: the f32 pair within
        PATH_TOL (the program computes each row alone), each bf16 run's
        distance from f32 and the overlay path's beside them; the prefill
        and one decode step, each layer part's row 0 at both batches
        (``first_part``); and which operations of a MoE layer's step change
        row 0's bits with the batch on equal inputs (``op_rows``)."""
        dev, arch, tr = self.dev, cfg.arch_id, self.trace
        p0 = torch.from_numpy(tr["reqs"][0].prompt)[None].to(dev)
        t0 = torch.from_numpy(tr["dense"][0])[None].to(dev)
        eng32 = ServingEngine(cfg.replace(param_dtype="float32"), widened(params),
                              max_seq=eng.max_seq, device=dev)
        runs = {(name, b): self.forced_rows(e, p0, t0, b)
                for name, e in (("bf16", eng), ("f32", eng32)) for b in (1, 2)}
        prev = common.set_matvec_dispatch("off")
        try:
            overlay = self.forced_rows(eng, p0, t0, 1)
        finally:
            common.set_matvec_dispatch(prev)

        def dist(a, b):
            return (a - b).abs().max().item()
        out = {"steps": t0.shape[1] - 1,
               "bf16_batch_1_vs_2": dist(runs["bf16", 1], runs["bf16", 2]),
               "f32_batch_1_vs_2": dist(runs["f32", 1], runs["f32", 2]),
               "bf16_batch_1_vs_f32": dist(runs["bf16", 1], runs["f32", 1]),
               "bf16_batch_2_vs_f32": dist(runs["bf16", 2], runs["f32", 2]),
               "overlay_batch_1_vs_f32": dist(overlay, runs["f32", 1]),
               "f32_logit_std": runs["f32", 1].std().item()}
        check(out["f32_batch_1_vs_2"] <= PATH_TOL, f"(e) {arch}: at f32 a request's steps at "
              f"batch 1 and as row 0 of 2 differ by {out['f32_batch_1_vs_2']:.4g} > {PATH_TOL}")
        out["first_part"] = {name: self.first_part(e, p0, t0[:, :1])
                             for name, e in (("bf16", eng), ("f32", eng32))}
        del eng32, runs
        out["op_rows"] = rows = self.op_rows(cfg, params)
        moving = [n for n, r in rows.items() if "pim_matvec" in n and not r["row_0_equal"]]
        check(not moving, f"(e) {arch}: pim_matvec's row 0 changes with the batch in {moving}")
        print(f"{self.NAME} (e) batch witness: {json.dumps(out)}", flush=True)
        return out

    def forced_rows(self, eng, p0, t0, b):
        """Row 0's logits (n - 1, V) f32 of the teacher-forced decode steps of
        ``t0`` (1, n) after ``p0``'s batch-1 prefill, its cache repeated to
        ``b`` rows."""
        cfg, s = eng.cfg, p0.shape[1]
        cache = init_cache(cfg, 1, eng.max_seq, self.dev)
        prefill(eng.params, cfg, p0, cache)
        cache = repeated(cfg, cache, b)
        out = []
        for i in range(t0.shape[1] - 1):
            logits, _ = decode_step(eng.params, cfg, t0[:, i:i + 1].repeat(b, 1), cache, s + i)
            out.append(logits[0, -1].float())
        return torch.stack(out)

    def first_part(self, eng, p0, tok):
        """``p0``'s prefill, then one decode step of ``tok`` from equal caches
        (row 0's prefill, repeated), each at batch 1 and as row 0 of 2: the
        first layer part (attention or feed-forward, layer 0 the dense one)
        whose row 0 differs, how many parts differ, and the last part's and
        the logits' distance."""
        cfg, s = eng.cfg, p0.shape[1]
        cache = init_cache(cfg, 1, eng.max_seq, self.dev)
        caches = {1: cache, 2: init_cache(cfg, 2, eng.max_seq, self.dev)}

        def parted(run, names):
            sinks, logits = {1: [], 2: []}, {}
            for b in (1, 2):
                with recorded(blocks, names, sinks[b]):
                    logits[b] = run(b)[0][:1, -1].float()
            parts = [(i // 2, "attention" if name.startswith("self_attn") else "feed-forward",
                      (x - y).abs().max().item())
                     for i, ((name, x), (_, y)) in enumerate(zip(sinks[1], sinks[2]))]
            apart = [p for p in parts if p[2] > 0]
            return {"parts": len(parts), "parts_differing": len(apart),
                    "first_differing": (dict(zip(("layer", "part", "max_abs"), apart[0]))
                                        if apart else None),
                    "last_part_max_abs": parts[-1][2],
                    "logits_max_abs": (logits[1] - logits[2]).abs().max().item()}
        out = {"prefill": parted(lambda b: prefill(eng.params, cfg, p0.repeat(b, 1), caches[b]),
                                 ("self_attn_prefill", "_ffn"))}
        caches[2] = repeated(cfg, cache, 2)
        out["decode"] = parted(lambda b: decode_step(eng.params, cfg, tok.repeat(b, 1), caches[b],
                                                     s), ("self_attn_decode", "_ffn"))
        return out

    def op_rows(self, cfg, params):
        """The operations of the first MoE layer's decode step and the head,
        each on a random batch of 2 in the dtype the step gives it (drawn
        from a generator of its own), row 0 against the same operation on
        row 0 alone: bit for bit or not, and by how much."""
        bf, f32 = torch.bfloat16, torch.float32
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        lay = lm._layer(params["layers"], 0)
        a, mo, m = lay["attn"], lay["moe"], cfg.mla
        h, e, d = cfg.n_heads, cfg.moe.n_experts, cfg.d_model
        cap = moe._capacity(1, cfg.moe)  # a one-token row's dispatch group

        def rnd(*shape, dt=bf):
            return torch.randn(shape, generator=gen, device=self.dev).to(dt)

        def experts(x):  # x (B, E, cap, D): each row's buffers, as moe_apply lays them
            b = x.shape[0]
            y = moe._experts(mo, x.transpose(0, 1).reshape(e, b * cap, d))
            return y.reshape(e, b, cap, d).transpose(0, 1)
        ops = {
            "wq pim_matvec": (lambda x: common.linear(x, a["wq"]), rnd(2, 1, d)),
            "w_dkv pim_matvec": (lambda x: common.linear(x, a["w_dkv"]), rnd(2, 1, d)),
            "W_uk into q, bf16 einsum": (
                lambda q: torch.einsum("bqhd,hcd->bqhc", q, common.dq(a["w_uk"], bf)),
                rnd(2, 1, h, m.qk_nope_dim)),
            "W_uv out of o_lat, f32 einsum": (
                lambda o: torch.einsum("bqhc,hcd->bqhd", o, common.dq(a["w_uv"], f32)),
                rnd(2, 1, h, m.kv_lora_rank, dt=f32)),
            "wo pim_matvec": (lambda x: common.linear(x, a["wo"]), rnd(2, 1, h * m.v_head_dim)),
            "routed experts, bf16 bmm": (experts, rnd(2, e, cap, d)),
            "shared experts pim_matvec": (lambda x: common.mlp_apply(mo["shared"], x),
                                          rnd(2, 1, d)),
            "moe_apply": (lambda x: moe.moe_apply(mo, x, cfg.moe)[0], rnd(2, 1, d)),
            "head pim_matvec": (lambda x: common.linear(x, params["head"]), rnd(2, 1, d))}
        out = {}
        for name, (fn, x) in ops.items():
            y1, y2 = fn(x[:1]).float(), fn(x)[:1].float()
            out[name] = {"row_0_equal": torch.equal(y1, y2),
                         "max_abs": (y1 - y2).abs().max().item(),
                         "max_abs_output": y1.abs().max().item()}
        return out

    def mla_layer(self, cfg, gen):
        """(a): the absorbed decode and verify windows against the expanded
        prefill on one f32 MLA layer at full width, within MLA_FORMS_TOL; the
        paged pool under a permuted block table against the dense store,
        outputs and latents bit for bit."""
        dev, m, b, s0 = self.dev, cfg.mla, BATCH, MLA_PREFIX
        kw = dict(n_heads=cfg.n_heads, m=m, rope_theta=cfg.rope_theta)
        f32 = torch.float32
        p = mla.mla_init(gen, cfg.d_model, cfg.n_heads, m, f32, dev)
        fan, depth = MLA_TREE["tree_fan"], MLA_TREE["k"]
        k = MLA_SPEC["k"]
        x = torch.randn((b, s0 + k + 1, cfg.d_model), generator=gen, device=dev)
        other = torch.randn((b, depth, cfg.d_model), generator=gen, device=dev)
        out = {"rows": b, "prefix": s0, "store": MLA_STORE, "tol": MLA_FORMS_TOL}
        with torch.inference_mode():
            def expanded(seq):
                return mla.mla_prefill(p, seq, mla.mla_cache_init(b, seq.shape[1], m, f32, dev),
                                       **kw)[0]
            y = expanded(x)
            y1 = expanded(torch.cat([x[:, :s0 + 1], other], dim=1))  # chain 1's path
            pos, posv = torch.tensor(s0, device=dev), torch.full((b,), s0, device=dev)
            window = torch.cat([x[:, s0:s0 + 1 + depth], other], dim=1)  # root, chain 0, chain 1
            want = {"decode": y[:, s0:s0 + 1], "verify": y[:, s0:],
                    "tree": torch.cat([y[:, s0:s0 + 1 + depth], y1[:, s0 + 1:]], dim=1)}
            width = MLA_STORE // MLA_PS
            bt = (torch.randperm(b * width, generator=torch.Generator().manual_seed(SEED + 19))
                  + 1).reshape(b, width).to(dev)
            got, stores = {}, {}
            for layout in ("dense", "paged"):
                for case in want:
                    dense = mla.mla_cache_init(b, MLA_STORE, m, f32, dev)
                    mla.mla_prefill(p, x[:, :s0], dense, **kw)
                    if layout == "dense":
                        cache = dense
                    else:
                        cache = mla.mla_cache_init(b * width + 1, MLA_PS, m, f32, dev)
                        for r in range(b):
                            mla.mla_paged_insert(cache, {n: v[r:r + 1] for n, v in dense.items()},
                                                 bt[r])
                    paged = dict(block_tables=bt, page_size=MLA_PS) if layout == "paged" else {}
                    if case == "decode" and layout == "dense":
                        o, _ = mla.mla_decode(p, x[:, s0:s0 + 1], cache, pos, **kw)
                    elif case == "decode":
                        o, _ = mla.mla_decode_paged(p, x[:, s0:s0 + 1], cache, bt, posv,
                                                    page_size=MLA_PS, **kw)
                    elif case == "verify":
                        o, _ = mla.mla_verify(p, x[:, s0:], cache, posv, **paged, **kw)
                    else:
                        o, _ = mla.mla_verify(p, window, cache, posv, tree=(fan, depth),
                                              **paged, **kw)
                    got[layout, case] = o
                    stores[layout, case] = {n: (v if layout == "dense" else v[bt].reshape(
                        b, MLA_STORE, -1)) for n, v in cache.items()}
            torch.cuda.synchronize()
        for case, ref in want.items():
            err = (got["dense", case] - ref).abs().max().item()
            ok = bool(torch.isfinite(got["dense", case]).all()) and err <= MLA_FORMS_TOL
            same = (torch.equal(got["dense", case], got["paged", case])
                    and all(torch.equal(stores["dense", case][n], stores["paged", case][n])
                            for n in ("c", "kr")))
            out[case] = {"absorbed_vs_expanded_max_abs_err": err, "paged_equal_dense": same}
            check(ok and same, f"(a) {MLA_ARCH} MLA {case}: {out[case]}")
        out["max_abs_output"] = y.abs().max().item()
        return out

    def layer_checks(self, rep, cfg, gen):
        """(a): the MLA layer (``mla_layer``), and ``pim_matvec`` at the
        config's shapes (MLA_KERNEL_EXTRA beside the dense layer's)."""
        rep["mla_layer"] = self.mla_layer(cfg, gen)
        pl = matvec_plan(cfg.d_model, cfg.vocab, BATCH, 8, self.sms)
        rep["kernel_vs_plain"], _ = family_kernel_cases(
            cfg, gen, extra=MLA_KERNEL_EXTRA, chunk_fault=pl.chunk_rows < pl.rows_per_cta)

    def floors_reckoned(self, cfg, step):
        """(b): the step's floors reckoned from the config's widths (every
        int8 code, no scales, at 3.35 TB/s), which the measured stream's
        must match within 2% (scales, norms and the f32 router add under
        1%); and the step no faster than its floor."""
        m, d = cfg.mla, cfg.d_model
        e, n_moe = cfg.moe, cfg.n_layers - cfg.n_dense_layers
        qh = m.qk_nope_dim + m.qk_rope_dim
        mla_codes = (d * cfg.n_heads * qh + d * (m.kv_lora_rank + m.qk_rope_dim)
                     + cfg.n_heads * m.kv_lora_rank * (m.qk_nope_dim + m.v_head_dim)
                     + cfg.n_heads * m.v_head_dim * d)
        expert = 3 * d * e.d_ff_expert
        dense = 4 * d * cfg.q_dim + 3 * d * cfg.d_ff
        codes = (cfg.n_dense_layers * dense + n_moe * (mla_codes + (e.n_experts + e.n_shared)
                                                       * expert) + d * cfg.vocab)
        routed = codes - n_moe * expert * (e.n_experts - min(e.n_experts, BATCH * e.top_k))
        out = {"codes_reckoned": codes, "floor_reckoned_ms": codes / HBM_BYTES_PER_S * 1e3,
               "routed_floor_reckoned_ms": routed / HBM_BYTES_PER_S * 1e3}
        check(abs(step["floor_ms"] / out["floor_reckoned_ms"] - 1) < 0.02
              and abs(step["routed_floor_ms"] / out["routed_floor_reckoned_ms"] - 1) < 0.02,
              f"(b) {cfg.arch_id}: floors {step['floor_ms']:.4g} / {step['routed_floor_ms']:.4g} "
              f"ms, reckoned {out}")
        check(step["captured_ms"] > step["floor_ms"], f"(b) {cfg.arch_id}: a step of "
              f"{step['captured_ms']:.4g} ms beats its floor of {step['floor_ms']:.4g} ms")
        return out

    def speculation_checks(self, rep, cfg, params, prompt):
        """(g): ``WindowChecks.speculation`` at batch 1; n-gram windows at
        BATCH rows (``batch_windows``); the continuous engine
        (``spec_serves``)."""
        self.speculation(rep, cfg, params, prompt[:1], None)
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        self.batch_windows(rep, cfg, params, prompt)
        self._took(rep, "g batch", t)
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        self.spec_serves(rep, cfg, params)
        self._took(rep, "g serves", t)

    @torch.inference_mode()
    def batch_windows(self, rep, cfg, params, prompt):
        """(g): n-gram windows of k = 4 at BATCH rows (20-row windows through
        ``x @ dq(w)``, each row one dispatch group), greedy, the first
        MLA_SPEC_EAGER_NEW tokens captured (no ``pim_matvec`` launch) and
        ``torch.equal`` to eager; against plain greedy decoding at
        HIT_BAR.  (Sampled windows run at batch 1.)"""
        dev, arch, n = self.dev, cfg.arch_id, MLA_SPEC_NEW
        spec = SpecConfig(**MLA_SPEC)
        eng = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW, device=dev)
        eager = EagerServingEngine(cfg, params, max_seq=PROMPT + N_NEW, device=dev)
        graphs = count_captures(eng)
        plain = eng.generate(prompt, n)
        out = {"rows": BATCH, "window_rows": BATCH * (spec.k + 1), "cases": []}
        for label, mode in (("greedy", GREEDY),):
            got = eng.generate(prompt, n, speculate=spec, **mode)
            row = {"case": f"n-gram k={spec.k}, {label}", "spec_stats": dict(eng.spec_stats)}
            m = MLA_SPEC_EAGER_NEW
            short, launches, counted_as = counted_launches(
                graphs, lambda: eng.generate(prompt, m, speculate=spec, **mode))
            want = eager.generate(prompt, m, speculate=spec, **mode)
            row.update(tokens_equal_eager=torch.equal(short, want), launches=launches,
                       launches_counted_as=counted_as)
            check(torch.equal(short, got[:, :m]) and row["tokens_equal_eager"],
                  f"(g batch) {arch} {label}: the captured windows differ from the eager ones "
                  f"or from the first of the longer run")
            check(launches == dict.fromkeys(launches, 0), f"(g batch) {arch} {label}: "
                  f"{BATCH * (spec.k + 1)}-row windows launched {launches}")
            if mode["greedy"]:
                row["vs_plain"] = spec_vs_plain(f"{self.NAME} {arch}", "(g batch) n-gram", eng,
                                                prompt, got, plain)
            out["cases"].append(row)
        rep["batch_windows"] = out

    def spec_serves(self, rep, cfg, params):
        """(g): the continuous engine (MOE_SERVE: 2 slots; n-gram and tree
        windows of 2 x 5 rows through ``x @ dq(w)``, the self-draft's 2 x 3
        and its steps of 2 rows through ``pim_matvec``) on (e)'s first
        MLA_SERVE_REQUESTS requests under each of MLA_SERVE_SPEC, greedy:
        captured ``torch.equal`` to ``EagerEngine``, the launches counted,
        each request against its solo run (``self.trace``) at HIT_BAR."""
        dev, arch, tr = self.dev, cfg.arch_id, self.trace
        per_step = matvec_calls_per_step(cfg)
        reqs = tr["reqs"][:MLA_SERVE_REQUESTS]
        out = {"requests": len(reqs), "bar": HIT_BAR}
        for name, sp in MLA_SERVE_SPEC.items():
            spec = SpecConfig(**sp)
            geo = dict(speculate=spec, device=dev, draft_cfg=cfg, draft_params=params,
                       **MOE_SERVE)
            eng = ContinuousBatchingEngine(cfg, params, **geo)
            graphs = count_captures(eng)
            eng.serve(reqs)  # captures its admits and window
            got, launches, counted_as = counted_launches(graphs, lambda: eng.serve(reqs))
            iters, events = eng.decode_chunk_iters, events_of(eng.last_report)
            eager = EagerEngine(cfg, params, **geo)
            want = eager.serve(reqs)
            row = {"window_rows": MOE_SERVE["slots"] * (1 + spec.k * max(spec.tree_fan, 1)),
                   "iterations": iters, "emitted": eng.spec_emitted,
                   "live_windows": eng.spec_live_steps,
                   "tokens_equal_eager": same_tokens(got, want),
                   "events_equal_eager": events == events_of(eager.last_report),
                   "launches": launches, "launches_counted_as": counted_as}
            check(row["tokens_equal_eager"] and row["events_equal_eager"],
                  f"(g serves) {arch} {name}: the captured serve differs from the eager one")
            # each admit unembeds its last position through the untied head; an
            # iteration makes a step's calls for each of a draft's k + 1 steps of
            # 2 rows, and for the window where it is at most 8 rows
            calls = (spec.k + 1 if spec.mode == "draft" else 0) + (
                row["window_rows"] <= common.MATVEC_MAX_M)
            expect = dict.fromkeys(launches, 0)
            expect["pim_matvec"] = per_step * calls * iters + len(reqs)
            check(launches == expect, f"(g serves) {arch} {name}: launches {launches}, "
                  f"expected {expect}")
            self.launches[f"{self.NAME} {arch} {name} serve"] = launches
            with torch.inference_mode():
                row["vs_solo"] = paged_vs_dense(
                    f"(g serves) {arch} {name}", got, tr["dense"][:len(reqs)],
                    [r.max_new for r in reqs], tr["gap_at"], HIT_BAR)
            out[name] = row
            del eng, eager, graphs
            gc.collect()
            torch.cuda.empty_cache()
        rep["spec_serves"] = out


# ---- 20. falcon-mamba-7b: the ssm family, and speculation on it ------------------------------
# falcon-mamba-7b at full width and all 64 layers (d 4,096, d_in 8,192, state
# 16, conv 4, dt_rank 256, vocab 65,024, untied head, no attention), int8,
# drawn and quantized one (K, N) slice at a time from a generator of its own
# (SEED + 14; the int4 self-draft is the same draw at int4), its inputs from
# another (SEED + 15).  A layer's decode state is per row: h (d_in, N) and the
# conv tail (K - 1, d_in), both f32.
SSM_ARCH = "falcon-mamba-7b"
# (a): one f32 Mamba1 layer at full width over BATCH rows: a prefill of PROMPT
# tokens, and a right-padded prompt of SSM_PRIME (prime) real tokens in
# SSM_PADDED positions (two chunks of 256, the second padded), each against as
# many ``mamba1_decode`` steps over the same tokens from a zero state.  The
# prefill runs the recurrence in decode's association, so only the
# projections' f32 sums (a matmul of PROMPT x BATCH rows against one of
# BATCH) differ: within KERNEL_TOL.
SSM_PRIME, SSM_PADDED = 293, 300
# (a): pim_matvec's shapes on this config beside the head: in_proj, x_proj,
# dt_proj (K = dt_rank 256, the smallest K on a main path yet) and out_proj.
SSM_KERNEL_EXTRA = ((4096, 16384), (8192, 288), (256, 8192), (8192, 4096))
SSM_F32_LAYERS = 4  # (c)
SSM_CHECK_NEW = 8  # (c), (d): the first tokens of (b)'s greedy generation, teacher-forced
SSM_TIME_STEPS = 8  # (b): captured replays timed, greedy and sampled
# (d): the bar of the bf16 kernel path's distance from the overlay path, set
# as phases 18 and 19 set theirs.  On the H100 (PERF.md section 6) the sound
# paths differed by 0.479 at 64 layers, LOGIT_TOL's reach doubled; layer 0's
# out_proj losing its last K split (1,024 of 8,192 rows) moved them by 7.23,
# layer 32's by 0.672.  The witness (``SsmPhase.witness``) shows each bf16
# run drifting from the same int8 model at f32, so two sound bf16 paths may
# differ by about the sum of the two drifts: the bar is a constant, about
# twice the sound distance, which layer 0's fault must pass.  Layer 32's
# fault lies inside the drift, and (c) catches it at f32.
SSM_OVERLAY_TOL = 1.0
# (e): five requests over two slots of 16-token pages, no prompt a whole
# number of pages, so every admit masks pads out of its state row; request
# SSM_REPEAT repeats request 0's prompt, which the prefix cache must not hit
# on this family.  Its eager twin runs the first SSM_EAGER requests (more
# than the slots: an admit into a freed slot) at SSM_EAGER_NEW new.
SSM_SERVE = dict(slots=2, page_size=16, chunk=4, max_seq=160, page_alloc_seed=SEED)
SSM_TRACE = ((100, 6), (37, 5), (121, 4), (61, 5), (100, 4))
SSM_REPEAT = 4
SSM_EAGER, SSM_EAGER_NEW = 3, 4
# (e): the bar of a paged request's first divergence from its solo run.  On
# the H100 (PERF.md section 6) the 100-token prompt (requests 0 and 4)
# first diverged at token 0, at a solo top-2 gap of 0.094: its admit
# prefills 112 positions, the solo run 100, and the witness shows the two
# prefills' first-token logits apart at bf16 and within PATH_TOL at f32
# over the same codes (the pads masked out of the state exactly), so two
# bf16 arithmetics are held at HIT_BAR, as in phases 10 and 19.
SSM_SOLO_BAR = HIT_BAR
# (f): speculation, every window at most 8 rows (pim_matvec, as the plain
# step): at batch 1 n-gram windows of k = 4 (5 rows), the int4 tree as the
# int8 tree's draft (k = 4: five one-row draft steps and a 5-row window), a
# tree of fan 2 x depth 3 (two chains of 4, 8 rows); at BATCH rows n-gram
# windows of k = 1 (8 rows); on the continuous engine's 2 slots each of
# SSM_SERVE_SPEC (8, 6 and 8 rows) over (e)'s first SSM_SERVE_REQUESTS.
SSM_SPEC, SSM_DRAFT, SSM_TREE = dict(k=4), dict(k=4, mode="draft"), dict(k=3, tree_fan=2)
SSM_BATCH_SPEC = dict(k=1)
SSM_SERVE_SPEC = {"n-gram": dict(k=3), "int4 self-draft": dict(k=2, mode="draft"),
                  "tree": dict(k=1, tree_fan=2)}
SSM_SERVE_REQUESTS = 2
SSM_SPEC_NEW, SSM_SPEC_EAGER_NEW = 16, 6
SSM_SPEC_REPS, SSM_SPEC_ROUNDS = 4, 1  # window times
# (f): planted windows whose accepted tokens are plain greedy decoding's: the
# state ``commit_verify`` writes against the state of decoding the accepted
# tokens, relative to the state's largest value, at bf16 over all the
# layers and at f32 over (c)'s SSM_F32_LAYERS; a commit one step late must
# be farther than SSM_COMMIT_TOL.
SSM_COMMIT_TOL = 1e-4


def rel_dist(a: dict, b: dict) -> float:
    """The largest |a - b| over every leaf, each over its largest |b|."""
    return max(((a[k].float() - b[k].float()).abs().max()
                / b[k].float().abs().max().clamp_min(1e-30)).item() for k in b)


class SsmPhase(WindowChecks):
    """Phase 20: falcon-mamba-7b at full width and depth, (a) to (f) of the
    module's docstring."""

    NAME = PHASE = "phase 20"
    REPS, ROUNDS = SSM_SPEC_REPS, SSM_SPEC_ROUNDS

    def __init__(self, dev):
        self.dev, self.launches = dev, {}
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count

    def _took(self, rep, section, t0):
        rep["section_s"][section] = time.perf_counter() - t0
        print(f"{self.NAME} ({section}): {rep['section_s'][section]:.1f} s", flush=True)

    @staticmethod
    def window_rows(sp):
        """A batch-1 window's rows: a tree's chains each run as a window of
        1 + depth rows from a copy of the row's state."""
        return sp.tree_fan * (1 + sp.k) if sp.tree_fan else 1 + sp.k

    # ------------------------------------------------------------------ (a) --
    @torch.inference_mode()
    def ssm_layer(self, cfg, gen):
        """(a): one f32 Mamba1 layer at full width: the chunked prefill against
        the step-by-step decode over the same tokens (PROMPT tokens, and
        SSM_PRIME real tokens padded to SSM_PADDED under ``length``), outputs
        and state within KERNEL_TOL; ``mamba1_verify``'s per-step states, a
        linear window of k + 1 and a tree of fan 2 x depth 3 run as chains
        (``lm._tree_to_chains``, node order back), against as many decode
        steps along each path: bit for bit, or the largest difference,
        within KERNEL_TOL."""
        dev, s, b, d = self.dev, cfg.ssm, BATCH, cfg.d_model
        d_in, f32 = s.expand * d, torch.float32
        p = mamba.mamba1_init(gen, d, s, f32, dev)

        def zero(n=b):
            return mamba.mamba1_cache_init(n, d_in, s, dev)

        def decoded(x, state, keep=False):
            """x (B, n, D) through n decode steps from a copy of ``state``:
            outputs (B, n, D), and the final state (every step's, stacked
            on axis 1, with ``keep``)."""
            st, ys, steps = {k: v.clone() for k, v in state.items()}, [], []
            for j in range(x.shape[1]):
                y, _ = mamba.mamba1_decode(p, x[:, j:j + 1], st, s)
                ys.append(y)
                if keep:
                    steps.append({k: v.clone() for k, v in st.items()})
            if keep:
                st = {k: torch.stack([t[k] for t in steps], dim=1) for k in st}
            return torch.cat(ys, dim=1), st

        def compare(label, got_y, got, want_y, want):
            errs = {"y": within_tol(got_y, want_y), **{k: within_tol(got[k], want[k])
                                                       for k in want}}
            row = {"bit_equal": torch.equal(got_y, want_y)
                   and all(torch.equal(got[k], want[k]) for k in want),
                   "max_abs_err": {k: e for k, (_, e) in errs.items()},
                   "max_abs_state": {k: want[k].abs().max().item() for k in want}}
            check(all(ok for ok, _ in errs.values()), f"(a) {SSM_ARCH} {label}: {row}")
            return row

        out = {"rows": b, "tol": KERNEL_TOL}
        x = torch.randn((b, SSM_PADDED, d), generator=gen, device=dev)
        y, st = mamba.mamba1_prefill(p, x[:, :PROMPT], zero(), s)
        out[f"prefill {b} x {PROMPT}"] = compare("prefill", y, st, *decoded(x[:, :PROMPT], zero()))
        base = {k: v.clone() for k, v in st.items()}
        y, st = mamba.mamba1_prefill(p, x, zero(), s, length=torch.tensor(SSM_PRIME, device=dev))
        yd, sd = decoded(x[:, :SSM_PRIME], zero())
        out[f"prefill {b} x {SSM_PADDED}, length {SSM_PRIME}"] = compare(
            "prefill under length", y[:, :SSM_PRIME], st, yd, sd)
        k = SSM_SPEC["k"]
        win = x[:, PROMPT:PROMPT + k + 1]
        before = {n: v.clone() for n, v in base.items()}
        y, steps = mamba.mamba1_verify(p, win, base, s)
        check(all(torch.equal(base[n], before[n]) for n in base), "(a) the window wrote the state")
        out[f"verify k={k}"] = compare("verify", y, steps, *decoded(win, base, keep=True))
        fan, depth = SSM_TREE["tree_fan"], SSM_TREE["k"]
        other = torch.randn((b, depth, d), generator=gen, device=dev)
        tree = torch.cat([x[:, PROMPT:PROMPT + 1 + depth], other], dim=1)  # root, chain 0, chain 1
        tiled = {n: v.repeat_interleave(fan, dim=0) for n, v in base.items()}
        yc, sc = mamba.mamba1_verify(p, lm._tree_to_chains(tree, fan, depth), tiled, s)
        y, steps = (lm._chains_to_tree(yc, fan, depth),
                    {n: lm._chains_to_tree(v, fan, depth) for n, v in sc.items()})
        y0, s0 = decoded(tree[:, :1 + depth], base, keep=True)
        y1, s1 = decoded(torch.cat([tree[:, :1], other], dim=1), base, keep=True)
        out[f"tree fan {fan} x depth {depth}"] = compare(
            "tree", y, steps, torch.cat([y0, y1[:, 1:]], dim=1),
            {n: torch.cat([s0[n], s1[n][:, 1:]], dim=1) for n in s0})
        torch.cuda.synchronize()
        print(f"{self.NAME} (a) layer: {json.dumps(out)}", flush=True)
        return out

    # ------------------------------------------------------------------ (b) --
    def floors_reckoned(self, cfg, step, rows):
        """(b): the weight stream reckoned from the config's widths (every int8
        code), which the measured stream must match within 2% (scales,
        norms, the conv and the dynamics add under 1%); the per-row state,
        read and written once a step; and the step no faster than its
        floor."""
        s, d, n_l = cfg.ssm, cfg.d_model, cfg.n_layers
        d_in, dt_rank = s.expand * d, s.dt_rank or d // 16
        codes = n_l * (d * 2 * d_in + d_in * (dt_rank + 2 * s.state_dim) + dt_rank * d_in
                       + d_in * d) + d * cfg.vocab
        state = n_l * rows * (d_in * s.state_dim + (s.conv_dim - 1) * d_in) * 4
        out = {"codes_reckoned": codes, "floor_reckoned_ms": codes / HBM_BYTES_PER_S * 1e3,
               "state_bytes": state, "state_ms": 2 * state / HBM_BYTES_PER_S * 1e3}
        check(abs(step["floor_ms"] / out["floor_reckoned_ms"] - 1) < 0.02,
              f"(b) {cfg.arch_id}: floor {step['floor_ms']:.4g} ms, reckoned {out}")
        check(step["captured_ms"] > step["floor_ms"], f"(b) {cfg.arch_id}: a step of "
              f"{step['captured_ms']:.4g} ms beats its floor of {step['floor_ms']:.4g} ms")
        return out

    @torch.inference_mode()
    def witness(self, cfg, params, eng, prompt, ftoks, lo):
        """(d), (e): why two sound bf16 paths part.  The same int8 codes with
        every bf16 leaf in f32 (``widened``): (d)'s teacher-forced logits of
        the kernel path and of the overlay path (``lo``) each against the
        f32 model's; and (e)'s request 0, its admit (the prompt padded to
        whole pages, ``length`` masking the pads) against a prefill of the
        prompt alone, the first token's logits and the state, at bf16 and
        at f32, the f32 pair within PATH_TOL."""
        dev, arch = self.dev, cfg.arch_id
        cfg32, p32 = cfg.replace(param_dtype="float32"), widened(params)
        eng32 = ServingEngine(cfg32, p32, max_seq=eng.max_seq, device=dev)
        lk = forced_logits(eng, prompt, ftoks, SSM_CHECK_NEW)
        lf = forced_logits(eng32, prompt, ftoks, SSM_CHECK_NEW)
        del eng32

        def dist(a, b):
            return (a - b).abs().max().item()
        out = {"kernel_vs_f32": dist(lk, lf), "overlay_vs_f32": dist(lo, lf),
               "kernel_vs_overlay": dist(lk, lo)}
        p0 = self.trace["reqs"][0].prompt
        n, ps = len(p0), SSM_SERVE["page_size"]
        spad = -(-n // ps) * ps
        padded = torch.zeros((1, spad), dtype=torch.int32, device=dev)
        padded[0, :n] = torch.from_numpy(p0).to(dev)
        for name, (c, p) in (("bf16", (cfg, params)), ("f32", (cfg32, p32))):
            ca, cb = init_cache(c, 1, spad, dev), init_cache(c, 1, spad, dev)
            la, _ = prefill(p, c, padded, ca, length=n)
            lb, _ = prefill(p, c, padded[:, :n], cb)
            out[f"admit_vs_unpadded_{name}"] = {
                "positions": [spad, n],
                "first_token_logits_max_abs": dist(la[0, n - 1].float(), lb[0, -1].float()),
                "state_rel_dist": rel_dist(ca["layers"], cb["layers"])}
        f32 = out["admit_vs_unpadded_f32"]["first_token_logits_max_abs"]
        check(f32 <= PATH_TOL, f"(e) {arch}: at f32 the padded admit's first logits are "
              f"{f32:.4g} from the unpadded prefill's, > {PATH_TOL}")
        print(f"{self.NAME} witness: {json.dumps(out)}", flush=True)
        return out

    def plans(self, eng, prompt, toks):
        """(b): each distinct ``pim_matvec`` call of a decode step and the
        kernel's plan for it (``step_routes``)."""
        with torch.inference_mode():
            routes = step_routes(eng, prompt, toks, self.sms)
        seen = {}
        for r in routes:
            seen.setdefault((r["rows"], r["N"], r["M"], r["x"]), {**r, "calls": 0})["calls"] += 1
        return list(seen.values())

    # ------------------------------------------------------------------ (e) --
    def serve(self, rep, cfg, params, eng, gen):
        """(e): SSM_TRACE on the continuous engine with ``prefix_cache=True``:
        each request served alone first (its graphs captured), then the
        trace counted (a step's calls an iteration and each admit's one-row
        head); each request's tokens ``torch.equal`` to its own served
        alone; no prefix hit; captured == ``EagerEngine`` on the first
        SSM_EAGER requests (admits, chunk steps and an admit into a freed
        slot); each request against its solo ``generate`` at SSM_SOLO_BAR.
        Keeps the trace, the solo runs and their gaps for (f)."""
        dev, per_step, arch = self.dev, matvec_calls_per_step(cfg), cfg.arch_id
        ps = SSM_SERVE["page_size"]
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen, device=dev).cpu().numpy()
                   .astype(np.int32) for n, _ in SSM_TRACE]
        prompts[SSM_REPEAT] = prompts[0]
        check(all(len(p) % ps for p in prompts), f"(e) a prompt of {ps}-token pages")
        budgets = [m for _, m in SSM_TRACE]
        reqs = [Request(prompt=p, max_new=m) for p, m in zip(prompts, budgets)]
        ce = ContinuousBatchingEngine(cfg, params, prefix_cache=True, device=dev, **SSM_SERVE)
        graphs = count_captures(ce)
        alone = [ce.serve([r])[0] for r in reqs]
        out, launches, counted_as = counted_launches(graphs, lambda: ce.serve(reqs))
        report, iters = ce.last_report, ce.decode_chunk_iters
        cached = [e["cached_tokens"] for rec in report.records for e in rec.events
                  if e["name"] == "admit"]
        check(report.prefix_hits == 0 and not any(cached),
              f"(e) {arch}: the prefix cache hit on ssm: {cached}")
        expect = dict.fromkeys(launches, 0)
        expect["pim_matvec"] = per_step * iters + len(reqs)
        check(launches == expect, f"(e) {arch} serve: launches {launches}, expected {expect}")
        self.launches[f"{self.NAME} {arch} serve"] = launches
        apart = [r for r in range(len(reqs)) if not np.array_equal(alone[r], out[r])]
        check(not apart, f"(e) {arch}: requests {apart} differ from themselves served alone")
        first = [Request(prompt=r.prompt, max_new=SSM_EAGER_NEW) for r in reqs[:SSM_EAGER]]
        out_c = ce.serve(first)
        events_c = events_of(ce.last_report)
        eager = EagerEngine(cfg, params, prefix_cache=True, device=dev, **SSM_SERVE)
        out_e = eager.serve(first)
        check(same_tokens(out_c, out_e) and events_c == events_of(eager.last_report),
              f"(e) {arch}: the captured serve differs from the eager one")
        graphs_kept = capture_report(ce, graphs)
        del eager, ce, graphs
        with torch.inference_mode():
            dense = [eng.generate(torch.from_numpy(p)[None].to(dev), m)[0].cpu().numpy()
                     for p, m in zip(prompts, budgets)]

        def gap_at(r, j):  # the solo run's top-2 gap before token j
            seq = torch.from_numpy(np.concatenate([prompts[r], dense[r][:j]]))[None].to(dev)
            logits, _ = prefill(params, cfg, seq, init_cache(cfg, 1, seq.shape[1], dev))
            return top2_gap(logits[0, -1])
        with torch.inference_mode():
            vs = paged_vs_dense(f"(e) {arch}", out, dense, budgets, gap_at, SSM_SOLO_BAR)
        self.trace = {"reqs": reqs, "dense": dense, "gap_at": gap_at}
        rep["serve"] = {"requests": len(reqs), "prompt_lengths": [len(p) for p in prompts],
                        "rounds": report.rounds, "decode_chunk_iters": iters,
                        "tokens": sum(len(o) for o in out), "cached_tokens": cached,
                        "prefix_hits": report.prefix_hits, "equal_served_alone": len(reqs),
                        "captured_equal_eager": {"requests": SSM_EAGER, "new": SSM_EAGER_NEW},
                        "graphs": graphs_kept, "vs_solo": vs,
                        "launches": {"launches": launches, "counted_as": counted_as}}

    # ------------------------------------------------------------------ (f) --
    def windows(self, rep, cfg, params, params4, prompt):
        """(f): the fixed engine.  At batch 1 n-gram windows (greedy and
        sampled), the int4 self-draft and tree windows (greedy); at BATCH rows
        n-gram windows of SSM_BATCH_SPEC: each generation's first
        SSM_SPEC_EAGER_NEW tokens captured (launches counted: a step's
        calls a window, the draft's k + 1 one-row steps besides) and
        ``torch.equal`` to ``EagerServingEngine``'s, with its window
        counts; greedy against plain greedy decoding at HIT_BAR; a tree of
        fan 1 equal to the linear window of its depth.  Then the windows'
        device ms.  Returns the plain batch-1 tokens."""
        dev, arch, n = self.dev, cfg.arch_id, SSM_SPEC_NEW
        per_step = matvec_calls_per_step(cfg)
        kw = dict(max_seq=PROMPT + N_NEW, device=dev, draft_cfg=cfg, draft_params=params4)
        eng, eager = ServingEngine(cfg, params, **kw), EagerServingEngine(cfg, params, **kw)
        graphs = count_captures(eng)
        p1 = prompt[:1]
        spec, draft, tree = (SpecConfig(**c) for c in (SSM_SPEC, SSM_DRAFT, SSM_TREE))
        cases = (("n-gram k=4, greedy", spec, GREEDY, p1), ("n-gram k=4, sampled", spec, SAMPLED, p1),
                 ("int4 self-draft k=4, greedy", draft, GREEDY, p1),
                 (f"tree fan {tree.tree_fan} x depth {tree.k}, greedy", tree, GREEDY, p1),
                 (f"n-gram k={SSM_BATCH_SPEC['k']}, {BATCH} rows, greedy",
                  SpecConfig(**SSM_BATCH_SPEC), GREEDY, prompt))
        out, plain, stats = {"bar": HIT_BAR, "n_new": n, "cases": []}, {}, {}
        with torch.inference_mode():
            for label, sp, mode, pr in cases:
                b = pr.shape[0]
                if b not in plain:
                    plain[b] = eng.generate(pr, n)
                got = eng.generate(pr, n, speculate=sp, **mode)
                if b == 1:  # the window times' tokens a window: the greedy run's
                    stats.setdefault(sp, dict(eng.spec_stats))
                m = SSM_SPEC_EAGER_NEW
                short, launches, counted_as = counted_launches(
                    graphs, lambda: eng.generate(pr, m, speculate=sp, **mode))
                windows = eng.spec_stats["verify_steps"]
                row = {"case": label, "window_rows": b * self.window_rows(sp),
                       "spec_stats": dict(eng.spec_stats), "eager_new": m,
                       "tokens_equal_eager": torch.equal(
                           short, eager.generate(pr, m, speculate=sp, **mode)),
                       "windows_equal_eager": eng.spec_stats == eager.spec_stats,
                       "launches": launches, "launches_counted_as": counted_as,
                       "windows_counted": windows}
                check(torch.equal(short, got[:, :m]) and row["tokens_equal_eager"]
                      and row["windows_equal_eager"], f"(f) {arch} {label}: the captured "
                      f"windows differ from the eager ones, or from the longer run's: {row}")
                calls = (sp.k + 1 if sp.mode == "draft" else 0) + (
                    row["window_rows"] <= common.MATVEC_MAX_M)
                expect = dict.fromkeys(launches, 0)
                expect["pim_matvec"] = per_step * calls * windows
                check(launches == expect, f"(f) {arch} {label}: launches {launches}, "
                      f"expected {expect}")
                self.launches[f"{self.NAME} {arch} {label}"] = launches
                if mode["greedy"]:
                    row["vs_plain"] = spec_vs_plain(f"{self.NAME} {arch}", f"(f) {label}", eng,
                                                    pr, got, plain[b])
                out["cases"].append(row)
            fan1 = eng.generate(p1, n, speculate=SpecConfig(k=tree.k, tree_fan=1))
            linear = eng.generate(p1, n, speculate=SpecConfig(k=tree.k))
            out["fan_1_equal_linear"] = torch.equal(fan1, linear)
            check(out["fan_1_equal_linear"], f"(f) {arch}: tree_fan=1 differs from linear")
        del eager
        out["window_ms"] = self.window_times(eng, p1, None, (spec, draft, tree), stats)
        del eng, graphs
        rep["speculation"] = out
        return plain[1]

    @torch.inference_mode()
    def planted(self, cfg, params, prompt, plain, label):
        """(f): windows planted with plain greedy decoding's tokens: a linear
        window of k = 4 whose first two proposals are plain's and the rest
        wrong, and a tree of fan 2 x depth 3 whose chain 1 holds plain's
        next two and a wrong third (chain 0 wrong): verified (``verify_step``
        on a batch-1 cache after the prompt), accepted greedily, committed
        at the accepted step (``commit_verify``); the state against
        ``decode_step``s of the accepted tokens from the same cache, within
        SSM_COMMIT_TOL of its largest value; a commit one step (one node)
        late must be farther."""
        dev, s0, v = self.dev, prompt.shape[1], cfg.vocab
        g = plain[0].to(torch.int64)
        wrong = lambda t: (t + 1) % v  # noqa: E731
        base = init_cache(cfg, 1, PROMPT + N_NEW, dev)
        prefill(params, cfg, prompt[:1], base)
        kept = {n: t.clone() for n, t in base["layers"].items()}
        pos = torch.full((1,), s0, dtype=torch.int64, device=dev)
        k, (fan, depth) = SSM_SPEC["k"], (SSM_TREE["tree_fan"], SSM_TREE["k"])
        lin = torch.stack([g[0], g[1], g[2], wrong(g[3]), wrong(g[4])])[None]
        chain0 = torch.stack([wrong(g[1]), g[2], g[3]])
        chain1 = torch.stack([g[1], g[2], wrong(g[3])])
        tree = torch.cat([g[:1], chain0, chain1])[None]
        out = {"tol": SSM_COMMIT_TOL, "layers": cfg.n_layers}

        def restore():
            for n, t in base["layers"].items():
                t.copy_(kept[n])

        def decoded(toks):
            c = init_cache(cfg, 1, PROMPT + N_NEW, dev)
            for n, t in c["layers"].items():
                t.copy_(kept[n])
            for j in range(toks.shape[1]):
                decode_step(params, cfg, toks[:, j:j + 1].to(torch.int32), c, s0 + j)
            return c["layers"]

        for name, window, tree_arg in (("linear", lin, None), ("tree", tree, (fan, depth))):
            dists = {}
            for late in (False, True):
                restore()
                lg, vc = verify_step(params, cfg, window.to(torch.int32), base, pos, tree=tree_arg)
                if tree_arg is None:
                    _, a = speculative.greedy_accept(window.to(torch.int32), lg)
                    node, cf = a, torch.zeros_like(a)
                else:
                    _, a, cf = speculative.greedy_tree_accept(
                        window[:, 1:].reshape(1, fan, depth).to(torch.int32), lg)
                    node = torch.where(a > 0, cf * depth + a, 0)
                at = int(node) + int(late)
                check(at < window.shape[1], f"(f) {label} {name}: no step after node {int(node)}")
                lm.commit_verify(cfg, vc, torch.tensor([at], device=dev))
                path = (window[:, :int(a) + 1] if tree_arg is None or int(a) == 0 else
                        torch.cat([window[:, :1],
                                   window[:, 1 + int(cf) * depth:1 + int(cf) * depth + int(a)]],
                                  dim=1))
                dists["late" if late else "sound"] = rel_dist(base["layers"], decoded(path))
            restore()
            out[name] = {"accepted": int(a), "kept_chain": int(cf), "committed_node": int(node),
                         "sound_rel_dist": dists["sound"], "late_rel_dist": dists["late"]}
            check(dists["sound"] <= SSM_COMMIT_TOL < dists["late"],
                  f"(f) {label} {name}: the committed state against decoding the accepted "
                  f"tokens: {out[name]}")
        print(f"{self.NAME} (f) planted {label}: {json.dumps(out)}", flush=True)
        return out

    def spec_serves(self, rep, cfg, params, params4):
        """(f): the continuous engine (SSM_SERVE's 2 slots) on (e)'s first
        SSM_SERVE_REQUESTS requests under each of SSM_SERVE_SPEC, greedy,
        the int4 tree as the draft: captured ``torch.equal`` to
        ``EagerEngine``, the launches counted, each request against its
        solo run (``self.trace``) at HIT_BAR."""
        dev, arch, tr = self.dev, cfg.arch_id, self.trace
        per_step = matvec_calls_per_step(cfg)
        reqs = tr["reqs"][:SSM_SERVE_REQUESTS]
        out = {"requests": len(reqs), "bar": HIT_BAR}
        for name, sp in SSM_SERVE_SPEC.items():
            spec = SpecConfig(**sp)
            geo = dict(speculate=spec, device=dev, draft_cfg=cfg, draft_params=params4,
                       **SSM_SERVE)
            eng = ContinuousBatchingEngine(cfg, params, **geo)
            graphs = count_captures(eng)
            eng.serve(reqs)  # captures its admits and windows
            got, launches, counted_as = counted_launches(graphs, lambda: eng.serve(reqs))
            iters, events = eng.decode_chunk_iters, events_of(eng.last_report)
            eager = EagerEngine(cfg, params, **geo)
            want = eager.serve(reqs)
            row = {"window_rows": SSM_SERVE["slots"] * self.window_rows(spec),
                   "iterations": iters, "emitted": eng.spec_emitted,
                   "live_windows": eng.spec_live_steps,
                   "tokens_equal_eager": same_tokens(got, want),
                   "events_equal_eager": events == events_of(eager.last_report),
                   "launches": launches, "launches_counted_as": counted_as}
            check(row["tokens_equal_eager"] and row["events_equal_eager"],
                  f"(f serves) {arch} {name}: the captured serve differs from the eager one")
            calls = (spec.k + 1 if spec.mode == "draft" else 0) + (
                row["window_rows"] <= common.MATVEC_MAX_M)
            expect = dict.fromkeys(launches, 0)
            expect["pim_matvec"] = per_step * calls * iters + len(reqs)
            check(launches == expect, f"(f serves) {arch} {name}: launches {launches}, "
                  f"expected {expect}")
            self.launches[f"{self.NAME} {arch} {name} serve"] = launches
            with torch.inference_mode():
                row["vs_solo"] = paged_vs_dense(
                    f"(f serves) {arch} {name}", got, tr["dense"][:len(reqs)],
                    [r.max_new for r in reqs], tr["gap_at"], HIT_BAR)
            out[name] = row
            del eng, eager, graphs
            gc.collect()
            torch.cuda.empty_cache()
        rep["spec_serves"] = out

    # --------------------------------------------------------------- the run --
    def run(self):
        dev, cfg = self.dev, get_config(SSM_ARCH)
        arch, d, d_in = cfg.arch_id, cfg.d_model, cfg.ssm.expand * cfg.d_model
        gen = torch.Generator(device=dev).manual_seed(SEED + 15)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = {"check": f"{self.NAME}: {arch} at full width and all {cfg.n_layers} layers, "
                        "int8 weights",
               "arch": arch, "layers": cfg.n_layers, "d_model": d, "d_inner": d_in,
               "state_dim": cfg.ssm.state_dim, "conv_dim": cfg.ssm.conv_dim,
               "dt_rank": cfg.ssm.dt_rank or d // 16, "vocab": cfg.vocab, "section_s": {}}

        t = time.perf_counter()  # (a) the layer and the kernel at the config's shapes
        rep["ssm_layer"] = self.ssm_layer(cfg, gen)
        pl = matvec_plan(d, cfg.vocab, BATCH, 8, self.sms)
        rep["kernel_vs_plain"], _ = family_kernel_cases(
            cfg, gen, extra=SSM_KERNEL_EXTRA, chunk_fault=pl.chunk_rows < pl.rows_per_cta)
        gc.collect()
        torch.cuda.empty_cache()
        self._took(rep, "a", t)

        t = time.perf_counter()
        params = quantized_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 14), 8)
        torch.cuda.synchronize()
        rep.update(weights_s=time.perf_counter() - t, int8_bytes=pim_bytes(params),
                   peak_bytes_drawing=torch.cuda.max_memory_allocated())
        print(f"{self.NAME} (weights): {rep['weights_s']:.1f} s, {rep['int8_bytes']} bytes",
              flush=True)
        eng = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW, device=dev)
        prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen, device=dev)
        per_step = matvec_calls_per_step(cfg)
        check(per_step == len(SSM_LINEARS) * cfg.n_layers + 1,
              f"{arch}: {per_step} pim_matvec calls a step")
        graphs = count_captures(eng)

        t = time.perf_counter()  # (b) the fixed engine: counted, captured against eager
        with torch.inference_mode():
            eng.generate(prompt, 2)  # warm-up: the greedy step's capture
            toks, launches, counted_as = counted_launches(graphs,
                                                          lambda: eng.generate(prompt, N_NEW))
            rep["captured_vs_eager"] = [captured_vs_eager(
                eng, prompt, N_NEW, f"{arch} int8 greedy, {BATCH} x {PROMPT}", toks=toks,
                **GREEDY)[0]]
            sampled, stoks = captured_vs_eager(eng, prompt, N_NEW, f"{arch} int8 sampled, "
                                               f"{BATCH} x {PROMPT}", **SAMPLED)
            rep["captured_vs_eager"].append(sampled)
        check(not torch.equal(stoks, toks), f"(b) {arch}: sampled tokens equal greedy ones")
        expect = dict.fromkeys(launches, 0)
        expect["pim_matvec"] = per_step * (N_NEW - 1)
        check(launches == expect, f"(b) {arch}: launches {launches}, expected {expect}")
        check(all(g.launches["pim_matvec"] == per_step for g in graphs),
              f"(b) {arch}: captured steps launch {[g.launches for g in graphs]}, expected "
              f"{per_step} pim_matvec each")
        self.launches[f"{self.NAME} {arch} generate"] = launches
        rep["launches"] = {"launches": launches, "per_step": per_step, "counted_as": counted_as}
        with torch.inference_mode():
            med, rounds = step_ms({"captured_ms": (eng, GREEDY),
                                   "captured_sampled_ms": (eng, SAMPLED)},
                                  prompt, SSM_TIME_STEPS + 1, 1)
            kernels_ms = _time_ms([functools.partial(
                pim_matvec, torch.randn((BATCH, w["codes"].shape[0]), generator=gen,
                                        device=dev).to(torch.bfloat16), w["codes"], w["scale"],
                bits=8) for w in (weight_at(params, path) for path in step_calls(cfg))], 3)
        stream = cross_stream_bytes(eng)
        rep["step"] = {**med, "stream_bytes": stream, "floor_ms": stream / HBM_BYTES_PER_S * 1e3,
                       "pim_matvec_ms_a_step": kernels_ms * per_step, "rounds": rounds,
                       "timing": f"device ms a captured step at {BATCH} x {PROMPT}, CUDA events "
                                 f"over {SSM_TIME_STEPS} replays; pim_matvec: the step's "
                                 f"{per_step} calls on its own codes back to back in a CUDA "
                                 "graph; floor: every code and scale at 3.35 TB/s"}
        rep["step"].update(self.floors_reckoned(cfg, rep["step"], BATCH))
        rep["step"]["peak_bytes"] = torch.cuda.max_memory_allocated()
        rep["plans"] = self.plans(eng, prompt, toks)
        print(f"{self.NAME} (b): " + json.dumps({"launches": launches, "step": rep["step"],
                                                 "plans": rep["plans"]}), flush=True)
        self._took(rep, "b", t)

        t = time.perf_counter()  # (e) the continuous engine
        self.serve(rep, cfg, params, eng, gen)
        gc.collect()  # the counted captures hold each engine in a cycle
        torch.cuda.empty_cache()
        self._took(rep, "e", t)

        t = time.perf_counter()  # (f) speculation
        params4 = quantized_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 14), 4)
        plain = self.windows(rep, cfg, params, params4, prompt)
        rep["planted"] = {"bf16": self.planted(cfg, params, prompt, plain,
                                               f"bf16, {cfg.n_layers} layers")}
        self._took(rep, "f windows", t)
        t = time.perf_counter()
        self.spec_serves(rep, cfg, params, params4)
        del params4
        gc.collect()
        torch.cuda.empty_cache()
        self._took(rep, "f serves", t)

        t = time.perf_counter()  # (d) the bf16 kernel path against the overlay path
        ftoks = toks[:, :SSM_CHECK_NEW]
        diff, _, lo = against_overlay(eng, prompt, ftoks, SSM_CHECK_NEW, f"{arch} int8",
                                      tol=SSM_OVERLAY_TOL, capture=False)
        pl = matvec_plan(d_in, d, BATCH, 8, self.sms)
        rows = (d_in - (pl.cluster - 1) * pl.rows_per_cta if pl.cluster > 1
                else d_in - (d_in - 1) // pl.chunk_rows * pl.chunk_rows)  # out_proj's last K split
        out0 = step_calls(cfg).index(("layers", 0, *SSM_LINEARS[3]))
        with decode_linears_through(dropped_call(per_step, out0, rows)):
            fault = (forced_logits(eng, prompt, ftoks, SSM_CHECK_NEW) - lo).abs().max().item()
        check(fault > SSM_OVERLAY_TOL, f"(d) {arch}: layer 0's out_proj, its last {rows} K "
              f"rows dropped, moved the logits by {fault:.4g}, within the bar {SSM_OVERLAY_TOL}")
        rep["witness"] = self.witness(cfg, params, eng, prompt, ftoks, lo)
        gc.collect()
        torch.cuda.empty_cache()
        self._took(rep, "d", t)

        t = time.perf_counter()  # (c) the f32 path, SSM_F32_LAYERS deep, against plain
        cfg32 = cfg.replace(n_layers=SSM_F32_LAYERS, param_dtype="float32")
        params32 = quantized_params(cfg32, gen, 8)
        eng32 = ServingEngine(cfg32, params32, max_seq=PROMPT + N_NEW, device=dev)
        rep["f32_path"] = plain_path_check(eng32, eng, prompt, ftoks, lo,
                                           f"{arch} int8 f32 kernel path vs plain path, "
                                           f"{SSM_F32_LAYERS} layers", rows)
        with torch.inference_mode():
            plain32 = eng32.generate(prompt[:1], SSM_SPEC["k"] + 1)
        rep["planted"]["f32"] = self.planted(cfg32, params32, prompt, plain32,
                                             f"f32, {SSM_F32_LAYERS} layers")
        del eng32, params32, lo
        rep["overlay"] = {"max_abs_logit_diff": diff, "bar": SSM_OVERLAY_TOL,
                          "planted_fault": f"layer 0's out_proj: its last {rows} K rows dropped",
                          "planted_fault_max_abs_logit_diff": fault,
                          "middle_out_proj_fault_max_abs_logit_diff":
                              rep["f32_path"]["planted_fault_bf16_diff_vs_overlay"],
                          "logit_tol": LOGIT_TOL}
        gc.collect()
        torch.cuda.empty_cache()
        self._took(rep, "c", t)
        rep["peak_bytes"] = torch.cuda.max_memory_allocated()
        self.trace = None  # its solo-gap closure holds the int8 tree
        del eng, graphs, params
        gc.collect()
        torch.cuda.empty_cache()
        rep["phase_s"] = time.perf_counter() - t0
        print(json.dumps(rep), flush=True)
        return self.launches


def overlay_depths() -> int:
    """``python3 chip_smoke.py --overlay-depths``: phase 17 (b) for the vlm
    alone at 1, 2 and CROSS_VLM_GROUPS groups, on the generator, draws and
    gates of the run's vlm (so its last reading is (b)'s), with each of
    ``CrossPhase._faults``, bars not applied: how the distance between two
    sound bf16 arithmetics grows with depth, and how far each fault stands
    from it.  Prints one JSON line a depth."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev, arch = torch.device("cuda", 0), CROSS[1]
    phase = CrossPhase(dev)
    for groups in (1, 2, CROSS_VLM_GROUPS):
        t0 = time.perf_counter()
        cfg = phase._config(arch, groups)
        gen = torch.Generator(device=dev).manual_seed(SEED + 10 + CROSS.index(arch))
        params = phase._weights(cfg, gen)
        eng = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW, device=dev)
        prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen, device=dev)
        ex = phase._extras(cfg, params, gen, BATCH)
        with torch.inference_mode():
            toks = eng.generate(prompt, CROSS_CHECK_NEW, extras=ex)
        rep, _ = phase.overlay(eng, prompt, toks, ex, math.inf,
                               faults=tuple(phase._faults(cfg)))
        print(json.dumps({"overlay_depth": arch, "groups": groups, "layers": cfg.n_layers,
                          **rep, "s": time.perf_counter() - t0}), flush=True)
        del eng, params, ex, toks
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(overlay_depths() if sys.argv[1:] == ["--overlay-depths"] else main())

#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card and check its kernels.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Two paths run, at qwen2-1.5b's full width (28 layers, bf16, random weights
from a seeded generator on the card):

* greedy decoding from PIM-quantized weights: ``serving.quantize_tree`` ->
  ``models.prefill`` -> ``models.decode_step`` -> ``ServingEngine.generate``,
  every decode-time linear through the hand-written CUDA kernel
  ``pim_matvec``;
* the packed kernel entry point ``repro_torch.kernels`` (``ops``): every
  layer's seven float weights through ``quantize_for_pim``, then
  ``pim_dense`` (the CUDA kernel ``pim_matmul``) on a prefill's 4 x 128 rows
  and ``pim_matvec_dense`` on 4 of them.

Phases:

1. the card's name and power limit; the kernels build, one ``nvcc`` per
   source, all at once (set-up);
2. each kernel against its plain PyTorch version, rtol 1e-5, atol 1e-4:
   ``pim_matvec`` at the decode path's full-width shapes (int8 and int4,
   M in {1, 4, 8}, every epilogue, f32 and bf16 inputs, one odd-K int4
   weight); ``pim_matmul`` at the seven linears' shapes with M in {9, 512}
   and at ragged shapes that are multiples of no tile (one with M <= 8), the
   same grid of bits, epilogues and dtypes;
3. the decode path: 4 requests of 128 prompt tokens, 32 new tokens, int8
   weights.  ``pim_matvec``'s launch count must be 7 x 28 x 31 and
   ``pim_matmul``'s 0 (prefill stays ``x @ dq(w)``); the teacher-forced
   decode logits must agree with the overlay path (``x @ dq(w)``, dispatch
   "off") within LOGIT_TOL; greedy tokens must agree with the overlay path's
   wherever the top-2 margin exceeds the two paths' difference.  A shorter
   int4 generation is checked the same way.  The same path in f32 must give
   the logits of its plain version (every decode linear through
   ``pim_matvec_plain`` on the card) within PATH_TOL, and a planted fault
   (one layer's ``down`` loses its last K split) must fail that check;
4. the entry point, at bits 8 and then 4: ``pim_matmul`` must launch
   exactly 7 x 28 times per pass and every output agree with
   ``pim_matmul_plain`` within KERNEL_TOL; a planted fault (one layer's
   ``down`` loses the kernel's last K tile) must fail that check;
   ``pim_matvec_dense`` on 4 rows against ``pim_matvec_plain``;
5. times on the card with CUDA events over CUDA-graph replays (device
   time, free of the host's issue rate): per shape, kernel / bound (the
   larger of the bytes at the HBM rate and the multiply-adds at the bf16
   tensor cores' rate, x being bf16; the f32 CUDA-core term beside it) /
   plain / overlay yardstick (``torch.matmul`` on a pre-dequantized bf16 weight: it
   reads 2 bytes a weight where the kernels read 1 or 0.5) / library
   (``torch._weight_int8pack_mm``, int8 only), cycling through all 28
   layers' weights so no weight is timed out of L2; ``pim_matvec`` at the
   decode path's M = 4 and ``pim_matmul`` at the prefill's M = 512; and one
   pass of each kernel's 196 launches in the path's order.  The kernels are
   also timed as an eager loop issues them.

Then the ``kernels`` JSON line, and last the device line.  Any failure exits
non-zero; so does a host with no card, and a directory without the package.
"""
import concurrent.futures
import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.pim_matmul import BLOCK_K, pim_matmul, pim_matmul_plain  # noqa: E402
from repro_torch.kernels.pim_matvec import pim_matvec, pim_matvec_plain, split_rows  # noqa: E402
from repro_torch.models import common, decode_step, init_cache, init_params, prefill  # noqa: E402
from repro_torch.quant import QuantizedTensor, dequantize  # noqa: E402
from repro_torch.serving import ServingEngine, quantize_tree  # noqa: E402

SEED = 20260
KERNELS = ("pim_matvec", "pim_matmul")
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
TIME_BUDGET_S = 1.0  # about this long per measurement, at most `reps` passes
PREFILL_ROWS = BATCH * PROMPT  # one prefill's rows: what pim_dense is held at
MATMUL_ROWS = (9, PREFILL_ROWS)  # just past pim_matvec's M <= 8, and a prefill
RAGGED = ((130, 1000, 300), (7, 1000, 300))  # (M, K, N): multiples of no tile
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
    eng4 = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW_INT4, pim_bits=4, device=dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen, device=dev)
    # The entry point's phases draw from a generator of their own, so the
    # decode path's inputs do not depend on them.
    gen_mm = torch.Generator(device=dev).manual_seed(SEED + 1)

    # ---- 2. kernel vs plain ------------------------------------------------
    max_err = kernel_vs_plain(pim_matvec, pim_matvec_plain, matvec_cases(eng8, eng4), gen)
    max_err = max(max_err, odd_k_case(gen))
    print(f"pim_matvec vs plain: max |err| {max_err:.3g} within rtol "
          f"{KERNEL_TOL['rtol']} atol {KERNEL_TOL['atol']}")
    mm_cases = matmul_cases(params, gen_mm)
    mm_err = kernel_vs_plain(pim_matmul, pim_matmul_plain, mm_cases, gen_mm)
    print(f"pim_matmul vs plain: max |err| {mm_err:.3g} within rtol "
          f"{KERNEL_TOL['rtol']} atol {KERNEL_TOL['atol']} over "
          f"{32 * len(mm_cases)} cases")

    # ---- 3. the decode path --------------------------------------------------
    eng8.generate(prompt, 2)  # warm-up: library load, allocator, cuBLAS handles
    torch.cuda.synchronize()
    pim_matvec.launches = pim_matmul.launches = 0
    t0 = time.perf_counter()
    toks = eng8.generate(prompt, N_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = pim_matvec.launches
    want = len(LINEARS) * cfg.n_layers * (N_NEW - 1)
    check(launches == want, f"pim_matvec launched {launches} times on the "
          f"main path, expected {want}")
    check(pim_matmul.launches == 0, f"pim_matmul launched {pim_matmul.launches} "
          "times on the decode path, whose prefill is x @ dq(w)")
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
                      "prompt": PROMPT, "n_new": N_NEW, "launches": launches,
                      "pim_matmul_launches": pim_matmul.launches,
                      "generate_s": t_gen, "prefill_s": t_prefill,
                      "decode_ms_per_step": decode_s * 1e3,
                      "decode_tokens_per_s": BATCH / decode_s,
                      "overlay_decode_ms_per_step": decode_off_s * 1e3,
                      "max_abs_logit_diff_vs_overlay": diff8}))

    pim_matvec.launches = 0
    toks4 = eng4.generate(prompt, N_NEW_INT4)
    torch.cuda.synchronize()
    launches4 = pim_matvec.launches
    want4 = len(LINEARS) * cfg.n_layers * (N_NEW_INT4 - 1)
    check(launches4 == want4, f"int4 path: {launches4} launches, expected {want4}")
    diff4, _, _ = against_overlay(eng4, prompt, toks4, N_NEW_INT4, "int4")
    print(json.dumps({"path": "qwen2-1.5b int4 generate", "n_new": N_NEW_INT4,
                      "launches": launches4, "max_abs_logit_diff_vs_overlay": diff4}))
    against_plain(eng8, gen, prompt, toks, lo8)

    # ---- 4. the entry point ----------------------------------------------------
    mm_weights, entry = entry_point(params, gen_mm)
    del params
    print(json.dumps(entry))
    mm_err = max(mm_err, entry["max_abs_err"])

    # ---- 5. times ------------------------------------------------------------
    shapes, step = timings(pim_matvec, pim_matvec_plain, BATCH,
                           {bits: engine_weights(eng, bits) for eng, bits in ((eng8, 8), (eng4, 4))},
                           gen, "one decode step")
    for row in shapes:
        print(json.dumps(row))
    print(json.dumps({"decode_step_launches": step}))
    mm_shapes, mm_pass = timings(pim_matmul, pim_matmul_plain, PREFILL_ROWS, mm_weights, gen_mm,
                                 f"one prefill's linears at {BATCH} x {PROMPT} tokens")
    for row in mm_shapes:
        print(json.dumps(row))
    print(json.dumps({"prefill_pass_launches": mm_pass}))
    print(json.dumps({"kernels": [{
        "name": "pim_matvec", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pim_matvec.cu",
        "replaces": "src/repro/kernels/pim_matvec.py:40",
        "launches": launches, "max_abs_err": max_err,
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
        "f32_cuda_core_ms": mm_pass["f32_cuda_core_ms"],
        "library_ms": mm_pass["library_ms"], "overlay_ms": mm_pass["overlay_ms"],
        "eager_ms": mm_pass["kernel_eager_ms"], "per": mm_pass["per"],
    }]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def within_tol(got, ref):
    """(every output finite and within KERNEL_TOL of ``ref``, max |err|)."""
    err = (got - ref).abs()
    ok = bool((err <= KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * ref.abs()).all())
    return bool(torch.isfinite(got).all()) and ok, err.max().item()


def matvec_cases(eng8, eng4):
    """``pim_matvec``'s cases: every linear of the decode path, layer 0,
    bits 8 and 4, M in {1, 4, 8}."""
    return [(name, m, qs[0]) for eng, bits in ((eng8, 8), (eng4, 4))
            for name, qs, _ in engine_weights(eng, bits) for m in (1, 4, 8)]


def matmul_cases(params, gen):
    """``pim_matmul``'s cases: the seven linears' layer-0 weights through
    ``ops.quantize_for_pim`` with M in MATMUL_ROWS, and random weights at
    the RAGGED shapes; bits 8 and 4."""
    cases = []
    for bits in (8, 4):
        for group, name, _ in LINEARS:
            q = ops.quantize_for_pim(params["layers"][group][name][0], bits)
            cases += [(name, m, q) for m in MATMUL_ROWS]
        for m, k, n in RAGGED:
            w = 0.02 * torch.randn((k, n), generator=gen, device=gen.device)
            cases.append((f"ragged K={k} N={n}", m, ops.quantize_for_pim(w, bits)))
    return cases


def kernel_vs_plain(kernel, plain, cases, gen) -> float:
    """``kernel`` against ``plain`` on every (label, M, QuantizedTensor) of
    ``cases``: f32 and bf16 inputs, every activation, with and without bias
    and residual.  Returns the max |err|."""
    max_err = 0.0
    dev = gen.device
    for label, m, q in cases:
        k, n = q.shape
        x32 = torch.randn((m, k), generator=gen, device=dev)
        b32 = torch.randn((n,), generator=gen, device=dev)
        r32 = torch.randn((m, n), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x, b, r = x32.to(dtype), b32.to(dtype), r32.to(dtype)
            for act in ("none", "relu", "silu", "gelu"):
                for bias, res in ((None, None), (b, None), (None, r), (b, r)):
                    kw = dict(bits=q.bits, bias=bias, activation=act, residual=res)
                    got = kernel(x, q.codes, q.scale, **kw)
                    ref = plain(x, q.codes, q.scale, **kw)
                    torch.cuda.synchronize()
                    ok, err = within_tol(got, ref)
                    check(ok, f"{kernel.__name__} {label} bits={q.bits} M={m} "
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
    of ``layer``, the last K split of the kernel's first pass adds nothing
    (the activations it multiplies are zeroed).  Counts decode calls, so it
    holds for a prefill (which makes none) and then decode steps."""
    calls = 0
    sm = torch.cuda.get_device_properties(0).multi_processor_count

    def faulty(x, w_codes, scale, *, bits=8, **kw):
        nonlocal calls
        if calls % (n_layers * len(LINEARS)) == layer * len(LINEARS) + index:
            splits, per = split_rows(w_codes.shape[0], w_codes.shape[1], sm)
            x = x.clone()
            x[:, (splits - 1) * per * (8 // bits):] = 0
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
                      "planted_fault": f"layer {cfg.n_layers // 2} down: last K split dropped",
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
    loses the kernel's last K tile (the activations it multiplies are
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
    faulty[:, (q.shape[0] - 1) // BLOCK_K * BLOCK_K:] = 0
    ok, fault_err = within_tol(ops.pim_dense(faulty, q),
                               pim_matmul_plain(x, q.codes, q.scale, bits=8))
    check(not ok, f"the planted fault moved pim_dense's output by only "
          f"{fault_err:.3g}: the check cannot see it")
    report.update({"max_abs_err": max_err, "pim_matvec_dense_max_abs_err": vec_err,
                   "tol": KERNEL_TOL,
                   "planted_fault": f"layer {layer} down, bits 8: last K tile "
                                    f"({BLOCK_K} of {q.shape[0]}) dropped",
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


def _bound_terms_ms(m, k, n, bits, bias_bytes):
    """(bytes term, operations term, f32 CUDA-core term) of the least time,
    in ms, for bf16 x: the bytes the function must move (codes, scale, x,
    bias, f32 out, each once) over the HBM rate; its multiply-adds over the
    card's peak rate for their type, bf16 on the tensor cores (int8 and
    int4 codes are exact in bf16 and a bf16 product is exact in f32); and
    the same multiply-adds over the f32 rate outside the tensor cores, the
    rate the current ``pim_matmul`` design runs at: a note on that design,
    not a bound (data-sheet peaks)."""
    moved = k * n * bits // 8 + 4 * n + m * k * 2 + bias_bytes + 4 * m * n
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


def timings(kernel, plain, m, weights, gen, what):
    """Per-shape times of ``kernel`` at M = ``m`` with bf16 inputs, cycling
    through all layers' weights (``weights``: {bits: [(name,
    [QuantizedTensor per layer], [bias per layer])]}); then one pass of
    every launch in path order (layer-major), int8."""
    dev = gen.device
    n_layers = len(weights[8][0][1])
    n_linears = len(weights[8])
    rows = []
    step = {"kernel": [], "plain": [], "overlay": [], "library": []}
    step_bytes = step_ops = step_f32 = 0.0
    for bits, linears in weights.items():
        for name, qs, bs in linears:
            k, n = qs[0].shape
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            calls = {
                "kernel": [functools.partial(kernel, x, q.codes, q.scale, bits=bits, bias=b)
                           for q, b in zip(qs, bs)],
                "plain": [functools.partial(plain, x, q.codes, q.scale, bits=bits, bias=b)
                          for q, b in zip(qs, bs)],
                "overlay": [functools.partial(torch.matmul, x, dequantize(q).to(torch.bfloat16))
                            for q in qs],
            }
            lib_err = library_us = None
            if bits == 8:
                calls["library"], lib_err = library_calls(x, qs)
                if calls["library"] is not None:
                    library_us = _time_ms(calls["library"], 20) * 1e3
            by_bytes, by_ops, by_f32 = _bound_terms_ms(m, k, n, bits,
                                                       0 if bs[0] is None else 2 * n)
            rows.append({"kernel": kernel.__name__, "shape": name, "K": k, "N": n,
                         "bits": bits, "M": m,
                         "kernel_us": _time_ms(calls["kernel"], 20) * 1e3,
                         "bound_us": max(by_bytes, by_ops) * 1e3,
                         "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                         "f32_cuda_core_us": by_f32 * 1e3,
                         "plain_us": _time_ms(calls["plain"], 5) * 1e3,
                         "overlay_yardstick_us": _time_ms(calls["overlay"], 20) * 1e3,
                         "library_us": library_us, "library_error": lib_err,
                         "kernel_eager_us": _time_ms(calls["kernel"], 5, graph=False) * 1e3})
            if bits == 8:
                for key in step:
                    step[key].append(calls.get(key))
                step_bytes += by_bytes * n_layers
                step_ops += by_ops * n_layers
                step_f32 += by_f32 * n_layers

    n_calls = n_layers * n_linears

    def step_ms(key, reps, graph=True):  # layer-major, the linears in path order
        order = [step[key][j][i] for i in range(n_layers) for j in range(n_linears)]
        return _time_ms(order, reps, graph) * n_calls

    return rows, {
        "per": f"{what}: {n_calls} launches ({n_layers} layers x {n_linears} "
               f"linears), M={m}, int8, bf16 x; device time (CUDA graph replay)",
        "kernel_ms": step_ms("kernel", 20), "plain_ms": step_ms("plain", 5),
        "overlay_ms": step_ms("overlay", 20),
        "library_ms": (None if None in step["library"] else step_ms("library", 20)),
        "kernel_eager_ms": step_ms("kernel", 5, graph=False),
        "bound_ms": max(step_bytes, step_ops),
        "bound_by": "bytes" if step_bytes >= step_ops else "operations",
        "f32_cuda_core_ms": step_f32}


if __name__ == "__main__":
    sys.exit(main())

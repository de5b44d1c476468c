#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check its kernels.

    python3 chip_smoke.py        # from the repository root, one CUDA card

The main path is greedy decoding of qwen2-1.5b at full width (28 layers,
bf16, random weights from a seeded generator on the card) from PIM-quantized
weights: ``serving.quantize_tree`` -> ``models.prefill`` ->
``models.decode_step`` -> ``ServingEngine.generate``, every decode-time linear
through the hand-written CUDA kernel ``pim_matvec``.  Phases:

1. the card's name and power limit; the kernels build (set-up);
2. each kernel against its plain PyTorch version at the path's full-width
   shapes (int8 and int4, M in {1, 4, 8}, every epilogue, f32 and bf16
   inputs, one odd-K int4 weight): rtol 1e-5, atol 1e-4;
3. the slice: 4 requests of 128 prompt tokens, 32 new tokens, int8 weights.
   The kernel's launch count must be 7 x 28 x 31; the teacher-forced decode
   logits must agree with the overlay path (``x @ dq(w)``, dispatch "off")
   within LOGIT_TOL; greedy tokens must agree with the overlay path's
   wherever the top-2 margin exceeds the two paths' difference.  A shorter
   int4 generation is checked the same way.  The same path in f32 must give
   the logits of its plain version (every decode linear through
   ``pim_matvec_plain`` on the card) within PATH_TOL, and a planted fault
   (one layer's ``down`` loses its last K split) must fail that check;
4. times on the card with CUDA events over CUDA-graph replays (device
   time, free of the host's issue rate): per shape, kernel / bound / plain /
   overlay yardstick (``torch.matmul`` on a pre-dequantized bf16 weight: it
   reads 2 bytes a weight where the kernel reads 1 or 0.5) / library
   (``torch._weight_int8pack_mm``, int8 only), cycling through all 28
   layers' weights so no weight is timed out of L2; and one decode step's
   196 kernel launches in the path's order.  The kernel is also timed as the
   eager loop issues it.

Then the ``kernels`` JSON line, and last the device line.  Any failure exits
non-zero; so does a host with no card, and a directory without the package.
"""
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.pim_matvec import pim_matvec, pim_matvec_plain, split_rows  # noqa: E402
from repro_torch.models import common, decode_step, init_cache, init_params, prefill  # noqa: E402
from repro_torch.serving import ServingEngine, quantize_tree  # noqa: E402

SEED = 20260
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
    lib = build.build("pim_matvec")
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
    print(lib.with_name(lib.name + ".log").read_text(), file=sys.stderr)

    cfg = get_config("qwen2-1.5b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    eng8 = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW, pim_bits=8, device=dev)
    eng4 = ServingEngine(cfg, params, max_seq=PROMPT + N_NEW_INT4, pim_bits=4, device=dev)
    del params
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen, device=dev)

    # ---- 2. kernel vs plain at the path's shapes -------------------------
    max_err = kernel_vs_plain(eng8, eng4, gen)
    max_err = max(max_err, odd_k_case(gen))
    print(f"kernel vs plain: max |err| {max_err:.3g} within rtol "
          f"{KERNEL_TOL['rtol']} atol {KERNEL_TOL['atol']}")

    # ---- 3. the slice ------------------------------------------------------
    eng8.generate(prompt, 2)  # warm-up: library load, allocator, cuBLAS handles
    torch.cuda.synchronize()
    pim_matvec.launches = 0
    t0 = time.perf_counter()
    toks = eng8.generate(prompt, N_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = pim_matvec.launches
    want = len(LINEARS) * cfg.n_layers * (N_NEW - 1)
    check(launches == want, f"pim_matvec launched {launches} times on the "
          f"main path, expected {want}")
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

    # ---- 4. times ------------------------------------------------------------
    shapes, step = timings(eng8, eng4, gen)
    for row in shapes:
        print(json.dumps(row))
    print(json.dumps({"decode_step_launches": step}))
    print(json.dumps({"kernels": [{
        "name": "pim_matvec", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pim_matvec.cu",
        "replaces": "src/repro/kernels/pim_matvec.py:40",
        "launches": launches, "max_abs_err": max_err,
        "ms": step["kernel_ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
        "library_ms": step["library_ms"], "overlay_ms": step["overlay_ms"],
        "eager_ms": step["kernel_eager_ms"], "per": step["per"],
    }]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_vs_plain(eng8, eng4, gen) -> float:
    """Every linear of the path, layer 0: bits 8 and 4, M in {1, 4, 8}, every
    activation, with and without bias and residual, f32 and bf16 inputs."""
    max_err = 0.0
    dev = gen.device
    for eng, bits in ((eng8, 8), (eng4, 4)):
        for group, name, _ in LINEARS:
            w = {key: v[0] for key, v in eng.params["layers"][group][name].items()}
            k = w["codes"].shape[0] * (8 // bits)
            n = w["codes"].shape[1]
            for m in (1, 4, 8):
                x32 = torch.randn((m, k), generator=gen, device=dev)
                b32 = torch.randn((n,), generator=gen, device=dev)
                r32 = torch.randn((m, n), generator=gen, device=dev)
                for dtype in (torch.float32, torch.bfloat16):
                    x, b, r = x32.to(dtype), b32.to(dtype), r32.to(dtype)
                    for act in ("none", "relu", "silu", "gelu"):
                        for bias, res in ((None, None), (b, None), (None, r), (b, r)):
                            kw = dict(bits=bits, bias=bias, activation=act, residual=res)
                            got = pim_matvec(x, w["codes"], w["scale"], **kw)
                            ref = pim_matvec_plain(x, w["codes"], w["scale"], **kw)
                            torch.cuda.synchronize()
                            err = (got - ref).abs()
                            ok = bool((err <= KERNEL_TOL["atol"]
                                       + KERNEL_TOL["rtol"] * ref.abs()).all())
                            check(bool(torch.isfinite(got).all()) and ok,
                                  f"pim_matvec {name} bits={bits} M={m} {dtype} "
                                  f"{act} bias={bias is not None} "
                                  f"residual={res is not None}: max err "
                                  f"{err.max().item():.3g}")
                            max_err = max(max_err, err.max().item())
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
    err = (got - ref).abs()
    check(bool((err <= KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * ref.abs()).all()),
          f"odd-K int4 linear vs plain: max err {err.max().item():.3g}")
    check(bool(torch.allclose(got, overlay, rtol=1e-4, atol=1e-4)),
          f"odd-K int4 linear vs overlay: max err {(got - overlay).abs().max().item():.3g}")
    return err.max().item()


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


def _bound_terms_ms(m, k, n, bits, x_bytes, bias_bytes):
    """(bytes term, operations term) of the least time, in ms: the bytes the
    function must move (codes, scale, x, bias, f32 out, each once) over the
    HBM rate, and its multiply-adds over the f32 rate (data-sheet peaks)."""
    moved = k * n * bits // 8 + 4 * n + m * k * x_bytes + bias_bytes + 4 * m * n
    return moved / HBM_BYTES_PER_S * 1e3, 2 * m * k * n / F32_FLOP_PER_S * 1e3


def _time_ms(calls, reps, graph=True):
    """Mean ms per call over ``reps`` passes through ``calls``, with CUDA
    events, after one warm-up pass.  ``graph=True`` captures one pass in a
    CUDA graph and replays it, so the host's issue rate is out of the
    measurement (device time); ``graph=False`` times the eager Python loop,
    which is what the decode path pays today."""
    for c in calls:
        c()
    torch.cuda.synchronize()
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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def library_calls(x, ws):
    """One PyTorch call per layer computing the int8 kernel's function:
    ``torch._weight_int8pack_mm(x, codes^T, scale)`` = (x @ codes) * scale
    in x's dtype (the scale cast to it), without the bias (wq/wk/wv add it
    in a second call, left out).  The port never calls it.  Checked once
    against the plain version; returns (calls, None), or (None, the error)
    where this PyTorch has no CUDA kernel for it."""
    lib = [(w["codes"].T.contiguous(), w["scale"].reshape(-1).to(x.dtype)) for w in ws]
    try:
        got = torch._weight_int8pack_mm(x, *lib[0]).float()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0]}"
    ref = pim_matvec_plain(x, ws[0]["codes"], ws[0]["scale"], bits=8)
    check(bool(torch.allclose(got, ref, rtol=1e-2, atol=1e-2)),
          f"_weight_int8pack_mm vs plain: max err {(got - ref).abs().max().item():.3g}")
    return [functools.partial(torch._weight_int8pack_mm, x, c, s) for c, s in lib], None


def timings(eng8, eng4, gen):
    """Per-shape times at the path's M = 4 with bf16 inputs, cycling through
    all layers' weights; then one decode step's 196 launches in order."""
    dev, m = gen.device, BATCH
    n_layers = eng8.cfg.n_layers
    rows = []
    step = {"kernel": [], "plain": [], "overlay": [], "library": []}
    step_bytes = step_ops = 0.0
    for eng, bits in ((eng8, 8), (eng4, 4)):
        for group, name, bname in LINEARS:
            lw = eng.params["layers"][group]
            ws = [{k: v[i] for k, v in lw[name].items()} for i in range(n_layers)]
            bs = [None if bname is None else lw[bname][i] for i in range(n_layers)]
            k = ws[0]["codes"].shape[0] * (8 // bits)
            n = ws[0]["codes"].shape[1]
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            calls = {
                "kernel": [functools.partial(pim_matvec, x, w["codes"], w["scale"],
                                             bits=bits, bias=b) for w, b in zip(ws, bs)],
                "plain": [functools.partial(pim_matvec_plain, x, w["codes"], w["scale"],
                                            bits=bits, bias=b) for w, b in zip(ws, bs)],
                "overlay": [functools.partial(torch.matmul, x, common.dq(w, torch.bfloat16))
                            for w in ws],
            }
            lib_err = library_us = None
            if bits == 8:
                calls["library"], lib_err = library_calls(x, ws)
                if calls["library"] is not None:
                    library_us = _time_ms(calls["library"], 20) * 1e3
            by_bytes, by_ops = _bound_terms_ms(m, k, n, bits, 2, 0 if bname is None else 2 * n)
            rows.append({"shape": name, "K": k, "N": n, "bits": bits, "M": m,
                         "kernel_us": _time_ms(calls["kernel"], 20) * 1e3,
                         "bound_us": max(by_bytes, by_ops) * 1e3,
                         "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                         "plain_us": _time_ms(calls["plain"], 5) * 1e3,
                         "overlay_yardstick_us": _time_ms(calls["overlay"], 20) * 1e3,
                         "library_us": library_us, "library_error": lib_err,
                         "kernel_eager_us": _time_ms(calls["kernel"], 5, graph=False) * 1e3})
            if bits == 8:
                for key in step:
                    step[key].append(calls.get(key))
                step_bytes += by_bytes * n_layers
                step_ops += by_ops * n_layers

    n_calls = n_layers * len(LINEARS)

    def step_ms(key, reps, graph=True):  # layer-major, the linears in path order
        order = [step[key][j][i] for i in range(n_layers) for j in range(len(LINEARS))]
        return _time_ms(order, reps, graph) * n_calls

    return rows, {
        "per": f"one decode step: {n_calls} launches ({n_layers} layers x "
               f"{len(LINEARS)} linears), M={m}, int8, bf16 x; device time "
               "(CUDA graph replay)",
        "kernel_ms": step_ms("kernel", 20), "plain_ms": step_ms("plain", 5),
        "overlay_ms": step_ms("overlay", 20),
        "library_ms": (None if None in step["library"] else step_ms("library", 20)),
        "kernel_eager_ms": step_ms("kernel", 5, graph=False),
        "bound_ms": max(step_bytes, step_ops),
        "bound_by": "bytes" if step_bytes >= step_ops else "operations"}


if __name__ == "__main__":
    sys.exit(main())

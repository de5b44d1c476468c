#!/usr/bin/env python3
"""Trace a steady window of the port's decode loop on one NVIDIA card.

    python3 decode_trace.py [--steps 8] [--trace build/traces/decode_trace.json]

Full-width qwen2-1.5b (random weights from a seed), int8 weights, batch 4,
128-token prompts, greedy: the configuration ``chip_smoke.py`` drives.
After a prefill and a few warm-up steps it times ``--steps`` decode steps on
the host's clock without the profiler, then the next ``--steps`` under
``torch.profiler`` (CPU and CUDA activity).  From the profiler's Chrome
trace it counts, per decode step, the device's kernels, its busy time (the
union of kernel, memcpy and memset intervals) and the host's operator calls,
and ranks the kernels by device time.  Prints one JSON object; exits
non-zero where the trace holds no device activity.  The trace of 8 steps
takes about 50 MB.
"""
import argparse
import collections
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import decode_step, init_cache, init_params, prefill  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

SEED = 20260
BATCH, PROMPT, WARM = 4, 128, 4
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_group(name: str) -> str:
    if "pim_matvec" in name:
        return "pim_matvec"
    if any(t in name.lower() for t in ("gemm", "cutlass", "xmma", "gemv", "cublas")):
        return "cuBLAS (attention einsums, unembed, prefill)"
    return "other (elementwise, reductions, copies)"


def busy_us(events) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if ts + dur <= end:
            continue
        total += ts + dur - max(ts, end)
        end = ts + dur
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace", default=str(Path(__file__).resolve().parent / "build"
                                           / "traces" / "decode_trace.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_trace: no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen2-1.5b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_seq = PROMPT + WARM + 2 * args.steps
    eng = ServingEngine(cfg, init_params(cfg, gen, device=dev), max_seq=max_seq,
                        pim_bits=8, device=dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen, device=dev)
    eng.generate(prompt, 2)  # warm-up: kernel build and load, allocator

    with torch.inference_mode():
        cache = init_cache(cfg, BATCH, max_seq, dev)
        logits, cache = prefill(eng.params, cfg, prompt, cache)
        pos = PROMPT

        def steps(n):
            nonlocal logits, cache, pos
            for _ in range(n):
                tok = logits[:, -1].argmax(dim=-1, keepdim=True)
                logits, cache = decode_step(eng.params, cfg, tok, cache, pos)
                pos += 1

        steps(WARM)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(args.steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / args.steps

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            steps(args.steps)
            torch.cuda.synchronize()
            prof_wall_us = (time.perf_counter() - t0) * 1e6 / args.steps

    out = Path(args.trace)
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    events = [e for e in json.loads(out.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        print("decode_trace: the profiler recorded no device activity", file=sys.stderr)
        return 1
    kernels = [e for e in device if e["cat"] == "kernel"]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    by_group = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        for table, key in ((by_name, e["name"]), (by_group, kernel_group(e["name"]))):
            table[key][0] += 1
            table[key][1] += e["dur"]
    n = args.steps
    busy = busy_us(device) / n
    print(json.dumps({
        "config": f"qwen2-1.5b int8, batch {BATCH}, prompt {PROMPT}, decode steps "
                  f"{PROMPT + WARM}..{PROMPT + WARM + 2 * n - 1}",
        "card": torch.cuda.get_device_name(0),
        "step_wall_us": wall_us,
        "step_wall_us_profiled": prof_wall_us,
        "device_busy_us_per_step": busy,
        "device_busy_share": busy / wall_us,
        "device_busy_share_profiled": busy / prof_wall_us,
        "kernels_per_step": len(kernels) / n,
        "device_events_per_step": len(device) / n,
        "host_ops_per_step": sum(e.get("cat") == "cpu_op" for e in events) / n,
        "cuda_runtime_calls_per_step": sum(e.get("cat") == "cuda_runtime" for e in events) / n,
        "groups": {g: {"kernels_per_step": c / n, "device_us_per_step": t / n}
                   for g, (c, t) in sorted(by_group.items(), key=lambda kv: -kv[1][1])},
        "top_kernels": [{"name": k[:120], "per_step": c / n, "device_us_per_step": t / n}
                        for k, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]],
        "trace": str(out),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

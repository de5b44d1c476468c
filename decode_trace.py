#!/usr/bin/env python3
"""Trace a steady window of the port's decode step on one NVIDIA card, eager
and captured side by side.

    python3 decode_trace.py [--steps 8] [--trace build/traces/decode_trace.json]

Full-width qwen2-1.5b (random weights from a seed), int8 weights, batch 4,
128-token prompts: the configuration ``chip_smoke.py`` drives.  Three ways
to run the same step, ``serving.decode_and_emit``: the eager loop (greedy),
the engine's captured step (one CUDA-graph replay a step, greedy) and the
captured step sampling at temperature 0.8, top-k 50.  Each run starts from
its own prefill and a few warm-up steps.  First ROUNDS rounds of
``--steps`` steps each on the host's clock without the profiler, the three
ways alternating in every round, the SM clock read after each; then one ``torch.profiler`` session
(``repro_torch.tracing``) over ``--steps`` steps of each, one window each.
From its Chrome trace it counts, per decode step and per way, the device's
kernels, its busy time (the union of kernel, memcpy and memset intervals)
and busy share (``tracing.busy_share``: busy time a step over the median
host-clock step of the rounds), the host's operator and CUDA runtime
calls, and ranks the kernels by device time.  Prints one JSON object;
exits non-zero where the trace holds no device activity.  The trace of 8
steps of each takes about 60 MB.
"""
import argparse
import collections
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import DecodeState, ServingEngine, decode_and_emit  # noqa: E402

SEED = 20260
BATCH, PROMPT, WARM, ROUNDS = 4, 128, 4, 4
SAMPLED = {"temperature": 0.8, "top_k": 50, "key": SEED}


def kernel_group(name: str) -> str:
    if "pim_matvec" in name:
        return "pim_matvec"
    if any(t in name.lower() for t in ("gemm", "cutlass", "xmma", "gemv", "cublas")):
        return "cuBLAS (attention einsums, unembed, prefill)"
    return "other (elementwise, reductions, copies)"


def window_report(window: tracing.Window, n: int) -> dict:
    """Per-step counts of one traced window of ``n`` steps."""
    by_name = collections.defaultdict(lambda: [0, 0.0])
    by_group = collections.defaultdict(lambda: [0, 0.0])
    for e in window.device:
        if e["cat"] != "kernel":
            continue
        for table, key in ((by_name, e["name"]), (by_group, kernel_group(e["name"]))):
            table[key][0] += 1
            table[key][1] += e["dur"]
    return {
        "step_wall_us_profiled": window.host_us / n,
        "device_busy_us_per_step": tracing.busy_us(window.device) / n,
        "kernels_per_step": len(window.kernels) / n,
        "device_events_per_step": len(window.device) / n,
        "host_ops_per_step": window.host_ops / n,
        "cuda_runtime_calls_per_step": window.runtime_calls / n,
        "graph_launch_us_per_step_profiled": sum(
            e["dur"] for e in window.host if e["name"] == "cudaGraphLaunch") / n,
        "groups": {g: {"kernels_per_step": c / n, "device_us_per_step": t / n}
                   for g, (c, t) in sorted(by_group.items(), key=lambda kv: -kv[1][1])},
        "top_kernels": [{"name": k[:120], "per_step": c / n, "device_us_per_step": t / n}
                        for k, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace", default=str(Path(__file__).resolve().parent / "build"
                                           / "traces" / "decode_trace.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_trace: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen2-1.5b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_seq = PROMPT + 1 + WARM + args.steps
    eng = ServingEngine(cfg, init_params(cfg, gen, device=dev), max_seq=max_seq,
                        pim_bits=8, device=dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen, device=dev)
    n = args.steps

    with torch.inference_mode():
        eager_st = DecodeState(cfg, BATCH, max_seq, dev)
        ways = {  # (buffers, step, greedy, sampling keywords)
            "eager": (eager_st, functools.partial(decode_and_emit, eng.params, cfg, eager_st,
                                                  greedy=True, top_k=0), True, {}),
            "captured": (eng.state(BATCH), eng.step(BATCH, greedy=True, top_k=0), True, {}),
            "captured_sampled": (eng.state(BATCH), eng.step(BATCH, greedy=False,
                                                            top_k=SAMPLED["top_k"]),
                                 False, SAMPLED),
        }

        def start(way):
            """A prefill and WARM steps: the window's steps are steady ones."""
            st, step, greedy, kw = ways[way]
            st.start(eng.params, cfg, prompt, kw.get("key"), kw.get("temperature", 1.0),
                     greedy=greedy, top_k=kw.get("top_k", 0))
            for _ in range(WARM):
                step()
            torch.cuda.synchronize()

        def steps(way):
            step = ways[way][1]
            for _ in range(n):
                step()
            torch.cuda.synchronize()

        rounds = []
        for _ in range(ROUNDS):
            row = {}
            for way in ways:
                start(way)
                t0 = time.perf_counter()
                steps(way)
                row[way] = (time.perf_counter() - t0) * 1e6 / n
            row["sm_clock_mhz"] = tracing.sm_clock_mhz()
            rounds.append(row)
        try:
            windows = tracing.trace_windows(
                [(way, functools.partial(start, way), functools.partial(steps, way))
                 for way in ways], args.trace)
        except ValueError as err:
            print(f"decode_trace: {err}", file=sys.stderr)
            return 1

    if not all(w.device for w in windows.values()):
        print("decode_trace: the profiler recorded no device activity in a window",
              file=sys.stderr)
        return 1
    report = {}
    for way, window in windows.items():
        wall = sorted(row[way] for row in rounds)[len(rounds) // 2]
        report[way] = window_report(window, n)
        report[way].update(step_wall_us=wall,
                           device_busy_share=tracing.busy_share(window, n, wall))
    print(json.dumps({
        "config": f"qwen2-1.5b int8, batch {BATCH}, prompt {PROMPT}, decode positions "
                  f"{PROMPT + WARM}..{PROMPT + WARM + n - 1} of each way; sampled: "
                  f"temperature {SAMPLED['temperature']}, top-k {SAMPLED['top_k']}",
        "card": smi,
        "step_wall_us_rounds": rounds,
        **report,
        "trace": args.trace,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

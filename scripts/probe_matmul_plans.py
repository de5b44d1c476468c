#!/usr/bin/env python3
"""Time every plan of the port's pim_matmul / bitplane_matmul at
qwen2-1.5b's prefill shapes on one NVIDIA card, beside the planner's choice.

    python3 scripts/probe_matmul_plans.py [--bits 8] [--m 512]

For each of the four weight shapes (K x N: wq/wo, wk/wv, gate/up, down),
bf16 x of M rows and int8 (or int4) codes of a seeded random weight: each
candidate plan (tile height x cluster size) is checked against
``pim_matmul_plain`` (rtol 1e-5, atol 1e-4) and timed with CUDA events over
CUDA-graph replays, cycling through 8 copies of the weight; then
``bitplane_matmul`` with the planner's plan on the weight's planes, which
must equal ``pim_matmul`` bit for bit.  Prints one JSON line per shape, the
planner's plan and the fastest one, and exits non-zero on a failed check.
"""
import argparse
import concurrent.futures
import importlib
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import bitplane, build, ops  # noqa: E402
from repro_torch.quant import quantize_symmetric, to_bitplanes  # noqa: E402

mm = importlib.import_module("repro_torch.kernels.pim_matmul")
SHAPES = {"wq": (1536, 1536), "wk": (1536, 256), "gate": (1536, 8960), "down": (8960, 1536)}
TOL = dict(rtol=1e-5, atol=1e-4)
COPIES = 8


def time_ms(calls, reps=10):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in calls:
            c()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--m", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(build.build, ("pim_matmul", "bitplane_matmul")))
    for lib in libs:
        log = lib.with_name(lib.name + ".log").read_text()
        print("\n".join(line for line in log.splitlines()
                        if "registers" in line or "spill" in line or "Compiling entry" in line))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    for name, (k, n) in SHAPES.items():
        x = torch.randn((args.m, k), generator=gen, device=dev).to(torch.bfloat16)
        ws = [0.02 * torch.randn((k, n), generator=gen, device=dev) for _ in range(COPIES)]
        qs = [ops.quantize_for_pim(w, args.bits) for w in ws]
        chosen = mm.plan(args.m, k, n, args.bits, torch.bfloat16, sms)
        ref = mm.pim_matmul_plain(x, qs[0].codes, qs[0].scale, bits=args.bits)
        times = {}
        for pl in mm.candidates(args.m, k, n):
            # The wrapper with its plan lookup replaced: every check still runs.
            with mock.patch.object(mm, "packed_plan", return_value=pl):
                got = mm.pim_matmul(x, qs[0].codes, qs[0].scale, bits=args.bits)
                torch.cuda.synchronize()
                good = bool(torch.isclose(got, ref, **TOL).all())
                ok &= good
                calls = [lambda q=q: mm.pim_matmul(x, q.codes, q.scale, bits=args.bits)
                         for q in qs]
                times[f"{pl.tile_n}x{pl.tile_m}x{pl.cluster}"] = (time_ms(calls) * 1e3, good,
                                                                  pl.ctas)
        qb = quantize_symmetric(ws[0], args.bits)
        planes = to_bitplanes(qb.codes, args.bits)
        packed = mm.pim_matmul(x, qs[0].codes, qs[0].scale, bits=args.bits)
        bp = bitplane.bitplane_matmul(x, planes, qb.scale)
        torch.cuda.synchronize()
        equal = torch.equal(bp, packed)
        ok &= equal
        plane_sets = [to_bitplanes(quantize_symmetric(w, args.bits).codes, args.bits) for w in ws]
        bp_us = time_ms([lambda p=p: bitplane.bitplane_matmul(x, p, qb.scale)
                         for p in plane_sets]) * 1e3
        best = min(times, key=lambda key: times[key][0])
        print(json.dumps({"shape": name, "K": k, "N": n, "M": args.m, "bits": args.bits,
                          "planner": f"{chosen.tile_n}x{chosen.tile_m}x{chosen.cluster}",
                          "planner_us": times[f"{chosen.tile_n}x{chosen.tile_m}x{chosen.cluster}"][0],
                          "fastest": best, "fastest_us": times[best][0],
                          "bitplane_us": bp_us, "bitplane_equal": equal,
                          "all_us": {key: round(v[0], 2) for key, v in times.items()},
                          "all_ok": all(v[1] for v in times.values()),
                          "max_err": (packed - ref).abs().max().item()}))
    print(f"card: {smi}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

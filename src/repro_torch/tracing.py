"""Windows of one ``torch.profiler`` session on the card, for the port's scripts.

``chip_smoke.py`` and ``decode_trace.py`` both trace short windows of work
(one kernel call, one replay of the captured decode step, a counted
generation) and read, for each window, the kernels the device ran, its busy
time and the host's calls.  A process gets device events from one profiler
session only (a second session may record none), so a script traces all its
windows in one call of ``trace_windows``.  Each window runs between two spin
kernels (``torch.cuda._sleep``) that mark its start and end on the device,
inside a ``record_function`` range that marks it on the host.

The device-busy share of a decode step is ONE number here (``busy_share``):
the union of the step's device intervals in the trace over the host-clock
step time measured without the profiler, in the same process.  Not over the
window's own host range: under the profiler each replay of a captured step
(``cudaGraphLaunch`` of ~2,500 kernel nodes) holds the host for longer than
the step's device time (``decode_trace.py`` reports how long), so a share
within the window measures the profiler's launch cost.
"""
from __future__ import annotations

import bisect
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # the name of torch.cuda._sleep's kernel
SPIN_CYCLES = 1000


@dataclass
class Window:
    """One traced window: ``device`` its device events (kernels, copies,
    sets) between its two markers, ``host`` the host operator and CUDA
    runtime events inside its range, ``host_us`` the range's length."""
    device: list
    host: list
    host_us: float

    @property
    def kernels(self) -> list:
        return [e["name"] for e in self.device if e["cat"] == "kernel"]

    @property
    def host_ops(self) -> int:
        return sum(e["cat"] == "cpu_op" for e in self.host)

    @property
    def runtime_calls(self) -> int:
        return sum(e["cat"] == "cuda_runtime" for e in self.host)


def sm_clock_mhz() -> float:
    """The card's SM clock now, in MHz, as ``nvidia-smi`` reads it: beside a
    host-clock time, it tells a slower card from a slower program."""
    out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip())


def busy_us(events) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if ts + dur <= end:
            continue
        total += ts + dur - max(ts, end)
        end = ts + dur
    return total


def busy_share(window: Window, steps: int, step_us: float) -> float:
    """The device-busy share of a step: ``window``'s device busy time per
    step (it holds ``steps`` steps) over ``step_us``, the host-clock time
    of a step measured without the profiler."""
    return busy_us(window.device) / steps / step_us


def split_windows(events, labels) -> dict:
    """Chrome-trace ``events`` of one session -> {label: Window}, in order:
    the device events between the k-th pair of markers belong to
    ``labels[k]``, the host events to the range ``window <label>``.
    Raises ValueError unless there is one pair of markers per label."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    groups, inside = [], False
    for e in sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"]):
        if MARKER in e["name"]:
            inside = not inside
            if inside:
                groups.append([])
        elif inside:
            groups[-1].append(e)
    if len(groups) != len(labels) or inside:
        raise ValueError(f"the trace holds {len(groups)} marked windows, expected "
                         f"{len(labels)}: the profiler recorded no device events?")
    ranges = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    # the host events sorted by start once, each window's a slice of them
    host_events = sorted((e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")),
                         key=lambda e: e["ts"])
    starts = [e["ts"] for e in host_events]
    out = {}
    for label, device in zip(labels, groups):
        r = ranges[f"window {label}"]
        lo = bisect.bisect_left(starts, r["ts"])
        hi = bisect.bisect_left(starts, r["ts"] + r["dur"])
        out[label] = Window(device, host_events[lo:hi], r["dur"])
    return out


def session_events(results) -> list:
    """A profiler session's events (``prof.profiler.kineto_results``) as
    Chrome-trace events ``{"ph": "X", "cat", "name", "ts", "dur"}`` (µs),
    read without writing the trace (at a million kernels, writing and
    loading the JSON took a minute on the chip's host).  The events carry no
    category on every torch version, so it is told here: a user range by
    its flag, a device event by its device (a copy's name starts with
    "Memcpy", a set's with "Memset", the rest are kernels), a CUDA runtime
    call by its name ("cuda..."), a driver call by its ("cu..." otherwise,
    as ``cuLaunchKernel``), and the profiler's own overhead (no device
    index) is left out; the rest are operators.  These are the categories
    ``export_chrome_trace`` gives the same events."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in results.events():
        name, on_device = e.name(), e.device_type() == cuda
        if e.is_user_annotation():
            cat = "gpu_user_annotation" if on_device else "user_annotation"
        elif on_device:
            cat = ("gpu_memcpy" if name.startswith("Memcpy") else
                   "gpu_memset" if name.startswith("Memset") else "kernel")
        elif e.device_index() < 0:
            continue
        else:
            cat = ("cuda_runtime" if name.startswith("cuda") else
                   "cuda_driver" if name.startswith("cu") else "cpu_op")
        out.append({"ph": "X", "cat": cat, "name": name, "ts": e.start_ns() / 1e3,
                    "dur": e.duration_ns() / 1e3})
    return out


def trace_windows(windows, path=None, times=None) -> dict:
    """One profiler session (CPU and CUDA activity) over ``windows``
    [(label, set-up or None, fn)], in order.  Each set-up runs first,
    outside the window; then ``fn`` runs in the window and is synchronised
    inside it.  With ``path`` the Chrome trace is written there.  Returns
    ``split_windows`` of the session's events.  ``times``, a dict, takes the
    host seconds of each stage: the session (its windows and set-ups, and
    the profiler's stop), the trace's export, reading the events and
    splitting them."""
    times = {} if times is None else times
    t0 = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for label, setup, fn in windows:
            if setup is not None:
                setup()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            with torch.profiler.record_function(f"window {label}"):
                fn()
                torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
    t1 = time.perf_counter()
    if path is not None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
    t2 = time.perf_counter()
    events = session_events(prof.profiler.kineto_results)
    t3 = time.perf_counter()
    out = split_windows(events, [label for label, _, _ in windows])
    times.update(session_s=t1 - t0, export_s=t2 - t1, read_s=t3 - t2,
                 split_s=time.perf_counter() - t3, events=len(events))
    return out

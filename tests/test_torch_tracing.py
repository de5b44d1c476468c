"""``repro_torch.tracing``, the trace reading that ``chip_smoke.py`` and
``decode_trace.py`` share, on hand-made Chrome-trace events: the busy time
is the union of device intervals, and each window gets the device events
between its pair of spin-kernel markers and the host events inside its
range."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402


def _dev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _host(name, ts, dur, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.mark.parametrize("spans, want", [
    ([], 0.0),
    ([(0, 5)], 5.0),
    ([(0, 5), (10, 2)], 7.0),           # disjoint
    ([(0, 5), (3, 5)], 8.0),            # overlapping
    ([(0, 10), (2, 3), (4, 1)], 10.0),  # nested
    ([(5, 5), (0, 5)], 10.0),           # touching, out of order
])
def test_busy_us_is_the_union_of_intervals(spans, want):
    assert tracing.busy_us([{"ts": ts, "dur": dur} for ts, dur in spans]) == want


def test_split_windows_assigns_device_and_host_events():
    spin = tracing.MARKER + "(long)"
    events = [
        _dev(spin, 0, 10), _dev("k_a", 12, 4), _dev("copy", 16, 2, "gpu_memcpy"),
        _dev(spin, 20, 10),
        _dev("outside", 35, 3),
        _dev(spin, 40, 10), _dev("k_b", 52, 6), _dev("k_b", 55, 6), _dev(spin, 70, 10),
        _host("window one", 5, 20, "user_annotation"),
        _host("window two", 45, 30, "user_annotation"),
        _host("aten::add", 6, 1), _host("cudaLaunchKernel", 7, 1, "cuda_runtime"),
        _host("aten::mul", 30, 1),  # between the windows
        {"ph": "i", "cat": "cpu_op", "name": "instant", "ts": 50},
    ]
    got = tracing.split_windows(events, ["one", "two"])
    one, two = got["one"], got["two"]
    assert one.kernels == ["k_a"] and len(one.device) == 2
    assert (one.host_ops, one.runtime_calls, one.host_us) == (1, 1, 20)
    assert tracing.busy_share(one, 2, 6) == 0.5
    assert two.kernels == ["k_b", "k_b"]
    assert (two.host_ops, two.runtime_calls) == (0, 0)
    assert tracing.busy_share(two, 1, 18) == 0.5


@pytest.mark.parametrize("labels, markers", [(["one", "two"], 2), (["one"], 3), (["one"], 0)])
def test_split_windows_refuses_a_wrong_number_of_markers(labels, markers):
    events = [_dev(tracing.MARKER, 10 * i, 1) for i in range(markers)]
    events += [_host(f"window {label}", 0, 100, "user_annotation") for label in labels]
    with pytest.raises(ValueError, match="marked windows"):
        tracing.split_windows(events, labels)


class _Kineto:
    """A stand-in for a profiler result's event (``_KinetoEvent``)."""

    def __init__(self, name, device, ts_ns, dur_ns, user=False, index=0):
        self._v = (name, device, ts_ns, dur_ns, user, index)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def device_index(self):
        return self._v[5]


def test_session_events_tell_each_category_and_split_as_the_chrome_trace():
    """The profiler's events read without a Chrome trace: kernels, copies and
    sets on the device, the user ranges, CUDA runtime and driver calls and
    operators on the host, the profiler's overhead (no device index) left
    out; split into windows they give what the same events in Chrome form
    give (a driver call is not among a window's host events)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spin = tracing.MARKER + "(long)"
    results = type("R", (), {"events": lambda self: [
        _Kineto(spin, cuda, 0, 10_000), _Kineto("k_a", cuda, 12_000, 4_000),
        _Kineto("Memcpy DtoH (Device -> Pageable)", cuda, 16_000, 2_000),
        _Kineto("Memset (Device)", cuda, 18_000, 1_000), _Kineto(spin, cuda, 20_000, 10_000),
        _Kineto("window one", cpu, 5_000, 20_000, user=True),
        _Kineto("window one", cuda, 12_000, 7_000, user=True),
        _Kineto("aten::add", cpu, 6_000, 1_000), _Kineto("cudaGraphLaunch", cpu, 7_000, 1_000),
        _Kineto("cuLaunchKernel", cpu, 7_500, 500),
        _Kineto("Buffer Flush", cpu, 8_000, 1_000, index=-1)]})()
    events = tracing.session_events(results)
    assert [(e["cat"], e["name"]) for e in events] == [
        ("kernel", spin), ("kernel", "k_a"), ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)"),
        ("gpu_memset", "Memset (Device)"), ("kernel", spin), ("user_annotation", "window one"),
        ("gpu_user_annotation", "window one"), ("cpu_op", "aten::add"),
        ("cuda_runtime", "cudaGraphLaunch"), ("cuda_driver", "cuLaunchKernel")]
    assert events[1]["ts"] == 12.0 and events[1]["dur"] == 4.0
    one = tracing.split_windows(events, ["one"])["one"]
    assert one.kernels == ["k_a"] and len(one.device) == 3
    assert (one.host_ops, one.runtime_calls, one.host_us) == (1, 1, 20)


def test_session_events_match_the_chrome_trace_of_a_real_session(tmp_path):
    """A real profiler session on the CPU: every event ``session_events``
    reads has the category, name and length that ``export_chrome_trace``
    gives it, and the Chrome trace holds no other event (its own
    ``Trace`` span aside)."""
    import json

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("window one"):
            x = torch.randn(8, 8)
            torch.softmax(x @ x, dim=-1).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    chrome = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") != "Trace"), key=lambda e: e["ts"])
    ours = sorted(tracing.session_events(prof.profiler.kineto_results), key=lambda e: e["ts"])
    assert {e["cat"] for e in ours} == {"cpu_op", "user_annotation"}
    assert [(e["cat"], e["name"]) for e in ours] == [(e["cat"], e["name"]) for e in chrome]
    assert [e["dur"] for e in ours] == pytest.approx([e["dur"] for e in chrome], abs=1e-3)

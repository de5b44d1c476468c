"""``repro_torch.tracing``, the trace reading that ``chip_smoke.py`` and
``decode_trace.py`` share, on hand-made Chrome-trace events: the busy time
is the union of device intervals, and each window gets the device events
between its pair of spin-kernel markers and the host events inside its
range."""
import pytest

pytest.importorskip("torch")

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

"""The engines' CUDA-graph capture pauses Python's cycle collector: a graph
that a collected cycle frees while another graph is being captured
invalidates that capture on the card (``cudaErrorStreamCaptureInvalidated``),
and ``torch.cuda.graph`` does not collect before it begins.  The capture
itself runs on the card only; here ``torch.cuda.graph`` and ``CUDAGraph``
are stand-ins that record the collector's state."""
import contextlib
import gc

import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving.engine import CapturedSteps, gc_paused  # noqa: E402


@pytest.fixture
def fake_capture(monkeypatch):
    class Graph:
        pass

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        assert isinstance(g, Graph)
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)


@pytest.mark.parametrize("enabled", [True, False])
def test_capture_runs_with_the_collector_paused_and_restores_it(fake_capture, enabled):
    seen = []
    prev = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        steps = CapturedSteps(torch.device("cpu"))
        steps._capture(lambda: seen.append(gc.isenabled()), None)
        assert seen == [False] and gc.isenabled() == enabled
        with pytest.raises(RuntimeError):
            with gc_paused():
                raise RuntimeError("a failed capture")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if prev else gc.disable)()

"""Port parity, the paper's analytical models and tables: ``repro_torch.core``'s
``costmodel``, ``devices``, ``archmodels`` and ``scalability`` against
``repro.core``'s, and the port's ``paper_tables`` and ``array_demo`` against
the JAX package's ``benchmarks/paper_tables.py`` and
``examples/pim_array_demo.py``, on the CPU.

The models are the same plain Python in both packages, so every value,
floats included, must be equal (``==``).  The tables' rows must carry the
same names and ``derived`` values; ``us_per_call`` is each package's own
timing and is not compared.
"""
import contextlib
import dataclasses
import importlib.util
import io
import math
from pathlib import Path

import pytest
from hypothesis import given, strategies as st

pytest.importorskip("torch")

from repro.core import archmodels as jarch  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core import devices as jdev  # noqa: E402
from repro.core import scalability as jscale  # noqa: E402
from repro_torch.core import archmodels, array_demo, costmodel as cm, devices  # noqa: E402
from repro_torch.core import paper_tables, scalability  # noqa: E402
from torch_helpers import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = (1, 2, 3, 4, 5, 8, 12, 16, 21, 24, 32, 40, 64)
QS = (1, 2, 3, 16, 17, 32, 48, 64, 100, 128, 1024, 4096, 32_768, 64_512, 65_536)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["costmodel", "devices", "archmodels", "scalability"])
def test_plain_python_modules_are_the_references_copies(name):
    """The models are copied as they are: the same source, byte for byte."""
    port = (ROOT / "src" / "repro_torch" / "core" / f"{name}.py").read_bytes()
    assert port == (ROOT / "src" / "repro" / "core" / f"{name}.py").read_bytes()


def test_costmodel_functions_over_a_grid():
    for x in QS + WIDTHS:
        assert cm.log2i(x) == jcm.log2i(x)
    for n in WIDTHS:
        for fn in ("add_sub_cycles", "mult_cycles_overlay", "mult_cycles_overlay_booth_avg",
                   "mult_cycles_custom", "mac16_cycles_custom", "mac16_cycles_mod"):
            assert getattr(cm, fn)(n) == getattr(jcm, fn)(n), (fn, n)
        for booth_avg in (False, True):
            assert cm.mac16_cycles_overlay(n, booth_avg) == jcm.mac16_cycles_overlay(n, booth_avg)
        for q in QS:
            for fn in ("accum_cycles_spar2", "accum_cycles_picaso", "accum_cycles_custom",
                       "accum_cycles_picaso_block", "accum_cycles_amod"):
                assert getattr(cm, fn)(q, n) == getattr(jcm, fn)(q, n), (fn, q, n)
            for booth_avg in (False, True):
                assert cm.matvec_cycles_overlay(q, n, booth_avg) == \
                    jcm.matvec_cycles_overlay(q, n, booth_avg)
    assert cm.BLOCK == jcm.BLOCK == 16


def _device_fields(d):
    return (dataclasses.astuple(d), d.luts, d.ffs, d.slices, d.bram18, d.max_pes)


def test_devices_table_vii_and_the_evaluation_parts():
    assert list(devices.ALL_DEVICES) == list(jdev.ALL_DEVICES)
    for key, d in devices.ALL_DEVICES.items():
        assert _device_fields(d) == _device_fields(jdev.ALL_DEVICES[key]), key
    assert list(devices.TABLE_VII) == list(jdev.TABLE_VII)
    assert _device_fields(devices.ALVEO_U55) == _device_fields(jdev.ALVEO_U55)
    assert _device_fields(devices.VIRTEX7_485) == _device_fields(jdev.VIRTEX7_485)
    assert devices.ALVEO_U55.max_pes == 64_512


def _arch_fields(a):
    plain = [getattr(a, f.name) for f in dataclasses.fields(a)
             if f.name not in ("mult_cycles", "accum_cycles")]
    mult = [a.mult_cycles(n) for n in WIDTHS]
    accum = [a.accum_cycles(q, n) for q in QS for n in WIDTHS]
    per_device = [(a.fmax(d), a.mac16_latency_us(n, d, b), a.peak_tmacs(n, d, b))
                  for d in devices.ALL_DEVICES.values() for n in (4, 8, 16, 32)
                  for b in (False, True)]
    eff = [a.memory_efficiency(n) for n in WIDTHS]
    return plain, a.mult_cycles.__name__, a.accum_cycles.__name__, mult, accum, per_device, eff


def test_archmodels_every_arch_and_table_iv():
    assert list(archmodels.ARCHS) == list(jarch.ARCHS)
    for name, arch in archmodels.ARCHS.items():
        assert _arch_fields(arch) == _arch_fields(jarch.ARCHS[name]), name
    assert _arch_fields(archmodels.SPAR2) == _arch_fields(jarch.SPAR2)
    assert list(archmodels.TABLE_IV) == list(jarch.TABLE_IV)
    for key, cfg in archmodels.TABLE_IV.items():
        ref = jarch.TABLE_IV[key]
        assert dataclasses.astuple(cfg) == dataclasses.astuple(ref), key
        assert (cfg.lut_block, cfg.ff_block, cfg.slice_block) == (
            ref.lut_block, ref.ff_block, ref.slice_block)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_fig5_fig6_fig7_tables(n):
    for dev in devices.ALL_DEVICES.values():
        assert archmodels.relative_mac_latency(n, dev) == jarch.relative_mac_latency(n, dev)
        assert archmodels.peak_throughput_table(n, dev) == jarch.peak_throughput_table(n, dev)
    assert archmodels.relative_mac_latency(n) == jarch.relative_mac_latency(n)
    assert archmodels.peak_throughput_table(n) == jarch.peak_throughput_table(n)
    assert archmodels.memory_efficiency_table(n) == jarch.memory_efficiency_table(n)


def test_max_array_and_scaling_study_over_all_devices():
    for key, dev in devices.ALL_DEVICES.items():
        for overlay in ("picaso", "spar2"):
            assert dataclasses.astuple(scalability.max_array(overlay, dev)) == \
                dataclasses.astuple(jscale.max_array(overlay, jdev.ALL_DEVICES[key]))
    got = scalability.scaling_study(devices.ALL_DEVICES)
    want = jscale.scaling_study(jdev.ALL_DEVICES)
    assert {k: {o: dataclasses.astuple(r) for o, r in v.items()} for k, v in got.items()} == \
        {k: {o: dataclasses.astuple(r) for o, r in v.items()} for k, v in want.items()}
    u55 = scalability.max_array("picaso", devices.ALVEO_U55)
    assert (u55.tiles, u55.pes) == (252, 64_512)


# ---- the reference's property tests (tests/test_core_property.py), on the port's copies
QPOW = st.integers(1, 6).map(lambda e: 2 ** (e + 4))
NS = st.sampled_from([4, 8, 16, 32])


@given(q=QPOW, n=NS)
def test_picaso_accumulation_never_slower_than_spar2(q, n):
    assert cm.accum_cycles_picaso(q, n) < cm.accum_cycles_spar2(q, n)


@given(q=QPOW, n=NS)
def test_amod_accum_faster_than_custom(q, n):
    assert cm.accum_cycles_amod(q, n) < cm.accum_cycles_custom(q, n)


@given(n=NS)
def test_memory_efficiency_ordering(n):
    a = archmodels.ARCHS
    assert (a["CCB"].memory_efficiency(n) < a["CoMeFa-A"].memory_efficiency(n)
            < a["A-Mod"].memory_efficiency(n) <= a["PiCaSO-F"].memory_efficiency(n))


@given(n=NS)
def test_accum_formulas_positive_monotone(n):
    cycles = [cm.accum_cycles_picaso(q, n) for q in (16, 32, 64, 128, 256)]
    assert 0 < cycles[0] and all(a < b for a, b in zip(cycles, cycles[1:]))


# ----------------------------------------------------------- paper tables ----
@pytest.fixture(scope="module")
def reference_rows():
    """The JAX package's rows, one run of each function (its table 5 runs
    the JAX simulator three times)."""
    ref = _load(ROOT / "benchmarks" / "paper_tables.py", "reference_paper_tables")
    assert [f.__name__ for f in ref.ALL] == [f.__name__ for f in paper_tables.ALL]
    return {f.__name__: f() for f in ref.ALL}


@pytest.mark.parametrize("fn", paper_tables.ALL, ids=lambda f: f.__name__)
def test_paper_tables_rows_equal_the_reference(reference_rows, fn):
    rows = fn(device="cpu")
    want = reference_rows[fn.__name__]
    assert [(name, derived) for name, _, derived in rows] == \
        [(name, derived) for name, _, derived in want]
    assert [type(d) for _, _, d in rows] == [type(d) for _, _, d in want]
    assert all(isinstance(us, float) and math.isfinite(us) and us >= 0 for _, us, _ in rows)


def test_paper_tables_csv_main():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        paper_tables.main(["--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert len(lines) == 1 + sum(len(f(device="cpu")) for f in paper_tables.ALL)
    assert "table5/sim_dot64_correct," in out.getvalue()


def test_array_demo_prints_the_reference_examples_values():
    ref = _load(ROOT / "examples" / "pim_array_demo.py", "reference_pim_array_demo")
    want, got = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(want):
        ref.main()
    with contextlib.redirect_stdout(got):
        array_demo.main(device="cpu")
    body, note = got.getvalue().rsplit("\n\n", 1)
    assert body + "\n" == want.getvalue()
    assert "not a measurement" in note

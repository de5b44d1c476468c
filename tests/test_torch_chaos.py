"""Port parity, no model: the resilience tier's host-side pieces against the
JAX package's (``repro.serving.chaos``, ``repro.serving.resilience``,
``repro.runtime.fault``).

The same ``ChaosConfig`` must fire at the same calls of every site, with
rates and with scripts, so a chaos trace means the same thing in both
packages; the degradation ladder must walk the same rungs on the same
bad/clean rounds; the heartbeat monitor must sweep and revive alike; and a
snapshot's JSON must be byte-equal, so a file written by either package
resumes in the other.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.runtime import fault as jax_fault  # noqa: E402
from repro.serving import chaos as jax_chaos  # noqa: E402
from repro.serving import resilience as jax_res  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from repro_torch.serving import chaos, resilience  # noqa: E402

from torch_helpers import jax_maps_bounded  # noqa: E402,F401

CONFIGS = {
    "rates": dict(seed=3, fault_rate=0.3, crash_rate=0.1, straggle_rate=0.4, straggle_s=0.2,
                  squeeze_rate=0.5, squeeze_frac=0.3, corrupt_rate=0.25),
    "scripts": dict(fault_rounds=(2, 5), crash_rounds=(1,), straggle_rounds=(0, 3, 4),
                    squeeze_rounds=(2,), corrupt_rids=(1, 6)),
    "capped": dict(seed=9, fault_rate=0.6, straggle_rate=0.6, squeeze_rate=0.6,
                   corrupt_rate=0.6, max_faults=5, crash_rounds=(7,)),
}


def _drive(mod, cfg_kw, rounds=40):
    """Every site of an injector of ``mod`` called as an engine calls them,
    round by round; returns (what each call gave, the log, the counts)."""
    inj = mod.FaultInjector(mod.ChaosConfig(**cfg_kw))
    calls = []
    for rnd in range(rounds):
        for site, call in (("crash", lambda: inj.crash(rnd)),
                           ("chunk", lambda: inj.chunk_fault(rnd))):
            try:
                call()
                calls.append((site, rnd, None))
            except (mod.ChunkFault, mod.EngineCrash) as e:
                calls.append((site, rnd, type(e).__name__, str(e)))
        calls.append(("straggle", rnd, inj.chunk_latency(rnd)))
        calls.append(("squeeze", rnd, inj.squeeze_pages(rnd % 9, rnd)))
        prompt = np.arange(5 + rnd % 4, dtype=np.int32)
        calls.append(("corrupt", rnd, inj.corrupt_request(prompt, rnd % 8, rnd).tolist()))
    log = [dataclasses.astuple(f) for f in inj.log]
    return calls, log, inj.counts


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_injector_fires_as_jax_does(name):
    got = _drive(chaos, CONFIGS[name])
    want = _drive(jax_chaos, CONFIGS[name])
    assert got == want
    assert got[2], "nothing fired: the case checks nothing"
    if name == "capped":
        assert sum(got[2].values()) <= 5 + 1  # the cap, and the scripted crash past it


def test_injector_streams_are_independent_and_reset_log_keeps_them():
    cfg = chaos.ChaosConfig(seed=3, fault_rate=0.3, straggle_rate=0.3)

    def fired(n_straggle):
        inj = chaos.FaultInjector(cfg)
        out = []
        for rnd in range(50):
            try:
                inj.chunk_fault(rnd)
            except chaos.ChunkFault:
                out.append(rnd)
            for _ in range(n_straggle):
                inj.chunk_latency(rnd)
        return out, inj

    (a, inj), (b, _) = fired(1), fired(5)
    assert a == b and a
    inj.reset_log()
    assert inj.log == [] and inj.counts == {}
    assert inj._calls["chunk"] == 50  # the streams go on where they were


def test_virtual_clock():
    for mod in (chaos, jax_chaos):
        clk = mod.VirtualClock(2.0)
        assert clk() == 2.0
        assert clk.advance(1.5) == 3.5 and clk() == 3.5
        with pytest.raises(ValueError, match="forward"):
            clk.advance(-1.0)


@pytest.mark.parametrize("has_spec", [False, True])
@pytest.mark.parametrize("ladder_kw", [dict(cooldown=2), dict(cooldown=1), dict(enabled=False)])
def test_ladder_walks_as_jax_does(has_spec, ladder_kw):
    rng = np.random.default_rng(4)
    bads = [True, True, False, True, True, True, True, False, False, False,
            *rng.random(30).tolist()]
    ladders = [mod.DegradationLadder(mod.LadderConfig(**ladder_kw), has_spec=has_spec)
               for mod in (resilience, jax_res)]
    for rnd, b in enumerate(bads):
        bad = b if isinstance(b, bool) else b < 0.5
        seen = []
        for lad in ladders:
            lad.update(rnd, bad, "straggle" if bad else "")
            seen.append((lad.level, lad.active(), lad.params(8, 4 if has_spec else None),
                         lad.shedding()))
        assert seen[0] == seen[1], rnd
    assert ladders[0].trace == ladders[1].trace
    assert ladders[0].actions == ladders[1].actions
    if ladder_kw.get("enabled", True):
        assert any(r == "recovered" for _, _, r in ladders[0].trace)
        assert max(lvl for _, lvl, _ in ladders[0].trace) == ladders[0].max_level


def test_policy_defaults_and_resume_mode():
    assert dataclasses.asdict(resilience.ResiliencePolicy()) == dataclasses.asdict(
        jax_res.ResiliencePolicy())
    assert dataclasses.asdict(resilience.LadderConfig()) == dataclasses.asdict(
        jax_res.LadderConfig())
    with pytest.raises(ValueError, match="resume_mode"):
        resilience.ResiliencePolicy(resume_mode="replay")


def test_heartbeat_monitor_sweeps_and_revives_as_jax_does():
    runs = []
    for fmod, cmod in ((fault, chaos), (jax_fault, jax_chaos)):
        clk = cmod.VirtualClock()
        mon = fmod.HeartbeatMonitor(3, timeout_s=5.0, clock=clk)
        seen = []
        for t in range(12):
            clk.advance(1.0)
            mon.beat(0)
            if t < 4:
                mon.beat(1)
            if t == 10:
                mon.revive(1)
            seen.append((mon.sweep(), sorted(mon.dead), mon.healthy))
        mon.beat(2)  # a dead host's beat is ignored
        seen.append((dict(mon.last_seen), sorted(mon.dead)))
        runs.append(seen)
    assert runs[0] == runs[1]
    assert runs[0][5][0] == [2] and runs[0][9][0] == [1] and runs[0][10][1] == [2]
    ev = fault.FailureEvent(0, 3, "crash:x")
    assert dataclasses.astuple(ev) == dataclasses.astuple(jax_fault.FailureEvent(0, 3, "crash:x"))


def _snapshot(mod):
    return mod.ServeSnapshot(
        finished={0: [5, 6, 7], 3: [1]},
        inflight={2: mod.InflightState(emitted=[9, 8], wctr=0, t_admit=0.25, t_first=0.25,
                                       acc_ema=0.0),
                  4: mod.InflightState(emitted=[3], t_admit=None)},
        queued=[5, 1], closed={6: ("shed", "deadline"), 7: ("rejected", "corrupt")}, round=4)


def test_snapshot_json_is_jax_s_and_files_load_across_packages(tmp_path):
    ours, theirs = _snapshot(resilience), _snapshot(jax_res)
    assert ours.to_json() == theirs.to_json()
    for writer, reader, name in ((resilience, jax_res, "a"), (jax_res, resilience, "b")):
        path = str(tmp_path / f"{name}.snap")
        writer.save_snapshot(path, _snapshot(writer))
        back = reader.load_snapshot(path)
        assert back.to_json() == ours.to_json()
        assert back.inflight[2].emitted == [9, 8] and back.closed[6] == ("shed", "deadline")
    assert resilience.load_snapshot(str(tmp_path / "missing.snap")) is None
    assert not (tmp_path / "a.snap.tmp").exists()


def test_report_attainment_and_goodput():
    recs = [resilience.RequestRecord(status="done", tokens=np.zeros(4, np.int32)),
            resilience.RequestRecord(status="done", tokens=np.zeros(3, np.int32),
                                     met_deadline=False),
            resilience.RequestRecord(status="done", tokens=np.zeros(2, np.int32),
                                     met_deadline=True),
            resilience.RequestRecord(status="shed", tokens=np.zeros(1, np.int32))]
    rep = resilience.ServeReport(records=recs)
    assert rep.slo_attainment() == 0.5 and rep.goodput_tokens() == 6
    assert resilience.ServeReport().slo_attainment() == 1.0
    fields = {f.name for f in dataclasses.fields(jax_res.ServeReport)}
    assert {f.name for f in dataclasses.fields(resilience.ServeReport)} == fields

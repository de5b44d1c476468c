"""Serving-tier resilience: the SLO policy, the degradation ladder, crash
replay snapshots and the restart supervisor (twin of
``repro.serving.resilience``).

This module is the host-side half of fault-tolerant serving; the engine
half is ``ContinuousBatchingEngine.serve_detailed`` (``serving.engine``),
which consults a ``ResiliencePolicy`` at every scheduling boundary and
returns a ``ServeReport``.  Nothing here touches the device: resilience is
scheduling, and the (request id, counter) draw keys (``serving.sampling``)
make a replayed request's token stream the undisturbed run's.

Failure semantics:

* **Retried**: transient chunk faults (``chaos.ChunkFault``), raised before
  any chunk step of the round runs.  The engine backs off (clock skew, no
  real sleep under a virtual clock) and tries the same chunk again, up to
  ``max_retries`` times; past that the round is an engine crash.
* **Shed**: queued requests past their deadline (``shed_expired``), queue
  overflow beyond ``max_queue`` (lowest SLO class first, the youngest
  breaking ties), requests that can never fit the page pool (``"oom"``),
  and at the ladder's top rung queued requests below ``protect_slo``.  A
  shed request keeps the tokens it emitted; running requests are not shed.
* **Rejected**: invalid payloads (corrupt token ids, empty prompts, budgets
  past ``max_seq``) get status ``"rejected"``.  Without a policy the engine
  raises instead.
* **Degraded**: the ladder trades throughput for stability one rung at a
  time: a speculating engine first halves its window (``halve_k``), then
  stops speculating (``no_spec``, plain chunks that keep the n-gram history
  warm); every engine then halves its chunk (``halve_chunk``, the host
  regains control twice as often) and sheds below ``protect_slo``
  (``shed_low_slo``).  Greedy tokens are the same at every rung.
* **Replayed**: after a crash the supervisor restores the last
  ``ServeSnapshot`` and the engine re-admits each in-flight request by one
  prefill over ``prompt + emitted[:-1]``, its draw counter resumed at
  ``len(emitted)`` (``resume_mode="prefill"``), or requeues it from scratch
  (``"recompute"``, as recompute preemption does).  Recompute replays the
  decode arithmetic bit for bit.  Prefill replay computes the emitted
  tokens' K/V with the prefill's arithmetic where the undisturbed run
  decoded them, so on the card (bf16, where the two round differently) its
  later tokens agree with the undisturbed run's up to near-ties; on the
  CPU in f32 they agree with the JAX package's within its tolerance.

Each bad round (retries, preemptions, sheds, page pressure, a straggler)
escalates the ladder one rung; ``cooldown`` clean rounds in a row
de-escalate it one.  ``ServingSupervisor`` detects a crash through a
``runtime.fault.HeartbeatMonitor`` that the engine beats every round.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np

from repro_torch.runtime.fault import FailureEvent, HeartbeatMonitor

from .chaos import EngineCrash, FaultInjector, VirtualClock


# ------------------------------------------------------------------ policy --
@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """Degradation-ladder tuning; the rungs are in the module docstring."""

    enabled: bool = True
    cooldown: int = 3           # clean rounds before de-escalating one rung
    free_frac: float = 0.125    # free-page fraction that counts as pressure
    protect_slo: int = 1        # the top rung sheds queued requests below this


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Request-level robustness for ``serve_detailed``.  The default is safe
    everywhere: validation on, a few retries, the ladder on, an unbounded
    queue, a snapshot every round."""

    max_retries: int = 3          # transient-fault retries of one chunk
    backoff_s: float = 0.01       # base backoff (doubles per attempt)
    max_queue: Optional[int] = None  # bounded admission queue (None: off)
    shed_expired: bool = True     # shed queued requests past their deadline
    validate: bool = True         # admission payload validation
    ladder: LadderConfig = LadderConfig()
    snapshot_every: int = 1       # rounds between snapshots (0: off)
    snapshot_sink: Optional[Callable] = None  # called with each ServeSnapshot
    resume_mode: str = "prefill"  # "prefill" (re-admit mid-stream) or "recompute"
    round_time: float = 0.0       # virtual seconds a round (deterministic deadlines)

    def __post_init__(self):
        if self.resume_mode not in ("prefill", "recompute"):
            raise ValueError(f"resume_mode {self.resume_mode!r}")


# ------------------------------------------------------------------ report --
@dataclasses.dataclass
class RequestRecord:
    """Outcome of one request: ``status`` is ``"done"`` (full budget or stop
    token), ``"shed"`` (with the tokens emitted before) or ``"rejected"``.
    Times are engine-clock seconds from serve start, skew included;
    ``met_deadline`` is None when the request had no deadline.  ``slot`` is
    the batch slot it last occupied; ``events`` its span events, dicts of
    ``{"name", "ts", ...}``: ``admit`` (slot, round, cached/prefilled
    tokens, cow), ``decode`` (one per round it was live in: dur, round,
    tokens), ``preempt`` (slot), ``shed`` (reason), ``finish`` (tokens)."""

    status: str = "pending"
    reason: str = ""
    tokens: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    met_deadline: Optional[bool] = None
    slot: Optional[int] = None
    events: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeReport:
    """Everything ``serve_detailed`` observed: per-request outcomes, the
    resilience counters, one counter sample per round that ran a chunk
    (free, retained and in-use pages, prefix-hit tokens so far, the
    round's speculation width ``eff_k`` (0 for plain steps), the queue,
    retries so far) and the prefix cache's counters."""

    records: list = dataclasses.field(default_factory=list)
    rounds: int = 0
    retries: int = 0
    straggle_s: float = 0.0
    squeezed_pages: int = 0
    sheds: int = 0
    rejects: int = 0
    restarts: int = 0           # filled by the supervisor
    failures: list = dataclasses.field(default_factory=list)
    ladder_trace: list = dataclasses.field(default_factory=list)  # (round, rung, reason)
    max_ladder_level: int = 0
    counters: list = dataclasses.field(default_factory=list)
    prefix_hits: int = 0        # admits served (partly) from the prefix trie
    prefix_hit_tokens: int = 0  # prompt tokens aliased instead of prefilled
    prefill_tokens: int = 0     # prompt tokens computed by the admits
    cow_forks: int = 0          # copy-on-write page forks
    evictions: int = 0          # retained cache pages evicted under pressure

    @property
    def outputs(self) -> list[np.ndarray]:
        return [r.tokens for r in self.records]

    def done(self) -> list[int]:
        return [i for i, r in enumerate(self.records) if r.status == "done"]

    def latencies(self) -> list[float]:
        """Completion time (serve start to last token) per done request,
        interpolated within a round to the chunk iteration the request's
        slot last emitted in."""
        return [r.t_done for r in self.records if r.status == "done" and r.t_done is not None]

    def slo_attainment(self) -> float:
        """Fraction of requests that finished and met their deadline (no
        deadline counts as met; shed and rejected as missed)."""
        if not self.records:
            return 1.0
        met = sum(1 for r in self.records
                  if r.status == "done" and r.met_deadline in (True, None))
        return met / len(self.records)

    def goodput_tokens(self) -> int:
        """Tokens of requests that finished within their deadline."""
        return sum(len(r.tokens) for r in self.records
                   if r.status == "done" and r.met_deadline in (True, None))


# ---------------------------------------------------------------- snapshot --
@dataclasses.dataclass
class InflightState:
    """Replay state of one in-flight request: its emissions so far (the
    prompt is in the request list; the token draw counter is
    ``len(emitted)``), its admit times, and the speculative window's draw
    counter ``wctr`` and the adaptive controller's acceptance estimate
    ``acc_ema``, both as the engine holds them (0 and 0.0 without
    speculation), so a snapshot reads the same in both packages."""

    emitted: list
    wctr: int = 0
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    acc_ema: float = 0.5


@dataclasses.dataclass
class ServeSnapshot:
    """Host-side request state at a round boundary: no device buffers and no
    pages (a resumed admit recomputes them).  JSON, so a supervisor can
    keep it across the death of the process (``save_snapshot``)."""

    finished: dict      # ridx -> [tokens] of completed requests
    inflight: dict      # ridx -> InflightState, in admit order
    queued: list        # ridx, FIFO order
    closed: dict        # ridx -> (status, reason) of shed and rejected ones
    round: int = 0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["finished"] = {str(k): [int(t) for t in v] for k, v in d["finished"].items()}
        d["inflight"] = {str(k): v for k, v in d["inflight"].items()}
        d["closed"] = {str(k): list(v) for k, v in d["closed"].items()}
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "ServeSnapshot":
        d = json.loads(s)
        return cls(finished={int(k): [int(t) for t in v] for k, v in d["finished"].items()},
                   inflight={int(k): InflightState(**v) for k, v in d["inflight"].items()},
                   queued=[int(r) for r in d["queued"]],
                   closed={int(k): tuple(v) for k, v in d["closed"].items()},
                   round=int(d["round"]))


def save_snapshot(path: str, snap: ServeSnapshot) -> None:
    """Write a snapshot atomically (a temporary file, fsync, ``os.replace``),
    so a crash mid-write never corrupts the recovery point."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(snap.to_json())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_snapshot(path: str) -> Optional[ServeSnapshot]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return ServeSnapshot.from_json(f.read())


# ------------------------------------------------------------------ ladder --
class DegradationLadder:
    """Escalate on bad rounds, de-escalate after ``cooldown`` clean ones.
    ``params(chunk, k)`` maps the rung onto the round's chunk and
    speculation width; the speculation rungs exist only for an engine that
    speculates."""

    def __init__(self, cfg: LadderConfig, *, has_spec: bool):
        self.cfg = cfg
        self.level = 0
        self._clean = 0
        self.actions = (["halve_k", "no_spec"] if has_spec else []) + ["halve_chunk",
                                                                       "shed_low_slo"]
        self.trace: list = []

    @property
    def max_level(self) -> int:
        return len(self.actions)

    def active(self) -> list:
        return self.actions[: self.level]

    def update(self, rnd: int, bad: bool, reason: str = "") -> None:
        if not self.cfg.enabled:
            return
        if bad:
            self._clean = 0
            if self.level < self.max_level:
                self.level += 1
                self.trace.append((rnd, self.level, reason))
        else:
            self._clean += 1
            if self.level > 0 and self._clean >= self.cfg.cooldown:
                self.level -= 1
                self._clean = 0
                self.trace.append((rnd, self.level, "recovered"))

    def params(self, chunk: int, k: Optional[int]):
        """(effective chunk, effective k); a None k means no speculation."""
        active = self.active()
        if k is not None:
            if "no_spec" in active:
                k = None
            elif "halve_k" in active:
                k = max(1, k // 2)
        if "halve_chunk" in active:
            chunk = max(1, chunk // 2)
        return chunk, k

    def shedding(self) -> bool:
        return "shed_low_slo" in self.active()


# -------------------------------------------------------------- supervisor --
class ServingSupervisor:
    """Restart loop for a crashing ``ContinuousBatchingEngine``: run
    ``serve_detailed``; on ``EngineCrash``, advance the shared clock past the
    heartbeat timeout so the monitor's ``sweep`` sees the engine dead,
    record the ``FailureEvent``, ``revive`` the host, restore the engine's
    last snapshot and serve again from it.  ``snapshot_path`` also writes
    every snapshot to disk, and ``run`` starts from that file when it
    exists, so a fresh engine object can resume a trace whose engine died."""

    def __init__(self, engine, *, policy: Optional[ResiliencePolicy] = None,
                 chaos: Optional[FaultInjector] = None,
                 monitor: Optional[HeartbeatMonitor] = None,
                 clock: Optional[VirtualClock] = None, max_restarts: int = 8,
                 snapshot_path: Optional[str] = None):
        self.engine = engine
        self.policy = policy or ResiliencePolicy()
        self.chaos = chaos
        self.clock = clock or VirtualClock()
        self.monitor = monitor or HeartbeatMonitor(1, timeout_s=30.0, clock=self.clock)
        self.max_restarts = max_restarts
        self.snapshot_path = snapshot_path
        self.restarts = 0
        self.failures: list[FailureEvent] = []

    def _beat(self) -> None:
        self.monitor.beat(0)

    def run(self, requests, **serve_kw) -> ServeReport:
        policy = self.policy
        if self.snapshot_path is not None and policy.snapshot_sink is None:
            policy = dataclasses.replace(
                policy, snapshot_sink=lambda s: save_snapshot(self.snapshot_path, s))
        snap = load_snapshot(self.snapshot_path) if self.snapshot_path is not None else None
        while True:
            try:
                report = self.engine.serve_detailed(requests, policy=policy, chaos=self.chaos,
                                                    resume=snap, heartbeat=self._beat,
                                                    **serve_kw)
                report.restarts = self.restarts
                report.failures = list(self.failures)
                return report
            except EngineCrash as e:
                self.restarts += 1
                # the engine stopped beating: move the clock past the timeout
                # so the monitor's sweep detects the death
                self.clock.advance(self.monitor.timeout_s + 1.0)
                dead = self.monitor.sweep()
                assert 0 in dead or 0 in self.monitor.dead
                self.failures.append(FailureEvent(0, getattr(self.engine, "last_round", -1),
                                                  f"crash:{e}"))
                if self.restarts > self.max_restarts:
                    raise
                self.monitor.revive(0)
                snap = self.engine.last_snapshot
                if self.snapshot_path is not None:
                    disk = load_snapshot(self.snapshot_path)
                    if disk is not None:
                        snap = disk

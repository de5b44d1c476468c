"""Deterministic fault injection for the serving tier (twin of
``repro.serving.chaos``).

A ``FaultInjector`` is consulted at the continuous-batching engine's
scheduling boundaries (chunk execution, request admission, page top-up) and
injects seeded failures, so every failure mode the resilience layer handles
(``serving.resilience``) is reproducible: the same ``ChaosConfig`` fires at
the same calls as the JAX package's injector, and tests can hold the tokens
of a disturbed serve against an undisturbed one.

Failure modes, each drawn from its own counter-based PRNG stream
(``SeedSequence([seed, site])``), so one site's draws never shift another's
schedule:

* **chunk faults** (``fault_rate``): a transient ``ChunkFault`` raised at
  the chunk boundary before any chunk step runs (the device is untouched,
  so the engine retries with backoff);
* **engine crashes** (``crash_rate``): an ``EngineCrash`` at the round
  boundary, which only ``resilience.ServingSupervisor`` recovers from;
* **stragglers** (``straggle_rate``, ``straggle_s``): chunk latency as
  engine-clock skew, no real sleep;
* **page squeezes** (``squeeze_rate``, ``squeeze_frac``): a fraction of the
  free list withheld for one round, forcing recompute preemption;
* **request corruption** (``corrupt_rate``): an out-of-range token id
  written into a prompt at admission, which validation must reject.

The ``*_rounds`` and ``corrupt_rids`` fields script exact injection points
on top of the random draws.  Scripted rounds match each site's call counter,
which counts across supervisor restarts.  Every injection is recorded in
``FaultInjector.log``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


class ChunkFault(RuntimeError):
    """Transient failure of one decode chunk: retryable, since no chunk step
    ran and the engine's host state and cache are intact."""


class EngineCrash(RuntimeError):
    """The engine process is gone.  ``serve_detailed`` re-raises it after
    keeping its latest snapshot on ``last_snapshot``; only the
    ``ServingSupervisor`` recovers from it (restore and replay)."""


class VirtualClock:
    """A monotonic clock advanced explicitly, so deadlines, heartbeat timeouts
    and injected latency are deterministic.  Callable like
    ``time.monotonic``."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("time only moves forward")
        self._now += float(dt)
        return self._now


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded fault-injection rates, all 0 by default.  ``fault_rate``,
    ``crash_rate``, ``straggle_rate`` and ``squeeze_rate`` are per round,
    ``corrupt_rate`` per admitted request; the script fields add exact
    injection points (site calls, or request ids for ``corrupt_rids``)."""

    seed: int = 0
    fault_rate: float = 0.0
    crash_rate: float = 0.0
    straggle_rate: float = 0.0
    straggle_s: float = 0.05
    squeeze_rate: float = 0.0
    squeeze_frac: float = 0.5
    corrupt_rate: float = 0.0
    max_faults: Optional[int] = None  # cap on all injections (None: no cap)
    fault_rounds: Sequence[int] = ()
    crash_rounds: Sequence[int] = ()
    straggle_rounds: Sequence[int] = ()
    squeeze_rounds: Sequence[int] = ()
    corrupt_rids: Sequence[int] = ()


@dataclasses.dataclass
class InjectedFault:
    site: str  # "chunk" | "crash" | "straggle" | "squeeze" | "corrupt"
    round: int
    detail: str = ""


class FaultInjector:
    """Draws each site's injections from an independent stream
    (``SeedSequence([seed, site index])``), one draw per call whether or not
    it fires."""

    _SITES = ("chunk", "crash", "straggle", "squeeze", "corrupt")

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self._rng = {site: np.random.default_rng(np.random.SeedSequence([cfg.seed, i]))
                     for i, site in enumerate(self._SITES)}
        self._calls = {site: 0 for site in self._SITES}
        self.log: list[InjectedFault] = []

    def _budget_left(self) -> bool:
        return self.cfg.max_faults is None or len(self.log) < self.cfg.max_faults

    def _fire(self, site: str, rate: float, script: Sequence[int], match=None) -> bool:
        call = self._calls[site]
        self._calls[site] += 1
        hit = self._rng[site].random() < rate  # always draw: stable streams
        scripted = (call if match is None else match) in script
        return scripted or (hit and self._budget_left())

    def reset_log(self) -> None:
        """Forget the recorded injections, not the streams."""
        self.log = []

    @property
    def counts(self) -> dict:
        out: dict[str, int] = {}
        for f in self.log:
            out[f.site] = out.get(f.site, 0) + 1
        return out

    def chunk_fault(self, rnd: int) -> None:
        """Raise ``ChunkFault`` for this chunk attempt, or return."""
        if self._fire("chunk", self.cfg.fault_rate, self.cfg.fault_rounds):
            self.log.append(InjectedFault("chunk", rnd))
            raise ChunkFault(f"injected chunk fault at round {rnd}")

    def crash(self, rnd: int) -> None:
        """Raise ``EngineCrash`` at this round boundary, or return."""
        if self._fire("crash", self.cfg.crash_rate, self.cfg.crash_rounds):
            self.log.append(InjectedFault("crash", rnd))
            raise EngineCrash(f"injected engine crash at round {rnd}")

    def chunk_latency(self, rnd: int) -> float:
        """Injected straggler latency (seconds of clock skew) for this round,
        or 0.0."""
        if self._fire("straggle", self.cfg.straggle_rate, self.cfg.straggle_rounds):
            self.log.append(InjectedFault("straggle", rnd, f"+{self.cfg.straggle_s}s"))
            return float(self.cfg.straggle_s)
        return 0.0

    def squeeze_pages(self, n_free: int, rnd: int) -> int:
        """How many free pages to withhold from the allocator this round
        (given back at the end of the round)."""
        if n_free and self._fire("squeeze", self.cfg.squeeze_rate, self.cfg.squeeze_rounds):
            n = max(1, int(n_free * self.cfg.squeeze_frac))
            self.log.append(InjectedFault("squeeze", rnd, f"{n} pages"))
            return n
        return 0

    def corrupt_request(self, prompt: np.ndarray, ridx: int, rnd: int) -> np.ndarray:
        """The prompt as admission sees it: corrupted (one position set to an
        out-of-range token id), or unchanged."""
        if self._fire("corrupt", self.cfg.corrupt_rate, self.cfg.corrupt_rids, match=ridx):
            bad = np.array(prompt, np.int64, copy=True)
            pos = int(self._rng["corrupt"].integers(0, len(bad)))
            bad[pos] = np.iinfo(np.int32).max // 2  # far past any vocabulary
            self.log.append(InjectedFault("corrupt", rnd, f"request {ridx} token {pos}"))
            return bad
        return prompt

"""Heartbeats and failure events (twin of ``FailureEvent`` and
``HeartbeatMonitor`` in ``repro.runtime.fault``).

The continuous-batching engine heartbeats a ``HeartbeatMonitor`` every
scheduling round, and ``serving.resilience.ServingSupervisor`` detects a
crashed engine through ``sweep``, records a ``FailureEvent``, ``revive``-s
the restarted engine and replays its in-flight requests from the engine's
last snapshot.  Host-side Python only: it runs the same on the CPU and
beside a card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class FailureEvent:
    host: int
    at_step: int
    kind: str  # "dead" | "straggler" | "crash:<message>"


class HeartbeatMonitor:
    """Detects dead hosts from missed heartbeats."""

    def __init__(self, n_hosts: int, timeout_s: float = 30.0, clock=time.monotonic):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self._clock = clock
        now = clock()
        self.last_seen = {h: now for h in range(n_hosts)}
        self.dead: set[int] = set()

    def beat(self, host: int) -> None:
        if host not in self.dead:
            self.last_seen[host] = self._clock()

    def sweep(self) -> list[int]:
        """Mark and return newly dead hosts."""
        now = self._clock()
        newly = [h for h, t in self.last_seen.items()
                 if h not in self.dead and now - t > self.timeout_s]
        self.dead.update(newly)
        return newly

    def revive(self, host: int) -> None:
        """Re-admit a restarted host: clear its dead mark and restart its
        heartbeat window at now."""
        self.dead.discard(host)
        self.last_seen[host] = self._clock()

    @property
    def healthy(self) -> list[int]:
        return [h for h in range(self.n_hosts) if h not in self.dead]

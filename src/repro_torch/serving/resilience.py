"""What a serve reports (twin of ``RequestRecord`` and ``ServeReport`` in
``repro.serving.resilience``).  The port's ``serve_detailed`` runs without a
resilience policy and fills the fields that need none; the policy, fault
injection, snapshots and replay come with the resilience tier."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class RequestRecord:
    """Outcome of one request: ``status`` is ``"done"`` (full budget or stop
    token), ``"shed"`` or ``"rejected"`` (under a policy).  Times are
    engine-clock seconds from serve start; ``met_deadline`` is None when the
    request had no deadline.  ``slot`` is the batch slot it last occupied;
    ``events`` its span events, dicts of ``{"name", "ts", ...}``: ``admit``
    (slot, round, cached/prefilled tokens, cow), ``decode`` (one per round it
    was live in: dur, round, tokens), ``preempt`` (slot), ``finish``
    (tokens)."""

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
    rounds, one counter sample per round that ran a chunk (free, retained
    and in-use pages, prefix-hit tokens so far, the queue), and the prefix
    cache's counters.  (The reference's retry, shed and ladder counters come
    with the resilience tier.)"""

    records: list = dataclasses.field(default_factory=list)
    rounds: int = 0
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
        return [r.t_done for r in self.records
                if r.status == "done" and r.t_done is not None]

"""Multi-replica front end: route a request stream over N
``ContinuousBatchingEngine`` replicas, each request's tokens those of a solo
engine (twin of ``repro.serving.router``).

The engines are independent replicas, each with its own page pool, prefix
trie and scheduler; the router is a host-side dispatcher.  Routing is
least-loaded with prefix affinity:

* **affinity**: a host-side shadow of each replica's prefix trie
  (``prefix.PrefixTrie``, keyed the same way) tracks which prompt prefixes
  each replica has been sent.  A request prefers the replica whose shadow
  holds its longest prefix, whose real trie will serve those pages.  The
  shadow ignores evictions: routing needs no cache state from the engines.
* **load**: ties go to the replica with the least outstanding predicted
  work, over its requests the prompt tokens it will prefill (given
  affinity) plus ``max_new``; then to the lowest index.

Every sampled draw is keyed by (request id, draw counter), whatever the
slot, chunk, engine or batch.  The router pins each request's index in the
whole trace as its ``rid`` and every replica serves with the same key, so a
request's token stream is the one a solo engine serving the whole trace
would draw.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .engine import Request
from .prefix import PrefixTrie, chunk_keys, extras_fingerprint
from .resilience import RequestRecord, ServeReport


@dataclasses.dataclass
class RouterReport:
    """The merged outcome of one routed trace: ``records`` in the trace's
    order (index i is request i, as with a solo engine), ``assignments[i]``
    the replica that served request i, and each replica's ``ServeReport``
    (whose records are the same objects, in the replica's order).
    ``affinity_hits`` counts requests routed to a replica whose shadow trie
    already held a prefix of their prompt."""

    records: list = dataclasses.field(default_factory=list)
    assignments: list = dataclasses.field(default_factory=list)
    replica_reports: list = dataclasses.field(default_factory=list)
    affinity_hits: int = 0
    prefix_hits: int = 0
    prefix_hit_tokens: int = 0
    prefill_tokens: int = 0
    cow_forks: int = 0
    evictions: int = 0

    @property
    def outputs(self) -> list[np.ndarray]:
        return [r.tokens for r in self.records]

    def done(self) -> list[int]:
        return [i for i, r in enumerate(self.records) if r.status == "done"]

    def latencies(self) -> list[float]:
        return [r.t_done for r in self.records if r.status == "done" and r.t_done is not None]


class ReplicaRouter:
    """Route request streams over ``engines`` (see the module docstring),
    built alike (the same config and parameters; the prefix cache as the
    caller likes).  ``serve_detailed`` serves each replica's share on its
    own: replicas share no device state."""

    def __init__(self, engines: Sequence):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        self.engines = list(engines)
        ps = {e.page_size for e in self.engines}
        if len(ps) != 1:
            raise ValueError(f"replicas disagree on page_size ({sorted(ps)}); prefix affinity "
                             "keys chunks by page_size, so routing would be meaningless")
        self.page_size = ps.pop()

    def _shadow_insert(self, shadow: PrefixTrie, ctr: list, r: int, keys, fp) -> None:
        """Register ``keys`` in replica ``r``'s shadow trie under fresh page
        numbers (sequence numbers of that replica)."""
        fresh = list(range(ctr[r], ctr[r] + len(keys)))
        ctr[r] += len(keys)
        shadow.insert(keys, fp, fresh, on_new=lambda p: None)

    def route(self, requests: Sequence[Request]) -> list[int]:
        """Each request's replica: the longest shadow-trie prefix first, the
        least predicted outstanding work second, the lowest index last.
        Touches no engine."""
        n = len(self.engines)
        shadows = [PrefixTrie() for _ in range(n)]
        load, ctr, out = [0] * n, [0] * n, []
        for req in requests:
            keys = chunk_keys(np.asarray(req.prompt, np.int32), self.page_size)
            fp = extras_fingerprint(req.extras)
            matched = [len(shadows[r].match(keys, fp)) for r in range(n)]
            best = max(range(n), key=lambda r: (matched[r], -load[r], -r))
            load[best] += (len(req.prompt) - matched[best] * self.page_size) + int(req.max_new)
            self._shadow_insert(shadows[best], ctr, best, keys, fp)
            out.append(best)
        return out

    def serve_detailed(self, requests: Sequence[Request], *, greedy: bool = True,
                       temperature: float = 1.0, top_k: int = 0, key=None, policy=None,
                       chaos=None, assignments: Optional[Sequence[int]] = None) -> RouterReport:
        """Route (unless ``assignments`` is given) and serve every replica's
        share, one replica after another, merging the reports back into the
        trace's order.  Each request's ``rid`` is pinned to its index in the
        trace unless it has one; ``policy`` and ``chaos`` apply to every
        replica alike."""
        assign = list(assignments) if assignments is not None else self.route(requests)
        if len(assign) != len(requests):
            raise ValueError("assignments length != requests length")
        report = RouterReport(records=[None] * len(requests), assignments=assign)
        shadows = [PrefixTrie() for _ in self.engines]
        ctr = [0] * len(self.engines)
        for req, r in zip(requests, assign):
            keys = chunk_keys(np.asarray(req.prompt, np.int32), self.page_size)
            fp = extras_fingerprint(req.extras)
            if shadows[r].match(keys, fp):
                report.affinity_hits += 1
            self._shadow_insert(shadows[r], ctr, r, keys, fp)
        for r, eng in enumerate(self.engines):
            idxs = [i for i, a in enumerate(assign) if a == r]
            if not idxs:
                report.replica_reports.append(ServeReport())
                continue
            subs = [dataclasses.replace(requests[i], rid=(requests[i].rid
                                                          if requests[i].rid is not None else i))
                    for i in idxs]
            rep = eng.serve_detailed(subs, greedy=greedy, temperature=temperature, top_k=top_k,
                                     key=key, policy=policy, chaos=chaos)
            report.replica_reports.append(rep)
            for i, rec in zip(idxs, rep.records):
                rec.replica = r  # for the trace exporter
                report.records[i] = rec
            report.prefix_hits += rep.prefix_hits
            report.prefix_hit_tokens += rep.prefix_hit_tokens
            report.prefill_tokens += rep.prefill_tokens
            report.cow_forks += rep.cow_forks
            report.evictions += rep.evictions
        report.records = [RequestRecord() if rec is None else rec for rec in report.records]
        return report

    def serve(self, requests: Sequence[Request], **kw) -> list[np.ndarray]:
        return [r.tokens for r in self.serve_detailed(requests, **kw).records]

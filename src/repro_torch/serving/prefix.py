"""The continuous-batching engine's page pool (twin of ``PagePool`` in
``repro.serving.prefix``; the prefix trie comes with the prefix cache).

Host-side numpy bookkeeping: a page's refcount is the number of live block-
table references to it.  Pages registered in a prefix cache (``cached``)
are retained on an LRU list when their last reference goes, and ``alloc``
evicts them LRU-first before it fails.  With an ``rng``
(``np.random.default_rng``) the free list is shuffled at every ``alloc``,
so block tables become random permutations of the pool; given the same
seed and the same operations, the pool hands out the JAX package's page
ids.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np


class PagePool:
    """Refcounted page pool.  Page 0 is the trash page and never circulates.

    Per page: FREE (on ``free``, refcount 0) -> REFERENCED (refcount >= 1;
    ``alloc`` starts at 1, ``acquire`` adds one) -> on the last
    ``release``: RETAINED (a cached page, refcount 0, on the LRU) or FREE."""

    def __init__(self, num_pages: int, rng=None):
        self.num_pages = int(num_pages)
        self.free = list(range(1, self.num_pages))
        self.refcnt = np.zeros(self.num_pages, np.int64)
        self.cached: set[int] = set()       # pages registered in a prefix cache
        self.lru = OrderedDict()            # retained refcount-0 cached pages
        self._rng = rng

    def available(self, reserve: tuple = ()) -> int:
        """Pages ``alloc`` could hand out now: free + retained, less the
        retained pages in ``reserve`` the caller is about to ``acquire``."""
        held = sum(1 for p in reserve if p in self.lru)
        return len(self.free) + len(self.lru) - held

    def in_use(self) -> int:
        """Pages with live references (retained pages are not in use)."""
        return int((self.refcnt[1:] > 0).sum())

    def alloc(self, n: int) -> list[int]:
        if n > self.available():
            raise RuntimeError(
                f"page allocator overdraw: requested {n} pages with only "
                f"{len(self.free)} free (+{len(self.lru)} evictable) — "
                "admission/top-up must check the free list before allocating")
        while len(self.free) < n:
            page, _ = self.lru.popitem(last=False)  # evict the least recent
            self.cached.discard(page)
            self.free.append(page)
        if self._rng is not None:
            self._rng.shuffle(self.free)
        pages, self.free = self.free[:n], self.free[n:]
        for p in pages:
            self.refcnt[p] = 1
        return pages

    def acquire(self, page: int) -> None:
        """Add a reference to a live or retained page (aliasing)."""
        if self.refcnt[page] == 0:
            self.lru.pop(page)  # refcount-0 pages that are not free are retained
        self.refcnt[page] += 1

    def release(self, page: int) -> None:
        if page == 0 or self.refcnt[page] <= 0:
            raise ValueError(
                f"double-free: page {page} is not currently allocated — a page "
                "freed twice would be issued to two slots at once and silently "
                "cross-corrupt their KV state")
        self.refcnt[page] -= 1
        if self.refcnt[page] == 0:
            if page in self.cached:
                self.lru[page] = None  # retained, most-recent end
            else:
                self.free.append(page)

    def mark_cached(self, page: int) -> None:
        self.cached.add(page)

    def assert_quiescent(self) -> None:
        """With no live requests: no page referenced, and every circulating
        page on the free list or the LRU exactly once."""
        held = np.flatnonzero(self.refcnt[1:] > 0) + 1
        if held.size:
            raise AssertionError(
                f"page leak: {held.tolist()} still allocated with no live requests")
        expect = self.num_pages - 1  # page 0 (trash) never circulates
        pool = list(self.free) + list(self.lru)
        if len(pool) != expect or len(set(pool)) != expect:
            raise AssertionError(
                f"free-list corruption: {len(self.free)} free + {len(self.lru)} "
                f"retained ({len(set(pool))} unique), expected {expect}")
        if not set(self.lru) <= self.cached:
            raise AssertionError(
                f"retained pages {sorted(set(self.lru) - self.cached)} are not "
                "registered in a prefix cache")

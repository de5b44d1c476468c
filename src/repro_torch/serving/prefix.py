"""The shared-prefix KV page cache: the refcounted page pool and the host-side
prefix trie (twin of ``repro.serving.prefix``).

Host-side numpy bookkeeping, as in the JAX package:

* ``PagePool``: a page's refcount is the number of live block-table
  references to it.  Pages registered in the prefix trie (``cached``) are
  retained on an LRU list when their last reference goes, their K/V still
  valid, so a later request with the same prefix can alias them again;
  ``alloc`` evicts retained pages LRU-first (telling ``on_evict``) before it
  fails, so cached pages are capacity on loan, never reserved.  With an
  ``rng`` (``np.random.default_rng``) the free list is shuffled at every
  ``alloc``, so block tables become random permutations of the pool; given
  the same seed and the same operations, the pool hands out the JAX
  package's page ids.
* ``PrefixTrie``: maps page-aligned prompt chunks to registered pages.  Its
  keys are each full ``page_size`` chunk's token bytes, walked from
  position 0 under a root per extras fingerprint, so a page matches only
  when every token before it (and the request's conditioning) is the same:
  the causal dependency of its K/V.

The engine registers only the full pages of an uncached admit's prompt
(positions decode never rewrites), and forks a shared page copy-on-write
before a write lands in it.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch


def _leaves(tree):
    """A plain tree's array leaves in the JAX package's order (dict keys
    sorted, sequences in order, None an empty subtree)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def extras_fingerprint(extras) -> Optional[str]:
    """Digest of a request's per-slot conditioning (a plain dict of arrays),
    the root its chunk chains hang from; ``None`` extras share the ``None``
    root.  Each leaf's shape, dtype and bytes are hashed in the JAX
    package's leaf order; a tensor (on any device) as the numpy array of
    its values, a bf16 one under the dtype name ``bfloat16``, as a JAX bf16
    array hashes."""
    if extras is None:
        return None
    h = hashlib.sha1()
    for leaf in _leaves(extras):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            bf16 = t.dtype == torch.bfloat16
            a = (t.view(torch.int16) if bf16 else t).numpy()
            dtype = "bfloat16" if bf16 else str(a.dtype)
        else:
            a = np.asarray(leaf)
            dtype = str(a.dtype)
        h.update(str(a.shape).encode())
        h.update(dtype.encode())
        h.update(a.tobytes())
    return h.hexdigest()


def chunk_keys(seq: np.ndarray, page_size: int) -> list[bytes]:
    """The trie keys of a token sequence: the raw bytes of each FULL
    ``page_size``-aligned chunk (a partial tail chunk never enters the
    trie: decode still writes its page)."""
    seq = np.ascontiguousarray(np.asarray(seq, np.int32))
    n = len(seq) // page_size
    return [seq[i * page_size:(i + 1) * page_size].tobytes() for i in range(n)]


@dataclasses.dataclass
class _Node:
    page: int
    children: dict = dataclasses.field(default_factory=dict)


class PrefixTrie:
    """Chunk-chain trie: ``match`` returns the pages of the longest registered
    chain prefix, ``insert`` extends a chain, ``drop_page`` detaches an
    evicted page's node (its subtree can no longer match, and its pages stay
    evictable through the pool's LRU)."""

    def __init__(self):
        self._roots: dict = {}  # extras fingerprint -> {chunk bytes: _Node}
        self._where: dict[int, tuple] = {}  # page -> (children dict, key)

    def match(self, keys: list[bytes], fp) -> list[int]:
        """Pages of the longest registered chain prefix of ``keys``."""
        children = self._roots.get(fp)
        out: list[int] = []
        for k in keys:
            node = None if children is None else children.get(k)
            if node is None:
                break
            out.append(node.page)
            children = node.children
        return out

    def insert(self, keys: list[bytes], fp, pages: list[int],
               on_new: Callable[[int], None]) -> int:
        """Walk and extend the chain of ``keys``: chunk i with no node yet
        gets one holding ``pages[i]``, and ``on_new(pages[i])`` fires.  An
        existing node stays (the first registration wins).  Returns the
        number of pages newly registered."""
        children = self._roots.setdefault(fp, {})
        new = 0
        for k, page in zip(keys, pages):
            node = children.get(k)
            if node is None:
                node = _Node(page=int(page))
                children[k] = node
                self._where[int(page)] = (children, k)
                on_new(int(page))
                new += 1
            children = node.children
        return new

    def drop_page(self, page: int) -> None:
        loc = self._where.pop(int(page), None)
        if loc is not None:
            children, k = loc
            node = children.get(k)
            if node is not None and node.page == int(page):
                del children[k]

    def __len__(self) -> int:
        return len(self._where)


class PagePool:
    """Refcounted page pool.  Page 0 is the trash page and never circulates.

    Per page: FREE (on ``free``, refcount 0) -> REFERENCED (refcount >= 1;
    ``alloc`` starts at 1, ``acquire`` adds one) -> on the last
    ``release``: RETAINED (a cached page, refcount 0, on the LRU) or FREE.
    ``evictions`` counts the retained pages ``alloc`` took back."""

    def __init__(self, num_pages: int, rng=None,
                 on_evict: Optional[Callable[[int], None]] = None):
        self.num_pages = int(num_pages)
        self.free = list(range(1, self.num_pages))
        self.refcnt = np.zeros(self.num_pages, np.int64)
        self.cached: set[int] = set()       # pages registered in the trie
        self.lru = OrderedDict()            # retained refcount-0 cached pages
        self.on_evict = on_evict
        self.evictions = 0
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
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(page)
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

    def touch(self, page: int) -> None:
        """Move a retained page to the LRU's most-recent end."""
        if page in self.lru:
            self.lru.move_to_end(page)

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
                "registered in the prefix trie")

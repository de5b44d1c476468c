"""Port parity: the prefix cache's host side (``serving.prefix``): the page
pool, the prefix trie, ``chunk_keys`` and ``extras_fingerprint``.

All of it is host-side numpy in both packages.  Under the same operations
and the same ``page_alloc_seed`` the port's pool must hand out exactly the
JAX package's page ids (its free list is shuffled by the same
``np.random.default_rng``), keep the same refcounts, free list and LRU of
retained pages, evict the same pages in the same order (telling
``on_evict``), and refuse the same misuse: a double free, an overdraw, a
leak at quiescence.  The trie must match, register and drop the same pages.
"""
import numpy as np
import pytest

from repro.serving import prefix as jax_prefix
from repro.serving.prefix import PagePool as JaxPool
from repro_torch.serving import prefix
from repro_torch.serving.prefix import PagePool

from torch_helpers import jax_maps_bounded  # noqa: E402,F401

NUM_PAGES = 12


def _state(pool):
    return (list(pool.free), pool.refcnt.tolist(), sorted(pool.cached), list(pool.lru),
            pool.in_use(), pool.available())


def _script(pool):
    """A fixed sequence of pool operations; returns every page id handed out."""
    got = [pool.alloc(3), pool.alloc(2)]
    a, b = got
    pool.acquire(a[0])  # aliased: refcount 2
    pool.mark_cached(a[1])
    pool.mark_cached(b[0])
    for p in a + b:
        pool.release(p)  # a[0] keeps one reference; a[1], b[0] are retained
    assert list(pool.lru) == [a[1], b[0]]
    assert pool.available(reserve=(a[1],)) == pool.available() - 1
    got.append(pool.alloc(pool.available()))  # evicts both retained pages
    assert not pool.lru and not pool.cached
    pool.acquire(got[-1][0])
    for p in got[2]:
        pool.release(p)
    pool.release(got[2][0])
    pool.release(a[0])
    return got


@pytest.mark.parametrize("seed", [None, 0, 7])
def test_page_ids_and_state_match_jax(seed):
    pools = []
    for cls in (JaxPool, PagePool):
        rng = None if seed is None else np.random.default_rng(seed)
        pool = cls(NUM_PAGES, rng=rng)
        ids = _script(pool)
        pools.append((ids, _state(pool)))
        pool.assert_quiescent()
    assert pools[0] == pools[1]


def test_misuse_raises_as_in_jax():
    for cls in (JaxPool, PagePool):
        pool = cls(5, rng=np.random.default_rng(1))
        pages = pool.alloc(2)
        for p in pages:
            pool.release(p)
        with pytest.raises(ValueError, match="double-free"):
            pool.release(pages[0])
        with pytest.raises(ValueError, match="double-free"):
            pool.release(0)  # the trash page never circulates
        with pytest.raises(RuntimeError, match="overdraw"):
            pool.alloc(5)  # 4 pages circulate
        pool.assert_quiescent()  # a refused alloc takes nothing
        leaked = pool.alloc(1)
        with pytest.raises(AssertionError, match="page leak"):
            pool.assert_quiescent()
        pool.release(leaked[0])
        pool.free.append(pool.free[0])  # a page listed twice
        with pytest.raises(AssertionError, match="free-list corruption"):
            pool.assert_quiescent()


def _evicting_script(pool, trie_cls, chunk_keys):
    """Pool and trie together, as the engine drives them: two prompts'
    pages registered, released to the LRU, one touched, a match that
    aliases a retained page, then allocations that evict LRU-first (the trie
    told through ``on_evict``).  Returns every page handed out, the pages
    evicted and each match."""
    trie = trie_cls()
    evicted = []

    def on_evict(page):
        evicted.append(page)
        trie.drop_page(page)
    pool.on_evict = on_evict
    ps = 4
    a = np.arange(12, dtype=np.int32)  # three full pages
    b = np.concatenate([a[:4], np.arange(50, 58, dtype=np.int32)])  # shares page 0
    got, matches = [], []
    for seq in (a, b):
        keys = chunk_keys(seq, ps)
        matched = trie.match(keys, None)
        matches.append(list(matched))
        for p in matched:
            pool.acquire(p)
        pages = matched + pool.alloc(len(keys) - len(matched))
        got.append(pages)
        trie.insert(keys, None, pages, on_new=pool.mark_cached)
    assert len(trie) == 5  # a's three pages, b's two of its own
    for pages in got:
        for p in pages:
            pool.release(p)
    pool.touch(got[0][1])  # a's second page: most recent now
    pool.touch(0)  # not retained: no effect
    lru = list(pool.lru)
    matches.append(trie.match(chunk_keys(a, ps), None))
    for p in matches[-1]:
        pool.acquire(p)  # aliased off the LRU
    got.append(pool.alloc(pool.available()))  # evicts every retained page left
    matches.append(trie.match(chunk_keys(b, ps), None))  # b's pages went; its first is a's
    for p in got[-1] + matches[-2]:
        pool.release(p)
    return got, evicted, matches, lru, len(trie), pool.evictions


@pytest.mark.parametrize("seed", [None, 3])
def test_trie_and_eviction_match_jax(seed):
    runs = []
    for cls, mod in ((JaxPool, jax_prefix), (PagePool, prefix)):
        pool = cls(NUM_PAGES, rng=None if seed is None else np.random.default_rng(seed))
        runs.append((_evicting_script(pool, mod.PrefixTrie, mod.chunk_keys), _state(pool)))
        pool.assert_quiescent()
    assert runs[0] == runs[1]
    (got, evicted, matches, _, left, evictions), _ = runs[1]
    assert matches[2] == got[0] and evictions == len(evicted) == 2
    assert left == 3 and matches[3] == got[0][:1]  # a's chain stayed, b's own pages went


def test_chunk_keys_and_fingerprint_match_jax():
    """Full page-aligned chunks only, as raw int32 bytes; the fingerprint of
    None is None, and of a plain dict of arrays JAX's digest (leaves in
    sorted-key order)."""
    seq = np.random.default_rng(0).integers(0, 1000, 11).astype(np.int64)
    for ps in (1, 4, 11, 12):
        assert prefix.chunk_keys(seq, ps) == jax_prefix.chunk_keys(seq, ps)
    assert len(prefix.chunk_keys(seq, 4)) == 2
    assert prefix.extras_fingerprint(None) is None is jax_prefix.extras_fingerprint(None)
    rng = np.random.default_rng(1)
    extras = {"image_embeds": rng.standard_normal((3, 4)).astype(np.float32),
              "aux": {"b": np.arange(5, dtype=np.int32), "a": np.ones(2, np.float32)}}
    fp = prefix.extras_fingerprint(extras)
    assert fp == jax_prefix.extras_fingerprint(extras)
    other = {**extras, "aux": {**extras["aux"], "b": np.arange(1, 6, dtype=np.int32)}}
    assert prefix.extras_fingerprint(other) != fp


def test_trie_first_registration_wins_and_roots_per_fingerprint():
    """A chunk registered twice keeps its first page; another fingerprint is
    another root; a dropped page's node no longer matches, nor do its
    descendants."""
    for mod in (jax_prefix, prefix):
        trie = mod.PrefixTrie()
        keys = mod.chunk_keys(np.arange(12, dtype=np.int32), 4)
        marked = []
        assert trie.insert(keys, None, [5, 6, 7], on_new=marked.append) == 3
        assert trie.insert(keys[:2], None, [8, 9], on_new=marked.append) == 0
        assert trie.insert(keys[:1], "fp", [8], on_new=marked.append) == 1
        assert marked == [5, 6, 7, 8]
        assert trie.match(keys, None) == [5, 6, 7] and trie.match(keys, "fp") == [8]
        trie.drop_page(6)
        trie.drop_page(6)  # twice: no effect
        assert trie.match(keys, None) == [5] and len(trie) == 3

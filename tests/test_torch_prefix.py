"""Port parity: the continuous engine's page pool (``serving.prefix.PagePool``).

The pool is host-side numpy in both packages.  Under the same operations and
the same ``page_alloc_seed`` the port's pool must hand out exactly the JAX
package's page ids (its free list is shuffled by the same
``np.random.default_rng``), keep the same refcounts, free list and LRU of
retained pages, and refuse the same misuse: a double free, an overdraw, a
leak at quiescence.
"""
import numpy as np
import pytest

from repro.serving.prefix import PagePool as JaxPool
from repro_torch.serving.prefix import PagePool

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

"""Sharded numpy across a thread pool for the host-side projection build.

The 10M-tuple snapshot projection is a chain of elementwise passes,
gathers and scatters over ~10-16M-row arrays.  Numpy releases the GIL for
all of them, so on a multi-core host the memory-bound passes shard
near-linearly across threads; on a single-core host (or for small inputs)
everything runs inline and costs one comparison.

Only *independent-range* work shards here: ``shard_apply`` hands each
worker a half-open ``[lo, hi)`` slice of the index space and the callback
must only write rows it owns (disjoint output ranges; shared read-only
inputs are fine).  Sorts and cumulative scans stay single-threaded — their
merge step would eat the win at this scale.

``KETO_BUILD_THREADS`` overrides the pool size (0/1 forces inline).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

_MIN_CHUNK = 1 << 20  # below ~1M rows the dispatch overhead dominates

_pool: Optional[ThreadPoolExecutor] = None
_pool_size = 0


def pool_size() -> int:
    env = os.environ.get("KETO_BUILD_THREADS", "").strip()
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return max(1, os.cpu_count() or 1)


def _get_pool(size: int) -> ThreadPoolExecutor:
    global _pool, _pool_size
    if _pool is None or _pool_size != size:
        if _pool is not None:
            _pool.shutdown(wait=False)
        _pool = ThreadPoolExecutor(
            max_workers=size, thread_name_prefix="keto-build"
        )
        _pool_size = size
    return _pool


def shard_apply(n: int, fn: Callable[[int, int], None]) -> None:
    """Run ``fn(lo, hi)`` over a partition of ``range(n)``.

    Inline when the host has one core or the range is small; otherwise the
    shards run on the shared build pool and this call blocks until all
    complete (re-raising the first worker exception).
    """
    size = pool_size()
    if size <= 1 or n < 2 * _MIN_CHUNK:
        fn(0, n)
        return
    shards = min(size, max(1, n // _MIN_CHUNK))
    step = -(-n // shards)
    futs = []
    pool = _get_pool(size)
    for lo in range(0, n, step):
        futs.append(pool.submit(fn, lo, min(lo + step, n)))
    for f in futs:
        f.result()

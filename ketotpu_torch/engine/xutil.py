"""Arena allocation (K4), the lexicographic sort of key columns and the
lexicographic binary search over them.

:func:`arena_assign` turns per-task child counts into flat child slots:
the batched replacement for goroutine fan-out in the reference
(`internal/check/checkgroup/concurrent_checkgroup.go:66-138`), as in the
JAX package's ``engine/xutil.py``.  :func:`lex_sort` sorts int32 key
columns lexicographically with payload columns carried along; the
sort-based frontier pack (``fastpath._pack_sort``) calls it.
:func:`lex_searchsorted` finds query keys in columns sorted that way; as
in JAX, nothing of the engine calls it.  Each launches its CUDA kernel
(``csrc/arena.cu``, ``csrc/sort.cu``, ``csrc/search.cu``) on CUDA tensors
and runs its plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ketotpu_torch import kernels

Tensor = torch.Tensor


def arena_assign(counts: Tensor, arena_size: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Flatten per-task child counts into arena slots.

    ``counts``: int32[T] children requested per task (0 for inactive tasks).

    Returns ``(offsets, total, parent, ordinal)`` where ``offsets[t]`` is the
    exclusive prefix sum (the arena base of task t's children), ``total`` the
    0-d total, and for each arena slot ``j < arena_size``: ``parent[j]`` =
    the task index owning the slot and ``ordinal[j]`` its child ordinal;
    slots >= total get parent == -1 and ordinal 0.
    """
    if counts.device.type == "cpu":
        return _arena_assign_plain(counts, arena_size)
    return _arena_assign_cuda(counts, arena_size)


def _arena_assign_plain(counts: Tensor, arena_size: int):
    counts = counts.to(torch.int32)
    dev = counts.device
    n = counts.shape[0]
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    total = counts.sum(dtype=torch.int32)
    j = torch.arange(arena_size, dtype=torch.int32, device=dev)
    # parent[j] = last t with offsets[t] <= j among counts > 0 rows: scatter
    # each task index at its range start and forward-fill with a running
    # max.  Starts at or past the arena go to a sink slot (JAX drops them).
    t = torch.arange(n, dtype=torch.int32, device=dev)
    start = torch.where((counts > 0) & (offsets < arena_size), offsets, arena_size)
    mark = torch.full((arena_size + 1,), -1, dtype=torch.int32, device=dev)
    mark = mark.scatter_reduce(0, start.to(torch.int64), t, "amax")[:arena_size]
    parent = torch.cummax(mark, 0).values
    parent = torch.where(j < total, parent, -1)
    safe = parent.clamp(0, n - 1).to(torch.int64)
    ordinal = torch.where(parent >= 0, j - offsets[safe], 0).to(torch.int32)
    return offsets, total, parent, ordinal


#: csrc/arena.cu kArenaTile: tasks per tile of the chained scan
ARENA_TILE = 512
#: per CUDA device, the chained scan's state: int32 [ticket, finished
#: blocks, then two words per tile's status]; zeroed once here, left zeroed
#: by every call (the last block to finish clears what the call used)
_ARENA_STATE: Dict[int, Tensor] = {}


def _arena_state(dev: torch.device, tiles: int) -> Tensor:
    """The device's chained-scan state, grown (zeroed) to hold ``tiles``
    tiles.  Calls on one device share it, so they run in stream order."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    state = _ARENA_STATE.get(index)
    if state is None or (state.shape[0] - 2) // 2 < tiles:
        cap = max(64, 1 << max(tiles - 1, 0).bit_length())
        state = _ARENA_STATE[index] = torch.zeros(2 + 2 * cap, dtype=torch.int32,
                                                  device=dev)
    return state


def _arena_assign_cuda(counts: Tensor, arena_size: int):
    kernels.require(counts, torch.int32, "counts")
    n = counts.shape[0]
    dev = counts.device
    offsets = torch.empty(n, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    parent = torch.empty(arena_size, dtype=torch.int32, device=dev)
    ordinal = torch.empty(arena_size, dtype=torch.int32, device=dev)
    state = _arena_state(dev, -(-n // ARENA_TILE))
    kernels.launch(
        "arena", "arena_assign", kernels.ptr(counts), n, arena_size,
        kernels.ptr(offsets), kernels.ptr(total), kernels.ptr(parent),
        kernels.ptr(ordinal), kernels.ptr(state), (state.shape[0] - 2) // 2,
        kernels.stream(),
    )
    kernels.LAUNCHES["arena_assign"] += 1
    return offsets, total[0], parent, ordinal


# -- the lexicographic sort ------------------------------------------------------

SORT_TILE = 1024  # csrc/sort.cuh kSortTile: rows per tile of a digit pass
SORT_BINS = 256  # csrc/sort.cuh kSortBins: one 8-bit digit
MAX_SORT_KEYS = 8  # csrc/sort.cuh kSortMaxKeys
#: the sort's status words keep a count of rows in 30 bits
MAX_SORT_ROWS = (1 << 30) - 1


class SortLayout(NamedTuple):
    """The kernel's plan for one sort (``csrc/sort.cuh``).

    ``passes``: per digit pass, least significant first, (key column,
    shift, flip the sign bit 0/1); ``perm_words``: the int32 permutation
    scratch (double-buffered from three passes on); ``zeroed_words``: the
    int32 scratch the call clears (per pass 256 histogram bins, one tile
    counter and 256 status words per tile)."""

    passes: Tuple[Tuple[int, int, int], ...]
    perm_words: int
    zeroed_words: int


def sort_layout(n: int, bits: Sequence[int]) -> SortLayout:
    """The digit passes and scratch sizes of a sort of ``n`` rows by key
    columns of widths ``bits`` (column 0 most significant).  A width ``b``
    gives ``ceil(b / 8)`` passes over its low bytes, none at 0; at 32 the
    sign bit is flipped (negatives first).  Raises on a width outside [0,
    32], more than :data:`MAX_SORT_KEYS` columns, or ``n`` past
    :data:`MAX_SORT_ROWS`."""
    widths = [int(b) for b in bits]
    if not 1 <= len(widths) <= MAX_SORT_KEYS:
        raise ValueError(f"{len(widths)} key columns: the kernel takes 1 to "
                         f"{MAX_SORT_KEYS}")
    if any(not 0 <= b <= 32 for b in widths):
        raise ValueError(f"bits {widths}: one width in [0, 32] per key")
    if not 0 <= n <= MAX_SORT_ROWS:
        raise ValueError(f"{n} rows: the sort takes at most {MAX_SORT_ROWS} "
                         f"(a 30-bit count per status word)")
    passes = tuple((k, shift, int(widths[k] == 32))
                   for k in reversed(range(len(widths)))
                   for shift in range(0, widths[k], 8))
    np_ = len(passes)
    perm = 0 if np_ < 2 else n if np_ == 2 else 2 * n
    tiles = -(-n // SORT_TILE)
    zeroed = np_ * (SORT_BINS + 1 + tiles * SORT_BINS) if np_ else 0
    return SortLayout(passes, perm, zeroed)


def lex_sort(keys, *payload: Tensor, bits: Optional[Sequence[int]] = None):
    """Sort int32 key columns lexicographically (``keys[0]`` most
    significant), carrying the payload columns along: the JAX
    ``lex_sort`` (``jax.lax.sort(keys + payload, num_keys=K)``).

    ``keys``: a sequence of K int32[N] tensors or one int32[K, N] tensor.
    ``bits``: per key, its width; a width below 32 promises
    ``0 <= key < 2**width``, so the kernel passes over only the low
    ``ceil(width / 8)`` bytes (default 32 each: any int32, negatives
    first).  Returns ``(sorted keys, sorted payload)``, tuples of [N]
    tensors.  The sort is stable (equal keys keep their row order); JAX's
    is not, so only the order among equal keys may differ from it."""
    block = keys if isinstance(keys, Tensor) and keys.dim() == 2 else None
    keys = tuple(keys)
    if not keys:
        raise ValueError("lex_sort needs at least one key column")
    if keys[0].device.type == "cpu":
        return _lex_sort_plain(keys, *payload, bits=bits)
    return _lex_sort_cuda(keys, payload, bits, block)


def _lex_sort_plain(keys, *payload: Tensor, bits: Optional[Sequence[int]] = None):
    """A chain of stable sorts, least significant key first.  ``bits`` is
    the kernel's promise about the keys and is not read here."""
    keys = tuple(keys)
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return tuple(k[perm] for k in keys), tuple(p[perm] for p in payload)


def _lex_sort_cuda(keys: Tuple[Tensor, ...], payload: Tuple[Tensor, ...], bits,
                   block: Optional[Tensor]):
    dev = keys[0].device
    n = keys[0].shape[0]
    nk, npay = len(keys), len(payload)
    widths = [32] * nk if bits is None else [int(b) for b in bits]
    if len(widths) != nk:
        raise ValueError(f"bits {widths}: one width per key column ({nk})")
    plan = sort_layout(n, widths)
    for i, c in enumerate(keys + payload):
        kernels.require(c, torch.int32, f"column {i}", shape=(n,), device=dev)
    # one int32[K, N] block: the caller's, when it passed one
    kb = (block.contiguous() if block is not None
          else keys[0].view(1, n) if nk == 1 else torch.stack(keys))
    pb = (None if npay == 0 else payload[0].view(1, n) if npay == 1
          else torch.stack(payload))
    i32 = dict(dtype=torch.int32, device=dev)
    keys_out = torch.empty((nk, n), **i32)
    pay_out = torch.empty((npay, n), **i32)
    if n == 0:
        return tuple(keys_out), tuple(pay_out)
    perms = torch.empty(plan.perm_words, **i32)
    zeroed = torch.empty(plan.zeroed_words, **i32)
    rows = (ctypes.c_int32 * (3 * max(len(plan.passes), 1)))(
        *(v for p in plan.passes for v in p))
    kernels.launch(
        "sort", "lex_sort", kernels.ptr(kb), nk, kernels.ptr(pb), npay, n,
        ctypes.cast(rows, ctypes.c_void_p).value, len(plan.passes),
        kernels.ptr(keys_out), kernels.ptr(pay_out) if npay else None,
        kernels.ptr(perms), kernels.ptr(zeroed), plan.zeroed_words,
        kernels.stream(),
    )
    kernels.LAUNCHES["lex_sort"] += 1
    return tuple(keys_out), tuple(pay_out)


# -- the lexicographic binary search -----------------------------------------------


def lex_searchsorted(keys, queries) -> Tuple[Tensor, Tensor]:
    """Vectorized lexicographic binary search: the JAX ``lex_searchsorted``.

    ``keys``: K int32 columns of length N sorted together in
    :func:`lex_sort` order (``keys[0]`` most significant), as a sequence
    of tensors or one int32[K, N] tensor; ``queries``: K int32 columns of
    length Q, the same way.  Returns ``(idx int32[Q], found bool[Q])``:
    the insertion point (first index whose key is >= the query) and
    whether the key there equals the query.  N == 0 gives idx 0 and
    found False."""
    if not len(keys) or len(keys) != len(queries):
        raise ValueError(f"{len(keys)} key columns, {len(queries)} query columns")
    if queries[0].device.type == "cpu":
        return _lex_searchsorted_plain(keys, queries)
    return _lex_searchsorted_cuda(keys, queries)


def _lex_searchsorted_plain(keys, queries) -> Tuple[Tensor, Tensor]:
    """JAX's unrolled ``bit_length(N) + 1`` steps, every midpoint gather
    clamped to N - 1."""
    keys, queries = tuple(keys), tuple(queries)
    n = keys[0].shape[0]
    q = queries[0].shape[0]
    dev = queries[0].device
    if n == 0:
        return (torch.zeros(q, dtype=torch.int32, device=dev),
                torch.zeros(q, dtype=torch.bool, device=dev))
    lo = torch.zeros(q, dtype=torch.int32, device=dev)
    hi = torch.full((q,), n, dtype=torch.int32, device=dev)
    for _ in range(max(1, int(n).bit_length() + 1)):
        mid = (lo + hi) // 2
        at = mid.clamp(0, n - 1).to(torch.int64)
        live = lo < hi
        go_right = live & _lex_less([k[at] for k in keys], queries)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | ~live, hi, mid)
    at = lo.clamp(0, n - 1).to(torch.int64)
    found = (lo < n) & _lex_eq([k[at] for k in keys], queries)
    return lo, found


def _lex_less(a, b) -> Tensor:
    """Elementwise a < b under lexicographic order over key columns."""
    lt = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    eq = torch.ones_like(lt)
    for ka, kb in zip(a, b):
        lt = lt | (eq & (ka < kb))
        eq = eq & (ka == kb)
    return lt


def _lex_eq(a, b) -> Tensor:
    eq = torch.ones(a[0].shape, dtype=torch.bool, device=a[0].device)
    for ka, kb in zip(a, b):
        eq = eq & (ka == kb)
    return eq


def _block(cols, name: str, dev) -> Tensor:
    """The columns as one contiguous int32[K, n] block: the caller's, when
    it passed one, else stacked."""
    if isinstance(cols, Tensor) and cols.dim() == 2:
        kernels.require(cols, torch.int32, name, device=dev)
        return cols
    n = cols[0].shape[0]
    for i, c in enumerate(cols):
        kernels.require(c, torch.int32, f"{name} column {i}", shape=(n,),
                        device=dev)
    return torch.stack(tuple(cols))


def _lex_searchsorted_cuda(keys, queries) -> Tuple[Tensor, Tensor]:
    nk = len(keys)
    if nk > MAX_SORT_KEYS:
        raise ValueError(f"{nk} key columns: the kernel takes at most {MAX_SORT_KEYS}")
    dev = queries[0].device
    kb, qb = _block(keys, "keys", dev), _block(queries, "queries", dev)
    n, q = kb.shape[1], qb.shape[1]
    idx = torch.empty(q, dtype=torch.int32, device=dev)
    found = torch.empty(q, dtype=torch.bool, device=dev)
    kernels.launch("search", "lex_searchsorted", kernels.ptr(kb), nk, n,
                   kernels.ptr(qb), q, kernels.ptr(idx), kernels.ptr(found),
                   kernels.stream())
    kernels.LAUNCHES["lex_searchsorted"] += 1
    return idx, found

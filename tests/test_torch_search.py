"""Port parity: the lexicographic binary search (``xutil.lex_searchsorted``)
against the JAX package's ``engine/xutil.py`` ``lex_searchsorted``, at
tolerance 0: the insertion point and the found bit of every query.

Keys are sorted with ``np.lexsort`` (the order of both packages'
``lex_sort``).  The cases: one to three key columns, empty and one-row
key sets, runs of duplicate keys, negative keys, queries below the first
key and above the last, and the port's own ``lex_sort`` output as keys.
The CUDA kernel (``csrc/search.cu``) is held against the plain version on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ketotpu.engine import xutil as jxutil
from ketotpu_torch.engine import xutil as txutil

torch.set_num_threads(1)


def _sorted_keys(rng, k: int, n: int, lo: int, hi: int) -> np.ndarray:
    keys = rng.integers(lo, hi, (k, n)).astype(np.int32)
    return keys[:, np.lexsort(keys[::-1])] if n else keys


def _queries(rng, keys: np.ndarray, q: int, lo: int, hi: int) -> np.ndarray:
    """Half drawn from the keys (when there are any), the rest random in
    [lo - 2, hi + 2): below the first key and above the last among them."""
    k, n = keys.shape
    out = rng.integers(lo - 2, hi + 2, (k, q)).astype(np.int32)
    if n:
        take = rng.integers(0, n, q // 2)
        out[:, : q // 2] = keys[:, take]
    return out


def _jax(keys, queries):
    idx, found = jxutil.lex_searchsorted(
        tuple(jnp.asarray(c) for c in keys), tuple(jnp.asarray(c) for c in queries))
    return np.asarray(idx), np.asarray(found)


def _check(keys: np.ndarray, queries: np.ndarray, as_block: bool):
    jidx, jfound = _jax(keys, queries)
    if as_block:
        idx, found = txutil.lex_searchsorted(torch.from_numpy(keys),
                                             torch.from_numpy(queries))
    else:
        idx, found = txutil.lex_searchsorted(
            [torch.from_numpy(c.copy()) for c in keys],
            [torch.from_numpy(c.copy()) for c in queries])
    assert idx.dtype == torch.int32 and found.dtype == torch.bool
    assert np.array_equal(idx.numpy(), jidx)
    assert np.array_equal(found.numpy(), jfound)
    return idx.numpy(), found.numpy()


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 64, 1000])
def test_lex_searchsorted_matches_jax(k, n):
    """Small key ranges: long runs of duplicate keys and negative keys."""
    rng = np.random.default_rng(10 * k + n)
    keys = _sorted_keys(rng, k, n, -3, 4)
    queries = _queries(rng, keys, 96, -3, 4)
    idx, found = _check(keys, queries, as_block=n % 2 == 0)
    if n == 0:
        assert not idx.any() and not found.any()
        return
    # the first equal key, when there is one; else no key equals it
    for i in range(queries.shape[1]):
        row = tuple(queries[:, i])
        pos = [j for j in range(n) if tuple(keys[:, j]) == row]
        assert found[i] == bool(pos)
        if pos:
            assert idx[i] == pos[0]
    assert found[: 48].all()


def test_lex_searchsorted_wide_keys_and_both_ends():
    """Full-range int32 columns: every query beyond both ends lands at 0
    or N, and the port's lex_sort output searches as its input does."""
    rng = np.random.default_rng(3)
    n = 5000
    keys = rng.integers(-(2**31), 2**31 - 1, (3, n), dtype=np.int64).astype(np.int32)
    keys[0] = rng.integers(-5, 5, n)
    sk, _ = txutil.lex_sort(torch.from_numpy(keys))
    keys = torch.stack(sk).numpy()
    assert np.array_equal(keys, keys[:, np.lexsort(keys[::-1])])
    queries = _queries(rng, keys, 512, -5, 5)
    below = np.array([[-6], [0], [0]], np.int32)
    above = np.array([[5], [0], [0]], np.int32)
    queries = np.concatenate([queries, below, above, keys[:, :1], keys[:, -1:]],
                             axis=1)
    idx, found = _check(keys, queries, as_block=True)
    assert idx[-4] == 0 and idx[-3] == n and not found[-4:-2].any()
    assert idx[-2] == 0 and found[-2] and found[-1]
    _check(keys, queries, as_block=False)


def test_lex_searchsorted_rejects_mismatched_columns():
    keys = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="columns"):
        txutil.lex_searchsorted(keys, torch.zeros((1, 3), dtype=torch.int32))

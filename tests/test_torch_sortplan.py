"""The wrappers' side of the one-launch K4 and the onesweep radix sort, on
the CPU: ``xutil.sort_layout`` (the digit-pass plan and the scratch sizes
that ``csrc/sort.cuh`` reads) and its row limit, and the plain
``arena_assign`` against the JAX package's at the edges the cluster
kernel's shares and tiles meet (``csrc/arena.cu``: no task, fewer tasks
than blocks, a total past the arena, one task past the arena).

The kernels themselves are held against these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ketotpu.engine import xutil as jxutil
from ketotpu_torch.engine import xutil as txutil

torch.set_num_threads(1)


# -- the digit-pass plan ----------------------------------------------------------


def test_tenant_plane_keys_take_nine_passes():
    """The tenant plane's pack keys (qid 14, ns 16, rel 4, obj 32 bits,
    ``fastpath._sort_bits``): obj's four bytes first with the sign flip,
    then rel's one, ns's two, qid's two."""
    plan = txutil.sort_layout(65536, (14, 16, 4, 32))
    assert plan.passes == ((3, 0, 1), (3, 8, 1), (3, 16, 1), (3, 24, 1),
                           (2, 0, 0), (1, 0, 0), (1, 8, 0), (0, 0, 0),
                           (0, 8, 0))
    assert len(plan.passes) == 9


@pytest.mark.parametrize("bits,passes", [
    ((0,), 0), ((0, 0, 0), 0), ((1,), 1), ((8,), 1), ((9,), 2), ((31,), 4),
    ((32,), 4), ((32, 0, 32), 8), ((32,) * 8, 32), ((20, 32), 7),
])
def test_a_width_gives_its_bytes_as_passes(bits, passes):
    """ceil(b / 8) passes per column, none for a 0-bit column, least
    significant column first and, within one, least significant byte
    first; only 32-bit columns flip the sign bit."""
    plan = txutil.sort_layout(100, bits)
    assert len(plan.passes) == passes
    want = [(k, s, int(bits[k] == 32)) for k in reversed(range(len(bits)))
            for s in range(0, bits[k], 8)]
    assert list(plan.passes) == want
    for col, shift, flip in plan.passes:
        assert shift % 8 == 0 and shift < max(bits[col], 1)
        assert flip == (bits[col] == 32)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 70001, 10_619_481])
@pytest.mark.parametrize("bits", [(0,), (8,), (16,), (14, 16, 4, 32),
                                  (32, 32, 32, 32)])
def test_scratch_sizes(n, bits):
    """The permutation scratch (none for one pass, one permutation for two,
    two from three on) and the cleared words: per pass 256 histogram bins,
    one tile counter and 256 status words per tile of 1,024 rows."""
    plan = txutil.sort_layout(n, bits)
    p = len(plan.passes)
    assert txutil.SORT_TILE == 1024
    assert plan.perm_words == (0 if p < 2 else n if p == 2 else 2 * n)
    tiles = -(-n // 1024)
    assert plan.zeroed_words == p * (256 + 1 + 256 * tiles)
    if p == 0:
        assert plan.zeroed_words == 0


def test_rows_must_fit_the_status_count():
    """A status word keeps a tile's count in 30 bits: n < 2^30."""
    assert txutil.sort_layout(txutil.MAX_SORT_ROWS, (32,)).passes
    assert txutil.MAX_SORT_ROWS == (1 << 30) - 1
    with pytest.raises(ValueError, match="at most"):
        txutil.sort_layout(1 << 30, (32,))
    with pytest.raises(ValueError):
        txutil.sort_layout(-1, (32,))


@pytest.mark.parametrize("bits", [(), (33,), (-1,), (8,) * 9])
def test_bad_widths_and_key_counts_raise(bits):
    with pytest.raises(ValueError):
        txutil.sort_layout(10, bits)


def test_the_plain_sort_ignores_the_plan():
    """On CPU tensors ``lex_sort`` is the plain chain of stable sorts,
    whatever the widths promise: equal to numpy's stable lexsort."""
    rng = np.random.default_rng(3)
    keys = rng.integers(-3, 3, (3, 2049)).astype(np.int32)
    pay = np.arange(2049, dtype=np.int32)
    (k0, k1, k2), (p,) = txutil.lex_sort(torch.from_numpy(keys),
                                         torch.from_numpy(pay), bits=(2, 8, 32))
    order = np.lexsort(keys[::-1], axis=0)
    assert np.array_equal(p.numpy(), pay[order])
    assert np.array_equal(torch.stack((k0, k1, k2)).numpy(), keys[:, order])


# -- arena_assign at the cluster kernel's edges ---------------------------------------


def _counts(case):
    rng = np.random.default_rng(len(case))
    if case == "all-zero":
        return np.zeros(4096, np.int32), 512
    if case == "total-past-arena":
        return rng.integers(0, 6, 1000).astype(np.int32), 700
    if case == "one-task-past-arena":
        c = np.zeros(40, np.int32)
        c[[3, 17, 18]] = (2, 5000, 4)
        return c, 1024
    if case == "one-task":
        return np.array([7], np.int32), 16
    if case == "one-task-none":
        return np.array([0], np.int32), 16
    if case == "fewer-tasks-than-blocks":
        return np.array([0, 3, 0, 1, 2], np.int32), 9
    if case == "seven-tasks":
        return rng.integers(0, 4, 7).astype(np.int32), 8
    if case == "ragged-shares":
        # 8,193 tasks: seven shares of 1,025 and a last of 1,018
        c = rng.integers(0, 3, 8193).astype(np.int32)
        c[rng.random(8193) < 0.5] = 0
        return c, 16384
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "all-zero", "total-past-arena", "one-task-past-arena", "one-task",
    "one-task-none", "fewer-tasks-than-blocks", "seven-tasks", "ragged-shares",
])
def test_arena_assign_edges_match_jax(case):
    counts, arena = _counts(case)
    # one compile per shape (eager, each of its ops would compile apart)
    want = jax.jit(jxutil.arena_assign, static_argnums=1)(jnp.asarray(counts), arena)
    got = txutil.arena_assign(torch.from_numpy(counts), arena)
    for w, t in zip(want, got):
        assert t.dtype == torch.int32
        assert np.array_equal(t.numpy(), np.asarray(w))
    _offsets, total, parent, ordinal = got
    # every slot below min(total, arena) belongs to a task, the rest to none
    used = min(int(total), arena)
    assert (parent[:used] >= 0).all() and (parent[used:] == -1).all()
    assert (ordinal[used:] == 0).all()

"""The port's CUDA kernels on the card, against their plain PyTorch versions
on the same CUDA tensors (tolerance 0), at small and edge-case shapes.

These need a CUDA card and skip without one.  The suite's conftest
imports JAX, which the port does not need; on a GPU machine without JAX:

    python -m pytest --noconftest -o addopts= -p no:cacheprovider -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` holds the same comparisons at the served shapes (first
pass and retry) on the 10M-tuple graph.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ketotpu_torch import kernels
from ketotpu_torch.engine import fastpath as fp
from ketotpu_torch.engine import xutil
from ketotpu_torch.engine.device import DeviceCheckEngine
from ketotpu_torch.utils.synth import (
    build_synth_columnar,
    synth_queries,
    synth_queries_mixed,
)
from torch_parity import SMALL_SYNTH

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = build_synth_columnar(seed=0, **SMALL_SYNTH)
    return g, DeviceCheckEngine(g.store, g.manager)


@pytest.mark.parametrize("q,frontier,arena,boost", [
    (256, 8192, 16384, 1),  # the engine's bucket floor, roomy caps
    (256, 256, 64, 1),  # forced overflow at every level
    (301, 512, 5000, 1),  # ragged batch and arena sizes
    (8192, 8192, 16384, 1),  # the served first pass
    (8192, 32768, 65536, 4),  # the served retry
])
def test_every_kernel_matches_its_plain_version(engine, q, frontier, arena, boost):
    g, eng = engine
    qpack, _, _ = eng.pack_queries(synth_queries(g, q, seed=q))
    qpack = qpack[:, :q].copy()
    tables = eng.device_tables()
    sched = fp.level_schedule(q, frontier, arena, eng.max_depth, boost)
    rec = chip_smoke.Recorder()
    chip_smoke.check_kernels(tables, qpack, sched, eng.max_width, rec)
    assert all(e == 0 for e in rec.err.values())
    kw = dict(frontier=frontier, arena=arena, max_depth=eng.max_depth,
              max_width=eng.max_width, boost=boost)
    res = fp.run_fast_packed(tables, qpack, **kw)
    plain = fp.run_fast_packed_plain(tables, qpack, **kw)
    assert torch.equal(res.codes(), plain.codes())
    assert torch.equal(res.occ(), plain.occ())


@pytest.mark.parametrize("n,arena", [(1, 8), (4097, 9000), (5_000_000, 1 << 20)])
def test_arena_scan_across_tiles(engine, n, arena):
    """One tile, a ragged second tile, and more tile sums than one block
    scans at once (the chunked carry)."""
    rng = np.random.default_rng(n)
    counts = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).cuda()
    got = xutil.arena_assign(counts, arena)
    want = xutil._arena_assign_plain(counts, arena)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_engine_on_the_card_matches_the_oracle(engine):
    g, eng = engine
    queries = synth_queries(g, 512, seed=1)
    got = eng.batch_check(queries)
    assert got == [eng.oracle.check_is_member(q) for q in queries]


@pytest.mark.parametrize("graph,case", [
    ("synth", "first-pass"), ("synth", "retry"), ("synth", "tiny-arena"),
    ("synth", "one-level"), ("synth", "tiny-leaves"),
    ("synth", "global-claims"), ("fixture", "first-pass"),
    ("fixture", "retry"), ("fixture", "tiny-vcap"), ("fixture", "tiny-arena"),
    ("fixture", "one-level"), ("fixture", "global-claims"),
])
def test_every_algebra_kernel_matches_its_plain_version(engine, graph, case):
    """The tier-2 kernels step by step against their plain versions on the
    same state (every tensor of it, tolerance 0), at the engine's shapes
    and at shapes that force each capacity edge: arena overflow, visited
    overflow, the level budget, leaf drop.  A visited set whose claims do
    not fit the kernel's shared memory is refused."""
    if graph == "synth":
        g, eng = engine
        rows = synth_queries_mixed(g, 700, seed=21, general_frac=0.6)
    else:
        eng, batches = chip_smoke.fixture_engine()
        rows = [t for b in batches.values() for t in b]
    enc, gi = eng.encode_general(rows)
    boost = eng.retry_scale if case == "retry" else 1
    qpack, (sizes, fast_b, fast_sched, vcap) = eng.pack_general(enc, gi, boost)
    if case == "tiny-arena":
        sizes = (64,) * len(sizes)
    elif case == "tiny-vcap":
        vcap = 8
    elif case == "one-level":
        sizes = sizes[:1]
    elif case == "tiny-leaves":
        fast_b = 256
        fast_sched = fp.level_schedule(256, 512, 1024, eng.max_depth)
    elif case == "global-claims":
        vcap = 2 * kernels.VISITED_SMEM_SLOTS
    sched = (tuple(sizes), fast_b, fast_sched, vcap)
    rec = chip_smoke.Recorder()
    tag = ("t", chip_smoke.gen_key(qpack, boost, sched))
    if case == "global-claims":
        with pytest.raises(ValueError, match="visited set"):
            chip_smoke.check_general(eng.device_tables(), qpack, sched,
                                     eng.max_width, rec, tag)
        return
    codes, _occ = chip_smoke.check_general(
        eng.device_tables(), qpack, sched, eng.max_width, rec, tag)
    assert all(len(rec.calls[k]) for k in chip_smoke.GEN_KERNELS)
    assert all(e == 0 for e in rec.err.values())
    if graph == "fixture" and case == "retry":
        work = np.sum([chip_smoke.visited_counts(a[0], a[1])
                       for _t, a, _k in rec.calls["gen_visited"]], axis=0)
        assert work[1] and work[2], "keys must be inserted and seen"
    if case in ("tiny-arena", "tiny-vcap", "one-level", "tiny-leaves"):
        assert ((codes[: len(gi)] >> 2) & 1).any(), "the case must overflow"


def test_engine_answers_general_rows_on_the_card(engine):
    g, eng = engine
    rows = synth_queries_mixed(g, 600, seed=2)
    f0 = eng.fallbacks
    got = eng.batch_check(rows)
    assert got == [eng.oracle.check_is_member(q) for q in rows]
    assert eng.general_rows > 0 and eng.fallbacks == f0


def test_engine_refuses_a_visited_set_past_shared_memory(engine):
    """The visited-set kernel keeps its claims in one block's shared
    memory: an engine whose retry would need a larger set is refused when
    it is built, not in the middle of a batch."""
    g, _eng = engine
    with pytest.raises(ValueError, match="visited set"):
        DeviceCheckEngine(g.store, g.manager, vcap=kernels.VISITED_SMEM_SLOTS)

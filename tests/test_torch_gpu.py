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
from ketotpu_torch.engine import fastpath as fp
from ketotpu_torch.engine import xutil
from ketotpu_torch.engine.device import DeviceCheckEngine
from ketotpu_torch.utils.synth import build_synth_columnar, synth_queries
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

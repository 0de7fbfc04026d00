"""The port's CUDA kernels on the card, against their plain PyTorch versions
on the same CUDA tensors (tolerance 0), at small and edge-case shapes.

These need a CUDA card and skip without one.  The suite's conftest
imports JAX, which the port does not need; on a GPU machine without JAX:

    python -m pytest --noconftest -o addopts= -p no:cacheprovider -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` holds the same comparisons at the served shapes (first
pass and retry, each fused wave shape) on the 10M-tuple graph.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ketotpu_torch import kernels
from ketotpu_torch.engine import device as tdevice
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


@pytest.mark.parametrize("t,arena", [(8192, 16384), (32768, 65536)],
                         ids=["first-pass", "retry"])
@pytest.mark.parametrize("fill", ["sparse", "past-arena"])
def test_arena_assign_at_the_served_shapes(t, arena, fill):
    """K4 at the engine's first-pass (8,192 tasks, 16,384 slots) and retry
    (32,768 / 65,536) shapes, with a total under the arena and past it:
    offsets, total, parent and ordinal equal the plain version's, from one
    device launch per call (where the profiler sees the card)."""
    _needs_card()
    rng = np.random.default_rng(t + len(fill))
    counts = rng.integers(0, 8 if fill == "sparse" else 40, t)
    counts[rng.random(t) < 0.7] = 0
    counts = torch.from_numpy(counts.astype(np.int32)).cuda()
    rec = chip_smoke.Recorder()
    _off, total, _par, _ord = rec.run("arena_assign", counts, arena)
    assert rec.err["arena_assign"] == 0
    assert (int(total) > arena) == (fill == "past-arena")
    ops = chip_smoke.device_ops(lambda: xutil.arena_assign(counts, arena))
    if ops is not None:
        assert len(ops) == 1, ops


def test_arena_assign_leaves_its_state_zeroed():
    """K4's chained scan keeps its ticket and status words in one buffer
    per device across calls: after calls of changing sizes (one task,
    more tiles than the card holds blocks at once, no task, a ragged tile,
    the served first pass), each on an unaligned view, every result equals
    the plain version's and the buffer is zero again."""
    _needs_card()
    rng = np.random.default_rng(5)
    for t, a in ((1, 8), (600_000, 1 << 20), (0, 0), (1025, 9), (8192, 16384)):
        c = np.concatenate([[0], rng.integers(0, 4, t)]).astype(np.int32)
        counts = torch.from_numpy(c).cuda()[1:]
        got = xutil.arena_assign(counts, a)
        want = xutil._arena_assign_plain(counts, a)
        for x, y in zip(got, want):
            assert torch.equal(x, y), (t, a)
    torch.cuda.synchronize()
    state = xutil._ARENA_STATE[torch.cuda.current_device()]
    assert int(state.abs().sum()) == 0


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


@pytest.mark.parametrize("n", [1, 700, 1024, 4096, 5000])
def test_leo_probe_matches_its_plain_version(engine, n):
    """K6 on the card against its plain version: present and absent pairs,
    must-miss keys and keys above the last pair; at n == 1024 and 4096 the
    pairs fill their bucket (the search's clamped midpoint)."""
    from ketotpu_torch.leopard import device as leodev

    rng = np.random.default_rng(n)
    cap = leodev._pair_bucket(n)
    keys = np.unique(rng.integers(0, 1 << 20, 4 * n) << 32
                     | rng.integers(0, 1 << 16, 4 * n))[:n]
    sets = np.full(cap, leodev._PAIR_PAD, np.int32)
    elts = np.full(cap, leodev._PAIR_PAD, np.int32)
    sets[:n], elts[:n] = keys >> 32, keys & 0x7FFFFFFF
    hops = np.zeros(cap, np.int32)
    hops[:n] = rng.integers(0, 12, n)
    q = np.concatenate([keys[rng.integers(0, n, 3000)],
                        rng.integers(0, 1 << 20, 3000) << 32,
                        ((keys[-1] >> 32) + 1) << 32 | np.arange(500),
                        np.full(300, -1, np.int64)])
    q_set, q_elt = leodev.split_keys(q, len(q))
    args = [torch.from_numpy(a).cuda() for a in (sets, elts, hops, q_set, q_elt)]
    kernels.reset_launches()
    hit, hop = leodev.probe(*args)
    assert kernels.LAUNCHES["leo_probe"] == 1
    phit, phop = leodev._probe_plain(*args)
    assert torch.equal(hit, phit) and torch.equal(hop, phop)
    assert bool(hit[:3000].all()) and not bool(hit[6000:].any())


def test_unfused_short_chunk_probes_on_the_card(engine):
    """The unfused cascade with Leopard on searches a chunk of any size on
    the card: a chunk well under 2048 rows launches K6 once."""
    g, _eng = engine
    eng = DeviceCheckEngine(g.store, g.manager)
    rows = chip_smoke.membership_queries(g, 43, 600, 300, 300)
    assert len(rows) < 2048
    eng.batch_check(rows)  # warm
    kernels.reset_launches()
    got = eng.batch_check(rows)
    assert kernels.LAUNCHES["leo_probe"] == 1
    assert eng.leopard_answered > 0
    assert got == [eng.oracle.check_is_member(q) for q in rows]


@pytest.fixture(scope="module")
def fused_engine(engine):
    """The fused engine, Leopard on, over the small synth graph."""
    g, _eng = engine
    return g, DeviceCheckEngine(g.store, g.manager, fused_dispatch=True)


@pytest.mark.parametrize("traffic,depth,variant", [
    ("mixed", 0, "served"), ("mixed", 2, "two-lanes"), ("mixed", 0, "modes"),
    ("members", 0, "modes"),
    ("members", 0, "served"), ("members", 1, "served"),
    ("mixed", 0, "no-fast"), ("mixed", 0, "no-general"),
    ("mixed", 0, "tier0-only"), ("mixed", 0, "no-pairs"), ("mixed", 0, "tiny"),
])
def test_every_wave_kernel_matches_its_plain_version(fused_engine, traffic,
                                                     depth, variant):
    """The fused wave's four kernels call by call against their plain
    versions, and the whole int32 output against the plain wave
    (tolerance 0): mixed and membership traffic, each tier absent in turn,
    no pair columns, hand-set probe modes, two tier-1 lanes, and caps so
    small that every retry lane takes rows."""
    g, eng = fused_engine
    if traffic == "mixed":
        rows = synth_queries_mixed(g, 900, seed=31, general_frac=0.4)
    else:
        rows = chip_smoke.membership_queries(g, 37, 800, 400, 300)
    plan = eng.plan_wave(rows, depth)
    qpack, tables, kw = plan.qpack, plan.tables, dict(plan.kwargs)
    if variant == "two-lanes":
        kw["retry_lanes"] = 2
    elif variant == "modes":
        qpack = qpack.copy()
        qpack[7] = np.random.default_rng(3).integers(0, 5, qpack.shape[1])
    elif variant in ("no-fast", "tier0-only"):
        kw.update(fast_sched=None, retry_sched=None, retry_lanes=0)
    if variant in ("no-general", "tier0-only"):
        kw.update(gen=None, gen_retry=None)
    elif variant == "no-pairs":
        tables = {k: v for k, v in tables.items() if not k.startswith("leo_")}
    elif variant == "tiny":
        tiny = DeviceCheckEngine(g.store, g.manager, fused_dispatch=True,
                                 frontier=1024, arena=512, gen_arena=64)
        plan = tiny.plan_wave(rows, depth)
        qpack, tables, kw = plan.qpack, plan.tables, plan.kwargs
    plan = plan._replace(tables=tables)
    rec = chip_smoke.Recorder()
    out = chip_smoke.check_wave(plan, rec, ("t", "wave"), qpack=qpack, kwargs=kw)
    assert all(e == 0 for e in rec.err.values())
    assert len(rec.calls["wave_tier0"]) == len(rec.calls["wave_pack"]) == 1
    rows_out = out[: plan.n]
    if variant == "tiny":
        assert ((rows_out >> 8) & 1).any() and ((rows_out >> 9) & 1).any()
    if traffic == "members" and depth == 0 and variant == "served":
        assert ((rows_out >> 6) & 1).all()
    if traffic == "members" and variant == "modes":
        # hits within the budget: the LM_HIT_ONLY rows that hit answer
        hit_only = qpack[7][: plan.n] == 4
        assert ((rows_out >> 6) & 1)[hit_only].any()


def test_fused_engine_on_the_card_matches_the_oracle(fused_engine):
    g, eng = fused_engine
    rows = synth_queries_mixed(g, 600, seed=5) + \
        chip_smoke.membership_queries(g, 41, 300, 150, 150)
    kernels.reset_launches()
    got = eng.batch_check(rows)
    assert got == [eng.oracle.check_is_member(q) for q in rows]
    assert eng.leopard_answered > 0
    assert eng.fused_waves == eng.fused_d2h_fetches
    assert all(kernels.LAUNCHES[k] for k in chip_smoke.WAVE_KERNELS)


# -- the delta overlay (K2's overlay branches) -------------------------------


@pytest.fixture(scope="module")
def written():
    """A fused engine over its own small synth graph after chip_smoke's
    write batches a1, b and c, drained in one batch: the overlay holds
    added and deleted pairs, a virtual node and dirty rows.  Returns (graph,
    engine, the rows those writes touched)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ketotpu_torch.api.types import RelationTuple

    g = build_synth_columnar(seed=1, **SMALL_SYNTH)
    eng = DeviceCheckEngine(g.store, g.manager, fused_dispatch=True)
    eng.batch_check(synth_queries(g, 64, seed=3))
    rows = []
    for name, ins, dels, touched, _tier, _leo in chip_smoke.write_script(
            g, np.random.default_rng(43)):
        if name in ("a1", "b", "c"):
            g.store.transact_relation_tuples(insert=ins, delete=dels)
            rows += [RelationTuple.from_string(r) for r in touched]
    eng.batch_check(rows)
    assert eng.overlay_applies == 1 and eng.rebuilds == 1
    st = eng._overlay
    assert st.new_nodes and st.dirty_nodes and st.pair_net
    return g, eng, rows + synth_queries_mixed(g, 300, seed=7)


def test_overlay_kernels_match_their_plain_versions(written):
    """probe_level, pack_verdicts, gen_classify and wave_lane (and every
    other kernel of the three tiers) call by call against their plain
    versions over tables with a non-empty overlay, dirty bits included."""
    g, eng, rows = written
    rec = chip_smoke.Recorder()
    tables = eng.device_tables()
    qpack, err, general = eng.pack_queries(rows)
    for boost in (1, eng.retry_scale):
        shape = (qpack.shape[1], boost * eng.frontier, boost * eng.arena, boost)
        codes, _occ = chip_smoke.check_kernels(
            tables, qpack, chip_smoke.schedule(shape, eng.max_depth),
            eng.max_width, rec, ("t", shape))
        assert ((codes[: len(rows)] >> 2) & 1).any()  # dirty rows
    _gi, _a, _fb, stats = chip_smoke.replay_general(eng, tables, rows, rec, "g")
    assert stats["general"] and stats["dirty"]
    plan = eng.plan_wave(rows)
    chip_smoke.check_wave(plan, rec, ("w", chip_smoke.wave_key(plan)))
    assert all(e == 0 for e in rec.err.values())
    for k in chip_smoke.OVERLAY_KERNELS:
        assert rec.calls[k], k


def test_written_engine_on_the_card_matches_the_oracle(written):
    g, eng, rows = written
    fb = eng.fallbacks
    assert eng.batch_check(rows) == [eng.oracle.check_is_member(q) for q in rows]
    assert eng.fallbacks > fb  # dirty rows went to the oracle
    eng.fused_dispatch = False
    try:
        assert eng.batch_check(rows) == [eng.oracle.check_is_member(q)
                                         for q in rows]
    finally:
        eng.fused_dispatch = True


def test_overflowing_overlay_folds_on_the_card():
    """Past ``max_overlay_pairs`` the changes since the base fold into it:
    no re-projection, the device shapes unchanged, verdicts exact, and
    every kernel of the three tiers equal to its plain version on the
    folded tables (base hash tables spliced in place)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ketotpu_torch.api.types import RelationTuple

    g = build_synth_columnar(seed=2, **SMALL_SYNTH)
    eng = DeviceCheckEngine(g.store, g.manager, fused_dispatch=True)
    eng.max_overlay_pairs = 64
    eng.batch_check(synth_queries(g, 64, seed=3))
    shapes = eng._array_shapes(eng.device_tables())
    burst = [RelationTuple.from_string(f"Group:g{i % 200}#members@u{7 * i + 1}")
             for i in range(100)]
    g.store.transact_relation_tuples(insert=burst)
    rows = burst + synth_queries(g, 200, seed=5)
    assert eng.batch_check(rows) == [eng.oracle.check_is_member(q) for q in rows]
    assert (eng.folds, eng.rebuilds, eng.last_write["tier"]) == (1, 1, "fold")
    assert eng._array_shapes(eng.device_tables()) == shapes
    rec = chip_smoke.Recorder()
    tables = eng.device_tables()
    qpack, _err, _general = eng.pack_queries(rows)
    shape = (qpack.shape[1], eng.frontier, eng.arena, 1)
    chip_smoke.check_kernels(tables, qpack,
                             chip_smoke.schedule(shape, eng.max_depth),
                             eng.max_width, rec, ("t", shape))
    chip_smoke.replay_general(eng, tables, rows, rec, "g")
    chip_smoke.replay_waves(eng, rows, rec, "w")
    assert all(e == 0 for e in rec.err.values())
    for k in ("probe_level", "pack_verdicts", "wave_lane"):
        assert rec.calls[k], k


# -- Expand (K9) ------------------------------------------------------------------


def _expand_roots(g, eng, n):
    """Doc#parents, Group#members and Folder#viewers roots of the graph."""
    from ketotpu_torch.api.types import SubjectSet

    rng = np.random.default_rng(n)
    docs = [SubjectSet("Doc", g.docs[int(i)], "parents")
            for i in rng.choice(len(g.docs), n, replace=False)]
    groups = [SubjectSet("Group", g.groups[int(i)], "members")
              for i in rng.choice(len(g.groups), n, replace=False)]
    folders = [SubjectSet("Folder", g.folders[int(i)], "viewers")
               for i in rng.choice(len(g.folders), n, replace=False)]
    return docs + groups + folders


@pytest.mark.parametrize("n,cap", [(1, 65536), (40, 65536), (170, 65536),
                                   (170, 64)])
def test_expand_kernels_match_their_plain_versions(engine, n, cap, monkeypatch):
    """expand_roots and expand_level (and K4 between them) call by call,
    then the whole walk, against the plain versions on the base tables;
    the trees against the oracle's."""
    from ketotpu_torch.engine.oracle import ExpandEngine

    g, eng = engine
    roots = _expand_roots(g, eng, n)
    snap, tables, _ov = eng.expand_view()
    rec = chip_smoke.Recorder()
    _shape, over = chip_smoke.hold_expand(tables, snap.vocab, roots, rec, "x",
                                          cap=cap)
    assert all(e == 0 for e in rec.err.values())
    assert rec.calls["expand_roots"] and rec.calls["expand_level"]
    assert over.any() == (cap < 65536)
    oracle = ExpandEngine(g.store, max_depth=eng.max_depth)
    monkeypatch.setattr(tdevice, "EXPAND_CAP", cap)
    trees = eng.batch_expand(roots, 5)
    assert eng.last_expand["over"] == int(over.sum())
    assert [chip_smoke.tree_json(t) for t in trees] == [
        chip_smoke.tree_json(oracle.build_tree(r, 5)) for r in roots]


def test_expand_kernels_match_their_plain_versions_on_the_overlay(written):
    """The walk on tables with a non-empty overlay: a virtual node reads 0
    members, a dirty row keeps its base degree; the trees (the overlay's
    members merged on the host) against the oracle's."""
    from ketotpu_torch.api.types import SubjectSet
    from ketotpu_torch.engine.oracle import ExpandEngine

    g, eng, rows = written
    roots = list(dict.fromkeys(SubjectSet(t.namespace, t.object, t.relation)
                               for t in rows))[:256]
    snap, tables, ov = eng.expand_view()
    assert ov is not None and ov.new_nodes and (ov.added or ov.deleted)
    rec = chip_smoke.Recorder()
    chip_smoke.hold_expand(tables, snap.vocab, roots, rec, "x")
    assert all(e == 0 for e in rec.err.values())
    kernels.reset_launches()
    trees = eng.batch_expand(roots, 5)
    assert kernels.LAUNCHES["expand_roots"] == 1
    oracle = ExpandEngine(g.store, max_depth=eng.max_depth)
    assert [chip_smoke.tree_json(t) for t in trees] == [
        chip_smoke.tree_json(oracle.build_tree(r, 5)) for r in roots]


# -- the graph-sharded mesh (K10) ------------------------------------------------


def _cuda_mesh(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ketotpu_torch.parallel import make_mesh

    return make_mesh(n, axis="shard", devices=["cuda:0"] * n)


def _children(rng, a, dev):
    """``a`` random children: a fifth dead, the rest over 4 namespaces and
    a few thousand objects (so several land on each shard), 64 queries."""
    qid = rng.integers(0, 64, a).astype(np.int32)
    qid[rng.random(a) < 0.2] = -1

    def col(lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, a).astype(np.int32)).to(dev)

    return fp.Items(torch.from_numpy(qid).to(dev), col(0, 4), col(0, 3000),
                    col(0, 16), col(0, 6),
                    torch.from_numpy(rng.random(a) < 0.5).to(dev),
                    torch.from_numpy(rng.random(a) < 0.5).to(dev))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("a,cap", [(1, 8), (5000, 8), (5000, 700),
                                   (65536, 4096), (65536, 65536)])
def test_shard_kernels_match_their_plain_versions(n, a, cap):
    """shard_owner, shard_route (send block and over bits; the small caps
    overflow) and shard_merge on the card against their plain versions."""
    mesh = _cuda_mesh(n)
    rng = np.random.default_rng(n * 100003 + a)
    dev = mesh.devices[0]
    ch = _children(rng, a, dev)
    q_over = torch.from_numpy((rng.random(64) < 0.1).astype(np.int32)).to(dev)
    rec = chip_smoke.Recorder()
    rec.run("shard_owner", ch.ns, ch.obj, n)
    send, qo = rec.run("shard_route", ch, q_over, n_shards=n, cap=cap)
    stage = torch.from_numpy(rng.integers(0, 2, (n, 3, a)).astype(np.int32)).to(dev)
    rec.run("shard_merge", stage)
    assert all(e == 0 for e in rec.err.values())
    alive = int((ch.qid >= 0).sum())
    sent = int((send[:, 0] >= 0).sum())
    if cap >= a:
        assert sent == alive and torch.equal(qo, q_over)
    elif a > 8 * n * cap:  # every destination overflows
        assert sent == n * cap < alive and bool((qo > q_over).any())


@pytest.fixture(scope="module")
def mesh_engines(engine):
    """The small synth graph on four shards of one card and on one."""
    g, _eng = engine
    from ketotpu_torch.parallel import MeshCheckEngine

    return g, {n: MeshCheckEngine(g.store, g.manager, mesh_devices=n,
                                  devices=["cuda:0"] * n) for n in (1, 4)}


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("frontier,arena", [(2048, 8192), (256, 96)])
def test_sharded_check_kernels_match_their_plain_versions(mesh_engines, n,
                                                          frontier, arena):
    """The sharded fast run step by step (every kernel against its plain
    version), its verdict bytes against the plain run's; the small caps
    overflow the route and the frontier."""
    from ketotpu_torch.parallel import graphshard as gs

    g, meng = mesh_engines
    eng = meng[n]
    queries = synth_queries(g, min(512, frontier), seed=n)
    enc = eng._encode(eng.snapshot(), queries, 0)
    rec = chip_smoke.Recorder()
    kw = dict(frontier=frontier, arena=arena, max_depth=eng.max_depth,
              max_width=eng.max_width)
    got = gs._sharded_fast(rec.mesh_ops(), eng._stacked, enc, eng.mesh, **kw)
    want = gs._sharded_fast(gs._PLAIN_OPS, eng._stacked, enc, eng.mesh, **kw)
    assert torch.equal(got, want)
    assert all(e == 0 for e in rec.err.values())
    assert rec.calls["shard_route"] and rec.calls["shard_merge"]
    if arena < 8192:
        assert ((got >> 1) & 1).any()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("boost", [1, 4])
def test_sharded_general_kernels_match_their_plain_versions(n, boost):
    """The sharded tier-2 program step by step on the AND/NOT fixture
    (every state against the plain version's), its codes and per-shard
    occupancy rows against the plain program's."""
    from ketotpu_torch.parallel import MeshCheckEngine
    from ketotpu_torch.parallel import graphshard as gs

    _cuda_mesh(n)
    eng, batches = chip_smoke.fixture_engine(
        MeshCheckEngine, mesh_devices=n, devices=["cuda:0"] * n)
    rows = [t for name, b in batches.items() if name != "flood" for t in b]
    enc, gi = eng.encode_general(rows)
    qpack, (sizes, fast_b, fast_sched, vcap) = eng.pack_general(enc, gi, boost)
    kw = dict(sizes=sizes, fast_b=fast_b, fast_sched=fast_sched,
              max_width=eng.max_width, vcap=vcap)
    rec = chip_smoke.Recorder()
    got = gs.fetch_general(gs._sharded_general(rec.mesh_ops(), eng._stacked,
                                               qpack, eng.mesh, **kw))
    want = gs.fetch_general(gs._sharded_general(gs._PLAIN_OPS, eng._stacked,
                                                qpack, eng.mesh, **kw))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert all(e == 0 for e in rec.err.values())
    for k in ("shard_owner", "shard_merge_classified", "shard_merge_child",
              "gen_visited"):
        assert rec.calls[k], k


@pytest.mark.parametrize("n", [1, 4])
def test_mesh_engine_on_the_card_matches_the_single_engine(mesh_engines, engine,
                                                           n):
    g, meng = mesh_engines
    _g, eng = engine
    rows = synth_queries_mixed(g, 700, seed=11)
    kernels.reset_launches()
    got = meng[n].batch_check(rows)
    assert got == eng.batch_check(rows)
    assert got == [eng.oracle.check_is_member(q) for q in rows]
    for k in chip_smoke.MESH_KERNELS:
        assert kernels.LAUNCHES[k] > 0, k


# -- K5b: the sort-based pack and the radix sort under it ---------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("bits,n", [
    ((32,), 1), ((32,), 1023), ((32, 32), 1024), ((14, 16, 4, 32), 1025),
    ((14, 16, 4, 32), 65536), ((8, 0, 32), 4097), ((32, 32, 32, 32), 70001),
    ((20, 32), 1 << 20),
])
def test_lex_sort_matches_its_plain_version(bits, n):
    """The radix sort on the card, stable as its plain version: keys and
    payload equal row for row, negatives and many ties included."""
    _needs_card()
    rng = np.random.default_rng(n + len(bits))
    keys = []
    for b in bits:
        if b == 32:
            k = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
            k[: n // 2] = rng.integers(-3, 3, n // 2)  # ties and negatives
        else:
            k = rng.integers(0, 1 << b, n) if b else np.zeros(n, np.int64)
        keys.append(torch.from_numpy(k.astype(np.int32)).cuda())
    payload = [torch.from_numpy(rng.integers(-99, 99, n).astype(np.int32)).cuda()
               for _ in range(2)]
    rec = chip_smoke.Recorder()
    kernels.reset_launches()
    rec.run("lex_sort", keys, *payload, bits=bits)
    assert rec.err["lex_sort"] == 0 and kernels.LAUNCHES["lex_sort"] == 1


@pytest.mark.parametrize("n", [xutil.SORT_TILE - 1, xutil.SORT_TILE,
                               xutil.SORT_TILE + 1, 16384, 65536])
@pytest.mark.parametrize("keys_are", ["tenant-keys", "all-equal"])
def test_lex_sort_at_tile_edges(n, keys_are):
    """The onesweep sort at one tile of rows, one less and one more, and at
    the tenant plane's pack sizes, on the pack's key widths (14, 16, 4, 32)
    and on keys all equal (every row one digit in every pass: the payload
    keeps its row order); then at most 2 + (digit passes) device
    operations per call (the memset, the histograms, one launch per pass)
    where the profiler sees the card."""
    _needs_card()
    bits = (14, 16, 4, 32)
    rng = np.random.default_rng(n)
    if keys_are == "all-equal":
        keys = np.tile(np.array([[5], [77], [3], [-9]], np.int32), (1, n))
    else:
        keys = np.stack([rng.integers(0, 1 << b, n) if b < 32 else
                         rng.integers(-(1 << 31), 1 << 31, n) for b in bits])
        keys[:, rng.integers(0, n, n // 3)] = keys[:, rng.integers(0, n, n // 3)]
    keys = torch.from_numpy(keys.astype(np.int32)).cuda()
    pay = torch.arange(n, dtype=torch.int32, device="cuda")
    rec = chip_smoke.Recorder()
    (_k, (sp,)) = rec.run("lex_sort", keys, pay, bits=bits)
    assert rec.err["lex_sort"] == 0
    if keys_are == "all-equal":
        assert torch.equal(sp, pay)
    ops = chip_smoke.device_ops(lambda: xutil.lex_sort(keys, pay, bits=bits))
    if ops is not None:
        assert len(ops) <= 2 + len(xutil.sort_layout(n, bits).passes), ops


def _sort_children(rng, a, q, dev, as_rows):
    """``a`` children with a fifth dead and many duplicate keys, under
    2^16 namespaces and 16 relations."""
    cols = [rng.integers(-1, q, a), rng.integers(0, 1 << 16, a),
            rng.integers(0, 5000, a), rng.integers(0, 16, a),
            rng.integers(0, 6, a), rng.random(a) < 0.5, rng.random(a) < 0.3]
    cols[0][rng.random(a) < 0.2] = -1
    src, dst = rng.integers(0, a, a // 3), rng.integers(0, a, a // 3)
    for c in range(4):
        cols[c][dst] = cols[c][src]
    if as_rows:
        return torch.from_numpy(np.stack([c.astype(np.int32) for c in cols],
                                         axis=1).copy()).to(dev)
    return fp.Items(*(torch.from_numpy(c.astype(np.int32)).to(dev)
                      for c in cols[:5]),
                    torch.from_numpy(cols[5]).to(dev),
                    torch.from_numpy(cols[6]).to(dev))


@pytest.mark.parametrize("as_rows", [False, True], ids=["items", "rows"])
@pytest.mark.parametrize("a,q,f", [(8, 4, 8), (1000, 300, 256),
                                   (16384, 8192, 8192), (65536, 8192, 32768),
                                   (65536, 8192, 64)])
def test_pack_sort_matches_its_plain_version(a, q, f, as_rows):
    """pack_sort (and the lex_sort it runs) on the card against their
    plain versions: the frontier, the over bits and the occupancy."""
    _needs_card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(a + f)
    ch = _sort_children(rng, a, q, dev, as_rows)
    qf = torch.from_numpy((rng.random(q) < 0.2).astype(np.int32)).to(dev)
    qo = torch.from_numpy((rng.random(q) < 0.1).astype(np.int32)).to(dev)
    occ = torch.zeros(1, dtype=torch.int32, device=dev)
    rec = chip_smoke.Recorder()
    rec.run("pack_sort", ch, qf, qo, frontier=f, nsb=16, relb=4, occ_out=occ)
    assert rec.err["pack_sort"] == 0 and rec.err["lex_sort"] == 0
    assert len(rec.calls["lex_sort"]) == 1


def test_plane_past_31_key_bits_on_the_card():
    """A 128-tenant plane (namespace dim 1024, relation dim 512) at Q =
    8192: every tier-1 kernel held against its plain version level by
    level, every pack by sort; the engine's verdicts are the oracle's."""
    _needs_card()
    from ketotpu_torch.api.types import RelationTuple
    from ketotpu_torch.opl.parser import parse
    from ketotpu_torch.storage.memory import InMemoryTupleStore
    from ketotpu_torch.storage.namespaces import StaticNamespaceManager
    from ketotpu_torch.tenancy import TenantPlane
    from ketotpu_torch.utils.synth import SYNTH_OPL
    from torch_parity import fill_plane, tenant_queries

    ns, _ = parse(SYNTH_OPL)
    plane = TenantPlane(InMemoryTupleStore(), StaticNamespaceManager(ns),
                        max_tenants=129)
    fill_plane(plane, RelationTuple.from_string, SYNTH_OPL, 128)
    eng = DeviceCheckEngine(plane.fused_store, plane.manager)
    rows = [RelationTuple.from_string(s) for s in tenant_queries(128, 8000, 7)]
    qpack, _, _ = eng.pack_queries(rows)
    tables = eng.device_tables()
    sched = fp.level_schedule(qpack.shape[1], eng.frontier, eng.arena,
                              eng.max_depth, 1)
    rec = chip_smoke.Recorder()
    chip_smoke.check_kernels(tables, qpack, sched, eng.max_width, rec)
    assert all(e == 0 for e in rec.err.values())
    assert rec.calls["pack_sort"] and not rec.calls["pack_scatter"]
    kernels.reset_launches()
    got = eng.batch_check(rows)
    assert kernels.LAUNCHES["pack_sort"] > 0 and kernels.LAUNCHES["lex_sort"] > 0
    assert got[::13] == [eng.oracle.check_is_member(q) for q in rows[::13]]


@pytest.mark.parametrize("k,n,q", [
    (1, 0, 5), (1, 1, 7), (2, 1025, 4097), (4, 65536, 65536), (8, 5000, 300),
    (4, 1 << 20, 1 << 16),
])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_lex_searchsorted_matches_its_plain_version(k, n, q, order):
    """The binary search on the card against the plain unrolled search:
    idx and found equal for every query, on keys sorted by ``lex_sort``
    (queries half drawn from the keys, negatives and both ends) and on
    unsorted keys, where both take the same midpoints."""
    _needs_card()
    rng = np.random.default_rng(k * 31 + n)
    keys = torch.from_numpy(rng.integers(-4, 4, (k, n)).astype(np.int32)).cuda()
    if order == "sorted" and n:
        keys = torch.stack(xutil.lex_sort(keys)[0])
    queries = torch.from_numpy(rng.integers(-6, 6, (k, q)).astype(np.int32)).cuda()
    if n:
        take = torch.from_numpy(rng.integers(0, n, q // 2)).cuda()
        queries[:, : q // 2] = keys[:, take]
    rec = chip_smoke.Recorder()
    kernels.reset_launches()
    rec.run("lex_searchsorted", keys, queries)
    assert rec.err["lex_searchsorted"] == 0
    assert kernels.LAUNCHES["lex_searchsorted"] == 1
    if order == "sorted" and n:
        idx, found = xutil.lex_searchsorted(tuple(keys), tuple(queries))
        assert found[: q // 2].all()


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("frontier,arena,depth", [(1024, 2048, 5), (64, 64, 3)])
def test_shard_fast_check_kernels_match_their_plain_versions(engine, n, frontier,
                                                             arena, depth):
    """The query-data-parallel fast path on n slices of the card: every
    step's kernel calls against their plain versions, and the found / over
    bits against the plain run's; the small caps overflow at the last
    level, whose children are built too."""
    from ketotpu_torch.parallel import mesh as pm

    g, eng = engine
    qpack, _, _ = eng.pack_queries(synth_queries(g, 512, seed=n))
    qpack = np.ascontiguousarray(qpack[:, : min(qpack.shape[1], frontier * n)])
    mesh = pm.make_mesh(devices=["cuda:0"] * n)
    kw = dict(frontier=frontier, arena=arena, max_depth=depth,
              max_width=eng.max_width, axis="data", active=qpack[5])
    tables = eng.device_tables()
    rec = chip_smoke.Recorder()
    got = pm._shard_fast(rec.ops().fast, tables, qpack[:5], mesh, **kw)
    want = pm._shard_fast(fp._PLAIN_OPS, tables, qpack[:5], mesh, **kw)
    assert all(e == 0 for e in rec.err.values())
    assert torch.equal(got.found, want.found) and torch.equal(got.over, want.over)
    kernels.reset_launches()
    res = pm.shard_fast_check(tables, qpack[:5], mesh, **kw)
    assert torch.equal(res.found, got.found) and torch.equal(res.over, got.over)
    assert kernels.LAUNCHES["init_state"] == n
    assert kernels.LAUNCHES["probe_level"] == n * depth
    if arena < 2048:
        assert res.over.any()


@pytest.mark.parametrize("n", [1, 4])
def test_shard_general_check_kernels_match_their_plain_versions(n):
    """The query-data-parallel K7 program on the AND/NOT fixture, n slices
    of the card: codes and each slice's occupancy row against the plain
    program's."""
    from ketotpu_torch.engine import algebra as alg
    from ketotpu_torch.parallel import mesh as pm

    _needs_card()
    eng, batches = chip_smoke.fixture_engine()
    rows = [t for name, b in batches.items() if name != "flood" for t in b]
    enc, gi = eng.encode_general(rows)
    qpack, _ = eng.pack_general(enc, gi, 1)
    qpack = qpack[:, : qpack.shape[1] // n * n]
    sizes, fast_b, fast_sched, vcap = eng._gen_schedule(qpack.shape[1] // n, 1)
    kw = dict(sizes=sizes, fast_b=fast_b, fast_sched=fast_sched,
              max_width=eng.max_width, vcap=vcap, axis="data")
    mesh = pm.make_mesh(devices=["cuda:0"] * n)
    tables = eng.device_tables()
    codes, occ = pm.shard_general_check(tables, qpack, mesh, **kw)
    pcodes, pocc = pm._shard_general(alg._PLAIN_OPS, tables, qpack, mesh, **kw)
    assert torch.equal(codes, pcodes) and torch.equal(occ, pocc)
    assert occ.shape[0] == n

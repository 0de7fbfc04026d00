"""Port parity: the tier-2 algebra program (K7) against the JAX package's
``engine/algebra.py``, at tolerance 0.

Both sides read the same snapshot arrays (the JAX side its device_put copy,
the port ``upload(..., "cpu")``), so the port runs its plain PyTorch
versions here; ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the
CUDA kernels against those plain versions on the card.

The JAX-shaped functions (``_classify_level``, ``_visited``,
``_construct_level``, ``_collect_fast``, ``_fast_subrun``) run eagerly on
both sides over the same seeded level state.  The whole program
(``run_general_packed_plain`` against the jitted ``run_general_packed``)
runs at one static shape per graph, three in all, because XLA:CPU
compiles each shape anew: the tier-2 fixture at small capacities (each
query batch reaches one capacity edge), the small synth graph and the
rewrites fixture at roomier ones.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.engine import algebra as jalg
from ketotpu.engine import delta as jdelta
from ketotpu.engine.vocab import Vocab as JVocab
from ketotpu.opl.parser import parse as jparse
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu.utils import synth as jsynth
from ketotpu_torch.engine import algebra as talg
from ketotpu_torch.engine import fastpath as tfp
from ketotpu_torch.engine.device import upload
from torch_parity import (
    ALGEBRA_BATCHES,
    ALGEBRA_OPL,
    FIXTURES,
    REWRITES_QUERIES,
    REWRITES_TUPLES,
    SMALL_SYNTH,
    algebra_tuples,
    granted_checks,
    release_jax_caches,  # noqa: F401 - autouse fixture
)

torch.set_num_threads(1)

MAX_WIDTH = 100

#: one static shape per graph: (Q, sizes, fast_b, sub-run schedule, vcap)
SHAPES = {
    # small on purpose: each fixture batch reaches one capacity edge
    "algebra": (64, (96, 96, 64, 64, 64, 64), 16,
                tfp.level_schedule(16, 64, 128, 5), 8),
    "synth": (256, (768, 1024, 1024, 768, 512, 256), 512,
              tfp.level_schedule(512, 1024, 2048, 5), 256),
    "rewrites": (64, (192, 256, 256, 128), 128,
                 tfp.level_schedule(128, 256, 512, 5), 64),
}


def _np(x):
    return np.asarray(x)


def _snapshot_from(tuples, source):
    namespaces, errs = jparse(source)
    assert not errs, errs
    return jdelta.build_snapshot_cols(
        jdelta.TupleColumns.from_tuples(
            JVocab(), [JTuple.from_string(s) for s in tuples]),
        JManager(namespaces),
    )


def _graph(name):
    if name == "synth":
        g = jsynth.build_synth_columnar(seed=0, **SMALL_SYNTH)
        cols, alive, _tail, _head = g.store.export_columns()
        snap = jdelta.build_snapshot_cols(
            jdelta.TupleColumns.from_arrays(g.store.vocab, cols, alive), g.manager)
        return g, snap
    if name == "rewrites":
        src = (FIXTURES / "rewrites_namespaces.keto.ts").read_text()
        return None, _snapshot_from(REWRITES_TUPLES, src)
    return None, _snapshot_from(algebra_tuples(), ALGEBRA_OPL)


@pytest.fixture(scope="module")
def graphs():
    """name -> (synth graph or None, snapshot, JAX tables, port tables)."""
    out = {}
    for name in SHAPES:
        g, snap = _graph(name)
        arrays = snap.check_arrays()
        out[name] = (g, snap, jax.device_put(arrays), upload(arrays, "cpu"))
    return out


def _qpack(snap, queries, q, depth=5):
    """int32[6, q]: (ns, obj, rel, subj, depth, active), padded inactive."""
    v = snap.vocab
    n = len(queries)
    rows = np.zeros((6, q), np.int32)
    rows[:4, n:] = -1
    rows[4, n:] = 1
    rows[0, :n] = [v.namespaces.lookup(t.namespace) for t in queries]
    rows[1, :n] = [v.objects.lookup(t.object) for t in queries]
    rows[2, :n] = [v.relations.lookup(t.relation) for t in queries]
    rows[3, :n] = [v.subject_key(t.subject) for t in queries]
    rows[4, :n] = depth
    rows[5, :n] = 1
    return rows


def _assert_dict(port, want, what):
    assert set(port) == set(want), (what, set(port) ^ set(want))
    for k in want:
        w = _np(want[k])
        p = port[k].numpy()
        assert p.dtype == w.dtype, (what, k, p.dtype, w.dtype)
        assert np.array_equal(p, w), (what, k)


def _flags(x):
    """A port 0/1 int32 flag vector as the JAX bool vector."""
    return x.numpy().astype(bool)


# -- the JAX-shaped functions, one level at a time ------------------------------


def _random_level(rng, snap, F, Q, *, real_frac=0.5, queries=None):
    """A seeded level state: half random (out-of-range ids, negative
    depths, dead slots included), half taken from real query rows."""
    NS, R = snap.flat.direct_ok.shape
    P = snap.op.p_kind.shape[0]
    n_obj = max(len(snap.vocab.objects), 2)
    t = dict(
        kind=rng.integers(0, 3, F),
        ns=rng.integers(-1, NS + 1, F),
        obj=rng.integers(-1, n_obj, F),
        rel=rng.integers(-1, R + 1, F),
        d=rng.integers(-1, 6, F),
        skip=rng.random(F) < 0.3,
        force=rng.random(F) < 0.3,
        prog=rng.integers(-1, P, F),
        qid=rng.integers(-1, Q, F),
        vscope=rng.integers(-1, 4 * F, F),
        parent=rng.integers(-1, F, F),
        neg=rng.random(F) < 0.2,
    )
    if queries is not None:
        qp = _qpack(snap, queries, len(queries))
        take = rng.random(F) < real_frac
        pick = rng.integers(0, len(queries), F)
        for row, k in ((0, "ns"), (1, "obj"), (2, "rel")):
            t[k] = np.where(take, qp[row][pick], t[k])
        t["kind"] = np.where(take & (rng.random(F) < 0.5), 0, t["kind"])
    return {k: (v.astype(bool) if v.dtype == bool else v.astype(np.int32))
            for k, v in t.items()}


def _synth_rows(g, n, seed):
    rows = jsynth.synth_queries_mixed(g, n, seed=seed, general_frac=0.6)
    grants = [JTuple.from_string(s) for s in granted_checks(g.store, n // 4, seed)]
    edits = [JTuple.from_string(str(t).replace("#view@", "#edit@")) for t in grants]
    return rows + grants + edits


@pytest.mark.parametrize("seed", range(3))
def test_classify_level_matches_jax(graphs, seed):
    g, snap, jg, tg = graphs["synth"]
    rng = np.random.default_rng(seed)
    Q = 64
    level = _random_level(rng, snap, 256, Q, queries=_synth_rows(g, 64, seed))
    q_subj = rng.integers(-1, len(snap.vocab.subjects), Q).astype(np.int32)
    jt, jcount, jaux = jalg._classify_level(
        jg, {k: jnp.asarray(v) for k, v in level.items()}, jnp.asarray(q_subj))
    tt, tcount, taux = talg._classify_level(
        tg, {k: torch.from_numpy(v) for k, v in level.items()},
        torch.from_numpy(q_subj))
    _assert_dict(tt, jt, "t")
    _assert_dict(taux, jaux, "aux")
    assert np.array_equal(tcount.numpy(), _np(jcount))
    assert _np(jt["resolved"]).any() and (_np(jcount) > 0).any()


@pytest.mark.parametrize("seed", range(3))
def test_visited_matches_jax(seed):
    """Two rounds of inserts into a 64-slot set: duplicates in a batch,
    keys already in the set, and more keys than the probe window can
    place (pending keys)."""
    rng = np.random.default_rng(seed)
    A, VS = 256, 64
    jv = tuple(jnp.full((VS,), jalg._I32MAX, jnp.int32) for _ in range(4))
    tv = tuple(torch.full((VS,), talg.I32MAX, dtype=torch.int32) for _ in range(4))
    seen_any = pend_any = False
    for _round in range(2):
        pool = rng.integers(0, 40, (60, 4)).astype(np.int32)
        keys = pool[rng.integers(0, len(pool), A)]
        evc = rng.random(A) < 0.7
        jv, jseen, jpend = jalg._visited(
            jv, *(jnp.asarray(keys[:, i]) for i in range(4)), jnp.asarray(evc), A)
        tv, tseen, tpend = talg._visited(
            tv, *(torch.from_numpy(keys[:, i].copy()) for i in range(4)),
            torch.from_numpy(evc), A)
        for a, b in zip(tv, jv):
            assert np.array_equal(a.numpy(), _np(b))
        assert np.array_equal(tseen.numpy(), _np(jseen))
        assert np.array_equal(tpend.numpy(), _np(jpend))
        seen_any |= bool(_np(jseen).any())
        pend_any |= bool(_np(jpend).any())
    assert seen_any and pend_any


@pytest.mark.parametrize("A", [32, 2048])
def test_construct_level_matches_jax(graphs, A):
    """Two levels of construction from real general roots (classified on
    both sides), the visited set carried across: at A = 32 the arena
    overflows, at 2048 it fits."""
    g, snap, jg, tg = graphs["algebra"]
    queries = [JTuple.from_string(s) for b in ALGEBRA_BATCHES.values() for s in b]
    Q = 128
    qpack = _qpack(snap, queries, Q)
    q_subj = qpack[3]
    jt = jalg._init_roots(jnp.asarray(qpack), Q)
    tt = talg._init_roots(torch.from_numpy(qpack), Q)
    _assert_dict(tt, jt, "roots")
    vs = 16
    jv = tuple(jnp.full((vs,), jalg._I32MAX, jnp.int32) for _ in range(4))
    tv = tuple(torch.full((vs,), talg.I32MAX, dtype=torch.int32) for _ in range(4))
    jover = jnp.zeros((Q,), bool)
    tover = torch.zeros(Q, dtype=torch.int32)
    base = 0
    for _lvl in range(2):
        jt, jcount, jaux = jalg._classify_level(jg, jt, jnp.asarray(q_subj))
        tt, tcount, taux = talg._classify_level(tg, tt, torch.from_numpy(q_subj))
        jt, jchild, jv, jover = jalg._construct_level(
            jg, jt, jcount, jaux, jv, jover, A=A, level_base=base,
            max_width=MAX_WIDTH, Q=Q)
        tt, tchild, tv, tover = talg._construct_level(
            tg, tt, tcount, taux, tv, tover, A=A, level_base=base,
            max_width=MAX_WIDTH, Q=Q)
        _assert_dict(tt, jt, "parents")
        _assert_dict(tchild, jchild, "children")
        for a, b in zip(tv, jv):
            assert np.array_equal(a.numpy(), _np(b))
        assert np.array_equal(_flags(tover), _np(jover))
        base += jt["kind"].shape[0]
        jt, tt = jchild, tchild
    assert (_np(jchild["qid"]) >= 0).any()
    if A == 32:
        assert _np(jover).any()


def test_collect_fast_matches_jax(graphs):
    """Three levels of leaves into a buffer too small for them: leaf ids,
    the dropped leaves' UNKNOWN + over, the buffer and the leaf count."""
    g, snap, jg, tg = graphs["synth"]
    rng = np.random.default_rng(7)
    Q, B = 32, 16
    levels = []
    for F in (32, 64, 64):
        lv = _random_level(rng, snap, F, Q)
        lv["resolved"] = rng.random(F) < 0.3
        lv["res"] = rng.integers(0, 4, F).astype(np.int32)
        lv["fast_id"] = np.full(F, -1, np.int32)
        levels.append(lv)
    q_subj = rng.integers(0, 100, Q).astype(np.int32)
    jl, jfb, jover, jn = jalg._collect_fast(
        [{k: jnp.asarray(v) for k, v in lv.items()} for lv in levels],
        jnp.asarray(q_subj), jnp.zeros((Q,), bool), B, Q)
    tl, tfb, tover, tn = talg._collect_fast(
        [{k: torch.from_numpy(v) for k, v in lv.items()} for lv in levels],
        torch.from_numpy(q_subj), torch.zeros(Q, dtype=torch.int32), B, Q)
    for a, b in zip(tl, jl):
        _assert_dict(a, b, "level")
    _assert_dict(tfb, jfb, "leaf buffer")
    assert np.array_equal(_flags(tover), _np(jover))
    assert int(tn) == int(jn) > B


def test_fast_subrun_matches_jax(graphs):
    """The BFS over a leaf buffer: found / over per leaf and the live
    leaves per level.  The JAX loop packs once more after its probe-only
    last level; the port's loop stops there, and the bits agree.  Leaf
    depths run past the three-level schedule (they are capped to it)."""
    g, snap, jg, tg = graphs["synth"]
    rng = np.random.default_rng(3)
    B = 128
    rows = _synth_rows(g, 96, 3)
    qp = _qpack(snap, rows[:B], B)
    fb = dict(
        ns=qp[0], obj=qp[1],
        rel=np.where(rng.random(B) < 0.5, qp[2],
                     snap.vocab.relations.lookup("view")).astype(np.int32),
        d=rng.integers(0, 6, B).astype(np.int32),
        skip=rng.random(B) < 0.3, force=rng.random(B) < 0.3,
        subj=qp[3], valid=(qp[5] != 0) & (rng.random(B) < 0.9),
    )
    sched = tfp.level_schedule(B, 256, 512, 3)
    jfound, jover, jdirty, jocc = jalg._fast_subrun(
        jg, {k: jnp.asarray(v) for k, v in fb.items()}, sched=sched,
        max_width=MAX_WIDTH)
    tfb = {k: torch.from_numpy(np.array(v)) for k, v in fb.items()}
    leaves = talg._leaf_items(tfb, len(sched))
    tocc = torch.zeros(len(sched), dtype=torch.int32)
    tocc[0] = (leaves.qid >= 0).sum()
    tfound, tover, tdirty = talg._fast_subrun(
        tfp._PLAIN_OPS, tg, leaves, tfb["subj"], sched=sched,
        max_width=MAX_WIDTH, occ=tocc)
    assert np.array_equal(_flags(tfound), _np(jfound))
    assert np.array_equal(_flags(tover), _np(jover))
    assert np.array_equal(_flags(tdirty), _np(jdirty))
    assert tocc.tolist() == [int(x) for x in jocc]
    assert _np(jfound).any() and not _np(jfound).all()


# -- the whole program ----------------------------------------------------------


def _compare_program(graphs, name, queries):
    """JAX run_general_packed vs the port's plain program on one padded
    batch: codes and occupancy at tolerance 0.  Returns (codes, port
    state)."""
    _g, snap, jg, tg = graphs[name]
    q, sizes, fast_b, sched, vcap = SHAPES[name]
    qpack = _qpack(snap, queries, q)
    kw = dict(sizes=sizes, fast_b=fast_b, fast_sched=sched, max_width=MAX_WIDTH,
              vcap=vcap)
    jcodes, jocc = jalg.run_general_packed(jg, qpack, **kw)
    packed = talg.run_general_packed_plain(tg, qpack, **kw)
    codes, occ = packed.fetch()
    assert np.array_equal(codes, _np(jcodes))
    assert np.array_equal(occ, _np(jocc))
    _res, st = talg._run_general(talg._PLAIN_OPS, tg, qpack, sizes, fast_b, sched,
                                 MAX_WIDTH, vcap)
    return codes[: len(queries)], st


@pytest.mark.parametrize("batch", list(ALGEBRA_BATCHES))
def test_general_program_matches_jax_on_the_fixture(graphs, batch, monkeypatch):
    pending, seen = [], []
    visited = talg._visited

    def spy(*args):
        out = visited(*args)
        seen.append(bool(out[1].any()))
        pending.append(bool(out[2].any()))
        return out

    monkeypatch.setattr(talg, "_visited", spy)
    queries = [JTuple.from_string(s) for s in ALGEBRA_BATCHES[batch]]
    codes, st = _compare_program(graphs, "algebra", queries)
    res, over = codes & 3, (codes >> 2) & 1
    D = st.depth
    tk = st.tasks
    if batch == "andnot":
        # exact: IS and NOT both, NOT chains included, nothing over; the
        # trivial leaves (one probe) resolved in place, out of the sub-run
        assert not over.any() and {1, 2} <= set(res.tolist())
        triv = ((tk[talg.TI["kind"]] == talg.K_FAST) & (tk[talg.TI["qid"]] >= 0)
                & (tk[talg.TI["fast_id"]] < 0) & (tk[talg.TI["resolved"]] != 0))
        assert triv.any() and int(st.occ()[D + 1]) == 0
    elif batch == "visited":
        assert any(pending), "the visited set must overflow"
        assert over.any()
    elif batch == "error":
        assert res[0] == 3 and res[1] == 1  # R_ERR, then an exact IS
    elif batch == "depth":
        lo, n = st.span(D)
        last = st.aux[talg.AI["count"], lo:lo + n] > 0
        capped = last & (st.tasks[talg.TI["qid"], lo:lo + n] >= 0)
        assert capped.any(), "the level budget must cap a task"
        assert over[0] and not over[1]
        # a fast leaf on the last level is not capped: the sub-run takes it
        leaf = ((tk[talg.TI["kind"], lo:lo + n] == talg.K_FAST)
                & (tk[talg.TI["fast_id"], lo:lo + n] >= 0))
        assert leaf.any()
    elif batch == "flood":
        arena = any(int(st.acount(L).sum()) > st.widths[L + 1] for L in range(D))
        assert arena, "the arena must overflow"
        assert int(st.occ()[D + 1]) > st.leaves.qid.shape[0], "leaves must drop"
        assert over.any() and not over.all()
    elif batch == "dedup":
        # a key met twice under one scope is seen, not expanded again
        # (the rows need seven levels, so here the level budget caps them)
        assert any(seen) and not any(pending)


def test_general_program_matches_jax_on_the_synth_graph(graphs):
    g, *_ = graphs["synth"]
    rows = _synth_rows(g, 160, 11)
    codes, _st = _compare_program(graphs, "synth", rows[:256])
    assert {1, 2} <= set((codes & 3).tolist())


def test_general_program_matches_jax_on_the_rewrites_fixture(graphs):
    queries = [JTuple.from_string(s) for s in REWRITES_QUERIES]
    codes, _st = _compare_program(graphs, "rewrites", queries)
    assert {1, 2} <= set((codes & 3).tolist())

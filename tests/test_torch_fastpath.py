"""Port parity: the tier-1 BFS (K3 expand_phase, K4 arena_assign, K5 pack
and the packed multi-level batch) against the JAX package, at tolerance 0.

Both sides read the same snapshot arrays (the JAX side its device_put copy,
the port ``upload(..., "cpu")``), so the port runs its plain PyTorch
versions here; the CUDA kernels are held against those same plain versions
on the card by ``chip_smoke.py``.  To keep the XLA compile count small,
every case of a test shares one batch size and one schedule.
"""

import numpy as np
import pytest
import torch

import jax

from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.engine import delta as jdelta
from ketotpu.engine import fastpath as jfp
from ketotpu.engine import xutil as jxutil
from ketotpu.engine.vocab import Vocab as JVocab
from ketotpu.opl.parser import parse as jparse
from ketotpu.storage import InMemoryTupleStore as JStore
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu.utils import synth as jsynth
from ketotpu_torch.engine import fastpath as tfp
from ketotpu_torch.engine import xutil as txutil
from ketotpu_torch.engine.device import upload
from torch_parity import (
    SMALL_SYNTH,
    pure_or_case,
    release_jax_caches,  # noqa: F401 - autouse fixture
)

torch.set_num_threads(1)

MAX_WIDTH = 100


def _np(x):
    return np.asarray(x)


def _synth_snapshot():
    g = jsynth.build_synth_columnar(seed=0, **SMALL_SYNTH)
    cols, alive, _tail, _head = g.store.export_columns()
    snap = jdelta.build_snapshot_cols(
        jdelta.TupleColumns.from_arrays(g.store.vocab, cols, alive), g.manager
    )
    return g, snap


def _qpack(snap, queries, depths, q):
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
    rows[4, :n] = depths
    rows[5, :n] = 1
    return rows


@pytest.fixture(scope="module")
def synth():
    g, snap = _synth_snapshot()
    arrays = snap.check_arrays()
    return g, snap, jax.device_put(arrays), upload(arrays, "cpu")


# -- K4 ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_arena_assign_matches_jax(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, 64).astype(np.int32)
    counts[rng.random(64) < 0.4] = 0
    if seed % 2:
        counts[10] = 90  # total past the arena: starts beyond it are dropped
    want = jxutil.arena_assign(jax.numpy.asarray(counts), 128)
    got = txutil.arena_assign(torch.from_numpy(counts), 128)
    for w, t in zip(want, got):
        assert t.dtype == torch.int32
        assert np.array_equal(t.numpy(), _np(w))


# -- K3 + K5, level by level -----------------------------------------------------


def _frontier_dict(s):
    """A JAX frontier state's columns under the port's column names."""
    return {c: s[f"f_{n}"] for c, n in zip(tfp.ITEM_COLS, (
        "qid", "ns", "obj", "rel", "depth", "skip", "force"))}


def _assert_items(t, j):
    for c in tfp.ITEM_COLS:
        want = _np(j[c])
        got = getattr(t, c).numpy()
        assert got.dtype == want.dtype, c
        assert np.array_equal(got, want), c


def test_expand_and_pack_levels_match_jax(synth):
    g, snap, jg, tg = synth
    queries = jsynth.synth_queries_mixed(g, 200, seed=4, general_frac=0.0)
    q, frontier, arena, levels = 256, 512, 1024, 5
    qpack = _qpack(snap, queries, 5, q)
    ns_dim, rel_dim = snap.flat.direct_ok.shape
    nsb, relb = jfp._pack_bits(ns_dim), jfp._pack_bits(rel_dim)
    expand = jax.jit(jfp.expand_phase,
                     static_argnames=("arena", "max_width", "probe_only"))
    pack = jax.jit(jfp._pack_scatter, static_argnames=("frontier", "nsb", "relb"))

    js = jfp.init_state(*qpack[:5], qpack[5].astype(bool), frontier=frontier)
    js = dict(js)
    js["f_depth"] = jax.numpy.minimum(js["f_depth"], levels)
    occ = torch.zeros(1, dtype=torch.int32)
    f, qf, qo, qs = tfp.init_state(torch.from_numpy(qpack), frontier=frontier,
                                   levels=levels, occ_out=occ)
    _assert_items(f, _frontier_dict(js))
    assert int(occ[0]) == len(queries)
    explored = 0
    qd = torch.zeros_like(qo)
    for lvl in range(levels):
        last = lvl == levels - 1
        a = 8 if last else arena
        jch, jqf, jqo, jqd = expand(jg, js, arena=a, max_width=MAX_WIDTH,
                                    probe_only=last)
        ch, qf, qo, qd = tfp.expand_phase(tg, f, qf, qo, qd, qs, arena=a,
                                          max_width=MAX_WIDTH, probe_only=last)
        _assert_items(ch, jch)
        assert np.array_equal(qf.numpy().astype(bool), _np(jqf))
        assert np.array_equal(qo.numpy().astype(bool), _np(jqo))
        assert np.array_equal(qd.numpy().astype(bool), _np(jqd))
        explored += int((ch.qid >= 0).sum())
        if last:
            break
        jnxt, jqo = pack(jch, jqf, jqo, frontier=frontier, nsb=nsb, relb=relb)
        f, qo = tfp.pack_phase(ch, qf, qo, frontier=frontier, ns_dim=ns_dim,
                               rel_dim=rel_dim)
        _assert_items(f, _frontier_dict(jnxt))
        assert np.array_equal(qo.numpy().astype(bool), _np(jqo))
        js = dict(jnxt, q_found=jqf, q_over=jqo, q_dirty=jqd, q_subj=js["q_subj"])
    assert explored > 0


def test_pack_phase_refuses_keys_wider_than_31_bits(monkeypatch):
    """A key wider than 31 bits (8 + 14 + 14) does not take the hash
    scatter: ``pack_phase`` packs it by sort (K5b,
    ``tests/test_torch_packsort.py`` holds it to JAX)."""
    def no_scatter(*_a, **_k):
        raise AssertionError("the scatter cannot pack a 36-bit key")

    monkeypatch.setattr(tfp, "_pack_scatter_plain", no_scatter)
    ch = tfp.Items.dead(8, "cpu")
    flags = torch.zeros(256, dtype=torch.int32)
    out, qo = tfp.pack_phase(ch, flags, flags, frontier=8, ns_dim=1 << 14,
                             rel_dim=1 << 14)
    assert (out.qid == -1).all() and int(qo.sum()) == 0


# -- the packed multi-level batch ------------------------------------------------


def _compare_packed(jg, tg, qpack, **kw):
    jcodes, jocc = jfp.run_fast_packed(jg, qpack, **kw)
    codes, occ = tfp.run_fast_packed(tg, qpack, **kw).fetch()
    assert np.array_equal(codes, _np(jcodes))
    assert np.array_equal(occ, _np(jocc))
    return codes


@pytest.mark.parametrize("seed", range(10))
def test_run_fast_packed_pure_or_fuzz(seed):
    """The pure-OR fuzz generator of tests/test_fastpath.py, every query at
    rest depths 0, 2, 3 and 5: verdict bytes and occupancy."""
    rng = np.random.default_rng(seed + 100)
    source, tuples, queries = pure_or_case(rng)
    namespaces, errs = jparse(source)
    assert not errs, errs
    store = JStore()
    store.write_relation_tuples(*[JTuple.from_string(s) for s in tuples])
    snap = jdelta.build_snapshot_cols(
        jdelta.TupleColumns.from_tuples(JVocab(), store.all_tuples()),
        JManager(namespaces),
    )
    assert not snap.flat.impure.any()
    qs = [JTuple.from_string(s) for s in queries] * 4
    depths = np.repeat(np.array([5, 2, 3, 5], np.int32), len(queries))  # 0 -> max
    qpack = _qpack(snap, qs, depths, 128)
    arrays = snap.check_arrays()
    _compare_packed(jax.device_put(arrays), upload(arrays, "cpu"), qpack,
                    frontier=512, arena=2048, max_depth=5, max_width=MAX_WIDTH)


def test_run_fast_packed_forced_overflow(synth):
    """A frontier and arena far too small: over bits and the occupancy of
    the truncated levels must agree too."""
    g, snap, jg, tg = synth
    queries = jsynth.synth_queries(g, 256, seed=9)
    qpack = _qpack(snap, queries, 5, 256)
    codes = _compare_packed(jg, tg, qpack, frontier=256, arena=64, max_depth=5,
                            max_width=MAX_WIDTH)
    assert ((codes >> 1) & 1).sum() > 0, "the case must overflow"


def test_run_fast_matches_jax(synth):
    """The unpacked entry ``run_fast`` (the JAX ``_run_fused`` over the same
    body as the packed batch): found, over and dirty bits, on a batch with
    inactive rows, roots deeper than the schedule (clamped to it) and
    caps small enough to overflow."""
    g, snap, jg, tg = synth
    # stored tuples asked back (found at the roots) and random checks
    stored = [t for _, t in zip(range(32), g.store.all_tuples())]
    queries = stored + jsynth.synth_queries(g, 256 - len(stored), seed=9)
    qpack = _qpack(snap, queries, 5, 256)
    rng = np.random.default_rng(11)
    qpack[4] = rng.integers(0, 8, 256)  # depth 0 .. 7 against 5 levels
    active = rng.random(256) < 0.9
    kw = dict(frontier=256, arena=64, max_depth=5, max_width=MAX_WIDTH)
    want = jfp.run_fast(jg, *qpack[:5], active, **kw)
    got = tfp.run_fast(tg, *(torch.from_numpy(r) for r in qpack[:5]),
                       torch.from_numpy(active), **kw)
    for name in ("found", "over", "dirty"):
        t = getattr(got, name)
        assert t.dtype == torch.bool, name
        assert np.array_equal(t.numpy(), _np(getattr(want, name))), name
    assert got.over.any() and got.found.any()
    assert not (got.found | got.over)[~torch.from_numpy(active)].any()

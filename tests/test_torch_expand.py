"""Port parity of Expand (K9 and the host DFS replay) on the CPU.

* The plain K9 (``expand_device._run_expand_plain``, the walk the CUDA
  kernels of ``csrc/expand.cu`` are held to on the card) against the JAX
  ``_run_expand`` on the same tables and roots, bit for bit: every column
  of every level record (the padding rows of the power-of-two root bucket
  included) and ``over``.  The cases are the JAX suite's
  (``tests/test_expand_device.py``): the synth graph's usersets, a cycle,
  a diamond, depth truncation, an empty row, leaf / set order, plus an
  overflowing cap and pending writes (a virtual node, a dirty row).  The
  JAX program compiles once per (table shapes, schedule): five here.
* The port engine's ``batch_expand(device="cpu")`` trees (``to_json``)
  against the JAX engine's and the JAX oracle's, with and without pending
  writes (the JAX suite's overlay cases), ``SubjectID`` roots, unknown
  roots and overflow (``device.EXPAND_CAP`` set low to force it).
* A seeded Expand fuzz over ``_random_case`` (``tests/test_device_engine.py``)
  with writes between batches, against the JAX oracle.
"""

import numpy as np
import pytest
import torch

from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.api.types import SubjectID as JSubjectID
from ketotpu.api.types import SubjectSet as JSubjectSet
from ketotpu.engine import expand_device as jxd
from ketotpu.engine.oracle import ExpandEngine as JExpand
from ketotpu.engine.tpu import DeviceCheckEngine as JEngine
from ketotpu.opl.parser import parse as jparse
from ketotpu.storage import InMemoryTupleStore as JStore
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu.utils import synth as jsynth
from ketotpu_torch import kernels
from ketotpu_torch.api.types import RelationTuple as TTuple
from ketotpu_torch.api.types import SubjectID as TSubjectID
from ketotpu_torch.api.types import SubjectSet as TSubjectSet
from ketotpu_torch.engine import device as tdevice
from ketotpu_torch.engine import expand_device as xd
from ketotpu_torch.engine.device import DeviceCheckEngine as TEngine
from ketotpu_torch.opl.parser import parse as tparse
from ketotpu_torch.storage.memory import InMemoryTupleStore as TStore
from ketotpu_torch.storage.namespaces import StaticNamespaceManager as TManager
from ketotpu_torch.utils import synth as tsynth
from test_device_engine import _random_case
from torch_parity import release_jax_caches  # noqa: F401

torch.set_num_threads(1)

#: the JAX suite's hand-written cases in one store, so the JAX program
#: compiles once per schedule for all of them
SMALL_LINES = [
    "g:a#m@g:b#m", "g:b#m@g:a#m", "g:b#m@alice",  # a cycle
    "g:root#m@g:left#m", "g:root#m@g:right#m",  # a diamond
    "g:left#m@g:shared#m", "g:right#m@g:shared#m", "g:shared#m@bob",
    "g:c1#m@g:c2#m", "g:c2#m@g:c3#m", "g:c3#m@carol",  # a chain
    "g:o#m@zed", "g:o#m@g:p#m", "g:o#m@amy", "g:p#m@bob",  # leaf / set order
    "g:e#m@alice",
]
SMALL_ROOTS = ["g:a#m", "g:root#m", "g:c1#m", "g:o#m", "g:none#m", "g:b#m",
               "g:shared#m", "x:unknown#m", "g:e#m"]
SYNTH = dict(n_users=48, n_groups=6, n_folders=24, n_docs=96)
ENGINE_SYNTH = dict(n_users=32, n_groups=4, n_folders=16, n_docs=64)


def _set(cls, s: str):
    head, rel = s.split("#", 1)
    ns, obj = head.split(":", 1)
    return cls(ns, obj, rel)


def _js(t):
    return None if t is None else t.to_json()


def _pair(lines=None, graph=None, manager_src=None):
    """The JAX and the port engine over stores holding the same tuples."""
    if graph is not None:
        jg, tg = jsynth.build_synth(**graph), tsynth.build_synth(**graph)
        return (jg.store, JEngine(jg.store, jg.manager),
                tg.store, TEngine(tg.store, tg.manager, device="cpu"))
    js, ts = JStore(), TStore()
    js.write_relation_tuples(*map(JTuple.from_string, lines))
    ts.write_relation_tuples(*map(TTuple.from_string, lines))
    jm = tm = None
    if manager_src is not None:
        jm, tm = JManager(jparse(manager_src)[0]), TManager(tparse(manager_src)[0])
    return js, JEngine(js, jm), ts, TEngine(ts, tm, device="cpu")


def _torch_tables(jarrays):
    return {k: torch.from_numpy(np.array(v)) for k, v in jarrays.items()}


def _hold_walk(jeng, teng, roots, rest_depth, cap=65536):
    """The plain K9 against the JAX program on the JAX engine's Expand
    tables; and the port engine's own tables equal to those.  Returns the
    schedule."""
    jeng.snapshot()  # drains pending writes, as the port's view does
    jarrays = jeng._expand_arrays()
    tables = teng.expand_view()[1]
    assert sorted(tables) == sorted(jarrays)
    for k, v in jarrays.items():
        # ov_nbase: a 0-d array in JAX, one element in the port
        assert np.array_equal(np.asarray(v).reshape(-1) if k == "ov_nbase"
                              else np.asarray(v), tables[k].numpy()), k
    block = xd.encode_roots(teng.snapshot().vocab, roots)
    depth = rest_depth if 0 < rest_depth <= teng.max_depth else teng.max_depth
    block[4, :len(roots)] = depth
    sched = xd.expand_schedule(block.shape[1], 16, depth, cap)
    assert sched == jxd.expand_schedule(block.shape[1], 16, depth, cap)
    jlevels, jover = jxd._run_expand(jarrays, *block, schedule=sched)
    levels, over = xd._run_expand_plain(_torch_tables(jarrays), *block,
                                        schedule=sched)
    assert len(levels) == len(jlevels) == len(sched)
    for lvl, (got, want) in enumerate(zip(levels, jlevels)):
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), (lvl, k)
    assert np.array_equal(over, np.asarray(jover))
    return sched, levels, over


@pytest.mark.parametrize("rest_depth", [0, 2])
def test_walk_matches_jax_on_the_hand_written_cases(rest_depth):
    _js_, jeng, _ts, teng = _pair(SMALL_LINES)
    roots = [_set(TSubjectSet, r) for r in SMALL_ROOTS]
    sched, levels, _over = _hold_walk(jeng, teng, roots, rest_depth)
    assert sched[0] == 16  # nine roots in a bucket of 16: padding rows
    live0 = levels[0]["live"]
    assert live0.all() and (levels[0]["node"][len(roots):] == -1).all()
    if rest_depth == 0:
        # the cycle's back edge is not expanded: g:a -> g:b -> g:a stops
        assert levels[2]["live"].sum() < (levels[2]["parent"] >= 0).sum()


def test_walk_matches_jax_on_the_synth_usersets_and_overflow():
    _js_, jeng, ts, teng = _pair(graph=SYNTH)
    roots = sorted({(t.namespace, t.object, t.relation) for t in ts.all_tuples()})
    roots = [TSubjectSet(*r) for r in roots] + [TSubjectSet("Doc", "none", "x")]
    _hold_walk(jeng, teng, roots, 0)


def test_engine_trees_match_jax_and_the_oracle(monkeypatch):
    jst, jeng, tst, teng = _pair(graph=ENGINE_SYNTH)
    oracle = JExpand(jst, max_depth=jeng.max_depth)
    some = next(t for t in tst.all_tuples() if t.relation == "viewers")
    roots = ["Group:g1#members", f"{some.namespace}:{some.object}#viewers",
             "Doc:none#viewers", "Nope:x#y", "Folder:f0#parents"]
    tsubs = [TSubjectID("alice")] + [_set(TSubjectSet, r) for r in roots]
    jsubs = [JSubjectID("alice")] + [_set(JSubjectSet, r) for r in roots]
    # one root per JAX call: the JAX program compiles for 8 padded roots
    for k in range(1, len(tsubs)):
        got = teng.batch_expand([tsubs[0], tsubs[k]])
        want = jeng.batch_expand([jsubs[0], jsubs[k]])
        assert [_js(t) for t in got] == [_js(t) for t in want]
        assert _js(got[1]) == _js(oracle.build_tree(jsubs[k]))
        assert got[0].type.value == "leaf"
    for depth in (1, 2, 3, 4):
        got = teng.batch_expand(tsubs[1:], depth)
        assert [_js(t) for t in got] == [
            _js(oracle.build_tree(s, depth)) for s in jsubs[1:]]
    # a cap of one slot per level: the root overflows and the oracle
    # answers it; the JAX walk's over bits and records agree
    want = _js(jeng.batch_expand([jsubs[2]], cap=1)[0])
    monkeypatch.setattr(tdevice, "EXPAND_CAP", 1)
    f0 = teng.fallbacks
    got = teng.batch_expand([tsubs[2]])
    assert teng.fallbacks == f0 + 1 and teng.last_expand["over"] == 1
    assert _js(got[0]) == want
    _hold_walk(jeng, teng, [tsubs[2]], 0, cap=1)


def test_overflowed_roots_and_only_they_go_to_the_oracle(monkeypatch):
    """At caps where part of a batch overflows (most roots at 16, a few at
    128), the over roots, and no other, are answered by the oracle, and
    every tree equals the JAX oracle's."""
    jst, _jeng, tst, teng = _pair(graph=ENGINE_SYNTH)
    oracle = JExpand(jst, max_depth=teng.max_depth)
    roots = sorted({(t.namespace, t.object, t.relation) for t in tst.all_tuples()})
    want = [_js(oracle.build_tree(JSubjectSet(*r))) for r in roots]
    asked = []

    class Asked(tdevice.ExpandEngine):
        def build_tree(self, subject, rest_depth=0):
            asked.append(subject)
            return super().build_tree(subject, rest_depth)

    monkeypatch.setattr(tdevice, "ExpandEngine", Asked)
    for cap in (16, 128):
        monkeypatch.setattr(tdevice, "EXPAND_CAP", cap)
        f0, asked[:] = teng.fallbacks, []
        got = teng.batch_expand([TSubjectSet(*r) for r in roots])
        n_over = teng.last_expand["over"]
        assert 0 < n_over < len(roots) and teng.fallbacks == f0 + n_over
        assert len(asked) == n_over
        assert [_js(t) for t in got] == want


def _write_both(jst, tst, ins=(), dels=()):
    for s in dels:
        jst.delete_relation_tuples(JTuple.from_string(s))
        tst.delete_relation_tuples(TTuple.from_string(s))
    for s in ins:
        jst.write_relation_tuples(JTuple.from_string(s))
        tst.write_relation_tuples(TTuple.from_string(s))


def _overlay_case(name, tst):
    """The JAX suite's overlay cases: (writes before the engines' base,
    deletes and inserts after it, the roots to expand)."""
    doc = next(t for t in tst.all_tuples() if t.relation == "viewers")
    dsub = f"{doc.namespace}:{doc.object}#viewers"
    if name == "members":
        fold = next(t for t in tst.all_tuples()
                    if t.relation == "viewers" and t.namespace == "Folder"
                    and not isinstance(t.subject, TSubjectID))
        dropped = next(t for t in tst.all_tuples()
                       if (t.namespace, t.object, t.relation)
                       == (fold.namespace, fold.object, "viewers")
                       and isinstance(t.subject, TSubjectID))
        return ([], [str(dropped)],
                [f"Folder:{fold.object}#viewers@Group:g1#members",
                 f"Folder:{fold.object}#viewers@fresh-user"],
                [f"Folder:{fold.object}#viewers", "Group:g1#members"])
    if name == "duplicate":
        return [], [], [f"{dsub}@twice", f"{dsub}@twice"], [dsub]
    if name == "over-existing":
        return [f"{dsub}@twice"], [], [f"{dsub}@twice"], [dsub]
    if name == "reinsert-fewer":
        return ([f"{dsub}@twice", f"{dsub}@twice"], [f"{dsub}@twice"],
                [f"{dsub}@twice"], [dsub])
    if name == "virtual":
        return ([], [], ["Doc:dnew#viewers@newbie", "Doc:dnew#owners@u1",
                         "Doc:dnew#parents@Folder:f2"],
                ["Doc:dnew#viewers", "Doc:dnew#owners", "Doc:dnew#parents"])
    assert name == "dirty"
    return ([], [], ["Group:g0#members@Group:g2#members",
                     "Group:g2#members@late-user"],
            ["Group:g0#members", "Group:g2#members", "Folder:f0#viewers"])


@pytest.mark.parametrize("case", ["members", "duplicate", "over-existing",
                                  "reinsert-fewer", "virtual", "dirty"])
def test_engine_trees_under_pending_writes(case):
    jg, tg = jsynth.build_synth(**ENGINE_SYNTH), tsynth.build_synth(**ENGINE_SYNTH)
    pre, dels, ins, roots = _overlay_case(case, tg.store)
    _write_both(jg.store, tg.store, pre)
    jeng = JEngine(jg.store, jg.manager)
    teng = TEngine(tg.store, tg.manager, device="cpu")
    jeng.snapshot(), teng.snapshot()
    _write_both(jg.store, tg.store, ins, dels)
    oracle = JExpand(jg.store, max_depth=jeng.max_depth)
    rebuilds, fallbacks = teng.rebuilds, teng.fallbacks
    got = teng.batch_expand([_set(TSubjectSet, r) for r in roots])
    assert teng.rebuilds == rebuilds and teng.fallbacks == fallbacks
    assert teng.projection_stats()["overlay_active"]
    want = [oracle.build_tree(_set(JSubjectSet, r)) for r in roots]
    assert [_js(t) for t in got] == [_js(t) for t in want]
    jgot = jeng.batch_expand([_set(JSubjectSet, roots[0])])
    assert _js(got[0]) == _js(jgot[0])
    if case == "duplicate":
        assert str(_js(got[0])).count("twice") == 2
    if case in ("virtual", "dirty"):
        # the walk on the overlay's tables (a virtual node reads 0 members,
        # a dirty row keeps its base degree), bit for bit
        _hold_walk(jeng, teng, [_set(TSubjectSet, r) for r in roots], 0)


def test_cpu_expand_launches_nothing():
    _js_, _jeng, _ts, teng = _pair(SMALL_LINES)
    kernels.reset_launches()
    out = teng.batch_expand([_set(TSubjectSet, r) for r in SMALL_ROOTS])
    assert out[0] is not None and out[4] is None
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def _fuzz_roots(source_tuples):
    namespaces = sorted({t.split(":", 1)[0] for t in source_tuples})
    return [f"{ns}:o{o}#r{r}" for ns in namespaces for o in range(5)
            for r in range(4)]


@pytest.mark.parametrize("seed", range(10))
def test_expand_fuzz(seed, monkeypatch):
    rng = np.random.default_rng(2000 + seed)
    source, tuples, _queries = _random_case(rng)
    js, ts = JStore(), TStore()
    js.write_relation_tuples(*map(JTuple.from_string, tuples))
    ts.write_relation_tuples(*map(TTuple.from_string, tuples))
    teng = TEngine(ts, TManager(tparse(source)[0]), device="cpu",
                   frontier=256, arena=1024, max_batch=256, gen_arena=256,
                   vcap=64)
    oracle = JExpand(js, max_depth=teng.max_depth)
    live = sorted(tuples)
    roots = _fuzz_roots(tuples)
    for step in range(4):
        for depth, cap in ((0, 65536), (2, 65536), (0, 16)):
            monkeypatch.setattr(tdevice, "EXPAND_CAP", cap)
            got = teng.batch_expand([_set(TSubjectSet, r) for r in roots],
                                    depth)
            want = [oracle.build_tree(_set(JSubjectSet, r), depth) for r in roots]
            bad = [r for r, g, w in zip(roots, got, want) if _js(g) != _js(w)]
            assert not bad, (step, depth, cap, bad[:4])
        for _ in range(2):
            if live and rng.random() < 0.4:
                t = live.pop(int(rng.integers(len(live))))
                js.delete_relation_tuples(JTuple.from_string(t))
                ts.delete_relation_tuples(TTuple.from_string(t))
                continue
            t = tuples[int(rng.integers(len(tuples)))]
            head, subj = t.split("@", 1)
            t = f"{head.split(':', 1)[0]}:o{int(rng.integers(5))}#" \
                f"{head.split('#', 1)[1]}@{subj}"
            js.write_relation_tuples(JTuple.from_string(t))
            ts.write_relation_tuples(TTuple.from_string(t))
            live.append(t)

"""Port parity: ``MeshCheckEngine(devices=["cpu"] * 4)`` (the port's
graph-sharded serving engine, through its plain versions) against the JAX
package's ``MeshCheckEngine(mesh_devices=4)`` on the virtual CPU devices of
``tests/conftest.py``, and against the JAX oracle.

Verdicts and the oracle-fallback masks (``_collect`` of one chunk) must
agree bit for bit, before and after writes: memberships that ride the
per-shard overlays, a nested subject set whose dirty rows go to the
oracle, and a burst past the overlay budget that re-partitions.  Expand
goes through the bounded replica, and to the oracle past its budget.
Both engines run one fixed schedule (``KETO_NO_ADAPTIVE`` for JAX, three
skeleton levels, caps no batch here overflows), so XLA:CPU compiles the
sharded fast program, the sharded general program and the Expand walk
once each.
"""

import numpy as np
import pytest
import torch

from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.api.types import SubjectSet as JSubjectSet
from ketotpu.engine.oracle import CheckEngine as JOracle
from ketotpu.engine.oracle import ExpandEngine as JExpand
from ketotpu.parallel import MeshCheckEngine as JMesh
from ketotpu.utils import synth as jsynth
from ketotpu_torch.api.types import RelationTuple as TTuple
from ketotpu_torch.api.types import SubjectSet as TSubjectSet
from ketotpu_torch.parallel import MeshCheckEngine as TMesh
from ketotpu_torch.utils import synth as tsynth
from torch_parity import granted_checks, release_jax_caches  # noqa: F401

torch.set_num_threads(1)

GRAPH = dict(n_users=64, n_groups=8, n_folders=32, n_docs=128)
KW = dict(frontier=1024, arena=4096, gen_levels=3, max_batch=1024)


@pytest.fixture(autouse=True)
def _fixed_jax_schedule(monkeypatch):
    monkeypatch.setenv("KETO_NO_ADAPTIVE", "1")


@pytest.fixture(scope="module")
def mesh():
    """(JAX graph, port graph, JAX engine, port engine, JAX oracle)."""
    jg, tg = jsynth.build_synth(**GRAPH), tsynth.build_synth(**GRAPH)
    jeng = JMesh(jg.store, jg.manager, mesh_devices=4, **KW)
    teng = TMesh(tg.store, tg.manager, mesh_devices=4, devices=["cpu"] * 4, **KW)
    return jg, tg, jeng, teng, JOracle(jg.store, jg.manager)


def _rows(jg, seed):
    """Doc view / edit rows (tiers 1 and 2), granted edits, and group
    memberships (tier 0 answers those)."""
    rows = [str(t) for t in jsynth.synth_queries_mixed(jg, 160, seed=seed)]
    rng = np.random.default_rng(seed)
    return rows + [r.replace("#view@", "#edit@")
                   for r in granted_checks(jg.store, 48, seed)[:24]] + [
        f"Group:g{g}#members@u{u}" for g, u in zip(rng.integers(0, 8, 32),
                                                  rng.integers(0, 64, 32))]


def _both(mesh, rows):
    """(verdicts, fallback mask) of one chunk on each engine, held equal,
    and the verdicts against the oracle."""
    jg, tg, jeng, teng, oracle = mesh
    jq = [JTuple.from_string(r) for r in rows]
    tq = [TTuple.from_string(r) for r in rows]
    ja, jf = jeng._collect(jeng._dispatch(jq, 0))
    ta, tf = teng._collect(teng._dispatch(tq, 0))
    assert np.array_equal(tf, jf)
    assert np.array_equal(ta[~tf], ja[~jf])
    got = teng.batch_check(tq)
    assert got == jeng.batch_check(jq)
    assert got == [oracle.check_is_member(q) for q in jq]
    return np.asarray(got), tf


def _write(mesh, insert=(), delete=()):
    jg, tg, *_ = mesh
    jg.store.transact_relation_tuples(
        insert=[JTuple.from_string(s) for s in insert],
        delete=[JTuple.from_string(s) for s in delete])
    tg.store.transact_relation_tuples(
        insert=[TTuple.from_string(s) for s in insert],
        delete=[TTuple.from_string(s) for s in delete])


def test_verdicts_and_fallback_masks_match_jax(mesh):
    _jg, tg, _jeng, teng, _o = mesh
    got, fb = _both(mesh, _rows(mesh[0], 4))
    assert got.any() and not got.all() and not fb.any()
    assert teng.general_rows > 0 and teng.leopard_answered > 0
    stats = teng.shard_stats()
    assert [s["device"] for s in stats] == ["cpu"] * 4
    assert all(s["batches"] > 0 and s["nodes"] > 0 for s in stats)
    assert sum(s["leopard_pairs"] for s in stats) > 0
    assert teng.shard_route_counts().sum() == sum(s["batches"] for s in stats)


def test_membership_writes_ride_the_per_shard_overlays(mesh):
    jg, _tg, _jeng, teng, _o = mesh
    rebuilds = teng.rebuilds
    ins = [f"Group:g{i}#members@u{(i * 7 + 3) % 64}" for i in range(1, 8, 2)]
    dels = [str(t) for t in jg.store.all_tuples()
            if t.namespace == "Doc" and t.relation == "viewers"][:4]
    _write(mesh, ins, dels)
    rows = [r.replace("#members@", "#members@") for r in ins] + [
        f"Folder:f{i}#view@u{(i * 7 + 3) % 64}" for i in range(16)] + [
        d.replace("#viewers@", "#view@") for d in dels]
    _both(mesh, rows + _rows(jg, 5))
    assert teng.last_write["tier"] == "overlay" and teng.rebuilds == rebuilds
    assert sum(s["overlay_pairs"] for s in teng.shard_stats()) == len(ins) + len(dels)


def test_a_nested_subject_set_goes_dirty_to_the_oracle(mesh):
    jg, _tg, _jeng, teng, _o = mesh
    rebuilds, fb0 = teng.rebuilds, teng.fallbacks
    _write(mesh, ["Group:g2#members@Group:g5#members"])
    rows = [f"Group:g2#members@u{u}" for u in range(5, 64, 8)] + [
        f"Folder:f{i}#view@u{u}" for i in range(8) for u in (5, 13)]
    _got, fb = _both(mesh, rows + _rows(jg, 6))
    assert teng.last_write["tier"] == "overlay" and teng.rebuilds == rebuilds
    assert fb.any() and teng.fallbacks > fb0
    assert sum(s["overlay_dirty"] for s in teng.shard_stats()) > 0


def test_a_burst_past_the_overlay_repartitions(mesh):
    jg, _tg, jeng, teng, _o = mesh
    jeng.max_overlay_pairs = teng.max_overlay_pairs = 16
    rebuilds = teng.rebuilds
    ins = [f"Doc:d{i}#viewers@u{(5 * i) % 64}" for i in range(40)]
    _write(mesh, ins)
    _both(mesh, [r.replace("#viewers@", "#view@") for r in ins] + _rows(jg, 7))
    assert teng.last_write["tier"] == "rebuild" and teng.rebuilds == rebuilds + 1
    assert teng.folds == 0
    assert all(s["overlay_pairs"] == 0 for s in teng.shard_stats())


def _roots():
    return ([f"Group:g{i}#members" for i in range(8)]
            + [f"Folder:f{i}#viewers" for i in range(0, 32, 3)]
            + [f"Doc:d{i}#parents" for i in range(0, 128, 9)] + ["Nope:x#y"])


def _set(cls, s):
    head, rel = s.split("#", 1)
    ns, obj = head.split(":", 1)
    return cls(ns, obj, rel)


@pytest.mark.parametrize("write", [None, "Group:g3#members@late-user"])
def test_expand_through_the_replica_matches_jax(mesh, write):
    """The replica is built at the first Expand; a later membership write
    reaches it through the replicated overlay."""
    jg, _tg, jeng, teng, _o = mesh
    if write:
        _write(mesh, [write])
    roots = _roots()
    got = teng.batch_expand([_set(TSubjectSet, r) for r in roots])
    want = jeng.batch_expand([_set(JSubjectSet, r) for r in roots])
    oracle = JExpand(jg.store, max_depth=jeng.max_depth)
    js = [None if t is None else t.to_json() for t in want]
    assert [None if t is None else t.to_json() for t in got] == js
    assert js == [None if t is None else t.to_json() for t in (
        oracle.build_tree(_set(JSubjectSet, r)) for r in roots)]
    assert teng._device_arrays is not None  # the replica was built
    if write:
        assert teng.last_write["tier"] == "overlay"
        assert "late-user" in str(got[3].to_json())


def test_a_tiny_replica_budget_sends_expand_to_the_oracle():
    jg, tg = jsynth.build_synth(**GRAPH), tsynth.build_synth(**GRAPH)
    teng = TMesh(tg.store, tg.manager, mesh_devices=2, devices=["cpu"] * 2,
                 replica_budget_mb=0, **KW)
    roots = _roots()
    got = teng.batch_expand([_set(TSubjectSet, r) for r in roots])
    oracle = JExpand(jg.store, max_depth=teng.max_depth)
    assert [None if t is None else t.to_json() for t in got] == [
        None if t is None else t.to_json()
        for t in (oracle.build_tree(_set(JSubjectSet, r)) for r in roots)]
    assert teng._device_arrays is None and teng.fallbacks == len(roots)


def test_devices_default_to_the_cards_and_raise_without_them(monkeypatch):
    from ketotpu_torch.storage.memory import InMemoryTupleStore

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="mesh_devices=2 but only 0"):
        TMesh(InMemoryTupleStore(), mesh_devices=2)
    with pytest.raises(ValueError, match="not ported"):
        TMesh(InMemoryTupleStore(), mesh_devices=1, devices=["cpu"],
              failover=True)

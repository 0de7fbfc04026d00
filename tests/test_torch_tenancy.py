"""Port parity of the tenant plane (``ketotpu_torch.tenancy``) against the
JAX package's ``tenancy/``, and of the slice it opens: a plane whose
namespace and relation dims push a served batch's frontier key past 31
bits, so every level packs by sort (K5b).

The host half (qualification, store views, quotas, lifecycle, the
plane's namespace manager) is driven identically on both packages and
the observable results compared.  The slice: 512 tenants, each a tiny
synth graph under its own relation names (namespace dim 4096, relation
dim 2048), served at Q = 512 by the port's ``DeviceCheckEngine`` on the
CPU and the JAX one, unfused and then fused, Leopard on in both: the
verdicts, the retry (over-bit) and oracle-fallback counts and the tier
counts must be equal, and both packages must take the sort.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ketotpu import tenancy as jten
from ketotpu.api import types as jtypes
from ketotpu.engine import fastpath as jfp
from ketotpu.engine.oracle import CheckEngine as JOracle
from ketotpu.engine.tpu import DeviceCheckEngine as JEngine
from ketotpu.opl.parser import parse as jparse
from ketotpu.storage import InMemoryTupleStore as JStore
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu.tenancy import quota as jquota
from ketotpu.tenancy import store as jstore
from ketotpu.utils import synth as jsynth
from ketotpu_torch import tenancy as tten
from ketotpu_torch.api import types as ttypes
from ketotpu_torch.engine import fastpath as tfp
from ketotpu_torch.engine.device import DeviceCheckEngine as TEngine
from ketotpu_torch.opl.parser import parse as tparse
from ketotpu_torch.storage.memory import InMemoryTupleStore as TStore
from ketotpu_torch.storage.namespaces import StaticNamespaceManager as TManager
from ketotpu_torch.tenancy import quota as tquota
from ketotpu_torch.tenancy import store as tstore
from torch_parity import (
    fill_plane,
    release_jax_caches,  # noqa: F401 - autouse fixture
    tenant_ids,
    tenant_queries,
)

torch.set_num_threads(1)

#: each package's pieces, under one set of names
JAX = SimpleNamespace(ten=jten, store_mod=jstore, quota=jquota, types=jtypes,
                      Store=JStore, Manager=JManager, parse=jparse)
PORT = SimpleNamespace(ten=tten, store_mod=tstore, quota=tquota, types=ttypes,
                       Store=TStore, Manager=TManager, parse=tparse)
BOTH = (JAX, PORT)
SEP = "\x1f"


def _nm(pkg, *names):
    ns, errors = pkg.parse("\n".join(
        f"class {n} implements Namespace {{}}" for n in names))
    assert not errors
    return pkg.Manager(ns)


def _t(pkg, s):
    return pkg.types.RelationTuple.from_string(s)


def _outcome(fn):
    """(kind, value): a call's result, or the name of what it raised."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return "raised", type(e).__name__


# -- qualification ----------------------------------------------------------------


@pytest.mark.parametrize("row", [
    "doc:readme#viewer@alice",
    "doc:readme#viewer@group:eng#member",
    f"evil{SEP}doc:x#viewer@group{SEP}x:eng#member",  # the separator spoof
    "doc:a#b@c:d#",
])
def test_qualification_round_trips_match_jax(row):
    outs = []
    for pkg in BOTH:
        st = pkg.store_mod
        t = _t(pkg, row)
        q = st.qualify_tuple("acme", t)
        outs.append((
            str(q), str(st.unqualify_tuple(q)), st.split_ns(q.namespace),
            st.split_ns(st.qualify_ns("victim-not", t.namespace)),
            st.split_ns(t.namespace),
        ))
        assert st.unqualify_tuple(q) == t
    assert outs[0] == outs[1]
    # the split takes the FIRST separator, which the server prepended
    assert outs[1][3][0] == "victim-not"


@pytest.mark.parametrize("nid", ["", f"a{SEP}b", "ok"])
def test_plane_validates_nids_as_jax(nid):
    outs = [_outcome(lambda pkg=pkg: pkg.ten.TenantPlane(
        pkg.Store(), _nm(pkg, "doc")).create(nid)) for pkg in BOTH]
    assert outs[0] == outs[1]


# -- store views: seeded random operations ------------------------------------------


def _view_state(pkg, views, fused, cursor):
    out = {"head": fused.log_head}
    for nid, v in views.items():
        entries, head = v.changes_since(cursor)
        rows, token = v.get_relation_tuples(
            pkg.types.RelationQuery(namespace="doc"), page_size=3)
        out[nid] = (
            sorted(str(t) for t in v.all_tuples()), len(v), v.version,
            [(op, str(t)) for op, t in entries], head,
            [str(t) for t in rows], token,
            v.exists_relation_tuples(pkg.types.RelationQuery(namespace="doc")),
        )
    return out


@pytest.mark.parametrize("seed", range(3))
def test_random_view_operations_match_jax(seed):
    """The same seeded sequence of writes, deletes, transactions and
    scoped delete-alls through three tenants' views of one fused store:
    rows, versions, the global head and the filtered change log agree."""
    nids = ("a", "b", "c")
    sides = []
    for pkg in BOTH:
        fused = pkg.Store()
        sides.append((pkg, fused, {n: fused.with_network(n) for n in nids}))
    rng = random.Random(seed)
    pool = [f"doc:d{i}#viewer@u{j}" for i in range(6) for j in range(3)]
    pool += ["doc:d1#viewer@group:g#member", "file:f#owner@u1"]
    for step in range(80):
        nid, op = rng.choice(nids), rng.random()
        picks = rng.sample(pool, 2)
        cursor = rng.randrange(0, step + 1)
        states = []
        for pkg, fused, views in sides:
            v = views[nid]
            if op < 0.5:
                v.write_relation_tuples(_t(pkg, picks[0]))
            elif op < 0.8:
                v.delete_relation_tuples(_t(pkg, picks[0]))
            elif op < 0.95:
                v.transact_relation_tuples(insert=[_t(pkg, picks[0])],
                                           delete=[_t(pkg, picks[1])])
            else:
                v.delete_all_relation_tuples(
                    pkg.types.RelationQuery(namespace="doc", object="d1"))
            states.append(_view_state(pkg, views, fused, cursor))
        assert states[0] == states[1], f"step {step}"


def test_view_listeners_fire_per_tenant_as_jax():
    got = []
    for pkg in BOTH:
        fused = pkg.Store()
        a, b, a2 = (fused.with_network(n) for n in ("a", "b", "a"))
        seen = {"a": [], "b": [], "a2": []}
        a.on_change(seen["a"].append)
        b.on_change(seen["b"].append)
        a2.on_change(seen["a2"].append)
        a.write_relation_tuples(_t(pkg, "doc:1#v@u"))
        b.write_relation_tuples(_t(pkg, "doc:2#v@u"))
        a2.write_relation_tuples(_t(pkg, "doc:3#v@u"))
        got.append(seen)
    assert got[0] == got[1]
    assert got[1]["a"] == [1, 2] and got[1]["b"] == [1]


# -- quotas ---------------------------------------------------------------------------


def _quota_script(pkg):
    q = pkg.quota
    out = {}
    out["rate0"] = all(q.TokenBucket(0.0).try_take() for _ in range(1000))
    b = q.TokenBucket(0.001, burst=5)
    out["burst"] = [b.try_take() for _ in range(8)]
    g = q.InflightGauge(2)
    out["gauge"] = [g.try_acquire(), g.try_acquire(), g.try_acquire()]
    g.release()
    out["gauge"] += [g.try_acquire(), g.inflight]
    fused = pkg.Store()
    capped = pkg.store_mod.TenantStoreView(
        fused, "noisy", quotas=q.TenantQuotas(max_tuples=3))
    victim = pkg.store_mod.TenantStoreView(fused, "victim")
    out["max_tuples"] = [_outcome(lambda i=i: capped.write_relation_tuples(
        _t(pkg, f"doc:d{i}#v@u"))) for i in range(5)]
    capped.delete_relation_tuples(_t(pkg, "doc:d0#v@u"))
    out["freed"] = _outcome(lambda: capped.write_relation_tuples(
        _t(pkg, "doc:d9#v@u")))
    for i in range(10):
        victim.write_relation_tuples(_t(pkg, f"doc:v{i}#v@u"))
    out["sizes"] = (len(capped), len(victim))
    slow = pkg.store_mod.TenantStoreView(
        fused, "slow", quotas=q.TenantQuotas(write_rate=0.001))
    out["rate"] = [_outcome(lambda i=i: slow.write_relation_tuples(
        _t(pkg, f"doc:s{i}#v@u"))) for i in range(3)]
    out["stats"] = q.TenantQuotas(inflight=4, write_rate=0.0,
                                  max_tuples=9).stats()
    return out


def test_quotas_match_jax():
    jax_out, port_out = (_quota_script(pkg) for pkg in BOTH)
    assert jax_out == port_out
    assert port_out["burst"] == [True] * 5 + [False] * 3
    assert port_out["max_tuples"][3] == ("raised", "TooManyRequestsError")


# -- lifecycle and the plane's namespace manager ----------------------------------------


def _lifecycle_script(pkg):
    plane = pkg.ten.TenantPlane(pkg.Store(), _nm(pkg, "doc", "file"),
                                max_tenants=4, metrics_top_k=2)
    out = {"v0": plane.ns_version}
    out["create"] = [_outcome(lambda n=n: plane.create(n))
                     for n in ("a", "a", "b", "c", "d")]
    out["v1"] = plane.ns_version
    out["delete"] = [_outcome(lambda n=n: plane.delete(n))
                     for n in (plane.default_network, "ghost")]
    v = plane.view_for("b")
    v.write_relation_tuples(_t(pkg, "doc:1#v@u"), _t(pkg, "doc:2#v@u"))
    head0 = plane.fused_store.log_head
    out["purge"] = (plane.delete("b"), plane.fused_store.log_head - head0,
                    plane.has_tenant("b"))
    out["opl"] = [_outcome(lambda s=s: plane.set_opl("a", s)) for s in (
        "class {{{{", "class proj implements Namespace {}")]
    out["names"] = sorted(n.name for n in plane.manager.namespaces())
    out["get"] = [_outcome(lambda n=n: plane.manager.get_namespace(n).name)
                  for n in (f"a{SEP}proj", f"a{SEP}doc", "proj",
                            f"{plane.default_network}{SEP}file")]
    out["tenant_view"] = [n.name for n in plane.manager_for("a").namespaces()]
    out["cleared"] = _outcome(lambda: plane.set_opl("a", ""))
    out["after_clear"] = sorted(n.name for n in plane.manager.namespaces())
    for i, nid in enumerate(plane.tenant_ids()):
        plane.note_checks(nid, i + 1)
    out["catalog"] = [{k: r[k] for k in r if k != "created_at"}
                      for r in plane.catalog()]
    out["stats"] = plane.stats()
    calls = []
    sink = SimpleNamespace(
        gauge=lambda name, v, **kw: calls.append(("gauge", name, v, kw.get("tenant"))),
        counter=lambda name, v, **kw: calls.append(("counter", name, v, kw.get("tenant"))))
    plane.publish(sink)
    out["metrics"] = calls
    return out


def test_lifecycle_and_manager_match_jax():
    jax_out, port_out = (_lifecycle_script(pkg) for pkg in BOTH)
    assert jax_out == port_out
    assert port_out["create"][-1] == ("raised", "TooManyRequestsError")
    assert f"a{SEP}proj" in port_out["names"]
    assert f"a{SEP}doc" not in port_out["names"]
    assert f"a{SEP}doc" in port_out["after_clear"]


def test_plane_fingerprint_follows_the_catalog():
    """The port's plane manager keeps the engine's fingerprint per catalog
    version (``config_fingerprint``): the same value as hashing its
    namespaces, changed by every lifecycle event."""
    from ketotpu_torch.engine.device import config_fingerprint
    from ketotpu_torch.storage.namespaces import namespaces_fingerprint

    plane = tten.TenantPlane(TStore(), _nm(PORT, "doc"))
    seen = set()
    for step in ("x", "y", "opl", "delete"):
        if step == "opl":
            plane.set_opl("x", "class proj implements Namespace {}")
        elif step == "delete":
            plane.delete("y")
        else:
            plane.create(step)
        fp = config_fingerprint(plane.manager)
        assert fp == namespaces_fingerprint(plane.manager.namespaces())
        assert fp == config_fingerprint(plane.manager)
        seen.add(fp)
    assert len(seen) == 4


# -- the slice: a 512-tenant plane served at Q = 512 ---------------------------------

N_TENANTS = 512
N_ROWS = 500  # one chunk, padded to Q = 512
#: caps small enough that the first pass overflows (over bits, retries)
CAPS = dict(frontier=512, arena=1024)


def _plane_of(pkg, tuple_cls):
    ns, errors = pkg.parse(jsynth.SYNTH_OPL)
    assert not errors
    store = pkg.Store()
    plane = pkg.ten.TenantPlane(store, pkg.Manager(ns),
                                max_tenants=N_TENANTS + 1)
    fill_plane(plane, tuple_cls.from_string, jsynth.SYNTH_OPL, N_TENANTS)
    return plane


@pytest.fixture(scope="module")
def planes():
    """Both packages' planes and engines (Leopard on, unfused to begin
    with): one projection each, shared by the unfused and fused runs."""
    jplane = _plane_of(JAX, jtypes.RelationTuple)
    tplane = _plane_of(PORT, ttypes.RelationTuple)
    jeng = JEngine(jplane.fused_store, jplane.manager, fused_dispatch=False,
                   **CAPS)
    teng = TEngine(tplane.fused_store, tplane.manager, fused_dispatch=False,
                   device="cpu", **CAPS)
    # fixed schedules on both sides: no occupancy feedback
    for eng in (jeng, teng):
        eng._update_occ = lambda *a: None
        eng._update_gen_occ = lambda *a: None
    return jplane, tplane, jeng, teng


@pytest.fixture
def sorts(monkeypatch):
    """Calls of each package's sort-based and scatter packs."""
    n = {"jax_sort": 0, "jax_scatter": 0, "sort": 0, "scatter": 0}
    for module, name, key in ((jfp, "_pack_sort", "jax_sort"),
                              (jfp, "_pack_scatter", "jax_scatter"),
                              (tfp, "_pack_sort_plain", "sort"),
                              (tfp, "_pack_scatter_plain", "scatter")):
        orig = getattr(module, name)

        def counted(*a, _orig=orig, _key=key, **k):
            n[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(module, name, counted)
    return n


def _counters(eng):
    return {"retries": eng.retries, "fallbacks": eng.fallbacks,
            "fused_tier_rows": dict(eng.fused_tier_rows),
            "leopard_answered": eng.leopard_answered}


def test_plane_tables_match_jax(planes):
    _jp, _tp, jeng, teng = planes
    jeng.snapshot()
    jg = jeng._device_arrays
    tg = teng.device_tables()
    assert tuple(tg["f_direct_ok"].shape) == (4096, 2048)
    common = sorted(set(jg) & set(tg))
    assert {"taint", "err_reach", "prog_root", "f_css_rel"} <= set(common)
    for k in common:
        want = np.asarray(jg[k])
        got = tg[k].numpy()
        if k == "ov_nbase":  # 0-d in JAX, one element in the port
            got = got.reshape(want.shape)
        assert np.array_equal(got, want), k


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_plane_engine_matches_jax_and_takes_the_sort(planes, sorts, fused):
    jplane, _tp, jeng, teng = planes
    rows = tenant_queries(N_TENANTS, N_ROWS, seed=11 + fused)
    before = (_counters(jeng), _counters(teng))
    jeng.fused_dispatch = teng.fused_dispatch = fused
    want = jeng.batch_check([jtypes.RelationTuple.from_string(s) for s in rows])
    got = teng.batch_check([ttypes.RelationTuple.from_string(s) for s in rows])
    assert got == want
    oracle = JOracle(jplane.fused_store, jplane.manager)
    sample = range(0, N_ROWS, 7)
    assert [got[i] for i in sample] == [
        oracle.check_is_member(jtypes.RelationTuple.from_string(rows[i]))
        for i in sample]
    assert 0 < sum(got) < N_ROWS
    delta = [{k: (v - b[k] if not isinstance(v, dict)
                  else {t: v[t] - b[k][t] for t in v})
              for k, v in _counters(e).items()}
             for e, b in zip((jeng, teng), before)]
    assert delta[0] == delta[1]
    assert delta[1]["retries"] > 0  # the first pass overflowed: over bits
    # the Q = 512 batch packs by sort (9 + 12 + 11 key bits); a retry of
    # at most 256 rows pads to Q = 256 (31 bits) and takes the scatter, in
    # both packages alike (JAX counts traces, the port calls)
    assert sorts["jax_sort"] > 0 and sorts["sort"] > 0
    assert (sorts["jax_scatter"] > 0) == (sorts["scatter"] > 0)


def test_tenant_engines_serve_their_own_tenant_only(planes):
    """``TenantCheckEngine.batch_check`` over the shared port engine, a few
    tenants at a time, against the exact oracle; then a grant written
    through one tenant's store view reaches that tenant's next verdict and
    no other tenant's, though both ask the same unqualified question."""
    jplane, tplane, _jeng, teng = planes
    nids = tenant_ids(N_TENANTS)
    oracle = JOracle(jplane.fused_store, jplane.manager)
    for k, nid in enumerate((nids[0], nids[17], nids[-1])):
        rows = [s.split(SEP, 1)[1] for s in tenant_queries(1, 40, seed=k)]
        got = tplane.engine_for(nid, teng).batch_check(
            [ttypes.RelationTuple.from_string(s) for s in rows])
        assert got == [oracle.check_is_member(jtypes.RelationTuple.from_string(
            f"{nid}{SEP}{s}")) for s in rows]
    probe = [ttypes.RelationTuple.from_string("Doc:d0#view@intruder")]
    a_eng = tplane.engine_for(nids[1], teng)
    b_eng = tplane.engine_for(nids[2], teng)
    assert a_eng.batch_check(probe) == b_eng.batch_check(probe) == [False]

    def row(nid):
        return next(r for r in tplane.catalog() if r["id"] == nid)

    writes0 = row(nids[1])["writes"]
    tplane.view_for(nids[1]).write_relation_tuples(
        ttypes.RelationTuple.from_string("Doc:d0#viewers1@intruder"))
    assert a_eng.batch_check(probe) == [True]
    assert b_eng.batch_check(probe) == [False]
    assert row(nids[1])["checks"] == 2 and row(nids[2])["checks"] == 2
    assert row(nids[1])["writes"] == writes0 + 1


def _edit_rows(n: int, seed: int):
    """Doc#edit rows (banned AND NOT view: the general tier) of random
    tenants, and their Doc#view twins."""
    rows = []
    for s in tenant_queries(N_TENANTS, 4 * n, seed=seed):
        if "#view@" in s:
            rows += [s.replace("#view@", "#edit@"), s]
    return rows[:n]


def test_general_sub_run_takes_the_sort(planes, sorts):
    """AND/NOT rows: the tier-2 program hands its pure-OR leaves to a
    sub-run whose leaf buffer (at least 512 here: 9 + 12 + 11 key bits)
    packs by sort; the verdicts are the oracle's."""
    jplane, _tp, _jeng, teng = planes
    teng.fused_dispatch = False
    rows = [s for s in _edit_rows(600, seed=21) if "#edit@" in s]
    g0 = teng.general_rows
    got = teng.batch_check([ttypes.RelationTuple.from_string(s) for s in rows])
    oracle = JOracle(jplane.fused_store, jplane.manager)
    assert got == [oracle.check_is_member(jtypes.RelationTuple.from_string(s))
                   for s in rows]
    assert teng.general_rows - g0 == len(rows) and sorts["sort"] > 0


def test_mesh_pack_takes_the_sort(planes, sorts):
    """The graph-sharded engine over the same plane, two shards on the
    CPU: each shard packs the rows routed to it by sort, and the verdicts
    equal the single-device engine's and the oracle's."""
    from ketotpu_torch.parallel import MeshCheckEngine

    jplane, tplane, _jeng, teng = planes
    meng = MeshCheckEngine(tplane.fused_store, tplane.manager, mesh_devices=2,
                           devices=["cpu"] * 2, **CAPS)
    rows = tenant_queries(N_TENANTS, N_ROWS, seed=31) + _edit_rows(60, seed=32)
    queries = [ttypes.RelationTuple.from_string(s) for s in rows]
    teng.fused_dispatch = False
    want = teng.batch_check(queries)
    n_single = sorts["sort"]
    got = meng.batch_check(queries)
    assert got == want
    oracle = JOracle(jplane.fused_store, jplane.manager)
    assert got[::9] == [oracle.check_is_member(
        jtypes.RelationTuple.from_string(s)) for s in rows[::9]]
    assert sorts["sort"] > n_single

"""Port parity: the graph-sharded mesh's partition, route and fast run
(``ketotpu_torch/parallel/graphshard.py``) against the JAX package's
``parallel/graphshard.py``, at tolerance 0.

The JAX side runs on the virtual 8-device CPU platform that
``tests/conftest.py`` forces; the port's shards are ``["cpu"] * n`` in one
process, so its wrappers take their plain versions (``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold the CUDA kernels against those on the
card).  XLA:CPU compiles each sharded program shape anew (about 10-25 s),
so the file keeps to three: the route at one shape, and the fast run at
the JAX suite's roomy caps (an explicit ``assign`` column reuses it) and
at its overflowing ones.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ketotpu.api.types import SubjectSet as JSubjectSet
from ketotpu.parallel import graphshard as jgs
from ketotpu.parallel import make_mesh as jmake_mesh
from ketotpu.utils import synth as jsynth
from ketotpu_torch.engine import fastpath as tfp
from ketotpu_torch.parallel import graphshard as tgs
from ketotpu_torch.parallel import make_mesh as tmake_mesh
from ketotpu_torch.utils import synth as tsynth
from torch_parity import release_jax_caches  # noqa: F401 - autouse fixture

torch.set_num_threads(1)

GRAPH = dict(n_users=64, n_groups=8, n_folders=32, n_docs=128)
ROUTE_COLS = ("qid", "ns", "obj", "rel", "d", "skip", "force")


# -- the owner hash -----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8])
def test_owner_hash_matches_jax(n):
    rng = np.random.default_rng(n)
    edge = np.array([0, 1, -1, -2, 2**31 - 1, -(2**31), 65535, 65536],
                    np.int32)
    ns = np.concatenate([edge, rng.integers(-5, 40, 4000).astype(np.int32),
                         np.repeat(edge, len(edge))])
    obj = np.concatenate([edge[::-1], rng.integers(-(2**31), 2**31 - 1, 4000,
                                                   dtype=np.int64).astype(np.int32),
                          np.tile(edge, len(edge))])
    want = np.asarray(jgs.shard_of_device(jnp.asarray(ns), jnp.asarray(obj), n))
    host = jgs.shard_of_np(ns.astype(np.int64), obj.astype(np.int64), n)
    assert np.array_equal(tgs.shard_of_np(ns.astype(np.int64),
                                          obj.astype(np.int64), n), host)
    got = tgs.shard_owner(torch.from_numpy(ns), torch.from_numpy(obj), n)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, host)
    assert set(np.unique(want)) == set(range(n))


# -- the sharded stacks -------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    return jsynth.build_synth(**GRAPH), tsynth.build_synth(**GRAPH)


@pytest.mark.parametrize("n,replicate", [(4, False), (3, True), (8, False)])
def test_sharded_stacks_match_jax(graphs, n, replicate):
    """Key by key, the padded per-shard stacks (and, replicated, a hot
    key's rows copied to two more shards)."""
    jg, tg = graphs
    jsnaps, jst = jgs.build_sharded_snapshot(jg.store, jg.manager, n)
    tsnaps, tst = tgs.build_sharded_snapshot(tg.store, tg.manager, n)
    extra = 0
    if replicate:
        t = next(x for x in tg.store.all_tuples() if x.namespace == "Folder")
        jv, tv = jsnaps[0].vocab, tsnaps[0].vocab
        key = (tv.namespaces.lookup(t.namespace), tv.objects.lookup(t.object))
        assert key == (jv.namespaces.lookup(t.namespace),
                       jv.objects.lookup(t.object))
        owner = int(tgs.shard_of_np(np.array([key[0]]), np.array([key[1]]), n)[0])
        rep = {key: [(owner + 1) % n, (owner + 2) % n]}
        jsnaps, jst = jgs.build_sharded_snapshot(jg.store, jg.manager, n,
                                                 vocab=jv, replicate=rep)
        tsnaps, tst = tgs.build_sharded_snapshot(tg.store, tg.manager, n,
                                                 vocab=tv, replicate=rep)
        extra = 2 * sum(1 for x in tg.store.all_tuples()
                        if (x.namespace, x.object) == (t.namespace, t.object))
    assert set(tst) == set(jst)
    for k in jst:
        assert tst[k].dtype == jst[k].dtype, k
        assert np.array_equal(tst[k], jst[k]), k
    assert [s.n_tuples for s in tsnaps] == [s.n_tuples for s in jsnaps]
    assert sum(s.n_tuples for s in tsnaps) == len(tg.store) + extra
    assert max(s.n_tuples for s in tsnaps) < len(tg.store) // 2 + extra


# -- the route and the exchange ----------------------------------------------------


def _children(rng, n, A, Q):
    def col(lo, hi):
        return rng.integers(lo, hi, (n, A)).astype(np.int32)

    qid = col(0, Q)
    qid[rng.random((n, A)) < 0.25] = -1
    return dict(qid=qid, ns=col(0, 4), obj=col(0, 3000), rel=col(0, 16),
                d=col(0, 6), skip=rng.random((n, A)) < 0.5,
                force=rng.random((n, A)) < 0.5)


def test_route_and_exchange_match_jax_all_to_all():
    """Every shard routes its own children (a quarter dead, most
    destinations past ``cap``); each shard's received block and over bits
    equal the JAX ``_route`` under ``shard_map`` (``lax.all_to_all``)."""
    n, A, Q, cap = 4, 256, 64, 24
    rng = np.random.default_rng(5)
    ch = _children(rng, n, A, Q)
    q_over = (rng.random((n, Q)) < 0.1)
    mesh = jmake_mesh(n, axis="shard")

    def local(c, qo):
        c = {k: v[0] for k, v in c.items()}
        out, qo2 = jgs._route(c, n, cap, qo[0], "shard")
        recv = jnp.stack([out[k].astype(jnp.int32) for k in ROUTE_COLS], axis=1)
        return recv[None], qo2[None]

    jrecv, jover = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P("shard"), P("shard")),
        out_specs=(P("shard"), P("shard")), check_vma=False,
    ))({k: jnp.asarray(v) for k, v in ch.items()}, jnp.asarray(q_over))
    jrecv, jover = np.asarray(jrecv), np.asarray(jover)

    tmesh = tmake_mesh(n, axis="shard", devices=["cpu"] * n)
    sends, overs = [], []
    for s in range(n):
        items = tfp.Items(*(torch.from_numpy(np.ascontiguousarray(ch[k][s]))
                            for k in ROUTE_COLS))
        send, qo = tgs.shard_route(
            items, torch.from_numpy(q_over[s].astype(np.int32)),
            n_shards=n, cap=cap)
        sends.append(send)
        overs.append(qo)
    recvs = tgs.exchange(sends, tmesh.devices, cap)
    for s in range(n):
        assert np.array_equal(recvs[s].numpy(), jrecv[s]), s
        assert np.array_equal(overs[s].numpy().astype(bool), jover[s]), s
    assert jover.sum() > q_over.sum(), "the caps must overflow"
    assert (jrecv[:, :, 0] >= 0).sum() > n * cap  # most rows filled


# -- the sharded fast run ------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded(graphs):
    """(JAX stacks, port shard tables, queries encoded, oracle verdicts) at
    n = 8 over the JAX suite's cross-shard synth graph."""
    jg, tg = graphs
    n = 8
    _jsnaps, jst = jgs.build_sharded_snapshot(jg.store, jg.manager, n)
    tsnaps, tst = tgs.build_sharded_snapshot(tg.store, tg.manager, n)
    tables = tgs.upload_shards(tst, tmake_mesh(n, "shard", ["cpu"] * n))
    queries = jsynth.synth_queries(jg, 128)
    v = tsnaps[0].vocab
    enc = (
        np.array([v.namespaces.lookup(q.namespace) for q in queries], np.int32),
        np.array([v.objects.lookup(q.object) for q in queries], np.int32),
        np.array([v.relations.lookup(q.relation) for q in queries], np.int32),
        np.array([v.subject_key(q.subject) for q in queries], np.int32),
        np.full(len(queries), 5, np.int32),
    )
    crossings = 0
    for t in jg.store.all_tuples():
        if isinstance(t.subject, JSubjectSet):
            ids = [(v.namespaces.lookup(a), v.objects.lookup(b)) for a, b in (
                (t.namespace, t.object), (t.subject.namespace, t.subject.object))]
            own = tgs.shard_of_np(np.array([i[0] for i in ids]),
                                  np.array([i[1] for i in ids]), n)
            crossings += int(own[0] != own[1])
    assert crossings > 50, crossings
    from ketotpu.engine.oracle import CheckEngine

    oracle = CheckEngine(jg.store, jg.manager)
    want = np.array([oracle.check_is_member(q) for q in queries])
    return n, jst, tables, enc, want


def _both(sharded, rows=None, **kw):
    n, jst, tables, enc, _want = sharded
    enc = tuple(a[:rows] for a in enc)
    jres = jgs.sharded_check(jst, enc, jmake_mesh(n, axis="shard"), **kw)
    tres = tgs.sharded_check(tables, enc, tmake_mesh(n, "shard", ["cpu"] * n), **kw)
    for name in ("found", "over", "dirty"):
        assert np.array_equal(getattr(tres, name), np.asarray(getattr(jres, name))), name
    return tres


def test_sharded_check_matches_jax_across_shards(sharded):
    res = _both(sharded, frontier=1024, arena=4096)
    want = sharded[4]
    assert not res.over.any()
    assert np.array_equal(res.found, want)
    assert want.any() and not want.all()


def test_sharded_check_with_an_explicit_assign_column(sharded):
    """Roots activate where ``assign`` says: a third moved off their hash
    owner (their probes miss there), a tenth of them inactive."""
    n, _jst, _tables, enc, _want = sharded
    rng = np.random.default_rng(3)
    owner = tgs.shard_of_np(np.clip(enc[0], 0, None), np.clip(enc[1], 0, None), n)
    assign = np.where(rng.random(len(owner)) < 0.33, (owner + 1) % n, owner)
    active = rng.random(len(owner)) > 0.1
    res = _both(sharded, frontier=1024, arena=4096, assign=assign.astype(np.int32),
                active=active)
    assert not res.found[~active].any()


def test_sharded_check_overflow_is_monotone(sharded):
    """Tiny caps (64 rows, the JAX suite's): the route and the frontier
    overflow; an over row is never a wrong IS, and a clean row equals the
    oracle."""
    res = _both(sharded, rows=64, frontier=64, arena=128)
    want = sharded[4][:64]
    assert res.over.any()
    assert not (res.found & ~want).any()
    clean = ~res.over
    assert np.array_equal(res.found[clean], want[clean])

"""Port parity of K5b, the sort-based frontier pack
(``fastpath._pack_sort``), and of the sort under it (``xutil.lex_sort``)
against the JAX package, at tolerance 0.

The pack takes the sort whenever the (query, namespace, relation) key does
not pack into 31 bits.  Its frontier comes out in key order, which the
next level's arena offsets, overflow and occupancy depend on, so the
frontier columns, ``q_over`` and the occupancy are held to JAX, not only
the verdicts.  ``lax.sort`` is not stable and the port's sort is, so the
payload of ``lex_sort`` is compared per group of equal keys.  The CUDA
kernels are held against these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.engine import delta as jdelta
from ketotpu.engine import fastpath as jfp
from ketotpu.engine import xutil as jxutil
from ketotpu.engine.vocab import Vocab as JVocab
from ketotpu.opl.parser import parse as jparse
from ketotpu.storage import InMemoryTupleStore as JStore
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu.tenancy import TenantPlane as JPlane
from ketotpu.utils import synth as jsynth
from ketotpu_torch.engine import fastpath as tfp
from ketotpu_torch.engine import xutil as txutil
from ketotpu_torch.engine.device import upload
from torch_parity import (
    fill_plane,
    release_jax_caches,  # noqa: F401 - autouse fixture
    tenant_queries,
)

torch.set_num_threads(1)

FRONTIER_COLS = ("qid", "ns", "obj", "rel", "depth", "skip", "force")


def _np(x):
    return np.asarray(x)


def _children(rng, a: int, q: int, n_ns: int, n_obj: int):
    """Seeded arena columns: dead rows (qid -1), rows of found queries and
    many duplicate (query, node) keys with differing depth/skip/force."""
    cols = dict(
        qid=rng.integers(-1, q, a).astype(np.int32),
        ns=rng.integers(0, n_ns, a).astype(np.int32),
        obj=rng.integers(0, n_obj, a).astype(np.int32),
        rel=rng.integers(0, 3, a).astype(np.int32),
        d=rng.integers(0, 6, a).astype(np.int32),
        skip=rng.random(a) < 0.5,
        force=rng.random(a) < 0.3,
    )
    # exact copies of earlier keys, with their own d/skip/force
    src = rng.integers(0, a, a // 4)
    dst = rng.integers(0, a, a // 4)
    for c in ("qid", "ns", "obj", "rel"):
        cols[c][dst] = cols[c][src]
    return cols


def _port_children(cols, as_rows: bool):
    if as_rows:
        return torch.from_numpy(np.stack(
            [cols[c].astype(np.int32) for c in tfp.ITEM_COLS], axis=1).copy())
    return tfp.Items(*(torch.from_numpy(cols[c].copy()) for c in tfp.ITEM_COLS))


def _assert_frontier(out, jout):
    for c, j in zip(tfp.ITEM_COLS, FRONTIER_COLS):
        want = _np(jout[f"f_{j}"])
        got = getattr(out, c).numpy()
        assert got.dtype == want.dtype, c
        assert np.array_equal(got, want), c


_JAX_PACK_SORT = jax.jit(jfp._pack_sort, static_argnames=("frontier",))


# -- K5b: the sort-based pack ----------------------------------------------------


@pytest.mark.parametrize("as_rows", [False, True], ids=["items", "rows"])
@pytest.mark.parametrize("a,q,f,n_obj", [
    (64, 16, 8, 6),  # the frontier overflows: over bits
    (64, 16, 64, 4),  # heavy duplication, room for every survivor
    (1000, 300, 2000, 50),
    (4096, 512, 1024, 200),  # overflow at a served-like width
])
def test_pack_sort_matches_jax(a, q, f, n_obj, as_rows):
    rng = np.random.default_rng(a + q + f)
    cols = _children(rng, a, q, n_ns=5, n_obj=n_obj)
    q_found = rng.random(q) < 0.2
    q_over = rng.random(q) < 0.1
    jout, jqo = _JAX_PACK_SORT({c: jnp.asarray(v) for c, v in cols.items()},
                               jnp.asarray(q_found), jnp.asarray(q_over),
                               frontier=f)
    occ = torch.full((1,), -7, dtype=torch.int32)
    out, qo = tfp._pack_sort(
        _port_children(cols, as_rows),
        torch.from_numpy(q_found.astype(np.int32)),
        torch.from_numpy(q_over.astype(np.int32)),
        frontier=f, nsb=3, relb=2, occ_out=occ)
    _assert_frontier(out, jout)
    assert np.array_equal(qo.numpy().astype(bool), _np(jqo))
    assert int(occ[0]) == int((_np(jout["f_qid"]) >= 0).sum())
    if f < a // 4:
        assert qo.numpy().sum() > q_over.sum()  # the overflow marked queries


def test_pack_sort_of_dead_children_is_empty():
    cols = _children(np.random.default_rng(1), 64, 16, 5, 6)
    cols["qid"][:] = -1
    occ = torch.zeros(1, dtype=torch.int32)
    out, qo = tfp._pack_sort(_port_children(cols, False),
                             torch.zeros(16, dtype=torch.int32),
                             torch.zeros(16, dtype=torch.int32),
                             frontier=32, nsb=3, relb=2, occ_out=occ)
    assert (out.qid == -1).all() and (out.ns == -1).all()
    assert int(occ[0]) == 0 and int(qo.sum()) == 0


def test_pack_phase_takes_the_sort_past_31_key_bits(monkeypatch):
    """Q = 64 (6 bits), 2^16 namespaces and 2^12 relations: 34 key bits.
    Both packages' ``pack_phase`` take the sort and agree."""
    calls = {"jax_sort": 0, "jax_scatter": 0, "sort": 0, "scatter": 0}

    def counted(module, name, key):
        orig = getattr(module, name)

        def f(*a, **k):
            calls[key] += 1
            return orig(*a, **k)

        monkeypatch.setattr(module, name, f)

    counted(jfp, "_pack_sort", "jax_sort")
    counted(jfp, "_pack_scatter", "jax_scatter")
    counted(tfp, "_pack_sort_plain", "sort")
    counted(tfp, "_pack_scatter_plain", "scatter")
    ns_dim, rel_dim, q, f = 1 << 16, 1 << 12, 64, 128
    rng = np.random.default_rng(5)
    cols = _children(rng, 512, q, n_ns=ns_dim, n_obj=9)
    cols["ns"] = rng.choice([0, 7, ns_dim - 1], 512).astype(np.int32)
    cols["rel"] = rng.choice([1, rel_dim - 1], 512).astype(np.int32)
    q_found = rng.random(q) < 0.1
    q_over = np.zeros(q, bool)
    jout, jqo = jax.jit(jfp.pack_phase, static_argnames=(
        "frontier", "ns_dim", "rel_dim"))(
        {c: jnp.asarray(v) for c, v in cols.items()}, jnp.asarray(q_found),
        jnp.asarray(q_over), frontier=f, ns_dim=ns_dim, rel_dim=rel_dim)
    out, qo = tfp.pack_phase(_port_children(cols, False),
                             torch.from_numpy(q_found.astype(np.int32)),
                             torch.from_numpy(q_over.astype(np.int32)),
                             frontier=f, ns_dim=ns_dim, rel_dim=rel_dim)
    _assert_frontier(out, jout)
    assert np.array_equal(qo.numpy().astype(bool), _np(jqo))
    assert calls == {"jax_sort": 1, "jax_scatter": 0, "sort": 1, "scatter": 0}


# -- lex_sort ---------------------------------------------------------------------


@pytest.mark.parametrize("n_keys,n_payload,n", [
    (1, 0, 0), (1, 1, 1), (2, 1, 37), (3, 2, 1000), (4, 1, 4096), (4, 0, 300),
])
def test_lex_sort_matches_jax(n_keys, n_payload, n):
    rng = np.random.default_rng(10 * n_keys + n)
    # narrow ranges with negatives: many ties, signed order
    keys = [rng.integers(-4, 5, n).astype(np.int32) for _ in range(n_keys)]
    if n_keys > 1 and n:
        keys[-1][: n // 3] = np.iinfo(np.int32).min
        keys[0][n // 2:] = np.iinfo(np.int32).max
    payload = [rng.integers(-1000, 1000, n).astype(np.int32)
               for _ in range(n_payload)]
    jk, jp = jxutil.lex_sort([jnp.asarray(k) for k in keys],
                             *[jnp.asarray(p) for p in payload])
    tk, tpay = txutil.lex_sort([torch.from_numpy(k) for k in keys],
                               *[torch.from_numpy(p) for p in payload])
    assert len(tk) == n_keys and len(tpay) == n_payload
    for j, t in zip(jk, tk):
        assert t.dtype == torch.int32
        assert np.array_equal(t.numpy(), _np(j))
    # equal keys may carry their payload in another order (lax.sort is not
    # stable): compare the rows as multisets; the keys already agree row
    # for row, so this compares each group of equal keys
    jrows = sorted(zip(*[_np(c).tolist() for c in (*jk, *jp)]))
    trows = sorted(zip(*[c.numpy().tolist() for c in (*tk, *tpay)]))
    assert jrows == trows


def test_lex_sort_is_stable_and_takes_a_key_block():
    keys = torch.tensor([[2, 1, 2, 1, 2], [0, 0, 0, 0, 0]], dtype=torch.int32)
    pay = torch.arange(5, dtype=torch.int32)
    (k0, k1), (p,) = txutil.lex_sort(keys, pay, bits=(2, 1))
    assert k0.tolist() == [1, 1, 2, 2, 2] and k1.tolist() == [0] * 5
    assert p.tolist() == [1, 3, 0, 2, 4]


# -- a whole batch past 31 key bits ---------------------------------------------


N_TENANTS = 128


@pytest.fixture(scope="module")
def plane_tables():
    """The snapshot of a 128-tenant plane (each tenant its own relation
    names): namespace dim 1024, relation dim 512."""
    namespaces, errors = jparse(jsynth.SYNTH_OPL)
    assert not errors
    store = JStore()
    plane = JPlane(store, JManager(namespaces), max_tenants=N_TENANTS + 1)
    fill_plane(plane, JTuple.from_string, jsynth.SYNTH_OPL, N_TENANTS)
    snap = jdelta.build_snapshot_cols(
        jdelta.TupleColumns.from_tuples(JVocab(), store.all_tuples()),
        plane.manager)
    arrays = snap.check_arrays()
    return snap, jax.device_put(arrays), upload(arrays, "cpu")


def _qpack(snap, queries, q: int, depth: int = 5):
    v = snap.vocab
    ts = [JTuple.from_string(s) for s in queries]
    n = len(ts)
    rows = np.zeros((6, q), np.int32)
    rows[:4, n:] = -1
    rows[0, :n] = [v.namespaces.lookup(t.namespace) for t in ts]
    rows[1, :n] = [v.objects.lookup(t.object) for t in ts]
    rows[2, :n] = [v.relations.lookup(t.relation) for t in ts]
    rows[3, :n] = [v.subject_key(t.subject) for t in ts]
    rows[4, :n] = depth
    rows[5, :n] = 1
    return rows


def test_run_fast_packed_past_31_key_bits_matches_jax(plane_tables, monkeypatch):
    """The whole multi-level batch where every pack takes the sort: verdict
    bytes (found, over, dirty bits) and per-level occupancy at tolerance 0,
    at caps that overflow (over bits and over-driven occupancy)."""
    snap, jg, tg = plane_tables
    ns_dim, rel_dim = snap.flat.direct_ok.shape
    nsb, relb = jfp._pack_bits(ns_dim), jfp._pack_bits(rel_dim)
    q = 1 << (32 - nsb - relb)  # the smallest batch past 31 key bits
    assert jfp._pack_bits(q) + nsb + relb == 32
    sorts = {"jax": 0, "port": 0}
    orig_j, orig_t = jfp._pack_sort, tfp._pack_sort_plain

    def jcount(*a, **k):
        sorts["jax"] += 1
        return orig_j(*a, **k)

    def tcount(*a, **k):
        sorts["port"] += 1
        return orig_t(*a, **k)

    monkeypatch.setattr(jfp, "_pack_sort", jcount)
    monkeypatch.setattr(tfp, "_pack_sort_plain", tcount)
    qpack = _qpack(snap, tenant_queries(N_TENANTS, q - 100, seed=3), q)
    kw = dict(frontier=q, arena=q, max_depth=5, max_width=100)
    jcodes, jocc = jfp.run_fast_packed(jg, qpack, **kw)
    res = tfp.run_fast_packed(tg, qpack, **kw)
    codes, occ = res.fetch()
    assert np.array_equal(codes, _np(jcodes))
    assert np.array_equal(occ, _np(jocc))
    assert (codes & 1).any() and ((codes >> 1) & 1).any()
    assert sorts["jax"] >= 4 and sorts["port"] == 4  # every packing level

"""Port parity of tier 0: ``ketotpu_torch.leopard`` against the JAX
package's ``ketotpu.leopard`` on the same tuples, at tolerance 0.

The closure index is host numpy in both packages (the port's is a copy),
so its arrays, its verdicts and its probe modes must be identical, also
after incremental changes; the device half — the shipped pair columns and
the K6 binary search's plain version — must equal the JAX
``ship_pairs`` / ``probe_in_program`` bit for bit, including the case
where the pairs fill their bucket exactly and the search's midpoint
reaches the capacity (JAX clamps that gather).
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.engine import delta as jdelta
from ketotpu.engine.vocab import Vocab as JVocab
from ketotpu.leopard import closure as jclosure
from ketotpu.leopard import device as jleodev
from ketotpu.opl.ast import Namespace as JNamespace
from ketotpu.opl.parser import parse as jparse
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu.utils import synth as jsynth
from ketotpu_torch.api.types import RelationTuple as TTuple
from ketotpu_torch.engine import delta as tdelta
from ketotpu_torch.engine.vocab import Vocab as TVocab
from ketotpu_torch.leopard import closure as tclosure
from ketotpu_torch.leopard import device as tleodev
from ketotpu_torch.opl.ast import Namespace as TNamespace
from ketotpu_torch.opl.parser import parse as tparse
from ketotpu_torch.storage.namespaces import StaticNamespaceManager as TManager
from torch_parity import (
    REWRITES_TUPLES,
    release_jax_caches,  # noqa: F401 - autouse fixture
)

torch.set_num_threads(1)

ARRAYS = ("nodes", "set_src", "set_dst", "set_hop", "rset_dst", "rset_src",
          "rset_hop", "elt_packed", "elt_set", "elt_e", "elt_hop", "relt_e",
          "relt_set", "tainted")


def _random_graph(seed, *, n_groups=16, n_users=10, depth=12):
    """Nested-group tuples as ``tests/test_leopard.py`` draws them: a
    depth-``depth`` containment chain, random extra containment edges in
    both directions (cycles occur), users scattered over groups."""
    rng = random.Random(seed)
    groups = [f"G{i}" for i in range(n_groups)]
    users = [f"u{i}" for i in range(n_users)]
    tuples = set()
    for i in range(min(depth, n_groups) - 1):
        tuples.add(f"g:{groups[i]}#member@g:{groups[i + 1]}#member")
    for _ in range(n_groups):
        a, b = rng.sample(groups, 2)
        tuples.add(f"g:{a}#member@g:{b}#member")
    for u in users:
        for g in rng.sample(groups, rng.randint(1, 3)):
            tuples.add(f"g:{g}#member@{u}")
    return groups, users, sorted(tuples)


def _rewrites_managers():
    from torch_parity import FIXTURES

    src = (FIXTURES / "rewrites_namespaces.keto.ts").read_text()
    jns, jerr = jparse(src)
    tns, terr = tparse(src)
    assert not jerr and not terr
    return JManager(jns), TManager(tns)


def _graph(name):
    """(tuple strings, JAX manager, port manager) of a named graph."""
    if name == "synth":
        g = jsynth.build_synth(seed=0)
        tuples = sorted(str(t) for t in g.store.tuples_and_head()[0])
        jns, _ = jparse(jsynth.SYNTH_OPL)
        tns, _ = tparse(jsynth.SYNTH_OPL)
        return tuples, JManager(jns), TManager(tns)
    if name == "deep":
        g = jsynth.build_deep_groups(depth=12, n_chains=8)
        tuples = sorted(str(t) for t in g.store.tuples_and_head()[0])
        jns, _ = jparse(jsynth.SYNTH_OPL)
        tns, _ = tparse(jsynth.SYNTH_OPL)
        return tuples, JManager(jns), TManager(tns)
    if name == "rewrites":
        jm, tm = _rewrites_managers()
        return list(REWRITES_TUPLES), jm, tm
    seed = int(name.split("-")[1])
    _groups, _users, tuples = _random_graph(seed)
    return (tuples, JManager([JNamespace("g"), JNamespace("u")]),
            TManager([TNamespace("g"), TNamespace("u")]))


def _build(tuples, jman, tman, **kw):
    """The two indexes over the same tuples, each with its own columns."""
    jcols = jdelta.TupleColumns.from_tuples(
        JVocab(), [JTuple.from_string(s) for s in tuples])
    tcols = tdelta.TupleColumns.from_tuples(
        TVocab(), [TTuple.from_string(s) for s in tuples])
    jidx = jclosure.ClosureIndex(**kw)
    tidx = tclosure.ClosureIndex(**kw)
    jidx.build_from_cols(jcols, jman)
    tidx.build_from_cols(tcols, tman)
    jidx.bind_vocab(jcols.vocab)
    tidx.bind_vocab(tcols.vocab)
    return (jidx, jcols), (tidx, tcols)


def _assert_same_index(jidx, tidx):
    assert jidx.R == tidx.R and jidx.n_nodes == tidx.n_nodes
    for name in ARRAYS:
        a, b = getattr(jidx, name), getattr(tidx, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert jidx._rewrite_his == tidx._rewrite_his
    assert jidx._d_elt == tidx._d_elt
    assert jidx.dirty == tidx.dirty and jidx._d_taint == tidx._d_taint
    assert jidx.stats() | {"build_s": 0} == tidx.stats() | {"build_s": 0}


GRAPHS = ["synth", "deep", "rewrites", "random-0", "random-1", "random-2",
          "random-3"]


@pytest.mark.parametrize("name", GRAPHS)
def test_closure_arrays_match_jax(name):
    tuples, jman, tman = _graph(name)
    (jidx, _), (tidx, _) = _build(tuples, jman, tman)
    assert tidx.pairs > 0
    _assert_same_index(jidx, tidx)


def _queries(cols, rng, n):
    """Encoded (ns, obj, rel, subj) of seeded queries over the vocab:
    existing ids (mostly), -1 misses, and an unknown relation."""
    v = cols.vocab
    k = lambda m: rng.integers(-1, m, n).astype(np.int32)  # noqa: E731
    q_ns = k(len(v.namespaces))
    q_obj = k(len(v.objects))
    q_rel = k(len(v.relations) + 1)
    q_subj = k(len(v.subjects))
    return q_ns, q_obj, q_rel, q_subj


def _verdicts(idx, cols, q, depths):
    q_ns, q_obj, q_rel, q_subj = q
    nodes, node_hi = idx.node_ids_np(q_ns, q_obj, q_rel)
    out = [nodes, node_hi]
    for d in depths:
        allowed, answered = idx.answer_checks(nodes, q_subj, node_hi, d)
        out += [allowed, answered, idx.prep_fused_checks(nodes, q_subj,
                                                         node_hi, d)]
    return out


def _member_queries(cols, groups, users):
    """Every (group, user) membership check of a random graph, encoded."""
    v = cols.vocab
    rows = [(v.namespaces.lookup("g"), v.objects.lookup(g),
             v.relations.lookup("member"), v.subjects.lookup(f"id:{u}"))
            for g in groups + ["nobody"] for u in users]
    return tuple(np.array(c, np.int32) for c in zip(*rows))


@pytest.mark.parametrize("seed", range(4))
def test_answers_and_probe_modes_match_jax_across_changes(seed):
    """answer_checks and prep_fused_checks agree before and after
    apply_changes adds (delta pairs: LM_ALLOW within the depth budget,
    LM_HIT_ONLY beyond it) and deletes (dirty sets: LM_NONE); unknown
    nodes give LM_DENY and clean ones LM_PROBE."""
    groups, users, tuples = _random_graph(seed)
    jman = JManager([JNamespace("g"), JNamespace("u")])
    tman = TManager([TNamespace("g"), TNamespace("u")])
    (jidx, jcols), (tidx, tcols) = _build(tuples, jman, tman)
    rng = random.Random(100 + seed)
    nrng = np.random.default_rng(seed)
    depths = (2, 3, 5, 16)
    modes = set()
    live = list(tuples)
    for round_ in range(4):
        if round_:
            writes = []
            for _ in range(rng.randint(1, 4)):
                g = rng.choice(groups)
                if rng.random() < 0.6:
                    writes.append(f"g:{g}#member@u_new{round_}_{rng.randint(0, 3)}")
                else:
                    writes.append(f"g:{g}#member@g:{rng.choice(groups)}#member")
            writes = [w for w in writes if w not in live]
            deletes = rng.sample(live, 1) if round_ == 3 else []
            changes = [(1, w) for w in writes] + [(-1, d) for d in deletes]
            live = [t for t in live if t not in deletes] + writes
            jch = [(op, JTuple.from_string(s)) for op, s in changes]
            tch = [(op, TTuple.from_string(s)) for op, s in changes]
            for op, t in jch:
                jcols.apply(op, t)
            for op, t in tch:
                tcols.apply(op, t)
            assert jidx.apply_changes(jch) == tidx.apply_changes(tch)
            users = users + sorted({w.split("@")[1] for w in writes
                                    if "#" not in w.split("@")[1]})
        _assert_same_index(jidx, tidx)
        for q in (_queries(jcols, nrng, 300),
                  _member_queries(jcols, groups, users)):
            want = _verdicts(jidx, jcols, q, depths)
            got = _verdicts(tidx, tcols, q, depths)
            assert len(got) == len(want)
            for a, b in zip(want, got):
                np.testing.assert_array_equal(a, b)
            for lm in want[4::3]:
                modes.update(int(m) for m in np.unique(lm))
        assert jidx.fallbacks == tidx.fallbacks
    assert {1, 3} <= modes, modes


def test_every_probe_mode_is_reached():
    """A graph where each mode appears at rest depth 2: a delta pair within
    the budget (LM_ALLOW), one beyond it (LM_HIT_ONLY), a clean node
    (LM_PROBE), a dirty one (LM_NONE) and an unknown one (LM_DENY)."""
    groups = ["A", "B", "C", "E", "F"]
    tuples = ["g:A#member@g:B#member", "g:B#member@g:C#member",
              "g:C#member@u0", "g:A#member@u1", "g:E#member@g:F#member",
              "g:F#member@u2", "g:E#member@u3"]
    jman = JManager([JNamespace("g"), JNamespace("u")])
    tman = TManager([TNamespace("g"), TNamespace("u")])
    (jidx, jcols), (tidx, tcols) = _build(tuples, jman, tman)
    changes = [(1, "g:C#member@u9"), (-1, "g:E#member@g:F#member")]
    for cols, idx, T in ((jcols, jidx, JTuple), (tcols, tidx, TTuple)):
        ch = [(op, T.from_string(s)) for op, s in changes]
        for op, t in ch:
            cols.apply(op, t)
        assert idx.apply_changes(ch)
    _assert_same_index(jidx, tidx)
    q = _member_queries(jcols, groups, ["u0", "u1", "u2", "u3", "u9"])
    for d in (2, 3, 4):
        want = _verdicts(jidx, jcols, q, (d,))
        got = _verdicts(tidx, tcols, q, (d,))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
    assert set(_verdicts(tidx, tcols, q, (2,))[4].tolist()) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("name", ["synth", "deep", "random-0"])
def test_ship_pairs_match_jax(name):
    tuples, jman, tman = _graph(name)
    (jidx, _), (tidx, _) = _build(tuples, jman, tman)
    jdev = jleodev.ship_pairs(jidx)
    tdev = tleodev.ship_pairs(tidx, "cpu")
    assert set(jdev) == set(tdev) == {"sets", "elts", "hops"}
    for k in jdev:
        a = np.asarray(jdev[k])
        b = tdev[k].numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tleodev.ship_pairs(tclosure.ClosureIndex(), "cpu") is None


def _pair_columns(rng, n):
    """Sorted unique (set, elt) pairs, padded to their bucket."""
    cap = tleodev._pair_bucket(n)
    keys = np.unique(rng.integers(0, 1 << 20, 4 * n) << 32
                     | rng.integers(0, 1 << 16, 4 * n))[:n]
    assert len(keys) == n
    sets = np.full(cap, tleodev._PAIR_PAD, np.int32)
    elts = np.full(cap, tleodev._PAIR_PAD, np.int32)
    sets[:n] = (keys >> 32).astype(np.int32)
    elts[:n] = (keys & 0x7FFFFFFF).astype(np.int32)
    hops = np.zeros(cap, np.int32)
    hops[:n] = rng.integers(0, 12, n)
    return keys, sets, elts, hops


@pytest.mark.parametrize("n", [1, 700, 1024, 2048, 3000])
def test_probe_plain_matches_jax(n):
    """Present pairs, absent pairs, must-miss -1 keys, and keys above the
    last pair: at n == 1024 and 2048 the pairs fill their bucket, so those
    drive the search's midpoint to the capacity (the clamped gather)."""
    rng = np.random.default_rng(n)
    keys, sets, elts, hops = _pair_columns(rng, n)
    present = keys[rng.integers(0, n, 400)]
    absent = rng.integers(0, 1 << 20, 400) << 32 | rng.integers(0, 1 << 16, 400)
    above = (keys[-1] >> 32) + 1 + rng.integers(0, 4, 100)
    qkeys = np.concatenate([present, absent, above << 32 | 3,
                            np.full(50, -1, np.int64), keys[-1:]])
    q_set, q_elt = tleodev.split_keys(qkeys, len(qkeys))
    jhit, jhop = jleodev.probe_in_program(
        jnp.asarray(sets), jnp.asarray(elts), jnp.asarray(hops),
        jnp.asarray(q_set), jnp.asarray(q_elt))
    thit, thop = tleodev._probe_plain(*map(torch.from_numpy, (sets, elts, hops,
                                                             q_set, q_elt)))
    assert thit.dtype == thop.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jhit), thit.numpy().astype(bool))
    np.testing.assert_array_equal(np.asarray(jhop), thop.numpy())
    # the wrapper takes the plain version for CPU tensors
    whit, whop = tleodev.probe(*map(torch.from_numpy, (sets, elts, hops,
                                                       q_set, q_elt)))
    assert torch.equal(whit, thit) and torch.equal(whop, thop)
    assert thit[:400].all() and not thit[800:900].any()
    if n == tleodev._pair_bucket(n):
        # the search's low bound passes the last slot for the keys above
        idx = tleodev.search(*map(torch.from_numpy, (sets, elts)),
                             torch.from_numpy(q_set[800:900]),
                             torch.from_numpy(q_elt[800:900]))
        assert (idx == len(sets) - 1).all()


def test_probe_pairs_match_jax():
    """The unfused path's batched probe returns what the JAX one returns,
    bool hits and int32 hops.  Below the JAX package's 2048-row minimum
    (where JAX leaves the batch to the host) the port still probes, and a
    short batch gets the long batch's rows."""
    tuples, jman, tman = _graph("deep")
    (jidx, jcols), (tidx, tcols) = _build(tuples, jman, tman)
    rng = np.random.default_rng(5)
    n = jleodev.DEVICE_PROBE_MIN + 37
    q = _queries(jcols, rng, n)
    nodes, _hi = tidx.node_ids_np(q[0], q[1], q[2])
    keys = np.where((nodes >= 0) & (q[3] >= 0),
                    nodes.astype(np.int64) << 32 | q[3].astype(np.int64), -1)
    keys[:200] = tidx.elt_packed[rng.integers(0, len(tidx.elt_packed), 200)]
    want = jleodev.probe_pairs(jleodev.ship_pairs(jidx), keys, 4096)
    got = tleodev.probe_pairs(tleodev.ship_pairs(tidx, "cpu"), keys, 4096)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0][:200].all()
    assert jleodev.probe_pairs(jleodev.ship_pairs(jidx), keys[:100], 256) is None
    short = tleodev.probe_pairs(tleodev.ship_pairs(tidx, "cpu"), keys[:100],
                                256)
    for a, b in zip(want, short):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a[:100], b)
    assert tleodev.probe_pairs(None, keys, 4096) is None


def test_closure_too_large_at_the_same_max_pairs():
    tuples, jman, tman = _graph("synth")
    (jidx, _), _ = _build(tuples, jman, tman)
    pairs = len(jidx.elt_packed)
    for cap in (pairs - 1, len(jidx.set_src) - 1):
        with pytest.raises(jclosure.ClosureTooLarge) as jerr:
            _build(tuples, jman, tman, max_pairs=cap)
        jidx2 = tclosure.ClosureIndex(max_pairs=cap)
        tcols = tdelta.TupleColumns.from_tuples(
            TVocab(), [TTuple.from_string(s) for s in tuples])
        with pytest.raises(tclosure.ClosureTooLarge) as terr:
            jidx2.build_from_cols(tcols, tman)
        assert str(terr.value) == str(jerr.value)
        assert jidx2.pairs == 0 and jidx2.n_nodes == 0
    (jidx, _), (tidx, _) = _build(tuples, jman, tman, max_pairs=pairs)
    _assert_same_index(jidx, tidx)

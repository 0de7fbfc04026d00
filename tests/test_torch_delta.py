"""Port parity: the delta overlay, the snapshot fold and K2's overlay
branches against the JAX package, at tolerance 0.

* ``delta.apply_changes`` + ``overlay_arrays``: the overlay state and every
  ``om_`` / ``ovt_`` / ``ov_dirty`` / ``ov_nbase`` array byte for byte, and
  ``OverlayRejected`` on the same inputs, over seeded write storms (new
  subjects and objects, deletes, net-zero churn, subject-set edges, an
  unknown namespace, a new relation-level edge pair);
* ``delta.fold_snapshot_cols``: every array of the folded snapshot, or
  ``FoldRejected`` on both sides, over the storms of
  ``tests/test_projection.py``;
* the plain ``_node_lookup`` / ``_member`` / ``_node_dirty`` /
  ``expand_phase`` of the port (the plain versions the CUDA kernels are
  held against on the card) over tables with a non-empty overlay, level by
  level; then the tier-1 verdict byte (its dirty bit 2) and the general
  tier's code (its dirty bit 3) of whole batches.

The JAX side compiles three programs here (``expand_phase`` at two arenas
with ``_pack_scatter``, one ``run_fast_packed`` shape and one
``run_general_packed`` shape, ``tests/test_torch_algebra.py``'s rewrites
shape); everything else runs eagerly.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.engine import algebra as jalg
from ketotpu.engine import delta as jdl
from ketotpu.engine import fastpath as jfp
from ketotpu.engine.vocab import Vocab as JVocab
from ketotpu.utils import synth as jsynth
from ketotpu_torch.api.types import RelationTuple as TTuple
from ketotpu_torch.engine import algebra as talg
from ketotpu_torch.engine import delta as tdl
from ketotpu_torch.engine import fastpath as tfp
from ketotpu_torch.engine.device import upload
from ketotpu_torch.engine.vocab import Vocab as TVocab
from ketotpu_torch.utils import synth as tsynth
from torch_parity import release_jax_caches  # noqa: F401 - autouse fixture

torch.set_num_threads(1)

MAX_WIDTH = 100
GRAPH = dict(n_users=40, n_groups=6, n_folders=12, n_docs=60)
#: the snapshot fields the fold must reproduce (tests/test_projection.py)
CMP = (
    "node_hi", "node_lo", "row_ptr", "edge_ns", "edge_obj", "edge_rel",
    "edge_node", "mem_node", "mem_subj", "mem_row_ptr", "mem_ord_subj",
)


def _np(x):
    return np.asarray(x)


class Side:
    """One package's copy of the same graph: its column cache and the base
    snapshot built from it."""

    def __init__(self, synth, dl, vocab, parse_tuple, tuples):
        self.dl = dl
        self.parse = parse_tuple
        g = synth.build_synth(**GRAPH)
        self.manager = g.manager
        self.cols = dl.TupleColumns(vocab())
        for t in tuples:
            self.cols.apply(1, parse_tuple(t))
        self.snap = dl.build_snapshot_cols(self.cols, g.manager, version=0)
        self.state = dl.OverlayState()

    def apply(self, changes):
        """Apply ``changes`` (op, tuple string) to the columns, then to the
        overlay; returns the overlay arrays or the exception type."""
        ts = [(op, self.parse(s)) for op, s in changes]
        for op, t in ts:
            self.cols.apply(op, t)
        try:
            self.dl.apply_changes(self.state, self.snap, self.cols.vocab, ts)
            return self.dl.overlay_arrays(self.state, self.snap, pair_cap=64)
        except self.dl.OverlayRejected:
            return "rejected"


def _tuples():
    return [str(t) for t in jsynth.build_synth(**GRAPH).store.all_tuples()]


def _sides():
    tuples = _tuples()
    j = Side(jsynth, jdl, JVocab, JTuple.from_string, tuples)
    t = Side(tsynth, tdl, TVocab, TTuple.from_string, tuples)
    return j, t, tuples


def _storm(seed: int, tuples, *, n: int, reject: bool):
    """Seeded write storm over the synth graph: (op, tuple string) pairs,
    the shapes of tests/test_projection.py's storms plus nested groups and
    (with ``reject``) the writes the overlay cannot represent."""
    rnd = random.Random(seed)
    live = list(tuples)
    users = [f"u{seed}x{i}" for i in range(6)] + [f"u{i}" for i in range(10)]
    docs = sorted({t.split(":", 1)[1].split("#", 1)[0]
                   for t in tuples if t.startswith("Doc:")})
    groups = [f"g{i}" for i in range(GRAPH["n_groups"])]
    sets = [t for t in tuples if "#" in t.split("@", 1)[1]]
    objs = {}
    for t in tuples:
        ns, rest = t.split(":", 1)
        objs.setdefault(ns, set()).add(rest.split("#", 1)[0])
    objs = {k: sorted(v) for k, v in objs.items()}
    out = []
    for _ in range(n):
        r = rnd.random()
        if r < 0.3 and live:
            t = rnd.choice(live)
            out.append((-1, t))
            if rnd.random() < 0.3:
                out.append((-1, t))  # a second delete of the same tuple
            else:
                live.remove(t)
        elif r < 0.55:
            doc = rnd.choice(docs) if rnd.random() < 0.8 else f"new{seed}d{rnd.randrange(4)}"
            t = f"Doc:{doc}#{rnd.choice(['viewers', 'owners'])}@{rnd.choice(users)}"
            out.append((1, t))
            live.append(t)
            if rnd.random() < 0.3:  # net-zero churn
                out += [(-1, t), (1, t)]
        elif r < 0.7:
            t = f"Group:{rnd.choice(groups)}#members@{rnd.choice(users)}"
            out.append((1 if rnd.random() < 0.7 else -1, t))
        elif r < 0.85:
            # a subject-set edge of a class the base holds, on another
            # object of its namespace: a dirty row
            head, subj = rnd.choice(sets).split("@", 1)
            ns, rest = head.split(":", 1)
            rel = rest.split("#", 1)[1]
            t = f"{ns}:{rnd.choice(objs[ns])}#{rel}@{subj}"
            out.append((1 if rnd.random() < 0.6 else -1, t))
        elif reject and r < 0.9:
            out.append((1, rnd.choice([
                "brandnewns:obj#rel@someone",  # past the base table dims
                "Doc:d0#viewers@Folder:f0#viewers",  # a new edge class
            ])))
        elif live:
            # every tuple of one (namespace, object, relation): node removal
            t0 = rnd.choice(live)
            key = t0.split("@", 1)[0]
            for t in [t for t in live if t.split("@", 1)[0] == key]:
                out.append((-1, t))
                live.remove(t)
    return out


def _assert_arrays(got: dict, want: dict, what):
    assert got.keys() == want.keys(), what
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        assert np.array_equal(a, b), (what, k)


@pytest.mark.parametrize("seed", range(8))
def test_overlay_matches_jax_byte_for_byte(seed):
    """Three slices of one storm, each applied to both overlays: the same
    state and arrays after each, or the same rejection."""
    j, t, tuples = _sides()
    storm = _storm(seed, tuples, n=36, reject=seed % 4 == 3)
    for lo in range(0, len(storm), 12):
        part = storm[lo:lo + 12]
        jw, tw = j.apply(part), t.apply(part)
        if isinstance(jw, str) or isinstance(tw, str):
            assert jw == tw == "rejected", (seed, lo)
            break
        _assert_arrays(tw, jw, (seed, lo))
        assert t.state.pair_net == j.state.pair_net
        assert t.state.new_nodes == j.state.new_nodes
        assert t.state.dirty_nodes == j.state.dirty_nodes


def test_overlay_storms_reach_every_branch():
    """The storms above are not vacuous: most slices apply, and they create
    virtual nodes, added and deleted pairs, dirty rows and rejections (a
    delete of a subject the vocabulary never saw, an unknown namespace, a
    new edge class)."""
    seen = set()
    applied = 0
    for seed in range(8):
        _j, t, tuples = _sides()
        storm = _storm(seed, tuples, n=36, reject=seed % 4 == 3)
        for lo in range(0, len(storm), 12):
            out = t.apply(storm[lo:lo + 12])
            if isinstance(out, str):
                seen.add("rejected")
                break
            applied += 1
            codes = set(out["om_val"][out["om_key_a"] >= 0].tolist())
            seen |= {("om", c) for c in codes}
            if t.state.new_nodes:
                seen.add("virtual")
            if out["ov_dirty"].any():
                seen.add("dirty")
    assert seen >= {("om", tdl.OV_ADDED), ("om", tdl.OV_DELETED), "virtual",
                    "dirty", "rejected"}, seen
    assert applied >= 10, applied


def test_base_lookups_match_jax():
    """``_base_node_id`` and ``_base_pair_count`` search where the JAX
    functions walk: the same answers over every base node, every base
    membership row and misses on both sides of them."""
    j, t, _ = _sides()
    snap = t.snap
    assert j.snap.n_nodes == snap.n_nodes
    rng = np.random.default_rng(5)
    nodes = [(int(h), int(lo)) for h, lo in zip(snap.node_hi[:snap.n_nodes],
                                                  snap.node_lo[:snap.n_nodes])]
    nodes += [(h, lo + d) for h, lo in nodes[::7] for d in (-1, 1)]
    nodes += [(int(rng.integers(-2, 40)), int(rng.integers(-2, 400)))
              for _ in range(200)]
    for h, lo in nodes:
        assert tdl._base_node_id(snap, h, lo) == jdl._base_node_id(j.snap, h, lo)
    rows = rng.integers(0, snap.n_tuples, 300)
    pairs = [(int(snap.mem_node[i]), int(snap.mem_subj[i])) for i in rows]
    pairs += [(n, s + 1) for n, s in pairs[:100]] + [
        (int(rng.integers(-1, snap.n_nodes + 3)), int(rng.integers(0, 300)))
        for _ in range(200)]
    for n, s in pairs:
        assert tdl._base_pair_count(snap, n, s) == jdl._base_pair_count(
            j.snap, n, s)


def _cols_side(dl, vocab, parse, tuples, bulk):
    cols = dl.TupleColumns(vocab())
    for t in tuples:
        cols.apply(1, parse(t))
    if bulk:  # a columnar store's adoption: the row-key index stays lazy
        cols = dl.TupleColumns.from_arrays(
            cols.vocab, {c: getattr(cols, c)[:cols.n] for c in cols.COLS},
            cols.alive[:cols.n])
    return cols


@pytest.mark.parametrize("bulk", [False, True], ids=["eager", "bulk"])
@pytest.mark.parametrize("seed", range(2))
def test_row_key_index_matches_jax(seed, bulk):
    """The mirror's row-key index sorts where the JAX one builds a dict:
    after every add (duplicates too), delete (repeated, unknown) and
    compaction both mirrors hold the same rows, columns and alive bits."""
    tuples = _tuples()
    sides = [_cols_side(jdl, JVocab, JTuple.from_string, tuples, bulk),
             _cols_side(tdl, TVocab, TTuple.from_string, tuples, bulk)]
    parses = (JTuple.from_string, TTuple.from_string)
    rnd = random.Random(seed)
    live = list(tuples)

    def step(op, t):
        for cols, parse in zip(sides, parses):
            cols.apply(op, parse(t))
        jc, tc = sides
        assert (jc.n, jc.alive_count) == (tc.n, tc.alive_count)
        assert np.array_equal(jc.alive[:jc.n], tc.alive[:tc.n])
        for c in tdl.TupleColumns.COLS:
            assert np.array_equal(getattr(jc, c)[:jc.n], getattr(tc, c)[:tc.n])

    def churn(n):
        for _ in range(n):
            r = rnd.random()
            if r < 0.35 and live:
                t = rnd.choice(live)
                step(-1, t)
                if rnd.random() < 0.2:
                    step(-1, t)  # a delete of a tuple already gone
                else:
                    live.remove(t)
            elif r < 0.55 and live:
                t = rnd.choice(live)  # a duplicate row of a live tuple
                step(1, t)
                live.append(t)
            elif r < 0.9:
                t = f"Doc:k{rnd.randrange(30)}#viewers@ku{rnd.randrange(30)}"
                step(1, t)
                live.append(t)
            else:
                step(-1, f"Doc:k{rnd.randrange(30)}#owners@nobody{seed}")

    churn(300)
    rnd.shuffle(live)
    for t in live[: len(live) * 3 // 5]:
        step(-1, t)
    del live[: len(live) * 3 // 5]
    n0 = sides[1].n
    for cols in sides:
        cols.compact()
    assert sides[1].n < n0  # the compaction ran
    step(1, "Doc:k0#viewers@ku0")
    live.append("Doc:k0#viewers@ku0")
    churn(200)


def test_empty_overlay_tables_match_jax():
    """What the engine ships with every projection before the first write:
    the fixed-shape empty tables at the served pair cap."""
    j, t, _ = _sides()
    want = jdl.overlay_arrays(jdl.OverlayState(), j.snap, pair_cap=4096)
    got = tdl.overlay_arrays(tdl.OverlayState(), t.snap, pair_cap=4096)
    _assert_arrays(got, want, "empty")
    assert got["om_key_a"].shape == (4096,) and got["om_ptr"].shape == (16385,)
    assert got["om_pw"].shape == (tdl.OVERLAY_PROBE,)


def test_overlay_size_limit_raises_like_jax():
    """More pairs than the fixed-shape table holds: both raise ValueError
    (the engine then folds or re-projects)."""
    j, t, tuples = _sides()
    users = [f"v{i}" for i in range(40)]
    part = [(1, f"Doc:d{i % 60}#viewers@{u}") for i, u in enumerate(users)]
    for side in (j, t):
        ts = [(op, side.parse(s)) for op, s in part]
        for op, x in ts:
            side.cols.apply(op, x)
        side.dl.apply_changes(side.state, side.snap, side.cols.vocab, ts)
    with pytest.raises(ValueError):
        jdl.overlay_arrays(j.state, j.snap, pair_cap=8)
    with pytest.raises(ValueError):
        tdl.overlay_arrays(t.state, t.snap, pair_cap=8)


# -- the fold ------------------------------------------------------------------


FOLD_SEEDS = range(100, 108)


def _fold_both(seed):
    """One storm folded into each side's base: (JAX snapshot, port
    snapshot, port side); a snapshot is None where the fold rejected."""
    j, t, tuples = _sides()
    storm = _storm(seed, tuples, n=40, reject=seed % 4 == 1)
    folded = []
    for side in (j, t):
        ts = [(op, side.parse(s)) for op, s in storm]
        for op, x in ts:
            side.cols.apply(op, x)
        try:
            folded.append(side.dl.fold_snapshot_cols(
                side.snap, side.cols.vocab, ts, version=1))
        except side.dl.FoldRejected:
            folded.append(None)
    return (*folded, t)


def test_fold_storms_fold():
    """Enough of the storms fold (the rest cross a padded shape or add an
    edge class) for the parity below to mean something."""
    ok = sum(_fold_both(seed)[1] is not None for seed in FOLD_SEEDS)
    assert 3 <= ok < len(FOLD_SEEDS), ok


@pytest.mark.parametrize("seed", FOLD_SEEDS)
def test_fold_matches_jax(seed):
    """Every array of the folded snapshot equal, or FoldRejected on both
    sides; the fold's result also equals a from-scratch build where the
    fold accepts."""
    jf, tf, t = _fold_both(seed)
    assert (jf is None) == (tf is None), seed
    if tf is None:
        return
    for f in CMP + ("sub_ns", "sub_obj", "sub_rel"):
        assert np.array_equal(getattr(tf, f), getattr(jf, f)), (seed, f)
    assert (tf.n_nodes, tf.n_edges, tf.n_tuples) == (
        jf.n_nodes, jf.n_edges, jf.n_tuples)
    _assert_arrays(tf.check_arrays(), jf.check_arrays(), seed)
    scratch = tdl.build_snapshot_cols(t.cols, t.manager, version=1)
    for f in CMP:
        assert np.array_equal(getattr(tf, f), getattr(scratch, f)), (seed, f)


def test_fold_rejects_what_jax_rejects():
    """A new relation-level edge class, on both sides."""
    j, t, _ = _sides()
    for side in (j, t):
        x = side.parse("Doc:d0#viewers@Folder:f0")
        side.cols.apply(1, x)
        with pytest.raises(side.dl.FoldRejected):
            side.dl.fold_snapshot_cols(side.snap, side.cols.vocab, [(1, x)],
                                       version=1)


# -- K2's overlay branches, plain form -------------------------------------------


def _writes(tuples):
    """New nodes, added and deleted pairs, and subject-set edges written
    and deleted (dirty rows, one of them on a new node)."""
    nested = next(t for t in tuples if t.startswith("Group:")
                  and "#members@Group:" in t)
    folder_set = next(t for t in tuples if t.startswith("Folder:")
                      and "#viewers@Group:" in t)
    doc_parent = next(t for t in tuples if t.startswith("Doc:d5#parents@"))
    return [
        (1, "Doc:fresh0#viewers@u1"),  # a new node: virtual id through ovt_
        (1, "Doc:fresh0#owners@u2"),
        (1, "Doc:fresh0#parents@Folder:f1"),  # a dirty virtual node
        (1, "Group:g1#members@u7x"),  # an added pair (a new subject)
        (-1, "Group:g0#members@u0"),  # a deleted pair
        (1, "Group:g2#members@Group:g3#members"),  # nested groups: dirty
        (-1, nested),
        (-1, folder_set),
        (1, "Folder:f7#viewers@Group:g4#members"),
        (-1, doc_parent),
    ]


@pytest.fixture(scope="module")
def overlay():
    """Both sides after ``_writes``: the sides, the JAX tables and the
    port's tables (base + overlay)."""
    j, t, tuples = _sides()
    writes = _writes(tuples)
    jw, tw = j.apply(writes), t.apply(writes)
    assert not isinstance(jw, str)
    _assert_arrays(tw, jw, "writes")
    assert t.state.new_nodes and t.state.dirty_nodes
    jg = jax.device_put({**j.snap.check_arrays(), **jw})
    tg = upload({**t.snap.check_arrays(), **tw}, "cpu")
    return j, t, jg, tg


def _probe_columns(j, rng, n):
    """ns, obj, rel columns: every base node, the virtual ones, and random
    (often unknown) triples."""
    snap = j.snap
    R = snap.num_rels
    hi = np.concatenate([snap.node_hi[:snap.n_nodes],
                         np.array([k[0] for k in j.state.new_nodes], np.int64)])
    lo = np.concatenate([snap.node_lo[:snap.n_nodes],
                         np.array([k[1] for k in j.state.new_nodes], np.int64)])
    pick = rng.integers(0, len(hi), n)
    ns, rel, obj = (hi[pick] // R), (hi[pick] % R), lo[pick]
    noise = rng.random(n) < 0.2
    obj = np.where(noise, rng.integers(-1, len(j.cols.vocab.objects) + 5, n), obj)
    return ns.astype(np.int32), obj.astype(np.int32), rel.astype(np.int32)


def test_node_lookup_member_and_dirty_match_jax(overlay):
    j, t, jg, tg = overlay
    rng = np.random.default_rng(0)
    ns, obj, rel = _probe_columns(j, rng, 4096)
    jn = _np(jfp._node_lookup(jg, jnp.asarray(ns), jnp.asarray(obj),
                              jnp.asarray(rel)))
    tn = tfp._node_lookup(tg, *map(torch.from_numpy, (ns, obj, rel))).numpy()
    assert np.array_equal(tn, jn)
    assert (tn >= j.snap.n_nodes).any()  # virtual ids resolved
    # membership: every overlay pair, base pairs, random pairs
    keys = np.array(list(j.state.pair_net), np.int64).reshape(-1, 2)
    base = rng.integers(0, j.snap.n_tuples, 2048)
    node = np.concatenate([keys[:, 0], j.snap.mem_node[base],
                           rng.integers(-1, j.snap.n_nodes + 4, 512)])
    subj = np.concatenate([keys[:, 1], j.snap.mem_subj[base],
                           rng.integers(-1, 200, 512)])
    node, subj = node.astype(np.int32), subj.astype(np.int32)
    jm = _np(jfp._member(jg, jnp.asarray(node), jnp.asarray(subj)))
    tm = tfp._member(tg, torch.from_numpy(node), torch.from_numpy(subj)).numpy()
    assert np.array_equal(tm, jm)
    assert jm[:len(keys)].any() and not jm[:len(keys)].all()
    probe = np.concatenate([np.array(sorted(j.state.dirty_nodes)), node,
                            [-5, 10**6]]).astype(np.int32)
    jd = _np(jfp._node_dirty(jg, jnp.asarray(probe)))
    td = tfp._node_dirty(tg, torch.from_numpy(probe)).numpy()
    assert np.array_equal(td, jd) and td.any()


def _frontier_dict(s):
    return {c: s[f"f_{n}"] for c, n in zip(tfp.ITEM_COLS, (
        "qid", "ns", "obj", "rel", "depth", "skip", "force"))}


def _assert_items(t, j):
    for c in tfp.ITEM_COLS:
        want = _np(j[c])
        got = getattr(t, c).numpy()
        assert np.array_equal(got.astype(want.dtype), want), c


def _queries(n, seed, general=False):
    """Checks on the written nodes and their neighbours: the dirty rows'
    own relations and the view permissions that expand through them; with
    ``general``, Doc#edit rows (AND/NOT) only."""
    rnd = random.Random(seed)
    objs = ["fresh0", "d5", "d7"] + [f"d{i}" for i in range(20)]
    if not general:
        objs += ["g0", "g1", "g2", "g3"] + [f"f{i}" for i in range(6)]
    users = [f"u{i}" for i in range(40)] + ["u7x"]
    out = []
    for _ in range(n):
        o = rnd.choice(objs)
        ns = {"f": "Folder", "g": "Group"}.get(o[0], "Doc")
        rel = ("edit" if general else
               "members" if ns == "Group" else
               rnd.choice(("view", "viewers", "owners")))
        out.append(f"{ns}:{o}#{rel}@{rnd.choice(users)}")
    return out


def _qpack(side, queries, q, depth=5):
    v = side.cols.vocab
    rows = np.zeros((6, q), np.int32)
    n = len(queries)
    rows[:4, n:] = -1
    rows[4, n:] = 1
    ts = [side.parse(s) for s in queries]
    rows[0, :n] = [v.namespaces.lookup(t.namespace) for t in ts]
    rows[1, :n] = [v.objects.lookup(t.object) for t in ts]
    rows[2, :n] = [v.relations.lookup(t.relation) for t in ts]
    rows[3, :n] = [v.subject_key(t.subject) for t in ts]
    rows[4, :n] = depth
    rows[5, :n] = 1
    return rows


def test_expand_phase_levels_match_jax(overlay):
    """Level by level: children, found, over and dirty bits."""
    j, t, jg, tg = overlay
    queries = _queries(200, 1)
    q, frontier, arena, levels = 256, 512, 1024, 5
    qpack = _qpack(j, queries, q)
    assert np.array_equal(qpack, _qpack(t, queries, q))
    ns_dim, rel_dim = j.snap.flat.direct_ok.shape
    nsb, relb = jfp._pack_bits(ns_dim), jfp._pack_bits(rel_dim)
    expand = jax.jit(jfp.expand_phase,
                     static_argnames=("arena", "max_width", "probe_only"))
    pack = jax.jit(jfp._pack_scatter, static_argnames=("frontier", "nsb", "relb"))
    js = dict(jfp.init_state(*qpack[:5], qpack[5].astype(bool),
                             frontier=frontier))
    js["f_depth"] = jnp.minimum(js["f_depth"], levels)
    occ = torch.zeros(1, dtype=torch.int32)
    f, qf, qo, qs = tfp.init_state(torch.from_numpy(qpack), frontier=frontier,
                                   levels=levels, occ_out=occ)
    qd = torch.zeros_like(qo)
    for lvl in range(levels):
        last = lvl == levels - 1
        a = 8 if last else arena
        jch, jqf, jqo, jqd = expand(jg, js, arena=a, max_width=MAX_WIDTH,
                                    probe_only=last)
        ch, qf, qo, qd = tfp.expand_phase(tg, f, qf, qo, qd, qs, arena=a,
                                          max_width=MAX_WIDTH, probe_only=last)
        _assert_items(ch, jch)
        for got, want in ((qf, jqf), (qo, jqo), (qd, jqd)):
            assert np.array_equal(got.numpy().astype(bool), _np(want))
        if last:
            break
        jnxt, jqo = pack(jch, jqf, jqo, frontier=frontier, nsb=nsb, relb=relb)
        f, qo = tfp.pack_phase(ch, qf, qo, frontier=frontier, ns_dim=ns_dim,
                               rel_dim=rel_dim)
        _assert_items(f, _frontier_dict(jnxt))
        js = dict(jnxt, q_found=jqf, q_over=jqo, q_dirty=jqd,
                  q_subj=js["q_subj"])
    assert qd.any() and qf.any()


def test_tier1_verdict_byte_matches_jax(overlay):
    """The packed batch's verdict bytes (bit 2 dirty) and occupancy."""
    j, t, jg, tg = overlay
    queries = _queries(240, 2)
    qpack = _qpack(j, queries, 256)
    kw = dict(frontier=512, arena=2048, max_depth=5, max_width=MAX_WIDTH)
    jcodes, jocc = jfp.run_fast_packed(jg, qpack, **kw)
    codes, occ = tfp.run_fast_packed(tg, qpack, **kw).fetch()
    assert np.array_equal(codes, _np(jcodes))
    assert np.array_equal(occ, _np(jocc))
    assert (codes & 4).any() and (codes & 1).any()


def test_general_code_bit3_matches_jax(overlay):
    """AND/NOT rows (Doc#edit = !banned && view) over the written rows: the
    whole general program's codes, its dirty bit 3 among them, at
    tests/test_torch_algebra.py's rewrites shape."""
    j, t, jg, tg = overlay
    queries = _queries(60, 3, general=True)
    qpack = _qpack(j, queries, 64)
    kw = dict(sizes=(192, 256, 256, 128), fast_b=128,
              fast_sched=tfp.level_schedule(128, 256, 512, 5),
              max_width=MAX_WIDTH, vcap=64)
    jcodes, jocc = jalg.run_general_packed(jg, qpack, **kw)
    codes, occ = talg.run_general_packed_plain(tg, qpack, **kw).fetch()
    assert np.array_equal(codes, _np(jcodes))
    assert np.array_equal(occ, _np(jocc))
    assert (codes & 8).any() and ((codes & 3) == 1).any()

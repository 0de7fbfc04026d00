"""Column cache and the vectorized snapshot build.

The port's copy of the column half of the JAX package's ``engine/delta.py``:

* **TupleColumns** — the store's tuples as append-only numpy id columns,
  maintained O(1) per write from the store's change log
  (`storage/memory.py:changes_since`).  A full rebuild becomes pure
  vectorized numpy (lexsort/unique/searchsorted) over these columns —
  no re-interning, no per-tuple loops.
* **build_snapshot_cols** — that rebuild, producing arrays identical to
  `snapshot.build_snapshot`.

The logic is unchanged, so both packages project byte-identical tables.
The O(delta) write overlay (``OverlayState``, ``overlay_arrays``) is not
ported yet: the port re-projects after a write.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ketotpu_torch.api.types import RelationTuple, SubjectSet
from ketotpu_torch.engine import hashtab, parallel
from ketotpu_torch.engine.snapshot import Snapshot, _bucket
from ketotpu_torch.engine.vocab import Vocab


class TupleColumns:
    """Append-only id columns over the live tuple set (amortized growth)."""

    COLS = ("ns", "obj", "rel", "subj", "is_set", "s_ns", "s_obj", "s_rel")

    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.cap = 1024
        self.n = 0
        self.alive_count = 0
        for c in self.COLS:
            setattr(self, c, np.full(self.cap, -1, np.int32))
        self.alive = np.zeros(self.cap, bool)
        # tuple identity (vocab id 4-tuple) -> alive row indices (FIFO
        # delete order parity with the store's seq-ordered removal).
        # None = lazy: bulk-adopted columns skip the per-row dict build
        # (the 10M-tuple cliff) and pay it on the first delete instead.
        self._rows_by_key: Optional[Dict[Tuple, List[int]]] = {}

    @classmethod
    def from_arrays(
        cls, vocab: Vocab, cols: Dict[str, np.ndarray], alive: np.ndarray
    ) -> "TupleColumns":
        """Adopt pre-built id columns (a columnar store's base segment)
        without any per-row Python — the row-key index is lazy."""
        self = cls.__new__(cls)
        self.vocab = vocab
        n = int(len(alive))
        cap = 1024
        while cap < max(n, 1):
            cap *= 2
        self.cap = cap
        self.n = n
        for c in cls.COLS:
            arr = np.full(cap, -1, np.int32)
            arr[:n] = cols[c][:n]
            setattr(self, c, arr)
        self.alive = np.zeros(cap, bool)
        self.alive[:n] = alive[:n]
        self.alive_count = int(self.alive[:n].sum())
        self._rows_by_key = None
        return self

    @classmethod
    def from_tuples(cls, vocab: Vocab, tuples) -> "TupleColumns":
        """Bulk adoption of a plain tuple list (a store rescan, a
        replica's adopted scan): capacity is sized once up front instead
        of paying log2(n) grow-copies of all 8 columns, and the row-key
        index stays lazy like :meth:`from_arrays` — the first delete
        pays for the dict, a bootstrap doesn't."""
        self = cls(vocab)
        n = len(tuples)
        cap = self.cap
        while cap < max(n, 1):
            cap *= 2
        if cap != self.cap:
            self.cap = cap
            for c in cls.COLS:
                setattr(self, c, np.full(cap, -1, np.int32))
            self.alive = np.zeros(cap, bool)
        self._rows_by_key = None
        v = vocab
        ns_c, obj_c, rel_c, subj_c = self.ns, self.obj, self.rel, self.subj
        is_set_c = self.is_set
        sns_c, sobj_c, srel_c = self.s_ns, self.s_obj, self.s_rel
        for i, t in enumerate(tuples):
            v.intern_tuple(t)
            ns_c[i] = v.namespaces.lookup(t.namespace)
            obj_c[i] = v.objects.lookup(t.object)
            rel_c[i] = v.relations.lookup(t.relation)
            subj_c[i] = v.subjects.lookup(t.subject.unique_id())
            if isinstance(t.subject, SubjectSet):
                is_set_c[i] = 1
                sns_c[i] = v.namespaces.lookup(t.subject.namespace)
                sobj_c[i] = v.objects.lookup(t.subject.object)
                srel_c[i] = v.relations.lookup(t.subject.relation)
            else:
                is_set_c[i] = 0
        self.alive[:n] = True
        self.n = n
        self.alive_count = n
        return self

    def masked(self, keep_rows: np.ndarray) -> "TupleColumns":
        """Shallow view with ``alive`` further restricted to ``keep_rows``
        (bool[n]) — shard partitioning without copying the columns."""
        out = TupleColumns.__new__(TupleColumns)
        out.vocab = self.vocab
        out.cap = self.cap
        out.n = self.n
        for c in self.COLS:
            setattr(out, c, getattr(self, c))
        out.alive = self.alive.copy()
        out.alive[: self.n] &= keep_rows[: self.n]
        out.alive_count = int(out.alive[: self.n].sum())
        out._rows_by_key = None
        return out

    def freeze(self) -> "TupleColumns":
        """Stable view for an off-thread snapshot build while the original
        keeps absorbing writes.  Appends only touch rows >= the frozen
        ``n`` (growth reallocates, never mutates the prefix) and deletes
        only flip the (copied) alive bitmap, so the id-column prefix this
        view reads is immutable — EXCEPT under ``compact()``, which the
        engine only runs on the blocking rebuild path after invalidating
        the in-flight build's generation token.  The clone must never be
        written."""
        out = TupleColumns.__new__(TupleColumns)
        out.vocab = self.vocab
        out.cap = self.cap
        out.n = self.n
        for c in self.COLS:
            setattr(out, c, getattr(self, c))
        out.alive = self.alive[: self.n].copy()
        out.alive_count = int(out.alive.sum())
        out._rows_by_key = None
        return out

    def _key_ids(self, t: RelationTuple) -> Optional[Tuple]:
        """Identity of a tuple in vocab-id space; None when any part is
        unknown to the vocab (such a tuple cannot be in the columns)."""
        v = self.vocab
        ids = (
            v.namespaces.lookup(t.namespace),
            v.objects.lookup(t.object),
            v.relations.lookup(t.relation),
            v.subjects.lookup(t.subject.unique_id()),
        )
        return None if -1 in ids else ids

    def _ensure_key_index(self) -> None:
        if self._rows_by_key is not None:
            return
        idx: Dict[Tuple, List[int]] = {}
        live = np.flatnonzero(self.alive[: self.n])
        keys = zip(
            self.ns[live].tolist(), self.obj[live].tolist(),
            self.rel[live].tolist(), self.subj[live].tolist(),
        )
        for i, key in zip(live.tolist(), keys):
            idx.setdefault(key, []).append(i)
        self._rows_by_key = idx

    def _grow(self) -> None:
        new_cap = self.cap * 2
        for c in self.COLS:
            arr = getattr(self, c)
            grown = np.full(new_cap, -1, np.int32)
            grown[: self.n] = arr[: self.n]
            setattr(self, c, grown)
        grown_alive = np.zeros(new_cap, bool)
        grown_alive[: self.n] = self.alive[: self.n]
        self.alive = grown_alive
        self.cap = new_cap

    def apply(self, op: int, t: RelationTuple) -> None:
        if op > 0:
            self.vocab.intern_tuple(t)
            if self.n == self.cap:
                self._grow()
            i = self.n
            v = self.vocab
            self.ns[i] = v.namespaces.lookup(t.namespace)
            self.obj[i] = v.objects.lookup(t.object)
            self.rel[i] = v.relations.lookup(t.relation)
            self.subj[i] = v.subjects.lookup(t.subject.unique_id())
            if isinstance(t.subject, SubjectSet):
                self.is_set[i] = 1
                self.s_ns[i] = v.namespaces.lookup(t.subject.namespace)
                self.s_obj[i] = v.objects.lookup(t.subject.object)
                self.s_rel[i] = v.relations.lookup(t.subject.relation)
            else:
                self.is_set[i] = 0
            self.alive[i] = True
            self.n += 1
            self.alive_count += 1
            if self._rows_by_key is not None:
                key = (int(self.ns[i]), int(self.obj[i]),
                       int(self.rel[i]), int(self.subj[i]))
                self._rows_by_key.setdefault(key, []).append(i)
        else:
            key = self._key_ids(t)
            if key is None:
                return
            self._ensure_key_index()
            rows = self._rows_by_key.get(key)
            if rows:
                i = rows.pop(0)
                if not rows:
                    del self._rows_by_key[key]
                if self.alive[i]:
                    self.alive[i] = False
                    self.alive_count -= 1

    def compact(self) -> None:
        """Drop dead rows (preserving order) when they dominate."""
        if self.n - self.alive_count <= self.n // 2:
            return
        keep = np.flatnonzero(self.alive[: self.n])
        for c in self.COLS:
            arr = getattr(self, c)
            arr[: len(keep)] = arr[keep]
            arr[len(keep):] = -1
        self.alive[: len(keep)] = True
        self.alive[len(keep):] = False
        self.n = len(keep)
        if self._rows_by_key is not None:
            remap = {int(old): new for new, old in enumerate(keep)}
            for key, rows in self._rows_by_key.items():
                self._rows_by_key[key] = [
                    remap[r] for r in rows if r in remap
                ]


#: per-phase wall-time keys ``build_snapshot_cols`` reports (the bench and
#: ``keto_projection_phase_seconds`` carry the same vocabulary)
BUILD_PHASES = ("columns", "sort_unique", "csr_pack", "hashtab", "optable")


def build_snapshot_cols(
    cols: TupleColumns,
    manager,
    *,
    strict: bool = False,
    version: int = -1,
    phases: Optional[Dict[str, float]] = None,
) -> Snapshot:
    """Vectorized snapshot build from the column cache.

    Produces arrays identical to `snapshot.build_snapshot` (same node
    ordering, same insertion-order CSR, same membership sort) without
    per-tuple Python loops — rebuild cost is a few numpy passes, sharded
    across the build pool on multi-core hosts (engine/parallel.py).

    ``phases`` (optional dict) accumulates per-phase wall seconds under
    the BUILD_PHASES keys, so a projection_build_s regression is
    attributable to a specific stage.
    """
    import time

    from ketotpu_torch.engine.optable import compile_flat_tables, compile_op_table
    from ketotpu_torch.engine.snapshot import _compute_taint

    ph = phases if phases is not None else {}

    def _mark(key, t0):
        t1 = time.perf_counter()
        ph[key] = ph.get(key, 0.0) + (t1 - t0)
        return t1

    t0 = time.perf_counter()
    vocab = cols.vocab
    op = compile_op_table(manager, vocab, strict=strict)
    num_rels = op.prog_root.shape[1]
    num_ns = op.prog_root.shape[0]
    t0 = _mark("optable", t0)

    # -- columns: live views of the id columns ------------------------------
    # all-alive (the cold build after compaction) takes zero-copy slices;
    # otherwise one gather per column.  The subject-set decode columns are
    # NEVER gathered at full width — later stages index them through the
    # (much smaller) set-row selection instead.
    n_all = cols.n
    if cols.alive_count == n_all:
        live = None
        ns = cols.ns[:n_all]
        obj = cols.obj[:n_all]
        rel = cols.rel[:n_all]
        subj = cols.subj[:n_all]
        is_set = cols.is_set[:n_all]
    else:
        live = np.flatnonzero(cols.alive[:n_all])
        ns = cols.ns[live]
        obj = cols.obj[live]
        rel = cols.rel[live]
        subj = cols.subj[live]
        is_set = cols.is_set[live]
    n_tuples = len(ns)
    t0 = _mark("columns", t0)

    # -- node table (sorted by (hi, lo), ids dense) -------------------------
    # packed key = (ns * num_rels + rel) << 32 | obj, built in place to
    # avoid four 85MB temporaries at the 10M-row scale
    packed = np.empty(n_tuples, np.int64)

    def _pack(lo, hi_):
        seg = packed[lo:hi_]
        np.multiply(ns[lo:hi_], num_rels, out=seg, casting="unsafe")
        seg += rel[lo:hi_]
        seg <<= 32
        seg += obj[lo:hi_]

    parallel.shard_apply(n_tuples, _pack)

    # one stable argsort of the packed key replaces the old
    # unique + searchsorted + argsort(node_of_row) triple: equal packed
    # keys ARE equal nodes and packed order IS node order, so this
    # permutation doubles as the membership insertion order (m_order)
    s1 = np.argsort(packed, kind="stable")
    sp = packed[s1]
    subj_s1 = subj[s1]  # membership insertion order (seq within node)
    if n_tuples:
        newg = np.empty(n_tuples, bool)
        newg[0] = True
        np.not_equal(sp[1:], sp[:-1], out=newg[1:])
        uniq_packed = sp[newg]
        gid32 = np.cumsum(newg, dtype=np.int32)  # node id + 1 per position
        gid32 -= 1
        node_of_row = np.empty(n_tuples, np.int32)
        node_of_row[s1] = gid32  # scatter back to row order
    else:
        uniq_packed = np.zeros(0, np.int64)
        node_of_row = np.zeros(0, np.int32)
        gid32 = np.zeros(0, np.int32)
    n_nodes = len(uniq_packed)

    # membership pairs sorted by (node, subj): node values come free as
    # the group ids (gid32); the subject column only needs sorting WITHIN
    # multi-tuple groups — most nodes own a single tuple, so instead of a
    # full lexsort (the old build's single hottest pass) sort just the
    # multi-group rows by a packed (node, subj) VALUE key.  Singleton
    # rows pass through in s1 order, which is already (node, subj) order.
    mem_node_v = gid32
    if n_tuples:
        is_last = np.empty(n_tuples, bool)
        is_last[:-1] = newg[1:]
        is_last[-1] = True
        multi = ~(newg & is_last)  # row sits in a group of size >= 2
        mem_subj_v = subj_s1.copy()
        rows_m = np.flatnonzero(multi)
        if len(rows_m):
            mk = gid32[rows_m].astype(np.int64)
            mk <<= 32
            mk += subj_s1[rows_m]
            mk.sort()  # values only: grouped by node, subj ascending
            mem_subj_v[rows_m] = mk & 0xFFFFFFFF
    else:
        mem_subj_v = subj_s1
    t0 = _mark("sort_unique", t0)

    # -- subject-set CSR (insertion order within each row) -------------------
    # s1 already groups rows by node with seq order preserved, so the set
    # rows in s1 order ARE the edge list (old: flatnonzero + stable argsort)
    sel = np.empty(n_tuples, bool)

    def _sel(lo, hi_):
        np.equal(is_set[s1[lo:hi_]], 1, out=sel[lo:hi_])

    parallel.shard_apply(n_tuples, _sel)
    ss_sorted = s1[sel]  # row index (live-space) per edge, grouped by node
    ss_rows = gid32[sel]  # node id per edge
    rows_set = ss_sorted if live is None else live[ss_sorted]
    edge_ns_v = cols.s_ns[rows_set]
    edge_obj_v = cols.s_obj[rows_set]
    edge_rel_v = cols.s_rel[rows_set]
    n_edges = len(ss_sorted)
    counts = np.bincount(ss_rows, minlength=max(n_nodes, 1))[: max(n_nodes, 1)]

    # edge target node ids
    e_hi = edge_ns_v.astype(np.int64) * num_rels + edge_rel_v
    e_packed = (e_hi << 32) | edge_obj_v.astype(np.int64)
    e_idx = np.searchsorted(uniq_packed, e_packed)
    e_found = (e_idx < n_nodes) & (
        uniq_packed[np.minimum(e_idx, max(n_nodes - 1, 0))] == e_packed
    )
    edge_node_v = np.where(e_found, e_idx, -1).astype(np.int32)

    # -- dynamic relation-level pairs (for taint) ---------------------------
    # packed unique over the edge rows instead of a Python set of 4-tuples
    # over millions of lists; the source (ns, rel) pair is the high word
    # of the node key already gathered into sp
    src_pk = sp[sel] >> 32
    dkey = (src_pk << 32) | (e_hi & 0xFFFFFFFF)
    du = np.unique(dkey)
    d_src = du >> 32
    d_dst = du & 0xFFFFFFFF
    dyn = set(
        zip(
            (d_src // num_rels).tolist(), (d_src % num_rels).tolist(),
            (d_dst // num_rels).tolist(), (d_dst % num_rels).tolist(),
        )
    )

    # -- pack + pad ---------------------------------------------------------
    # only device-bound arrays get _bucket padding; node_hi/node_lo and the
    # sorted membership columns stay host-side (checkpointing + overlay
    # binary searches) and are stored at exact length
    npad = _bucket(n_nodes)
    epad = _bucket(n_edges)
    mpad = _bucket(n_tuples)

    node_hi = np.empty(n_nodes, np.int32)
    node_lo = np.empty(n_nodes, np.int32)

    def _node_cols(lo, hi_):
        node_hi[lo:hi_] = uniq_packed[lo:hi_] >> 32
        node_lo[lo:hi_] = uniq_packed[lo:hi_] & 0xFFFFFFFF

    parallel.shard_apply(n_nodes, _node_cols)

    row_ptr = np.empty(npad + 1, np.int32)
    row_ptr[0] = 0
    if n_nodes:
        np.cumsum(counts, out=row_ptr[1 : n_nodes + 1])
    row_ptr[n_nodes + 1:] = n_edges

    def pad_edges(v):
        out = np.empty(epad, np.int32)
        out[:n_edges] = v
        out[n_edges:] = -1
        return out

    mem_node = mem_node_v
    mem_subj = mem_subj_v
    mem_ord_subj = np.empty(mpad, np.int32)

    def _mem_fill(lo, hi_):
        # insertion-ordered member list per node: s1 is stable by node, so
        # it keeps the live rows' append (seq) order within each group
        mem_ord_subj[lo:hi_] = subj_s1[lo:hi_]

    parallel.shard_apply(n_tuples, _mem_fill)
    mem_ord_subj[n_tuples:] = -1
    # per-node membership CSR straight from the group boundaries: every
    # node owns >= 1 tuple, so the i-th True in newg IS the row offset of
    # node i (no bincount/cumsum pass over the 10M column)
    mem_row_ptr = np.empty(npad + 1, np.int32)
    mem_row_ptr[n_nodes:] = n_tuples
    if n_nodes:
        mem_row_ptr[:n_nodes] = np.flatnonzero(newg)

    spad = _bucket(max(len(vocab.subjects), 1))
    sub_ns = np.full(spad, -1, np.int32)
    sub_obj = np.full(spad, -1, np.int32)
    sub_rel = np.full(spad, -1, np.int32)
    ss_subj = subj[ss_sorted]
    sub_ns[ss_subj] = edge_ns_v
    sub_obj[ss_subj] = edge_obj_v
    sub_rel[ss_subj] = edge_rel_v
    t0 = _mark("csr_pack", t0)

    flat = compile_flat_tables(
        manager, vocab, strict=strict, num_ns=num_ns, num_rel=num_rels
    )
    taint, err_reach = _compute_taint(flat, op, dyn, num_ns, num_rels)
    t0 = _mark("optable", t0)

    node_tab = hashtab.build_table(
        node_hi,
        node_lo,
        np.arange(n_nodes, dtype=np.int32),
        lean=True, probe=2 * hashtab.SNAPSHOT_PROBE,
    )
    mem_tab = hashtab.build_table(
        mem_node_v, mem_subj_v,
        lean=True, probe=2 * hashtab.SNAPSHOT_PROBE,
    )
    t0 = _mark("hashtab", t0)

    snap = Snapshot(
        vocab=vocab,
        op=op,
        flat=flat,
        taint=taint,
        err_reach=err_reach,
        num_rels=num_rels,
        node_hi=node_hi,
        node_lo=node_lo,
        row_ptr=row_ptr,
        edge_ns=pad_edges(edge_ns_v),
        edge_obj=pad_edges(edge_obj_v),
        edge_rel=pad_edges(edge_rel_v),
        edge_node=pad_edges(edge_node_v),
        mem_node=mem_node,
        mem_subj=mem_subj,
        mem_row_ptr=mem_row_ptr,
        mem_ord_subj=mem_ord_subj,
        sub_ns=sub_ns,
        sub_obj=sub_obj,
        sub_rel=sub_rel,
        n_nodes=n_nodes,
        n_edges=n_edges,
        n_tuples=n_tuples,
        version=version,
        node_tab=node_tab,
        mem_tab=mem_tab,
    )
    snap.dyn_pairs = dyn
    return snap

"""Columnar tuple store: the 10M-tuple-scale Manager implementation.

The reference loads bulk data through row-at-a-time SQL inserts
(`internal/persistence/sql/relationtuples.go:263-287`); at the BASELINE
scale (10M tuples) a Python-object row store costs gigabytes and minutes
of per-tuple work just to *hold* the data.  This store keeps a bulk-loaded
**base segment** as numpy id columns over a shared `Vocab` — the exact
layout the device projection consumes (`engine/delta.TupleColumns`), so
the engine adopts it zero-copy via ``export_columns`` instead of
materializing ten million `RelationTuple` objects.

Everything written *after* the bulk load flows through the inherited
`InMemoryTupleStore` machinery (rows, indexes, change log), so the write
path, pagination contract, and change-log semantics are identical to the
in-memory store; reads stitch the base segment and the tail together.
Base-segment queries run as vectorized column scans behind a lazily built
sorted index (the (ns, obj, rel) forward index — the same shape as the
reference's ``idx_relation_tuples_full`` partial index).

Wire parity note: base sequence numbers are 0..n_base-1 in load order and
tail rows continue after them, so page tokens behave exactly like the
in-memory store's.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ketotpu_torch.api.types import (
    RelationQuery,
    RelationTuple,
    SubjectID,
    SubjectSet,
)
from ketotpu_torch.engine.vocab import Vocab
from ketotpu_torch.storage.memory import (
    DEFAULT_PAGE_SIZE,
    InMemoryTupleStore,
    _matches,
)


class ColumnarTupleStore(InMemoryTupleStore):
    """Manager over a columnar base segment + an in-memory tail."""

    #: column names of the base segment (TupleColumns layout)
    COLS = ("ns", "obj", "rel", "subj", "is_set", "s_ns", "s_obj", "s_rel")

    def __init__(self, vocab: Optional[Vocab] = None):
        super().__init__()
        self.vocab = vocab if vocab is not None else Vocab()
        self._b: Dict[str, np.ndarray] = {
            c: np.zeros(0, np.int32) for c in self.COLS
        }
        self._b_alive = np.zeros(0, bool)
        self._b_n = 0
        # id -> string decode tables, refreshed lazily from the vocab
        self._dec: Dict[str, List[str]] = {}
        # lazy (hi=ns*STRIDE... ) sorted forward index over base rows
        self._fwd_order: Optional[np.ndarray] = None
        self._fwd_keys: Optional[np.ndarray] = None
        self._sub_order: Optional[np.ndarray] = None  # reverse-subject index

    # -- bulk load -----------------------------------------------------------

    def bulk_load_ids(self, cols: Dict[str, np.ndarray]) -> None:
        """Adopt pre-interned id columns as the base segment (append).

        ``cols`` maps every name in ``COLS`` to an int32 array of equal
        length; ids MUST come from this store's ``vocab``.  One version
        bump for the whole load; the change log is reset (readers holding
        an older cursor get the None sentinel and full-rescan, which for
        engines lands on the ``export_columns`` fast path).
        """
        n = len(cols["ns"])
        with self._lock:
            if self._rows:
                raise ValueError(
                    "bulk_load_ids must precede row-wise writes"
                )
            base = {
                c: np.ascontiguousarray(cols[c], np.int32)
                for c in self.COLS
            }
            if self._b_n:
                base = {
                    c: np.concatenate([self._b[c], base[c]])
                    for c in self.COLS
                }
            self._b = base
            self._b_n = len(base["ns"])
            self._b_alive = np.ones(self._b_n, bool)
            self._next_seq = self._b_n
            self._fwd_order = self._fwd_keys = self._sub_order = None
            # advance past every pre-load log entry AND the loaded base
            # rows, so every cursor issued before this load falls behind
            # _log_start and forces the full-rescan/export_columns path
            # (advancing by n alone would let a cursor taken after
            # write-then-delete churn read an empty delta and miss the
            # whole bulk-loaded segment)
            self._log_start += len(self._log) + n
            self._log.clear()
            self._bump()

    def export_columns(self):
        """(columns dict, alive bool[n], tail tuples, head) for zero-copy
        engine adoption (engine/delta.TupleColumns.from_arrays).  All four
        read under ONE lock so a concurrent write cannot slip between the
        column view and the change-log cursor (it would double-apply when
        the engine later drains ``changes_since(head)``)."""
        with self._lock:
            return (
                {c: self._b[c] for c in self.COLS},
                self._b_alive,
                list(self._rows.values()),
                self._log_start + len(self._log),
            )

    # -- decode --------------------------------------------------------------

    def _strings(self, space: str) -> List[str]:
        tab = self._dec.get(space)
        interner = getattr(self.vocab, space)
        if tab is None or len(tab) != len(interner):
            tab = interner.strings()
            self._dec[space] = tab
        return tab

    def _materialize(self, i: int) -> RelationTuple:
        b = self._b
        nss = self._strings("namespaces")
        objs = self._strings("objects")
        rels = self._strings("relations")
        if b["is_set"][i]:
            subject = SubjectSet(
                namespace=nss[b["s_ns"][i]],
                object=objs[b["s_obj"][i]],
                relation=rels[b["s_rel"][i]],
            )
        else:
            uid = self._strings("subjects")[b["subj"][i]]
            subject = SubjectID(id=uid[3:])  # strip "id:" (unique_id form)
        return RelationTuple(
            namespace=nss[b["ns"][i]],
            object=objs[b["obj"][i]],
            relation=rels[b["rel"][i]],
            subject=subject,
        )

    # -- base-segment query machinery ---------------------------------------

    def _fwd(self) -> Tuple[np.ndarray, np.ndarray]:
        """Sorted (ns, obj, rel) forward index over base rows: one int64
        key per row, argsorted — range lookup by searchsorted."""
        if self._fwd_keys is None:
            b = self._b
            key = (
                (b["ns"].astype(np.int64) << 42)
                | (b["obj"].astype(np.int64) << 14)
                | b["rel"].astype(np.int64)
            )
            self._fwd_order = np.argsort(key, kind="stable")
            self._fwd_keys = key[self._fwd_order]
        return self._fwd_keys, self._fwd_order

    def _base_candidates(self, query: Optional[RelationQuery]) -> np.ndarray:
        """Base row indices possibly matching ``query``, ascending."""
        if self._b_n == 0:
            return np.zeros(0, np.int64)
        b = self._b
        if query is None:
            return np.flatnonzero(self._b_alive)
        v = self.vocab
        full = (
            query.namespace is not None
            and query.object is not None
            and query.relation is not None
        )
        if full:
            ns = v.namespaces.lookup(query.namespace)
            obj = v.objects.lookup(query.object)
            rel = v.relations.lookup(query.relation)
            if -1 in (ns, obj, rel):
                return np.zeros(0, np.int64)
            keys, order = self._fwd()
            want = (int(ns) << 42) | (int(obj) << 14) | int(rel)
            lo = np.searchsorted(keys, want, side="left")
            hi = np.searchsorted(keys, want, side="right")
            rows = np.sort(order[lo:hi])
        else:
            mask = self._b_alive.copy()
            if query.namespace is not None:
                i = v.namespaces.lookup(query.namespace)
                mask &= b["ns"] == i
            if query.object is not None:
                i = v.objects.lookup(query.object)
                mask &= b["obj"] == i
            if query.relation is not None:
                i = v.relations.lookup(query.relation)
                mask &= b["rel"] == i
            subject = query.subject()
            if subject is not None:
                i = v.subjects.lookup(subject.unique_id())
                mask &= b["subj"] == i
            return np.flatnonzero(mask)
        subject = query.subject()
        out = rows[self._b_alive[rows]]
        if subject is not None:
            i = v.subjects.lookup(subject.unique_id())
            if i < 0:
                return np.zeros(0, np.int64)
            out = out[b["subj"][out] == i]
        return out

    # -- Manager surface (base + inherited tail) ----------------------------

    def get_relation_tuples(
        self,
        query: Optional[RelationQuery] = None,
        *,
        page_token: str = "",
        page_size: int = 0,
    ) -> Tuple[List[RelationTuple], str]:
        if page_size <= 0:
            page_size = DEFAULT_PAGE_SIZE
        after = -1
        if page_token:
            try:
                after = int(page_token)
            except ValueError:
                from ketotpu_torch.storage.memory import ErrMalformedPageToken

                raise ErrMalformedPageToken() from None
        with self._lock:
            out: List[Tuple[int, RelationTuple]] = []
            rows = self._base_candidates(query)
            if after >= 0:
                rows = rows[rows > after]
            rows = rows[: page_size + 1]  # never materialize a full scan
            for i in rows.tolist():
                out.append((i, self._materialize(i)))
                if len(out) > page_size:
                    break
            if len(out) <= page_size:
                for seq in self._candidates(query):
                    if seq <= after:
                        continue
                    t = self._rows.get(seq)
                    if t is not None and _matches(t, query):
                        out.append((seq, t))
                        if len(out) > page_size:
                            break
            if len(out) > page_size:
                page = out[:page_size]
                return [t for _, t in page], str(page[-1][0])
            return [t for _, t in out], ""

    def exists_relation_tuples(
        self, query: Optional[RelationQuery] = None
    ) -> bool:
        with self._lock:
            if len(self._base_candidates(query)):
                return True
        return super().exists_relation_tuples(query)

    def __len__(self) -> int:
        return int(self._b_alive.sum()) + len(self._rows)

    def all_tuples(self) -> List[RelationTuple]:
        with self._lock:
            base = [
                self._materialize(i)
                for i in np.flatnonzero(self._b_alive).tolist()
            ]
            return base + list(self._rows.values())

    def tuples_and_head(self) -> Tuple[List[RelationTuple], int]:
        with self._lock:
            return self.all_tuples(), self._log_start + len(self._log)

    # -- writes --------------------------------------------------------------

    def transact_relation_tuples(
        self,
        insert: Iterable[RelationTuple] = (),
        delete: Iterable[RelationTuple] = (),
    ) -> None:
        insert, delete = list(insert), list(delete)
        for t in insert:
            if t.subject is not None:  # nil subject: typed error below
                self.vocab.intern_tuple(t)  # keep ids available for encode
        with self._lock:
            # deletes may target base rows: handle those here, the rest
            # (incl. inserts) via the inherited row machinery
            base_deletes = []
            for t in delete:
                base_deletes.extend(self._base_rows_of(t))
            super().transact_relation_tuples(insert=insert, delete=delete)
            killed = False
            for i in base_deletes:
                if self._b_alive[i]:
                    self._b_alive[i] = False
                    self._log_locked(-1, self._materialize(i))
                    killed = True
            if killed and not insert:
                self._bump()

    def _base_rows_of(self, t: RelationTuple) -> List[int]:
        v = self.vocab
        ids = (
            v.namespaces.lookup(t.namespace),
            v.objects.lookup(t.object),
            v.relations.lookup(t.relation),
        )
        if -1 in ids:
            return []
        keys, order = self._fwd()
        want = (int(ids[0]) << 42) | (int(ids[1]) << 14) | int(ids[2])
        lo = np.searchsorted(keys, want, side="left")
        hi = np.searchsorted(keys, want, side="right")
        rows = np.sort(order[lo:hi])
        sid = v.subjects.lookup(t.subject.unique_id())
        if sid < 0:
            return []
        rows = rows[
            self._b_alive[rows] & (self._b["subj"][rows] == sid)
        ]
        return rows.tolist()

    def delete_all_relation_tuples(
        self, query: Optional[RelationQuery] = None
    ) -> int:
        with self._lock:
            rows = self._base_candidates(query)
            for i in rows.tolist():
                self._b_alive[i] = False
                self._log_locked(-1, self._materialize(i))
            n_tail = super().delete_all_relation_tuples(query)
            if len(rows) and not n_tail:
                self._bump()
            return int(len(rows)) + n_tail

"""String interning: the host-side vocabulary mapping API strings to dense ids.

The reference maps every namespace/object/subject string to a UUIDv5 before it
touches storage (`internal/relationtuple/uuid_mapping.go:199-267`,
`internal/persistence/sql/uuid_mapping.go:35-74`).  On TPU we go one step
further: dense int32 ids, so graph nodes index directly into CSR arrays.  The
UUID mapper (`ketotpu/api/uuid_map.py`) stays the wire-parity layer; this
vocabulary is the device-id layer.

Interners are append-only so ids remain stable across snapshot rebuilds —
arrays grow, existing ids never move (mirrors the reference's INSERT ON
CONFLICT DO NOTHING mapping writes).

Columnar encode: ``lookup_many`` probes a bucketed hash table
(engine/hashtab.py) keyed on the strings' 62-bit Python hashes — one
vectorized probe per request column instead of one dict walk per item.
Every probe hit is verified against the reverse string table (two distinct
strings CAN share a masked hash), and misses — including entries interned
after the table was built — fall back to the dict, which stays the
authority.  The table is rebuilt amortized as the interner grows, so the
vectorized path never lags more than a constant factor behind."""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np

from ketotpu_torch.api.types import RelationTuple, Subject, SubjectSet
from ketotpu_torch.engine import hashtab

#: interners smaller than this answer straight from the dict — the table
#: build is O(n) and only pays for itself once columns are long-lived
_TABLE_MIN = 1024

_HASH_MASK = (1 << 62) - 1
_HALF_MASK = (1 << 31) - 1


class Interner:
    """Append-only string -> int32 id mapping."""

    def __init__(self):
        self._ids: Dict[str, int] = {}
        # vectorized-probe state (built lazily by lookup_many): the hash
        # table over entries [0, _tab_n), and the id->string verification
        # column frozen at build time
        self._tab = None
        self._tab_rev: Optional[np.ndarray] = None
        self._tab_n = 0
        self._tab_lock = threading.Lock()

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._ids)
            self._ids[s] = i
        return i

    def lookup(self, s: str) -> int:
        """-1 for unknown strings (a miss everywhere on device)."""
        return self._ids.get(s, -1)

    def __len__(self) -> int:
        return len(self._ids)

    def strings(self):
        return list(self._ids.keys())

    # -- columnar probe ------------------------------------------------------

    def _rebuild_index(self) -> None:
        """(Re)build the hash table over the current entries.  Keys are the
        strings' 62-bit hashes split into two non-negative int32 halves
        (hashtab keys must be non-negative); ids double as entry order, so
        ``np.array(keys)`` in dict order IS the reverse table."""
        strs = list(self._ids.keys())
        n = len(strs)
        ha = np.fromiter(map(hash, strs), np.int64, n) & _HASH_MASK
        self._tab = hashtab.build_table(
            (ha & _HALF_MASK).astype(np.int32),
            ((ha >> 31) & _HALF_MASK).astype(np.int32),
            np.arange(n, dtype=np.int32),
        )
        self._tab_rev = np.array(strs, dtype=object)
        self._tab_n = n

    def _index(self):
        """The probe table, rebuilt amortized: entries interned after a
        build answer through the dict until the interner doubles."""
        n = len(self._ids)
        if n < _TABLE_MIN:
            return None
        if self._tab is None or n >= 2 * self._tab_n:
            with self._tab_lock:
                n = len(self._ids)
                if self._tab is None or n >= 2 * self._tab_n:
                    self._rebuild_index()
        return self._tab

    def lookup_many(self, strs: Sequence[str]) -> np.ndarray:
        """Vectorized :meth:`lookup` over a whole column; -1 per miss."""
        n = len(strs)
        get = self._ids.get
        tab = self._index()
        if tab is None or n == 0:
            return np.fromiter((get(s, -1) for s in strs), np.int32, n)
        ha = np.fromiter(map(hash, strs), np.int64, n) & _HASH_MASK
        ids, found = hashtab.lookup_np(
            tab,
            (ha & _HALF_MASK).astype(np.int32),
            ((ha >> 31) & _HALF_MASK).astype(np.int32),
        )
        out = np.where(found, ids, np.int32(-1)).astype(np.int32)
        hit = np.flatnonzero(found)
        if len(hit):
            # collision safety: a probe hit only proves the masked hash
            # matched — verify the actual strings and demote mismatches
            # to misses (the dict answers them exactly below)
            col = np.empty(len(hit), object)
            col[:] = [strs[i] for i in hit]
            same = np.asarray(self._tab_rev[ids[hit]] == col, bool)
            if not same.all():
                out[hit[~same]] = -1
                found[hit[~same]] = False
        for i in np.flatnonzero(~found):
            # scalar fallback: vocab misses AND entries newer than the
            # table build (the dict is the authority either way)
            out[i] = get(strs[i], -1)
        return out


class Vocab:
    """The four id spaces of the tuple graph."""

    def __init__(self):
        self.namespaces = Interner()
        self.objects = Interner()
        self.relations = Interner()
        self.subjects = Interner()  # keyed by Subject.unique_id()
        # The empty relation is legal ("the object itself",
        # ketoapi/enc_string.go:79-94) — always present.
        self.relations.intern("")

    def intern_tuple(self, t: RelationTuple) -> None:
        self.namespaces.intern(t.namespace)
        self.objects.intern(t.object)
        self.relations.intern(t.relation)
        self.subjects.intern(t.subject.unique_id())
        if isinstance(t.subject, SubjectSet):
            self.namespaces.intern(t.subject.namespace)
            self.objects.intern(t.subject.object)
            self.relations.intern(t.subject.relation)

    def subject_key(self, s: Optional[Subject]) -> int:
        if s is None:
            return -1
        return self.subjects.lookup(s.unique_id())

    def encode_columns(self, ns, obj, rel, subj_uid):
        """Bulk-encode four request string columns to int32 id columns —
        one vectorized probe per column (engine/hashtab.py), scalar dict
        fallback only for misses.  Byte-for-byte equal to mapping
        ``lookup``/``subject_key`` over the items."""
        return (
            self.namespaces.lookup_many(ns),
            self.objects.lookup_many(obj),
            self.relations.lookup_many(rel),
            self.subjects.lookup_many(subj_uid),
        )

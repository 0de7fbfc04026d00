"""In-memory relation-tuple store.

Implements the Manager contract of the reference persister
(`internal/persistence/sql/relationtuples.go:207-287`): filtered reads with
opaque-token pagination, existence probes, transactional insert+delete, and
delete-by-query — over an ordered in-memory map with secondary indexes instead
of SQL.  Duplicate tuples are allowed, as in the reference (every insert is a
fresh row keyed by a new id, relationtuples.go:112-115).

The store versions itself: every committed write bumps ``version`` and fires
registered change listeners.  Snapshot projection (CSR for the TPU engine)
keys off that version.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ketotpu_torch.api.types import (
    BadRequestError,
    RelationQuery,
    RelationTuple,
)

DEFAULT_PAGE_SIZE = 100


def ErrMalformedPageToken() -> BadRequestError:
    return BadRequestError("malformed page token")


class InMemoryTupleStore:
    """Ordered tuple store with by-userset and by-subject indexes."""

    def __init__(self):
        self._lock = threading.RLock()
        self._rows: Dict[int, RelationTuple] = {}  # seq -> tuple, insertion order
        self._next_seq = 0
        # (namespace, object, relation) -> [seq]; the forward index backing
        # expand / subject-set traversal (the reference's
        # idx_relation_tuples_full partial indexes).
        self._by_userset: Dict[Tuple[str, str, str], List[int]] = {}
        # subject unique_id -> [seq]; the reverse-subject index.
        self._by_subject: Dict[str, List[int]] = {}
        self.version = 0
        self._listeners: List[Callable[[int], None]] = []
        # append-only change log for incremental snapshot projection
        # (SURVEY §7 step 8): entries are (+1|-1, tuple) effective mutations.
        # Bounded: readers that fall behind log_start must full-rebuild.
        self._log: List[Tuple[int, RelationTuple]] = []
        self._log_start = 0  # index of _log[0] in the all-time sequence
        self._log_cap = 65536
        # overflow surfacing (keto_changelog_overflow_total): the registry
        # installs a hook(n_evicted, first_of_episode); an "episode" runs
        # from the first eviction until a lagging reader actually observes
        # the gap (changes_since -> None) and rebuilds.
        self.overflow_hook: Optional[Callable[[int, bool], None]] = None
        self.overflow_evictions = 0
        self._overflow_episode = False

    # -- change notification -------------------------------------------------

    def on_change(self, fn: Callable[[int], None]) -> None:
        self._listeners.append(fn)

    def _bump(self) -> None:
        self.version += 1
        for fn in self._listeners:
            fn(self.version)

    # -- reads ---------------------------------------------------------------

    def get_relation_tuples(
        self,
        query: Optional[RelationQuery] = None,
        *,
        page_token: str = "",
        page_size: int = 0,
    ) -> Tuple[List[RelationTuple], str]:
        """Return (tuples, next_page_token); empty token means last page."""
        if page_size <= 0:
            page_size = DEFAULT_PAGE_SIZE
        after = -1
        if page_token:
            try:
                after = int(page_token)
            except ValueError:
                raise ErrMalformedPageToken() from None

        with self._lock:
            out: List[Tuple[int, RelationTuple]] = []
            for seq in self._candidates(query):
                if seq <= after:
                    continue
                t = self._rows.get(seq)
                if t is not None and _matches(t, query):
                    out.append((seq, t))
                    if len(out) > page_size:
                        # one overflow row fetched: a next page exists
                        page = out[:page_size]
                        return [t for _, t in page], str(page[-1][0])
        return [t for _, t in out], ""

    def _candidates(self, query: Optional[RelationQuery]) -> Iterable[int]:
        """Pick the most selective index for the query; always sorted by seq."""
        if query is not None and query.namespace is not None and query.object is not None \
                and query.relation is not None:
            return list(self._by_userset.get(
                (query.namespace, query.object, query.relation), ()))
        if query is not None and query.subject() is not None:
            return list(self._by_subject.get(query.subject().unique_id(), ()))
        return list(self._rows.keys())

    def exists_relation_tuples(self, query: Optional[RelationQuery] = None) -> bool:
        with self._lock:
            return any(_matches(self._rows[s], query) for s in self._candidates(query))

    def __len__(self) -> int:
        return len(self._rows)

    def all_tuples(self) -> List[RelationTuple]:
        with self._lock:
            return list(self._rows.values())

    def tuples_and_head(self) -> Tuple[List[RelationTuple], int]:
        """All tuples plus the log head, read atomically — a snapshot
        builder that seeds from the scan and later drains `changes_since`
        from the returned head cannot miss a concurrent write."""
        with self._lock:
            return list(self._rows.values()), self._log_start + len(self._log)

    def version_and_head(self) -> Tuple[int, int]:
        """(version, log head) in one lock window.  Snaptoken minting needs
        the pair atomic: a write landing between two separate reads would
        mint a token whose cursor includes entries of a version the token
        does not claim — harmless for freshness, wrong for the exactness a
        replicated follower must preserve across a takeover."""
        with self._lock:
            return self.version, self._log_start + len(self._log)

    def replica_scan(self) -> Tuple[List[RelationTuple], int, int]:
        """(tuples, head, version) in one lock window: the bootstrap scan a
        warm-standby follower seeds its replica from."""
        with self._lock:
            head = self._log_start + len(self._log)
            return list(self._rows.values()), head, self.version

    # -- writes --------------------------------------------------------------

    def write_relation_tuples(self, *tuples: RelationTuple) -> None:
        self.transact_relation_tuples(insert=tuples, delete=())

    def delete_relation_tuples(self, *tuples: RelationTuple) -> None:
        self.transact_relation_tuples(insert=(), delete=tuples)

    def transact_relation_tuples(
        self,
        insert: Iterable[RelationTuple] = (),
        delete: Iterable[RelationTuple] = (),
    ) -> None:
        """Apply inserts then deletes atomically (transact_server semantics:
        sql/relationtuples.go:277-287)."""
        insert, delete = list(insert), list(delete)
        for t in insert:
            if t.subject is None:
                raise BadRequestError("subject is not allowed to be nil")
        with self._lock:
            for t in insert:
                self._insert_locked(t)
            n_deleted = 0
            for t in delete:
                n_deleted += self._delete_exact_locked(t)
            if insert or n_deleted:
                self._bump()

    # -- replication (warm-standby follower) ---------------------------------

    def adopt_replica(
        self,
        tuples: Iterable[RelationTuple],
        head: int,
        version: int,
        log: Iterable[Tuple[int, RelationTuple]] = (),
        log_start: Optional[int] = None,
    ) -> None:
        """Install a leader's full row scan as this store's state, anchored
        at the LEADER'S changelog coordinates.  ``log`` is the leader's tail
        ``[log_start, head)`` so an engine whose base snapshot sits at
        ``log_start`` can drain forward through ``changes_since`` exactly as
        it would on the leader.  From here on, ``apply_replicated`` batches
        keep positions and versions identical to the leader's — which is
        what makes every leader-minted snaptoken satisfiable on this
        replica after a takeover."""
        tuples = list(tuples)
        log = list(log)
        if log_start is None:
            log_start = head - len(log)
        if log_start + len(log) != head:
            raise ValueError(
                f"replica log [{log_start}, {log_start + len(log)}) does "
                f"not end at the declared head {head}"
            )
        with self._lock:
            self._rows.clear()
            self._by_userset.clear()
            self._by_subject.clear()
            self._next_seq = 0
            for t in tuples:
                seq = self._next_seq
                self._next_seq += 1
                self._rows[seq] = t
                self._by_userset.setdefault(
                    (t.namespace, t.object, t.relation), []
                ).append(seq)
                self._by_subject.setdefault(
                    t.subject.unique_id(), []
                ).append(seq)
            self._log = log
            self._log_start = log_start
            self._overflow_episode = False
            self.version = version

    def apply_replicated(
        self,
        entries: Iterable[Tuple[int, RelationTuple]],
        head: int,
        version: int,
    ) -> None:
        """Apply a tailed changelog batch from the leader.  Each entry is
        one EFFECTIVE row mutation (exactly what ``_log_locked`` recorded on
        the leader), so a ``-1`` removes exactly one matching row; applying
        the batch grows this log by ``len(entries)``, landing the head at
        the leader's — asserted, because silent coordinate drift would
        desync every snaptoken cursor minted afterward."""
        entries = list(entries)
        with self._lock:
            for op, t in entries:
                if op > 0:
                    self._insert_locked(t)
                else:
                    key = (t.namespace, t.object, t.relation)
                    for seq in list(self._by_userset.get(key, ())):
                        if self._rows[seq] == t:
                            self._remove_row_locked(seq)
                            break
            my_head = self._log_start + len(self._log)
            if my_head != head:
                raise ValueError(
                    f"replica head {my_head} diverged from leader head "
                    f"{head} after applying {len(entries)} entries"
                )
            self.version = version
            for fn in self._listeners:
                fn(self.version)

    def delete_all_relation_tuples(self, query: Optional[RelationQuery] = None) -> int:
        with self._lock:
            doomed = [s for s in self._candidates(query) if _matches(self._rows[s], query)]
            for seq in doomed:
                self._remove_row_locked(seq)
            if doomed:
                self._bump()
            return len(doomed)

    # -- internals -----------------------------------------------------------

    def _insert_locked(self, t: RelationTuple) -> None:
        seq = self._next_seq
        self._next_seq += 1
        self._rows[seq] = t
        self._by_userset.setdefault((t.namespace, t.object, t.relation), []).append(seq)
        self._by_subject.setdefault(t.subject.unique_id(), []).append(seq)
        self._log_locked(1, t)

    def _delete_exact_locked(self, t: RelationTuple) -> int:
        key = (t.namespace, t.object, t.relation)
        n = 0
        for seq in list(self._by_userset.get(key, ())):
            if self._rows[seq] == t:
                self._remove_row_locked(seq)
                n += 1
        return n

    def _remove_row_locked(self, seq: int) -> None:
        t = self._rows.pop(seq)
        key = (t.namespace, t.object, t.relation)
        self._by_userset[key].remove(seq)
        if not self._by_userset[key]:
            del self._by_userset[key]
        sid = t.subject.unique_id()
        self._by_subject[sid].remove(seq)
        if not self._by_subject[sid]:
            del self._by_subject[sid]
        self._log_locked(-1, t)

    # -- change log ----------------------------------------------------------

    def _log_locked(self, op: int, t: RelationTuple) -> None:
        self._log.append((op, t))
        if len(self._log) > self._log_cap:
            drop = len(self._log) - self._log_cap
            del self._log[:drop]
            self._log_start += drop
            first = not self._overflow_episode
            self._overflow_episode = True
            self.overflow_evictions += drop
            if self.overflow_hook is not None:
                self.overflow_hook(drop, first)

    @property
    def log_head(self) -> int:
        """All-time index just past the newest change-log entry."""
        with self._lock:
            return self._log_start + len(self._log)

    def changes_since(self, cursor: int):
        """Effective mutations [(op, tuple)] since ``cursor`` (a previous
        ``log_head`` value), plus the new cursor.  Returns ``None`` for the
        entries when the cursor predates the bounded log (reader must
        rebuild from a full scan)."""
        with self._lock:
            head = self._log_start + len(self._log)
            if cursor < self._log_start:
                # the lagging reader has seen the gap and will rebuild:
                # the overflow episode is over (the next eviction logs anew)
                self._overflow_episode = False
                return None, head
            return list(self._log[cursor - self._log_start:]), head

    def changes_since_versioned(self, cursor: int):
        """``changes_since`` plus the store version, all in one lock window
        (the replication tail op ships the triple so the follower's replica
        lands on exactly the leader's (head, version) pair)."""
        with self._lock:
            entries, head = self.changes_since(cursor)
            return entries, head, self.version


def _matches(t: RelationTuple, q: Optional[RelationQuery]) -> bool:
    if q is None:
        return True
    if q.namespace is not None and t.namespace != q.namespace:
        return False
    if q.object is not None and t.object != q.object:
        return False
    if q.relation is not None and t.relation != q.relation:
        return False
    subject = q.subject()
    if subject is not None and t.subject != subject:
        return False
    return True

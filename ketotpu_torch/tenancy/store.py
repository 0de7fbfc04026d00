"""Tenant store view: the nid-scoped storage contract over the fused store.

One shared ("fused") in-memory store holds every tenant's tuples under
qualified namespaces (``f"{nid}\\x1f{ns}"``).  Each tenant gets a
:class:`TenantStoreView` presenting the ordinary single-tenant storage
surface — unqualified rows, filtered changelog — in GLOBAL changelog
coordinates, exactly the contract the SQL stores implement with their
``nid`` column over a global AUTOINCREMENT id (``keto_change_log``):

* ``log_head`` is the fused head (sqlite's ``MAX(id)+1`` has no nid
  filter either), so snaptokens minted by any tenant compare directly
  against the shared engine's drain cursors — no translation layer;
* ``changes_since(cursor)`` returns only this tenant's entries but
  advances to the global head, so repeated drains never re-deliver;
* writes are quota-gated (write-rate bucket + tuple cap) and fire the
  view's own listeners — a tenant WatchHub or expand-cache follows only
  its own writes.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, List, Optional, Tuple

from ketotpu_torch.api.types import (
    RelationQuery,
    RelationTuple,
    SubjectSet,
    TooManyRequestsError,
)
from ketotpu_torch.storage.memory import DEFAULT_PAGE_SIZE, ErrMalformedPageToken, _matches

#: unit separator — cannot appear in a client namespace, so qualified
#: names are collision-free and the tenant prefix splits unambiguously
SEP = "\x1f"


def qualify_ns(nid: str, ns: str) -> str:
    return nid + SEP + ns


def split_ns(qns: str) -> Tuple[Optional[str], str]:
    """(nid, ns) for a qualified name; (None, name) when unqualified."""
    i = qns.find(SEP)
    if i < 0:
        return None, qns
    return qns[:i], qns[i + 1:]


def qualify_subject(nid: str, s):
    if isinstance(s, SubjectSet):
        return SubjectSet(
            namespace=qualify_ns(nid, s.namespace),
            object=s.object,
            relation=s.relation,
        )
    return s


def unqualify_subject(s):
    if isinstance(s, SubjectSet):
        _, ns = split_ns(s.namespace)
        return SubjectSet(namespace=ns, object=s.object, relation=s.relation)
    return s


def qualify_tuple(nid: str, t: RelationTuple) -> RelationTuple:
    return RelationTuple(
        namespace=qualify_ns(nid, t.namespace),
        object=t.object,
        relation=t.relation,
        subject=qualify_subject(nid, t.subject),
    )


def unqualify_tuple(t: RelationTuple) -> RelationTuple:
    _, ns = split_ns(t.namespace)
    return RelationTuple(
        namespace=ns,
        object=t.object,
        relation=t.relation,
        subject=unqualify_subject(t.subject),
    )


def qualify_query(nid: str, q: Optional[RelationQuery]) -> Optional[RelationQuery]:
    if q is None:
        return None
    return RelationQuery(
        namespace=qualify_ns(nid, q.namespace) if q.namespace is not None else None,
        object=q.object,
        relation=q.relation,
        subject_id=q.subject_id,
        subject_set=qualify_subject(nid, q.subject_set)
        if q.subject_set is not None else None,
    )


class TenantStoreView:
    """Single-tenant storage surface over the shared fused store."""

    # the registry's overflow hook targets the fused store, not the view;
    # expose the seam so _wire_overflow no-ops cleanly
    def __init__(self, fused, nid: str, quotas=None, on_write=None):
        self._fused = fused
        self.nid = nid
        self._prefix = nid + SEP
        self._quotas = quotas
        self._on_write = on_write  # plane accounting hook(n_ops)
        self._listeners: List[Callable[[int], None]] = []
        self.overflow_hook: Optional[Callable[[int, bool], None]] = None
        self._lock = threading.Lock()
        # per-nid version, mirroring sqlite's per-nid keto_meta row: bumps
        # only on THIS tenant's effective writes
        self._version = 0
        # follow the fused changelog so view listeners fire for THIS
        # tenant's writes however they arrive (own view, admin surface,
        # or another view handle of the same nid)
        self._follow_cursor = fused.log_head
        fused.on_change(self._fused_changed)

    # -- change notification -------------------------------------------------

    def on_change(self, fn: Callable[[int], None]) -> None:
        self._listeners.append(fn)

    def _fused_changed(self, _version: int) -> None:
        """Fused-store listener: bump the per-nid version and fire view
        listeners only when the new changelog entries touch this tenant.
        Always invoked on the writer's thread while it holds the fused
        store's (re-entrant) lock, so the drain below is race-free and
        lock order is strictly fused -> view."""
        with self._lock:
            entries, head = self._fused.changes_since(self._follow_cursor)
            self._follow_cursor = head
            mine = entries is None or any(
                t.namespace.startswith(self._prefix) for _op, t in entries
            )
            if mine:
                self._version += 1
                v = self._version
        if mine:
            for fn in self._listeners:
                fn(v)

    # -- reads ---------------------------------------------------------------

    def _mine(self) -> List[RelationTuple]:
        return [
            unqualify_tuple(t) for t in self._fused.all_tuples()
            if t.namespace.startswith(self._prefix)
        ]

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
                raise ErrMalformedPageToken() from None
        out: List[Tuple[int, RelationTuple]] = []
        for i, t in enumerate(self._mine()):
            if i <= after or not _matches(t, query):
                continue
            out.append((i, t))
            if len(out) > page_size:
                page = out[:page_size]
                return [t for _, t in page], str(page[-1][0])
        return [t for _, t in out], ""

    def exists_relation_tuples(self, query: Optional[RelationQuery] = None) -> bool:
        if query is not None and query.namespace is not None:
            return self._fused.exists_relation_tuples(qualify_query(self.nid, query))
        return any(_matches(t, query) for t in self._mine())

    def __len__(self) -> int:
        return sum(
            1 for t in self._fused.all_tuples()
            if t.namespace.startswith(self._prefix)
        )

    def all_tuples(self) -> List[RelationTuple]:
        return self._mine()

    def tuples_and_head(self) -> Tuple[List[RelationTuple], int]:
        tuples, head = self._fused.tuples_and_head()
        return [
            unqualify_tuple(t) for t in tuples
            if t.namespace.startswith(self._prefix)
        ], head

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def version_and_head(self) -> Tuple[int, int]:
        # per-nid version, GLOBAL head — exactly sqlite's pair (per-nid
        # keto_meta version, global MAX(id)+1 head).  Fused head is read
        # first: lock order is strictly fused -> view everywhere (the
        # fused-change listener holds the fused lock when it takes ours).
        head = self._fused.log_head
        with self._lock:
            return self._version, head

    @property
    def log_head(self) -> int:
        return self._fused.log_head

    def changes_since(self, cursor: int):
        entries, head = self._fused.changes_since(cursor)
        if entries is None:
            return None, head
        return [
            (op, unqualify_tuple(t)) for op, t in entries
            if t.namespace.startswith(self._prefix)
        ], head

    def changes_since_versioned(self, cursor: int):
        entries, head = self.changes_since(cursor)
        return entries, head, self._fused.version

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
        insert, delete = list(insert), list(delete)
        q = self._quotas
        if q is not None and (insert or delete):
            n = len(insert) + len(delete)
            if not q.writes.try_take(n):
                raise TooManyRequestsError(
                    f"tenant {self.nid!r} write rate exceeded"
                )
            if q.max_tuples > 0 and insert \
                    and len(self) + len(insert) > q.max_tuples:
                raise TooManyRequestsError(
                    f"tenant {self.nid!r} tuple quota exceeded "
                    f"({q.max_tuples})"
                )
        self._fused.transact_relation_tuples(
            insert=[qualify_tuple(self.nid, t) for t in insert],
            delete=[qualify_tuple(self.nid, t) for t in delete],
        )
        if self._on_write is not None and (insert or delete):
            self._on_write(len(insert) + len(delete))

    def delete_all_relation_tuples(self, query: Optional[RelationQuery] = None) -> int:
        doomed = [t for t in self._mine() if _matches(t, query)]
        if not doomed:
            return 0
        # through transact so quota accounting and the changelog see the
        # deletes as ordinary effective mutations (exact-match semantics
        # delete duplicates too, matching the fused store's behavior)
        self._fused.transact_relation_tuples(
            insert=(),
            delete=[qualify_tuple(self.nid, t) for t in doomed],
        )
        if self._on_write is not None:
            self._on_write(len(doomed))
        return len(doomed)

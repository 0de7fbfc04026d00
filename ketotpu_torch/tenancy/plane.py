"""The tenant plane: one shared device engine, thousands of isolated stores.

Architecture (see the package docstring): tenant tuples live in one fused
store under qualified namespaces (``nid + "\\x1f" + ns``).  This module
holds everything above the store view:

* :class:`PlaneNamespaceManager` — the namespace config the SHARED device
  engine sees: every tenant's effective namespaces under their qualified
  names.  Tenant create/delete/OPL-reload changes this manager's output,
  which changes ``config_fingerprint`` — the engine's next snapshot sync
  runs a full re-projection.  Padded device shapes come from power-of-two
  buckets, so the swap keeps the table shapes unless the fleet outgrows
  its buckets.
* :class:`TenantNamespaceManager` — one tenant's UNqualified view for its
  derived registry (handlers validate raw client namespace names).
* :class:`TenantCheckEngine` — the per-tenant check facade above the
  shared engine (the device engine itself here): it qualifies scalar
  tuples and ColumnBlocks, then delegates, so batches mix tenants while
  vocab and cache keys stay tenant-distinct by construction (two
  tenants' identical checks can never collapse into one).  Inflight-unit
  quota gates admission.
* :class:`TenantListEngine` — qualifying facade over a shared list
  engine (closure answers stay per-tenant because node identity embeds
  the qualified namespace); its parent's ``list_objects`` /
  ``list_subjects`` are not ported yet.
* :class:`TenantPlane` — lifecycle (create/list/delete/OPL hot reload),
  per-tenant quotas and counters, and bounded-cardinality metrics
  (top-K tenants by traffic, remainder folded into ``other``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ketotpu_torch.api.types import (
    BadRequestError,
    NotFoundError,
    TooManyRequestsError,
)
from ketotpu_torch.opl.ast import Namespace
from ketotpu_torch.storage.namespaces import namespaces_fingerprint
from ketotpu_torch.tenancy.quota import TenantQuotas
from ketotpu_torch.tenancy.store import (  # noqa: F401  (re-exported package API)
    SEP,
    TenantStoreView,
    qualify_ns,
    qualify_subject,
    qualify_tuple,
    split_ns,
    unqualify_subject,
)


class PlaneNamespaceManager:
    """Namespace config for the shared engine: the union of every
    tenant's effective namespaces under qualified names.

    ``namespaces()`` sits on the snapshot-sync hot path (the engine
    fingerprints it before every dispatch), so the qualified list is
    cached and keyed on (plane config version, base manager output
    identity) — the base identity keeps file-backed managers' hot
    reload windows working without re-quoting every call.  The
    fingerprint itself (:meth:`config_fingerprint`) is cached with it:
    hashing the reprs of thousands of tenants' namespaces before every
    batch would cost more than the batch.
    """

    def __init__(self, plane: "TenantPlane", base):
        self._plane = plane
        self._base = base
        self._cache_key = None
        self._cache: List[Namespace] = []
        self._fingerprint: Optional[int] = None
        self._lock = threading.Lock()

    def _refresh_locked(self, base) -> None:
        key = (self._plane.ns_version, tuple(id(n) for n in base))
        if key == self._cache_key:
            return
        out: List[Namespace] = []
        for nid in self._plane.tenant_ids():
            override = self._plane.override_namespaces(nid)
            for ns in (override if override is not None else base):
                # rewrites reference relation names only, so a renamed
                # shallow copy shares the relation ASTs
                out.append(Namespace(
                    name=qualify_ns(nid, ns.name),
                    relations=ns.relations,
                ))
        self._cache_key = key
        self._cache = out
        self._fingerprint = None

    def namespaces(self) -> List[Namespace]:
        base = self._base.namespaces()  # reload window for file managers
        with self._lock:
            self._refresh_locked(base)
            return list(self._cache)

    def config_fingerprint(self) -> int:
        """``namespaces_fingerprint(self.namespaces())``, computed once per
        catalog version."""
        base = self._base.namespaces()
        with self._lock:
            self._refresh_locked(base)
            if self._fingerprint is None:
                self._fingerprint = namespaces_fingerprint(self._cache)
            return self._fingerprint

    def get_namespace(self, name: str) -> Namespace:
        nid, base_name = split_ns(name)
        if nid is None or not self._plane.has_tenant(nid):
            raise NotFoundError(f"namespace {name!r} was not found")
        override = self._plane.override_namespaces(nid)
        if override is not None:
            for ns in override:
                if ns.name == base_name:
                    return Namespace(name=name, relations=ns.relations)
            raise NotFoundError(f"namespace {name!r} was not found")
        ns = self._base.get_namespace(base_name)
        return Namespace(name=name, relations=ns.relations)


class TenantNamespaceManager:
    """One tenant's unqualified namespace view (override-or-shared),
    resolved dynamically so an OPL hot reload is visible immediately."""

    def __init__(self, plane: "TenantPlane", nid: str):
        self._plane = plane
        self.nid = nid

    def namespaces(self) -> List[Namespace]:
        override = self._plane.override_namespaces(self.nid)
        if override is not None:
            return list(override)
        return self._plane.base_manager.namespaces()

    def get_namespace(self, name: str) -> Namespace:
        override = self._plane.override_namespaces(self.nid)
        if override is not None:
            for ns in override:
                if ns.name == name:
                    return ns
            raise NotFoundError(f"namespace {name!r} was not found")
        return self._plane.base_manager.get_namespace(name)


class TenantCheckEngine:
    """Per-tenant check facade over the shared engine.

    Every query is namespace-qualified BEFORE it reaches the shared
    machinery, so batch keys and the device vocab ids are tenant-distinct
    by construction.  The inflight-unit token bucket sheds a flooding
    tenant with 429 before its work occupies a batch slot.
    """

    # a handler's columnar pre-encode probes engine._vocab; the block
    # must be qualified first, so hide the shared vocab behind None (the
    # shared engine encodes after qualification)
    _vocab = None

    def __init__(self, plane: "TenantPlane", nid: str, parent):
        self._plane = plane
        self.nid = nid
        self._prefix = nid + SEP
        self._parent = parent
        self._quotas = plane.quotas_for(nid)

    @property
    def inner(self):
        # debug surfaces (_device_engine -> projection_stats) unwrap to
        # the SHARED device engine; mutating paths never travel this way
        return getattr(self._parent, "inner", self._parent)

    def close(self) -> None:
        """Tenant eviction must NOT close the shared engine underneath
        every other tenant — the facade owns nothing to close."""

    def _acquire(self, n: int) -> None:
        if not self._quotas.inflight.try_acquire(n):
            self._plane.note_shed(self.nid, n)
            raise TooManyRequestsError(
                f"tenant {self.nid!r} inflight quota exceeded "
                f"({self._quotas.inflight.cap} units)"
            )

    def check(self, r, rest_depth: int = 0) -> bool:
        return self.check_is_member(r, rest_depth)

    def check_is_member(self, r, rest_depth: int = 0) -> bool:
        self._acquire(1)
        try:
            verdict = self._parent.check_is_member(
                qualify_tuple(self.nid, r), rest_depth
            )
        finally:
            self._quotas.inflight.release(1)
        self._plane.note_checks(self.nid, 1)
        return verdict

    def batch_check(self, queries, rest_depth: int = 0):
        n = len(queries)
        if n == 0:
            return []
        self._acquire(n)
        try:
            verdicts = self._parent.batch_check(
                [qualify_tuple(self.nid, q) for q in queries], rest_depth
            )
        finally:
            self._quotas.inflight.release(n)
        self._plane.note_checks(self.nid, n)
        return verdicts

    def _qualify_block(self, block):
        from ketotpu_torch.engine import columns

        ns = [self._prefix + s for s in block.ns]
        sa = [
            self._prefix + s if block.skind[i] == columns.SUBJ_SET else s
            for i, s in enumerate(block.sa)
        ]
        # suid recomputes from the qualified sa column, so cache keys and
        # vocab subject ids are tenant-distinct too
        return columns.ColumnBlock(
            ns, list(block.obj), list(block.rel), list(block.skind),
            sa, list(block.sb), list(block.sc),
        )

    def check_block(self, block, rest_depth: int = 0):
        n = len(block)
        if n == 0:
            import numpy as np

            return np.zeros(0, bool), {}
        self._acquire(n)
        try:
            qb = self._qualify_block(block)
            cb = (getattr(self._parent, "check_block", None)
                  or getattr(self._parent, "batch_check_block", None))
            if cb is not None:
                verdicts, row_errs = cb(qb, rest_depth)
            else:
                from ketotpu_torch.engine import columns

                verdicts, row_errs = columns.block_check_via_tuples(
                    self._parent, qb, rest_depth
                )
        finally:
            self._quotas.inflight.release(n)
        self._plane.note_checks(self.nid, n)
        return verdicts, row_errs

    # the worker wire and direct block callers probe this name
    batch_check_block = check_block

    def __getattr__(self, name):
        # read-only forwarding (rebuilds, consistency_cursors, snapshot,
        # refresh, projection_stats, ...) to the shared engine
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "_parent"), name)


class TenantListEngine:
    """Qualifying facade over the shared device list engine."""

    def __init__(self, nid: str, parent):
        self.nid = nid
        self._parent = parent

    def list_objects(self, namespace: str, relation: str, subject, *,
                     page_size: int = 0, page_token: str = ""):
        return self._parent.list_objects(
            qualify_ns(self.nid, namespace), relation,
            qualify_subject(self.nid, subject),
            page_size=page_size, page_token=page_token,
        )

    def list_subjects(self, namespace: str, object: str, relation: str, *,
                      page_size: int = 0, page_token: str = ""):
        subs, token = self._parent.list_subjects(
            qualify_ns(self.nid, namespace), object, relation,
            page_size=page_size, page_token=page_token,
        )
        return [unqualify_subject(s) for s in subs], token


class _Tenant:
    __slots__ = ("nid", "quotas", "checks", "writes", "shed",
                 "created_at", "override", "opl_source")

    def __init__(self, nid: str, quotas: TenantQuotas):
        self.nid = nid
        self.quotas = quotas
        self.checks = 0
        self.writes = 0
        self.shed = 0
        self.created_at = time.time()
        self.override: Optional[List[Namespace]] = None
        self.opl_source: Optional[str] = None


class TenantPlane:
    """Tenant catalog + quotas + metrics over one fused store.

    ``ns_version`` bumps on every lifecycle event (create / delete / OPL
    reload); :class:`PlaneNamespaceManager` folds it into the namespace
    config the shared engine fingerprints, so each event is exactly one
    generation swap on the warmed engine.
    """

    def __init__(self, fused_store, base_manager, *,
                 default_network: str = "default",
                 max_tenants: int = 1024,
                 quota_inflight: int = 0,
                 quota_write_rate: float = 0.0,
                 quota_max_tuples: int = 0,
                 metrics_top_k: int = 8,
                 logger=None):
        self.fused_store = fused_store
        self.base_manager = base_manager
        self.default_network = default_network
        self.max_tenants = int(max_tenants)
        self.metrics_top_k = int(metrics_top_k)
        self._quota_defaults = dict(
            inflight=int(quota_inflight),
            write_rate=float(quota_write_rate),
            max_tuples=int(quota_max_tuples),
        )
        self._logger = logger
        self._lock = threading.RLock()
        self._tenants: Dict[str, _Tenant] = {}
        self.ns_version = 0
        self._published: Dict[tuple, float] = {}  # counter emit deltas
        self.manager = PlaneNamespaceManager(self, base_manager)
        # the default network always exists — single-tenant requests land
        # there without an admin step
        self._create_locked(default_network)

    # -- catalog -------------------------------------------------------------

    @staticmethod
    def _validate_nid(nid: str) -> str:
        if not nid or SEP in nid:
            raise BadRequestError(f"invalid tenant id {nid!r}")
        return nid

    def tenant_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def has_tenant(self, nid: str) -> bool:
        with self._lock:
            return nid in self._tenants

    def _create_locked(self, nid: str) -> _Tenant:
        t = _Tenant(nid, TenantQuotas(**self._quota_defaults))
        self._tenants[nid] = t
        self.ns_version += 1
        return t

    def create(self, nid: str) -> dict:
        """Explicit create (admin surface); idempotent."""
        self._validate_nid(nid)
        with self._lock:
            if nid in self._tenants:
                return {"id": nid, "created": False}
            if len(self._tenants) >= self.max_tenants:
                raise TooManyRequestsError(
                    f"tenant capacity reached ({self.max_tenants})"
                )
            self._create_locked(nid)
        if self._logger is not None:
            self._logger.info("tenant %r created", nid)
        return {"id": nid, "created": True}

    def ensure(self, nid: str) -> _Tenant:
        """Implicit create on first request — the Ory Network pattern
        where the auth proxy's header IS the provisioning event."""
        self._validate_nid(nid)
        with self._lock:
            t = self._tenants.get(nid)
            if t is None:
                if len(self._tenants) >= self.max_tenants:
                    raise TooManyRequestsError(
                        f"tenant capacity reached ({self.max_tenants})"
                    )
                t = self._create_locked(nid)
            return t

    def delete(self, nid: str) -> dict:
        """Drop a tenant: its tuples leave through the ordinary changelog
        (so caches/projections invalidate), then its namespaces leave the
        fingerprint (one generation swap)."""
        with self._lock:
            if nid not in self._tenants:
                raise NotFoundError(f"tenant {nid!r} was not found")
            if nid == self.default_network:
                raise BadRequestError("cannot delete the default network")
        prefix = nid + SEP
        doomed = [
            t for t in self.fused_store.all_tuples()
            if t.namespace.startswith(prefix)
        ]
        if doomed:
            self.fused_store.transact_relation_tuples(delete=doomed)
        with self._lock:
            self._tenants.pop(nid, None)
            self.ns_version += 1
        if self._logger is not None:
            self._logger.info("tenant %r deleted (%d tuples)", nid, len(doomed))
        return {"id": nid, "deleted": True, "tuples_removed": len(doomed)}

    # -- per-tenant config ---------------------------------------------------

    def set_opl(self, nid: str, source: str) -> dict:
        """Install (or clear, with empty source) a tenant's own OPL
        namespace config — hot: the next snapshot sync sees the new
        fingerprint and swaps generations."""
        from ketotpu_torch.opl.parser import parse

        t = self.ensure(nid)
        if not source.strip():
            with self._lock:
                t.override = None
                t.opl_source = None
                self.ns_version += 1
            return {"id": nid, "namespaces": None}
        namespaces, errors = parse(source)
        if errors:
            raise BadRequestError(
                "parsing OPL failed: " + "; ".join(e.msg for e in errors)
            )
        with self._lock:
            t.override = namespaces
            t.opl_source = source
            self.ns_version += 1
        return {"id": nid, "namespaces": [n.name for n in namespaces]}

    def override_namespaces(self, nid: str) -> Optional[List[Namespace]]:
        with self._lock:
            t = self._tenants.get(nid)
            return t.override if t is not None else None

    def quotas_for(self, nid: str) -> TenantQuotas:
        return self.ensure(nid).quotas

    # -- per-tenant assembly (used by Registry.for_network) ------------------

    def view_for(self, nid: str, quotas: Optional[TenantQuotas] = None
                 ) -> TenantStoreView:
        t = self.ensure(nid)
        return TenantStoreView(
            self.fused_store, nid,
            quotas=quotas if quotas is not None else t.quotas,
            on_write=lambda n, _nid=nid: self.note_writes(_nid, n),
        )

    def manager_for(self, nid: str) -> TenantNamespaceManager:
        self.ensure(nid)
        return TenantNamespaceManager(self, nid)

    def engine_for(self, nid: str, parent) -> TenantCheckEngine:
        return TenantCheckEngine(self, nid, parent)

    def list_engine_for(self, nid: str, parent) -> TenantListEngine:
        return TenantListEngine(nid, parent)

    # -- accounting ----------------------------------------------------------

    def note_checks(self, nid: str, n: int) -> None:
        with self._lock:
            t = self._tenants.get(nid)
            if t is not None:
                t.checks += n

    def note_writes(self, nid: str, n: int) -> None:
        with self._lock:
            t = self._tenants.get(nid)
            if t is not None:
                t.writes += n

    def note_shed(self, nid: str, n: int) -> None:
        with self._lock:
            t = self._tenants.get(nid)
            if t is not None:
                t.shed += n

    def tuple_counts(self) -> Dict[str, int]:
        """One pass over the fused store: nid -> live tuple count."""
        counts = {nid: 0 for nid in self.tenant_ids()}
        for t in self.fused_store.all_tuples():
            nid, _ = split_ns(t.namespace)
            if nid in counts:
                counts[nid] += 1
        return counts

    def catalog(self) -> List[dict]:
        """Per-tenant rows for GET /debug/tenants and the CLI."""
        counts = self.tuple_counts()
        out = []
        with self._lock:
            for nid in sorted(self._tenants):
                t = self._tenants[nid]
                out.append({
                    "id": nid,
                    "default": nid == self.default_network,
                    "tuples": counts.get(nid, 0),
                    "checks": t.checks,
                    "writes": t.writes,
                    "shed": t.shed,
                    "opl_override": t.override is not None,
                    "quotas": t.quotas.stats(),
                    "created_at": t.created_at,
                })
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "tenants": len(self._tenants),
                "max_tenants": self.max_tenants,
                "ns_version": self.ns_version,
                "default_network": self.default_network,
            }

    # -- metrics (bounded cardinality) ---------------------------------------

    def publish(self, metrics) -> None:
        """Emit per-tenant series for the top-K tenants by lifetime check
        traffic; every other tenant folds into ``tenant="other"`` so the
        scrape cardinality is bounded by K+1 regardless of fleet size."""
        counts = self.tuple_counts()
        with self._lock:
            tenants = list(self._tenants.values())
        tenants.sort(key=lambda t: t.checks, reverse=True)
        top = tenants[:max(1, self.metrics_top_k)]
        rest = tenants[len(top):]
        metrics.gauge(
            "keto_tenant_count", float(len(tenants)),
            help="live tenants on the plane",
        )
        rows = [(t.nid, t.checks, t.writes, t.shed,
                 counts.get(t.nid, 0)) for t in top]
        if rest:
            rows.append((
                "other",
                sum(t.checks for t in rest),
                sum(t.writes for t in rest),
                sum(t.shed for t in rest),
                sum(counts.get(t.nid, 0) for t in rest),
            ))
        for nid, checks, writes, shed, tuples in rows:
            metrics.gauge(
                "keto_tenant_tuples", float(tuples),
                help="live relation tuples per tenant (top-K + other)",
                tenant=nid,
            )
            for name, total, hlp in (
                ("keto_tenant_checks_total", checks,
                 "checks served per tenant (top-K + other)"),
                ("keto_tenant_writes_total", writes,
                 "tuple mutations per tenant (top-K + other)"),
                ("keto_tenant_shed_total", shed,
                 "requests shed by per-tenant quotas (top-K + other)"),
            ):
                prev = self._published.get((name, nid), 0.0)
                if total > prev:
                    metrics.counter(name, float(total - prev),
                                    help=hlp, tenant=nid)
                    self._published[(name, nid)] = float(total)

"""Tenant plane: thousands of isolated stores on one device engine.

The port of the JAX package's ``tenancy/`` (host code; no kernel of its
own).  Ory Network runs Keto multi-tenant with a per-request
``Contextualizer`` resolving ``X-Keto-Network`` into a network id and
``nid``-scoped rows (Keto's ``persistence/sql/persister.go``); Zanzibar
itself is one shared service for every client namespace.  This package
serves that model on one device engine: one set of device tables holds
every tenant.

The core trick is namespace qualification.  A tenant's tuples live in a
single shared ("fused") store under the namespace ``f"{nid}\\x1f{ns}"``
— the unit separator can never appear in a client namespace, so the
qualified name space is collision-free.  Because node identity in the
device projection is (namespace, object, relation), qualifying the
namespace qualifies every vocab id, CSR row, Leopard closure pair and
cache key at once: cross-tenant leakage is impossible by construction
rather than filtered after the fact.  Tenant create/reload/delete
changes the namespace-config fingerprint, so the engine's next batch
re-projects.  Every tenant adds its namespaces to the vocabulary, so at
thousands of tenants the padded namespace dim passes 2^11 and a batch of
more than a few thousand queries packs its frontiers by sort
(``fastpath._pack_sort``): the (query, namespace, relation) key no longer
fits 31 bits.

Per-tenant surfaces are facades over the shared machinery:

* :class:`~ketotpu_torch.tenancy.store.TenantStoreView` — the storage
  contract (rows/changelog/log_head in GLOBAL changelog coordinates,
  filtered per tenant — the same contract the SQL stores' ``nid`` column
  implements);
* ``TenantCheckEngine`` — qualifies checks/blocks before the shared
  engine, so batches mix tenants while identical keys from different
  tenants stay distinct;
* :class:`~ketotpu_torch.tenancy.quota.TenantQuotas` — token buckets for
  inflight check units, write rate, and tuple count; a tenant's batch
  flood sheds inside its own budget (429).
"""

from ketotpu_torch.tenancy.plane import (  # noqa: F401
    SEP,
    TenantCheckEngine,
    TenantPlane,
    qualify_ns,
    split_ns,
)
from ketotpu_torch.tenancy.quota import TenantQuotas, TokenBucket  # noqa: F401
from ketotpu_torch.tenancy.store import TenantStoreView  # noqa: F401

"""Synthetic Drive-style permission graphs for benchmarks and dry runs.

Models the BASELINE benchmark shapes: a folder tree with viewer/owner
assignments (some through group subject-sets), documents under folders, and
`view` permissions that chain computed-userset + tuple-to-userset rewrites up
the tree (the "5-hop rewrites" workload).  Mirrors the reference's deep/wide
benchmark generators (internal/check/bench_test.go:56-133) in spirit, at
configurable scale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ketotpu_torch.api.types import RelationTuple, SubjectID, SubjectSet
from ketotpu_torch.opl.parser import parse
from ketotpu_torch.storage.memory import InMemoryTupleStore
from ketotpu_torch.storage.namespaces import StaticNamespaceManager

SYNTH_OPL = """
import { Namespace, SubjectSet, Context } from "@ory/keto-namespace-types"

class User implements Namespace {}

class Group implements Namespace {
  related: {
    members: (User | Group)[]
  }
}

class Folder implements Namespace {
  related: {
    parents: Folder[]
    viewers: (User | SubjectSet<Group, "members">)[]
    owners: (User | SubjectSet<Group, "members">)[]
  }
  permits = {
    own: (ctx: Context): boolean =>
      this.related.owners.includes(ctx.subject) ||
      this.related.parents.traverse((p) => p.permits.own(ctx)),
    view: (ctx: Context): boolean =>
      this.related.viewers.includes(ctx.subject) ||
      this.permits.own(ctx) ||
      this.related.parents.traverse((p) => p.permits.view(ctx)),
  }
}

class Doc implements Namespace {
  related: {
    parents: Folder[]
    viewers: (User | SubjectSet<Group, "members">)[]
    owners: (User | SubjectSet<Group, "members">)[]
    banned: User[]
  }
  permits = {
    view: (ctx: Context): boolean =>
      this.related.viewers.includes(ctx.subject) ||
      this.related.owners.includes(ctx.subject) ||
      this.related.parents.traverse((p) => p.permits.view(ctx)),
    edit: (ctx: Context): boolean =>
      !this.related.banned.includes(ctx.subject) &&
      this.permits.view(ctx),
  }
}
"""


@dataclass
class SynthGraph:
    store: InMemoryTupleStore
    manager: StaticNamespaceManager
    users: List[str]
    docs: List[str]
    folders: List[str]
    groups: List[str] = None


def build_synth(
    *,
    n_users: int = 100,
    n_groups: int = 10,
    n_folders: int = 50,
    n_docs: int = 200,
    fanout: int = 4,
    seed: int = 0,
) -> SynthGraph:
    """Folder tree of degree ``fanout``; docs attach to random folders;
    viewers/owners assigned directly and through groups."""
    rng = np.random.default_rng(seed)
    namespaces, errors = parse(SYNTH_OPL)
    assert not errors, errors
    manager = StaticNamespaceManager(namespaces)
    store = InMemoryTupleStore()

    users = [f"u{i}" for i in range(n_users)]
    groups = [f"g{i}" for i in range(n_groups)]
    folders = [f"f{i}" for i in range(n_folders)]
    docs = [f"d{i}" for i in range(n_docs)]
    tuples: List[RelationTuple] = []

    def t(ns, obj, rel, subj):
        tuples.append(RelationTuple(ns, obj, rel, subj))

    # group membership: users spread over groups; a few nested groups
    for i, u in enumerate(users):
        t("Group", groups[i % n_groups], "members", SubjectID(u))
    for i in range(1, n_groups, 3):
        t("Group", groups[i - 1], "members", SubjectSet("Group", groups[i], "members"))

    # folder tree rooted at f0
    for i in range(1, n_folders):
        t("Folder", folders[i], "parents", SubjectSet("Folder", folders[(i - 1) // fanout]))
    # scatter viewers/owners on folders: direct users and group sets
    for i, f in enumerate(folders):
        if i % 3 == 0:
            t("Folder", f, "viewers", SubjectID(users[int(rng.integers(n_users))]))
        if i % 5 == 0:
            t("Folder", f, "owners", SubjectID(users[int(rng.integers(n_users))]))
        if i % 4 == 0:
            t("Folder", f, "viewers",
              SubjectSet("Group", groups[int(rng.integers(n_groups))], "members"))

    # docs under folders with occasional direct grants
    for i, d in enumerate(docs):
        t("Doc", d, "parents", SubjectSet("Folder", folders[int(rng.integers(n_folders))]))
        if i % 7 == 0:
            t("Doc", d, "viewers", SubjectID(users[int(rng.integers(n_users))]))
        if i % 11 == 0:
            t("Doc", d, "owners", SubjectID(users[int(rng.integers(n_users))]))
        if i % 13 == 0:
            # exclusion targets for the AND/NOT `edit` permit
            t("Doc", d, "banned", SubjectID(users[int(rng.integers(n_users))]))

    store.write_relation_tuples(*tuples)
    return SynthGraph(
        store=store, manager=manager, users=users, docs=docs,
        folders=folders, groups=groups,
    )


def synth_queries(
    graph: SynthGraph, n: int, *, seed: int = 1
) -> List[RelationTuple]:
    """Mixed doc-view checks: random (doc, user) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = graph.docs[int(rng.integers(len(graph.docs)))]
        u = graph.users[int(rng.integers(len(graph.users)))]
        out.append(RelationTuple("Doc", d, "view", SubjectID(u)))
    return out


def synth_queries_mixed(
    graph: SynthGraph,
    n: int,
    *,
    seed: int = 1,
    general_frac: float = 0.3,
    subject_set_frac: float = 0.15,
) -> List[RelationTuple]:
    """BASELINE config #4's query shape: mixed (subject_id, subject_set)
    queries with a slice hitting the intersection/exclusion `edit` permit
    (the AND/NOT general path)."""
    rng = np.random.default_rng(seed)
    out = []
    groups = graph.groups or []
    for _ in range(n):
        d = graph.docs[int(rng.integers(len(graph.docs)))]
        rel = "edit" if rng.random() < general_frac else "view"
        if groups and rng.random() < subject_set_frac:
            subject = SubjectSet(
                "Group", groups[int(rng.integers(len(groups)))], "members"
            )
        else:
            subject = SubjectID(
                graph.users[int(rng.integers(len(graph.users)))]
            )
        out.append(RelationTuple("Doc", d, rel, subject))
    return out


def build_deep_groups(
    *,
    depth: int = 12,
    n_chains: int = 8,
    n_users: int = 64,
    seed: int = 0,
) -> SynthGraph:
    """Deep nested-group chains for the Leopard deep-check workload.

    ``n_chains`` independent chains of ``depth`` groups each:
    ``gc_0.members`` contains ``gc_1#members`` contains ... down to
    ``gc_{depth-1}``, whose members are direct users.  A check
    ``Group:gc_0#members@user`` therefore needs ``depth`` containment hops —
    the shape where the closure index replaces a BFS level per hop with one
    binary search.  The graph is rewrite-free and narrow, so every node is
    clean and closure verdicts carry the whole workload (zero fallbacks).
    """
    rng = np.random.default_rng(seed)
    namespaces, errors = parse(SYNTH_OPL)
    assert not errors, errors
    manager = StaticNamespaceManager(namespaces)
    store = InMemoryTupleStore()

    users = [f"u{i}" for i in range(n_users)]
    groups: List[str] = []
    tuples: List[RelationTuple] = []
    for c in range(n_chains):
        chain = [f"g{c}_{d}" for d in range(depth)]
        groups.extend(chain)
        for d in range(depth - 1):
            tuples.append(RelationTuple(
                "Group", chain[d], "members",
                SubjectSet("Group", chain[d + 1], "members"),
            ))
        # users land in the deepest group of a random subset of chains
        for u in users:
            if rng.random() < 0.5:
                tuples.append(RelationTuple(
                    "Group", chain[-1], "members", SubjectID(u)))
    store.write_relation_tuples(*tuples)
    return SynthGraph(
        store=store, manager=manager, users=users, docs=[],
        folders=[], groups=groups,
    )


def deep_queries(
    graph: SynthGraph, n: int, *, depth: int = 12, seed: int = 1
) -> List[RelationTuple]:
    """Checks against chain roots: each needs ``depth`` containment hops."""
    rng = np.random.default_rng(seed)
    roots = [g for g in (graph.groups or []) if g.endswith("_0")]
    out = []
    for _ in range(n):
        g = roots[int(rng.integers(len(roots)))]
        u = graph.users[int(rng.integers(len(graph.users)))]
        out.append(RelationTuple("Group", g, "members", SubjectID(u)))
    return out


def build_synth_columnar(
    *,
    n_users: int = 1_200_000,
    n_groups: int = 25_000,
    n_folders: int = 500_000,
    n_docs: int = 6_500_000,
    fanout: int = 4,
    seed: int = 0,
) -> SynthGraph:
    """The 10M-tuple-scale synth graph, built columnar (VERDICT r2 #4).

    Same shape as `build_synth` (folder tree, group subject-sets, CSS+TTU
    view chains) but every tuple is generated directly as vectorized id
    columns into a `ColumnarTupleStore` — no per-tuple Python objects, so
    a 10M-tuple graph loads in seconds instead of minutes and the engine
    adopts the columns wholesale (`export_columns`).
    """
    from ketotpu_torch.storage.columnar import ColumnarTupleStore

    rng = np.random.default_rng(seed)
    namespaces, errors = parse(SYNTH_OPL)
    assert not errors, errors
    manager = StaticNamespaceManager(namespaces)

    users = [f"u{i}" for i in range(n_users)]
    groups = [f"g{i}" for i in range(n_groups)]
    folders = [f"f{i}" for i in range(n_folders)]
    docs = [f"d{i}" for i in range(n_docs)]

    # deterministic dense id assignment, interners built in bulk
    from ketotpu_torch.engine.vocab import Vocab

    v = Vocab()
    v.namespaces._ids = {"Group": 0, "Folder": 1, "Doc": 2}
    objs = {}
    for name in groups:
        objs[name] = len(objs)
    for name in folders:
        objs[name] = len(objs)
    for name in docs:
        objs[name] = len(objs)
    v.objects._ids = objs
    # "" is pre-interned at id 0 (Vocab __init__)
    R_EMPTY = v.relations.intern("")
    R_MEMBERS = v.relations.intern("members")
    R_PARENTS = v.relations.intern("parents")
    R_VIEWERS = v.relations.intern("viewers")
    R_OWNERS = v.relations.intern("owners")
    R_BANNED = v.relations.intern("banned")
    subs = {f"id:{u}": i for i, u in enumerate(users)}
    for g in groups:
        subs[f"set:Group:{g}#members"] = len(subs)
    for f in folders:
        subs[f"set:Folder:{f}#"] = len(subs)
    v.subjects._ids = subs

    U, G, F = n_users, n_groups, n_folders
    NS_G, NS_F, NS_D = 0, 1, 2
    OBJ_G, OBJ_F, OBJ_D = 0, G, G + F  # object-id bases per family
    SUB_GSET, SUB_FSET = U, U + G  # subject-id bases for set subjects

    segs = []

    def seg(ns, obj, rel, subj, is_set, s_ns, s_obj, s_rel):
        n = len(obj)
        segs.append({
            "ns": np.full(n, ns, np.int32),
            "obj": np.asarray(obj, np.int32),
            "rel": np.full(n, rel, np.int32),
            "subj": np.asarray(subj, np.int32),
            "is_set": np.full(n, is_set, np.int32),
            "s_ns": np.full(n, s_ns, np.int32) if np.isscalar(s_ns)
            else np.asarray(s_ns, np.int32),
            "s_obj": np.full(n, s_obj, np.int32) if np.isscalar(s_obj)
            else np.asarray(s_obj, np.int32),
            "s_rel": np.full(n, s_rel, np.int32),
        })

    # group membership: users spread over groups
    ui = np.arange(U, dtype=np.int64)
    seg(NS_G, OBJ_G + ui % G, R_MEMBERS, ui, 0, -1, -1, -1)
    # nested groups every 3rd
    gi = np.arange(1, G, 3, dtype=np.int64)
    seg(NS_G, OBJ_G + gi - 1, R_MEMBERS, SUB_GSET + gi, 1,
        NS_G, OBJ_G + gi, R_MEMBERS)
    # folder tree rooted at f0
    fi = np.arange(1, F, dtype=np.int64)
    parents = (fi - 1) // fanout
    seg(NS_F, OBJ_F + fi, R_PARENTS, SUB_FSET + parents, 1,
        NS_F, OBJ_F + parents, R_EMPTY)
    # folder viewers/owners: direct users and group sets
    f3 = np.arange(0, F, 3, dtype=np.int64)
    seg(NS_F, OBJ_F + f3, R_VIEWERS,
        rng.integers(U, size=len(f3)), 0, -1, -1, -1)
    f5 = np.arange(0, F, 5, dtype=np.int64)
    seg(NS_F, OBJ_F + f5, R_OWNERS,
        rng.integers(U, size=len(f5)), 0, -1, -1, -1)
    f4 = np.arange(0, F, 4, dtype=np.int64)
    g4 = rng.integers(G, size=len(f4))
    seg(NS_F, OBJ_F + f4, R_VIEWERS, SUB_GSET + g4, 1,
        NS_G, OBJ_G + g4, R_MEMBERS)
    # docs under folders with occasional direct grants
    di = np.arange(n_docs, dtype=np.int64)
    df = rng.integers(F, size=n_docs)
    seg(NS_D, OBJ_D + di, R_PARENTS, SUB_FSET + df, 1,
        NS_F, OBJ_F + df, R_EMPTY)
    d7 = np.arange(0, n_docs, 7, dtype=np.int64)
    seg(NS_D, OBJ_D + d7, R_VIEWERS,
        rng.integers(U, size=len(d7)), 0, -1, -1, -1)
    d11 = np.arange(0, n_docs, 11, dtype=np.int64)
    seg(NS_D, OBJ_D + d11, R_OWNERS,
        rng.integers(U, size=len(d11)), 0, -1, -1, -1)
    d13 = np.arange(0, n_docs, 13, dtype=np.int64)
    seg(NS_D, OBJ_D + d13, R_BANNED,
        rng.integers(U, size=len(d13)), 0, -1, -1, -1)

    cols = {
        k: np.concatenate([s[k] for s in segs])
        for k in ("ns", "obj", "rel", "subj", "is_set", "s_ns", "s_obj",
                  "s_rel")
    }
    store = ColumnarTupleStore(v)
    store.bulk_load_ids(cols)
    return SynthGraph(
        store=store, manager=manager, users=users, docs=docs,
        folders=folders, groups=groups,
    )

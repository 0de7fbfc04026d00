"""Shared inputs of the port's parity tests (tests/test_torch_*.py).

Everything here is numpy and plain Python: each test feeds the same arrays
to the JAX package and to its PyTorch port and compares the outputs at
tolerance 0.  ``release_jax_caches`` is the one fixture: each parity module
that runs JAX programs imports it.
"""

import gc
import pathlib

import numpy as np
import pytest

FIXTURES = pathlib.Path(__file__).parent / "fixtures"

#: the small columnar synth graph: 10,405 tuples, built in well under a
#: second, tables inside the hash build's small-table regime
SMALL_SYNTH = dict(n_users=2000, n_groups=200, n_folders=1000, n_docs=5000)


@pytest.fixture(scope="module", autouse=True)
def release_jax_caches():
    """Drop the JAX reference's traces and compiled programs when a parity
    module ends.  They hold several hundred thousand Python objects; a
    worker that goes on to run other test files would otherwise pay for
    them in every full garbage collection, which stalls the timing-bound
    serving tests that share the process."""
    yield
    import jax

    jax.clear_caches()
    gc.collect()


#: rewrites-example tuples (the namespaces are
#: fixtures/rewrites_namespaces.keto.ts)
REWRITES_TUPLES = [
    "Group:dev#members@bob",
    "Group:admin#members@alice",
    "Group:admin#members@Group:dev#members",
    "Folder:keto#viewers@Group:dev#members",
    "Folder:keto#parents@Folder:root",
    "Folder:root#viewers@Group:admin#members",
    "File:keto/README.md#parents@Folder:keto",
    "File:keto/README.md#owners@carol",
    "File:private#owners@Group:admin#members",
]

REWRITES_QUERIES = [
    "Group:dev#members@bob",
    "Group:admin#members@bob",
    "File:keto/README.md#view@bob",
    "File:keto/README.md#view@alice",
    "File:keto/README.md#view@eve",
    "File:keto/README.md#view@carol",
    "File:keto/README.md#edit@carol",
    "File:private#edit@bob",
    "File:private#view@alice",
    "Folder:keto#view@alice",
    "Folder:root#view@bob",
    "Unknown:x#view@bob",
]


def cat_videos_tuples():
    """The cat-videos example's relation tuples (JSON files)."""
    import json

    out = []
    for p in sorted((FIXTURES / "cat-videos" / "relation-tuples").glob("*.json")):
        d = json.loads(p.read_text())
        d.pop("$schema", None)
        out.append(d)
    return out


CAT_VIDEOS_QUERIES = [
    "videos:/cats/1.mp4#view@*",
    "videos:/cats/1.mp4#owner@cat lady",
    "videos:/cats/2.mp4#view@cat lady",
    "videos:/cats/2.mp4#view@*",
    "videos:/cats/1.mp4#view@nobody",
    "videos:/cats#owner@cat lady",
]


def pure_or_case(rng):
    """Random pure-OR config + graph: unions of includes / traverse chains."""
    n_ns = int(rng.integers(2, 4))
    names = [f"N{i}" for i in range(n_ns)]
    lines = ["import { Namespace, SubjectSet, Context } from '@ory/keto-namespace-types'"]
    rels = ["r0", "r1"]
    perms = ["p0", "p1"]
    for name in names:
        # only namespaces with permits in the types: traverse() type-checks
        # against every declared type (typechecks.go); plain subject-id
        # tuples need no type declaration at non-strict runtime
        related = "\n".join(
            f"    {r}: ({' | '.join(names)})[]" for r in rels
        )
        choices = [
            "this.related.r0.includes(ctx.subject)",
            "this.related.r1.includes(ctx.subject)",
            "this.related.r0.traverse((x) => x.permits.p1(ctx))",
            "this.related.r1.traverse((x) => x.permits.p0(ctx))",
            "this.permits.p1(ctx)",
        ]
        e0 = " || ".join(
            rng.choice(choices, size=int(rng.integers(1, 4)), replace=False).tolist()
        )
        e1 = " || ".join(
            rng.choice(choices[:2], size=int(rng.integers(1, 3)), replace=False).tolist()
        )
        lines.append(
            f"class {name} implements Namespace {{\n"
            f"  related: {{\n{related}\n  }}\n"
            f"  permits = {{\n"
            f"    p0: (ctx: Context): boolean =>\n      {e0},\n"
            f"    p1: (ctx: Context): boolean =>\n      {e1},\n"
            f"  }}\n}}"
        )
    lines.insert(1, "class User implements Namespace {}")
    source = "\n".join(lines)

    objects = [f"o{i}" for i in range(5)]
    users = [f"u{i}" for i in range(4)]
    tuples = set()
    for _ in range(int(rng.integers(8, 40))):
        ns = str(rng.choice(names))
        obj = str(rng.choice(objects))
        rel = str(rng.choice(rels))
        if rng.random() < 0.5:
            subj = str(rng.choice(users))
        else:
            subj = f"{rng.choice(names)}:{rng.choice(objects)}#{rng.choice(rels)}"
        tuples.add(f"{ns}:{obj}#{rel}@{subj}")

    queries = [
        f"{rng.choice(names)}:{rng.choice(objects)}"
        f"#{rng.choice(rels + perms)}@{rng.choice(users)}"
        for _ in range(25)
    ]
    return source, sorted(tuples), queries


def granted_checks(store, n: int, seed: int):
    """Doc#view checks the synth graph grants (as strings): a direct viewer
    of the doc, or a viewer user of the doc's parent folder."""
    from ketotpu.api.types import RelationQuery, SubjectID

    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        d = f"d{7 * int(rng.integers(700))}"  # SMALL_SYNTH docs below 4900
        rows, _ = store.get_relation_tuples(
            RelationQuery(namespace="Doc", object=d, relation="viewers"))
        out.extend(f"Doc:{d}#view@{t.subject.id}" for t in rows)
        parents, _ = store.get_relation_tuples(
            RelationQuery(namespace="Doc", object=d, relation="parents"))
        for p in parents:
            fv, _ = store.get_relation_tuples(RelationQuery(
                namespace="Folder", object=p.subject.object, relation="viewers"))
            out.extend(f"Doc:{d}#view@{v.subject.id}" for v in fv
                       if isinstance(v.subject, SubjectID))
    return out[:n]


#: the tier-2 fixture: intersection and exclusion (the JAX engine tests'
#: OPL_ANDNOT shapes), a NOT chain, a subject-set relation whose children
#: are AND/NOT permits (they enter the visited set), a tainted folder
#: recursion deeper than a few skeleton levels, and a subject set into an
#: undeclared relation (a client error mid-traversal)
ALGEBRA_OPL = """
import { Namespace, SubjectSet, Context } from "@ory/keto-namespace-types"

class User implements Namespace {}

class Team implements Namespace {
  related: {
    members: User[]
    suspended: User[]
  }
  permits = {
    active: (ctx: Context): boolean =>
      this.related.members.includes(ctx.subject) &&
      !this.related.suspended.includes(ctx.subject),
  }
}

class Folder implements Namespace {
  related: {
    parents: Folder[]
    owners: User[]
    banned: User[]
  }
  permits = {
    manage: (ctx: Context): boolean =>
      (this.related.owners.includes(ctx.subject) &&
        !this.related.banned.includes(ctx.subject)) ||
      this.related.parents.traverse((p) => p.permits.manage(ctx)),
  }
}

class Doc implements Namespace {
  related: {
    editors: User[]
    signers: User[]
    banned: User[]
    crew: (User | SubjectSet<Team, "members">)[]
    viewers: (User | SubjectSet<Team, "members">)[]
  }
  permits = {
    finalize: (ctx: Context): boolean =>
      this.related.editors.includes(ctx.subject) &&
      this.related.signers.includes(ctx.subject),
    edit: (ctx: Context): boolean =>
      this.related.editors.includes(ctx.subject) &&
      !this.related.banned.includes(ctx.subject),
    locked: (ctx: Context): boolean =>
      !this.related.signers.includes(ctx.subject),
    open: (ctx: Context): boolean => !this.permits.locked(ctx),
    staff: (ctx: Context): boolean => this.related.crew.includes(ctx.subject),
    seen: (ctx: Context): boolean => this.related.viewers.includes(ctx.subject),
    c1: (ctx: Context): boolean =>
      this.permits.c2(ctx) && this.related.signers.includes(ctx.subject),
    c2: (ctx: Context): boolean =>
      this.permits.seen(ctx) && this.related.signers.includes(ctx.subject),
  }
}
"""


def algebra_tuples():
    out = [
        "Doc:a#editors@alice", "Doc:a#signers@alice", "Doc:a#editors@bob",
        "Doc:a#banned@bob", "Doc:b#signers@carol", "Doc:w#crew@dan",
        "Doc:e#crew@Folder:f0#nosuch",
    ]
    for i in range(24):
        out.append(f"Doc:w#crew@Team:t{i}#active")
        out.append(f"Team:t{i}#members@u{i}")
        out.append(f"Team:t{i}#members@u{i + 1}")
        if i % 3 == 0:
            out.append(f"Team:t{i}#suspended@u{i}")
    for k in range(8):
        out.append(f"Folder:f{k}#parents@Folder:f{k + 1}")
    out += ["Folder:f8#owners@dave", "Folder:f5#owners@erin",
            "Folder:f3#banned@erin", "Folder:f6#owners@frank"]
    # a pure permit behind two nested ANDs: a leaf that is not trivial (it
    # has a rewrite) on the last level of a six-level skeleton
    out += ["Doc:a#viewers@Team:t1#members", "Doc:a#signers@u1"]
    # two subject sets under one scope that share a member: the second
    # visit of Team:t1#active is a key the visited set has already seen
    out += ["Doc:v#crew@Doc:v1#crew", "Doc:v#crew@Doc:v2#crew",
            "Doc:v1#crew@Team:t1#active", "Doc:v2#crew@Team:t1#active"]
    return out


#: query batches over the tier-2 fixture, each reaching one edge
ALGEBRA_BATCHES = {
    "andnot": [f"Doc:{d}#{r}@{u}" for d in "ab"
               for r in ("finalize", "edit", "locked", "open")
               for u in ("alice", "bob", "carol")],
    "visited": [f"Doc:w#staff@u{j}" for j in (0, 1, 2, 5, 9, 25)]
               + ["Doc:w#staff@dan"],
    "error": ["Doc:e#staff@alice", "Doc:a#edit@alice"],
    "depth": ["Folder:f0#manage@dave", "Folder:f7#manage@dave",
              "Folder:f4#manage@erin", "Folder:f2#manage@frank",
              "Doc:a#c1@u1", "Doc:a#c1@alice"],
    "flood": [f"Doc:w#staff@u{j % 30}" for j in range(60)]
             + ["Doc:a#edit@alice", "Doc:a#open@alice"],
    "dedup": ["Doc:v#staff@u2", "Doc:v#staff@u3"],
}


# -- the tenant plane (tests/test_torch_tenancy.py, test_torch_packsort.py) ----

#: relations each tenant's own OPL renames with its index: two relation
#: names per tenant, so the relation vocabulary grows with the plane
TENANT_RENAMED = ("viewers", "owners")
#: one tenant's tiny synth graph (build_synth's shape)
TENANT_SYNTH = dict(n_users=4, n_groups=2, n_folders=3, n_docs=5)


def tenant_ids(n: int):
    return [f"t{i:03d}" for i in range(n)]


def tenant_opl(base_opl: str, i: int) -> str:
    """Tenant i's own OPL: the synth OPL with its relations renamed."""
    for rel in TENANT_RENAMED:
        base_opl = base_opl.replace(rel, f"{rel}{i}")
    return base_opl


def tenant_tuples(i: int):
    """Tenant i's tuples (unqualified strings): a tiny synth graph seeded
    by i, under the renamed relations of :func:`tenant_opl`."""
    from ketotpu_torch.utils.synth import build_synth

    g = build_synth(seed=i, **TENANT_SYNTH)
    out = []
    for t in g.store.all_tuples():
        s = str(t)
        for rel in TENANT_RENAMED:
            s = s.replace(f"#{rel}@", f"#{rel}{i}@")
        out.append(s)
    return out


def fill_plane(plane, tuple_from_string, base_opl: str, n: int) -> None:
    """Give ``plane`` n tenants, each with its own OPL and its tuples
    written through its store view (either package's plane)."""
    for i, nid in enumerate(tenant_ids(n)):
        plane.set_opl(nid, tenant_opl(base_opl, i))
        plane.view_for(nid).write_relation_tuples(
            *[tuple_from_string(s) for s in tenant_tuples(i)])


def tenant_queries(n_tenants: int, n: int, seed: int):
    """Qualified check strings over the plane of :func:`fill_plane`:
    Doc#view and Group#members rows of random tenants, users and objects
    (the tiny graphs grant a good share of them)."""
    sep = "\x1f"
    rng = np.random.default_rng(seed)
    nids = tenant_ids(n_tenants)
    out = []
    for _ in range(n):
        nid = nids[int(rng.integers(n_tenants))]
        u = f"u{int(rng.integers(TENANT_SYNTH['n_users']))}"
        if rng.random() < 0.75:
            d = int(rng.integers(TENANT_SYNTH["n_docs"]))
            out.append(f"{nid}{sep}Doc:d{d}#view@{u}")
        else:
            g = int(rng.integers(TENANT_SYNTH["n_groups"]))
            out.append(f"{nid}{sep}Group:g{g}#members@{u}")
    return out

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

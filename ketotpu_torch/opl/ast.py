"""Namespace configuration AST.

Parity with the reference AST (`internal/namespace/ast/ast_definitions.go:8-71`
and `internal/namespace/definitions.go:15-34`): a namespace has relations, a
relation has subject types and an optional subject-set rewrite tree of n-ary
or/and nodes over computed-subject-set, tuple-to-subject-set, and
invert-result leaves.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Union


class Operator(enum.IntEnum):
    OR = 0
    AND = 1

    def __str__(self) -> str:
        return "or" if self is Operator.OR else "and"


@dataclass(frozen=True)
class RelationType:
    """A permitted subject type: a namespace, or a subject set ns#relation."""

    namespace: str
    relation: str = ""  # optional; non-empty means SubjectSet<namespace, relation>


@dataclass(frozen=True)
class ComputedSubjectSet:
    """Rewrite to the same object's ``relation`` userset."""

    relation: str


@dataclass(frozen=True)
class TupleToSubjectSet:
    """Indirect via tuples: for each subject set S of obj#relation, check
    S.object#computed_subject_set_relation."""

    relation: str
    computed_subject_set_relation: str


@dataclass
class InvertResult:
    """Inverts the check result of the child (the ``!`` operator)."""

    child: "Child"


@dataclass
class SubjectSetRewrite:
    """N-ary or/and over rewrite children."""

    operation: Operator = Operator.OR
    children: List["Child"] = field(default_factory=list)


Child = Union[SubjectSetRewrite, ComputedSubjectSet, TupleToSubjectSet, InvertResult]


def as_rewrite(child: Child) -> SubjectSetRewrite:
    """Wrap a child in a top-level rewrite (relations always hold a rewrite
    root, even for a single parsed child) — ast_definitions.go:62-71."""
    if isinstance(child, SubjectSetRewrite):
        return child
    return SubjectSetRewrite(operation=Operator.OR, children=[child])


@dataclass
class Relation:
    name: str
    types: List[RelationType] = field(default_factory=list)
    subject_set_rewrite: Optional[SubjectSetRewrite] = None


@dataclass
class Namespace:
    name: str
    relations: List[Relation] = field(default_factory=list)

    def relation(self, name: str) -> Optional[Relation]:
        for r in self.relations:
            if r.name == name:
                return r
        return None


# -- JSON (debug / config surface) -----------------------------------------


def child_to_json(c: Child) -> dict:
    if isinstance(c, SubjectSetRewrite):
        return {
            "operator": str(c.operation),
            "children": [child_to_json(ch) for ch in c.children],
        }
    if isinstance(c, ComputedSubjectSet):
        return {"relation": c.relation}
    if isinstance(c, TupleToSubjectSet):
        return {
            "relation": c.relation,
            "computed_subject_set_relation": c.computed_subject_set_relation,
        }
    if isinstance(c, InvertResult):
        return {"inverted": child_to_json(c.child)}
    raise TypeError(f"unknown rewrite child {type(c)!r}")


def relation_to_json(r: Relation) -> dict:
    d: dict = {"name": r.name}
    if r.types:
        d["types"] = [
            {"namespace": t.namespace, **({"relation": t.relation} if t.relation else {})}
            for t in r.types
        ]
    if r.subject_set_rewrite is not None:
        d["rewrite"] = child_to_json(r.subject_set_rewrite)
    return d

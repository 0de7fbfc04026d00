"""Batched one-hop traversal primitives.

These are the check engine's hot-path queries, with the same contract as the
reference's SQL traverser (`internal/persistence/sql/traverser.go:51-191`):

* ``traverse_subject_set_expansion``: all subject-set children of
  ``obj#relation``, each annotated with a *found* bit — whether the target
  subject is a direct member of that child — short-circuiting after the first
  found child.
* ``traverse_subject_set_rewrite``: the OR-of-computed-subject-sets shortcut —
  one probe across ``relation IN (...)``; on miss, returns the rewritten
  candidate tuples for another hop.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

from ketotpu_torch.api.types import RelationQuery, RelationTuple, SubjectSet
from ketotpu_torch.storage.memory import InMemoryTupleStore
from ketotpu_torch.storage.namespaces import NamespaceManager, ast_relation_for


class TraversalDirection(enum.Enum):
    # reference: internal/relationtuple/definitions.go:66-72
    SUBJECT_SET_EXPAND = "subject set expand"
    COMPUTED_USERSET = "computed userset"
    TUPLE_TO_USERSET = "tuple to userset"


@dataclass
class TraversalResult:
    from_: RelationTuple
    to: RelationTuple
    via: TraversalDirection
    found: bool


class Traverser:
    def __init__(
        self,
        store: InMemoryTupleStore,
        namespace_manager: Optional[NamespaceManager] = None,
        *,
        strict_mode: bool = False,
    ):
        self.store = store
        self.namespace_manager = namespace_manager
        self.strict_mode = strict_mode

    def traverse_subject_set_expansion(
        self, start: RelationTuple
    ) -> List[TraversalResult]:
        """traverser.go:53-121.  The *to* tuples carry the start subject so
        the engine can recurse on them directly."""
        res: List[TraversalResult] = []
        page_token = ""
        while True:
            rows, page_token = self.store.get_relation_tuples(
                RelationQuery(
                    namespace=start.namespace,
                    object=start.object,
                    relation=start.relation,
                ),
                page_token=page_token,
                page_size=1000,
            )
            for row in rows:
                if not isinstance(row.subject, SubjectSet):
                    continue
                child = row.subject
                found = self.store.exists_relation_tuples(
                    RelationQuery(
                        namespace=child.namespace,
                        object=child.object,
                        relation=child.relation,
                    ).with_subject(start.subject)
                )
                res.append(
                    TraversalResult(
                        from_=start,
                        to=RelationTuple(
                            namespace=child.namespace,
                            object=child.object,
                            relation=child.relation,
                            subject=start.subject,
                        ),
                        via=TraversalDirection.SUBJECT_SET_EXPAND,
                        found=found,
                    )
                )
                if found:
                    return res
            if not page_token:
                return res

    def traverse_subject_set_rewrite(
        self, start: RelationTuple, computed_subject_set_relations: List[str]
    ) -> List[TraversalResult]:
        """traverser.go:123-191."""
        relations = []
        for relation in computed_subject_set_relations:
            ast_rel = None
            if self.namespace_manager is not None:
                try:
                    ast_rel = ast_relation_for(
                        self.namespace_manager, start.namespace, relation
                    )
                except Exception:
                    ast_rel = None
            # In strict mode, skip relations that have their own rewrites --
            # those rewrites are applied in memory instead (traverser.go:135-140).
            if self.strict_mode and ast_rel is not None \
                    and ast_rel.subject_set_rewrite is not None:
                continue
            relations.append(relation)

        if relations:
            for relation in relations:
                hit, _ = self.store.get_relation_tuples(
                    RelationQuery(
                        namespace=start.namespace,
                        object=start.object,
                        relation=relation,
                    ).with_subject(start.subject),
                    page_size=1,
                )
                if hit:
                    return [
                        TraversalResult(
                            from_=start,
                            to=hit[0],
                            via=TraversalDirection.COMPUTED_USERSET,
                            found=True,
                        )
                    ]

        # Otherwise the next candidates are ALL rewritten relations -- the
        # unfiltered input list, as in traverser.go:176-188.
        return [
            TraversalResult(
                from_=start,
                to=RelationTuple(
                    namespace=start.namespace,
                    object=start.object,
                    relation=relation,
                    subject=start.subject,
                ),
                via=TraversalDirection.COMPUTED_USERSET,
                found=False,
            )
            for relation in computed_subject_set_relations
        ]

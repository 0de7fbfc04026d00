"""Sequential check/expand engines with exact reference semantics.

This is the *parity oracle*: a direct expression of the reference check
engine's decision procedure (internal/check/engine.go, rewrites.go, binop.go,
checkgroup/) as a sequential evaluator.  The TPU engine is differential-tested
against it; the serving layer can also fall back to it.

Semantic contract reproduced here (file:line refer to the reference):

* Three-valued membership {UNKNOWN, IS_MEMBER, NOT_MEMBER}
  (checkgroup/definitions.go:68-72).  A check *group* resolves to IS_MEMBER
  if any child is, otherwise NOT_MEMBER — UNKNOWN children are swallowed
  (concurrent_checkgroup.go:108-123).  NOT inverts IS↔NOT but preserves
  UNKNOWN (rewrites.go:186-195), so depth-exhausted subtrees under a negation
  never flip to allowed.
* Depth budget: checkIsAllowed guards rest_depth<=0 (engine.go:215); direct
  and expand subchecks get rest_depth-1 (engine.go:242,245); subject-set
  rewrite is applied at the same depth (engine.go:237) with <=0 guard
  (rewrites.go:39); nested rewrites decrement (rewrites.go:118); computed
  subject sets recurse at the same depth with a <0 guard (rewrites.go:214,
  224-229); tuple-to-subject-set children recurse at rest_depth-1 with a <0
  guard (rewrites.go:247,281-286); expand recursion continues at the depth
  passed to checkExpandSubject with skip_direct (engine.go:161).
* Width: subject-set expansion truncates to max_width-1 children when more
  than max_width results return (engine.go:141-150).
* Cycle guard: a visited set of subject-sets created lazily per
  expansion-subtree and inherited downward (engine.go:119,157-162,
  x/graph/graph_utils.go:38-53).
* Strict mode: relations with rewrites skip the direct check; subject-set
  expansion only runs when the relation's types include subject sets
  (engine.go:233-246, 251-258).
* Unknown namespaces answer "not allowed", never "not found"
  (namespace/definitions.go:43-48); a declared namespace that does not
  declare the queried relation is a client error (definitions.go:61).
* OR-of-computed-subject-sets are batched through the traverser shortcut
  (rewrites.go:62-93, sql/traverser.go:123-191).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, List, Optional, Set, Tuple

from ketotpu_torch.api.types import (
    BadRequestError,
    RelationQuery,
    RelationTuple,
    Subject,
    SubjectID,
    SubjectSet,
    Tree,
    TreeNodeType,
)
from ketotpu_torch.opl import ast
from ketotpu_torch.storage.memory import InMemoryTupleStore
from ketotpu_torch.storage.namespaces import NamespaceManager, ast_relation_for
from ketotpu_torch.storage.traverser import Traverser

DEFAULT_MAX_DEPTH = 5  # limit.max_read_depth (embedx/config.schema.json:368-375)
DEFAULT_MAX_WIDTH = 100  # limit.max_read_width (embedx/config.schema.json:376-383)


class Membership(enum.IntEnum):
    UNKNOWN = 0
    IS_MEMBER = 1
    NOT_MEMBER = 2


@dataclass
class CheckResult:
    membership: Membership
    tree: Optional[Tree] = None

    @property
    def allowed(self) -> bool:
        return self.membership is Membership.IS_MEMBER


_UNKNOWN = CheckResult(Membership.UNKNOWN)
_NOT_MEMBER = CheckResult(Membership.NOT_MEMBER)

# A deferred subcheck: call to evaluate.
_Check = Callable[[], CheckResult]


def _group(checks: List[_Check]) -> CheckResult:
    """Checkgroup collapse: first IS_MEMBER wins, UNKNOWN swallowed."""
    for check in checks:
        result = check()
        if result.membership is Membership.IS_MEMBER:
            return result
    return _NOT_MEMBER


def _or(checks: List[_Check]) -> CheckResult:
    # binop.go:18-39 (empty => NotMember; first IsMember returned as-is)
    return _group(checks)


def _and(checks: List[_Check]) -> CheckResult:
    # binop.go:41-73 (empty => NotMember; any non-IsMember => NotMember)
    if not checks:
        return _NOT_MEMBER
    tree = Tree(type=TreeNodeType.INTERSECTION)
    for check in checks:
        result = check()
        if result.membership is not Membership.IS_MEMBER:
            return _NOT_MEMBER
        tree.children.append(result.tree)
    return CheckResult(Membership.IS_MEMBER, tree)


def _with_edge(edge_type: TreeNodeType, tuple_: RelationTuple, check: _Check) -> _Check:
    """checkgroup.WithEdge (definitions.go:104-127): annotate the child's tree
    with this rewrite edge."""

    def wrapped() -> CheckResult:
        result = check()
        if result.tree is None:
            tree = Tree(type=TreeNodeType.LEAF, tuple=tuple_)
        else:
            tree = Tree(type=edge_type, tuple=tuple_, children=[result.tree])
        return CheckResult(result.membership, tree)

    return wrapped


def _rewrite_node_type(op: ast.Operator) -> TreeNodeType:
    return TreeNodeType.INTERSECTION if op is ast.Operator.AND else TreeNodeType.UNION


class CheckEngine:
    """Sequential permission-check engine (the parity oracle)."""

    def __init__(
        self,
        store: InMemoryTupleStore,
        namespace_manager: Optional[NamespaceManager] = None,
        *,
        max_depth: int = DEFAULT_MAX_DEPTH,
        max_width: int = DEFAULT_MAX_WIDTH,
        strict_mode: bool = False,
        track_visited: bool = True,
    ):
        self.store = store
        self.namespace_manager = namespace_manager
        self.max_depth = max_depth
        self.max_width = max_width
        self.strict_mode = strict_mode
        # track_visited=False explores the full depth-bounded closure with no
        # cycle-visited suppression (exponential; test arbiter only).  The
        # reference's *concurrent* engine races its shared visited set
        # (engine.go:119,157-162), so any schedule's IS verdicts lie between
        # the sequential-DFS run and this closure — the device BFS is
        # arbitrated against both (see fastpath.py docstring).
        self.track_visited = track_visited
        self.traverser = Traverser(
            store, namespace_manager, strict_mode=strict_mode
        )

    # -- public API ---------------------------------------------------------

    def check_is_member(self, r: RelationTuple, rest_depth: int = 0) -> bool:
        return self.check_relation_tuple(r, rest_depth).allowed

    def check_relation_tuple(self, r: RelationTuple, rest_depth: int = 0) -> CheckResult:
        # Global max-depth takes precedence when lesser or request depth <= 0
        # (engine.go:82-84).
        if rest_depth <= 0 or self.max_depth < rest_depth:
            rest_depth = self.max_depth
        return self._check_is_allowed(r, rest_depth, skip_direct=False, visited=None)

    # -- core recursion -----------------------------------------------------

    def _ast_relation(self, r: RelationTuple) -> Optional[ast.Relation]:
        if self.namespace_manager is None:
            return None
        return ast_relation_for(self.namespace_manager, r.namespace, r.relation)

    def _check_is_allowed(
        self,
        r: RelationTuple,
        rest_depth: int,
        *,
        skip_direct: bool,
        visited: Optional[Set[Tuple[str, str, str]]],
    ) -> CheckResult:
        # engine.go:214-249
        if rest_depth <= 0:
            return _UNKNOWN

        relation = self._ast_relation(r)  # may raise BadRequestError
        has_rewrite = relation is not None and relation.subject_set_rewrite is not None
        strict = self.strict_mode
        can_have_subject_sets = (
            not strict
            or relation is None
            or any(t.relation != "" for t in relation.types)
        )

        checks: List[_Check] = []
        if has_rewrite:
            checks.append(
                lambda: self._check_subject_set_rewrite(
                    r, relation.subject_set_rewrite, rest_depth, visited
                )
            )
        if (not strict or not has_rewrite) and not skip_direct:
            checks.append(lambda: self._check_direct(r, rest_depth - 1))
        if can_have_subject_sets:
            checks.append(lambda: self._check_expand_subject(r, rest_depth - 1, visited))

        return _group(checks)

    def _check_direct(self, r: RelationTuple, rest_depth: int) -> CheckResult:
        # engine.go:167-208
        if rest_depth <= 0:
            return _UNKNOWN
        if self.store.exists_relation_tuples(r.to_query()):
            return CheckResult(
                Membership.IS_MEMBER, Tree(type=TreeNodeType.LEAF, tuple=r)
            )
        return _NOT_MEMBER

    def _check_expand_subject(
        self,
        r: RelationTuple,
        rest_depth: int,
        visited: Optional[Set[Tuple[str, str, str]]],
    ) -> CheckResult:
        # engine.go:102-164
        if rest_depth <= 0:
            return _UNKNOWN

        results = self.traverser.traverse_subject_set_expansion(r)

        # The current hop may already answer the check.
        for result in results:
            if result.found:
                return CheckResult(Membership.IS_MEMBER)

        if len(results) > self.max_width:
            results = results[: self.max_width - 1]

        inner_visited = visited if visited is not None else set()
        checks: List[_Check] = []
        for result in results:
            key = (result.to.namespace, result.to.object, result.to.relation)
            if self.track_visited and key in inner_visited:
                continue
            inner_visited.add(key)
            checks.append(
                lambda to=result.to: self._check_is_allowed(
                    to, rest_depth, skip_direct=True, visited=inner_visited
                )
            )
        return _group(checks)

    def _check_subject_set_rewrite(
        self,
        r: RelationTuple,
        rewrite: ast.SubjectSetRewrite,
        rest_depth: int,
        visited: Optional[Set[Tuple[str, str, str]]],
    ) -> CheckResult:
        # rewrites.go:33-134
        if rest_depth <= 0:
            return _UNKNOWN

        if rewrite.operation is ast.Operator.OR:
            op = _or
        elif rewrite.operation is ast.Operator.AND:
            op = _and
        else:  # pragma: no cover
            raise NotImplementedError("unknown rewrite operation")

        checks: List[_Check] = []
        handled: Set[int] = set()

        # Shortcut for ORs of computed subject sets (rewrites.go:62-93).
        if rewrite.operation is ast.Operator.OR:
            computed: List[str] = []
            for i, child in enumerate(rewrite.children):
                if isinstance(child, ast.ComputedSubjectSet):
                    handled.add(i)
                    computed.append(child.relation)
            if computed:
                checks.append(
                    lambda: self._check_computed_userset_batch(
                        r, computed, rest_depth, visited
                    )
                )

        for i, child in enumerate(rewrite.children):
            if i in handled:
                continue
            if isinstance(child, ast.TupleToSubjectSet):
                checks.append(
                    _with_edge(
                        TreeNodeType.TUPLE_TO_SUBJECT_SET,
                        r,
                        lambda c=child: self._check_tuple_to_subject_set(
                            r, c, rest_depth, visited
                        ),
                    )
                )
            elif isinstance(child, ast.ComputedSubjectSet):
                checks.append(
                    _with_edge(
                        TreeNodeType.COMPUTED_SUBJECT_SET,
                        r,
                        lambda c=child: self._check_computed_subject_set(
                            r, c, rest_depth, visited
                        ),
                    )
                )
            elif isinstance(child, ast.SubjectSetRewrite):
                checks.append(
                    _with_edge(
                        _rewrite_node_type(child.operation),
                        r,
                        lambda c=child: self._check_subject_set_rewrite(
                            r, c, rest_depth - 1, visited
                        ),
                    )
                )
            elif isinstance(child, ast.InvertResult):
                checks.append(
                    _with_edge(
                        TreeNodeType.NOT,
                        r,
                        lambda c=child: self._check_inverted(r, c, rest_depth, visited),
                    )
                )
            else:  # pragma: no cover
                raise NotImplementedError(f"unknown rewrite child {type(child)!r}")

        return op(checks)

    def _check_computed_userset_batch(
        self,
        r: RelationTuple,
        computed_relations: List[str],
        rest_depth: int,
        visited: Optional[Set[Tuple[str, str, str]]],
    ) -> CheckResult:
        # rewrites.go:73-91
        results = self.traverser.traverse_subject_set_rewrite(r, computed_relations)
        for result in results:
            if result.found:
                return CheckResult(Membership.IS_MEMBER)
        checks: List[_Check] = [
            lambda to=result.to: self._check_is_allowed(
                to, rest_depth - 1, skip_direct=True, visited=visited
            )
            for result in results
        ]
        return _group(checks)

    def _check_inverted(
        self,
        r: RelationTuple,
        inverted: ast.InvertResult,
        rest_depth: int,
        visited: Optional[Set[Tuple[str, str, str]]],
    ) -> CheckResult:
        # rewrites.go:136-200 (note the < 0 guard and same-depth recursion)
        if rest_depth < 0:
            return _UNKNOWN

        child = inverted.child
        if isinstance(child, ast.TupleToSubjectSet):
            check = _with_edge(
                TreeNodeType.TUPLE_TO_SUBJECT_SET,
                r,
                lambda: self._check_tuple_to_subject_set(r, child, rest_depth, visited),
            )
        elif isinstance(child, ast.ComputedSubjectSet):
            check = _with_edge(
                TreeNodeType.COMPUTED_SUBJECT_SET,
                r,
                lambda: self._check_computed_subject_set(r, child, rest_depth, visited),
            )
        elif isinstance(child, ast.SubjectSetRewrite):
            check = _with_edge(
                _rewrite_node_type(child.operation),
                r,
                lambda: self._check_subject_set_rewrite(r, child, rest_depth, visited),
            )
        elif isinstance(child, ast.InvertResult):
            check = _with_edge(
                TreeNodeType.NOT,
                r,
                lambda: self._check_inverted(r, child, rest_depth, visited),
            )
        else:  # pragma: no cover
            raise NotImplementedError(f"unknown rewrite child {type(child)!r}")

        result = check()
        if result.membership is Membership.IS_MEMBER:
            return CheckResult(Membership.NOT_MEMBER, result.tree)
        if result.membership is Membership.NOT_MEMBER:
            return CheckResult(Membership.IS_MEMBER, result.tree)
        return result  # UNKNOWN stays UNKNOWN

    def _check_computed_subject_set(
        self,
        r: RelationTuple,
        subject_set: ast.ComputedSubjectSet,
        rest_depth: int,
        visited: Optional[Set[Tuple[str, str, str]]],
    ) -> CheckResult:
        # rewrites.go:208-230: rewrite the relation, recurse at same depth.
        if rest_depth < 0:
            return _UNKNOWN
        return self._check_is_allowed(
            RelationTuple(
                namespace=r.namespace,
                object=r.object,
                relation=subject_set.relation,
                subject=r.subject,
            ),
            rest_depth,
            skip_direct=False,
            visited=visited,
        )

    def _check_tuple_to_subject_set(
        self,
        r: RelationTuple,
        subject_set: ast.TupleToSubjectSet,
        rest_depth: int,
        visited: Optional[Set[Tuple[str, str, str]]],
    ) -> CheckResult:
        # rewrites.go:242-293
        if rest_depth < 0:
            return _UNKNOWN

        checks: List[_Check] = []
        page_token = ""
        while True:
            tuples, page_token = self.store.get_relation_tuples(
                RelationQuery(
                    namespace=r.namespace,
                    object=r.object,
                    relation=subject_set.relation,
                ),
                page_token=page_token,
            )
            for t in tuples:
                if isinstance(t.subject, SubjectSet):
                    sub = t.subject
                    checks.append(
                        lambda sub=sub: self._check_is_allowed(
                            RelationTuple(
                                namespace=sub.namespace,
                                object=sub.object,
                                relation=subject_set.computed_subject_set_relation,
                                subject=r.subject,
                            ),
                            rest_depth - 1,
                            skip_direct=False,
                            visited=visited,
                        )
                    )
            if not page_token:
                break
        return _group(checks)


class ExpandEngine:
    """Subject-tree expansion (expand/engine.go:43-124)."""

    def __init__(
        self,
        store: InMemoryTupleStore,
        *,
        max_depth: int = DEFAULT_MAX_DEPTH,
    ):
        self.store = store
        self.max_depth = max_depth

    def build_tree(self, subject: Subject, rest_depth: int = 0) -> Optional[Tree]:
        if rest_depth <= 0 or self.max_depth < rest_depth:
            rest_depth = self.max_depth
        return self._build(subject, rest_depth, set())

    def _build(
        self, subject: Subject, rest_depth: int, visited: Set[str]
    ) -> Optional[Tree]:
        # Expand-tree nodes carry a tuple with only the subject populated
        # (Mapper.ToTree, uuid_mapping.go:356-380).
        if isinstance(subject, SubjectID):
            return Tree(
                type=TreeNodeType.LEAF,
                tuple=RelationTuple("", "", "", subject),
            )

        if subject.unique_id() in visited:
            return None
        visited.add(subject.unique_id())

        sub_tree = Tree(
            type=TreeNodeType.UNION,
            tuple=RelationTuple("", "", "", subject),
        )

        page_token = ""
        first = True
        while first or page_token:
            first = False
            rels, page_token = self.store.get_relation_tuples(
                RelationQuery(
                    namespace=subject.namespace,
                    object=subject.object,
                    relation=subject.relation,
                ),
                page_token=page_token,
            )
            if not rels:
                return None
            if rest_depth <= 1:
                sub_tree.type = TreeNodeType.LEAF
                return sub_tree
            for rel in rels:
                child = self._build(rel.subject, rest_depth - 1, visited)
                if child is None:
                    child = Tree(
                        type=TreeNodeType.LEAF,
                        tuple=RelationTuple("", "", "", rel.subject),
                    )
                sub_tree.children.append(child)
        return sub_tree

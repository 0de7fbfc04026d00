"""Public API types: relation tuples, queries, subject trees, and codecs.

These types are the wire contract of the framework and keep exact parity with
the reference's public API package (`ketoapi/public_api_definitions.go`,
`ketoapi/enc_string.go:16-94`, `ketoapi/enc_url_query.go:13-130`).

The tuple grammar is ``namespace:object#relation@subject`` where the subject is
either a plain subject id or a subject set ``ns:obj#rel`` (optionally wrapped
in parentheses).  Both subject forms are first-class everywhere.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Optional, Union


class KetoAPIError(Exception):
    """Base error carrying an HTTP status code for the REST surface."""

    status_code = 500

    def __init__(self, message: str, *, status_code: Optional[int] = None):
        super().__init__(message)
        self.message = message
        if status_code is not None:
            self.status_code = status_code


class BadRequestError(KetoAPIError):
    status_code = 400


class NotFoundError(KetoAPIError):
    status_code = 404


class TooManyRequestsError(KetoAPIError):
    """Admission control shed this request; the client should back off."""

    status_code = 429


class DeadlineExceededError(KetoAPIError):
    """The request's deadline budget expired before a verdict was ready."""

    status_code = 504


class StaleSnapshotError(KetoAPIError):
    """The serving snapshot could not be brought at-least-as-fresh as the
    client's snaptoken within the freshness-barrier budget (Zanzibar's
    zookie contract): 412 on REST, FAILED_PRECONDITION on gRPC."""

    status_code = 412


def ErrMalformedInput(detail: str = "") -> BadRequestError:
    # reference: ketoapi/enc_string.go:14
    msg = "malformed string input"
    if detail:
        msg += ": " + detail
    return BadRequestError(msg)


def ErrNilSubject() -> BadRequestError:
    return BadRequestError("subject is not allowed to be nil")


def ErrDroppedSubjectKey() -> BadRequestError:
    # reference: ketoapi/public_api_definitions.go (ErrDroppedSubjectKey)
    return BadRequestError(
        'provide "subject_id" or "subject_set.*"; support for "subject" was dropped'
    )


def ErrDuplicateSubject() -> BadRequestError:
    return BadRequestError("exactly one of subject_id or subject_set has to be provided")


def ErrIncompleteSubject() -> BadRequestError:
    return BadRequestError(
        'incomplete subject, provide "subject_id" or a complete "subject_set.*"'
    )


def ErrIncompleteTuple() -> BadRequestError:
    return BadRequestError(
        'incomplete tuple, provide "namespace", "object", "relation", and a subject'
    )


# --------------------------------------------------------------------------
# Subjects
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class SubjectID:
    """A plain subject identifier, e.g. a user id."""

    id: str

    def __str__(self) -> str:
        return self.id

    def unique_id(self) -> str:
        """Stable string for visited-set bookkeeping (cycle detection)."""
        return "id:" + self.id


@dataclass(frozen=True)
class SubjectSet:
    """A subject set ``namespace:object#relation`` (all members of a userset).

    An empty relation is allowed and means "the object itself"
    (reference: ketoapi/enc_string.go:79-94).
    """

    namespace: str
    object: str
    relation: str = ""

    def __str__(self) -> str:
        if self.relation == "":
            return f"{self.namespace}:{self.object}"
        return f"{self.namespace}:{self.object}#{self.relation}"

    def unique_id(self) -> str:
        return f"set:{self.namespace}:{self.object}#{self.relation}"

    @staticmethod
    def from_string(s: str) -> "SubjectSet":
        namespace_and_object, _, relation = s.partition("#")
        namespace, sep, obj = namespace_and_object.partition(":")
        if not sep:
            raise ErrMalformedInput("expected subject set to contain ':'")
        return SubjectSet(namespace=namespace, object=obj, relation=relation)


Subject = Union[SubjectID, SubjectSet]


def subject_from_string(s: str) -> Subject:
    """Parse a subject: strings containing ':' are subject sets, else ids.

    reference: ketoapi/enc_string.go:57-67 (including stripping optional
    parentheses around subject sets).
    """
    s = s.strip("()")
    if ":" in s:
        return SubjectSet.from_string(s)
    return SubjectID(id=s)


# --------------------------------------------------------------------------
# Relation tuples and queries
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RelationTuple:
    """One relation tuple ``namespace:object#relation@subject``."""

    namespace: str
    object: str
    relation: str
    subject: Subject

    def __str__(self) -> str:
        return f"{self.namespace}:{self.object}#{self.relation}@{self.subject}"

    @staticmethod
    def from_string(s: str) -> "RelationTuple":
        # reference: ketoapi/enc_string.go:38-70
        namespace, sep, rest = s.partition(":")
        if not sep:
            raise ErrMalformedInput("expected input to contain ':'")
        obj, sep, rest = rest.partition("#")
        if not sep:
            raise ErrMalformedInput("expected input to contain '#'")
        relation, sep, subject = rest.partition("@")
        if not sep:
            raise ErrMalformedInput("expected input to contain '@'")
        return RelationTuple(
            namespace=namespace,
            object=obj,
            relation=relation,
            subject=subject_from_string(subject),
        )

    # -- JSON ---------------------------------------------------------------

    def to_json(self) -> dict:
        d = {"namespace": self.namespace, "object": self.object, "relation": self.relation}
        if isinstance(self.subject, SubjectID):
            d["subject_id"] = self.subject.id
        else:
            d["subject_set"] = {
                "namespace": self.subject.namespace,
                "object": self.subject.object,
                "relation": self.subject.relation,
            }
        return d

    @staticmethod
    def from_json(d: Mapping) -> "RelationTuple":
        subject = _subject_from_json(d)
        if subject is None:
            raise ErrNilSubject()
        try:
            return RelationTuple(
                namespace=d["namespace"],
                object=d["object"],
                relation=d["relation"],
                subject=subject,
            )
        except KeyError as e:
            raise ErrIncompleteTuple() from e

    # -- URL query ----------------------------------------------------------

    def to_url_query(self) -> dict:
        return self.to_query().to_url_query()

    @staticmethod
    def from_url_query(q: Mapping[str, str]) -> "RelationTuple":
        # reference: ketoapi/enc_url_query.go:85-103
        rq = RelationQuery.from_url_query(q)
        if rq.subject() is None:
            raise ErrNilSubject()
        if rq.namespace is None or rq.object is None or rq.relation is None:
            raise ErrIncompleteTuple()
        return RelationTuple(
            namespace=rq.namespace,
            object=rq.object,
            relation=rq.relation,
            subject=rq.subject(),
        )

    def to_query(self) -> "RelationQuery":
        return RelationQuery(
            namespace=self.namespace,
            object=self.object,
            relation=self.relation,
            subject_id=self.subject.id if isinstance(self.subject, SubjectID) else None,
            subject_set=self.subject if isinstance(self.subject, SubjectSet) else None,
        )


def _subject_from_json(d: Mapping) -> Optional[Subject]:
    if d.get("subject_id") is not None:
        return SubjectID(id=d["subject_id"])
    ss = d.get("subject_set")
    if ss is not None:
        try:
            return SubjectSet(
                namespace=ss["namespace"], object=ss["object"], relation=ss.get("relation", "")
            )
        except (KeyError, TypeError) as e:
            raise ErrIncompleteSubject() from e
    return None


@dataclass
class RelationQuery:
    """A (partial) query over relation tuples; all fields optional."""

    namespace: Optional[str] = None
    object: Optional[str] = None
    relation: Optional[str] = None
    subject_id: Optional[str] = None
    subject_set: Optional[SubjectSet] = None

    def subject(self) -> Optional[Subject]:
        if self.subject_id is not None:
            return SubjectID(id=self.subject_id)
        return self.subject_set

    def with_subject(self, subject: Optional[Subject]) -> "RelationQuery":
        if isinstance(subject, SubjectID):
            self.subject_id, self.subject_set = subject.id, None
        elif isinstance(subject, SubjectSet):
            self.subject_id, self.subject_set = None, subject
        else:
            self.subject_id = self.subject_set = None
        return self

    # -- URL query ----------------------------------------------------------

    @staticmethod
    def from_url_query(q: Mapping[str, str]) -> "RelationQuery":
        # reference: ketoapi/enc_url_query.go:13-56 -- exact error parity.
        if "subject" in q:
            raise ErrDroppedSubjectKey()

        rq = RelationQuery()
        has_sid = "subject_id" in q
        has_ss = [k in q for k in
                  ("subject_set.namespace", "subject_set.object", "subject_set.relation")]
        if not has_sid and not any(has_ss):
            pass  # not queried for a subject
        elif has_sid and any(has_ss):
            raise ErrDuplicateSubject()
        elif has_sid:
            rq.subject_id = q["subject_id"]
        elif all(has_ss):
            rq.subject_set = SubjectSet(
                namespace=q["subject_set.namespace"],
                object=q["subject_set.object"],
                relation=q["subject_set.relation"],
            )
        else:
            raise ErrIncompleteSubject()

        rq.namespace = q.get("namespace", rq.namespace)
        rq.object = q.get("object", rq.object)
        rq.relation = q.get("relation", rq.relation)
        return rq

    def to_url_query(self) -> dict:
        v = {}
        if self.namespace is not None:
            v["namespace"] = self.namespace
        if self.relation is not None:
            v["relation"] = self.relation
        if self.object is not None:
            v["object"] = self.object
        if self.subject_id is not None:
            v["subject_id"] = self.subject_id
        elif self.subject_set is not None:
            v["subject_set.namespace"] = self.subject_set.namespace
            v["subject_set.object"] = self.subject_set.object
            v["subject_set.relation"] = self.subject_set.relation
        return v

    # -- JSON ---------------------------------------------------------------

    def to_json(self) -> dict:
        d = {}
        if self.namespace is not None:
            d["namespace"] = self.namespace
        if self.object is not None:
            d["object"] = self.object
        if self.relation is not None:
            d["relation"] = self.relation
        if self.subject_id is not None:
            d["subject_id"] = self.subject_id
        elif self.subject_set is not None:
            d["subject_set"] = {
                "namespace": self.subject_set.namespace,
                "object": self.subject_set.object,
                "relation": self.subject_set.relation,
            }
        return d

    @staticmethod
    def from_json(d: Mapping) -> "RelationQuery":
        rq = RelationQuery(
            namespace=d.get("namespace"),
            object=d.get("object"),
            relation=d.get("relation"),
        )
        return rq.with_subject(_subject_from_json(d))


# --------------------------------------------------------------------------
# Write deltas (PATCH /admin/relation-tuples)
# --------------------------------------------------------------------------


class PatchAction(str, enum.Enum):
    # reference: ketoapi/public_api_definitions.go:116-121
    INSERT = "insert"
    DELETE = "delete"


@dataclass(frozen=True)
class RelationTupleDelta:
    action: PatchAction
    relation_tuple: RelationTuple

    @staticmethod
    def from_json(d: Mapping) -> "RelationTupleDelta":
        try:
            action = PatchAction(d["action"])
            tuple_json = d["relation_tuple"]
        except (ValueError, KeyError) as e:
            raise BadRequestError(
                f"patch delta needs a valid action and a relation_tuple, got {d!r}"
            ) from e
        return RelationTupleDelta(
            action=action, relation_tuple=RelationTuple.from_json(tuple_json)
        )


# --------------------------------------------------------------------------
# Namespaces
# --------------------------------------------------------------------------


@dataclass
class Namespace:
    """Public namespace descriptor (name only on the wire)."""

    name: str

    def to_json(self) -> dict:
        return {"name": self.name}


# --------------------------------------------------------------------------
# Expand / debug trees
# --------------------------------------------------------------------------


class TreeNodeType(str, enum.Enum):
    # reference: ketoapi/public_api_definitions.go:185-192
    UNION = "union"
    EXCLUSION = "exclusion"
    INTERSECTION = "intersection"
    LEAF = "leaf"
    TUPLE_TO_SUBJECT_SET = "tuple_to_subject_set"
    COMPUTED_SUBJECT_SET = "computed_subject_set"
    NOT = "not"
    UNSPECIFIED = "unspecified"


@dataclass
class Tree:
    """A subject-expansion tree (Expand API) or check debug tree.

    ``tuple`` is the relation tuple this node stands for.  For Expand trees the
    subject of the tuple is the expanded subject (reference:
    ketoapi/public_api_definitions.go:217-229).
    """

    type: TreeNodeType
    tuple: Optional[RelationTuple] = None
    children: list = field(default_factory=list)

    def to_json(self) -> dict:
        d: dict = {"type": self.type.value}
        if self.tuple is not None:
            d["tuple"] = self.tuple.to_json()
        if self.children:
            d["children"] = [c.to_json() for c in self.children]
        return d

    @staticmethod
    def from_json(d: Mapping) -> "Tree":
        return Tree(
            type=TreeNodeType(d.get("type", "unspecified")),
            tuple=(
                RelationTuple.from_json(d["tuple"]) if "tuple" in d else None
            ),
            children=[Tree.from_json(c) for c in d.get("children", ())],
        )

    def label(self) -> str:
        return str(self.tuple) if self.tuple is not None else ""

    def __str__(self) -> str:
        # reference: ketoapi/enc_string.go:108-151 (pretty printer)
        if self.type == TreeNodeType.LEAF:
            return f"∋ {self.label()}️"

        children = []
        for i, c in enumerate(self.children):
            indent = "   " if i == len(self.children) - 1 else "│  "
            children.append(("\n" + indent).join(str(c).split("\n")))

        set_operation = {
            TreeNodeType.INTERSECTION: "and",
            TreeNodeType.UNION: "or",
            TreeNodeType.EXCLUSION: "\\",
            TreeNodeType.NOT: "not",
            TreeNodeType.TUPLE_TO_SUBJECT_SET: "┐ tuple to userset",
            TreeNodeType.COMPUTED_SUBJECT_SET: "┐ computed userset",
        }.get(self.type, "")

        box = "└" if len(children) == 1 else "├"
        return f"{set_operation} {self.label()}\n{box}──" + "\n└──".join(children)


def parse_tuples(lines: Iterable[str]) -> list:
    """Parse a sequence of tuple-grammar strings, skipping blanks/comments."""
    out = []
    for line in lines:
        line = line.strip()
        if not line or line.startswith("//") or line.startswith("#"):
            continue
        out.append(RelationTuple.from_string(line))
    return out

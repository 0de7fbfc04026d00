"""Ory Permission Language (OPL): lexer, parser, type checker.

OPL is a TypeScript subset: ``class X implements Namespace { related / permits }``.
Parsing produces namespace definitions with userset-rewrite ASTs
(union/intersection/exclusion, computed-userset, tuple-to-userset) with the
same semantics as the reference implementation (`internal/schema/`).
"""

from ketotpu_torch.opl.ast import (
    Child,
    ComputedSubjectSet,
    InvertResult,
    Namespace,
    Operator,
    Relation,
    RelationType,
    SubjectSetRewrite,
    TupleToSubjectSet,
    as_rewrite,
)
from ketotpu_torch.opl.parser import ParseError, parse

__all__ = [
    "Child",
    "ComputedSubjectSet",
    "InvertResult",
    "Namespace",
    "Operator",
    "ParseError",
    "Relation",
    "RelationType",
    "SubjectSetRewrite",
    "TupleToSubjectSet",
    "as_rewrite",
    "parse",
]

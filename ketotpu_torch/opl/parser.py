"""OPL recursive-descent parser and post-parse type checker.

Grammar and behavioral parity with the reference parser
(`internal/schema/parser.go:27-537`, `typechecks.go:44-130`,
`limits.go:6-14`):

* ``class Name implements Namespace { related: {...}  permits = {...} }``
* ``related`` entries declare subject types: ``rel: Ns[]``,
  ``rel: (A | B)[]``, ``rel: SubjectSet<Ns, "relation">[]``, ``rel: Array<A | B>``
* ``permits`` entries compile boolean expressions over
  ``this.related.X.includes(ctx.subject)`` (computed subject set),
  ``this.related.X.traverse((s) => s.permits.Y(ctx))`` /
  ``...traverse((s) => s.related.Y.includes(ctx.subject))`` (tuple to subject
  set), ``this.permits.Y(ctx)`` (computed subject set), combined with
  ``&&``/``||``/``!`` and parentheses, into an n-ary rewrite AST.
* Expression nesting is capped at 10 (`limits.go:13`); binary chains are
  simplified to n-ary nodes (`parser.go:519-537`).
* Type checks run only when parsing produced no errors: referenced namespaces
  and relations must exist; tuple-to-subject-set targets are checked
  recursively through subject-set types to depth 10 (`limits.go:8`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

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
from ketotpu_torch.opl.lexer import Item, ItemType, tokenize_non_comment

# Maximum number of nested '(' and '!' in a single 'permits' expression.
EXPRESSION_NESTING_MAX_DEPTH = 10

# Maximum recursion when type-checking SubjectSet<Ns, "rel"> chains.
TUPLE_TO_SUBJECT_SET_TYPECHECK_MAX_DEPTH = 10


@dataclass
class SourcePosition:
    line: int
    column: int

    def to_json(self) -> dict:
        # json tags are "Line" and "column" in the reference
        # (ketoapi/public_api_definitions.go:257-258).
        return {"Line": self.line, "column": self.column}


class ParseError(Exception):
    def __init__(self, msg: str, item: Item, source: str):
        super().__init__(msg)
        self.msg = msg
        self.item = item
        self.source = source

    def _to_src_pos(self, pos: int) -> SourcePosition:
        # Mirrors parse_errors.go:104-117 (column resets to 0 after newline).
        line, col = 1, 0
        for c in self.source:
            col += 1
            pos -= 1
            if pos <= 0:
                break
            if c == "\n":
                line += 1
                col = 0
        return SourcePosition(line, col)

    @property
    def start(self) -> SourcePosition:
        return self._to_src_pos(self.item.start)

    @property
    def end(self) -> SourcePosition:
        return self._to_src_pos(self.item.end)

    def to_json(self) -> dict:
        return {
            "message": self.msg,
            "start": self.start.to_json(),
            "end": self.end.to_json(),
        }

    def __str__(self) -> str:
        start, end = self.start, self.end
        rows = self.source.split("\n")
        out = [f"error from {start.line}:{start.column} to {end.line}:{end.column}: {self.msg}", ""]
        if len(rows) < start.line:
            out.append("meta error: could not find source position in input")
            return "\n".join(out) + "\n"
        start_line_idx = max(start.line - 2, 0)
        error_line_idx = max(start.line - 1, 0)
        for line in range(start_line_idx, error_line_idx + 1):
            out.append(f"{line:4d} | {rows[line]}")
        marker = []
        for i, r in enumerate(rows[error_line_idx]):
            if start.column == i:
                marker.append("^")
            elif start.column <= i <= end.column - 1:
                marker.append("~")
            elif r.isspace():
                marker.append(r)
            else:
                marker.append(" ")
        out.append("     | " + "".join(marker))
        if error_line_idx + 1 < len(rows):
            out.append(f"{error_line_idx + 1:4d} | {rows[error_line_idx + 1]}")
            out.append("")
        return "\n".join(out) + "\n"


class _Capture:
    """Capture slot for `_match`: NAME takes identifier/string-literal values,
    ANY takes any next item."""

    __slots__ = ("kind", "item")

    def __init__(self, kind: str):
        self.kind = kind
        self.item: Optional[Item] = None

    @property
    def val(self) -> str:
        assert self.item is not None
        return self.item.val


def _name() -> _Capture:
    return _Capture("name")


def _any() -> _Capture:
    return _Capture("any")


def _optional(*tokens: str) -> Callable:
    """Optionally match the token sequence: if the first token is present it is
    consumed and the rest must follow (parser.go:91-109)."""

    def matcher(p: "_Parser") -> bool:
        if not tokens:
            return True
        if p._peek().val == tokens[0]:
            p._next()
            for token in tokens[1:]:
                i = p._next()
                if i.val != token:
                    p._add_fatal(i, f'expected "{token}", got "{i.val}"')
                    return False
        return True

    return matcher


class _Parser:
    def __init__(self, source: str):
        self.source = source
        self._tokens = tokenize_non_comment(source)
        self._last_item: Optional[Item] = None
        self._lookahead: Optional[Item] = None
        self.namespaces: List[Namespace] = []
        self.namespace: Optional[Namespace] = None
        self.errors: List[ParseError] = []
        self.fatal = False
        self.checks: List[Callable[["_Parser"], None]] = []

    # -- token stream -------------------------------------------------------

    def _next(self) -> Item:
        if self._lookahead is not None:
            item, self._lookahead = self._lookahead, None
            return item
        # After the stream ends (EOF or ERROR), keep returning the final item,
        # like the reference lexer keeps emitting items after termination.
        item = next(self._tokens, self._last_item)
        assert item is not None
        self._last_item = item
        return item

    def _peek(self) -> Item:
        if self._lookahead is None:
            self._lookahead = self._next()
        return self._lookahead

    # -- error bookkeeping --------------------------------------------------

    def _add_err(self, item: Item, msg: str) -> None:
        self.errors.append(ParseError(msg, item, self.source))

    def _add_fatal(self, item: Item, msg: str) -> None:
        self._add_err(item, msg)
        self.fatal = True

    def _add_check(self, check: Callable[["_Parser"], None]) -> None:
        self.checks.append(check)

    # -- matching machinery (parser.go:111-168) -----------------------------

    def _match(self, *tokens) -> bool:
        if self.fatal:
            return False
        for token in tokens:
            if isinstance(token, str):
                i = self._next()
                if i.val != token:
                    self._add_fatal(i, f'expected "{token}", got "{i.val}"')
                    return False
            elif isinstance(token, _Capture):
                i = self._next()
                if token.kind == "name" and i.typ not in (
                    ItemType.IDENTIFIER,
                    ItemType.STRING_LITERAL,
                ):
                    self._add_fatal(i, f"expected identifier, got {i.typ.value}")
                    return False
                token.item = i
            elif callable(token):
                if not token(self):
                    return False
            else:  # pragma: no cover
                raise TypeError(f"unexpected match token {token!r}")
        return True

    def _match_if(self, typ: ItemType, *tokens) -> bool:
        if self.fatal:
            return False
        if self._peek().typ is not typ:
            return False
        return self._match(*tokens)

    # -- grammar ------------------------------------------------------------

    def parse(self) -> Tuple[List[Namespace], List[ParseError]]:
        while not self.fatal:
            item = self._next()
            if item.typ is ItemType.EOF:
                break
            elif item.typ is ItemType.ERROR:
                self._add_fatal(item, f"fatal: {item.val}")
            elif item.typ is ItemType.KEYWORD_CLASS:
                self._parse_class()

        if not self.errors:
            for check in self.checks:
                check(self)

        return self.namespaces, self.errors

    def _parse_class(self) -> None:
        name = _name()
        self._match(name, "implements", "Namespace", "{")
        if self.fatal:
            return
        self.namespace = Namespace(name=name.val)

        while not self.fatal:
            item = self._next()
            if item.typ is ItemType.BRACE_RIGHT:
                self.namespaces.append(self.namespace)
                return
            elif item.val == "related":
                self._parse_related()
            elif item.val == "permits":
                self._parse_permits()
            elif item.typ is ItemType.SEMICOLON:
                continue
            else:
                self._add_fatal(item, f"expected 'permits' or 'related', got \"{item.val}\"")
                return

    def _parse_related(self) -> None:
        self._match(":", "{")
        while not self.fatal:
            item = self._next()
            if item.typ is ItemType.SEMICOLON:
                continue
            elif item.typ is ItemType.BRACE_RIGHT:
                return
            elif item.typ in (ItemType.IDENTIFIER, ItemType.STRING_LITERAL):
                relation = item.val
                types: List[RelationType] = []
                self._match(":")

                t = self._next()
                if t.val == "Array":
                    self._match("<")
                    types.extend(self._parse_type_union(ItemType.ANGLED_RIGHT))
                elif t.val == "SubjectSet":
                    types.append(self._match_subject_set())
                    self._match("[", "]", _optional(","))
                elif t.typ is ItemType.PAREN_LEFT:
                    types.extend(self._parse_type_union(ItemType.PAREN_RIGHT))
                    self._match("[", "]", _optional(","))
                else:
                    types.append(RelationType(namespace=t.val))
                    self._add_check(_check_namespace_exists(t))
                    self._match("[", "]", _optional(","))

                if self.namespace is not None:
                    self.namespace.relations.append(Relation(name=relation, types=types))
            else:
                self._add_fatal(
                    item, f"expected identifier or '}}', got {item.typ.value} \"{item.val}\""
                )
                return

    def _match_subject_set(self) -> RelationType:
        namespace, relation = _any(), _any()
        self._match("<", namespace, ",", relation, ">")
        if namespace.item is not None and relation.item is not None:
            self._add_check(_check_namespace_has_relation(namespace.item, relation.item))
            return RelationType(namespace=namespace.val, relation=relation.val)
        return RelationType(namespace="", relation="")

    def _parse_type_union(self, end_type: ItemType) -> List[RelationType]:
        types: List[RelationType] = []
        while not self.fatal:
            identifier = _any()
            self._match(identifier)
            if identifier.item is None:
                return types
            if identifier.val == "SubjectSet":
                types.append(self._match_subject_set())
            else:
                types.append(RelationType(namespace=identifier.val))
                self._add_check(_check_namespace_exists(identifier.item))
            item = self._next()
            if item.typ is end_type:
                return types
            elif item.typ is ItemType.TYPE_UNION:
                continue
            else:
                self._add_fatal(item, f"expected '|', got \"{item.val}\"")
        return types

    def _parse_permits(self) -> None:
        self._match("=", "{")
        while not self.fatal:
            item = self._next()
            if item.typ is ItemType.BRACE_RIGHT:
                return
            elif item.typ in (ItemType.IDENTIFIER, ItemType.STRING_LITERAL):
                permission = item.val
                self._match(
                    ":", "(", "ctx", _optional(":", "Context"), ")",
                    _optional(":", "boolean"), "=>",
                )
                rewrite = simplify_expression(
                    self._parse_permission_expressions(
                        ItemType.OPERATOR_COMMA, EXPRESSION_NESTING_MAX_DEPTH
                    )
                )
                if rewrite is None:
                    return
                if self.namespace is not None:
                    self.namespace.relations.append(
                        Relation(name=permission, subject_set_rewrite=rewrite)
                    )
            else:
                self._add_fatal(
                    item, f"expected identifier or '}}', got {item.typ.value} \"{item.val}\""
                )
                return

    def _parse_permission_expressions(
        self, final_type: ItemType, depth: int
    ) -> Optional[SubjectSetRewrite]:
        if depth <= 0:
            self._add_fatal(
                self._peek(),
                "expression nested too deeply; maximal nesting depth is "
                f"{EXPRESSION_NESTING_MAX_DEPTH}",
            )
            return None

        root: Optional[SubjectSetRewrite] = None
        # Only expect an expression at the beginning and after a binary operator.
        expect_expression = True

        while not self.fatal:
            item = self._peek()

            if item.typ is ItemType.PAREN_LEFT:
                self._next()
                child = self._parse_permission_expressions(ItemType.PAREN_RIGHT, depth - 1)
                if child is None:
                    return None
                root = _add_child(root, child)
                expect_expression = False

            elif item.typ is final_type:
                self._next()
                return root

            elif item.typ is ItemType.BRACE_RIGHT:
                # Leave '}' for _parse_permits to consume.
                return root

            elif item.typ in (ItemType.OPERATOR_AND, ItemType.OPERATOR_OR):
                self._next()
                # A binary operator before the first expression is invalid.
                if root is None:
                    return None
                root = SubjectSetRewrite(
                    operation=(
                        Operator.AND if item.typ is ItemType.OPERATOR_AND else Operator.OR
                    ),
                    children=[root],
                )
                expect_expression = True

            elif item.typ is ItemType.OPERATOR_NOT:
                self._next()
                child = self._parse_not_expression(depth - 1)
                if child is None:
                    return None
                root = _add_child(root, child)
                expect_expression = False

            else:
                if not expect_expression:
                    self._add_fatal(item, "did not expect another expression")
                    return None
                child = self._parse_permission_expression()
                if child is None:
                    return None
                root = _add_child(root, child)
                # Deliberate parity quirk: the reference re-arms
                # expectExpression after a plain expression (parser.go:373),
                # so two adjacent plain expressions do not error.
                expect_expression = True
        return None

    def _parse_not_expression(self, depth: int) -> Optional[Child]:
        if depth <= 0:
            self._add_fatal(
                self._peek(),
                "expression nested too deeply; maximal nesting depth is "
                f"{EXPRESSION_NESTING_MAX_DEPTH}",
            )
            return None

        if self._peek().typ is ItemType.PAREN_LEFT:
            self._next()
            child: Optional[Child] = self._parse_permission_expressions(
                ItemType.PAREN_RIGHT, depth - 1
            )
        else:
            child = self._parse_permission_expression()
        if child is None:
            return None
        return InvertResult(child=child)

    def _match_property_access(self, prop) -> bool:
        return self._match_if(ItemType.BRACKET_LEFT, "[", prop, "]") or self._match(".", prop)

    def _parse_permission_expression(self) -> Optional[Child]:
        verb, name = _any(), _any()

        if not self._match("this", ".", verb):
            return None
        if not self._match_property_access(name):
            return None

        if verb.val == "related":
            if not self._match("."):
                return None
            item = self._next()
            if item.val == "traverse":
                return self._parse_tuple_to_subject_set(name.item)
            elif item.val == "includes":
                return self._parse_computed_subject_set(name.item)
            else:
                self._add_fatal(item, f"expected 'traverse' or 'includes', got \"{item.val}\"")
                return None

        elif verb.val == "permits":
            if not self._match("(", "ctx", ")"):
                return None
            assert self.namespace is not None
            self._add_check(
                _check_current_namespace_has_relation(self.namespace.name, name.item)
            )
            return ComputedSubjectSet(relation=name.val)

        else:
            self._add_fatal(
                verb.item, f"expected 'related' or 'permits', got \"{verb.val}\""
            )
            return None

    def _parse_tuple_to_subject_set(self, relation: Item) -> Optional[Child]:
        arg, verb = _any(), _any()
        subject_set_rel = _name()

        if not self._match("("):
            return None
        if not (self._match_if(ItemType.PAREN_LEFT, "(", arg, ")") or self._match(arg)):
            return None
        self._match("=>", arg.val, ".", verb)
        if self.fatal:
            return None

        if verb.val == "related":
            if not self._match_property_access(subject_set_rel):
                return None
            self._match(
                ".", "includes", "(", "ctx", ".", "subject",
                _optional(","), ")", _optional(","), ")",
            )
            assert self.namespace is not None
            self._add_check(
                _check_all_relation_types_have_relation(
                    self.namespace.name, relation, subject_set_rel.val
                )
            )
        elif verb.val == "permits":
            if not self._match_property_access(subject_set_rel):
                return None
            self._match("(", "ctx", ")", ")")
            assert self.namespace is not None
            self._add_check(
                _check_all_relation_types_have_relation(
                    self.namespace.name, relation, subject_set_rel.val
                )
            )
        else:
            self._add_fatal(verb.item, f"expected 'related' or 'permits', got \"{verb.val}\"")
            return None

        assert self.namespace is not None
        self._add_check(_check_current_namespace_has_relation(self.namespace.name, relation))
        return TupleToSubjectSet(
            relation=relation.val, computed_subject_set_relation=subject_set_rel.val
        )

    def _parse_computed_subject_set(self, relation: Item) -> Optional[Child]:
        if not self._match("(", "ctx", ".", "subject", ")"):
            return None
        assert self.namespace is not None
        self._add_check(_check_current_namespace_has_relation(self.namespace.name, relation))
        return ComputedSubjectSet(relation=relation.val)


def _add_child(root: Optional[SubjectSetRewrite], child: Child) -> SubjectSetRewrite:
    if root is None:
        return as_rewrite(child)
    root.children.append(child)
    return root


def simplify_expression(root: Optional[SubjectSetRewrite]) -> Optional[SubjectSetRewrite]:
    """Merge binary chains of the same operator into n-ary nodes
    (parser.go:519-537)."""
    if root is None:
        return None
    new_children: List[Child] = []
    for child in root.children:
        if isinstance(child, SubjectSetRewrite) and child.operation == root.operation:
            simplify_expression(child)
            new_children.extend(child.children)
        else:
            new_children.append(child)
    root.children = new_children
    return root


# -- type checks (typechecks.go:44-130) -------------------------------------


def _find_namespace(namespaces: List[Namespace], name: str) -> Optional[Namespace]:
    for n in namespaces:
        if n.name == name:
            return n
    return None


def _find_relation(namespaces: List[Namespace], namespace: str, relation: str):
    n = _find_namespace(namespaces, namespace)
    if n is None:
        return None
    return n.relation(relation)


def _check_namespace_exists(namespace: Item):
    def check(p: _Parser) -> None:
        if _find_namespace(p.namespaces, namespace.val) is None:
            p._add_err(namespace, f'namespace "{namespace.val}" was not declared')

    return check


def _check_namespace_has_relation(namespace: Item, relation: Item):
    def check(p: _Parser) -> None:
        n = _find_namespace(p.namespaces, namespace.val)
        if n is None:
            p._add_err(namespace, f'namespace "{namespace.val}" was not declared')
            return
        if n.relation(relation.val) is None:
            p._add_err(
                relation,
                f'namespace "{namespace.val}" did not declare relation "{relation.val}"',
            )

    return check


def _check_current_namespace_has_relation(namespace_name: str, relation: Item):
    def check(p: _Parser) -> None:
        n = _find_namespace(p.namespaces, namespace_name)
        if n is None:
            p._add_err(relation, f'namespace "{namespace_name}" was not declared')
            return
        if n.relation(relation.val) is None:
            p._add_err(
                relation,
                f'namespace "{namespace_name}" did not declare relation "{relation.val}"',
            )

    return check


def _check_all_relation_types_have_relation(
    namespace_name: str, relation_type: Item, relation: str
):
    def check(p: _Parser) -> None:
        _recursive_types_check(
            p,
            relation_type,
            namespace_name,
            relation_type.val,
            relation,
            TUPLE_TO_SUBJECT_SET_TYPECHECK_MAX_DEPTH,
        )

    return check


def _recursive_types_check(
    p: _Parser, item: Item, namespace: str, relation_type: str, relation: str, depth: int
) -> None:
    if depth < 0:
        p._add_err(item, "could not typecheck deeply nested SubjectSet further")
        return
    r = _find_relation(p.namespaces, namespace, relation_type)
    if r is None:
        p._add_err(
            item, f'relation "{relation_type}" was not declared in namespace "{namespace}"'
        )
        return
    for t in r.types:
        if t.relation == "":
            if _find_relation(p.namespaces, t.namespace, relation) is None:
                p._add_err(
                    item,
                    f'relation "{relation}" was not declared in namespace "{t.namespace}"',
                )
        else:
            # The type is itself a subject set: recursively check that it
            # (eventually) declares the required relation.
            _recursive_types_check(p, item, t.namespace, t.relation, relation, depth - 1)


def parse(source: str) -> Tuple[List[Namespace], List[ParseError]]:
    """Parse OPL source into namespaces; returns (namespaces, errors)."""
    return _Parser(source).parse()

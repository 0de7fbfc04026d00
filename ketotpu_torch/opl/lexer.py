"""OPL tokenizer.

A straightforward scanner producing the same token taxonomy as the reference
lexer (`internal/schema/lexer.go:40-89`): identifiers, string literals,
comments, keywords (class/implements/this/ctx), multi-rune operators
(``=>``, ``||``, ``&&``) before single-rune ones, and an error token carrying
the message on invalid input.  Implemented as a generator instead of the
reference's goroutine/channel state machine — same stream, idiomatic Python.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterator


class ItemType(enum.Enum):
    ERROR = "error"
    EOF = "eof"
    IDENTIFIER = "identifier"
    COMMENT = "comment"
    STRING_LITERAL = "string literal"
    # keywords
    KEYWORD_CLASS = "class"
    KEYWORD_IMPLEMENTS = "implements"
    KEYWORD_THIS = "this"
    KEYWORD_CTX = "ctx"
    # operators
    OPERATOR_AND = "&&"
    OPERATOR_OR = "||"
    OPERATOR_NOT = "!"
    OPERATOR_ASSIGN = "="
    OPERATOR_ARROW = "=>"
    OPERATOR_DOT = "."
    OPERATOR_COLON = ":"
    OPERATOR_COMMA = ","
    # misc
    SEMICOLON = ";"
    TYPE_UNION = "|"
    # brackets
    PAREN_LEFT = "("
    PAREN_RIGHT = ")"
    BRACE_LEFT = "{"
    BRACE_RIGHT = "}"
    BRACKET_LEFT = "["
    BRACKET_RIGHT = "]"
    ANGLED_LEFT = "<"
    ANGLED_RIGHT = ">"


@dataclass(frozen=True)
class Item:
    typ: ItemType
    val: str
    start: int
    end: int

    def __str__(self) -> str:
        if self.typ is ItemType.ERROR:
            return "error: " + self.val
        if self.typ is ItemType.EOF:
            return "EOF"
        if self.typ in (ItemType.IDENTIFIER, ItemType.STRING_LITERAL):
            v = self.val if len(self.val) <= 10 else self.val[:10] + "..."
            return f"'{v}'"
        return self.val


_SPACES = "\t\n\v\f\r "
_DIGITS = "0123456789"
_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_"

_MULTI_RUNE = [("=>", ItemType.OPERATOR_ARROW),
               ("||", ItemType.OPERATOR_OR),
               ("&&", ItemType.OPERATOR_AND)]

_ONE_RUNE = {
    ":": ItemType.OPERATOR_COLON,
    ".": ItemType.OPERATOR_DOT,
    "(": ItemType.PAREN_LEFT,
    ")": ItemType.PAREN_RIGHT,
    "[": ItemType.BRACKET_LEFT,
    "]": ItemType.BRACKET_RIGHT,
    "{": ItemType.BRACE_LEFT,
    "}": ItemType.BRACE_RIGHT,
    "<": ItemType.ANGLED_LEFT,
    ">": ItemType.ANGLED_RIGHT,
    "=": ItemType.OPERATOR_ASSIGN,
    ",": ItemType.OPERATOR_COMMA,
    ";": ItemType.SEMICOLON,
    "|": ItemType.TYPE_UNION,
    "!": ItemType.OPERATOR_NOT,
}

_KEYWORDS = {
    "class": ItemType.KEYWORD_CLASS,
    "implements": ItemType.KEYWORD_IMPLEMENTS,
    "this": ItemType.KEYWORD_THIS,
    "ctx": ItemType.KEYWORD_CTX,
}


def tokenize(source: str) -> Iterator[Item]:
    """Yield tokens; terminates with exactly one EOF or ERROR item."""
    pos = 0
    n = len(source)
    while True:
        while pos < n and source[pos] in _SPACES:
            pos += 1
        if pos >= n:
            yield Item(ItemType.EOF, "", pos, pos)
            return
        start = pos

        matched = False
        for tok, typ in _MULTI_RUNE:
            if source.startswith(tok, pos):
                pos += len(tok)
                yield Item(typ, tok, start, pos)
                matched = True
                break
        if matched:
            continue

        if source.startswith("//", pos):
            end = source.find("\n", pos)
            end = n if end == -1 else end
            yield Item(ItemType.COMMENT, source[pos:end], start, end)
            pos = end
            continue
        if source.startswith("/*", pos):
            end = source.find("*/", pos + 2)
            if end == -1:
                yield Item(ItemType.ERROR, "unclosed comment", start, n)
                return
            yield Item(ItemType.COMMENT, source[pos:end + 2], start, end + 2)
            pos = end + 2
            continue

        c = source[pos]
        if c in _ONE_RUNE:
            pos += 1
            yield Item(_ONE_RUNE[c], c, start, pos)
            continue

        if c in "'\"":
            end = source.find(c, pos + 1)
            if end == -1:
                yield Item(ItemType.ERROR, "unclosed string literal", start, n)
                return
            yield Item(ItemType.STRING_LITERAL, source[pos + 1:end], pos + 1, end)
            pos = end + 1
            continue

        if c in _LETTERS:
            pos += 1
            while pos < n and source[pos] in _LETTERS + _DIGITS:
                pos += 1
            word = source[start:pos]
            yield Item(_KEYWORDS.get(word, ItemType.IDENTIFIER), word, start, pos)
            continue

        yield Item(ItemType.ERROR, f"unexpected token {c}", start, pos + 1)
        return


def tokenize_non_comment(source: str) -> Iterator[Item]:
    for item in tokenize(source):
        if item.typ is not ItemType.COMMENT:
            yield item

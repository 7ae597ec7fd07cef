"""Reference recursive-descent parser for the constrained-SQL subset.

This is the *independent second implementation* of the language grammar.py
compiles to a DFA: a conventional lexer + recursive descent over the same
SELECT subset. It exists for two jobs:

- **test oracle**: tests/test_constrain.py asserts that every string the
  token-DFA can emit parses here (and that curated invalid SQL is rejected
  by both) — the DFA and this parser hold each other honest.
- **validity metric**: evalh scores `grammar-valid%` by calling
  `is_valid_spark_sql` on generated SQL, with or without constrained
  decoding — the uplift the constrain subsystem exists to produce.

The parser is deliberately a hair more *lenient* than the DFA on
whitespace (it lexes first, so `COUNT (*)` and `a>2` need no special
cases); the only hard boundary rule it keeps is rejecting a number glued
to a word (`2AND`), which the DFA also rejects. Leniency in this direction
is safe: the guarantees flow DFA -> parser (everything the decoder can
emit must parse), never the other way.

A copy of the JAX package's `constrain/parser.py` (pure Python): the port
imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .grammar import AGGREGATES, RESERVED, STRING_CHARS

_RESERVED = {w.upper() for w in RESERVED}
_AGGS = {w.upper() for w in AGGREGATES}
_CMP_OPS = ("<=", ">=", "<>", "!=", "=", "<", ">")
_WS = " \n\t"
_WORD_START = set("abcdefghijklmnopqrstuvwxyz"
                  "ABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_WORD_CHARS = _WORD_START | set("0123456789")


class SqlSyntaxError(ValueError):
    """Raised with a position + message when the text leaves the subset."""


@dataclasses.dataclass(frozen=True)
class _Tok:
    kind: str   # word | number | string | op | punct
    text: str
    pos: int


def _lex(sql: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch in _WS:
            i += 1
            continue
        if ch in _WORD_START:
            j = i + 1
            while j < n and sql[j] in _WORD_CHARS:
                j += 1
            toks.append(_Tok("word", sql[i:j], i))
            i = j
            continue
        if ch.isdigit() or (ch == "-" and i + 1 < n and sql[i + 1].isdigit()):
            j = i + 1 if ch == "-" else i
            while j < n and sql[j].isdigit():
                j += 1
            if j < n and sql[j] == "." and j + 1 < n and sql[j + 1].isdigit():
                j += 1
                while j < n and sql[j].isdigit():
                    j += 1
            # A word char glued to a number ("2AND") is a lex error — the
            # grammar requires whitespace there too, and letting it split
            # silently would make the parser accept SQL the DFA (and real
            # engines) reject.
            if j < n and sql[j] in _WORD_START:
                raise SqlSyntaxError(f"malformed number at {i}")
            toks.append(_Tok("number", sql[i:j], i))
            i = j
            continue
        if ch == "'":
            j = i + 1
            while j < n and sql[j] != "'":
                if sql[j] not in STRING_CHARS:
                    raise SqlSyntaxError(
                        f"character {sql[j]!r} not allowed in string at {j}"
                    )
                j += 1
            if j >= n:
                raise SqlSyntaxError(f"unterminated string at {i}")
            toks.append(_Tok("string", sql[i:j + 1], i))
            i = j + 1
            continue
        for op in _CMP_OPS:  # maximal munch: 2-char ops first
            if sql.startswith(op, i):
                toks.append(_Tok("op", op, i))
                i += len(op)
                break
        else:
            if ch in ",().;*":
                toks.append(_Tok("punct", ch, i))
                i += 1
            else:
                raise SqlSyntaxError(f"unexpected character {ch!r} at {i}")
    return toks


class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0

    # ------------------------------------------------------------- stream
    def peek(self) -> Optional[_Tok]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self) -> _Tok:
        tok = self.peek()
        if tok is None:
            raise SqlSyntaxError("unexpected end of input")
        self.i += 1
        return tok

    def at_kw(self, *words: str) -> bool:
        tok = self.peek()
        return (tok is not None and tok.kind == "word"
                and tok.text.upper() in words)

    def expect_kw(self, word: str) -> None:
        tok = self.take()
        if tok.kind != "word" or tok.text.upper() != word:
            raise SqlSyntaxError(f"expected {word} at {tok.pos}, got {tok.text!r}")

    def at_punct(self, ch: str) -> bool:
        tok = self.peek()
        return tok is not None and tok.kind == "punct" and tok.text == ch

    def expect_punct(self, ch: str) -> None:
        tok = self.take()
        if tok.kind != "punct" or tok.text != ch:
            raise SqlSyntaxError(f"expected {ch!r} at {tok.pos}, got {tok.text!r}")

    # ------------------------------------------------------------ grammar
    def ident(self) -> str:
        tok = self.take()
        if tok.kind != "word" or tok.text.upper() in _RESERVED:
            raise SqlSyntaxError(
                f"expected identifier at {tok.pos}, got {tok.text!r}"
            )
        return tok.text

    def col_ref(self) -> None:
        self.ident()
        if self.at_punct("."):
            self.take()
            self.ident()

    def func_call(self) -> None:
        tok = self.take()  # caller checked at_kw(*_AGGS)
        assert tok.text.upper() in _AGGS
        self.expect_punct("(")
        if self.at_punct("*"):
            self.take()
        else:
            self.col_ref()
        self.expect_punct(")")

    def operand(self) -> None:
        tok = self.peek()
        if tok is None:
            raise SqlSyntaxError("unexpected end of input in expression")
        if tok.kind in ("number", "string"):
            self.take()
        elif self.at_kw(*_AGGS):
            self.func_call()
        else:
            self.col_ref()

    def scalar(self) -> None:
        """IN-list / BETWEEN bound: literal or column ref, no aggregates
        (matching the DFA's `scalar` branch)."""
        tok = self.peek()
        if tok is None:
            raise SqlSyntaxError("unexpected end of input in expression")
        if tok.kind in ("number", "string"):
            self.take()
        else:
            self.col_ref()

    def predicate(self) -> None:
        self.operand()
        # IS [NOT] NULL / [NOT] LIKE 'pattern' / [NOT] IN (...) /
        # [NOT] BETWEEN lo AND hi — keyword predicates; the lexer
        # already split words, so (unlike the DFA) `a IS  NULL` with
        # any whitespace parses. Leniency note: the DFA restricts the
        # left side to a column reference while this parser accepts any
        # operand ("5 IS NULL" parses here, is unspellable there) — safe
        # in the guaranteed direction, DFA ⊆ parser.
        if self.at_kw("IS"):
            self.take()
            if self.at_kw("NOT"):
                self.take()
            self.expect_kw("NULL")
            return
        if self.at_kw("NOT", "LIKE", "IN", "BETWEEN"):
            if self.at_kw("NOT"):
                self.take()
            if self.at_kw("LIKE"):
                self.take()
                tok = self.take()
                if tok.kind != "string":
                    raise SqlSyntaxError(
                        f"LIKE needs a string pattern at {tok.pos}, "
                        f"got {tok.text!r}"
                    )
                return
            if self.at_kw("IN"):
                # Parenthesized non-empty scalar list (no nested
                # selects in this subset).
                self.take()
                self.expect_punct("(")
                self.scalar()
                while self.at_punct(","):
                    self.take()
                    self.scalar()
                self.expect_punct(")")
                return
            # BETWEEN consumes its AND eagerly, so condition()'s
            # AND/OR loop never mistakes the range conjunction for a
            # boolean connective.
            self.expect_kw("BETWEEN")
            self.scalar()
            self.expect_kw("AND")
            self.scalar()
            return
        tok = self.take()
        if tok.kind != "op":
            raise SqlSyntaxError(
                f"expected comparison at {tok.pos}, got {tok.text!r}"
            )
        self.operand()

    def bool_term(self) -> None:
        """One term of a WHERE/HAVING condition: a bare predicate or a
        parenthesized AND/OR chain — `( pred OR pred ) AND pred`.
        Leniency note: the parser recurses, so arbitrarily NESTED parens
        parse here while the DFA (which cannot count) accepts exactly
        one level — safe in the guaranteed direction, DFA ⊆ parser."""
        if self.at_punct("("):
            self.take()
            self.condition()
            self.expect_punct(")")
        else:
            self.predicate()

    def condition(self) -> None:
        self.bool_term()
        while self.at_kw("AND", "OR"):
            self.take()
            self.bool_term()

    def sel_item(self) -> None:
        if self.at_kw(*_AGGS):
            self.func_call()
        else:
            self.col_ref()
        if self.at_kw("AS"):
            self.take()
            self.ident()

    def order_item(self) -> None:
        if self.at_kw(*_AGGS):
            self.func_call()
        else:
            self.col_ref()
        if self.at_kw("ASC", "DESC"):
            self.take()

    def query(self) -> None:
        self.expect_kw("SELECT")
        if self.at_kw("DISTINCT"):
            self.take()
        if self.at_punct("*"):
            self.take()
        else:
            self.sel_item()
            while self.at_punct(","):
                self.take()
                self.sel_item()
        self.expect_kw("FROM")
        self.ident()
        while self.at_kw("JOIN", "INNER", "LEFT", "RIGHT"):
            if not self.at_kw("JOIN"):
                self.take()
            self.expect_kw("JOIN")
            self.ident()
            self.expect_kw("ON")
            self.predicate()
        if self.at_kw("WHERE"):
            self.take()
            self.condition()
        if self.at_kw("GROUP"):
            self.take()
            self.expect_kw("BY")
            self.col_ref()
            while self.at_punct(","):
                self.take()
                self.col_ref()
            if self.at_kw("HAVING"):
                self.take()
                self.condition()
        if self.at_kw("ORDER"):
            self.take()
            self.expect_kw("BY")
            self.order_item()
            while self.at_punct(","):
                self.take()
                self.order_item()
        if self.at_kw("LIMIT"):
            self.take()
            tok = self.take()
            if tok.kind != "number" or not tok.text.isdigit():
                raise SqlSyntaxError(
                    f"LIMIT needs a plain integer at {tok.pos}"
                )
        if self.at_punct(";"):
            self.take()
        if self.peek() is not None:
            tok = self.peek()
            raise SqlSyntaxError(
                f"trailing tokens at {tok.pos}: {tok.text!r}"
            )


def parse_spark_sql(sql: str) -> None:
    """Raise SqlSyntaxError unless `sql` is in the constrained subset."""
    toks = _lex(sql)
    if not toks:
        raise SqlSyntaxError("empty statement")
    _Parser(toks).query()


def is_valid_spark_sql(sql: str) -> bool:
    """Boolean twin of parse_spark_sql — the evalh grammar-valid oracle."""
    try:
        parse_spark_sql(sql)
    except SqlSyntaxError:
        return False
    return True

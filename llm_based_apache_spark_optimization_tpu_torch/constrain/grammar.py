"""The Spark-SQL SELECT subset served by the constrained decoder.

One grammar, two compilation modes:

- **generic** (`spark_sql_dfa()`): identifiers are any non-reserved word —
  the mode the eval harness scores, covering the evalh fixture suite and
  Spider-style single-table queries: projections (with aggregates and
  aliases), WHERE (comparisons, `IS [NOT] NULL`, `[NOT] LIKE 'pat%'`,
  `[NOT] IN (...)`, `[NOT] BETWEEN lo AND hi`),
  GROUP BY/HAVING, ORDER BY (ASC/DESC), LIMIT, JOIN..ON, numeric and
  string literals.
- **schema-aware** (`spark_sql_dfa(table=..., columns=...)`): the
  table/column branches are compiled from the uploaded CSV's schema — the
  same strings app/pipeline.py already feeds the prompt — so the model
  *cannot spell* a column that is not in the table (each name is allowed in
  its schema casing plus all-lower/all-upper; aliases after AS stay generic
  so `SUM(x) AS total_fare` still works).

Whitespace is part of the language on purpose: clause keywords require a
separating space on their word-side boundaries (`SELECT *FROM` is invalid,
and the DFA therefore *forces* the decoder to emit the space), while
punctuation and comparison operators take optional whitespace. Reserved
words are carved out of the identifier language via DFA difference
(dfa.py), so `FROM from` can never be produced.

The reference recursive-descent parser for the same subset lives in
parser.py; the tests hold the two implementations together.

A copy of the JAX package's `constrain/grammar.py` (pure Python): the port
imports nothing of that package.
"""

from __future__ import annotations

import functools
import string
from typing import Optional, Tuple

from .dfa import (
    Alt,
    Auto,
    CharDfa,
    Chars,
    Lit,
    Opt,
    Plus,
    Re,
    Seq,
    Star,
    compile_dfa,
    difference,
)

#: Reserved words — excluded from the identifier language (any casing).
RESERVED: Tuple[str, ...] = (
    "SELECT", "DISTINCT", "FROM", "WHERE", "GROUP", "BY", "HAVING",
    "ORDER", "LIMIT", "JOIN", "INNER", "LEFT", "RIGHT", "ON", "AS",
    "AND", "OR", "ASC", "DESC",
    "IS", "NOT", "NULL", "LIKE", "IN", "BETWEEN",
    "SUM", "AVG", "COUNT", "MIN", "MAX",
)

#: Aggregate function names (subset of RESERVED).
AGGREGATES: Tuple[str, ...] = ("SUM", "AVG", "COUNT", "MIN", "MAX")

#: Characters allowed inside '...' string literals (no quote, no newline).
STRING_CHARS = frozenset(
    string.ascii_letters + string.digits + " _-.,:/%()@#+*=<>?!"
)

_LETTERS = frozenset(string.ascii_letters)
_DIGITS = frozenset(string.digits)
_WORD_START = _LETTERS | {"_"}
_WORD_CHARS = _LETTERS | _DIGITS | {"_"}

WS: Re = Plus(Chars(" \n\t"))
OWS: Re = Opt(WS)


def kw(word: str) -> Re:
    """Case-insensitive keyword (SELECT / select / Select / ...)."""
    return Seq(*[Chars({c.lower(), c.upper()}) for c in word])


@functools.lru_cache(maxsize=1)
def _ident_fragment() -> Re:
    """Generic identifier: `[A-Za-z_][A-Za-z0-9_]*` minus RESERVED (any
    casing) — computed once via DFA difference and embedded as Auto."""
    any_word = Seq(Chars(_WORD_START), Star(Chars(_WORD_CHARS)))
    keywords = Alt(*[kw(w) for w in RESERVED])
    return Auto(difference(compile_dfa(any_word), compile_dfa(keywords)))


def is_constrainable_identifier(name: str) -> bool:
    """True iff a schema name can be compiled into the grammar: plain
    `[A-Za-z_][A-Za-z0-9_]*` shape and not a reserved word. CSV headers
    with spaces/punctuation (which the SQL backends quote) and
    keyword-named columns cannot be emitted unambiguously — callers drop
    them (app/pipeline.py falls back to unconstrained when nothing
    survives)."""
    if not name or name[0] not in _WORD_START:
        return False
    if any(c not in _WORD_CHARS for c in name):
        return False
    return name.upper() not in {w.upper() for w in RESERVED}


def _name_fragment(names: Tuple[str, ...]) -> Re:
    """Literal-name branch for schema mode: each name in its schema casing
    plus all-lower and all-upper (SQL identifiers are case-insensitive;
    forcing one casing would fail models that normalize). Names that are
    not constrainable — reserved words, or shapes outside the identifier
    charset like a CSV header with a space — are dropped: compiling them
    verbatim would let the decoder emit text the validity oracle and the
    SQL engines both reject, breaking the every-completion-parses
    guarantee."""
    variants = []
    for name in names:
        if not is_constrainable_identifier(name):
            continue
        for v in {name, name.lower(), name.upper()}:
            variants.append(Lit(v))
    if not variants:
        raise ValueError(f"no usable identifiers in {names!r}")
    return Alt(*variants)


def _build(table: Optional[str], columns: Optional[Tuple[str, ...]]) -> Re:
    ident = _ident_fragment()
    column = _name_fragment(tuple(columns)) if columns else ident
    table_ref = _name_fragment((table,)) if table else ident

    col_ref = Alt(column, Seq(table_ref, Lit("."), column))
    number = Seq(Opt(Lit("-")), Plus(Chars(_DIGITS)),
                 Opt(Seq(Lit("."), Plus(Chars(_DIGITS)))))
    string_lit = Seq(Lit("'"), Star(Chars(STRING_CHARS)), Lit("'"))
    agg = Alt(*[kw(a) for a in AGGREGATES])
    func_call = Seq(agg, OWS, Lit("("), OWS,
                    Alt(col_ref, Lit("*")), OWS, Lit(")"))
    operand = Alt(col_ref, number, string_lit, func_call)
    cmp = Alt(Lit("="), Lit("<="), Lit(">="), Lit("<>"), Lit("!="),
              Lit("<"), Lit(">"))
    # IS [NOT] NULL applies to column references (the only operand that
    # can be null in this subset); [NOT] LIKE takes a string-literal
    # pattern ('%'/'_' wildcards are already in STRING_CHARS). Both are
    # word-keyword predicates, so WS separation is mandatory like every
    # other clause keyword.
    null_pred = Seq(col_ref, WS, kw("IS"), WS,
                    Opt(Seq(kw("NOT"), WS)), kw("NULL"))
    like_pred = Seq(col_ref, WS, Opt(Seq(kw("NOT"), WS)),
                    kw("LIKE"), WS, string_lit)
    # [NOT] IN takes a parenthesized non-empty list of scalar literals
    # or column refs (no nested selects in this subset); [NOT]
    # BETWEEN lo AND hi keeps WS around its keywords mandatory — the
    # AND here binds to BETWEEN, which the reference parser
    # disambiguates by consuming it eagerly (parser.py).
    scalar = Alt(col_ref, number, string_lit)
    in_pred = Seq(col_ref, WS, Opt(Seq(kw("NOT"), WS)), kw("IN"), OWS,
                  Lit("("), OWS, scalar,
                  Star(Seq(OWS, Lit(","), OWS, scalar)), OWS, Lit(")"))
    between_pred = Seq(col_ref, WS, Opt(Seq(kw("NOT"), WS)),
                       kw("BETWEEN"), WS, scalar, WS, kw("AND"), WS,
                       scalar)
    predicate = Alt(Seq(operand, OWS, cmp, OWS, operand),
                    null_pred, like_pred, in_pred, between_pred)
    # WHERE/HAVING conditions allow ONE level of parenthesized boolean
    # grouping — `( pred OR pred ) AND pred` — which covers the common
    # precedence-fixing shape without making the regular grammar try to
    # count nesting depth (a DFA cannot balance unbounded parens; the
    # reference parser accepts the same bounded depth, tested together
    # in tests/test_constrain.py). JOIN..ON keeps a bare predicate.
    bool_chain = Seq(predicate,
                     Star(Seq(WS, Alt(kw("AND"), kw("OR")), WS, predicate)))
    group_term = Seq(Lit("("), OWS, bool_chain, OWS, Lit(")"))
    bool_term = Alt(predicate, group_term)
    condition = Seq(bool_term,
                    Star(Seq(WS, Alt(kw("AND"), kw("OR")), WS, bool_term)))

    sel_item = Seq(Alt(func_call, col_ref),
                   Opt(Seq(WS, kw("AS"), WS, ident)))
    sel_list = Alt(Lit("*"),
                   Seq(sel_item, Star(Seq(OWS, Lit(","), OWS, sel_item))))

    join = Seq(WS, Opt(Seq(Alt(kw("INNER"), kw("LEFT"), kw("RIGHT")), WS)),
               kw("JOIN"), WS, table_ref, WS, kw("ON"), WS, predicate)
    where = Seq(WS, kw("WHERE"), WS, condition)
    group = Seq(WS, kw("GROUP"), WS, kw("BY"), WS,
                col_ref, Star(Seq(OWS, Lit(","), OWS, col_ref)),
                Opt(Seq(WS, kw("HAVING"), WS, condition)))
    # ORDER BY may name a SELECT alias, so its key stays a generic
    # identifier even in schema mode.
    order_key = Alt(func_call, col_ref, ident)
    order_item = Seq(order_key, Opt(Seq(WS, Alt(kw("ASC"), kw("DESC")))))
    order = Seq(WS, kw("ORDER"), WS, kw("BY"), WS,
                order_item, Star(Seq(OWS, Lit(","), OWS, order_item)))
    limit = Seq(WS, kw("LIMIT"), WS, Plus(Chars(_DIGITS)))

    return Seq(
        OWS, kw("SELECT"), WS, Opt(Seq(kw("DISTINCT"), WS)), sel_list,
        WS, kw("FROM"), WS, table_ref,
        Star(join), Opt(where), Opt(group), Opt(order), Opt(limit),
        OWS, Opt(Lit(";")), OWS,
    )


@functools.lru_cache(maxsize=16)
def spark_sql_dfa(
    table: Optional[str] = None,
    columns: Optional[Tuple[str, ...]] = None,
) -> CharDfa:
    """Compile the SELECT subset to a trimmed char-level DFA (cached per
    schema — the generic grammar compiles once per process)."""
    return compile_dfa(_build(table, columns))


def grammar_fingerprint(
    table: Optional[str] = None,
    columns: Optional[Tuple[str, ...]] = None,
) -> str:
    """Stable identity for a grammar variant — the cache/compat key the
    mask compiler and the scheduler's install gate both use. repr-based so
    schemas cannot collide on separator characters (columns ('a,b',) and
    ('a', 'b') must NOT share a key — a collision would serve one schema's
    compiled masks to the other's requests)."""
    if table is None and columns is None:
        return "spark_sql"
    return f"spark_sql:{table!r}:{tuple(columns or ())!r}"

"""Scoring metrics for NL→SQL quality: exact match, Levenshtein distance,
and execution match.

Exact match + edit distance are the reference's metrics (reference
`Model_Evaluation_&_Comparision.py:45-51`: stripped string equality and
`Levenshtein.distance`). Uses the C-accelerated `Levenshtein` package when
importable, with an in-tree two-row DP fallback so the harness has zero hard
dependencies.

`execution_match` goes beyond the reference: string metrics punish
semantically identical SQL (alias names, whitespace, clause order), so the
harness can additionally RUN both queries against the in-tree SQL backend
and compare result sets — Spider's execution-accuracy notion, possible here
because the framework ships its own SQL engine seam (sql/backend.py).

A copy of the JAX package's `evalh/metrics.py`.
"""

from __future__ import annotations

from typing import Optional

try:
    from Levenshtein import distance as _lev
except ImportError:  # pragma: no cover
    _lev = None


def exact_match(generated: str, expected: str) -> int:
    return int(generated.strip() == expected.strip())


def edit_distance(a: str, b: str) -> int:
    if _lev is not None:
        return _lev(a, b)
    return _edit_distance_dp(a, b)


def _norm_cell(x) -> str:
    """Value normalization for result comparison: floats round to 6 places
    (engine-dependent float formatting must not fail a match), everything
    else compares as its string form."""
    if isinstance(x, float):
        return f"{round(x, 6):.6f}"
    return str(x)


_FORBIDDEN = (
    "insert", "update", "delete", "drop", "alter", "create", "replace",
    "attach", "detach", "pragma", "vacuum", "reindex",
)


def _is_query(sql: str) -> bool:
    """Read-only guard: only SELECT/WITH statements may run, and no
    mutating keyword may appear ANYWHERE (SQLite allows WITH-prefixed
    DELETE/UPDATE/INSERT, so checking the head token alone is not enough).
    Generated SQL is model output — a mutation would corrupt the SHARED
    fixture backend and silently poison every later case's scoring. A rare
    false positive (a string literal containing a keyword) just scores the
    case conservatively. Defense in depth: the fixture backend is also set
    engine-level read-only (SQLiteBackend.set_read_only), and sqlite3's
    execute rejects multi-statement strings."""
    import re

    head = re.match(r"\s*([A-Za-z]+)", sql or "")
    if not head or head.group(1).upper() not in ("SELECT", "WITH"):
        return False
    lowered = sql.lower()
    return not any(
        re.search(rf"\b{kw}\b", lowered) for kw in _FORBIDDEN
    )


def executes(generated: str, backend) -> bool:
    """Executability oracle (weaker than execution_match, no expected query
    needed): does the generated statement RUN on the backend at all? This
    is the metric grammar-constrained decoding moves directly — a
    completion that parses under the in-tree grammar should also execute —
    reported beside grammar-valid% in the constrained-vs-unconstrained
    tables. Non-SELECT statements never execute (same _is_query guard)."""
    if not _is_query(generated):
        return False
    try:
        backend.execute(generated)
    except Exception:
        return False
    return True


def execution_outcome(
    generated: str, expected: str, backend
) -> "tuple[Optional[bool], bool, str]":
    """(execution match, generated-executes, engine error) with the
    generated statement run AT MOST ONCE — the harness scores both metrics
    per case, and a second identical round trip per case doubled the
    oracle I/O across a suite. The third element is the engine's error
    text when the generated statement failed ("" on success) — the evalh
    explain stage routes it to the in-fleet error-analysis model, the
    same trace shape app/pipeline.explain_error handles in serving.

    Match semantics (Spider's test-suite convention): run both queries,
    compare columns-count + rows — as a multiset, EXCEPT when the expected
    query carries ORDER BY, where row order is part of the asked-for
    semantics and compares as an ordered list. None when the EXPECTED
    query itself fails (the case cannot be judged), False when only the
    generated query fails or results differ. Non-SELECT statements never
    execute (see _is_query)."""
    import re

    got = None
    gen_err = ""
    if _is_query(generated):
        try:
            got = backend.execute(generated)
            gen_ok = True
        except Exception as e:
            gen_ok = False
            gen_err = f"{type(e).__name__}: {e}"
    else:
        gen_ok = False
        gen_err = "statement rejected: not a read-only SELECT/WITH query"

    if not _is_query(expected):
        return None, gen_ok, gen_err
    try:
        exp = backend.execute(expected)
    except Exception:
        return None, gen_ok, gen_err
    if not gen_ok:
        return False, False, gen_err
    if len(got.columns) != len(exp.columns):
        return False, True, ""

    def norm(rows):
        return [tuple(_norm_cell(x) for x in r) for r in rows]

    if re.search(r"\border\s+by\b", expected, re.IGNORECASE):
        return norm(got.rows) == norm(exp.rows), True, ""
    return sorted(norm(got.rows)) == sorted(norm(exp.rows)), True, ""


def execution_match(
    generated: str, expected: str, backend
) -> Optional[bool]:
    """Execution accuracy alone (see execution_outcome for the shared-run
    form and the full semantics)."""
    return execution_outcome(generated, expected, backend)[0]


def _edit_distance_dp(a: str, b: str) -> int:
    """Two-row Wagner–Fischer; O(len(a)·len(b)) time, O(len(b)) space."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(
                prev[j] + 1,          # deletion
                cur[j - 1] + 1,       # insertion
                prev[j - 1] + (ca != cb),  # substitution
            ))
        prev = cur
    return prev[-1]

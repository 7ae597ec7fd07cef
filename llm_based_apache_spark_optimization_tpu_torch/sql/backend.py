"""SQL execution backend protocol: CSV → temp view → SQL → CSV out.

This is the capability surface the reference gets from Apache Spark via py4j
(reference `Flask/app.py:95-129`, `FastAPI/app.py:68-133`): read a CSV with
header+schema inference, expose its schema as `"col (dtype)"` lines (the
text-to-SQL model's system prompt is built from exactly that string —
`FastAPI/app.py:79,85-89`), register it as the temp view `temp_view`, run a
SQL string against it, and export the result as ONE headed CSV file
(Spark's `coalesce(1)` + part-file rename dance, `FastAPI/app.py:118-133`).

Two implementations:
  - SQLiteBackend (sql/sqlite_backend.py): in-tree default, zero external
    engines — stdlib sqlite3 with Spark-compatible schema naming.
  - SparkBackend (sql/spark_backend.py): the real thing when pyspark is
    importable; the north star keeps Spark as the consumer of TPU-generated
    SQL (SURVEY.md §2.3).
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Protocol, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class TableSchema:
    """Column names + Spark-style dtype names (bigint/double/string/...)."""

    columns: Tuple[str, ...]
    dtypes: Tuple[str, ...]

    def prompt_lines(self) -> str:
        """The exact schema string fed to the NL→SQL system prompt
        (reference `FastAPI/app.py:79`)."""
        return "\n".join(f"{c} ({t})" for c, t in zip(self.columns, self.dtypes))


@dataclasses.dataclass(frozen=True)
class ResultTable:
    columns: Tuple[str, ...]
    rows: List[Tuple]


class SQLBackend(Protocol):
    def load_csv(self, path: str, view_name: str = "temp_view") -> TableSchema:
        """Read a headed CSV, infer types, register as `view_name`."""
        ...

    def execute(self, sql: str) -> ResultTable:
        """Run SQL against registered views; raises on engine errors."""
        ...

    def write_csv(self, result: ResultTable, out_path: str) -> str:
        """Write result as ONE headed CSV file (coalesce(1) semantics)."""
        ...


def is_transient_sql_error(e: BaseException) -> bool:
    """Infra-shaped SQL failures worth retrying (and breaker-counting):
    injected chaos faults, sqlite lock/busy contention, py4j/Spark
    connection drops. A syntax/semantic error is DETERMINISTIC — retrying
    replays the same failure and must instead go straight to the
    error-analysis path."""
    from ..utils.faults import InjectedFault

    if isinstance(e, InjectedFault):
        return True
    import sqlite3

    if isinstance(e, sqlite3.OperationalError):
        msg = str(e).lower()
        return "locked" in msg or "busy" in msg
    # Spark's py4j surfaces dead-gateway errors as generic Py4JError /
    # ConnectionError shapes; match by type name so the sqlite-only image
    # needs no pyspark import.
    if isinstance(e, ConnectionError):
        return True
    return type(e).__name__ in ("Py4JNetworkError", "Py4JJavaError") and \
        "connection" in str(e).lower()


class ResilientSQLBackend:
    """SQLBackend wrapper: fault injection seams + transient-error retry +
    a circuit breaker around `execute()` (serve/resilience.py).

    The retry replays only failures `is_transient_sql_error` classifies as
    infrastructure (the queries are SELECTs over temp views — idempotent by
    construction); deterministic engine errors propagate immediately to the
    error-analysis stage, exactly as before. The breaker counts only those
    infra failures: when the engine itself is down, requests shed with
    `CircuitOpen` instead of each burning a full retry ladder, and the
    pipeline degrades along its existing SQL-failure path. Chaos seams:
    `sql:load`, `sql:exec`, and the duration-valued `sql:stall`
    (utils/faults.py)."""

    def __init__(self, inner: SQLBackend, retry=None, breaker=None,
                 rng: Optional[random.Random] = None):
        from ..serve.resilience import CircuitBreaker, RetryPolicy

        self.inner = inner
        self._retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_delay_s=0.02, max_delay_s=0.5,
        )
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            "sql backend", failure_threshold=5, reset_after_s=10.0,
        )
        self._rng = rng if rng is not None else random.Random()

    def load_csv(self, path: str, view_name: str = "temp_view") -> TableSchema:
        from ..utils import tracing
        from ..utils.faults import FAULTS

        # No retry: load failures (missing file, malformed CSV) are
        # deterministic; the seam exists so chaos runs can fail the load
        # boundary too.
        with tracing.span("sql.load", view=view_name):
            FAULTS.check("sql:load")
            return self.inner.load_csv(path, view_name)

    def execute(self, sql: str) -> ResultTable:
        from ..utils import tracing
        from ..utils.faults import FAULTS

        if not self._breaker.allow():
            raise self._breaker.shed()

        def attempt() -> ResultTable:
            # `sql:stall:p:secs` (duration-valued): a SQL engine that is
            # up but SLOW — the check sleeps, then the query runs, so
            # caller-side deadlines see real elapsed time.
            FAULTS.check("sql:stall")
            FAULTS.check("sql:exec")
            # Per-class SQL error sites (ISSUE 20): each raises a
            # REPRESENTATIVE engine error for one branch of the repair
            # taxonomy — syntax/schema are deterministic engine answers
            # (no retry, breaker records success), transient is
            # lock-contention-shaped (retried, breaker-counted).
            FAULTS.check("sql:syntax")
            FAULTS.check("sql:schema")
            FAULTS.check("sql:transient")
            return self.inner.execute(sql)

        # The span covers the whole retry ladder (what the REQUEST paid),
        # not one attempt — retries are an attr, not separate spans.
        with tracing.span("sql.exec"):
            try:
                out = self._retry.call(
                    attempt, retryable=is_transient_sql_error, rng=self._rng,
                )
            except Exception as e:
                if is_transient_sql_error(e):
                    self._breaker.record_failure()
                else:
                    # The engine answered (with an error): it is up.
                    self._breaker.record_success()
                raise
            self._breaker.record_success()
            return out

    def write_csv(self, result: ResultTable, out_path: str) -> str:
        from ..utils import tracing

        with tracing.span("sql.write_csv"):
            return self.inner.write_csv(result, out_path)

"""SQLite-backed SQL executor with Spark-compatible schema naming.

The in-tree default engine: no JVM, no py4j, no external processes. Type
inference mirrors Spark's `inferSchema=True` naming so the schema string the
NL→SQL model sees is identical to what Spark would produce for the same CSV
(reference `Flask/app.py:95-98`): integers → `int`/`bigint`, decimals →
`double`, ISO date-times → `timestamp`, everything else → `string`.

Dialect note: the generated workloads (SELECT/WHERE/GROUP BY/ORDER
BY/aggregates — the entire query surface in the reference's eval suite)
execute identically on SQLite and Spark SQL; engine-specific SQL surfaces the
same way it does in the reference — as an execution error routed to the
error-analysis model.

A copy of the JAX package's `sql/sqlite_backend.py`: type inference takes
the C++ scanner's dtypes (`native.csv_scan`, `native/csvscan.cpp`) when its
column count equals the header's, and otherwise (ragged rows, a file the
scanner refuses, `LSOT_NO_NATIVE=1`) the Python pass, which is its
behavioral reference.
"""

from __future__ import annotations

import csv
import re
import sqlite3
from pathlib import Path
from typing import List, Optional, Tuple

from .backend import ResultTable, TableSchema

_INT32_MAX = 2**31 - 1
_TS_RE = re.compile(r"^\d{4}-\d{2}-\d{2}([ T]\d{2}:\d{2}(:\d{2}(\.\d+)?)?)?$")


def _infer_dtype(values: List[str]) -> str:
    """Spark-inferSchema-compatible dtype name for one column's strings."""
    saw_float = saw_int = saw_ts = False
    max_abs = 0
    for v in values:
        if v == "" or v is None:
            continue
        if not v.isascii() or "_" in v:
            # CPython's int()/float() accept '_' separators and non-ASCII
            # digits; Spark's inferSchema does not, and neither does the
            # JAX package's native scanner. Classify them as strings so
            # all three agree.
            return "string"
        try:
            i = int(v)
            saw_int = True
            max_abs = max(max_abs, abs(i))
            continue
        except ValueError:
            pass
        try:
            float(v)
            saw_float = True
            continue
        except ValueError:
            pass
        if _TS_RE.match(v.strip()):
            saw_ts = True
            continue
        return "string"
    if saw_ts and not (saw_int or saw_float):
        return "timestamp"
    if saw_float:
        return "double"
    if saw_int:
        return "bigint" if max_abs > _INT32_MAX else "int"
    return "string"


_AFFINITY = {"int": "INTEGER", "bigint": "INTEGER", "double": "REAL",
             "timestamp": "TEXT", "string": "TEXT"}


class SQLiteBackend:
    """One backend instance = one session of views over an in-memory DB."""

    def __init__(self, db_path: str = ":memory:"):
        self._conn = sqlite3.connect(db_path, check_same_thread=False)

    def load_csv(self, path: str, view_name: str = "temp_view") -> TableSchema:
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(str(p))
        with p.open(newline="") as f:
            reader = csv.reader(f)
            try:
                header = next(reader)
            except StopIteration:
                raise ValueError(f"empty CSV: {path}")
            rows = list(reader)
        # Inference: the C++ scanner's dtypes, where it read as many
        # columns as the header has; the Python pass otherwise.
        from ..native import csv_scan

        scanned = csv_scan(p)
        if scanned is not None and len(scanned[0]) == len(header):
            dtypes = tuple(scanned[0])
        else:
            dtypes = tuple(
                _infer_dtype([r[i] if i < len(r) else "" for r in rows])
                for i in range(len(header))
            )
        cols = ", ".join(
            f'"{c}" {_AFFINITY[t]}' for c, t in zip(header, dtypes)
        )
        cur = self._conn.cursor()
        cur.execute(f'DROP TABLE IF EXISTS "{view_name}"')
        cur.execute(f'CREATE TABLE "{view_name}" ({cols})')
        placeholders = ", ".join("?" * len(header))
        norm = [
            tuple((r[i] if i < len(r) else None) if (i < len(r) and r[i] != "") else None
                  for i in range(len(header)))
            for r in rows
        ]
        cur.executemany(f'INSERT INTO "{view_name}" VALUES ({placeholders})', norm)
        self._conn.commit()
        return TableSchema(columns=tuple(header), dtypes=dtypes)

    def set_read_only(self) -> None:
        """Freeze the session: further statements may only read (sqlite
        `query_only` pragma). Used by eval execution-match scoring, which
        runs MODEL-GENERATED SQL against a shared fixture — a DELETE/DROP
        slipping through a string-level guard must still be refused by the
        engine itself."""
        self._conn.execute("PRAGMA query_only = ON")

    def execute(self, sql: str) -> ResultTable:
        cur = self._conn.cursor()
        cur.execute(sql)
        columns = tuple(d[0] for d in cur.description) if cur.description else ()
        return ResultTable(columns=columns, rows=cur.fetchall())

    def write_csv(self, result: ResultTable, out_path: str) -> str:
        out = Path(out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("w", newline="") as f:
            w = csv.writer(f)
            w.writerow(result.columns)
            w.writerows(result.rows)
        return str(out)

    def close(self) -> None:
        self._conn.close()

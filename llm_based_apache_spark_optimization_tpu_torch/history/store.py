"""Query-history store: the `query_results` audit log.

Schema parity with the reference's MySQL table (INSERT at
`Flask/app.py:36-40`; implied auto-increment `id` via `ORDER BY id DESC`
`:218`): query_results(id, input_file_name, input_data, sql_query,
output_file). Read path is the paginated history view — 8 rows per page,
newest first, has_next from COUNT(*) (`Flask/app.py:200-235`).

SQLite is the in-tree default (stdlib, zero setup); MySQL is a drop-in when
`mysql-connector-python` is installed, keeping the reference's deployment
shape available. Unlike the reference — which swallows store errors with a
print and unbound-variable bugs in its `finally` (`Flask/app.py:44-50`,
SURVEY.md §2.2 quirks) — failures here raise to the caller, and the app layer
decides to degrade gracefully.
"""

from __future__ import annotations

import dataclasses
import sqlite3
import threading
from typing import List, Protocol, Tuple

PAGE_SIZE = 8  # reference: LIMIT 8 (Flask/app.py:214, despite its "10 records" comment)


@dataclasses.dataclass(frozen=True)
class HistoryRecord:
    id: int
    input_file_name: str
    input_data: str
    sql_query: str
    output_file: str


class HistoryStore(Protocol):
    def record(self, input_file_name: str, input_data: str, sql_query: str,
               output_file: str) -> int: ...

    def page(self, page: int, page_size: int = PAGE_SIZE
             ) -> Tuple[List[HistoryRecord], bool]: ...

    def count(self) -> int: ...


_SCHEMA = """
CREATE TABLE IF NOT EXISTS query_results (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    input_file_name TEXT NOT NULL,
    input_data TEXT NOT NULL,
    sql_query TEXT NOT NULL,
    output_file TEXT NOT NULL
)
"""


class SQLiteHistory:
    def __init__(self, db_path: str = ":memory:"):
        self._conn = sqlite3.connect(db_path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute(_SCHEMA)
            self._conn.commit()

    def record(self, input_file_name: str, input_data: str, sql_query: str,
               output_file: str) -> int:
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO query_results "
                "(input_file_name, input_data, sql_query, output_file) "
                "VALUES (?, ?, ?, ?)",
                (input_file_name, input_data, sql_query, output_file),
            )
            self._conn.commit()
            return int(cur.lastrowid)

    def page(self, page: int, page_size: int = PAGE_SIZE
             ) -> Tuple[List[HistoryRecord], bool]:
        page = max(1, page)
        offset = (page - 1) * page_size
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, input_file_name, input_data, sql_query, output_file "
                "FROM query_results ORDER BY id DESC LIMIT ? OFFSET ?",
                (page_size, offset),
            ).fetchall()
            total = self._conn.execute(
                "SELECT COUNT(*) FROM query_results"
            ).fetchone()[0]
        has_next = total > page * page_size
        return [HistoryRecord(*r) for r in rows], has_next

    def count(self) -> int:
        with self._lock:
            return self._conn.execute(
                "SELECT COUNT(*) FROM query_results"
            ).fetchone()[0]

    def close(self) -> None:
        self._conn.close()


class MySQLHistory:
    """Same store over MySQL — the reference's deployment (DSN instead of the
    reference's hard-coded credentials, `Flask/app.py:28-33`)."""

    def __init__(self, host: str, user: str, password: str, database: str):
        import mysql.connector  # gated: not in the CI image

        self._connect = lambda: mysql.connector.connect(
            host=host, user=user, password=password, database=database
        )
        conn = self._connect()
        cur = conn.cursor()
        cur.execute(
            "CREATE TABLE IF NOT EXISTS query_results ("
            "id INT AUTO_INCREMENT PRIMARY KEY, "
            "input_file_name TEXT NOT NULL, input_data TEXT NOT NULL, "
            "sql_query TEXT NOT NULL, output_file TEXT NOT NULL)"
        )
        conn.commit()
        cur.close()
        conn.close()

    def record(self, input_file_name: str, input_data: str, sql_query: str,
               output_file: str) -> int:
        conn = self._connect()
        try:
            cur = conn.cursor()
            cur.execute(
                "INSERT INTO query_results "
                "(input_file_name, input_data, sql_query, output_file) "
                "VALUES (%s, %s, %s, %s)",
                (input_file_name, input_data, sql_query, output_file),
            )
            conn.commit()
            return int(cur.lastrowid)
        finally:
            conn.close()

    def page(self, page: int, page_size: int = PAGE_SIZE):
        page = max(1, page)
        conn = self._connect()
        try:
            cur = conn.cursor()
            cur.execute(
                "SELECT id, input_file_name, input_data, sql_query, output_file "
                "FROM query_results ORDER BY id DESC LIMIT %s OFFSET %s",
                (page_size, (page - 1) * page_size),
            )
            rows = cur.fetchall()
            cur.execute("SELECT COUNT(*) FROM query_results")
            total = cur.fetchone()[0]
        finally:
            conn.close()
        return [HistoryRecord(*r) for r in rows], total > page * page_size

    def count(self) -> int:
        conn = self._connect()
        try:
            cur = conn.cursor()
            cur.execute("SELECT COUNT(*) FROM query_results")
            return cur.fetchone()[0]
        finally:
            conn.close()

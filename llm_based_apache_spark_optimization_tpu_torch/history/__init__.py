"""query_results history store (SQLite default, MySQL optional); a copy of
the JAX package's `history/`."""

from .store import (  # noqa: F401
    PAGE_SIZE,
    HistoryRecord,
    HistoryStore,
    MySQLHistory,
    SQLiteHistory,
)

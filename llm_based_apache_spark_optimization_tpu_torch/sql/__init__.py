"""SQL execution backends: CSV → temp_view → SQL → single-file CSV export.

Copies of the JAX package's `sql/` modules (host code, no device): the
SQLite backend without the native CSV scanner, Spark when `pyspark` is
importable, and the resilient wrapper."""

from .backend import (  # noqa: F401
    ResilientSQLBackend,
    ResultTable,
    SQLBackend,
    TableSchema,
    is_transient_sql_error,
)
from .spark_backend import SparkBackend, spark_available  # noqa: F401
from .sqlite_backend import SQLiteBackend  # noqa: F401


def default_backend() -> SQLBackend:
    """Spark when installed (the reference's engine), else in-tree SQLite."""
    if spark_available():
        return SparkBackend()
    return SQLiteBackend()

"""PySpark-backed SQL executor — the reference's engine, behind the same
protocol.

Used when `pyspark` is importable (it is not in the CI image; the SQLite
backend is the default there). Mirrors the reference's exact Spark usage:
`read.csv(header=True, inferSchema=True)` (`Flask/app.py:95`),
`createOrReplaceTempView` (`:113`), `spark.sql` (`:115`), and the
`coalesce(1)` single-file CSV export with part-file rename (`:119-129`).

The py4j-independent logic — schema tuple building, the part-file rename
dance, the empty-result header-only export — lives in module functions so
tests can drive it without a JVM (tests/test_sql.py uses a fake session;
a `pytest.importorskip("pyspark")` integration test covers the real one).
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path
from typing import Sequence, Tuple

from .backend import ResultTable, TableSchema


def spark_available() -> bool:
    try:
        import pyspark  # noqa: F401
        return True
    except ImportError:
        return False


def schema_from_dtypes(dtypes: Sequence[Tuple[str, str]]) -> TableSchema:
    """`df.dtypes` [(name, spark_type), ...] -> TableSchema.

    The reference builds its model-facing schema string from exactly this
    list (`FastAPI/app.py:79`); the empty-dataframe case (no columns) must
    yield empty tuples, not a zip() crash.
    """
    cols, types = zip(*dtypes) if dtypes else ((), ())
    return TableSchema(columns=tuple(cols), dtypes=tuple(types))


def collect_part_file(tmp_dir: str | Path, out_path: str | Path) -> str:
    """Move the single `part-*` file of a coalesce(1) CSV write to its final
    name and clean up the Spark output directory (the rename dance of
    reference `Flask/app.py:119-129`). Raises FileNotFoundError if Spark
    produced no part file (failed/empty write)."""
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tmp_dir)
    part = next(
        (p for p in sorted(tmp.iterdir()) if p.name.startswith("part-")), None
    )
    if part is None:
        raise FileNotFoundError(f"no part-* file under {tmp}")
    shutil.move(str(part), str(out))
    shutil.rmtree(tmp, ignore_errors=True)
    return str(out)


def write_header_only_csv(columns: Sequence[str], out_path: str | Path) -> str:
    """Empty result set: a successful query still exports a headed CSV
    (same shape the SQLite backend produces, incl. quoting) — Spark's
    createDataFrame([]) cannot infer types, so this path skips the JVM."""
    import csv

    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", newline="") as f:
        csv.writer(f).writerow(columns)
    return str(out)


class SparkBackend:
    def __init__(self, app_name: str = "llm-spark-opt-tpu", spark=None):
        """`spark=None` builds/reuses the real session (requires pyspark);
        tests inject a stand-in session through the parameter."""
        if spark is None:
            from pyspark.sql import SparkSession

            spark = SparkSession.builder.appName(app_name).getOrCreate()
        self._spark = spark
        self._dfs = {}

    def load_csv(self, path: str, view_name: str = "temp_view") -> TableSchema:
        if not Path(path).exists():
            raise FileNotFoundError(path)
        df = self._spark.read.csv(path, header=True, inferSchema=True)
        df.createOrReplaceTempView(view_name)
        self._dfs[view_name] = df
        return schema_from_dtypes(df.dtypes)

    def execute(self, sql: str) -> ResultTable:
        df = self._spark.sql(sql)
        rows = [tuple(r) for r in df.collect()]
        return ResultTable(columns=tuple(df.columns), rows=rows)

    def write_csv(self, result: ResultTable, out_path: str) -> str:
        if not result.rows:
            return write_header_only_csv(result.columns, out_path)
        # Re-create a DataFrame for the Spark write path so the export uses
        # the engine's own CSV writer (coalesce(1) + part-file rename).
        df = self._spark.createDataFrame(result.rows, schema=list(result.columns))
        tmp = tempfile.mkdtemp(prefix="spark_out_")
        df.coalesce(1).write.mode("overwrite").option("header", "true").csv(tmp)
        return collect_part_file(tmp, out_path)

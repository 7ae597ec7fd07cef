"""Spider-style text-to-SQL cases: embedded subset + real-dataset loader.

BASELINE.json denominates the north-star metric on Spider (configs 4/5:
"batch=32 Spider NL questions"). The real Spider dataset is not shipped in
this image, so two sources exist:

- `load_spider(path)` — reads the real Spider JSON (dev.json/train_spider
  format: `question`, `query`, `db_id`, with schemas in tables.json) when an
  operator has it on disk.
- `SPIDER_SMOKE` — an in-tree, hand-written subset in Spider's shape
  (multiple databases, joins/aggregates/nesting of graded difficulty) so
  batch-eval plumbing and benchmarks run hermetically. These cases are
  original to this repo, not copied from Spider.

A copy of the JAX package's `evalh/spider.py`.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .fixtures import EvalCase


class SpiderLoadError(ValueError):
    """Typed failure from `load_spider`: a missing dataset
    file, unreadable JSON, a malformed example row or tables.json entry
    all raise THIS — so an eval leg over operator-supplied Spider paths
    fails with one catchable, message-bearing error instead of crashing
    mid-leg with whatever KeyError/JSONDecodeError the input produced."""


@dataclasses.dataclass(frozen=True)
class SpiderCase:
    db_id: str
    schema_ddl: str  # CREATE TABLE statements, the model-facing system prompt
    nl: str
    expected_sql: str

    def as_eval_case(self) -> EvalCase:
        return EvalCase(nl=self.nl, expected_sql=self.expected_sql)


_CONCERT_DDL = (
    "CREATE TABLE stadium (stadium_id int, name text, capacity int, "
    "city text); "
    "CREATE TABLE concert (concert_id int, concert_name text, "
    "stadium_id int, year int); "
    "CREATE TABLE singer (singer_id int, name text, age int, country text); "
    "CREATE TABLE singer_in_concert (concert_id int, singer_id int);"
)

_SHOP_DDL = (
    "CREATE TABLE products (product_id int, name text, price double, "
    "category text); "
    "CREATE TABLE orders (order_id int, product_id int, quantity int, "
    "order_date date, customer_id int); "
    "CREATE TABLE customers (customer_id int, name text, city text);"
)

_FLIGHT_DDL = (
    "CREATE TABLE airports (airport_code text, airport_name text, city text); "
    "CREATE TABLE flights (flight_id int, source_airport text, "
    "dest_airport text, departure_time timestamp, price double);"
)

SPIDER_SMOKE: List[SpiderCase] = [
    SpiderCase(
        "concert_singer", _CONCERT_DDL,
        "How many singers are there?",
        "SELECT COUNT(*) FROM singer;",
    ),
    SpiderCase(
        "concert_singer", _CONCERT_DDL,
        "List the name and capacity of every stadium in Sydney.",
        "SELECT name, capacity FROM stadium WHERE city = 'Sydney';",
    ),
    SpiderCase(
        "concert_singer", _CONCERT_DDL,
        "Show each year and the number of concerts held that year.",
        "SELECT year, COUNT(*) FROM concert GROUP BY year;",
    ),
    SpiderCase(
        "concert_singer", _CONCERT_DDL,
        "What are the names of singers who performed in more than one concert?",
        "SELECT s.name FROM singer s JOIN singer_in_concert sc "
        "ON s.singer_id = sc.singer_id GROUP BY s.singer_id, s.name "
        "HAVING COUNT(*) > 1;",
    ),
    SpiderCase(
        "shop", _SHOP_DDL,
        "What is the average price of products in each category?",
        "SELECT category, AVG(price) FROM products GROUP BY category;",
    ),
    SpiderCase(
        "shop", _SHOP_DDL,
        "List the names of customers who placed orders for more than 10 items "
        "in total.",
        "SELECT c.name FROM customers c JOIN orders o "
        "ON c.customer_id = o.customer_id GROUP BY c.customer_id, c.name "
        "HAVING SUM(o.quantity) > 10;",
    ),
    SpiderCase(
        "shop", _SHOP_DDL,
        "Find the most expensive product.",
        "SELECT name FROM products ORDER BY price DESC LIMIT 1;",
    ),
    SpiderCase(
        "flight_2", _FLIGHT_DDL,
        "How many flights depart from each airport?",
        "SELECT source_airport, COUNT(*) FROM flights GROUP BY source_airport;",
    ),
    SpiderCase(
        "flight_2", _FLIGHT_DDL,
        "What is the cheapest flight from JFK to LAX?",
        "SELECT MIN(price) FROM flights WHERE source_airport = 'JFK' "
        "AND dest_airport = 'LAX';",
    ),
    SpiderCase(
        "flight_2", _FLIGHT_DDL,
        "List the cities with more than 2 airports.",
        "SELECT city, COUNT(*) FROM airports GROUP BY city "
        "HAVING COUNT(*) > 2;",
    ),
]


def _ddl_from_tables_json(tables) -> Dict[str, str]:
    """db_id -> flattened CREATE TABLE DDL from Spider's tables.json entry."""
    if not isinstance(tables, list):
        raise SpiderLoadError(
            f"tables.json must be a JSON array of database entries, "
            f"got {type(tables).__name__}")
    out = {}
    for i, db in enumerate(tables):
        try:
            db_id = db["db_id"]
            stmts = []
            names = db["table_names_original"]
            cols_by_table: Dict[int, List[Tuple[str, str]]] = {}
            for (t_idx, col), ctype in zip(
                db["column_names_original"], db["column_types"]
            ):
                if t_idx >= 0:
                    cols_by_table.setdefault(t_idx, []).append((col, ctype))
            for t_idx, tname in enumerate(names):
                cols = ", ".join(
                    f"{c} {t}" for c, t in cols_by_table.get(t_idx, [])
                )
                stmts.append(f"CREATE TABLE {tname} ({cols});")
        except (KeyError, TypeError, ValueError) as e:
            raise SpiderLoadError(
                f"malformed tables.json entry #{i}"
                f"{' (db_id ' + repr(db.get('db_id')) + ')' if isinstance(db, dict) else ''}"
                f": {e!r}") from e
        out[db_id] = " ".join(stmts)
    return out


def load_spider(
    data_json: str | Path, tables_json: Optional[str | Path] = None,
    limit: Optional[int] = None,
) -> List[SpiderCase]:
    """Load real Spider cases (dev.json / train_spider.json layout).

    `tables_json` defaults to `tables.json` next to the data file; without
    it, cases carry an empty schema (prompt-side schema then must come from
    elsewhere).

    Every failure mode — missing file, unreadable JSON, a row without
    question/query/db_id, a malformed tables.json entry — raises the
    typed `SpiderLoadError` with the offending path/row named, so a
    harness leg iterating operator paths degrades that one leg instead
    of crashing mid-run."""
    data_json = Path(data_json)
    try:
        text = data_json.read_text()
    except OSError as e:
        raise SpiderLoadError(f"cannot read Spider data {data_json}: {e}") \
            from e
    try:
        rows = json.loads(text)
    except ValueError as e:
        raise SpiderLoadError(
            f"Spider data {data_json} is not valid JSON: {e}") from e
    if not isinstance(rows, list):
        raise SpiderLoadError(
            f"Spider data {data_json} must be a JSON array of examples, "
            f"got {type(rows).__name__}")
    if not rows:
        # An empty example list would hand a leg zero cases — its
        # rates would all be 0/0. Fail typed at the load boundary
        # where the operator can see WHICH file was empty.
        raise SpiderLoadError(f"Spider data {data_json} holds no examples")
    if tables_json is None:
        cand = data_json.parent / "tables.json"
        tables_json = cand if cand.exists() else None
    if tables_json:
        tables_path = Path(tables_json)
        try:
            tables_text = tables_path.read_text()
        except OSError as e:
            raise SpiderLoadError(
                f"cannot read Spider schemas {tables_path}: {e}") from e
        try:
            tables = json.loads(tables_text)
        except ValueError as e:
            raise SpiderLoadError(
                f"Spider schemas {tables_path} is not valid JSON: {e}") \
                from e
        ddl = _ddl_from_tables_json(tables)
    else:
        ddl = {}
    cases = []
    for i, r in enumerate(rows):
        try:
            cases.append(SpiderCase(
                db_id=r["db_id"],
                schema_ddl=ddl.get(r["db_id"], ""),
                nl=r["question"],
                expected_sql=r["query"],
            ))
        except (KeyError, TypeError) as e:
            raise SpiderLoadError(
                f"malformed Spider example #{i} in {data_json} "
                f"(need question/query/db_id): {e!r}") from e
    return cases[:limit] if limit else cases

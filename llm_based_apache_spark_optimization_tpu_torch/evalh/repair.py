"""Repair leg: executable% after k repair rounds — the paper's headline
number.

The reference paper's loop is NL → SQL → execute → on error, diagnose and
retry; every eval leg so far stopped at "did the one-shot SQL execute".
This leg drives `app/repair.RepairEngine` — the SAME loop production
requests take — against real per-database schemas (the Spider fixture
path: each case's DDL is instantiated into its own SQLite database), and
reports the cumulative executable fraction after k ∈ {0, 1, .., K}
repair rounds. k=0 is the one-shot baseline; the k=K column is what
self-healing buys.

Two suites:

- **clean** — the model's own output against the case's database. Repair
  rounds fire only where the model actually produced failing SQL.
- **injected** — every case's FIRST execution raises a representative
  engine error from one of the per-class fault sites
  (`utils/faults.SQL_FAULT_ERRORS`, cycling syntax/schema/transient), so
  every taxonomy branch is exercised deterministically and k=0 is 0% by
  construction — the suite where k=2 strictly exceeding one-shot is an
  acceptance gate, not a hope.

Counterpart of the JAX package's `evalh/repair.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from ..app.repair import RepairEngine, build_repair_prompt, classify_sql_error
from ..serve.service import GenerationService
from ..sql.sqlite_backend import SQLiteBackend
from ..utils.faults import SQL_FAULT_ERRORS
from .spider import SPIDER_SMOKE, SpiderCase

#: Injected-suite fault rotation: one representative engine error per
#: repairable taxonomy branch (type-mismatch has no injection site —
#: sqlite coerces rather than erroring, so its branch is exercised by
#: classifier tests instead).
INJECT_CYCLE = ("sql:syntax", "sql:schema", "sql:transient")

#: System prompt shape for Spider-style cases: the case DDL IS the
#: schema context (spider.SpiderCase.schema_ddl's contract). Repair
#: rounds reuse it verbatim — the prefix-reuse contract.
SPIDER_SYSTEM = "The database schema is:\n{ddl}\nAnswer with one SQL query."


@dataclasses.dataclass(frozen=True)
class RepairCaseResult:
    nl: str
    sql: str                       # last SQL attempted
    success_round: Optional[int]   # 0 = one-shot, k = after k rounds, None = never
    error_class: str = ""          # terminal class when never executable
    error: str = ""


def backend_for_ddl(ddl: str) -> SQLiteBackend:
    """Instantiate a case's CREATE TABLE DDL into its own in-memory
    SQLite database (empty tables: this leg scores EXECUTABILITY, not
    result agreement), then lock it read-only like production."""
    b = SQLiteBackend()
    for stmt in ddl.split(";"):
        if stmt.strip():
            b.execute(stmt.strip() + ";")
    b.set_read_only()
    return b


def _injected_execute(backend: SQLiteBackend, site: str) -> Callable:
    """Execute closure whose FIRST call raises `site`'s representative
    engine error (utils/faults.SQL_FAULT_ERRORS); later calls hit the
    real database. Deterministic: no registry, no env."""
    exc_cls, message = SQL_FAULT_ERRORS[site]
    fired = []

    def execute(sql: str):
        if not fired:
            fired.append(True)
            raise exc_cls(site, message)
        return backend.execute(sql)

    return execute


def run_repair_leg(
    service: GenerationService,
    model: str,
    cases: Optional[Sequence[SpiderCase]] = None,
    max_rounds: int = 2,
    inject: bool = False,
    max_new_tokens: int = 256,
) -> Dict:
    """Drive the repair loop over Spider-shaped cases; return the
    executable%-after-k report.

    `executable_after[k]` is CUMULATIVE: the fraction of cases whose SQL
    executed within k repair rounds (k=0 = one-shot). A fresh
    RepairEngine per leg (backoff 0 — eval measures rounds, not wall
    clock) keeps legs independent of each other's breaker state."""
    cases = list(SPIDER_SMOKE if cases is None else cases)
    engine = RepairEngine(max_rounds=max_rounds, backoff_s=0.0)
    results: List[RepairCaseResult] = []
    for i, case in enumerate(cases):
        backend = backend_for_ddl(case.schema_ddl)
        execute = (
            _injected_execute(backend, INJECT_CYCLE[i % len(INJECT_CYCLE)])
            if inject else backend.execute
        )
        system = SPIDER_SYSTEM.format(ddl=case.schema_ddl)
        res = service.generate(
            model=model, system=system, prompt=case.nl,
            max_new_tokens=max_new_tokens,
        )
        sql = res.response
        try:
            execute(sql)
        except Exception as first_err:  # noqa: BLE001 — classified below
            def regenerate(error_text, failed_sql, _remaining,
                           _system=system, _nl=case.nl):
                r = service.generate(
                    model=model, system=_system,
                    prompt=build_repair_prompt(_nl, failed_sql, error_text),
                    max_new_tokens=max_new_tokens,
                )
                return r.response

            outcome = engine.run(first_err, sql, execute=execute,
                                 regenerate=regenerate)
            results.append(RepairCaseResult(
                nl=case.nl, sql=outcome.sql,
                success_round=outcome.rounds if outcome.ok else None,
                error_class="" if outcome.ok else (
                    outcome.error_class or classify_sql_error(first_err)),
                error="" if outcome.ok else outcome.error,
            ))
        else:
            results.append(RepairCaseResult(
                nl=case.nl, sql=sql, success_round=0))
        backend.close()
    n = len(results) or 1
    executable_after = {
        k: sum(1 for r in results
               if r.success_round is not None and r.success_round <= k) / n
        for k in range(max_rounds + 1)
    }
    return {
        "model": model,
        "suite": "injected" if inject else "clean",
        "cases": len(results),
        "max_rounds": max_rounds,
        "executable_after": executable_after,
        "per_case": [dataclasses.asdict(r) for r in results],
    }


def format_repair_summary(report: Dict) -> str:
    """Human-readable leg summary for the evalh CLI."""
    lines = [
        f"repair leg [{report['suite']}] — model={report['model']} "
        f"cases={report['cases']} max_rounds={report['max_rounds']}",
    ]
    for k, frac in sorted(report["executable_after"].items()):
        label = "one-shot" if int(k) == 0 else f"after {k} round(s)"
        lines.append(f"  executable {label:>16}: {100.0 * frac:5.1f}%")
    stuck = [r for r in report["per_case"] if r["success_round"] is None]
    if stuck:
        lines.append(f"  unrepairable: {len(stuck)}")
        for r in stuck[:4]:
            lines.append(f"    [{r['error_class']}] {r['nl'][:60]}")
    return "\n".join(lines)

"""Self-healing SQL (ISSUE 20): the execute→diagnose→repair loop.

The reference paper's whole pitch is NL → SQL → *execute on Spark* → on
error, *diagnose and retry* — this module is that loop as a first-class
serving workload. A failed execution is classified into a typed SQL-error
taxonomy, then fed back — error text + original question + schema —
through the SAME grammar-constrained decoder that produced it (optionally
a tenant-pinned repair model), re-executed, and bounded:

- **Taxonomy** (`classify_sql_error`): syntax / schema
  (unknown-column-or-table) / type (type-mismatch) / resource /
  transient. Classification drives policy: resource errors are not
  fixable by rewriting SQL (degrade immediately); everything else earns
  bounded repair rounds.
- **Bounds**: at most `LSOT_REPAIR_MAX_ROUNDS` regenerate+re-execute
  rounds, exponential backoff between them, the whole budget charged
  against the ORIGINAL request deadline — a repair round never buys time
  the client didn't grant.
- **Breaker**: when repair ITSELF is failing (the repair generate sheds
  typed — breaker open, scheduler crashed, overloaded, deadline burned),
  a circuit breaker opens and subsequent failures degrade straight to
  the diagnosed error, exactly the §2.2 explain path that always existed.
- **QoS**: repair requests ride the `replay` class under the original
  tenant (serve/qos.py), so a repair storm is charged to its tenant's
  backfill budget and cannot starve interactive traffic — and the repair
  prompt reuses the original system prompt verbatim, so repair waves are
  near-total prefix-cache hits (the short-turn agentic traffic shape the
  serving stack was built for).

Every terminal outcome is typed: repaired (executed after ≥1 round) or
unrepairable (diagnosed error + class). Counters land in
`utils.observability.repair` (the `/metrics` reserved "repair" block and
the `lsot_repair_*` Prometheus families), and each round appends a
flight-recorder row (`REPAIR_FLIGHT`) so a postmortem can replay which
request repaired after how many rounds of what error class.

`LSOT_REPAIR=0` removes the loop entirely: the pipeline's failure path
is bit-for-bit the pre-repair explain path (chaos stage 10 asserts it).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional, Tuple

from ..serve.flightrecorder import FlightRecorder
from ..utils.observability import repair as repair_counters

log = logging.getLogger("lsot.repair")

__all__ = [
    "REPAIR_CLASSES",
    "REPAIRABLE_CLASSES",
    "RepairAttempt",
    "RepairOutcome",
    "RepairEngine",
    "REPAIR_FLIGHT",
    "classify_sql_error",
    "build_repair_prompt",
]

#: The typed SQL-error taxonomy (ISSUE 20). Fixed vocabulary — every
#: per-class counter/label is bounded by these five values.
REPAIR_CLASSES = ("syntax", "schema", "type", "resource", "transient")

#: Classes a regenerate-with-feedback round can plausibly fix. A
#: resource error (engine out of memory/disk, breaker open) is the
#: ENGINE's state, not the SQL's — rewriting the query replays it, so
#: those degrade straight to the diagnosed error.
REPAIRABLE_CLASSES = frozenset({"syntax", "schema", "type", "transient"})

#: Process-wide repair flight ring: one row per repair round + one
#: terminal event per repaired/unrepairable request — the postmortem
#: columns (request_id, error_class, round, outcome) the /metrics
#: "repair" block surfaces under "recent".
REPAIR_FLIGHT = FlightRecorder(replica="repair")

# Message fragments → class, checked in order (first hit wins). Both
# sqlite's and Spark's error shapes are represented so the classifier
# serves the in-tree backend and the north-star consumer alike.
_CLASS_PATTERNS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("schema", ("no such table", "no such column", "unknown column",
                "table or view not found", "cannot resolve",
                "ambiguous column", "not found in")),
    ("type", ("type mismatch", "datatype mismatch", "cannot cast",
              "incompatible type", "invalid input syntax for type",
              "could not convert")),
    ("resource", ("out of memory", "disk full", "disk i/o error",
                  "too many", "resource exhausted", "limit exceeded",
                  "circuit", "overloaded")),
    ("syntax", ("syntax error", "parseexception", "mismatched input",
                "unexpected token", "incomplete input", "parse error",
                "unrecognized token")),
)


def classify_sql_error(e: BaseException) -> str:
    """Classify an execution failure into the repair taxonomy.

    Injected per-class sites (utils/faults.SQL_FAULT_ERRORS) classify by
    their site name — the deterministic chaos anchor; infra-shaped
    failures (sql/backend.is_transient_sql_error: lock contention,
    connection drops, injected transients) are `transient`; typed
    capacity sheds (CircuitOpen/Overloaded) are `resource`; everything
    else classifies by engine-message shape, defaulting to `syntax` —
    the broadest model-authored-error class, whose repair policy
    (regenerate with the error text) is also the correct generic move."""
    from ..serve.resilience import CircuitOpen, Overloaded
    from ..sql.backend import is_transient_sql_error
    from ..utils.faults import InjectedSQLError

    if isinstance(e, InjectedSQLError):
        point = e.site.rpartition(":")[2]
        return point if point in REPAIR_CLASSES else "syntax"
    if isinstance(e, (CircuitOpen, Overloaded)):
        return "resource"
    if is_transient_sql_error(e):
        return "transient"
    msg = str(e).lower()
    for cls, needles in _CLASS_PATTERNS:
        if any(n in msg for n in needles):
            return cls
    return "syntax"


def build_repair_prompt(question: str, failed_sql: str, error: str) -> str:
    """The repair request body: original question + the SQL that failed +
    the engine's error text. The SYSTEM prompt is deliberately not here —
    callers reuse the original schema system prompt verbatim, which is
    what makes repair waves near-total prefix-cache hits."""
    return (
        f"{question}\n\n"
        f"The SQL query previously generated for this question:\n\n"
        f"{failed_sql}\n\n"
        f"failed with this error:\n\n{error}\n\n"
        f"Write a corrected SQL query that answers the question."
    )


@dataclasses.dataclass(frozen=True)
class RepairAttempt:
    """One diagnose→regenerate→re-execute round's record."""

    round: int
    error_class: str
    error: str
    failed_sql: str


@dataclasses.dataclass(frozen=True)
class RepairOutcome:
    """Terminal, typed result of one repair loop."""

    ok: bool
    sql: str                 # last SQL attempted (the repaired one when ok)
    result: object = None    # the execute() value when ok
    rounds: int = 0          # repair rounds actually issued
    repaired: bool = False   # ok via >= 1 repair round
    error_class: str = ""    # terminal class when not ok
    error: str = ""          # terminal engine/diagnosis error when not ok
    degraded: str = ""       # "" | breaker_open | deadline | unrepairable
                             # | rounds_exhausted | repair_failed
    attempts: Tuple[RepairAttempt, ...] = ()


class RepairEngine:
    """Bounded, backoff-governed, breaker-guarded repair loop.

    Decoupled from prompt construction on purpose: callers pass
    `regenerate(error_text, failed_sql, remaining_deadline_s) -> sql`
    and `execute(sql) -> result` closures, so the pipeline (service +
    QoS + grammar) and the eval harness (per-database fixture backends)
    measure the SAME loop. One engine instance is shared across requests
    — the breaker's whole point is remembering that repair has been
    failing lately."""

    def __init__(
        self,
        max_rounds: int = 2,
        backoff_s: float = 0.05,
        breaker=None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        from ..serve.resilience import CircuitBreaker

        self.max_rounds = max(0, int(max_rounds))
        self.backoff_s = max(0.0, float(backoff_s))
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            "sql repair", failure_threshold=3, reset_after_s=30.0,
        )
        self._sleep = sleep

    def run(
        self,
        first_error: BaseException,
        first_sql: str,
        execute: Callable[[str], object],
        regenerate: Callable[[str, str, Optional[float]], str],
        deadline=None,
        request_id: str = "",
    ) -> RepairOutcome:
        """Drive the loop for one already-failed execution. Never raises:
        every path returns a typed RepairOutcome (the bounded-termination
        contract chaos stage 10 asserts)."""
        from ..serve.resilience import (
            CircuitOpen,
            DeadlineExceeded,
            Overloaded,
            SchedulerCrashed,
        )

        attempts: List[RepairAttempt] = []
        err: BaseException = first_error
        sql = first_sql

        def terminal(degraded: str, rounds: int, cls: str) -> RepairOutcome:
            repair_counters.inc("unrepairable")
            repair_counters.inc(f"diagnosed_{cls}")
            REPAIR_FLIGHT.event(
                "repair_terminal", request_id=request_id, outcome=degraded,
                error_class=cls, rounds=rounds,
            )
            return RepairOutcome(
                ok=False, sql=sql, rounds=rounds, error_class=cls,
                error=str(err), degraded=degraded, attempts=tuple(attempts),
            )

        cls = classify_sql_error(err)
        if self.max_rounds <= 0 or cls not in REPAIRABLE_CLASSES:
            return terminal("unrepairable", 0, cls)
        if not self.breaker.allow():
            # Repair itself has been failing: skip the loop, return the
            # diagnosed error straight away (the pre-repair degrade).
            repair_counters.inc("breaker_skips")
            return terminal("breaker_open", 0, cls)

        for rnd in range(1, self.max_rounds + 1):
            attempts.append(RepairAttempt(
                round=rnd, error_class=cls, error=str(err), failed_sql=sql,
            ))
            if deadline is not None and deadline.expired():
                repair_counters.inc("deadline_stops")
                return terminal("deadline", rnd - 1, cls)
            if rnd > 1 and self.backoff_s > 0:
                self._sleep(self.backoff_s * (2 ** (rnd - 2)))
            remaining = deadline.remaining() if deadline is not None else None
            repair_counters.inc("repair_rounds")
            REPAIR_FLIGHT.record(
                request_id=request_id, round=rnd, error_class=cls,
                error=str(err)[:200],
            )
            try:
                sql = regenerate(str(err), sql, remaining)
            except (CircuitOpen, DeadlineExceeded, Overloaded,
                    SchedulerCrashed) as gen_err:
                # The REPAIR PATH is unavailable — that is what the
                # breaker counts, so a storm of failing repairs degrades
                # to diagnosis instead of hammering a down fleet.
                self.breaker.record_failure()
                log.warning("repair generate unavailable (%s); degrading "
                            "to the diagnosed error", type(gen_err).__name__)
                if isinstance(gen_err, DeadlineExceeded):
                    repair_counters.inc("deadline_stops")
                    return terminal("deadline", rnd, cls)
                return terminal("repair_failed", rnd, cls)
            self.breaker.record_success()
            try:
                result = execute(sql)
            except Exception as exec_err:  # noqa: BLE001 — classified below
                err = exec_err
                cls = classify_sql_error(err)
                if cls not in REPAIRABLE_CLASSES:
                    return terminal("unrepairable", rnd, cls)
                continue
            repair_counters.inc("repaired")
            REPAIR_FLIGHT.event(
                "repair_terminal", request_id=request_id, outcome="repaired",
                error_class=cls, rounds=rnd,
            )
            return RepairOutcome(
                ok=True, sql=sql, result=result, rounds=rnd, repaired=True,
                attempts=tuple(attempts),
            )
        return terminal("rounds_exhausted", self.max_rounds, cls)


def repair_metrics_block() -> dict:
    """The reserved "repair" /metrics block: the monotonic counters plus
    the last few flight rows — empty dict when the loop never ran, so a
    repair-free deployment's /metrics is byte-identical to before."""
    counters = repair_counters.snapshot()
    if not any(counters.values()):
        return {}
    block = dict(counters)
    block["recent"] = REPAIR_FLIGHT.snapshot(8)
    return block

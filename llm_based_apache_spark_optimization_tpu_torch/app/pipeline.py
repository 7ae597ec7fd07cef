"""The NL→SQL pipeline: one implementation behind both app frontends.

Reference equivalent: the duplicated handler bodies of `Flask/app.py:75-172`
and `FastAPI/app.py:62-144`. Stages (status strings are the §2.2 behavioral
contract, surfaced through the per-request status feed):

  upload/stage CSV → load into SQL backend + extract schema → NL→SQL via the
  generation service → execute → write single CSV → record history; on SQL
  failure, route the engine error to the error-analysis model.

Differences from the reference, by design (SURVEY.md §2.2 quirks — fixed,
shapes kept):
  - status is per-pipeline-run, not a process-global (the reference's race);
  - the export timestamp is computed per run, not once at import;
  - history-store failures degrade gracefully but are logged, never fatal
    (same user-facing behavior, without unbound-variable crashes).

A copy of the JAX package's `app/pipeline.py` over the port's serving
stack, schema-constrained generation (`constrain_sql`) included: the
uploaded CSV's identifier-shaped columns and the view name are compiled
into the SQL model's grammar, and the repair loop regenerates through the
same grammar.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Callable, Optional

from ..history.store import HistoryStore
from ..serve.service import GenerationService
from ..sql.backend import SQLBackend
from .config import AppConfig

log = logging.getLogger("lsot.pipeline")

# §2.2 status-stage strings (Flask/app.py:79-146,152-169).
ST_UPLOAD = "Uploading file..."
ST_LOAD = "CSV file loading into Spark."
ST_GEN = "Generating SQL query..."
ST_GEN_OK = "SQL query generated successfully."
ST_EXEC = "Executing query in Spark..."
ST_SAVE_CSV = "Saving results to CSV..."
ST_SAVE_DB = "Saving results to MySQL..."
ST_ERR = "Error occurred"
ST_ERR_RESOLVE = "Trying to resolve error..."
ST_ERR_DONE = "Error resolved"
# Self-healing SQL (app/repair.py) — new stage, emitted only when a repair
# round actually runs, so LSOT_REPAIR=0 status feeds are byte-identical.
ST_REPAIR = "Repairing SQL query..."


@dataclasses.dataclass
class PipelineResult:
    ok: bool
    input_file_name: str
    input_data: str
    table_schema: str = ""
    sql_query: str = ""
    output_file: str = ""
    error_message: str = ""
    error_solution: str = ""


StatusCb = Callable[[str, str], None]  # (status, message)


def _noop_status(status: str, message: str) -> None:
    pass


class Pipeline:
    def __init__(
        self,
        service: GenerationService,
        sql_backend,
        history: Optional[HistoryStore],
        config: AppConfig,
    ):
        """`sql_backend` is a zero-arg factory (e.g. the SQLiteBackend class
        itself) or a single instance. A factory gives each run its own
        backend — its own connection and its own `temp_view` — so concurrent
        requests can't read each other's tables (the reference shares one
        SparkSession-wide view across all users, `Flask/app.py:16,113`)."""
        from ..sql.backend import ResilientSQLBackend

        self.service = service
        raw_factory = (
            sql_backend if callable(sql_backend) else (lambda: sql_backend)
        )
        # One shared breaker across runs (the wrapper is per-run, like the
        # backend): transient exec failures retry with backoff, and a DOWN
        # engine sheds with CircuitOpen instead of burning a retry ladder
        # per request — which the error-analysis fallback then degrades
        # exactly like any other SQL failure (§2.2 contract preserved).
        from ..serve.resilience import CircuitBreaker

        shared_breaker = CircuitBreaker(
            "sql backend", failure_threshold=config.breaker_threshold,
            reset_after_s=config.breaker_reset_s,
        )
        self._sql_factory = lambda: ResilientSQLBackend(
            raw_factory(), breaker=shared_breaker,
        )
        self.history = history
        self.config = config
        # Self-healing SQL (app/repair.py): ONE engine — hence one
        # breaker — shared across runs, so "repair has been failing
        # lately" is remembered between requests. None when
        # LSOT_REPAIR=0: the failure path below is then the pre-repair
        # explain path, bit for bit.
        self._repair_engine = None
        if config.repair and config.repair_max_rounds > 0:
            from .repair import RepairEngine

            self._repair_engine = RepairEngine(
                max_rounds=config.repair_max_rounds,
                backoff_s=config.repair_backoff_s,
                breaker=CircuitBreaker(
                    "sql repair",
                    failure_threshold=config.repair_breaker_threshold,
                    reset_after_s=config.repair_breaker_reset_s,
                ),
            )

    def run(
        self,
        file_path: str,
        input_text: str,
        status: StatusCb = _noop_status,
        request_id: str = "",
        tenant: str = "",
    ) -> PipelineResult:
        """Execute the full pipeline for one staged CSV + NL question.

        `tenant` (ISSUE 20) threads the front door's tenant id through to
        the generation service — the initial generate AND any repair
        rounds are admitted/charged under it, and repair rides its prefix
        namespace. "" = the single-tenant behavior, unchanged."""
        cfg = self.config
        file_name = Path(file_path).name
        result = PipelineResult(ok=False, input_file_name=file_name,
                                input_data=input_text)
        sql = self._sql_factory()
        # The repair budget is charged against the ORIGINAL request
        # deadline: start the clock before the first generate, so rounds
        # spend what the client granted, never more.
        repair_deadline = None
        if self._repair_engine is not None and cfg.deadline_s:
            from ..serve.resilience import Deadline

            repair_deadline = Deadline.after(cfg.deadline_s)

        status("processing", ST_LOAD)
        schema = sql.load_csv(file_path, cfg.view_name)
        result.table_schema = schema.prompt_lines()

        status("processing", ST_GEN)
        # Schema-aware constrained decoding (opt-in, constrain/): the SAME
        # schema string that seeds the prompt is compiled into the
        # decoder's identifier grammar — the model cannot hallucinate a
        # column that is not in the uploaded table, and the L3
        # error-diagnosis path stops being the only defense against
        # unparseable SQL.
        constrain = None
        if cfg.constrain_sql:
            from ..constrain.grammar import is_constrainable_identifier

            # Only identifier-shaped headers can enter the grammar (a CSV
            # column like "Trip Distance" is quoted by the SQL backend but
            # cannot be emitted unambiguously by the decoder); with no
            # usable column the run degrades to unconstrained rather than
            # failing the request.
            # The view name enters the grammar's table branch exactly like
            # columns enter the identifier branch — same shape rule, same
            # degrade-to-unconstrained policy (LSOT_VIEW_NAME is
            # env-settable; a reserved or quoted-only name must not turn
            # every upload into a deep compile error).
            if not is_constrainable_identifier(cfg.view_name):
                log.warning(
                    "constrain_sql: view name %r is not identifier-shaped; "
                    "generating unconstrained", cfg.view_name,
                )
            else:
                cols = [c for c in schema.columns
                        if is_constrainable_identifier(c)]
                dropped = [c for c in schema.columns if c not in cols]
                if dropped:
                    # Loud either way: a dropped column is UNSPELLABLE
                    # under the grammar, so questions about it will be
                    # answered with confidently wrong SQL over the
                    # remaining columns.
                    log.warning(
                        "constrain_sql: column(s) %s in %s are not "
                        "identifier-shaped and cannot enter the grammar — "
                        "the model cannot reference them%s",
                        dropped, file_name,
                        "" if cols else "; generating unconstrained",
                    )
                if cols:
                    constrain = {"table": cfg.view_name, "columns": cols}
        # §2.2 NL→SQL system prompt, verbatim (FastAPI/app.py:85-89).
        res = self.service.generate(
            model=cfg.sql_model,
            system=(
                f"Table name is {cfg.view_name}. "
                f"The structure of the table is:\n{result.table_schema}"
            ),
            prompt=input_text,
            max_new_tokens=cfg.max_new_tokens,
            constrain=constrain,
            # Per-request latency budget (LSOT_DEADLINE_S; 0 = none):
            # enforced end to end by deadline-capable backends — the
            # request fails typed instead of pinning a slot forever.
            deadline_s=cfg.deadline_s or None,
            # Correlation: without this, an UNSAMPLED /process-data/
            # request's structured log line would carry no request_id —
            # the id the client got in X-Request-Id would grep to
            # nothing.
            request_id=request_id or None,
            tenant=tenant,
        )
        result.sql_query = res.response
        status("processing", ST_GEN_OK)

        status("processing", ST_EXEC)
        try:
            table = sql.execute(result.sql_query)
        except Exception as e:
            table = None
            if self._repair_engine is not None:
                table = self._repair_sql(
                    e, result, sql, constrain, input_text, status,
                    request_id, tenant, repair_deadline,
                )
            if table is None:
                if not result.error_message:
                    result.error_message = str(e)
                result.error_solution = self.explain_error(
                    result.error_message, status)
                return result

        status("processing", ST_SAVE_CSV)
        stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
        out_path = str(Path(cfg.output_dir) / f"{stamp}_{file_name}.csv")
        result.output_file = sql.write_csv(table, out_path)

        status("processing", ST_SAVE_DB)
        if self.history is not None:
            try:
                from ..utils import tracing

                with tracing.span("history.record"):
                    self.history.record(
                        file_name, input_text, result.sql_query,
                        result.output_file,
                    )
            except Exception:
                # Reference parity: a history outage must not fail the request
                # (Flask/app.py:44-45) — but we log instead of print-and-lose.
                log.exception("history store failed; continuing")

        result.ok = True
        status("done", "done")
        return result

    def _repair_sql(self, first_error, result, sql, constrain, input_text,
                    status, request_id, tenant, deadline):
        """Drive the bounded repair loop (app/repair.py) for one failed
        execution: error text + original question + schema back through
        the constrained decoder, re-execute, up to
        LSOT_REPAIR_MAX_ROUNDS. Returns the repaired ResultTable (with
        result.sql_query updated to the query that actually ran) or None
        — with result.error_message already holding the terminal
        diagnosed engine error for the explain path."""
        from .repair import build_repair_prompt

        cfg = self.config
        status("processing", ST_REPAIR)
        model = cfg.repair_model or cfg.sql_model
        if cfg.repair_model and cfg.repair_model not in self.service.models():
            # A pinned-but-unregistered repair model must not turn a
            # diagnosable SQL error into a dead request: fall back loudly.
            log.warning(
                "repair model %r is not registered (available: %s); "
                "repairing with the SQL model instead",
                cfg.repair_model, self.service.models(),
            )
            model = cfg.sql_model
        # The ORIGINAL system prompt, verbatim: a repair wave's prefill
        # prefix-hits the schema blocks the first generate already cached.
        system = (
            f"Table name is {cfg.view_name}. "
            f"The structure of the table is:\n{result.table_schema}"
        )

        def regenerate(error_text, failed_sql, remaining):
            res = self.service.generate(
                model=model,
                system=system,
                prompt=build_repair_prompt(input_text, failed_sql,
                                           error_text),
                max_new_tokens=cfg.max_new_tokens,
                constrain=constrain,
                deadline_s=(remaining if remaining is not None
                            else (cfg.deadline_s or None)),
                request_id=f"{request_id}-repair" if request_id else None,
                tenant=tenant,
                # Repair is deferrable retry traffic: it rides the
                # backfill class so a repair storm cannot starve
                # interactive requests (serve/qos.py).
                qos="replay",
            )
            return res.response

        outcome = self._repair_engine.run(
            first_error, result.sql_query,
            execute=sql.execute, regenerate=regenerate,
            deadline=deadline, request_id=request_id,
        )
        if outcome.ok:
            result.sql_query = outcome.sql
            status("processing", ST_GEN_OK)
            return outcome.result
        result.error_message = outcome.error
        return None

    def explain_error(self, error_message: str, status: StatusCb = _noop_status) -> str:
        """Error-analysis path — §2.2 prompts verbatim (FastAPI/app.py:99-111).

        Degrades gracefully: if the error-analysis model is UNAVAILABLE
        (breaker open, scheduler crashed, overloaded, deadline burned), the
        raw engine error string comes back instead — the §2.2 contract
        promises the user an `error_details` field, and a second failure
        must not turn a diagnosable SQL error into a dead request. Only
        the typed unavailability errors degrade: a misconfigured model
        name (KeyError) or a programming bug must SURFACE, not ship to
        production disguised as intended degradation."""
        from ..serve.resilience import (
            CircuitOpen,
            DeadlineExceeded,
            Overloaded,
            SchedulerCrashed,
        )

        status("error", ST_ERR_RESOLVE)
        try:
            res = self.service.generate(
                model=self.config.error_model,
                system=(
                    "You are an AI that helps troubleshoot Apache Spark errors. "
                    "Provide clear, concise solutions."
                ),
                prompt=(
                    f"The following Spark error occurred:\n\n{error_message}\n\n"
                    f"Please analyze this error and suggest possible solutions."
                ),
                max_new_tokens=self.config.max_new_tokens,
                deadline_s=self.config.deadline_s or None,
            )
        except (CircuitOpen, DeadlineExceeded, Overloaded, SchedulerCrashed):
            log.exception(
                "error-analysis model unavailable; degrading to the raw "
                "engine error"
            )
            status("error", ST_ERR_DONE)
            return error_message
        status("error", ST_ERR_DONE)
        return res.response

"""Headless JSON API — parity with the reference's FastAPI service.

`POST /process-data/` takes `{"input_text": ..., "file_name": ...}` where the
file must already exist in the input dir (no upload — reference
`FastAPI/app.py:62-73`), and returns the §2.2 contract shapes verbatim:

  missing file  → {"error": "CSV file not found at <path>"}
  SQL failure   → {"error": "SQL execution failed", "sql_query", "error_details"}
  success       → {"message": "Query executed successfully!", "input_file_name",
                   "input_data", "sql_query", "output_file"}

(`FastAPI/app.py:72-73,112-116,138-144`.)

A copy of the JAX package's `app/api.py` over the port's serving stack.
Tenant and qos labels (`X-Lsot-Tenant` / `X-Lsot-Qos` headers, which win
over the JSON fields) reach the QoS front door (serve/qos.py): an unknown
class is a 400, a shed tenant a 429 with Retry-After (before the headers of
a stream), an unregistered model a typed 4xx.
"""

from __future__ import annotations

import math
import os

from ..history.store import HistoryStore
from ..serve.resilience import (
    CircuitOpen,
    DeadlineExceeded,
    Draining,
    Overloaded,
    SchedulerCrashed,
)
from ..serve.qos import normalize_qos
from ..serve.service import GenerationService
from ..sql.backend import SQLBackend
from ..utils import tracing
from ..utils.tracing import TRACER
from .config import AppConfig
from .health import (
    add_debug_routes,
    add_health_routes,
    install_drain_gate,
    metrics_response,
)
from .pipeline import Pipeline
from .wsgi import App, Request, Response


def _retry_after_headers(exc) -> list:
    after = max(1, int(math.ceil(getattr(exc, "retry_after_s", 1.0))))
    return [("Retry-After", str(after))]


def unavailable_response(exc) -> Response:
    """Map the typed fault-tolerance errors (serve/resilience.py) to their
    HTTP semantics — used by the headless API frontend (the web UI keeps
    the reference's §2.2 page flow, routing every failure through the
    error-analysis page):

      Overloaded        → 429 + Retry-After (admission control shed it;
                          back off and resubmit)
      Draining          → 503 + Retry-After (the whole server is shutting
                          down gracefully, not one queue backing up)
      SchedulerCrashed  → 503 (engine dead — not a per-request 500)
      CircuitOpen       → 503 + Retry-After (a dependency is down; the
                          breaker names the probe window)
      DeadlineExceeded  → 504 (the request's own budget ran out)
    """
    if isinstance(exc, Draining):
        return Response.json({"error": str(exc)}, status=503,
                             headers=_retry_after_headers(exc))
    if isinstance(exc, Overloaded):
        return Response.json({"error": str(exc)}, status=429,
                             headers=_retry_after_headers(exc))
    if isinstance(exc, CircuitOpen):
        return Response.json({"error": str(exc)}, status=503,
                             headers=_retry_after_headers(exc))
    if isinstance(exc, SchedulerCrashed):
        return Response.json({"error": str(exc)}, status=503)
    return Response.json({"error": str(exc)}, status=504)


#: The except clause the API routes guard generation calls with.
UNAVAILABLE_ERRORS = (Overloaded, CircuitOpen, SchedulerCrashed,
                      DeadlineExceeded)


def create_api_app(
    service: GenerationService,
    sql_backend: SQLBackend,
    history: HistoryStore | None,
    config: AppConfig | None = None,
) -> App:
    cfg = config or AppConfig.from_env()
    cfg.ensure_dirs()
    pipeline = Pipeline(service, sql_backend, history, cfg)
    # request_id_factory: the id is born at DISPATCH and echoed as
    # X-Request-Id on every response this app produces — early 400s,
    # 404/405s, and the wsgi last-resort 500 guard included (structural;
    # a handler cannot forget the header).
    app = App(secret_key=cfg.secret_key,
              request_id_factory=tracing.new_request_id)
    # Lifecycle surface: /healthz (liveness), /readyz (readiness), the
    # SIGTERM drain gate and the observability debug routes — app/health.py.
    add_health_routes(app, service)
    add_debug_routes(app, service)
    install_drain_gate(app, service)

    def _rid(req: Request) -> str:
        """The dispatch-assigned correlation id (App.request_id_factory);
        minted here only for a Request that bypassed dispatch (direct
        handler calls in tests)."""
        if not req.request_id:
            req.request_id = tracing.new_request_id()
        return req.request_id

    @app.route("/process-data/", methods=("POST",))
    def process_data(req: Request) -> Response:
        """The id is born at dispatch and echoed on every response shape
        by the App layer; the span tree only for the head-sampled
        fraction (LSOT_TRACE_SAMPLE)."""
        return _process_data(req, _rid(req))

    def _process_data(req: Request, request_id: str) -> Response:
        try:
            data = req.json()
        except Exception:
            return Response.json({"error": "invalid JSON body"}, status=400)
        input_text = data.get("input_text", "")
        file_name = data.get("file_name", "")
        # Bare names only: os.path.join would happily follow "../" or an
        # absolute path out of the input dir.
        if not file_name or os.path.basename(file_name) != file_name:
            return Response.json({"error": "invalid file name"}, status=400)
        file_path = os.path.join(cfg.input_dir, file_name)
        if not os.path.exists(file_path):
            return Response.json(
                {"error": "CSV file not found at " + file_path})
        # Tenant identity (ISSUE 18/20): header wins, JSON field as the
        # no-proxy fallback — same extraction as /api/generate. The
        # pipeline threads it to the initial generate AND any repair
        # rounds (which ride QoS class `replay` under this tenant).
        tenant = str(req.environ.get("HTTP_X_LSOT_TENANT", "")
                     or data.get("tenant", "") or "").strip()
        trace = TRACER.begin(request_id=request_id, endpoint="/process-data/")
        try:
            with tracing.use(trace):
                with tracing.span("pipeline.run", file=file_name):
                    result = pipeline.run(file_path, input_text,
                                          request_id=request_id,
                                          tenant=tenant)
        except UNAVAILABLE_ERRORS as e:
            # Overload/outage is the SERVER's state, not a §2.2 pipeline
            # outcome: answer 429/503/504 so clients back off, instead of
            # the catch-all 500 that reads as a bug.
            return unavailable_response(e)
        finally:
            TRACER.finish(trace)
        if not result.ok:
            return Response.json({
                "error": "SQL execution failed",
                "sql_query": result.sql_query,
                "error_details": result.error_solution,
            })
        return Response.json({
            "message": "Query executed successfully!",
            "input_file_name": result.input_file_name,
            "input_data": result.input_data,
            "sql_query": result.sql_query,
            "output_file": result.output_file,
        })

    @app.route("/api/generate", methods=("POST",))
    def api_generate(req: Request) -> Response:
        """The dispatch layer echoes X-Request-Id on every response
        shape — early 400s/404s and the 500 guard included."""
        return _api_generate(req, _rid(req))

    def _api_generate(req: Request, request_id: str) -> Response:
        """Direct generation endpoint, Ollama wire shape: body
        `{"model", "prompt", "system"?, "stream"?, "max_new_tokens"?,
        "constrain"?, "deadline_s"?, "idempotency_key"?}`.
        stream=false (default) returns `{"model", "response", "done": true}`
        in one JSON object; stream=true returns NDJSON lines
        `{"model", "response": <chunk>, "done": false}` flushed per chunk,
        terminated by `{"model", "done": true}` — tokens arrive live from
        the continuous-batching scheduler. The reference app only ever
        called the blocking form (`FastAPI/app.py:85-90`).

        `constrain` opts into grammar-constrained decoding: the string
        "spark_sql" (generic SELECT subset) or
        `{"table": ..., "columns": [...]}` (schema-aware: the model cannot
        emit identifiers outside the schema). The completion is then
        guaranteed to parse under the in-tree grammar (constrain/)."""
        try:
            data = req.json()
        except Exception:
            return Response.json({"error": "invalid JSON body"}, status=400)
        model = data.get("model", "")
        prompt = data.get("prompt", "")
        if not model or not prompt:
            return Response.json(
                {"error": "both 'model' and 'prompt' are required"},
                status=400,
            )
        system = data.get("system", "")
        max_new = data.get("max_new_tokens")
        # Client input errors must be 400s, not 500s (or mid-stream error
        # lines): validate before any generation starts.
        if max_new is not None and (
            not isinstance(max_new, int) or isinstance(max_new, bool)
            or max_new < 1
        ):
            return Response.json(
                {"error": "'max_new_tokens' must be a positive integer"},
                status=400,
            )
        deadline_s = data.get("deadline_s")
        if deadline_s is not None and (
            not isinstance(deadline_s, (int, float))
            or isinstance(deadline_s, bool) or deadline_s <= 0
        ):
            return Response.json(
                {"error": "'deadline_s' must be a positive number"},
                status=400,
            )
        # Retry safety on the BLOCKING path: a resubmit carrying the same
        # key after a 503 gets the journaled result instead of a second
        # generation (supervised scheduler backends; ignored elsewhere).
        # Rejected with stream=true rather than silently dropped: a
        # deduped stream would need the journaled tokens replayed into
        # the new connection, which the streaming path does not do — a
        # client believing its key protected a retried stream would be
        # double-generating.
        idempotency_key = data.get("idempotency_key")
        if idempotency_key is not None and (
            not isinstance(idempotency_key, str) or not idempotency_key
        ):
            return Response.json(
                {"error": "'idempotency_key' must be a non-empty string"},
                status=400,
            )
        if idempotency_key is not None and data.get("stream", False):
            return Response.json(
                {"error": "'idempotency_key' applies to blocking requests "
                          "only (stream=false): a retried stream is a new "
                          "generation"},
                status=400,
            )
        constrain = data.get("constrain")
        if constrain is not None and not (
            constrain == "spark_sql"
            or (isinstance(constrain, dict)
                # Exactly the documented keys, at least one present: a
                # typo'd dict ({"Table": ...}) would otherwise pass on
                # get() defaults and silently compile the GENERIC grammar
                # while the client believes schema constraining is on.
                and constrain
                and set(constrain) <= {"table", "columns"}
                and isinstance(constrain.get("table", ""), str)
                and isinstance(constrain.get("columns", []), list)
                # Present-but-empty columns would silently compile the
                # GENERIC grammar while the client believes its schema is
                # locked.
                and constrain.get("columns", ["_"]) != []
                # Every column must be a string: a non-string entry would
                # only explode deep in grammar compilation as a 500 (or a
                # mid-stream error line) instead of this 400.
                and all(isinstance(c, str)
                        for c in constrain.get("columns", [])))
        ):
            return Response.json(
                {"error": "'constrain' must be \"spark_sql\" or "
                          "{\"table\": ..., \"columns\": [...str...]}"},
                status=400,
            )
        # Multi-tenant front door (ISSUE 18): tenant and qos class ride
        # the X-Lsot-Tenant / X-Lsot-Qos headers (gateway-injected, so
        # they win) or the JSON body; unlabeled traffic stays the ""
        # default tenant. An unknown class is the client's error — 400
        # here, never a mid-stream line.
        tenant = str(req.environ.get("HTTP_X_LSOT_TENANT", "")
                     or data.get("tenant", "") or "").strip()
        try:
            qos = normalize_qos(str(req.environ.get("HTTP_X_LSOT_QOS", "")
                                    or data.get("qos", "") or ""))
        except ValueError as e:
            return Response.json({"error": str(e)}, status=400)
        # Resolve the model BEFORE streaming: once the NDJSON generator is
        # returned, 200 headers are already on the wire and a late KeyError
        # could only abort the body — the 404 must fire here.
        if model not in service.models():
            return Response.json(
                {"error": f"model {model!r} is not registered; "
                          f"available: {service.models()}"},
                status=404,
            )
        # Head-sampled trace for the request id born in the wrapper above
        # — the correlation handle between a client report, the request
        # log line, and an exported span tree.
        trace = TRACER.begin(request_id=request_id, model=model,
                             endpoint="/api/generate")
        streaming = False
        try:
            if not data.get("stream", False):
                with tracing.use(trace):
                    res = service.generate(
                        model, prompt, system=system, max_new_tokens=max_new,
                        constrain=constrain, deadline_s=deadline_s,
                        idempotency_key=idempotency_key,
                        request_id=request_id, tenant=tenant, qos=qos,
                    )
                return Response.json({
                    "model": model, "response": res.response, "done": True,
                    "request_id": request_id,
                })

            # Pre-validate the request shape (oversize prompt / no decode
            # room / unsupported-or-uncompilable constrain spec) while a
            # 400 is still possible: the generator below runs AFTER 200
            # headers are sent, where the identical ValueError could only
            # become a mid-stream error line — and the blocking branch of
            # this same endpoint answers 400.
            service.validate(model, prompt, system=system,
                             max_new_tokens=max_new, constrain=constrain)

            # PRIME the stream before sending headers: the scheduler's
            # submit (admission control!) runs lazily on the generator's
            # first step, and a shed must be a real 429/503/504 with
            # Retry-After — under overload, exactly when backoff matters
            # most, a 200 + error line would leave streaming clients with
            # no signal to back off on. Nothing useful ever precedes the
            # first chunk, so holding the 200 until it exists costs only
            # what the client was waiting for anyway.
            inner = service.generate_stream(
                model, prompt, system=system, max_new_tokens=max_new,
                constrain=constrain, deadline_s=deadline_s,
                request_id=request_id, tenant=tenant, qos=qos,
            )
            try:
                with tracing.use(trace):
                    first = next(inner)
            except StopIteration:
                first = None
            streaming = True  # the chunks() finally owns the trace now

            def chunks():
                try:
                    try:
                        if first is not None:
                            yield {"model": model, "response": first,
                                   "done": False}
                        # tracing.stepwise: inner advances under the
                        # trace context, which is never held across our
                        # own yields (the generator/contextvar hazard).
                        for piece in tracing.stepwise(inner, trace):
                            yield {"model": model, "response": piece,
                                   "done": False}
                    except Exception as e:  # mid-stream failure: headers
                        # are already sent, so surface the error as a final
                        # line instead of severing the connection silently.
                        yield {"model": model, "error": str(e), "done": True,
                               "request_id": request_id}
                        return
                    yield {"model": model, "done": True,
                           "request_id": request_id}
                finally:
                    # Deterministic unwind on client disconnect: the
                    # service generator's finally cancels the scheduler
                    # request and records metrics.
                    inner.close()
                    TRACER.finish(trace)

            return Response.ndjson_stream(chunks())
        except UNAVAILABLE_ERRORS as e:
            # Overload / engine-dead / dependency-down / deadline burned:
            # 429/503/504 with Retry-After where meaningful — a shed
            # request is the server asking the client to back off, not a
            # client mistake (400) or a bug (500).
            return unavailable_response(e)
        except KeyError as e:
            return Response.json({"error": str(e)}, status=404)
        except ValueError as e:
            # Request-shape rejections (e.g. a prompt that leaves no decode
            # room in the serving window) are the client's error.
            return Response.json({"error": str(e)}, status=400)
        finally:
            if not streaming:
                # Blocking/error paths finish (export) the sampled trace
                # here; the streaming path hands ownership to chunks().
                TRACER.finish(trace)

    @app.route("/models")
    def models(req: Request) -> Response:
        return Response.json({
            "models": service.models(),
            "stats": service.stats,
        })

    @app.route("/metrics")
    def metrics(req: Request) -> Response:
        """Per-model serving aggregates (p50/p95 latency, decode tok/s,
        TTFT, queue wait) and the scheduler layer's stats (prefix cache,
        speculation, page pool, roofline ledger, watchdog, flight
        recorder); `?format=prometheus` renders the same payload and the
        fixed-bucket histograms in the exposition text format."""
        return metrics_response(service, req)

    return app

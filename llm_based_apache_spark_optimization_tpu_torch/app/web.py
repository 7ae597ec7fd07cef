"""Browser UI — parity with the reference's Flask app, race-free.

Routes (reference `Flask/app.py:53-235`): `GET /` form page, `GET /status`
live status feed, `POST /process-data/` multipart upload + pipeline, `GET
/show` result page, `GET /err_sol` error+solution page, `GET /history?page=N`
paginated run log, plus `GET /static/styles.css`.

Contract kept (§2.2): AJAX responses are `{"redirect": <url>}`; the error
redirect carries file_name/table_schema/sql_query/error_message/err as query
params; status stage strings are the reference's. Fixed by design: status is
per-browser-session (the reference mutates one process-global dict —
`Flask/app.py:59-72` — so concurrent users see each other's progress), and
the upload path is sanitized.

A copy of the JAX package's `app/web.py` over the port's serving stack.
"""

from __future__ import annotations

import html
import secrets
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Dict, Tuple
from urllib.parse import urlencode

from jinja2 import Environment, FileSystemLoader, select_autoescape

from ..history.store import HistoryStore
from ..serve.service import GenerationService
from ..sql.backend import SQLBackend
from ..utils import tracing
from .config import AppConfig
from .health import (
    add_debug_routes,
    add_health_routes,
    install_drain_gate,
    metrics_response,
)
from .pipeline import ST_UPLOAD, Pipeline
from .wsgi import App, Request, Response

_TEMPLATES_DIR = Path(__file__).parent / "templates"
_STATIC_DIR = Path(__file__).parent / "static"


def secure_filename(name: str) -> str:
    keep = [c if (c.isalnum() or c in "._-") else "_" for c in name]
    cleaned = "".join(keep).lstrip("._")
    return cleaned or "upload.csv"


class StatusBoard:
    """Per-session status feed (replaces the reference's racy global)."""

    def __init__(self, ttl_s: float = 3600.0):
        self._lock = threading.Lock()
        self._ttl = ttl_s
        self._entries: Dict[str, Tuple[float, str, str]] = {}

    def set(self, sid: str, status: str, message: str) -> None:
        now = time.time()
        with self._lock:
            self._entries[sid] = (now, status, message)
            dead = [k for k, (t, _, _) in self._entries.items()
                    if now - t > self._ttl]
            for k in dead:
                del self._entries[k]

    def get(self, sid: str) -> Dict[str, str]:
        with self._lock:
            entry = self._entries.get(sid)
        if entry is None:
            return {"status": "idle", "message": ""}
        _, status, message = entry
        return {"status": status, "message": message}


def create_web_app(
    service: GenerationService,
    sql_backend: SQLBackend,
    history: HistoryStore | None,
    config: AppConfig | None = None,
) -> App:
    cfg = config or AppConfig.from_env()
    cfg.ensure_dirs()
    pipeline = Pipeline(service, sql_backend, history, cfg)
    # Same dispatch-level X-Request-Id echo as the headless API: every
    # web response carries the correlation id too.
    app = App(secret_key=cfg.secret_key,
              request_id_factory=tracing.new_request_id)
    # Same lifecycle surface as the headless API (app/health.py): probes
    # and the SIGTERM drain gate are frontend-independent.
    add_health_routes(app, service)
    add_debug_routes(app, service)
    install_drain_gate(app, service)
    board = StatusBoard()
    env = Environment(
        loader=FileSystemLoader(str(_TEMPLATES_DIR)),
        autoescape=select_autoescape(["html"]),
    )

    def render(name: str, **ctx) -> Response:
        return Response.html(env.get_template(name).render(**ctx))

    def session_id(req: Request) -> str:
        sid = req.session.get("sid")
        if not sid:
            sid = secrets.token_hex(8)
            req.session["sid"] = sid
        return sid

    @app.route("/")
    def index(req: Request) -> Response:
        session_id(req)
        return render("index.html")

    @app.route("/status")
    def status(req: Request) -> Response:
        return Response.json(board.get(session_id(req)))

    @app.route("/metrics")
    def metrics(req: Request) -> Response:
        """Per-model serving aggregates and the scheduler layer's stats;
        `?format=prometheus` renders the exposition text."""
        return metrics_response(service, req)

    @app.route("/static/styles.css")
    def styles(req: Request) -> Response:
        body = (_STATIC_DIR / "styles.css").read_bytes()
        return Response(body=body, headers=[("Content-Type", "text/css")])

    @app.route("/process-data/", methods=("POST",))
    def process_data(req: Request) -> Response:
        sid = session_id(req)
        board.set(sid, "processing", ST_UPLOAD)
        upload = req.files.get("file")
        input_text = req.form.get("input_text", "")
        if upload is None or not upload.filename:
            board.set(sid, "error", "No file uploaded")
            return Response.json({"error": "no file uploaded"}, status=400)
        file_name = secure_filename(upload.filename)
        # Per-request subdirectory: concurrent uploads of the same filename
        # must not overwrite each other between this write and the pipeline's
        # read-back, while the basename (used for history/display) stays clean.
        file_path = Path(cfg.input_dir) / uuid.uuid4().hex[:12] / file_name
        file_path.parent.mkdir(parents=True, exist_ok=True)
        file_path.write_bytes(upload.content)

        # Head-sampled request trace, same as the API frontend: without
        # the installed context the pipeline's sql.load/sql.exec spans
        # would read tracing.current() == None and record nothing — a
        # sampled web request would export a tree missing exactly the
        # SQL/pipeline breakdown the README promises.
        trace = tracing.TRACER.begin(request_id=req.request_id,
                                     endpoint="/process-data/")
        try:
            try:
                try:
                    with tracing.use(trace):
                        with tracing.span("pipeline.run", file=file_name):
                            result = pipeline.run(
                                str(file_path), input_text,
                                status=lambda s, m: board.set(sid, s, m),
                                request_id=req.request_id,
                            )
                finally:
                    # The staged copy is only needed between this handler's
                    # write and the pipeline's read-back; without cleanup
                    # every upload would grow input_dir forever.
                    shutil.rmtree(file_path.parent, ignore_errors=True)
            except Exception as e:
                # Reference parity: the Flask handler routes ANY failure
                # through the LLM error-analysis page (Flask/app.py:151-172)
                # — but unlike the reference, fields that never got assigned
                # render as empty strings instead of raising NameError (§2.2
                # known quirks). The analysis call runs under the SAME
                # request trace/decision window: outside it,
                # service.generate would re-draw the head sample and export
                # a second tree under a freshly minted id that greps to
                # nothing.
                from .pipeline import PipelineResult

                result = PipelineResult(ok=False, input_file_name=file_name,
                                        input_data=input_text)
                result.error_message = str(e)
                try:
                    with tracing.use(trace):
                        result.error_solution = pipeline.explain_error(
                            str(e), status=lambda s, m: board.set(sid, s, m))
                except Exception:
                    result.error_solution = "(error analysis unavailable)"
        finally:
            tracing.TRACER.finish(trace)
        if not result.ok:
            board.set(sid, "done", "done")
            params = urlencode({
                "file_name": result.input_file_name,
                "table_schema": result.table_schema,
                "sql_query": result.sql_query,
                "error_message": result.error_message,
                "err": result.error_solution,
            })
            return Response.json({"redirect": f"/err_sol?{params}"})
        req.session["result"] = {
            "input_file_name": result.input_file_name,
            "input_data": result.input_data,
            "sql_query": result.sql_query,
            "output_file": result.output_file,
        }
        board.set(sid, "done", "done")
        return Response.json({"redirect": "/show"})

    @app.route("/show")
    def show(req: Request) -> Response:
        result = req.session.get("result")
        if not result:
            return Response.redirect("/")
        return render("show.html", result=result)

    @app.route("/err_sol")
    def err_sol(req: Request) -> Response:
        return render(
            "err_sol.html",
            file_name=req.query.get("file_name", ""),
            table_schema=req.query.get("table_schema", ""),
            sql_query=req.query.get("sql_query", ""),
            error_message=req.query.get("error_message", ""),
            err=req.query.get("err", ""),
        )

    @app.route("/history")
    def history_view(req: Request) -> Response:
        try:
            page = int(req.query.get("page", "1"))
        except ValueError:
            page = 1
        if history is None:
            records, has_next = [], False
        else:
            records, has_next = history.page(page, cfg.page_size)
        return render(
            "hist.html", records=records, page=page, has_next=has_next
        )

    return app

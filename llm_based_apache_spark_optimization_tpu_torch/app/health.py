"""Health-gated serving: /healthz, /readyz, and the drain gate.

Lifecycle endpoints for both HTTP frontends (the headless JSON API and the
web UI register the same routes — one definition, app/api.py + app/web.py):

- `GET /healthz` — LIVENESS: the process is up and the WSGI loop answers.
  Always 200 while the process serves; a dead supervisor does not fail
  liveness (readiness already pulls the instance out of rotation). A fleet
  (SchedulerPool) also carries each replica's lifecycle (`fleet`: {model:
  [{replica, state, restarts, stalls, ...}]}) and its membership counters
  (`fleet_membership`).
- `GET /readyz` — READINESS: should this instance receive traffic?
  Aggregates the supervised schedulers' lifecycle
  (`ready | restarting | degraded | dead`, serve/supervisor.py) through
  `GenerationService.health()`:

      ready       200 — serving normally
      degraded    200 — serving, but the last restart dropped work
      restarting  503 + Retry-After — the loop is being rebuilt (a loop
                  the watchdog caught wedged lands here too); the
                  Retry-After includes the restart backoff remaining
      dead        503 — restart budget exhausted; pull the instance
      draining    503 + Retry-After — SIGTERM received, shutting down

  The body carries the full health payload (per-model states and the
  restart/replay/lost/stall counters).
- **Drain gate** — a `before_request` hook: once `service.drain()` has
  been triggered (SIGTERM, app/__main__.py), every new mutating request
  (POST) answers 503 + Retry-After while in-flight work finishes, except a
  `/api/generate` POST carrying an `idempotency_key` for a model whose
  backend has a journal (the supervisor answers it from its cache, or with
  a typed `Draining` 503 itself).

Also here, for both frontends: the `/metrics` body (`metrics_response`)
and the observability debug routes (`add_debug_routes`).

Counterpart of the JAX package's `app/health.py`.
"""

from __future__ import annotations

import math

from ..serve.service import GenerationService
from .wsgi import App, Request, Response

__all__ = ["add_debug_routes", "add_health_routes", "install_drain_gate",
           "metrics_response"]


def metrics_response(service: GenerationService, req: Request) -> Response:
    """The shared `/metrics` body for both frontends: JSON by default,
    `?format=prometheus` the exposition text, anything else a 400."""
    fmt = req.query.get("format", "json")
    if fmt == "prometheus":
        from ..utils.prometheus import CONTENT_TYPE

        return Response(body=service.metrics_prometheus().encode(),
                        headers=[("Content-Type", CONTENT_TYPE)])
    if fmt != "json":
        return Response.json(
            {"error": "'format' must be json or prometheus"}, status=400)
    return Response.json(service.metrics_snapshot())


#: readiness state -> (HTTP status, include Retry-After)
_READY_STATUS = {
    "ready": (200, False),
    "degraded": (200, False),
    "restarting": (503, True),
    "dead": (503, False),
}


def _retry_after(seconds: float) -> list:
    return [("Retry-After", str(max(1, int(math.ceil(seconds)))))]


def add_health_routes(app: App, service: GenerationService) -> None:
    """Register /healthz + /readyz on an App (both frontends call this)."""

    @app.route("/healthz")
    def healthz(req: Request) -> Response:
        # Liveness stays 200; a fleet also carries each replica's
        # lifecycle and the membership counters, per model.
        body: dict = {"status": "ok"}
        fleet = service.fleet_health()
        if fleet:
            body["fleet"] = fleet
        membership = service.fleet_membership()
        if membership:
            body["fleet_membership"] = membership
        return Response.json(body)

    @app.route("/readyz")
    def readyz(req: Request) -> Response:
        health = service.health()
        if service.draining:
            return Response.json(
                {**health, "state": "draining"}, status=503,
                headers=_retry_after(service.retry_after_hint()),
            )
        status, hint = _READY_STATUS.get(health["state"], (503, False))
        headers = (_retry_after(service.retry_after_hint())
                   if status != 200 and hint else None)
        return Response.json(health, status=status, headers=headers)


def _int_query(req: Request, name: str):
    """(value or None, error Response or None) for an optional integer
    query parameter; 0 reads as absent."""
    try:
        return int(req.query.get(name, "0")) or None, None
    except ValueError:
        return None, Response.json({"error": f"'{name}' must be an integer"},
                                   status=400)


def add_debug_routes(app: App, service: GenerationService) -> None:
    """Register the observability debug routes on an App (both frontends,
    like the health routes):

    - `GET /debug/flightrecorder[?last=N]` — each model's flight-recorder
      ring: one record per harvested round (occupancy, admitted/retired
      rids, tokens emitted, round wall, cadence, roofline columns) merged
      with the supervisor's lifecycle events.
    - `GET /debug/traces[?last=N]` — the most recent head-sampled request
      traces (utils/tracing.py) and the tracer's sampling config.
    - `GET /debug/slo` — the rolling SLO engine's report (utils/slo.py).
    - `GET /debug/prefixcache[?top=K]` — each model's prefix-cache
      registry: the top-K resident entries by token mass, the
      reuse-distance histogram and the churn counters (digests, never
      token ids).
    - `GET /debug/profile[?rounds=N[&model=M]]` — with `rounds`, arm a
      bounded torch.profiler capture of the scheduler's next N rounds (409
      while a capture is in flight, 400 when no backend can profile or
      `rounds` is bad); without it, poll the capture state
      (armed/capturing/done and the artifacts)."""

    @app.route("/debug/flightrecorder")
    def flightrecorder(req: Request) -> Response:
        last, err = _int_query(req, "last")
        return err or Response.json({"models": service.flight_snapshot(last)})

    @app.route("/debug/traces")
    def traces(req: Request) -> Response:
        from ..utils.tracing import TRACER

        last, err = _int_query(req, "last")
        return err or Response.json({"tracer": TRACER.stats(),
                                     "traces": service.recent_traces(last)})

    @app.route("/debug/slo")
    def slo(req: Request) -> Response:
        return Response.json(service.slo_report())

    @app.route("/debug/prefixcache")
    def prefixcache(req: Request) -> Response:
        top, err = _int_query(req, "top")
        if err:
            return err
        if top is not None and top < 1:
            # A negative K would slice from the end: no bound at all.
            return Response.json({"error": "'top' must be >= 1"}, status=400)
        return Response.json({"models": service.prefix_registry(top)})

    @app.route("/debug/profile")
    def profile(req: Request) -> Response:
        rounds = req.query.get("rounds")
        if rounds is None:
            return Response.json({"captures": service.profile_status()})
        try:
            n = int(rounds)
        except ValueError:
            return Response.json({"error": "'rounds' must be an integer"},
                                 status=400)
        try:
            return Response.json(service.profile_capture(
                n, model=req.query.get("model") or None))
        except LookupError as e:  # no backend can profile
            return Response.json({"error": str(e)}, status=400)
        except RuntimeError as e:  # one capture at a time
            return Response.json({"error": str(e)}, status=409)
        except ValueError as e:
            return Response.json({"error": str(e)}, status=400)


def install_drain_gate(app: App, service: GenerationService) -> None:
    """Refuse NEW mutating work during drain with 503 + Retry-After; a
    keyed `/api/generate` for a backend with a journal goes through."""

    @app.before_request
    def drain_gate(req: Request):
        if req.method != "POST" or not service.draining:
            return None
        if req.path == "/api/generate":
            try:
                body = req.json()
                if isinstance(body.get("idempotency_key"), str) and \
                        service.supports_idempotency(body.get("model", "")):
                    return None  # the journal, not the gate, answers
            except Exception:  # noqa: BLE001 — malformed body: no key to
                pass           # honor, so it gets the drain 503 below
        return Response.json(
            {"error": "server draining: not accepting new requests"},
            status=503,
            headers=_retry_after(service.retry_after_hint()),
        )

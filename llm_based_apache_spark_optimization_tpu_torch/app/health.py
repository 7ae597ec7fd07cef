"""Health-gated serving: /healthz, /readyz, and the drain gate.

Lifecycle endpoints for both HTTP frontends (the headless JSON API and the
web UI register the same routes — one definition, app/api.py + app/web.py):

- `GET /healthz` — LIVENESS: the process is up and the WSGI loop answers.
  Always 200 while the process serves.
- `GET /readyz` — READINESS: should this instance receive traffic? 200
  with the service's health payload (`GenerationService.health()`), or
  503 + Retry-After once SIGTERM started the drain.
- **Drain gate** — a `before_request` hook: once `service.drain()` has
  been triggered (SIGTERM, app/__main__.py), every new mutating request
  (POST) answers 503 + Retry-After while in-flight work finishes. GETs
  (health probes, result pages) stay up so operators can watch the drain.

Counterpart of the JAX package's `app/health.py` without what reads state
the port does not have yet: the supervisor's restarting/degraded/dead
states and the drain gate's journaled-idempotency pass (ROADMAP A11), the
fleet views on `/healthz` (A11), `/metrics` and the `/debug/*` routes
(A12).
"""

from __future__ import annotations

from ..serve.service import GenerationService
from .wsgi import App, Request, Response

__all__ = ["add_health_routes", "install_drain_gate"]


#: Retry-After of the drain's 503s: one second, without the scheduler
#: service-time estimate of the JAX package's supervisor (ROADMAP A11).
_DRAIN_HEADERS = [("Retry-After", "1")]


def add_health_routes(app: App, service: GenerationService) -> None:
    """Register /healthz + /readyz on an App (both frontends call this)."""

    @app.route("/healthz")
    def healthz(req: Request) -> Response:
        return Response.json({"status": "ok"})

    @app.route("/readyz")
    def readyz(req: Request) -> Response:
        health = service.health()
        if service.draining:
            return Response.json(
                {**health, "state": "draining"}, status=503,
                headers=_DRAIN_HEADERS,
            )
        return Response.json(health)


def install_drain_gate(app: App, service: GenerationService) -> None:
    """Refuse NEW mutating work during drain with 503 + Retry-After."""

    @app.before_request
    def drain_gate(req: Request):
        if req.method != "POST" or not service.draining:
            return None
        return Response.json(
            {"error": "server draining: not accepting new requests"},
            status=503,
            headers=_DRAIN_HEADERS,
        )

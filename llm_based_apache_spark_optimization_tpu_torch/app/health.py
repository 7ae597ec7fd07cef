"""Health-gated serving: /healthz, /readyz, and the drain gate.

Lifecycle endpoints for both HTTP frontends (the headless JSON API and the
web UI register the same routes — one definition, app/api.py + app/web.py):

- `GET /healthz` — LIVENESS: the process is up and the WSGI loop answers.
  Always 200 while the process serves; a dead supervisor does not fail
  liveness (readiness already pulls the instance out of rotation).
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

Counterpart of the JAX package's `app/health.py` without what reads state
the port does not have yet: the fleet views on `/healthz` (ROADMAP A11),
`/metrics` and the `/debug/*` routes (A12).
"""

from __future__ import annotations

import math

from ..serve.service import GenerationService
from .wsgi import App, Request, Response

__all__ = ["add_health_routes", "install_drain_gate"]


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
        return Response.json({"status": "ok"})

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

"""Generation service: a registry of named models and `generate`, the call
shape of `ollama.generate(model=..., system=..., prompt=...)`.

Counterpart of the JAX package's `serve/service.py`: registry, templates,
per-model stats, request tracing, deadlines and request ids, the lifecycle
seams the app's health routes and drain gate read (`health`, `draining`,
`drain`, `close`), `validate` and `generate_stream` for `/api/generate`
(token streaming through the scheduler backend's `complete_stream`).
`health()` aggregates the supervised schedulers' lifecycle
(serve/supervisor.py) and `drain()` lets each backend finish or journal its
in-flight work; idempotency keys reach backends with a journal; a
`constrain` spec reaches backends that declare `supports_constrain` (the
engine and scheduler backends) and is a request-shape error elsewhere.

Observability: every request is recorded in the service's
`MetricsRegistry` (utils/observability.py: latency, TTFT, queue wait,
request class and replica; windowed percentiles, fixed-bucket histograms,
the SLO engine's sketches and the sampled request log), and the service
answers the app's scrapes: `metrics_snapshot` (JSON `/metrics`, with each
backend's serving stats and the `resilience`, `slo` and `repair` blocks),
`metrics_prometheus`, `flight_snapshot`, `recent_traces`,
`prefix_registry`, `slo_report`, `profile_capture` and `profile_status`
(the `/debug/*` routes).

Multi-tenant front door (serve/qos.py): every generate charges one token
of its (tenant, class) bucket to the process-wide `ADMISSION` controller
(a `TenantShed`, an `Overloaded`, when the bucket is empty; HTTP 429 with
a bucket-aware Retry-After), applies the class's default deadline to a
request without one, and forwards the labels to backends that declare
`supports_qos` (the scheduler's WFQ order and tenant prefix namespaces).
`set_tenant_models` / `resolve_model` pin a tenant to a registered model
(`LSOT_TENANT_MODELS`). The admission counters are the `qos` block of
/metrics. Fleets: `fleet_health` and `fleet_membership` are the
per-replica lifecycle and the membership counters of backends serving
from a `SchedulerPool`, for /healthz.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from ..ops.sampling import SamplingParams
from ..utils import tracing
from ..utils.observability import (
    MetricsRegistry,
    RequestMetrics,
    resilience,
    trace_capture,
)
from ..utils.tracing import TRACER
from .qos import ADMISSION, parse_tenant_models
from .templates import TEMPLATES, Template

log = logging.getLogger("lsot.service")

@dataclasses.dataclass(frozen=True)
class GenerateResult:
    response: str
    model: str
    latency_s: float
    output_tokens: int
    ttft_s: float = 0.0
    prompt_tokens: int = 0
    # Queue wait (submit -> slot admission) on the scheduler path; 0.0 =
    # not measured.
    queue_wait_s: float = 0.0
    # Trace-correlation id when the request ran under one.
    request_id: str = ""

    @property
    def tok_per_s(self) -> float:
        return self.output_tokens / self.latency_s if self.latency_s > 0 else 0.0


@dataclasses.dataclass
class ModelEntry:
    name: str
    backend: object  # EngineBackend | SchedulerBackend | FakeBackend (duck-typed)
    template: Template


class GenerationService:
    """Named-model registry + generate()."""

    def __init__(self):
        self._models: Dict[str, ModelEntry] = {}
        self._lock = threading.Lock()
        self.stats: Dict[str, Dict[str, float]] = {}
        #: Per-request records: windowed percentiles and the fixed-bucket
        #: latency/TTFT/TPOT/queue-wait histograms /metrics renders.
        self.metrics = MetricsRegistry()
        # Drain mode (SIGTERM path): once set, the HTTP layers answer new
        # work with 503 + Retry-After while in-flight requests finish.
        self._draining = False
        # Per-tenant model routing (LSOT_TENANT_MODELS): tenant ->
        # model_id, resolved at every generate. Unlisted tenants, and
        # tenants pinned to a model that is not registered, keep the
        # request's own model (warned once a tenant).
        self._tenant_models: Dict[str, str] = parse_tenant_models(
            os.environ.get("LSOT_TENANT_MODELS", ""))
        self._tenant_model_warned: set = set()

    def set_tenant_models(self, spec: str) -> None:
        """Install a tenant -> model_id map from its spec string (replaces
        the environment's)."""
        with self._lock:
            self._tenant_models = parse_tenant_models(spec)
            self._tenant_model_warned = set()

    def resolve_model(self, model: str, tenant: str) -> str:
        """The model a request runs on: its tenant's pinned model when that
        is registered, else `model`."""
        if not tenant:
            return model
        with self._lock:
            pinned = self._tenant_models.get(tenant)
            if pinned is None:
                return model
            if pinned not in self._models:
                if tenant not in self._tenant_model_warned:
                    self._tenant_model_warned.add(tenant)
                    log.warning("tenant %r pins model %r which is not registered "
                                "(available: %s); falling through to %r",
                                tenant, pinned, sorted(self._models), model)
                return model
        return pinned

    def register(self, name: str, backend, template: str = "completion") -> None:
        if template not in TEMPLATES:
            raise ValueError(f"unknown template {template!r}; choices {sorted(TEMPLATES)}")
        with self._lock:
            self._models[name] = ModelEntry(name, backend, TEMPLATES[template])
            self.stats.setdefault(
                name, {"requests": 0, "total_latency_s": 0.0, "total_tokens": 0}
            )

    def models(self):
        return sorted(self._models)

    def _entry(self, model: str) -> ModelEntry:
        entry = self._models.get(model)
        if entry is None:
            raise KeyError(
                f"model {model!r} is not registered; available: {self.models()}"
            )
        return entry

    def _entries(self) -> List[ModelEntry]:
        with self._lock:
            return list(self._models.values())

    def _record(self, model: str, latency: float, metrics: List[RequestMetrics]) -> None:
        """Per-model totals (the batch wall counts once) and one registry
        record a request."""
        with self._lock:
            s = self.stats[model]
            s["requests"] += len(metrics)
            s["total_latency_s"] += latency
            s["total_tokens"] += sum(m.output_tokens for m in metrics)
        for m in metrics:
            self.metrics.record(m)

    # --------------------------------------------------------- observability

    def backend_stats(self) -> Dict[str, Dict]:
        """Per-model serving-layer stats from backends exposing .stats()
        (the scheduler backend's prefix cache, speculation, page pool,
        ledger, watchdog and flight-recorder blocks)."""
        out: Dict[str, Dict] = {}
        for e in self._entries():
            fn = getattr(e.backend, "stats", None)
            if callable(fn):
                out[e.name] = fn()
        return out

    def metrics_snapshot(self) -> Dict[str, Dict]:
        """The /metrics payload: per-model request aggregates, each model's
        serving-layer stats under "serving", and the reserved blocks:
        "resilience" (process-wide counters and live breakers) whenever a
        counter fired or a breaker is registered, "slo" when objectives
        are configured, "qos" once the front door admitted or shed a
        labeled request, "repair" once the SQL repair loop ran."""
        from ..app.repair import repair_metrics_block
        from ..utils import slo as slo_mod
        from .resilience import breaker_states

        snap = self.metrics.snapshot()
        for model, extra in self.backend_stats().items():
            snap.setdefault(model, {})["serving"] = extra
        counters = resilience.snapshot()
        breakers = breaker_states()
        if any(counters.values()) or breakers:
            snap["resilience"] = dict(counters)
            if breakers:
                snap["resilience"]["breakers"] = breakers
        if slo_mod.ENGINE.enabled:
            snap["slo"] = slo_mod.ENGINE.report()
        qos_block = ADMISSION.snapshot()
        if qos_block:
            snap["qos"] = qos_block
        repair_block = repair_metrics_block()
        if repair_block:
            snap["repair"] = repair_block
        return snap

    def metrics_prometheus(self) -> str:
        """The same payload in Prometheus exposition text
        (`/metrics?format=prometheus`), plus the registry's histograms."""
        from ..utils.prometheus import render_prometheus

        return render_prometheus(self.metrics_snapshot(), self.metrics.histograms)

    def _per_scheduler(self, seam: str, entries=None):
        """(model name, bound seam) for each backend exposing `seam`, one a
        scheduler (two names over one scheduler report it once)."""
        seen = set()
        for e in self._entries() if entries is None else entries:
            fn = getattr(e.backend, seam, None)
            key = id(getattr(e.backend, "scheduler", e.backend))
            if callable(fn) and key not in seen:
                seen.add(key)
                yield e.name, fn

    def flight_snapshot(self, last: Optional[int] = None) -> Dict[str, list]:
        """Per-model flight-recorder records (supervised schedulers merged
        with their lifecycle events) — the /debug/flightrecorder payload."""
        return {name: fn(last) for name, fn in self._per_scheduler("flight_snapshot")}

    def recent_traces(self, n: Optional[int] = None) -> list:
        """Last head-sampled request traces (the /debug/traces payload)."""
        return TRACER.recent(n)

    def prefix_registry(self, top_k: Optional[int] = None) -> Dict[str, Dict]:
        """Per-model prefix-cache registries — the /debug/prefixcache
        payload (backends without the seam, and empty registries, left
        out)."""
        out: Dict[str, Dict] = {}
        for name, fn in self._per_scheduler("prefix_registry"):
            reg = fn(top_k)
            if reg:
                out[name] = reg
        return out

    def slo_report(self) -> Dict[str, object]:
        """The /debug/slo payload: the SLO engine's rolling report (its
        sketches are there with no objective configured too)."""
        from ..utils import slo as slo_mod

        return slo_mod.ENGINE.report()

    def profile_capture(self, rounds: Optional[int] = None,
                        model: Optional[str] = None) -> Dict[str, object]:
        """Arm a device-trace capture (/debug/profile) on the first backend
        exposing the seam, or `model`'s. Raises LookupError when no backend
        can profile, RuntimeError while a capture is in flight, ValueError
        for a bad `rounds`."""
        entries = [e for e in self._entries() if model is None or e.name == model]
        for name, fn in self._per_scheduler("profile_rounds", entries):
            return {**fn(rounds), "model": name}
        raise LookupError(
            f"no {'backend for model ' + repr(model) if model else 'registered backend'}"
            f" supports device profiling")

    def profile_status(self) -> Dict[str, object]:
        """Per-model capture state (armed/capturing/last artifact)."""
        out: Dict[str, object] = {}
        for name, fn in self._per_scheduler("profile_status"):
            st = fn()
            if st:
                out[name] = st
        return out

    # ------------------------------------------------------------- lifecycle

    @property
    def draining(self) -> bool:
        return self._draining

    def health(self) -> Dict[str, object]:
        """Aggregate lifecycle state for /readyz: the WORST state across
        backends exposing a health() seam (the supervised scheduler's
        ready | restarting | degraded | dead), per-model detail, and
        summed restart counters. Backends without the seam (engines,
        fakes, bare schedulers) are 'ready' by construction: their
        failures are per-request, not lifecycle."""
        order = {"ready": 0, "degraded": 1, "restarting": 2, "dead": 3}
        worst = "ready"
        models: Dict[str, Dict] = {}
        totals = {"restarts": 0, "replayed": 0, "lost": 0, "stalls": 0}
        seen = set()
        for e in self._entries():
            hfn = getattr(e.backend, "health", None)
            h = hfn() if callable(hfn) else None
            if not h:
                continue
            models[e.name] = h
            state = h.get("state", "ready")
            if order.get(state, 0) > order[worst]:
                worst = state
            # Dedupe by the underlying scheduler: the shared-weights alias
            # (serve/factory.py) wraps one supervisor in two backends.
            key = id(getattr(e.backend, "scheduler", e.backend))
            if key not in seen:
                seen.add(key)
                for k in totals:
                    totals[k] += int(h.get(k, 0) or 0)
        out: Dict[str, object] = {"state": worst, "draining": self._draining,
                                  "models": models, **totals}
        # A replica burning a configured SLO (utils/slo.py: both burn-rate
        # arms above 1) marks the instance degraded: still serving, flagged.
        # One report a probe, so `burning` and `state` agree.
        from ..utils import slo as slo_mod

        if slo_mod.ENGINE.enabled:
            rep = slo_mod.ENGINE.report()
            out["slo"] = {"state": rep["state"], "burning": rep["burning"]}
            if rep["burning"] and out["state"] == "ready":
                out["state"] = "degraded"
        return out

    def _per_fleet(self, seam: str) -> Dict[str, object]:
        """{model: the backend scheduler's `seam()`} for backends serving
        from a fleet (empty or None results left out)."""
        out: Dict[str, object] = {}
        for e in self._entries():
            fn = getattr(getattr(e.backend, "scheduler", None), seam, None)
            val = fn() if callable(fn) else None
            if val:
                out[e.name] = val
        return out

    def fleet_health(self) -> Dict[str, list]:
        """Per-replica lifecycle per model, for backends serving from a
        `SchedulerPool` (or a supervisor over one): {model: [{replica,
        state, phase_role, model_id, restarts, ...}]}. Empty for single
        schedulers and engines. /healthz carries it."""
        return self._per_fleet("replica_health")

    def fleet_membership(self) -> Dict[str, Dict[str, object]]:
        """The pool's membership counters per model (`fleet_stats`: size,
        serving, joins, retires, drains). /healthz carries it."""
        return self._per_fleet("fleet_stats")

    def supports_idempotency(self, model: str) -> bool:
        """Can `model`'s backend dedupe an idempotency key against a
        journal? The drain gate lets such keyed requests through."""
        with self._lock:
            entry = self._models.get(model)
        return bool(entry and getattr(entry.backend, "supports_idempotency",
                                      False))

    def retry_after_hint(self, default: float = 1.0) -> float:
        """Backpressure hint for drain-mode and readiness 503s: the
        largest estimate across backends exposing one."""
        hints = [fn() for fn in (getattr(e.backend, "retry_after_hint", None)
                                 for e in self._entries()) if callable(fn)]
        return max(hints) if hints else default

    def drain(self, deadline_s: Optional[float] = None) -> None:
        """Graceful shutdown (SIGTERM): stop admitting — the HTTP drain
        gate answers 503 + Retry-After from here on — then let each
        backend finish in-flight work up to the shared deadline
        (supervised schedulers journal what is left), then close
        everything. `deadline_s <= 0` journals and exits at once."""
        from .resilience import Deadline

        self._draining = True
        deadline = (Deadline.after(deadline_s)
                    if deadline_s is not None and deadline_s > 0 else None)
        immediate = deadline_s is not None and deadline_s <= 0
        seen = set()
        for e in self._entries():
            d = getattr(e.backend, "drain", None)
            key = id(getattr(e.backend, "scheduler", e.backend))
            if d is None or key in seen:
                continue
            seen.add(key)
            remaining = deadline.remaining() if deadline is not None else None
            if immediate or (remaining is not None and remaining <= 0):
                remaining = 0.0
            d(remaining)
        self.close()

    def close(self) -> None:
        """Shut down owned backend resources (scheduler threads and their
        caches). Idempotent; a backend shared by two names shuts down once."""
        seen = set()
        for e in self._entries():
            shutdown = getattr(e.backend, "shutdown", None)
            if shutdown is not None and id(e.backend) not in seen:
                seen.add(id(e.backend))
                shutdown()

    # ------------------------------------------------------------ generation

    @staticmethod
    def _constrain_kwargs(entry: ModelEntry, constrain) -> Dict:
        """`constrain` is opt-in per request ("spark_sql", or a schema dict
        {"table", "columns"}): forwarded only to backends that declare
        `supports_constrain`; anything else is a clear request-shape error
        rather than a silently unconstrained completion."""
        if constrain is None:
            return {}
        if not getattr(entry.backend, "supports_constrain", False):
            raise ValueError(
                f"model {entry.name!r} backend does not support "
                f"constrained decoding")
        return {"constrain": constrain}

    @classmethod
    def _request_kwargs(cls, entry: ModelEntry, constrain, deadline_s,
                        tenant: str = "", qos: str = "") -> Dict:
        """The constrain kwargs, a deadline for backends that can enforce
        one (`supports_deadline`; elsewhere a best-effort hint, dropped, as
        in the JAX package), and the tenant labels for backends that
        declare `supports_qos` (elsewhere they were charged at admission
        and go no further)."""
        kwargs = cls._constrain_kwargs(entry, constrain)
        if deadline_s is not None and getattr(entry.backend, "supports_deadline",
                                              False):
            kwargs["deadline_s"] = deadline_s
        if (tenant or qos) and getattr(entry.backend, "supports_qos", False):
            kwargs.update(tenant=tenant, qos=qos)
        return kwargs

    def _admit_qos(self, tenant: str, qos: str,
                   deadline_s: Optional[float]) -> Optional[float]:
        """Front-door admission: take one token of the (tenant, class)
        bucket (raises `TenantShed`, HTTP 429, when it is empty) and give
        a request without a deadline its class's default. A no-op with
        QoS off."""
        if not ADMISSION.enabled:
            return deadline_s
        ADMISSION.admit(tenant, qos, fleet_hint=self.retry_after_hint())
        if deadline_s is None:
            return ADMISSION.default_deadline(qos)
        return deadline_s

    def generate(
        self,
        model: str,
        prompt: str,
        system: str = "",
        max_new_tokens: Optional[int] = None,
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
        constrain=None,
        deadline_s: Optional[float] = None,
        idempotency_key: Optional[str] = None,
        request_id: Optional[str] = None,
        tenant: str = "",
        qos: str = "",
    ) -> GenerateResult:
        """One completion. `idempotency_key` goes only to backends with a
        journal to dedupe against (`supports_idempotency`: the supervised
        scheduler) and is dropped elsewhere, as in the JAX package. The
        request passes the front door first (`_admit_qos`), on its
        tenant's pinned model (`resolve_model`)."""
        model = self.resolve_model(model, tenant)
        entry = self._entry(model)
        deadline_s = self._admit_qos(tenant, qos, deadline_s)
        kwargs = self._request_kwargs(entry, constrain, deadline_s, tenant, qos)
        if idempotency_key is not None and getattr(
                entry.backend, "supports_idempotency", False):
            kwargs["idempotency_key"] = idempotency_key
        rendered = entry.template(system, prompt)
        tr, own, rid = tracing.begin_or_ambient(request_id, model)
        t0 = time.perf_counter()
        try:
            with tracing.use(tr) if own is not None else contextlib.nullcontext():
                with tracing.span("service.generate", model=model,
                                  constrained=constrain is not None):
                    with trace_capture(f"generate-{model}"):
                        completion = entry.backend.complete(
                            rendered, max_new_tokens=max_new_tokens,
                            sampling=sampling, seed=seed, **kwargs,
                        )
        finally:
            TRACER.finish(own)
        latency = time.perf_counter() - t0
        self._record(model, latency, [RequestMetrics(
            model=model, prompt_tokens=completion.prompt_tokens,
            output_tokens=completion.output_tokens, latency_s=latency,
            ttft_s=completion.ttft_s,
            queue_wait_s=getattr(completion, "queue_wait_s", 0.0),
            rclass=getattr(completion, "rclass", ""),
            replica=getattr(completion, "replica", ""), request_id=rid)])
        return GenerateResult(
            response=completion.text, model=model, latency_s=latency,
            output_tokens=completion.output_tokens, ttft_s=completion.ttft_s,
            prompt_tokens=completion.prompt_tokens,
            queue_wait_s=getattr(completion, "queue_wait_s", 0.0), request_id=rid,
        )

    def validate(self, model: str, prompt: str, system: str = "",
                 max_new_tokens: Optional[int] = None, constrain=None) -> None:
        """Raise the KeyError/ValueError generate() would raise for a bad
        model name, a bad `constrain` spec or an oversize prompt, without
        generating: streaming handlers call this while a 400 is still
        possible. A `constrain` spec is compiled here (errors become 400s;
        the compile is cached for the request itself) and the backend
        checks its clamped budget against the grammar's shortest parse."""
        entry = self._entry(model)
        self._constrain_kwargs(entry, constrain)  # supports check
        compiled = None
        if constrain is not None:
            resolve = getattr(entry.backend, "_resolve_constraint", None)
            if resolve is not None:
                compiled = resolve(constrain)
        check = getattr(entry.backend, "check_budget", None)
        if check is not None:
            check(entry.template(system, prompt), max_new_tokens,
                  constraint=compiled)

    def generate_stream(
        self,
        model: str,
        prompt: str,
        system: str = "",
        max_new_tokens: Optional[int] = None,
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
        constrain=None,
        deadline_s: Optional[float] = None,
        request_id: Optional[str] = None,
        tenant: str = "",
        qos: str = "",
    ):
        """Yield the completion as text chunks while it decodes (Ollama's
        `stream=true` surface): through the backend's `complete_stream`
        (the scheduler backend's), or as one chunk from a backend without
        that seam (engines, fakes), as the JAX package does. Metrics record
        the request like generate(), also when the consumer closes the
        stream early; closing it cancels the request. The front door runs
        at the generator's first step: the HTTP layer primes the stream
        before it sends headers, so a shed is still a real 429."""
        model = self.resolve_model(model, tenant)
        entry = self._entry(model)
        streamer = getattr(entry.backend, "complete_stream", None)
        if streamer is None:
            res = self.generate(model, prompt, system=system,
                                max_new_tokens=max_new_tokens, sampling=sampling,
                                seed=seed, constrain=constrain,
                                deadline_s=deadline_s, request_id=request_id,
                                tenant=tenant, qos=qos)
            if res.response:
                yield res.response
            return
        deadline_s = self._admit_qos(tenant, qos, deadline_s)
        kwargs = self._request_kwargs(entry, constrain, deadline_s, tenant, qos)
        rendered = entry.template(system, prompt)
        tr, own, rid = tracing.begin_or_ambient(request_id, model)
        stats: dict = {}
        t0 = time.perf_counter()
        inner = streamer(rendered, max_new_tokens=max_new_tokens,
                         sampling=sampling, seed=seed, stats_out=stats, **kwargs)
        try:
            with trace_capture(f"generate-{model}"):
                # The backend advances under the trace context, never held
                # across our own yields (the generator/contextvar hazard).
                yield from (tracing.stepwise(inner, tr) if own is not None else inner)
        finally:
            inner.close()  # its finally cancels the request and fills stats
            TRACER.finish(own)
            latency = time.perf_counter() - t0
            self._record(model, latency, [RequestMetrics(
                model=model, prompt_tokens=stats.get("prompt_tokens", 0),
                output_tokens=stats.get("output_tokens", 0), latency_s=latency,
                ttft_s=stats.get("ttft_s", 0.0),
                queue_wait_s=stats.get("queue_wait_s", 0.0),
                rclass=stats.get("rclass", ""), replica=stats.get("replica", ""),
                request_id=rid)])

    def generate_batch(
        self,
        model: str,
        prompts: List[str],
        system: str = "",
        max_new_tokens: Optional[int] = None,
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
        constrain=None,
        tenant: str = "",
        qos: str = "",
    ) -> List[GenerateResult]:
        """Batched twin of generate(): one device program for all prompts.
        Each result's latency is the batch's wall clock. The front door
        charges one token a member: a storm cannot fold itself into one
        batch call."""
        model = self.resolve_model(model, tenant)
        entry = self._entry(model)
        for _ in prompts:
            self._admit_qos(tenant, qos, None)
        rendered = [entry.template(system, p) for p in prompts]
        t0 = time.perf_counter()
        with trace_capture(f"generate-batch-{model}"):
            completions = entry.backend.complete_batch(
                rendered, max_new_tokens=max_new_tokens, sampling=sampling, seed=seed,
                **self._request_kwargs(entry, constrain, None, tenant, qos),
            )
        latency = time.perf_counter() - t0
        # Each member's latency is the batch wall; its share of distinct
        # wall is wall / B, so aggregate tok/s is not understated.
        self._record(model, latency, [RequestMetrics(
            model=model, prompt_tokens=c.prompt_tokens,
            output_tokens=c.output_tokens, latency_s=latency,
            wall_share_s=latency / len(completions), ttft_s=c.ttft_s)
            for c in completions])
        return [
            GenerateResult(
                response=c.text, model=model, latency_s=latency,
                output_tokens=c.output_tokens, ttft_s=c.ttft_s,
                prompt_tokens=c.prompt_tokens,
                queue_wait_s=getattr(c, "queue_wait_s", 0.0),
            )
            for c in completions
        ]

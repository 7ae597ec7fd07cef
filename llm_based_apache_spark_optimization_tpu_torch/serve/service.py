"""Generation service: a registry of named models and `generate`, the call
shape of `ollama.generate(model=..., system=..., prompt=...)`.

Counterpart of the JAX package's `serve/service.py`: registry, templates,
per-model stats, request tracing, deadlines and request ids, the lifecycle
seams the app's health routes and drain gate read (`health`, `draining`,
`drain`, `close`), `validate` and `generate_stream` for `/api/generate`
(token streaming through the scheduler backend's `complete_stream`).
`health()` aggregates the supervised schedulers' lifecycle
(serve/supervisor.py) and `drain()` lets each backend finish or journal its
in-flight work; idempotency keys reach backends with a journal. Not ported
yet: constrained decoding (a `constrain` spec raises, ROADMAP A8), the QoS
front door and tenant routing (`tenant`/`qos` are carried and not charged,
A11), the fleet views (A11), Prometheus, SLOs and profiling (A12).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional

from ..ops.sampling import SamplingParams
from ..utils import tracing
from ..utils.observability import HistogramSet
from ..utils.tracing import TRACER
from .templates import TEMPLATES, Template


@dataclasses.dataclass(frozen=True)
class GenerateResult:
    response: str
    model: str
    latency_s: float
    output_tokens: int
    ttft_s: float = 0.0
    prompt_tokens: int = 0
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
        # Fixed-bucket latency and TTFT histograms per model (the JAX
        # package's Prometheus feed; /metrics is ROADMAP A12).
        self.histograms = HistogramSet()
        # Drain mode (SIGTERM path): once set, the HTTP layers answer new
        # work with 503 + Retry-After while in-flight requests finish.
        self._draining = False

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

    def _record(self, model: str, n_requests: int, latency: float, tokens: int,
                ttfts=()) -> None:
        with self._lock:
            s = self.stats[model]
            s["requests"] += n_requests
            s["total_latency_s"] += latency
            s["total_tokens"] += tokens
        self.histograms.observe("lsot_request_latency_seconds", latency, model=model)
        for ttft in ttfts:
            if ttft:
                self.histograms.observe("lsot_ttft_seconds", ttft, model=model)

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
        return {"state": worst, "draining": self._draining,
                "models": models, **totals}

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
    def _request_kwargs(entry: ModelEntry, constrain, deadline_s) -> Dict:
        """A `constrain` spec raises (grammar-constrained decoding is not
        ported, ROADMAP A8: a clear request-shape error, not a silently
        unconstrained completion). A deadline goes only to backends that
        can enforce one (`supports_deadline`); elsewhere it is a
        best-effort hint and dropped, as in the JAX package."""
        if constrain is not None:
            raise ValueError(
                f"model {entry.name!r}: constrained decoding is not ported "
                f"(ROADMAP A8)")
        if deadline_s is None or not getattr(entry.backend, "supports_deadline",
                                             False):
            return {}
        return {"deadline_s": deadline_s}

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
        scheduler) and is dropped elsewhere, as in the JAX package;
        `tenant` and `qos` are carried, not charged (ROADMAP A11)."""
        entry = self._entry(model)
        kwargs = self._request_kwargs(entry, constrain, deadline_s)
        if idempotency_key is not None and getattr(
                entry.backend, "supports_idempotency", False):
            kwargs["idempotency_key"] = idempotency_key
        rendered = entry.template(system, prompt)
        tr, own, rid = tracing.begin_or_ambient(request_id, model)
        t0 = time.perf_counter()
        try:
            with tracing.use(tr) if own is not None else contextlib.nullcontext():
                with tracing.span("service.generate", model=model):
                    completion = entry.backend.complete(
                        rendered, max_new_tokens=max_new_tokens,
                        sampling=sampling, seed=seed, **kwargs,
                    )
        finally:
            TRACER.finish(own)
        latency = time.perf_counter() - t0
        self._record(model, 1, latency, completion.output_tokens, [completion.ttft_s])
        return GenerateResult(
            response=completion.text, model=model, latency_s=latency,
            output_tokens=completion.output_tokens, ttft_s=completion.ttft_s,
            prompt_tokens=completion.prompt_tokens, request_id=rid,
        )

    def validate(self, model: str, prompt: str, system: str = "",
                 max_new_tokens: Optional[int] = None, constrain=None) -> None:
        """Raise the KeyError/ValueError generate() would raise for a bad
        model name, a bad `constrain` spec or an oversize prompt, without
        generating: streaming handlers call this while a 400 is still
        possible."""
        entry = self._entry(model)
        self._request_kwargs(entry, constrain, None)
        check = getattr(entry.backend, "check_budget", None)
        if check is not None:
            check(entry.template(system, prompt), max_new_tokens)

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
        stream early; closing it cancels the request."""
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
        kwargs = self._request_kwargs(entry, constrain, deadline_s)
        rendered = entry.template(system, prompt)
        tr, own, _ = tracing.begin_or_ambient(request_id, model)
        stats: dict = {}
        t0 = time.perf_counter()
        inner = streamer(rendered, max_new_tokens=max_new_tokens,
                         sampling=sampling, seed=seed, stats_out=stats, **kwargs)
        try:
            # The backend advances under the trace context, never held
            # across our own yields (the generator/contextvar hazard).
            yield from (tracing.stepwise(inner, tr) if own is not None else inner)
        finally:
            inner.close()  # its finally cancels the request and fills stats
            TRACER.finish(own)
            self._record(model, 1, time.perf_counter() - t0,
                         stats.get("output_tokens", 0), [stats.get("ttft_s", 0.0)])

    def generate_batch(
        self,
        model: str,
        prompts: List[str],
        system: str = "",
        max_new_tokens: Optional[int] = None,
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
    ) -> List[GenerateResult]:
        """Batched twin of generate(): one device program for all prompts.
        Each result's latency is the batch's wall clock."""
        entry = self._entry(model)
        rendered = [entry.template(system, p) for p in prompts]
        t0 = time.perf_counter()
        completions = entry.backend.complete_batch(
            rendered, max_new_tokens=max_new_tokens, sampling=sampling, seed=seed,
        )
        latency = time.perf_counter() - t0
        self._record(model, len(prompts), latency,
                     sum(c.output_tokens for c in completions),
                     [c.ttft_s for c in completions])
        return [
            GenerateResult(
                response=c.text, model=model, latency_s=latency,
                output_tokens=c.output_tokens, ttft_s=c.ttft_s,
                prompt_tokens=c.prompt_tokens,
            )
            for c in completions
        ]

"""Observability: per-request metrics, stage timers, counters, profiler capture.

A copy of the JAX package's `utils/observability.py`, its profiler capture
on `torch.profiler`:

- `StageTimer` — wall-clock spans around pipeline stages (prefill vs decode,
  SQL exec, persistence), cheap enough to always be on.
- `RequestMetrics` / `MetricsRegistry` — per-request records (prompt/output
  tokens, decode tok/s, end-to-end latency, TTFT, queue wait) with
  process-lifetime aggregates (count, p50/p95 latency, aggregate tok/s),
  fixed-bucket histograms and a sampled JSON request log
  (`LSOT_REQUEST_LOG`), surfaced by the app's `/metrics` endpoint.
- `CounterSet` and its two process-wide sets, `resilience` (retries, sheds,
  deadline expiries, breaker trips, injected faults) and `repair` (the
  self-healing SQL loop).
- `trace_capture` — a torch.profiler capture of a code region, gated
  behind the LSOT_TRACE_DIR env var: zero overhead when unset, a gzipped
  Chrome trace (Perfetto-loadable) under that directory when set.

Everything is thread-safe: the serving layer calls this from request
threads and the continuous-batching scheduler loop alike.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import logging
import os
import random
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

log = logging.getLogger("lsot.metrics")


#: App-startup override (AppConfig.request_log → reconfigure_request_log);
#: None falls through to the LSOT_REQUEST_LOG env read below.
_LOG_SAMPLE_OVERRIDE: Optional[float] = None


def _request_log_sample() -> float:
    """LSOT_REQUEST_LOG: fraction of requests whose JSON log line is
    emitted (default 1.0 = all, 0 disables). The line used to be
    unconditional — string-formatting + I/O per request at high QPS."""
    if _LOG_SAMPLE_OVERRIDE is not None:
        return _LOG_SAMPLE_OVERRIDE
    try:
        return min(1.0, max(0.0, float(
            os.environ.get("LSOT_REQUEST_LOG", "1") or 0.0
        )))
    except ValueError:
        return 1.0


def reconfigure_request_log(sample: float) -> None:
    """App-startup wiring seam (AppConfig.request_log): set the log-line
    sampling fraction for registries constructed after this call AND for
    the module-level `registry` — so `AppConfig(request_log=0.0)` is
    honored, not a silent no-op."""
    global _LOG_SAMPLE_OVERRIDE
    _LOG_SAMPLE_OVERRIDE = min(1.0, max(0.0, float(sample)))
    registry._log_sample = _LOG_SAMPLE_OVERRIDE


class StageTimer:
    """Accumulates named wall-clock spans: `with timer.stage("prefill"): ...`.

    Re-entering a stage name accumulates (decode chunks sum into one
    "decode" figure)."""

    def __init__(self):
        self._spans: Dict[str, float] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._spans[name] = self._spans.get(name, 0.0) + dt

    @property
    def spans(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._spans)


@dataclasses.dataclass
class RequestMetrics:
    model: str
    prompt_tokens: int
    output_tokens: int
    latency_s: float
    # This request's share of *distinct* wall-clock. For a request served in
    # a batch of B, latency_s is the batch wall (what the caller truly
    # waited) while wall_share_s is wall/B — aggregate tok/s must divide by
    # distinct time, not by the same wall counted B times (mirrors
    # evalh.ModelReport.wall_clock_s). 0.0 means "same as latency_s"
    # (sequential request).
    wall_share_s: float = 0.0
    # Time to first token (submit -> first accepted token harvested), the
    # metric streaming exists for. 0.0 = not measured (backends without a
    # first-token seam: the one-XLA-program engine, fakes).
    ttft_s: float = 0.0
    # Queue wait (submit -> slot admission) on the scheduler path: the
    # share of latency that is BACKLOG, not compute. 0.0 = not measured.
    queue_wait_s: float = 0.0
    # Request class for the histogram label set: "" (plain), or any of
    # "constrained"/"speculative"/"constrained+speculative" — the classes
    # whose latency profiles an operator prices separately.
    rclass: str = ""
    # Which scheduler replica served it (SchedulerPool attribution);
    # "" when there is no replica notion (engine, fakes).
    replica: str = ""
    # Trace-correlation handle (utils/tracing.py): echoed in the request
    # log line so a log line and an exported trace join on one id.
    request_id: str = ""
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def distinct_wall_s(self) -> float:
        return self.wall_share_s or self.latency_s

    @property
    def decode_tok_s(self) -> float:
        decode = self.stages.get("decode")
        span = decode if decode else self.latency_s
        return self.output_tokens / span if span > 0 else 0.0

    def to_dict(self) -> Dict:
        out = {
            "model": self.model,
            "prompt_tokens": self.prompt_tokens,
            "output_tokens": self.output_tokens,
            "latency_s": round(self.latency_s, 4),
            "decode_tok_s": round(self.decode_tok_s, 2),
            "stages": {k: round(v, 4) for k, v in self.stages.items()},
        }
        if self.ttft_s:
            out["ttft_s"] = round(self.ttft_s, 4)
        if self.queue_wait_s:
            out["queue_wait_s"] = round(self.queue_wait_s, 4)
        if self.rclass:
            out["class"] = self.rclass
        if self.replica:
            out["replica"] = self.replica
        if self.request_id:
            out["request_id"] = self.request_id
        return out

    @property
    def tpot_s(self) -> float:
        """Time per output token AFTER the first (the streaming cadence
        metric): (latency - ttft) / (n - 1). Falls back to latency/n when
        no TTFT was measured; 0.0 when nothing decoded."""
        if self.output_tokens <= 0:
            return 0.0
        if self.ttft_s and self.output_tokens > 1:
            return max(0.0, self.latency_s - self.ttft_s) / (
                self.output_tokens - 1
            )
        return self.latency_s / self.output_tokens


#: Fixed latency buckets (seconds) shared by the TTFT/TPOT/queue-wait/
#: latency histograms: Prometheus-style cumulative `le` bounds spanning
#: sub-ms CPU fakes to minute-long chip decodes. FIXED (not windowed
#: percentiles) on purpose — histograms aggregate across scrapes and
#: replicas; percentiles don't.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram:
    """Prometheus-shaped cumulative histogram: fixed `le` buckets +
    sum + count. Thread-safe; observe() is a bisect + increments."""

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS_S):
        self._lock = threading.Lock()
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Dict[str, object]:
        """Cumulative counts per upper bound (Prometheus `le` semantics:
        bucket[le] counts observations <= le, ending at +Inf == count)."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, out = 0, {}
        for le, c in zip(self.buckets, counts):
            cum += c
            out[le] = cum
        return {"buckets": out, "sum": s, "count": total}


class HistogramSet:
    """Named histograms keyed by a label tuple — the exposition feed for
    `/metrics?format=prometheus`. Keys are (name, ((label, value), ...))
    so one set holds e.g. lsot_ttft_seconds across model × replica ×
    request-class without pre-registration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Histogram] = {}

    def observe(self, name: str, value: float, **labels: str) -> None:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram()
        h.observe(value)

    def snapshot(self) -> Dict[str, List[Dict]]:
        """{name: [{labels: {...}, buckets/sum/count}, ...]} — the shape
        utils/prometheus.py renders."""
        with self._lock:
            items = list(self._hists.items())
        out: Dict[str, List[Dict]] = {}
        for (name, labels), h in items:
            out.setdefault(name, []).append(
                {"labels": dict(labels), **h.snapshot()}
            )
        return out


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class MetricsRegistry:
    """Process-lifetime request aggregates, keyed by model name.

    Bounded memory: keeps only the last `window` per-request records per
    model for percentiles; counters are exact over the full lifetime.
    """

    def __init__(self, window: int = 1024,
                 request_log_sample: Optional[float] = None):
        self._window = window
        self._lock = threading.Lock()
        self._recent: Dict[str, List[RequestMetrics]] = {}
        self._count: Dict[str, int] = {}
        self._tokens: Dict[str, int] = {}
        self._time: Dict[str, float] = {}
        # Fixed-bucket histograms beside the windowed percentiles:
        # histograms AGGREGATE (across scrapes, replicas, processes) where
        # a windowed p95 cannot — the Prometheus exposition renders these.
        self.histograms = HistogramSet()
        # Per-request log-line sampling (LSOT_REQUEST_LOG): an
        # unconditional JSON line at INFO pays json.dumps + handler I/O per
        # request at high QPS even when nobody reads it.
        self._log_sample = (request_log_sample if request_log_sample
                            is not None else _request_log_sample())
        self._log_rng = random.Random(0)

    def record(self, m: RequestMetrics) -> None:
        with self._lock:
            recent = self._recent.setdefault(m.model, [])
            recent.append(m)
            if len(recent) > self._window:
                del recent[: len(recent) - self._window]
            self._count[m.model] = self._count.get(m.model, 0) + 1
            self._tokens[m.model] = self._tokens.get(m.model, 0) + m.output_tokens
            self._time[m.model] = self._time.get(m.model, 0.0) + m.distinct_wall_s
        # "r0" matches the single-scheduler flight-recorder default and
        # the pool's "r{i}" scheme: one replica-label vocabulary across
        # the histogram and serving-gauge families.
        labels = {"model": m.model, "replica": m.replica or "r0",
                  "class": m.rclass or "plain"}
        self.histograms.observe("lsot_request_latency_seconds",
                                m.latency_s, **labels)
        # TPOT is the post-first-token cadence: undefined for a 1-token
        # completion, where the latency/n fallback would record the FULL
        # request latency (queue + prefill + TTFT) as a "per token" time
        # and skew the histogram's tail by orders of magnitude.
        if m.output_tokens > 1:
            self.histograms.observe("lsot_tpot_seconds", m.tpot_s, **labels)
        if m.ttft_s:
            self.histograms.observe("lsot_ttft_seconds", m.ttft_s, **labels)
        if m.queue_wait_s:
            self.histograms.observe("lsot_queue_wait_seconds",
                                    m.queue_wait_s, **labels)
        # Rolling SLO engine (utils/slo.py): the same TTFT/TPOT/queue-wait
        # observations feed the windowed burn-rate sketches, per replica.
        # Lazy import (slo imports this module's bucket bounds) and gated
        # on `enabled`, so the no-objective hot path pays one attribute
        # read.
        from . import slo as _slo

        eng = _slo.ENGINE
        if eng.enabled:
            rep = m.replica or "r0"
            if m.ttft_s:
                eng.observe("ttft", m.ttft_s, replica=rep)
            if m.output_tokens > 1:
                eng.observe("tpot", m.tpot_s, replica=rep)
            if m.queue_wait_s:
                eng.observe("queue_wait", m.queue_wait_s, replica=rep)
        # Level check BEFORE the json.dumps (the formatting was the cost,
        # not the logging call), then the sampling knob.
        if self._log_sample > 0.0 and log.isEnabledFor(logging.INFO):
            if self._log_sample >= 1.0 or \
                    self._log_rng.random() < self._log_sample:
                log.info("request %s", json.dumps(m.to_dict()))

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            out = {}
            for model, recent in self._recent.items():
                lats = sorted(r.latency_s for r in recent)
                toks = sum(r.output_tokens for r in recent)
                # Distinct wall-clock: batch members contribute wall/B each,
                # so batched throughput isn't understated by ~batch_size.
                span = sum(r.distinct_wall_s for r in recent)
                out[model] = {
                    "requests": self._count[model],
                    "output_tokens": self._tokens[model],
                    "p50_latency_s": round(_percentile(lats, 0.50), 4),
                    "p95_latency_s": round(_percentile(lats, 0.95), 4),
                    "avg_decode_tok_s": round(toks / span, 2) if span else 0.0,
                }
                # TTFT percentiles over the requests that measured one
                # (scheduler-path requests; the single-program engine has
                # no first-token seam and reports none).
                ttfts = sorted(r.ttft_s for r in recent if r.ttft_s)
                if ttfts:
                    out[model]["ttft_p50_s"] = round(_percentile(ttfts, 0.50), 4)
                    out[model]["ttft_p95_s"] = round(_percentile(ttfts, 0.95), 4)
                # Queue-wait percentiles (scheduler-path requests): how
                # much of the latency was backlog, not compute.
                qws = sorted(r.queue_wait_s for r in recent if r.queue_wait_s)
                if qws:
                    out[model]["queue_wait_p50_s"] = round(
                        _percentile(qws, 0.50), 4)
                    out[model]["queue_wait_p95_s"] = round(
                        _percentile(qws, 0.95), 4)
            return out


# Default process-wide registry the serving layer records into.
registry = MetricsRegistry()


class CounterSet:
    """Named monotonic counters (thread-safe) for low-cardinality event
    counts the per-request registry cannot express: retries, sheds,
    breaker trips, injected faults. Snapshot is a plain dict for the
    /metrics payload."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


#: Process-wide fault-tolerance counters (serve/resilience.py writes them:
#: retries/retry_giveups, shed, deadline_expired, breaker_trips/
#: breaker_open_shed/breaker_closes, faults_injected) — merged into the
#: /metrics payload by GenerationService.metrics_snapshot.
resilience = CounterSet()

#: Process-wide self-healing-SQL counters (app/repair.py writes them:
#: repair_rounds, repaired, unrepairable, breaker_skips, deadline_stops,
#: plus one diagnosed_<class> counter per taxonomy class — a FIXED
#: five-entry vocabulary, so cardinality is bounded by construction) —
#: merged into the /metrics payload under the reserved "repair" key by
#: GenerationService.metrics_snapshot and rendered as the lsot_repair_*
#: Prometheus families.
repair = CounterSet()


@contextlib.contextmanager
def trace_capture(name: str = "lsot") -> Iterator[None]:
    """torch.profiler trace of the enclosed region when LSOT_TRACE_DIR is
    set: `LSOT_TRACE_DIR/<name>/*.trace.json.gz` (utils/traceprof.py),
    CUDA activity once the process has initialised a card, CPU activity
    otherwise. One profiler session runs at a time: while another capture
    (a `/debug/profile` one) holds the process-wide slot, the region runs
    untraced."""
    trace_dir = os.environ.get("LSOT_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from . import traceprof

    owner = f"trace_capture:{name}:{threading.get_ident()}"
    if not traceprof.try_acquire_capture(owner):
        yield
        return
    try:
        prof = traceprof.start_capture(traceprof.cuda_in_use())
        try:
            yield
        finally:
            traceprof.stop_capture(prof, os.path.join(trace_dir, name))
    finally:
        traceprof.release_capture(owner)

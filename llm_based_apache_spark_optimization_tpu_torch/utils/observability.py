"""Observability: the counters and histograms the app path bumps.

A copy of part of the JAX package's `utils/observability.py`:
- `CounterSet` and its two process-wide sets, `resilience` (retries,
  sheds, deadline expiries, breaker trips, injected faults; written by
  `serve/resilience.py`, `utils/faults.py`, `sql/backend.py` and the
  scheduler) and `repair` (the self-healing SQL loop, `app/repair.py`);
- `Histogram` and `HistogramSet`, fixed-bucket latency histograms
  (`GenerationService.histograms` observes each request's latency and
  TTFT).

The per-request registry, the request log and the profiler capture are not
copied, and `/metrics`, which reads these, is not served yet (ROADMAP A12).
Everything is thread-safe.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Sequence, Tuple


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

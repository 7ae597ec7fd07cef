"""Rolling SLO engine: streaming quantile sketches + multi-window burn rates.

A copy of the JAX package's `utils/slo.py`.

The histograms in `utils/observability.py` aggregate over the process
LIFETIME — good for dashboards, useless for "are we violating the latency
objective RIGHT NOW": an hour of healthy traffic drowns five bad minutes.
This module is the serving stack's live SLO view:

- `QuantileSketch` — a fixed-bucket cumulative sketch (same
  `LATENCY_BUCKETS_S` bounds as the Prometheus histograms): `observe` is
  a bisect + increments, `quantile(q)` answers within one bucket's width
  (it returns the upper bound of the bucket holding rank ceil(q·n) — the
  documented error bound the tests pin), and sketches MERGE by
  elementwise addition, so per-replica sketches roll up to a fleet view
  losslessly (the property windowed percentiles fundamentally lack).
- `SLOEngine` — rolling time-sliced windows over TTFT / TPOT /
  queue-wait, evaluated against configured objectives
  (`LSOT_SLO_TTFT_MS` / `LSOT_SLO_TPOT_MS` / `LSOT_SLO_QUEUE_WAIT_MS`,
  window `LSOT_SLO_WINDOW_S`, good-fraction target `LSOT_SLO_TARGET`)
  with MULTI-WINDOW burn rates (the SRE alerting recipe): the burn rate
  is (bad fraction) / (error budget); `burning` requires BOTH the long
  window and the short window (window/12, the fast-detect arm) above
  1.0 — a long-window burn alone is "warning" (old incident, already
  recovering), a short-window spike alone is noise that has not yet
  consumed real budget. Per-replica state rides the same engine
  (observations carry the shared r{i} label vocabulary), so
  `health()` can mark exactly the burning replica degraded and the
  pool's placement view can route around it.

One process-wide `ENGINE` (like `observability.registry`), fed by
`MetricsRegistry.record` and reconfigured at app startup from AppConfig.
Zero overhead when no objective is configured: `enabled` is False and
the registry skips the calls.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .observability import LATENCY_BUCKETS_S

__all__ = ["ENGINE", "QuantileSketch", "SLOEngine", "reconfigure"]

#: Metrics the engine tracks (seconds; the knob names are milliseconds
#: because operators think in ms for these).
METRICS = ("ttft", "tpot", "queue_wait")


class QuantileSketch:
    """Fixed-bucket cumulative quantile sketch, mergeable across
    replicas/windows. Bucket-error bound: `quantile(q)` returns the
    upper bound of the bucket containing rank ceil(q·count), so the
    true q-quantile lies within that bucket (exact ≤ answer, and answer
    is the tightest bound the bucketing can give). Values past the last
    bound report the last bound (documented saturation — pick bounds
    that cover the objective)."""

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: Sequence[float] = LATENCY_BUCKETS_S):
        self.bounds: Tuple[float, ...] = tuple(sorted(bounds))
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # +inf last
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        if other.bounds != self.bounds:
            raise ValueError("cannot merge sketches with different bounds")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        return self

    def quantile(self, q: float) -> float:
        """Upper bucket bound holding rank ceil(q·count); 0.0 empty."""
        if self.count <= 0:
            return 0.0
        rank = min(self.count, max(1, -int(-q * self.count // 1)))  # ceil
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1]
        return self.bounds[-1]

    def frac_over(self, threshold: float) -> float:
        """Fraction of observations STRICTLY over `threshold` (bucket
        resolution: counts every bucket whose lower range lies above it —
        exact when the threshold is a bucket bound, which is why the
        engine snaps objectives onto bounds at construction)."""
        if self.count <= 0:
            return 0.0
        idx = bisect.bisect_left(self.bounds, threshold)
        # buckets [0, idx] hold values <= bounds[idx] >= threshold when
        # threshold is a bound; everything after is over.
        over = sum(self.counts[idx + 1:]) if idx < len(self.bounds) \
            else self.counts[-1]
        return over / self.count

    def snapshot(self) -> Dict[str, object]:
        return {"count": self.count, "sum": round(self.sum, 6),
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


class _Rolling:
    """Time-sliced ring of sketches: the window is `slices` equal
    sub-spans, observations land in the current slice, and a window
    query merges the slices young enough — O(slices) memory, no
    timestamps stored per observation."""

    def __init__(self, window_s: float, slices: int,
                 bounds: Sequence[float],
                 time_fn: Callable[[], float]):
        self.window_s = float(window_s)
        self.slices = max(1, int(slices))
        self.slice_s = self.window_s / self.slices
        self.bounds = tuple(bounds)
        self._time = time_fn
        # slot index -> (epoch, sketch); epoch = int(now / slice_s).
        self._ring: List[Optional[Tuple[int, QuantileSketch]]] = \
            [None] * self.slices

    def _slot(self, epoch: int) -> QuantileSketch:
        i = epoch % self.slices
        cur = self._ring[i]
        if cur is None or cur[0] != epoch:
            sk = QuantileSketch(self.bounds)
            self._ring[i] = (epoch, sk)
            return sk
        return cur[1]

    def observe(self, v: float) -> None:
        self._slot(int(self._time() / self.slice_s)).observe(v)

    def merged(self, window_s: Optional[float] = None) -> QuantileSketch:
        """Union sketch of the slices inside `window_s` (default: the
        full window)."""
        now_epoch = int(self._time() / self.slice_s)
        n = self.slices if window_s is None else max(
            1, min(self.slices, int(round(window_s / self.slice_s)))
        )
        out = QuantileSketch(self.bounds)
        for entry in self._ring:
            if entry is not None and now_epoch - entry[0] < n:
                out.merge(entry[1])
        return out


class SLOEngine:
    """Rolling objectives over TTFT/TPOT/queue-wait, per replica.

    Objectives are seconds thresholds (0 disables a metric's objective;
    its sketch still records, so /debug/slo shows quantiles even before
    an objective is configured). `target` is the good fraction (0.99 =
    1% error budget); burn rate = bad_frac / (1 - target). A replica is
    BURNING when both the long and the short (window/12) burn rates of
    any objective exceed 1.0; one of the two alone is a warning."""

    #: Short window divisor (the SRE multi-window fast arm).
    SHORT_DIV = 12

    def __init__(self, *, ttft_ms: float = 0.0, tpot_ms: float = 0.0,
                 queue_wait_ms: float = 0.0, window_s: float = 300.0,
                 target: float = 0.99, slices: int = 12,
                 bounds: Sequence[float] = LATENCY_BUCKETS_S,
                 time_fn: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._time = time_fn
        self.window_s = max(1.0, float(window_s))
        self.slices = max(self.SHORT_DIV, int(slices))
        self.target = min(0.9999, max(0.5, float(target)))
        bounds = tuple(sorted(bounds))
        self.objectives: Dict[str, float] = {}
        for metric, ms in (("ttft", ttft_ms), ("tpot", tpot_ms),
                           ("queue_wait", queue_wait_ms)):
            if ms and ms > 0:
                # Snap the threshold UP onto a sketch bound so frac_over
                # is exact at bucket resolution (never flags a value the
                # operator's threshold would not have).
                thr = ms / 1000.0
                i = bisect.bisect_left(bounds, thr)
                self.objectives[metric] = (bounds[i] if i < len(bounds)
                                           else bounds[-1])
        self._bounds = bounds
        # (metric, replica) -> _Rolling.
        self._rolling: Dict[Tuple[str, str], _Rolling] = {}

    @property
    def enabled(self) -> bool:
        return bool(self.objectives)

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target

    # ------------------------------------------------------------ feeding

    def observe(self, metric: str, seconds: float,
                replica: str = "r0") -> None:
        if metric not in METRICS:
            return
        key = (metric, replica or "r0")
        # The whole observe runs under the engine lock: ring rotation and
        # the sketch's counter increments are read-modify-writes, and
        # concurrent request-completion threads would otherwise drop or
        # miscount observations under exactly the high-QPS conditions the
        # engine exists to measure. One uncontended lock per request
        # TERMINAL (not per round) — far off the decode hot path.
        with self._lock:
            roll = self._rolling.get(key)
            if roll is None:
                roll = self._rolling[key] = _Rolling(
                    self.window_s, self.slices, self._bounds, self._time
                )
            roll.observe(seconds)

    # ----------------------------------------------------------- reading

    def _metric_view(self, sketch_long: QuantileSketch,
                     sketch_short: QuantileSketch,
                     metric: str) -> Dict[str, object]:
        out: Dict[str, object] = {**sketch_long.snapshot()}
        thr = self.objectives.get(metric)
        if thr is not None:
            bad_long = sketch_long.frac_over(thr)
            bad_short = sketch_short.frac_over(thr)
            burn_long = bad_long / self.error_budget
            burn_short = bad_short / self.error_budget
            out.update({
                "objective_s": thr,
                "bad_frac": round(bad_long, 6),
                "bad_frac_short": round(bad_short, 6),
                "burn_rate": round(burn_long, 3),
                "burn_rate_short": round(burn_short, 3),
                "burning": bool(sketch_long.count and sketch_short.count
                                and burn_long > 1.0 and burn_short > 1.0),
                "warning": bool(sketch_long.count
                                and (burn_long > 1.0 or burn_short > 1.0)),
            })
        return out

    def replica_report(self, replica: str) -> Dict[str, object]:
        short_s = self.window_s / self.SHORT_DIV
        metrics: Dict[str, object] = {}
        # Merges run under the same lock observes take: a half-applied
        # counter increment mid-merge would desync count vs buckets.
        with self._lock:
            views = [
                (m, roll.merged(), roll.merged(short_s))
                for m in METRICS
                if (roll := self._rolling.get((m, replica))) is not None
            ]
        for m, long_sk, short_sk in views:
            metrics[m] = self._metric_view(long_sk, short_sk, m)
        burning = any(v.get("burning") for v in metrics.values()
                      if isinstance(v, dict))
        warning = any(v.get("warning") for v in metrics.values()
                      if isinstance(v, dict))
        return {
            "replica": replica,
            "metrics": metrics,
            "state": ("burning" if burning
                      else "warning" if warning else "ok"),
        }

    def replica_burning(self, replica: str) -> bool:
        return self.replica_report(replica)["state"] == "burning"

    def replicas(self) -> List[str]:
        with self._lock:
            return sorted({r for (_, r) in self._rolling})

    def report(self) -> Dict[str, object]:
        """The /debug/slo payload: config, per-replica views, and the
        fleet roll-up (replica sketches MERGED, not averaged — the
        mergeability the fixed buckets buy)."""
        short_s = self.window_s / self.SHORT_DIV
        reps = self.replicas()
        per = [self.replica_report(r) for r in reps]
        fleet: Dict[str, object] = {}
        for m in METRICS:
            long_sk = QuantileSketch(self._bounds)
            short_sk = QuantileSketch(self._bounds)
            with self._lock:
                rollers = [self._rolling[(m, r)] for r in reps
                           if (m, r) in self._rolling]
                for roll in rollers:
                    long_sk.merge(roll.merged())
                    short_sk.merge(roll.merged(short_s))
            if rollers:
                fleet[m] = self._metric_view(long_sk, short_sk, m)
        burning = [p["replica"] for p in per if p["state"] == "burning"]
        warning = [p["replica"] for p in per if p["state"] == "warning"]
        return {
            "enabled": self.enabled,
            "objectives": {m: {"threshold_s": t, "target": self.target}
                           for m, t in self.objectives.items()},
            "window_s": self.window_s,
            "short_window_s": round(short_s, 3),
            "replicas": per,
            "fleet": fleet,
            "burning": burning,
            "state": ("burning" if burning
                      else "warning" if warning or any(
                          v.get("warning") for v in fleet.values()
                          if isinstance(v, dict)) else "ok"),
        }

    def burning(self) -> List[str]:
        """Replica labels currently burning an objective (the health()
        degraded feed)."""
        return [r for r in self.replicas() if self.replica_burning(r)]


def _engine_from_env() -> SLOEngine:
    def _f(name: str, default: str) -> float:
        try:
            return float(os.environ.get(name, default) or 0.0)
        except ValueError:
            return float(default)

    return SLOEngine(
        ttft_ms=_f("LSOT_SLO_TTFT_MS", "0"),
        tpot_ms=_f("LSOT_SLO_TPOT_MS", "0"),
        queue_wait_ms=_f("LSOT_SLO_QUEUE_WAIT_MS", "0"),
        window_s=_f("LSOT_SLO_WINDOW_S", "300"),
        target=_f("LSOT_SLO_TARGET", "0.99"),
    )


#: Process-wide engine the serving layer feeds (MetricsRegistry.record)
#: and the /debug/slo, /metrics, health() surfaces read.
ENGINE: SLOEngine = _engine_from_env()


def reconfigure(*, ttft_ms: float = 0.0, tpot_ms: float = 0.0,
                queue_wait_ms: float = 0.0, window_s: float = 300.0,
                target: float = 0.99) -> SLOEngine:
    """App-startup wiring seam (AppConfig.slo_*): swap the process
    engine — same pattern as `tracing.TRACER.reconfigure`, so
    `AppConfig(slo_ttft_ms=500)` is honored, not a silent no-op.
    Returns the new engine (tests use the return to drive a clock)."""
    global ENGINE
    ENGINE = SLOEngine(ttft_ms=ttft_ms, tpot_ms=tpot_ms,
                       queue_wait_ms=queue_wait_ms, window_s=window_s,
                       target=target)
    return ENGINE

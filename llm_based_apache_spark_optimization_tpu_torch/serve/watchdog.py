"""Liveness primitives: decode-loop heartbeats and stall thresholds.

A copy of the JAX package's `serve/watchdog.py`. The supervisor
(serve/supervisor.py) recovers failures that raise; a wedged decode loop (a
hung device call, a stuck dependency) raises nothing. This module is the
detection half:

- `Heartbeat`: a thread-safe stamp the scheduler's event loop touches at
  the top of every iteration (`stamp(busy=...)`), plus a `round_done()`
  tick per harvested decode round that feeds an EWMA of round intervals.
  `age()` is the time since the loop last proved it was alive;
  `expected_round_s()` is its own measured cadence.
- `stall_threshold(hb, factor, floor_s)`: the escalation bar,
  `max(floor_s, factor x expected_round_s)`.
- `CombinedHeartbeat`: a read-only view over several heartbeats (a replica
  pool): `busy` if any replica is busy, `age()` the oldest busy replica's.

The enforcement half is `SupervisedScheduler`'s monitor thread, which
escalates a busy heartbeat older than the threshold to `SchedulerStalled`.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["CombinedHeartbeat", "Heartbeat", "stall_threshold"]


class Heartbeat:
    """Progress stamp for one event loop. `stamp(busy)` at the top of
    every loop iteration (cheap: a lock + three stores); `round_done()`
    once per harvested decode round to feed the round-interval EWMA.
    Readers (the supervisor's monitor thread, /metrics) see a coherent
    (time, busy) pair."""

    __slots__ = ("_lock", "_last", "_busy", "_beats", "_rounds",
                 "_last_round", "_round_ewma", "_alpha")

    def __init__(self, alpha: float = 0.2):
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._busy = False
        self._beats = 0
        self._rounds = 0
        self._last_round: Optional[float] = None
        self._round_ewma: Optional[float] = None
        self._alpha = alpha

    def stamp(self, busy: bool) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._busy = busy
            self._beats += 1
            if not busy:
                # Idle gap: the next harvested round's interval must not
                # feed the cadence EWMA — one hour of quiet before a
                # request would otherwise inflate expected_round_s (and
                # with it the stall threshold) by orders of magnitude,
                # silently disabling detection for the burst that follows.
                # The EWMA itself persists: it remembers what a healthy
                # round cost in the last busy period.
                self._last_round = None

    def round_done(self) -> None:
        """One decode round harvested: progress, and a cadence sample."""
        now = time.monotonic()
        with self._lock:
            if self._last_round is not None:
                dt = now - self._last_round
                self._round_ewma = (
                    dt if self._round_ewma is None
                    else self._alpha * dt + (1 - self._alpha) * self._round_ewma
                )
            self._last_round = now
            self._rounds += 1
            # A harvested round is also a liveness proof in its own right.
            self._last = now
            self._beats += 1

    def age(self) -> float:
        with self._lock:
            return time.monotonic() - self._last

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._busy

    @property
    def rounds(self) -> int:
        with self._lock:
            return self._rounds

    def expected_round_s(self) -> Optional[float]:
        """EWMA of intervals between harvested rounds (None until two
        rounds have completed) — the loop's own measured cadence, the
        base the stall threshold scales from."""
        with self._lock:
            return self._round_ewma

    def snapshot(self) -> Dict[str, object]:
        """/metrics payload: age, busy flag, round count, cadence."""
        with self._lock:
            ewma = self._round_ewma
            return {
                "age_s": round(time.monotonic() - self._last, 3),
                "busy": self._busy,
                "rounds": self._rounds,
                "expected_round_s": (round(ewma, 4)
                                     if ewma is not None else None),
            }


class CombinedHeartbeat:
    """Read-only monitor view over several replicas' heartbeats
    (SchedulerPool): one wedged replica must look stale even while its
    siblings keep stamping, so `age()` is the OLDEST busy replica's age
    (falling back to the oldest overall when none is busy) and `busy` is
    any-replica-busy. `expected_round_s` is the slowest replica's cadence
    — the threshold must tolerate the pool's worst healthy round.

    `labels` attributes each heartbeat to its replica ("r{i}" by
    default, the pool's label vocabulary): `snapshot()` carries them,
    and `verdicts(factor, floor_s)` turns the combined view into a
    per-replica stall judgment — the fleet supervisor needs to know
    WHICH replica went stale, not just that the oldest busy one did."""

    def __init__(self, heartbeats: Sequence[Heartbeat],
                 labels: Optional[Sequence[str]] = None):
        if not heartbeats:
            raise ValueError("CombinedHeartbeat needs at least one heartbeat")
        self._hbs = list(heartbeats)
        if labels is not None and len(labels) != len(self._hbs):
            raise ValueError(
                f"got {len(labels)} labels for {len(self._hbs)} heartbeats"
            )
        self.labels = (list(labels) if labels is not None
                       else [f"r{i}" for i in range(len(self._hbs))])

    @property
    def busy(self) -> bool:
        return any(h.busy for h in self._hbs)

    def age(self) -> float:
        busy_ages = [h.age() for h in self._hbs if h.busy]
        return max(busy_ages) if busy_ages else max(
            h.age() for h in self._hbs
        )

    @property
    def rounds(self) -> int:
        return sum(h.rounds for h in self._hbs)

    @property
    def cold(self) -> bool:
        """ANY replica still at zero harvested rounds: the pool is still
        in first-boot territory. The summed `rounds` cannot gate a warmup
        grace window — one warmed replica would end the grace for
        siblings whose first rounds are still blocking their loop (and
        reading as a wedge)."""
        return any(h.rounds == 0 for h in self._hbs)

    def expected_round_s(self) -> Optional[float]:
        vals = [v for v in (h.expected_round_s() for h in self._hbs)
                if v is not None]
        return max(vals) if vals else None

    def verdicts(self, factor: float, floor_s: float) -> List[Dict[str, object]]:
        """Per-replica stall judgment: for each heartbeat, its label, its
        own age/busy, its OWN threshold (each replica is judged by its
        own measured cadence — a slow replica must not lower the bar for
        a fast sibling, nor vice versa), and the verdict: `stalled` is
        True only for a BUSY replica whose age exceeds its threshold.
        This is what makes a pool stall attributable: the combined
        `age()` can say the oldest busy replica is stale, but only the
        verdict list says WHICH — the targeted-restart feed."""
        out = []
        for label, h in zip(self.labels, self._hbs):
            age = h.age()
            busy = h.busy
            threshold = stall_threshold(h, factor, floor_s)
            out.append({
                "replica": label,
                "busy": busy,
                "age_s": round(age, 3),
                "stall_threshold_s": round(threshold, 3),
                "stalled": bool(busy and age > threshold),
            })
        return out

    def snapshot(self) -> Dict[str, object]:
        ewma = self.expected_round_s()
        return {
            "age_s": round(self.age(), 3),
            "busy": self.busy,
            "rounds": self.rounds,
            "expected_round_s": round(ewma, 4) if ewma is not None else None,
            "replicas": [
                {"replica": label, **h.snapshot()}
                for label, h in zip(self.labels, self._hbs)
            ],
        }


def stall_threshold(hb, factor: float, floor_s: float) -> float:
    """Heartbeat age beyond which a BUSY loop counts as wedged:
    `max(floor_s, factor × expected_round_s)`. Both knobs surface as
    LSOT_STALL_FACTOR / LSOT_STALL_MIN_S (app/config.py). The floor must
    sit above the worst LEGITIMATE host-thread occupation — a first
    prefill that builds the CUDA kernels blocks the loop exactly like a
    wedge does (raise LSOT_STALL_MIN_S past it, or lean on the warmup
    grace, before tightening it)."""
    ewma = hb.expected_round_s()
    return max(float(floor_s), float(factor) * (ewma or 0.0))

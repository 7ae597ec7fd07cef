"""Fault-tolerance primitives for the serving path.

The north star is heavy traffic, and heavy traffic means overload and
partial failure are NORMAL operating states, not exceptions: queues back
up, a sidecar daemon restarts, a SQL engine hiccups, a device loop dies.
Before this module the stack had exactly one failure policy — the
scheduler fails everything on a loop crash — and everything else hung,
crashed the request, or piled up silently. Production serving engines
(vLLM/TGI, PAPERS.md) treat admission control and request timeouts as core
scheduler features; this module is that layer, shared by the scheduler,
the Ollama client adapter, and the SQL backends:

- `Deadline` — a monotonic-clock budget threaded request → queue → decode.
  Created once at the edge (`Deadline.after(seconds)`) and *checked* at
  every hand-off; expired work fails fast with `DeadlineExceeded` instead
  of occupying a slot or a connection.
- `RetryPolicy` — capped exponential backoff with FULL jitter (delay ~
  U[0, min(cap, base·2^attempt)]); retries only failures the caller
  classifies as safe (idempotent or connect-phase: the request never
  reached the dependency, so replaying it cannot double-apply anything).
- `CircuitBreaker` — classic closed/open/half-open per external
  dependency: `failure_threshold` consecutive infra failures open the
  circuit, open calls shed instantly with `CircuitOpen` (no connect
  timeout burned per request while the dependency is down), and after
  `reset_after_s` ONE half-open probe decides whether to close again.

Typed errors are the API contract: `Overloaded` (shed at admission, HTTP
429), `DeadlineExceeded` (budget burned, HTTP 504), `CircuitOpen`
(dependency down, HTTP 503), `SchedulerCrashed` (engine dead — 503 and
breaker-relevant, distinct from a per-request 500), `Draining` (the server
is shutting down gracefully — 503 + Retry-After). All subclass
RuntimeError so existing broad handlers keep working.

Every constructed breaker also registers itself by dependency name in a
process-wide registry (`breaker_states()`), so `/metrics` can show the
per-dependency open/closed picture instead of aggregate counters only.

Everything here is stdlib + thread-safe, with injectable clock/rng/sleep
so tests replay deterministically. Counters land in
`utils.observability.resilience` and surface through `/metrics`.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Optional

from ..utils.observability import resilience

__all__ = [
    "CircuitBreaker",
    "CircuitOpen",
    "Deadline",
    "DeadlineExceeded",
    "Draining",
    "Overloaded",
    "Quarantined",
    "RetryPolicy",
    "SchedulerCrashed",
    "SchedulerStalled",
    "SlotStalled",
    "breaker_states",
]


# --------------------------------------------------------------- typed errors


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired (queued or in flight) — HTTP 504."""


class SlotStalled(DeadlineExceeded):
    """One slot's generation made no progress for N consecutive harvest
    rounds while other slots in the same batch advanced: the scheduler
    retires it typed instead of letting it occupy a decode lane forever.
    504-family (subclasses DeadlineExceeded): the client's latency budget
    is what a wedged lane burns, and existing 504 handlers keep working.
    A WHOLE-loop stall is the watchdog's job (`SchedulerStalled`); this is
    the single-lane case, which must not restart the loop."""


class Overloaded(RuntimeError):
    """Admission control shed the request (queue at capacity) — HTTP 429.

    `retry_after_s` is the server's backpressure hint, surfaced as the
    Retry-After header."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class Draining(Overloaded):
    """The server is draining for shutdown (SIGTERM): new work is refused
    and journaled-but-unfinished work is spilled for the next process —
    HTTP 503 + Retry-After (the replacement instance will take the retry).
    Subclasses Overloaded so existing shed handlers keep working; the API
    layer maps it to 503 (the whole SERVER is going away, not one queue)."""


class CircuitOpen(RuntimeError):
    """A dependency's circuit breaker is open: the call was shed without
    touching the dependency — HTTP 503 with Retry-After."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class Quarantined(RuntimeError):
    """A poison request: its replay has ridden down LSOT_MAX_ENTRY_REPLAYS
    crashed scheduler incarnations, so the supervisor retires it typed
    instead of letting one request burn the whole fleet's restart budget
    crash by crash (serve/supervisor.py). Client-visible (a generic 500
    at the API layer — the request itself is the suspect, not the
    server's capacity, so none of the retry-me 429/503/504 shapes fit);
    the `quarantined` resilience counter tallies it for operators."""


class SchedulerCrashed(RuntimeError):
    """The scheduler's event loop died: every request on it fails with THIS
    (not a per-request error), carrying the original traceback so API and
    pipeline callers can answer 503 "engine dead" instead of a generic 500
    — and operators see the real device error, not just its last victim."""

    def __init__(self, message: str, crash_traceback: str = ""):
        super().__init__(message)
        self.crash_traceback = crash_traceback

    @classmethod
    def from_exception(cls, exc: BaseException) -> "SchedulerCrashed":
        import traceback

        tb = "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__)
        )
        wrapped = cls(f"scheduler loop crashed: {exc!r}", crash_traceback=tb)
        wrapped.__cause__ = exc
        return wrapped


class SchedulerStalled(SchedulerCrashed):
    """The decode loop stopped making progress — its heartbeat went stale
    past the watchdog's stall threshold while work was in flight (hung XLA
    dispatch, wedged device tunnel). A wedge never *raises*, so the
    watchdog (serve/watchdog.py + SupervisedScheduler's monitor thread)
    escalates it to this SYNTHETIC crash: subclassing `SchedulerCrashed`
    means the existing restart/journal/replay machinery recovers hung
    requests exactly like crashed ones, and the API still answers 503."""


# ------------------------------------------------------------------ deadline


class Deadline:
    """Monotonic expiry instant. Create once per request at the edge, check
    (`expired()`) at every hand-off; `remaining()` bounds downstream waits
    (retry sleeps, queue gets) so no stage can outlive the budget."""

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: float):
        self.expires_at = expires_at

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        if seconds <= 0:
            raise ValueError(f"deadline must be positive, got {seconds}")
        return cls(time.monotonic() + seconds)

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def __repr__(self) -> str:  # diagnostics in error messages
        return f"Deadline(remaining={self.remaining():.3f}s)"


# --------------------------------------------------------------------- retry


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with full jitter.

    `call(fn, retryable=...)` retries `fn` while `retryable(exc)` is true
    and attempts remain. Only pass a `retryable` that is safe to replay:
    connect-phase failures (the request never reached the dependency) and
    idempotent operations. Sleep/rng are injectable so tests run at full
    speed and replay exactly; a `deadline` clamps every backoff sleep and
    stops retrying once the budget is gone (the last real error
    propagates — a retry that cannot finish is not attempted)."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        """Full jitter: U[0, min(cap, base·2^attempt)]. Decorrelates retry
        storms — synchronized clients reconnecting after a dependency blip
        would otherwise hammer it in lockstep at every backoff step."""
        return rng.uniform(
            0.0, min(self.max_delay_s, self.base_delay_s * (2.0 ** attempt))
        )

    def call(
        self,
        fn: Callable,
        retryable: Callable[[BaseException], bool],
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        deadline: Optional[Deadline] = None,
    ):
        rng = rng if rng is not None else random.Random()
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classified by `retryable`
                if not retryable(e):
                    # Deterministic failure: NOT a resilience event (no
                    # counter) — a bad SQL query is the caller's error, and
                    # counting it would make /metrics report "faults" on a
                    # perfectly healthy stack.
                    raise
                if attempt == self.max_attempts - 1:
                    resilience.inc("retry_giveups")
                    raise
                delay = self.delay_s(attempt, rng)
                if deadline is not None:
                    room = deadline.remaining()
                    if room <= 0:
                        # Budget gone: the retry could never finish.
                        resilience.inc("retry_giveups")
                        raise
                    delay = min(delay, room)
                resilience.inc("retries")
                sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover


# ----------------------------------------------------------- circuit breaker

#: Process-wide registry of the LIVE breaker per dependency name (last
#: constructed wins — deployments build one breaker per dependency; tests
#: that churn breakers just update the pointer). /metrics reads it through
#: `breaker_states()` so operators see WHICH dependency (ollama, sql,
#: scheduler-restart) is open, not just that some aggregate counter moved.
_BREAKERS: dict = {}
_BREAKERS_LOCK = threading.Lock()


def breaker_states() -> dict:
    """{name: {state, consecutive_failures, retry_after_s}} for every
    registered breaker — the per-dependency view the aggregate trip/shed
    counters cannot give (ROADMAP fault-tolerance follow-up)."""
    with _BREAKERS_LOCK:
        items = list(_BREAKERS.items())
    out = {}
    for name, b in items:
        with b._lock:
            state, failures = b._state, b._failures
        out[name] = {
            "state": state,
            "consecutive_failures": failures,
            "retry_after_s": round(b.retry_after_s(), 3),
        }
    return out


class CircuitBreaker:
    """Closed/open/half-open breaker for ONE external dependency.

    closed: calls flow; `failure_threshold` CONSECUTIVE recorded failures
    trip it open. open: `allow()` is False (callers shed with CircuitOpen)
    until `reset_after_s` has passed. half-open: exactly one probe call is
    allowed through; its success closes the circuit, its failure re-opens
    (re-stamping the timer). Record only INFRA failures (connect refused,
    timeouts, injected faults) — a caller error like bad SQL says nothing
    about the dependency's health and must not trip the breaker."""

    def __init__(
        self,
        name: str,
        failure_threshold: int = 5,
        reset_after_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        with _BREAKERS_LOCK:
            _BREAKERS[name] = self

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call proceed right now? Half-open admits ONE probe; callers
        that take the permit must report back via record_success/failure."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at >= self.reset_after_s:
                    self._state = "half_open"
                    self._probing = False
                else:
                    return False
            # half-open: one in-flight probe at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            if self._state != "closed":
                resilience.inc("breaker_closes")
            self._state = "closed"
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            if self._state == "half_open":
                # Failed probe: straight back to open, timer restarted.
                self._state = "open"
                self._opened_at = self._clock()
                self._probing = False
                resilience.inc("breaker_trips")
                return
            self._failures += 1
            if self._state == "closed" and \
                    self._failures >= self.failure_threshold:
                self._state = "open"
                self._opened_at = self._clock()
                resilience.inc("breaker_trips")

    def unregister(self) -> None:
        """Drop this breaker from the /metrics registry (if it is still
        the registered instance for its name). Long-lived owners that
        tear down — a supervised scheduler shutting down — call this so
        the per-dependency view doesn't accumulate dead dependencies."""
        with _BREAKERS_LOCK:
            if _BREAKERS.get(self.name) is self:
                del _BREAKERS[self.name]

    def retry_after_s(self) -> float:
        """Seconds until the next half-open probe window (Retry-After)."""
        with self._lock:
            if self._state != "open":
                return 0.0
            return max(
                0.0, self.reset_after_s - (self._clock() - self._opened_at)
            )

    def shed(self) -> CircuitOpen:
        """The typed error for a disallowed call (counter included)."""
        resilience.inc("breaker_open_shed")
        retry_after = max(0.1, self.retry_after_s())
        return CircuitOpen(
            f"{self.name}: circuit open after repeated failures; "
            f"next probe in {retry_after:.1f}s",
            retry_after_s=retry_after,
        )

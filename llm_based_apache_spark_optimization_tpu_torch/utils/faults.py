"""Deterministic fault injection at the serving stack's failure boundaries.

A fault-tolerance layer that has never seen a fault is untested by
definition (FlashInfer-Bench's thesis, PAPERS.md: a serving stack is only
trustworthy when its failure behavior is itself exercised by the harness).
This registry lets tests, the chaos evalh mode, and `scripts/chaos_smoke.sh`
make the out-of-process boundaries fail ON DEMAND, reproducibly:

    LSOT_FAULTS=ollama:connect:0.5,sql:exec:1 LSOT_FAULTS_SEED=0 pytest -m chaos

Spec grammar: comma-separated `site:point:probability[:seconds]` entries.
The first two fields name an injection site (`ollama:connect`,
`sql:exec`, `sql:load`, `sched:decode` — kills the loop at round issue,
before any token of the round exists — `sched:crash` — kills it at
harvest, MID-BATCH, after tokens may already have streamed to clients:
the supervisor's replay-without-duplicates seam — `sched:slot_stall` —
marks a request's slot as a silently no-progress decode lane, the
per-slot stall-retirement seam — `sched:wedge_r{i}` — the
replica-ADDRESSABLE fleet seam: every scheduler checks
`sched:wedge_<its replica label>` at round issue, so
`sched:wedge_r1:1:0.5` wedges exactly pool replica r1 (duration form)
or `sched:wedge_r1:1` crashes it (raising form) while its siblings run
untouched — the targeted-restart chaos trigger — plus the
duration-valued HANG sites below; grep for `FAULTS.check` to
enumerate); the probability is a float
in (0, 1]. The RNG is seeded (`LSOT_FAULTS_SEED`, default 0), so the
same spec + seed + call sequence replays the exact same fault schedule —
chaos tests assert concrete outcomes, not distributions.

**Duration-valued sites** (the optional 4th field, seconds > 0) model
HANGS instead of failures: a firing check SLEEPS for that long and then
returns instead of raising — the wedge that never raises is exactly what
the watchdog layer (serve/watchdog.py) exists to catch. `sched:hang:1:5`
wedges the decode loop 5 s at round issue (the supervisor's heartbeat
monitor must escalate it to a `SchedulerStalled` restart);
`ollama:stall:p:secs` and `sql:stall:p:secs` stall the out-of-process
boundaries so dependency timeouts/deadlines are exercised, not assumed.
Site names are always exactly two `:`-separated segments — the parser
relies on it to tell `site:point:prob:secs` from a malformed entry.

**Value-valued sites** reuse the same 4th field as a plain NUMBER the
injection point interprets itself, read through `FAULTS.value(site)`
(fires with the configured probability, returns the value, never raises
or sleeps). In-tree value sites: `kv:pressure:p:v` — the paged KV
scheduler shrinks its effective page pool by `v` (a fraction of the
pool when v < 1, an absolute page count otherwise) for every loop
iteration the site fires, forcing the allocation failures that drive
victim preemption (serve/scheduler.py; `evalh --chaos` pressure stage)
— and `net:delay:p:secs` — the replica-transport rpc envelope
(serve/remote.py) stalls that long on the wire, driving the
deadline-propagating timeout path.

**Network sites** (ISSUE 15, consumed at the CLIENT side of both
replica transports in serve/remote.py so one seeded schedule drives
loopback and socket fleets alike): `net:drop:p` — the RPC executes on
the server but the response is lost, so the retry must dedup against
the idempotency-token ledger (the no-double-generate proof);
`net:dup:p` — the request is delivered twice and the second delivery
must be absorbed by the same ledger; `net:delay:p:secs` — above;
`net:partition_r{i}:p` — replica-ADDRESSABLE, like `sched:wedge_r{i}`:
every RPC, token-stream delivery and lease ping to pool replica r{i}
fails while the site is configured, which is what drives the
lease-expiry → targeted-restart → journal-replay recovery path
(`evalh --chaos` stage 7). Drop/dup consult the non-raising
`FAULTS.fires(site)` draw; the partition's STATE (token-stream gating)
reads `FAULTS.site_active(site)`, which never draws — concurrent
stream deliveries must not perturb the seeded schedule.

**Per-class SQL error sites** (ISSUE 20): `sql:syntax`, `sql:schema`
and `sql:transient` fire inside `ResilientSQLBackend.execute` and raise
a REPRESENTATIVE engine error instead of the generic `InjectedFault` —
the exact strings a real sqlite engine produces for each class of the
repair taxonomy (app/repair.classify_sql_error), so chaos stage 10 and
the unit tests can exercise every taxonomy branch deterministically.
`sql:syntax`/`sql:schema` raise `InjectedSQLError` (a plain Exception:
deterministic engine answers, NEVER retried or breaker-counted);
`sql:transient` raises `InjectedFault` (a ConnectionError: the retry
ladder and breaker treat it like the lock-contention outage it
simulates). `SQL_FAULT_ERRORS` below is the site → message table.

**Fleet-membership site** (ISSUE 17): `fleet:spawn:p` fires inside the
autoscaler's scale-up attempt (serve/elastic.py) BEFORE the standby
worker is contacted — an injected spawn failure must degrade to "keep
serving at the current fleet size" (a counted non-event in
autoscaler.stats()), never wedge the control loop or lose a request
(`evalh --chaos` stage 8's partition-during-scale-up leg).

Injection points call `FAULTS.check("site:point")`, which raises
`InjectedFault` (a ConnectionError subclass, so connect-phase retry
classifiers treat it exactly like a real refused connection) — or, for a
duration-valued site, sleeps — with the configured probability. With no
spec configured the check is one dict lookup on an empty dict —
effectively free on the serving path.

Determinism caveat: the registry draws from ONE seeded stream, so replay
is exact only when the injection points are hit in a deterministic order
(single-threaded harnesses, or probability 1). Concurrent chaos runs still
get the configured *rates*, just not a bit-exact schedule.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Tuple

from .observability import resilience

__all__ = ["FAULTS", "FaultRegistry", "InjectedFault", "InjectedSQLError",
           "SQL_FAULT_ERRORS"]


class InjectedFault(ConnectionError):
    """A deliberately injected failure. Subclasses ConnectionError so the
    retry layers' connect-phase classifiers (and generic OSError handlers)
    treat it like the real outage it simulates."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(message or f"injected fault at {site!r} (LSOT_FAULTS)")
        self.site = site


class InjectedSQLError(Exception):
    """A deliberately injected DETERMINISTIC engine error (ISSUE 20):
    the message is a representative real-engine string for one class of
    the repair taxonomy. A plain Exception on purpose — retry ladders
    and breakers must treat it exactly like the syntax/schema error it
    simulates (no retry, no breaker count), so the only layer that acts
    on it is the repair loop's classifier."""

    def __init__(self, site: str, message: str):
        super().__init__(message)
        self.site = site


#: Per-class SQL fault sites (ISSUE 20): site → (exception class,
#: representative engine error string). The messages are the shapes
#: app/repair.classify_sql_error keys on, so configuring
#: `sql:syntax:1` drives the exact taxonomy branch a real engine would.
SQL_FAULT_ERRORS = {
    "sql:syntax": (InjectedSQLError, 'near "FORM": syntax error'),
    "sql:schema": (InjectedSQLError, "no such column: total_amout"),
    "sql:transient": (InjectedFault, "database is locked"),
}


class FaultRegistry:
    """Seeded per-site fault probabilities + injected-fault counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._probs: Dict[str, float] = {}
        self._durations: Dict[str, float] = {}
        self._rng = random.Random(0)
        self._counts: Dict[str, int] = {}
        # Injectable so hang-site tests assert the sleep without paying it.
        self._sleep = time.sleep

    # ------------------------------------------------------------- config

    @classmethod
    def parse(cls, spec: str) -> Dict[str, float]:
        """`"ollama:connect:0.5,sql:exec:1"` -> {"ollama:connect": 0.5,
        "sql:exec": 1.0} (probabilities only; duration fields are dropped
        — use parse_spec for both). Raises ValueError on malformed
        entries — a typo'd chaos spec must fail the run, not silently
        inject nothing."""
        return cls.parse_spec(spec)[0]

    @staticmethod
    def parse_spec(spec: str) -> Tuple[Dict[str, float], Dict[str, float]]:
        """Full parse: (probabilities, durations). An entry is
        `site:point:prob` (raising site) or `site:point:prob:secs`
        (duration-valued hang site: the check SLEEPS secs instead of
        raising). Site names are exactly two segments."""
        probs: Dict[str, float] = {}
        durations: Dict[str, float] = {}
        for entry in filter(None, (s.strip() for s in spec.split(","))):
            fields = entry.split(":")
            if len(fields) not in (3, 4):
                raise ValueError(
                    f"bad fault spec entry {entry!r} "
                    f"(want site:point:prob[:secs])"
                )
            site = f"{fields[0]}:{fields[1]}"
            if not fields[0] or not fields[1]:
                raise ValueError(
                    f"bad fault spec entry {entry!r} "
                    f"(want site:point:prob[:secs])"
                )
            try:
                prob = float(fields[2])
            except ValueError:
                raise ValueError(
                    f"bad fault probability in {entry!r}"
                ) from None
            if not 0.0 < prob <= 1.0:
                raise ValueError(
                    f"fault probability must be in (0, 1], got {prob} "
                    f"in {entry!r}"
                )
            if len(fields) == 4:
                try:
                    secs = float(fields[3])
                except ValueError:
                    raise ValueError(
                        f"bad hang duration in {entry!r}"
                    ) from None
                if secs <= 0.0:
                    raise ValueError(
                        f"hang duration must be positive, got {secs} "
                        f"in {entry!r}"
                    )
                durations[site] = secs
            probs[site] = prob
        return probs, durations

    def configure(self, spec: str, seed: int = 0) -> "FaultRegistry":
        """(Re)configure sites + reseed the stream; empty spec disables."""
        probs, durations = self.parse_spec(spec)
        with self._lock:
            self._probs = probs
            self._durations = durations
            self._rng = random.Random(seed)
            self._counts = {}
        return self

    def configure_from_env(self) -> "FaultRegistry":
        return self.configure(
            os.environ.get("LSOT_FAULTS", ""),
            int(os.environ.get("LSOT_FAULTS_SEED", "0")),
        )

    def clear(self) -> None:
        with self._lock:
            self._probs = {}
            self._durations = {}
            self._counts = {}

    @property
    def active(self) -> bool:
        return bool(self._probs)

    # ----------------------------------------------------------- checking

    def check(self, site: str) -> None:
        """Raise InjectedFault with the site's configured probability —
        or, for a duration-valued site (`site:point:prob:secs`), SLEEP
        that long and return: the hang that never raises, which the
        watchdog layer must detect from outside."""
        if not self._probs:  # fast path: injection off
            return
        with self._lock:
            prob = self._probs.get(site)
            if prob is None or self._rng.random() >= prob:
                return
            self._counts[site] = self._counts.get(site, 0) + 1
            secs = self._durations.get(site)
        resilience.inc("faults_injected")
        if secs is not None:
            # Outside the lock: a wedge must not block other sites' checks.
            self._sleep(secs)
            return
        sql_err = SQL_FAULT_ERRORS.get(site)
        if sql_err is not None:
            exc_cls, message = sql_err
            raise exc_cls(site, message)
        raise InjectedFault(site)

    def fires(self, site: str) -> bool:
        """Boolean draw: True with the site's configured probability
        (counted like check()), never raises or sleeps — for injection
        points that apply their own semantics to a PLAIN firing (the
        transport layer's `net:drop`/`net:dup`). False when the site is
        unconfigured; an unconfigured site draws nothing, so sites
        compose without perturbing each other's seeded schedules."""
        if not self._probs:  # fast path: injection off
            return False
        with self._lock:
            prob = self._probs.get(site)
            if prob is None or self._rng.random() >= prob:
                return False
            self._counts[site] = self._counts.get(site, 0) + 1
        resilience.inc("faults_injected")
        return True

    def site_active(self, site: str) -> bool:
        """Is the site configured at all? NO randomness — no draw, no
        count — so state-like consultations (is replica r1 currently
        partitioned?) can run from any thread at any rate without
        perturbing the seeded schedule the raising/boolean draws replay."""
        if not self._probs:
            return False
        with self._lock:
            return site in self._probs

    def value(self, site: str):
        """Value-valued check: with the site's configured probability,
        return its 4th-field number (never raises, never sleeps) — the
        injection point applies its own semantics (e.g. `kv:pressure`
        shrinks the effective page pool by the value). Returns None when
        the site is unconfigured, has no value field, or the draw does
        not fire. Counts like check() so chaos reports can still prove
        the site fired."""
        if not self._probs:  # fast path: injection off
            return None
        with self._lock:
            prob = self._probs.get(site)
            secs = self._durations.get(site)
            if prob is None or secs is None \
                    or self._rng.random() >= prob:
                return None
            self._counts[site] = self._counts.get(site, 0) + 1
        resilience.inc("faults_injected")
        return secs

    def counts(self) -> Dict[str, int]:
        """Injected faults per site since configure()."""
        with self._lock:
            return dict(self._counts)


#: Process-wide registry every injection point consults; configured from
#: LSOT_FAULTS / LSOT_FAULTS_SEED at import (tests reconfigure directly).
FAULTS = FaultRegistry().configure_from_env()

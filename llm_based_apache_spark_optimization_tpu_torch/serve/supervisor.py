"""Supervised scheduler lifecycle: crash-only serving with journal + replay.

A copy of the JAX package's `serve/supervisor.py`. `SupervisedScheduler`
wraps a `ContinuousBatchingScheduler` or a `SchedulerPool` (anything with
its submit surface) and treats its event loop as a crash-only component:

- **Write-ahead journal.** Every admitted request gets a monotonic request
  id and a journal entry (prompt ids, params, deadline, and a
  client-suppliable *idempotency key*) BEFORE it reaches the inner
  scheduler. Once journaled (and not shed with a typed `Overloaded` or a
  request-shape `ValueError`), the request is ACKNOWLEDGED: it reaches
  exactly one terminal state, a result or a typed error, however many
  times the loop underneath dies. Clients hold the supervisor's own future.
- **Idempotency keys.** A duplicate key while the original is in flight
  returns the SAME future; after completion it returns the journaled
  result (bounded LRU) without generating again.
- **Crash -> restart -> replay.** When an inner future (or submit) fails
  with `SchedulerCrashed`, the supervisor tears the dead loop down,
  rebuilds the scheduler from its factory under bounded restarts with
  full-jitter backoff (`RetryPolicy`), and replays journaled work in
  request-id order. Per-request seeded sampling streams make the replayed
  prefix identical, so tokens a streaming consumer already received are
  suppressed; consumers that cannot take a replay opt out with
  `idempotent=False`. Requests whose deadline expired during the outage
  fail typed `DeadlineExceeded` and count as lost.
- **Health.** `health()` reports `ready | restarting | degraded | dead`
  plus restart/replay/lost counters, the `/readyz` payload. `degraded`
  means the last restart dropped acknowledged work; it clears on the next
  clean completion. Restart budget exhausted -> `dead`.
- **Liveness (the watchdog).** A monitor thread reads the inner
  scheduler's `heartbeat` (serve/watchdog.py) and escalates a busy loop
  whose heartbeat is older than `max(stall_min_s, stall_factor x measured
  round cadence)` to a synthetic `SchedulerStalled`, a `SchedulerCrashed`
  subclass, so the same restart/journal/replay machinery recovers it.
  Teardown of a wedged loop uses a bounded join.
- **Drain.** `drain(deadline_s)` stops admitting (submits raise
  `Draining`), waits for in-flight work up to the deadline, then journals
  what is left to the optional on-disk spill and shuts the loop down.
  `recover()` resubmits a spill file at the next start, so retried
  idempotency keys find their results.

- **Fleets.** Over a `SchedulerPool` with a replica factory, one
  replica's crash or stall is a targeted restart of that replica alone
  (the pool's `on_replica_restart` / `on_replica_drained` call back into
  this journal), and only that replica's journaled requests re-place on
  the fleet, each at most max(2, replicas + 1) times before the
  whole-pool restart takes over; the `*_replica` methods, the per-replica
  loads and health, and the pool's model, routing and tenant views pass
  through. A journaled entry keeps its `model_id`, `tenant` and `qos` over
  replays and the spill. Over one scheduler these hooks do nothing.
  Phase-split fleets: a prefill replica that dies mid-handoff (its first
  token already streamed, the blob never shipped) fails the request typed;
  the entry re-prefills on a sibling with the delivered token suppressed.
  `handoff_stats` and `phase_role` pass through. A remote replica whose
  lease expired (serve/remote.py) fails its requests with
  `ReplicaUnreachable`, a `SchedulerCrashed`: the same targeted replay;
  `transport_stats` passes through.

A constrained entry carries its compiled tables (`constraint`) and
its serializable spec (`constraint_spec`, the grammar name or schema
dict): a replay after a crash resubmits the same tables, and `recover()`
recompiles a spilled spec through `constraint_resolver`, which
`SchedulerBackend` points at its tokenizer's compile.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import logging
import os
import random
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Callable, Dict, List, Optional, Sequence

from ..ops.sampling import SamplingParams
from ..utils.observability import resilience
from .flightrecorder import FlightRecorder, append_jsonl, merge_snapshots
from .resilience import (
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    Draining,
    Overloaded,
    Quarantined,
    RetryPolicy,
    SchedulerCrashed,
    SchedulerStalled,
)
from .qos import DEFAULT_TENANT, bounded_bump
from .watchdog import stall_threshold

_log = logging.getLogger("lsot.supervisor")

__all__ = ["JournalEntry", "SupervisedScheduler"]


@dataclasses.dataclass
class JournalEntry:
    """One acknowledged request in the write-ahead journal. Everything
    needed to resubmit it verbatim after a restart, plus the delivery
    state that makes streaming replay idempotent (`generated` holds the
    tokens the CLIENT has seen; a replay suppresses that prefix)."""

    rid: int
    ids: List[int]
    max_new: int
    sampling: SamplingParams
    seed: int
    idempotency_key: Optional[str]
    constraint: object
    deadline: Optional[Deadline]
    on_token: Optional[Callable[[int], None]]
    idempotent: bool
    future: Future
    generated: List[int] = dataclasses.field(default_factory=list)
    inner: Optional[Future] = None
    cancelled: bool = False
    done: bool = False
    # The constraint SPEC ("spark_sql" / {"table", "columns"} dict) beside
    # the compiled object: the compiled grammar holds device tables and is
    # not serializable, but the spec is plain JSON — it is what the drain
    # spill writes, and recover() recompiles it through the supervisor's
    # `constraint_resolver` (set by SchedulerBackend, which owns the
    # tokenizer the tables must be compiled against).
    constraint_spec: object = None
    # Request-scoped trace (utils/tracing.RequestTrace) when the request
    # was head-sampled: forwarded to every inner-scheduler attempt (the
    # replayed incarnation records into the SAME tree), and its span tree
    # rides the postmortem dump for requests caught in a crash/stall.
    trace: object = None
    # Fleet pools (targeted restart): how many times this entry has been
    # re-placed onto a sibling after a single-replica crash — the bound
    # that stops an entry ping-ponging across a fleet of dying replicas
    # instead of escalating to the full-pool restart path.
    replica_replays: int = 0
    # Poison-request quarantine: how many crashed/stalled incarnations
    # this entry has been replayed after. Past the supervisor's
    # `max_entry_replays` (LSOT_MAX_ENTRY_REPLAYS) the entry retires
    # typed `Quarantined` instead of riding down — and re-crashing —
    # incarnation after incarnation until the fleet's restart budget is
    # gone.
    crash_replays: int = 0
    # Multi-model serving: the registered model this request
    # named. Journaled so a crash replay re-places onto the SAME
    # checkpoint's replicas ("" = model-blind, the single-model shape).
    model_id: str = ""
    # Multi-tenant QoS: tenant attribution and service class.
    # Journaled so a crash replay — and a drain spill recovered by the
    # NEXT process — bills to the same tenant and keeps its WFQ/prefix
    # namespace ("" = unlabeled, the single-tenant shape).
    tenant: str = ""
    qos: str = ""


class SupervisedScheduler:
    """Crash-supervised wrapper with the scheduler's submit surface.

    `factory` is a zero-arg callable building a fresh (not-started)
    scheduler; the supervisor owns start/shutdown of every instance it
    builds. Duck-typed: anything exposing the `ContinuousBatchingScheduler`
    submit contract works (SchedulerPool, the chaos harness's host-only
    replica), so the supervisor's journal/replay logic is testable without
    a device.
    """

    #: GenerationService/SchedulerBackend gate `idempotency_key=` on this.
    supports_idempotency = True

    #: Uniquifies the default breaker name across supervisors in one
    #: process (a multi-model service builds several; a shared last-wins
    #: registry slot would report only the last one's loop health).
    _instances = 0
    _instances_lock = threading.Lock()

    def __init__(
        self,
        factory: Callable[[], object],
        max_restarts: int = 5,
        restart_policy: Optional[RetryPolicy] = None,
        spill_path: Optional[str] = None,
        completed_keys: int = 1024,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        name: Optional[str] = None,
        stall_factor: float = 16.0,
        stall_min_s: float = 10.0,
        stall_join_s: Optional[float] = None,
        warmup_grace_s: float = 0.0,
        postmortem_path: Optional[str] = None,
        max_entry_replays: int = 0,
    ):
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if max_entry_replays < 0:
            raise ValueError("max_entry_replays must be >= 0")
        if name is None:
            with SupervisedScheduler._instances_lock:
                SupervisedScheduler._instances += 1
                n = SupervisedScheduler._instances
            name = "scheduler" if n == 1 else f"scheduler-{n}"
        self.name = name
        self._factory = factory
        self._inner = factory()
        # Fleet pools (SchedulerPool with a replica factory): wire the
        # pool's replica-lifecycle callbacks at THIS layer — the journal
        # lives here, so the pool tells us when a targeted restart/drain
        # finished and we re-place exactly that replica's requests.
        self._wire_fleet(self._inner)
        self.max_restarts = max_restarts
        self._restart_policy = restart_policy or RetryPolicy(
            max_attempts=max_restarts + 1, base_delay_s=0.1, max_delay_s=5.0
        )
        self.spill_path = spill_path
        self._completed_cap = max(1, completed_keys)
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep
        # RLock: terminal futures resolve under the lock, and a client
        # done-callback is allowed to submit follow-up work inline.
        self._lock = threading.RLock()
        self._journal: Dict[int, JournalEntry] = OrderedDict()
        self._by_key: Dict[str, JournalEntry] = {}
        self._completed: "OrderedDict[str, tuple]" = OrderedDict()
        self._next_rid = 1
        self._state = "ready"
        self._draining = False
        self._closed = False
        self._crash_exc: Optional[BaseException] = None
        self._restarts = 0
        self._replayed = 0
        self._lost = 0
        # Poison-request quarantine: an entry replayed after
        # more than this many crashed/stalled incarnations retires typed
        # `Quarantined` instead of burning the restart budget crash by
        # crash — one poison request must not take the fleet down with
        # it. 0 disables (the library default; the app wires
        # LSOT_MAX_ENTRY_REPLAYS). Set it BELOW max_restarts, or the
        # budget dies first and the quarantine never fires.
        self.max_entry_replays = int(max_entry_replays)
        self._quarantined = 0
        # Quarantine attribution per tenant: the poison-
        # request counter gains a tenant axis (bounded top-K labels), so
        # an operator sees WHOSE requests keep crashing the loop.
        self._quarantined_by_tenant: Dict[str, float] = {}
        # Watchdog (serve/watchdog.py): a monitor thread compares the
        # inner loop's heartbeat age against
        # max(stall_min_s, stall_factor × measured round cadence) and
        # escalates a busy-but-stale loop to a synthetic SchedulerStalled.
        # stall_min_s <= 0 disables monitoring entirely; the floor must
        # sit above the worst legitimate host-thread occupation (a first
        # prefill that builds the CUDA kernels blocks the loop exactly
        # like a wedge — raise the floor, or use the warmup grace).
        self.stall_factor = float(stall_factor)
        self.stall_min_s = float(stall_min_s)
        # How long teardown waits for a (possibly wedged) loop thread to
        # join before abandoning it — a wedged join must not block the
        # restart thread for the length of the hang it is recovering from.
        # None = unbounded: with the watchdog DISABLED (stall_min_s <= 0,
        # the operator's opt-out for legitimately slow rounds) nothing
        # ever flags a loop as wedged, so teardown must never abandon a
        # healthy worker mid-round either.
        if stall_join_s is not None:
            self._stall_join_s: Optional[float] = float(stall_join_s)
        elif self.stall_min_s > 0:
            self._stall_join_s = max(1.0, self.stall_min_s)
        else:
            self._stall_join_s = None
        self._stalls = 0
        # Warmup-aware stall floor: for `warmup_grace_s` after
        # start()/each restart — and only while the inner has harvested
        # ZERO rounds — the watchdog's floor is raised to the grace
        # value, so first-boot work (a kernel build, which blocks the
        # loop thread exactly like a wedge) cannot be escalated as one. The first harvested round
        # proves the programs are warm and ends the grace early. 0
        # disables (the library default — tight-threshold tests and
        # pre-warmed deployments keep today's behavior); the app wires
        # LSOT_STALL_WARMUP_S (default 120 s) through AppConfig.
        self.warmup_grace_s = float(warmup_grace_s)
        self._grace_until = 0.0
        # Postmortem dump (the flight recorder's exit path): on
        # crash/stall escalation and on drain, the supervisor writes its
        # lifecycle events + the inner's last-N round records + the
        # still-pending requests' span trees as JSONL here — next to the
        # journal spill by default.
        if postmortem_path is not None:
            self.postmortem_path: Optional[str] = postmortem_path or None
        elif spill_path:
            self.postmortem_path = f"{spill_path}.postmortem.jsonl"
        else:
            self.postmortem_path = os.environ.get("LSOT_POSTMORTEM") or None
        #: Lifecycle black box (serve/flightrecorder.py): restart/stall/
        #: drain/dead markers, merged with the inner's per-round records
        #: in flight_snapshot() and the postmortem dump.
        self.flight = FlightRecorder(capacity=64, replica=name)
        # Expected-recovery instant (monotonic) while a restart backoff
        # sleep is pending: retry_after_hint() folds it in so shed/drain
        # hints during a stall stay honest (the inner's queue-depth ×
        # service-time estimate is frozen while the loop is down).
        self._restart_eta: Optional[float] = None
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._warned_unspillable = False
        # Single-flight drain: orchestrators commonly repeat SIGTERM, and
        # a second concurrent drain would cut the first's grace period
        # short and rewrite ('w' mode) the spill it just wrote.
        self._drain_lock = threading.Lock()
        self._drain_report: Optional[Dict[str, object]] = None
        # Recompiles a spilled constraint SPEC at recover() time
        # (spec -> compiled grammar). Set by SchedulerBackend — the owner
        # of the tokenizer+stop-ids the tables compile against; None means
        # constrained spill records cannot be recovered and count lost.
        self.constraint_resolver: Optional[Callable[[object], object]] = None
        # Per-dependency breaker view: the engine loop is a dependency too.
        # A crash records a failure, a successful restart a success — so
        # /metrics "resilience.breakers.<name>-restart" tells operators
        # EACH supervised loop's health the same way "ollama"/"sql" tell
        # dependency health (the registry is last-wins per name, hence the
        # per-instance name). Never consulted for shedding: the journal
        # admits during restarts on purpose (replay picks the work up).
        self._breaker = CircuitBreaker(
            f"{name}-restart",
            failure_threshold=max(1, max_restarts),
            reset_after_s=60.0,
        )

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "SupervisedScheduler":
        self._inner.start()
        self._grace_until = time.monotonic() + self.warmup_grace_s
        self.flight.event("start")
        if self.stall_min_s > 0 and self._watch_thread is None \
                and getattr(self._inner, "heartbeat", None) is not None:
            self._watch_stop.clear()
            self._watch_thread = threading.Thread(
                target=self._watch_loop, daemon=True,
                name="lsot-supervisor-watchdog",
            )
            self._watch_thread.start()
        return self

    def shutdown(self) -> None:
        """Stop the inner loop; fail anything still journaled (clean
        shutdown is not a crash: no restart, no replay). Idempotent."""
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join()
            self._watch_thread = None
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = [e for e in self._journal.values() if not e.done]
        try:
            # Bounded even on the clean path: a SIGTERM aimed at a wedged
            # loop must not hang the exit the drain deadline exists to
            # bound (the abandoned daemon zombie dies with the process).
            self._shutdown_inner(self._inner)
        except Exception:  # noqa: BLE001 — a broken inner must not wedge close
            _log.exception("inner scheduler shutdown failed")
        exc = RuntimeError("scheduler shut down mid-request")
        with self._lock:
            for e in pending:
                if not e.done:
                    self._fail_locked(e, exc)
        # This supervisor's loop is no longer a live dependency: keep the
        # /metrics per-dependency breaker view free of corpses.
        self._breaker.unregister()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    def warmup(self, prompt_len: Optional[int] = None) -> None:
        warm = getattr(self._inner, "warmup", None)
        if callable(warm):
            warm(prompt_len)

    # Admission-arithmetic surface, mirrored from the live inner scheduler
    # so SchedulerBackend wraps a supervisor exactly like a bare scheduler.
    @property
    def cfg(self):
        return self._inner.cfg

    @property
    def max_seq(self):
        return self._inner.max_seq

    @property
    def decode_chunk(self):
        return self._inner.decode_chunk

    @property
    def prompt_bucket(self):
        return self._inner.prompt_bucket

    @property
    def stop_ids(self):
        return self._inner.stop_ids

    @property
    def overshoot(self):
        return self._inner.overshoot

    @property
    def _spec_draft(self):
        return getattr(self._inner, "_spec_draft", 0)

    @property
    def _harvest_lag(self):
        return getattr(self._inner, "_harvest_lag", 1)

    @property
    def prefix_stats(self):
        return getattr(self._inner, "prefix_stats", {})

    @property
    def speculation_stats(self):
        """The current incarnation's speculative acceptance (None with
        speculation off)."""
        return getattr(self._inner, "speculation_stats", None)

    @property
    def prefix_telemetry(self):
        """Prefix-cache telemetry passthrough: the serving.prefix block
        survives supervision (None for a cache that is off)."""
        return self._inner.prefix_telemetry

    def prefix_registry(self, top_k=None):
        """The /debug/prefixcache payload survives supervision."""
        return self._inner.prefix_registry(top_k)

    def resident_digests(self, limit=None):
        return self._inner.resident_digests(limit)

    def prefix_affinity(self, digests):
        """Cache-aware routing feed passthrough (an inner SchedulerPool;
        [] for an inner without one)."""
        fn = getattr(self._inner, "prefix_affinity", None)
        return fn(digests) if callable(fn) else []

    @property
    def page_stats(self):
        """Paged-KV pool stats passthrough (None for contiguous inner
        schedulers) — the /metrics kv_pages gauges survive supervision."""
        return getattr(self._inner, "page_stats", None)

    @property
    def perf_stats(self):
        """Roofline-ledger passthrough (utils/perfmodel.py): the
        serving.perf view survives supervision."""
        return self._inner.perf_stats

    @property
    def handoff_stats(self):
        """Prefill→decode handoff passthrough: the serving.handoff view
        and the lsot_handoff_* families survive supervision (None for a
        mixed or duck-typed inner)."""
        return getattr(self._inner, "handoff_stats", None)

    @property
    def transport_stats(self):
        """Replica-transport passthrough: the serving.transport view and
        the lsot_transport_* families survive supervision (None for a
        fleet of local replicas)."""
        return getattr(self._inner, "transport_stats", None)

    @property
    def phase_role(self):
        return getattr(self._inner, "phase_role", "mixed")

    @property
    def model_id(self):
        """Model axis passthrough: a supervised scheduler reports its
        checkpoint id like a bare one, so a pool routes it under that
        model."""
        return getattr(self._inner, "model_id", "")

    def profile_rounds(self, rounds=None, out_dir=None):
        """On-demand capture passthrough (/debug/profile): the inner loop
        owns the device, so it owns the capture; the process-wide
        single-capture guard lives below this seam."""
        return self._inner.profile_rounds(rounds, out_dir)

    def profile_status(self):
        return self._inner.profile_status()

    @property
    def supports_model_routing(self):
        """Callers forward a model_id through supervision only when the
        inner routes on it (a pool)."""
        return bool(getattr(self._inner, "supports_model_routing", False))

    @property
    def supports_qos(self):
        return bool(getattr(self._inner, "supports_qos", False))

    def model_stats(self):
        """The inner pool's per-model aggregation (None elsewhere)."""
        fn = getattr(self._inner, "model_stats", None)
        return fn() if callable(fn) else None

    def routing_stats(self):
        """The inner pool's placement counters (None elsewhere)."""
        fn = getattr(self._inner, "routing_stats", None)
        return fn() if callable(fn) else None

    def qos_stats(self):
        """The inner's per-tenant WFQ counters with the supervisor's own
        per-tenant quarantine axis folded in."""
        fn = getattr(self._inner, "qos_stats", None)
        out = fn() if callable(fn) else None
        with self._lock:
            quarantined = dict(self._quarantined_by_tenant)
        if quarantined:
            out = dict(out) if out else {}
            out["quarantined"] = quarantined
        return out

    def retry_after_hint(self) -> float:
        """The inner scheduler's queue-depth × service-time estimate —
        except while the loop is down (stalled/crashed, mid-restart):
        then the inner's EWMA is stale and its queue frozen, so the hint
        is clamped to at least the restart backoff remaining (the
        watchdog's expected-recovery time). Clamped to [1, 60] s like the
        scheduler's own estimate."""
        with self._lock:
            restarting = self._state == "restarting"
            eta = self._restart_eta
        try:
            hint = getattr(self._inner, "retry_after_hint", None)
            base = hint() if callable(hint) else 1.0
        except Exception:  # noqa: BLE001 — a dead/churning inner mid-restart
            base = 1.0
        if restarting and eta is not None:
            base = max(base, eta - time.monotonic())
        return float(min(60.0, max(1.0, base)))

    # Fleet passthroughs (inner SchedulerPool): runtime per-replica ops
    # and the per-replica load/health views keep working through the
    # supervision layer — the journal on THIS side re-places whatever a
    # targeted restart or drain leaves behind (the wired callbacks).
    def restart_replica(self, replica, reason: str = "manual") -> bool:
        fn = getattr(self._inner, "restart_replica", None)
        return bool(fn(replica, reason=reason)) if callable(fn) else False

    def drain_replica(self, replica, deadline_s: Optional[float] = None,
                      remove: bool = False) -> Dict[str, object]:
        fn = getattr(self._inner, "drain_replica", None)
        if not callable(fn):
            raise ValueError("inner scheduler has no replica fleet")
        return fn(replica, deadline_s=deadline_s, remove=remove)

    def replica_loads(self) -> List[Dict[str, object]]:
        fn = getattr(self._inner, "replica_loads", None)
        return fn() if callable(fn) else []

    def replica_health(self) -> List[Dict[str, object]]:
        fn = getattr(self._inner, "replica_health", None)
        return fn() if callable(fn) else []

    # Elastic membership passthroughs: the autoscaler and the
    # app's fleet endpoints address the pool through the supervision
    # layer — joins/retires hit the LIVE inner (re-resolved per call, so
    # they keep working across full-restart swaps).
    def add_replica(self, scheduler, label: Optional[str] = None,
                    weight: float = 1.0, elastic: bool = True) -> str:
        fn = getattr(self._inner, "add_replica", None)
        if not callable(fn):
            raise ValueError("inner scheduler has no replica fleet")
        return fn(scheduler, label=label, weight=weight, elastic=elastic)

    def retire_replica(self, replica=None,
                       deadline_s: Optional[float] = None
                       ) -> Optional[Dict[str, object]]:
        fn = getattr(self._inner, "retire_replica", None)
        return (fn(replica, deadline_s=deadline_s)
                if callable(fn) else None)

    def fleet_stats(self) -> Optional[Dict[str, object]]:
        fn = getattr(self._inner, "fleet_stats", None)
        return fn() if callable(fn) else None

    # ---------------------------------------------------------------- client

    def submit(
        self,
        ids: Sequence[int],
        max_new_tokens: int = 256,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
        on_token: Optional[Callable[[int], None]] = None,
        constraint=None,
        deadline_s: Optional[float] = None,
        idempotency_key: Optional[str] = None,
        idempotent: bool = True,
        constraint_spec=None,
        trace=None,
        model_id: str = "",
        tenant: str = "",
        qos: str = "",
    ) -> "Future[List[int]]":
        """Journal + submit. The returned future survives loop crashes: it
        resolves from whichever scheduler incarnation finishes the work.
        `idempotency_key` dedupes retries (same key → same result);
        `idempotent=False` marks a consumer whose delivered tokens cannot
        be replayed (the entry fails typed instead of double-streaming).
        `constraint_spec` is the serializable twin of `constraint`
        (grammar name / schema dict): with it, a keyed constrained entry
        survives the drain spill — recover() recompiles the spec through
        `constraint_resolver` instead of failing the request typed."""
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        with self._lock:
            if idempotency_key is not None:
                # Idempotency lookups come BEFORE every lifecycle check:
                # serving an already-journaled result admits no new work,
                # so even a draining or DEAD supervisor honors the "retry
                # with the same key is safe" contract — a client whose
                # response was lost on the wire must not get a 503 for a
                # result sitting in memory.
                live = self._by_key.get(idempotency_key)
                if live is not None and not live.done:
                    # Same request already acknowledged: one result, one
                    # generation — the retry rides the original's future.
                    resilience.inc("sched_idempotent_hits")
                    return live.future
                hit = self._completed.get(idempotency_key)
                if hit is not None:
                    resilience.inc("sched_idempotent_hits")
                    self._completed.move_to_end(idempotency_key)
                    f: Future = Future()
                    f.set_result(list(hit))
                    return f
            if self._draining:
                # Checked before _closed: a drained-then-shut supervisor
                # still answers the RETRYABLE typed error (the replacement
                # instance takes the retry), not lifecycle misuse.
                raise Draining(
                    "server draining: not admitting new requests",
                    retry_after_s=self.retry_after_hint(),
                )
            if self._closed:
                raise RuntimeError("scheduler has shut down")
            if self._state == "dead":
                raise self._dead_error()
            if constraint is not None \
                    and not isinstance(constraint_spec, (str, dict)):
                # A raw pre-compiled CompiledMask with no serializable
                # spec cannot survive the drain spill (there is nothing
                # portable to write): it fails typed at spill time. Count
                # and warn NOW so operators see the exposure before a
                # drain makes it a lost request — the last recovery gap
                # ROADMAP's crash-recovery item documents.
                resilience.inc("unspillable_constraints")
                if not self._warned_unspillable:
                    self._warned_unspillable = True
                    _log.warning(
                        "constrained request submitted with a pre-compiled "
                        "constraint and no serializable spec: it cannot be "
                        "journal-spilled across a drain (pass the grammar "
                        "name/schema dict as constraint_spec). Counted at "
                        "/metrics resilience.unspillable_constraints; "
                        "warning once."
                    )
            entry = JournalEntry(
                rid=self._next_rid,
                ids=list(ids),
                max_new=max_new_tokens,
                sampling=sampling,
                seed=seed,
                idempotency_key=idempotency_key,
                constraint=constraint,
                constraint_spec=constraint_spec,
                deadline=(Deadline.after(deadline_s)
                          if deadline_s is not None else None),
                on_token=on_token,
                idempotent=idempotent,
                future=Future(),
                trace=trace,
                model_id=str(model_id or ""),
                tenant=str(tenant or ""),
                qos=str(qos or ""),
            )
            self._next_rid += 1
            entry.future._lsot_entry = entry  # cancel() handle
            self._journal[entry.rid] = entry
            if idempotency_key is not None:
                self._by_key[idempotency_key] = entry
            if self._state == "restarting":
                # Acknowledged while the loop is down: the replay pass
                # after the restart submits it in rid order.
                return entry.future
            try:
                self._submit_entry_locked(entry)
            except (ValueError, Overloaded):
                # Request-shape rejection or a typed shed: NOT acknowledged
                # — the caller got a real error, nothing to replay.
                self._forget_locked(entry)
                raise
            except Exception as exc:  # noqa: BLE001 — crash classification below
                if self._is_crash(exc):
                    # The loop died under us: the request IS acknowledged
                    # (journaled); restart + replay will serve it.
                    self._notice_crash_locked(self._wrap_crash(exc))
                    return entry.future
                self._forget_locked(entry)
                raise
            return entry.future

    def cancel(self, future: "Future[List[int]]") -> None:
        """Cooperative cancel, supervisor-aware: marks the journal entry so
        a replay resolves with what was already delivered, and forwards to
        the inner scheduler's cancel seam. Safe on foreign futures."""
        entry: Optional[JournalEntry] = getattr(future, "_lsot_entry", None)
        if entry is None:
            return
        entry.cancelled = True
        inner = entry.inner
        if inner is not None:
            req = getattr(inner, "_lsot_request", None)
            if req is not None:
                req.cancelled = True

    def generate(
        self,
        prompts: List[List[int]],
        max_new_tokens: int = 256,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
    ) -> List[List[int]]:
        """Synchronous batch helper (scheduler-compatible signature)."""
        futs = [
            self.submit(p, max_new_tokens=max_new_tokens, sampling=sampling,
                        seed=seed)
            for p in prompts
        ]
        return [f.result() for f in futs]

    # ---------------------------------------------------------------- health

    def health(self) -> Dict[str, object]:
        """The `/readyz` payload: lifecycle state + restart counters.
        A loop the watchdog caught wedged reports `restarting` here (the
        escalation rides the crash path), with `stalls` counting how many
        times liveness — not an exception — triggered the recovery."""
        with self._lock:
            out = {
                "state": self._state,
                "draining": self._draining,
                "restarts": self._restarts,
                "max_restarts": self.max_restarts,
                "replayed": self._replayed,
                "lost": self._lost,
                "quarantined": self._quarantined,
                "stalls": self._stalls,
                "journal_depth": sum(
                    1 for e in self._journal.values() if not e.done
                ),
                "last_crash": (str(self._crash_exc)
                               if self._crash_exc is not None else None),
            }
        # Fleet pools: per-replica lifecycle beside the pool-level state —
        # /readyz shows WHICH replica is restarting/dead, not just that
        # something somewhere is.
        rh = getattr(self._inner, "replica_health", None)
        if callable(rh):
            try:
                out["replicas"] = rh()
            except Exception:  # noqa: BLE001 — a churning pool mid-read
                pass
        # Elastic membership: the fleet size/joins/retires/
        # pump ledger rides the same probe.
        fs = getattr(self._inner, "fleet_stats", None)
        if callable(fs):
            try:
                fleet = fs()
            except Exception:  # noqa: BLE001 — a churning pool mid-read
                fleet = None
            if fleet:
                out["fleet"] = fleet
        return out

    @property
    def heartbeat(self):
        """The live inner loop's heartbeat (None for heartbeat-less
        duck-typed inners) — what the monitor thread reads."""
        return getattr(self._inner, "heartbeat", None)

    @property
    def watchdog_stats(self) -> Dict[str, object]:
        """/metrics liveness view: the inner's heartbeat + per-slot stall
        retirements, plus this supervisor's whole-loop stall detections
        and the threshold currently in force."""
        inner = getattr(self._inner, "watchdog_stats", None)
        out: Dict[str, object] = dict(inner) if inner is not None else {}
        hb = self.heartbeat
        out["stalls_detected"] = self._stalls
        out["stall_threshold_s"] = (
            round(stall_threshold(hb, self.stall_factor,
                                  self._effective_floor(hb)), 3)
            if hb is not None and self.stall_min_s > 0 else None
        )
        # Operators reading a raised threshold need to know WHY: the
        # warmup grace window is active until the first harvested round.
        out["warmup_grace_active"] = self._warmup_grace_active()
        return out

    def flight_stats(self) -> Dict[str, object]:
        """Ring occupancy for /metrics: the INNER scheduler's per-round
        ring — the one sized by LSOT_FLIGHT_ROUNDS, whose fill/overwrite
        counters an operator actually monitors — beside this supervisor's
        small lifecycle ring. Without the split, `getattr(sched, 'flight')`
        on a supervised backend resolves to the sparse 64-slot lifecycle
        recorder and /metrics reports the wrong ring."""
        out: Dict[str, object] = {"supervisor": self.flight.stats()}
        inner = self._inner
        fs = getattr(inner, "flight_stats", None)
        if callable(fs):
            out["scheduler"] = fs()
        else:
            fl = getattr(inner, "flight", None)
            if fl is not None:
                out["scheduler"] = fl.stats()
        return out

    # ----------------------------------------------------------------- drain

    def drain(self, deadline_s: Optional[float] = None) -> Dict[str, object]:
        """SIGTERM path: stop admitting (submits raise `Draining`), let
        in-flight work finish up to the drain deadline, then journal what
        is left to the spill file and shut down. `deadline_s=None` waits
        for everything; `deadline_s <= 0` means journal-and-exit NOW (no
        waiting — an unbounded wait on a wedged loop is exactly the hang
        a drain deadline exists to prevent). Returns the accounting the
        shutdown log wants. Single-flight: a repeated SIGTERM joins the
        in-progress drain and gets its report instead of clobbering the
        freshly written spill."""
        with self._drain_lock:
            if self._drain_report is not None:
                return self._drain_report
            self.flight.event("drain", deadline_s=deadline_s)
            # SIGTERM is a black-box moment too: dump what the scheduler
            # was doing (and which requests were mid-flight) before the
            # spill/shutdown churns the state.
            self._postmortem_dump("drain")
            with self._lock:
                self._draining = True
                waiting = [e for e in self._journal.values() if not e.done]
            if deadline_s is not None and deadline_s <= 0:
                waiting = []  # deadline already burned: straight to the spill
            deadline = (Deadline.after(deadline_s)
                        if deadline_s is not None and deadline_s > 0 else None)
            finished = 0
            for e in waiting:
                timeout = None
                if deadline is not None:
                    timeout = deadline.remaining()
                    if timeout <= 0:
                        break
                try:
                    e.future.result(timeout=timeout)
                    finished += 1
                except FutureTimeoutError:
                    break
                except Exception:  # noqa: BLE001 — typed terminal states count as drained
                    finished += 1
            spilled = self._spill_pending()
            self.shutdown()
            self._drain_report = {
                "drained": finished,
                "spilled": spilled,
                "spill_path": self.spill_path if spilled else None,
            }
            return self._drain_report

    def _spill_pending(self) -> int:
        """Journal-and-exit: persist unfinished entries (JSONL) so the next
        process can `recover()` them, then fail their futures typed
        `Draining` — the client is told to retry, and a retry with the
        same idempotency key finds the recovered result. Only KEYED
        entries spill: the idempotency cache is the sole cross-process
        handle to a recovered result, so regenerating keyless work would
        burn startup device time on futures nobody can claim. Constrained
        entries spill their constraint SPEC (grammar name / schema dict —
        the compiled device tables themselves are not serializable);
        recover() recompiles the spec through `constraint_resolver`.
        A constrained entry WITHOUT a serializable spec (a caller handed
        the scheduler a pre-compiled CompiledMask directly) still fails
        typed without a record — there is nothing portable to write.

        The COMPLETED idempotency cache spills too, as literal `result`
        records: a client whose response was lost on the wire retries its
        key against the NEXT process, and regenerating there would be
        wasteful at best, wrong at worst (the result already exists).
        Every record carries the spill wall-clock so recovery charges
        downtime against remaining deadlines."""
        now = time.time()
        with self._lock:
            pending = [e for e in self._journal.values() if not e.done]
            records = []
            for e in pending:
                # A constrained entry is spillable only through its
                # serializable SPEC (str/dict); a raw CompiledMask has no
                # portable representation and the entry fails typed below.
                spec_ok = (e.constraint is None
                           or isinstance(e.constraint_spec, (str, dict)))
                if spec_ok and not e.cancelled \
                        and e.idempotency_key is not None:
                    rem = (e.deadline.remaining()
                           if e.deadline is not None else None)
                    rec = {
                        "rid": e.rid,
                        "ids": e.ids,
                        "max_new": e.max_new,
                        "temperature": e.sampling.temperature,
                        "top_p": e.sampling.top_p,
                        "top_k": e.sampling.top_k,
                        "seed": e.seed,
                        "idempotency_key": e.idempotency_key,
                        "deadline_remaining_s": rem,
                        "spilled_at_unix": now,
                        # Forensic only ("how far did it get before the
                        # drain"): recover() regenerates from scratch —
                        # deterministic decode makes the result identical,
                        # so there is no cross-process suppression to do.
                        "delivered": len(e.generated),
                    }
                    if e.constraint is not None:
                        rec["constrain"] = e.constraint_spec
                    if e.model_id:
                        rec["model_id"] = e.model_id
                    if e.tenant:
                        rec["tenant"] = e.tenant
                    if e.qos:
                        rec["qos"] = e.qos
                    records.append(rec)
            for key, result in self._completed.items():
                records.append({
                    "idempotency_key": key,
                    "result": list(result),
                    "spilled_at_unix": now,
                })
        spilled = 0
        spilled_keys = set()
        if records and self.spill_path:
            with open(self.spill_path, "w", encoding="utf-8") as f:
                for rec in records:
                    f.write(json.dumps(rec) + "\n")
            spilled = len(records)
            spilled_keys = {r["idempotency_key"] for r in records}
        hint = self.retry_after_hint()
        # Tell each client the truth: only entries actually WRITTEN to
        # the spill may promise their key will find a journaled result;
        # keyless/constrained/spill-disabled entries just get the drain.
        journaled_exc = Draining(
            "server draining: request journaled for restart; retry with "
            "the same idempotency key",
            retry_after_s=hint,
        )
        plain_exc = Draining(
            "server draining: request not completed; retry later",
            retry_after_s=hint,
        )
        with self._lock:
            for e in pending:
                if not e.done:
                    self._fail_locked(
                        e, journaled_exc if e.idempotency_key in spilled_keys
                        else plain_exc,
                    )
        return spilled

    def recover(self, path: Optional[str] = None) -> int:
        """Restore a spill file from a previous process: completed
        `result` records load straight into the idempotency cache (no
        regeneration — retried keys find them immediately); pending
        records resubmit server-side, their results landing in the same
        cache. Deadlines are charged for the DOWNTIME between spill and
        recovery (the spill wall-clock stamp); entries that no longer fit
        their budget count as lost. Returns the number of records
        restored; removes the file.

        Never raises: recovery runs during server startup, and the
        crash-recovery feature must not itself become a startup crash — a
        truncated line (SIGKILL mid-spill), a record that no longer fits
        a reconfigured scheduler (ValueError), or a shed (Overloaded) is
        logged and counted lost; every parseable record still gets its
        chance."""
        path = path or self.spill_path
        if not path or not os.path.exists(path):
            return 0
        recovered = 0
        try:
            with open(path, encoding="utf-8") as f:
                lines = [line for line in f if line.strip()]
            os.remove(path)
        except OSError:
            _log.exception("journal spill at %s unreadable; skipping", path)
            return 0
        now = time.time()
        for line in lines:
            try:
                rec = json.loads(line)
                if "result" in rec:
                    # A completed result from the previous process: serve
                    # future retries of this key from memory.
                    with self._lock:
                        self._completed[rec["idempotency_key"]] = tuple(
                            rec["result"]
                        )
                        while len(self._completed) > self._completed_cap:
                            self._completed.popitem(last=False)
                    recovered += 1
                    continue
                rem = rec.get("deadline_remaining_s")
                if rem is not None:
                    # The clock kept running while the process was down.
                    rem -= max(0.0, now - rec.get("spilled_at_unix", now))
                    if rem <= 0:
                        with self._lock:
                            self._lost += 1
                        resilience.inc("sched_lost")
                        continue
                ckw = {}
                spec = rec.get("constrain")
                if spec is not None:
                    # Recompile the spilled SPEC into device tables
                    # against the serving tokenizer (the compile cache in
                    # constrain/ dedupes across records). No resolver →
                    # the ValueError lands in the per-record guard below
                    # and the record counts lost — logged, not a startup
                    # crash.
                    if self.constraint_resolver is None:
                        raise ValueError(
                            "constrained spill record needs a "
                            "constraint_resolver (SchedulerBackend sets "
                            "one before recovery)"
                        )
                    ckw = {"constraint": self.constraint_resolver(spec),
                           "constraint_spec": spec}
                self.submit(
                    rec["ids"], max_new_tokens=rec["max_new"],
                    sampling=SamplingParams(
                        temperature=rec.get("temperature", 0.0),
                        top_p=rec.get("top_p", 1.0),
                        top_k=rec.get("top_k", 0),
                    ),
                    seed=rec.get("seed", 0),
                    deadline_s=rem,
                    idempotency_key=rec.get("idempotency_key"),
                    model_id=str(rec.get("model_id", "") or ""),
                    tenant=str(rec.get("tenant", "") or ""),
                    qos=str(rec.get("qos", "") or ""),
                    **ckw,
                )
            except Exception:  # noqa: BLE001 — per-record: salvage the rest
                _log.exception("unrecoverable journal spill record: %.120s",
                               line)
                with self._lock:
                    self._lost += 1
                resilience.inc("sched_lost")
                continue
            recovered += 1
        return recovered

    # -------------------------------------------------------------- internal

    @staticmethod
    def _is_crash(exc: BaseException) -> bool:
        # Crashes are classified by TYPE only: the scheduler's loop death
        # and the pool's everything-dead summary both raise
        # SchedulerCrashed (a message-string contract would silently
        # break recovery on rewording).
        return isinstance(exc, SchedulerCrashed)

    @staticmethod
    def _wrap_crash(exc: BaseException) -> SchedulerCrashed:
        if isinstance(exc, SchedulerCrashed):
            return exc
        return SchedulerCrashed.from_exception(exc)

    def _dead_error(self) -> SchedulerCrashed:
        msg = (f"scheduler dead: restart budget exhausted "
               f"({self._restarts}/{self.max_restarts} restarts)")
        err = SchedulerCrashed(msg)
        if self._crash_exc is not None:
            err.__cause__ = self._crash_exc
            err.crash_traceback = getattr(
                self._crash_exc, "crash_traceback", "")
        return err

    def _make_on_token(self, entry: JournalEntry):
        """Per-attempt token tap: counts/records delivered tokens for
        replay, suppressing the prefix the client already received (the
        replayed stream is byte-identical — per-request seeded RNG).
        Returns `(tap, cell)`; the caller binds `cell["fut"]` to the
        attempt's inner future right after submit so the tap can tell
        whether it still speaks for `entry` — an ABANDONED zombie
        incarnation (wedged loop the bounded join gave up on) may
        unwedge and harvest a round long after the replay installed a
        fresh attempt, and its late tokens must reach neither
        `entry.generated` nor the client a second time."""
        suppress = len(entry.generated)
        seen = 0
        cell: Dict[str, object] = {"fut": None}

        def tap(tok: int) -> None:
            nonlocal seen
            f = cell["fut"]
            if f is not None and entry.inner is not f:
                return  # stale attempt from a torn-down/abandoned incarnation
            seen += 1
            if seen <= suppress:
                return
            entry.generated.append(tok)
            if entry.on_token is not None:
                try:
                    entry.on_token(tok)
                except Exception:  # noqa: BLE001 — consumer bugs must not break accounting
                    entry.on_token = None

        return tap, cell

    def _submit_entry_locked(self, entry: JournalEntry) -> None:
        if entry.deadline is not None:
            rem = entry.deadline.remaining()
            if rem <= 0:
                resilience.inc("deadline_expired")
                raise DeadlineExceeded(
                    "request deadline exceeded before admission"
                )
            deadline_s = rem
        else:
            deadline_s = None
        # Invalidate any prior attempt BEFORE the new tap snapshots its
        # suppression prefix: a zombie tap firing from here on sees
        # `entry.inner is not` its own future and drops the token, so the
        # prefix length cannot grow under the snapshot.
        entry.inner = None
        tap, cell = self._make_on_token(entry)
        kwargs = {}
        if entry.trace is not None:
            # Forwarded only when sampled: duck-typed inners without the
            # tracing seam (the chaos harness's toy replica) keep working.
            kwargs["trace"] = entry.trace
        if entry.model_id and getattr(self._inner,
                                      "supports_model_routing", False):
            # Model axis: replays ride through here too, so a
            # journaled model-named request re-places onto the same
            # checkpoint's replicas after a crash — duck-typed inners
            # without the axis never see the kwarg.
            kwargs["model_id"] = entry.model_id
        if (entry.tenant or entry.qos) and getattr(self._inner,
                                                   "supports_qos", False):
            # Tenant axis: replays and spill recovery keep
            # their attribution so WFQ/preemption charge the right
            # tenant after a crash; qos-blind inners never see it.
            kwargs["tenant"] = entry.tenant
            kwargs["qos"] = entry.qos
        fut = self._inner.submit(
            entry.ids, max_new_tokens=entry.max_new, sampling=entry.sampling,
            seed=entry.seed, on_token=tap,
            constraint=entry.constraint, deadline_s=deadline_s, **kwargs,
        )
        entry.inner = fut
        cell["fut"] = fut
        if entry.cancelled:  # cancelled while the loop was down
            req = getattr(fut, "_lsot_request", None)
            if req is not None:
                req.cancelled = True
        fut.add_done_callback(
            lambda f, e=entry: self._on_inner_done(e, f)
        )

    def _on_inner_done(self, entry: JournalEntry, fut: Future) -> None:
        with self._lock:
            if entry.done or entry.inner is not fut:
                return  # stale attempt from a torn-down incarnation
            exc = fut.exception()
            if exc is None:
                self._finish_locked(entry, fut.result())
                if self._state == "degraded":
                    # A clean completion proves the restarted loop serves.
                    self._state = "ready"
                return
            if self._is_crash(exc):
                # Fleet pools: a SINGLE replica's crash gets a targeted
                # restart and this entry re-places onto a sibling — the
                # whole-pool teardown (which would restart every healthy
                # replica and replay their work too) is reserved for the
                # fleet actually being gone.
                if self._try_fleet_replay_locked(entry, fut, exc):
                    return
                # The entry stays journaled: restart + replay owns it now.
                self._notice_crash_locked(self._wrap_crash(exc))
                return
            if not self._closed and isinstance(exc, RuntimeError) \
                    and str(exc) == "scheduler shut down mid-request":
                # Teardown CROSSFIRE, not a per-request failure: the
                # restart thread shut the old incarnation down and a
                # HEALTHY replica's in-flight work (pool case) was closed
                # with it. The request is acknowledged — leave it
                # journaled; the replay pass resubmits it on the rebuilt
                # scheduler. (Outside supervisor-owned teardown this
                # message can only mean lifecycle misuse — the supervisor
                # owns start/shutdown of every inner it builds.)
                return
            self._fail_locked(entry, exc)

    def _finish_locked(self, entry: JournalEntry, result: List[int]) -> None:
        entry.done = True
        self._journal.pop(entry.rid, None)
        # Surface the serving attempt's measured queue wait / replica on
        # the CLIENT-facing future (the inner future is an implementation
        # detail that dies with the loop).
        for attr in ("_lsot_queue_wait", "_lsot_replica"):
            v = getattr(entry.inner, attr, None)
            if v is not None:
                setattr(entry.future, attr, v)
        if entry.idempotency_key is not None:
            if self._by_key.get(entry.idempotency_key) is entry:
                del self._by_key[entry.idempotency_key]
            if not entry.cancelled:
                # A cancelled entry resolves with its PARTIAL tokens —
                # never cache that as the key's authoritative result; a
                # retry with the key deserves a full generation.
                self._completed[entry.idempotency_key] = tuple(result)
                while len(self._completed) > self._completed_cap:
                    self._completed.popitem(last=False)
        entry.future.set_result(result)

    def _fail_locked(self, entry: JournalEntry, exc: BaseException) -> None:
        entry.done = True
        self._journal.pop(entry.rid, None)
        if entry.idempotency_key is not None and \
                self._by_key.get(entry.idempotency_key) is entry:
            del self._by_key[entry.idempotency_key]
        entry.future.set_exception(exc)

    def _forget_locked(self, entry: JournalEntry) -> None:
        """Un-acknowledge: the submit itself answered the caller (shed or
        request-shape error), so nothing may linger for replay."""
        entry.done = True
        self._journal.pop(entry.rid, None)
        if entry.idempotency_key is not None and \
                self._by_key.get(entry.idempotency_key) is entry:
            del self._by_key[entry.idempotency_key]

    def _notice_crash_locked(self, exc: SchedulerCrashed) -> None:
        self._crash_exc = exc
        if self._state in ("restarting", "dead") or self._closed:
            return  # single-flight: one restart thread at a time
        self._breaker.record_failure()
        self._state = "restarting"
        self.flight.event(
            "stall" if isinstance(exc, SchedulerStalled) else "crash",
            error=str(exc)[:200],
        )
        _log.warning("scheduler loop crashed; supervisor restarting: %s", exc)
        threading.Thread(
            target=self._restart_and_replay, daemon=True,
            name="lsot-supervisor-restart",
        ).start()

    def _restart_and_replay(self) -> None:
        """The restart thread (one thread per crash episode): tear down,
        rebuild with backoff under the restart budget, replay the journal.
        A crash DURING replay loops back to another rebuild; budget
        exhaustion fails everything typed and marks the supervisor dead."""
        # The black-box moment: dump the postmortem BEFORE teardown churns
        # anything — supervisor lifecycle + the dead loop's last-N rounds
        # + the hung requests' span trees, next to the journal spill.
        self._postmortem_dump(
            "stall" if isinstance(self._crash_exc, SchedulerStalled)
            else "crash"
        )
        while True:
            old = self._inner
            try:
                # Joins the dead worker (all its done-callbacks have run
                # past this point) — BOUNDED: a worker the watchdog caught
                # WEDGED never joins, so schedulers that support a join
                # timeout get one and the zombie daemon thread is
                # abandoned (it exits when it unwedges; its late
                # callbacks are superseded by the replay's fresh inner
                # futures — the `entry.inner is not fut` staleness guard).
                self._shutdown_inner(old)
            except Exception:
                _log.exception("dead scheduler teardown failed; continuing")
            with self._lock:
                if self._closed:
                    return
                if self._restarts >= self.max_restarts:
                    self._die_locked()
                    return
                attempt = self._restarts
                self._restarts += 1
            resilience.inc("sched_restarts")
            delay = self._restart_policy.delay_s(attempt, self._rng)
            with self._lock:
                # Published for retry_after_hint: shed/drain hints during
                # the outage promise at least the backoff remaining.
                self._restart_eta = time.monotonic() + delay
            self._sleep(delay)
            try:
                inner = self._factory()
                # Warm BEFORE serving when the inner can: a cold first
                # round blocks the fresh loop's thread exactly like the
                # wedge this restart may be recovering from. Warming
                # happens here, while the state is `restarting` and the
                # monitor is quiet.
                warm = getattr(inner, "warmup", None)
                if callable(warm):
                    warm()
                inner.start()
            except Exception:  # noqa: BLE001 — rebuild failure burns one restart credit
                _log.exception("scheduler rebuild failed (restart %d/%d)",
                               attempt + 1, self.max_restarts)
                self._breaker.record_failure()
                continue
            with self._lock:
                if self._closed:
                    inner.shutdown()
                    return
                self._inner = inner
                self._wire_fleet(inner)
                try:
                    lost = self._replay_locked()
                except _CrashedAgain:
                    continue  # the fresh loop died mid-replay: go again
                self._state = "degraded" if lost else "ready"
                self._restart_eta = None
                # The rebuilt loop recompiled nothing (warmup() above ran
                # while the monitor was quiet), but re-open the grace
                # window anyway: a pool rebuild or a changed shape can
                # still compile lazily on the first real admission.
                self._grace_until = time.monotonic() + self.warmup_grace_s
                self._breaker.record_success()
                self.flight.event("restart", attempt=self._restarts,
                                  state=self._state, lost=lost)
                _log.info(
                    "scheduler restarted (restart %d/%d): state=%s lost=%d",
                    self._restarts, self.max_restarts, self._state, lost,
                )
                return

    def _replay_one_locked(self, e: JournalEntry,
                           defer_on_overload: bool = False) -> str:
        """Replay ONE journal entry onto the current inner: the shared
        core of the full-restart replay pass and the fleet pools'
        per-replica re-placement. Returns `"replayed"`, `"lost"` (failed
        typed), `"quarantined"` (poison entry retired typed after too
        many crashed incarnations), `"skipped"` (done/cancelled), or
        `"deferred"` (kept
        journaled for a later pass — only with `defer_on_overload`, the
        fleet case where a shed now would drop acknowledged work that a
        finishing replica rebuild is about to have room for). Raises
        `_CrashedAgain` when the inner dies under the resubmit."""
        if e.done:
            return "skipped"
        if e.cancelled:
            # The consumer already gave up: resolve with what it got
            # (the bare scheduler's cancel contract), don't re-decode.
            self._finish_locked(e, list(e.generated))
            return "skipped"
        if e.deadline is not None and e.deadline.expired():
            resilience.inc("deadline_expired")
            resilience.inc("sched_lost")
            self._lost += 1
            self._fail_locked(e, DeadlineExceeded(
                f"request deadline expired during scheduler restart "
                f"with {len(e.generated)} of {e.max_new} tokens "
                f"delivered"
            ))
            return "lost"
        if not e.idempotent and e.generated:
            # Tokens already reached a consumer that declared itself
            # replay-unsafe: failing typed beats double-applying.
            resilience.inc("sched_lost")
            self._lost += 1
            self._fail_locked(e, self._wrap_crash(
                self._crash_exc
                or SchedulerCrashed("scheduler loop crashed")
            ))
            return "lost"
        # Poison-request quarantine: every call here means the entry's
        # previous incarnation ended in a crash/stall/teardown — an entry
        # that keeps riding down incarnations is the prime suspect for
        # CAUSING them (a deterministically-crashing input replays into a
        # crash every time, burning one restart credit per lap). Past the
        # budget, retire it typed instead of replaying it again; the
        # remaining journal replays normally and the fleet keeps its
        # restart credits for organic failures.
        e.crash_replays += 1
        if self.max_entry_replays and \
                e.crash_replays > self.max_entry_replays:
            self._quarantined += 1
            bounded_bump(self._quarantined_by_tenant, e.tenant or DEFAULT_TENANT)
            resilience.inc("quarantined")
            self.flight.event("quarantine", rid=e.rid,
                              replays=e.crash_replays - 1)
            _log.warning(
                "journal entry rid=%d quarantined after %d crashed "
                "incarnations (max_entry_replays=%d)",
                e.rid, e.crash_replays - 1, self.max_entry_replays,
            )
            self._fail_locked(e, Quarantined(
                f"request quarantined: {e.crash_replays - 1} scheduler "
                f"incarnations crashed while it was in flight "
                f"(LSOT_MAX_ENTRY_REPLAYS={self.max_entry_replays}); "
                f"not replaying it again"
            ))
            return "quarantined"
        try:
            self._submit_entry_locked(e)
        except DeadlineExceeded as exc:
            resilience.inc("sched_lost")
            self._lost += 1
            self._fail_locked(e, exc)
            return "lost"
        except Overloaded as exc:
            if defer_on_overload:
                # Fleet re-placement with nowhere to place right now
                # (e.g. a pool-of-one mid-rebuild): keep the entry
                # journaled — the pool's on_replica_restart callback
                # replays it once the rebuild lands. The entry never
                # reached an incarnation, so the quarantine tally above
                # must not count this attempt (sustained overload would
                # otherwise quarantine a healthy acknowledged request).
                e.crash_replays -= 1
                return "deferred"
            # A fresh loop's queue should hold the journal; a cap
            # smaller than the backlog is a deployment error — fail
            # typed rather than spin the restart thread.
            resilience.inc("sched_lost")
            self._lost += 1
            self._fail_locked(e, exc)
            return "lost"
        except Exception as exc:  # noqa: BLE001 — crash classification
            if self._is_crash(exc):
                self._crash_exc = self._wrap_crash(exc)
                self._breaker.record_failure()
                raise _CrashedAgain() from exc
            resilience.inc("sched_lost")
            self._lost += 1
            self._fail_locked(e, exc)
            return "lost"
        if not e.done and e.inner is not None and e.inner.done():
            # The fresh loop killed this submit before its callback
            # was even attached: the callback ran INLINE on this
            # thread (RLock), where _notice_crash_locked's
            # single-flight guard no-ops because WE are the restart
            # thread. Detect it here — otherwise the entry would stay
            # journaled forever with a dead inner future and its
            # client would hang.
            exc2 = e.inner.exception()
            if exc2 is not None and self._is_crash(exc2):
                self._crash_exc = self._wrap_crash(exc2)
                self._breaker.record_failure()
                raise _CrashedAgain()
        self._replayed += 1
        resilience.inc("sched_replayed")
        return "replayed"

    def _replay_locked(self) -> int:
        """Resubmit journaled work in rid order. Returns how many
        acknowledged requests were LOST (failed typed instead of
        replayed): expired deadlines, and in-flight non-idempotent
        streams. Raises `_CrashedAgain` if the fresh loop dies under the
        replay itself."""
        lost = 0
        for rid in sorted(self._journal):
            if self._replay_one_locked(self._journal[rid]) == "lost":
                lost += 1
        return lost

    # ----------------------------------------------------- fleet (pools)

    def _fleet_inner(self):
        """The inner when it is a fleet pool (SchedulerPool with a
        replica factory): targeted restart + per-replica replay replace
        the whole-pool teardown for single-replica failures."""
        inner = self._inner
        return inner if getattr(inner, "supports_replica_restart",
                                False) else None

    def _wire_fleet(self, inner) -> None:
        """Point a fleet pool's replica-lifecycle callbacks at this
        journal: after a targeted restart/drain completes, re-place
        exactly that replica's outstanding requests."""
        if getattr(inner, "supports_replica_restart", False):
            inner.on_replica_restart = self._on_replica_restarted
            inner.on_replica_drained = self._replay_replica
            # Pushed constrained handoffs: the pool resolves
            # wire constraint SPECs through the supervisor's resolver
            # (installed by SchedulerBackend, the tokenizer owner).
            # Bound late so a resolver set AFTER start() still reaches
            # every inner rebuild.
            if hasattr(inner, "constraint_resolver"):
                inner.constraint_resolver = self._resolve_fleet_constraint

    def _resolve_fleet_constraint(self, spec):
        """Late-bound spec→tables resolver for the inner pool (pushed
        handoffs re-materialized from the wire)."""
        fn = self.constraint_resolver
        if fn is None:
            raise ValueError(
                "constrained handoff spec needs a constraint_resolver "
                "(SchedulerBackend installs one)"
            )
        return fn(spec)

    def _on_replica_restarted(self, label: str) -> None:
        """A targeted replica rebuild just landed: re-open the warmup
        grace window BEFORE replaying — the fresh replica's first rounds
        block its loop exactly like the wedge that triggered the rebuild,
        and without the grace the watchdog would re-flag the rebuild and
        burn the replica's budget — the same cascade the full-restart
        path already guards against."""
        with self._lock:
            self._grace_until = time.monotonic() + self.warmup_grace_s
        self._replay_replica(label)

    @staticmethod
    def _is_teardown_runtime(exc: Optional[BaseException]) -> bool:
        return (isinstance(exc, RuntimeError)
                and str(exc) == "scheduler shut down mid-request")

    def _replay_replica(self, label: str,
                        defer_on_overload: bool = False) -> int:
        """Re-place the journaled requests still ATTRIBUTED to replica
        `label` — inner futures that will never resolve (a wedged corpse
        abandoned by a targeted restart), teardown crossfire
        (RuntimeError from the replica's clean close), or a crash the
        inline fleet path deferred — onto the current fleet in rid
        order. Entries already re-placed carry a different (or live)
        inner and are skipped, so the pass is idempotent. Returns how
        many entries were resubmitted."""
        replayed = 0
        with self._lock:
            if self._closed or self._state == "dead":
                return 0
            for rid in sorted(self._journal):
                e = self._journal[rid]
                if e.done:
                    continue
                if e.inner is None:
                    # A DEFERRED fleet re-placement (the prior attempt
                    # was invalidated and nothing could take the work
                    # mid-rebuild): claim it regardless of label — it
                    # has no attribution left, and this callback fires
                    # exactly when capacity returned.
                    pass
                elif getattr(e.inner, "_lsot_replica", None) != label:
                    continue
                elif e.inner.done():
                    exc = e.inner.exception()
                    if not (self._is_teardown_runtime(exc)
                            or self._is_crash(exc)):
                        continue  # resolved for real: nothing to recover
                try:
                    if self._replay_one_locked(
                            e, defer_on_overload=defer_on_overload) \
                            == "replayed":
                        replayed += 1
                except _CrashedAgain:
                    # The whole fleet is gone under the re-placement:
                    # the standard full-pool crash path owns recovery.
                    self._notice_crash_locked(self._wrap_crash(
                        self._crash_exc
                        or SchedulerCrashed("fleet replay crashed")
                    ))
                    return replayed
        if replayed:
            self.flight.event("replica_replay", replica=label,
                              replayed=replayed)
        return replayed

    def _try_fleet_replay_locked(self, entry: JournalEntry, fut: Future,
                                 exc: BaseException) -> bool:
        """A journaled request's inner future failed with a crash while
        the inner is a fleet pool: notify the pool (targeted restart of
        the crashed replica) and re-place THIS entry on a sibling
        immediately, instead of escalating to the whole-pool teardown.
        Returns True when the entry was handled (re-placed, deferred for
        the post-rebuild pass, or terminally failed) — False falls back
        to the full crash path."""
        inner = self._fleet_inner()
        if (inner is None or self._closed
                or self._state not in ("ready", "degraded")):
            return False
        label = getattr(fut, "_lsot_replica", None)
        if label:
            try:
                inner.notice_replica_crash(label, exc)
            except Exception:  # noqa: BLE001 — restart kick is best-effort
                _log.exception("notice_replica_crash(%s) failed", label)
        entry.replica_replays += 1
        cap = len(getattr(inner, "schedulers", ())) + 1
        if entry.replica_replays > max(2, cap):
            # Ping-ponging across a fleet of dying replicas: stop playing
            # whack-a-mole and let the full-pool restart own it.
            return False
        try:
            self._replay_one_locked(entry, defer_on_overload=True)
        except _CrashedAgain:
            return False
        return True

    def _shutdown_inner(self, sched) -> None:
        """Shut an inner scheduler down with a bounded join when it
        supports one (ContinuousBatchingScheduler/SchedulerPool do);
        duck-typed inners without a timeout parameter get the plain
        call. The bound is what keeps teardown of a WEDGED loop from
        hanging the restart thread for the length of the hang it is
        recovering from; with the watchdog disabled (`_stall_join_s` is
        None) the join is unbounded — nothing can have flagged the loop
        as wedged, so a healthy slow round must not be abandoned."""
        try:
            takes_timeout = "timeout" in inspect.signature(
                sched.shutdown
            ).parameters
        except (TypeError, ValueError):  # builtins/uninspectable callables
            takes_timeout = False
        if takes_timeout and self._stall_join_s is not None:
            sched.shutdown(timeout=self._stall_join_s)
        else:
            sched.shutdown()

    def _effective_floor(self, hb) -> float:
        """The watchdog floor, warmup-aware: during the post-(re)start
        grace window — and only while the loop has harvested ZERO rounds
        (the first harvest proves the loop is warm) — the floor is
        raised to `warmup_grace_s`, so first-boot work that
        blocks the loop thread exactly like a wedge cannot be escalated
        as one. Outside the window (or once disabled) it is stall_min_s,
        unchanged."""
        if self.warmup_grace_s <= 0:
            return self.stall_min_s
        if self._hb_cold(hb) and time.monotonic() < self._grace_until:
            return max(self.stall_min_s, self.warmup_grace_s)
        return self.stall_min_s

    @staticmethod
    def _hb_cold(hb) -> bool:
        """Still in first-boot compile territory? Prefer the heartbeat's
        `cold` property (CombinedHeartbeat: ANY replica at zero rounds —
        the pool-summed `rounds` would let one warmed replica end the
        grace while a sibling's cold compile still reads as a wedge);
        fall back to rounds==0 for single heartbeats."""
        cold = getattr(hb, "cold", None)
        if cold is not None:
            return bool(cold)
        return getattr(hb, "rounds", 1) == 0

    def _warmup_grace_active(self) -> bool:
        hb = self.heartbeat
        return (self.warmup_grace_s > 0 and hb is not None
                and self._hb_cold(hb)
                and time.monotonic() < self._grace_until)

    def flight_snapshot(self, last: Optional[int] = None) -> List[Dict]:
        """Merged black-box view: the live inner's per-round records
        (pool-merged when the inner is a SchedulerPool) + this
        supervisor's lifecycle events, in time order — the
        /debug/flightrecorder payload for supervised backends."""
        return merge_snapshots([self.flight, self._inner], last)

    def _postmortem_dump(self, reason: str) -> Optional[str]:
        """Write the black box to disk: supervisor lifecycle events, the
        inner's last-N round records, and the span trees of every
        still-pending (hung) request — one JSONL, next to the journal
        spill. Returns the path (None when no postmortem path is
        configured — the last rounds still go to the restart log either
        way). Never raises: the postmortem writer must not turn a crash
        into a second crash."""
        try:
            rounds = self.flight_snapshot()
            with self._lock:
                pending = [e for e in self._journal.values() if not e.done]
            traces = []
            for e in pending:
                rec: Dict[str, object] = {
                    "rid": e.rid, "delivered": len(e.generated),
                    "max_new": e.max_new,
                    "idempotency_key": e.idempotency_key,
                }
                if e.trace is not None:
                    try:
                        rec["trace"] = e.trace.to_dict()
                    except Exception:  # noqa: BLE001 — a broken trace stays out
                        pass
                traces.append(rec)
            # The restart log gets the tail even with no dump file: the
            # "what was it doing" question must be answerable from logs
            # alone on a diskless deployment.
            tail = [r for r in rounds if "round" in r][-5:]
            _log.warning(
                "%s postmortem (%s): %d pending request(s), last rounds: %s",
                self.name, reason, len(pending),
                json.dumps(tail) if tail else "none recorded",
            )
            if not self.postmortem_path:
                return None
            # APPEND, never truncate (append_jsonl): every dump starts
            # with its own "kind": "postmortem" header, so a routine
            # SIGTERM-drain dump cannot clobber the stall/crash evidence
            # written minutes earlier — the whole point of the black box.
            # Readers take the records after the last header they care
            # about.
            header = {
                "kind": "postmortem", "reason": reason,
                "name": self.name, "ts": time.time(),
                "state": self._state, "restarts": self._restarts,
                "stalls": self._stalls, "pending": len(pending),
            }
            written = append_jsonl(self.postmortem_path, [
                header,
                *rounds,
                *({"kind": "pending_request", **t} for t in traces),
            ])
            return self.postmortem_path if written else None
        except Exception:  # noqa: BLE001 — diagnostics must never crash recovery
            _log.exception("postmortem dump failed")
            return None

    def _watch_loop(self) -> None:
        """The watchdog monitor: poll the live inner's heartbeat and
        escalate a busy loop whose stamp has gone stale past the stall
        threshold. One escalation per episode — the state gate (only
        ready/degraded loops are judged) and the heartbeat identity check
        keep the monitor from re-flagging a loop already being rebuilt or
        flagging the fresh one with the corpse's stale reading."""
        poll = max(0.02, min(0.25, self.stall_min_s / 4.0))
        while not self._watch_stop.wait(poll):
            with self._lock:
                if self._closed:
                    return
                if self._state not in ("ready", "degraded"):
                    continue
                inner = self._inner
            hb = getattr(inner, "heartbeat", None)
            if hb is None or not hb.busy:
                continue
            if getattr(inner, "supports_replica_restart", False) and \
                    callable(getattr(inner, "stalled_replicas", None)):
                # Fleet pools: judge each replica by ITS OWN heartbeat and
                # escalate only the stale ones to TARGETED restarts —
                # siblings keep serving. The wedged replica's journaled
                # requests re-place immediately (deferred if nothing can
                # take them yet; the post-rebuild callback finishes the
                # job). The whole-pool SchedulerStalled escalation below
                # is reserved for non-fleet inners.
                try:
                    stalled = inner.stalled_replicas(
                        self.stall_factor, self._effective_floor(hb))
                except Exception:  # noqa: BLE001 — a churning pool mid-read
                    stalled = []
                for label in stalled:
                    with self._lock:
                        if self._closed or self._state not in (
                                "ready", "degraded"):
                            break
                        if self._inner is not inner:
                            break
                        self._stalls += 1
                    resilience.inc("sched_stalls")
                    self.flight.event("replica_stall", replica=label)
                    _log.warning(
                        "watchdog: replica %s busy-stale past its stall "
                        "threshold; targeted restart", label,
                    )
                    if inner.restart_replica(label, reason="stalled"):
                        self._replay_replica(label, defer_on_overload=True)
                continue
            age = hb.age()
            threshold = stall_threshold(hb, self.stall_factor,
                                        self._effective_floor(hb))
            if age <= threshold:
                continue
            exc = SchedulerStalled(
                f"decode loop made no progress for {age:.2f}s "
                f"(stall threshold {threshold:.2f}s) with work in flight: "
                f"escalating the wedge to a restart"
            )
            with self._lock:
                if self._closed or self._state not in ("ready", "degraded"):
                    continue
                if self._inner is not inner:
                    continue  # the wedged incarnation is already gone
                self._stalls += 1
                resilience.inc("sched_stalls")
                _log.warning("watchdog: %s", exc)
                self._notice_crash_locked(exc)

    def _die_locked(self) -> None:
        self._state = "dead"
        self._restart_eta = None
        self.flight.event("dead", restarts=self._restarts)
        err = self._dead_error()
        _log.error("supervisor giving up: %s", err)
        for e in list(self._journal.values()):
            if not e.done:
                resilience.inc("sched_lost")
                self._lost += 1
                self._fail_locked(e, err)


class _CrashedAgain(Exception):
    """Internal signal: the freshly restarted loop crashed during replay."""

"""Chaos mode: run the fixture suite under a fault-injection spec and prove
the fault-tolerance layer closes every request.

FlashInfer-Bench's argument (PAPERS.md) applied to this repo: a serving
stack is only trustworthy when its FAILURE behavior is exercised by the
same harness that scores its success behavior. This module stands up a
self-contained replica of the reference's serving topology — an in-process
"Ollama" daemon (stdlib HTTP, oracle answers) behind the retry/breaker
`OllamaClientService`, and a `ResilientSQLBackend` over SQLite loaded with
the taxi fixture — then drives the four-query suite through it while
`utils.faults` injects failures at the two out-of-process boundaries
(`ollama:connect`, `sql:exec`).

The contract the report asserts, and `evalh --chaos` prints:

- **zero hung requests** — every request ends in exactly one terminal
  state: clean success, success-after-retry, a typed shed
  (CircuitOpen/Overloaded), graceful degradation (SQL failure answered
  with the raw engine error, the §2.2 fallback), or a typed connect
  failure. Nothing blocks, nothing leaks.
- the resilience counters (retries, breaker trips, sheds) moved — the
  layer actually did work, the run didn't just get lucky.
- **zero lost acknowledged requests** across scheduler crashes: a second
  stage drives a supervised scheduler (serve/supervisor.py over a
  host-only loop replica) under `sched:crash` injection — the loop dies
  MID-BATCH, the supervisor restarts it and replays the journal, and the
  report's `scheduler` section shows restart/replay/lost counts with
  `lost == 0` and duplicate idempotency keys deduplicated to one result.
- **zero silently-hung clients** across a WEDGED loop: a third stage
  injects a duration-valued `sched:hang` (the loop sleeps instead of
  raising — the failure mode no exception-based recovery can see), and
  the supervisor's watchdog must detect the stale heartbeat within its
  stall threshold, escalate to a `SchedulerStalled` restart, and replay —
  the report's `watchdog` section shows stalls detected, detection
  latency (bounded by the configured threshold + one poll), and zero
  unresolved clients.
- **targeted restart, not pool-wide**: a fourth stage wedges exactly ONE
  replica of a supervised fleet pool via the replica-addressable
  `sched:wedge_r1` site — the watchdog must attribute the stall to that
  replica, restart only it (sibling restart counters stay zero, the
  supervisor's whole-pool restart never fires), re-place its journaled
  requests onto the siblings, and every client resolves token-identical
  to a wedge-free control with zero lost acknowledged requests — the
  report's `fleet` section.
- **graceful degradation under KV-page pressure**: a fifth stage drives
  the REAL paged scheduler (tiny random weights) under a `kv:pressure`
  storm: the value-valued site
  withholds pool pages so overcommitted decode top-ups fail and victims
  preempt. Every request — greedy, sampled, grammar-constrained — must
  complete TOKEN-IDENTICAL to a pressure-free control, zero lost, with
  ≥1 preemption actually fired (no silent pass) — the report's
  `kv_pressure` section.

Stages 6-10 cover the phase-split fleet's handoff, the network transport,
elastic membership, the multi-tenant front door and self-healing SQL (each
stage's docstring has its contract).

Deterministic: the injection RNG is seeded and every boundary is hit from
the driving thread in a fixed order (the scheduler stage's single worker
included), so the same (spec, seed) replays the same fault schedule and
the same outcome histogram.

Counterpart of the JAX package's `evalh/chaos.py`: the same ten stages, the
same assertions and the same per-seed caches. The stages that build real
schedulers (5-9) make TINY's weights from a seeded `torch.Generator` on
`device` (`run_chaos(..., device=)`; on a card TINY's head dim is widened to
64, the smallest the kernels take).
"""

from __future__ import annotations

import json
import queue as queue_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Dict, Optional

DEFAULT_SPEC = "ollama:connect:0.5,sql:exec:1,sched:crash:0.2"

#: Per-seed cache of the pressure stage's pressure-free control outputs
#: (deterministic greedy/seeded decode — same seed, same tokens).
_PRESSURE_CONTROLS: Dict[int, list] = {}

#: Per-seed cached stage REPORTS for the scheduler-building stages
#: (pressure, disagg): each runs in its OWN injection scope under a
#: FIXED spec, so its report is a pure function of the seed — and
#: pytest drives run_chaos several times per process, where rebuilding
#: tiny scheduler fleets per call is most of the chaos suite's
#: wall (the seeded-replay contract already promises the same report).
_PRESSURE_REPORTS: Dict[int, Dict] = {}
_DISAGG_REPORTS: Dict[int, Dict] = {}


def _fake_ollama_daemon(answers: Dict[str, str]):
    """In-process oracle 'Ollama': answers /api/tags and /api/generate with
    the suite's expected SQL (keyed by prompt). Returns (server, url)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # keep chaos output clean
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/api/tags":
                self._json({"models": [{"name": "duckdb-nsql"}]})
            else:
                self._json({"error": "nope"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n))
            answer = answers.get(req.get("prompt", ""), "SELECT 1;")
            self._json({
                "model": req.get("model"), "response": answer,
                "eval_count": len(answer.split()), "done": True,
            })

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}"


class _ToyScheduler:
    """Host-only replica of the scheduler's submit/crash surface (no torch).

    One worker thread pops requests and 'decodes' them deterministically
    (token i of request (ids, seed) is a pure function of both), consulting
    `FAULTS.check("sched:crash")` before each emitted token — so a
    configured spec kills the loop MID-BATCH exactly like the real
    scheduler's harvest-time seam, failing every in-flight and queued
    future with one `SchedulerCrashed`. The supervisor is deliberately
    scheduler-agnostic (duck-typed factory); this replica lets the chaos
    harness prove the journal/replay/zero-lost contract self-contained,
    without standing up a device scheduler (the `chaos` pytest lane drives
    the REAL scheduler through the same seam — tests/test_supervisor.py).
    """

    def __init__(self, tokens_per_request: int = 6,
                 token_sleep_s: float = 0.002):
        from ..serve.flightrecorder import FlightRecorder
        from ..serve.watchdog import Heartbeat

        self.tokens_per_request = tokens_per_request
        # A hair of per-token wall: keeps a burst of submits ahead of the
        # decode drain, so the POOL's least-loaded placement over toy
        # replicas is deterministic (outstanding counts, not thread
        # scheduling, decide routing) — the fleet stage relies on it.
        self.token_sleep_s = token_sleep_s
        self._queue: "queue_mod.Queue" = queue_mod.Queue()
        self._crash = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # Queued + in-flight request count: the pool router's load signal
        # (backlog_score mirrors the real scheduler's seam).
        self._outstanding = 0
        # Liveness stamp, like the real scheduler's: stamped busy before
        # every emitted token, idle before blocking on the queue — so the
        # supervisor's watchdog monitors this replica through the same
        # seam, and an injected `sched:hang` (the check SLEEPS) reads as
        # a stale busy heartbeat.
        self.heartbeat = Heartbeat()
        # Flight recorder, like the real scheduler's: one record per
        # 'decode round' (token), so the supervisor's postmortem dump on
        # an injected crash/stall carries last-N rounds for the toy too.
        self.flight = FlightRecorder(capacity=64)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def shutdown(self, timeout=None):
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout)
            self._thread = None

    def submit(self, ids, max_new_tokens=256, sampling=None, seed=0,
               on_token=None, constraint=None, deadline_s=None, trace=None):
        from concurrent.futures import Future

        with self._lock:
            if self._crash is not None:
                raise self._crash
            self._outstanding += 1
        fut = Future()
        self._queue.put((list(ids), min(max_new_tokens,
                                        self.tokens_per_request),
                         seed, on_token, fut))
        return fut

    def backlog_score(self):
        """The pool router's load signal (the real scheduler's seam):
        no service-time EWMA for the toy, so the tie-break carries it."""
        with self._lock:
            return 0.0, self._outstanding

    @staticmethod
    def expected(ids, n, seed):
        """The deterministic 'completion' — replay MUST reproduce it."""
        return [(sum(ids) * 31 + seed * 17 + i * 7) % 997 for i in range(n)]

    def _run(self):
        import time as time_mod

        from ..serve.resilience import SchedulerCrashed
        from ..utils.faults import FAULTS

        while True:
            self.heartbeat.stamp(busy=False)  # idle: blocking for work
            item = self._queue.get()
            if item is None:
                return
            ids, n, seed, on_token, fut = item
            toks = self.expected(ids, n, seed)
            try:
                out = []
                for t in toks:
                    self.heartbeat.stamp(busy=True)
                    FAULTS.check("sched:crash")  # mid-batch death seam
                    FAULTS.check("sched:hang")   # duration site: wedge here
                    if FAULTS.active:
                        # Replica-addressable fleet seam, mirroring the
                        # real scheduler's: `sched:wedge_<label>` wedges
                        # or crashes exactly THIS pool replica.
                        FAULTS.check(
                            f"sched:wedge_{self.flight.replica}")
                    if self.token_sleep_s:
                        time_mod.sleep(self.token_sleep_s)
                    out.append(t)
                    if on_token is not None:
                        on_token(t)
                    self.heartbeat.round_done()
                    self.flight.record(round=self.heartbeat.rounds,
                                       occupancy=1, emitted=1)
            except Exception as exc:  # noqa: BLE001 — loop death, like _run's guard
                crash = SchedulerCrashed.from_exception(exc)
                with self._lock:
                    self._crash = crash
                    self._outstanding = 0
                fut.set_exception(crash)
                while True:  # fail everything queued behind the corpse
                    try:
                        nxt = self._queue.get_nowait()
                    except queue_mod.Empty:
                        return
                    if nxt is not None:
                        nxt[-1].set_exception(crash)
            else:
                fut.set_result(out)
                with self._lock:
                    self._outstanding = max(0, self._outstanding - 1)


def _run_scheduler_stage(seed: int, requests: int = 12) -> Dict:
    """Drive a supervised crash-prone scheduler and prove zero lost
    acknowledged requests: every future resolves with the deterministic
    expected tokens (replayed across however many restarts the injected
    schedule causes), and duplicate idempotency keys return ONE result."""
    import random
    import time as time_mod

    from ..serve.resilience import RetryPolicy
    from ..serve.supervisor import SupervisedScheduler

    sup = SupervisedScheduler(
        _ToyScheduler,
        # Generous budget + millisecond backoff: the stage exercises the
        # journal/replay logic, not production restart pacing.
        max_restarts=1000,
        restart_policy=RetryPolicy(max_attempts=1001, base_delay_s=0.001,
                                   max_delay_s=0.01),
        rng=random.Random(seed),
    ).start()
    try:
        futs, expect, firsts = [], [], []
        for i in range(requests):
            ids, rseed = [1 + i, 2 + i], i
            # Every third request is submitted TWICE under one key: the
            # journal must collapse the pair to a single generation.
            key = f"chaos-req-{i}" if i % 3 == 0 else None
            # TTFT across crash/replay churn: submit→first delivered
            # token, the "where latency lives" figure chaos runs now
            # report beside their outcome histogram.
            t_sub = time_mod.monotonic()
            first: list = []

            def on_tok(tok, first=first, t_sub=t_sub):
                if not first:
                    first.append(time_mod.monotonic() - t_sub)

            firsts.append(first)
            ckw: Dict = {"on_token": on_tok}
            if i == 1:
                # One CONSTRAINED request rides the chaos schedule: the
                # journal carries both the (opaque, toy) compiled object
                # and its serializable spec — the new spill format — and
                # the entry must replay across loop deaths exactly like
                # its unconstrained neighbours (zero lost below covers
                # it). The toy scheduler ignores the constraint; what is
                # under test is the SUPERVISOR's bookkeeping.
                ckw.update({"constraint": object(),
                            "constraint_spec": {"table": "taxi",
                                                "columns": ["VendorID"]}})
            fut = sup.submit(ids, seed=rseed, idempotency_key=key, **ckw)
            futs.append(fut)
            expect.append(_ToyScheduler.expected(ids, 6, rseed))
            if key is not None:
                dup = sup.submit(ids, seed=rseed, idempotency_key=key)
                futs.append(dup)
                expect.append(expect[-1])
        hung = mismatched = 0
        for fut, want in zip(futs, expect):
            try:
                got = fut.result(timeout=60)
            except Exception:  # noqa: BLE001 — typed terminal ≠ hung, but IS lost here
                got = None
            if got is None:
                hung += 1
            elif got != want:
                mismatched += 1
        health = sup.health()
        # Latency decomposition across the crash churn: TTFT through
        # restarts/replays + the toy loop's measured round cadence. Wall
        # times are NOT deterministic — run_chaos lifts this dict out of
        # the stage report so the seeded-replay comparison stays exact.
        ttfts = sorted(f[0] for f in firsts if f)
        hb = getattr(sup._inner, "heartbeat", None)
        cadence = hb.expected_round_s() if hb is not None else None
        latency = {
            "ttft_p50_s": (round(ttfts[len(ttfts) // 2], 6)
                           if ttfts else None),
            "ttft_max_s": round(ttfts[-1], 6) if ttfts else None,
            "round_cadence_s": round(cadence, 6) if cadence else None,
        }
    finally:
        sup.shutdown()
    report = {
        "requests": requests,
        "duplicate_keys": sum(1 for i in range(requests) if i % 3 == 0),
        "constrained_requests": 1 if requests > 1 else 0,
        "restarts": health["restarts"],
        "replayed": health["replayed"],
        "lost": health["lost"],
        "unresolved": hung,
        "mismatched": mismatched,
        "state": health["state"],
        "latency": latency,
    }
    assert hung == 0, (
        f"{hung} acknowledged request(s) never produced their result "
        f"across scheduler crashes"
    )
    assert mismatched == 0, (
        f"{mismatched} replayed request(s) diverged from the deterministic "
        f"expected completion"
    )
    assert health["lost"] == 0, (
        f"{health['lost']} acknowledged request(s) lost across restarts"
    )
    return report


def _run_hang_stage(seed: int, hang_s: float = 0.35,
                    stall_min_s: float = 0.1, requests: int = 3) -> Dict:
    """Wedge a supervised toy loop with a duration-valued `sched:hang`
    (the loop SLEEPS mid-batch — no exception ever fires) and prove the
    watchdog path end to end: the stale busy heartbeat is detected within
    the stall threshold + one monitor poll, the wedge escalates to a
    `SchedulerStalled` restart, the journal replays, and every client
    resolves with the deterministic expected tokens — zero silently-hung
    clients. The factory clears injection on rebuild (the established
    one-episode pattern), so the schedule is deterministic. Runs in its
    OWN injection scope; returns its fault counts for the caller to
    merge."""
    import random

    from ..serve.resilience import RetryPolicy
    from ..serve.supervisor import SupervisedScheduler
    from ..utils.faults import FAULTS

    FAULTS.configure(f"sched:hang:1:{hang_s}", seed)
    builds = []
    counts_at_rebuild: Dict[str, int] = {}

    def factory():
        if builds:
            # One wedge episode: the rebuilt loop runs clean. Snapshot the
            # injected-hang counts first — clear() wipes them.
            counts_at_rebuild.update(FAULTS.counts())
            FAULTS.clear()
        builds.append(1)
        return _ToyScheduler()

    sup = SupervisedScheduler(
        factory, max_restarts=5,
        restart_policy=RetryPolicy(max_attempts=6, base_delay_s=0.001,
                                   max_delay_s=0.01),
        rng=random.Random(seed),
        stall_factor=2.0, stall_min_s=stall_min_s,
        # The wedged toy sleeps through several per-token hangs before it
        # can join: abandon it fast (the supervisor owns the client
        # futures; the zombie's late results hit the staleness guard).
        stall_join_s=0.2,
    ).start()
    t0 = time.monotonic()
    try:
        futs, expect = [], []
        for i in range(requests):
            ids, rseed = [3 + i, 4 + i], 100 + i
            futs.append(sup.submit(ids, seed=rseed))
            expect.append(_ToyScheduler.expected(ids, 6, rseed))
        hung = mismatched = 0
        for fut, want in zip(futs, expect):
            try:
                got = fut.result(timeout=60)
            except Exception:  # noqa: BLE001 — typed terminal counts lost here
                got = None
            if got is None:
                hung += 1
            elif got != want:
                mismatched += 1
        wall = time.monotonic() - t0
        health = sup.health()
        counts = dict(counts_at_rebuild)
        for site, n in FAULTS.counts().items():
            counts[site] = counts.get(site, 0) + n
    finally:
        FAULTS.clear()
        sup.shutdown()
    report = {
        "requests": requests,
        "hang_s": hang_s,
        "stall_threshold_s": stall_min_s,
        "stalls_detected": health["stalls"],
        "restarts": health["restarts"],
        "replayed": health["replayed"],
        "lost": health["lost"],
        "unresolved": hung,
        "mismatched": mismatched,
        "state": health["state"],
        "faults_injected": counts,
        # Detection + recovery wall: how long the clients actually waited
        # for the wedge to be caught and replayed (bounded below).
        "wall_s": round(wall, 3),
    }
    assert hung == 0, (
        f"{hung} client(s) silently hung across an injected decode-loop "
        f"wedge — the watchdog failed to recover them"
    )
    assert mismatched == 0, (
        f"{mismatched} replayed request(s) diverged after the stall restart"
    )
    assert health["stalls"] >= 1, (
        "the injected hang was never detected as a stall"
    )
    assert health["lost"] == 0, (
        f"{health['lost']} acknowledged request(s) lost across the stall"
    )
    # Bounded detection + recovery: everything resolved in a small
    # multiple of the injected wedge (detection <= threshold + poll, then
    # teardown join + millisecond backoff + replay). A wall anywhere near
    # requests × hang_s would mean the hang was waited out, not detected.
    bound = 6 * hang_s + 5.0
    assert wall < bound, (
        f"hang stage took {wall:.2f}s (bound {bound:.2f}s): detection or "
        f"recovery is not bounded"
    )
    return report


def _run_fleet_stage(seed: int, wedge_s: float = 0.35,
                     stall_min_s: float = 0.1, replicas: int = 3,
                     requests: int = 9) -> Dict:
    """Fleet chaos: wedge ONE replica of a supervised pool via the
    replica-addressable `sched:wedge_r1` site and prove the
    targeted-restart contract end to end — the watchdog attributes the
    stale heartbeat to r1 specifically, ONLY r1 restarts (sibling
    restart counters stay zero), r1's journaled requests re-place onto
    the siblings, every client resolves with the deterministic expected
    tokens (token-identical to a wedge-free control — the toy's output
    is a pure function of (ids, seed), exactly like the real scheduler's
    greedy decode), and zero acknowledged requests are lost. Runs in its
    OWN injection scope; returns fault counts for the caller to merge."""
    import random

    from ..serve.resilience import RetryPolicy
    from ..serve.scheduler import SchedulerPool
    from ..serve.supervisor import SupervisedScheduler
    from ..utils.faults import FAULTS

    FAULTS.configure(f"sched:wedge_r1:1:{wedge_s}", seed)
    counts_at_clear: Dict[str, int] = {}

    def replica_factory():
        # The REBUILT replica runs clean (one wedge episode — the
        # established chaos pattern): clear injection the moment the pool
        # rebuilds r1, snapshotting the counts first.
        counts_at_clear.update(FAULTS.counts())
        FAULTS.clear()
        return _ToyScheduler()

    def make_pool():
        return SchedulerPool(
            [_ToyScheduler() for _ in range(replicas)],
            factory=replica_factory,
            max_restarts=5,
            restart_policy=RetryPolicy(max_attempts=6, base_delay_s=0.001,
                                       max_delay_s=0.01),
            rng=random.Random(seed),
            replica_join_s=0.2,
        )

    sup = SupervisedScheduler(
        make_pool, max_restarts=5,
        restart_policy=RetryPolicy(max_attempts=6, base_delay_s=0.001,
                                   max_delay_s=0.01),
        rng=random.Random(seed),
        stall_factor=2.0, stall_min_s=stall_min_s,
        stall_join_s=0.2,
    ).start()
    t0 = time.monotonic()
    try:
        futs, expect = [], []
        for i in range(requests):
            ids, rseed = [7 + i, 8 + i], 200 + i
            futs.append(sup.submit(ids, seed=rseed))
            expect.append(_ToyScheduler.expected(ids, 6, rseed))
        hung = mismatched = 0
        for fut, want in zip(futs, expect):
            try:
                got = fut.result(timeout=60)
            except Exception:  # noqa: BLE001 — typed terminal counts lost here
                got = None
            if got is None:
                hung += 1
            elif got != want:
                mismatched += 1
        wall = time.monotonic() - t0
        # The clients resolve off the SIBLINGS well before the wedged
        # replica's bounded teardown + rebuild lands: wait for the
        # targeted restart to complete before judging the counters.
        deadline = time.monotonic() + 10.0
        health = sup.health()
        while time.monotonic() < deadline:
            reps = {r["replica"]: r for r in health.get("replicas", [])}
            r1 = reps.get("r1", {})
            if (int(r1.get("restarts", 0)) >= 1
                    and r1.get("state") in ("ready", "degraded")):
                break
            time.sleep(0.01)
            health = sup.health()
        counts = dict(counts_at_clear)
        for site, n in FAULTS.counts().items():
            counts[site] = counts.get(site, 0) + n
    finally:
        FAULTS.clear()
        sup.shutdown()
    per_replica = {r["replica"]: r for r in health.get("replicas", [])}
    wedged = per_replica.get("r1", {})
    sibling_restarts = sum(
        int(r.get("restarts", 0)) for lbl, r in per_replica.items()
        if lbl != "r1"
    )
    report = {
        "replicas": replicas,
        "requests": requests,
        "wedge_s": wedge_s,
        "stall_threshold_s": stall_min_s,
        "wedged_replica": "r1",
        "wedged_restarts": int(wedged.get("restarts", 0)),
        "sibling_restarts": sibling_restarts,
        "stalls_detected": health["stalls"],
        "pool_restarts": health["restarts"],
        "replayed": health["replayed"],
        "lost": health["lost"],
        "unresolved": hung,
        "mismatched": mismatched,
        "state": health["state"],
        "faults_injected": counts,
        "wall_s": round(wall, 3),
    }
    assert hung == 0, (
        f"{hung} client(s) silently hung across a single wedged replica "
        f"— the fleet failed to recover them"
    )
    assert mismatched == 0, (
        f"{mismatched} re-placed request(s) diverged from the wedge-free "
        f"control outputs"
    )
    assert health["lost"] == 0, (
        f"{health['lost']} acknowledged request(s) lost across the "
        f"targeted replica restart"
    )
    assert report["wedged_restarts"] >= 1, (
        "the wedged replica was never restarted — the stall was not "
        "attributed"
    )
    assert sibling_restarts == 0, (
        f"{sibling_restarts} sibling restart(s): the wedge escalated "
        f"beyond the one wedged replica (targeted restart regressed to "
        f"pool-wide)"
    )
    assert health["restarts"] == 0, (
        "the SUPERVISOR's whole-pool restart fired for a single-replica "
        "wedge — targeted restart must keep siblings serving"
    )
    # Bounded recovery, like the hang stage: anywhere near
    # requests × wedge_s means the wedge was waited out, not detected.
    bound = 6 * wedge_s + 5.0
    assert wall < bound, (
        f"fleet stage took {wall:.2f}s (bound {bound:.2f}s): targeted "
        f"detection or re-placement is not bounded"
    )
    return report


def _tiny(seed: int, device):
    """TINY and its f32 weights from `seed` on `device` (a card widens the
    head dim to 64, the kernels' smallest)."""
    import dataclasses

    import torch

    from .. import resolve_device
    from ..models import TINY
    from ..models.llama import init_params

    dev = resolve_device(device)
    cfg = TINY if dev.type == "cpu" else dataclasses.replace(TINY, head_dim=64)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, init_params(cfg, gen, torch.float32, device=dev)


def _run_pressure_stage(seed: int, withhold_pages: int = 6, device=None) -> Dict:
    """KV-page pressure chaos: drive the REAL paged scheduler
    (tiny random-weight model, CPU) under a `kv:pressure` storm — the
    value-valued site withholds part of the page pool every loop
    iteration, so overcommitted decode top-ups fail and victims preempt —
    and prove graceful degradation end to end: every request completes,
    outputs are TOKEN-IDENTICAL to a pressure-free control (greedy,
    sampled, and a grammar-constrained request — the deterministic-resume
    contract across recompute re-prefill), zero lost, and at least one
    preemption actually fired (a storm that preempts nobody proves
    nothing — no silent pass). Unlike stages 1-4 this one builds a real
    scheduler on `device`: page pressure is a property of the real pool,
    not of a host-only toy. Runs in its OWN injection scope; returns fault counts for the
    caller to merge (the per-iteration sampling makes raw counts
    timing-dependent, so the report only keeps whether the site fired).
    The report is cached per seed (own scope, fixed spec), so repeated
    run_chaos calls in one process pay the scheduler builds once."""
    cached = _PRESSURE_REPORTS.get((seed, withhold_pages))
    if cached is not None:
        return cached

    from ..constrain import get_constraint
    from ..ops.sampling import SamplingParams
    from ..serve.scheduler import ContinuousBatchingScheduler
    from ..tokenizer import ByteTokenizer
    from ..utils.faults import FAULTS

    cfg, params = _tiny(seed, device)
    tok = ByteTokenizer()
    cm = get_constraint("spark_sql", tok, (2,))
    budget = max(24, cm.min_new_tokens)
    # Greedy, sampled (temperature > 0), constrained, greedy — the three
    # request classes whose resumes exercise three different determinism
    # mechanisms (position replay, fold_in(key, count) restore, FSM
    # replay).
    reqs = [
        ([1, 5, 9], SamplingParams(), None, 24),
        ([1, 7, 11], SamplingParams(temperature=0.8, top_p=0.95), None, 24),
        (tok.encode("SELECT", add_bos=True), SamplingParams(), cm, budget),
        ([1, 3, 4, 8], SamplingParams(), None, 24),
    ]

    def drive(pressure: bool):
        if pressure:
            FAULTS.configure(f"kv:pressure:1:{withhold_pages}", seed)
        try:
            # Pool = one max-length request (the floor), overcommitted at
            # 0.25: two slots admit on expected envelopes, top-ups grow
            # them mid-decode, and the withheld reserve makes those
            # top-ups fail — the preemption trigger.
            with ContinuousBatchingScheduler(
                cfg, params, num_slots=2, decode_chunk=4,
                prompt_bucket=8, stop_ids=(2,), max_seq=96,
                kv_layout="paged", kv_page_size=8, kv_pages=12,
                kv_overcommit=0.25, device=device,
            ) as sched:
                futs = [
                    sched.submit(ids, max_new_tokens=mn, sampling=sp,
                                 seed=300 + i, constraint=c)
                    for i, (ids, sp, c, mn) in enumerate(reqs)
                ]
                outs = []
                for f in futs:
                    try:
                        outs.append(f.result(timeout=300))
                    except Exception:  # noqa: BLE001 — lost, counted below
                        outs.append(None)
                stats = dict(sched.page_stats)
        finally:
            FAULTS.clear()
        return outs, stats

    # The pressure-free control is a pure function of the seed: cache it
    # per process so repeated chaos runs (pytest drives run_chaos several
    # times) pay the control scheduler build once.
    control = _PRESSURE_CONTROLS.get(seed)
    if control is None:
        control, _ = drive(False)
        _PRESSURE_CONTROLS[seed] = control
    outs, stats = drive(True)
    lost = sum(1 for o in outs if o is None)
    mismatched = sum(
        1 for o, c in zip(outs, control) if o is not None and o != c
    )
    report = {
        "requests": len(reqs),
        "request_classes": ["greedy", "sampled", "constrained", "greedy"],
        "withhold_pages": withhold_pages,
        "overcommit": stats["overcommit"],
        "preemptions": stats["preemptions"],
        "page_waits": stats["page_waits"],
        "evictions": stats["evictions"],
        "lost": lost,
        "mismatched": mismatched,
        "pressure_fired": stats["preemptions"] > 0
        or stats["page_waits"] > 0,
    }
    assert lost == 0, (
        f"{lost} request(s) never completed under the kv:pressure storm "
        f"— pressure relief lost acknowledged work"
    )
    assert mismatched == 0, (
        f"{mismatched} resumed request(s) diverged from the pressure-free "
        f"control — preemption resume is not token-identical"
    )
    assert stats["preemptions"] >= 1, (
        "the kv:pressure storm forced no preemption — the stage proved "
        "nothing (no silent pass)"
    )
    _PRESSURE_REPORTS[(seed, withhold_pages)] = report
    return report


#: Per-seed cached crash-free controls for the disagg stage (pytest
#: drives run_chaos repeatedly; the control scheduler build is paid once).
_DISAGG_CONTROLS: Dict[int, list] = {}


def _run_disagg_stage(seed: int, device=None) -> Dict:
    """Disaggregated-serving chaos: a supervised PHASE-SPLIT
    fleet — one prefill + one decode replica, real tiny paged schedulers
    on `device` — serves greedy, sampled and constrained traffic in two
    waves. Wave 1 runs clean and must migrate every request through the
    export→requeue→import handoff (≥1 export asserted: an in-place
    fallback pass proves nothing). Wave 2 runs under `sched:handoff:1`,
    which kills the prefill replica MID-HANDOFF — first token committed
    and streamed, blob never shipped; the pool must restart ONLY the
    prefill replica (decode sibling's restart counter stays zero) while
    the supervisor re-places its journaled requests onto the decode
    sibling — the re-prefill-on-a-sibling path — with delivered
    prefixes suppressed. Both waves must come out TOKEN-IDENTICAL to a
    single mixed-replica control, zero lost. Own injection scope, like
    stages 3-5. The report is cached per seed (own scope, fixed spec),
    so repeated run_chaos calls in one process pay the fleet builds
    once."""
    cached = _DISAGG_REPORTS.get(seed)
    if cached is not None:
        return cached
    import random as _random


    from ..constrain import get_constraint
    from ..ops.sampling import SamplingParams
    from ..serve.resilience import RetryPolicy
    from ..serve.scheduler import ContinuousBatchingScheduler, SchedulerPool
    from ..serve.supervisor import SupervisedScheduler
    from ..tokenizer import ByteTokenizer
    from ..utils.faults import FAULTS

    cfg, params = _tiny(seed, device)
    tok = ByteTokenizer()
    cm = get_constraint("spark_sql", tok, (2,))
    budget = max(16, cm.min_new_tokens)
    reqs = [
        ([1, 5, 9], SamplingParams(), None, 8),
        ([1, 7, 11], SamplingParams(temperature=0.8, top_p=0.95), None, 8),
        (tok.encode("SELECT", add_bos=True), SamplingParams(), cm, budget),
        ([1, 3, 4, 8], SamplingParams(), None, 8),
    ]

    def make_replica(role="mixed"):
        return ContinuousBatchingScheduler(
            cfg, params, num_slots=2, decode_chunk=4, prompt_bucket=8,
            stop_ids=(2,), max_seq=96, kv_layout="paged", kv_page_size=8,
            phase_role=role, device=device,
        )

    control = _DISAGG_CONTROLS.get(seed)
    if control is None:
        with make_replica() as ctl:
            futs = [
                ctl.submit(ids, max_new_tokens=mn, sampling=sp,
                           seed=700 + i, constraint=c)
                for i, (ids, sp, c, mn) in enumerate(reqs)
            ]
            control = [f.result(timeout=300) for f in futs]
        _DISAGG_CONTROLS[seed] = control

    roles = ["prefill", "decode"]
    rebuilt = []

    def rebuild(i):
        if i == 0:
            # Exactly ONE crash episode: the rebuilt prefill replica
            # runs clean, making the schedule deterministic.
            FAULTS.clear()
        rebuilt.append(i)
        return make_replica(roles[i])

    def make_pool():
        return SchedulerPool(
            [make_replica(r) for r in roles], factory=rebuild,
            max_restarts=3,
            restart_policy=RetryPolicy(max_attempts=4, base_delay_s=0.001,
                                       max_delay_s=0.01),
            rng=_random.Random(seed),
        )

    sup = SupervisedScheduler(
        make_pool, max_restarts=3,
        restart_policy=RetryPolicy(max_attempts=4, base_delay_s=0.001,
                                   max_delay_s=0.01),
        rng=_random.Random(seed),
    ).start()

    def wave():
        futs = [
            sup.submit(ids, max_new_tokens=mn, sampling=sp, seed=700 + i,
                       constraint=c)
            for i, (ids, sp, c, mn) in enumerate(reqs)
        ]
        outs = []
        for f in futs:
            try:
                outs.append(f.result(timeout=300))
            except Exception:  # noqa: BLE001 — lost, counted below
                outs.append(None)
        return outs

    try:
        outs_clean = wave()  # wave 1: clean disaggregated serving
        pool = sup._inner
        exports = sum(
            int(r.get("exports", 0))
            for r in (pool.handoff_stats or {}).get("replicas", [])
        )
        FAULTS.configure("sched:handoff:1", seed)
        outs_crash = wave()  # wave 2: prefill replica dies mid-handoff
        # FAULTS.counts() is wiped by the rebuild factory's clear(): the
        # crash evidence is the pool's own lifecycle ring instead.
        crashes = sum(
            1 for r in pool.flight_snapshot()
            if r.get("kind") == "replica_crash" and r.get("replica") == "r0"
        )
        loads = {r["replica"]: r for r in pool.replica_loads()}
    finally:
        FAULTS.clear()
        sup.shutdown()

    lost = sum(1 for o in outs_clean + outs_crash if o is None)
    mismatched = sum(
        1 for o, c in zip(outs_clean, control) if o is not None and o != c
    ) + sum(
        1 for o, c in zip(outs_crash, control) if o is not None and o != c
    )
    report = {
        "requests": 2 * len(reqs),
        "request_classes": ["greedy", "sampled", "constrained", "greedy"],
        "handoffs": exports,
        "crashes_injected": crashes,
        "prefill_restarts": loads.get("r0", {}).get("restarts", 0),
        "decode_restarts": loads.get("r1", {}).get("restarts", 0),
        "lost": lost,
        "mismatched": mismatched,
    }
    assert exports >= 1, (
        "the phase-split fleet exported no handoff — every request fell "
        "back to decoding in place, the stage proved nothing"
    )
    assert report["crashes_injected"] >= 1, (
        "sched:handoff never fired — the crash-mid-handoff path was not "
        "exercised"
    )
    assert lost == 0, (
        f"{lost} request(s) never completed across the prefill-replica "
        f"crash — the handoff state lost acknowledged work"
    )
    assert mismatched == 0, (
        f"{mismatched} request(s) diverged from the mixed-replica "
        f"control — the phase-split path is not token-identical"
    )
    assert report["decode_restarts"] == 0, (
        "the decode replica restarted during a prefill-replica crash — "
        "the recovery was not targeted"
    )
    _DISAGG_REPORTS[seed] = report
    return report


#: Per-seed cached fault-free controls for the net-transport stage.
_NET_CONTROLS: Dict[int, list] = {}

#: Per-seed cached stage-7 REPORTS: the stage runs in its own injection
#: scope under a FIXED per-class spec, so its report is a pure function
#: of the seed — pytest drives run_chaos several times per process, and
#: the three tiny-scheduler builds + the targeted rebuild are the
#: priciest thing in the whole chaos suite.
_NET_REPORTS: Dict[int, Dict] = {}


class _CountingReplica:
    """Transparent scheduler wrapper counting submit() EXECUTIONS at
    the replica — the no-double-generate proof: under net:drop/net:dup
    chaos the transport's retries and duplicated deliveries must dedup
    against the idempotency-token ledger, so the scheduler itself sees
    each logical request exactly once."""

    def __init__(self, inner):
        self.inner = inner
        self.submits = 0

    def submit(self, *a, **k):
        self.submits += 1
        return self.inner.submit(*a, **k)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _run_net_stage(seed: int, device=None) -> Dict:
    """Transport chaos: a supervised TWO-replica fleet of
    REAL tiny speculative schedulers behind loopback transports — the
    same rpc envelope the socket transport runs — serves greedy,
    sampled and grammar-constrained traffic (all speculative: draft 2)
    under each network fault class in turn:

    - `net:drop` — responses lost, RPCs retried: outputs must be
      token-identical to a fault-free control AND each request must
      execute exactly once at the scheduler (the idempotency-token
      ledger dedups the retries — no token double-generated).
    - `net:delay` — the wire stalls; the envelope absorbs it inside the
      rpc budget and nothing is lost or reordered.
    - `net:dup` — every request delivered twice; the ledger absorbs the
      duplicate (exactly-once execution again).
    - `net:partition_r1` — ALL I/O to replica r1 fails: its lease must
      expire, ONLY r1 restart (sibling counter zero, no whole-pool
      restart), its journaled work re-place onto r0, and every client
      resolve token-identical with zero lost and no duplicated stream
      tokens.

    Own injection scope, like stages 3-6; builds tiny schedulers on
    `device` like the pressure/disagg stages. The report is cached per seed
    (fixed per-class specs + own scope make it a pure function of the
    seed), so repeated run_chaos calls in one process pay the fleet
    builds once."""
    cached = _NET_REPORTS.get(seed)
    if cached is not None:
        return cached
    import random as _random
    import time as _time


    from ..constrain import get_constraint
    from ..ops.sampling import SamplingParams
    from ..serve.remote import LoopbackTransport
    from ..serve.resilience import RetryPolicy
    from ..serve.scheduler import ContinuousBatchingScheduler, SchedulerPool
    from ..serve.supervisor import SupervisedScheduler
    from ..tokenizer import ByteTokenizer
    from ..utils.faults import FAULTS

    cfg, params = _tiny(seed, device)
    tok = ByteTokenizer()
    cm = get_constraint("spark_sql", tok, (2,))
    budget = max(16, cm.min_new_tokens)
    reqs = [
        ([1, 5, 9], SamplingParams(), None, 8),
        ([1, 7, 11], SamplingParams(temperature=0.8, top_p=0.95), None, 8),
        (tok.encode("SELECT", add_bos=True), SamplingParams(), cm, budget),
        ([1, 3, 4, 8], SamplingParams(), None, 8),
    ]

    def make_sched():
        return ContinuousBatchingScheduler(
            cfg, params, num_slots=2, decode_chunk=4, prompt_bucket=8,
            stop_ids=(2,), max_seq=96, speculative_draft=2, device=device,
        )

    # Fault-free control: per-request determinism means output is a pure
    # function of (ids, sampling, seed) — one bare replica is the oracle.
    control = _NET_CONTROLS.get(seed)
    if control is None:
        with make_sched() as ctl:
            futs = [
                ctl.submit(ids, max_new_tokens=mn, sampling=sp,
                           seed=900 + i, constraint=c)
                for i, (ids, sp, c, mn) in enumerate(reqs)
            ]
            control = [f.result(timeout=300) for f in futs]
        _NET_CONTROLS[seed] = control

    counters: Dict[str, "_CountingReplica"] = {}
    rebuilt = []

    def make_transport(i):
        counting = _CountingReplica(make_sched())
        counters[f"r{i}"] = counting
        return LoopbackTransport(
            counting, label=f"r{i}",
            retry_policy=RetryPolicy(max_attempts=6, base_delay_s=0.001,
                                     max_delay_s=0.01),
            rng=_random.Random(seed + i), sleep=lambda s: None,
        )

    def rebuild(i):
        if i == 1:
            # The partition "heals" when the pool rebuilds r1 —
            # exactly one lease-expiry episode, deterministic schedule.
            FAULTS.clear()
        rebuilt.append(i)
        return make_transport(i)

    def make_pool():
        return SchedulerPool(
            [make_transport(0), make_transport(1)], factory=rebuild,
            max_restarts=3,
            restart_policy=RetryPolicy(max_attempts=4, base_delay_s=0.001,
                                       max_delay_s=0.01),
            rng=_random.Random(seed),
            lease_s=0.05, lease_misses=2,
        )

    sup = SupervisedScheduler(
        make_pool, max_restarts=3,
        restart_policy=RetryPolicy(max_attempts=4, base_delay_s=0.001,
                                   max_delay_s=0.01),
        rng=_random.Random(seed),
    ).start()

    def wave(tag: str) -> Dict:
        submits_before = sum(c.submits for c in counters.values())
        streams: list = [[] for _ in reqs]
        futs = []
        for i, (ids, sp, c, mn) in enumerate(reqs):
            futs.append(sup.submit(
                ids, max_new_tokens=mn, sampling=sp, seed=900 + i,
                constraint=c, on_token=streams[i].append,
            ))
        outs = []
        for f in futs:
            try:
                outs.append(f.result(timeout=300))
            except Exception:  # noqa: BLE001 — lost, counted below
                outs.append(None)
        lost = sum(1 for o in outs if o is None)
        mismatched = sum(
            1 for o, c in zip(outs, control) if o is not None and o != c
        )
        # No-duplicate streaming: every delivered stream must be a
        # PREFIX of its final result (a dropped wire may skip delivery;
        # it must never deliver a token twice or out of order).
        stream_bad = sum(
            1 for s, o in zip(streams, outs)
            if o is not None and s != o[: len(s)]
        )
        return {
            "requests": len(reqs),
            "lost": lost,
            "mismatched": mismatched,
            "stream_violations": stream_bad,
            "scheduler_submits": sum(c.submits for c in counters.values())
            - submits_before,
        }

    waves: Dict[str, Dict] = {}
    try:
        # Deterministic single-class scopes, cleared between waves so
        # each class's seeded schedule stands alone.
        FAULTS.configure("net:drop:0.4", seed)
        waves["drop"] = wave("drop")
        waves["drop"]["faults"] = dict(FAULTS.counts())
        FAULTS.configure("net:delay:0.5:0.005", seed)
        waves["delay"] = wave("delay")
        waves["delay"]["faults"] = dict(FAULTS.counts())
        FAULTS.configure("net:dup:1", seed)
        waves["dup"] = wave("dup")
        waves["dup"]["faults"] = dict(FAULTS.counts())
        health_mid = sup.health()
        restarts_before_partition = {
            r["replica"]: int(r.get("restarts", 0))
            for r in health_mid.get("replicas", [])
        }
        FAULTS.configure("net:partition_r1:1", seed)
        waves["partition"] = wave("partition")
        # The rebuild swapped r1's counting wrapper out mid-wave, so the
        # submit delta is not meaningful here (the exactly-once proof is
        # the token-identity + stream checks + the three clean waves).
        waves["partition"].pop("scheduler_submits", None)
        # Wait for the targeted restart of r1 to land before judging
        # the counters (clients resolved off r0 well before).
        deadline = _time.monotonic() + 10.0
        health = sup.health()
        while _time.monotonic() < deadline:
            reps = {r["replica"]: r for r in health.get("replicas", [])}
            r1 = reps.get("r1", {})
            if (int(r1.get("restarts", 0)) >= 1
                    and r1.get("state") in ("ready", "degraded")):
                break
            _time.sleep(0.01)
            health = sup.health()
    finally:
        FAULTS.clear()
        sup.shutdown()

    reps = {r["replica"]: r for r in health.get("replicas", [])}
    waves["partition"]["lease_expired"] = bool(rebuilt)
    report = {
        "request_classes": ["greedy", "sampled", "constrained"],
        "speculative_draft": 2,
        "waves": waves,
        "partitioned_replica": "r1",
        "partition_restarts": int(reps.get("r1", {}).get("restarts", 0))
        - restarts_before_partition.get("r1", 0),
        "sibling_restarts": int(reps.get("r0", {}).get("restarts", 0))
        - restarts_before_partition.get("r0", 0),
        "pool_restarts": health["restarts"],
        "replayed": health["replayed"],
        "lost_total": health["lost"],
    }
    for tag, w in waves.items():
        assert w["lost"] == 0, (
            f"{w['lost']} request(s) lost under net:{tag} — the transport "
            f"envelope dropped acknowledged work"
        )
        assert w["mismatched"] == 0, (
            f"{w['mismatched']} request(s) diverged from the fault-free "
            f"control under net:{tag}"
        )
        assert w["stream_violations"] == 0, (
            f"{w['stream_violations']} stream(s) delivered duplicated/"
            f"reordered tokens under net:{tag}"
        )
    for tag in ("drop", "delay", "dup"):
        assert any(k.startswith("net:") for k in waves[tag]["faults"]), (
            f"net:{tag} never fired — the wave proved nothing"
        )
        assert waves[tag]["scheduler_submits"] == len(reqs), (
            f"net:{tag}: {waves[tag]['scheduler_submits']} scheduler "
            f"submits for {len(reqs)} requests — retries/dups "
            f"double-generated (idempotency broken)"
        )
    assert report["partition_restarts"] >= 1, (
        "the partitioned replica's lease never expired — the partition "
        "was not detected"
    )
    assert report["sibling_restarts"] == 0, (
        f"{report['sibling_restarts']} sibling restart(s): the partition "
        f"escalated beyond the partitioned replica"
    )
    assert report["pool_restarts"] == 0, (
        "the SUPERVISOR's whole-pool restart fired for a single-replica "
        "partition — recovery must stay targeted"
    )
    assert report["lost_total"] == 0, (
        f"{report['lost_total']} acknowledged request(s) lost across the "
        f"partition"
    )
    _NET_REPORTS[seed] = report
    return report


#: Per-seed cached control outputs + stage-8 REPORTS for the elastic
#: stage: own injection scope, fixed specs — a pure function of the
#: seed. The stage builds the most tiny schedulers of any stage (plus
#: real socket workers), so the cache matters most here.
_ELASTIC_CONTROLS: Dict[int, list] = {}
_ELASTIC_REPORTS: Dict[int, Dict] = {}


def _run_elastic_stage(seed: int, device=None) -> Dict:
    """Elastic-fleet chaos: a supervised ALL-REMOTE
    phase-split fleet — one prefill + one decode worker, each a real
    tiny paged scheduler behind a `ReplicaServer` on a loopback
    socket — serves greedy, sampled and constrained traffic while the
    membership machinery takes four faults in a fixed order:

    1. **burst → scale-up**: a 2x request burst raises the remote
       decode tier's queue-depth EWMA over the scale threshold; the
       `FleetAutoscaler` (driven by an explicit clock) must JOIN a
       freshly spawned standby decode worker mid-burst —
       handshake-validated, placeable, `replica_join` in the pool's
       flight ring — and every burst request must resolve
       token-identical to the fault-free control with ≥1 handoff
       PUSHED through the wire (zero pushes = the pump never ran and
       the stage proved nothing).
    2. **partition during scale-up**: `fleet:spawn:1` makes the next
       spawn attempt fail like an unreachable standby host — a
       counted non-event (`spawn_failures`), fleet size unchanged,
       control loop alive, the next wave clean.
    3. **SIGKILL remote prefill mid-handoff**: the prefill worker's
       server + scheduler are torn down the moment ≥1 new push of the
       wave is in flight; the lease must expire, ONLY r0 restart —
       against a replacement worker — and the journal re-place its
       work on the decode tier with delivered stream prefixes
       suppressed: zero lost, zero duplicated stream tokens, outputs
       identical.
    4. **scale-down racing in-flight streams**: `retire_replica`
       fires with a wave in flight; the drain re-places the elastic
       decode worker's work onto siblings (`replica_retire` in the
       flight ring) and the wave still resolves token-identical with
       exactly-once streams on the shrunken fleet.

    Own injection scope, like stages 3-7; the report is cached per
    seed (fixed specs + own scope make it a pure function of the
    seed)."""
    cached = _ELASTIC_REPORTS.get(seed)
    if cached is not None:
        return cached
    import random as _random
    import time as _time


    from ..constrain import get_constraint
    from ..ops.sampling import SamplingParams
    from ..serve.elastic import FleetAutoscaler
    from ..serve.remote import ReplicaServer, SocketTransport
    from ..serve.resilience import RetryPolicy
    from ..serve.scheduler import ContinuousBatchingScheduler, SchedulerPool
    from ..serve.supervisor import SupervisedScheduler
    from ..tokenizer import ByteTokenizer
    from ..utils.faults import FAULTS

    cfg, params = _tiny(seed, device)
    tok = ByteTokenizer()
    cm = get_constraint("spark_sql", tok, (2,))
    budget = max(16, cm.min_new_tokens)
    reqs = [
        ([1, 5, 9], SamplingParams(), None, 8),
        ([1, 7, 11], SamplingParams(temperature=0.8, top_p=0.95), None, 8),
        (tok.encode("SELECT", add_bos=True), SamplingParams(), cm, budget),
        ([1, 3, 4, 8], SamplingParams(), None, 8),
    ]

    def resolver(spec):
        return get_constraint(spec, tok, (2,))

    def make_sched(role):
        return ContinuousBatchingScheduler(
            cfg, params, num_slots=2, decode_chunk=4, prompt_bucket=8,
            stop_ids=(2,), max_seq=96, kv_layout="paged", kv_page_size=8,
            phase_role=role, device=device,
        )

    control = _ELASTIC_CONTROLS.get(seed)
    if control is None:
        with make_sched("mixed") as ctl:
            futs = [ctl.submit(ids, max_new_tokens=mn, sampling=sp,
                               seed=800 + i, constraint=c)
                    for i, (ids, sp, c, mn) in enumerate(reqs)]
            control = [f.result(timeout=300) for f in futs]
        _ELASTIC_CONTROLS[seed] = control

    all_workers: list = []   # every (server, scheduler) pair, for cleanup
    live: Dict[str, ReplicaServer] = {}  # role -> newest live worker

    def spawn_worker(role):
        sched = make_sched(role)
        sched.start()
        srv = ReplicaServer(sched, constraint_resolver=resolver)
        all_workers.append((srv, sched))
        live[role] = srv
        return srv

    def transport_to(srv, label):
        return SocketTransport(
            srv.address, label=label,
            retry_policy=RetryPolicy(max_attempts=2, base_delay_s=0.001,
                                     max_delay_s=0.01),
            rpc_timeout_s=5.0,
        )

    spawn_worker("prefill")
    spawn_worker("decode")
    rebuilt: list = []

    def rebuild(i):
        # A targeted restart reconnects to the CURRENT worker of that
        # role — the replacement host after a SIGKILL.
        rebuilt.append(i)
        role = "prefill" if i == 0 else "decode"
        return transport_to(live[role], f"r{i}")

    def make_pool():
        return SchedulerPool(
            [transport_to(live["prefill"], "r0"),
             transport_to(live["decode"], "r1")],
            factory=rebuild, max_restarts=3,
            restart_policy=RetryPolicy(max_attempts=4, base_delay_s=0.001,
                                       max_delay_s=0.05),
            rng=_random.Random(seed), lease_s=0.05, lease_misses=2,
        )

    sup = SupervisedScheduler(
        make_pool, max_restarts=3,
        restart_policy=RetryPolicy(max_attempts=4, base_delay_s=0.001,
                                   max_delay_s=0.05),
        rng=_random.Random(seed),
    ).start()
    # Pushed CONSTRAINED handoffs recompile their wire spec through the
    # fleet seam (pool._fleet_constraint -> supervisor -> this).
    sup.constraint_resolver = resolver
    pool = sup._inner

    def spawn_standby():
        return transport_to(spawn_worker("decode"), "r2")

    def submit_all(n=1):
        streams = [[] for _ in range(n * len(reqs))]
        futs = []
        for r in range(n):
            for i, (ids, sp, c, mn) in enumerate(reqs):
                j = r * len(reqs) + i
                futs.append(sup.submit(
                    ids, max_new_tokens=mn, sampling=sp, seed=800 + i,
                    constraint=c, on_token=streams[j].append))
        return futs, streams

    def settle(futs, streams, n=1):
        outs = []
        for f in futs:
            try:
                outs.append(f.result(timeout=300))
            except Exception:  # noqa: BLE001 — lost, counted below
                outs.append(None)
        want = control * n
        return {
            "requests": len(futs),
            "lost": sum(1 for o in outs if o is None),
            "mismatched": sum(1 for o, c in zip(outs, want)
                              if o is not None and o != c),
            # Exactly-once streaming: every delivered stream must be a
            # PREFIX of its final result.
            "stream_violations": sum(1 for s, o in zip(streams, outs)
                                     if o is not None and s != o[: len(s)]),
        }

    waves: Dict[str, Dict] = {}
    auto = FleetAutoscaler(
        pool, spawn_standby, fleet_min=2, fleet_max=3, scale_up_q=1.0,
        scale_down_q=-1.0, hold_s=0.0, interval_s=0.0,
        drain_deadline_s=10.0,
    )
    auto2 = FleetAutoscaler(
        pool, spawn_standby, fleet_min=2, fleet_max=6, scale_up_q=0.0,
        scale_down_q=-1.0, hold_s=0.0, interval_s=0.0,
    )
    try:
        # Leg 1 — burst -> scale-up, stepped on an explicit clock while
        # the burst is in flight (the queued EWMA crosses the threshold
        # as soon as a ping digest refreshes the remote backlog).
        futs, streams = submit_all(n=2)
        t, fired = 0.0, None
        step_deadline = _time.monotonic() + 120.0
        while fired != "up" and _time.monotonic() < step_deadline:
            fired = auto.step(t)
            t += 0.05
            _time.sleep(0.02)
        waves["burst"] = settle(futs, streams, n=2)
        size_after_up = int(pool.fleet_stats()["size"])

        # Leg 2 — partition during scale-up: the spawn attempt fails
        # like an unreachable standby host; a counted non-event.
        FAULTS.configure("fleet:spawn:1", seed)
        auto2.step(0.0)
        FAULTS.clear()
        size_after_fail = int(pool.fleet_stats()["size"])

        # Leg 3 — SIGKILL the remote prefill worker the moment a NEW
        # push of this wave is in flight. The replacement worker is
        # spawned BEFORE the kill: the pool's live transport still
        # targets the old address (nothing places on the standby until
        # the rebuild), but the lease-expiry rebuild finds an
        # already-accepting host on its FIRST attempt — spawning after
        # the kill races scheduler boot against the restart budget and
        # can exhaust it into a spurious whole-pool escalation.
        h0 = sup.health()
        r_before = {r["replica"]: int(r.get("restarts", 0))
                    for r in h0.get("replicas", [])}
        pushed_before = int(pool.fleet_stats()["pushed"])
        pf_srv, pf_sched = all_workers[0]
        spawn_worker("prefill")
        futs, streams = submit_all()
        kill_deadline = _time.monotonic() + 60.0
        while (int(pool.fleet_stats()["pushed"]) == pushed_before
               and not all(f.done() for f in futs)
               and _time.monotonic() < kill_deadline):
            _time.sleep(0.002)
        pf_srv.close()
        pf_sched.shutdown()
        waves["kill"] = settle(futs, streams)
        heal_deadline = _time.monotonic() + 30.0
        h = sup.health()
        while _time.monotonic() < heal_deadline:
            reps = {r["replica"]: r for r in h.get("replicas", [])}
            r0 = reps.get("r0", {})
            if (int(r0.get("restarts", 0)) > r_before.get("r0", 0)
                    and r0.get("state") in ("ready", "degraded")):
                break
            _time.sleep(0.02)
            h = sup.health()
        reps = {r["replica"]: r for r in h.get("replicas", [])}

        # Leg 4 — forced scale-down racing the in-flight wave: the
        # drain re-places the elastic worker's work onto the siblings.
        futs, streams = submit_all()
        retired = pool.retire_replica(deadline_s=10.0)
        waves["retire"] = settle(futs, streams)

        fl = pool.fleet_stats()
        ring_kinds = {r.get("kind") for r in pool.flight_snapshot()}
        health_final = sup.health()
    finally:
        FAULTS.clear()
        sup.shutdown()
        for srv, sched in all_workers:
            srv.close()
            sched.shutdown()

    report = {
        "requests": sum(w["requests"] for w in waves.values()),
        "request_classes": ["greedy", "sampled", "constrained", "greedy"],
        "waves": waves,
        "pushed_handoffs": int(fl["pushed"]),
        "scale_ups": int(auto.stats()["ups"]),
        "spawn_failures": int(auto2.stats()["spawn_failures"]),
        "size_after_scale_up": size_after_up,
        "size_after_spawn_failure": size_after_fail,
        "retired": (retired or {}).get("replica"),
        "joins": int(fl["joins"]),
        "retires": int(fl["retires"]),
        "prefill_restarts": int(reps.get("r0", {}).get("restarts", 0))
        - r_before.get("r0", 0),
        "sibling_restarts": sum(
            int(reps.get(lbl, {}).get("restarts", 0)) - r_before.get(lbl, 0)
            for lbl in ("r1", "r2")),
        "pool_restarts": int(health_final["restarts"]),
        "lost": sum(w["lost"] for w in waves.values()),
        "mismatched": sum(w["mismatched"] for w in waves.values()),
        "stream_violations": sum(w["stream_violations"]
                                 for w in waves.values()),
        "fleet_serving": int(fl["serving"]),
    }
    assert report["scale_ups"] >= 1 and size_after_up == 3, (
        "the burst never scaled the fleet up — the queue-EWMA signal or "
        "the join path is broken"
    )
    assert report["pushed_handoffs"] >= 1, (
        "no handoff was PUSHED through the wire — the pump never ran; "
        "everything fell back to decode-in-place and the stage proved "
        "nothing"
    )
    assert report["spawn_failures"] == 1, (
        "fleet:spawn never fired — the partition-during-scale-up path "
        "was not exercised"
    )
    assert size_after_fail == size_after_up, (
        "a FAILED spawn changed the fleet size — the degraded path must "
        "keep serving at the current membership"
    )
    assert report["prefill_restarts"] >= 1, (
        "killing the remote prefill worker never expired its lease — "
        "the SIGKILL was not detected"
    )
    assert report["sibling_restarts"] == 0, (
        f"{report['sibling_restarts']} sibling restart(s): the prefill "
        f"worker's death escalated beyond its own replica"
    )
    assert report["pool_restarts"] == 0, (
        "the SUPERVISOR's whole-pool restart fired for a single-worker "
        "death — recovery must stay targeted"
    )
    assert report["retired"] is not None and report["retires"] == 1, (
        "retire_replica retired nothing — the elastic worker was not "
        "eligible for scale-down"
    )
    assert report["fleet_serving"] == 2, (
        f"{report['fleet_serving']} serving replicas after scale-down — "
        f"expected the base fleet of 2"
    )
    assert report["lost"] == 0, (
        f"{report['lost']} request(s) lost across scale-up, spawn "
        f"failure, worker SIGKILL and scale-down — elastic membership "
        f"shed acknowledged work"
    )
    assert report["mismatched"] == 0, (
        f"{report['mismatched']} request(s) diverged from the fault-free "
        f"control — the elastic fleet is not token-identical"
    )
    assert report["stream_violations"] == 0, (
        f"{report['stream_violations']} stream(s) delivered duplicated/"
        f"reordered tokens across the membership churn"
    )
    assert "replica_join" in ring_kinds and "replica_retire" in ring_kinds, (
        "the pool's flight ring carries no join/retire lifecycle events"
    )
    _ELASTIC_REPORTS[seed] = report
    return report


_QOS_REPORTS: Dict[int, Dict] = {}


def _run_qos_stage(seed: int, device=None) -> Dict:
    """Multi-tenant storm chaos: tenant A floods a REAL tiny
    paged scheduler with long-prompt batch requests (the harness-scale
    stand-in for the 100k-token-prompt storm) while tenant B submits a
    few short interactive requests behind the backlog. With QoS on
    (WFQ at admission + `_page_wait`), B's p95 TTFT must stay within
    tolerance of a storm-free control while A absorbs the degradation
    (A's p95 ≥ B's p95); zero acknowledged requests lost. A second
    drive with `LSOT_QOS=0` reconciles at the TOKEN level: the
    off-switch run's outputs must be identical per request (per-request
    seeded RNG makes tokens order-independent — any divergence means
    the off path executed QoS code), and the scheduler must report no
    QoS state at all. Own injection-free scope; builds tiny
    schedulers on `device` like the pressure/disagg stages; the report is
    cached per seed so repeated run_chaos calls pay the builds once."""
    cached = _QOS_REPORTS.get(seed)
    if cached is not None:
        return cached
    import os as _os
    import time as _time


    from ..ops.sampling import SamplingParams
    from ..serve.scheduler import ContinuousBatchingScheduler

    cfg, params = _tiny(seed, device)

    # Tenant A's storm: long prompts, decode-heavy; tenant B: short
    # interactive probes. Every request is greedy with its own seed, so
    # outputs are pure functions of (ids, max_new, seed) — the token
    # reconciliation anchor.
    storm = [([1] + [3 + (i + j) % 7 for j in range(40)], 24, 500 + i)
             for i in range(6)]
    quiet = [([1, 5, 9], 8, 900), ([1, 7, 11], 8, 901)]

    def drive(qos_on: bool, include_storm: bool):
        saved = _os.environ.get("LSOT_QOS")
        _os.environ["LSOT_QOS"] = "1" if qos_on else "0"
        try:
            sched = ContinuousBatchingScheduler(
                cfg, params, num_slots=2, decode_chunk=4,
                prompt_bucket=8, stop_ids=(2,), max_seq=96,
                kv_layout="paged", kv_page_size=8, kv_pages=24, device=device,
            )
        finally:
            if saved is None:
                _os.environ.pop("LSOT_QOS", None)
            else:
                _os.environ["LSOT_QOS"] = saved
        ttft: Dict[str, float] = {}
        outs: Dict[str, object] = {}
        with sched:
            subs = []
            if include_storm:
                subs += [(f"a{i}", "stormy", "batch", ids, mn, sd)
                         for i, (ids, mn, sd) in enumerate(storm)]
            subs += [(f"b{i}", "quiet", "interactive", ids, mn, sd)
                     for i, (ids, mn, sd) in enumerate(quiet)]
            t0 = _time.perf_counter()

            def tap(key):
                def on_token(_tok, _key=key):
                    ttft.setdefault(_key, _time.perf_counter() - t0)
                return on_token

            futs = [
                (key, sched.submit(
                    ids, max_new_tokens=mn, sampling=SamplingParams(),
                    seed=sd, on_token=tap(key), tenant=tenant, qos=qos))
                for key, tenant, qos, ids, mn, sd in subs
            ]
            for key, f in futs:
                try:
                    outs[key] = f.result(timeout=300)
                except Exception:  # noqa: BLE001 — lost, counted below
                    outs[key] = None
            qstats = sched.qos_stats()
        return outs, ttft, qstats

    def p95(vals):
        vals = sorted(vals)
        return vals[max(0, int(0.95 * len(vals)) - (1 if len(vals) else 0))] \
            if vals else 0.0

    # Storm-free control: tenant B alone — the baseline its stormy-run
    # TTFT is held against.
    control_outs, control_ttft, _ = drive(qos_on=True, include_storm=False)
    storm_outs, storm_ttft, qstats = drive(qos_on=True, include_storm=True)
    off_outs, _off_ttft, off_qstats = drive(qos_on=False,
                                            include_storm=True)

    lost = sum(1 for o in storm_outs.values() if o is None)
    lost += sum(1 for o in control_outs.values() if o is None)
    lost += sum(1 for o in off_outs.values() if o is None)
    mismatched = sum(
        1 for k in storm_outs
        if storm_outs[k] is not None and off_outs.get(k) is not None
        and storm_outs[k] != off_outs[k]
    )
    mismatched += sum(
        1 for k in control_outs
        if control_outs[k] is not None and storm_outs.get(k) is not None
        and control_outs[k] != storm_outs[k]
    )
    control_p95 = p95([control_ttft[k] for k in control_ttft])
    quiet_p95 = p95([v for k, v in storm_ttft.items()
                     if k.startswith("b")])
    stormy_p95 = p95([v for k, v in storm_ttft.items()
                      if k.startswith("a")])
    report = {
        "storm_requests": len(storm),
        "quiet_requests": len(quiet),
        "lost": lost,
        "mismatched": mismatched,
        "control_p95_ttft_s": round(control_p95, 4),
        "quiet_p95_ttft_s": round(quiet_p95, 4),
        "stormy_p95_ttft_s": round(stormy_p95, 4),
        "qos_off_state_clean": off_qstats is None,
        "tenants_tracked": sorted((qstats or {}).get("submitted", {})),
    }
    assert lost == 0, (
        f"{lost} request(s) never completed across the tenant storm "
        f"drives — the front door lost acknowledged work"
    )
    assert mismatched == 0, (
        f"{mismatched} request(s) diverged between QoS-on, QoS-off and "
        f"control drives — tenant isolation broke the token-level "
        f"determinism contract"
    )
    assert off_qstats is None, (
        "LSOT_QOS=0 scheduler still reports QoS state — the off-switch "
        "is not reproducing the pre-QoS path"
    )
    # Isolation contract: the storm moves tenant A's p95, not B's. The
    # tolerance is generous (host-timing noise on shared CI), but FIFO
    # head-of-line blocking fails it by an order of magnitude: B behind
    # A's whole backlog would wait the storm's full decode wall.
    tol = max(3.0 * control_p95, control_p95 + 1.0)
    assert quiet_p95 <= tol, (
        f"quiet tenant p95 TTFT {quiet_p95:.3f}s exceeds tolerance "
        f"{tol:.3f}s (storm-free control {control_p95:.3f}s) — the storm "
        f"tenant head-of-line-blocked the interactive tenant"
    )
    assert stormy_p95 >= quiet_p95, (
        f"storm tenant p95 TTFT {stormy_p95:.3f}s beat the quiet "
        f"tenant's {quiet_p95:.3f}s — the degradation landed on the "
        f"wrong tenant"
    )
    _QOS_REPORTS[seed] = report
    return report


_REPAIR_REPORTS: Dict[int, Dict] = {}


def _run_repair_stage(seed: int) -> Dict:
    """Self-healing SQL chaos: the execute→diagnose→repair
    loop under per-class fault injection, through the REAL pipeline
    (app/pipeline.Pipeline + app/repair.RepairEngine + ResilientSQLBackend
    over SQLite with the taxi fixture). Host-only; four parts:

    A. **repaired** — the SQL model emits broken SQL one-shot and the
       corrected query on repair prompts: every request must come back
       `ok` with exactly one repair round charged.
    B. **per-class bounded termination** — each `sql:*` fault site fires
       on EVERY execute (p=1, the unrepairable worst case): every
       request must terminate TYPED (diagnosed error + explain fallback,
       never a hang or an escape) within LSOT_REPAIR_MAX_ROUNDS rounds,
       with the right taxonomy class counted.
    C. **LSOT_REPAIR=0 off-switch** — the same broken-SQL traffic with
       repair disabled must reproduce the pre-repair failure path bit
       for bit: the raw engine error + explainer answer, exactly one SQL
       generate + one explain model call, no repair status stage, zero
       movement on every repair counter.
    D. **non-repair traffic untouched** — clean traffic (correct SQL
       one-shot) under repair=on must be token-identical to a
       repair-off control, with zero repair counters moved and the same
       single model call.
    """
    cached = _REPAIR_REPORTS.get(seed)
    if cached is not None:
        return dict(cached)
    import tempfile
    from pathlib import Path as _Path

    from ..app.config import AppConfig
    from ..app.pipeline import ST_REPAIR, Pipeline
    from ..serve.backends import FakeBackend
    from ..serve.service import GenerationService
    from ..sql.sqlite_backend import SQLiteBackend
    from ..utils.faults import FAULTS
    from ..utils.observability import repair as repair_counters
    from .fixtures import write_taxi_fixture_csv

    BROKEN = "SELEC * FORM temp_view"
    GOOD = "SELECT COUNT(*) FROM temp_view"
    EXPLAIN = "Check that the referenced columns exist in the schema."
    REPAIR_MARKER = "failed with this error"

    def build(sql_fn, repair_on: bool, out_dir: str):
        svc = GenerationService()
        sqlgen = FakeBackend(sql_fn)
        expl = FakeBackend(lambda p: EXPLAIN)
        svc.register("duckdb-nsql", sqlgen)
        svc.register("llama3.2", expl)
        cfg = AppConfig(
            repair=repair_on, repair_max_rounds=2, repair_backoff_s=0.0,
            # High SQL breaker threshold: part B's persistent transient
            # faults must reach the CLASSIFIER every round, not flip the
            # engine breaker into CircuitOpen mid-stage.
            breaker_threshold=100,
            output_dir=out_dir, history_db=":memory:",
        )
        return Pipeline(svc, SQLiteBackend, None, cfg), sqlgen, expl

    def delta(before):
        now = repair_counters.snapshot()
        return {k: v - before.get(k, 0)
                for k, v in now.items() if v != before.get(k, 0)}

    lost = 0
    report: Dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = str(_Path(tmp) / "taxi.csv")
        write_taxi_fixture_csv(csv_path)
        out_dir = str(_Path(tmp) / "out")
        _Path(out_dir).mkdir()

        def broken_then_fixed(p):
            return GOOD if REPAIR_MARKER in p else BROKEN

        # Part A — clean repaired path: broken one-shot, fixed on repair.
        pipe, sqlgen, _ = build(broken_then_fixed, True, out_dir)
        requests = 3
        before = repair_counters.snapshot()
        statuses: list = []
        repaired_ok = 0
        for _ in range(requests):
            try:
                res = pipe.run(csv_path, "How many rows are there?",
                               status=lambda s, m: statuses.append(m))
            except Exception:  # noqa: BLE001 — an escape IS the lost case
                lost += 1
                continue
            if res.ok and res.sql_query == GOOD:
                repaired_ok += 1
            elif not res.error_message:
                lost += 1
        d = delta(before)
        assert repaired_ok == requests, (
            f"only {repaired_ok}/{requests} broken-SQL requests came back "
            f"repaired"
        )
        assert d.get("repaired", 0) == requests, (
            f"repaired counter moved {d.get('repaired', 0)}, "
            f"expected {requests}"
        )
        assert d.get("repair_rounds", 0) == requests, (
            "each repaired request should charge exactly one round, got "
            f"{d.get('repair_rounds', 0)} for {requests} requests"
        )
        assert ST_REPAIR in statuses, (
            "the repair stage never surfaced in the status feed"
        )
        report["repaired"] = {"requests": requests, "ok": repaired_ok,
                              "rounds": d.get("repair_rounds", 0)}

        # Part B — per-class bounded termination: every execute (initial
        # AND every repair re-execute) raises the class's representative
        # engine error; the loop must stop typed within max_rounds. Own
        # injection scope per class.
        per_class: Dict[str, Dict] = {}
        for site in ("sql:syntax", "sql:schema", "sql:transient"):
            cls_name = site.rpartition(":")[2]
            pipe, sqlgen, expl = build(lambda p: GOOD, True, out_dir)
            before = repair_counters.snapshot()
            FAULTS.configure(f"{site}:1", seed)
            try:
                res = pipe.run(csv_path, "How many rows are there?")
            except Exception:  # noqa: BLE001 — an escape IS the lost case
                lost += 1
                res = None
            finally:
                FAULTS.clear()
            d = delta(before)
            terminal_typed = (
                res is not None and not res.ok
                and bool(res.error_message) and bool(res.error_solution)
            )
            assert terminal_typed, (
                f"{site}: request did not terminate typed "
                f"(res={res and (res.ok, res.error_message)})"
            )
            assert d.get("repair_rounds", 0) <= 2, (
                f"{site}: {d.get('repair_rounds', 0)} rounds exceeds "
                f"LSOT_REPAIR_MAX_ROUNDS=2"
            )
            assert d.get(f"diagnosed_{cls_name}", 0) >= 1, (
                f"{site}: taxonomy counted {d} — no diagnosed_{cls_name}"
            )
            per_class[cls_name] = {
                "terminal_typed": terminal_typed,
                "rounds": d.get("repair_rounds", 0),
                "diagnosed": d.get(f"diagnosed_{cls_name}", 0),
            }
        report["per_class"] = per_class

        # Part C — off-switch: repair=0 reproduces the pre-repair failure
        # path bit for bit (raw engine error + explainer answer, one SQL
        # generate + one explain call, no repair stage, counters frozen).
        pipe, sqlgen, expl = build(broken_then_fixed, False, out_dir)
        before = repair_counters.snapshot()
        statuses_off: list = []
        try:
            res_off = pipe.run(csv_path, "How many rows are there?",
                               status=lambda s, m: statuses_off.append(m))
        except Exception:  # noqa: BLE001
            lost += 1
            res_off = None
        d = delta(before)
        assert res_off is not None and not res_off.ok
        assert "syntax error" in res_off.error_message.lower()
        assert res_off.error_solution == EXPLAIN
        assert len(sqlgen.calls) == 1 and len(expl.calls) == 1, (
            f"repair-off made {len(sqlgen.calls)} SQL + {len(expl.calls)} "
            f"explain model calls; pre-repair behavior is exactly 1 + 1"
        )
        assert ST_REPAIR not in statuses_off
        assert d == {}, f"repair-off moved repair counters: {d}"
        report["repair_off"] = {"identical": True,
                                "model_calls": len(sqlgen.calls)
                                + len(expl.calls)}

        # Part D — non-repair traffic: clean requests under repair=on are
        # token-identical to a repair-off control, zero repair counters.
        pipe_on, gen_on, _ = build(lambda p: GOOD, True, out_dir)
        pipe_ctl, gen_ctl, _ = build(lambda p: GOOD, False, out_dir)
        before = repair_counters.snapshot()
        try:
            res_on = pipe_on.run(csv_path, "How many rows are there?")
            res_ctl = pipe_ctl.run(csv_path, "How many rows are there?")
        except Exception:  # noqa: BLE001
            lost += 1
            res_on = res_ctl = None
        d = delta(before)
        assert res_on is not None and res_on.ok and res_ctl.ok
        assert res_on.sql_query == res_ctl.sql_query == GOOD, (
            "repair=on perturbed clean traffic's generated tokens"
        )
        assert len(gen_on.calls) == len(gen_ctl.calls) == 1
        assert gen_on.calls == gen_ctl.calls, (
            "repair=on perturbed the clean request's rendered prompt"
        )
        assert d == {}, f"clean traffic moved repair counters: {d}"
        report["clean"] = {"identical": True}

    report["lost"] = lost
    _REPAIR_REPORTS[seed] = report
    return dict(report)


def run_chaos(
    spec: Optional[str] = None,
    seed: int = 0,
    rounds: int = 4,
    max_new_tokens: int = 64,
    device=None,
) -> Dict:
    """Drive the fixture suite `rounds` times under the injection spec,
    then the supervised-scheduler crash stage; return the outcome
    histogram + the scheduler's restart/replay/lost counts + counter
    deltas. Raises AssertionError if any request fails to reach a
    terminal state (zero-hung) or any acknowledged scheduler request is
    lost across crashes (zero-lost) — a chaos run that hangs or loses
    work is the bug it exists to catch. Stages 5-9 build their schedulers
    on `device` (default: the card; it raises without one before any
    stage runs)."""
    import random
    import tempfile

    from ..serve.ollama_client import OllamaClientService
    from ..serve.resilience import (
        CircuitBreaker,
        CircuitOpen,
        Overloaded,
        RetryPolicy,
    )
    from ..sql.backend import ResilientSQLBackend
    from ..sql.sqlite_backend import SQLiteBackend
    from ..utils.faults import FAULTS
    from ..utils.observability import resilience
    from .fixtures import (
        FOUR_QUERY_SUITE,
        TAXI_DDL_SYSTEM,
        write_taxi_fixture_csv,
    )

    from .. import resolve_device

    resolve_device(device)
    spec = spec if spec is not None else DEFAULT_SPEC
    # Each stage's wall seconds (the port's addition to the report; wall
    # clock, like `latency`, so outside the seeded-replay contract).
    stage_s: Dict[str, float] = {}
    clock = time.perf_counter
    t_stage = clock()
    FAULTS.configure(spec, seed)
    before = resilience.snapshot()

    srv, url = _fake_ollama_daemon(
        {c.nl: c.expected_sql for c in FOUR_QUERY_SUITE}
    )
    # Millisecond backoffs: chaos runs exercise the retry LOGIC, not
    # production sleep budgets; seeded jitter keeps the schedule replayable.
    svc = OllamaClientService(
        url, timeout_s=10.0,
        retry=RetryPolicy(max_attempts=3, base_delay_s=0.001,
                          max_delay_s=0.01),
        breaker=CircuitBreaker("ollama", failure_threshold=3,
                               reset_after_s=0.05),
    )
    svc._rng = random.Random(seed)

    sql = ResilientSQLBackend(
        SQLiteBackend(),
        retry=RetryPolicy(max_attempts=3, base_delay_s=0.001,
                          max_delay_s=0.01),
        # reset_after longer than a few requests' wall: once tripped, the
        # breaker stays open across requests and the report shows real
        # sheds, not a probe-per-request flutter.
        breaker=CircuitBreaker("sql", failure_threshold=3,
                               reset_after_s=0.5),
        rng=random.Random(seed),
    )
    with tempfile.NamedTemporaryFile(suffix=".csv") as f:
        write_taxi_fixture_csv(f.name)
        # Load once, outside injection scope concerns: the suite queries
        # the view `taxi` (sql:load faults are exercised by the unit
        # tests; chaos mode targets the per-request boundaries).
        sql.inner.load_csv(f.name, "taxi")

    outcomes = {"ok": 0, "ok_after_retry": 0, "shed": 0, "degraded": 0,
                "connect_failed": 0}
    try:
        for _ in range(rounds):
            for case in FOUR_QUERY_SUITE:
                retries_before = resilience.get("retries")
                try:
                    res = svc.generate(
                        "duckdb-nsql", case.nl, system=TAXI_DDL_SYSTEM,
                        max_new_tokens=max_new_tokens,
                    )
                    generated = res.response
                except (CircuitOpen, Overloaded):
                    # Typed shed: the client is told to back off — in the
                    # HTTP apps this is the 429/503 + Retry-After path.
                    outcomes["shed"] += 1
                    continue
                except RuntimeError:
                    # Connect failure that survived the whole retry ladder:
                    # typed, attributed, non-hanging.
                    outcomes["connect_failed"] += 1
                    continue
                try:
                    sql.execute(generated)
                except CircuitOpen:
                    # The SQL breaker is open: the request shed without
                    # touching the engine (503 + Retry-After in the apps).
                    outcomes["shed"] += 1
                    continue
                except Exception as e:  # noqa: BLE001 — any SQL failure
                    # The §2.2 degradation: the request is still ANSWERED,
                    # with the engine error where the result would be —
                    # exactly what pipeline.explain_error falls back to
                    # when the error model is down too.
                    assert str(e)
                    outcomes["degraded"] += 1
                    continue
                if resilience.get("retries") > retries_before:
                    outcomes["ok_after_retry"] += 1
                else:
                    outcomes["ok"] += 1
        # Stage 2 — crash recovery: a supervised scheduler under the
        # spec's `sched:crash` site must lose ZERO acknowledged requests
        # across however many mid-batch loop deaths the schedule injects
        # (runs inside the injection scope: same seeded stream).
        stage_s["suite"] = round(clock() - t_stage, 3)
        t_stage = clock()
        scheduler_report = _run_scheduler_stage(seed, requests=3 * rounds)
        stage_s["scheduler"] = round(clock() - t_stage, 3)
    finally:
        srv.shutdown()
        fault_counts = FAULTS.counts()  # clear()/reconfigure wipes them
        FAULTS.clear()

    after = resilience.snapshot()

    # Stage 3 — hang detection: a duration-valued `sched:hang` wedges a
    # supervised loop mid-batch; the watchdog must detect the stale
    # heartbeat, escalate, restart, and replay — zero silently-hung
    # clients. Runs in its OWN injection scope (the hang spec must not
    # perturb the main stages' seeded schedule) AND outside the
    # before/after resilience snapshot pair, so its fault/stall/restart
    # counts stay inside its report rather than polluting the
    # spec-driven `resilience_delta` and `faults` tallies the main
    # stages reconcile against.
    t_stage = clock()
    watchdog_report = _run_hang_stage(seed)
    stage_s["watchdog"] = round(clock() - t_stage, 3)
    # Stage 4 — fleet: a supervised POOL with one replica wedged via the
    # replica-addressable `sched:wedge_r1` site. The watchdog must
    # attribute the stall, restart ONLY that replica (sibling restart
    # counters zero, no whole-pool restart), re-place its journaled
    # requests onto the siblings, and every client must resolve with the
    # wedge-free control outputs — zero lost acknowledged requests. Own
    # injection scope, outside the snapshot pair, like stage 3.
    t_stage = clock()
    fleet_report = _run_fleet_stage(seed)
    stage_s["fleet"] = round(clock() - t_stage, 3)
    # Stage 5 — KV-page pressure: the REAL paged scheduler under a
    # `kv:pressure` storm (the value-valued site withholds pool pages, so
    # overcommitted top-ups fail and victims preempt). Every request must
    # complete token-identical to a pressure-free control — greedy,
    # sampled AND constrained — with ≥1 preemption actually fired. Own
    # injection scope, outside the snapshot pair, like stages 3-4. This
    # stage is the first to build a tiny scheduler on `device`.
    t_stage = clock()
    pressure_report = _run_pressure_stage(seed, device=device)
    stage_s["kv_pressure"] = round(clock() - t_stage, 3)
    # Stage 6 — disaggregated serving: a supervised phase-split fleet
    # (prefill + decode replicas, real tiny paged schedulers) must
    # migrate every request through the KV handoff token-identical to a
    # mixed-replica control, and survive a `sched:handoff` crash that
    # kills the prefill replica mid-handoff — targeted restart, journal
    # re-placement onto the decode sibling, zero lost. Own injection
    # scope, outside the snapshot pair, like stages 3-5.
    t_stage = clock()
    disagg_report = _run_disagg_stage(seed, device=device)
    stage_s["disagg"] = round(clock() - t_stage, 3)
    # Stage 7 — network transport: a supervised fleet of real tiny
    # schedulers behind LOOPBACK transports (the socket transport's rpc
    # envelope without the second process) under each net fault class —
    # lost responses retried and deduped by the idempotency-token
    # ledger (exactly-once execution proven by scheduler-side submit
    # counts), duplicated deliveries absorbed, wire delays ridden out,
    # and a partition of r1 detected by LEASE expiry with ONLY r1
    # restarted and its journaled work re-placed on r0 — every wave
    # token-identical to a fault-free control, zero lost, zero
    # duplicated stream tokens. Own injection scope, like stages 3-6.
    t_stage = clock()
    net_report = _run_net_stage(seed, device=device)
    stage_s["transport"] = round(clock() - t_stage, 3)
    # Stage 8 — elastic membership: an all-remote phase-split fleet
    # (real socket workers) under the full membership chaos menu —
    # burst-driven scale-up, an injected `fleet:spawn` failure standing
    # in for a partition during scale-up, SIGKILL of the remote prefill
    # worker mid-handoff, and a forced scale-down racing in-flight
    # streams — every wave token-identical to a fault-free control,
    # zero lost, zero duplicated stream tokens, only the affected
    # replica restarted. Own injection scope, like stages 3-7.
    t_stage = clock()
    elastic_report = _run_elastic_stage(seed, device=device)
    stage_s["elastic"] = round(clock() - t_stage, 3)
    # Stage 9 — multi-tenant storm: tenant A floods a real paged
    # scheduler with long-prompt batch requests while tenant B's
    # interactive probes arrive behind the backlog — WFQ must keep B's
    # p95 TTFT within tolerance of a storm-free control while A absorbs
    # the degradation; zero lost; an LSOT_QOS=0 drive reconciles
    # token-for-token (off-switch discipline). Own injection-free scope.
    t_stage = clock()
    qos_report = _run_qos_stage(seed, device=device)
    stage_s["qos"] = round(clock() - t_stage, 3)
    # Stage 10 — self-healing SQL: the real pipeline's
    # execute→diagnose→repair loop under per-class `sql:*` injection —
    # broken SQL repaired in bounded rounds, every persistent-fault
    # request terminating typed within LSOT_REPAIR_MAX_ROUNDS,
    # LSOT_REPAIR=0 reproducing the pre-repair path bit for bit, and
    # clean traffic token-identical to a repair-off control. Own
    # injection scopes per fault class, host-only, outside the snapshot
    # pair like stages 3-9.
    t_stage = clock()
    repair_report = _run_repair_stage(seed)
    stage_s["repair"] = round(clock() - t_stage, 3)
    requests = rounds * len(FOUR_QUERY_SUITE)
    hung = requests - sum(outcomes.values())
    hung += scheduler_report["unresolved"]
    hung += watchdog_report["unresolved"]
    hung += fleet_report["unresolved"]
    hung += pressure_report["lost"]
    hung += disagg_report["lost"]
    hung += sum(w["lost"] for w in net_report["waves"].values())
    hung += elastic_report["lost"]
    hung += qos_report["lost"]
    hung += repair_report["lost"]
    assert hung == 0, f"{hung} request(s) never reached a terminal state"
    # Wall-clock figures are non-deterministic by nature: lifted OUT of
    # the scheduler stage's report so the seeded-replay determinism
    # contract (same spec+seed → same outcome fields) stays exact.
    latency = scheduler_report.pop("latency", None)
    return {
        "spec": spec,
        "seed": seed,
        "requests": requests,
        "outcomes": outcomes,
        "hung": hung,
        "scheduler": scheduler_report,
        "watchdog": watchdog_report,
        "fleet": fleet_report,
        "kv_pressure": pressure_report,
        "disagg": disagg_report,
        "transport": net_report,
        "elastic": elastic_report,
        "qos": qos_report,
        "repair": repair_report,
        "latency": latency,
        "stage_seconds": stage_s,
        "resilience_delta": {
            k: after.get(k, 0) - before.get(k, 0)
            for k in sorted(set(before) | set(after))
            if after.get(k, 0) != before.get(k, 0)
        },
        "faults_injected": fault_counts,
    }

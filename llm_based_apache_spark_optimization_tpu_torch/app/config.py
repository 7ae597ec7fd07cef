"""Typed application config with env overrides.

The reference hard-codes every knob — I/O dirs, MySQL DSN with credentials,
model names, page size, secret key, bind address (SURVEY.md §5 "Config/flag
system": `Flask/app.py:12,19-20,28-33,214`; `FastAPI/app.py:68,118,148`).
Here they live in one frozen dataclass, overridable from the environment with
the `LSOT_` prefix.

A copy of the JAX package's `app/config.py`. The port's entry point
(`app/__main__.py`) refuses, by name, the knob of the layer it does not
have yet (the bench seed, ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class AppConfig:
    input_dir: str = "data/input"
    output_dir: str = "data/output"
    history_db: str = "data/history.db"     # sqlite path, or ":memory:"
    sql_model: str = "duckdb-nsql"          # NL→SQL generator
    error_model: str = "llama3.2"           # error-analysis explainer
    view_name: str = "temp_view"
    page_size: int = 8
    secret_key: str = "change-me"
    host: str = "127.0.0.1"
    port: int = 8000
    max_new_tokens: int = 256
    # Grammar-constrained NL→SQL (constrain/): the pipeline compiles the
    # uploaded CSV's schema into the decoder's identifier grammar, so the
    # SQL model cannot emit a column that is not in the table. Opt-in
    # (LSOT_CONSTRAIN_SQL=1): only engine/scheduler backends support it —
    # fake/demo backends would reject the request.
    constrain_sql: bool = False
    # --- fault tolerance (serve/resilience.py; README "Operating under
    # load"). All off/unbounded by default — production deployments should
    # set every one of them.
    # Scheduler admission control: submits beyond this backlog shed with a
    # typed Overloaded → HTTP 429 + Retry-After. 0 = unbounded.
    max_queue_depth: int = 0
    # Per-request latency budget in seconds, threaded request → queue →
    # decode; expiry fails typed (DeadlineExceeded → 504). 0 = none.
    deadline_s: float = 0.0
    # Circuit breaker on the SQL execution backend: consecutive INFRA
    # failures (not per-query SQL errors) before the circuit opens, and how
    # long it stays open before one half-open probe.
    breaker_threshold: int = 5
    breaker_reset_s: float = 10.0
    # Startup seed for the ENGINE backend's deadline-clamp s/token EWMA
    # (serve/backends.EngineBackend): without a seed the first request
    # after boot runs unclamped — there is nothing to exchange a deadline
    # against until one completion has been measured. LSOT_STOK_SEED is an
    # explicit seconds-per-output-token figure (wins when both are set);
    # LSOT_STOK_SEED_BENCH points at a bench artifact JSONL whose last
    # line is converted via serve.backends.stok_seed_from_bench. 0/"" =
    # unseeded (the historical behavior).
    stok_seed: float = 0.0
    stok_seed_bench: str = ""
    # --- crash recovery & lifecycle (serve/supervisor.py; README "Crash
    # recovery & lifecycle").
    # Supervisor restart budget: how many times a crashed decode loop is
    # rebuilt (with backoff) before /readyz reports "dead" and journaled
    # work fails typed.
    max_restarts: int = 5
    # SIGTERM graceful-drain budget in seconds: stop admitting, finish
    # in-flight up to this long, then journal-and-exit.
    drain_deadline_s: float = 10.0
    # Optional on-disk journal spill (JSONL): unfinished requests are
    # written here at drain/exit and recovered (resubmitted) at the next
    # start, so retried idempotency keys find their results. "" = off.
    journal_spill: str = ""
    # --- paged-KV memory pressure (kv_layout="paged"; README "Operating
    # under memory pressure"). Overcommit admission: reserve
    # min(budget, max(ratio × budget, observed-generation EWMA)) pages at
    # admission instead of the worst-case envelope; 1.0 = exact-envelope
    # (today's behavior). Decode tops pages up per harvest; a failed
    # top-up preempts a victim whose resume is token-identical
    # (recompute, or spilled host page copies with kv_spill).
    kv_overcommit: float = 1.0
    kv_spill: bool = False
    # KV-cache storage dtype ("" = compute dtype, "int8" = quantized KV —
    # README "Quantized pages"): the env twin of the --kv-int8 CLI flag
    # (the flag wins when both are set). With kv_layout="paged" the pool
    # stores int8 pages + per-position scales, so the same HBM budget
    # holds ~2x the live tokens; page accounting, watermarks and
    # overcommit all price the true int8 page bytes.
    kv_quant: str = ""
    # Free-page watermarks (fractions of the pool): under LOW, the
    # scheduler proactively evicts LRU prefix-cache pages until HIGH
    # recovers — pressure is relieved before an allocation fails. 0 = off.
    kv_watermark_low: float = 0.0
    kv_watermark_high: float = 0.0
    # Poison-request quarantine (serve/supervisor.py): a journal entry
    # replayed after more than this many crashed scheduler incarnations
    # retires typed `Quarantined` instead of burning the restart budget
    # lap after lap. Keep it BELOW max_restarts or the budget dies first;
    # 0 disables.
    max_entry_replays: int = 3
    # --- fleet serving (serve/scheduler.SchedulerPool; README "Fleet
    # serving"). dp>1 scheduler deployments run a supervised fleet of
    # replicas with per-replica lifecycle.
    # Per-REPLICA restart budget: how many times the pool rebuilds one
    # crashed/stalled replica (bounded backoff) before marking only THAT
    # replica dead — siblings keep serving. Independent of max_restarts,
    # which budgets whole-pool restarts at the supervisor.
    replica_max_restarts: int = 5
    # Placement router for the scheduler pool: "least_loaded" scores each
    # replica by queue-depth × service-time EWMA (deadline-aware, skips
    # restarting/draining replicas); "round_robin" keeps the pre-fleet
    # blind rotation.
    pool_router: str = "least_loaded"
    # Disaggregated prefill/decode serving (README "Disaggregated
    # serving"): per-replica phase roles for a dp>1 scheduler pool, e.g.
    # "prefill:1,decode:3" — prefill replicas run chunked prefill, pack
    # the KV pages into a handoff blob and retire into a handoff queue;
    # the phase-aware router places the migrated request on a decode
    # replica (falling back to decoding in place when none can take it).
    # Counts must sum to --dp; requires --kv-layout=paged. "" = every
    # replica "mixed" (today's behavior bit for bit).
    pool_phases: str = ""
    # --- multi-host fleet (serve/remote.py; README "Multi-host fleet").
    # Cache-aware routing (ISSUE 15): SchedulerPool.submit consumes the
    # PR-14 prefix-affinity feed in the placement order (affinity →
    # pressure penalty → weighted least-loaded tie-break). ON by
    # default; 0 reproduces the pre-affinity placement order bit for
    # bit (no digest lookups, no affinity flight events).
    pool_affinity: bool = True
    # Heterogeneous replica weights ("4,1,1" — one positive capacity
    # multiplier per replica index, padded with 1.0): a tp=4 replica
    # weighted 4 takes proportionally more token mass than a tp=1
    # sibling. "" = all 1.0 (the unweighted order, bit for bit).
    replica_weights: str = ""
    # --- multi-model serving (serve/modelpool.py; README "Serving
    # multiple models"). Registry spec, ";"-separated entries:
    #   model_id=source[:path][,hbm=F][,template=T][,replicas=N][,add_bos=B]
    # e.g. "duckdb-nsql=tiny,hbm=0.7;llama3.2=tiny,hbm=0.3" stands up two
    # co-resident checkpoints in ONE scheduler pool with the paged-KV
    # arena partitioned 70/30 between them. Sources: tiny (random-weight
    # proof harness), hf, gguf. "" = single-model assembly (today's
    # behavior bit for bit, including the shared-weights error-model
    # alias).
    models: str = ""
    # Model-aware placement for the scheduler pool: requests carrying a
    # model_id only place on replicas serving that checkpoint (model →
    # affinity → pressure → weighted least-loaded). 0 reproduces the
    # model-blind placement order bit for bit; requests with no model_id
    # are never affected either way.
    pool_models: bool = True
    # Remote replicas ("1=host:port,3=host:port" — replica INDEX =
    # worker address): those pool slots become SocketTransports to
    # `python -m …serve.remote` workers instead of local schedulers.
    # The lease below is their liveness authority; a dead/partitioned
    # worker's journaled work re-places on siblings with zero
    # acknowledged requests lost. "" = all replicas in-process.
    pool_remote: str = ""
    # Remote-replica lease: ping each transport replica every lease_s
    # seconds; lease_misses consecutive failures expire the lease
    # (unreachable → targeted restart → journal re-placement).
    # lease_s <= 0 disables the monitor.
    lease_s: float = 2.0
    lease_misses: int = 3
    # --- elastic fleet membership (serve/elastic.py; README "Elastic
    # fleet"). Standby `serve.remote` worker addresses
    # ("host:port,host:port"): scale-up connects the next unclaimed one
    # as a SocketTransport replica (join handshake validates page
    # geometry/model before it is placeable); scale-down rides
    # drain_replica (drain → re-place → remove, zero lost) and only
    # ever retires autoscaler-added replicas. "" = autoscaler off.
    fleet_workers: str = ""
    # Fleet size bounds: min defaults to the configured fleet size at
    # startup (never scale below what the operator stood up); max to
    # min + the standby count. -1 = those defaults.
    fleet_min: int = -1
    fleet_max: int = -1
    # Scale signals + hysteresis (per-serving-replica queued-request
    # EWMA thresholds; SLO burn and kv_pressure also trigger
    # scale-up). A direction must hold scale_hold_s continuously to
    # act; actions are spaced >= scale_interval_s (flap damping).
    scale_up_q: float = 4.0
    scale_down_q: float = 0.5
    scale_hold_s: float = 3.0
    scale_interval_s: float = 5.0
    # Push-style handoff pump (serve/remote.py): bound on the in-worker
    # unacked pushed-handoff window AND the local scheduler handoff
    # buffer — beyond it the worker decodes in place (typed
    # backpressure, never loss).
    pump_depth: int = 32
    # --- liveness / hang detection (serve/watchdog.py; README "Liveness &
    # hangs"). The supervisor's watchdog escalates a BUSY decode loop
    # whose heartbeat age exceeds
    # max(stall_min_s, stall_factor × measured round cadence) to a
    # SchedulerStalled restart — a wedge never raises, so this is the
    # only way hung requests recover. stall_min_s <= 0 disables the
    # watchdog. The floor must sit above the worst legitimate
    # host-thread occupation (a cold XLA compile of an unwarmed prefill
    # bucket blocks the loop exactly like a wedge).
    stall_factor: float = 16.0
    stall_min_s: float = 10.0
    # Warmup-aware stall floor: for this long after start()/each restart
    # — and only until the scheduler harvests its FIRST round — the
    # watchdog floor is raised to this value, so first-boot cold XLA
    # compiles (which block the loop thread exactly like a wedge) cannot
    # be escalated as hangs. 0 disables (the pre-warmed deployment /
    # library default).
    stall_warmup_s: float = 120.0
    # --- observability (utils/tracing.py, serve/flightrecorder.py,
    # README "Observability").
    # Head-sampled request tracing: the fraction of requests whose span
    # tree (queue-wait, prefill, per-decode-round, SQL exec, ...) is
    # recorded and exported. 0 = off (request ids still flow), 1 = every
    # request. Safe always-on: unsampled requests pay one RNG draw.
    trace_sample: float = 0.0
    # Export directory for sampled traces: requests.jsonl (one line per
    # request) + <request_id>.trace.json.gz (Chrome-trace format — loads
    # in Perfetto and in utils/traceprof.Trace). "" = in-memory ring only
    # (the /debug/traces endpoint still serves the last few).
    trace_export: str = ""
    # Scheduler flight-recorder ring size (per-harvested-round records
    # kept for /debug/flightrecorder and the crash/stall/SIGTERM
    # postmortem dump).
    flight_rounds: int = 256
    # Per-request JSON log-line sampling (the line MetricsRegistry.record
    # emits at INFO): 1 = every request (historical behavior), 0 = off —
    # the hot path skips the json.dumps + handler I/O entirely.
    request_log: float = 1.0
    # Prefix-cache telemetry bounds (ISSUE 14; README "Prefix-cache
    # telemetry"). How many registry entries /debug/prefixcache returns
    # per replica (top-K by token mass) and how many recent admissions
    # the reuse-distance ring remembers — both bound memory and payload
    # size, never correctness (entries carry digests, not token ids).
    prefix_topk: int = 32
    prefix_ring: int = 256
    # --- performance attribution & SLOs (utils/perfmodel.py,
    # utils/slo.py; README "Performance attribution & SLOs").
    # Rolling SLO objectives in MILLISECONDS (operator units); 0
    # disables that objective. A replica whose multi-window burn rate
    # exceeds 1 on both arms marks /readyz degraded and flags itself in
    # the pool's placement view.
    slo_ttft_ms: float = 0.0
    slo_tpot_ms: float = 0.0
    slo_queue_wait_ms: float = 0.0
    # Long evaluation window in seconds (the fast-detect arm is
    # window/12) and the good-fraction target (0.99 = 1% error budget).
    slo_window_s: float = 300.0
    slo_target: float = 0.99
    # On-demand device profiling (/debug/profile): default rounds per
    # capture, and the artifact directory ("" = next to the trace
    # export dir, else a tempdir).
    profile_rounds: int = 8
    profile_dir: str = ""
    # --- multi-tenant front door (serve/qos.py; README "Multi-tenant
    # front door"). Requests carry `tenant` + `qos`
    # (interactive|batch|replay) via X-Lsot-Tenant/X-Lsot-Qos headers or
    # JSON fields. qos=False reproduces the single-tenant admission
    # order bit for bit (no buckets, FIFO page-wait, shared prefix
    # registry).
    qos: bool = True
    # Per-(tenant, class) token-bucket budgets: "2" = 2 req/s for every
    # class, "2,interactive=4" overrides per class. "" = no rate
    # ceiling (WFQ fairness still applies). Burst defaults to 2s of
    # rate when unset.
    tenant_rate: str = ""
    tenant_burst: str = ""
    # WFQ weights ("tenantA=4,tenantB=1"); unlisted tenants weigh 1.0.
    tenant_weights: str = ""
    # Per-tenant prefix-cache namespaces: off = today's shared registry
    # bit for bit (cross-tenant prefix reuse allowed again).
    prefix_tenant_ns: bool = True
    # Per-class default deadline in seconds, applied only when the
    # request carries none ("interactive gets the tighter budget"). 0 =
    # no class default.
    qos_deadline_interactive: float = 0.0
    qos_deadline_batch: float = 0.0
    qos_deadline_replay: float = 0.0
    # --- self-healing SQL (app/repair.py; README "Self-healing SQL").
    # When a generated query fails execution, classify the engine error
    # (syntax/schema/type/resource/transient) and feed error text +
    # original question + schema back through the constrained decoder,
    # re-executing up to repair_max_rounds times. Repair rounds are
    # charged against the ORIGINAL request deadline and ride QoS class
    # `replay` under the requesting tenant. repair=False reproduces the
    # pre-repair failure path bit for bit (straight to error analysis).
    repair: bool = True
    repair_max_rounds: int = 2
    # Model the repair regenerate rides on; "" = the same sql_model that
    # produced the query. A tenant can also pin one via tenant_models.
    repair_model: str = ""
    # Exponential backoff base between repair rounds (round 2 waits
    # backoff, round 3 waits 2x backoff, ...).
    repair_backoff_s: float = 0.05
    # Breaker on the REPAIR PATH itself: this many consecutive typed
    # repair-generate failures (fleet down, overloaded) open the circuit
    # and failures degrade straight to the diagnosed error until
    # repair_breaker_reset_s passes.
    repair_breaker_threshold: int = 3
    repair_breaker_reset_s: float = 30.0
    # --- per-tenant model routing (serve/qos.parse_tenant_models;
    # README "Serving multiple models"). "tenantA=duckdb-nsql,
    # tenantB=llama3.2": requests from a listed tenant route to that
    # model_id atop the multi-model pool; unknown tenants (and tenants
    # mapped to unregistered models) fall through to the request's own
    # model. "" = no routing (today's behavior bit for bit).
    tenant_models: str = ""

    @classmethod
    def from_env(cls, **overrides) -> "AppConfig":
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        kwargs = {}
        for name in fields:
            env = os.environ.get(f"LSOT_{name.upper()}")
            if env is not None:
                default = getattr(cls, name)
                if isinstance(default, bool):
                    # bool("false") is True — parse flag strings properly.
                    kwargs[name] = env.strip().lower() in ("1", "true",
                                                           "yes", "on")
                else:
                    kwargs[name] = type(default)(env)
        kwargs.update(overrides)
        return cls(**kwargs)

    def ensure_dirs(self) -> None:
        Path(self.input_dir).mkdir(parents=True, exist_ok=True)
        Path(self.output_dir).mkdir(parents=True, exist_ok=True)
        if self.history_db != ":memory:":
            Path(self.history_db).parent.mkdir(parents=True, exist_ok=True)

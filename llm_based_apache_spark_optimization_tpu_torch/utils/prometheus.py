"""Prometheus text exposition for the /metrics payload.

A copy of the JAX package's `utils/prometheus.py`.

`/metrics?format=prometheus` renders the SAME data the JSON endpoint
serves — per-model request aggregates, serving-layer stats, process-wide
resilience counters — in the exposition format (text/plain; version
0.0.4) every scrape stack ingests, plus the fixed-bucket TTFT / TPOT /
queue-wait / latency histograms `MetricsRegistry` now keeps beside its
windowed percentiles (histograms aggregate across scrapes and replicas;
windowed percentiles cannot). Both serving systems in the vLLM/TGI
comparison (PAPERS.md) ship this surface as table stakes.

Rendering rules (no client library — the format is 20 lines of spec):

- metric names: `lsot_` + snake_case path; `# HELP`/`# TYPE` emitted once
  per name, all samples of one name contiguous (the exposition grammar
  requires it).
- per-model scalar aggregates become gauges/counters labeled
  `{model="..."}`; nested serving stats flatten with `_`-joined paths
  (`lsot_serving_prefix_cache_hits`); booleans render 0/1; non-numeric
  leaves are skipped (they stay JSON-only).
- resilience counters: `lsot_resilience_events_total{event="retries"}`;
  breaker states: `lsot_breaker_open{dependency="sql backend"}`.
- histograms: standard `_bucket{le=...}` / `_sum` / `_count` triplets
  with the model × replica × request-class label set.

The golden test (tests/test_prometheus.py) scrapes a live fake-backend
app and validates names/types/label sets with a minimal in-test parser —
no new dependency.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

from .observability import HistogramSet

__all__ = ["render_prometheus", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")

#: JSON aggregate key -> (metric suffix, TYPE). Counters keep their
#: monotonic semantics; windowed percentiles are gauges by nature.
_MODEL_KEYS = {
    "requests": ("requests_total", "counter"),
    "output_tokens": ("output_tokens_total", "counter"),
    "p50_latency_s": ("p50_latency_seconds", "gauge"),
    "p95_latency_s": ("p95_latency_seconds", "gauge"),
    "avg_decode_tok_s": ("decode_tokens_per_second", "gauge"),
    "ttft_p50_s": ("ttft_p50_seconds", "gauge"),
    "ttft_p95_s": ("ttft_p95_seconds", "gauge"),
    "queue_wait_p50_s": ("queue_wait_p50_seconds", "gauge"),
    "queue_wait_p95_s": ("queue_wait_p95_seconds", "gauge"),
}


def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _num(v) -> Optional[float]:
    """Numeric leaf or None (strings/None/lists stay JSON-only).
    bools render 0/1 — `busy`, breaker `open` flags."""
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)) and math.isfinite(v):
        return float(v)
    return None


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(v)


class _Emitter:
    """Groups samples by metric name so HELP/TYPE appear once and all
    samples of a name are contiguous (the exposition grammar)."""

    def __init__(self):
        self._order: List[str] = []
        self._meta: Dict[str, str] = {}
        self._samples: Dict[str, List[str]] = {}

    def add(self, name: str, labels: Dict[str, str], value: float,
            mtype: str = "gauge", suffix: str = "") -> None:
        name = _NAME_OK.sub("_", name)
        if name not in self._meta:
            self._order.append(name)
            self._meta[name] = mtype
            self._samples[name] = []
        self._samples[name].append(
            f"{name}{suffix}{_labels(labels)} {_fmt(value)}"
        )

    def render(self) -> str:
        out: List[str] = []
        for name in self._order:
            out.append(f"# HELP {name} lsot serving metric {name}")
            out.append(f"# TYPE {name} {self._meta[name]}")
            out.extend(self._samples[name])
        return "\n".join(out) + "\n"


def _flatten_serving(emit: _Emitter, model: str, prefix: str, node) -> None:
    """Nested serving stats -> gauges with `_`-joined names. List entries
    (e.g. per-replica heartbeat snapshots, pool load views) are labeled
    `replica` — the entry's own "replica" name when it carries one, else
    "r{i}" — the SAME vocabulary the histogram families use, so the two
    can be joined/grouped on the label."""
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten_serving(emit, model, f"{prefix}_{k}", v)
        return
    if isinstance(node, list):
        for i, v in enumerate(node):
            if isinstance(v, dict):
                name = v.get("replica")
                rep = name if isinstance(name, str) and name else f"r{i}"
                for k, inner in v.items():
                    n = _num(inner)
                    if n is not None:
                        emit.add(_NAME_OK.sub("_", f"{prefix}_{k}"),
                                 {"model": model, "replica": rep}, n)
        return
    n = _num(node)
    if n is not None:
        emit.add(_NAME_OK.sub("_", prefix), {"model": model}, n)


def _emit_perf(emit: _Emitter, model: str, perf: Dict) -> None:
    """The roofline-ledger gauges: `serving.perf` becomes
    lsot_mfu / lsot_hbm_util / lsot_perf_compute_bound labeled
    model × replica × PHASE (prefill|decode|draft|verify) — the live
    per-replica prefill/decode hardware-asymmetry signal. Accepts one
    replica's ledger ({"replica", "phases"}) or a pool's
    ({"replicas": [...]})."""
    ledgers = perf.get("replicas") if isinstance(perf.get("replicas"),
                                                 list) else [perf]
    for led in ledgers:
        if not isinstance(led, dict):
            continue
        rep = led.get("replica") or "r0"
        for k in ("peak_tflops", "peak_hbm_gbs"):
            n = _num(led.get(k))
            if n is not None:
                emit.add(f"lsot_perf_{k}", {"model": model, "replica": rep},
                         n)
        for phase, ph in (led.get("phases") or {}).items():
            if not isinstance(ph, dict):
                continue
            labels = {"model": model, "replica": rep, "phase": str(phase)}
            for key, name in (("mfu", "lsot_mfu"),
                              ("hbm_util", "lsot_hbm_util"),
                              ("tflops", "lsot_perf_tflops"),
                              ("gbs", "lsot_perf_hbm_gbs"),
                              ("rounds", "lsot_perf_rounds")):
                n = _num(ph.get(key))
                if n is not None:
                    emit.add(name, labels, n,
                             "counter" if key == "rounds" else "gauge")
            if "bound" in ph:
                emit.add("lsot_perf_compute_bound", labels,
                         1.0 if ph["bound"] == "compute-bound" else 0.0)


def _emit_handoff(emit: _Emitter, model: str, ho: Dict) -> None:
    """The prefill→decode handoff families: `serving.handoff`
    becomes lsot_handoff_* counters labeled model × replica ×
    phase_role — exports/imports/in-place fallbacks, page and byte
    volume each way, and the summed wait for a decode slot (the
    between-legs latency a disaggregated deployment tunes). Accepts one
    replica's stats dict or a pool's ({"replicas": [...]})."""
    stats = ho.get("replicas") if isinstance(ho.get("replicas"),
                                             list) else [ho]
    for rec in stats:
        if not isinstance(rec, dict):
            continue
        labels = {"model": model,
                  "replica": str(rec.get("replica") or "r0"),
                  "phase_role": str(rec.get("phase_role") or "mixed")}
        for key, name, mtype in (
                ("exports", "lsot_handoff_exports_total", "counter"),
                ("imports", "lsot_handoff_imports_total", "counter"),
                ("inplace_fallbacks",
                 "lsot_handoff_inplace_fallbacks_total", "counter"),
                ("pages_out", "lsot_handoff_pages_out_total", "counter"),
                ("pages_in", "lsot_handoff_pages_in_total", "counter"),
                ("bytes_out", "lsot_handoff_bytes_out_total", "counter"),
                ("bytes_in", "lsot_handoff_bytes_in_total", "counter"),
                ("wait_s_sum", "lsot_handoff_wait_seconds_sum", "counter"),
                ("wait_count", "lsot_handoff_wait_count", "counter"),
                ("queued_handoffs", "lsot_handoff_queued", "gauge"),
        ):
            n = _num(rec.get(key))
            if n is not None:
                emit.add(name, labels, n, mtype)


def _emit_transport(emit: _Emitter, model: str, tr: Dict) -> None:
    """The replica-transport families: `serving.transport`
    becomes lsot_transport_* counters labeled model × replica ×
    ENDPOINT (the rpc op — submit/requeue/ping/…) for the per-call
    counters, and model × replica for the lease/connection lifecycle —
    rpc volume, retries, timeouts, errors, lease misses/expiries,
    reconnects, and the 0/1 unreachable flag a partition trips. Accepts
    one transport's stats dict or a pool's ({"replicas": [...]})."""
    stats = tr.get("replicas") if isinstance(tr.get("replicas"),
                                             list) else [tr]
    for rec in stats:
        if not isinstance(rec, dict):
            continue
        rep = str(rec.get("replica") or "r0")
        for op, counters in sorted((rec.get("endpoints") or {}).items()):
            if not isinstance(counters, dict):
                continue
            labels = {"model": model, "replica": rep, "endpoint": str(op)}
            for key, name in (("rpcs", "lsot_transport_rpcs_total"),
                              ("retries", "lsot_transport_retries_total"),
                              ("timeouts", "lsot_transport_timeouts_total"),
                              ("errors", "lsot_transport_errors_total")):
                n = _num(counters.get(key))
                if n is not None:
                    emit.add(name, labels, n, "counter")
        labels = {"model": model, "replica": rep,
                  "kind": str(rec.get("kind") or "transport")}
        for key, name, mtype in (
                ("lease_misses", "lsot_transport_lease_misses", "gauge"),
                ("lease_expiries",
                 "lsot_transport_lease_expiries_total", "counter"),
                ("reconnects", "lsot_transport_reconnects_total",
                 "counter"),
                ("unreachable", "lsot_transport_unreachable", "gauge"),
        ):
            n = _num(rec.get(key))
            if n is not None:
                emit.add(name, labels, n, mtype)


def _emit_prefix(emit: _Emitter, model: str, pv: Dict) -> None:
    """The prefix-cache telemetry families: `serving.prefix`
    becomes lsot_prefix_* counters/gauges labeled model × replica —
    hits/misses/evictions/ghost-reinsertions, reused tokens, the priced
    prefill seconds the hits saved, the live hit-rate EWMA, and what the
    cache currently holds (entries / tokens / device bytes). Accepts one
    replica's block or a pool's ({"replicas": [...]})."""
    stats = pv.get("replicas") if isinstance(pv.get("replicas"),
                                             list) else [pv]
    for rec in stats:
        if not isinstance(rec, dict):
            continue
        labels = {"model": model,
                  "replica": str(rec.get("replica") or "r0")}
        for key, name, mtype in (
                ("hits", "lsot_prefix_hits_total", "counter"),
                ("misses", "lsot_prefix_misses_total", "counter"),
                ("evictions", "lsot_prefix_evictions_total", "counter"),
                ("reinserts", "lsot_prefix_reinserts_total", "counter"),
                ("reused_tokens", "lsot_prefix_reused_tokens_total",
                 "counter"),
                ("blocks_reused", "lsot_prefix_blocks_reused_total",
                 "counter"),
                ("prefill_s_saved",
                 "lsot_prefix_saved_prefill_seconds_total", "counter"),
                ("hit_rate", "lsot_prefix_hit_rate", "gauge"),
                ("hit_rate_ewma", "lsot_prefix_hit_rate_ewma", "gauge"),
                ("resident_entries", "lsot_prefix_resident_entries",
                 "gauge"),
                ("resident_tokens", "lsot_prefix_resident_tokens",
                 "gauge"),
                ("resident_bytes", "lsot_prefix_resident_bytes", "gauge"),
        ):
            n = _num(rec.get(key))
            if n is not None:
                emit.add(name, labels, n, mtype)


def _emit_fleet(emit: _Emitter, model: str, fl: Dict) -> None:
    """The elastic-membership families: `serving.fleet`
    becomes lsot_fleet_* gauges/counters labeled model — live fleet
    size and serving/elastic counts, join/retire lifecycle totals, the
    drain-duration ledger scale-down rides, and the pushed-handoff
    pump's depth/bytes/latency (wire-receive → pool placement)."""
    labels = {"model": model}
    for key, name, mtype in (
            ("size", "lsot_fleet_size", "gauge"),
            ("serving", "lsot_fleet_serving", "gauge"),
            ("elastic", "lsot_fleet_elastic", "gauge"),
            ("joins", "lsot_fleet_joins_total", "counter"),
            ("retires", "lsot_fleet_retires_total", "counter"),
            ("drain_s_sum", "lsot_fleet_drain_seconds_sum", "counter"),
            ("drain_count", "lsot_fleet_drain_count", "counter"),
            ("pushed", "lsot_fleet_pushed_handoffs_total", "counter"),
            ("push_bytes", "lsot_fleet_pushed_handoff_bytes_total",
             "counter"),
            ("pump_depth", "lsot_fleet_pump_depth", "gauge"),
            ("push_placed", "lsot_fleet_push_placed_total", "counter"),
            ("push_place_p50_ms", "lsot_fleet_push_place_p50_ms",
             "gauge"),
            ("push_place_p95_ms", "lsot_fleet_push_place_p95_ms",
             "gauge"),
    ):
        n = _num(fl.get(key))
        if n is not None:
            emit.add(name, labels, n, mtype)


def _emit_models(emit: _Emitter, model: str, mv: Dict) -> None:
    """The multi-model fleet families: `serving.models`
    becomes lsot_model_* gauges/counters labeled model (the BACKEND
    whose stats block carried the view) × served_model (the co-resident
    checkpoint the row attributes to) — per-model queue depth, decode
    occupancy, throughput, and the partitioned KV-page arena each
    checkpoint holds. Only present on multi-model fleets: a
    single-model pool's stats omit the block entirely, keeping its
    /metrics byte-identical."""
    for rec in mv.get("models") or []:
        if not isinstance(rec, dict):
            continue
        labels = {"model": model,
                  "served_model": str(rec.get("model") or "")}
        for key, name, mtype in (
                ("replicas", "lsot_model_replicas", "gauge"),
                ("placeable", "lsot_model_placeable_replicas", "gauge"),
                ("queued", "lsot_model_queue_depth", "gauge"),
                ("active_slots", "lsot_model_active_slots", "gauge"),
                ("pending_new_tokens", "lsot_model_pending_new_tokens",
                 "gauge"),
                ("backlog_s", "lsot_model_backlog_seconds", "gauge"),
                ("placements", "lsot_model_placements_total", "counter"),
                ("tokens_total", "lsot_model_output_tokens_total",
                 "counter"),
                ("tok_s", "lsot_model_tokens_per_second", "gauge"),
                ("kv_pages_total", "lsot_model_kv_pages_total", "gauge"),
                ("kv_pages_in_use", "lsot_model_kv_pages_in_use",
                 "gauge"),
        ):
            n = _num(rec.get(key))
            if n is not None:
                emit.add(name, labels, n, mtype)


def _emit_slo(emit: _Emitter, slo: Dict) -> None:
    """The rolling-SLO families: per-replica + fleet quantile
    gauges, bad-fraction/burn-rate gauges per window arm, and the 0/1
    burning flag /readyz keys degraded off."""
    for m, obj in (slo.get("objectives") or {}).items():
        n = _num((obj or {}).get("threshold_s"))
        if n is not None:
            emit.add("lsot_slo_objective_seconds", {"metric": m}, n)
    views = [(r.get("replica") or "r0", r.get("metrics") or {})
             for r in slo.get("replicas") or [] if isinstance(r, dict)]
    views.append(("fleet", slo.get("fleet") or {}))
    for rep, metrics in views:
        for m, v in metrics.items():
            if not isinstance(v, dict):
                continue
            labels = {"metric": str(m), "replica": rep}
            for q in ("p50", "p90", "p99"):
                n = _num(v.get(q))
                if n is not None:
                    emit.add(f"lsot_slo_{q}_seconds", labels, n)
            n = _num(v.get("count"))
            if n is not None:
                emit.add("lsot_slo_observations", labels, n)
            for key, win in (("bad_frac", "long"),
                             ("bad_frac_short", "short")):
                n = _num(v.get(key))
                if n is not None:
                    emit.add("lsot_slo_bad_fraction",
                             {**labels, "window": win}, n)
            for key, win in (("burn_rate", "long"),
                             ("burn_rate_short", "short")):
                n = _num(v.get(key))
                if n is not None:
                    emit.add("lsot_slo_burn_rate",
                             {**labels, "window": win}, n)
            if "burning" in v:
                emit.add("lsot_slo_burning", labels,
                         1.0 if v["burning"] else 0.0)


def _emit_qos_admission(emit: _Emitter, qos: Dict) -> None:
    """The front-door lsot_tenant_* families: per-(tenant,
    class) admit/shed counters, cumulative shed wait, and live bucket
    levels. Labels are bounded upstream (top-K + "_other" fold in
    serve/qos.py), so a tenant-id flood cannot balloon the payload."""
    for key, name in (
            ("admitted", "lsot_tenant_admitted_total"),
            ("shed", "lsot_tenant_shed_total"),
            ("shed_wait_s", "lsot_tenant_shed_wait_seconds_total"),
    ):
        for label, v in (qos.get(key) or {}).items():
            tenant, sep, cls = str(label).rpartition("/")
            n = _num(v)
            if n is not None:
                emit.add(name,
                         {"tenant": tenant if sep else str(label),
                          "qos": cls if sep else ""},
                         n, "counter")
    for label, v in (qos.get("bucket_level") or {}).items():
        tenant, sep, cls = str(label).rpartition("/")
        n = _num(v)
        if n is not None:
            emit.add("lsot_tenant_bucket_level",
                     {"tenant": tenant if sep else str(label),
                      "qos": cls if sep else ""}, n)


def _emit_repair(emit: _Emitter, rep: Dict) -> None:
    """The self-healing-SQL lsot_repair_* families. Label
    cardinality is bounded by construction: the only labeled family is
    lsot_repair_errors_total{class=...}, whose classes come from the
    fixed five-value taxonomy (app/repair.REPAIR_CLASSES); the "recent"
    flight rows are /metrics JSON only and never become series."""
    for key, name in (
            ("repair_rounds", "lsot_repair_rounds_total"),
            ("repaired", "lsot_repair_repaired_total"),
            ("unrepairable", "lsot_repair_unrepairable_total"),
            ("breaker_skips", "lsot_repair_breaker_skips_total"),
            ("deadline_stops", "lsot_repair_deadline_stops_total"),
    ):
        n = _num(rep.get(key))
        if n is not None:
            emit.add(name, {}, n, "counter")
    for key, v in rep.items():
        if not key.startswith("diagnosed_"):
            continue
        n = _num(v)
        if n is not None:
            emit.add("lsot_repair_errors_total",
                     {"class": key[len("diagnosed_"):]}, n, "counter")


def _emit_qos_sched(emit: _Emitter, model: str, qv: Dict) -> None:
    """Scheduler-side WFQ view: per-replica virtual time and
    ready/page-wait depths, plus per-tenant submitted/preempted/
    quarantined counters — first-class families on the shared model ×
    replica × tenant vocabulary instead of path-flattened names (tenant
    ids must be label VALUES, never metric names)."""
    reps = qv.get("replicas")
    if isinstance(reps, list):
        views = [(str(r.get("replica") or f"r{i}"), r)
                 for i, r in enumerate(reps) if isinstance(r, dict)]
    else:
        views = [("r0", qv)]
    for rep, v in views:
        labels = {"model": model, "replica": rep}
        for key, name in (
                ("virtual_time", "lsot_qos_virtual_time"),
                ("ready", "lsot_qos_ready_depth"),
                ("page_wait", "lsot_qos_page_wait_depth"),
        ):
            n = _num(v.get(key))
            if n is not None:
                emit.add(name, labels, n)
        for key, name, mtype in (
                ("submitted", "lsot_tenant_submitted_total", "counter"),
                ("preempted", "lsot_tenant_preempted_total", "counter"),
                ("weights", "lsot_tenant_weight", "gauge"),
                ("backlog", "lsot_tenant_backlog", "gauge"),
        ):
            d = v.get(key)
            if not isinstance(d, dict):
                continue
            for tenant, cnt in d.items():
                n = _num(cnt)
                if n is not None:
                    emit.add(name, {**labels, "tenant": str(tenant)},
                             n, mtype)
    q = qv.get("quarantined")
    if isinstance(q, dict):
        for tenant, cnt in q.items():
            n = _num(cnt)
            if n is not None:
                emit.add("lsot_tenant_quarantined_total",
                         {"model": model, "tenant": str(tenant)},
                         n, "counter")


def render_prometheus(snapshot: Dict,
                      histograms: Optional[HistogramSet] = None) -> str:
    """Render `GenerationService.metrics_snapshot()` (+ the registry's
    histogram set) as Prometheus exposition text."""
    emit = _Emitter()
    resilience = snapshot.get("resilience") or {}
    for model, agg in snapshot.items():
        if model in ("resilience", "slo", "qos", "repair") \
                or not isinstance(agg, dict):
            continue
        for key, (suffix, mtype) in _MODEL_KEYS.items():
            n = _num(agg.get(key))
            if n is not None:
                emit.add(f"lsot_{suffix}", {"model": model}, n, mtype)
        serving = agg.get("serving")
        if isinstance(serving, dict):
            # The roofline ledger renders as first-class phase × replica
            # gauges (not path-flattened serving gauges) so dashboards
            # join lsot_mfu/lsot_hbm_util on the same label vocabulary
            # as the latency histograms.
            serving = dict(serving)
            perf = serving.pop("perf", None)
            if isinstance(perf, dict):
                _emit_perf(emit, model, perf)
            # Handoff traffic renders as first-class replica × phase_role
            # families (not path-flattened gauges) so dashboards join
            # lsot_handoff_* on the same label vocabulary as lsot_mfu.
            ho = serving.pop("handoff", None)
            if isinstance(ho, dict):
                _emit_handoff(emit, model, ho)
            # Replica-transport traffic renders as first-class
            # replica × endpoint families so dashboards join
            # lsot_transport_* on the shared replica vocabulary.
            tr = serving.pop("transport", None)
            if isinstance(tr, dict):
                _emit_transport(emit, model, tr)
            # Prefix-cache telemetry renders as first-class
            # model × replica families (not path-flattened gauges) so
            # dashboards join lsot_prefix_* on the same label vocabulary
            # as lsot_mfu / the latency histograms. The flat
            # serving.prefix_cache sums keep their historical
            # lsot_serving_prefix_cache_* names below.
            pv = serving.pop("prefix", None)
            if isinstance(pv, dict):
                _emit_prefix(emit, model, pv)
            # Multi-model fleet stats render as first-class
            # model × served_model families so dashboards
            # split queue depth / tok/s / KV pages by co-resident
            # checkpoint.
            mv = serving.pop("models", None)
            if isinstance(mv, dict):
                _emit_models(emit, model, mv)
            # Elastic-membership stats render as first-class model-level
            # families so dashboards watch fleet size /
            # join-retire churn / pushed-handoff latency directly.
            fl = serving.pop("fleet", None)
            if isinstance(fl, dict):
                _emit_fleet(emit, model, fl)
            # WFQ/tenant scheduler stats render as first-class model ×
            # replica × tenant families: tenant ids must be
            # label values, never path-flattened metric names.
            qv = serving.pop("qos", None)
            if isinstance(qv, dict):
                _emit_qos_sched(emit, model, qv)
            _flatten_serving(emit, model, "lsot_serving", serving)
    if resilience:
        breakers = resilience.get("breakers") or {}
        for event, count in resilience.items():
            n = _num(count)
            if n is not None:
                emit.add("lsot_resilience_events_total", {"event": event},
                         n, "counter")
        for dep, state in breakers.items():
            if isinstance(state, dict):
                is_open = state.get("state") == "open"
                fails = _num(state.get("failures"))
            else:
                is_open = state == "open"
                fails = None
            emit.add("lsot_breaker_open", {"dependency": dep},
                     1.0 if is_open else 0.0)
            if fails is not None:
                emit.add("lsot_breaker_failures", {"dependency": dep}, fails)
    slo = snapshot.get("slo")
    if isinstance(slo, dict):
        _emit_slo(emit, slo)
    qos = snapshot.get("qos")
    if isinstance(qos, dict):
        _emit_qos_admission(emit, qos)
    rep = snapshot.get("repair")
    if isinstance(rep, dict):
        _emit_repair(emit, rep)
    if histograms is not None:
        for name, series in sorted(histograms.snapshot().items()):
            name = _NAME_OK.sub("_", name)
            for s in series:
                labels = dict(s.get("labels", {}))
                for le, c in s["buckets"].items():
                    emit.add(name, {**labels, "le": _fmt(float(le))},
                             c, "histogram", suffix="_bucket")
                emit.add(name, {**labels, "le": "+Inf"}, s["count"],
                         "histogram", suffix="_bucket")
                emit.add(name, labels, s["sum"], "histogram", suffix="_sum")
                emit.add(name, labels, s["count"], "histogram",
                         suffix="_count")
    return emit.render()

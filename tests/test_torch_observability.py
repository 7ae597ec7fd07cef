"""The port's metrics layer against the JAX package's, on the CPU.

- `render_prometheus` writes byte-identical exposition text for the same
  snapshot and the same histogram observations;
- `SLOEngine` reports, `MetricsRegistry` snapshots and histograms, and
  `PerfModel` attributions (`observe`, `observe_mixed`, `flush_prefill`,
  `prefill_saved`, `stats`) are equal for the same inputs and the same
  device kind (a TPU row and the CPU fallback); the H100 row the port adds
  is pinned, its int8 column at the bf16 rate;
- `traceprof.Trace` reads a synthetic torch Chrome trace: the union of
  overlapping kernel intervals on two streams, the CPU fallback, the
  capture guard and defaults;
- the app: `/metrics` (JSON and Prometheus) and the five `/debug/*` routes
  answer with JAX's payload keys and Prometheus family names, over
  `FakeBackend` and over the tiny contiguous schedulers with bridged
  weights (values that read a clock excepted); each observability knob of
  the entry point takes effect, and `python -m ... --cpu --backend tiny
  --api` serves the routes.

No assertion reads wall time.
"""

import gzip
import json
import logging
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from llm_based_apache_spark_optimization_tpu.app import AppConfig as JaxAppConfig
from llm_based_apache_spark_optimization_tpu.app import create_api_app as jax_api
from llm_based_apache_spark_optimization_tpu.app.__main__ import (
    make_tiny_service as jax_tiny_service,
)
from llm_based_apache_spark_optimization_tpu.history import (
    SQLiteHistory as JaxSQLiteHistory,
)
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.serve import FakeBackend as JaxFake
from llm_based_apache_spark_optimization_tpu.serve import (
    GenerationService as JaxService,
)
from llm_based_apache_spark_optimization_tpu.sql import SQLiteBackend as JaxSQLiteBackend
from llm_based_apache_spark_optimization_tpu.utils import observability as jobs
from llm_based_apache_spark_optimization_tpu.utils import perfmodel as jperf
from llm_based_apache_spark_optimization_tpu.utils import prometheus as jprom
from llm_based_apache_spark_optimization_tpu.utils import slo as jslo
from llm_based_apache_spark_optimization_tpu_torch.app import (
    AppConfig,
    create_api_app,
    create_web_app,
)
from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.serve import (
    FakeBackend,
    GenerationService,
)
from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend
from llm_based_apache_spark_optimization_tpu_torch.utils import observability as tobs
from llm_based_apache_spark_optimization_tpu_torch.utils import perfmodel as tperf
from llm_based_apache_spark_optimization_tpu_torch.utils import prometheus as tprom
from llm_based_apache_spark_optimization_tpu_torch.utils import slo as tslo
from llm_based_apache_spark_optimization_tpu_torch.utils import traceprof

CSV = "VendorID,passenger_count,total_amount\n1,2,12.5\n2,4,25.0\n1,3,18.0\n"

# ------------------------------------------------------------- Prometheus

PERF_R0 = {
    "replica": "r0", "device_kind": "NVIDIA H100 80GB HBM3",
    "peak_tflops": 989.0, "peak_hbm_gbs": 3350.0, "param_bytes": 13476839424,
    "weight_bits": 16, "kv_quant": "", "kv_layout": "paged", "tp": 1,
    "phases": {
        "decode": {"mfu": 0.01, "hbm_util": 0.6, "tflops": 9.89, "gbs": 2010.0,
                   "rounds": 7, "bound": "memory-bound"},
        "prefill": {"mfu": 0.4, "hbm_util": 0.05, "tflops": 395.6, "gbs": 167.5,
                    "rounds": 3, "bound": "compute-bound"},
        "mixed": {"mfu": 0.1, "hbm_util": 0.3, "tflops": 98.9, "gbs": 1005.0,
                  "rounds": 2, "bound": "memory-bound"},
    },
}
PREFIX_R0 = {
    "replica": "r0", "hits": 6, "misses": 2, "hit_rate": 0.75, "hit_rate_ewma": 0.8,
    "blocks_reused": 18, "reused_tokens": 288, "evictions": 3, "reinserts": 1,
    "cached_blocks": 4, "prefill_flops_saved": 1.0e9, "prefill_s_saved": 0.125,
    "resident_entries": 4, "resident_tokens": 64, "resident_bytes": 16384,
}
SLO_METRICS = {
    "ttft": {"count": 40, "sum": 2.0, "p50": 0.05, "p90": 0.25, "p99": 0.5,
             "objective_s": 0.1, "bad_frac": 0.02, "bad_frac_short": 0.2,
             "burn_rate": 2.0, "burn_rate_short": 20.0, "burning": True,
             "warning": True},
}
SNAPSHOTS = {
    "aggregates_resilience": {
        "duckdb-nsql": {
            "requests": 3, "output_tokens": 30, "p50_latency_s": 0.5,
            "p95_latency_s": 0.9, "avg_decode_tok_s": 60.0, "ttft_p50_s": 0.1,
            "ttft_p95_s": 0.2, "queue_wait_p50_s": 0.01, "queue_wait_p95_s": 0.03,
            "serving": {"prefix_cache": {"hits": 2, "blocks_reused": 4},
                        "watchdog": {"heartbeat": {"busy": False, "rounds": 7},
                                     "slots_retired_stalled": 0},
                        "flight_recorder": {"records": 7, "capacity": 256,
                                            "total": 7, "overwritten": 0},
                        "kv_pages": {"pages_total": 32, "pages_free": 30,
                                     "kv_quant": "int8"}},
        },
        "resilience": {"retries": 2, "shed": 1,
                       "breakers": {"sql backend": {"state": "open", "failures": 5}}},
    },
    "perf_prefix": {"m": {"requests": 1,
                          "serving": {"perf": PERF_R0, "prefix": PREFIX_R0}}},
    "pool_shapes": {"m": {"requests": 1, "serving": {
        "perf": {"replicas": [PERF_R0, {**PERF_R0, "replica": "r1"}]},
        "prefix": {"replicas": [PREFIX_R0, {**PREFIX_R0, "replica": "r1", "hits": 1}]}}}},
    "slo": {"slo": {"enabled": True,
                    "objectives": {"ttft": {"threshold_s": 0.1, "target": 0.99}},
                    "window_s": 300.0,
                    "replicas": [{"replica": "r1", "metrics": SLO_METRICS,
                                  "state": "burning"}],
                    "fleet": SLO_METRICS, "burning": ["r1"], "state": "burning"}},
    "repair": {"repair": {"repair_rounds": 3, "repaired": 1, "unrepairable": 1,
                          "breaker_skips": 0, "deadline_stops": 0,
                          "diagnosed_unknown_column": 2, "recent": []}},
}


def _histograms(mod):
    hs = mod.HistogramSet()
    for v, labels in ((0.002, dict(model="m", replica="r0", **{"class": "plain"})),
                      (0.03, dict(model="m", replica="r0", **{"class": "plain"})),
                      (0.7, dict(model="m", replica="r1", **{"class": "constrained"})),
                      (75.0, dict(model="n", replica="r0", **{"class": "plain"}))):
        hs.observe("lsot_ttft_seconds", v, **labels)
        hs.observe("lsot_request_latency_seconds", 2 * v, **labels)
    return hs


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_render_prometheus_byte_identical(name):
    snap = SNAPSHOTS[name]
    want = jprom.render_prometheus(snap, _histograms(jobs))
    got = tprom.render_prometheus(snap, _histograms(tobs))
    assert got == want
    assert tprom.CONTENT_TYPE == jprom.CONTENT_TYPE


# ----------------------------------------------------- SLO and registry

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _drive_slo(mod):
    clock = _Clock()
    eng = mod.SLOEngine(ttft_ms=100, tpot_ms=20, queue_wait_ms=50, window_s=60,
                        target=0.9, time_fn=clock)
    rng = np.random.default_rng(7)
    reports = []
    for step in range(40):
        for rep in ("r0", "r1"):
            scale = 3.0 if (rep == "r1" and step > 25) else 1.0
            eng.observe("ttft", float(rng.exponential(0.05 * scale)), replica=rep)
            eng.observe("tpot", float(rng.exponential(0.01 * scale)), replica=rep)
            eng.observe("queue_wait", float(rng.exponential(0.02)), replica=rep)
        if step % 10 == 9:
            reports.append((eng.report(), eng.burning(), eng.enabled))
        clock.t += 2.5
    return reports


def test_slo_engine_reports_equal_jax():
    got, want = _drive_slo(tslo), _drive_slo(jslo)
    assert got == want
    assert any(r[1] for r in want), "the drive should burn a replica"


def _requests():
    rng = np.random.default_rng(3)
    out = []
    for i in range(30):
        out.append(dict(
            model="m" if i % 3 else "n", prompt_tokens=int(rng.integers(4, 40)),
            output_tokens=int(rng.integers(0, 20)),
            latency_s=float(rng.uniform(0.05, 3.0)),
            wall_share_s=float(rng.uniform(0.0, 0.5)) if i % 4 == 0 else 0.0,
            ttft_s=float(rng.uniform(0.0, 0.4)) if i % 5 else 0.0,
            queue_wait_s=float(rng.uniform(0.0, 0.2)) if i % 2 else 0.0,
            rclass=("constrained" if i % 7 == 0 else ""),
            replica=("r1" if i % 6 == 0 else ""), request_id=f"req-{i}",
            stages={"decode": 0.5} if i % 8 == 0 else {}))
    return out


@pytest.mark.parametrize("window", [1024, 8])
def test_metrics_registry_snapshots_equal_jax(window):
    """Same records, same windowed percentiles, histograms, SLO feed and
    request-log lines."""
    results = []
    for mod, slo_mod in ((jobs, jslo), (tobs, tslo)):
        old = slo_mod.ENGINE
        lines = []
        handler = logging.Handler()
        handler.emit = lambda record: lines.append(record.getMessage())
        mod.log.addHandler(handler)
        level = mod.log.level
        mod.log.setLevel(logging.INFO)
        try:
            eng = slo_mod.reconfigure(ttft_ms=100, queue_wait_ms=50, window_s=60)
            reg = mod.MetricsRegistry(window=window, request_log_sample=0.5)
            for kw in _requests():
                reg.record(mod.RequestMetrics(**kw))
            results.append((reg.snapshot(), reg.histograms.snapshot(),
                            eng.report()["fleet"], lines))
        finally:
            mod.log.removeHandler(handler)
            mod.log.setLevel(level)
            slo_mod.ENGINE = old
    assert results[1] == results[0]
    assert results[0][3], "the sampled request log wrote no line"


def test_request_metrics_and_stage_timer_equal_jax():
    for kw in _requests()[:6]:
        j, t = jobs.RequestMetrics(**kw), tobs.RequestMetrics(**kw)
        assert t.to_dict() == j.to_dict()
        assert (t.tpot_s, t.decode_tok_s, t.distinct_wall_s) == \
            (j.tpot_s, j.decode_tok_s, j.distinct_wall_s)
    timer = tobs.StageTimer()
    with timer.stage("decode"):
        pass
    with timer.stage("decode"):
        pass
    assert set(timer.spans) == {"decode"}


def test_request_log_knob_equals_jax(monkeypatch):
    for value, want in (("0", 0.0), ("0.25", 0.25), ("7", 1.0), ("bad", 1.0)):
        monkeypatch.setenv("LSOT_REQUEST_LOG", value)
        assert tobs._request_log_sample() == jobs._request_log_sample() == want


# ---------------------------------------------------------- the ledger

KINDS = ["TPU v5 lite", "TPU v6e", "", "NVIDIA H100 80GB HBM3"]


def _ledger_outputs(mod, cfg, kind, layout, kv_quant, bits):
    pm = mod.PerfModel(cfg, param_bytes=123456, weight_bits=bits, kv_itemsize=4,
                       kv_quant=kv_quant, kv_layout=layout,
                       page_size=8 if layout == "paged" else None, device_kind=kind)
    out = [pm.peak_flops, pm.peak_bw]
    for phase, rows, tokens, ctx, wall in (("decode", 2, 4, 30, 0.004),
                                           ("verify", 2, 5, 41, 0.002),
                                           ("draft", 2, 4, 64, 0.001),
                                           ("decode", 2, 4, 33, 0.0)):
        out.append(pm.observe(phase, rows=rows, tokens=tokens, ctx=ctx, wall_s=wall))
    pm.note_prefill(rows=3, tokens=16, ctx=20)
    pm.note_prefill(rows=1, tokens=8, ctx=4)
    out.append(pm.flush_prefill(0.01))
    out.append(pm.flush_prefill(0.01))  # nothing banked: None
    out.append(pm.observe_mixed(rows=2, dec_tokens=4, dec_ctx=30, pre_rows=1,
                                pre_tokens=16, pre_ctx=8, wall_s=0.003))
    out.append(pm.prefill_saved(24))
    out.append(pm.prefill_saved(0))
    out.append(pm.stats())
    out.append([mod.kv_bytes(cfg, 2, c, itemsize=4, kv_quant=kv_quant, kv_layout=layout,
                             page_size=8) for c in (1, 7, 8, 33)])
    out.append([mod.decode_step_bytes(cfg, 2, 33, 123456, itemsize=4, kv_quant=kv_quant,
                                      kv_layout=layout, page_size=8)])
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout,kv_quant,bits", [("contiguous", None, 16),
                                                  ("contiguous", "int8", 8),
                                                  ("paged", None, 4),
                                                  ("paged", "int8", 16)])
def test_perfmodel_equals_jax(kind, layout, kv_quant, bits):
    """The same attributions for the same inputs; the H100 kind is the one
    row JAX does not have (it prices it at its host fallback), so there
    the port is held to JAX with the H100 peaks patched in."""
    got = _ledger_outputs(tperf, TINY, kind, layout, kv_quant, bits)
    if kind.startswith("NVIDIA"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(jperf.PEAKS, "h100", tperf.PEAKS["h100"])
            want = _ledger_outputs(jperf, JAX_TINY, kind, layout, kv_quant, bits)
    else:
        want = _ledger_outputs(jperf, JAX_TINY, kind, layout, kv_quant, bits)
    assert got == want
    assert tperf.flops_per_token(TINY, 33) == jperf.flops_per_token(JAX_TINY, 33)
    assert tperf.prefill_flops(TINY, 2, 16, 9) == jperf.prefill_flops(JAX_TINY, 2, 16, 9)
    assert tperf.draft_bytes(TINY, 2, 4, 64) == jperf.draft_bytes(JAX_TINY, 2, 4, 64)


def test_h100_row_pinned(monkeypatch):
    """989 TFLOP/s dense bf16 and 3350 GB/s; int8 (chosen for any weight
    width <= 8, int4 included) at the bf16 rate, since the port's int8 and
    int4 matmuls multiply on the bf16 tensor cores. The TPU rows and the
    host fallback are JAX's."""
    monkeypatch.setenv("LSOT_PEAK_TFLOPS", "0.2")
    monkeypatch.setenv("LSOT_PEAK_HBM_GBS", "50")
    assert tperf.PEAKS["h100"] == (989.0, 989.0, 3350.0)
    for quant in ("", "int8"):
        assert tperf.peak_for("NVIDIA H100 80GB HBM3", quant) == (989e12, 3350e9)
    assert {k: v for k, v in tperf.PEAKS.items() if k != "h100"} == jperf.PEAKS
    for kind in ("TPU v4", "cpu", "", "NVIDIA A100-SXM4-80GB"):
        for quant in ("", "int8"):
            assert tperf.peak_for(kind, quant) == jperf.peak_for(kind, quant)
    assert tperf.cpu_fallback_peaks() == jperf.cpu_fallback_peaks() == (0.2e12, 50e9)
    pm = tperf.PerfModel(TINY, param_bytes=1, weight_bits=4,
                         device_kind="NVIDIA H100 80GB HBM3")
    assert pm.stats()["peak_tflops"] == 989.0 and pm.stats()["peak_hbm_gbs"] == 3350.0


# ------------------------------------------------------------ traceprof

def _kernel(name, ts, dur, tid):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": tid,
            "ts": ts, "dur": dur, "args": {"stream": tid}}


def synthetic_trace():
    """A torch.profiler export's shape: kernels on two streams (overlaps
    within and across), a memcpy, CPU-side events that must not count, and
    metadata. Device busy, by hand: [100, 160) U [150, 200) U [190, 230)
    U [300, 310) U [305, 320) U [400, 402) = 130 + 20 + 2 = 152 us over a
    span of 302 us."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        _kernel("flash_prefill", 100.0, 60.0, 7),
        _kernel("decode_split", 150.0, 50.0, 13),
        _kernel("flash_prefill", 190.0, 40.0, 7),
        _kernel("page_write", 300.0, 10.0, 7),
        _kernel("int4_matmul", 305.0, 15.0, 13),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "pid": 0, "tid": 7,
         "ts": 400.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 9,
         "tid": 9, "ts": 90.0, "dur": 500.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 9, "tid": 9,
         "ts": 50.0, "dur": 900.0},
        {"ph": "X", "cat": "kernel", "name": "empty", "pid": 0, "tid": 7,
         "ts": 500.0, "dur": 0.0},
        {"ph": "f", "cat": "ac2g", "name": "flow", "pid": 0, "tid": 7, "ts": 100.0},
    ]
    return {"schemaVersion": 1, "traceEvents": events}


def test_trace_reads_kernel_union_of_a_torch_trace(tmp_path):
    tr = traceprof.Trace()
    tr._ingest(synthetic_trace())
    assert tr.device_time_s() == pytest.approx(152e-6, rel=1e-12)
    assert tr.op_time_s() == pytest.approx(177e-6, rel=1e-12)
    assert tr.span_s() == pytest.approx(302e-6, rel=1e-12)
    assert tr.busy_share() == pytest.approx(152 / 302, rel=1e-12)
    top = tr.top_ops(2)
    assert [(n, c) for n, _, c in top] == [("flash_prefill", 2), ("decode_split", 1)]
    assert top[0][1] == pytest.approx(100e-6)
    # The same document as an artifact, found and loaded from a directory.
    d = tmp_path / "cap" / "nested"
    d.mkdir(parents=True)
    with gzip.open(d / "lsot.1.2.trace.json.gz", "wt") as f:
        json.dump(synthetic_trace(), f)
    (d / "other.json").write_text("{}")
    arts = traceprof.find_profile_artifacts(str(tmp_path / "cap"))
    assert arts == [str(d / "lsot.1.2.trace.json.gz")]
    assert traceprof.Trace().load_dir(str(tmp_path)).device_time_s() == \
        pytest.approx(152e-6, rel=1e-12)


def test_trace_falls_back_to_cpu_ops_without_device_lanes():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::matmul", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 2.0, "dur": 6.0},
        {"ph": "X", "cat": "python_function", "name": "f", "ts": 0.0, "dur": 50.0},
    ]}
    tr = traceprof.Trace()
    tr._ingest(doc)
    assert tr.device_time_s() == pytest.approx(10e-6)
    assert tr.op_time_s() == pytest.approx(16e-6)
    assert traceprof.Trace().busy_share() == 0.0


def test_device_trace_on_the_cpu_writes_and_reads_an_artifact(tmp_path):
    import torch

    with traceprof.device_trace(str(tmp_path), cuda=False) as tr:
        torch.randn(32, 32) @ torch.randn(32, 32)
    assert traceprof.find_profile_artifacts(str(tmp_path))
    assert "aten::mm" in tr.ops and tr.device_time_s() > 0.0


def test_capture_guard_and_defaults_equal_jax(monkeypatch, tmp_path):
    from llm_based_apache_spark_optimization_tpu.utils import traceprof as jtp

    assert traceprof.try_acquire_capture("a")
    assert not traceprof.try_acquire_capture("b")
    assert traceprof.capture_owner() == "a"
    traceprof.release_capture("b")  # not the owner: no effect
    assert traceprof.capture_owner() == "a"
    traceprof.release_capture("a")
    assert traceprof.capture_owner() is None
    monkeypatch.delenv("LSOT_PROFILE_DIR", raising=False)
    for env in ({}, {"LSOT_PROFILE_ROUNDS": "3", "LSOT_PROFILE_DIR": str(tmp_path)},
                {"LSOT_PROFILE_ROUNDS": "junk"}, {"LSOT_PROFILE_ROUNDS": "0"}):
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            assert traceprof.profile_defaults() == jtp.profile_defaults()
    try:
        traceprof.reconfigure_profile(str(tmp_path / "p"), 5)
        assert traceprof.profile_defaults() == (str(tmp_path / "p"), 5)
    finally:
        traceprof.reconfigure_profile(None, None)


# ------------------------------------------------------------- the app

def _keys(obj):
    """The payload's shape: nested keys, list items merged, leaves typed
    only as 'leaf' (values that read a clock differ run to run)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        merged = {}
        for item in obj:
            sub = _keys(item)
            if isinstance(sub, dict):
                merged.update(sub)
        return [merged] if merged else []
    return "leaf"


def _families(text):
    return sorted(line.split()[2] for line in text.splitlines()
                  if line.startswith("# TYPE "))


#: Blocks of process-wide state (counters, breakers, the SLO engine, the
#: JAX front door's tenant counters): present or not by what other tests
#: in the same process did, so the shape comparisons leave them out.
PROCESS_BLOCKS = ("resilience", "slo", "repair", "qos")
PROCESS_FAMILIES = ("lsot_resilience_", "lsot_breaker_", "lsot_slo_", "lsot_repair_",
                    "lsot_qos_", "lsot_tenant_")


def _shapes(scrape):
    """What the two apps must agree on: the payload keys of /metrics (the
    process-wide blocks aside), of the flight recorder, prefix-cache and
    profile routes, the top-level keys of /debug/slo and /debug/traces and
    the tracer's (their contents are process-wide), and the Prometheus
    families (the process-wide ones aside)."""
    metrics = {k: v for k, v in scrape["metrics"].items() if k not in PROCESS_BLOCKS}
    out = {"metrics": _keys(metrics),
           "families": [f for f in _families(scrape["prometheus"].text)
                        if not f.startswith(PROCESS_FAMILIES)],
           "/debug/slo": sorted(scrape["/debug/slo"]),
           "/debug/traces": (sorted(scrape["/debug/traces"]),
                             sorted(scrape["/debug/traces"]["tracer"]))}
    for path in ("/debug/flightrecorder", "/debug/prefixcache", "/debug/profile"):
        out[path] = _keys(scrape[path])
    return out


DEBUG_ROUTES = ("/debug/flightrecorder", "/debug/traces", "/debug/slo",
                "/debug/prefixcache", "/debug/profile")


def _scrape(client):
    out = {"metrics": client.get("/metrics").json(),
           "prometheus": client.request("GET", "/metrics", query="format=prometheus")}
    for path in DEBUG_ROUTES:
        res = client.get(path)
        assert res.status == 200, path
        out[path] = res.json()
    return out


def _fake_services():
    jsvc, tsvc = JaxService(), GenerationService()
    for svc, fake in ((jsvc, JaxFake), (tsvc, FakeBackend)):
        svc.register("duckdb-nsql", fake(lambda p: "SELECT 1"))
        svc.register("llama3.2", fake(lambda p: "explained"))
    return jsvc, tsvc


def _clients(jsvc, tsvc, tmp_path, factory=create_api_app):
    out = []
    for svc, app_fn, config, hist, sql in (
            (jsvc, jax_api, JaxAppConfig, JaxSQLiteHistory, JaxSQLiteBackend),
            (tsvc, factory, AppConfig, SQLiteHistory, SQLiteBackend)):
        root = tmp_path / type(svc).__module__.split(".")[0]
        (root / "input").mkdir(parents=True, exist_ok=True)
        (root / "input" / "taxi.csv").write_text(CSV)
        c = config(input_dir=str(root / "input"), output_dir=str(root / "out"),
                   history_db=":memory:", max_new_tokens=8, secret_key="k")
        out.append(app_fn(svc, sql, hist(), c).test_client())
    return out


def test_metrics_and_debug_payloads_match_jax_over_fake_backends(tmp_path):
    jsvc, tsvc = _fake_services()
    scrapes = []
    for svc, client in zip((jsvc, tsvc), _clients(jsvc, tsvc, tmp_path)):
        for _ in range(3):
            svc.generate("duckdb-nsql", "q", system="s")
        res = client.post_json("/process-data/", {"input_text": "total fare",
                                                  "file_name": "taxi.csv"})
        assert res.status == 200
        scrapes.append(_scrape(client))
    want, got = scrapes
    assert got["prometheus"].headers["Content-Type"] == tprom.CONTENT_TYPE
    assert _shapes(got) == _shapes(want)
    assert got["metrics"]["duckdb-nsql"]["requests"] == 4
    # No backend here can profile: arming is a 400, a bad count too.
    for client in _clients(jsvc, tsvc, tmp_path):
        assert client.request("GET", "/debug/profile", query="rounds=2").status == 400
        assert client.request("GET", "/debug/profile", query="rounds=x").status == 400
        assert client.request("GET", "/metrics", query="format=xml").status == 400
        assert client.request("GET", "/debug/prefixcache", query="top=-1").status == 400
        assert client.request("GET", "/debug/flightrecorder", query="last=x").status == 400


def test_web_frontend_serves_metrics_and_debug_routes(tmp_path):
    jsvc, tsvc = _fake_services()
    client = _clients(jsvc, tsvc, tmp_path, factory=create_web_app)[1]
    tsvc.generate("duckdb-nsql", "q")
    assert client.get("/metrics").json()["duckdb-nsql"]["requests"] == 1
    assert "lsot_requests_total" in _families(
        client.request("GET", "/metrics", query="format=prometheus").text)
    for path in DEBUG_ROUTES:
        assert client.get(path).status == 200, path


def test_metrics_and_debug_payloads_match_jax_over_tiny_schedulers(tmp_path):
    """Both apps over their tiny contiguous schedulers with the same
    weights: after the same requests, `/metrics` and the debug routes carry
    JAX's keys (the serving block's `prefix`, `perf`, `watchdog`,
    `flight_recorder`) and the Prometheus text JAX's families. The
    flight records' fields and the prefix registry are equal field by
    field in tests/test_torch_flight.py."""
    jsvc = jax_tiny_service(8, scheduler=True, supervise=False)
    try:
        weights = tuple(
            params_from_jax(jax.tree.map(np.asarray,
                                         jsvc._models[m].backend.scheduler.params),
                            device="cpu")
            for m in ("duckdb-nsql", "mistral"))
        tsvc = entry.make_tiny_service(8, device="cpu", weights=weights, supervise=False)
        try:
            scrapes = []
            for svc, client in zip((jsvc, tsvc), _clients(jsvc, tsvc, tmp_path)):
                for q in ("total fare per vendor", "total fare per vendor"):
                    client.post_json("/process-data/", {"input_text": q,
                                                        "file_name": "taxi.csv"})
                scrapes.append(_scrape(client))
            want, got = scrapes
            # Both packages' schedulers report their tenant QoS block
            # (`serving.qos`, rendered in the lsot_qos_* and lsot_tenant_*
            # families): QoS is on by default in both.
            for m in ("duckdb-nsql", "llama3.2", "mistral"):
                for scrape in (want, got):
                    assert scrape["metrics"][m]["serving"]["qos"] is not None
            assert _shapes(got) == _shapes(want)
            serving = got["metrics"]["duckdb-nsql"]["serving"]
            assert {"prefix_cache", "prefix", "perf", "watchdog",
                    "flight_recorder"} <= set(serving)
            assert serving["perf"]["device_kind"] == "" and \
                serving["perf"]["peak_tflops"] == 0.2
            rounds = got["/debug/flightrecorder"]["models"]["duckdb-nsql"]
            assert [r["round"] for r in rounds] == list(range(1, len(rounds) + 1))
            assert got["metrics"]["duckdb-nsql"]["queue_wait_p50_s"] >= 0.0
        finally:
            tsvc.close()
    finally:
        jsvc.close()


# ------------------------------------------------ the entry point's knobs

@pytest.fixture()
def restore_observability():
    yield
    entry.configure_observability(AppConfig())


def _tiny_scheduler(svc):
    return svc._models["duckdb-nsql"].backend.scheduler


KNOB_EFFECTS = {
    "LSOT_SLO_TTFT_MS": ("250", lambda svc: tslo.ENGINE.objectives["ttft"] == 0.25),
    "LSOT_SLO_TPOT_MS": ("40", lambda svc: tslo.ENGINE.objectives["tpot"] == 0.05),
    "LSOT_SLO_QUEUE_WAIT_MS": ("100", lambda svc: tslo.ENGINE.objectives["queue_wait"] == 0.1),
    "LSOT_SLO_WINDOW_S": ("60", lambda svc: tslo.ENGINE.window_s == 60.0),
    "LSOT_SLO_TARGET": ("0.9", lambda svc: tslo.ENGINE.target == 0.9),
    "LSOT_REQUEST_LOG": ("0", lambda svc: svc.metrics._log_sample == 0.0),
    "LSOT_TRACE_SAMPLE": ("1", lambda svc: _trace_sample() == 1.0),
    "LSOT_TRACE_EXPORT": ("{tmp}/traces", lambda svc: _trace_export().endswith("traces")),
    "LSOT_FLIGHT_ROUNDS": ("1024", lambda svc: _tiny_scheduler(svc).flight.capacity == 1024),
    "LSOT_PROFILE_ROUNDS": ("4", lambda svc: traceprof.profile_defaults()[1] == 4),
    "LSOT_PROFILE_DIR": ("{tmp}/prof", lambda svc: traceprof.profile_defaults()[0].endswith("prof")),
    "LSOT_PREFIX_TOPK": ("8", lambda svc: _tiny_scheduler(svc)._prefix_topk == 8),
    "LSOT_PREFIX_RING": ("64", lambda svc: _tiny_scheduler(svc)._prefix_ring_cap == 64),
}


def _trace_sample():
    from llm_based_apache_spark_optimization_tpu_torch.utils.tracing import TRACER

    return TRACER.stats()["sample"]


def _trace_export():
    from llm_based_apache_spark_optimization_tpu_torch.utils.tracing import TRACER

    return TRACER.export_dir or ""


@pytest.mark.parametrize("knob", sorted(KNOB_EFFECTS))
def test_entry_point_honours_observability_knob(monkeypatch, tmp_path, knob,
                                                restore_observability):
    """Each knob the port used to refuse now reaches its layer: set alone,
    the service builds and the knob's effect is visible there."""
    value, effect = KNOB_EFFECTS[knob]
    assert not hasattr(entry, "UNPORTED_KNOBS")  # the entry point refuses no knob
    monkeypatch.setenv(knob, value.format(tmp=tmp_path))
    cfg = AppConfig.from_env(input_dir=str(tmp_path / "in"),
                             output_dir=str(tmp_path / "out"), history_db=":memory:")
    svc = entry.build_service(entry.build_parser().parse_args(
        ["--cpu", "--backend", "tiny", "--no-supervise", "--slots", "2"]), cfg)
    try:
        assert effect(svc), knob
    finally:
        svc.close()


def test_stok_seed_bench_is_honoured(monkeypatch, tmp_path):
    """LSOT_STOK_SEED_BENCH seeds the checkpoint engine backend's deadline
    clamp with the artifact's B / value, as the JAX entry point does, and
    LSOT_STOK_SEED wins over it."""
    from llm_based_apache_spark_optimization_tpu_torch import tokenizer
    from llm_based_apache_spark_optimization_tpu_torch.serve import EngineBackend

    bench = tmp_path / "bench.jsonl"
    bench.write_text(json.dumps({"metric": "decode tok/s B=4", "value": 200.0}) + "\n")
    seen = []

    class Built(Exception):
        pass

    def from_hf_checkpoint(cls, path, tok, **kwargs):
        seen.append(kwargs["sec_per_tok_seed"])
        raise Built

    monkeypatch.setattr(tokenizer, "HFTokenizer", lambda path: None)
    monkeypatch.setattr(EngineBackend, "from_hf_checkpoint", classmethod(from_hf_checkpoint))
    monkeypatch.setenv("LSOT_STOK_SEED_BENCH", str(bench))
    args = entry.build_parser().parse_args(
        ["--cpu", "--backend", "checkpoint", "--no-scheduler", "--sql-model-path", "ckpt"])
    monkeypatch.delenv("LSOT_STOK_SEED", raising=False)
    for explicit in (None, "0.5"):
        if explicit:
            monkeypatch.setenv("LSOT_STOK_SEED", explicit)
        cfg = AppConfig.from_env(input_dir=str(tmp_path / "in"),
                                 output_dir=str(tmp_path / "out"), history_db=":memory:")
        with pytest.raises(Built):
            entry.build_service(args, cfg)
    assert seen == [4 / 200.0, 0.5]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_entry_point_serves_metrics_and_debug_routes(tmp_path):
    """`python -m ...app --cpu --backend tiny --api` on a free local port
    answers /metrics in both formats and the five /debug/* routes, a
    profile capture included (armed, a second refused with 409, polled)."""
    port = _free_port()
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root), LSOT_INPUT_DIR=str(tmp_path / "in"),
               LSOT_OUTPUT_DIR=str(tmp_path / "out"),
               LSOT_HISTORY_DB=str(tmp_path / "h.db"),
               LSOT_PROFILE_DIR=str(tmp_path / "prof"))
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "taxi.csv").write_text(CSV)
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_based_apache_spark_optimization_tpu_torch.app",
         "--cpu", "--backend", "tiny", "--api", "--slots", "2", "--host", "127.0.0.1",
         "--port", str(port)],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    base = f"http://127.0.0.1:{port}"

    def get(path):
        try:
            with urllib.request.urlopen(base + path, timeout=60) as r:
                return r.status, r.read(), r.headers.get("Content-Type")
        except urllib.error.HTTPError as e:
            return e.code, e.read(), e.headers.get("Content-Type")

    try:
        for _ in range(600):
            try:
                if get("/healthz")[0] == 200:
                    break
            except OSError:
                time.sleep(0.1)
        else:
            pytest.fail("the app never answered /healthz")
        req = urllib.request.Request(
            base + "/process-data/", method="POST",
            data=json.dumps({"input_text": "total fare", "file_name": "taxi.csv"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
        status, body, _ = get("/metrics")
        assert status == 200 and "serving" in json.loads(body)["duckdb-nsql"]
        status, body, ctype = get("/metrics?format=prometheus")
        assert status == 200 and ctype == tprom.CONTENT_TYPE
        assert "lsot_mfu" in _families(body.decode())
        for path in DEBUG_ROUTES:
            status, body, _ = get(path)
            assert status == 200, path
            json.loads(body)
        assert get("/debug/profile?rounds=0")[0] == 400
        status, body, _ = get("/debug/profile?rounds=1000&model=duckdb-nsql")
        assert status == 200 and json.loads(body)["state"] == "armed"
        assert get("/debug/profile?rounds=2&model=llama3.2")[0] == 409
        caps = json.loads(get("/debug/profile")[1])["captures"]
        assert caps["duckdb-nsql"]["state"] in ("armed", "capturing")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

"""The port's scheduler observability against the JAX scheduler's, on the CPU
in f32 (TINY, the same bridged params, 2 slots, `decode_chunk=4`,
`prompt_bucket=8`).

- The same greedy traffic, with the prefix cache on, gives equal flight
  records on every column that does not read a clock (`round`,
  `occupancy`, `queued`, `admitted`, `retired`, `emitted`, `phase`,
  `perf_ctx`, `kv_pages*`, `prefix_reuse`), equal events (`preempt`, `resume` under
  page pressure, recompute and spill; `crash`), equal `prefix_telemetry`
  and an equal `prefix_registry` (digests, tokens, hits, rounds, pages,
  bytes, shares, the reuse-distance histogram), contiguous and paged. The
  traffic is queued before the loop starts, so both loops see the same
  arrivals. `queued` counts the submit queue alone in both: each loop
  moves its queue into the WFQ ready pool every iteration, and the ready
  pool's depth is `qos_stats()["ready"]`.
- The ledger columns recompute from the record (the ledger is the analytic
  model evaluated live), and weight bytes agree with JAX's for bridged
  bf16, int4 and int8 trees.
- The profile hook on the CPU (torch.profiler CPU activity): armed ->
  capturing -> done, a `*.trace.json.gz` artifact, `profile_start` and
  `profile_done` events, a second capture refused (409 at the route),
  `rounds=0` a 400, the guard released on shutdown.
- Queue wait and TTFT reach `Completion`, `GenerateResult` and the
  registry; a sampled request's trace carries the `sched.*` spans; the
  supervisor merges its lifecycle events with the round records and passes
  the registry and the profile hook through.

No assertion reads wall time.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.ops.quant import (
    quantize_params as jax_q8,
)
from llm_based_apache_spark_optimization_tpu.ops.quant import (
    quantize_params_int4 as jax_q4,
)
from llm_based_apache_spark_optimization_tpu.ops.quant import (
    quantize_unembed as jax_qu,
)
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from llm_based_apache_spark_optimization_tpu.utils.faults import FAULTS as JAX_FAULTS
from llm_based_apache_spark_optimization_tpu_torch.app import AppConfig, create_api_app
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    GenerationService,
    SchedulerBackend,
)
from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
    _leaves,
    prefix_digest,
)
from llm_based_apache_spark_optimization_tpu_torch.serve.supervisor import (
    SupervisedScheduler,
)
from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer
from llm_based_apache_spark_optimization_tpu_torch.utils import traceprof, tracing
from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

BASE = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,))
PREFIX = [1] + list(range(5, 28))  # 24 tokens: 3 blocks of 8
BURST = [(PREFIX + [40], 6), (PREFIX + [41, 42], 9), ([1, 3, 4], 5),
         (PREFIX + [43], 7), (PREFIX[:17] + [60, 61], 8)]
SEQUENTIAL = [(PREFIX + [44], 5), (PREFIX[:9] + [70], 5)]
PRESSURE = dict(BASE, max_seq=64, kv_layout="paged", kv_page_size=8,
                kv_overcommit=0.25, kv_pages=9)
STORM = [[1, 5, 9], [1, 7], [1, 3, 4, 8, 10], [1, 11, 12, 13]]
#: Record columns that read a clock (or are the recorder's own stamps).
CLOCK = {"ts", "seq", "round_wall_s", "cadence_s", "mfu", "hbm_util", "bound",
         "prefill_mfu", "prefill_hbm_util"}


@pytest.fixture(scope="module")
def both():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def make(both, jax_side: bool, **kw):
    jp, tp = both
    if jax_side:
        return JaxScheduler(JAX_TINY, jp, **kw)
    return ContinuousBatchingScheduler(TINY, tp, **kw, device="cpu")


def queue_then_start(sched, traffic):
    """Submit every request before the loop starts (submit needs a running
    loop: a stand-in thread object passes its check), then start it: both
    packages' loops see the same arrivals at their first iteration."""
    sched._thread = threading.current_thread()
    try:
        futs = [sched.submit(ids, max_new_tokens=n) for ids, n in traffic]
    finally:
        sched._thread = None
    sched.start()
    return futs


def settle(sched, timeout=120.0):
    """Wait until the loop has harvested every round in flight, holds no
    slot, and has come back to the top of its loop (a heartbeat) since:
    futures resolve at retirement, before the rounds issued with the
    retired slot are harvested, and a harvest writes its record after its
    retirements, so a caller that submits or shuts down as soon as the
    slots are free lands in that record's `queued`. A bound on the wait,
    not a measurement."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not sched._pending and not sched._prefill_q and \
                all(r is None for r in sched._slot_req):
            beats = sched.heartbeat._beats
            while time.time() < deadline:
                if sched.heartbeat._beats > beats:
                    return
                time.sleep(0.005)
        time.sleep(0.005)
    raise AssertionError("scheduler did not settle")


def quiesced(sched):
    """Settle, then shut the loop down: the records are read after the last
    harvest."""
    settle(sched)
    sched.shutdown()
    return sched.flight.snapshot()


def run_traffic(sched):
    futs = queue_then_start(sched, BURST)
    outs = [f.result(timeout=300) for f in futs]
    for ids, n in SEQUENTIAL:  # each admitted into an idle loop
        settle(sched)
        outs.append(sched.submit(ids, max_new_tokens=n).result(timeout=300))
    recs = quiesced(sched)
    return outs, recs, sched.prefix_telemetry, sched.prefix_registry()


def columns(recs):
    return [{k: v for k, v in r.items() if k not in CLOCK} for r in recs]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_flight_records_and_prefix_registry_match_jax(both, layout):
    kw = dict(BASE, kv_layout=layout, **({"kv_page_size": 8} if layout == "paged" else {}))
    want = run_traffic(make(both, True, **kw))
    got = run_traffic(make(both, False, **kw))
    assert got[0] == want[0]
    assert columns(got[1]) == columns(want[1])
    assert [r["round"] for r in got[1]] == list(range(1, len(got[1]) + 1))
    assert {r["phase"] for r in got[1]} == {"decode"}
    assert any(r.get("prefix_reuse") for r in got[1])
    if layout == "paged":
        # No page leaks: once idle, the pages in use are the cache's.
        assert got[1][-1]["kv_pages"] >= got[2]["resident_tokens"] // 8
    assert got[2] == want[2]
    assert got[2]["hits"] > 0 and got[2]["reinserts"] == 0
    assert got[3] == want[3]
    assert got[3]["entries"] and got[3]["reuse_distance"]


def test_prefix_digest_equals_jax():
    from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
        prefix_digest as jax_digest,
    )

    for ids in ([1], PREFIX, list(range(300)), [2**31 - 1, 0, 5]):
        assert prefix_digest(ids) == jax_digest(ids)


@pytest.mark.parametrize("spill", [False, True], ids=["recompute", "spill"])
def test_pressure_events_match_jax(both, spill):
    """Page pressure (`kv:pressure` withholds pages from an overcommitted
    pool) preempts and resumes: the same preempt and resume events (slot,
    rid, generated tokens, spill, mode) and the same round records."""
    res = []
    for jax_side, faults in ((True, JAX_FAULTS), (False, FAULTS)):
        sched = make(both, jax_side, **PRESSURE, kv_spill=spill)
        faults.configure("kv:pressure:1:3", 0)
        try:
            futs = queue_then_start(sched, [(p, 24) for p in STORM])
            outs = [f.result(timeout=300) for f in futs]
            recs = quiesced(sched)
        finally:
            faults.clear()
        res.append((outs, columns(recs)))
    assert res[1] == res[0]
    events = [r for r in res[1][1] if "kind" in r]
    assert {e["kind"] for e in events} == {"preempt", "resume"}
    assert all(e["mode"] == ("spill" if spill else "recompute")
               for e in events if e["kind"] == "resume")


def test_crash_event_matches_jax(both):
    """`sched:crash` kills the loop at a harvest: a `crash` event with the
    error's type and text, and the futures fail typed."""
    kinds = []
    for jax_side, faults in ((True, JAX_FAULTS), (False, FAULTS)):
        sched = make(both, jax_side, **BASE)
        faults.configure("sched:crash:1", 0)
        try:
            futs = queue_then_start(sched, [([1, 5, 9], 8)])
            with pytest.raises(Exception):
                futs[0].result(timeout=300)
            sched._thread.join(60)
        finally:
            faults.clear()
        kinds.append([{k: v for k, v in r.items() if k not in CLOCK}
                      for r in sched.flight.snapshot() if "kind" in r])
    assert kinds[1] == kinds[0]
    assert kinds[1][-1]["kind"] == "crash"


def test_ledger_columns_recompute_from_the_record(both):
    """Every record's mfu/hbm_util/bound is `round_attribution` (or
    `mixed_attribution` for a ragged mixed round) of the record's own
    columns; the per-phase EWMAs count the same rounds."""
    for kw in (dict(BASE), dict(BASE, kv_layout="paged", kv_page_size=8, ragged=True)):
        sched = make(both, False, **kw)
        futs = queue_then_start(sched, BURST)
        [f.result(timeout=300) for f in futs]
        recs = [r for r in quiesced(sched) if "mfu" in r]
        pm = sched.perf
        for rec in recs:
            if rec["phase"] == "mixed":
                att = pm.mixed_attribution(
                    rows=sched.num_slots, dec_tokens=sched.decode_chunk,
                    dec_ctx=rec["perf_ctx"], pre_rows=rec["pre_rows"],
                    pre_tokens=rec["pre_tokens"], pre_ctx=rec["pre_ctx"],
                    wall_s=rec["round_wall_s"])
            else:
                att = pm.round_attribution(rec["phase"], rows=sched.num_slots,
                                           tokens=sched.decode_chunk,
                                           ctx=rec["perf_ctx"], wall_s=rec["round_wall_s"])
            assert (rec["mfu"], rec["hbm_util"], rec["bound"]) == \
                (att["mfu"], att["hbm_util"], att["bound"])
        phases = sched.perf_stats["phases"]
        for phase in {r["phase"] for r in recs}:
            assert phases[phase]["rounds"] == sum(r["phase"] == phase for r in recs)
        assert "prefill" in phases
        if kw.get("ragged"):
            assert any(r["phase"] == "mixed" for r in recs)


def test_speculative_rounds_are_the_verify_phase(both):
    sched = make(both, False, **BASE, speculative_draft=2)
    futs = queue_then_start(sched, [([1, 5, 9, 2], 6), ([1, 7, 3], 6)])
    [f.result(timeout=300) for f in futs]
    recs = [r for r in quiesced(sched) if "mfu" in r]
    assert recs and all(r["phase"] == "verify" and "spec_emitted" in r for r in recs)
    assert {"draft", "verify"} <= set(sched.perf_stats["phases"])
    assert sched.prefix_telemetry is None  # reuse is off under speculation


@pytest.mark.parametrize("tree", ["bf16", "int4", "int8", "int8_unembed"])
def test_param_bytes_equal_jax_for_bridged_trees(tree):
    """The ledger's weight bytes (what a decode step streams) equal JAX's
    sum of leaf bytes for the same bridged tree: packing and scales are
    stored alike."""
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.bfloat16)
    jt = {"bf16": lambda p: p, "int4": lambda p: jax_q4(p, group=32),
          "int8": jax_q8, "int8_unembed": lambda p: jax_qu(jax_q8(p))}[tree](jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jt), device="cpu")
    want = int(sum(x.nbytes for x in jax.tree.leaves(jt)))
    assert sum(t.nbytes for t in _leaves(tp)) == want
    sched = ContinuousBatchingScheduler(TINY, tp, **BASE, device="cpu")
    assert sched.perf.param_bytes == want
    assert sched.perf.weight_bits == {"bf16": 16, "int4": 4}.get(tree, 8)


# --------------------------------------------------------- the profile hook

def wait_capture(sched, timeout=120.0):
    """Poll profile_status until the capture finished (a bound on the wait,
    not a measurement)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        last = sched.profile_status().get("last")
        if last and last["state"] in ("done", "error", "aborted"):
            return last
        time.sleep(0.02)
    raise AssertionError(f"capture never finished: {sched.profile_status()}")


def test_profile_hook_captures_rounds_on_the_cpu(both, tmp_path):
    sched = make(both, False, **BASE).start()
    try:
        assert sched.profile_status()["state"] == "idle"
        with pytest.raises(ValueError):
            sched.profile_rounds(0)
        out = sched.profile_rounds(2, out_dir=str(tmp_path))
        assert out["state"] == "armed" and out["rounds"] == 2
        assert sched.profile_status()["state"] == "armed"
        assert traceprof.capture_owner() is not None
        with pytest.raises(RuntimeError, match="already in flight"):
            sched.profile_rounds(2, out_dir=str(tmp_path))
        sched.generate([[1, 5, 9], [1, 7]], max_new_tokens=12)
        last = wait_capture(sched)
        assert last["state"] == "done", last
        assert last["artifacts"] and all(a.endswith(".trace.json.gz")
                                         for a in last["artifacts"])
        assert last["artifact_bytes"] > 0
        assert traceprof.capture_owner() is None
        tr = traceprof.Trace().load_dir(str(last["dir"]))
        assert tr.op_time_s() > 0.0 and tr.top_ops(1)
        kinds = [r.get("kind") for r in sched.flight.snapshot()]
        assert kinds.count("profile_start") == kinds.count("profile_done") == 1
        # Exactly the captured rounds lie between the two events.
        start, done = kinds.index("profile_start"), kinds.index("profile_done")
        assert sum(k is None for k in kinds[start:done]) >= 2
    finally:
        sched.shutdown()


def test_profile_abort_on_shutdown_releases_the_guard(both, tmp_path):
    sched = make(both, False, **BASE).start()
    sched.profile_rounds(1000, out_dir=str(tmp_path))
    sched.shutdown()
    assert traceprof.capture_owner() is None
    assert sched.profile_status()["last"]["state"] == "aborted"


def test_profile_route_arms_refuses_and_polls(both, tmp_path):
    """/debug/profile over a scheduler backend: rounds=0 is a 400, an arm
    answers its state, a second arm while the first is in flight is a 409,
    and a bare GET polls until the capture is done."""
    (tmp_path / "in").mkdir()
    tok = ByteTokenizer()
    svc = GenerationService()
    svc.register("a", SchedulerBackend(make(both, False, **BASE), tok, max_new_tokens=8))
    svc.register("b", SchedulerBackend(make(both, False, **BASE), tok, max_new_tokens=8))
    cfg = AppConfig(input_dir=str(tmp_path / "in"), output_dir=str(tmp_path / "out"),
                    history_db=":memory:", profile_dir=str(tmp_path / "prof"))
    client = create_api_app(svc, SQLiteBackend, SQLiteHistory(), cfg).test_client()
    try:
        assert client.request("GET", "/debug/profile", query="rounds=0").status == 400
        res = client.request("GET", "/debug/profile", query="rounds=2&model=a")
        assert res.status == 200 and res.json()["state"] == "armed"
        assert res.json()["model"] == "a"
        assert client.request("GET", "/debug/profile", query="rounds=2&model=b").status == 409
        assert client.request("GET", "/debug/profile",
                              query="rounds=2&model=nope").status == 400
        for _ in range(2):
            svc.generate("a", "select", max_new_tokens=8)
        deadline = time.time() + 120
        while time.time() < deadline:
            caps = client.get("/debug/profile").json()["captures"]
            if caps["a"].get("last", {}).get("state") == "done":
                break
            time.sleep(0.02)
        assert caps["a"]["last"]["state"] == "done" and caps["a"]["last"]["artifacts"]
        assert caps["b"]["state"] == "idle"
        rounds = client.get("/debug/flightrecorder").json()["models"]["a"]
        assert {"profile_start", "profile_done"} <= {r.get("kind") for r in rounds}
    finally:
        svc.close()


# ------------------------------------------- queue wait, spans, supervisor

def test_queue_wait_reaches_completion_result_and_registry(both):
    """A request behind a full slot batch waits in the queue: its queue
    wait is admission less submit, on the Completion, the GenerateResult
    and the registry's percentiles (and no larger than its latency)."""
    sched = make(both, False, **dict(BASE, num_slots=1))
    backend = SchedulerBackend(sched, ByteTokenizer(), max_new_tokens=8)
    svc = GenerationService()
    svc.register("m", backend)
    try:
        results = [None] * 3
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, svc.generate("m", f"query {i}"))) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert all(r is not None for r in results)
        for r in results:
            assert 0.0 < r.queue_wait_s <= r.latency_s
            assert 0.0 < r.ttft_s <= r.latency_s
        snap = svc.metrics_snapshot()["m"]
        assert snap["requests"] == 3
        assert {"queue_wait_p50_s", "ttft_p50_s"} <= set(snap)
        hist = svc.metrics.histograms.snapshot()
        assert hist["lsot_queue_wait_seconds"][0]["count"] == 3
        assert hist["lsot_queue_wait_seconds"][0]["labels"] == {
            "model": "m", "replica": "r0", "class": "plain"}
        c = backend.complete("one more")
        assert c.queue_wait_s > 0.0 and c.replica == "r0" and c.rclass == ""
    finally:
        svc.close()


def test_sampled_request_trace_carries_sched_spans(both):
    old = (tracing.TRACER.sample, tracing.TRACER.export_dir)
    tracing.TRACER.reconfigure(sample=1.0)
    svc = GenerationService()
    svc.register("m", SchedulerBackend(make(both, False, **BASE), ByteTokenizer(),
                                       max_new_tokens=6))
    try:
        res = svc.generate("m", "count the rows", request_id="req-flight")
        trace = next(t for t in svc.recent_traces() if t["request_id"] == "req-flight")
        names = [s["name"] for s in trace["spans"]]
        assert {"sched.queue_wait", "sched.prefill", "sched.decode",
                "sched.round"} <= set(names), names
        assert res.request_id == "req-flight"
    finally:
        svc.close()
        tracing.TRACER.sample, tracing.TRACER.export_dir = old


def test_supervisor_merges_lifecycle_and_rounds(both, tmp_path):
    sup = SupervisedScheduler(lambda: make(both, False, **BASE), name="scheduler:t")
    backend = SchedulerBackend(sup, ByteTokenizer(), max_new_tokens=6)
    try:
        backend.complete_batch([("x" * 30), ("x" * 30), ("x" * 30)])
        snap = backend.flight_snapshot()
        kinds = [r.get("kind") for r in snap]
        assert "start" in kinds and None in kinds
        assert [r["ts"] for r in snap] == sorted(r["ts"] for r in snap)
        stats = backend.stats()
        assert {"supervisor", "scheduler"} <= set(stats["flight_recorder"])
        assert stats["perf"]["device_kind"] == "" and "watchdog" in stats
        assert stats["prefix"]["replica"] == "r0"
        reg = backend.prefix_registry(2)
        assert reg["top_k"] == 2 and reg["enabled"]
        hottest = sup.resident_digests(1)
        assert len(hottest) == 1 and hottest[0] in {e["digest"] for e in
                                                    backend.prefix_registry()["entries"]}
        out = backend.profile_rounds(1000, str(tmp_path))
        assert out["state"] == "armed" and backend.profile_status()["state"] == "armed"
    finally:
        backend.shutdown()
    assert traceprof.capture_owner() is None

"""The port's multi-tenant front door (serve/qos.py) and the scheduler's
tenant half, on the CPU, against the JAX package's:

- every `serve/qos.py` function and class on the same inputs, with the
  bucket clock injected (`now`);
- the scheduler's weighted-fair queueing: a two-tenant storm (8 `batch`
  requests of one tenant, 2 `interactive` of another, queued before the
  loop starts) admits in the same order, with equal `qos_stats` and equal
  greedy tokens, on TINY at f32 with bridged weights; the start-time fair
  order and the weights on staged requests; the page waiters' expiry in
  deadline order;
- `LSOT_QOS=0`, and unlabeled traffic with QoS on, admit FIFO with the
  same tokens;
- prefix digests and the registry with tenant namespacing on and off;
- HTTP twins of the JAX package's tests/test_qos.py over FakeBackend: the
  storm shed 429 with Retry-After while the quiet tenant is served, an
  unknown class 400 with the header winning over the JSON field, a shed
  stream a 429 before its headers.

No assertion reads wall time."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.serve import qos as jq
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from llm_based_apache_spark_optimization_tpu.serve.scheduler import _Request as JaxRequest
from llm_based_apache_spark_optimization_tpu_torch.app import AppConfig, create_api_app
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    FakeBackend,
    GenerationService,
)
from llm_based_apache_spark_optimization_tpu_torch.serve import qos as tq
from llm_based_apache_spark_optimization_tpu_torch.serve.resilience import (
    Deadline,
    DeadlineExceeded,
    Overloaded,
)
from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import _Request
from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend

BASE = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,))
PREFIX = [1] + list(range(5, 28))  # 24 tokens: 3 blocks of 8
#: The storm: 8 `batch` requests of tenant "storm", then 2 `interactive`
#: of tenant "quiet", (ids, budget, tenant, qos), prompts of mixed length.
STORM = ([([1] + [5 + (i * 7 + j) % 40 for j in range(3 + i % 4)], 6 + i % 3,
           "storm", "batch") for i in range(8)]
         + [([1, 3, 4, 8], 5, "quiet", "interactive"),
            ([1, 11, 12, 13, 14], 7, "quiet", "interactive")])


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
    """Submit every (ids, budget, tenant, qos) before the loop starts
    (submit needs a running loop: a stand-in thread object passes its
    check), then start it: both loops see the same arrivals."""
    sched._thread = threading.current_thread()
    try:
        futs = [sched.submit(ids, max_new_tokens=n, tenant=t, qos=q)
                for ids, n, t, q in traffic]
    finally:
        sched._thread = None
    sched.start()
    return futs


def settle(sched, timeout=120.0):
    """Wait for the loop to hold no slot and no round in flight: futures
    resolve at retirement, before the rounds issued with the retired slot
    are harvested. A bound on the wait, not a measurement."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not sched._pending and not sched._prefill_q and \
                all(r is None for r in sched._slot_req):
            return
        time.sleep(0.005)
    raise AssertionError("scheduler did not settle")


def settle_and_stop(sched):
    settle(sched)
    sched.shutdown()


def admitted_order(sched):
    return [rid for r in sched.flight.snapshot() if "admitted" in r for rid in r["admitted"]]


# ------------------------------------------------------- serve/qos.py parity


@pytest.mark.parametrize("fn,args", [
    ("normalize_qos", ("interactive",)), ("normalize_qos", ("  Batch ",)),
    ("normalize_qos", ("REPLAY",)), ("normalize_qos", ("",)), ("normalize_qos", (None,)),
    ("normalize_qos", ("premium",)),
    ("parse_tenant_weights", ("a=4, b=1.5, junk, c=oops, =2, d=-1",)),
    ("parse_tenant_weights", ("",)),
    ("parse_tenant_models", ("a=duckdb-nsql, b=llama3.2,junk,=x,c=",)),
    ("tenant_salt", ("",)), ("tenant_salt", ("acme",)), ("tenant_salt", ("ünï",)),
    ("qos_enabled", ()), ("prefix_tenant_ns_enabled", ()),
])
def test_qos_functions_equal_jax(fn, args):
    def call(mod):
        try:
            return getattr(mod, fn)(*args)
        except ValueError as e:
            return ("ValueError", str(e))

    assert call(tq) == call(jq)
    assert (tq.QOS_CLASSES, tq.DEFAULT_TENANT, tq.OTHER_TENANT, tq.TENANT_TOPK) == \
        (jq.QOS_CLASSES, jq.DEFAULT_TENANT, jq.OTHER_TENANT, jq.TENANT_TOPK)


def test_bounded_bump_equals_jax():
    outs = []
    for mod in (tq, jq):
        counters = {}
        for i in range(6):
            mod.bounded_bump(counters, f"t{i % 5}", top_k=3)
        mod.bounded_bump(counters, "", top_k=99)
        mod.bounded_bump(counters, "t1", amount=2.5, top_k=3)
        outs.append(counters)
    assert outs[0] == outs[1]
    assert outs[0][tq.OTHER_TENANT] == 2 and outs[0][tq.DEFAULT_TENANT] == 1


@pytest.mark.parametrize("rate,burst", [(2.0, 4.0), (0.0, 1.0), (0.5, 0.2)])
def test_token_bucket_equals_jax_on_an_injected_clock(rate, burst):
    """take/refill_eta over the same clock stamps: the same decisions,
    levels and ETAs."""
    stamps = [100.0, 100.0, 100.0, 100.0, 100.0, 100.25, 100.5, 101.0, 1e6, 1e6, 1e6]
    outs = []
    for mod in (tq, jq):
        b = mod.TokenBucket(rate=rate, burst=burst)
        outs.append([(b.take(1.0, now=t), round(b.level, 9), b.refill_eta(1.0, now=t))
                     for t in stamps])
    assert outs[0] == outs[1]


def test_bucket_registry_equals_jax():
    outs = []
    for mod in (tq, jq):
        reg = mod.TenantBucketRegistry(rate_spec="1,interactive=2",
                                       burst_spec="interactive=2", max_buckets=3)
        seq = [reg.check(t, c, now=1.0 + 0.1 * i)
               for i, (t, c) in enumerate([("a", "interactive")] * 4
                                          + [(f"t{k}", "") for k in range(5)]
                                          + [("a", "batch"), ("b", "batch")])]
        outs.append((seq, sorted(reg._buckets), reg.bucket("z", "replay") is None))
    assert outs[0] == outs[1]
    assert ("_other", "") in outs[0][1]


def test_admission_controller_equals_jax():
    """The same admit sequence on both controllers: the same sheds, the
    same bucket-aware Retry-After (max of refill ETA and the fleet hint),
    the same snapshot (admit/shed counters; bucket levels at their own
    clock, compared rounded) and per-class deadlines."""
    outs = []
    for mod in (tq, jq):
        ctl = mod.AdmissionController()
        ctl.reconfigure(enabled=True, rate="2", burst="2",
                        deadlines={"interactive": 1.5, "batch": 0.0})
        seq = []
        for tenant, qos, hint in [("acme", "batch", 0.0)] * 3 + [("acme", "batch", 7.5),
                                                                 ("", "", 1.0),
                                                                 ("b", "interactive", 0.0)]:
            try:
                ctl.admit(tenant, qos, fleet_hint=hint)
                seq.append("ok")
            except mod.TenantShed as e:
                seq.append((type(e).__mro__[1].__name__, e.tenant, e.qos,
                            round(e.retry_after_s, 1)))
        snap = ctl.snapshot()
        snap.pop("bucket_level")
        snap["shed_wait_s"] = {k: round(v, 1) for k, v in snap["shed_wait_s"].items()}
        outs.append((seq, snap, [ctl.default_deadline(c) for c in ("interactive",
                                                                    "batch", "")]))
        off = mod.AdmissionController()
        off.reconfigure(enabled=False, rate="0.0001", burst="1")
        for _ in range(5):
            off.admit("storm", "batch", fleet_hint=9.0)
        quiet = mod.AdmissionController()
        quiet.reconfigure(enabled=True, rate="", burst="")
        quiet.admit("", "")
        outs[-1] += (off.snapshot(), quiet.snapshot())
    assert outs[0] == outs[1]
    assert outs[0][0][3][0] == "Overloaded" and outs[0][0][3][3] == 7.5


# --------------------------------------------------- the scheduler's tenant half


def test_two_tenant_storm_admission_order_and_tokens_equal_jax(both):
    """8 `batch` requests of "storm" then 2 `interactive` of "quiet", all
    queued before the loop starts over 2 slots: the port admits them in
    JAX's WFQ order (the quiet tenant ahead of the storm's backlog), with
    the same `qos_stats` and the same greedy tokens."""
    runs = []
    for jax_side in (True, False):
        sched = make(both, jax_side, **BASE)
        futs = queue_then_start(sched, STORM)
        outs = [f.result(timeout=300) for f in futs]
        settle_and_stop(sched)
        runs.append((outs, admitted_order(sched), sched.qos_stats()))
    (jouts, jorder, jstats), (outs, order, stats) = runs
    assert outs == jouts
    assert order == jorder
    assert stats == jstats
    assert stats["submitted"] == {"storm": 8, "quiet": 2}
    # WFQ: the quiet tenant's two requests are admitted ahead of the
    # storm's tail (rids 9, 10 before storm rids 5-8).
    assert order.index(9) < order.index(5) and order.index(10) < order.index(6)
    assert order != sorted(order)


def test_qos_off_and_unlabeled_traffic_admit_fifo_with_the_same_tokens(both, monkeypatch):
    """`LSOT_QOS=0` carries the labels and reads none of them: FIFO
    admission, no vft or salt stamps, no stats block; unlabeled traffic
    with QoS on is one tenant, FIFO too. Both give the JAX scheduler's
    tokens."""
    unlabeled = [(ids, n, "", "") for ids, n, _, _ in STORM]
    monkeypatch.setenv("LSOT_QOS", "0")
    off = make(both, False, **BASE)
    futs = queue_then_start(off, STORM)
    out_off = [f.result(timeout=300) for f in futs]
    settle_and_stop(off)
    assert admitted_order(off) == list(range(1, len(STORM) + 1))
    assert off.qos_stats() is None and off._ready == [] and off._wfq_vt == 0.0
    assert all(f._lsot_request.vft == 0.0 and f._lsot_request.ns == () for f in futs)
    monkeypatch.delenv("LSOT_QOS")
    runs = []
    for jax_side in (True, False):
        sched = make(both, jax_side, **BASE)
        futs = queue_then_start(sched, unlabeled)
        runs.append([f.result(timeout=300) for f in futs])
        settle_and_stop(sched)
        if not jax_side:
            assert admitted_order(sched) == list(range(1, len(STORM) + 1))
            assert sched.qos_stats()["submitted"] == {"default": len(STORM)}
    assert runs[0] == runs[1] == out_off


@pytest.mark.parametrize("weights,want", [
    ("", ["storm", "light", "storm", "storm"]),
    ("light=0.25", ["storm", "storm", "storm", "light"]),
    ("light=4", ["light", "storm", "storm", "storm"]),
])
def test_wfq_order_of_staged_requests_equals_jax(both, monkeypatch, weights, want):
    """Requests staged in the ready pool leave in start-time fair order,
    scaled by LSOT_TENANT_WEIGHTS, in both packages; the per-tenant
    counters and each tenant's prefix salt agree."""
    monkeypatch.setenv("LSOT_TENANT_WEIGHTS", weights)
    orders = []
    for jax_side, req_cls in ((True, JaxRequest), (False, _Request)):
        sched = make(both, jax_side, **BASE)
        from concurrent.futures import Future

        reqs = [req_cls(ids=[1] * 8, max_new=8, temperature=0.0, top_p=1.0, top_k=0,
                        seed=0, future=Future(), tenant=t)
                for t in ("storm", "storm", "storm", "light")]
        with sched._submit_lock:
            for i, r in enumerate(reqs):
                r.rid = i + 1
                sched._stamp_qos_locked(r)
                sched._ready.append(r)
        order = []
        while (r := sched._ready_pop()) is not None:
            order.append((r.tenant, r.vft, r.ns))
        orders.append((order, sched.qos_stats()))
    assert orders[0] == orders[1]
    assert [t for t, _, _ in orders[1][0]] == want


def test_page_waiters_expire_in_deadline_order(both):
    """Under WFQ the page waiters are in service order: expiry still fails
    them typed in deadline order, as in JAX, and a live waiter stays."""
    from concurrent.futures import Future

    sched = make(both, False, **BASE, kv_layout="paged", kv_page_size=8, kv_pages=16)
    now = time.monotonic()
    failed = []
    reqs = {}
    for tag, tenant, exp in (("later", "light", now - 1.0), ("earlier", "heavy", now - 2.0),
                             ("alive", "heavy", now + 30.0)):
        r = _Request(ids=[1, 2], max_new=8, temperature=0.0, top_p=1.0, top_k=0, seed=0,
                     future=Future(), tenant=tenant, deadline=Deadline(exp))
        r.submitted_at = time.perf_counter()
        r.future.add_done_callback(lambda f, t=tag: failed.append(t))
        sched._page_wait.append(r)
        reqs[tag] = r
    sched._sweep_page_wait()
    assert failed == ["earlier", "later"]
    for tag in ("earlier", "later"):
        with pytest.raises(DeadlineExceeded):
            reqs[tag].future.result(timeout=1)
    assert list(sched._page_wait) == [reqs["alive"]]


@pytest.mark.parametrize("ns", ["1", "0"], ids=["tenant_ns_on", "tenant_ns_off"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefix_digests_and_registry_equal_jax(both, monkeypatch, ns, layout):
    """Two tenants share a schema prefix: with namespacing on, each
    tenant's cache keys and digests carry its salt (the tenants neither
    match nor evict each other's entries), off they share the entries; in
    both cases the registry, the telemetry and the tokens equal JAX's."""
    monkeypatch.setenv("LSOT_PREFIX_TENANT_NS", ns)
    kw = dict(BASE, kv_layout=layout, **({"kv_page_size": 8} if layout == "paged" else {}))
    traffic = [(PREFIX + [40 + i], 5, tenant, "batch")
               for i, tenant in enumerate(["a", "b", "a", "b", "a", "b", ""])]
    runs = []
    for jax_side in (True, False):
        sched = make(both, jax_side, **kw)
        outs = []
        sched.start()
        for ids, n, t, q in traffic:  # one at a time, each into an idle loop
            settle(sched)
            outs.append(sched.submit(ids, max_new_tokens=n, tenant=t, qos=q).result(timeout=300))
        settle_and_stop(sched)
        runs.append((outs, sched.prefix_telemetry, sched.prefix_registry(),
                     sorted(sched.resident_digests())))
    assert runs[1] == runs[0]
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        prefix_chain_digests,
        prefix_digest,
    )

    digests = set(runs[1][3])
    salted = prefix_digest(tq.tenant_salt("a") + tuple(PREFIX[:16]))
    shared = prefix_digest(PREFIX[:16])
    assert (salted in digests) == (ns == "1") and (shared in digests) == (ns == "0")
    assert prefix_chain_digests(PREFIX, 8, tq.tenant_salt("a"))[1] == salted


# ------------------------------------------------------------ HTTP twins

CSV = "VendorID,total_amount\n1,12.5\n2,25.0\n"


def _api_clients(tmp_path):
    """The port's API app and the JAX package's, each over a FakeBackend
    that answers `SELECT 1;`."""
    from llm_based_apache_spark_optimization_tpu.app import AppConfig as JaxAppConfig
    from llm_based_apache_spark_optimization_tpu.app import create_api_app as jax_api
    from llm_based_apache_spark_optimization_tpu.history import SQLiteHistory as JaxHistory
    from llm_based_apache_spark_optimization_tpu.serve import FakeBackend as JaxFake
    from llm_based_apache_spark_optimization_tpu.serve import GenerationService as JaxService
    from llm_based_apache_spark_optimization_tpu.sql import SQLiteBackend as JaxSQLite

    kw = dict(input_dir=str(tmp_path / "input"), output_dir=str(tmp_path / "output"),
              history_db=":memory:", secret_key="test-secret")
    tsvc = GenerationService()
    tsvc.register("duckdb-nsql", FakeBackend(lambda p: "SELECT 1;"))
    jsvc = JaxService()
    jsvc.register("duckdb-nsql", JaxFake(lambda p: "SELECT 1;"))
    return (create_api_app(tsvc, SQLiteBackend(), SQLiteHistory(), AppConfig(**kw)).test_client(),
            jax_api(jsvc, JaxSQLite(), JaxHistory(), JaxAppConfig(**kw)).test_client())


@pytest.fixture()
def admissions():
    """Both packages' process-wide controllers, reset to the environment's
    settings afterwards."""
    yield tq.ADMISSION, jq.ADMISSION
    tq.ADMISSION.reconfigure()
    jq.ADMISSION.reconfigure()


def _gen(client, tenant, qos="batch", **body):
    return client.post_json("/api/generate",
                            {"model": "duckdb-nsql", "prompt": "hi", **body},
                            headers={"X-Lsot-Tenant": tenant, "X-Lsot-Qos": qos})


def test_http_two_tenants_storm_shed_quiet_served_as_jax(tmp_path, admissions):
    """The storm tenant blows its bucket and gets typed 429s with a
    Retry-After; the quiet tenant is served; the counters reach /metrics
    and the lsot_tenant_* families; the same statuses and counters as the
    JAX app."""
    views = []
    for adm, client in zip(admissions, _api_clients(tmp_path)):
        adm.reconfigure(enabled=True, rate="1", burst="2")
        storm = [_gen(client, "storm") for _ in range(5)]
        quiet = _gen(client, "quiet", qos="interactive")
        snap = client.get("/metrics").json()
        text = client.get("/metrics", query="format=prometheus").text
        views.append(([r.status for r in storm], quiet.status, quiet.json()["response"],
                      [float(r.headers["Retry-After"]) >= 1 for r in storm if r.status == 429],
                      snap["qos"]["admitted"], snap["qos"]["shed"],
                      sorted(line.split(" ")[0] for line in text.splitlines()
                             if line.startswith("lsot_tenant_") and "bucket" not in line)))
    assert views[0] == views[1]
    statuses, quiet_status, answer, retry_ok, admitted, shed, families = views[0]
    assert statuses == [200, 200, 429, 429, 429] and all(retry_ok)
    assert quiet_status == 200 and answer == "SELECT 1;"
    assert admitted["quiet/interactive"] == 1 and shed["storm/batch"] == 3
    assert 'lsot_tenant_shed_total{qos="batch",tenant="storm"}' in families


def test_http_unknown_qos_is_400_and_the_header_wins_as_jax(tmp_path, admissions):
    views = []
    for adm, client in zip(admissions, _api_clients(tmp_path)):
        adm.reconfigure(enabled=True, rate="100", burst="100")
        bad = client.post_json("/api/generate",
                               {"model": "duckdb-nsql", "prompt": "hi", "qos": "premium"})
        ok = client.post_json(
            "/api/generate",
            {"model": "duckdb-nsql", "prompt": "hi", "tenant": "body-t", "qos": "batch"},
            headers={"X-Lsot-Tenant": "header-t", "X-Lsot-Qos": "replay"})
        views.append((bad.status, "unknown qos class" in bad.json()["error"], ok.status,
                      adm.snapshot()["admitted"]))
    assert views[0] == views[1] == (400, True, 200, {"header-t/replay": 1})


def test_http_streaming_shed_is_a_429_before_the_headers_as_jax(tmp_path, admissions):
    views = []
    for adm, client in zip(admissions, _api_clients(tmp_path)):
        adm.reconfigure(enabled=True, rate="1", burst="1")
        body = {"stream": True}
        first = _gen(client, "s", qos="interactive", **body)
        second = _gen(client, "s", qos="interactive", **body)
        views.append((first.status, second.status, "Retry-After" in second.headers))
    assert views[0] == views[1] == (200, 429, True)


def test_tenant_shed_is_an_overloaded_and_unknown_model_a_typed_4xx(tmp_path, admissions):
    """A `TenantShed` rides the Overloaded -> 429 mapping; an unregistered
    model is a 404 on /api/generate, before any admission is charged."""
    assert issubclass(tq.TenantShed, Overloaded)
    client = _api_clients(tmp_path)[0]
    admissions[0].reconfigure(enabled=True, rate="1", burst="1")
    res = client.post_json("/api/generate", {"model": "nope", "prompt": "hi"},
                           headers={"X-Lsot-Tenant": "t"})
    assert res.status == 404 and "not registered" in res.json()["error"]
    assert admissions[0].snapshot() == {}

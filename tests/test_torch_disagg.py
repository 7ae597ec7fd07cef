"""Phase roles and the prefill -> decode KV handoff in the port, on the CPU
against the JAX package (TINY at f32, paged, pages of 8, the same bridged
weights; replicas built as tests/test_disagg.py builds them).

Twins of the JAX package's 19 cases (tests/test_disagg.py):

- the roles' parse and validation, with JAX's messages;
- the blob's round trip over the bf16, f32 and int8 pools, and JAX's
  blob imported into the port's pool (one wire format);
- a `prefill:1,decode:1` fleet: greedy tokens equal to JAX's split fleet
  and to the port's mixed control, its `handoff_stats` counts equal to
  JAX's; sampled, constrained and speculative streams equal to the port's
  mixed control (sampled streams cannot be JAX's: another RNG);
- `phase_role="mixed"` is the scheduler without roles, bit for bit;
- a lone prefill replica decodes in place; streaming across the handoff;
- the handoff span, flight columns and events as JAX's;
- the four placement units, the decode-side pressure storm, a prefill
  replica crashing mid-handoff under the supervisor (nothing lost), the
  drain of a prefill replica;

and the pump depth's backpressure, as JAX's. Every wait has a timeout; no
assertion reads wall time."""

import threading
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.engine import paged_kv as jax_kv
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.serve import resilience as jax_res
from llm_based_apache_spark_optimization_tpu.serve import scheduler as jax_sched
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine import paged_kv as t_kv
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.ops.sampling import SamplingParams
from llm_based_apache_spark_optimization_tpu_torch.serve import resilience as t_res
from llm_based_apache_spark_optimization_tpu_torch.serve import scheduler as t_sched
from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

PKGS = {"jax": dict(sched=jax_sched, res=jax_res),
        "torch": dict(sched=t_sched, res=t_res)}
PROMPTS = [[1, 5, 9], [1, 7], [1, 3, 4, 8, 10], [1, 11, 12, 13]]
#: handoff_stats keys whose values are counts (the wait sum is a wall).
COUNTS = ("phase_role", "exports", "imports", "inplace_fallbacks", "pages_out",
          "pages_in", "bytes_out", "bytes_in", "wait_count", "queued_handoffs",
          "backpressure")


@pytest.fixture(scope="module")
def both():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def generic_sql():
    """The port's generic Spark-SQL grammar over the ByteTokenizer (stop id
    2), compiled once for the module."""
    from llm_based_apache_spark_optimization_tpu_torch.constrain import get_constraint
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    return tok, get_constraint("spark_sql", tok, (2,))


def make_sched(both, side, role="mixed", **kw):
    kw = dict(dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,),
                   kv_layout="paged", kv_page_size=8), **kw)
    jp, tp = both
    if side == "jax":
        return jax_sched.ContinuousBatchingScheduler(JAX_TINY, jp, phase_role=role, **kw)
    return t_sched.ContinuousBatchingScheduler(TINY, tp, phase_role=role, device="cpu",
                                               **kw)


def split_pool(both, side, **kw):
    return PKGS[side]["sched"].SchedulerPool([make_sched(both, side, "prefill", **kw),
                                              make_sched(both, side, "decode", **kw)])


def counts(hs):
    """A pool's handoff_stats without the walls, by replica."""
    return {r["replica"]: {k: r[k] for k in COUNTS} for r in hs["replicas"]}


def serve(pool, reqs, timeout=120):
    """Submit (ids, max_new, sampling, seed, constraint) requests at once;
    their outputs in order."""
    with pool:
        futs = [pool.submit(ids, max_new_tokens=mn, sampling=sp, seed=sd, constraint=c)
                for ids, mn, sp, sd, c in reqs]
        return [f.result(timeout=timeout) for f in futs]


def greedy(prompts, n):
    return [(p, n, SamplingParams(), 0, None) for p in prompts]


def control(both, reqs, **kw):
    """The port's mixed control: one replica, each request alone."""
    with make_sched(both, "torch", **kw) as ctl:
        return [ctl.submit(ids, max_new_tokens=mn, sampling=sp, seed=sd,
                           constraint=c).result(timeout=120)
                for ids, mn, sp, sd, c in reqs]


# ----------------------------------------------------------- unit: roles

@pytest.mark.parametrize("spec,n", [
    ("", 3), ("prefill:1,decode:3", 4), ("mixed:2", 2), ("prefill:1,decode:1", 3),
    ("prefil:1,decode:1", 2), ("prefill", 1), ("prefill:2", 2), ("decode:x", 1),
    ("decode:0", 1), (" prefill:1 , decode:1 ", 2),
])
def test_parse_pool_phases_as_jax(spec, n):
    """Each spec gives JAX's roles or JAX's error message."""
    out = {}
    for side, pkg in PKGS.items():
        try:
            out[side] = pkg["sched"].parse_pool_phases(spec, n)
        except ValueError as e:
            out[side] = ("ValueError", str(e))
    assert out["torch"] == out["jax"]
    assert t_sched.PHASE_ROLES == jax_sched.PHASE_ROLES


def test_phase_role_validation_as_jax(both, monkeypatch):
    """An unknown role, and a role on the contiguous layout, raise JAX's
    messages; "mixed" takes either layout; ragged rounds: `ragged=True`
    raises on a phase-split replica and `LSOT_RAGGED=1` degrades silently,
    as in JAX."""
    for kw in (dict(role="draft"), dict(role="prefill", kv_layout="contiguous"),
               dict(role="decode", ragged=True)):
        msgs = []
        for side in PKGS:
            with pytest.raises(ValueError) as e:
                make_sched(both, side, **kw)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
    make_sched(both, "torch", role="mixed", kv_layout="contiguous")
    monkeypatch.setenv("LSOT_RAGGED", "1")
    assert [make_sched(both, side, role="prefill")._ragged for side in PKGS] == [
        False, False]
    assert make_sched(both, "torch")._ragged is True


# --------------------------------------------- wire format: export/import

@pytest.mark.parametrize("quant,dtype", [(None, torch.bfloat16), (None, torch.float32),
                                         ("int8", torch.float32)])
def test_export_import_roundtrip(quant, dtype):
    """The blob is a host copy of every pool array (int8 scales beside
    their values): a later write to the source does not move it, an import
    into other pages of another pool lands it exactly, and its bytes are
    `handoff_bytes`."""
    pool = t_kv.init_page_pool(TINY, 6, 8, dtype=dtype, device="cpu", kv_quant=quant)
    for i, arr in enumerate(pool.values()):
        arr.copy_(torch.randn(arr.shape, generator=torch.Generator().manual_seed(i))
                  .mul(20).to(arr.dtype))
    blob = t_kv.export_pages(pool, [1, 3])
    assert len(blob) == len(pool) and all(isinstance(b, np.ndarray) for b in blob)
    assert all(b.shape[1] == 2 for b in blob)
    frozen = [b.copy() for b in blob]
    for arr in pool.values():
        arr[:, 1] = 0
    for b, f in zip(blob, frozen):
        np.testing.assert_array_equal(b, f)
    dst = {k: torch.zeros_like(v) for k, v in pool.items()}
    t_kv.import_pages(dst, [4, 0], blob)
    for (k, arr), b in zip(dst.items(), blob):
        got = arr[:, [4, 0]]
        want = torch.from_numpy(b)
        if got.dtype == torch.bfloat16:
            want = want.view(torch.bfloat16)
        assert torch.equal(got, want), k
    assert t_kv.handoff_bytes(blob) == sum(b.nbytes for b in blob)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_jax_blob_imports_into_the_port_pool(quant):
    """One wire format: JAX's pool and the port's hold the same arrays in
    the same order and geometry, so a JAX export lands in a port pool
    bit for bit, and the port's export of it equals JAX's."""
    jpool = jax_kv.init_page_pool(JAX_TINY, 6, 8, dtype=jnp.float32, kv_quant=quant)
    rng = np.random.default_rng(0)
    jcache = []
    for k in jpool:
        a = jpool[k]
        fill = (rng.integers(-127, 128, a.shape) if a.dtype == jnp.int8
                else rng.standard_normal(a.shape))
        jcache.append(jnp.asarray(fill, a.dtype))
    jblob = jax_kv.export_pages(jcache, [1, 3])
    tpool = t_kv.init_page_pool(TINY, 6, 8, dtype=torch.float32, device="cpu",
                                kv_quant=quant)
    assert list(tpool) == [k for k in jpool if k != "ptab"]
    t_kv.import_pages(tpool, [2, 5], jblob)
    for got, want in zip(t_kv.export_pages(tpool, [2, 5]), jblob):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert t_kv.handoff_bytes(jblob) == jax_kv.handoff_bytes(jblob)


# --------------------------------------------------------------- fleets

def test_handoff_allocator_invariants_and_cow_prefix_as_jax(both):
    """Shared-prefix traffic through a split fleet: tokens equal to JAX's
    split fleet and to the port's mixed control, the source's prefix cache
    shares pages before each export, both allocators stay consistent and
    release every migrated request's pages, and the handoff counts equal
    JAX's."""
    shared = [1, 5, 9, 2, 6, 3, 7, 4]
    reqs = greedy([shared + [10 + i] for i in range(4)], 5)
    got = {}
    for side in PKGS:
        pool = split_pool(both, side)
        outs = []
        with pool:
            for ids, mn, *_ in reqs:  # one at a time: the same prefix-cache churn
                outs.append(pool.submit(ids, max_new_tokens=mn).result(timeout=120))
        pre, dec = pool.schedulers
        for s in (pre, dec):
            s._page_alloc.check()
            assert all(not pages for pages in s._slot_pages)
        assert pre._page_alloc.shares > 0
        assert pre._page_alloc.pages_in_use <= sum(len(v) for v in pre._prefix_pages.values())
        assert dec._page_alloc.pages_in_use == 0
        got[side] = (outs, counts(pool.handoff_stats), pre._page_alloc.shares)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == control(both, reqs)
    per = got["torch"][1]
    assert per["r0"]["exports"] == 4 and per["r1"]["imports"] == 4
    assert per["r0"]["pages_out"] == per["r1"]["pages_in"] > 0
    assert per["r0"]["bytes_out"] == per["r1"]["bytes_in"] > 0


def test_export_import_int8_scales_preserved_as_jax(both):
    """An int8 pool hands off its pages with their f32 scales: the split
    fleet's tokens equal the port's int8 mixed control and JAX's int8
    split fleet, with JAX's handoff counts."""
    reqs = greedy(PROMPTS, 5)
    outs = {}
    for side in PKGS:
        pool = split_pool(both, side, kv_quant="int8")
        outs[side] = (serve(pool, reqs), counts(pool.handoff_stats))
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == control(both, reqs, kv_quant="int8")
    assert outs["torch"][1]["r1"]["imports"] == 4


def queue_then_start(sched, prompts, n):
    """Submit every prompt before the loop starts (a stand-in thread passes
    submit's check), then start it: two schedulers see the same arrivals at
    their first iteration, so the same admissions and rounds."""
    sched._thread = threading.current_thread()
    try:
        futs = [sched.submit(p, max_new_tokens=n) for p in prompts]
    finally:
        sched._thread = None
    sched.start()
    return futs


def settle(sched, timeout=60.0):
    """Wait until the loop holds no slot and no round, and has come back to
    the top of its loop since (a harvest records its round after resolving
    its futures). A bound on the wait, not a measurement."""
    import time as _t

    deadline = _t.monotonic() + timeout
    while _t.monotonic() < deadline:
        if not sched._pending and all(r is None for r in sched._slot_req):
            beats = sched.heartbeat._beats
            while _t.monotonic() < deadline and sched.heartbeat._beats == beats:
                _t.sleep(0.005)
            return dict(sched.page_stats)
        _t.sleep(0.005)
    raise AssertionError("scheduler did not settle")


def test_mixed_role_default_reproduces_today_bitforbit(both):
    """`phase_role="mixed"` is the scheduler without roles: the same
    tokens, page accounting and flight records (walls aside), no handoff
    stats, events or columns, for the same arrivals."""
    tp = both[1]
    kw = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,),
              kv_layout="paged", kv_page_size=8, device="cpu")
    got = []
    for sched in (t_sched.ContinuousBatchingScheduler(TINY, tp, **kw),
                  make_sched(both, "torch", role="mixed")):
        try:
            outs = [f.result(timeout=120) for f in queue_then_start(sched, PROMPTS, 6)]
            got.append((outs, settle(sched), sched.flight.snapshot(),
                        sched.handoff_stats))
        finally:
            sched.shutdown()
    (out_a, stats_a, snap_a, _), (out_b, stats_b, snap_b, ho_b) = got
    assert ho_b is None
    assert out_a == out_b and stats_a == stats_b
    strip = ("ts", "round_wall_s", "cadence_s", "mfu", "hbm_util", "bound",
             "prefill_mfu", "prefill_hbm_util", "perf_ctx")

    def core(snap):
        return [{k: v for k, v in r.items() if k not in strip} for r in snap]

    assert core(snap_a) == core(snap_b)
    for rec in snap_b:
        assert "handoffs" not in rec and "pages_migrated" not in rec
        assert rec.get("kind", "") not in ("handoff_export", "handoff_import",
                                           "handoff_inplace")


def test_phase_split_parity_greedy_sampled_constrained(both, generic_sql):
    """The split fleet's greedy, sampled and grammar-constrained streams
    equal the port's mixed control's token for token (the stream index
    restored at 1, the grammar replayed); its greedy unconstrained streams
    equal JAX's split fleet's."""
    tok, cm = generic_sql
    budget = max(16, cm.min_new_tokens)
    reqs = [([1, 5, 9], 6, SamplingParams(), 40, None),
            ([1, 7, 11], 6, SamplingParams(temperature=0.8, top_p=0.9), 41, None),
            (tok.encode("SELECT", add_bos=True), budget, SamplingParams(), 42, cm),
            ([1, 3, 4, 8], 6, SamplingParams(temperature=0.5, top_k=8), 43, None),
            ([1, 11, 12, 13], 6, SamplingParams(), 44, None)]
    kw = dict(stop_ids=(2,), max_seq=96)
    pool = split_pool(both, "torch", **kw)
    outs = serve(pool, reqs)
    assert outs == control(both, reqs, **kw)
    assert sum(r["exports"] for r in pool.handoff_stats["replicas"]) == len(reqs)
    plain = [r for r in reqs if r[2].temperature <= 0 and r[4] is None]
    jax_outs = serve(split_pool(both, "jax", **kw), plain)
    assert [o for o, r in zip(outs, reqs) if r in plain] == jax_outs


def test_phase_split_parity_speculative(both):
    """Speculative traffic (greedy and sampled) across the handoff: the
    importer rebuilds the draft history from the committed prefix and
    restores the stream index, so the split fleet's verify rounds emit
    the port's mixed control's tokens."""
    kw = dict(speculative_draft=2)
    reqs = [([1, 5, 9, 5, 9], 6, SamplingParams(temperature=0.9, top_k=8), 11, None),
            ([1, 6, 2, 6, 2], 6, SamplingParams(), 0, None),
            ([1, 7, 3, 7, 3], 6, SamplingParams(temperature=0.7), 12, None)]
    pool = split_pool(both, "torch", **kw)
    assert serve(pool, reqs) == control(both, reqs, **kw)
    assert sum(r["imports"] for r in pool.handoff_stats["replicas"]) == len(reqs)
    dec = pool.schedulers[1]
    assert dec.speculation_stats["verify_rounds"] > 0


def test_lone_prefill_replica_decodes_in_place_as_jax(both):
    """A prefill replica with no consumer (no pool) decodes in place, with
    JAX's tokens and counts and the mixed control's tokens."""
    got = {}
    for side in PKGS:
        with make_sched(both, side, role="prefill") as lone:
            outs = [lone.submit(p, max_new_tokens=6).result(timeout=60) for p in PROMPTS]
            hs = lone.handoff_stats
        got[side] = (outs, {k: hs[k] for k in COUNTS})
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == control(both, greedy(PROMPTS, 6))
    assert got["torch"][1]["inplace_fallbacks"] == len(PROMPTS)
    assert got["torch"][1]["exports"] == 0


def test_streaming_and_ttft_across_handoff(both):
    """The stream spans the handoff: the first token comes from the prefill
    replica's thread at pack time, the rest from the decode replica's, in
    order, no duplicate, equal to the control's; the first token is
    delivered before the decode replica imports the request."""
    golden = control(both, greedy(PROMPTS[:1], 6))[0]
    pool = split_pool(both, "torch")
    streamed, threads = [], []

    def on_token(tok):
        streamed.append(tok)
        threads.append(threading.current_thread())

    with pool:
        pre, dec = pool.schedulers
        fut = pool.submit(PROMPTS[0], max_new_tokens=6, on_token=on_token)
        out = fut.result(timeout=120)
        pre_thread, dec_thread = pre._thread, dec._thread
    assert out == golden and streamed == golden
    assert threads[0] is pre_thread and set(threads[1:]) == {dec_thread}
    snap = pool.flight_snapshot()
    kinds = [r.get("kind") for r in snap]
    assert kinds.index("handoff_export") < kinds.index("handoff_import")


def test_handoff_observability_span_columns_stats_as_jax(both):
    """The sched.handoff span (pages, bytes, export seconds, wait, source),
    the export event in the trace, the handoff_export / handoff_place /
    handoff_import events, the decode replica's pages_migrated /
    handoff_wait_s columns and the prefill replica's pack records carry
    JAX's keys and counts."""
    from llm_based_apache_spark_optimization_tpu.utils.tracing import (
        RequestTrace as JaxTrace,
    )
    from llm_based_apache_spark_optimization_tpu_torch.utils.tracing import RequestTrace

    seen = {}
    for side, trace_cls in (("jax", JaxTrace), ("torch", RequestTrace)):
        pool = split_pool(both, side)
        tr = trace_cls("req-handoff")
        with pool:
            out = pool.submit(PROMPTS[2], max_new_tokens=5, trace=tr).result(timeout=120)
        assert out
        d = tr.to_dict()
        spans = {s["name"]: s for s in d["spans"]}
        ho = spans["sched.handoff"]
        assert ho["attrs"]["pages"] >= 1 and ho["attrs"]["bytes"] > 0
        assert ho["attrs"]["wait_s"] >= 0.0 and ho["attrs"]["src"] == "r0"
        events = {r["kind"]: r for r in pool.flight_snapshot()
                  if str(r.get("kind", "")).startswith("handoff_")}
        pre, dec = pool.schedulers
        mig = [r for r in dec.flight.snapshot() if "pages_migrated" in r]
        packs = [r for r in pre.flight.snapshot() if r.get("handoffs")]
        assert mig and mig[0]["handoff_wait_s"] >= 0.0
        assert packs and packs[-1]["phase"] == "prefill"
        seen[side] = dict(
            span={k: ho["attrs"][k] for k in ("pages", "bytes", "src")},
            span_keys=sorted(ho["attrs"]),
            trace_events=sorted(e["name"] for e in d.get("events", [])
                                if e["name"].startswith("sched.handoff")),
            has_export_span="sched.handoff_export" in spans,
            events={k: (sorted(v), v.get("pages")) for k, v in events.items()},
            migrated=mig[0]["pages_migrated"],
            pack=(sorted(packs[-1]), packs[-1]["handoffs"], packs[-1]["emitted"]),
            counts=counts(pool.handoff_stats))
    assert seen["torch"] == seen["jax"]
    assert set(seen["torch"]["events"]) == {"handoff_export", "handoff_place",
                                            "handoff_import"}


def test_replica_loads_and_health_carry_phase_role_as_jax(both):
    got = {}
    for side in PKGS:
        pool = split_pool(both, side)
        with pool:
            pool.submit(PROMPTS[0], max_new_tokens=4).result(timeout=120)
            loads = {r["replica"]: r for r in pool.replica_loads()}
            health = {r["replica"]: r for r in pool.replica_health()}
        got[side] = ({lb: {k: v for k, v in r.items()
                           if k in ("phase_role", "handoff_exports", "handoff_imports",
                                    "handoff_queued")} for lb, r in loads.items()},
                     {lb: r["phase_role"] for lb, r in health.items()})
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["r0"]["handoff_exports"] == 1
    assert got["torch"][0]["r1"]["handoff_imports"] == 1


# ------------------------------------------------- router and placement

class FakeTarget:
    """A requeue-capable fake with a scripted backlog, role and decode
    pressure, for the placement units."""

    def __init__(self, role="decode", secs=0.0, hbm=0.0, reject=False):
        self.phase_role = role
        self.secs, self.hbm, self.reject = secs, hbm, reject
        self.taken = []
        self._crash = None

    def start(self):
        return self

    def shutdown(self, timeout=None):
        pass

    def backlog_score(self):
        return self.secs, 0

    @property
    def perf_stats(self):
        return {"phases": {"decode": {"hbm_util": self.hbm}}}

    def requeue(self, req):
        if self.reject:
            raise ValueError("incompatible")
        self.taken.append(req)

    def submit(self, ids, **kw):
        f = Future()
        f.set_result(list(ids))
        return f


class FakeReq:
    def __init__(self):
        self.deadline = None
        self.future = Future()
        self.rid = 1
        self.handoff = {"pages": 2}


def taken(targets):
    return [bool(t.taken) for t in targets]


def twin(scenario):
    got = {side: scenario(pkg) for side, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_place_handoff_prefers_low_pressure_decode_replica():
    def scenario(pkg):
        ts = [FakeTarget("prefill"), FakeTarget("decode", hbm=0.9),
              FakeTarget("decode", hbm=0.2), FakeTarget("mixed")]
        pkg["sched"].SchedulerPool(ts)._place_handoff(FakeReq(), 0)
        return taken(ts)

    assert twin(scenario) == [False, False, True, False]


def test_place_handoff_falls_back_to_mixed_then_source():
    def scenario(pkg):
        ts = [FakeTarget("prefill"), FakeTarget("decode", reject=True),
              FakeTarget("mixed")]
        pkg["sched"].SchedulerPool(ts)._place_handoff(FakeReq(), 0)
        # Every sibling refuses: the source takes it back (decode in place).
        ts2 = [FakeTarget("prefill"), FakeTarget("decode", reject=True)]
        pool2 = pkg["sched"].SchedulerPool(ts2)
        pool2._place_handoff(FakeReq(), 0)
        ev = [r for r in pool2.flight_snapshot() if r.get("kind") == "handoff_place"]
        return taken(ts), taken(ts2), [(e["to"], e["src"], e["inplace"]) for e in ev]

    assert twin(scenario) == ([False, False, True], [True, False],
                              [("r0", "r0", True)])


def test_deadline_spills_over_to_idle_decode_replicas():
    """A deadline the prefill tier cannot meet goes to an idle decode
    replica instead of a 504; with every tier infeasible the 504 fires."""
    def scenario(pkg):
        backed_up = FakeTarget("prefill", secs=30.0)
        idle_dec = FakeTarget("decode", secs=0.1)
        pool = pkg["sched"].SchedulerPool([backed_up, idle_dec])
        fut = pool.submit([1, 2], deadline_s=1.0)
        idle_dec.secs = 40.0
        with pytest.raises(pkg["res"].DeadlineExceeded, match="no replica can serve"):
            pool.submit([3], deadline_s=1.0)
        return fut.result(), fut._lsot_replica

    assert twin(scenario) == ([1, 2], "r1")


def test_new_requests_avoid_decode_role_replicas():
    def scenario(pkg):
        pool = pkg["sched"].SchedulerPool([FakeTarget("decode"), FakeTarget("prefill")])
        fut = pool.submit([1, 2, 3])
        # Only decode replicas placeable: they still serve (roles are
        # routing policy, not capability).
        lone = pkg["sched"].SchedulerPool([FakeTarget("decode")]).submit([4])
        return fut.result(), fut._lsot_replica, lone.result()

    assert twin(scenario) == ([1, 2, 3], "r1", [4])


# ------------------------------------------------------------ chaos

@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_decode_side_pressure_storm_token_identical(both):
    """`kv:pressure` withholds 9 of the decode pool's 14 pages: imports go
    through page waits or preemptions, and every request still completes
    with the mixed control's tokens (a sampled one included)."""
    reqs = [([1, 5, 9], 8, SamplingParams(), 30, None),
            ([1, 7, 11], 8, SamplingParams(temperature=0.8), 31, None),
            ([1, 3, 4, 8], 8, SamplingParams(), 32, None)]
    kw = dict(max_seq=96)
    golden = control(both, reqs, **kw)
    pool = t_sched.SchedulerPool([
        make_sched(both, "torch", "prefill", **kw),
        make_sched(both, "torch", "decode", kv_pages=14, kv_overcommit=0.25, **kw)])
    FAULTS.configure("kv:pressure:1:9", seed=0)
    try:
        with pool:
            futs = [pool.submit(ids, max_new_tokens=mn, sampling=sp, seed=sd)
                    for ids, mn, sp, sd, _ in reqs]
            outs = [f.result(timeout=300) for f in futs]
            stats = dict(pool.schedulers[1].page_stats)
    finally:
        FAULTS.clear()
    assert outs == golden
    assert stats["preemptions"] > 0 or stats["page_waits"] > 0, stats


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_prefill_crash_mid_handoff_zero_lost(both, generic_sql):
    """A supervised `prefill:1,decode:1` fleet, greedy, sampled and
    constrained traffic in two waves: the first clean (every request
    handed off), the second under `sched:handoff:1`, which kills the
    prefill replica mid-handoff (its first token committed and streamed,
    the blob never shipped). Only the prefill replica restarts; its
    journaled requests re-prefill on the decode sibling with the delivered
    token suppressed; both waves equal the mixed control, each stream
    equals its result (no token twice), nothing is lost."""
    import random

    from llm_based_apache_spark_optimization_tpu_torch.serve.supervisor import (
        SupervisedScheduler,
    )

    tok, cm = generic_sql
    budget = max(16, cm.min_new_tokens)
    reqs = [([1, 5, 9], 8, SamplingParams(), 700, None),
            ([1, 7, 11], 8, SamplingParams(temperature=0.8, top_p=0.95), 701, None),
            (tok.encode("SELECT", add_bos=True), budget, SamplingParams(), 702, cm),
            ([1, 3, 4, 8], 8, SamplingParams(), 703, None)]
    kw = dict(stop_ids=(2,), max_seq=96)
    golden = control(both, reqs, **kw)
    roles = ["prefill", "decode"]
    policy = t_res.RetryPolicy(max_attempts=4, base_delay_s=0.001, max_delay_s=0.01)

    def rebuild(i):
        if i == 0:
            FAULTS.clear()  # one crash episode: the rebuilt prefill replica runs clean
        return make_sched(both, "torch", roles[i], **kw)

    def make_pool():
        return t_sched.SchedulerPool([make_sched(both, "torch", r, **kw) for r in roles],
                                     factory=rebuild, max_restarts=3,
                                     restart_policy=policy, rng=random.Random(0))

    sup = SupervisedScheduler(make_pool, max_restarts=3, restart_policy=policy,
                              rng=random.Random(0)).start()

    def wave():
        streams = [[] for _ in reqs]
        futs = [sup.submit(ids, max_new_tokens=mn, sampling=sp, seed=sd, constraint=c,
                           on_token=streams[i].append)
                for i, (ids, mn, sp, sd, c) in enumerate(reqs)]
        outs = []
        for f in futs:
            try:
                outs.append(f.result(timeout=300))
            except Exception:  # noqa: BLE001 — lost, counted below
                outs.append(None)
        return outs, streams

    try:
        clean, clean_streams = wave()
        pool = sup._inner
        exports = sum(r["exports"] for r in pool.handoff_stats["replicas"])
        FAULTS.configure("sched:handoff:1", 0)
        crash, crash_streams = wave()
        crashes = sum(1 for r in pool.flight_snapshot()
                      if r.get("kind") == "replica_crash" and r.get("replica") == "r0")
        loads = {r["replica"]: r for r in pool.replica_loads()}
        health = sup.health()
    finally:
        FAULTS.clear()
        sup.shutdown()
    assert clean == golden and crash == golden
    assert clean_streams == golden and crash_streams == golden
    assert exports == len(reqs)
    assert crashes >= 1 and loads["r0"]["restarts"] >= 1
    assert loads["r1"]["restarts"] == 0
    assert health["lost"] == 0 and health["restarts"] == 0


def test_drain_prefill_replica_preserves_handoffs_as_jax(both):
    """A drained prefill replica's queued work, packed handoffs included,
    re-places on its sibling: nothing is shed, tokens as JAX's and as the
    mixed control's."""
    got = {}
    for side in PKGS:
        roles = ["prefill", "mixed"]
        pool = PKGS[side]["sched"].SchedulerPool(
            [make_sched(both, side, r) for r in roles],
            factory=lambda i, side=side, roles=roles: make_sched(both, side, roles[i]))
        with pool:
            futs = [pool.submit(p, max_new_tokens=5) for p in PROMPTS]
            pool.drain_replica("r0", deadline_s=30.0)
            got[side] = [f.result(timeout=120) for f in futs]
    assert got["torch"] == got["jax"] == control(both, greedy(PROMPTS, 5))


# ---------------------------------------------------------- backpressure

def test_pump_depth_backpressure_decodes_in_place_as_jax(both, monkeypatch):
    """`LSOT_PUMP_DEPTH=1`: of two prompts completing in one prefill chunk
    only the first is exported while the pump has not drained; the second
    decodes in place, counted as backpressure. Requests queued before the
    prefill replica's loop starts, so both packages see the same
    arrivals: JAX's tokens, placements and counts."""
    monkeypatch.setenv("LSOT_PUMP_DEPTH", "1")
    got = {}
    for side in PKGS:
        pool = split_pool(both, side)
        pre, dec = pool.schedulers
        assert pre._pump_depth == 1
        dec.start()
        pre._thread = threading.current_thread()  # submit's check, before the loop
        try:
            futs = [pool.submit(p, max_new_tokens=5) for p in PROMPTS]
        finally:
            pre._thread = None
        with pool:
            outs = [f.result(timeout=120) for f in futs]
        place = [(r["to"], r.get("inplace")) for r in pool.flight_snapshot()
                 if r.get("kind") == "handoff_place"]
        got[side] = (outs, counts(pool.handoff_stats), place)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == control(both, greedy(PROMPTS, 5))
    per = got["torch"][1]
    assert per["r0"]["backpressure"] >= 1
    assert per["r0"]["inplace_fallbacks"] == per["r0"]["backpressure"]
    assert per["r0"]["exports"] + per["r0"]["inplace_fallbacks"] == len(PROMPTS)

"""`warmup()` of the port's scheduler and pool against the JAX package's,
on the CPU in f32 (TINY, the same bridged params, 3 slots: k-buckets 1, 2
and 3, `decode_chunk=4`, `prompt_bucket=8`).

Twins of JAX's `test_warmup_compiles_all_kbuckets_without_state_change`
(tests/test_scheduler.py) over the contiguous and paged layouts, the int8
KV cache, speculation, ragged mixed rounds and a grammar-constrained
request after the warmup: a scheduler serves, stops, warms, serves again.
The warmup runs one forward for each of JAX's k-buckets and one parked
round; every cache position below the park position (a pool: every page)
is bit-identical after it, and so are the counters, the slot state, the
perf ledger and the flight ring; the streams equal JAX's scheduler's,
warmed the same way. Then the pool's warmup, the pool's rebuild (the
fresh replica warms before it starts), a tp=2 mesh over gloo (every
follower's cache unchanged), and the bench-artifact seed, the
`LSOT_STOK_SEED_BENCH` knob and the supervisor's `model_id` /
`prefix_affinity` passthroughs beside JAX's."""

import dataclasses
import json
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.constrain.masks import (
    CompiledMask as JaxCompiledMask,
)
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.serve import backends as jax_backends
from llm_based_apache_spark_optimization_tpu.serve import scheduler as jax_sched
from llm_based_apache_spark_optimization_tpu.serve import supervisor as jax_sup
from llm_based_apache_spark_optimization_tpu_torch.constrain import get_constraint
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.serve import backends as t_backends
from llm_based_apache_spark_optimization_tpu_torch.serve import resilience as t_res
from llm_based_apache_spark_optimization_tpu_torch.serve import scheduler as t_sched
from llm_based_apache_spark_optimization_tpu_torch.serve import supervisor as t_sup
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer
from torch_spmd import run_group

EOS = 2
BASE = dict(num_slots=3, decode_chunk=4, prompt_bucket=8, stop_ids=(EOS,))
FIRST = [[1, 5, 9], [1, 7, 3, 4, 8, 10, 2, 6, 11, 12]]  # served before the warmup
AFTER = [[1, 3, 4, 8, 10], [1, 11, 12, 13], [1] + [5, 9, 4] * 4]
SCHEMA = {"table": "trips", "columns": ["payment_type", "tip_amount"]}
PAGED = dict(kv_layout="paged", kv_page_size=8)
CASES = {
    "contiguous": dict(),
    "contiguous_int8": dict(kv_quant="int8"),
    "contiguous_spec": dict(speculative_draft=4),
    "contiguous_constrained": dict(),
    "paged": PAGED,
    "paged_int8": dict(PAGED, kv_quant="int8"),
    "paged_spec": dict(PAGED, speculative_draft=4),
    "paged_int8_spec_constrained": dict(PAGED, kv_quant="int8", speculative_draft=4),
    "paged_ragged": dict(PAGED, ragged=True),
}


@pytest.fixture(scope="module")
def both():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def schema():
    """The two-column schema grammar over the byte tokenizer: compiled in
    the port, JAX's mask built from the same host tables."""
    tc = get_constraint(SCHEMA, ByteTokenizer(), (EOS,))
    jc = JaxCompiledMask(**{f.name: getattr(tc, f.name)
                            for f in dataclasses.fields(JaxCompiledMask)})
    return jc, tc


def serve(sched, prompts, constraint=None, budget=6):
    """Submit `prompts` at once (the first under `constraint`, if any, with
    a budget that holds a whole parse)."""
    futs = [sched.submit(p, max_new_tokens=24 if i == 0 and constraint else budget,
                         constraint=constraint if i == 0 else None)
            for i, p in enumerate(prompts)]
    return [f.result(timeout=300) for f in futs]


def wait_idle(sched, timeout=30.0):
    """Futures resolve before the worker frees their slots: poll."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(r is not None for r in sched._slot_req):
        time.sleep(0.01)


def device_state(s):
    """Every cache position below the park position (a page pool: every
    page), the slot state and the draft history below max_seq."""
    if s._paged:
        cache = {n: p.clone() for n, p in s._pool.items()}
        cache["ptab"] = s._ptab.clone()
    else:
        cache = {n: c[:, :, :, :s._park].clone() for n, c in s._cache.items()}
    slots = {n: getattr(s, n).clone() for n in ("_cur", "_pos", "_temps", "_topps",
                                                "_topks", "_seeds", "_counts",
                                                "_cstates", "_crem")}
    if s._spec_draft:
        slots["_hist"] = s._hist[:, :s.max_seq].clone()
        slots["_hlen"] = s._hlen.clone()
    return {**cache, **slots}


def host_state(s):
    """Counters, the perf ledger (its pending prefill pile included), the
    flight ring and, paged, the allocator's counts."""
    counters = {n: getattr(s, n) for n in ("rounds_issued", "prefill_forwards",
                                           "mixed_rounds", "ragged_prefills",
                                           "grammar_swaps")}
    ledger = (s.perf_stats, s.perf._pending_prefill_flops, s.perf._pending_prefill_bytes)
    pages = s.page_stats if s._paged else None
    return counters, ledger, s.flight.snapshot(), s.flight_stats, pages, s.prefix_stats


def assert_same(before, after):
    assert before.keys() == after.keys()
    for n in before:
        assert torch.equal(before[n], after[n]), n


def counting_forward(monkeypatch):
    """Count `models.llama.forward` calls of the port's scheduler."""
    calls = []
    real = t_sched.forward

    def counted(*a, **kw):
        calls.append(a[2].shape[1])  # T of the tokens
        return real(*a, **kw)

    monkeypatch.setattr(t_sched, "forward", counted)
    return calls


@pytest.mark.parametrize("case", list(CASES))
def test_warmup_runs_every_kbucket_without_state_change(both, schema, case, monkeypatch):
    """Serve, stop, warm, serve again, in both packages: the port's warmup
    runs one forward for each of JAX's k-buckets at the prompt bucket (a
    ragged scheduler one mixed round) and one parked round, changes no
    visible state, and the streams after it equal JAX's warmed
    scheduler's."""
    jp, tp = both
    jc, tc = schema
    kw = dict(BASE, **CASES[case])
    constrained = case.endswith("constrained")
    jaxs = jax_sched.ContinuousBatchingScheduler(JAX_TINY, jp, **kw)
    jaxs.warmup()
    with jaxs:
        want = (serve(jaxs, FIRST), serve(jaxs, AFTER, jc if constrained else None))

    port = t_sched.ContinuousBatchingScheduler(TINY, tp, **kw, device="cpu")
    assert port._kbuckets() == jaxs._kbuckets == [1, 2, 3]
    with port:
        first = serve(port, FIRST)
        wait_idle(port)
    dev, host = device_state(port), host_state(port)
    calls = counting_forward(monkeypatch)
    port.warmup()
    steps = 1 if port._spec_draft else port.decode_chunk
    if port._ragged:  # one mixed round (its T = 8 step, then T = 1 steps), one round
        assert calls == [8] + [1] * (port.decode_chunk - 1) + [1] * port.decode_chunk
    else:
        assert calls == [8] * 3 + [port._spec_draft + 1 if port._spec_draft else 1] * steps
    assert_same(dev, device_state(port))
    assert host == host_state(port)
    with port:
        got = (first, serve(port, AFTER, tc if constrained else None))
    assert got == want
    if constrained:
        assert tc.walk(got[1][0] + [EOS]) is not None


def test_warmup_prompt_len_picks_the_chunk_bucket(both, monkeypatch):
    """`prompt_len` picks the smallest chunk bucket that holds it, as JAX's
    warmup does; past the largest bucket, the prompt bucket."""
    _, tp = both
    s = t_sched.ContinuousBatchingScheduler(TINY, tp, num_slots=2, decode_chunk=2,
                                            prompt_bucket=32, device="cpu")
    assert s._buckets == [16, 32]
    for prompt_len, t in ((5, 16), (17, 32), (100, 32), (None, 32)):
        calls = counting_forward(monkeypatch)
        s.warmup(prompt_len)
        assert calls == [t, t, 1, 1], prompt_len


def test_kernel_libraries_follow_the_configuration(both):
    """The libraries a warmup loads are those its configuration launches:
    the flash prefill (not under ragged mixed rounds), the contiguous
    decode or the paged attention and page write, their int8 twins, the
    int8 cache's verify window, and the quantized trees' matmuls."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
        quantize_params,
        quantize_params_int4,
    )

    _, tp = both

    def libs(params=tp, **kw):
        return t_sched.ContinuousBatchingScheduler(
            TINY, params, **dict(BASE, **kw), device="cpu")._kernel_libraries()

    assert libs() == ["flash_gqa_attention"]
    assert libs(kv_quant="int8") == ["flash_gqa_attention", "flash_gqa_attention_quantized"]
    assert libs(kv_quant="int8", speculative_draft=4) == [
        "flash_gqa_attention", "flash_gqa_attention_quantized",
        "ragged_paged_attention_quantized"]
    assert libs(**PAGED) == ["flash_gqa_attention", "ragged_paged_attention",
                             "fused_page_write"]
    assert libs(**PAGED, kv_quant="int8", ragged=True) == [
        "ragged_paged_attention_quantized", "fused_page_write_quantized"]
    assert libs(quantize_params_int4(tp, group=32)) == ["flash_gqa_attention",
                                                        "int4_matmul"]
    assert libs(quantize_params(tp), **PAGED) == [
        "flash_gqa_attention", "ragged_paged_attention", "fused_page_write",
        "int8_matmul"]


def test_load_all_builds_stale_libraries_together(monkeypatch):
    """`_build.load_all` starts one build for each stale library of the
    list before it waits for any, then loads each once."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import _build

    events = []
    monkeypatch.setattr(_build, "_loaded", {"fresh_loaded": object()})
    monkeypatch.setattr(_build, "_stale", lambda n: n != "fresh")
    monkeypatch.setattr(_build, "_start", lambda n: events.append(("start", n)) or n)
    monkeypatch.setattr(_build, "_finish", lambda n, p: events.append(("finish", n)))
    monkeypatch.setattr(_build, "load", lambda n: events.append(("load", n)))
    _build.load_all(["a", "fresh", "b", "fresh_loaded"])
    assert events == [("start", "a"), ("start", "b"), ("finish", "a"), ("finish", "b"),
                      ("load", "a"), ("load", "fresh"), ("load", "b"),
                      ("load", "fresh_loaded")]


def test_pool_warmup_reaches_every_replica(both, monkeypatch):
    """`SchedulerPool.warmup(prompt_len)` warms each replica with that
    prompt length, as JAX's does; a replica without a warmup (a remote
    transport) is skipped. The warmed pool's streams equal a JAX
    scheduler's."""
    jp, tp = both
    reps = [t_sched.ContinuousBatchingScheduler(TINY, tp, **BASE, device="cpu")
            for _ in range(2)]
    seen = []
    for i, s in enumerate(reps):
        real = s.warmup
        monkeypatch.setattr(s, "warmup", lambda n=None, i=i, real=real: (
            seen.append((i, n)), real(n)))
    states = [device_state(s) for s in reps]
    pool = t_sched.SchedulerPool(reps)
    pool.warmup(5)
    assert seen == [(0, 5), (1, 5)]
    for s, before in zip(reps, states):
        assert_same(before, device_state(s))
    with pool:
        got = [pool.submit(p, max_new_tokens=6).result(timeout=300) for p in AFTER]
    jaxs = jax_sched.ContinuousBatchingScheduler(JAX_TINY, jp, **BASE)
    with jaxs:
        assert got == [jaxs.submit(p, max_new_tokens=6).result(timeout=300)
                       for p in AFTER]


def test_pool_rebuild_warms_the_fresh_replica_before_start(both):
    """The pool's targeted rebuild warms the fresh replica before its
    start(), as JAX's does (a spy factory records the calls)."""
    _, tp = both
    events = []

    def spy(i=None):
        s = t_sched.ContinuousBatchingScheduler(TINY, tp, **BASE, device="cpu")
        n = len([e for e in events if e[0] == "build"])
        events.append(("build", n))
        warm, start = s.warmup, s.start
        s.warmup = lambda prompt_len=None: (events.append(("warmup", n)), warm(prompt_len))
        s.start = lambda: (events.append(("start", n)), start())[1]
        return s

    pool = t_sched.SchedulerPool(
        [spy(), spy()], factory=spy, max_restarts=2,
        restart_policy=t_res.RetryPolicy(max_attempts=3, base_delay_s=0.001,
                                         max_delay_s=0.01),
        rng=random.Random(0), replica_join_s=1.0)
    with pool:
        assert pool.restart_replica("r0") is True
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            r0 = {r["replica"]: r for r in pool.replica_health()}["r0"]
            if r0["restarts"] == 1 and r0["state"] in ("ready", "degraded"):
                break
            time.sleep(0.01)
        assert pool.schedulers[0].generate(AFTER[:1], max_new_tokens=4)
    fresh = [e for e in events if e[1] == 2]
    assert fresh == [("build", 2), ("warmup", 2), ("start", 2)]
    # The pool's own start() started the first two without a warmup.
    assert ("warmup", 0) not in events and ("start", 0) in events


def test_warmup_on_a_tp2_mesh_leaves_the_followers_caches(both, tmp_path):
    """tp=2 over gloo: rank 0 warms (one posted step), each follower runs
    the same forwards over its own scratch; every rank's cache below the
    park position (a pool: every page) is unchanged after it, and rank 0's
    streams equal JAX's warmed scheduler's."""
    jp, _ = both
    cases = [dict(BASE), dict(BASE, **PAGED), dict(BASE, speculative_draft=4)]
    want = []
    for kw in cases:
        jaxs = jax_sched.ContinuousBatchingScheduler(JAX_TINY, jp, **kw)
        jaxs.warmup()
        with jaxs:
            want.append((serve(jaxs, FIRST), serve(jaxs, AFTER)))
    payload = dict(params=jax.tree.map(np.asarray, jp), cases=cases,
                   first=FIRST, after=AFTER)
    ranks = run_group(2, "warmup_group", tmp_path, payload, timeout=120.0)
    for rank, out in enumerate(ranks):
        for i, case in enumerate(out):
            assert case["unchanged"], (rank, i)
            assert case["warm_forwards"] == 3 + (
                1 if cases[i].get("speculative_draft") else 4), (rank, i)
    assert [c["streams"] for c in ranks[0]] == want


# ------------------------------------------------- the bench-artifact seed

BENCH_FIXTURES = {
    "missing": None,
    "empty": "",
    "headline": json.dumps({"metric": "decode tok/s B=8", "value": 400.0}),
    "no_batch": json.dumps({"metric": "decode tok/s", "value": 50}),
    "last_parseable": "\n".join([json.dumps({"metric": "B=4", "value": 10.0}),
                                 json.dumps({"metric": "B=16", "value": 320.0}),
                                 "{not json", "trailing text"]),
    "zero_value": json.dumps({"metric": "B=8", "value": 0}),
    "string_value": json.dumps({"metric": "B=8", "value": "fast"}),
    "not_an_object": "[1, 2, 3]\n" + json.dumps([{"value": 3}]),
    "garbage": "no json here at all",
}


@pytest.mark.parametrize("name", list(BENCH_FIXTURES))
def test_stok_seed_from_bench_matches_jax(tmp_path, name):
    """The port's parse of a bench artifact equals JAX's on the same file:
    the last parseable JSON line's value and B, None where JAX gives
    None."""
    path = tmp_path / f"{name}.jsonl"
    if BENCH_FIXTURES[name] is not None:
        path.write_text(BENCH_FIXTURES[name])
    want = jax_backends.stok_seed_from_bench(str(path))
    got = t_backends.stok_seed_from_bench(str(path))
    assert got == want
    if name == "headline":
        assert got == pytest.approx(8 / 400.0)
    if name in ("missing", "empty", "zero_value", "string_value", "garbage"):
        assert got is None


# --------------------------------------------- the supervisor passthroughs

class _Inner:
    """A duck-typed inner scheduler for the supervisor: a model id and a
    prefix-affinity feed."""

    def __init__(self, model_id):
        self.model_id = model_id
        self.asked = []

    def prefix_affinity(self, digests):
        self.asked.append(list(digests))
        return [{"replica": "r0", "blocks": len(digests)}]

    def start(self):
        return self

    def shutdown(self, timeout=None):
        pass


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_supervised_model_id_and_prefix_affinity_pass_through(pkg):
    """A supervised scheduler built with model_id "m" reports "m" and
    forwards prefix_affinity to its inner, in both packages; an inner
    without them reads "" and []."""
    sup_mod = jax_sup if pkg == "jax" else t_sup
    inner = _Inner("m")
    sup = sup_mod.SupervisedScheduler(lambda: inner)
    assert sup.model_id == "m"
    assert sup.prefix_affinity(["d1", "d2"]) == [{"replica": "r0", "blocks": 2}]
    assert inner.asked == [["d1", "d2"]]
    bare = sup_mod.SupervisedScheduler(lambda: type("Bare", (), {
        "start": lambda self: self, "shutdown": lambda self, timeout=None: None})())
    assert bare.model_id == "" and bare.prefix_affinity(["d"]) == []


def test_pool_routes_a_supervised_replica_under_its_model(both):
    """A pool that adds a supervised replica built with model_id "m" routes
    it under "m", as JAX's pool does; a supervised pool's prefix_affinity
    equals its inner pool's."""
    _, tp = both

    def build():
        return t_sched.ContinuousBatchingScheduler(TINY, tp, **BASE, model_id="m",
                                                   device="cpu")

    ours = t_sched.SchedulerPool([t_sched.ContinuousBatchingScheduler(
        TINY, tp, **BASE, model_id="base", device="cpu")])
    theirs = jax_sched.SchedulerPool([_Inner("base")])
    sup = t_sup.SupervisedScheduler(build).start()
    try:
        with ours:
            label = ours.add_replica(sup)
            jlabel = theirs.add_replica(jax_sup.SupervisedScheduler(lambda: _Inner("m")))
            assert label == jlabel
            models = {st.label: st.model_id for st in ours._states}
            jmodels = {st.label: st.model_id for st in theirs._states}
            assert models == jmodels == {"r0": "base", "r1": "m"}
            assert ours.submit(AFTER[0], max_new_tokens=4, model_id="m").result(timeout=300)
            # Placed on the supervised replica, the one carrying "m".
            assert sup._inner.prefill_forwards == 1
            assert ours.schedulers[0].prefill_forwards == 0
            ours.schedulers.pop()  # shut down below, on its own
            ours._states.pop()
    finally:
        sup.shutdown()
    pool = t_sched.SchedulerPool([t_sched.ContinuousBatchingScheduler(
        TINY, tp, **BASE, device="cpu") for _ in range(2)])
    sup = t_sup.SupervisedScheduler(lambda: pool)
    with pool:
        for _ in range(2):  # a block is published at its second sighting
            pool.generate([[1] + [5, 9, 4] * 6], max_new_tokens=2)
        digests = [d for s in pool.schedulers for d in s.resident_digests()]
        assert digests
        assert sup.prefix_affinity(digests) == pool.prefix_affinity(digests)
        assert [r["score"] for r in pool.prefix_affinity(digests)] == [len(digests)]

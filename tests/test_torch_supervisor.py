"""The port's crash supervisor (serve/supervisor.py) and watchdog
(serve/watchdog.py), on the CPU: tests/test_supervisor.py's and
tests/test_watchdog.py's single-scheduler cases against a hand-cranked fake
scheduler (journal, idempotency keys, crash -> restart -> replay with
streamed-token suppression, expired deadlines, restart budget -> dead,
drain/spill/recover, stall escalation, health states); the same contracts
over the port's real tiny scheduler with `sched:crash` and `sched:hang`
injected; the supervised scheduler against the JAX package's on bridged
weights under the same injected crash; and the app's /readyz and drain gate
over supervised backends. Every wait has its own timeout of a few seconds."""

import json
import os
import random
import threading
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_based_apache_spark_optimization_tpu_torch.app import (
    AppConfig,
    create_api_app,
)
from llm_based_apache_spark_optimization_tpu_torch.constrain import get_constraint
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.serve import GenerationService
from llm_based_apache_spark_optimization_tpu_torch.serve.backends import Completion
from llm_based_apache_spark_optimization_tpu_torch.serve.resilience import (
    DeadlineExceeded,
    Draining,
    Overloaded,
    RetryPolicy,
    SchedulerCrashed,
    SchedulerStalled,
)
from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    SchedulerBackend,
)
from llm_based_apache_spark_optimization_tpu_torch.serve.supervisor import (
    SupervisedScheduler,
)
from llm_based_apache_spark_optimization_tpu_torch.serve.watchdog import (
    CombinedHeartbeat,
    Heartbeat,
    stall_threshold,
)
from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer
from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS
from llm_based_apache_spark_optimization_tpu_torch.utils.observability import (
    resilience,
)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.clear()
    yield
    FAULTS.clear()


def wait_for(cond, timeout=5.0, msg="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {msg}")


class ManualInner:
    """Fake scheduler with the submit surface: the test resolves futures
    and triggers crashes by hand. `heartbeat` lets the watchdog judge it:
    a submit stamps busy, and then nothing stamps again (a wedge)."""

    def __init__(self):
        self.submitted = []
        self.shut = False
        self.join_timeout = "unset"
        self.heartbeat = Heartbeat()
        self._crash = None

    def start(self):
        self.heartbeat.stamp(busy=False)
        return self

    def shutdown(self, timeout=None):
        self.shut = True
        self.join_timeout = timeout
        for rec in self.submitted:
            if not rec["future"].done():
                rec["future"].set_exception(
                    RuntimeError("scheduler shut down mid-request"))

    def submit(self, ids, max_new_tokens=256, sampling=None, seed=0,
               on_token=None, constraint=None, deadline_s=None):
        if self._crash is not None:
            raise self._crash
        rec = {"ids": list(ids), "max_new": max_new_tokens, "seed": seed,
               "on_token": on_token, "deadline_s": deadline_s, "future": Future()}
        self.submitted.append(rec)
        self.heartbeat.stamp(busy=True)
        return rec["future"]

    def emit(self, i, toks):
        for t in toks:
            self.submitted[i]["on_token"](t)

    def finish(self, i, result):
        self.submitted[i]["future"].set_result(list(result))

    def crash(self, exc=None):
        self._crash = exc or SchedulerCrashed("boom")
        for rec in self.submitted:
            if not rec["future"].done():
                rec["future"].set_exception(self._crash)


class Factory:
    def __init__(self):
        self.instances = []
        self.fail_builds = 0

    def __call__(self):
        if self.fail_builds > 0:
            self.fail_builds -= 1
            raise RuntimeError("rebuild failed")
        inner = ManualInner()
        self.instances.append(inner)
        return inner


def make_sup(max_restarts=3, sleep=None, stall_min_s=0.0, **kw):
    fac = Factory()
    delays = []
    sup = SupervisedScheduler(
        fac, max_restarts=max_restarts,
        restart_policy=RetryPolicy(max_attempts=max_restarts + 1,
                                   base_delay_s=0.01, max_delay_s=0.05),
        rng=random.Random(0),
        sleep=sleep if sleep is not None else delays.append,
        stall_min_s=stall_min_s, **kw,
    )
    return sup.start(), fac, delays


# ------------------------------------------------------------------ journal

def test_journal_dedup_by_idempotency_key():
    sup, fac, _ = make_sup()
    before = resilience.get("sched_idempotent_hits")
    f1 = sup.submit([1, 2], idempotency_key="k")
    assert sup.submit([1, 2], idempotency_key="k") is f1
    inner = fac.instances[0]
    assert len(inner.submitted) == 1
    inner.finish(0, [5, 6])
    assert f1.result(timeout=5) == [5, 6]
    assert sup.submit([1, 2], idempotency_key="k").result(timeout=5) == [5, 6]
    assert len(inner.submitted) == 1  # the journaled result, no re-decode
    assert resilience.get("sched_idempotent_hits") == before + 2
    f4 = sup.submit([1, 2], idempotency_key="other")
    inner.finish(1, [9])
    assert f4.result(timeout=5) == [9]
    sup.shutdown()


@pytest.mark.parametrize("exc", [Overloaded("queue full", retry_after_s=1.0),
                                 ValueError("prompt too long")])
def test_shed_and_shape_errors_are_not_acknowledged(exc):
    sup, fac, _ = make_sup()
    inner = fac.instances[0]
    real = inner.submit

    def refusing(*a, **kw):
        raise exc

    inner.submit = refusing
    with pytest.raises(type(exc)):
        sup.submit([1], idempotency_key="k")
    inner.submit = real
    assert sup.health()["journal_depth"] == 0
    f = sup.submit([1], idempotency_key="k")
    inner.finish(0, [3])
    assert f.result(timeout=5) == [3]
    sup.shutdown()


def test_cancelled_partial_result_not_cached_for_key():
    sup, fac, _ = make_sup()
    f = sup.submit([1, 2], idempotency_key="k")
    inner = fac.instances[0]
    inner.emit(0, [9])
    sup.cancel(f)
    inner.finish(0, [9])
    assert f.result(timeout=5) == [9]
    retry = sup.submit([1, 2], idempotency_key="k")
    assert len(inner.submitted) == 2
    inner.finish(1, [9, 10, 11])
    assert retry.result(timeout=5) == [9, 10, 11]
    sup.shutdown()


# ----------------------------------------------------------- crash + replay

def test_crash_restart_replays_and_suppresses_streamed_tokens():
    sup, fac, _ = make_sup()
    toks = []
    f = sup.submit([1, 2, 3], seed=7, on_token=toks.append)
    fac.instances[0].emit(0, [10, 11])
    fac.instances[0].crash()
    wait_for(lambda: len(fac.instances) == 2, msg="restart")
    inner2 = fac.instances[1]
    wait_for(lambda: len(inner2.submitted) == 1, msg="replay")
    assert inner2.submitted[0]["ids"] == [1, 2, 3] and inner2.submitted[0]["seed"] == 7
    inner2.emit(0, [10, 11, 12])
    assert toks == [10, 11, 12]
    inner2.finish(0, [10, 11, 12])
    assert f.result(timeout=5) == [10, 11, 12]
    assert fac.instances[0].shut
    h = sup.health()
    assert (h["state"], h["restarts"], h["replayed"], h["lost"]) == ("ready", 1, 1, 0)
    sup.shutdown()


def test_replay_skips_expired_deadlines_typed():
    sup, fac, _ = make_sup()
    doomed = sup.submit([1], deadline_s=0.05)
    alive = sup.submit([2], deadline_s=60.0)
    time.sleep(0.1)
    fac.instances[0].crash()
    wait_for(lambda: len(fac.instances) == 2, msg="restart")
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=5)
    inner2 = fac.instances[1]
    wait_for(lambda: len(inner2.submitted) == 1, msg="replay")
    assert inner2.submitted[0]["deadline_s"] < 60.0
    assert sup.health()["state"] == "degraded" and sup.health()["lost"] == 1
    inner2.finish(0, [9])
    assert alive.result(timeout=5) == [9]
    wait_for(lambda: sup.health()["state"] == "ready", msg="degraded clears")
    sup.shutdown()


def test_non_idempotent_inflight_not_replayed():
    sup, fac, _ = make_sup()
    f = sup.submit([1], on_token=[].append, idempotent=False)
    queued = sup.submit([2], idempotent=False)
    fac.instances[0].emit(0, [4])
    fac.instances[0].crash()
    wait_for(lambda: len(fac.instances) == 2, msg="restart")
    with pytest.raises(SchedulerCrashed):
        f.result(timeout=5)
    inner2 = fac.instances[1]
    wait_for(lambda: len(inner2.submitted) == 1, msg="replay of queued")
    inner2.finish(0, [8])
    assert queued.result(timeout=5) == [8]
    sup.shutdown()


def test_restart_budget_then_dead():
    sup, fac, delays = make_sup(max_restarts=2)
    f = sup.submit([1])
    for n in range(2):
        fac.instances[-1].crash()
        wait_for(lambda: len(fac.instances) == n + 2, msg=f"restart {n + 1}")
        wait_for(lambda: len(fac.instances[-1].submitted) == 1, msg="replay")
    fac.instances[-1].crash()
    wait_for(lambda: sup.health()["state"] == "dead", msg="dead")
    with pytest.raises(SchedulerCrashed):
        f.result(timeout=5)
    with pytest.raises(SchedulerCrashed, match="restart budget exhausted"):
        sup.submit([9])
    assert len(delays) == 2
    policy = sup._restart_policy
    for attempt, d in enumerate(delays):
        assert 0.0 <= d <= min(policy.max_delay_s, policy.base_delay_s * 2 ** attempt)
    sup.shutdown()


def test_rebuild_failures_burn_restart_credits():
    sup, fac, _ = make_sup(max_restarts=2)
    f = sup.submit([1])
    fac.fail_builds = 10
    fac.instances[0].crash()
    wait_for(lambda: sup.health()["state"] == "dead", msg="dead")
    with pytest.raises(SchedulerCrashed):
        f.result(timeout=5)
    sup.shutdown()


def test_submit_during_restart_is_journaled_and_replayed():
    gate = threading.Event()
    sup, fac, _ = make_sup(sleep=lambda s: gate.wait(timeout=5))
    f1 = sup.submit([1])
    fac.instances[0].crash()
    wait_for(lambda: sup.health()["state"] == "restarting", msg="restarting")
    f2 = sup.submit([5])
    assert sup.health()["journal_depth"] == 2
    gate.set()
    wait_for(lambda: len(fac.instances) == 2, msg="restart")
    inner2 = fac.instances[1]
    wait_for(lambda: len(inner2.submitted) == 2, msg="both replayed")
    assert [r["ids"] for r in inner2.submitted] == [[1], [5]]
    inner2.finish(0, [1])
    inner2.finish(1, [2])
    assert f1.result(timeout=5) == [1] and f2.result(timeout=5) == [2]
    sup.shutdown()


def test_poison_request_quarantined_after_max_entry_replays():
    from llm_based_apache_spark_optimization_tpu_torch.serve.resilience import (
        Quarantined,
    )

    sup, fac, _ = make_sup(max_restarts=5, max_entry_replays=1)
    f = sup.submit([1])
    for n in range(2):
        wait_for(lambda: len(fac.instances[-1].submitted) == 1, msg="submitted")
        fac.instances[-1].crash()
        wait_for(lambda: len(fac.instances) == n + 2, msg=f"restart {n + 1}")
    with pytest.raises(Quarantined):
        f.result(timeout=5)
    assert sup.health()["quarantined"] == 1
    assert sup.qos_stats()["quarantined"] == {"default": 1}
    sup.shutdown()


# -------------------------------------------------------------------- drain

def test_drain_semantics_and_spill_recovery(tmp_path):
    spill = str(tmp_path / "journal.jsonl")
    sup, fac, _ = make_sup(spill_path=spill)
    done = sup.submit([1], idempotency_key="a")
    pend = sup.submit([2, 3], max_new_tokens=5, idempotency_key="b", deadline_s=60.0)
    inner = fac.instances[0]
    inner.emit(1, [7])
    inner.finish(0, [4])
    assert done.result(timeout=5) == [4]
    report = sup.drain(deadline_s=0.2)
    assert report["spilled"] == 2 and report["spill_path"] == spill
    assert sup.drain(deadline_s=0.2) == report
    with pytest.raises(Draining):
        pend.result(timeout=5)
    with pytest.raises(Draining):
        sup.submit([9])
    assert sup.submit([1], idempotency_key="a").result(timeout=5) == [4]
    by_key = {r["idempotency_key"]: r for r in map(json.loads, open(spill))}
    assert by_key["b"]["ids"] == [2, 3] and by_key["b"]["delivered"] == 1
    assert 0 < by_key["b"]["deadline_remaining_s"] <= 60.0
    assert by_key["a"]["result"] == [4]

    sup2, fac2, _ = make_sup(spill_path=spill)
    assert sup2.recover() == 2
    inner2 = fac2.instances[0]
    assert [r["ids"] for r in inner2.submitted] == [[2, 3]]
    assert sup2.submit([1], idempotency_key="a").result(timeout=5) == [4]
    inner2.finish(0, [7, 8])
    assert sup2.submit([2, 3], idempotency_key="b").result(timeout=5) == [7, 8]
    assert len(inner2.submitted) == 1 and not os.path.exists(spill)
    sup2.shutdown()


def test_recover_charges_downtime_and_survives_corrupt_lines(tmp_path):
    spill = str(tmp_path / "spill.jsonl")
    stale = {"ids": [1], "max_new": 4, "seed": 0, "idempotency_key": "s",
             "deadline_remaining_s": 5.0, "spilled_at_unix": time.time() - 3600.0}
    fresh = {"ids": [2], "max_new": 4, "seed": 0, "idempotency_key": "f",
             "deadline_remaining_s": 3600.0, "spilled_at_unix": time.time() - 10.0}
    with open(spill, "w") as f:
        f.write('{"ids": [1], "max_new"\n')  # truncated mid-write
        f.write(json.dumps(stale) + "\n" + json.dumps(fresh) + "\n")
    sup, fac, _ = make_sup(spill_path=spill)
    before = resilience.get("sched_lost")
    assert sup.recover() == 1
    assert resilience.get("sched_lost") == before + 2
    assert [r["ids"] for r in fac.instances[0].submitted] == [[2]]
    assert fac.instances[0].submitted[0]["deadline_s"] < 3600.0
    sup.shutdown()


def test_scheduler_backend_recovers_spill_at_construction(tmp_path):
    spill = str(tmp_path / "spill.jsonl")
    with open(spill, "w") as f:
        f.write(json.dumps({"ids": [2, 3], "max_new": 5, "seed": 0,
                            "idempotency_key": "b", "deadline_remaining_s": None}) + "\n")
    sup, fac, _ = make_sup(spill_path=spill)
    backend = SchedulerBackend(sup, object())
    assert backend.supports_idempotency
    assert [r["ids"] for r in fac.instances[0].submitted] == [[2, 3]]
    assert not os.path.exists(spill)
    sup.shutdown()


# ------------------------------------------------------------ the watchdog

def test_heartbeat_age_busy_and_round_ewma():
    hb = Heartbeat(alpha=0.5)
    assert not hb.busy and hb.rounds == 0 and hb.expected_round_s() is None
    hb.stamp(busy=True)
    hb.round_done()
    time.sleep(0.02)
    hb.round_done()
    assert hb.rounds == 2 and hb.expected_round_s() >= 0.02
    hb.stamp(busy=False)  # an idle gap must not feed the cadence
    time.sleep(0.05)
    hb.stamp(busy=True)
    ewma = hb.expected_round_s()
    hb.round_done()
    assert hb.expected_round_s() == ewma
    snap = hb.snapshot()
    assert snap["busy"] and snap["rounds"] == 3


def test_stall_threshold_and_combined_heartbeat():
    hb = Heartbeat()
    assert stall_threshold(hb, 4.0, 0.5) == 0.5
    hb._round_ewma = 1.0
    assert stall_threshold(hb, 4.0, 0.5) == 4.0
    a, b = Heartbeat(), Heartbeat()
    a.stamp(busy=False)
    time.sleep(0.02)
    b.stamp(busy=True)
    combined = CombinedHeartbeat([a, b])
    assert combined.busy and combined.cold and combined.age() < a.age()
    verdicts = combined.verdicts(4.0, 10.0)
    assert [v["replica"] for v in verdicts] == ["r0", "r1"]
    assert not any(v["stalled"] for v in verdicts)


def test_watchdog_escalates_wedged_loop_and_replays():
    before = resilience.get("sched_stalls")
    sup, fac, _ = make_sup(stall_factor=4.0, stall_min_s=0.05)
    f = sup.submit([1, 2])  # stamps busy, then the loop goes silent
    wait_for(lambda: len(fac.instances) == 2, msg="stall escalation + rebuild")
    assert fac.instances[0].shut and fac.instances[0].join_timeout is not None
    wait_for(lambda: len(fac.instances[1].submitted) == 1, msg="replay")
    h = sup.health()
    assert h["stalls"] == 1 and h["restarts"] == 1
    assert isinstance(sup._crash_exc, SchedulerStalled)
    assert resilience.get("sched_stalls") == before + 1
    fac.instances[1].finish(0, [7, 8])
    assert f.result(timeout=5) == [7, 8]
    assert sup.watchdog_stats["stalls_detected"] == 1
    sup.shutdown()
    assert sup._watch_thread is None  # the monitor does not outlive shutdown


def test_zombie_tap_after_replay_is_dropped():
    received = []
    sup, fac, _ = make_sup(stall_factor=4.0, stall_min_s=0.05)
    f = sup.submit([1, 2], on_token=received.append)
    old_tap = fac.instances[0].submitted[0]["on_token"]
    old_tap(7)
    wait_for(lambda: len(fac.instances) == 2, msg="stall escalation + rebuild")
    wait_for(lambda: len(fac.instances[1].submitted) == 1, msg="replay")
    new_tap = fac.instances[1].submitted[0]["on_token"]
    new_tap(7)
    old_tap(7)
    old_tap(8)
    assert received == [7]
    new_tap(8)
    assert received == [7, 8]
    fac.instances[1].finish(0, [7, 8])
    assert f.result(timeout=5) == [7, 8]
    sup.shutdown()


def test_watchdog_ignores_idle_and_disabled_by_zero_floor():
    sup, fac, _ = make_sup(stall_factor=4.0, stall_min_s=0.05)
    time.sleep(0.3)  # idle: a stale busy=False stamp never escalates
    assert sup.health()["stalls"] == 0 and len(fac.instances) == 1
    sup.shutdown()
    sup, fac, _ = make_sup(stall_min_s=0.0)
    sup.submit([1])
    time.sleep(0.2)
    assert sup.health()["stalls"] == 0 and sup._watch_thread is None
    fac.instances[0].finish(0, [1])
    sup.shutdown()
    assert fac.instances[0].join_timeout is None  # unbounded without a watchdog


def test_retry_after_hint_includes_restart_backoff_remaining():
    entered, release = threading.Event(), threading.Event()

    def blocking_sleep(_d):
        entered.set()
        release.wait(5)

    fac = Factory()
    sup = SupervisedScheduler(
        fac, max_restarts=3, restart_policy=RetryPolicy(
            max_attempts=4, base_delay_s=20.0, max_delay_s=20.0),
        rng=random.Random(3), sleep=blocking_sleep, stall_min_s=0.0).start()
    expected = random.Random(3).uniform(0.0, 20.0)
    f = sup.submit([1, 2])
    fac.instances[0].crash()
    assert entered.wait(5)
    assert sup.health()["state"] == "restarting"
    assert expected - 1.0 <= sup.retry_after_hint() <= 60.0
    release.set()
    wait_for(lambda: len(fac.instances) == 2 and fac.instances[1].submitted, msg="replay")
    fac.instances[1].finish(0, [3])
    assert f.result(timeout=5) == [3]
    assert sup.retry_after_hint() == 1.0
    sup.shutdown()


# ------------------------------------------------ the real tiny scheduler

@pytest.fixture(scope="module")
def tiny_params():
    from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
    from llm_based_apache_spark_optimization_tpu.models import init_params

    jp = init_params(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


PROMPTS = [[1, 5 + i, 9, 3 * i + 1] for i in range(6)]


def port_sched(tp):
    return ContinuousBatchingScheduler(TINY, tp, num_slots=2, decode_chunk=4,
                                       prompt_bucket=8, stop_ids=(-1,), device="cpu")


def one_crash_factory(build, faults):
    builds = []

    def factory():
        if builds:
            faults.clear()  # exactly one crash: the rebuild runs clean
        builds.append(1)
        return build()

    return factory, builds


def fast_policy():
    return dict(max_restarts=3, rng=random.Random(0), restart_policy=RetryPolicy(
        max_attempts=4, base_delay_s=0.001, max_delay_s=0.01))


@pytest.mark.chaos
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_supervised_port_scheduler_crash_matches_jax(tiny_params):
    """An injected `sched:crash` kills the port's real scheduler mid-batch:
    every request completes, each token streams once, restarts = 1, lost =
    0, and the tokens equal both a crash-free run and the JAX package's
    supervised scheduler under the same injected crash on the same
    weights."""
    from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
    from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
        ContinuousBatchingScheduler as JaxScheduler,
    )
    from llm_based_apache_spark_optimization_tpu.serve.supervisor import (
        SupervisedScheduler as JaxSupervised,
    )
    from llm_based_apache_spark_optimization_tpu.utils.faults import FAULTS as JAX_FAULTS

    jp, tp = tiny_params
    with port_sched(tp) as control:
        expected = control.generate(PROMPTS, max_new_tokens=6)

    outs = {}
    for name, faults, sup_cls, build in (
            ("port", FAULTS, SupervisedScheduler, lambda: port_sched(tp)),
            ("jax", JAX_FAULTS, JaxSupervised, lambda: JaxScheduler(
                JAX_TINY, jp, num_slots=2, decode_chunk=4, prompt_bucket=8,
                stop_ids=(-1,)))):
        factory, builds = one_crash_factory(build, faults)
        faults.configure("sched:crash:1", seed=0)
        try:
            sup = sup_cls(factory, stall_min_s=0.0, **fast_policy()).start()
            streamed = [[] for _ in PROMPTS]
            futs = [sup.submit(p, max_new_tokens=6, on_token=streamed[i].append,
                               idempotency_key=f"{name}-{i}")
                    for i, p in enumerate(PROMPTS)]
            got = [f.result(timeout=60) for f in futs]
            h = sup.health()
            sup.shutdown()
        finally:
            faults.clear()
        assert got == streamed, name  # each token delivered exactly once
        assert (h["state"], h["restarts"], h["lost"]) == ("ready", 1, 0), name
        assert len(builds) == 2
        outs[name] = got
    assert outs["port"] == expected
    assert outs["port"] == outs["jax"]


@pytest.mark.chaos
def test_supervised_port_scheduler_hang_detected_and_replayed(tiny_params):
    """A duration-valued `sched:hang` wedges the real decode loop at round
    issue; the watchdog sees the stale busy heartbeat, escalates a
    SchedulerStalled restart, and the replay completes every request with
    the hang-free tokens."""
    _, tp = tiny_params
    with port_sched(tp) as control:
        expected = control.generate(PROMPTS[:3], max_new_tokens=6)
    factory, builds = one_crash_factory(lambda: port_sched(tp), FAULTS)
    FAULTS.configure("sched:hang:1:1.5", seed=0)
    sup = SupervisedScheduler(factory, stall_factor=4.0, stall_min_s=0.25,
                              stall_join_s=0.3, **fast_policy()).start()
    try:
        futs = [sup.submit(p, max_new_tokens=6) for p in PROMPTS[:3]]
        wait_for(lambda: sup.health()["state"] != "ready", timeout=3.0,
                 msg="stall detection")
        assert [f.result(timeout=30) for f in futs] == expected
        h = sup.health()
        assert (h["stalls"], h["restarts"], h["lost"]) == (1, 1, 0)
        assert isinstance(sup._crash_exc, SchedulerStalled)
    finally:
        sup.shutdown()
        FAULTS.clear()
        # The abandoned wedged loop wakes from its sleep and exits on its
        # stop event: join it, so no worker outlives the test.
        for t in threading.enumerate():
            if t.name.endswith("(_run)"):
                t.join(timeout=5)
                assert not t.is_alive(), "an abandoned scheduler loop did not exit"


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_scheduler_heartbeat_and_fault_seams(tiny_params):
    """The port's scheduler stamps its heartbeat each iteration and ticks
    it each harvested round; `sched:crash` kills the loop typed."""
    _, tp = tiny_params
    with port_sched(tp) as s:
        s.generate(PROMPTS[:2], max_new_tokens=6)
        # Futures resolve inside a harvest, before its round_done tick.
        wait_for(lambda: s.heartbeat.rounds >= 2, msg="two harvested rounds")
        assert s.watchdog_stats["heartbeat"]["rounds"] == s.heartbeat.rounds
        wait_for(lambda: not s.heartbeat.busy, msg="idle stamp")
    FAULTS.configure("sched:crash:1", seed=0)
    s = port_sched(tp).start()
    try:
        with pytest.raises(SchedulerCrashed):
            s.submit(PROMPTS[0], max_new_tokens=6).result(timeout=30)
    finally:
        s.shutdown(timeout=5)
    # A grammar constraint is served: below its shortest parse it raises,
    # at it the tokens walk the grammar.
    FAULTS.clear()
    cm = get_constraint({"table": "t", "columns": ["a"]}, ByteTokenizer(), (2,))
    with pytest.raises(ValueError, match="complete constrained parse"):
        port_sched(tp).submit([1, 2], max_new_tokens=cm.min_new_tokens - 1, constraint=cm)
    with port_sched(tp) as s:
        out = s.submit([1, 2], max_new_tokens=cm.min_new_tokens,
                       constraint=cm).result(timeout=30)
    assert len(out) == cm.min_new_tokens and cm.walk(out) is not None


# ---------------------------------------------------- the app's lifecycle

class HealthFake:
    def __init__(self):
        self.h = {"state": "ready", "restarts": 0, "replayed": 0, "lost": 0}

    def health(self):
        return self.h

    def retry_after_hint(self):
        return 2.5

    def complete(self, prompt, **kw):
        return Completion(text="SELECT 1", output_tokens=2, prompt_tokens=2)


class JournaledFake(HealthFake):
    supports_idempotency = True

    def complete(self, prompt, idempotency_key=None, **kw):
        self.key = idempotency_key
        return super().complete(prompt, **kw)


def client_for(tmp_path, svc):
    cfg = AppConfig(input_dir=str(tmp_path / "in"), output_dir=str(tmp_path / "out"),
                    history_db=":memory:", secret_key="t")
    return create_api_app(svc, SQLiteBackend, SQLiteHistory(), cfg).test_client()


@pytest.mark.parametrize("state,status,retry", [
    ("ready", 200, False), ("degraded", 200, False),
    ("restarting", 503, True), ("dead", 503, False),
])
def test_readyz_follows_the_supervisor_lifecycle(tmp_path, state, status, retry):
    svc = GenerationService()
    backend = HealthFake()
    svc.register("m", backend)
    client = client_for(tmp_path, svc)
    backend.h = {"state": state, "restarts": 1, "replayed": 3, "lost": 0}
    res = client.get("/readyz")
    assert res.status == status and res.json()["state"] == state
    assert res.json()["restarts"] == 1 and res.json()["replayed"] == 3
    assert ("Retry-After" in res.headers) == retry
    if retry:
        assert int(res.headers["Retry-After"]) == 3  # ceil of the 2.5 s hint
    assert client.get("/healthz").status == 200


def test_drain_gate_lets_keyed_requests_reach_a_journal(tmp_path):
    svc = GenerationService()
    svc.register("m", HealthFake())
    journaled = JournaledFake()
    svc.register("j", journaled)
    client = client_for(tmp_path, svc)
    assert client.post_json("/api/generate", {"model": "j", "prompt": "q",
                                              "idempotency_key": "k0"}).status == 200
    assert journaled.key == "k0"
    svc._draining = True
    res = client.post_json("/api/generate", {"model": "m", "prompt": "q"})
    assert res.status == 503 and int(res.headers["Retry-After"]) == 3
    assert client.get("/readyz").json()["state"] == "draining"
    assert client.post_json("/api/generate", {"model": "j", "prompt": "q",
                                              "idempotency_key": "k"}).status == 200
    assert client.post_json("/api/generate", {"model": "m", "prompt": "q",
                                              "idempotency_key": "k"}).status == 503


def test_service_health_dedupes_shared_supervisor_and_drains_once(tiny_params):
    """Two names over one supervised scheduler (the shared-weights alias)
    count its restarts once, and the drain reaches it once."""
    _, tp = tiny_params
    sup = SupervisedScheduler(lambda: port_sched(tp), stall_min_s=0.0)
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    b1 = SchedulerBackend(sup, ByteTokenizer(), max_new_tokens=4)
    b2 = SchedulerBackend(sup, ByteTokenizer(), max_new_tokens=4, add_bos=False)
    svc = GenerationService()
    svc.register("a", b1)
    svc.register("b", b2)
    sup._restarts = 2
    h = svc.health()
    assert h["state"] == "ready" and h["restarts"] == 2
    assert set(h["models"]) == {"a", "b"}
    svc.drain(5.0)
    assert sup.health()["draining"] and sup._closed

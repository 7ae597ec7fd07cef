"""The port's `SchedulerPool` (local replicas) and the crash supervisor over
it, on the CPU, against the JAX package's pool:

- twins of the JAX package's pool tests (tests/test_scheduler.py's fleet
  section) over host-only fake replicas with scripted backlogs: least
  loaded, deadline skip and 504, page-pressure and SLO-burn penalties,
  shed with the fleet's minimum Retry-After, the restart-aware hint,
  health, a restart refused while a drain owns the replica, prefix
  affinity on and off, and capacity weights. Each twin runs the same
  submits through both pools and holds the placement sequence,
  `routing_stats` and `replica_loads` equal;
- real tiny schedulers (TINY at f32, bridged weights) behind both pools:
  round robin and least loaded with engine-exact tokens, a crashed replica
  skipped, a runtime drain re-placing queued work, a targeted restart
  rebuilding only the crashed replica;
- the supervisor's fleet hooks over toy replicas (the JAX package's chaos
  toy and the port's twin of it): a replica's crash re-places its entry on
  a sibling, a wedged replica restarts alone, a pool of one defers and
  replays, and health and loads carry the replicas;
- the schedulers' dispatch lock: one a device, none on the CPU; injected
  on the CPU into a pool of three, a replica wedged at its round's fault
  seam holds no lock while its siblings serve, and a targeted restart of
  it leaves the lock free.

Every wait has its own timeout; no assertion reads wall time."""

import queue as queue_mod
import random
import threading
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.serve import flightrecorder as jax_fr
from llm_based_apache_spark_optimization_tpu.serve import resilience as jax_res
from llm_based_apache_spark_optimization_tpu.serve import scheduler as jax_sched
from llm_based_apache_spark_optimization_tpu.serve import supervisor as jax_sup
from llm_based_apache_spark_optimization_tpu.utils import faults as jax_faults
from llm_based_apache_spark_optimization_tpu.utils import slo as jax_slo
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.serve import flightrecorder as t_fr
from llm_based_apache_spark_optimization_tpu_torch.serve import resilience as t_res
from llm_based_apache_spark_optimization_tpu_torch.serve import scheduler as t_sched
from llm_based_apache_spark_optimization_tpu_torch.serve import supervisor as t_sup
from llm_based_apache_spark_optimization_tpu_torch.serve import watchdog as t_wd
from llm_based_apache_spark_optimization_tpu_torch.utils import faults as t_faults
from llm_based_apache_spark_optimization_tpu_torch.utils import slo as t_slo
from llm_based_apache_spark_optimization_tpu_torch.utils.observability import (
    resilience as t_counters,
)

#: The two packages' modules a twin reads, by side.
PKGS = {
    "jax": dict(sched=jax_sched, fr=jax_fr, res=jax_res, slo=jax_slo, sup=jax_sup,
                faults=jax_faults),
    "torch": dict(sched=t_sched, fr=t_fr, res=t_res, slo=t_slo, sup=t_sup,
                  faults=t_faults),
}
PROMPTS = [[1, 5, 9], [1, 7], [1, 3, 4, 8, 10], [1, 11, 12, 13]]


class FakeReplica:
    """Host-only replica with a pool's placement surface (a scripted
    backlog, an Overloaded switch, instant results), bound to one
    package's flight recorder and Overloaded."""

    def __init__(self, pkg, secs=0.0, toks=0, hint=1.0):
        self._pkg = pkg
        self._crash = None
        self.flight = pkg["fr"].FlightRecorder(capacity=8)
        self.secs, self.toks, self.hint = secs, toks, hint
        self.overloaded = False
        self.submitted = []

    def start(self):
        return self

    def shutdown(self, timeout=None):
        pass

    def backlog_score(self):
        return self.secs, self.toks

    def retry_after_hint(self):
        return self.hint

    def submit(self, ids, max_new_tokens=256, sampling=None, seed=0,
               on_token=None, constraint=None, deadline_s=None, trace=None):
        if self.overloaded:
            raise self._pkg["res"].Overloaded("fake full", retry_after_s=self.hint)
        self.submitted.append(list(ids))
        fut = Future()
        fut.set_result(list(ids))
        return fut


def placements(pool):
    return [r["to"] for r in pool.flight_snapshot() if r.get("kind") == "placement"]


def view(pool, replicas):
    """What a twin compares: where each submit went, the routing counters,
    the loads feed and each replica's submits."""
    return (placements(pool), pool.routing_stats(), pool.replica_loads(),
            [r.submitted for r in replicas])


def twin(scenario):
    """Run `scenario(pkg)` -> observation on both packages; the port's must
    equal JAX's. Returns the port's."""
    want = scenario(PKGS["jax"])
    got = scenario(PKGS["torch"])
    assert got == want
    return got


def test_least_loaded_routes_to_the_lightest_replica_as_jax():
    def scenario(pkg):
        heavy, light = FakeReplica(pkg, secs=5.0), FakeReplica(pkg, secs=0.25)
        pool = pkg["sched"].SchedulerPool([heavy, light])
        fut = pool.submit([1, 2, 3])
        a, b = FakeReplica(pkg, secs=1.0, toks=500), FakeReplica(pkg, secs=1.0, toks=3)
        pool2 = pkg["sched"].SchedulerPool([a, b])
        pool2.submit([4])
        return (fut.result(), fut._lsot_replica, view(pool, [heavy, light]),
                view(pool2, [a, b]), pool.flight_snapshot()[-1]["router"])

    got = twin(scenario)
    assert got[1] == "r1" and got[2][0] == ["r1"] and got[3][3] == [[], [[4]]]


def test_deadline_skip_and_504_when_infeasible_as_jax():
    def scenario(pkg):
        backed, fresh = FakeReplica(pkg, secs=10.0), FakeReplica(pkg, secs=0.2)
        pool = pkg["sched"].SchedulerPool([backed, fresh])
        pool.submit([1], deadline_s=1.0)
        backed.secs = fresh.secs = 30.0
        with pytest.raises(pkg["res"].DeadlineExceeded, match="no replica can serve"):
            pool.submit([2], deadline_s=1.0)
        pool.submit([3])
        return view(pool, [backed, fresh])

    got = twin(scenario)
    assert got[0] == ["r1", "r0"]


def test_pressure_penalty_deprioritises_a_stormy_replica_as_jax():
    def scenario(pkg):
        calm, stormy = FakeReplica(pkg, secs=2.0), FakeReplica(pkg, secs=0.1)
        stormy.page_stats = {"pages_withheld": 6, "pages_free": 0}
        pool = pkg["sched"].SchedulerPool([stormy, calm])
        pool.submit([1, 2])
        stormy.page_stats = {"pages_withheld": 0, "pages_free": 12}
        pool.submit([3])
        return placements(pool), pool.routing_stats()

    assert twin(scenario)[0] == ["r1", "r0"]


def test_slo_burning_replica_deprioritised_as_jax(monkeypatch):
    class Engine:
        enabled = True

        @staticmethod
        def replica_burning(label):
            return label == "r0"

    for pkg in PKGS.values():
        monkeypatch.setattr(pkg["slo"], "ENGINE", Engine())

    def scenario(pkg):
        burning, healthy = FakeReplica(pkg, secs=0.1), FakeReplica(pkg, secs=5.0)
        pool = pkg["sched"].SchedulerPool([burning, healthy])
        pool.submit([1])
        return view(pool, [burning, healthy])

    got = twin(scenario)
    assert got[0] == ["r1"] and [r["slo_burning"] for r in got[2]] == [True, False]


def test_all_full_sheds_with_the_fleet_minimum_retry_after_as_jax():
    def scenario(pkg):
        a, b = FakeReplica(pkg, hint=7.0), FakeReplica(pkg, hint=3.0)
        a.overloaded = True
        pool = pkg["sched"].SchedulerPool([a, b])
        pool.submit([1])
        b.overloaded = True
        with pytest.raises(pkg["res"].Overloaded) as exc:
            pool.submit([2])
        return view(pool, [a, b]), exc.value.retry_after_s

    got = twin(scenario)
    assert got[1] == pytest.approx(3.0)


def test_retry_after_hint_is_restart_aware_as_jax():
    def scenario(pkg):
        a, b = FakeReplica(pkg, hint=9.0), FakeReplica(pkg, hint=0.5)
        pool = pkg["sched"].SchedulerPool([a, b])
        hints = [pool.retry_after_hint()]
        b.hint = 4.0
        hints.append(pool.retry_after_hint())
        pool._states[1].state = "restarting"
        pool._states[1].restart_eta = time.monotonic() + 2.0
        restarting = pool.retry_after_hint()
        pool._states[1].state = "dead"
        hints.append(pool.retry_after_hint())
        return hints, 1.0 <= restarting <= 2.05

    assert twin(scenario) == ([1.0, 4.0, 9.0], True)


def test_health_aggregates_replica_states_as_jax():
    def scenario(pkg):
        pool = pkg["sched"].SchedulerPool([FakeReplica(pkg), FakeReplica(pkg)])
        seen = [pool.health()]
        for s0, s1 in (("restarting", "ready"), ("restarting", "dead"), ("dead", "dead"),
                       ("removed", "ready")):
            pool._states[0].state, pool._states[1].state = s0, s1
            seen.append(pool.health())
        return seen

    got = twin(scenario)
    assert [h["state"] for h in got] == ["ready", "degraded", "restarting", "dead", "ready"]
    assert sorted(got[0]["fleet"]) == ["drain_count", "drain_s_sum", "elastic", "joins",
                                       "pump_depth", "push_bytes", "push_placed", "pushed",
                                       "retires", "serving", "size"]


def test_restart_refused_while_a_drain_owns_the_replica_as_jax():
    def scenario(pkg):
        pool = pkg["sched"].SchedulerPool([FakeReplica(pkg), FakeReplica(pkg)],
                                          factory=lambda i: FakeReplica(pkg))
        out = []
        for state in ("draining", "removed"):
            pool._states[0].state = state
            out.append(pool.restart_replica("r0"))
        return out

    assert twin(scenario) == [False, False]


@pytest.mark.parametrize("affinity", [True, False], ids=["affinity_on", "affinity_off"])
def test_affinity_routing_as_jax(affinity):
    """On: a replica holding the request's chain-prefix digests sorts
    first, ahead of a better backlog, and the counters record the hit;
    off: the backlog order, with no lookup and no affinity event."""
    ids = list(range(1, 20))  # 19 tokens / block 8: 2 chain digests

    def scenario(pkg):
        digs = pkg["sched"].prefix_chain_digests(ids, 8)
        holder, lighter = FakeReplica(pkg, secs=2.0), FakeReplica(pkg, secs=0.1)
        holder._pblock = lighter._pblock = 8
        holder.resident_digests = lambda: list(digs)
        lighter.resident_digests = lambda: []
        pool = pkg["sched"].SchedulerPool([holder, lighter], affinity_routing=affinity)
        pool.submit(ids)
        pool.submit(list(range(50, 69)))
        events = [{k: v for k, v in r.items() if k not in ("ts", "seq")}
                  for r in pool.flight_snapshot() if r.get("kind") != "round"]
        return digs, view(pool, [holder, lighter]), events

    got = twin(scenario)
    assert got[1][0] == (["r0", "r1"] if affinity else ["r1", "r1"])
    assert got[1][1]["affinity_hits"] == int(affinity)


def test_weights_scale_the_backlog_comparison_as_jax():
    def scenario(pkg):
        sp = pkg["sched"]
        big, small = FakeReplica(pkg, secs=4.0), FakeReplica(pkg, secs=3.0)
        pool = sp.SchedulerPool([big, small], weights=[4.0, 1.0])
        pool.submit([1])
        big3, small3 = FakeReplica(pkg, secs=2.0), FakeReplica(pkg, secs=1.0)
        pool3 = sp.SchedulerPool([big3, small3], weights=[4.0, 1.0])
        pool3.submit([2])
        pool3.submit([3], deadline_s=1.5)
        errors = []
        for spec, n in (("0,1", 2), ("fast", 1), ("1,1,1", 2)):
            with pytest.raises(ValueError) as e:
                sp.parse_replica_weights(spec, n)
            errors.append(str(e.value))
        with pytest.raises(ValueError) as e:
            sp.SchedulerPool([FakeReplica(pkg), FakeReplica(pkg)], weights=[1.0, 1.0, 2.0])
        return (view(pool, [big, small]), view(pool3, [big3, small3]),
                sp.parse_replica_weights("2,1", 3), sp.parse_replica_weights("", 2),
                errors, str(e.value))

    got = twin(scenario)
    assert got[0][3] == [[[1]], []] and got[1][3] == [[[2]], [[3]]]
    assert got[0][2][0]["weight"] == 4.0 and "weight" not in got[0][2][1]


def test_phase_roles_and_remote_replicas_are_refused():
    """The handoff (ROADMAP A7.5) and remote replicas (A11) are not ported:
    a pool refuses such a replica by name."""
    pkg = PKGS["torch"]
    role = FakeReplica(pkg)
    role.phase_role = "prefill"
    with pytest.raises(NotImplementedError, match="A7.5"):
        t_sched.SchedulerPool([role])
    remote = FakeReplica(pkg)
    remote.is_remote = True
    pool = t_sched.SchedulerPool([FakeReplica(pkg)])
    with pytest.raises(NotImplementedError, match="A11"):
        pool.add_replica(remote)
    assert pool.add_replica(FakeReplica(pkg)) == "r1"
    assert pool.fleet_stats()["joins"] == 1 and pool.fleet_stats()["elastic"] == 1


# ------------------------------------------------- real tiny schedulers


@pytest.fixture(scope="module")
def both():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def make_sched(both, side, **kw):
    kw = dict(dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,)), **kw)
    jp, tp = both
    if side == "jax":
        return jax_sched.ContinuousBatchingScheduler(JAX_TINY, jp, **kw)
    return t_sched.ContinuousBatchingScheduler(TINY, tp, **kw, device="cpu")


@pytest.mark.parametrize("router", ["round_robin", "least_loaded"])
def test_real_replicas_serve_jax_tokens_with_jax_placements(both, router):
    """Two tiny replicas behind each pool: the port's placements, tokens
    and routing counters equal JAX's (submits in one burst, before any
    completion seeds a backlog estimate)."""
    outs = []
    for side in ("jax", "torch"):
        pool = PKGS[side]["sched"].SchedulerPool(
            [make_sched(both, side), make_sched(both, side)], router=router)
        with pool:
            futs = [pool.submit(p, max_new_tokens=4) for p in PROMPTS * 2]
            res = [f.result(timeout=120) for f in futs]
        outs.append((res, placements(pool), pool.routing_stats(),
                     [f._lsot_replica for f in futs]))
    assert outs[1] == outs[0]
    assert set(outs[1][1]) == {"r0", "r1"}


def test_a_crashed_replica_is_skipped_as_jax(both):
    outs = []
    for side in ("jax", "torch"):
        pkg = PKGS[side]
        pool = pkg["sched"].SchedulerPool([make_sched(both, side), make_sched(both, side)])
        with pool:
            pool.schedulers[0]._crash = RuntimeError("simulated device loss")
            res = pool.generate(PROMPTS[:2], max_new_tokens=4)
            pool.schedulers[1]._crash = RuntimeError("second loss")
            with pytest.raises(pkg["res"].SchedulerCrashed, match="all scheduler replicas"):
                pool.submit(PROMPTS[0])
            health = [(r["replica"], r["state"]) for r in pool.replica_health()]
            for s in pool.schedulers:
                s._crash = None
        outs.append((res, placements(pool), health))
    assert outs[1] == outs[0]
    assert outs[1][2] == [("r0", "dead"), ("r1", "dead")]


def test_drain_replica_re_places_queued_work_as_jax(both):
    """A runtime drain of r0 re-places its queued requests on r1 (nothing
    shed, tokens as JAX's), parks r0 `drained`, and placement skips it."""
    outs = []
    prompts = [[1, 5 + i] for i in range(6)]
    for side in ("jax", "torch"):
        pool = PKGS[side]["sched"].SchedulerPool(
            [make_sched(both, side, num_slots=1), make_sched(both, side, num_slots=1)])
        with pool:
            futs = [pool.submit(p, max_new_tokens=4) for p in prompts]
            report = pool.drain_replica("r0", deadline_s=60.0)
            res = [f.result(timeout=120) for f in futs]
            after = pool.submit(prompts[0], max_new_tokens=4)
            res.append(after.result(timeout=120))
            state = (report["state"], pool.health()["state"], after._lsot_replica)
        drained = [r for r in pool.flight_snapshot() if r.get("kind") == "replica_drained"]
        outs.append((res, state, drained[-1]["replica"]))
    assert outs[1] == outs[0]
    assert outs[1][1] == ("drained", "degraded", "r1")


def test_targeted_restart_rebuilds_only_the_crashed_replica_as_jax(both):
    outs = []
    for side in ("jax", "torch"):
        pkg = PKGS[side]
        pool = pkg["sched"].SchedulerPool(
            [make_sched(both, side), make_sched(both, side)],
            factory=lambda i, side=side: make_sched(both, side), max_restarts=2,
            restart_policy=pkg["res"].RetryPolicy(max_attempts=3, base_delay_s=0.001,
                                                  max_delay_s=0.01),
            rng=random.Random(0), replica_join_s=1.0)
        with pool:
            pool.schedulers[0]._crash = pkg["res"].SchedulerCrashed("simulated device loss")
            res = pool.generate(PROMPTS[:2], max_new_tokens=4)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                reps = {r["replica"]: r for r in pool.replica_health()}
                if reps["r0"]["restarts"] >= 1 and reps["r0"]["state"] in ("ready",
                                                                         "degraded"):
                    break
                time.sleep(0.02)
            reps = {r["replica"]: (r["restarts"], r["state"]) for r in pool.replica_health()}
            res2 = pool.generate(PROMPTS[:2] * 2, max_new_tokens=4)
        outs.append((res, reps["r0"][0], reps["r1"], res2))
    assert outs[1] == outs[0]
    assert outs[1][1] == 1 and outs[1][2] == (0, "ready")


# ------------------------------------------- the supervisor's fleet hooks


class ToyScheduler:
    """The port's twin of the JAX package's chaos toy replica
    (evalh/chaos.py `_ToyScheduler`): one worker thread 'decodes' each
    request deterministically, consulting the port's fault seams
    (`sched:crash`, `sched:hang`, `sched:wedge_<label>`) before each token,
    and stamps the port's heartbeat and flight recorder."""

    def __init__(self, tokens_per_request=6, token_sleep_s=0.002):
        self.tokens_per_request = tokens_per_request
        self.token_sleep_s = token_sleep_s
        self._queue = queue_mod.Queue()
        self._crash = None
        self._lock = threading.Lock()
        self._thread = None
        self._outstanding = 0
        self.heartbeat = t_wd.Heartbeat()
        self.flight = t_fr.FlightRecorder(capacity=64)

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
        with self._lock:
            if self._crash is not None:
                raise self._crash
            self._outstanding += 1
        fut = Future()
        self._queue.put((list(ids), min(max_new_tokens, self.tokens_per_request),
                         seed, on_token, fut))
        return fut

    def backlog_score(self):
        with self._lock:
            return 0.0, self._outstanding

    @staticmethod
    def expected(ids, n, seed):
        return [(sum(ids) * 31 + seed * 17 + i * 7) % 997 for i in range(n)]

    def _run(self):
        while True:
            self.heartbeat.stamp(busy=False)
            item = self._queue.get()
            if item is None:
                return
            ids, n, seed, on_token, fut = item
            try:
                out = []
                for t in self.expected(ids, n, seed):
                    self.heartbeat.stamp(busy=True)
                    t_faults.FAULTS.check("sched:crash")
                    t_faults.FAULTS.check("sched:hang")
                    if t_faults.FAULTS.active:
                        t_faults.FAULTS.check(f"sched:wedge_{self.flight.replica}")
                    if self.token_sleep_s:
                        time.sleep(self.token_sleep_s)
                    out.append(t)
                    if on_token is not None:
                        on_token(t)
                    self.heartbeat.round_done()
                    self.flight.record(round=self.heartbeat.rounds, occupancy=1, emitted=1)
            except Exception as exc:  # noqa: BLE001 — loop death, like the scheduler's
                crash = t_res.SchedulerCrashed.from_exception(exc)
                with self._lock:
                    self._crash = crash
                    self._outstanding = 0
                fut.set_exception(crash)
                while True:
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


def toy_cls(side):
    if side == "jax":
        from llm_based_apache_spark_optimization_tpu.evalh.chaos import _ToyScheduler

        return _ToyScheduler
    return ToyScheduler


def toy_fleet_sup(side, replicas=2, seed=0):
    """A supervised fleet of toy replicas with millisecond backoffs (the
    JAX package's fleet-test recipe) on `side`'s modules."""
    pkg = PKGS[side]
    toy = toy_cls(side)

    def replica_factory():
        pkg["faults"].FAULTS.clear()  # one fault episode: rebuilt replicas run clean
        return toy()

    def make_pool():
        return pkg["sched"].SchedulerPool(
            [toy() for _ in range(replicas)], factory=replica_factory, max_restarts=5,
            restart_policy=pkg["res"].RetryPolicy(max_attempts=6, base_delay_s=0.001,
                                                  max_delay_s=0.01),
            rng=random.Random(seed), replica_join_s=0.2)

    return pkg["sup"].SupervisedScheduler(
        make_pool, max_restarts=3,
        restart_policy=pkg["res"].RetryPolicy(max_attempts=4, base_delay_s=0.001,
                                              max_delay_s=0.01),
        rng=random.Random(seed), stall_factor=2.0, stall_min_s=0.1, stall_join_s=0.2)


def wait_replica_restarted(sup, label, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        reps = {r["replica"]: r for r in sup.health().get("replicas", [])}
        r = reps.get(label, {})
        if int(r.get("restarts", 0)) >= 1 and r.get("state") in ("ready", "degraded"):
            return reps
        time.sleep(0.01)
    raise AssertionError(f"replica {label} never finished restarting")


@pytest.fixture()
def clean_faults():
    for pkg in PKGS.values():
        pkg["faults"].FAULTS.clear()
    yield
    for pkg in PKGS.values():
        pkg["faults"].FAULTS.clear()


@pytest.mark.parametrize("spec,replicas,victim,n", [
    ("sched:wedge_r0:1", 2, "r0", 4),      # the replica's loop dies
    ("sched:wedge_r1:1:0.4", 3, "r1", 6),  # the replica wedges (a stall)
    ("sched:wedge_r0:1", 1, "r0", 1),      # a pool of one defers, then replays
], ids=["crash_re_places_on_a_sibling", "wedge_restarts_alone", "pool_of_one"])
def test_fleet_supervisor_restarts_one_replica_as_jax(clean_faults, spec, replicas,
                                                     victim, n):
    """A replica's crash or wedge under the supervisor: only that replica
    restarts, its journaled requests reproduce their tokens on the fleet,
    nothing is lost and the whole-pool restart never fires, in both
    packages."""
    views = []
    for side in ("jax", "torch"):
        pkg = PKGS[side]
        pkg["faults"].FAULTS.configure(spec, seed=0)
        sup = toy_fleet_sup(side, replicas=replicas).start()
        try:
            futs, expect = [], []
            for i in range(n):
                ids, rseed = [11 + i, 12 + i], 300 + i
                futs.append(sup.submit(ids, seed=rseed))
                expect.append(toy_cls(side).expected(ids, 6, rseed))
            outs = [f.result(timeout=60) for f in futs]
            reps = wait_replica_restarted(sup, victim)
            h = sup.health()
            views.append((outs == expect, reps[victim]["restarts"],
                          sorted(r for r, v in reps.items()
                                 if r != victim and v["restarts"] == 0),
                          h["restarts"], h["lost"], h["stalls"] >= 1 if ":0.4" in spec
                          else True))
        finally:
            pkg["faults"].FAULTS.clear()
            sup.shutdown()
    assert views[1] == views[0]
    assert views[1][0] and views[1][1] == 1 and views[1][3:5] == (0, 0)
    assert t_counters.get("replica_restarts") >= 1


def test_supervisor_health_and_loads_carry_the_replicas_as_jax():
    views = []
    for side in ("jax", "torch"):
        sup = toy_fleet_sup(side, replicas=2).start()
        try:
            h = sup.health()
            loads = sup.replica_loads()
            views.append(([(r["replica"], r["state"], r["model_id"], r["phase_role"])
                           for r in h["replicas"]],
                          [(ld["replica"], ld["state"]) for ld in loads],
                          sorted(h["fleet"]), sorted(loads[0])))
        finally:
            sup.shutdown()
    assert views[1] == views[0]
    assert views[1][0] == [("r0", "ready", "", "mixed"), ("r1", "ready", "", "mixed")]


def test_pool_crossfire_in_flight_work_replayed_not_lost():
    """The JAX package's crossfire case over the port's supervisor: one
    replica of a supervised pool crashes while another still decodes
    acknowledged work; the teardown closes the healthy replica's future
    with the untyped mid-request RuntimeError, and both entries replay on
    the rebuilt fleet."""
    incarnations = []

    class Inner:
        supports_replica_restart = False

        def __init__(self):
            self.submitted = []
            self._crash = None
            self.heartbeat = t_wd.Heartbeat()

        def start(self):
            return self

        def shutdown(self, timeout=None):
            for rec in self.submitted:
                if not rec["future"].done():
                    rec["future"].set_exception(RuntimeError("scheduler shut down "
                                                             "mid-request"))

        def submit(self, ids, **kw):
            rec = {"ids": list(ids), "future": Future()}
            self.submitted.append(rec)
            return rec["future"]

    def factory():
        incarnations.append(Inner())
        return incarnations[-1]

    sup = t_sup.SupervisedScheduler(
        factory, max_restarts=3,
        restart_policy=t_res.RetryPolicy(max_attempts=4, base_delay_s=0.001,
                                         max_delay_s=0.01),
        rng=random.Random(0), sleep=lambda s: None).start()
    try:
        crashed = sup.submit([1], idempotency_key="a")
        healthy = sup.submit([2], idempotency_key="b")
        incarnations[0]._crash = t_res.SchedulerCrashed("replica A died")
        incarnations[0].submitted[0]["future"].set_exception(incarnations[0]._crash)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not (
                len(incarnations) == 2 and len(incarnations[1].submitted) == 2):
            time.sleep(0.005)
        assert [r["ids"] for r in incarnations[1].submitted] == [[1], [2]]
        incarnations[1].submitted[0]["future"].set_result([10])
        incarnations[1].submitted[1]["future"].set_result([20])
        assert crashed.result(timeout=5) == [10] and healthy.result(timeout=5) == [20]
        h = sup.health()
        assert h["lost"] == 0 and h["replayed"] == 2 and h["state"] == "ready"
    finally:
        sup.shutdown()


def test_dispatch_lock_is_per_device_and_a_wedged_holder_stalls_no_one_for_good(
        both, clean_faults, monkeypatch):
    """On a card the schedulers of a process issue under their device's
    lock (one lock a device); on the CPU, where ops run as issued, there is
    none. With one lock injected into a pool of three tiny replicas, r0
    wedged at its round's fault seam (`sched:wedge_r0`, held until the test
    lets go) holds no lock: r1 and r2 serve their tokens meanwhile, and a
    targeted restart of r0 rebuilds it beside them with the lock free."""
    import contextlib

    import torch

    a, b = (t_sched.dispatch_lock(torch.device("cuda", 0)),
            t_sched.dispatch_lock(torch.device("cuda:0")))
    assert a is b and a is not t_sched.dispatch_lock(torch.device("cuda", 1))
    sched = make_sched(both, "torch")
    assert isinstance(sched._dispatch_lock, contextlib.nullcontext)
    with sched:
        want = [sched.submit(p, max_new_tokens=6).result(timeout=60) for p in PROMPTS[:3]]

    lock = threading.Lock()

    def locked(i=None):
        s = make_sched(both, "torch")
        s._dispatch_lock = lock
        return s

    wedged, release = threading.Event(), threading.Event()

    def wedge(secs):  # the duration seam's sleep, held open by the test
        wedged.set()
        assert release.wait(60), "the test never released the wedge"

    monkeypatch.setattr(t_faults.FAULTS, "_sleep", wedge)
    pool = t_sched.SchedulerPool(
        [locked(), locked(), locked()], factory=locked, max_restarts=2,
        restart_policy=t_res.RetryPolicy(max_attempts=3, base_delay_s=0.001,
                                         max_delay_s=0.01),
        rng=random.Random(0), replica_join_s=0.2)
    try:
        with pool:
            t_faults.FAULTS.configure("sched:wedge_r0:1:60", seed=0)
            stuck = pool.schedulers[0].submit(PROMPTS[0], max_new_tokens=6)
            assert wedged.wait(60), "r0 never reached its round's seam"
            # r0 sits in its seam, r1 and r2 idle: the lock is free.
            assert lock.acquire(timeout=10), "the wedged replica holds the lock"
            lock.release()
            sibs = [pool.schedulers[i].submit(p, max_new_tokens=6)
                    for i, p in ((1, PROMPTS[1]), (2, PROMPTS[2]))]
            assert [f.result(timeout=60) for f in sibs] == want[1:]
            assert not stuck.done() and not release.is_set()
            t_faults.FAULTS.clear()  # the rebuilt replica runs clean
            assert pool.restart_replica("r0") is True
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                reps = {r["replica"]: r for r in pool.replica_health()}
                if reps["r0"]["restarts"] == 1 and reps["r0"]["state"] in ("ready",
                                                                         "degraded"):
                    break
                time.sleep(0.01)
            assert [(r["replica"], r["restarts"]) for r in pool.replica_health()] == [
                ("r0", 1), ("r1", 0), ("r2", 0)]
            assert not release.is_set()  # the old r0 still sits in its seam
            assert lock.acquire(timeout=10), "the restart left the lock held"
            lock.release()
            again = [pool.schedulers[i].submit(p, max_new_tokens=6)
                     for i, p in enumerate(PROMPTS[:3])]
            assert [f.result(timeout=60) for f in again] == want
    finally:
        release.set()

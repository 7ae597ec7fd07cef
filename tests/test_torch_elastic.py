"""The elastic fleet in the port (serve/elastic.py, serve/factory.py's
`standby_spawner` and the entry point's `LSOT_FLEET_*` / `LSOT_SCALE_*`
wiring), on the CPU against the JAX package.

- Twins of the JAX package's 13 `FleetAutoscaler` cases
  (tests/test_elastic.py): one fake pool type and one explicit clock drive
  both packages' autoscalers, which must take the same actions, leave the
  same pool state and report the same `stats()` at every step.
- `standby_spawner` over two port `ReplicaServer`s on loopback sockets:
  each call claims the next address, `None` once they are used up, in both
  packages.
- A real pool of tiny bridged-weight paged schedulers that joins a standby
  through the autoscaler, places on it, and retires it by drain: the same
  tokens, placements and fleet counters as JAX's pool doing the same.
- The entry point under `--cpu --backend checkpoint --dp 2 --scheduler` with
  `LSOT_FLEET_WORKERS` set: the backend's autoscaler runs with the knobs of
  JAX's entry point's.

Every wait has a timeout; no assertion reads wall time."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.serve import elastic as jax_elastic
from llm_based_apache_spark_optimization_tpu.serve import factory as jax_factory
from llm_based_apache_spark_optimization_tpu.serve import scheduler as jax_sched
from llm_based_apache_spark_optimization_tpu.utils import faults as jax_faults
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.serve import elastic as t_elastic
from llm_based_apache_spark_optimization_tpu_torch.serve import factory as t_factory
from llm_based_apache_spark_optimization_tpu_torch.serve import scheduler as t_sched
from llm_based_apache_spark_optimization_tpu_torch.utils import faults as t_faults

SIDES = {"jax": (jax_elastic.FleetAutoscaler, jax_faults.FAULTS),
         "torch": (t_elastic.FleetAutoscaler, t_faults.FAULTS)}


class FakePool:
    """The fleet surface the autoscaler reads, as tests/test_elastic.py's
    fake: `queued` is the fleet's total queue (the autoscaler divides by the
    serving count itself)."""

    def __init__(self, serving=2, queued=0, elastic=0):
        self.serving = serving
        self.queued = queued
        self.elastic = elastic
        self.page_stats = None
        self.added = []
        self.retired = []

    def fleet_stats(self):
        return {"size": self.serving, "serving": self.serving, "elastic": self.elastic}

    def replica_loads(self):
        base, extra = divmod(self.queued, max(1, self.serving))
        return [{"replica": f"r{i}", "queued": base + (1 if i < extra else 0),
                 "active_slots": 0} for i in range(self.serving)]

    def add_replica(self, replica, label=None, weight=1.0, elastic=True):
        self.serving += 1
        if elastic:
            self.elastic += 1
        lbl = label or f"r{self.serving - 1}"
        self.added.append((lbl, elastic))
        return lbl

    def retire_replica(self, replica=None, deadline_s=None):
        if self.elastic <= 0:
            return None  # the real pool: operator replicas never retire
        self.serving -= 1
        self.elastic -= 1
        out = {"replica": f"r{self.serving}", "deadline_s": deadline_s}
        self.retired.append(out)
        return out

    def state(self):
        return (self.serving, self.elastic, list(self.added), list(self.retired))


class Run:
    """One package's autoscalers over fake pools: every step is logged with
    its action, the pool's state and `stats()`, the twin's comparison."""

    def __init__(self, side):
        self.cls, self.faults = SIDES[side]
        self.log = []

    def mk(self, pool, spawn=None, **kw):
        for k, v in (("fleet_min", 1), ("fleet_max", 8), ("scale_up_q", 2.0),
                     ("scale_down_q", 0.5), ("hold_s", 0.0), ("interval_s", 0.0),
                     ("ewma_alpha", 1.0)):
            kw.setdefault(k, v)
        return self.cls(pool, spawn or (lambda: object()), **kw)

    def step(self, auto, pool, t):
        out = auto.step(t)
        self.log.append((t, out, pool.state(), auto.stats()))
        return out


def case_scale_up_requires_continuous_hold(r):
    pool = FakePool(serving=2, queued=10)
    auto = r.mk(pool, hold_s=2.0)
    assert r.step(auto, pool, 0.0) is None
    assert r.step(auto, pool, 1.0) is None
    assert r.step(auto, pool, 2.0) == "up"
    assert pool.serving == 3 and pool.added[0][1] is True


def case_hold_resets_when_signal_drops(r):
    pool = FakePool(serving=2, queued=10)
    auto = r.mk(pool, hold_s=2.0)
    assert r.step(auto, pool, 0.0) is None
    pool.queued = 0
    assert r.step(auto, pool, 1.0) is None
    pool.queued = 10
    assert r.step(auto, pool, 2.0) is None
    assert r.step(auto, pool, 3.0) is None
    assert r.step(auto, pool, 4.0) == "up"
    assert pool.serving == 3


def case_cooldown_separates_consecutive_actions(r):
    pool = FakePool(serving=2, queued=20)
    auto = r.mk(pool, interval_s=10.0)
    assert r.step(auto, pool, 0.0) == "up"
    assert r.step(auto, pool, 1.0) is None
    assert r.step(auto, pool, 9.9) is None
    assert r.step(auto, pool, 10.0) == "up"
    assert pool.serving == 4


def case_fleet_max_caps_scale_up(r):
    pool = FakePool(serving=3, queued=100)
    auto = r.mk(pool, fleet_max=3)
    for t in range(5):
        assert r.step(auto, pool, float(t)) is None
    assert pool.serving == 3 and not pool.added


def case_fleet_min_floors_scale_down(r):
    pool = FakePool(serving=2, queued=0, elastic=2)
    auto = r.mk(pool, fleet_min=2)
    for t in range(5):
        assert r.step(auto, pool, float(t)) is None
    assert pool.serving == 2 and not pool.retired


def case_scale_down_rides_retire_with_drain_deadline(r):
    pool = FakePool(serving=3, queued=0, elastic=1)
    auto = r.mk(pool, fleet_min=2, drain_deadline_s=7.5)
    assert r.step(auto, pool, 0.0) == "down"
    assert pool.serving == 2 and pool.retired[0]["deadline_s"] == 7.5
    assert auto.stats()["downs"] == 1


def case_operator_replicas_never_retire(r):
    pool = FakePool(serving=3, queued=0, elastic=0)
    auto = r.mk(pool, fleet_min=1)
    assert r.step(auto, pool, 0.0) is None
    assert pool.serving == 3 and not pool.retired
    assert auto.stats()["downs"] == 0


def case_injected_spawn_failure_degrades_not_wedges(r):
    pool = FakePool(serving=2, queued=20)
    auto = r.mk(pool)
    r.faults.configure("fleet:spawn:1", 0)
    try:
        assert r.step(auto, pool, 0.0) is None
    finally:
        r.faults.clear()
    assert pool.serving == 2 and not pool.added
    assert auto.stats()["spawn_failures"] == 1
    assert r.step(auto, pool, 1.0) == "up"
    assert pool.serving == 3


def case_dead_standby_spawn_exception_counts_as_failure(r):
    pool = FakePool(serving=2, queued=20)

    def dead_spawn():
        raise ConnectionError("standby host is gone")

    auto = r.mk(pool, dead_spawn)
    assert r.step(auto, pool, 0.0) is None
    assert auto.stats()["spawn_failures"] == 1 and pool.serving == 2


def case_spawn_empty_is_counted_not_an_up(r):
    pool = FakePool(serving=2, queued=20)
    auto = r.mk(pool, lambda: None)
    assert r.step(auto, pool, 0.0) is None
    st = auto.stats()
    assert st["spawn_empty"] == 1 and st["ups"] == 0 and pool.serving == 2


def case_kv_pressure_scales_up_with_empty_queue(r):
    pool = FakePool(serving=2, queued=0)
    pool.page_stats = {"pages_withheld": 3}
    auto = r.mk(pool)
    assert r.step(auto, pool, 0.0) == "up"
    assert pool.serving == 3
    pool.elastic = 1
    auto2 = r.mk(pool, fleet_min=1, fleet_max=pool.serving)
    pool.page_stats = {"pages_withheld": 1}
    assert r.step(auto2, pool, 0.0) is None
    pool.page_stats = {"pages_withheld": 0}
    assert r.step(auto2, pool, 1.0) == "down"


def case_min_greater_than_max_rejected(r):
    with pytest.raises(ValueError) as e:
        r.mk(FakePool(), fleet_min=5, fleet_max=3)
    r.log.append(str(e.value))


def case_stats_surface_knobs_and_signal(r):
    pool = FakePool(serving=2, queued=4)
    auto = r.mk(pool, fleet_min=1, fleet_max=6, hold_s=1.5)
    r.step(auto, pool, 0.0)
    st = auto.stats()
    assert st["fleet_min"] == 1 and st["fleet_max"] == 6 and st["hold_s"] == 1.5
    assert st["steps"] == 1
    assert st["signal"]["queue_ewma"] == 2.0 and st["signal"]["serving"] == 2


CASES = {f.__name__[5:]: f for f in (
    case_scale_up_requires_continuous_hold, case_hold_resets_when_signal_drops,
    case_cooldown_separates_consecutive_actions, case_fleet_max_caps_scale_up,
    case_fleet_min_floors_scale_down, case_scale_down_rides_retire_with_drain_deadline,
    case_operator_replicas_never_retire, case_injected_spawn_failure_degrades_not_wedges,
    case_dead_standby_spawn_exception_counts_as_failure,
    case_spawn_empty_is_counted_not_an_up, case_kv_pressure_scales_up_with_empty_queue,
    case_min_greater_than_max_rejected, case_stats_surface_knobs_and_signal)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_autoscaler_twin(name):
    """Each JAX control-law case on both packages: the case's own checks
    hold on each, and the step logs (action, pool state, stats) are equal."""
    logs = {}
    for side in SIDES:
        run = Run(side)
        CASES[name](run)
        logs[side] = run.log
    assert logs["torch"] == logs["jax"]
    assert logs["torch"]  # the case logged what it compared


def test_autoscaler_env_defaults_as_jax(monkeypatch):
    """Knobs left None read `LSOT_FLEET_MIN/MAX` and `LSOT_SCALE_*` (a bad
    value falls back to the default), and the bounds default to the fleet
    size and that plus 4, in both packages."""
    for env in ({}, {"LSOT_FLEET_MAX": "9", "LSOT_SCALE_UP_Q": "x",
                     "LSOT_SCALE_HOLD_S": "0.25", "LSOT_SCALE_INTERVAL_S": "7"}):
        for k in ("LSOT_FLEET_MIN", "LSOT_FLEET_MAX", "LSOT_SCALE_UP_Q",
                  "LSOT_SCALE_DOWN_Q", "LSOT_SCALE_HOLD_S", "LSOT_SCALE_INTERVAL_S"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        stats = {side: cls(FakePool(serving=3), lambda: None).stats()
                 for side, (cls, _) in SIDES.items()}
        assert stats["torch"] == stats["jax"]
        assert stats["torch"]["fleet_min"] == 3
        assert stats["torch"]["fleet_max"] == (9 if env else 7)


def test_run_thread_steps_and_stops():
    """`run()` steps the fake fleet on the monotonic clock in a daemon
    thread until `stop()`; a second `run()` is a no-op."""
    import time

    pool = FakePool(serving=2, queued=20)
    auto = t_elastic.FleetAutoscaler(pool, lambda: object(), fleet_min=1, fleet_max=3,
                                     scale_up_q=2.0, hold_s=0.0, interval_s=0.0)
    assert auto.run(tick_s=0.01) is auto.run(tick_s=0.01)
    deadline = time.monotonic() + 30
    while pool.serving < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    auto.stop()
    assert pool.serving == 3 and auto.stats()["ups"] == 1
    assert auto._thread is None


# ------------------------------------------------------------- the spawner


def test_standby_spawner_claims_each_address_once():
    """Over two port `ReplicaServer`s (the chaos toy behind each), both
    packages' spawners hand out one `SocketTransport` an address, labelled
    standby0/standby1, that serves the toy's tokens; then `None`. A refused
    address raises, and an autoscaler counts it as a spawn failure."""
    import socket

    from llm_based_apache_spark_optimization_tpu_torch.evalh.chaos import _ToyScheduler
    from llm_based_apache_spark_optimization_tpu_torch.serve.remote import ReplicaServer

    toys = [_ToyScheduler(token_sleep_s=0.0).start() for _ in range(2)]
    servers = [ReplicaServer(t) for t in toys]
    try:
        spec = " , ".join(s.address for s in servers)
        for factory in (t_factory, jax_factory):
            spawn = factory.standby_spawner(spec, connect_timeout_s=2.0)
            assert spawn.addresses == tuple(s.address for s in servers)
            got = [spawn(), spawn()]
            try:
                assert [tr.label for tr in got] == ["standby0", "standby1"]
                for tr in got:
                    assert tr.submit([4, 5], seed=3).result(timeout=30) == \
                        _ToyScheduler.expected([4, 5], 6, 3)
                assert spawn() is None
            finally:
                for tr in got:
                    tr.shutdown()
        with socket.socket() as s:  # a port nothing listens on
            s.bind(("127.0.0.1", 0))
            dead = f"127.0.0.1:{s.getsockname()[1]}"
        pool = FakePool(serving=1, queued=10)
        auto = t_elastic.FleetAutoscaler(
            pool, t_factory.standby_spawner(dead, connect_timeout_s=0.5), fleet_min=1,
            fleet_max=2, scale_up_q=1.0, hold_s=0.0, interval_s=0.0)
        assert auto.step(0.0) is None
        assert auto.stats()["spawn_failures"] == 1 and pool.serving == 1
        assert t_factory.standby_spawner("").addresses == ()
    finally:
        for s in servers:
            s.close()
        for t in toys:
            t.shutdown()


# ------------------------------------------------------- a real tiny pool


@pytest.fixture(scope="module")
def both():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _elastic_pool_run(both, side):
    jp, tp = both
    sched_mod = jax_sched if side == "jax" else t_sched
    cls = SIDES[side][0]
    kw = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,),
              kv_layout="paged", kv_page_size=8)

    def make():
        if side == "jax":
            return jax_sched.ContinuousBatchingScheduler(JAX_TINY, jp, **kw)
        return t_sched.ContinuousBatchingScheduler(TINY, tp, device="cpu", **kw)

    spawned = []

    def spawn():
        spawned.append(make().start())
        return spawned[-1]

    pool = sched_mod.SchedulerPool([make()], router="round_robin")
    with pool:
        up = cls(pool, spawn, fleet_min=1, fleet_max=2, scale_up_q=0.0,
                 scale_down_q=-1.0, hold_s=0.0, interval_s=0.0)
        assert up.step(0.0) == "up"
        outs = [pool.submit(p, max_new_tokens=6).result(timeout=120)
                for p in ([1, 5, 9], [1, 7, 11], [1, 3, 4, 8])]
        down = cls(pool, spawn, fleet_min=1, fleet_max=2, scale_up_q=99.0,
                   scale_down_q=99.0, hold_s=0.0, interval_s=0.0, drain_deadline_s=30.0)
        assert down.step(0.0) == "down"
        outs.append(pool.submit([1, 2, 3], max_new_tokens=6).result(timeout=120))
        snap = pool.flight_snapshot()
        fl = pool.fleet_stats()
    for s in spawned:
        s.shutdown()
    return dict(
            outs=outs,
            placements=[r["to"] for r in snap if r.get("kind") == "placement"],
            events=[(r["kind"], r.get("replica")) for r in snap
                    if r.get("kind") in ("replica_join", "replica_retire")],
            fleet={k: fl[k] for k in ("size", "serving", "elastic", "joins", "retires",
                                      "drain_count")},
            stats=[{k: v for k, v in a.stats().items() if k != "signal"}
                   for a in (up, down)])


def test_pool_joins_and_retires_a_standby_as_jax(both):
    """A one-replica pool of tiny bridged-weight paged schedulers: the
    autoscaler joins a standby (elastic), round-robin places on it, then
    retires it by drain; the last request lands on r0. Tokens, placements,
    lifecycle events, fleet counters and autoscaler stats equal JAX's."""
    seen = {side: _elastic_pool_run(both, side) for side in ("jax", "torch")}
    assert seen["torch"] == seen["jax"]
    got = seen["torch"]
    assert "r1" in got["placements"][:3] and got["placements"][3] == "r0"
    assert got["events"] == [("replica_join", "r1"), ("replica_retire", "r1")]
    assert got["fleet"]["joins"] == 1 and got["fleet"]["retires"] == 1
    assert got["fleet"]["serving"] == 1 and got["fleet"]["elastic"] == 0


# --------------------------------------------------------- the entry point


def test_entry_point_runs_the_autoscaler_as_jax(tmp_path, monkeypatch):
    """`--cpu --backend checkpoint --dp 2 --scheduler` with
    `LSOT_FLEET_WORKERS` and the `LSOT_SCALE_*` knobs set: both entry
    points' backends carry a running autoscaler over the supervised pool
    with the same knobs, fleet_max defaulting to the two replicas plus the
    two standbys. Nothing scales: the thresholds are out of reach."""
    import dataclasses

    import torch
    from test_torch_tokenizer import write_tokenizer_json

    from llm_based_apache_spark_optimization_tpu.app import __main__ as jax_entry
    from llm_based_apache_spark_optimization_tpu_torch.app import AppConfig
    from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry
    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import save_hf_checkpoint
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params

    pytest.importorskip("tokenizers")
    mcfg = dataclasses.replace(TINY, max_seq_len=2048)
    ckpt = tmp_path / "ckpt"
    save_hf_checkpoint(mcfg, init_params(mcfg, torch.Generator().manual_seed(0),
                                         torch.float32, device="cpu"), ckpt)
    write_tokenizer_json(ckpt / "tokenizer.json", "wordlevel")
    for k, v in {"LSOT_FLEET_WORKERS": "127.0.0.1:1,127.0.0.1:2",
                 "LSOT_SCALE_UP_Q": "1000", "LSOT_SCALE_DOWN_Q": "-1",
                 "LSOT_SCALE_HOLD_S": "4.5", "LSOT_SCALE_INTERVAL_S": "6.5",
                 "LSOT_FLEET_MIN": "2"}.items():
        monkeypatch.setenv(k, v)
    argv = ["--cpu", "--backend", "checkpoint", "--sql-model-path", str(ckpt), "--dp",
            "2", "--slots", "2", "--max-new-tokens", "8"]
    args = entry.build_parser().parse_args(argv)
    assert not set(entry.UNPORTED_KNOBS) - {"stok_seed_bench"}
    stats = {}
    for side in ("jax", "torch"):
        svc = (jax_entry.make_checkpoint_service(argparse.Namespace(**vars(args)), 8)
               if side == "jax" else
               entry.build_service(args, AppConfig.from_env(history_db=":memory:")))
        backend = svc._models["duckdb-nsql"].backend
        auto = backend.autoscaler
        try:
            assert auto._thread is not None and auto._thread.is_alive()
            assert auto.pool is backend.scheduler
            assert auto._spawn.addresses == ("127.0.0.1:1", "127.0.0.1:2")
            assert svc.generate("duckdb-nsql", "select vendor").output_tokens > 0
            stats[side] = {k: v for k, v in auto.stats().items()
                           if k not in ("steps", "signal")}
        finally:
            auto.stop()
            svc.close()
    assert stats["torch"] == stats["jax"]
    assert stats["torch"]["fleet_min"] == 2 and stats["torch"]["fleet_max"] == 4
    assert (stats["torch"]["scale_up_q"], stats["torch"]["hold_s"],
            stats["torch"]["interval_s"]) == (1000.0, 4.5, 6.5)
    assert stats["torch"]["ups"] == stats["torch"]["downs"] == 0

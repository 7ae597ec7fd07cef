"""The port's model registry and multi-model pool (serve/modelpool.py, the
model axis of `SchedulerPool`), on the CPU, against the JAX package's
(twins of its tests/test_modelpool.py; the remote-worker case waits for
the remote replicas, ROADMAP A11):

- `parse_models_spec`, `partition_pages` and `ModelRegistry` on the same
  specs;
- model routing over fake replicas: the model filter before the load
  order, a typed `UnknownModel`, the model-blind order with routing off,
  a drain that keeps a lone model's work on its replica, a model whose
  replicas are all draining shedding Overloaded; the same placements as
  JAX's;
- the co-resident tiny fleet on the JAX fleet's weights (bridged): each
  model's greedy tokens, `model_stats`, the partitioned arena and the
  loads' model ids equal JAX's; distinct weights answer distinctly; an
  unregistered model is a typed error; the model axis leaves tokens as
  they were."""

from concurrent.futures import Future

import jax
import numpy as np
import pytest

from llm_based_apache_spark_optimization_tpu.serve import flightrecorder as jax_fr
from llm_based_apache_spark_optimization_tpu.serve import modelpool as jax_mp
from llm_based_apache_spark_optimization_tpu.serve import resilience as jax_res
from llm_based_apache_spark_optimization_tpu.serve import scheduler as jax_sched
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.serve import flightrecorder as t_fr
from llm_based_apache_spark_optimization_tpu_torch.serve import modelpool as t_mp
from llm_based_apache_spark_optimization_tpu_torch.serve import resilience as t_res
from llm_based_apache_spark_optimization_tpu_torch.serve import scheduler as t_sched

SIDES = {"jax": (jax_mp, jax_sched, jax_fr, jax_res),
         "torch": (t_mp, t_sched, t_fr, t_res)}


def both(fn):
    """fn(side modules) on both packages; the port's result must equal
    JAX's. Returns the port's."""
    want, got = fn(*SIDES["jax"]), fn(*SIDES["torch"])
    assert got == want
    return got


def errors(mp, spec):
    try:
        return [(m.model_id, m.source, m.path, round(m.hbm_fraction, 9), m.template,
                 m.replicas, m.add_bos) for m in mp.parse_models_spec(spec)]
    except ValueError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", [
    "sql=gguf:/ckpts/nsql.gguf,hbm=0.75,replicas=2;"
    "explainer=hf:/ckpts/llama,hbm=0.25,template=llama3-chat,add_bos=0",
    "x=tiny,hbm=0.5;y=tiny;z=tiny",
    "p=tiny;q=tiny",
    "a=tiny;a=tiny", "a=tiny,wat=1", "just-a-name", "a=tiny,hbm=0.8;b=tiny,hbm=0.8",
    "a=hf", "a=tiny,hbm=1.0;b=tiny", "a=nope:/x", "a=tiny,replicas=0", "",
])
def test_parse_models_spec_equals_jax(spec):
    both(lambda mp, *_: errors(mp, spec))


@pytest.mark.parametrize("total,fractions", [
    (256, (0.75, 0.25)), (16, (0.99, 0.01)), (1, (0.99, 0.01)), (7, (0.5, 0.3, 0.2)),
    (3, (0.34, 0.33, 0.33)), (1000, (0.1, 0.9)),
])
def test_partition_pages_equals_jax(total, fractions):
    def run(mp, *_):
        specs = [mp.ModelSpec(f"m{i}", hbm_fraction=f) for i, f in enumerate(fractions)]
        try:
            return mp.partition_pages(total, specs)
        except ValueError as e:
            return str(e)

    got = both(run)
    if isinstance(got, dict):
        assert sum(got.values()) == total and min(got.values()) >= 1


def test_model_registry_equals_jax():
    def run(mp, *_):
        reg = mp.ModelRegistry([mp.ModelSpec("a"), mp.ModelSpec("b", source="hf",
                                                                path="/x")])
        with pytest.raises(mp.UnknownModel, match="not registered") as e:
            reg.get("nope")
        with pytest.raises(ValueError, match="duplicate"):
            mp.ModelRegistry([mp.ModelSpec("a"), mp.ModelSpec("a")])
        return (reg.ids(), len(reg), "a" in reg, reg.get("b").path, str(e.value),
                isinstance(e.value, ValueError))

    both(run)


class FakeModelReplica:
    """Host-only replica with the placement surface and a model id: a
    scripted backlog, recorded submits and requeues."""

    def __init__(self, side, model_id="", secs=0.0):
        self._side = side
        self.model_id = model_id
        self.flight = side[2].FlightRecorder(capacity=8)
        self.secs = secs
        self.submitted, self.requeued, self.queued_reqs = [], [], []

    def start(self):
        return self

    def shutdown(self, timeout=None):
        pass

    def backlog_score(self):
        return self.secs, 0

    def retry_after_hint(self):
        return 1.0

    def submit(self, ids, max_new_tokens=256, sampling=None, seed=0, on_token=None,
               constraint=None, deadline_s=None, trace=None, model_id=""):
        if model_id and model_id != self.model_id:
            raise self._side[0].UnknownModel(f"replica serves {self.model_id!r}")
        self.submitted.append(list(ids))
        fut = Future()
        fut.set_result(list(ids))
        return fut

    def extract_queued(self):
        out, self.queued_reqs = self.queued_reqs, []
        return out

    def requeue(self, req):
        self.requeued.append(req)


def placements(pool, key="to"):
    return [r.get(key) for r in pool.flight_snapshot() if r.get("kind") == "placement"]


def test_pool_routes_by_model_before_load_as_jax():
    def run(*side):
        heavy_a = FakeModelReplica(side, "a", secs=9.0)
        light_b = FakeModelReplica(side, "b", secs=0.1)
        pool = side[1].SchedulerPool([heavy_a, light_b], model_routing=True)
        assert pool.submit([1, 2], model_id="a").result() == [1, 2]
        pool.submit([3])
        return (placements(pool), placements(pool, "model"), heavy_a.submitted,
                light_b.submitted, pool.model_stats()["models"][0]["placements"])

    assert both(run)[:2] == (["r0", "r1"], ["a", None])


def test_pool_unknown_model_fails_typed_as_jax():
    def run(mp, sched, *rest):
        a = FakeModelReplica((mp, sched, *rest), "a")
        b = FakeModelReplica((mp, sched, *rest), "b")
        pool = sched.SchedulerPool([a, b], model_routing=True)
        with pytest.raises(mp.UnknownModel, match="'nope'") as e:
            pool.submit([1], model_id="nope")
        return str(e.value), isinstance(e.value, ValueError), a.submitted + b.submitted

    got = both(run)
    assert "'a'" in got[0] and "'b'" in got[0] and got[2] == []


def test_pool_models_off_reproduces_the_model_blind_order_as_jax():
    def run(*side):
        def fleet():
            return [FakeModelReplica(side, "a", secs=2.0),
                    FakeModelReplica(side, "b", secs=0.5),
                    FakeModelReplica(side, "a", secs=1.0)]

        out = []
        for routing in (False, True):
            pool = side[1].SchedulerPool(fleet(), model_routing=routing)
            for i in range(6):
                pool.submit([i + 1])
            out.append((placements(pool), placements(pool, "model")))
        return out

    got = both(run)
    assert got[0] == got[1] and set(got[1][1]) == {None}


def test_drain_keeps_a_lone_models_work_on_its_replica_as_jax():
    def run(*side):
        only_a, other_b = FakeModelReplica(side, "a"), FakeModelReplica(side, "b")
        only_a.queued_reqs = ["x", "y"]
        pool = side[1].SchedulerPool([only_a, other_b], model_routing=True)
        res = pool.drain_replica("r0", deadline_s=0.1)
        a1, a2 = FakeModelReplica(side, "a"), FakeModelReplica(side, "a")
        a1.queued_reqs = ["z"]
        pool2 = side[1].SchedulerPool([a1, a2], model_routing=True)
        res2 = pool2.drain_replica("r0", deadline_s=0.1)
        return (res["replaced"], only_a.requeued, other_b.requeued, res2["replaced"],
                a2.requeued, res["state"])

    assert both(run) == (0, ["x", "y"], [], 1, ["z"], "drained")


def test_a_model_whose_replicas_all_drain_sheds_overloaded_as_jax():
    def run(*side):
        only_a, other_b = FakeModelReplica(side, "a"), FakeModelReplica(side, "b")
        pool = side[1].SchedulerPool([only_a, other_b], model_routing=True)
        pool.drain_replica("r0", deadline_s=0.05)
        with pytest.raises(side[3].Overloaded, match="draining or restarting"):
            pool.submit([1], model_id="a")
        return other_b.submitted, [r["model_id"] for r in pool.replica_health()]

    assert both(run) == ([], ["a", "b"])


# ---------------------------------------------------- co-resident tiny fleet


@pytest.fixture(scope="module")
def fleets():
    """The JAX tiny fleet and the port's over the same (bridged) weights:
    "sql" (hbm 0.75) and "explainer" (0.25), 2 slots each."""
    specs = [("sql", 0.75), ("explainer", 0.25)]
    jsvc, jpool, _ = jax_mp.build_tiny_model_service(
        [jax_mp.ModelSpec(m, hbm_fraction=f) for m, f in specs],
        num_slots=2, max_new_tokens=12)
    weights = [params_from_jax(jax.tree.map(np.asarray, s.params), device="cpu")
               for s in jpool.schedulers]
    tsvc, tpool, treg = t_mp.build_tiny_model_service(
        [t_mp.ModelSpec(m, hbm_fraction=f) for m, f in specs],
        num_slots=2, max_new_tokens=12, weights=weights, device="cpu")
    yield (jsvc, jpool), (tsvc, tpool, treg)
    jsvc.close()
    tsvc.close()


def _settled_stats(pool):
    import time

    deadline = time.time() + 60
    while time.time() < deadline:
        if all(not s._pending and all(r is None for r in s._slot_req)
               for s in pool.schedulers):
            break
        time.sleep(0.005)
    ms = pool.model_stats()["models"]
    return [{k: v for k, v in r.items() if k != "tok_s"} for r in ms]


def test_co_resident_models_serve_jax_tokens_and_stats(fleets):
    """Each model's completion of the same prompt equals JAX's, the two
    checkpoints answer differently, and after the traffic `model_stats`
    (the arena partition 3:1 included) and the loads' model ids equal
    JAX's."""
    (jsvc, jpool), (tsvc, tpool, _) = fleets
    prompt = "List the three largest fares"
    got = {}
    for tag, svc, pool in (("jax", jsvc, jpool), ("torch", tsvc, tpool)):
        res = {m: svc.generate(model=m, prompt=prompt, max_new_tokens=12)
               for m in ("sql", "explainer")}
        got[tag] = ({m: (r.response, r.output_tokens) for m, r in res.items()},
                    _settled_stats(pool),
                    [(r["replica"], r["model_id"]) for r in pool.replica_loads()])
    assert got["torch"] == got["jax"]
    texts, stats, loads = got["torch"]
    assert texts["sql"] != texts["explainer"]
    recs = {r["model"]: r for r in stats}
    assert recs["sql"]["kv_pages_total"] == 3 * recs["explainer"]["kv_pages_total"]
    assert all(r["replicas"] == 1 and r["placements"] >= 1 and r["tokens_total"] > 0
               for r in recs.values())
    assert loads == [("r0", "sql"), ("r1", "explainer")]


def test_co_resident_metrics_render_the_model_families(fleets):
    from llm_based_apache_spark_optimization_tpu_torch.utils.prometheus import (
        render_prometheus,
    )

    tsvc = fleets[1][0]
    tsvc.generate(model="explainer", prompt="why", max_new_tokens=4)
    text = render_prometheus(tsvc.metrics_snapshot())
    assert "lsot_model_kv_pages_total" in text and 'served_model="explainer"' in text


def test_an_unregistered_model_is_a_typed_error_as_jax(fleets):
    (jsvc, _), (tsvc, tpool, treg) = fleets
    msgs = []
    for svc in (jsvc, tsvc):
        with pytest.raises((KeyError, ValueError), match="not registered") as e:
            svc.generate(model="nope", prompt="hi", max_new_tokens=4)
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[0] == msgs[1]
    with pytest.raises(t_mp.UnknownModel):
        tpool.submit([1, 2], model_id="nope")
    with pytest.raises(t_mp.UnknownModel):
        tpool.schedulers[0].submit([1, 2], model_id="explainer")
    assert treg.ids() == ["sql", "explainer"]


def test_the_model_axis_leaves_tokens_as_they_were(fleets):
    """The same prompt and seed give the same tokens whether the submit
    names its model or not, on the replica and through the pool, in both
    packages."""
    outs = []
    for pool in (fleets[0][1], fleets[1][1]):
        sched = pool.schedulers[0]
        ids = [3, 7, 11]
        plain = sched.submit(ids, max_new_tokens=8, seed=99).result(timeout=300)
        named = sched.submit(ids, max_new_tokens=8, seed=99,
                             model_id="sql").result(timeout=300)
        pooled = pool.submit(ids, max_new_tokens=8, seed=99,
                             model_id="sql").result(timeout=300)
        assert plain == named == pooled
        outs.append(plain)
    assert outs[0] == outs[1]


def test_supervised_tiny_fleet_serves_and_restarts_a_replica():
    """`supervise=True` runs the pool under the crash supervisor with a
    pool factory (the replicas rebuild from the loaded weights): both
    models answer, and a targeted restart of one replica leaves the other
    serving."""
    import time

    svc, sup, _ = t_mp.build_tiny_model_service(
        [t_mp.ModelSpec("sql", hbm_fraction=0.75),
         t_mp.ModelSpec("explainer", hbm_fraction=0.25)],
        num_slots=2, max_new_tokens=6, supervise=True, device="cpu")
    try:
        assert sup.supports_model_routing and sup.supports_qos
        for m in ("sql", "explainer"):
            assert svc.generate(model=m, prompt="hi", max_new_tokens=6).output_tokens > 0
        assert sup.restart_replica("r0") is True
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            reps = {r["replica"]: r for r in sup.health()["replicas"]}
            if reps["r0"]["restarts"] == 1 and reps["r0"]["state"] in ("ready", "degraded"):
                break
            time.sleep(0.01)
        assert reps["r0"]["restarts"] == 1 and reps["r1"]["restarts"] == 0
        assert svc.generate(model="sql", prompt="hi", max_new_tokens=6).output_tokens > 0
        assert sup.health()["lost"] == 0
    finally:
        svc.close()

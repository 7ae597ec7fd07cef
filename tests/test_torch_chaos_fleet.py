"""The port's `evalh --chaos` stages 7-10 (evalh/chaos.py) on the CPU
against the JAX package's stage functions at seed 0: the network transport
under each fault class, elastic membership over real loopback socket
workers, the multi-tenant storm and self-healing SQL.

The counts each stage's contract fixes are equal to JAX's: lost,
mismatched, stream violations, scheduler submits, sibling and pool
restarts, joins, retires, scale-ups, spawn failures, fleet sizes, request
classes, tenants. Timings are not compared (stage 9's TTFT percentiles),
and the counts that follow thread timing are held to the stage's own
bounds in both packages: stage 7's fault tallies (the lease's pings cross
the faulted envelope too) and the partitioned replica's restarts, stage
8's `pushed_handoffs` (how many a prefill worker pushes before the kill
leg takes it down varies between runs of either package) and the prefill
worker's restarts. The port's stages build their TINY schedulers on the
CPU (`device="cpu"`).

Stages 7 and 8 hold their fleets under a 50 ms x 2 lease and assert that
only the faulted replica restarts; a CPU starved by other processes can
miss a live replica's beats, and the JAX package's stage then fails its
own assertion. The reference side is run again, up to REFERENCE_ATTEMPTS
times, until it completes (a completed stage caches its report per seed);
the port's stage runs once.

tests/test_torch_chaos.py holds stages 1-6 and the whole CLI run."""

from llm_based_apache_spark_optimization_tpu.evalh import chaos as jax_chaos
from llm_based_apache_spark_optimization_tpu_torch.evalh import chaos as t_chaos


REFERENCE_ATTEMPTS = 3


def reference(name):
    """The JAX package's stage `name` at seed 0, run again when its own
    in-stage assertion fails (see the module docstring)."""
    for attempt in range(REFERENCE_ATTEMPTS):
        try:
            return getattr(jax_chaos, name)(0)
        except AssertionError:
            if attempt == REFERENCE_ATTEMPTS - 1:
                raise


def stage(name):
    """`name` at seed 0 in both packages -> (JAX's report, the port's)."""
    kw = {} if name == "_run_repair_stage" else {"device": "cpu"}
    return reference(name), getattr(t_chaos, name)(0, **kw)


def test_net_stage_as_jax():
    """Stage 7: drop, delay, dup and a partition of r1 over loopback
    transports: exactly-once execution, no stream violations, the lease
    restarts r1 alone; each wave's counts and fault tallies are JAX's."""
    j, t = stage("_run_net_stage")

    def stable(rep):
        return dict(without(rep, "waves", "partition_restarts", "replayed"),
                    waves={tag: without(w, "faults") for tag, w in rep["waves"].items()})

    assert stable(t) == stable(j)
    for rep in (j, t):
        for tag, w in rep["waves"].items():
            assert w["lost"] == w["mismatched"] == w["stream_violations"] == 0, tag
        for tag in ("drop", "delay", "dup"):
            assert rep["waves"][tag]["scheduler_submits"] == 4
            assert any(k.startswith("net:") for k in rep["waves"][tag]["faults"]), tag
        assert rep["partition_restarts"] >= 1
        assert rep["sibling_restarts"] == rep["pool_restarts"] == rep["lost_total"] == 0


def test_elastic_stage_as_jax():
    """Stage 8, the elastic fleet's reference test: a burst scales up
    through the autoscaler (one join), a `fleet:spawn` failure is a counted
    non-event, the prefill worker's death restarts r0 alone, and the retire
    drains the joined worker; every wave token-identical with exactly-once
    streams."""
    j, t = stage("_run_elastic_stage")
    timing = ("pushed_handoffs", "prefill_restarts")
    assert without(t, *timing) == without(j, *timing)
    for rep in (j, t):
        assert rep["pushed_handoffs"] >= 1 and rep["prefill_restarts"] >= 1
    assert t["scale_ups"] >= 1 and t["size_after_scale_up"] == 3
    assert t["spawn_failures"] == 1 and t["size_after_spawn_failure"] == 3
    assert t["joins"] >= 1 and t["retires"] == 1 and t["fleet_serving"] == 2
    assert t["lost"] == t["mismatched"] == t["stream_violations"] == 0


def test_qos_stage_as_jax():
    """Stage 9: the storm tenant absorbs the degradation, nothing is lost,
    QoS on and off give the same tokens, the off switch leaves no QoS state."""
    j, t = stage("_run_qos_stage")
    wall = ("control_p95_ttft_s", "quiet_p95_ttft_s", "stormy_p95_ttft_s")
    assert without(t, *wall) == without(j, *wall)
    assert t["lost"] == t["mismatched"] == 0 and t["qos_off_state_clean"]
    assert t["stormy_p95_ttft_s"] >= t["quiet_p95_ttft_s"]


def test_repair_stage_as_jax():
    """Stage 10 through the real pipeline: repaired, typed per-class
    termination, the off switch and clean traffic, as JAX's."""
    j, t = stage("_run_repair_stage")
    assert t == j
    assert t["lost"] == 0 and t["repaired"]["ok"] == t["repaired"]["requests"]
    assert set(t["per_class"]) == {"syntax", "schema", "transient"}
    assert t["repair_off"]["identical"] and t["clean"]["identical"]


def test_stage_reports_are_cached_per_seed():
    """The per-seed caches are JAX's: a second call returns the cached
    report (repair's as a copy)."""
    for name, cache in (("_run_net_stage", "_NET_REPORTS"),
                        ("_run_elastic_stage", "_ELASTIC_REPORTS"),
                        ("_run_qos_stage", "_QOS_REPORTS")):
        rep = getattr(t_chaos, name)(0, device="cpu")
        assert getattr(t_chaos, cache)[0] is rep
        assert getattr(t_chaos, name)(0, device="cpu") is rep
    rep = t_chaos._run_repair_stage(0)
    assert rep == t_chaos._REPAIR_REPORTS[0] and rep is not t_chaos._REPAIR_REPORTS[0]
    assert sorted(n for n in dir(t_chaos) if n.endswith(("_REPORTS", "_CONTROLS"))) == \
        sorted(n for n in dir(jax_chaos) if n.endswith(("_REPORTS", "_CONTROLS")))


def without(rep, *keys):
    return {k: v for k, v in rep.items() if k not in keys}

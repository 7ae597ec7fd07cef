"""The port's `evalh --chaos` (evalh/chaos.py), stages 1-6 and the whole
run, on the CPU against the JAX package's stage functions at seed 0.

Each stage runs in both packages and the counts of its report that the
JAX package's own tests hold deterministic are equal: the outcome
histogram, hung, lost, unresolved, mismatched, states, request classes,
restarts where one fault episode fixes them. Timings are not compared, and
the counts those tests call timing artifacts are held to the stage's own
bounds in both packages instead (stage 2's `restarts` / `replayed`,
tests/test_supervisor.py; the hang stage's stalls, tests/test_watchdog.py;
stage 4's `faults_injected`; stage 5's `preemptions` / `page_waits` /
`evictions`, tests/test_paged_kv.py; stage 6's handoff, crash and restart
counts, tests/test_disagg.py). The port's stages build their TINY
schedulers on the CPU (`device="cpu"`).

Then one whole port run through its CLI (`python -m ...evalh --chaos
--cpu`, in its own process): zero hung and every stage's loss count and
`mismatched` zero, and its deterministic fields equal to an in-process run
of the same seed, as tests/test_resilience.py and tests/test_supervisor.py
check the JAX package's replay.

tests/test_torch_chaos_fleet.py holds stages 7-10."""

import json
import os
import subprocess
import sys

import pytest

from llm_based_apache_spark_optimization_tpu.evalh import chaos as jax_chaos
from llm_based_apache_spark_optimization_tpu_torch.evalh import chaos as t_chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Reports of the stages that have their own twins, for the run_chaos
#: twins of stages 1-4: each is a zero-loss report of the right shape.
_STUBS = {"_run_pressure_stage": {"lost": 0}, "_run_disagg_stage": {"lost": 0},
          "_run_net_stage": {"waves": {}}, "_run_elastic_stage": {"lost": 0},
          "_run_qos_stage": {"lost": 0}, "_run_repair_stage": {"lost": 0}}


def stage(name, **kw):
    """`name` at seed 0 in both packages -> (JAX's report, the port's)."""
    jax_rep = getattr(jax_chaos, name)(0, **kw)
    port_rep = getattr(t_chaos, name)(0, device="cpu", **kw) if name in (
        "_run_pressure_stage", "_run_disagg_stage") else getattr(t_chaos, name)(0, **kw)
    return jax_rep, port_rep


def without(rep, *keys):
    return {k: v for k, v in rep.items() if k not in keys}


@pytest.fixture()
def light(monkeypatch):
    """run_chaos with stages 5-10 stubbed in both packages (they have their
    own twins), so stages 1-4 run alone."""
    for mod in (jax_chaos, t_chaos):
        for name, rep in _STUBS.items():
            monkeypatch.setattr(mod, name, lambda seed, _rep=rep, **kw: dict(_rep))


def run_both(spec, rounds):
    return (jax_chaos.run_chaos(spec, seed=0, rounds=rounds),
            t_chaos.run_chaos(spec, seed=0, rounds=rounds, device="cpu"))


@pytest.mark.parametrize("spec", ["ollama:connect:0.5,sql:exec:1", "unused:site:1"])
def test_suite_stage_outcomes_as_jax(light, spec):
    """Stage 1 under a spec without scheduler faults: the outcome
    histogram, the resilience counters' movement and the injected fault
    counts are JAX's, and replay is deterministic (tests/test_resilience.py)."""
    j, t = run_both(spec, 2)
    t2 = t_chaos.run_chaos(spec, seed=0, rounds=2, device="cpu")
    for key in ("spec", "seed", "requests", "outcomes", "hung", "resilience_delta",
                "faults_injected"):
        assert t[key] == j[key], key
    assert t2["outcomes"] == t["outcomes"]
    assert t["hung"] == 0 and t["requests"] == sum(t["outcomes"].values())
    if spec.startswith("unused"):
        assert t["outcomes"]["ok"] == t["requests"] and t["faults_injected"] == {}
    else:
        assert t["resilience_delta"].get("retries", 0) > 0
        assert t["resilience_delta"].get("breaker_trips", 0) > 0
        assert t["outcomes"]["shed"] + t["outcomes"]["degraded"] > 0
        assert t["faults_injected"]["sql:exec"] > 0


def test_scheduler_stage_as_jax(light):
    """Stage 2 under `sched:crash:0.2` (tests/test_supervisor.py's spec):
    the outcomes and the scheduler section's stable fields are JAX's, and
    a second run replays them; crashes and replays happened. (With the
    default spec's 50 ms ollama breaker the histogram follows the host's
    speed, in both packages.)"""
    j, t = run_both("sched:crash:0.2", 2)
    t2 = t_chaos.run_chaos("sched:crash:0.2", seed=0, rounds=2, device="cpu")

    def stable(rep):
        return without(rep["scheduler"], "replayed", "restarts")

    assert t["outcomes"] == j["outcomes"] == t2["outcomes"]
    assert stable(t) == stable(j) == stable(t2)
    assert t["hung"] == 0 and t["scheduler"]["lost"] == 0
    assert t["scheduler"]["restarts"] >= 1 and t["scheduler"]["replayed"] >= 1
    assert set(t["latency"]) == set(j["latency"])


HANG_TIMING = ("wall_s", "stalls_detected", "restarts", "replayed", "faults_injected")
PRESSURE_TIMING = ("preemptions", "page_waits", "evictions")
DISAGG_TIMING = ("handoffs", "crashes_injected", "prefill_restarts")


def test_hang_stage_as_jax():
    j, t = stage("_run_hang_stage")
    assert without(t, *HANG_TIMING) == without(j, *HANG_TIMING)
    for rep in (j, t):
        assert rep["unresolved"] == rep["mismatched"] == rep["lost"] == 0
        assert rep["stalls_detected"] >= 1 and rep["state"] == "ready"
        assert rep["restarts"] >= 1 and rep["replayed"] >= 1
        assert rep["faults_injected"].get("sched:hang", 0) >= 1


def test_fleet_stage_as_jax():
    j, t = stage("_run_fleet_stage")
    stable = ("wall_s", "faults_injected")
    assert without(t, *stable) == without(j, *stable)
    assert without(t_chaos._run_fleet_stage(0), *stable) == without(t, *stable)
    assert t["wedged_restarts"] == 1 and t["sibling_restarts"] == t["pool_restarts"] == 0
    assert t["lost"] == t["unresolved"] == t["mismatched"] == 0


def test_pressure_stage_as_jax():
    """Stage 5 on the real paged scheduler: every request token-identical
    to the pressure-free control, a preemption fired, the counts JAX's."""
    j, t = stage("_run_pressure_stage")
    assert without(t, *PRESSURE_TIMING) == without(j, *PRESSURE_TIMING)
    for rep in (j, t):
        assert rep["lost"] == rep["mismatched"] == 0 and rep["preemptions"] >= 1
    assert t["request_classes"] == ["greedy", "sampled", "constrained", "greedy"]


def test_disagg_stage_as_jax():
    """Stage 6: the phase-split fleet hands off, survives a prefill crash
    mid-handoff with a targeted restart, and its counts are JAX's."""
    j, t = stage("_run_disagg_stage")
    assert without(t, *DISAGG_TIMING) == without(j, *DISAGG_TIMING)
    for rep in (j, t):
        assert rep["handoffs"] >= 1 and rep["crashes_injected"] >= 1
        assert rep["prefill_restarts"] >= 1
        assert rep["lost"] == rep["mismatched"] == rep["decode_restarts"] == 0


def _zero_loss(rep):
    """The run's terminal-state contract, every stage's loss count and
    `mismatched` included."""
    assert rep["hung"] == 0
    for key in ("scheduler", "watchdog", "fleet"):
        assert rep[key]["lost"] == rep[key]["unresolved"] == rep[key]["mismatched"] == 0
    for key in ("kv_pressure", "disagg", "elastic", "qos", "repair"):
        assert rep[key]["lost"] == 0, key
    for key in ("kv_pressure", "disagg", "elastic", "qos"):
        assert rep[key]["mismatched"] == 0, key
    assert rep["transport"]["lost_total"] == 0
    for w in rep["transport"]["waves"].values():
        assert w["lost"] == w["mismatched"] == w["stream_violations"] == 0
    el = rep["elastic"]
    assert el["stream_violations"] == 0 and el["joins"] >= 1 and el["pushed_handoffs"] >= 1


def test_cli_runs_all_ten_stages_deterministically():
    """`python -m ...evalh --chaos --cpu` in its own process prints one
    report with all ten stages and nothing hung or lost; its deterministic
    fields equal an in-process run of the same seed (the default spec's
    outcome histogram follows the host's speed: see
    `test_scheduler_stage_as_jax`)."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "llm_based_apache_spark_optimization_tpu_torch.evalh",
         "--chaos", "--cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    cli = json.loads(res.stdout)
    assert set(cli) >= {"scheduler", "watchdog", "fleet", "kv_pressure", "disagg",
                        "transport", "elastic", "qos", "repair"}
    _zero_loss(cli)
    here = t_chaos.run_chaos(seed=0, device="cpu")
    _zero_loss(here)
    assert sum(here["outcomes"].values()) == sum(cli["outcomes"].values())
    for key, timing in (("scheduler", ("replayed", "restarts")),
                        ("watchdog", HANG_TIMING), ("kv_pressure", PRESSURE_TIMING),
                        ("disagg", DISAGG_TIMING), ("repair", ())):
        assert without(here[key], *timing) == without(cli[key], *timing), key

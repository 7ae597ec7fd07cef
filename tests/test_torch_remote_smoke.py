"""Remote fleets end to end on the CPU: twins of the JAX package's
tests/test_remote_smoke.py (a remote decode worker, and a remote prefill
worker pushing its handoffs, each killed and replaced mid-traffic), with
the worker served by a ReplicaServer thread, run through both packages over
TINY f32 (the port's weights bridged from JAX's); and the port's worker as
a real process (`python -m ...serve.remote --cpu`) killed with SIGKILL.

Each leg checks: the traffic migrates prefill -> decode through the wire;
outputs equal a lone mixed scheduler's and the streams are delivered
exactly once; the loads carry the socket transport's block; after the
worker dies the lease expires, only the remote replica restarts (against a
replacement worker), the journal re-places the lost work with delivered
prefixes suppressed, and nothing is lost. The greedy outputs and counts are
JAX's. Every wait has its own bound; spawned workers are killed in a
`finally`."""

import os
import queue
import random
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.serve import remote as jax_remote
from llm_based_apache_spark_optimization_tpu.serve import resilience as jax_res
from llm_based_apache_spark_optimization_tpu.serve import scheduler as jax_sched
from llm_based_apache_spark_optimization_tpu.serve import supervisor as jax_sup
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params
from llm_based_apache_spark_optimization_tpu_torch.serve import remote as t_remote
from llm_based_apache_spark_optimization_tpu_torch.serve import resilience as t_res
from llm_based_apache_spark_optimization_tpu_torch.serve import scheduler as t_sched
from llm_based_apache_spark_optimization_tpu_torch.serve import supervisor as t_sup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": dict(side="jax", remote=jax_remote, sched=jax_sched, res=jax_res, sup=jax_sup),
    "torch": dict(side="torch", remote=t_remote, sched=t_sched, res=t_res, sup=t_sup),
}


@pytest.fixture(scope="module")
def params():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return {"jax": (JAX_TINY, jp),
            "torch": (TINY, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))}


def mk(pkg, params, role):
    cfg, p = params[pkg["side"]]
    kw = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(2,), max_seq=96,
              kv_layout="paged", kv_page_size=8, phase_role=role)
    if pkg["side"] == "torch":
        kw["device"] = "cpu"
    return pkg["sched"].ContinuousBatchingScheduler(cfg, p, **kw)


def policy(pkg, attempts, max_delay):
    return pkg["res"].RetryPolicy(max_attempts=attempts, base_delay_s=0.001,
                                  max_delay_s=max_delay)


def supervised_pool(pkg, make_replica):
    def make_pool():
        return pkg["sched"].SchedulerPool(
            [make_replica(0), make_replica(1)], factory=make_replica, max_restarts=3,
            restart_policy=policy(pkg, 4, 0.05), rng=random.Random(0), lease_s=0.05,
            lease_misses=2)

    return pkg["sup"].SupervisedScheduler(make_pool, max_restarts=3,
                                          restart_policy=policy(pkg, 4, 0.05),
                                          rng=random.Random(0)).start()


def wait_restarted(sup, label, timeout=20.0):
    """The supervisor's health once replica `label` restarted and serves."""
    deadline = time.monotonic() + timeout
    h = sup.health()
    while time.monotonic() < deadline:
        reps = {r["replica"]: r for r in h.get("replicas", [])}
        if int(reps.get(label, {}).get("restarts", 0)) >= 1 \
                and reps[label]["state"] in ("ready", "degraded"):
            break
        time.sleep(0.02)
        h = sup.health()
    return h, {r["replica"]: r for r in h["replicas"]}


def wave(sup, reqs, seed0):
    streams = [[] for _ in reqs]
    futs = [sup.submit(ids, max_new_tokens=8, seed=seed0 + i, on_token=streams[i].append)
            for i, ids in enumerate(reqs)]
    return streams, futs


def test_remote_decode_fleet_end_to_end(params):
    """A local prefill replica and a remote decode worker: the handoffs
    cross the wire, the loads carry the socket block; the worker dies (its
    server and scheduler torn down) after a replacement boots, only r1
    restarts, the next wave comes out identical with nothing lost, and the
    healed fleet serves through the replacement."""
    reqs = [[1, 5, 9 + i] for i in range(4)]

    def scenario(pkg):
        with mk(pkg, params, "mixed") as ctl:
            want = [ctl.submit(ids, max_new_tokens=8, seed=40 + i).result(timeout=300)
                    for i, ids in enumerate(reqs)]
        workers = []  # (server, scheduler), the newest live

        def spawn_worker():
            sched = mk(pkg, params, "decode")
            sched.start()
            workers.append((pkg["remote"].ReplicaServer(sched), sched))

        spawn_worker()

        def make_replica(i):
            if i == 1:
                return pkg["remote"].SocketTransport(
                    workers[-1][0].address, label="r1", retry_policy=policy(pkg, 2, 0.01),
                    rpc_timeout_s=5.0)
            return mk(pkg, params, "prefill")

        sup = supervised_pool(pkg, make_replica)
        try:
            streams, futs = wave(sup, reqs, 40)
            outs = [f.result(timeout=300) for f in futs]
            pool = sup._inner
            exports = sum(int(r.get("exports", 0))
                          for r in (pool.handoff_stats or {}).get("replicas", []))
            tr = {r["replica"]: r for r in pool.replica_loads()}["r1"]["transport"]
            srv0, sched0 = workers[0]
            spawn_worker()
            srv0.close()
            sched0.shutdown()
            _, futs2 = wave(sup, reqs, 40)
            outs2 = [f.result(timeout=300) for f in futs2]
            h, reps = wait_restarted(sup, "r1")
            out3 = sup.submit(reqs[0], max_new_tokens=8, seed=40).result(timeout=300)
            return (outs, outs == want, streams == outs, exports, tr["kind"],
                    tr["rpcs"] >= 1, outs2 == want, int(reps["r1"]["restarts"]) >= 1,
                    int(reps["r0"]["restarts"]), h["lost"], out3 == want[0])
        finally:
            sup.shutdown()
            for srv, sched in workers:
                srv.close()
                sched.shutdown()

    got = twin_smoke(scenario)
    assert got[1:] == (True, True, 4, "socket", True, True, True, 0, 0, True)


def twin_smoke(scenario):
    want = scenario(PKGS["jax"])
    got = scenario(PKGS["torch"])
    assert got == want
    return got


def test_remote_prefill_push_and_sigkill_mid_handoff(params):
    """A remote prefill worker beside a local decode replica: a clean wave
    crosses as pushed handoffs (the pull path never runs), token-identical,
    streams once; then the worker dies the moment a push of the next wave
    is in flight, the lease expires, only r0 restarts against a replacement,
    and the journal re-prefills the lost work with the delivered prefixes
    suppressed: nothing lost, streams once, outputs identical."""
    reqs = [[1, 5, 9 + i] for i in range(4)]

    def scenario(pkg):
        with mk(pkg, params, "mixed") as ctl:
            want = [ctl.submit(ids, max_new_tokens=8, seed=60 + i).result(timeout=300)
                    for i, ids in enumerate(reqs)]
        workers = []

        def spawn_worker():
            sched = mk(pkg, params, "prefill")
            sched.start()
            workers.append((pkg["remote"].ReplicaServer(sched), sched))

        spawn_worker()

        def make_replica(i):
            if i == 0:
                return pkg["remote"].SocketTransport(
                    workers[-1][0].address, label="r0", retry_policy=policy(pkg, 2, 0.01),
                    rpc_timeout_s=5.0)
            return mk(pkg, params, "decode")

        sup = supervised_pool(pkg, make_replica)
        try:
            pool = sup._inner
            streams, futs = wave(sup, reqs, 60)
            outs = [f.result(timeout=300) for f in futs]
            fl = pool.fleet_stats()
            pushed_before = int(fl["pushed"])
            srv0, sched0 = workers[0]
            spawn_worker()  # the replacement boots before the kill
            streams2, futs2 = wave(sup, reqs, 60)
            deadline = time.monotonic() + 60
            while (int(pool.fleet_stats()["pushed"]) == pushed_before
                   and not all(f.done() for f in futs2) and time.monotonic() < deadline):
                time.sleep(0.002)
            srv0.close()
            sched0.shutdown()
            outs2 = [f.result(timeout=300) for f in futs2]
            h, reps = wait_restarted(sup, "r0")
            return (outs, outs == want, streams == outs, pushed_before, fl["push_bytes"] > 0,
                    outs2 == want, streams2 == outs2, int(reps["r0"]["restarts"]) >= 1,
                    int(reps["r1"]["restarts"]), h["lost"])
        finally:
            sup.shutdown()
            for srv, sched in workers:
                srv.close()
                sched.shutdown()

    got = twin_smoke(scenario)
    assert got[1:] == (True, True, 4, True, True, True, True, 0, 0)


# --------------------------------------------------- the worker as a process


def spawn(extra=()):
    """Start the port's worker on the CPU; (process, address), the address
    read from its listening line within a bound."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_based_apache_spark_optimization_tpu_torch.serve.remote",
         "--cpu", "--kv-layout", "paged", "--kv-page-size", "8", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            break
        if line is None:
            break
        if line.startswith("lsot-remote-worker listening on "):
            return proc, line.split()[-1]
    proc.kill()
    proc.wait(timeout=30)
    raise AssertionError("the worker printed no listening line")


def test_worker_process_sigkill_loses_nothing():
    """`python -m ...serve.remote --cpu --phase-role prefill` as the remote
    prefill replica of a supervised pool beside a local decode replica
    (the worker builds TINY from a seeded generator, as the local replica
    here): two requests cross as pushed handoffs with the control's tokens;
    the worker is killed with SIGKILL once a push of the next two has
    arrived, the lease expires, only r0 restarts, against a replacement
    worker, and the journal replays: nothing lost, same tokens, and the
    healed fleet pushes through the replacement."""
    p = init_params(TINY, torch.Generator(device="cpu").manual_seed(0), dtype=torch.float32,
                    device="cpu")
    pkg = PKGS["torch"]
    params = {"torch": (TINY, p)}
    reqs = [[1, 5, 9], [1, 7, 11, 13]]
    with mk(pkg, params, "mixed") as ctl:
        want = [ctl.submit(ids, max_new_tokens=8, seed=40 + i).result(timeout=120)
                for i, ids in enumerate(reqs)]
    procs = []
    try:
        procs.append(spawn(("--phase-role", "prefill")))

        def make_replica(i):
            if i == 0:
                return t_remote.SocketTransport(procs[-1][1], label="r0",
                                                retry_policy=policy(pkg, 2, 0.01),
                                                rpc_timeout_s=5.0)
            return mk(pkg, params, "decode")

        sup = supervised_pool(pkg, make_replica)
        try:
            pool = sup._inner
            tr = pool.schedulers[0]
            assert (tr.phase_role, tr.num_slots, tr._page_size, tr.cfg.name) == \
                ("prefill", 2, 8, TINY.name)
            streams, futs = wave(sup, reqs, 40)
            assert [f.result(timeout=120) for f in futs] == want and streams == want
            pushed = pool.fleet_stats()["pushed"]
            assert pushed == 2
            procs.append(spawn(("--phase-role", "prefill")))  # the replacement
            streams2, futs2 = wave(sup, reqs, 40)
            deadline = time.monotonic() + 60
            while (pool.fleet_stats()["pushed"] == pushed
                   and not all(f.done() for f in futs2) and time.monotonic() < deadline):
                time.sleep(0.002)
            procs[0][0].send_signal(signal.SIGKILL)
            procs[0][0].wait(timeout=30)
            assert [f.result(timeout=120) for f in futs2] == want
            h, reps = wait_restarted(sup, "r0", timeout=60)
            assert int(reps["r0"]["restarts"]) >= 1 and int(reps["r1"]["restarts"]) == 0
            assert h["lost"] == 0
            assert sup.submit(reqs[0], max_new_tokens=8, seed=40).result(timeout=120) \
                == want[0]
            assert pool.schedulers[0].push_pump_stats["pushed"] >= 1
        finally:
            sup.shutdown()
    finally:
        for proc, _addr in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)


def test_worker_without_a_card_exits_naming_it():
    """Without `--cpu` the worker needs a CUDA card: with none visible it
    exits non-zero before serving, naming the card; there is no CPU
    fallback."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "llm_based_apache_spark_optimization_tpu_torch.serve.remote"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "CUDA" in res.stderr and "--cpu" in res.stderr
    assert "listening" not in res.stdout

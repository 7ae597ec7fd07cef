"""The port's multi-process runtime: twin of tests/test_multihost.py.

Two processes join one gloo group (a `FileStore` in `tmp_path`: no TCP
port), build the dp-outermost `global_mesh`, and each feeds its own rows
through `process_local_batch`; a sum over the whole batch and the gathered
batch show each rank's rows land at its dp index, as JAX's two-process
global array does. The environment mapping of `init_distributed`
(LSOT_COORDINATOR / LSOT_NUM_PROCESSES / LSOT_PROCESS_ID -> a `tcp://`
rendezvous) is checked against the call it makes.
"""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu_torch.parallel import multihost
from torch_spmd import run_group


def test_two_process_global_mesh_and_batch_assembly(tmp_path):
    ranks = run_group(2, "multihost_group", tmp_path)
    assert [r["primary"] for r in ranks] == [True, False]
    assert [r["coords"]["dp"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["shape"] == (3, 5)
        # sum(0..14) + sum(100..114): both processes' rows.
        assert r["total"] == 1710.0
        # Row order: process 0's rows first in the dp-sharded batch.
        assert r["whole"][0].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
        np.testing.assert_array_equal(r["whole"][3:], r["whole"][:3] + 100)


def test_init_distributed_maps_the_environment(monkeypatch):
    """LSOT_COORDINATOR / LSOT_NUM_PROCESSES / LSOT_PROCESS_ID become
    `init_process_group("gloo", init_method="tcp://...")`; without them,
    one process is a no-op; a coordinator without a process count raises."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(multihost, "_initialized", False)
    for name in ("LSOT_COORDINATOR", "LSOT_NUM_PROCESSES", "LSOT_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.init_distributed() is False and not calls
    monkeypatch.setenv("LSOT_COORDINATOR", "10.0.0.1:4321")
    with pytest.raises(ValueError, match="LSOT_NUM_PROCESSES"):
        multihost.init_distributed()
    monkeypatch.setenv("LSOT_NUM_PROCESSES", "4")
    monkeypatch.setenv("LSOT_PROCESS_ID", "3")
    assert multihost.init_distributed() is True
    assert calls == [("gloo", dict(init_method="tcp://10.0.0.1:4321",
                                   world_size=4, rank=3))]
    monkeypatch.setattr(multihost, "_initialized", False)


def _clear_group_env(monkeypatch):
    for name in ("LSOT_COORDINATOR", "LSOT_NUM_PROCESSES", "LSOT_PROCESS_ID",
                 "LSOT_MESH_DEVICES", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("entry", ["app", "runbook"])
@pytest.mark.parametrize("cards", [0, 1])
def test_mesh_without_a_card_each_raises(monkeypatch, entry, cards):
    """`--tp 2` without `--cpu` puts one rank on each card: on a host
    without two cards the command raises before it starts a rank, rather
    than forming a mesh of CPU ranks or stacking both on one card."""
    from llm_based_apache_spark_optimization_tpu_torch import runbook
    from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as app
    from llm_based_apache_spark_optimization_tpu_torch.parallel import launch

    _clear_group_env(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    started = []
    monkeypatch.setattr(launch.subprocess, "Popen",
                        lambda *a, **kw: started.append(a))
    with pytest.raises(RuntimeError, match=f"needs 2 CUDA devices.*has {cards}"):
        if entry == "app":
            app.main(["--backend", "tiny", "--tp", "2"])
        else:
            runbook.main(["--sql-model", "unused", "--tp", "2"])
    assert not started
    assert launch.mesh_devices(2, cpu=True) == ["cpu", "cpu"]
    monkeypatch.setenv("LSOT_MESH_DEVICES", "cuda:0,cuda:0")
    assert launch.mesh_devices(2, cpu=False) == ["cuda:0", "cuda:0"]


def test_ranks_naming_their_own_cards_need_one_each(monkeypatch):
    """Under an outer launcher each rank names its own card: none raises,
    and two ranks of one host on one card raise (a shared card is asked for
    by listing the devices)."""
    import torch.distributed as dist

    _clear_group_env(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.local_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj: out.__setitem__(slice(None), [obj, obj]))
    with pytest.raises(RuntimeError, match="would share cuda:0"):
        multihost.global_mesh(tp=2)


def _run(code: str, timeout: float = 60.0):
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def test_a_rank_that_exits_ends_rank0():
    """Rank 0 watches the ranks it started: one that exits before rank 0
    ends the group ends rank 0 too, with its exit code, while rank 0 would
    otherwise wait on it."""
    proc, took = _run(
        "import subprocess, sys, time\n"
        "from llm_based_apache_spark_optimization_tpu_torch.parallel.launch import Ranks\n"
        "Ranks([subprocess.Popen([sys.executable, '-c', 'import sys; sys.exit(3)'])])\n"
        "time.sleep(60)\n")
    assert proc.returncode == 3, proc.stderr
    assert "rank 1 exited with code 3" in proc.stderr
    assert took < 30


def test_a_failed_follower_exits_at_once():
    """A follower rank whose step loop fails exits with code 1 at once,
    though a thread of its own would keep it alive."""
    proc, took = _run(
        "import threading, time\n"
        "from llm_based_apache_spark_optimization_tpu_torch.parallel import launch\n"
        "from llm_based_apache_spark_optimization_tpu_torch.parallel.mesh import Mesh\n"
        "threading.Thread(target=time.sleep, args=(60,)).start()\n"
        "launch.follow(Mesh(1, 1, 2, ['cpu'] * 2, rank=1))\n")
    assert proc.returncode == 1, proc.stderr
    assert "Traceback" in proc.stderr
    assert took < 30


def test_a_dead_follower_fails_rank0s_post(tmp_path):
    """A follower's failed step: its close re-raises it, and rank 0's next
    post fails within rank 0's step timeout (the follower's wait on the
    channel keeps its long one)."""
    ranks = run_group(2, "dead_follower_group", tmp_path, dict(timeout_s=2))
    assert ranks[1][0] is not None and "follower's step failed" in ranks[1][0]
    assert ranks[0][0] is not None and "Timed out" in ranks[0][0]
    assert ranks[0][1] < 30

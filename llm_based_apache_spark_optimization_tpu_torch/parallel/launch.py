"""One command for a mesh: the entry points start their own follower ranks.

`python -m ...app --tp 2` and `python -m ...runbook --tp 2` are single
commands, as their JAX counterparts are. Started alone (no LSOT_COORDINATOR
in the environment), the command becomes rank 0 of a group of dp*sp*tp
processes: it starts the other ranks as copies of itself with the same
arguments, LSOT_COORDINATOR (a free localhost port), LSOT_NUM_PROCESSES,
LSOT_PROCESS_ID and the mesh's device list (LSOT_MESH_DEVICES) in their
environment, and joins them (`join`). Every rank builds the same mesh and
the same service; then rank 0 serves and drives, and the others follow its
steps (parallel/spmd.py) until it closes the channel (`finish`). Started
with those variables set (by an outer launcher, one process a node),
nothing is spawned: the process joins the group as the rank it is told.

The mesh's devices (`mesh_devices`), settled before any rank starts:
`["cpu"] * n` with `--cpu`; else LSOT_MESH_DEVICES ("cuda:0,cuda:0" puts
two ranks on one card, over gloo); else one card a rank, `cuda:0..n-1`,
and a host with fewer cards raises. Under an outer launcher each rank
names its own card (`multihost.local_device`). Nothing falls back to the
CPU or to a shared card.

Rank 0 watches the ranks it started: one that exits before rank 0 ends the
group ends rank 0 too, with that rank's exit code (its collectives would
otherwise wait on a peer that is gone). A follower whose step loop fails
exits at once with code 1 (`follow`), so rank 0 sees it.

A replica pool of tp meshes (`--dp N --tp M --scheduler`, `join_pool`) is
one command too: its process is world rank 0 and rank 0 of every replica's
submesh, and it starts the other M-1 ranks of each local replica
(1 + N*(M-1) processes in all; parallel/mesh.make_submeshes). Replica i's
shards sit on `pool_devices(...)[i*M:(i+1)*M]`, JAX's device slice. Under
an outer launcher the pool is refused (ROADMAP A13.5): the JAX entry point
never joins a multi-host runtime (its `init_distributed` is exported and
called by no entry point), so there is no path of its to follow.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import traceback
from typing import List, Optional, Sequence, Tuple

import torch

from .mesh import Mesh

_WATCH_PERIOD_S = 0.5
# Set in the environment of the ranks `start_group` starts: such a rank is
# not under an outer launcher.
_STARTED_BY = "LSOT_STARTED_BY"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks(list):
    """The follower processes rank 0 started, watched by a thread until
    `finish` ends the group."""

    def __init__(self, procs: Sequence[subprocess.Popen]):
        super().__init__(procs)
        self.ending = threading.Event()
        if procs:
            threading.Thread(target=self._watch, name="lsot-rank-watch",
                             daemon=True).start()

    def _watch(self) -> None:
        while not self.ending.wait(_WATCH_PERIOD_S):
            for rank, p in enumerate(self, 1):
                rc = p.poll()
                if rc is None or self.ending.is_set():
                    continue
                print(f"rank {rank} exited with code {rc} before rank 0 ended "
                      "the group: ending the group", file=sys.stderr, flush=True)
                for q in self:
                    if q.poll() is None:
                        q.kill()
                os._exit(rc or 1)


def mesh_devices(world: int, cpu: bool) -> Optional[List[str]]:
    """The device of each rank (module docstring); None where each rank
    names its own card (an outer launcher, or a group formed already)."""
    if cpu:
        return ["cpu"] * world
    spec = os.environ.get("LSOT_MESH_DEVICES", "")
    devices = [d.strip() for d in spec.split(",") if d.strip()]
    if devices:
        return devices
    import torch.distributed as dist

    if os.environ.get("LSOT_NUM_PROCESSES") or dist.is_initialized():
        return None
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < world:
        raise RuntimeError(
            f"a mesh of {world} ranks needs {world} CUDA devices, one a rank; "
            f"this host has {count}. Pass --cpu for CPU ranks, or name the "
            "placement with LSOT_MESH_DEVICES (cuda:0,cuda:0 puts two ranks "
            "on one card)")
    return [f"cuda:{i}" for i in range(world)]


def start_group(world: int, module: str, argv: Sequence[str],
                devices: Optional[Sequence[str]] = None) -> Ranks:
    """Join this process into a group of `world` ranks, starting the other
    ranks (`python -m module *argv`, told `devices`) unless the process is
    in a group already or the environment names its rank. Returns the
    started processes (rank 0 only), watched until `finish`."""
    from .multihost import init_distributed

    import torch.distributed as dist

    if world <= 1:
        return Ranks([])
    if dist.is_initialized():  # joined already (an embedding program's group)
        if dist.get_world_size() != world:
            raise ValueError(f"the group has {dist.get_world_size()} ranks, the "
                             f"flags ask for {world}")
        return Ranks([])
    if os.environ.get("LSOT_NUM_PROCESSES"):
        if int(os.environ["LSOT_NUM_PROCESSES"]) != world:
            raise ValueError(f"LSOT_NUM_PROCESSES={os.environ['LSOT_NUM_PROCESSES']} "
                             f"but the flags ask for {world} ranks")
        init_distributed()
        return Ranks([])
    addr = f"127.0.0.1:{_free_port()}"
    extra = {"LSOT_MESH_DEVICES": ",".join(devices)} if devices else {}
    procs = []
    for rank in range(1, world):
        env = dict(os.environ, LSOT_COORDINATOR=addr,
                   LSOT_NUM_PROCESSES=str(world), LSOT_PROCESS_ID=str(rank),
                   **{_STARTED_BY: str(os.getpid())}, **extra)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv], env=env))
    children = Ranks(procs)
    init_distributed(addr, world, 0)
    return children


def join(dp: int, sp: int, tp: int, cpu: bool, module: str,
         argv: Sequence[str]) -> Tuple[Mesh, Ranks]:
    """The entry points' mesh: its devices settled, the group formed (the
    other ranks started where this command is rank 0), the mesh built over
    it and printed on rank 0."""
    from .multihost import global_mesh

    world = dp * sp * tp
    devices = mesh_devices(world, cpu)
    children = start_group(world, module, argv, devices)
    mesh = global_mesh(dp=dp, sp=sp, tp=tp, devices=devices)
    if mesh.is_primary:
        print(mesh.describe(), file=sys.stderr)
    return mesh, children


def pool_devices(dp: int, tp: int, cpu: bool) -> List[str]:
    """The card of each shard of a pool of dp tp-replicas, replica i's shard
    j at i*tp + j: all "cpu" with `--cpu`; else LSOT_MESH_DEVICES (dp*tp
    entries; "cuda:0,cuda:0,cuda:0,cuda:0" puts a dp=2 tp=2 pool on one
    card, over gloo); else `cuda:0..dp*tp-1`, and a host with fewer cards
    raises."""
    n = dp * tp
    if cpu:
        return ["cpu"] * n
    spec = os.environ.get("LSOT_MESH_DEVICES", "")
    devices = [d.strip() for d in spec.split(",") if d.strip()]
    if devices:
        if len(devices) != n:
            raise ValueError(f"LSOT_MESH_DEVICES lists {len(devices)} devices; a "
                             f"pool of {dp} tp={tp} replicas has {n} shards")
        return devices
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        raise RuntimeError(
            f"a pool of {dp} tp={tp} replicas needs {n} CUDA devices, one a "
            f"shard; this host has {count}. Pass --cpu, or name the placement "
            "with LSOT_MESH_DEVICES")
    return [f"cuda:{i}" for i in range(n)]


def join_pool(dp: int, tp: int, cpu: bool, module: str, argv: Sequence[str],
              local: Optional[Sequence[int]] = None
              ) -> Tuple[List[Optional[Mesh]], Ranks]:
    """A replica pool's submeshes (module docstring): the group of 1 +
    len(local)*(tp-1) ranks formed (this command starting the others where
    it is rank 0), then one tp mesh for each replica of `local` (default
    all: the others are remote slots, with no mesh). Returns the mesh of
    each replica index (None where this rank holds no shard of it) and the
    started ranks."""
    import torch.distributed as dist

    from .mesh import make_submeshes

    if os.environ.get("LSOT_PROCESS_ID") and not os.environ.get(_STARTED_BY) \
            and not dist.is_initialized():
        raise NotImplementedError(
            "a replica pool of tp meshes under an outer launcher (LSOT_PROCESS_ID "
            "set by another program) is refused: ROADMAP A13.5. The JAX entry "
            "point never initialises a multi-host runtime (its init_distributed "
            "is called by no entry point), so the port has no path to follow; "
            "start the pool as one command")
    local = list(range(dp)) if local is None else list(local)
    devices = pool_devices(dp, tp, cpu)
    children = start_group(1 + len(local) * (tp - 1), module, argv, devices)
    meshes = make_submeshes(tp, [devices[i * tp:(i + 1) * tp] for i in local])
    out: List[Optional[Mesh]] = [None] * dp
    for i, m in zip(local, meshes):
        out[i] = m
    if not dist.is_initialized() or dist.get_rank() == 0:
        for i in local:
            print(f"replica {i}: {out[i].describe()}", file=sys.stderr)
    return out, children


def follow(*meshes: Mesh) -> None:
    """A follower rank: follow rank 0's steps on each mesh until it closes
    the channel. A failure ends the process at once with code 1, whatever
    threads it still has, so rank 0's watch sees it."""
    from . import spmd

    try:
        for mesh in meshes:
            spmd.close(mesh)
    except BaseException:  # noqa: BLE001 — reported, then the process ends
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def finish(mesh, children: Sequence[subprocess.Popen],
           timeout: float = 120.0) -> None:
    """Close the step channel of `mesh` (a Mesh, a list of them as
    `join_pool` gives, or None) and wait for the started ranks to exit."""
    ending = getattr(children, "ending", None)
    if ending is not None:
        ending.set()
    from . import spmd

    for m in (mesh if isinstance(mesh, (list, tuple)) else [mesh]):
        if m is not None:
            spmd.close(m)
    for p in children:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()

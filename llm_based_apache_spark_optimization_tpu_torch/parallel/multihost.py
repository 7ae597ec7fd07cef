"""Multi-process (multi-node) runtime: joining ranks into one group.

Counterpart of the JAX package's `parallel/multihost.py`. There every host
runs the same program and `jax.distributed.initialize` makes
`jax.devices()` span all hosts. Here every rank is a process: the same
environment variables, LSOT_COORDINATOR (host:port), LSOT_NUM_PROCESSES
and LSOT_PROCESS_ID, map to `torch.distributed.init_process_group` over a
`tcp://` rendezvous, and a mesh built over the world's devices
(`global_mesh`) spans every node. With none of them set and one process,
every function here is a no-op, as in JAX.

The default group is gloo: it carries the host-side traffic (object
broadcasts, the step channel); the mesh forms its own axis groups, NCCL
where every rank has its own card (parallel/mesh.py).
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import torch

from .mesh import Mesh, make_mesh

_initialized = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    init_method: Optional[str] = None,
) -> bool:
    """Join this process into the group; returns True if it did.

    Arguments default to LSOT_COORDINATOR, LSOT_NUM_PROCESSES and
    LSOT_PROCESS_ID. `init_method` replaces the tcp rendezvous (a
    `file://` store, as the tests use). Safe to call unconditionally: a
    single process with no coordinator is a no-op."""
    global _initialized
    import torch.distributed as dist

    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    coordinator_address = coordinator_address or os.environ.get("LSOT_COORDINATOR")
    num_processes = num_processes or _int_env("LSOT_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("LSOT_PROCESS_ID")
    if coordinator_address is None and init_method is None and num_processes is None:
        return False  # single-process mode
    if num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs the number of processes and this "
            "process's id (LSOT_NUM_PROCESSES, LSOT_PROCESS_ID)")
    if init_method is None:
        if coordinator_address is None:
            raise ValueError("init_distributed needs LSOT_COORDINATOR "
                             "(host:port) for more than one process")
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=int(num_processes), rank=int(process_id))
    _initialized = True
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def local_device() -> torch.device:
    """This process's card: LOCAL_RANK (or the rank) modulo the node's
    cards. Raises where there is no card: CPU ranks are asked for by name
    (`devices=["cpu"] * n`, an entry point's `--cpu`)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {process_index()} has no CUDA device: pass --cpu (or "
            "devices=['cpu'] * n) for a mesh of CPU ranks")
    local = _int_env("LOCAL_RANK")
    idx = process_index() if local is None else local
    return torch.device(f"cuda:{idx % torch.cuda.device_count()}")


def global_mesh(
    dp: int = 1,
    sp: int = 1,
    tp: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """(dp, sp, tp) mesh over every rank of the group (all nodes), each
    rank on `local_device()` unless `devices` lists them. dp is outermost,
    so its boundaries fall between nodes, and sp/tp collectives stay within
    one. Single-process it equals `mesh.make_mesh`. Ranks that name their
    own cards must name distinct ones: two ranks on one card are asked for
    by listing `devices`."""
    import torch.distributed as dist

    if devices is None:
        here = (socket.gethostname(), str(local_device()))
        if dist.is_initialized():
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, here)
        else:
            gathered = [here]
        first = {}
        for rank, where in enumerate(gathered):
            if where in first:
                raise RuntimeError(
                    f"ranks {first[where]} and {rank} would share {where[1]} "
                    f"on {where[0]}: give each rank a card of its own "
                    "(LOCAL_RANK), or list the devices (LSOT_MESH_DEVICES)")
            first[where] = rank
        devices = [d for _, d in gathered]
    if dp * sp * tp != len(devices):
        raise ValueError(
            f"dp*sp*tp = {dp * sp * tp} != global device count {len(devices)}"
        )
    return make_mesh(dp, sp, tp, devices)


def process_local_batch(local_batch, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a dp-sharded global batch, on its device.

    Each rank feeds only its own requests; the global batch is the
    concatenation of the dp ranks' local batches in dp order and no rank
    ever materializes it (`sharding.gather_batch` assembles it where a
    caller needs it whole). Every dp rank must bring the same number of
    rows."""
    x = torch.as_tensor(local_batch)
    if mesh.shape["dp"] > 1:
        import torch.distributed as dist

        rows = [None] * mesh.size
        dist.all_gather_object(rows, int(x.shape[0]), group=mesh.control)
        if len(set(rows)) != 1:
            raise ValueError(f"dp ranks bring unequal local batches: {rows}")
    return x.to(mesh.device)


def is_primary() -> bool:
    """True on the process that does singleton work (serving the HTTP
    front end, logging, writing history rows): rank 0."""
    return process_index() == 0

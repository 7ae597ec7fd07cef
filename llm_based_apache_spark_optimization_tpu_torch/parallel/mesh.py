"""Device mesh for TP x SP x DP sharded inference, one process per rank.

Counterpart of the JAX package's `parallel/mesh.py`. JAX is
single-controller: one program sees every device, places global arrays
with `NamedSharding`, and GSPMD inserts the collectives. PyTorch's idiom is
SPMD: each rank is a process under `torch.distributed`, holds only its own
shard, and the collectives are explicit (`ops/common.py`). A `Mesh` is one
rank's view of the (dp, sp, tp) grid: its coordinates, its device, and the
process group of each axis it lies on.

Axes, as in JAX:
  dp — request parallelism: the batch axis of the engine's requests.
  sp — sequence parallelism: long-prompt prefill through ring attention
       (ops/ring_attention.py), and decode cache slots sharded over sp.
  tp — tensor parallelism (Megatron): attention heads, the MLP's hidden
       axis and the vocabulary.

Rank r sits at (dp, sp, tp) = divmod chain of r with tp varying fastest,
as JAX's `reshape(dp, sp, tp)` of the device list: tp neighbours are
adjacent ranks, and dp is outermost (multihost.global_mesh).

Backends follow from the device list and are never swapped on failure:
NCCL when every rank has a card of its own, gloo for CPU ranks and for a
card that appears more than once (NCCL refuses two ranks on one device).
Gloo cannot move CUDA tensors point to point, so on such a layout every
collective stages its tensors through host memory (`Mesh.staged`), and
the callers that print a layout say so. A group that fails to form raises:
nothing falls back to one rank or to the CPU.

Every rank also joins two gloo groups over all ranks: `Mesh.steps`, the
channel on which rank 0 broadcasts the steps its host loop takes to the
others (parallel/spmd.py), used by nothing else, and `Mesh.control`, for
the host-side collectives every rank runs itself (barriers, object
broadcasts and gathers): a follower's step loop waits on the one while its
main thread may use the other. A follower waits on the step channel for as
long as rank 0 is idle; rank 0's posts time out after 30 minutes.
"""

from __future__ import annotations

import dataclasses
import datetime
import threading
import weakref
from typing import Dict, List, Optional, Sequence

import torch

from ..models.configs import LlamaConfig

AXES = ("dp", "sp", "tp")

# The step channel carries the serving loop's steps. A follower waits on it
# for as long as no request arrives; rank 0 waits on it only while a step
# it posts is outstanding, for a follower busy with the step before, so a
# follower that is gone fails rank 0's post rather than hanging it. Each
# rank's timeout is its own.
_IDLE_TIMEOUT = datetime.timedelta(days=365)
_STEP_TIMEOUT = datetime.timedelta(minutes=30)


def _device_list(devices, n: int) -> List[torch.device]:
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(count)]
    return [torch.device(d) for d in devices]


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if all(d.type == "cuda" for d in devices) and \
            len({(d.index or 0) for d in devices}) == len(devices):
        return "nccl"
    return "gloo"


class Mesh:
    """One rank's view of a (dp, sp, tp) mesh: `shape`, `coords`, `device`,
    `backend`, and `group(axis)`, the process group of the ranks that share
    this rank's other two coordinates (None for an axis of size 1)."""

    def __init__(self, dp: int, sp: int, tp: int,
                 devices: Sequence[torch.device], rank: int = 0,
                 groups: Optional[Dict[str, object]] = None,
                 control=None, steps=None, backend: str = "gloo",
                 ranks: Optional[Sequence[int]] = None):
        self.shape = {"dp": dp, "sp": sp, "tp": tp}
        self.devices = [torch.device(d) for d in devices]
        self.size = dp * sp * tp
        self.rank = rank
        # The world rank of each rank of this mesh (a submesh spans part of
        # the world); `rank` and `coords` are the mesh's own.
        self.ranks = list(range(self.size)) if ranks is None else list(ranks)
        self.coords = {"dp": rank // (sp * tp), "sp": (rank // tp) % sp,
                       "tp": rank % tp}
        self.device = self.devices[rank]
        self.backend = backend
        self._groups = groups or {}
        self.control = control
        self.steps = steps
        # Gloo over CUDA tensors: every collective goes through host memory.
        self.staged = backend == "gloo" and self.device.type == "cuda"
        # Rank 0's host loops hold this around a step they broadcast and
        # the collectives it runs, so steps of two threads never interleave.
        self.lock = threading.RLock()
        self.driving = False
        # Driven objects by index, held weakly: a closed or dropped one goes
        # when its owner lets it go (`_kept` holds those nothing else does).
        self._targets: List[weakref.ref] = []
        self._registered = threading.Condition()
        self._kept: List[object] = []
        # index -> (key, factory): how a follower rebuilds the object of
        # that index when rank 0 rebuilds it (a supervised restart).
        self._recipes: Dict[int, tuple] = {}
        self._follower = None
        # Param trees placed on the mesh (`place`), by index: each a list of
        # (path, weak reference to the leaf), so no tree outlives its owner.
        self._trees: List[List[tuple]] = []

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"tp={self.shape['tp']}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend}"
                f"{', staged through host' if self.staged else ''})")

    def describe(self) -> str:
        """The layout in one line, as entry points print it."""
        staged = (" (gloo on CUDA tensors: collectives staged through host "
                  "memory)" if self.staged else "")
        part = ("" if self.ranks == list(range(self.size))
                else f" as world ranks {self.ranks}")
        return (f"mesh dp={self.shape['dp']} sp={self.shape['sp']} "
                f"tp={self.shape['tp']} over {[str(d) for d in self.devices]}"
                f"{part}, backend {self.backend}{staged}")

    def group(self, axis: str):
        return self._groups.get(axis)

    def axis_ranks(self, axis: str) -> List[int]:
        """World ranks along `axis` through this rank, in axis order."""
        return [self.ranks[r] for r in _axis_ranks(self.shape, self.rank, axis)]

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def local_cfg(self, cfg: LlamaConfig) -> LlamaConfig:
        """The per-rank shape of a model under this mesh: a tp-th of the
        query heads, KV heads and MLP hidden axis (what this rank's caches
        and weights hold). Vocabulary and widths stay whole."""
        tp = self.shape["tp"]
        if tp == 1:
            return cfg
        return dataclasses.replace(
            cfg, num_heads=cfg.num_heads // tp,
            num_kv_heads=cfg.num_kv_heads // tp,
            intermediate_size=cfg.intermediate_size // tp)

    # The step channel (parallel/spmd.py): objects driven by rank 0 register
    # in construction order, which every rank follows.
    def register(self, obj) -> int:
        with self._registered:
            self._targets.append(weakref.ref(obj))
            self._registered.notify_all()
            return len(self._targets) - 1

    def target(self, idx: int):
        """Object `idx`; a follower's step for an object its own main
        thread has not built yet waits for it (rank 0 may build and drive
        its twin first)."""
        with self._registered:
            self._registered.wait_for(lambda: idx < len(self._targets))
        obj = self._targets[idx]()
        if obj is None:
            raise RuntimeError(f"mesh target {idx} is gone: its owner dropped it "
                               "while rank 0 still drives it")
        return obj

    def drop(self, idx: int) -> None:
        """Forget object `idx` (rank 0 shut it down), and let go of it if
        only the mesh held it (a follower's twin or build)."""
        with self._registered:
            self._registered.wait_for(lambda: idx < len(self._targets))
            obj = self._targets[idx]()
            self._targets[idx] = lambda: None
            self._kept = [o for o in self._kept if o is not obj]

    # Param trees: every rank places the same trees in the same order
    # (`parallel.sharding.shard_params`, which every engine and scheduler
    # calls), so an index names the same tree on every rank. Rank 0 builds a
    # scheduler while the others follow by posting its tree's index.
    def _replaying(self) -> bool:
        """True where a placement is rank 0's alone or a replayed step's:
        rank 0 while it drives, a follower on its step loop's thread."""
        if self.driving and self.is_primary:
            return True
        f = self._follower
        return f is not None and f.thread is threading.current_thread()

    def place(self, tree) -> Optional[int]:
        """Give param tree `tree` (a nested dict of tensors) the mesh's
        next index, held by weak references to its leaves; a tree placed
        before keeps its index. While rank 0 drives, or on a follower's
        step loop, nothing is placed (the other ranks place nothing then):
        returns the index, or None."""
        idx = self.tree_index(tree)
        if idx is not None or self._replaying():
            return idx
        self._trees.append([(path, weakref.ref(leaf)) for path, leaf in _leaves(tree)])
        return len(self._trees) - 1

    def tree_index(self, tree) -> Optional[int]:
        """The index `place` gave `tree` (the same leaves), or None."""
        leaves = list(_leaves(tree))
        for i, entry in enumerate(self._trees):
            if len(entry) == len(leaves) and all(
                    p == q and ref() is x for (p, ref), (q, x) in zip(entry, leaves)):
                return i
        return None

    def tree(self, idx: int) -> dict:
        """Placed tree `idx`, rebuilt from its leaves; raises if its owner
        dropped it."""
        out: dict = {}
        for path, ref in self._trees[idx]:
            leaf = ref()
            if leaf is None:
                raise RuntimeError(f"param tree {idx} placed on this mesh is gone: "
                                   "its owner dropped it while rank 0 builds on it")
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return out


def _leaves(tree, path=()):
    """(path, tensor) for every leaf of a nested dict of tensors."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree



def _axis_ranks(shape: Dict[str, int], rank: int, axis: str) -> List[int]:
    dp, sp, tp = shape["dp"], shape["sp"], shape["tp"]
    d, s, t = rank // (sp * tp), (rank // tp) % sp, rank % tp
    if axis == "tp":
        return [(d * sp + s) * tp + i for i in range(tp)]
    if axis == "sp":
        return [(d * sp + i) * tp + t for i in range(sp)]
    return [(i * sp + s) * tp + t for i in range(dp)]


def make_mesh(
    dp: int = 1,
    sp: int = 1,
    tp: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (dp, sp, tp) mesh over `devices`, one per rank (default: one per
    card, `cuda:0..n-1`). Raises when dp*sp*tp differs from the device
    count. A mesh of more than one rank needs `torch.distributed`
    initialised with that many ranks (`multihost.init_distributed`); every
    rank must call this with the same arguments, since forming the axis
    groups is collective. A repeated card or CPU devices give a gloo mesh,
    distinct cards an NCCL one (module docstring)."""
    devs = _device_list(devices, dp * sp * tp)
    if dp * sp * tp != len(devs):
        raise ValueError(
            f"dp*sp*tp = {dp * sp * tp} != device count {len(devs)}"
        )
    backend = backend_for(devs)
    if len(devs) == 1:
        return Mesh(dp, sp, tp, devs, rank=0, backend=backend)
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {len(devs)} ranks needs torch.distributed "
            f"initialised with {len(devs)} processes "
            "(parallel.init_distributed)")
    if dist.get_world_size() != len(devs):
        raise ValueError(
            f"dp*sp*tp = {len(devs)} != world size {dist.get_world_size()}")
    rank = dist.get_rank()
    if backend == "nccl":
        torch.cuda.set_device(devs[rank])
    shape = {"dp": dp, "sp": sp, "tp": tp}
    groups: Dict[str, object] = {}
    # new_group is collective over the world: every rank forms every group
    # in the same order, and keeps the ones it lies on.
    for axis in AXES:
        if shape[axis] == 1:
            continue
        seen = set()
        for r in range(len(devs)):
            ranks = tuple(_axis_ranks(shape, r, axis))
            if ranks in seen:
                continue
            seen.add(ranks)
            g = dist.new_group(list(ranks), backend=backend)
            if rank in ranks:
                groups[axis] = g
    control = dist.new_group(list(range(len(devs))), backend="gloo")
    steps = dist.new_group(list(range(len(devs))), backend="gloo",
                           timeout=_STEP_TIMEOUT if rank == 0 else _IDLE_TIMEOUT)
    return Mesh(dp, sp, tp, devs, rank=rank, groups=groups, control=control,
                steps=steps, backend=backend)


def make_submeshes(tp: int, devices: Sequence[Sequence]) -> List[Optional[Mesh]]:
    """A replica pool's tp meshes over one world: mesh i over the cards
    `devices[i]` (tp of them), as world ranks [0, 1 + i*(tp-1), ...,
    (i+1)*(tp-1)], so world rank 0 (the pool's process) is rank 0 of every
    mesh and the world has 1 + len(devices)*(tp-1) ranks. Every world rank
    calls this with the same arguments, since forming the groups is
    collective; it returns the meshes this rank lies on, None for the
    others. Each mesh has its own tp group (NCCL where its ranks' cards
    differ, else gloo), control group and step channel. A follower rank
    makes its card current; the pool's process names a replica's card on
    that replica's threads."""
    n = len(devices)
    world = 1 + n * (tp - 1)
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            f"a pool of {n} tp={tp} meshes needs torch.distributed initialised "
            f"with {world} processes (parallel.init_distributed)")
    if dist.get_world_size() != world:
        raise ValueError(f"a pool of {n} tp={tp} meshes has {world} ranks, the "
                         f"world {dist.get_world_size()}")
    rank = dist.get_rank()
    out: List[Optional[Mesh]] = []
    for i, devs in enumerate(devices):
        devs = [torch.device(d) for d in devs]
        if len(devs) != tp:
            raise ValueError(f"mesh {i} lists {len(devs)} devices for tp={tp}")
        ranks = [0] + [1 + i * (tp - 1) + j for j in range(tp - 1)]
        backend = backend_for(devs)
        local = ranks.index(rank) if rank in ranks else None
        # new_group is collective over the world: every rank forms every
        # mesh's groups in the same order.
        tp_group = dist.new_group(ranks, backend=backend)
        control = dist.new_group(ranks, backend="gloo")
        steps = dist.new_group(ranks, backend="gloo",
                               timeout=_STEP_TIMEOUT if local == 0 else _IDLE_TIMEOUT)
        if local is None:
            out.append(None)
            continue
        if local > 0 and devs[local].type == "cuda":
            torch.cuda.set_device(devs[local])
        out.append(Mesh(1, 1, tp, devs, rank=local, groups={"tp": tp_group},
                        control=control, steps=steps, backend=backend, ranks=ranks))
    return out

"""The step channel: rank 0's host loop, replayed by the other ranks.

The JAX package is single-controller: its scheduler's host loop issues
programs over global arrays, and every cache operation is one XLA
partitions. In the port each rank is a process that holds its own shard,
and the engine and the scheduler are host loops driven by wall clock,
deadlines, admission and HTTP arrivals: ranks running those loops on their
own would diverge and deadlock in their first collective.

So rank 0 (`multihost.is_primary`) runs the entry point, the service and
the host loops, and the other ranks follow. An object that rank 0 drives
(a scheduler; an engine once `drive` is on) registers with the mesh in
construction order, which every rank follows, so the same index names it
everywhere. A scheduler rank 0 builds while the others follow has them
build its counterpart first: a twin from the recipe of an earlier one with
the same params and arguments (a supervised restart, `post_rebuild`), or
else an object from a posted factory over a param tree every rank placed
(`post_build`, `Mesh.place`). For each device step it takes (a forward, a cache operation,
an engine call) rank 0 broadcasts a small descriptor over the mesh's gloo
step group (`Mesh.steps`), `(target, method, args, kwargs)` with its host
tensors,
under `mesh.lock`; every rank then applies the step to its own shard, in
the same order, so the collectives inside line up. The followers run
`follow`: one loop a process, in a thread (`ensure_following`) or in the
main thread of a follower process, until rank 0 posts the end (`close`).
"""

from __future__ import annotations

import threading
from typing import Any

import torch

_END = "__end__"
_CLOSE = "__close__"
_REBUILD = "__rebuild__"
_BUILD = "__build__"


def _to_host(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu")
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _to_device(obj: Any, device: torch.device) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


def _bcast(mesh, msg=None):
    import torch.distributed as dist

    box = [msg]
    dist.broadcast_object_list(box, src=mesh.ranks[0], group=mesh.steps)
    return box[0]


def post(mesh, target: int, method: str, *args, **kwargs) -> None:
    """Rank 0: tell every follower to call `method(*args, **kwargs)` on its
    own object `target`. The caller holds `mesh.lock` through the post and
    its own matching step."""
    _bcast(mesh, (target, method, _to_host(args), _to_host(kwargs)))


def post_close(mesh, target: int) -> None:
    """Rank 0: object `target` is shut down; its followers may return."""
    with mesh.lock:
        _bcast(mesh, (target, _CLOSE, (), {}))
    mesh.drop(target)


def post_rebuild(mesh, recipe: int) -> None:
    """Rank 0: every follower builds and starts an object from its recipe
    `recipe` (`Mesh._recipes`) and registers it next, as rank 0 registers
    the object it builds. The caller holds `mesh.lock`."""
    _bcast(mesh, (recipe, _REBUILD, (), {}))


def post_build(mesh, tree: int, factory) -> None:
    """Rank 0: every follower builds and starts `factory(params=<its placed
    tree `tree`>, mesh=<its mesh>)` (`Mesh.place`, `Mesh.tree`) and
    registers it next, as rank 0 registers the object it builds: an object
    with no earlier twin. `factory` is picklable (a `functools.partial` of
    a class and its arguments). The caller holds `mesh.lock`."""
    _bcast(mesh, (tree, _BUILD, (factory,), {}))


def _keep_started(mesh, obj) -> None:
    mesh._kept.append(obj)  # nothing else on this rank holds it
    obj.start()


class _Follower:
    def __init__(self, mesh):
        self.mesh = mesh
        self.closed: dict = {}
        self.done = threading.Event()
        self.error: BaseException = None
        self.thread = None

    def closed_event(self, target: int) -> threading.Event:
        return self.closed.setdefault(target, threading.Event())

    def run(self) -> None:
        mesh = self.mesh
        try:
            while True:
                msg = _bcast(mesh)
                if msg == _END:
                    break
                target, method, args, kwargs = msg
                if method == _CLOSE:
                    mesh.drop(target)
                    self.closed_event(target).set()
                    continue
                if method == _REBUILD:
                    _keep_started(mesh, mesh._recipes[target][1]())
                    continue
                if method == _BUILD:
                    _keep_started(mesh, args[0](params=mesh.tree(target), mesh=mesh))
                    continue
                obj = mesh.target(target)
                getattr(obj, method)(*_to_device(args, mesh.device),
                                     **_to_device(kwargs, mesh.device))
        except BaseException as exc:  # noqa: BLE001 — handed to the waiters
            self.error = exc
            raise
        finally:
            self.done.set()
            for ev in list(self.closed.values()):
                ev.set()


def _follower(mesh) -> _Follower:
    if mesh._follower is None:
        mesh._follower = _Follower(mesh)
    return mesh._follower


def ensure_following(mesh) -> None:
    """A follower rank: start this process's follow loop in a thread
    unless it runs already."""
    f = _follower(mesh)
    if f.thread is None:
        f.thread = threading.Thread(target=f.run, name="lsot-mesh-follower",
                                    daemon=True)
        f.thread.start()


def follow(mesh) -> None:
    """A follower rank: run the follow loop in this thread (or wait for the
    running one) until rank 0 closes the channel; re-raise its failure."""
    f = _follower(mesh)
    if f.thread is None:
        f.thread = threading.current_thread()
        f.run()
    else:
        f.done.wait()
    if f.error is not None:
        raise f.error


def wait_closed(mesh, target: int) -> None:
    """A follower rank: wait until rank 0 has shut object `target` down."""
    f = _follower(mesh)
    f.closed_event(target).wait()
    if f.error is not None:
        raise RuntimeError("the mesh's follow loop failed") from f.error


def drive(mesh) -> None:
    """Rank 0: from now on engines post their calls too (the entry points
    turn this on once the followers run `follow`)."""
    mesh.driving = True


def close(mesh) -> None:
    """End the step channel: rank 0 posts the end, the followers' loops
    return. Every rank calls it once, after its last driven step; on a
    follower it re-raises the loop's failure."""
    if mesh is None or mesh.size == 1:
        return
    if mesh.is_primary:
        with mesh.lock:
            _bcast(mesh, _END)
        mesh.driving = False
    else:
        f = _follower(mesh)
        if f.thread is None:
            follow(mesh)
        elif f.thread is not threading.current_thread():
            f.done.wait()
            if f.error is not None:
                raise RuntimeError("the mesh's follow loop failed") from f.error

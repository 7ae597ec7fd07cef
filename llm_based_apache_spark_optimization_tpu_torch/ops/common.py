"""Shared numerical constants, and the collectives of a sharded forward.

The JAX package's `ops/common.py` shims `shard_map` and `axis_size`: inside
a `shard_map` body, code sees its per-device block and names mesh axes for
its collectives. The port is SPMD already (each rank holds its own block,
parallel/mesh.py), so its counterparts are the collectives themselves,
named by mesh axis: `all_reduce`, `all_gather` along a tensor dim,
`broadcast` from an axis's first rank, `ring_shift` (ring attention's
rotation) and the axis's size and index.
Each is the identity on an axis of size 1 or without a mesh.

On a gloo mesh over CUDA tensors (two ranks on one card: `Mesh.staged`)
each collective copies its tensors to host memory, runs there, and copies
the result back: gloo has no point-to-point for CUDA tensors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

# Large-negative instead of -inf for masking: keeps softmax NaN-free on
# fully-masked rows and is representable in f32. Shared by attention masking
# and sampler logit masking so the semantics cannot diverge.
NEG_INF = -1e30


def axis_size(mesh, axis: str) -> int:
    """Size of mesh axis `axis` (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape[axis]


def axis_index(mesh, axis: str) -> int:
    """This rank's index along `axis` (0 without a mesh)."""
    return 0 if mesh is None else mesh.coords[axis]


def _host(x: torch.Tensor, mesh) -> torch.Tensor:
    return x.detach().to("cpu") if mesh.staged else x


def all_reduce(x: torch.Tensor, mesh, axis: str = "tp", op: str = "sum") -> torch.Tensor:
    """The sum (or max) of `x` over the ranks of `axis`, on every one of
    them; a new tensor."""
    if axis_size(mesh, axis) == 1:
        return x
    import torch.distributed as dist

    buf = _host(x, mesh).contiguous().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=mesh.group(axis))
    return buf.to(x.device)


def all_gather(x: torch.Tensor, mesh, axis: str = "tp", dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of `axis` concatenated along `dim`, in axis order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    import torch.distributed as dist

    buf = _host(x, mesh).contiguous()
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=mesh.group(axis))
    return torch.cat(parts, dim=dim).to(x.device)


def ring_shift(tensors: Sequence[torch.Tensor], mesh, axis: str = "sp"
               ) -> List[torch.Tensor]:
    """Send each tensor to the next rank of `axis` and receive the previous
    rank's (ring attention's rotation: what rank i held, rank i + 1 holds
    after the call). Every rank of the axis must call it, every step."""
    n = axis_size(mesh, axis)
    if n == 1:
        return list(tensors)
    import torch.distributed as dist

    ranks = mesh.axis_ranks(axis)
    me = mesh.coords[axis]
    nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
    group = mesh.group(axis)
    ops, outs = [], []
    for x in tensors:
        buf = _host(x, mesh).contiguous()
        out = torch.empty_like(buf)
        ops.append(dist.P2POp(dist.isend, buf, nxt, group=group))
        ops.append(dist.P2POp(dist.irecv, out, prv, group=group))
        outs.append(out)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [o.to(x.device) for o, x in zip(outs, tensors)]


def broadcast(x: Optional[torch.Tensor], mesh, axis: str = "tp", *,
              like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The first rank of `axis`'s tensor `x` on every rank of the axis; the
    other ranks pass `like`, a tensor of its shape and dtype to receive
    into. On a staged mesh the result stays in host memory."""
    if axis_size(mesh, axis) == 1:
        return x
    import torch.distributed as dist

    buf = _host(x if mesh.coords[axis] == 0 else like, mesh).contiguous()
    dist.broadcast(buf, src=mesh.axis_ranks(axis)[0], group=mesh.group(axis))
    return buf


def broadcast_object(obj, mesh, src: int = 0) -> Optional[object]:
    """`obj` from the mesh's rank `src` on every rank, over the control
    group."""
    if mesh is None or mesh.size == 1:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=mesh.ranks[src], group=mesh.control)
    return box[0]


def all_gather_object(obj, mesh) -> list:
    """Every rank's `obj`, in global rank order, over the control group."""
    if mesh is None or mesh.size == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.control)
    return out

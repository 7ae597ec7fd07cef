"""Sharding rules: how the Llama params tree, KV caches and batches split.

Counterpart of the JAX package's `parallel/sharding.py`, with the same
placements (Megatron tensor parallelism over "tp"):

  wq/wk/wv [L, D, heads*H]  column-parallel  -> shard the last dim
  wo       [L, N*H, D]      row-parallel     -> shard the contracted dim
  wg/wu    [L, D, F]        column-parallel  -> shard the last dim
  wd       [L, F, D]        row-parallel     -> shard the contracted dim
  norms                     replicated
  embed / lm_head           vocab-sharded over tp

In JAX a spec places a global array and GSPMD inserts the collectives. In
the port a spec says which block of the global tensor each rank keeps
(`shard_params` returns this rank's local tree), and the forward runs the
collectives itself (ops/common.py): an all-reduce after each row-parallel
product and after the vocab-sharded embedding lookup, an all-gather of the
vocab-sharded logits before sampling.

Specs are tuples of axis names or None, one per tensor dim, as JAX's
PartitionSpec (`P`). Only "tp" appears in a params spec; caches add "dp"
(batch rows) and "sp" (cache slots), and each rank allocates its own block
(`mesh.Mesh.local_cfg`, engine/generate.py).

Constraint: num_heads, num_kv_heads and the vocabulary divide by tp
(`validate_tp`, `shard_params`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.configs import LlamaConfig
from .mesh import Mesh

Pytree = Any


class P(tuple):
    """A partition spec: one mesh axis name (or None) per tensor dim."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def validate_tp(cfg: LlamaConfig, tp: int) -> None:
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_heads={cfg.num_heads} and "
            f"num_kv_heads={cfg.num_kv_heads} ({cfg.name})"
        )


def param_specs(cfg: LlamaConfig, quantized: bool = False,
                q_unembed: bool = False) -> Dict[str, Any]:
    """Spec tree matching models.llama.init_params exactly (JAX's
    `param_specs`). With `quantized=True` the seven matmul weights are q8
    trees: q8 shards as the weight, the per-out-channel scale keeps the out
    axis (over tp for column-parallel weights, replicated for row-parallel
    ones, whose scale multiplies the sum). `q_unembed` gives the int8
    tables' {"q8", "s"} specs. Unfused trees only; `specs_for_params`
    derives specs from an actual tree (int4 and fused layouts too), and the
    two agree wherever both apply."""
    def w(spec: P) -> Any:
        return {"q8": spec, "s": P(spec[0], spec[2])} if quantized else spec

    def table() -> Any:
        return ({"q8": P("tp", None), "s": P("tp")} if q_unembed
                else P("tp", None))

    specs: Dict[str, Any] = {
        "embed": table(),
        "blocks": {
            "wq": w(P(None, None, "tp")),
            "wk": w(P(None, None, "tp")),
            "wv": w(P(None, None, "tp")),
            "wo": w(P(None, "tp", None)),
            "wg": w(P(None, None, "tp")),
            "wu": w(P(None, None, "tp")),
            "wd": w(P(None, "tp", None)),
            "ln_attn": P(None, None),
            "ln_mlp": P(None, None),
        },
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = table()
    return specs


# Row-parallel block weights shard their contraction axis; every other
# matmul weight named here is column-parallel (out axis over tp).
_ROW_PARALLEL = ("wo", "wd")


def specs_for_params(params: Pytree, tp: int = 1) -> Pytree:
    """Spec tree derived leaf by leaf from an actual params tree: bf16, q8
    and q4 weights, fused ([L, D, C, O]) and unfused layouts (JAX's
    `specs_for_params`, the same rules):
    - column-parallel weights shard the out (last) axis; their scales shard
      with it;
    - row-parallel weights (wo/wd) shard the contraction axis; int8 scales
      replicate (they multiply the summed product), int4 group scales shard
      with their groups (applied inside the kernel, before the all-reduce);
    - stacked fused weights are column-parallel: out axis over tp, the C
      axis replicated;
    - embed/lm_head shard the vocab axis (int8 tables with their row
      scales); norms replicate.
    `tp` is used for the int4 row-parallel check: a shard must hold whole
    quant groups."""
    from ..ops.quant import is_q4tensor, is_qtensor

    def wspec(name: str, w: Any) -> Any:
        row = name in _ROW_PARALLEL
        if is_qtensor(w):
            if w["q8"].ndim == 4:  # stacked fused [L, D, C, O]
                return {"q8": P(None, None, None, "tp"),
                        "s": P(None, None, "tp")}
            return ({"q8": P(None, "tp", None), "s": P(None, None)} if row
                    else {"q8": P(None, None, "tp"), "s": P(None, "tp")})
        if is_q4tensor(w):
            if w["q4"].ndim == 4:  # stacked fused [L, D/2, C, O]
                return {"q4": P(None, None, None, "tp"),
                        "s4": P(None, None, None, "tp")}
            if row:
                n_groups = w["s4"].shape[-2]
                if n_groups % tp:
                    raise ValueError(
                        f"int4 {name}: tp={tp} does not divide the "
                        f"{n_groups} quant groups — a tensor-parallel "
                        f"shard would split a group (requantize with "
                        f"ops.quant.tp_safe_group)"
                    )
                return {"q4": P(None, "tp", None), "s4": P(None, "tp", None)}
            return {"q4": P(None, None, "tp"), "s4": P(None, None, "tp")}
        if w.ndim == 4:  # stacked fused [L, D, C, O]
            return P(None, None, None, "tp")
        return P(None, "tp", None) if row else P(None, None, "tp")

    def table(t: Any) -> Any:
        return {"q8": P("tp", None), "s": P("tp")} if is_qtensor(t) \
            else P("tp", None)

    specs: Dict[str, Any] = {
        "embed": table(params["embed"]),
        "blocks": {
            k: (P(None, None) if k.startswith("ln_") else wspec(k, v))
            for k, v in params["blocks"].items()
        },
        "final_norm": P(None),
    }
    if "lm_head" in params:
        specs["lm_head"] = table(params["lm_head"])
    return specs


def tree_map(fn, tree: Pytree, specs: Pytree) -> Pytree:
    """`fn(leaf, spec)` over a params tree and its spec tree."""
    if isinstance(specs, P):
        return fn(tree, specs)
    return {k: tree_map(fn, tree[k], specs[k]) for k in tree}


def leaf_spec(name: str) -> P:
    """The spec of an unquantized leaf by its name in the params tree (a
    block weight's key, "embed", "lm_head" or "final_norm"): what the
    checkpoint loaders place each tensor by, as it is read."""
    if name in ("embed", "lm_head"):
        return P("tp", None)
    if name == "final_norm" or name.startswith("ln_"):
        return P(None) if name == "final_norm" else P(None, None)
    return P(None, "tp", None) if name in _ROW_PARALLEL else P(None, None, "tp")


def block(x: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the global tensor `x` under `spec`, a view of
    `x` where it lies: each named axis split into equal parts, the part at
    this rank's index along that axis."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {axis}={n}")
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.coords[axis] * step, step)
    return x


def shard_tensor(x: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's block of `x` under `spec` (`block`), on the mesh's
    device."""
    return block(x, spec, mesh).to(mesh.device).contiguous()


def is_local(params: Pytree, cfg: LlamaConfig, mesh: Mesh) -> bool:
    """True when `params` already holds this rank's blocks (its embedding
    table has vocab/tp rows rather than the whole vocabulary)."""
    emb = params["embed"]
    rows = (emb["q8"] if isinstance(emb, dict) else emb).shape[0]
    return mesh.shape["tp"] > 1 and rows == cfg.vocab_size // mesh.shape["tp"]


def shard_params(params: Pytree, cfg: LlamaConfig, mesh: Mesh) -> Pytree:
    """This rank's local tree of a whole (host or single-device) params
    tree, on the mesh's device. Specs come from the tree itself
    (`specs_for_params`), so every layout shards: bf16, q8, q4, fused. A
    tree that is already local (loaded straight to the mesh) is returned
    as it is. The local tree is placed on the mesh (`Mesh.place`): every
    rank that shards the same trees in the same order gives each the same
    index, which names it when rank 0 builds a scheduler from it while the
    others follow."""
    local = _shard_params(params, cfg, mesh)
    mesh.place(local)
    return local


def _shard_params(params: Pytree, cfg: LlamaConfig, mesh: Mesh) -> Pytree:
    tp = mesh.shape["tp"]
    validate_tp(cfg, tp)
    if cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab_size={cfg.vocab_size} "
                         f"({cfg.name}): embed and unembed shard the vocabulary")
    if is_local(params, cfg, mesh):
        return tree_map(lambda x, s: x.to(mesh.device), params,
                        specs_for_params(params, tp=1))
    specs = specs_for_params(params, tp=tp)
    return tree_map(lambda x, s: shard_tensor(x, s, mesh), params, specs)


def cache_spec() -> P:
    """[L, B, K, S, H]: batch over dp, KV heads over tp, slots over sp.
    Each rank allocates its own block: the engine's contiguous cache holds
    this rank's dp rows, its tp-th of the KV heads and its sp-th of the
    slots, so an sp-way mesh holds sp times the context of one rank. Decode
    attention over slots sharded on sp combines partial softmaxes across
    the sp ranks (ops/ring_attention.sp_cache_attention)."""
    return P(None, "dp", "tp", "sp", None)


def batch_spec(ndim: int = 2) -> P:
    """[B, ...] batches: rows over dp, the other dims replicated."""
    return P("dp", *([None] * (ndim - 1)))


def paged_pool_spec(ndim: int = 5) -> P:
    """Pool arrays [L, P, K, PS(, H)]: KV heads over tp, every other axis
    replicated (page tables hold global page ids and any slot may map any
    page). Per-position scales (int8 pool, ndim 4) keep heads over tp."""
    return (P(None, None, "tp", None, None) if ndim == 5
            else P(None, None, "tp", None))


def shard_batch(tokens: Pytree, mesh: Mesh) -> Pytree:
    """This rank's dp rows of [B, ...] host arrays (a tensor, or a tuple or
    list of them), on its device. B must divide by dp (the engine pads)."""
    if isinstance(tokens, (tuple, list)):
        return type(tokens)(shard_batch(t, mesh) for t in tokens)
    return shard_tensor(torch.as_tensor(tokens), batch_spec(tokens.ndim), mesh)


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole [B, ...] batch from each dp rank's rows, on every rank."""
    from ..ops.common import all_gather

    return all_gather(x, mesh, "dp", dim=0)


def constrain_cache(cache: Pytree, mesh: Mesh) -> Pytree:
    """JAX pins the in-program cache layout here. Each rank of the port
    allocates only its own block, so there is nothing to move: this checks
    that every cache tensor lies on the mesh's device and returns the
    cache."""
    for name, x in cache.items():
        if x.device.type != mesh.device.type:
            raise ValueError(f"cache tensor {name!r} is on {x.device}, the "
                             f"mesh rank on {mesh.device}")
    return cache

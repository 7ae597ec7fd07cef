"""Llama-family transformer: parameters as a plain dict of tensors and one
`forward` for prefill and decode.

Counterpart of the JAX package's `models/llama.py`, with the same params
tree: per-layer weights stacked on a leading [L, ...] axis, matmul weights
in `[in, out]` layout (`x @ w`), `embed` [V, D], `final_norm` [D] and, for
untied models, `lm_head` [V, D]. `convert.params_from_jax` maps one tree
onto the other.

- Matmuls run in the params dtype (bf16 on the card); norms, rope, softmax
  and the SiLU gate run in f32; logits come back in f32.
- Every block matmul goes through `ops.quant.mm`: a plain `@` for a weight
  tensor, the int8 matmul kernel for an int8 tree {"q8", "s"}
  (`quantize_params`, `init_params_quantized`), the int4 matmul kernel for
  a 4-bit tree {"q4", "s4"} (`quantize_params_int4`); the params dtype is
  then that of the norms and embeddings.
- Fused trees (`fuse_blocks`, the engines' `fuse_matmuls=True`) stack
  projections that share an input on a new axis -2: "wqkv" [L, D, 3, O]
  for MHA, "wkv" [L, D, 2, KO] beside its own "wq" for GQA, and "wgu"
  [L, D, 2, F] always, in bf16, q8 or q4; `ops.quant.mm_stacked` runs each
  as one matmul over its contiguous (C, O) tail, every forward branch below
  included. Each output column is the same dot product as unfused.
- The unembed accumulates in f32: for bf16 on CUDA it is one bf16 matmul
  with an f32 output (`torch.mm(..., out_dtype=torch.float32)`), elsewhere
  `x.float() @ w.float().T`. An int8 table {"q8": [V, D], "s": [V]}
  (`ops.quant.quantize_unembed`) unembeds through the int8 matmul kernel's
  [V, D] layout (f32 logits, the scale after the sum) and embeds by
  dequantizing only the looked-up rows into `final_norm`'s dtype.
- The KV cache is `{"k", "v"}: [L, B, K, S, H]`, updated in place: each
  layer writes its fresh [B, T, K, H] sliver at per-row offsets of its own
  layer, and attention reads that layer's [B, K, S, H] view. Nothing
  rebuilds the cache.
- Or the paged cache `{"kp", "vp": [L, P, K, PS, H], "ptab": [B, NP]}`
  (engine/paged_kv.py), for T <= `_UNROLL_MAX_T` (decode steps and small
  windows): each layer first writes its sliver through the page table, in
  place (the fused page-write kernel), then attends through the table (the
  ragged paged attention kernel).
- Or the int8 caches. The contiguous `{"k8", "v8": [L, B, K, S, H] int8,
  "ks", "vs": [L, B, K, S] f32}` (`ops.quant.quantize_cache`) serves decode
  steps (T == 1) and windows of T <= `_UNROLL_MAX_T` (speculative verify
  rounds): each layer quantizes its fresh sliver (one scale per slot,
  absmax over H), writes values and scales in place, then attends through
  the quantized flash kernel at T == 1, which dequantizes in its tile, and
  at T > 1 through the quantized ragged paged attention kernel over the
  layer viewed as a pool of one page a row (P = B pages of S slots, row b
  mapping page b). The
  paged pool with scales `{"kp", "vp": int8, "kps", "vps": [L, P, K, PS]
  f32, "ptab"}` writes through the quantizing page-write kernel and reads
  through the quantized ragged paged attention kernel.
- `rows` runs a contiguous cache (bf16/f32 or int8) over a subset of its
  batch rows, one layer at a time: the scheduler's chunked prefill. Layer
  l gathers the rows' cache over [0, `span`) (an int8 cache dequantized to
  the compute dtype: values and scales cast to it, then multiplied in it),
  writes the chunk's K/V into that view, attends over it through the
  flash kernel, and writes only the chunk's window back into the cache
  (int8: quantized once, there). No all-layer view is built: at 7B, 8 rows
  of 4096 slots take 268 MiB a layer for K and again for V.
- `span` with a paged cache is the scheduler's paged prefill chunk, any T:
  `ptab` holds the chunk rows' table rows [k, NP], and layer l gathers
  each row's first ceil(`span` / PS) pages through it into a contiguous
  view [k, K, pages x PS, H] (an int8 pool dequantized the same way),
  writes the chunk's K/V into the view, attends over it through the flash
  kernel, and writes the chunk window back into the pool through the page
  write kernel (int8: the quantizing one), every column of the window
  that lands on a mapped page, as the JAX scheduler's scatter does. One
  layer's view at a time: 256 MiB for K and again for V at 7B, 8 rows of
  4096 slots, where a view of all layers took 8 GiB each.
- Attention, page writes and int4 matmuls go through
  `ops.kernels.dispatch`: the hand-written kernels on CUDA, their plain
  versions on the CPU.
- Under a mesh (`parallel/`) `params` and the caches are this rank's
  blocks (`parallel.sharding.shard_params`, `Mesh.local_cfg`): a tp-th of
  the heads, KV heads, MLP hidden axis and vocabulary. The forward runs the
  collectives GSPMD inserts in JAX: an all-reduce over tp after `wo` and
  `wd` (row-parallel, `ops.quant.mm(..., "row")`) and after the embedding
  lookup (each rank gathers only its vocabulary rows), and an all-gather of
  the vocab-sharded logits, so every rank returns the whole [B, T, V].
  Attention reads through the `sharded_*` kernel wrappers on the rank's
  heads. Under sp > 1 a cache is one of two kinds, and its type says which
  (`SpSlotCache`, never its shape):
  - the engine's contiguous cache, an `SpSlotCache`, holds this rank's
    sp-th of the slots (JAX's `cache_spec`): `attn_impl="ring"` prefills
    through ring attention over the call's fresh K/V (from position 0, as
    JAX's ring branch), later steps read through
    `ops.ring_attention.sp_cache_attention`, and each rank writes only the
    positions its slots hold;
  - every other cache is whole on each sp rank (JAX's `paged_pool_spec`
    and the scheduler's placement: KV heads over tp, slots and pages
    replicated): the scheduler's contiguous cache with `rows`, any paged
    pool. Those take the tp path above on every sp rank, whose ranks
    compute the same step as replicas.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.kernels.dispatch import (
    attention,
    attention_quantized,
    int8_mm,
    page_write,
    page_write_quantized,
    paged_attention,
    paged_attention_quantized,
)
from ..ops.common import all_gather, all_reduce, axis_index, axis_size
from ..ops.kernels.attention import (
    sharded_flash_gqa_attention,
    sharded_flash_gqa_attention_quantized,
)
from ..ops.kernels.paged_attention import (
    sharded_ragged_paged_attention,
    sharded_ragged_paged_attention_quantized,
)
from ..ops.norm import rms_norm
from ..ops.quant import is_q4tensor, is_qtensor, mm, mm_stacked, quantize_kv
from ..ops.ring_attention import ring_gqa_attention, sp_cache_attention
from ..ops.rope import apply_rope, rope_cos_sin
from .configs import LlamaConfig

Params = Dict[str, object]

# Paged forwards serve windows of at most this many tokens (decode steps,
# verify windows, mixed rounds); longer prefill runs a contiguous cache and
# packs its K/V into pool pages (engine/generate.py), or the paged chunk
# over one layer's gathered view at a time (`span`, serve/scheduler.py).
# The JAX package's unrolled small-T bound.
_UNROLL_MAX_T = 32


def init_params(
    cfg: LlamaConfig,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    mesh=None,
) -> Params:
    """Random weights made on `device` (default CUDA) from `generator`
    (default: seed 0 on that device), scaled 1/sqrt(fan_in) so random models
    give finite logits at any depth. Norm weights are ones. Under a `mesh`
    (on the mesh rank's device) each weight is made whole, one at a time,
    and only this rank's block is kept: the tree `shard_params` gives of
    the whole one, without ever holding the whole tree."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, f = cfg.hidden_size, cfg.intermediate_size
    nh, kh, hd, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers

    def w(shape, fan_in, name):
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        x = x.mul_(fan_in ** -0.5).to(dtype)
        if mesh is None:
            return x
        from ..parallel.sharding import leaf_spec, shard_tensor

        return shard_tensor(x, leaf_spec(name), mesh)

    params: Params = {
        "embed": w((cfg.vocab_size, d), d, "embed"),
        "blocks": {
            "wq": w((L, d, nh * hd), d, "wq"),
            "wk": w((L, d, kh * hd), d, "wk"),
            "wv": w((L, d, kh * hd), d, "wv"),
            "wo": w((L, nh * hd, d), nh * hd, "wo"),
            "wg": w((L, d, f), d, "wg"),
            "wu": w((L, d, f), d, "wu"),
            "wd": w((L, f, d), f, "wd"),
            "ln_attn": torch.ones((L, d), dtype=dtype, device=dev),
            "ln_mlp": torch.ones((L, d), dtype=dtype, device=dev),
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = w((cfg.vocab_size, d), d, "lm_head")
    return params


def fuse_blocks(params: Params) -> Params:
    """A params variant with the projections that share an input fused:
    wq|wk|wv -> "wqkv" for MHA (equal out dims), wk|wv -> "wkv" for GQA
    (wq, wider, stays its own matmul), and wg|wu -> "wgu". Each fused weight
    stacks its projections on a new axis -2, [L, D, C, O], as the JAX
    package's does: a bf16 tensor, a q8 tree (s [L, C, O]) or a q4 tree (q4
    [L, D/2, C, O], s4 [L, G, C, O]). One wider matmul replaces two or
    three; the tree takes new memory for the stacked copies, so drop the
    unfused tree once it is fused."""
    blocks = dict(params["blocks"])

    def out_dim(w):
        if is_qtensor(w):
            return w["q8"].shape[-1]
        if is_q4tensor(w):
            return w["q4"].shape[-1]
        return w.shape[-1]

    def stack(names):
        ws = [blocks.pop(n) for n in names]
        if isinstance(ws[0], dict):
            return {k: torch.stack([w[k] for w in ws], dim=-2) for k in ws[0]}
        return torch.stack(ws, dim=-2)

    if out_dim(blocks["wq"]) == out_dim(blocks["wk"]):  # MHA: one 3-stack
        blocks["wqkv"] = stack(("wq", "wk", "wv"))
    else:  # GQA: K and V share a shape, Q stays its own matmul
        blocks["wkv"] = stack(("wk", "wv"))
    blocks["wgu"] = stack(("wg", "wu"))
    out = dict(params)
    out["blocks"] = blocks
    return out


class SpSlotCache(dict):
    """A contiguous cache ({"k", "v"} or int8 {"k8", "v8", "ks", "vs"})
    whose slots are split over the mesh's sp axis: sp rank r holds global
    slots [r * S_loc, (r + 1) * S_loc) (the engine's cache under sp,
    `parallel.sharding.cache_spec`). `forward` takes the ring and
    `sp_cache_attention` for it and the tp path for any other cache, and
    raises where the two meet (a split cache with `rows` or a page pool, a
    ring prefill into a whole cache)."""


def _write_cache(layer_cache: torch.Tensor, new: torch.Tensor,
                 start: torch.Tensor) -> None:
    """Write `new` [B, T, K, H] into `layer_cache` [B, K, S, H] (a view of
    one layer of the stacked cache) at slots start[b] + t, in place; the
    same for per-slot scales [B, T, K] into [B, K, S]. A start past S - T
    is clamped to it, as JAX's dynamic_update_slice clamps: a parked row's
    verify window at the parking position lands in its own row's tail,
    which no live query reads before rewriting it."""
    b, t = new.shape[:2]
    rows = torch.arange(b, device=new.device)[:, None]
    start = start.long().clamp(0, layer_cache.shape[2] - t)
    slots = start[:, None] + torch.arange(t, device=new.device)[None, :]
    layer_cache[rows, :, slots] = new.to(layer_cache.dtype)


def _row_view(cache: Dict[str, torch.Tensor], name: str, layer: int,
              rows: torch.Tensor, span: int, dtype: torch.dtype) -> torch.Tensor:
    """Layer `layer` of K or V (`name`) for cache rows `rows` over [0, span):
    [k, K, span, H] in `dtype`, a fresh tensor (an int8 cache dequantized)."""
    if f"{name}8" in cache:
        q8 = cache[f"{name}8"][layer][rows, :, :span]
        sc = cache[f"{name}s"][layer][rows, :, :span]
        return q8.to(dtype) * sc[..., None].to(dtype)
    return cache[name][layer][rows, :, :span].to(dtype)


def _write_rows(cache: Dict[str, torch.Tensor], name: str, layer: int,
                rows: torch.Tensor, positions: torch.Tensor,
                new: torch.Tensor) -> None:
    """Write the chunk's K or V window `new` [k, T, K, H] into cache rows
    `rows` at `positions` [k, T] of layer `layer`; an int8 cache quantizes
    it there (one scale per slot)."""
    idx = (rows[:, None], slice(None), positions.long())
    if f"{name}8" in cache:
        qn = quantize_kv(new)
        cache[f"{name}8"][layer][idx] = qn["q8"]
        cache[f"{name}s"][layer][idx] = qn["s"]
    else:
        cache[name][layer][idx] = new.to(cache[name].dtype)


def _page_view(cache: Dict[str, torch.Tensor], name: str, layer: int,
               n_pages: int, dtype: torch.dtype) -> torch.Tensor:
    """Layer `layer` of K or V (`name`) for the paged chunk's rows over
    their first `n_pages` logical pages, gathered through `cache["ptab"]`
    [k, NP]: [k, K, n_pages x PS, H] in `dtype`, a fresh tensor (an int8
    pool dequantized: values and scales cast to `dtype`, then multiplied in
    it, as the JAX scheduler does). Sentinel entries, and pages past the
    table, clip to a real page whose content sits where the causal mask
    hides it."""
    pool = cache[f"{name}p"][layer]  # [P, K, PS(, H)]
    num_pages, kh, ps = pool.shape[:3]
    tab = cache["ptab"].long()[:, :n_pages]
    if n_pages > tab.shape[1]:
        tab = F.pad(tab, (0, n_pages - tab.shape[1]), value=num_pages - 1)
    safe = tab.clamp(0, num_pages - 1)

    def view(p):  # [P, K, PS(, H)] -> [k, K, n_pages x PS(, H)]
        g = p[safe]
        perm = (0, 2, 1, 3, 4) if p.dim() == 4 else (0, 2, 1, 3)
        return g.permute(*perm).reshape(safe.shape[0], kh, n_pages * ps,
                                        *p.shape[3:])

    if f"{name}ps" in cache:
        scales = cache[f"{name}ps"][layer]
        return view(pool).to(dtype) * view(scales)[..., None].to(dtype)
    return view(pool).to(dtype)


def _at(w, layer: int):
    """Layer `layer` of a stacked weight: a tensor, or a q8 or q4 tree's
    arrays."""
    return {k: v[layer] for k, v in w.items()} if isinstance(w, dict) else w[layer]


def _write_sp(layer_cache: torch.Tensor, new: torch.Tensor,
              positions: torch.Tensor, base: int) -> None:
    """Write `new` [B, T, K(, H)] at global `positions` [B, T] into this sp
    rank's block of slots [base, base + S_loc) of `layer_cache` [B, K,
    S_loc(, H)]; positions another rank holds are left to it."""
    local = positions.long() - base
    own = (local >= 0) & (local < layer_cache.shape[2])
    rows, cols = own.nonzero(as_tuple=True)
    layer_cache[rows, :, local[rows, cols]] = new[rows, cols].to(layer_cache.dtype)


def _embed(params: Params, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """[B, T] token ids -> [B, T, D]: the table's rows; an int8 table's
    rows dequantized in f32 (value x the row's scale), then cast to
    `final_norm`'s dtype. A vocab-sharded table (tp > 1): each rank looks
    up the ids its rows hold, zeros elsewhere, and the all-reduce over tp
    adds the one nonzero row of each id."""
    emb = params["embed"]
    idx = tokens.long()
    tp = axis_size(mesh, "tp")
    if tp > 1:
        v_loc = (emb["q8"] if is_qtensor(emb) else emb).shape[0]
        idx = idx - axis_index(mesh, "tp") * v_loc
        own = (idx >= 0) & (idx < v_loc)
        idx = idx.clamp(0, v_loc - 1)
    if is_qtensor(emb):
        rows = emb["q8"][idx].float() * emb["s"][idx][..., None]
        rows = rows.to(params["final_norm"].dtype)
    else:
        rows = emb[idx]
    if tp > 1:
        rows = all_reduce(rows * own[..., None].to(rows.dtype), mesh, "tp")
    return rows


def _unembed(x: torch.Tensor, w, mesh=None) -> torch.Tensor:
    """[B, T, D] x [V, D] -> [B, T, V] f32 logits, accumulated in f32; an
    int8 table through the int8 matmul kernel's [V, D] layout. A
    vocab-sharded table gives this rank's [B, T, V/tp] block, all-gathered
    over tp into the whole logits."""
    logits = _unembed_local(x, w)
    return all_gather(logits, mesh, "tp", dim=-1)


def _unembed_local(x: torch.Tensor, w) -> torch.Tensor:
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    if is_qtensor(w):
        logits = int8_mm(x2, w["q8"], w["s"], "vd")
    elif x.is_cuda and x.dtype == torch.bfloat16:
        logits = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        logits = x2.float() @ w.float().t()
    return logits.reshape(b, t, -1)


def forward(
    cfg: LlamaConfig,
    params: Params,
    tokens: torch.Tensor,     # [B, T] int
    positions: torch.Tensor,  # [B, T] int — absolute position of each token
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"k","v"}: [L, B, K, S, H]
                              # or int8 {"k8","v8","ks","vs"}, or paged
                              # {"kp","vp": [L, P, K, PS, H], "ptab": [B, NP]
                              # int} (int8 pool: plus "kps","vps")
    logit_indices: Optional[torch.Tensor] = None,     # [B] int
    kv_lens: Optional[torch.Tensor] = None,           # [B] int — live KV slots
    q_lens: Optional[torch.Tensor] = None,            # [B] int — live query
                                                      # cols (paged windows)
    rows: Optional[torch.Tensor] = None,              # [B] int — cache rows
    span: Optional[int] = None,                       # cache slots rows read
                                                      # (paged: positions the
                                                      # chunk's views cover)
    mesh=None,                                        # parallel.Mesh: params
                                                      # and cache are this
                                                      # rank's blocks
    attn_impl: Optional[str] = None,                  # "ring": sp prefill
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Run T tokens through the stack; returns (logits f32, cache).

    With `cache=None` the layer's own K/V are the keys (prefill-only
    scoring). With a cache, K/V are written at `positions[:, 0] + t` and
    attention reads the layer's whole cache, masked by position (an int8
    cache: T <= `_UNROLL_MAX_T`). With a paged cache, K/V are written at `positions`
    through the page table (dead columns past `q_lens` write nothing and
    read zeros), then attention reads through it. `logit_indices` unembeds
    only those T-indices ([B, 1, V] logits). With `rows`, token row i runs
    over contiguous cache row rows[i], reading slots [0, span) (default:
    the whole cache), one layer at a time; an int8 cache then serves any T.
    With a paged cache and `span`, row i is the chunk of the slot whose
    table row is ptab[i], over views of positions [0, span) (span at least
    the chunk's last position + 1), one layer at a time; any T.

    Under a `mesh` (module docstring) every rank of a tp/sp group calls the
    forward with the same tokens and gets the same logits. An
    `SpSlotCache` (sp > 1) has its slots split over sp: `attn_impl="ring"`
    is the prefill from position 0 through ring attention; without it the
    call reads the split slots (`sp_cache_attention`). Any other cache is
    whole on each sp rank and takes the tp path, `rows` and paged caches
    included."""
    b, t = tokens.shape
    tp, sp = axis_size(mesh, "tp"), axis_size(mesh, "sp")
    sharded = mesh is not None and mesh.size > 1
    if attn_impl not in (None, "ring"):
        raise ValueError(f"attn_impl must be None or 'ring', got {attn_impl!r}")
    if attn_impl == "ring" and sp == 1:
        raise ValueError('attn_impl="ring" requires a mesh with an "sp" axis > 1')
    split = isinstance(cache, SpSlotCache)
    if split and sp == 1:
        raise ValueError("an SpSlotCache splits its slots over sp: it needs a "
                         "mesh with an \"sp\" axis > 1")
    if split and ("kp" in cache or rows is not None):
        raise ValueError("a cache split over sp is the engine's contiguous "
                         "cache: rows and page pools run on caches whole on "
                         "each sp rank")
    if attn_impl == "ring" and cache is not None and not split:
        raise ValueError('attn_impl="ring" prefills a cache split over sp '
                         "(an SpSlotCache); this cache is whole on each rank")
    paged = cache is not None and "kp" in cache
    quant = cache is not None and "k8" in cache
    chunk = paged and span is not None
    if rows is not None:
        if cache is None or paged:
            raise ValueError("rows runs over a contiguous cache")
        s_cache = cache["k8" if quant else "k"].shape[3]
        span = s_cache if span is None else min(span, s_cache)
    elif quant and t > _UNROLL_MAX_T:
        raise ValueError(
            f"an int8 KV cache serves decode steps and windows of T <= "
            f"{_UNROLL_MAX_T} only, got T={t}: prefill fills a compute-dtype "
            "cache, then quantize_cache converts it once (engine/generate.py)")
    if paged and not chunk and t > _UNROLL_MAX_T:
        raise ValueError(
            "a paged KV cache serves the unrolled small-T path only "
            f"(T <= {_UNROLL_MAX_T}; decode, verify windows, and mixed "
            "ragged prefill+decode rounds): longer prefill runs a "
            "contiguous transient cache and packs its K/V into pool pages "
            "(engine/generate.py), or passes `span` for the paged chunk "
            "path (serve/scheduler.py)."
        )
    x = _embed(params, tokens, mesh)  # [B, T, D]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    start = positions[:, 0]
    nh, kh, hd = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim
    if sharded:  # the kernels on this rank's heads (dp rows, tp heads)
        attend = lambda *a: sharded_flash_gqa_attention(mesh, *a)  # noqa: E731
        attend_q = lambda *a: sharded_flash_gqa_attention_quantized(mesh, *a)  # noqa: E731
        attend_paged = lambda *a: sharded_ragged_paged_attention(mesh, *a)  # noqa: E731
        attend_paged_q = lambda *a: sharded_ragged_paged_attention_quantized(mesh, *a)  # noqa: E731
    else:
        attend, attend_q = attention, attention_quantized
        attend_paged, attend_paged_q = paged_attention, paged_attention_quantized
    # The sp path: a split cache, or a ring prefill with no cache.
    sp_path = split or attn_impl == "ring"
    s_base = (axis_index(mesh, "sp") * cache["k8" if quant else "k"].shape[3]
              if split else 0)
    blocks = params["blocks"]
    if chunk:
        chunk_pages = -(-span // cache["kp"].shape[3])
    if quant and rows is None and t > 1:
        # Each layer of the int8 cache is a page pool of one page a row.
        one_page = torch.arange(b, dtype=torch.int32, device=tokens.device)[:, None]

    for l in range(cfg.num_layers):
        h = rms_norm(x, blocks["ln_attn"][l], cfg.norm_eps)
        if "wqkv" in blocks:  # fused MHA: one [D, 3, O] matmul
            fused = mm_stacked(h, _at(blocks["wqkv"], l), mesh)
            q, k, v = (fused[..., i, :] for i in range(3))
        else:
            q = mm(h, _at(blocks["wq"], l), mesh)
            if "wkv" in blocks:  # fused GQA: Q alone, K|V one [D, 2, KO] matmul
                kv = mm_stacked(h, _at(blocks["wkv"], l), mesh)
                k, v = kv[..., 0, :], kv[..., 1, :]
            else:
                k = mm(h, _at(blocks["wk"], l), mesh)
                v = mm(h, _at(blocks["wv"], l), mesh)
        q, k = q.reshape(b, t, nh, hd), k.reshape(b, t, kh, hd)
        v = v.reshape(b, t, kh, hd)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if sp_path:
            attn = _sp_layer(cache, l, q, k, v, positions, base=s_base, mesh=mesh,
                             window=cfg.sliding_window, kv_lens=kv_lens,
                             ring=attn_impl == "ring", quant=quant)
        elif chunk:
            views = []
            for name, new in (("k", k), ("v", v)):
                view = _page_view(cache, name, l, chunk_pages, x.dtype)
                _write_cache(view, new, start)
                views.append(view)
            if "kps" in cache:
                page_write_quantized(cache["kp"], cache["kps"], cache["vp"],
                                     cache["vps"], k, v, positions,
                                     cache["ptab"], l, q_lens)
            else:
                page_write(cache["kp"], cache["vp"], k, v, positions,
                           cache["ptab"], l, q_lens)
            attn = attend(q, views[0], views[1], positions, cfg.sliding_window,
                          kv_lens)
        elif paged and "kps" in cache:
            page_write_quantized(cache["kp"], cache["kps"], cache["vp"],
                                 cache["vps"], k, v, positions, cache["ptab"],
                                 l, q_lens)
            attn = attend_paged_q(
                q, cache["kp"][l], cache["kps"][l], cache["vp"][l],
                cache["vps"][l], cache["ptab"], positions, cfg.sliding_window,
                kv_lens, q_lens)
        elif paged:
            page_write(cache["kp"], cache["vp"], k, v, positions,
                       cache["ptab"], l, q_lens)
            attn = attend_paged(q, cache["kp"][l], cache["vp"][l],
                                cache["ptab"], positions,
                                cfg.sliding_window, kv_lens, q_lens)
        elif rows is not None:
            views = []
            for name, new in (("k", k), ("v", v)):
                view = _row_view(cache, name, l, rows, span, x.dtype)
                _write_cache(view, new, start)
                _write_rows(cache, name, l, rows, positions, new)
                views.append(view)
            attn = attend(q, views[0], views[1], positions, cfg.sliding_window,
                          kv_lens)
        elif quant:
            for name, new in (("k", k), ("v", v)):
                qn = quantize_kv(new)
                _write_cache(cache[f"{name}8"][l], qn["q8"], start)
                _write_cache(cache[f"{name}s"][l], qn["s"], start)
            if t == 1:
                attn = attend_q(q, cache["k8"][l], cache["ks"][l],
                                cache["v8"][l], cache["vs"][l],
                                positions, cfg.sliding_window, kv_lens)
            else:
                # A window (a verify round): the quantized paged attention
                # over the layer as a pool [P = B, K, PS = S, H] whose row b
                # maps its one page b.
                attn = attend_paged_q(
                    q, cache["k8"][l], cache["ks"][l], cache["v8"][l],
                    cache["vs"][l], one_page, positions, cfg.sliding_window,
                    kv_lens)
        else:
            if cache is None:
                k_full = k.transpose(1, 2).contiguous()  # cache layout [B, K, T, H]
                v_full = v.transpose(1, 2).contiguous()
            else:
                k_full, v_full = cache["k"][l], cache["v"][l]
                _write_cache(k_full, k, start)
                _write_cache(v_full, v, start)
            attn = attend(q, k_full, v_full, positions, cfg.sliding_window,
                          kv_lens)
        x = x + mm(attn.reshape(b, t, nh * hd), _at(blocks["wo"], l), mesh, "row")
        h2 = rms_norm(x, blocks["ln_mlp"][l], cfg.norm_eps)
        if "wgu" in blocks:  # fused: gate|up one [D, 2, F] matmul
            gu = mm_stacked(h2, _at(blocks["wgu"], l), mesh)
            g_out, u_out = gu[..., 0, :], gu[..., 1, :]
        else:
            g_out = mm(h2, _at(blocks["wg"], l), mesh)
            u_out = mm(h2, _at(blocks["wu"], l), mesh)
        gate = F.silu(g_out.float()).to(x.dtype)
        x = x + mm(gate * u_out, _at(blocks["wd"], l), mesh, "row")

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logit_indices is not None:
        x = x[torch.arange(b, device=x.device), logit_indices.long()][:, None]
    unembed = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return _unembed(x, unembed, mesh), cache


def _sp_layer(cache, layer: int, q, k, v, positions, *, base: int, mesh,
              window, kv_lens, ring: bool, quant: bool) -> torch.Tensor:
    """One layer's attention with the sequence axis over sp: write the
    fresh K/V (int8: quantized) into this rank's slots of the split cache,
    if any, then attend through the ring (a prefill from position 0, over
    the fresh K/V) or over the split slots (a decode step or window)."""
    if cache is not None:
        if quant:
            for name, new in (("k", k), ("v", v)):
                qn = quantize_kv(new)
                _write_sp(cache[f"{name}8"][layer], qn["q8"], positions, base)
                _write_sp(cache[f"{name}s"][layer], qn["s"], positions, base)
        else:
            _write_sp(cache["k"][layer], k, positions, base)
            _write_sp(cache["v"][layer], v, positions, base)
    if ring:
        return ring_gqa_attention(mesh, q, k, v, positions, sliding_window=window)
    if quant:
        return sp_cache_attention(q, cache["k8"][layer], cache["v8"][layer],
                                  positions, mesh, window, kv_lens,
                                  k_scale=cache["ks"][layer],
                                  v_scale=cache["vs"][layer])
    return sp_cache_attention(q, cache["k"][layer], cache["v"][layer], positions,
                              mesh, window, kv_lens)

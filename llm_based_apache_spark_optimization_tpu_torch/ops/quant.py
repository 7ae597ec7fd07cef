"""Quantized storage: int8 and int4 block weights, int8 embed/unembed
tables and the int8 KV cache.

Counterpart of the JAX package's `ops/quant.py`: the formats the quantized
serving configurations use, the way the reference's users run these models
(Q4/Q8 GGUF blobs with a q8 KV cache).

- int8 weights ("q8" trees): symmetric absmax over the contraction axis,
  one scale per out channel, stored as {"q8": int8 [..., in, out], "s": f32
  [..., out]} (`quantize_weight`, `quantize_params`). The matmul feeds the
  raw int8 weight to the products and applies the scale after the f32 sum:
  the int8 matmul kernel (`ops/kernels/int8mm.py`); no bf16 copy of a
  weight is ever made on the card.
- int4 weights: symmetric absmax over each (contraction group, out channel),
  stored as {"q4": uint8 [..., in/2, out] packed nibbles, "s4": f32
  [..., in/group, out]}. Byte b of q4 packs contraction rows 2b (low
  nibble) and 2b+1 (high), biased by +8 (value = nibble - 8).
- Only the seven block matmuls quantize; `quantize_unembed` also stores the
  embed/unembed tables in int8 with one scale per vocab row, {"q8": int8
  [V, D], "s": f32 [V]} (a tied tree keeps one table). The forward gathers
  and dequantizes only the looked-up rows and unembeds through the int8
  kernel's [V, D] layout, f32 logits.
- `init_params_quantized` samples an int8 or int4 tree at its final size on
  the device, with JAX's structure and constant scales.
- The fused matmul trees (`models/llama.fuse_blocks`) stack projections on
  a new axis -2: a weight [D, C, O], q8 with s [C, O], q4 with q4 [D/2, C,
  O] and s4 [G, C, O]; `mm_stacked` runs each as one matmul over the
  contiguous (C, O) tail.
- int8 KV: one f32 scale per cache slot (absmax over the head dim), int8
  values. `quantize_cache` gives the contiguous cache layout
  {"k8", "ks", "v8", "vs"}.
- `mm(x, w, mesh, partition)`: a plain `@` for a bf16/f32 weight, the int8
  matmul kernel for a q8 tree, the int4 matmul kernel
  (`ops/kernels/int4mm.py`) for a q4 tree; on the CPU the kernels' plain
  versions. Under a mesh a row-parallel product is all-reduced over tp.

Rounding is `torch.round` (half to even, as `jnp.round`) and every division
is a true tensor-by-tensor division (PyTorch turns a division by a Python
scalar into a product with its reciprocal on the card, which can differ in
the last bit), so the quantizers are bit-exact against the JAX ones and
against the quantizing kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

QUANT_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def is_qtensor(w: Any) -> bool:
    return isinstance(w, dict) and "q8" in w


def is_q4tensor(w: Any) -> bool:
    return isinstance(w, dict) and "q4" in w


def tp_safe_group(n_in: int, group: int = 128) -> int:
    """Largest even quant group <= `group` that keeps whole groups inside
    every tensor-parallel shard of the contraction axis for tp in {1, 2, 4,
    8} (the JAX package's rule, kept so trees carry across): Llama-2-7B's
    ffn dim 11008 gives 86, the other 7B and 3B dims keep 128."""
    base = n_in // 8 if n_in % 8 == 0 else n_in
    g = min(group, base, n_in)
    while g > 2 and (base % g or g % 2):
        g -= 1
    return max(g, 2)


def unpack_nibbles(q4: torch.Tensor) -> torch.Tensor:
    """uint8 [..., in/2, out] -> int8 [..., in, out] of values in [-8, 7]:
    row 2b is byte b's low nibble, row 2b+1 its high nibble."""
    lo = (q4 & 0x0F).to(torch.int8) - 8
    hi = (q4 >> 4).to(torch.int8) - 8
    stacked = torch.stack([lo, hi], dim=-2)  # [..., in/2, 2, out]
    return stacked.reshape(*q4.shape[:-2], q4.shape[-2] * 2, q4.shape[-1])


def quantize_weight_int4(w: torch.Tensor, group: int = 128) -> Dict[str, torch.Tensor]:
    """[..., in, out] float -> {"q4": uint8 [..., in/2, out], "s4": f32
    [..., in/group, out]}."""
    n_in = w.shape[-2]
    group = min(group, n_in)
    if n_in % group or group % 2:
        raise ValueError(f"in dim {n_in} must be a multiple of even group {group}")
    w32 = w.float()
    grouped = w32.reshape(*w.shape[:-2], n_in // group, group, w.shape[-1])
    amax = grouped.abs().amax(dim=-2)                    # [..., groups, out]
    s = amax / torch.full_like(amax, 7.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(grouped / s[..., None, :]), -8, 7)
    q = q.reshape(*w.shape[:-2], n_in, w.shape[-1])
    nib = (q + 8).to(torch.uint8)
    pairs = nib.reshape(*w.shape[:-2], n_in // 2, 2, w.shape[-1])
    return {"q4": pairs[..., 0, :] | (pairs[..., 1, :] << 4), "s4": s}


def dequantize_weight_int4(w: Dict[str, torch.Tensor],
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The [..., in, out] weight a q4 tree stands for: nibble x group scale
    in f32, then cast to `dtype` (what the matmul kernel feeds its dots)."""
    q = unpack_nibbles(w["q4"]).float()
    n_in, groups = q.shape[-2], w["s4"].shape[-2]
    grouped = q.reshape(*q.shape[:-2], groups, n_in // groups, q.shape[-1])
    return (grouped * w["s4"][..., None, :]).reshape(q.shape).to(dtype)


def quantize_params_int4(params: Dict[str, Any], group: int = 128,
                         mesh=None) -> Dict[str, Any]:
    """int4-quantize the block matmul weights of a params tree (group
    clamped by `tp_safe_group`). Layer by layer, so a 7B tree quantizes on
    the card without a full-size f32 copy; the result is the same as
    quantizing the stacked weight at once. Under a `mesh` the tree is a
    rank's block and the result that block of the whole tree's
    quantization: a row-parallel weight's group comes from its whole
    contraction (tp_safe_group keeps whole groups on each rank)."""
    out = dict(params)
    blocks = {}
    tp = 1 if mesh is None else mesh.shape["tp"]
    for k, v in params["blocks"].items():
        if k not in QUANT_KEYS:
            blocks[k] = v
            continue
        n_in = v.shape[-2] * (tp if k in ("wo", "wd") else 1)
        g = tp_safe_group(n_in, group)
        per = [quantize_weight_int4(v[i], g) for i in range(v.shape[0])]
        blocks[k] = {"q4": torch.stack([p["q4"] for p in per]),
                     "s4": torch.stack([p["s4"] for p in per])}
    out["blocks"] = blocks
    return out


def quantize_weight(w: torch.Tensor, mesh=None) -> Dict[str, torch.Tensor]:
    """[..., in, out] float -> {"q8": int8 [..., in, out], "s": f32
    [..., out]}: absmax over the contraction axis / 127 (1 where a column is
    all zeros). With a `mesh`, `w` is a row-parallel block (a tp-th of the
    contraction): the absmax is reduced over tp first, so every rank gets
    the scale of the whole weight and its block of the whole weight's q8."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2)                        # [..., out]
    if mesh is not None:
        from .common import all_reduce

        amax = all_reduce(amax, mesh, "tp", op="max")
    s = amax / torch.full_like(amax, 127.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q8 = torch.clamp(torch.round(w32 / s[..., None, :]), -127, 127).to(torch.int8)
    return {"q8": q8, "s": s}


def dequantize_weight(w: Dict[str, torch.Tensor],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The [..., in, out] weight a q8 tree stands for, q8 x s in f32, then
    cast to `dtype`. For tests and yardsticks: `mm` never makes it."""
    return (w["q8"].float() * w["s"][..., None, :]).to(dtype)


def quantize_params(params: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    """int8-quantize the block matmul weights of a params tree. Layer by
    layer, so a 7B tree quantizes on the card without a full-size f32 copy;
    the result is the same as quantizing the stacked weight at once. Under
    a `mesh` the tree is a rank's block (a sharded load) and the result is
    that rank's block of the whole tree's quantization: the row-parallel
    weights' scales come from the absmax over every rank's rows."""
    out = dict(params)
    blocks = {}
    for k, v in params["blocks"].items():
        if k not in QUANT_KEYS:
            blocks[k] = v
            continue
        row = mesh if k in ("wo", "wd") else None
        per = [quantize_weight(v[i], row) for i in range(v.shape[0])]
        blocks[k] = {"q8": torch.stack([p["q8"] for p in per]),
                     "s": torch.stack([p["s"] for p in per])}
    out["blocks"] = blocks
    return out


def init_params_quantized(cfg, generator: Optional[torch.Generator] = None,
                          dtype: torch.dtype = torch.bfloat16, bits: int = 8,
                          device=None) -> Dict[str, Any]:
    """A random int8 (`bits=8`) or int4 (`bits=4`) params tree made at its
    final size on `device` (default CUDA) from `generator` (default: seed 0
    on that device), with no full-precision block weights on the way: a 7B
    int8 tree is 6.5 GB where the bf16 tree it would be quantized from is
    13 GB. The seven block matmuls are uniform over the whole code range
    (int8 -127..127, every nibble) with constant scales that give
    `init_params`' 1/sqrt(fan_in) magnitude, `fan_in ** -0.5 / 127` (int8)
    and `/ 7` per group of `tp_safe_group(fan_in)` (int4), as the JAX
    package's; embeddings, unembedding and norms stay in `dtype`."""
    from .. import resolve_device

    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, f = cfg.hidden_size, cfg.intermediate_size
    nh, kh, hd, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    shapes = {
        "wq": (L, d, nh * hd), "wk": (L, d, kh * hd), "wv": (L, d, kh * hd),
        "wo": (L, nh * hd, d), "wg": (L, d, f), "wu": (L, d, f),
        "wd": (L, f, d),
    }
    blocks: Dict[str, Any] = {}
    for name, shape in shapes.items():
        fan_in = shape[-2]
        if bits == 8:
            q8 = torch.randint(-127, 128, shape, generator=generator,
                               dtype=torch.int8, device=dev)
            s = torch.full(shape[:-2] + shape[-1:], fan_in ** -0.5 / 127.0,
                           dtype=torch.float32, device=dev)
            blocks[name] = {"q8": q8, "s": s}
        else:
            group = tp_safe_group(fan_in)
            q4 = torch.randint(0, 256, shape[:-2] + (fan_in // 2, shape[-1]),
                               generator=generator, dtype=torch.uint8, device=dev)
            s4 = torch.full(shape[:-2] + (fan_in // group, shape[-1]),
                            fan_in ** -0.5 / 7.0, dtype=torch.float32, device=dev)
            blocks[name] = {"q4": q4, "s4": s4}
    blocks["ln_attn"] = torch.ones((L, d), dtype=dtype, device=dev)
    blocks["ln_mlp"] = torch.ones((L, d), dtype=dtype, device=dev)

    def emb():
        x = torch.randn((cfg.vocab_size, d), generator=generator,
                        dtype=torch.float32, device=dev)
        return x.mul_(d ** -0.5).to(dtype)

    params: Dict[str, Any] = {
        "embed": emb(),
        "blocks": blocks,
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = emb()
    return params


def quantize_unembed(params: Dict[str, Any]) -> Dict[str, Any]:
    """int8-quantize the embedding and unembedding tables with one scale a
    vocab row (absmax over the hidden axis / 127): {"q8": int8 [V, D], "s":
    f32 [V]}. A tied tree keeps its one table; a table already quantized
    stays as it is. The forward gathers and dequantizes only the looked-up
    rows, and unembeds through the int8 matmul kernel's [V, D] layout with
    the scale applied to each logit after the f32 sum."""
    def q(t: torch.Tensor) -> Dict[str, torch.Tensor]:
        t32 = t.float()
        amax = t32.abs().amax(dim=-1)                    # [V]
        s = amax / torch.full_like(amax, 127.0)
        s = torch.where(s == 0.0, torch.ones_like(s), s)
        q8 = torch.clamp(torch.round(t32 / s[:, None]), -127, 127).to(torch.int8)
        return {"q8": q8, "s": s}

    out = dict(params)
    if not is_qtensor(params["embed"]):
        out["embed"] = q(params["embed"])
    if "lm_head" in params and not is_qtensor(params["lm_head"]):
        out["lm_head"] = q(params["lm_head"])
    return out


def quantize_kv(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """K or V [..., H] -> {"q8": int8 [..., H], "s": f32 [...]}: one scale
    per slot, absmax over the head dim / 127 (1 where the slot is all
    zeros)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    s = amax / torch.full_like(amax, 127.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q8 = torch.clamp(torch.round(x32 / s[..., None]), -127, 127).to(torch.int8)
    return {"q8": q8, "s": s}


def quantize_cache(k: torch.Tensor, v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A K/V cache pair -> the int8 cache {"k8", "ks", "v8", "vs"}."""
    kq, vq = quantize_kv(k), quantize_kv(v)
    return {"k8": kq["q8"], "ks": kq["s"], "v8": vq["q8"], "vs": vq["s"]}


def mm(x: torch.Tensor, w: Any, mesh=None, partition: str = "col") -> torch.Tensor:
    """x [..., IN] @ w: a plain matmul for a tensor; for a q8 tree the int8
    matmul kernel, for a q4 tree the int4 matmul kernel (their plain
    versions on the CPU); in x's dtype.

    Under a mesh `w` is this rank's block with the weight's Megatron
    `partition` (parallel/sharding.py): "col" (wq/wk/wv/wg/wu) holds a
    tp-th of the out axis and needs no collective; "row" (wo/wd) holds a
    tp-th of the contraction, so the partial products are all-reduced over
    tp. A q4 tree goes through `sharded_int4_matmul`. A q8 tree's
    per-channel scale multiplies each partial product inside the int8
    kernel, before the all-reduce, where JAX scales the sum: the same
    product, rounded in another order."""
    if is_q4tensor(w):
        return _q4_mm(x, w, mesh, partition)
    if isinstance(w, torch.Tensor):
        out = x @ w
    elif is_qtensor(w):
        from .kernels.dispatch import int8_mm

        out = _rows(x, lambda x2: int8_mm(x2, w["q8"], w["s"]))
    else:
        raise TypeError(f"mm takes a tensor, a q8 or a q4 tree, got {type(w).__name__}")
    if partition == "row" and mesh is not None:
        from .common import all_reduce

        out = all_reduce(out, mesh, "tp")
    elif partition not in ("col", "row"):
        raise ValueError(f"partition must be 'col' or 'row', got {partition!r}")
    return out


def _q4_mm(x: torch.Tensor, w: Dict[str, torch.Tensor], mesh,
           partition: str) -> torch.Tensor:
    """The int4 route of mm/mm_stacked: x's leading axes flattened to kernel
    rows, the sharded wrapper under a mesh."""
    from .kernels.dispatch import int4_mm
    from .kernels.int4mm import sharded_int4_matmul

    if mesh is not None:
        return _rows(x, lambda x2: sharded_int4_matmul(
            mesh, x2, w["q4"], w["s4"], partition=partition))
    return _rows(x, lambda x2: int4_mm(x2, w["q4"], w["s4"]))


def mm_stacked(x: torch.Tensor, w: Any, mesh=None) -> torch.Tensor:
    """x [..., D] @ a stacked fused weight [D, C, O] -> [..., C, O]
    (`models/llama.fuse_blocks`): one matmul over the contiguous (C, O)
    tail, so each output column is the same dot product as unfused. A
    tensor, a q8 tree (s [C, O]) or a q4 tree (q4 [D/2, C, O], s4 [G, C,
    O]: the int4 kernel flattens the tail). Always column-parallel: under a
    mesh each rank holds a tp-th of O and the C split stays local."""
    if isinstance(w, torch.Tensor):
        c, o = w.shape[-2:]
        out = x @ w.reshape(w.shape[0], c * o)
    elif is_qtensor(w):
        from .kernels.dispatch import int8_mm

        c, o = w["q8"].shape[-2:]
        q8 = w["q8"].reshape(w["q8"].shape[0], c * o)
        out = _rows(x, lambda x2: int8_mm(x2, q8, w["s"].reshape(c * o)))
    elif is_q4tensor(w):
        c, o = w["q4"].shape[-2:]
        out = _q4_mm(x, w, mesh, "col")
    else:
        raise TypeError(f"mm_stacked takes a tensor, a q8 or a q4 tree, got "
                        f"{type(w).__name__}")
    return out.reshape(*x.shape[:-1], c, o)


def _rows(x: torch.Tensor, fn) -> torch.Tensor:
    """`fn` over x's leading axes flattened into rows: [..., IN] -> [...,
    OUT]."""
    out = fn(x.reshape(-1, x.shape[-1]))
    return out.reshape(*x.shape[:-1], out.shape[-1])

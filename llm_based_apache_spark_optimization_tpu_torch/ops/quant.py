"""Quantized storage: int4 block weights and the int8 KV cache.

Counterpart of the JAX package's `ops/quant.py` for the formats the
quantized serving configuration uses (4-bit weights, int8 KV), the way the
reference's users run these models: Q4 GGUF blobs with a q8 KV cache.

- int4 weights: symmetric absmax over each (contraction group, out channel),
  stored as {"q4": uint8 [..., in/2, out] packed nibbles, "s4": f32
  [..., in/group, out]}. Byte b of q4 packs contraction rows 2b (low
  nibble) and 2b+1 (high), biased by +8 (value = nibble - 8). Only the seven
  block matmuls quantize; embeddings, unembedding and norms stay in the
  compute dtype.
- int8 KV: one f32 scale per cache slot (absmax over the head dim), int8
  values. `quantize_cache` gives the contiguous cache layout
  {"k8", "ks", "v8", "vs"}.
- `mm(x, w)`: a plain `@` for a bf16/f32 weight, the int4 matmul kernel
  (`ops/kernels/int4mm.py`) for a q4 tree.

Rounding is `torch.round` (half to even, as `jnp.round`) and every division
is a true tensor-by-tensor division (PyTorch turns a division by a Python
scalar into a product with its reciprocal on the card, which can differ in
the last bit), so the quantizers are bit-exact against the JAX ones and
against the quantizing kernel.

Not ported yet (ROADMAP A10): int8 weights ("q8" trees), `quantize_unembed`,
`init_params_quantized` and the stacked 3-D trees of the fused matmuls.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

QUANT_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


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


def quantize_params_int4(params: Dict[str, Any], group: int = 128) -> Dict[str, Any]:
    """int4-quantize the block matmul weights of a params tree (group
    clamped by `tp_safe_group`). Layer by layer, so a 7B tree quantizes on
    the card without a full-size f32 copy; the result is the same as
    quantizing the stacked weight at once."""
    out = dict(params)
    blocks = {}
    for k, v in params["blocks"].items():
        if k not in QUANT_KEYS:
            blocks[k] = v
            continue
        g = tp_safe_group(v.shape[-2], group)
        per = [quantize_weight_int4(v[i], g) for i in range(v.shape[0])]
        blocks[k] = {"q4": torch.stack([p["q4"] for p in per]),
                     "s4": torch.stack([p["s4"] for p in per])}
    out["blocks"] = blocks
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


def mm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x [..., IN] @ w: a plain matmul for a tensor, the int4 matmul kernel
    (its plain version on the CPU) for a q4 tree; in x's dtype."""
    if isinstance(w, torch.Tensor):
        return x @ w
    if is_q4tensor(w):
        from .kernels.dispatch import int4_mm

        lead = x.shape[:-1]
        out = int4_mm(x.reshape(-1, x.shape[-1]), w["q4"], w["s4"])
        return out.reshape(*lead, out.shape[-1])
    if isinstance(w, dict) and "q8" in w:
        raise NotImplementedError("int8 weights (q8 trees) are not ported (ROADMAP A10)")
    raise TypeError(f"mm takes a tensor or a q4 tree, got {type(w).__name__}")

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
  tensor, the int4 matmul kernel for a 4-bit tree {"q4", "s4"}
  (`quantize_params_int4`; the params dtype is then that of the norms and
  embeddings).
- The unembed accumulates in f32: for bf16 on CUDA it is one bf16 matmul
  with an f32 output (`torch.mm(..., out_dtype=torch.float32)`), elsewhere
  `x.float() @ w.float().T`.
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
  steps only (T == 1): each layer quantizes its fresh sliver (one scale per
  slot, absmax over H), writes values and scales in place, then attends
  through the quantized flash kernel, which dequantizes in its tile. The
  paged pool with scales `{"kp", "vp": int8, "kps", "vps": [L, P, K, PS]
  f32, "ptab"}` writes through the quantizing page-write kernel and reads
  through the quantized ragged paged attention kernel.
- Attention, page writes and int4 matmuls go through
  `ops.kernels.dispatch`: the hand-written kernels on CUDA, their plain
  versions on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.kernels.dispatch import (
    attention,
    attention_quantized,
    page_write,
    page_write_quantized,
    paged_attention,
    paged_attention_quantized,
)
from ..ops.norm import rms_norm
from ..ops.quant import mm, quantize_kv
from ..ops.rope import apply_rope, rope_cos_sin
from .configs import LlamaConfig

Params = Dict[str, object]

# Paged forwards serve windows of at most this many tokens (decode steps,
# verify windows, mixed rounds); longer prefill runs a contiguous cache and
# packs or scatters its K/V into pool pages (engine/generate.py,
# serve/scheduler.py). The JAX package's unrolled small-T bound.
_UNROLL_MAX_T = 32


def init_params(
    cfg: LlamaConfig,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> Params:
    """Random weights made on `device` (default CUDA) from `generator`
    (default: seed 0 on that device), scaled 1/sqrt(fan_in) so random models
    give finite logits at any depth. Norm weights are ones."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, f = cfg.hidden_size, cfg.intermediate_size
    nh, kh, hd, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers

    def w(shape, fan_in):
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return x.mul_(fan_in ** -0.5).to(dtype)

    params: Params = {
        "embed": w((cfg.vocab_size, d), d),
        "blocks": {
            "wq": w((L, d, nh * hd), d),
            "wk": w((L, d, kh * hd), d),
            "wv": w((L, d, kh * hd), d),
            "wo": w((L, nh * hd, d), nh * hd),
            "wg": w((L, d, f), d),
            "wu": w((L, d, f), d),
            "wd": w((L, f, d), f),
            "ln_attn": torch.ones((L, d), dtype=dtype, device=dev),
            "ln_mlp": torch.ones((L, d), dtype=dtype, device=dev),
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = w((cfg.vocab_size, d), d)
    return params


def _write_cache(layer_cache: torch.Tensor, new: torch.Tensor,
                 start: torch.Tensor) -> None:
    """Write `new` [B, T, K, H] into `layer_cache` [B, K, S, H] (a view of
    one layer of the stacked cache) at slots start[b] + t, in place; the
    same for per-slot scales [B, T, K] into [B, K, S]."""
    b, t = new.shape[:2]
    rows = torch.arange(b, device=new.device)[:, None]
    slots = start.long()[:, None] + torch.arange(t, device=new.device)[None, :]
    layer_cache[rows, :, slots] = new.to(layer_cache.dtype)


def _at(w, layer: int):
    """Layer `layer` of a stacked weight: a tensor, or a q4 tree's arrays."""
    return {k: v[layer] for k, v in w.items()} if isinstance(w, dict) else w[layer]


def _unembed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, T, D] x [V, D] -> [B, T, V] f32 logits, accumulated in f32."""
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    if x.is_cuda and x.dtype == torch.bfloat16:
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
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Run T tokens through the stack; returns (logits f32, cache).

    With `cache=None` the layer's own K/V are the keys (prefill-only
    scoring). With a cache, K/V are written at `positions[:, 0] + t` and
    attention reads the layer's whole cache, masked by position (an int8
    cache: T == 1 only). With a paged cache, K/V are written at `positions`
    through the page table (dead columns past `q_lens` write nothing and
    read zeros), then attention reads through it. `logit_indices` unembeds
    only those T-indices ([B, 1, V] logits)."""
    b, t = tokens.shape
    paged = cache is not None and "kp" in cache
    quant = cache is not None and "k8" in cache
    if quant and t != 1:
        raise ValueError(
            f"an int8 KV cache serves decode steps only (T == 1), got T={t}: "
            "prefill fills a compute-dtype cache, then quantize_cache converts "
            "it once (engine/generate.py)")
    if paged and t > _UNROLL_MAX_T:
        raise ValueError(
            "a paged KV cache serves the unrolled small-T path only "
            f"(T <= {_UNROLL_MAX_T}; decode, verify windows, and mixed "
            "ragged prefill+decode rounds): longer prefill runs a "
            "contiguous transient/row cache and packs or scatters its K/V "
            "into pool pages (engine/generate.py, serve/scheduler.py)."
        )
    x = params["embed"][tokens.long()]  # [B, T, D]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    start = positions[:, 0]
    nh, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    blocks = params["blocks"]

    for l in range(cfg.num_layers):
        h = rms_norm(x, blocks["ln_attn"][l], cfg.norm_eps)
        q = mm(h, _at(blocks["wq"], l)).reshape(b, t, nh, hd)
        k = mm(h, _at(blocks["wk"], l)).reshape(b, t, kh, hd)
        v = mm(h, _at(blocks["wv"], l)).reshape(b, t, kh, hd)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if paged and "kps" in cache:
            page_write_quantized(cache["kp"], cache["kps"], cache["vp"],
                                 cache["vps"], k, v, positions, cache["ptab"],
                                 l, q_lens)
            attn = paged_attention_quantized(
                q, cache["kp"][l], cache["kps"][l], cache["vp"][l],
                cache["vps"][l], cache["ptab"], positions, cfg.sliding_window,
                kv_lens, q_lens)
        elif paged:
            page_write(cache["kp"], cache["vp"], k, v, positions,
                       cache["ptab"], l, q_lens)
            attn = paged_attention(q, cache["kp"][l], cache["vp"][l],
                                   cache["ptab"], positions,
                                   cfg.sliding_window, kv_lens, q_lens)
        elif quant:
            for name, new in (("k", k), ("v", v)):
                qn = quantize_kv(new)
                _write_cache(cache[f"{name}8"][l], qn["q8"], start)
                _write_cache(cache[f"{name}s"][l], qn["s"], start)
            attn = attention_quantized(q, cache["k8"][l], cache["ks"][l],
                                       cache["v8"][l], cache["vs"][l], positions,
                                       cfg.sliding_window, kv_lens)
        else:
            if cache is None:
                k_full = k.transpose(1, 2).contiguous()  # cache layout [B, K, T, H]
                v_full = v.transpose(1, 2).contiguous()
            else:
                k_full, v_full = cache["k"][l], cache["v"][l]
                _write_cache(k_full, k, start)
                _write_cache(v_full, v, start)
            attn = attention(q, k_full, v_full, positions, cfg.sliding_window,
                             kv_lens)
        x = x + mm(attn.reshape(b, t, nh * hd), _at(blocks["wo"], l))
        h2 = rms_norm(x, blocks["ln_mlp"][l], cfg.norm_eps)
        gate = F.silu(mm(h2, _at(blocks["wg"], l)).float()).to(x.dtype)
        x = x + mm(gate * mm(h2, _at(blocks["wu"], l)), _at(blocks["wd"], l))

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logit_indices is not None:
        x = x[torch.arange(b, device=x.device), logit_indices.long()][:, None]
    unembed = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return _unembed(x, unembed), cache

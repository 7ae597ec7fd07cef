"""Grouped-query attention over a preallocated KV cache: the plain golden.

`gqa_attention` under `attention_mask` is the reference the attention kernel
(`ops/kernels/attention.py`) is held against, and `gqa_attention_quantized`
its twin over the int8 cache. GQA reshapes Q to [B, T, K, G, H] and
contracts per KV head, so K/V are never repeated; scores and softmax run in
float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import NEG_INF


def attention_mask(
    q_positions: torch.Tensor,
    kv_size: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Boolean [B, T, S] mask: key slot s visible to query at position p iff s <= p.

    Cache slots beyond a sequence's current length hold padded-prefill K/V;
    they sit at slots > p, so causality alone hides them.
    """
    kv_idx = torch.arange(kv_size, dtype=torch.int32,
                          device=q_positions.device)[None, None, :]
    qp = q_positions.to(torch.int32)[:, :, None]
    mask = kv_idx <= qp
    if sliding_window is not None:
        mask = mask & (qp - kv_idx < sliding_window)
    return mask


def gqa_attention(
    q: torch.Tensor,     # [B, T, N, H]
    k: torch.Tensor,     # [B, K, S, H]  (head-major cache layout)
    v: torch.Tensor,     # [B, K, S, H]
    mask: torch.Tensor,  # [B, T, S] bool
) -> torch.Tensor:
    """Returns [B, T, N, H] in q's dtype. N = K * G."""
    b, t, n, h = q.shape
    kh = k.shape[1]
    g = n // kh
    q5 = q.reshape(b, t, kh, g, h).permute(0, 2, 3, 1, 4).float()  # [B,K,G,T,H]
    scores = torch.matmul(q5, k.float().transpose(-1, -2)[:, :, None]) * h ** -0.5
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()[:, :, None])
    return out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, t, n, h)


def gqa_attention_quantized(
    q: torch.Tensor,     # [B, T, N, H]
    k8: torch.Tensor,    # [B, K, S, H] int8
    ks: torch.Tensor,    # [B, K, S] f32 — per-slot K scales
    v8: torch.Tensor,    # [B, K, S, H] int8
    vs: torch.Tensor,    # [B, K, S] f32 — per-slot V scales
    mask: torch.Tensor,  # [B, T, S] bool
) -> torch.Tensor:
    """`gqa_attention` over the int8 cache (ops/quant.quantize_kv), as the
    JAX package writes it: the K scales multiply the scores after the QK
    dot, the V scales fold into the probabilities, which are cast to q's
    dtype before the PV dot. Returns [B, T, N, H] in q's dtype."""
    b, t, n, h = q.shape
    kh = k8.shape[1]
    g = n // kh
    q5 = q.reshape(b, t, kh, g, h).permute(0, 2, 3, 1, 4).float()  # [B,K,G,T,H]
    scores = torch.matmul(q5, k8.float().transpose(-1, -2)[:, :, None])
    scores = scores * (ks.float()[:, :, None, None, :] * h ** -0.5)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    pv = probs * vs.float()[:, :, None, None, :]
    out = torch.matmul(pv.to(q.dtype).float(), v8.float()[:, :, None])
    return out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, t, n, h)

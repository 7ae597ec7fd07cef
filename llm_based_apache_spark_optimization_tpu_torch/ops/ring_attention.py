"""Ring attention: causal GQA with the sequence axis sharded over "sp", and
the decode read of a cache whose slots are sharded over "sp".

Counterpart of the JAX package's `ops/ring_attention.py`, which computes it
outside any Pallas kernel (einsums and an online softmax); so does this
module, in plain PyTorch. Each sp rank takes its own block of the query
sequence and of the K/V, computes blockwise attention against the K/V block
it holds, then passes that block to the next rank of the ring
(`ops.common.ring_shift`, `batch_isend_irecv`); after sp steps every query
block has seen every K/V block.

Numerics are flash-attention style: a running row max `m`, normalizer `l`
and unnormalized accumulator `o` in float32, merged with the
rescale-by-exp(m_old - m_new) identity. Causality (and a sliding window)
come from global positions: at step i a rank holds the K/V block that
started on rank (my - i) mod sp. A block that lies wholly right of every
query position here (or wholly left of the window) skips its math; the
rotation stays outside that skip on every step, or the ring deadlocks.

`ring_gqa_attention` takes this rank's view of the global operands (its
dp rows and tp heads, the whole sequence: activations outside attention
are replicated over sp, as in JAX) and returns the whole-sequence output,
gathered over sp.

`sp_cache_attention` is the decode side (JAX's "einsum path is the sp
decode impl"): each rank attends over its own slots of the cache, then the
ranks combine their partial softmaxes with an all-reduce of the row max
and of the rescaled sums (flash-decoding's combine).
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import NEG_INF, all_gather, all_reduce, axis_index, axis_size, ring_shift


def _ring_attention_sharded(
    q: torch.Tensor,            # [B, Tq, N, H]  this rank's query block
    k: torch.Tensor,            # [B, Tk, K, H]  this rank's K/V block (rotates)
    v: torch.Tensor,            # [B, Tk, K, H]
    q_positions: torch.Tensor,  # [B, Tq] global positions of the query block
    mesh,
    axis: str = "sp",
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    sp = axis_size(mesh, axis)
    my = axis_index(mesh, axis)
    b, tq, n, h = q.shape
    tk, kh = k.shape[1], k.shape[2]
    g = n // kh
    scale = h ** -0.5
    q5 = q.reshape(b, tq, kh, g, h).float()
    qp = q_positions.to(torch.int32)[:, :, None]  # [B, Tq, 1]
    qp_max, qp_min = int(qp.max()), int(qp.min())

    o = torch.zeros((b, tq, kh, g, h), dtype=torch.float32, device=q.device)
    m = torch.full((b, kh, g, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, tq), dtype=torch.float32, device=q.device)
    for i in range(sp):
        chunk = (my - i) % sp
        visible = chunk * tk <= qp_max
        if sliding_window is not None:
            visible = visible and (qp_min - (chunk * tk + tk - 1) < sliding_window)
        if visible:
            kv_idx = chunk * tk + torch.arange(tk, dtype=torch.int32,
                                               device=q.device)[None, None, :]
            mask = kv_idx <= qp  # [B, Tq, Tk]
            if sliding_window is not None:
                mask = mask & (qp - kv_idx < sliding_window)
            s = torch.einsum("btkgh,bskh->bkgts", q5, k.float()) * scale
            mask5 = mask[:, None, None, :, :]
            s = torch.where(mask5, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # A row masked everywhere has m_new == NEG_INF and exp(0) == 1:
            # zero it explicitly.
            p = torch.exp(s - m_new[..., None]) * mask5
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgts,bskh->btkgh", p.to(v.dtype).float(), v.float())
            o = o * alpha.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        k, v = ring_shift((k, v), mesh, axis)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = o / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, tq, n, h).to(q.dtype)


def ring_gqa_attention(
    mesh,
    q: torch.Tensor,            # [B, T, N, H]  this rank's dp rows / tp heads
    k: torch.Tensor,            # [B, T, K, H]
    v: torch.Tensor,            # [B, T, K, H]
    q_positions: torch.Tensor,  # [B, T] global positions
    sliding_window: Optional[int] = None,
    sp_axis: str = "sp",
) -> torch.Tensor:
    """Causal GQA with the sequence axis sharded over `sp_axis`: this rank
    attends its T/sp block of queries through the ring and the blocks are
    gathered back into [B, T, N, H]. T must divide by sp (the engine pads
    prompts to a multiple, `InferenceEngine.padded_prompt_len`)."""
    if mesh is None or sp_axis not in mesh.shape:
        raise ValueError(f"ring attention needs a mesh with an {sp_axis!r} axis")
    sp = mesh.shape[sp_axis]
    t = q.shape[1]
    if t % sp:
        raise ValueError(f"sequence length {t} not divisible by sp={sp}")
    tc, my = t // sp, mesh.coords[sp_axis]
    blk = slice(my * tc, (my + 1) * tc)
    out = _ring_attention_sharded(q[:, blk], k[:, blk], v[:, blk],
                                  q_positions[:, blk], mesh, sp_axis,
                                  sliding_window)
    return all_gather(out, mesh, sp_axis, dim=1)


def sp_cache_attention(
    q: torch.Tensor,            # [B, T, N, H]
    k: torch.Tensor,            # [B, K, S_loc, H]  this rank's cache slots
    v: torch.Tensor,            # [B, K, S_loc, H]
    q_positions: torch.Tensor,  # [B, T]
    mesh,
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,  # [B, K, S_loc] (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    sp_axis: str = "sp",
) -> torch.Tensor:
    """GQA over a cache whose slots are sharded over sp: this rank holds
    global slots [r * S_loc, (r + 1) * S_loc). Each rank's partial softmax
    (max, sum, unnormalized output) in f32 over its slots, masked by global
    slot (causal, window, `kv_lens`), then combined over sp. An int8 cache
    passes its scales: the K scales multiply the scores, the V scales the
    probabilities, as `ops.attention.gqa_attention_quantized`."""
    b, t, n, h = q.shape
    kh, s_loc = k.shape[1], k.shape[2]
    g = n // kh
    base = axis_index(mesh, sp_axis) * s_loc
    kv_idx = base + torch.arange(s_loc, dtype=torch.int32, device=q.device)[None, None, :]
    qp = q_positions.to(torch.int32)[:, :, None]
    mask = kv_idx <= qp
    if sliding_window is not None:
        mask = mask & (qp - kv_idx < sliding_window)
    if kv_lens is not None:
        mask = mask & (kv_idx < kv_lens.to(torch.int32)[:, None, None])
    q5 = q.reshape(b, t, kh, g, h).permute(0, 2, 3, 1, 4).float()  # [B,K,G,T,H]
    s = torch.matmul(q5, k.float().transpose(-1, -2)[:, :, None])
    if k_scale is not None:
        s = s * (k_scale.float()[:, :, None, None, :] * h ** -0.5)
    else:
        s = s * h ** -0.5
    mask5 = mask[:, None, None]
    s = torch.where(mask5, s, NEG_INF)
    m_loc = s.amax(dim=-1)
    m = all_reduce(m_loc, mesh, sp_axis, op="max")
    p = torch.exp(s - m[..., None]) * mask5
    l = all_reduce(p.sum(dim=-1), mesh, sp_axis)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, None, :]
    o = torch.matmul(p.to(q.dtype).float(), v.float()[:, :, None])  # [B,K,G,T,H]
    o = all_reduce(o, mesh, sp_axis)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = o / l[..., None]
    return out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, t, n, h)

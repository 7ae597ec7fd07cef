"""Flash GQA attention: the CUDA kernels' wrappers and their plain versions.

Counterpart of the JAX package's `ops/pallas/attention.py`
(`flash_gqa_attention`, `flash_gqa_attention_quantized`). The kernels are
`csrc/flash_gqa_attention.cu` and, over the int8 cache,
`csrc/flash_gqa_attention_quantized.cu`, built with nvcc at first use and
called through ctypes; see their headers for the design. Three launches,
counted apart:

- "flash_gqa_prefill" (T > 1): one block per (b, kv head, tile of rows):
  in bf16 the tensor-core kernel of `csrc/flash_prefill.cuh`, 64 rows a
  block; in f32 the scalar tile kernel, 16 rows a block;
- "flash_gqa_decode" (T == 1): one block per (b, kv head) holding all G rows;
- "flash_gqa_decode_quantized" (T == 1, int8 cache): the same blocks over
  int8 K/V with one f32 scale per slot, dequantized in the tile.

A tensor on the CPU goes to `flash_gqa_attention_plain`; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..common import NEG_INF
from .launches import count

HEAD_DIMS = (64, 128)
_PREFILL_ROWS = 16  # rows per block of the scalar kernel's prefill (csrc BR)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _LL, _LL, _LL, _LL, _LL, _LL, _I, ctypes.c_float, _I, _I, _P]
_Q_ARGTYPES = ([_P] * 8 + [_I] * 5 + [_LL] * 4
               + [_I, ctypes.c_float, _I, _I, _P])


def _default_kv_lens(q_positions: torch.Tensor, kv_lens, s: int) -> torch.Tensor:
    if kv_lens is None:
        kv_lens = q_positions.max(dim=1).values + 1
    return kv_lens.to(torch.int32).clamp(0, s)


def flash_gqa_attention_plain(
    q: torch.Tensor,            # [B, T, N, H]
    k: torch.Tensor,            # [B, K, S, H]
    v: torch.Tensor,            # [B, K, S, H]
    q_positions: torch.Tensor,  # [B, T] int
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,  # [B] int
) -> torch.Tensor:
    """The kernel's contract in eager PyTorch: `gqa_attention` under
    `attention_mask`, plus the live-length bound `kv_lens` (default
    max(position) + 1, clipped to [0, S]), exact zeros for a row with no
    visible key, and value rows past the live length zeroed before the PV
    product. Scores and softmax in f32; p is rounded to v's dtype before the
    PV product, as the TPU kernel does. Returns [B, T, N, H] in q's dtype."""
    b, t, n, h = q.shape
    kh, s = k.shape[1], k.shape[2]
    g = n // kh
    kv_lens = _default_kv_lens(q_positions, kv_lens, s)
    q5 = q.reshape(b, t, kh, g, h).permute(0, 2, 3, 1, 4).float()  # [B,K,G,T,H]
    scores = torch.matmul(q5, k.float().transpose(-1, -2)[:, :, None]) * h ** -0.5
    kv_idx = torch.arange(s, device=q.device)
    qp = q_positions.to(torch.int64)[:, None, None, :, None]  # [B,1,1,T,1]
    live = kv_idx[None, :] < kv_lens[:, None]                 # [B, S]
    mask = (kv_idx <= qp) & live[:, None, None, None, :]
    if sliding_window:
        mask = mask & (qp - kv_idx < sliding_window)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    v_z = torch.where(live[:, None, :, None], v, torch.zeros((), dtype=v.dtype,
                                                              device=v.device))
    pv = torch.matmul(p.to(v.dtype).float(), v_z.float()[:, :, None])
    out = pv / torch.where(l == 0.0, 1.0, l)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, n, h).to(q.dtype)


def decode_rows(g: int) -> int:
    """Row tile of the decode launch: the next power of two >= G, at most 16
    (so one block holds every query head of its KV head up to G = 16)."""
    br = 1
    while br < min(g, _PREFILL_ROWS):
        br *= 2
    return br


def flash_gqa_attention_cuda(q, k, v, q_positions, sliding_window=None,
                             kv_lens=None) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    b, t, n, h = q.shape
    kh, s = k.shape[1], k.shape[2]
    for name, x in (("k", k), ("v", v), ("q_positions", q_positions)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernel takes bf16 or f32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if h not in HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in {HEAD_DIMS}, got {h}")
    if k.shape != (b, kh, s, h) or v.shape != k.shape or n % kh:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q_positions.shape != (b, t):
        raise ValueError(f"q_positions {tuple(q_positions.shape)} != {(b, t)}")
    if not (k.is_contiguous() and v.is_contiguous()) or q.stride(-1) != 1:
        raise ValueError("k and v must be contiguous, q contiguous in its head dim")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 or any(
            st * q.element_size() % 16 for st in q.stride()[:3]):
        raise ValueError("q, k, v must be 16-byte aligned")
    # qpos and lens may be freed when this returns, before the kernel runs:
    # the caching allocator reuses their memory only in this stream's order.
    qpos = q_positions.to(torch.int32).contiguous()
    lens = _default_kv_lens(qpos, kv_lens, s).to(q.device).contiguous()
    out = torch.empty((b, t, n, h), dtype=q.dtype, device=q.device)
    decode = t == 1
    br = decode_rows(n // kh) if decode else _PREFILL_ROWS
    from ._build import kernel_fn

    err = kernel_fn("flash_gqa_attention", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
        lens.data_ptr(), out.data_ptr(), b, t, n, kh, s, h,
        *q.stride()[:3], *out.stride()[:3],
        int(sliding_window or 0), h ** -0.5, int(q.dtype == torch.bfloat16),
        br, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_gqa_attention launch failed: CUDA error {err}")
    count("flash_gqa_decode" if decode else "flash_gqa_prefill")
    return out


def flash_gqa_attention(
    q: torch.Tensor,            # [B, T, N, H]
    k: torch.Tensor,            # [B, K, S, H]  (head-major cache layout)
    v: torch.Tensor,            # [B, K, S, H]
    q_positions: torch.Tensor,  # [B, T] int — absolute position of each query
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,  # [B] int — live KV slots per row
) -> torch.Tensor:
    """Drop-in for `gqa_attention(q, k, v, attention_mask(positions, S, w))`
    whose output depends only on the first kv_lens[b] cache slots. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
    if q.device.type == "cpu":
        return flash_gqa_attention_plain(q, k, v, q_positions, sliding_window,
                                         kv_lens)
    if q.device.type != "cuda":
        raise ValueError(f"flash_gqa_attention runs on cuda or cpu, not {q.device}")
    return flash_gqa_attention_cuda(q, k, v, q_positions, sliding_window, kv_lens)


def dequantize_kv(q8: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 K or V [..., S, H] and per-slot scales [..., S] -> the compute
    dtype: the f32 product rounded once, as the kernels do in the tile."""
    return (q8.float() * s.float()[..., None]).to(dtype)


def flash_gqa_attention_quantized_plain(
    q: torch.Tensor,            # [B, T, N, H]
    k8: torch.Tensor,           # [B, K, S, H] int8
    ks: torch.Tensor,           # [B, K, S] f32
    v8: torch.Tensor,           # [B, K, S, H] int8
    vs: torch.Tensor,           # [B, K, S] f32
    q_positions: torch.Tensor,  # [B, T] int
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,  # [B] int
) -> torch.Tensor:
    """The quantized kernel's contract in eager PyTorch: K/V dequantized to
    q's dtype (`_dequant_streams`), then `flash_gqa_attention_plain`. Dead
    slots may hold any scale, NaN included: masking and the zeroing of
    value rows past the live length keep it out of the result."""
    return flash_gqa_attention_plain(
        q, dequantize_kv(k8, ks, q.dtype), dequantize_kv(v8, vs, q.dtype),
        q_positions, sliding_window, kv_lens)


def flash_gqa_attention_quantized_cuda(q, k8, ks, v8, vs, q_positions,
                                       sliding_window=None, kv_lens=None) -> torch.Tensor:
    """Launch the quantized CUDA kernel (T == 1); raises on anything it does
    not take."""
    b, t, n, h = q.shape
    kh, s = k8.shape[1], k8.shape[2]
    for name, x in (("k8", k8), ("ks", ks), ("v8", v8), ("vs", vs),
                    ("q_positions", q_positions)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernel takes bf16 or f32, got {q.dtype}")
    if k8.dtype != torch.int8 or v8.dtype != torch.int8 \
            or ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError(f"quantized cache must be int8 values and f32 scales, got "
                        f"{k8.dtype}, {ks.dtype}, {v8.dtype}, {vs.dtype}")
    if h not in HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in {HEAD_DIMS}, got {h}")
    if t != 1:
        raise ValueError(f"quantized flash kernel is decode-only (T=1), got T={t}")
    if (k8.shape != (b, kh, s, h) or v8.shape != k8.shape or ks.shape != (b, kh, s)
            or vs.shape != ks.shape or n % kh):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k8 {tuple(k8.shape)} ks "
                         f"{tuple(ks.shape)} v8 {tuple(v8.shape)} vs {tuple(vs.shape)}")
    if q_positions.shape != (b, t):
        raise ValueError(f"q_positions {tuple(q_positions.shape)} != {(b, t)}")
    if not all(x.is_contiguous() for x in (k8, ks, v8, vs)) or q.stride(-1) != 1:
        raise ValueError("the cache must be contiguous, q contiguous in its head dim")
    if (q.data_ptr() | k8.data_ptr() | v8.data_ptr()) % 16 \
            or (ks.data_ptr() | vs.data_ptr()) % 4 or any(
                st * q.element_size() % 16 for st in (q.stride(0), q.stride(2))):
        raise ValueError("q and the int8 cache must be 16-byte aligned")
    qpos = q_positions.to(torch.int32).contiguous()
    lens = _default_kv_lens(qpos, kv_lens, s).to(q.device).contiguous()
    out = torch.empty((b, t, n, h), dtype=q.dtype, device=q.device)
    from ._build import kernel_fn

    err = kernel_fn("flash_gqa_attention_quantized", _Q_ARGTYPES)(
        q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        qpos.data_ptr(), lens.data_ptr(), out.data_ptr(), b, n, kh, s, h,
        q.stride(0), q.stride(2), out.stride(0), out.stride(2),
        int(sliding_window or 0), h ** -0.5, int(q.dtype == torch.bfloat16),
        decode_rows(n // kh), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_gqa_attention_quantized launch failed: CUDA error {err}")
    count("flash_gqa_decode_quantized")
    return out


def flash_gqa_attention_quantized(
    q: torch.Tensor,            # [B, 1, N, H] — decode only
    k8: torch.Tensor,           # [B, K, S, H] int8
    ks: torch.Tensor,           # [B, K, S] f32 — per-slot K scales
    v8: torch.Tensor,           # [B, K, S, H] int8
    vs: torch.Tensor,           # [B, K, S] f32 — per-slot V scales
    q_positions: torch.Tensor,  # [B, 1] int
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,  # [B] int — live KV slots per row
) -> torch.Tensor:
    """Decode attention over the int8 cache, bounded by `kv_lens` (default
    max(position) + 1); T == 1 only, as the TPU kernel. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel."""
    if q.shape[1] != 1:
        raise ValueError(f"quantized flash kernel is decode-only (T=1), got T={q.shape[1]}")
    if q.device.type == "cpu":
        return flash_gqa_attention_quantized_plain(q, k8, ks, v8, vs, q_positions,
                                                   sliding_window, kv_lens)
    if q.device.type != "cuda":
        raise ValueError(f"flash_gqa_attention_quantized runs on cuda or cpu, not {q.device}")
    return flash_gqa_attention_quantized_cuda(q, k8, ks, v8, vs, q_positions,
                                              sliding_window, kv_lens)

"""Ragged paged attention: the CUDA kernels' wrappers and their plain versions.

Counterpart of the JAX package's `ops/pallas/paged_attention.py`
(`ragged_paged_attention`, `gather_pages`, `paged_attention_reference`, and
over the int8 pool `ragged_paged_attention_quantized`, `gather_page_scales`,
`paged_attention_reference_quantized`).
K/V live in a shared pool `[P, K, PS, H]` (one layer) and each batch row
reads its logical pages through a page table `[B, NP]`, whose unmapped
entries hold the sentinel P. Query windows are ragged: `q_lens[b]` live
columns per row, the rest come out as exact zeros, and `kv_lens[b] = 0`
parks a row (zeros). The int8 pool holds int8 values and one f32 scale per
(page, kv head, position), `[P, K, PS]`. The kernels are
`csrc/ragged_paged_attention.cu` and `csrc/ragged_paged_attention_quantized.cu`,
built with nvcc at first use and called through ctypes; see their headers
for the design. Decode (T == 1), over either pool, runs the split-KV kernel
of `csrc/decode_split.cuh` over a thread-block cluster of
`decode_split_plan` blocks a row; bf16 query windows (T > 1) the
tensor-core kernel of `csrc/window_split.cuh`, each row tile's KV range
split over a cluster of `window_split_plan` blocks; f32 query windows the
tile kernel of `csrc/gqa_tile.cuh`, 16 folded rows a block. The decode
launches count as "ragged_paged_attention" (and "_quantized"), the windows
as "ragged_paged_window" (and "_quantized").

A tensor on the CPU goes to the `_plain` version; a CUDA tensor launches the
kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .attention import (
    HEAD_DIMS,
    _default_kv_lens,
    decode_split_plan,
    dequantize_kv,
    flash_gqa_attention_plain,
    window_split_plan,
)
from .launches import count, sm_count

#: Folded query rows (T * G) one launch serves: the TPU kernel keeps the
#: whole folded query block resident, and the port keeps its bound.
MAX_QROWS = 512
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 8 + [_I] * 8 + [_LL] * 6
             + [_I, ctypes.c_float, _I, _I, _P])
_Q_ARGTYPES = ([_P] * 10 + [_I] * 8 + [_LL] * 6
               + [_I, ctypes.c_float, _I, _I, _P])


def validate_window(q: torch.Tensor, kv_heads: int) -> None:
    """Reject query windows whose folded row count T*G is outside
    [1, MAX_QROWS] (the TPU wrapper's `_validate_window` message)."""
    t, n = q.shape[1], q.shape[2]
    g = n // max(kv_heads, 1)
    if t < 1 or t * g > MAX_QROWS:
        raise ValueError(
            f"ragged_paged_attention serves query windows with "
            f"1 <= T*G <= {MAX_QROWS} folded rows, got T={t} (G={g}); "
            f"larger windows take paged_attention_reference"
        )


def launch_splits(b: int, kh: int, s_virt: int, t: int, g: int, bf16: bool,
                  sms: int) -> int:
    """The C entry points' `splits` argument: the decode kernel's cluster
    size at T == 1 (`decode_split_plan`), the bf16 window kernel's at T > 1
    (`window_split_plan` over G * T folded rows), and 0 for an f32 window,
    which the tile kernel serves (TF32 tensor cores would miss f32's
    tolerance)."""
    if t == 1:
        return decode_split_plan(b, kh, s_virt, t, sms)
    return window_split_plan(b, kh, s_virt, g * t, sms) if bf16 else 0


def _counter(name: str, t: int) -> str:
    """The launch count of a call: decode (T == 1) or query window."""
    return name if t == 1 else name.replace("attention", "window")


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Per-row contiguous views [B, K, NP*PS, H] of one layer's pool
    [P, K, PS, H], gathered through the table (a copy). Sentinel entries
    clip to a real page; their content sits where the mask hides it."""
    num_pages, kh, ps, h = pool.shape
    b, np_tab = page_table.shape
    safe = page_table.long().clamp(0, num_pages - 1)
    g = pool[safe]                                   # [B, NP, K, PS, H]
    return g.permute(0, 2, 1, 3, 4).reshape(b, kh, np_tab * ps, h)


def gather_page_scales(pool_s: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Per-row contiguous scale views [B, K, NP*PS] of one layer's scales
    [P, K, PS], gathered through the clipped table (`gather_pages`' H-less
    twin)."""
    num_pages, kh, ps = pool_s.shape
    b, np_tab = page_table.shape
    safe = page_table.long().clamp(0, num_pages - 1)
    return pool_s[safe].permute(0, 2, 1, 3).reshape(b, kh, np_tab * ps)


def _lens(q_positions, kv_lens, q_lens, s_virt, t):
    """(kv_lens, q_lens) as int32, defaulted and clipped as the TPU
    wrapper does: kv_lens to [0, NP*PS] (default max(position) + 1),
    q_lens to [0, T] (default T)."""
    kv_lens = _default_kv_lens(q_positions, kv_lens, s_virt)
    if q_lens is None:
        q_lens = torch.full((q_positions.shape[0],), t, dtype=torch.int32,
                            device=q_positions.device)
    return kv_lens, q_lens.to(torch.int32).clamp(0, t)


def ragged_paged_attention_plain(
    q: torch.Tensor,            # [B, T, N, H]
    k_pool: torch.Tensor,       # [P, K, PS, H]
    v_pool: torch.Tensor,       # [P, K, PS, H]
    page_table: torch.Tensor,   # [B, NP] int
    q_positions: torch.Tensor,  # [B, T] int
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,  # [B] int
    q_lens: Optional[torch.Tensor] = None,   # [B] int
) -> torch.Tensor:
    """The kernel's contract in eager PyTorch (`paged_attention_reference`):
    gather the rows through the clipped table, then the plain flash
    attention under the causal/window mask and `kv_lens` (zeros for a row
    with no visible key, so `kv_lens = 0` rows are zeros), p rounded to v's
    dtype before PV; window columns at or past `q_lens` are zeroed."""
    return _attend_rows(q, gather_pages(k_pool, page_table),
                        gather_pages(v_pool, page_table), q_positions,
                        sliding_window, kv_lens, q_lens)


def _attend_rows(q, k_rows, v_rows, q_positions, sliding_window, kv_lens, q_lens):
    """The plain flash attention over gathered row views [B, K, NP*PS, H]
    under the ragged-window contract (dead columns exact zeros)."""
    t = q.shape[1]
    kv_lens, q_lens = _lens(q_positions, kv_lens, q_lens, k_rows.shape[2], t)
    out = flash_gqa_attention_plain(q, k_rows, v_rows, q_positions, sliding_window,
                                    kv_lens)
    live = torch.arange(t, device=q.device)[None, :] < q_lens[:, None]
    return torch.where(live[:, :, None, None], out, torch.zeros((), dtype=out.dtype,
                                                                device=out.device))


def ragged_paged_attention_cuda(q, k_pool, v_pool, page_table, q_positions,
                                sliding_window=None, kv_lens=None,
                                q_lens=None) -> torch.Tensor:
    """Launch the CUDA kernel (T == 1: the split-KV decode kernel; T > 1:
    the window kernel in bf16, the tile kernel in f32), one launch a call;
    raises on anything it does not take, and on a refused cluster launch."""
    b, t, n, h = q.shape
    num_pages, kh, ps = k_pool.shape[:3]
    np_tab = page_table.shape[1]
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("q_positions", q_positions)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged kernel takes bf16 or f32, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"q, k_pool, v_pool dtypes differ: {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if h not in HEAD_DIMS:
        raise ValueError(f"paged kernel supports head_dim in {HEAD_DIMS}, got {h}")
    if (k_pool.shape != (num_pages, kh, ps, h) or v_pool.shape != k_pool.shape
            or n % kh or page_table.shape[0] != b):
        raise ValueError(f"bad shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pool.shape)} {tuple(v_pool.shape)} table "
                         f"{tuple(page_table.shape)}")
    if ps % 8:
        raise ValueError(f"page size must be a multiple of 8, got {ps}")
    if q_positions.shape != (b, t):
        raise ValueError(f"q_positions {tuple(q_positions.shape)} != {(b, t)}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()) or q.stride(-1) != 1:
        raise ValueError("pools must be contiguous, q contiguous in its head dim")
    if (q.data_ptr() | k_pool.data_ptr() | v_pool.data_ptr()) % 16 or any(
            st * q.element_size() % 16 for st in q.stride()[:3]):
        raise ValueError("q and the pools must be 16-byte aligned")
    validate_window(q, kh)
    # These may be freed when this returns, before the kernel runs: the
    # caching allocator reuses their memory only in this stream's order.
    tab = page_table.to(torch.int32).contiguous()
    qpos = q_positions.to(torch.int32).contiguous()
    kvl, ql = _lens(qpos, kv_lens, q_lens, np_tab * ps, t)
    kvl, ql = kvl.to(q.device).contiguous(), ql.to(q.device).contiguous()
    out = torch.empty((b, t, n, h), dtype=q.dtype, device=q.device)
    from ._build import kernel_fn

    err = kernel_fn("ragged_paged_attention", _ARGTYPES)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tab.data_ptr(),
        qpos.data_ptr(), kvl.data_ptr(), ql.data_ptr(), out.data_ptr(),
        b, t, n, kh, num_pages, ps, np_tab, h,
        *q.stride()[:3], *out.stride()[:3],
        int(sliding_window or 0), h ** -0.5, int(q.dtype == torch.bfloat16),
        launch_splits(b, kh, np_tab * ps, t, n // kh, q.dtype == torch.bfloat16,
                      sm_count(q.device)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA error {err}")
    count(_counter("ragged_paged_attention", t))
    return out


def ragged_paged_attention(
    q: torch.Tensor,            # [B, T, N, H] — ragged query windows
    k_pool: torch.Tensor,       # [P, K, PS, H] — one layer's page pool
    v_pool: torch.Tensor,       # [P, K, PS, H]
    page_table: torch.Tensor,   # [B, NP] int — pool page per logical page
    q_positions: torch.Tensor,  # [B, T] int
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,  # [B] int — live tokens per row
    q_lens: Optional[torch.Tensor] = None,   # [B] int — live query cols/row
) -> torch.Tensor:
    """Ragged flash attention reading K/V through per-row page tables;
    [B, T, N, H] in q's dtype. A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel."""
    validate_window(q, k_pool.shape[1])
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pool, v_pool, page_table,
                                            q_positions, sliding_window,
                                            kv_lens, q_lens)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu, not {q.device}")
    return ragged_paged_attention_cuda(q, k_pool, v_pool, page_table,
                                       q_positions, sliding_window, kv_lens,
                                       q_lens)


def ragged_paged_attention_quantized_plain(
    q: torch.Tensor,            # [B, T, N, H]
    k_pool: torch.Tensor,       # [P, K, PS, H] int8
    k_scale: torch.Tensor,      # [P, K, PS] f32
    v_pool: torch.Tensor,       # [P, K, PS, H] int8
    v_scale: torch.Tensor,      # [P, K, PS] f32
    page_table: torch.Tensor,   # [B, NP] int
    q_positions: torch.Tensor,  # [B, T] int
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,  # [B] int
    q_lens: Optional[torch.Tensor] = None,   # [B] int
) -> torch.Tensor:
    """The quantized kernel's contract in eager PyTorch
    (`paged_attention_reference_quantized`): gather value pages and scale
    columns through the clipped table, dequantize to q's dtype as the kernel
    does in its tile (`_dequant_page_streams`), then the plain ragged
    attention. Dead slots may hold any scale, NaN included."""
    k_rows = dequantize_kv(gather_pages(k_pool, page_table),
                           gather_page_scales(k_scale, page_table), q.dtype)
    v_rows = dequantize_kv(gather_pages(v_pool, page_table),
                           gather_page_scales(v_scale, page_table), q.dtype)
    return _attend_rows(q, k_rows, v_rows, q_positions, sliding_window, kv_lens,
                        q_lens)


def ragged_paged_attention_quantized_cuda(q, k_pool, k_scale, v_pool, v_scale,
                                          page_table, q_positions, sliding_window=None,
                                          kv_lens=None, q_lens=None) -> torch.Tensor:
    """Launch the quantized CUDA kernel (T == 1: the split-KV decode kernel;
    T > 1: the window kernel in bf16, the tile kernel in f32), one launch a
    call; raises on anything it does not take, and on a refused cluster
    launch."""
    b, t, n, h = q.shape
    num_pages, kh, ps = k_pool.shape[:3]
    np_tab = page_table.shape[1]
    for name, x in (("k_pool", k_pool), ("k_scale", k_scale), ("v_pool", v_pool),
                    ("v_scale", v_scale), ("page_table", page_table),
                    ("q_positions", q_positions)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged kernel takes bf16 or f32, got {q.dtype}")
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8 \
            or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"quantized pool must be int8 values and f32 scales, got "
                        f"{k_pool.dtype}, {k_scale.dtype}, {v_pool.dtype}, "
                        f"{v_scale.dtype}")
    if h not in HEAD_DIMS:
        raise ValueError(f"paged kernel supports head_dim in {HEAD_DIMS}, got {h}")
    if (k_pool.shape != (num_pages, kh, ps, h) or v_pool.shape != k_pool.shape
            or k_scale.shape != (num_pages, kh, ps) or v_scale.shape != k_scale.shape
            or n % kh or page_table.shape[0] != b):
        raise ValueError(f"bad shapes q {tuple(q.shape)} pools {tuple(k_pool.shape)} "
                         f"{tuple(v_pool.shape)} scales {tuple(k_scale.shape)} "
                         f"{tuple(v_scale.shape)} table {tuple(page_table.shape)}")
    if ps % 8:
        raise ValueError(f"page size must be a multiple of 8, got {ps}")
    if q_positions.shape != (b, t):
        raise ValueError(f"q_positions {tuple(q_positions.shape)} != {(b, t)}")
    if not all(x.is_contiguous() for x in (k_pool, k_scale, v_pool, v_scale)) \
            or q.stride(-1) != 1:
        raise ValueError("pools must be contiguous, q contiguous in its head dim")
    if (q.data_ptr() | k_pool.data_ptr() | v_pool.data_ptr()) % 16 \
            or (k_scale.data_ptr() | v_scale.data_ptr()) % 4 or any(
                st * q.element_size() % 16 for st in q.stride()[:3]):
        raise ValueError("q and the pools must be 16-byte aligned")
    validate_window(q, kh)
    tab = page_table.to(torch.int32).contiguous()
    qpos = q_positions.to(torch.int32).contiguous()
    kvl, ql = _lens(qpos, kv_lens, q_lens, np_tab * ps, t)
    kvl, ql = kvl.to(q.device).contiguous(), ql.to(q.device).contiguous()
    out = torch.empty((b, t, n, h), dtype=q.dtype, device=q.device)
    from ._build import kernel_fn

    err = kernel_fn("ragged_paged_attention_quantized", _Q_ARGTYPES)(
        q.data_ptr(), k_pool.data_ptr(), k_scale.data_ptr(), v_pool.data_ptr(),
        v_scale.data_ptr(), tab.data_ptr(), qpos.data_ptr(), kvl.data_ptr(),
        ql.data_ptr(), out.data_ptr(), b, t, n, kh, num_pages, ps, np_tab, h,
        *q.stride()[:3], *out.stride()[:3],
        int(sliding_window or 0), h ** -0.5, int(q.dtype == torch.bfloat16),
        launch_splits(b, kh, np_tab * ps, t, n // kh, q.dtype == torch.bfloat16,
                      sm_count(q.device)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"ragged_paged_attention_quantized launch failed: CUDA error {err}")
    count(_counter("ragged_paged_attention_quantized", t))
    return out


def ragged_paged_attention_quantized(
    q: torch.Tensor,            # [B, T, N, H] — ragged query windows
    k_pool: torch.Tensor,       # [P, K, PS, H] int8 — one layer's page pool
    k_scale: torch.Tensor,      # [P, K, PS] f32 — per-position K scales
    v_pool: torch.Tensor,       # [P, K, PS, H] int8
    v_scale: torch.Tensor,      # [P, K, PS] f32
    page_table: torch.Tensor,   # [B, NP] int
    q_positions: torch.Tensor,  # [B, T] int
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,  # [B] int
    q_lens: Optional[torch.Tensor] = None,   # [B] int
) -> torch.Tensor:
    """`ragged_paged_attention` over the int8 pool; [B, T, N, H] in q's
    dtype. A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel."""
    validate_window(q, k_pool.shape[1])
    if q.device.type == "cpu":
        return ragged_paged_attention_quantized_plain(
            q, k_pool, k_scale, v_pool, v_scale, page_table, q_positions,
            sliding_window, kv_lens, q_lens)
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention_quantized runs on cuda or cpu, not {q.device}")
    return ragged_paged_attention_quantized_cuda(
        q, k_pool, k_scale, v_pool, v_scale, page_table, q_positions, sliding_window,
        kv_lens, q_lens)


def sharded_ragged_paged_attention(
    mesh,
    q: torch.Tensor,            # [B, T, N/tp, H] — this rank's heads
    k_pool: torch.Tensor,       # [P, K/tp, PS, H] — this rank's pool block
    v_pool: torch.Tensor,
    page_table: torch.Tensor,   # [B, NP] — replicated
    q_positions: torch.Tensor,
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
    q_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The ragged paged kernel under a tp mesh (JAX
    `sharded_ragged_paged_attention`: a `shard_map` over the pool's KV-head
    axis, tables replicated). Each rank holds its tp-th of the pool's KV
    heads and of the query heads, so it launches the kernel on that block;
    heads never meet, no collective."""
    from .dispatch import paged_attention

    validate_window(q, k_pool.shape[1])
    return paged_attention(q, k_pool, v_pool, page_table, q_positions,
                           sliding_window, kv_lens, q_lens)


def sharded_ragged_paged_attention_quantized(
    mesh,
    q: torch.Tensor,
    k_pool: torch.Tensor,       # [P, K/tp, PS, H] int8
    k_scale: torch.Tensor,      # [P, K/tp, PS] f32
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    q_positions: torch.Tensor,
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
    q_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`sharded_ragged_paged_attention` over the int8 pool and its scales."""
    from .dispatch import paged_attention_quantized

    validate_window(q, k_pool.shape[1])
    return paged_attention_quantized(q, k_pool, k_scale, v_pool, v_scale,
                                     page_table, q_positions, sliding_window,
                                     kv_lens, q_lens)

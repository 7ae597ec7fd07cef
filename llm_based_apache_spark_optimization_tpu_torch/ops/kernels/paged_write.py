"""Fused page write: the CUDA kernels' wrappers and their plain versions.

Counterpart of the JAX package's `ops/pallas/paged_write.py`
(`fused_page_write`, `_coords`, `paged_write_reference`, and into the int8
pool `fused_page_write_quantized`, `paged_write_reference_quantized`): fresh K/V slivers
[B, T, K, H] land in the pools [L, P, K, PS, H] at a static layer, through
the page table, in place. A sliver is dropped (writes nothing) through a
sentinel table entry, past the row's pages, at a negative position, and,
with `q_lens`, at a window column at or past the row's live length. One
kernel, `csrc/page_write.cuh`, serves both pools through two C entries:
`csrc/fused_page_write.cu` (a copy into a bf16 or f32 pool) and
`csrc/fused_page_write_quantized.cu` (each sliver quantized to int8 values
plus one f32 scale per (position, kv head) on the way in); both match their
plain versions bit for bit. The kernel is a programmatic dependent launch:
it may start while the kernel before it (the RoPE of k, or this wrapper's
int32 casts) is still running, and waits for it before its first read.

A tensor on the CPU goes to `fused_page_write_plain`; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..quant import quantize_kv
from .launches import count

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 10 + [_P]
_Q_ARGTYPES = [_P] * 9 + [_I] * 10 + [_P]
# The kernel can load a row's page table up front, beside its position, when
# the table has at most this many pages (two entries a lane of a warp);
# otherwise it loads the one entry the position selects, after it.
TABLE_PREFETCH_PAGES = 64


def table_prefetch(np_tab: int, quantized: bool) -> bool:
    """Whether the kernel prefetches a table of `np_tab` pages: for the copy
    into a bf16 or f32 pool, which has nothing to do while the entry's load
    is in flight. The int8 pool quantizes meanwhile, which outlasts the load
    (on an H100 the prefetch made it slower; PERF.md)."""
    return not quantized and np_tab <= TABLE_PREFETCH_PAGES


def page_coords(
    positions: torch.Tensor,   # [B, T] int
    page_table: torch.Tensor,  # [B, NP] int
    page_size: int,
    num_pages: int,
    q_lens: Optional[torch.Tensor] = None,  # [B] int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pages [B, T], offs [B, T]) int64: pool page and in-page offset of
    each written position (`_coords`). Dropped positions get page ==
    num_pages: past the row or negative (they must drop, not clip onto the
    row's last page), through a sentinel entry, or at a dead window
    column."""
    pos = positions.long()
    np_tab = page_table.shape[1]
    page_idx = torch.div(pos, page_size, rounding_mode="floor")
    pages = torch.gather(page_table.long(), 1, page_idx.clamp(0, np_tab - 1))
    dead = (page_idx < 0) | (page_idx >= np_tab) | (pages < 0) | (pages >= num_pages)
    if q_lens is not None:
        t = pos.shape[1]
        dead = dead | (torch.arange(t, device=pos.device)[None, :]
                       >= q_lens.long().clamp(0, t)[:, None])
    pages = torch.where(dead, num_pages, pages)
    return pages, pos % page_size


def fused_page_write_plain(
    kp: torch.Tensor,          # [L, P, K, PS, H]
    vp: torch.Tensor,          # [L, P, K, PS, H]
    k_new: torch.Tensor,       # [B, T, K, H]
    v_new: torch.Tensor,       # [B, T, K, H]
    positions: torch.Tensor,   # [B, T] int
    page_table: torch.Tensor,  # [B, NP] int
    layer: int,
    q_lens: Optional[torch.Tensor] = None,  # [B] int
) -> None:
    """The kernel's contract in eager PyTorch (`paged_write_reference` for
    K and for V): one index_put per pool over the kept slivers. Selecting
    the kept slivers synchronises with the device."""
    num_pages, ps = kp.shape[1], kp.shape[3]
    pages, offs = page_coords(positions, page_table, ps, num_pages, q_lens)
    bi, ti = (pages < num_pages).nonzero(as_tuple=True)
    pg, of = pages[bi, ti], offs[bi, ti]
    kp[layer, pg, :, of] = k_new[bi, ti].to(kp.dtype)
    vp[layer, pg, :, of] = v_new[bi, ti].to(vp.dtype)


def fused_page_write_cuda(kp, vp, k_new, v_new, positions, page_table, layer,
                          q_lens=None) -> None:
    """Launch the CUDA kernel; raises on anything it does not take."""
    n_layers, num_pages, kh, ps, h = kp.shape
    b, t = positions.shape
    for name, x in (("vp", vp), ("k_new", k_new), ("v_new", v_new),
                    ("positions", positions), ("page_table", page_table)):
        if x.device != kp.device:
            raise ValueError(f"{name} is on {x.device}, kp on {kp.device}")
    if kp.dtype not in (torch.bfloat16, torch.float32) or vp.dtype != kp.dtype:
        raise TypeError(f"page write takes bf16 or f32 pools, got {kp.dtype}, "
                        f"{vp.dtype}")
    if vp.shape != kp.shape or k_new.shape != (b, t, kh, h) \
            or v_new.shape != k_new.shape or page_table.shape[0] != b:
        raise ValueError(f"bad shapes pools {tuple(kp.shape)} k_new "
                         f"{tuple(k_new.shape)} v_new {tuple(v_new.shape)} "
                         f"positions {tuple(positions.shape)} table "
                         f"{tuple(page_table.shape)}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside [0, {n_layers})")
    if h not in (64, 128):
        raise ValueError(f"page write supports head_dim 64 or 128, got {h}")
    if not (kp.is_contiguous() and vp.is_contiguous()) \
            or (kp.data_ptr() | vp.data_ptr()) % 16:
        raise ValueError("pools must be contiguous and 16-byte aligned")
    # These may be freed when this returns, before the kernel runs: the
    # caching allocator reuses their memory only in this stream's order.
    kn = k_new.to(kp.dtype).contiguous()
    vn = v_new.to(kp.dtype).contiguous()
    pos = positions.to(torch.int32).contiguous()
    tab = page_table.to(torch.int32).contiguous()
    ql = None if q_lens is None else q_lens.to(torch.int32).to(kp.device).contiguous()
    if (kn.data_ptr() | vn.data_ptr()) % 16:
        raise ValueError("k_new and v_new must be 16-byte aligned")
    from ._build import kernel_fn

    err = kernel_fn("fused_page_write", _ARGTYPES)(
        kn.data_ptr(), vn.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        pos.data_ptr(), tab.data_ptr(), None if ql is None else ql.data_ptr(),
        b, t, page_table.shape[1], num_pages, kh, ps, h, layer,
        kp.element_size(), int(table_prefetch(page_table.shape[1], False)),
        torch.cuda.current_stream(kp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_page_write launch failed: CUDA error {err}")
    count("fused_page_write")


def fused_page_write(
    kp: torch.Tensor,          # [L, P, K, PS, H] — shared K page pool
    vp: torch.Tensor,          # [L, P, K, PS, H]
    k_new: torch.Tensor,       # [B, T, K, H] fresh K sliver
    v_new: torch.Tensor,       # [B, T, K, H]
    positions: torch.Tensor,   # [B, T] int absolute positions
    page_table: torch.Tensor,  # [B, NP] int
    layer: int,
    q_lens: Optional[torch.Tensor] = None,  # [B] int live cols per row
) -> None:
    """Write K and V slivers into `kp[layer]`, `vp[layer]` through the
    page table, in place; returns nothing. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel."""
    if kp.device.type == "cpu":
        return fused_page_write_plain(kp, vp, k_new, v_new, positions,
                                      page_table, layer, q_lens)
    if kp.device.type != "cuda":
        raise ValueError(f"fused_page_write runs on cuda or cpu, not {kp.device}")
    return fused_page_write_cuda(kp, vp, k_new, v_new, positions, page_table,
                                 layer, q_lens)


def fused_page_write_quantized_plain(
    kp: torch.Tensor,          # [L, P, K, PS, H] int8
    kps: torch.Tensor,         # [L, P, K, PS] f32
    vp: torch.Tensor,          # [L, P, K, PS, H] int8
    vps: torch.Tensor,         # [L, P, K, PS] f32
    k_new: torch.Tensor,       # [B, T, K, H]
    v_new: torch.Tensor,       # [B, T, K, H]
    positions: torch.Tensor,   # [B, T] int
    page_table: torch.Tensor,  # [B, NP] int
    layer: int,
    q_lens: Optional[torch.Tensor] = None,  # [B] int
) -> None:
    """The quantizing kernel's contract in eager PyTorch
    (`paged_write_reference_quantized`): `quantize_kv` on the slivers, then
    the value and scale index_puts over the kept slivers."""
    num_pages, ps = kp.shape[1], kp.shape[3]
    pages, offs = page_coords(positions, page_table, ps, num_pages, q_lens)
    bi, ti = (pages < num_pages).nonzero(as_tuple=True)
    pg, of = pages[bi, ti], offs[bi, ti]
    for pool, scales, new in ((kp, kps, k_new), (vp, vps, v_new)):
        q = quantize_kv(new[bi, ti])
        pool[layer, pg, :, of] = q["q8"]
        scales[layer, pg, :, of] = q["s"]


def fused_page_write_quantized_cuda(kp, kps, vp, vps, k_new, v_new, positions,
                                    page_table, layer, q_lens=None) -> None:
    """Launch the quantizing CUDA kernel; raises on anything it does not
    take."""
    n_layers, num_pages, kh, ps, h = kp.shape
    b, t = positions.shape
    for name, x in (("kps", kps), ("vp", vp), ("vps", vps), ("k_new", k_new),
                    ("v_new", v_new), ("positions", positions),
                    ("page_table", page_table)):
        if x.device != kp.device:
            raise ValueError(f"{name} is on {x.device}, kp on {kp.device}")
    if kp.dtype != torch.int8 or vp.dtype != torch.int8 \
            or kps.dtype != torch.float32 or vps.dtype != torch.float32:
        raise TypeError(f"quantized pools must be int8 values and f32 scales, got "
                        f"{kp.dtype}, {kps.dtype}, {vp.dtype}, {vps.dtype}")
    if k_new.dtype not in (torch.bfloat16, torch.float32) or v_new.dtype != k_new.dtype:
        raise TypeError(f"slivers must be bf16 or f32, got {k_new.dtype}, {v_new.dtype}")
    if (vp.shape != kp.shape or kps.shape != kp.shape[:4] or vps.shape != kps.shape
            or k_new.shape != (b, t, kh, h) or v_new.shape != k_new.shape
            or page_table.shape[0] != b):
        raise ValueError(f"bad shapes pools {tuple(kp.shape)} scales {tuple(kps.shape)} "
                         f"k_new {tuple(k_new.shape)} v_new {tuple(v_new.shape)} "
                         f"positions {tuple(positions.shape)} table "
                         f"{tuple(page_table.shape)}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside [0, {n_layers})")
    if h not in (64, 128):
        raise ValueError(f"quantizing page write supports head_dim 64 or 128, got {h}")
    if not all(x.is_contiguous() for x in (kp, kps, vp, vps)) \
            or (kp.data_ptr() | vp.data_ptr()) % 16:
        raise ValueError("pools must be contiguous and 16-byte aligned")
    kn, vn = k_new.contiguous(), v_new.contiguous()
    pos = positions.to(torch.int32).contiguous()
    tab = page_table.to(torch.int32).contiguous()
    ql = None if q_lens is None else q_lens.to(torch.int32).to(kp.device).contiguous()
    if (kn.data_ptr() | vn.data_ptr()) % 16:
        raise ValueError("k_new and v_new must be 16-byte aligned")
    from ._build import kernel_fn

    err = kernel_fn("fused_page_write_quantized", _Q_ARGTYPES)(
        kn.data_ptr(), vn.data_ptr(), kp.data_ptr(), kps.data_ptr(), vp.data_ptr(),
        vps.data_ptr(), pos.data_ptr(), tab.data_ptr(),
        None if ql is None else ql.data_ptr(),
        b, t, page_table.shape[1], num_pages, kh, ps, h, layer, kn.element_size(),
        int(table_prefetch(page_table.shape[1], True)),
        torch.cuda.current_stream(kp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_page_write_quantized launch failed: CUDA error {err}")
    count("fused_page_write_quantized")


def fused_page_write_quantized(
    kp: torch.Tensor,          # [L, P, K, PS, H] int8 — shared K page pool
    kps: torch.Tensor,         # [L, P, K, PS] f32 — per-position K scales
    vp: torch.Tensor,          # [L, P, K, PS, H] int8
    vps: torch.Tensor,         # [L, P, K, PS] f32
    k_new: torch.Tensor,       # [B, T, K, H] fresh bf16/f32 K sliver
    v_new: torch.Tensor,       # [B, T, K, H]
    positions: torch.Tensor,   # [B, T] int absolute positions
    page_table: torch.Tensor,  # [B, NP] int
    layer: int,
    q_lens: Optional[torch.Tensor] = None,  # [B] int live cols per row
) -> None:
    """Quantize K and V slivers and write values and scales into
    `kp[layer]`, `kps[layer]`, `vp[layer]`, `vps[layer]` through the page
    table, in place; returns nothing. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel."""
    if kp.device.type == "cpu":
        return fused_page_write_quantized_plain(kp, kps, vp, vps, k_new, v_new,
                                                positions, page_table, layer, q_lens)
    if kp.device.type != "cuda":
        raise ValueError(
            f"fused_page_write_quantized runs on cuda or cpu, not {kp.device}")
    return fused_page_write_quantized_cuda(kp, kps, vp, vps, k_new, v_new, positions,
                                           page_table, layer, q_lens)

"""Paged KV cache: a shared device page pool + host-side page allocator.

Counterpart of the JAX package's `engine/paged_kv.py`:

    pool:        {"kp": [L, P, K, page_size, H], "vp": [L, P, K, page_size, H]}
                 int8 pool (kv_quant="int8"): int8 "kp"/"vp" plus f32
                 per-position scales "kps"/"vps": [L, P, K, page_size]
    page table:  [slots, pages_per_slot] int32 — per-slot logical->pool map

- The pool is sized to a device-memory budget (`pages_for_budget`), not to
  slots x S_max: a request holds ceil(need / page_size) pages.
- `PageAllocator` is pure host bookkeeping (free list + per-page
  refcounts). Refcounts make prefix-cache hits zero-copy: a hit maps the
  cached prefix's pages into the new slot's table instead of copying K/V.
- Copy-on-write: a shared page is never written in place; a writer whose
  range starts inside one first copies that page and remaps.
- The unmapped sentinel is `num_pages` (one past the pool). The page-write
  kernel and its plain version drop writes through it, and the attention
  kernel never reads it (its plain version clips it to a real page whose
  content the mask hides).
- `export_pages` copies pool pages into a host blob, one numpy stack per
  pool array, scales included (the spill format of the scheduler's
  preemption); `import_pages` writes a blob back into pool pages, bit for
  bit. bf16 stacks travel as their 16-bit patterns (numpy has no bf16).
- Under a tp mesh each rank's pool holds its tp-th of the KV heads, and a
  blob keeps the unsharded layout all the same: the export gathers every
  rank's head block to the mesh's rank 0, the import sends rank 0's blob
  to every rank, which writes its own block. So a tp=2 replica's blob is
  what a tp=1 replica exports from the same pool contents, and a replica
  of any tp imports it. Under sp every sp rank holds the same heads as its
  sp = 0 peer (the pool is whole on each sp rank): the export reads the
  sp = 0 ranks' heads alone, and the import writes the blob's heads on
  every sp rank.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.configs import LlamaConfig


class PageAccountingError(RuntimeError):
    """A refcount went negative or a freed page was freed again — the
    allocator's invariants are broken and the pool can no longer be
    trusted (this is a bug, not an operational condition)."""


def default_page_size() -> int:
    """LSOT_KV_PAGE_SIZE (default 64). Must be a positive multiple of 8."""
    try:
        ps = int(os.environ.get("LSOT_KV_PAGE_SIZE", "64"))
    except ValueError:
        ps = 64
    if ps <= 0 or ps % 8:
        raise ValueError(
            f"LSOT_KV_PAGE_SIZE must be a positive multiple of 8, got {ps}"
        )
    return ps


def _check_kv_quant(kv_quant: Optional[str]) -> None:
    if kv_quant not in (None, "int8"):
        raise ValueError(f"kv_quant must be None or 'int8', got {kv_quant!r}")


def page_bytes(cfg: LlamaConfig, page_size: int, itemsize: int = 2,
               kv_quant: Optional[str] = None) -> int:
    """Device bytes of ONE pool page across all layers (K and V). An int8
    pool costs H int8 values plus one f32 scale per position (`itemsize` is
    then ignored)."""
    _check_kv_quant(kv_quant)
    per_pos = cfg.head_dim + 4 if kv_quant else cfg.head_dim * itemsize
    return 2 * cfg.num_layers * cfg.num_kv_heads * page_size * per_pos


def pages_for_budget(cfg: LlamaConfig, budget_bytes: int, page_size: int,
                     itemsize: int = 2, kv_quant: Optional[str] = None) -> int:
    """Pool pages a device-memory budget buys (an int8 pool about twice as
    many)."""
    return max(0, int(budget_bytes) // page_bytes(cfg, page_size, itemsize, kv_quant))


def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    """Pages covering n_tokens positions (ceil)."""
    return -(-int(n_tokens) // int(page_size))


def init_page_pool(
    cfg: LlamaConfig, num_pages: int, page_size: int,
    dtype: torch.dtype = torch.bfloat16, device=None,
    kv_quant: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """The zeroed shared page pool on `device` (default CUDA): per
    (page, kv head) a contiguous [page_size, H] tile. `kv_quant="int8"`
    stores int8 values plus f32 per-position scales "kps"/"vps"
    [L, P, K, page_size], initialised to 1 so an unwritten page dequantizes
    to zeros, never NaN."""
    if page_size <= 0 or page_size % 8:
        raise ValueError(
            f"page_size must be a positive multiple of 8, got {page_size}"
        )
    _check_kv_quant(kv_quant)
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size,
             cfg.head_dim)
    dev = resolve_device(device)
    if kv_quant:
        return {"kp": torch.zeros(shape, dtype=torch.int8, device=dev),
                "kps": torch.ones(shape[:-1], dtype=torch.float32, device=dev),
                "vp": torch.zeros(shape, dtype=torch.int8, device=dev),
                "vps": torch.ones(shape[:-1], dtype=torch.float32, device=dev)}
    return {"kp": torch.zeros(shape, dtype=dtype, device=dev),
            "vp": torch.zeros(shape, dtype=dtype, device=dev)}


def pack_prefill_pages(
    cache: Dict[str, torch.Tensor], page_size: int, pages_per_row: int,
    kv_quant: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Contiguous prefill cache {"k","v"} [L, B, K, S, H] -> paged cache
    {"kp","vp","ptab"} with identity per-row tables (row b owns pool pages
    [b*ppr, (b+1)*ppr)). The engine's prefill -> paged decode handoff.
    `kv_quant="int8"` quantizes on the way (`ops.quant.quantize_kv`: int8
    values and one f32 scale a position) into the int8 pool {"kp", "kps",
    "vp", "vps", "ptab"}; pool scales the cache does not cover stay 1."""
    _check_kv_quant(kv_quant)
    k = cache["k"]
    n_layers, b, kh, s, h = k.shape
    ppr = int(pages_per_row)
    s_pad = s + (-s % page_size)
    np0 = s_pad // page_size
    if np0 > ppr:
        raise ValueError(
            f"prefill cache ({s} positions = {np0} pages) exceeds "
            f"pages_per_row={ppr}"
        )
    ptab = (torch.arange(b, dtype=torch.int32, device=k.device)[:, None] * ppr
            + torch.arange(ppr, dtype=torch.int32, device=k.device)[None, :])

    def pack(arr, fill=0.0):
        # Values [L, B, K, S, H], or scales [L, B, K, S] (no H axis).
        tail = arr.shape[4:]
        a = torch.nn.functional.pad(arr, (0, 0) * len(tail) + (0, s_pad - s),
                                    value=fill)
        a = a.reshape(n_layers, b, kh, np0, page_size, *tail).transpose(2, 3)
        pool = torch.full((n_layers, b, ppr, kh, page_size, *tail), fill,
                          dtype=arr.dtype, device=arr.device)
        pool[:, :, :np0] = a  # [L, B, ppr, ...] is the identity-table layout
        return pool.reshape(n_layers, b * ppr, kh, page_size, *tail)

    if kv_quant:
        from ..ops.quant import quantize_kv

        kq, vq = quantize_kv(cache["k"]), quantize_kv(cache["v"])
        return {"kp": pack(kq["q8"]), "kps": pack(kq["s"], 1.0),
                "vp": pack(vq["q8"]), "vps": pack(vq["s"], 1.0), "ptab": ptab}
    return {"kp": pack(cache["k"]), "vp": pack(cache["v"]), "ptab": ptab}


def export_pages(pool: Dict[str, torch.Tensor],
                 page_ids: Sequence[int]) -> Tuple[np.ndarray, ...]:
    """Copy pool pages into a host blob: one `[L, n, K, page_size(, H)]`
    numpy array per pool array in the pool's own order ((kp, vp), or (kp,
    kps, vp, vps) for the int8 pool, so the scales travel beside their
    values and a restore is bit-exact). The arrays are copies: the blob
    stays valid after the pages are freed or overwritten. On the card the
    gather is enqueued on the current stream, after the rounds that wrote
    the pages, and copied into pinned host buffers; the host then waits for
    that copy alone (an event), not for the whole device."""
    return export_pages_start(pool, page_ids)()


def export_pages_start(pool: Dict[str, torch.Tensor], page_ids: Sequence[int],
                       mesh=None) -> Callable[[], Tuple[np.ndarray, ...]]:
    """`export_pages` in two halves: this call enqueues the gather and the
    copy to pinned host buffers; the function it returns waits for that
    copy and returns the blob. A caller issuing under a dispatch lock waits
    outside it. Under a `mesh` every rank of it calls this with the same
    pages (module docstring): the sp = 0 ranks' heads are gathered to rank
    0, whose function returns the whole blob; the others' return an empty
    tuple."""
    from ..ops.common import all_gather, axis_index

    if axis_index(mesh, "sp"):
        return lambda: ()  # a replica of its sp = 0 peer's heads
    dev = next(iter(pool.values())).device
    idx = torch.tensor(list(page_ids), dtype=torch.int64, device=dev)
    # [L, n, K, page_size(, H)]: the KV-head axis is 2 in every pool array.
    stacks = [all_gather(arr[:, idx], mesh, "tp", dim=2) for arr in pool.values()]
    if axis_index(mesh, "tp"):
        return lambda: ()  # rank 0 holds the blob
    done = None
    if dev.type == "cuda":
        host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in stacks]
        for h, x in zip(host, stacks):
            h.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        stacks = host

    def finish() -> Tuple[np.ndarray, ...]:
        if done is not None:
            done.synchronize()
        return tuple((x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
                     for x in stacks)

    return finish


def import_pages(pool: Dict[str, torch.Tensor], page_ids: Sequence[int],
                 stacks: Optional[Sequence[np.ndarray]], mesh=None) -> None:
    """Write an `export_pages` blob into pool pages `page_ids` (freshly
    allocated, exclusive), in place: one indexed copy per pool array. On
    the card the host arrays go through pinned buffers without a
    synchronise, ordered on the current stream before any later round.
    Under a `mesh` every rank of it calls this with the same pages: rank 0
    brings the whole blob, the others None; the blob goes from rank 0 to
    the other sp ranks of tp index 0, then from each of those to its tp
    peers, and each rank writes its own block of the heads."""
    from ..ops.common import axis_index, axis_size, broadcast

    dev = next(iter(pool.values())).device
    idx = torch.tensor(list(page_ids), dtype=torch.int64, device=dev)
    tp, r = axis_size(mesh, "tp"), axis_index(mesh, "tp")
    primary = r == 0 and axis_index(mesh, "sp") == 0
    staged = mesh is not None and mesh.staged
    for i, arr in enumerate(pool.values()):
        shape = (arr.shape[0], len(page_ids), arr.shape[2] * tp, *arr.shape[3:])
        src = like = None
        if primary:
            src = torch.from_numpy(np.ascontiguousarray(stacks[i]))
            if src.dtype != arr.dtype:
                src = src.view(arr.dtype)  # bf16 from its 16-bit patterns
            if dev.type == "cuda" and not staged:
                src = src.pin_memory().to(dev, non_blocking=True)
        else:
            like = torch.empty(shape, dtype=arr.dtype,
                               device="cpu" if staged else dev)
        if r == 0:
            src = broadcast(src, mesh, "sp", like=like)
        if tp > 1:
            kl = arr.shape[2]
            src = broadcast(src, mesh, "tp", like=like).narrow(2, r * kl, kl)
        if src.device != dev:
            src = (src.pin_memory().to(dev, non_blocking=True)
                   if dev.type == "cuda" else src.to(dev))
        arr[:, idx] = src


def handoff_bytes(stacks: Sequence[np.ndarray]) -> int:
    """Host bytes of one `export_pages` blob."""
    return int(sum(int(np.asarray(s).nbytes) for s in stacks))


def blob_meta(stacks: Sequence[np.ndarray]) -> dict:
    """Self-description of one `export_pages` blob: array count, pages and
    page size read from its own geometry ([L, n, K, page_size(, H)]),
    whether it carries int8 scales (4 arrays), and its bytes."""
    arrs = [np.asarray(s) for s in stacks]
    if not arrs:
        return {"arrays": 0, "pages": 0, "page_size": 0, "nbytes": 0,
                "quantized": False}
    lead = arrs[0]
    return {
        "arrays": len(arrs),
        "pages": int(lead.shape[1]) if lead.ndim >= 2 else 0,
        "page_size": int(lead.shape[3]) if lead.ndim >= 4 else 0,
        "nbytes": int(sum(a.nbytes for a in arrs)),
        "quantized": len(arrs) == 4,
    }


class PageAllocator:
    """Host-side page accounting: free list + per-page refcounts.

    All methods are O(pages touched); nothing here talks to the device.
    Thread-unsafe by design — the scheduler's worker thread is the only
    caller.

    Invariants:
    - every page is either on the free list (refcount 0) or live
      (refcount >= 1) — never both, never neither;
    - `release` on a refcount-0 page raises (double free is a bug);
    - a shared page (refcount > 1) is never handed out by `alloc`.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0:
            raise ValueError(f"num_pages must be positive, got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: "deque[int]" = deque(range(self.num_pages))
        self._ref = [0] * self.num_pages
        #: zero-copy shares taken (prefix publish + hit mappings).
        self.shares = 0
        #: copy-on-write page copies (non-page-aligned boundaries only).
        self.cow_copies = 0
        #: Pages withheld from allocation (still free, refcount 0).
        self.withheld = 0
        #: Pressure-relief counters: victim preemptions, watermark
        #: evictions, and pages spilled to and restored from the host.
        self.preemptions = 0
        self.evictions = 0
        self.spilled_pages = 0
        self.restored_pages = 0
        #: Per-page counts of resident prefix-cache entries mapping the page.
        self._prefix_ref = [0] * self.num_pages
        self._prefix_resident = 0

    # ------------------------------------------------------------- queries

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_available(self) -> int:
        """Free pages grantable right now: the free list minus the
        withheld reserve."""
        return max(0, len(self._free) - self.withheld)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def pages_shared(self) -> int:
        """Pages currently mapped by more than one owner."""
        return sum(1 for r in self._ref if r > 1)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def is_shared(self, page: int) -> bool:
        return self._ref[page] > 1

    def can_alloc(self, n: int) -> bool:
        return self.pages_available >= n

    # ----------------------------------------------------------- mutations

    def withhold(self, n: int) -> None:
        """Reserve `n` free pages against allocation (they stay on the
        free list); `withhold(0)` lifts it."""
        if n < 0:
            raise ValueError(f"withhold({n})")
        self.withheld = min(int(n), self.num_pages)

    def note_preempt(self) -> None:
        self.preemptions += 1

    def note_evictions(self, n: int) -> None:
        self.evictions += int(n)

    def note_spill(self, n: int) -> None:
        self.spilled_pages += int(n)

    def note_restore(self, n: int) -> None:
        self.restored_pages += int(n)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh exclusive pages, or None (all-or-nothing: a request that
        cannot fully fit must not hold a partial grab)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if self.pages_available < n:
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            if self._ref[p] != 0:
                raise PageAccountingError(
                    f"free-list page {p} has refcount {self._ref[p]}"
                )
            self._ref[p] = 1
        return pages

    def share(self, pages: List[int], count: bool = True) -> None:
        """Take one additional reference on each page (zero-copy mapping).
        `count=False` for transient holds that must not count as shares."""
        for p in pages:
            if self._ref[p] <= 0:
                raise PageAccountingError(
                    f"share of dead page {p} (refcount {self._ref[p]})"
                )
        for p in pages:
            self._ref[p] += 1
        if count:
            self.shares += len(pages)

    def note_shares(self, n: int) -> None:
        """Promote n transient holds to counted zero-copy mappings."""
        self.shares += n

    def prefix_hold(self, pages: List[int]) -> None:
        """Mark pages as mapped by one more resident prefix-cache entry."""
        for p in pages:
            if self._prefix_ref[p] == 0:
                self._prefix_resident += 1
            self._prefix_ref[p] += 1

    def prefix_drop(self, pages: List[int]) -> None:
        """Drop one prefix-entry reference per page (entry eviction)."""
        for p in pages:
            if self._prefix_ref[p] <= 0:
                raise PageAccountingError(
                    f"prefix_drop of page {p} with no prefix reference"
                )
            self._prefix_ref[p] -= 1
            if self._prefix_ref[p] == 0:
                self._prefix_resident -= 1

    @property
    def prefix_resident_pages(self) -> int:
        """Unique pages held by at least one prefix-cache entry."""
        return self._prefix_resident

    def release(self, pages: List[int]) -> List[int]:
        """Drop one reference per page; pages reaching refcount 0 return to
        the free list. Returns the freed subset."""
        for p in pages:
            if self._ref[p] <= 0:
                raise PageAccountingError(
                    f"release of dead page {p} (refcount {self._ref[p]})"
                )
        freed = []
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def cow(self, page: int) -> Optional[int]:
        """Copy-on-write: exchange one reference on a SHARED page for a
        fresh exclusive page (the caller copies the content first). Returns
        `page` when it is already exclusive, None when no page is free."""
        if self._ref[page] <= 0:
            raise PageAccountingError(
                f"cow of dead page {page} (refcount {self._ref[page]})"
            )
        if self._ref[page] == 1:
            return page
        fresh = self.alloc(1)
        if fresh is None:
            return None
        self.release([page])
        self.cow_copies += 1
        return fresh[0]

    def note_cow(self) -> None:
        """Count a boundary-page copy made outside the refcount exchange."""
        self.cow_copies += 1

    def stats(self) -> Dict[str, int]:
        """Occupancy and sharing counters: a leaked page shows up as
        pages_in_use that never returns to pages_free."""
        return {
            "page_size": self.page_size,
            "pages_total": self.num_pages,
            "pages_free": self.pages_free,
            "pages_in_use": self.pages_in_use,
            "pages_shared": self.pages_shared,
            "pages_withheld": self.withheld,
            "prefix_resident_pages": self.prefix_resident_pages,
            "zero_copy_shares": self.shares,
            "cow_copies": self.cow_copies,
            "preemptions": self.preemptions,
            "evictions": self.evictions,
            "spilled_pages": self.spilled_pages,
            "restored_pages": self.restored_pages,
        }

    def check(self) -> None:
        """Assert the free-list/refcount partition."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise PageAccountingError("duplicate page on the free list")
        for p in range(self.num_pages):
            if (p in free) != (self._ref[p] == 0):
                raise PageAccountingError(
                    f"page {p}: refcount {self._ref[p]} vs free-list "
                    f"membership {p in free}"
                )

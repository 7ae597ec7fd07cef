"""Continuous-batching scheduler, over a contiguous KV cache or a paged KV
pool, and its backend.

Counterpart of the JAX package's `serve/scheduler.py` (the core of
`ContinuousBatchingScheduler`, both layouts, and `SchedulerBackend`).
Concurrent requests share one decode batch on the device, a fixed set of
`num_slots` sequence slots. Two KV layouts:

- `kv_layout="contiguous"` (the default, as in the JAX package and the
  reference app): one row a slot, `{"k", "v"}: [L, slots, K, S, H]`
  (engine/kvcache.py). Prefix cache: content-keyed blocks of the smallest
  bucket, each a device copy of the publisher's K/V (`[L, 1, K, pblock,
  H]`), restored into a new slot's row by device-to-device copies.
- `kv_layout="paged"`: K/V live in a shared page pool `[L, P, K, PS, H]`
  sized to a device-memory budget; each slot maps its logical pages
  through a row of the device page table `[slots, NP]`
  (engine/paged_kv.py). Admission allocates the request's whole envelope
  (bucketed prompt + budget + overshoot), all or nothing; a request the
  pool cannot hold yet waits in `_page_wait` until retirements free pages.
  Prefix cache: entries that REFERENCE pool pages (refcounts), so a hit
  maps the cached prefix into the new slot's table with no copy; a page is
  copied only where a matched prefix ends mid-page (copy-on-write).

In both, a block is published on its second sighting and hit from the
third, and reuse stops on block boundaries.

- Chunked prefill: one prompt chunk (a power-of-two bucket up to
  `prompt_bucket`) for up to 8 same-bucket admissions per forward. The
  contiguous layout runs the forward over the slots' own cache rows, one
  layer at a time (`forward(rows=...)`: no view of all layers is built);
  the paged layout over contiguous row views gathered from the pool, then
  a windowed scatter of the chunk's K/V back through the slots' pages.
  The final chunk samples the first token.
- Decode rounds: `decode_chunk` T=1 steps of the whole slot batch, with
  `kv_lens = pos + 1` for active slots and 0 for parked ones (parked slots
  read nothing and write at the parking position, `max_seq - 1`, which no
  query can see). Contiguous: each layer's flash GQA decode kernel over
  the slots' rows; paged: the fused page write and ragged paged attention
  kernels.
- Deadlines: a request submitted with `deadline_s` fails with
  `DeadlineExceeded` at admission if it expired while queued (or waiting
  for pages), or at the next harvest once in flight.
- int8 KV (`kv_quant="int8"`). Contiguous: int8 values plus one f32 scale
  a slot, `{"k8", "v8", "ks", "vs"}` with scales `[L, slots, K, S]`; decode
  writes quantize each fresh sliver and read through the quantized flash
  decode kernel; a prefill chunk dequantizes its rows to the compute dtype
  and quantizes only its own window back, so every entry is quantized
  once. Paged: the pool holds int8 values plus one f32
  scale per (layer, page, kv head, position), `"kps"`/`"vps"`
  [L, P, K, PS], about twice the tokens per device byte. Decode writes
  through the quantizing page-write kernel and reads through the quantized
  ragged paged attention kernel, which dequantizes in its tile. A prefill
  chunk dequantizes its gathered row views to the compute dtype (values
  and scales cast to it, then multiplied in it, as the JAX scheduler does)
  and requantizes only its own window on the way back, so every entry is
  quantized exactly once. Copy-on-write copies the scale pages with the
  values.
- Weights may be int4 trees (`ops.quant.quantize_params_int4`): every
  block matmul then runs the int4 matmul kernel on the card.
- Per-row sampling knobs and per-request streams (ops/sampling
  `sample_runtime`): slot s samples its i-th token from (seed, i), so a
  request replays the same tokens whatever shares the batch.
- Async issue/harvest: rounds, chunks and per-slot state updates are
  enqueued on one CUDA stream without waiting; host-to-device data goes
  through fresh pinned buffers (`non_blocking`). The host synchronises once
  per round, in `_harvest_round`, one round behind the issue frontier
  (`_harvest_lag`), so the transfer overlaps the next round. Page-table
  rows are updated by device ops enqueued after the rounds that read the
  old rows, so stream order gives in-flight rounds the table they were
  issued with.

One worker thread owns all device work. It enters `torch.inference_mode`
and the scheduler's device and stream itself: both are per-thread state.

- Liveness and chaos seams: the event loop stamps `heartbeat`
  (serve/watchdog.py) at the top of every iteration and ticks it at every
  harvested round, which the crash supervisor's watchdog reads
  (serve/supervisor.py). `sched:crash` (utils/faults.py) kills the loop at
  the top of a harvest, mid-batch; `sched:hang` sleeps at a decode round's
  issue.
- Checkpoints: `SchedulerBackend.from_hf_checkpoint` and `from_gguf` load
  weights onto the device and build the scheduler through a factory, so a
  supervised restart rebuilds the cache without reading the checkpoint
  again.

Not ported yet (ROADMAP A7 follow-ups): mixed ragged rounds, speculation,
grammar constraints, overcommit, preemption and spill, phase roles, QoS,
profiling and the flight recorder, prefix telemetry, `SchedulerPool` and
meshes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import resolve_device
from ..engine.kvcache import bucket_len, init_cache
from ..engine.paged_kv import (
    PageAllocator,
    default_page_size,
    init_page_pool,
    page_bytes,
    pages_for_budget,
    pages_for_tokens,
)
from ..models.configs import LlamaConfig
from ..models.llama import Params, forward
from ..ops.quant import quantize_kv
from ..ops.sampling import SamplingParams, greedy, sample_runtime
from .backends import Completion, trim_stop_texts
from ..utils.faults import FAULTS
from ..utils.observability import resilience
from .resilience import Deadline, DeadlineExceeded, SchedulerCrashed
from .watchdog import Heartbeat

_M32 = 0xFFFFFFFF


def _first_token_timer():
    """(on_token, first_at): on_token records the worker-thread harvest time
    of the request's first accepted token into first_at."""
    first_at: List[float] = []

    def on_tok(tok: int) -> None:
        if not first_at:
            first_at.append(time.perf_counter())

    return on_tok, first_at


@dataclasses.dataclass
class _Request:
    ids: List[int]
    max_new: int
    temperature: float
    top_p: float
    top_k: int
    seed: int
    future: Future
    # Called from the worker thread with each ACCEPTED token id, in order,
    # before the future resolves. Exceptions are swallowed (a broken
    # consumer must not kill the serving loop).
    on_token: Optional[Callable[[int], None]] = None
    # Set by `cancel`: the worker retires the request at its next harvest.
    cancelled: bool = False
    generated: List[int] = dataclasses.field(default_factory=list)
    # Chunked-prefill progress: prompt tokens already in the cache. A slot
    # is decode-eligible only once the whole prompt is in (`ready`).
    prefilled: int = 0
    ready: bool = False
    # Highest cache position (exclusive) this request can ever write:
    # admission allocated pages covering [0, page_end).
    page_end: int = 0
    # Already counted in page_waits (count requests, not retries).
    page_waited: bool = False
    deadline: Optional[Deadline] = None

    def past_deadline(self) -> bool:
        return self.deadline is not None and self.deadline.expired()

    def deadline_error(self) -> DeadlineExceeded:
        return DeadlineExceeded(
            f"request deadline exceeded with {len(self.generated)} of "
            f"{self.max_new} tokens generated")

    def emit(self, tok: int) -> None:
        if self.on_token is not None:
            try:
                self.on_token(tok)
            except Exception:  # noqa: BLE001 — consumer bugs must not kill serving
                self.on_token = None


class ContinuousBatchingScheduler:
    """Admit -> chunked prefill -> batched decode rounds -> retire, on one
    device batch over a contiguous KV cache or the paged KV pool.

    `submit()` is thread-safe and returns a Future of generated token ids
    (stop token stripped). A daemon thread owns all device work. `device`
    defaults to CUDA and must hold `params`; pass `device="cpu"` to run on
    the CPU (the kernels' plain versions)."""

    def __init__(
        self,
        cfg: LlamaConfig,
        params: Params,
        num_slots: int = 8,
        max_seq: Optional[int] = None,
        decode_chunk: int = 8,
        prompt_bucket: int = 128,
        stop_ids: Optional[Sequence[int]] = None,
        prefix_cache_blocks: int = 64,
        kv_layout: str = "contiguous",
        kv_page_size: Optional[int] = None,
        kv_pages: Optional[int] = None,
        kv_hbm_budget_bytes: Optional[int] = None,
        kv_quant: Optional[str] = None,
        device=None,
    ):
        self.kv_quant = kv_quant
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(
                f"kv_layout must be 'contiguous' or 'paged', got "
                f"{kv_layout!r}"
            )
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got {kv_quant!r}")
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        self.cfg = cfg
        self.device = resolve_device(device)
        if params["final_norm"].device.type != self.device.type:
            raise ValueError(f"params are on {params['final_norm'].device}, "
                             f"scheduler on {self.device}")
        self.params = params
        self.num_slots = num_slots
        self.max_seq = min(max_seq or cfg.max_seq_len, cfg.max_seq_len)
        self.decode_chunk = decode_chunk
        self.prompt_bucket = min(prompt_bucket, max(1, self.max_seq // 2))
        self.stop_ids = tuple(stop_ids) if stop_ids is not None else cfg.stop_ids
        dtype = params["final_norm"].dtype
        self._dtype = dtype

        dev = self.device
        self._page_wait: "deque[_Request]" = deque()
        if self._paged:
            self._init_paged(kv_page_size, kv_pages, kv_hbm_budget_bytes)
        else:
            # [L, slots, K, S, H], S rounded up to a multiple of 8 (int8:
            # values, and scales [L, slots, K, S]).
            self._cache = init_cache(cfg, num_slots, self.max_seq, dtype, dev,
                                     kv_quant)
            # Prefix cache: content key (token prefix) -> one block's K/V
            # (and scales), each [L, 1, K, pblock(, H)].
            self._prefix_cache: "OrderedDict[Tuple[int, ...], Dict[str, torch.Tensor]]" = (
                OrderedDict())
        # Inactive slots park at the last cache slot: a parked write lands
        # where no query can see it (submit keeps requests below it).
        self._park = self.max_seq - 1
        self._cur = torch.full((num_slots,), cfg.pad_id, dtype=torch.int32,
                               device=dev)
        self._pos = torch.full((num_slots,), self._park, dtype=torch.int32,
                               device=dev)
        self._temps = torch.zeros(num_slots, dtype=torch.float32, device=dev)
        self._topps = torch.ones(num_slots, dtype=torch.float32, device=dev)
        self._topks = torch.zeros(num_slots, dtype=torch.int32, device=dev)
        self._seeds = torch.zeros(num_slots, dtype=torch.int64, device=dev)
        self._counts = torch.zeros(num_slots, dtype=torch.int64, device=dev)
        self._slot_req: List[Optional[_Request]] = [None] * num_slots
        # Per-slot occupancy epoch, bumped at admission and retirement; the
        # harvest drops firsts issued under a stale epoch.
        self._slot_epoch: List[int] = [0] * num_slots
        # In-flight rounds: (issue-time slot->req list, epochs, toks [S,
        # chunk] device tensor, firsts [(slot, req, tok, epoch)]).
        self._pending: "deque[tuple]" = deque()
        self._first_pending: list = []
        self._harvest_lag = 1  # rounds kept in flight before syncing
        #: Decode rounds and prefill forwards issued (each round runs
        #: decode_chunk paged forwards; each prefill forward one flash
        #: prefill launch per layer on the card).
        self.rounds_issued = 0
        self.prefill_forwards = 0

        # Prompt-chunk buckets: powers of two up to prompt_bucket.
        b, buckets = min(16, self.prompt_bucket), []
        while b < self.prompt_bucket:
            buckets.append(b)
            b *= 2
        self._buckets = buckets + [self.prompt_bucket]
        # Up to kmax same-bucket admissions share one prefill forward. The
        # reference pads a group to a power-of-two k-bucket for its
        # compiled programs; an eager forward takes the group as it is.
        self._prefill_kmax = min(num_slots, 8)

        # Prefix cache: block size = the smallest bucket, so chunk
        # boundaries always land on block boundaries. The publish gate
        # remembers first sightings in `_prefix_seen`.
        self._pblock = self._buckets[0]
        self._prefix_cache_blocks = max(0, prefix_cache_blocks)
        self._prefix_seen: "OrderedDict[Tuple[int, ...], None]" = OrderedDict()
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_blocks_reused = 0
        self._prefix_reused_tokens = 0
        self._prefix_evictions = 0

        self._stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                        else None)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._prefill_q: "deque[Tuple[int, _Request]]" = deque()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._crash: Optional[BaseException] = None
        # Guards the closed-check+enqueue in submit() against the final
        # queue drain in _close().
        self._submit_lock = threading.Lock()
        self._closed = False
        #: Liveness stamp: the loop stamps it every iteration and ticks it
        #: every harvested round; the supervisor's watchdog reads it.
        self.heartbeat = Heartbeat()

    # ----------------------------------------------------- device helpers

    def _h2d(self, data, dtype: torch.dtype) -> torch.Tensor:
        """A host list as a tensor on the scheduler's device, without a
        synchronise: a fresh pinned buffer per copy (the caching host
        allocator keeps it alive until the copy has run)."""
        t = torch.tensor(data, dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _park_slot(self, slot: int) -> None:
        """Point a freshly reserved slot's decode writes at the parking
        position before its prompt starts streaming in."""
        self._cur[slot] = self.cfg.pad_id
        self._pos[slot] = self._park

    def _ready_slot(self, slot: int, req: _Request, tok: torch.Tensor) -> None:
        """Arm a slot for decode: the first sampled token (still on the
        device), its position, sampling knobs and RNG stream (index 1: the
        prefill sample used index 0)."""
        self._cur[slot] = tok
        self._pos[slot] = len(req.ids)
        self._temps[slot] = req.temperature
        self._topps[slot] = req.top_p
        self._topks[slot] = req.top_k
        self._seeds[slot] = req.seed & _M32
        self._counts[slot] = 1

    def _retire_slot(self, slot: int) -> None:
        """Reset a retired slot's sampling knobs."""
        self._temps[slot] = 0.0
        self._topps[slot] = 1.0
        self._topks[slot] = 0

    def _set_row(self, slot: int, row: List[int]) -> None:
        self._ptab[slot] = self._h2d(row, torch.int32)

    def _slice_block(self, slot: int, start: int) -> Dict[str, torch.Tensor]:
        """A copy of one prefix block of a slot's row: every cache tensor
        [L, slots, K, S(, H)] -> [L, 1, K, pblock(, H)] (values and, under
        int8, their scales)."""
        end = start + self._pblock
        return {n: c[:, slot:slot + 1, :, start:end].clone()
                for n, c in self._cache.items()}

    def _restore_block(self, block: Dict[str, torch.Tensor], slot: int,
                       start: int) -> None:
        """Copy a cached prefix block into a slot's row at `start`, device
        to device: a hit costs copies instead of a forward."""
        end = start + self._pblock
        for n, c in self._cache.items():
            c[:, slot, :, start:end] = block[n][:, 0]

    def _copy_page(self, dst: int, src: int) -> None:
        """One-page device copy (copy-on-write), every layer, K and V (and
        their scale pages in an int8 pool)."""
        for pool in self._pool.values():
            pool[:, dst] = pool[:, src]

    # ---------------------------------------------------- paged-KV host side

    def _init_paged(self, kv_page_size, kv_pages, kv_hbm_budget_bytes) -> None:
        """The page pool, its allocator and the device page tables."""
        cfg, num_slots, dtype = self.cfg, self.num_slots, self._dtype
        ps = int(kv_page_size or default_page_size())
        if ps <= 0 or ps % 8:
            raise ValueError(
                f"kv_page_size must be a positive multiple of 8, got {ps}")
        self._page_size = ps
        # Logical pages per slot: enough table entries to address max_seq.
        self._pages_per_slot = pages_for_tokens(self.max_seq, ps)
        if kv_pages:
            num_pages = int(kv_pages)
        elif kv_hbm_budget_bytes:
            num_pages = pages_for_budget(cfg, kv_hbm_budget_bytes, ps,
                                         dtype.itemsize, self.kv_quant)
        else:
            # Default: the contiguous layout's own footprint.
            num_pages = num_slots * self._pages_per_slot
        if num_pages < self._pages_per_slot:
            raise ValueError(
                f"page pool of {num_pages} pages cannot hold one max-length "
                f"request ({self._pages_per_slot} pages of {ps} tokens for "
                f"max_seq={self.max_seq}); raise kv_pages / "
                f"kv_hbm_budget_bytes or lower max_seq"
            )
        self._page_alloc = PageAllocator(num_pages, ps)
        # Host-side per-slot page lists (the device table's mirror).
        self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        # Prefix cache: content key (token prefix) -> pool pages covering it.
        self._prefix_pages: "OrderedDict[Tuple[int, ...], Tuple[int, ...]]" = (
            OrderedDict())
        self._page_wait_events = 0
        self._pool = init_page_pool(cfg, num_pages, ps, dtype, self.device,
                                    self.kv_quant)
        # Device page tables; the unmapped sentinel is num_pages.
        self._ptab = torch.full((num_slots, self._pages_per_slot), num_pages,
                                dtype=torch.int32, device=self.device)

    def _sync_ptab_row(self, slot: int) -> None:
        """Mirror a slot's host page list into the device table (unmapped
        tail entries carry the sentinel)."""
        pages = self._slot_pages[slot]
        self._set_row(slot, pages + [self._page_alloc.num_pages]
                      * (self._pages_per_slot - len(pages)))

    def _prefix_evict(self, key: Tuple[int, ...], pages: Tuple[int, ...]) -> None:
        self._page_alloc.prefix_drop(list(pages))
        self._page_alloc.release(list(pages))
        self._prefix_evictions += 1

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """All-or-nothing page grab, evicting LRU prefix-cache entries
        under pressure: cached prefixes never make a live request wait."""
        while not self._page_alloc.can_alloc(n) and self._prefix_pages:
            key, pages = self._prefix_pages.popitem(last=False)
            self._prefix_evict(key, pages)
        return self._page_alloc.alloc(n)

    def _free_slot_pages(self, slot: int) -> None:
        """Retirement: drop the slot's page references (pages still held by
        prefix-cache entries survive) and unmap its device row."""
        if self._slot_pages[slot]:
            self._page_alloc.release(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self._sync_ptab_row(slot)

    def _evict_entries_with(self, page: int) -> None:
        """Drop every prefix-cache entry referencing `page` (the
        copy-on-write fallback when the pool has no page for the copy)."""
        for key in [k for k, v in self._prefix_pages.items() if page in v]:
            self._prefix_evict(key, self._prefix_pages.pop(key))

    def _ensure_writable(self, slot: int, start_tok: int, end_tok: int) -> None:
        """Copy-on-write sweep before writing positions [start_tok,
        end_tok): a shared page in the range is copied into a fresh page
        (the prefix entry keeps the original) or, when the pool cannot fund
        the copy, un-published until exclusive."""
        ps = self._page_size
        pages = self._slot_pages[slot]
        hi = min(pages_for_tokens(end_tok, ps), len(pages))
        for pi in range(start_tok // ps, hi):
            pg = pages[pi]
            if not self._page_alloc.is_shared(pg):
                continue
            fresh = self._alloc_pages(1)
            if fresh is None:
                self._evict_entries_with(pg)
                if self._page_alloc.is_shared(pg):
                    raise RuntimeError(
                        f"page {pg} still shared inside a write range after "
                        f"un-publishing (slot {slot})")
                continue
            self._copy_page(fresh[0], pg)
            self._page_alloc.note_cow()
            self._page_alloc.release([pg])
            pages[pi] = fresh[0]
            self._sync_ptab_row(slot)

    def _reserve_new(self, req: _Request) -> int:
        """Generation tokens admission reserves: the whole remaining budget
        (the reference's exact mode; overcommit is not ported)."""
        return max(0, req.max_new - len(req.generated))

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ContinuousBatchingScheduler":
        if self._thread is None:
            if self._crash is not None:
                raise self._crash_error()
            if self._paged:
                # Re-sync every table row from the host mirror: a previous
                # _close released abandoned slots' pages host-side only.
                for i in range(self.num_slots):
                    self._sync_ptab_row(i)
            self._stop_evt.clear()
            with self._submit_lock:
                self._closed = False
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def shutdown(self, timeout: Optional[float] = None) -> None:
        """Stop the event loop and join it."""
        if self._thread is not None:
            self._stop_evt.set()
            self._queue.put(None)  # wake the loop
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    def _crash_error(self) -> SchedulerCrashed:
        if isinstance(self._crash, SchedulerCrashed):
            return self._crash
        return SchedulerCrashed.from_exception(self._crash)

    # ---------------------------------------------------------------- client

    @property
    def overshoot(self) -> int:
        """Max positions the device can run past a budget or stop token
        before the host notices: pending rounds x tokens per round."""
        return (self._harvest_lag + 1) * self.decode_chunk

    def submit(
        self,
        ids: Sequence[int],
        max_new_tokens: int = 256,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
        on_token: Optional[Callable[[int], None]] = None,
        deadline_s: Optional[float] = None,
        constraint=None,
    ) -> "Future[List[int]]":
        """Queue a request; returns a Future of its generated ids. The
        request samples from its own (seed, index) stream, so (ids,
        sampling, seed, max_new) reproduces the same tokens whatever else
        is served. `on_token` gets each accepted token, in order, from the
        worker thread. With `deadline_s` the request fails with
        `DeadlineExceeded` once that many seconds have passed: at admission,
        or at the next harvest once in flight. A grammar `constraint`
        raises (ROADMAP A8)."""
        if constraint is not None:
            raise ValueError("grammar-constrained decoding is not ported: "
                             "ROADMAP A8")
        if not ids:
            raise ValueError("empty prompt")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        need = (bucket_len(len(ids), self.prompt_bucket) + max_new_tokens
                + self.overshoot)
        if need > self.max_seq - 1:  # the last cache slot is the parking spot
            raise ValueError(
                f"prompt ({len(ids)} tokens, bucketed) + max_new_tokens "
                f"({max_new_tokens}) + overshoot ({self.overshoot}) = {need} "
                f"exceeds scheduler max_seq={self.max_seq}"
            )
        req = _Request(
            ids=list(ids), max_new=max_new_tokens,
            temperature=sampling.temperature, top_p=sampling.top_p,
            top_k=sampling.top_k, seed=seed, future=Future(),
            on_token=on_token,
            deadline=Deadline.after(deadline_s) if deadline_s is not None else None,
        )
        req.future._lsot_request = req  # cancel() handle
        with self._submit_lock:
            if self._closed:
                if self._crash is not None:
                    raise self._crash_error()
                raise RuntimeError("scheduler has shut down")
            if self._thread is None:
                raise RuntimeError(
                    "scheduler not started — call start() or use it as a "
                    "context manager (a queued Future would never resolve)")
            self._queue.put(req)
        return req.future

    def generate(
        self,
        prompts: List[List[int]],
        max_new_tokens: int = 256,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
    ) -> List[List[int]]:
        """Synchronous batch helper (engine-compatible signature)."""
        futs = [self.submit(p, max_new_tokens=max_new_tokens,
                            sampling=sampling, seed=seed) for p in prompts]
        return [f.result() for f in futs]

    @staticmethod
    def cancel(future: "Future[List[int]]") -> None:
        """Cooperatively cancel a submitted request: the worker retires it
        (resolving the future with what was generated) at its next
        harvest. A no-op on finished or foreign futures."""
        req = getattr(future, "_lsot_request", None)
        if req is not None:
            req.cancelled = True

    # ------------------------------------------------------------- stats

    @property
    def page_stats(self) -> Optional[Dict[str, int]]:
        """Pool occupancy and sharing counters (a leaked page shows up as
        pages_in_use that never drains); None for the contiguous layout."""
        if not self._paged:
            return None
        out = self._page_alloc.stats()
        out["pages_per_slot"] = self._pages_per_slot
        out["page_waits"] = self._page_wait_events
        out["kv_quant"] = self.kv_quant or ""
        out["page_bytes"] = page_bytes(self.cfg, self._page_size,
                                       self._dtype.itemsize, self.kv_quant)
        return out

    @property
    def prefix_stats(self) -> Dict[str, object]:
        """Prefix-cache counters: admissions that reused blocks (hits) vs
        cacheable admissions that found none (misses)."""
        total = self._prefix_hits + self._prefix_misses
        return {
            "hits": self._prefix_hits,
            "misses": self._prefix_misses,
            "hit_rate": round(self._prefix_hits / total, 4) if total else 0.0,
            "blocks_reused": self._prefix_blocks_reused,
            "reused_tokens": self._prefix_reused_tokens,
            "evictions": self._prefix_evictions,
            "cached_blocks": len(self._prefix_pages if self._paged
                                 else self._prefix_cache),
        }

    # ------------------------------------------------------------ admission

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _admit_paged(self, slot: int, req: _Request) -> bool:
        """Allocate the request's page envelope and map any cached prefix
        zero-copy (one-page copy-on-write only when the matched prefix ends
        mid-page). Returns False, with no side effects, when the pool
        cannot fund the envelope now."""
        ps, pb = self._page_size, self._pblock
        ids = req.ids
        plen = len(ids)
        s_virt = self._pages_per_slot * ps
        n = 0
        if self._prefix_cache_blocks:
            max_blocks = (plen - 1) // pb
            while n < max_blocks and tuple(ids[: (n + 1) * pb]) in self._prefix_pages:
                n += 1
            # A reuse offset shifts every chunk start; the final chunk's
            # bucket must still land inside the virtual row.
            while n and self._chunk_end(n * pb, plen) > s_virt:
                n -= 1
        reuse = n * pb
        need_end = min(s_virt, max(
            self._chunk_end(reuse, plen),
            bucket_len(plen, self.prompt_bucket) + self._reserve_new(req)
            + self.overshoot,
        ))
        need_pages = pages_for_tokens(need_end, ps)
        full = reuse // ps
        entry = self._prefix_pages.get(tuple(ids[:reuse])) if reuse else None
        shared = list(entry[:full]) if entry else []
        boundary_src = entry[full] if (entry and reuse % ps) else None
        # Take the refs BEFORE allocating: _alloc_pages evicts LRU entries
        # under pressure, and the matched entry must survive it. Transient
        # until admission succeeds, so not counted as shares yet.
        self._page_alloc.share(shared, count=False)
        if boundary_src is not None:
            self._page_alloc.share([boundary_src], count=False)
        fresh = self._alloc_pages(need_pages - full)
        if fresh is None:
            self._page_alloc.release(shared)
            if boundary_src is not None:
                self._page_alloc.release([boundary_src])
            if not req.page_waited:
                req.page_waited = True
                self._page_wait_events += 1
            return False
        if boundary_src is not None:
            # Copy-on-write at the non-page-aligned boundary: prefill
            # resumes mid-page inside the private copy.
            self._copy_page(fresh[0], boundary_src)
            self._page_alloc.note_cow()
            self._page_alloc.release([boundary_src])
        self._slot_pages[slot] = shared + fresh
        self._sync_ptab_row(slot)
        self._page_alloc.note_shares(len(shared))
        req.page_end = need_end
        if reuse:
            req.prefilled = reuse
            for j in range(n):  # LRU touch along the matched chain
                key = tuple(ids[: (j + 1) * pb])
                if key in self._prefix_pages:
                    self._prefix_pages.move_to_end(key)
        if self._prefix_cache_blocks:
            self._note_prefix(plen, n)
        return True

    def _admit_blocks(self, slot: int, req: _Request) -> None:
        """Contiguous prefix reuse: copy the longest cached chain of blocks
        of the prompt into the slot's row, device to device. At least one
        prompt token still goes through prefill (its logit samples the
        first output token)."""
        pb, ids = self._pblock, req.ids
        max_blocks = (len(ids) - 1) // pb
        n = 0
        while n < max_blocks and tuple(ids[: (n + 1) * pb]) in self._prefix_cache:
            n += 1
        # A reuse offset shifts every chunk start; the final chunk's bucket
        # must still land inside the cache.
        s_cache = next(iter(self._cache.values())).shape[3]
        while n and self._chunk_end(n * pb, len(ids)) > s_cache:
            n -= 1
        for j in range(n):
            key = tuple(ids[: (j + 1) * pb])
            self._prefix_cache.move_to_end(key)  # LRU touch
            self._restore_block(self._prefix_cache[key], slot, j * pb)
        req.prefilled = n * pb
        self._note_prefix(len(ids), n)

    def _note_prefix(self, plen: int, n: int) -> None:
        """Count an admission that reused `n` blocks (a hit), or a cacheable
        one that found none (a miss)."""
        if n:
            self._prefix_hits += 1
            self._prefix_blocks_reused += n
            self._prefix_reused_tokens += n * self._pblock
        elif (plen - 1) // self._pblock:
            self._prefix_misses += 1

    def _admit(self, slot: int, req: _Request) -> bool:
        """Reserve `slot` and queue the prompt for chunked prefill, reusing
        any cached prefix first. Returns False only when the page pool
        cannot hold the request yet."""
        if req.cancelled:  # cancelled while queued: never occupy a slot
            req.future.set_result(req.generated)
            return True
        if req.past_deadline():  # expired while queued: fail fast, typed
            resilience.inc("deadline_expired")
            req.future.set_exception(req.deadline_error())
            return True
        if self._paged and not self._admit_paged(slot, req):
            return False
        self._slot_req[slot] = req
        self._slot_epoch[slot] += 1
        self._park_slot(slot)
        if not self._paged and self._prefix_cache_blocks:
            self._admit_blocks(slot, req)
        self._prefill_q.append((slot, req))
        return True

    def _next_bucket(self, req: _Request) -> int:
        remaining = len(req.ids) - req.prefilled
        return next((b for b in self._buckets if b >= remaining),
                    self.prompt_bucket)

    def _chunk_end(self, start: int, total: int) -> int:
        """Highest cache position (exclusive) the chunked prefill of tokens
        [start, total) writes — the final chunk writes its whole bucket."""
        end = start
        while start < total:
            remaining = total - start
            t = next((b for b in self._buckets if b >= remaining),
                     self.prompt_bucket)
            end = start + t
            start += min(t, remaining)
        return end

    # -------------------------------------------------------------- prefill

    def _prefill_forward(self, group, t: int) -> torch.Tensor:
        """One prompt chunk for each (slot, req) of `group` in one forward.
        Returns the first-token samples [k] (used on final chunks)."""
        cfg = self.cfg
        tokens, lengths, starts = [], [], []
        for slot, req in group:
            chunk_ids = req.ids[req.prefilled: req.prefilled + t]
            tokens.append(chunk_ids + [cfg.pad_id] * (t - len(chunk_ids)))
            lengths.append(len(chunk_ids))
            starts.append(req.prefilled)
        tokens_t = self._h2d(tokens, torch.int32)
        positions = (self._h2d(starts, torch.int32)[:, None]
                     + torch.arange(t, dtype=torch.int32, device=self.device))
        last = self._h2d(lengths, torch.int64) - 1
        if self._paged:
            logits = self._prefill_paged(group, t, tokens_t, positions, last)
        else:
            # Over the slots' own cache rows, one layer at a time, reading
            # the slots below the chunks' end (rounded up to 64).
            span = max(starts) + t
            logits, _ = forward(cfg, self.params, tokens_t, positions,
                                self._cache, logit_indices=last,
                                rows=self._h2d([s for s, _ in group], torch.int64),
                                span=span + -span % 64)
        self.prefill_forwards += 1
        reqs = [req for _, req in group]
        if all(r.temperature <= 0.0 for r in reqs):
            return greedy(logits[:, 0])
        return sample_runtime(
            logits[:, 0],
            self._h2d([r.temperature for r in reqs], torch.float32),
            self._h2d([r.top_p for r in reqs], torch.float32),
            self._h2d([r.top_k for r in reqs], torch.int32),
            self._h2d([r.seed & _M32 for r in reqs], torch.int64),
            torch.zeros(len(reqs), dtype=torch.int64, device=self.device),
        )

    def _prefill_paged(self, group, t: int, tokens: torch.Tensor,
                       positions: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
        """The paged chunk forward, over contiguous row views gathered from
        the pool; the chunk's K/V then scatter back through the slots' pages
        (only this window: other pages of a row may be shared prefix
        pages). Returns the logits [k, 1, V]."""
        cfg, ps = self.cfg, self._page_size
        np_tab, num_pages = self._pages_per_slot, self._page_alloc.num_pages
        kp, vp = self._pool["kp"], self._pool["vp"]
        n_layers, _, kh, _, hd = kp.shape
        rows = []
        w_row, w_pos, w_page, w_off = [], [], [], []
        for i, (slot, req) in enumerate(group):
            pages = self._slot_pages[slot]
            rows.append(pages + [num_pages] * (np_tab - len(pages)))
            # Window scatter coordinates, from the host mirror of the table:
            # positions past the row's mapped pages are dropped.
            for p in range(req.prefilled, req.prefilled + t):
                if p // ps < len(pages):
                    w_row.append(i)
                    w_pos.append(p)
                    w_page.append(pages[p // ps])
                    w_off.append(p % ps)
        k = len(group)
        safe = self._h2d(rows, torch.int64).clamp(max=num_pages - 1)

        def rowview(pool):  # [L, P, K, PS(, H)] -> [L, k, K, NP*PS(, H)]
            g = pool[:, safe]
            perm = (0, 1, 3, 2, 4, 5) if pool.dim() == 5 else (0, 1, 3, 2, 4)
            return g.permute(*perm).reshape(n_layers, k, kh, np_tab * ps,
                                            *pool.shape[4:])

        if self.kv_quant:
            dt = self._dtype
            row_cache = {
                "k": rowview(kp).to(dt) * rowview(self._pool["kps"])[..., None].to(dt),
                "v": rowview(vp).to(dt) * rowview(self._pool["vps"])[..., None].to(dt),
            }
        else:
            row_cache = {"k": rowview(kp), "v": rowview(vp)}
        logits, _ = forward(cfg, self.params, tokens, positions, row_cache,
                            logit_indices=last)
        if w_row:
            r, p = self._h2d(w_row, torch.int64), self._h2d(w_pos, torch.int64)
            pg, of = self._h2d(w_page, torch.int64), self._h2d(w_off, torch.int64)
            if self.kv_quant:
                for name in ("k", "v"):
                    qn = quantize_kv(row_cache[name][:, r, :, p])  # [n, L, K, H]
                    self._pool[f"{name}p"][:, pg, :, of] = qn["q8"]
                    self._pool[f"{name}ps"][:, pg, :, of] = qn["s"]
            else:
                kp[:, pg, :, of] = row_cache["k"][:, r, :, p]
                vp[:, pg, :, of] = row_cache["v"][:, r, :, p]
        return logits

    def _prefill_step(self) -> None:
        """Run ONE prompt chunk for up to `_prefill_kmax` waiting requests
        of the same bucket in a single forward (chunked prefill interleaves
        with decode rounds instead of stalling every active slot)."""
        group: List[Tuple[int, _Request]] = []
        deferred = []
        t = 0
        while self._prefill_q and len(group) < self._prefill_kmax:
            s, r = self._prefill_q.popleft()
            if self._slot_req[s] is not r:
                continue
            if not group:
                t = self._next_bucket(r)
                group.append((s, r))
            elif self._next_bucket(r) == t:
                group.append((s, r))
            else:
                deferred.append((s, r))
        for item in reversed(deferred):  # keep arrival order for next passes
            self._prefill_q.appendleft(item)
        if not group:
            return
        if self._paged:  # copy-on-write sweep over each chunk's write window
            for slot, req in group:
                self._ensure_writable(slot, req.prefilled, req.prefilled + t)
        chunk_lens = [len(req.ids[req.prefilled: req.prefilled + t])
                      for _, req in group]
        toks = self._prefill_forward(group, t)

        for i, (slot, req) in enumerate(group):
            chunk_start = req.prefilled
            req.prefilled += chunk_lens[i]
            if self._prefix_cache_blocks:
                if self._paged:
                    self._publish_blocks_paged(slot, req, chunk_start)
                else:
                    self._publish_blocks(slot, req, chunk_start)
            if req.prefilled < len(req.ids):
                self._prefill_q.append((slot, req))
                continue
            # No sync: arm the slot with the still-on-device first token and
            # attach it to the next round's harvest (stop/budget checks on
            # it happen there, one round late).
            req.ready = True
            if self._paged:
                # Decode writes [len(ids), page_end): the final chunk's
                # publish may have shared the page holding the prompt tail.
                self._ensure_writable(slot, len(req.ids), req.page_end)
            self._ready_slot(slot, req, toks[i])
            self._first_pending.append((slot, req, toks[i], self._slot_epoch[slot]))

    def _first_sighting(self, key: Tuple[int, ...]) -> bool:
        """The publish gate: remember a block's first sighting (and publish
        nothing); True from the second on."""
        if key in self._prefix_seen:
            return False
        self._prefix_seen[key] = None
        while len(self._prefix_seen) > 4 * self._prefix_cache_blocks:
            self._prefix_seen.popitem(last=False)
        return True

    def _publish_blocks(self, slot: int, req: _Request, chunk_start: int) -> None:
        """Publish the chunk's completed prefix blocks as copies of the
        slot's row (chunk_start is block-aligned: reuse stops on block
        boundaries and every non-final chunk is a multiple of a block),
        gated on the block's second sighting; LRU eviction past
        `prefix_cache_blocks`."""
        pb = self._pblock
        for b0 in range(chunk_start // pb, req.prefilled // pb):
            key = tuple(req.ids[: (b0 + 1) * pb])
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                continue
            if self._first_sighting(key):
                continue
            self._prefix_cache[key] = self._slice_block(slot, b0 * pb)
            while len(self._prefix_cache) > self._prefix_cache_blocks:
                self._prefix_cache.popitem(last=False)
                self._prefix_evictions += 1

    def _publish_blocks_paged(self, slot: int, req: _Request,
                              chunk_start: int) -> None:
        """Publish the chunk's completed prefix blocks: an entry is a
        REFERENCE to the publisher's pages (refcount++), gated on the
        block's second sighting."""
        pb, ps = self._pblock, self._page_size
        for b0 in range(chunk_start // pb, req.prefilled // pb):
            key = tuple(req.ids[: (b0 + 1) * pb])
            if key in self._prefix_pages:
                self._prefix_pages.move_to_end(key)
                continue
            if self._first_sighting(key):
                continue
            pages = tuple(
                self._slot_pages[slot][: pages_for_tokens((b0 + 1) * pb, ps)])
            self._page_alloc.share(list(pages))
            self._page_alloc.prefix_hold(list(pages))
            self._prefix_pages[key] = pages
            while len(self._prefix_pages) > self._prefix_cache_blocks:
                self._prefix_evict(*self._prefix_pages.popitem(last=False))

    # --------------------------------------------------------------- decode

    def _decode_round(self, active: torch.Tensor, sampled: bool) -> torch.Tensor:
        """`decode_chunk` T=1 steps of the whole slot batch over the cache
        or the pool; returns the tokens [slots, chunk] (device)."""
        cache = dict(self._pool, ptab=self._ptab) if self._paged else self._cache
        cur, pos, toks = self._cur, self._pos, []
        for i in range(self.decode_chunk):
            logits, _ = forward(
                self.cfg, self.params, cur[:, None], pos[:, None], cache,
                # Parked slots read nothing; live slots up to their position.
                kv_lens=torch.where(active, pos + 1, 0),
            )
            if sampled:
                nxt = sample_runtime(logits[:, 0], self._temps, self._topps,
                                     self._topks, self._seeds, self._counts + i)
            else:
                nxt = greedy(logits[:, 0])
            cur = torch.where(active, nxt, self.cfg.pad_id)
            pos = torch.where(active, pos + 1, pos)
            toks.append(cur)
        self._cur, self._pos = cur, pos
        # Every active slot consumed `chunk` samples of its stream.
        self._counts = torch.where(active, self._counts + self.decode_chunk,
                                   self._counts)
        return torch.stack(toks, dim=1)

    def _issue_decode(self) -> None:
        """Enqueue one decode round; nothing synchronises here. Its tokens
        are harvested `_harvest_lag` rounds later."""
        # Duration-valued hang seam: `sched:hang:p:secs` sleeps here, the
        # wedge that never raises, which the supervisor's watchdog must
        # detect from the stale heartbeat.
        FAULTS.check("sched:hang")
        issue_reqs = [r if r is not None and r.ready else None
                      for r in self._slot_req]
        active = self._h2d([r is not None for r in issue_reqs], torch.bool)
        sampled = any(r is not None and r.temperature > 0.0 for r in issue_reqs)
        toks = self._decode_round(active, sampled)
        self.rounds_issued += 1
        self._pending.append((issue_reqs, list(self._slot_epoch), toks,
                              self._first_pending))
        self._first_pending = []

    # --------------------------------------------------------------- retire

    def _retire(self, slot: int, req: _Request, result: List[int]) -> None:
        req.future.set_result(result)
        self._release_slot(slot)

    def _fail_slot(self, slot: int, req: _Request, exc: Exception) -> None:
        """Retire a slot with a typed failure (deadline expiry)."""
        req.future.set_exception(exc)
        self._release_slot(slot)

    def _release_slot(self, slot: int) -> None:
        self._slot_req[slot] = None
        self._slot_epoch[slot] += 1
        self._retire_slot(slot)
        if self._paged:
            # In-flight rounds still write through the table rows they were
            # issued with; stream order puts those writes before any new
            # occupant's prefill of the freed pages.
            self._free_slot_pages(slot)

    def _append_first(self, slot: int, req: _Request, first: int,
                      epoch: int) -> None:
        """Apply a harvested prefill first token: stop/budget checks run
        here, one round late."""
        if req is not self._slot_req[slot] or epoch != self._slot_epoch[slot]:
            return
        if req.past_deadline():
            resilience.inc("deadline_expired")
            self._fail_slot(slot, req, req.deadline_error())
            return
        if req.cancelled or first in self.stop_ids or req.max_new < 1:
            self._retire(slot, req, req.generated)
            return
        req.generated.append(first)
        req.emit(first)
        if len(req.generated) >= req.max_new:
            self._retire(slot, req, req.generated)

    def _harvest_round(self) -> None:
        """Synchronise on the OLDEST in-flight round: one transfer brings
        its tokens and the prefill first tokens attached to it; retire
        finished requests and free their slots."""
        # Chaos seam: `sched:crash` kills the loop mid-batch (rounds issued,
        # tokens possibly streamed, slots occupied); a supervisor must
        # restart it and replay every acknowledged request without
        # duplicating delivered tokens.
        FAULTS.check("sched:crash")
        issue_reqs, epochs, toks_dev, firsts = self._pending.popleft()
        flat = torch.cat([toks_dev.reshape(-1)]
                         + [tok.reshape(1) for _, _, tok, _ in firsts]).tolist()
        chunk = self.decode_chunk
        # Firsts precede the round's tokens in every stream.
        for j, (slot, req, _, fep) in enumerate(firsts):
            self._append_first(slot, req, flat[self.num_slots * chunk + j], fep)
        for i, req in enumerate(issue_reqs):
            if req is None or req is not self._slot_req[i] \
                    or epochs[i] != self._slot_epoch[i]:
                continue  # inactive at issue, or retired since
            if req.cancelled:
                self._retire(i, req, req.generated)
                continue
            if req.past_deadline():
                resilience.inc("deadline_expired")
                self._fail_slot(i, req, req.deadline_error())
                continue
            done = False
            for tok in flat[i * chunk: (i + 1) * chunk]:
                if tok in self.stop_ids:
                    done = True
                    break
                req.generated.append(tok)
                req.emit(tok)
                if len(req.generated) >= req.max_new:
                    done = True
                    break
            if done:
                self._retire(i, req, req.generated)
        self.heartbeat.round_done()

    def _harvest_firsts(self) -> None:
        """Drain path: ready slots whose first token never rode a round."""
        if not self._first_pending:
            return
        firsts, self._first_pending = self._first_pending, []
        vals = torch.cat([tok.reshape(1) for _, _, tok, _ in firsts]).tolist()
        for (slot, req, _, fep), v in zip(firsts, vals):
            self._append_first(slot, req, v, fep)

    # ----------------------------------------------------------------- loop

    def _device_context(self) -> contextlib.ExitStack:
        """The worker thread's per-thread state: inference mode, and on the
        card the scheduler's device and stream."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self._stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _run(self) -> None:
        try:
            with self._device_context():
                self._loop()
            self._close(RuntimeError("scheduler shut down mid-request"))
        except BaseException as exc:  # noqa: BLE001 — a dead loop must not hang clients
            wrapped = SchedulerCrashed.from_exception(exc)
            self._crash = wrapped
            self._close(wrapped)
            raise

    def _close(self, exc: BaseException) -> None:
        """Fail every in-flight and queued request; reject future submits."""
        with self._submit_lock:
            self._closed = True
        self._prefill_q.clear()
        self._pending.clear()
        self._first_pending = []
        for req in self._page_wait:
            req.future.set_exception(exc)
        self._page_wait.clear()
        for i, req in enumerate(self._slot_req):
            if req is not None:
                req.future.set_exception(exc)
                self._slot_req[i] = None
                if self._paged and self._slot_pages[i]:
                    # Host-side release only; start() re-syncs the rows.
                    self._page_alloc.release(self._slot_pages[i])
                    self._slot_pages[i] = []
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.future.set_exception(exc)

    def _sweep_page_wait(self) -> None:
        """Cancelled page-starved waiters resolve with what they have;
        expired ones fail typed."""
        keep: "deque[_Request]" = deque()
        for req in self._page_wait:
            if req.cancelled:
                req.future.set_result(req.generated)
            elif req.past_deadline():
                resilience.inc("deadline_expired")
                req.future.set_exception(req.deadline_error())
            else:
                keep.append(req)
        self._page_wait = keep

    def _busy_now(self) -> bool:
        """Work anywhere in the pipeline: the busy flag each iteration
        stamps into the heartbeat."""
        return bool(self._prefill_q or self._pending or self._page_wait
                    or any(r is not None for r in self._slot_req)
                    or not self._queue.empty())

    @property
    def watchdog_stats(self) -> Dict[str, object]:
        """The loop's heartbeat (age, busy, rounds, measured cadence)."""
        return {"heartbeat": self.heartbeat.snapshot()}

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            # Liveness stamp first, so a wedge anywhere below leaves a
            # stale busy stamp for the watchdog to age.
            self.heartbeat.stamp(busy=self._busy_now())
            self._sweep_page_wait()
            # Admit pending requests into every free slot; page-starved
            # requests re-admit ahead of the queue, in arrival order.
            while self._free_slots():
                if self._page_wait:
                    req = self._page_wait.popleft()
                else:
                    try:
                        req = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if req is None:
                        continue
                if not self._admit(self._free_slots()[0], req):
                    # The pool cannot hold this envelope until live slots
                    # retire: park it at the front of the line.
                    self._page_wait.appendleft(req)
                    break
            # Fair interleave: at most one prompt chunk per decode round.
            if self._prefill_q:
                self._prefill_step()
            if any(r is not None and r.ready for r in self._slot_req):
                self._issue_decode()
                if len(self._pending) > self._harvest_lag:
                    self._harvest_round()
            elif not self._prefill_q:
                # Nothing left to issue: drain in-flight rounds and any
                # unridden first tokens, then wait for new requests.
                while self._pending:
                    self._harvest_round()
                self._harvest_firsts()
                if self._prefill_q or self._page_wait or any(
                        r is not None for r in self._slot_req):
                    continue
                try:
                    req = self._queue.get(timeout=0.05)
                    if req is not None and not self._admit(self._free_slots()[0], req):
                        self._page_wait.appendleft(req)
                except queue.Empty:
                    pass


class SchedulerBackend:
    """Tokenize -> scheduler.submit -> detokenize: the continuous-batching
    twin of `EngineBackend` (serve/backends.py). Concurrent callers share
    the scheduler's decode batch; no lock serialises them. TTFT is the time
    from submit to the request's first accepted token. `deadline_s` is the
    default per-request deadline (None: none); a request's own overrides
    it, and the scheduler retires an expired request typed.

    `scheduler` is a `ContinuousBatchingScheduler` or a
    `SupervisedScheduler` wrapping one (serve/supervisor.py): with the
    supervisor, the backend forwards idempotency keys to its journal,
    reports its lifecycle through `health()`, drains through it, and
    recovers a previous process's journal spill at construction."""

    #: GenerationService forwards a `deadline_s` to backends that set this.
    supports_deadline = True

    def __init__(
        self,
        scheduler: ContinuousBatchingScheduler,
        tokenizer,
        max_new_tokens: int = 256,
        sampling: SamplingParams = SamplingParams(),
        stop_texts: Sequence[str] = (),
        add_bos: bool = True,
        deadline_s: Optional[float] = None,
    ):
        self.scheduler = scheduler.start()
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling
        self.stop_texts = tuple(stop_texts)
        self.add_bos = add_bos
        self.deadline_s = deadline_s
        # Idempotency keys need a journal to dedupe against: only the
        # supervised wrapper has one.
        self.supports_idempotency = bool(
            getattr(scheduler, "supports_idempotency", False))
        # Journal-spill recovery happens here, the one seam every
        # deployment path funnels through: a previous process's drained
        # but unfinished requests resubmit, so retried idempotency keys
        # find their results.
        recover = getattr(scheduler, "recover", None)
        if callable(recover) and getattr(scheduler, "spill_path", None):
            recover()

    def shutdown(self) -> None:
        self.scheduler.shutdown()

    def health(self) -> Optional[Dict[str, object]]:
        """The supervisor's lifecycle (ready/restarting/degraded/dead and
        its counters) for /readyz; None for a bare scheduler."""
        h = getattr(self.scheduler, "health", None)
        return h() if callable(h) else None

    def drain(self, deadline_s: Optional[float] = None) -> None:
        """SIGTERM seam: a supervised scheduler stops admitting, finishes
        in-flight work up to the deadline and journals the rest; a bare
        one just stops."""
        d = getattr(self.scheduler, "drain", None)
        if callable(d):
            d(deadline_s)
        else:
            self.scheduler.shutdown()

    def retry_after_hint(self) -> float:
        hint = getattr(self.scheduler, "retry_after_hint", None)
        return hint() if callable(hint) else 1.0

    def check_budget(self, prompt: str, max_new_tokens: Optional[int] = None) -> None:
        """Raise the ValueError `complete` would raise for a prompt that
        leaves no decode room, without submitting."""
        self._budget(len(self.tokenizer.encode(prompt, add_bos=self.add_bos)),
                     max_new_tokens)

    def _budget(self, n_prompt_tokens: int, max_new_tokens: Optional[int]) -> int:
        """The requested budget, clamped to the room the scheduler window
        leaves after the bucketed prompt and the overshoot."""
        sched = self.scheduler
        room = sched.max_seq - 1 - sched.overshoot - bucket_len(
            n_prompt_tokens, sched.prompt_bucket)
        if room < 1:
            raise ValueError(
                f"prompt ({n_prompt_tokens} tokens) leaves no room in the "
                f"{sched.max_seq}-token scheduler window of {sched.cfg.name}"
            )
        return min(max_new_tokens or self.max_new_tokens, room)

    def _submit(self, ids, max_new_tokens, sampling, seed, deadline_s,
                idempotency_key=None):
        on_tok, first_at = _first_token_timer()
        kwargs = {}
        if idempotency_key is not None:
            # GenerationService forwards a key only when
            # supports_idempotency is set.
            kwargs["idempotency_key"] = idempotency_key
        fut = self.scheduler.submit(
            ids, max_new_tokens=self._budget(len(ids), max_new_tokens),
            sampling=sampling or self.sampling, seed=seed, on_token=on_tok,
            deadline_s=deadline_s if deadline_s is not None else self.deadline_s,
            **kwargs)
        return fut, first_at

    def _completion(self, ids, fut, first_at, t_submit) -> Completion:
        out = fut.result()
        text = trim_stop_texts(self.tokenizer.decode(out), self.stop_texts)
        return Completion(text=text, output_tokens=len(out),
                          prompt_tokens=len(ids),
                          ttft_s=(first_at[0] - t_submit) if first_at else 0.0)

    def complete(self, prompt: str, max_new_tokens: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None, seed: int = 0,
                 deadline_s: Optional[float] = None,
                 idempotency_key: Optional[str] = None) -> Completion:
        ids = self.tokenizer.encode(prompt, add_bos=self.add_bos)
        t_submit = time.perf_counter()
        fut, first_at = self._submit(ids, max_new_tokens, sampling, seed,
                                     deadline_s, idempotency_key)
        return self._completion(ids, fut, first_at, t_submit)

    def complete_batch(
        self, prompts: Sequence[str], max_new_tokens: Optional[int] = None,
        sampling: Optional[SamplingParams] = None, seed: int = 0,
        deadline_s: Optional[float] = None,
    ) -> List[Completion]:
        """Submit the whole batch at once: the scheduler interleaves the
        prompts through its slots (continuous batching)."""
        ids_list = [self.tokenizer.encode(p, add_bos=self.add_bos)
                    for p in prompts]
        t_submit = time.perf_counter()
        subs = [self._submit(ids, max_new_tokens, sampling, seed, deadline_s)
                for ids in ids_list]
        return [self._completion(ids, fut, first_at, t_submit)
                for ids, (fut, first_at) in zip(ids_list, subs)]

    # -------------------------------------------------------- checkpoints

    @classmethod
    def from_hf_checkpoint(cls, ckpt_dir: str, tokenizer, **kwargs
                           ) -> "SchedulerBackend":
        """HF safetensors directory -> a continuous-batching scheduler on
        `device` (default CUDA). The arguments are those of the JAX
        package's `SchedulerBackend.from_hf_checkpoint`: `dtype` (default
        bf16), `quantize_int4` (int4 block weights), `kv_quant="int8"`,
        the scheduler's shape arguments, and `supervise` with
        `max_restarts`, `max_entry_replays`, `journal_spill` and `stall_*`
        (serve/supervisor.py). What the port cannot honor yet raises and
        names its ROADMAP item."""
        from ..checkpoint import load_hf_checkpoint

        return cls._from_checkpoint(
            lambda dtype, device: load_hf_checkpoint(
                ckpt_dir, dtype=dtype or torch.bfloat16, device=device),
            os.path.basename(ckpt_dir.rstrip("/")), tokenizer, **kwargs)

    @classmethod
    def from_gguf(cls, gguf_path: str, tokenizer, cfg=None, **kwargs
                  ) -> "SchedulerBackend":
        """GGUF blob -> a continuous-batching scheduler, exactly like
        `from_hf_checkpoint` (the blob is parsed and dequantized by the
        port's C++ reader, checkpoint/gguf.py). A Q4 blob served with
        `quantize_int4=True` stays 4-bit end to end."""
        from ..checkpoint import load_gguf_checkpoint

        return cls._from_checkpoint(
            lambda dtype, device: load_gguf_checkpoint(
                gguf_path, cfg=cfg, dtype=dtype, device=device),
            os.path.basename(gguf_path), tokenizer, **kwargs)

    @classmethod
    def _from_checkpoint(
        cls,
        load,
        tag: str,
        tokenizer,
        mesh=None,
        dtype=None,
        num_slots: int = 8,
        prompt_bucket: int = 128,
        stop_ids: Optional[Sequence[int]] = None,
        quantize_int8: bool = False,
        quantize_int4: bool = False,
        quantize_unembed8: bool = False,
        kv_quant: Optional[str] = None,
        kv_layout: str = "contiguous",
        kv_page_size: Optional[int] = None,
        kv_pages: Optional[int] = None,
        kv_hbm_budget_bytes: Optional[int] = None,
        kv_overcommit: Optional[float] = None,
        kv_spill: Optional[bool] = None,
        kv_watermark_low: Optional[float] = None,
        kv_watermark_high: Optional[float] = None,
        max_seq: Optional[int] = None,
        decode_chunk: int = 8,
        speculative_draft: int = 0,
        max_queue_depth: int = 0,
        supervise: bool = False,
        max_restarts: int = 5,
        max_entry_replays: int = 0,
        journal_spill: Optional[str] = None,
        stall_factor: float = 16.0,
        stall_min_s: float = 10.0,
        stall_warmup_s: float = 0.0,
        device=None,
        **kwargs,
    ) -> "SchedulerBackend":
        from .backends import refuse_unported_load, resolve_stop_ids

        refuse_unported_load(mesh, quantize_int8, quantize_int4,
                             quantize_unembed8, speculative_draft)
        unported = [
            (kv_overcommit not in (None, 1.0), "kv_overcommit"),
            (kv_spill, "kv_spill"), (kv_watermark_low, "kv_watermark_low"),
            (kv_watermark_high, "kv_watermark_high"),
        ]
        for on, name in unported:
            if on:
                raise NotImplementedError(
                    f"{name} is not ported: ROADMAP A7.4 (overcommit, "
                    f"spill and watermarks)")
        if max_queue_depth:
            raise NotImplementedError(
                "max_queue_depth is not ported: ROADMAP A7.6 (scheduler "
                "admission control)")
        cfg, params = load(dtype, resolve_device(device))
        if quantize_int4:
            from ..ops.quant import quantize_params_int4

            params = quantize_params_int4(params)
        stops = (tuple(stop_ids) if stop_ids is not None
                 else resolve_stop_ids(cfg, tokenizer))

        def make_sched():
            # A factory, not an instance: the supervisor rebuilds from the
            # SAME loaded (and quantized) params after a crash: one read
            # of the checkpoint per process, not per restart.
            return ContinuousBatchingScheduler(
                cfg, params, num_slots=num_slots, max_seq=max_seq,
                decode_chunk=decode_chunk, prompt_bucket=prompt_bucket,
                stop_ids=stops, kv_quant=kv_quant, kv_layout=kv_layout,
                kv_page_size=kv_page_size, kv_pages=kv_pages,
                kv_hbm_budget_bytes=kv_hbm_budget_bytes,
                device=params["final_norm"].device)

        if supervise:
            from .supervisor import SupervisedScheduler

            return cls(SupervisedScheduler(
                make_sched, max_restarts=max_restarts,
                max_entry_replays=max_entry_replays,
                spill_path=journal_spill,
                stall_factor=stall_factor, stall_min_s=stall_min_s,
                warmup_grace_s=stall_warmup_s, name=f"scheduler:{tag}",
            ), tokenizer, **kwargs)
        return cls(make_sched(), tokenizer, **kwargs)

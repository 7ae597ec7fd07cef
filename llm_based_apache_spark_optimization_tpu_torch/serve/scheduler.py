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
  `prompt_bucket`) for up to 8 same-bucket admissions per forward, one
  layer at a time (no view of all layers is built). The contiguous layout
  runs it over the slots' own cache rows (`forward(rows=...)`); the paged
  layout over each layer's view of the slots' pages below the chunk's end,
  gathered through their table rows, the chunk's window written back
  through the page-write kernel (`forward(span=...)`). The final chunk
  samples the first token.
- Ragged mixed rounds (`ragged=True`, or `LSOT_RAGGED=1`; paged only,
  `prompt_bucket` capped at 32): a round's first step is one forward over
  this iteration's prompt chunks and the decode slots together (per-row
  `q_lens`: a chunk row's bucket, 1 for the others, whose dead columns
  write nothing and read zeros), then the usual T=1 steps. While no slot
  decodes, the chunks run that first step alone (a ragged prefill): the
  same forward, none of the T=1 steps that no slot would read (the JAX
  round runs them inside one compiled program; here each is dispatched
  from the host, and a lone request paid them on every chunk). Each
  request's tokens are the alternating scheduler's; only round boundaries
  move (over an int8 pool a chunk then attends to its own K/V as stored,
  in int8, whether or not a slot decodes beside it).
- Decode rounds: `decode_chunk` T=1 steps of the whole slot batch, with
  `kv_lens = pos + 1` for active slots and 0 for parked ones (parked slots
  read nothing and write at the parking position, `max_seq - 1`, which no
  query can see). Contiguous: each layer's flash GQA decode kernel over
  the slots' rows; paged: the fused page write and ragged paged attention
  kernels.
- Deadlines: a request submitted with `deadline_s` fails with
  `DeadlineExceeded` at admission if it expired while queued (or waiting
  for pages), or at the next harvest once in flight.
- Admission control: past `max_queue_depth` queued requests a submit
  sheds with `Overloaded`, its `retry_after_s` the queue's depth x the
  service-time EWMA of completed requests / slots, in [1, 60] s. A slot
  that appends nothing for `slot_stall_rounds` harvested rounds while the
  loop is live retires with `SlotStalled` (`sched:slot_stall` seam).
- Page pressure (paged; each knob defaults to its `LSOT_KV_*` variable):
  `kv_overcommit` < 1 reserves part of a request's budget at admission
  and tops pages up at each harvest; a top-up the pool cannot fund
  preempts a victim (fewest generated tokens first), which resumes ahead
  of the queue from its committed tokens: by re-prefilling prompt +
  generated, or with `kv_spill` by restoring host copies of its pages
  (`engine/paged_kv.export_pages`, scales included: bit-exact). Its
  sample index is restored from the host mirror, so greedy and sampled
  continuations are the unpreempted ones. Below `kv_watermark_low` x the
  pool of grantable pages, prefix-cache entries are evicted up to the high
  watermark. `kv:pressure` withholds pages (chaos seam). Pages freed by a
  preemption may be written by the victim's rounds still in flight; those
  writes run first in stream order and the next owner writes each
  position before any query reads it.
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

- Token streaming: `SchedulerBackend.complete_stream` yields text chunks
  as tokens are harvested, joining to exactly the blocking text (partial
  multi-byte sequences and a stop text's tail held back); closing it
  cancels the request.

- Grammar constraints (`submit(constraint=...)`, a compiled
  `constrain.CompiledMask`): each slot carries its FSM state and remaining
  budget on the device (`_cstates`, `_crem`; state 0 is the grammar's
  all-allowed sentinel, where unconstrained slots sit). A round with a
  constrained slot masks each step's logits to `need[state] <= remaining`
  and advances the states of the active slots; a final prefill chunk
  masks a constrained request's first token to `need[init] <= budget`
  (chunk rows of a mixed round likewise, decode rows at their state).
  One grammar's tables are installed at a time: a request with another
  grammar waits in `_constraint_wait` until the constrained slots drain,
  then the tables swap (`grammar_swaps`), one swap per grammar change.
  A resumed request re-derives its state by walking its committed
  tokens. Rounds without a constrained slot run no grammar op.

Not ported yet: speculation (A9, with its grammar-threaded verify
window; `constrain.fsm_advance_chain` is its primitive), phase roles and handoff
(A7.5), `SchedulerPool` (A7.10), profiling and the flight recorder's
rounds (A7.7), prefix telemetry (A7.8), tenant QoS (A11) and meshes
(A7.12, A13).
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
    export_pages,
    import_pages,
    init_page_pool,
    page_bytes,
    pages_for_budget,
    pages_for_tokens,
)
from ..models.configs import LlamaConfig
from ..models.llama import _UNROLL_MAX_T, Params, forward
from ..constrain.masks import (
    advance_states,
    allowed_tokens,
    trivial_tables,
)
from ..ops.sampling import SamplingParams, apply_token_mask, greedy, sample_runtime
from .backends import Completion, trim_stop_texts
from ..utils.faults import FAULTS, InjectedFault
from ..utils.observability import resilience
from .resilience import (
    Deadline,
    DeadlineExceeded,
    Overloaded,
    SchedulerCrashed,
    SlotStalled,
)
from .watchdog import Heartbeat

_M32 = 0xFFFFFFFF


def _env_on(name: str) -> bool:
    return os.environ.get(name, "0").strip().lower() in ("1", "true", "yes", "on")


def _first_token_timer(then: Optional[Callable[[int], None]] = None):
    """(on_token, first_at): on_token records the worker-thread harvest time
    of the request's first accepted token into first_at, then passes every
    token on to `then`."""
    first_at: List[float] = []

    def on_tok(tok: int) -> None:
        if not first_at:
            first_at.append(time.perf_counter())
        if then is not None:
            then(tok)

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
    # Grammar constraint (constrain.CompiledMask); None: free decoding.
    constraint: Optional[object] = None
    # Submit wall clock: the service-time EWMA behind retry_after_hint.
    submitted_at: float = 0.0
    # Slot stall retirement: consecutive harvested rounds in which this
    # slot appended nothing while the loop stayed live; `stall_inject` is
    # the `sched:slot_stall` chaos seam (the harvest reads the slot's row
    # as empty).
    stall_rounds: int = 0
    stall_inject: bool = False
    # Preemption: `resume_pref` committed generated tokens join the prompt
    # for the next admission (recompute resume re-prefills them);
    # `rng_count` mirrors the slot's sample index at the last harvest (the
    # resume restores it, so a sampled continuation draws what the
    # unpreempted control draws); `spilled` holds the host page copies of
    # a spill resume (`export_pages`).
    resume_pref: int = 0
    rng_count: int = 0
    spilled: Optional[Tuple] = None

    @property
    def full_ids(self) -> List[int]:
        """The prefill prefix: the prompt, plus after a preemption the
        committed tokens a recompute resume re-runs (generated token j sits
        at position len(ids) + j in both incarnations)."""
        if not self.resume_pref:
            return self.ids
        return self.ids + self.generated[: self.resume_pref]

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
        max_queue_depth: int = 0,
        slot_stall_rounds: int = 16,
        kv_overcommit: Optional[float] = None,
        kv_spill: Optional[bool] = None,
        kv_watermark_low: Optional[float] = None,
        kv_watermark_high: Optional[float] = None,
        ragged: Optional[bool] = None,
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
        # Admission control: a submit past this many queued requests sheds
        # with a typed Overloaded (0: unbounded).
        self.max_queue_depth = int(max_queue_depth)
        # A slot that appends nothing for this many harvested rounds while
        # the loop stays live retires with SlotStalled (0: never).
        self.slot_stall_rounds = int(slot_stall_rounds)
        self._slot_stalls = 0
        # EWMAs of completed requests' submit->retire wall (the Retry-After
        # estimate) and, paged, of their generation lengths (what overcommit
        # admission reserves).
        self._svc_ewma: Optional[float] = None
        self._gen_ewma: Optional[float] = None
        if ragged is None:
            # The env opt-in degrades silently where the round cannot run.
            ragged = _env_on("LSOT_RAGGED") and self._paged
        elif ragged and not self._paged:
            raise ValueError(
                "ragged mixed rounds need kv_layout='paged' (prefill rows "
                "scatter chunks through page tables)")
        self._ragged = bool(ragged)
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
        if self._ragged:
            # A mixed round runs its prompt chunks through the paged
            # small-T path: chunks cap at its bound.
            self.prompt_bucket = min(self.prompt_bucket, _UNROLL_MAX_T)
        self.stop_ids = tuple(stop_ids) if stop_ids is not None else cfg.stop_ids
        dtype = params["final_norm"].dtype
        self._dtype = dtype

        dev = self.device
        self._page_wait: "deque[_Request]" = deque()
        if self._paged:
            self._init_paged(kv_page_size, kv_pages, kv_hbm_budget_bytes)
            self._init_pressure(kv_overcommit, kv_spill, kv_watermark_low,
                                kv_watermark_high)
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
        # Per-slot grammar FSM state and remaining budget. crem rests at 1
        # on parked slots: the sentinel row's need is 1, so `need <= crem`
        # allows everything there.
        self._cstates = torch.zeros(num_slots, dtype=torch.int32, device=dev)
        self._crem = torch.ones(num_slots, dtype=torch.int32, device=dev)
        # The installed grammar and its device tables (the one-row sentinel
        # tables while none is installed); requests with another grammar
        # wait in `_constraint_wait` for the constrained slots to drain.
        self._constraint = None
        self._ctables = trivial_tables(dev)
        self._constraint_wait: "deque[_Request]" = deque()
        #: Grammar table installs (one per grammar change).
        self.grammar_swaps = 0
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
        #: decode_chunk forwards; each prefill forward one flash prefill
        #: launch per layer on the card). `mixed_rounds` counts the rounds
        #: of `rounds_issued` that were ragged mixed rounds: their first
        #: step is one forward over this round's prompt chunks and the
        #: decode slots together (one ragged attention and one page write
        #: a layer, at T = the chunk's bucket), the other decode_chunk - 1
        #: steps are the usual T = 1 steps. `ragged_prefills` counts the
        #: first steps a ragged scheduler ran alone, no slot decoding (not
        #: rounds: no T = 1 step follows).
        self.rounds_issued = 0
        self.prefill_forwards = 0
        self.mixed_rounds = 0
        self.ragged_prefills = 0

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
        self._cstates[slot] = 0
        self._crem[slot] = 1

    def _arm_slot(self, slot: int, req: _Request, tok, pos: int, count: int,
                  cstate, crem: int) -> None:
        """Arm a slot for decode: its next input token `tok` (a device
        scalar or an int) at position `pos`, its sampling knobs, its RNG
        stream at index `count`, its grammar state `cstate` (a device scalar
        or an int) and its remaining grammar budget `crem`."""
        self._cur[slot] = tok
        self._cstates[slot] = cstate
        self._crem[slot] = crem
        self._pos[slot] = pos
        self._temps[slot] = req.temperature
        self._topps[slot] = req.top_p
        self._topks[slot] = req.top_k
        self._seeds[slot] = req.seed & _M32
        self._counts[slot] = count

    def _retire_slot(self, slot: int) -> None:
        """Reset a retired slot's sampling knobs and grammar state."""
        self._temps[slot] = 0.0
        self._topps[slot] = 1.0
        self._topks[slot] = 0
        self._cstates[slot] = 0

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

    def _init_pressure(self, kv_overcommit, kv_spill, kv_watermark_low,
                       kv_watermark_high) -> None:
        """Page-pressure relief, each knob defaulting to its environment
        variable as in the JAX scheduler. `kv_overcommit` < 1 reserves
        min(budget, max(ratio x budget, expected generation)) at admission
        and tops pages up at each harvest; a failed top-up preempts a
        victim, resumed by re-prefilling prompt + committed tokens, or with
        `kv_spill` by restoring host copies of its pages. Below the low
        watermark of free pages the loop evicts prefix-cache entries until
        the high one (low 0: off)."""
        if kv_overcommit is None:
            kv_overcommit = float(os.environ.get("LSOT_KV_OVERCOMMIT", "1.0"))
        if not 0.0 < kv_overcommit <= 1.0:
            raise ValueError(f"kv_overcommit must be in (0, 1], got {kv_overcommit}")
        self._kv_overcommit = float(kv_overcommit)
        self._kv_spill = bool(_env_on("LSOT_KV_SPILL") if kv_spill is None
                              else kv_spill)
        if kv_watermark_low is None:
            kv_watermark_low = float(os.environ.get("LSOT_KV_WATERMARK_LOW", "0.0"))
        if kv_watermark_high is None:
            kv_watermark_high = float(os.environ.get("LSOT_KV_WATERMARK_HIGH", "0.0"))
        if not 0.0 <= kv_watermark_low <= 1.0 or \
                not 0.0 <= kv_watermark_high <= 1.0 or \
                kv_watermark_high < kv_watermark_low:
            raise ValueError(
                f"kv watermarks must satisfy 0 <= low <= high <= 1, "
                f"got low={kv_watermark_low} high={kv_watermark_high}")
        num_pages = self._page_alloc.num_pages
        self._wm_low_pages = int(kv_watermark_low * num_pages)
        self._wm_high_pages = max(self._wm_low_pages,
                                  int(kv_watermark_high * num_pages))

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
        """Generation tokens admission reserves. Exact mode (kv_overcommit
        = 1.0, the default): the whole remaining budget. Overcommitted:
        min(budget, max(ratio x budget, the EWMA of completed generation
        lengths less what the request already generated)); decode tops up
        at each harvest and a failed top-up preempts."""
        remaining = max(0, req.max_new - len(req.generated))
        r = self._kv_overcommit
        if r >= 1.0 or remaining == 0:
            return remaining
        floor = -int(-remaining * r // 1)  # ceil
        expect = 0
        if self._gen_ewma is not None:
            expect = max(0, -int(-self._gen_ewma // 1) - len(req.generated))
        return min(remaining, max(1, floor, expect))

    # ------------------------------------------------------ pressure relief

    def _sample_pressure(self) -> None:
        """Chaos seam: the value-valued `kv:pressure` site withholds part
        of the pool (a fraction when the value < 1, a page count otherwise)
        for every loop iteration it fires."""
        if not FAULTS.active:
            if self._page_alloc.withheld:
                self._page_alloc.withhold(0)
            return
        v = FAULTS.value("kv:pressure")
        if v is None:
            self._page_alloc.withhold(0)
            return
        total = self._page_alloc.num_pages
        self._page_alloc.withhold(int(v * total) if v < 1.0 else int(v))

    def _watermark_sweep(self) -> None:
        """Below the low watermark of grantable pages, evict LRU prefix
        entries until the high one recovers (or the cache is empty)."""
        if not self._wm_low_pages or \
                self._page_alloc.pages_available >= self._wm_low_pages:
            return
        evicted = 0
        while self._prefix_pages and \
                self._page_alloc.pages_available < self._wm_high_pages:
            self._prefix_evict(*self._prefix_pages.popitem(last=False))
            evicted += 1
        if evicted:
            self._page_alloc.note_evictions(evicted)
            resilience.inc("kv_evictions")

    def _preempt_slot(self, slot: int) -> None:
        """Release a victim's slot and pages and queue it to resume first.
        Spill mode copies its committed pages to the host first (the copy
        waits for the rounds in flight, whose writes past the committed
        positions ride along as garbage the resumed decode overwrites
        before any read); recompute mode re-prefills prompt + committed
        tokens at re-admission."""
        req = self._slot_req[slot]
        if self._kv_spill and req.generated:
            plen = len(req.ids) + len(req.generated)
            npg = min(pages_for_tokens(plen, self._page_size),
                      len(self._slot_pages[slot]))
            req.spilled = export_pages(self._pool, self._slot_pages[slot][:npg])
            self._page_alloc.note_spill(npg)
        req.resume_pref = len(req.generated)
        req.ready = False
        req.prefilled = 0
        self._slot_req[slot] = None
        self._slot_epoch[slot] += 1
        # A queued chunk of the victim must not run for a later incarnation
        # in the same slot.
        self._prefill_q = deque((s, r) for s, r in self._prefill_q if r is not req)
        self._retire_slot(slot)
        self._free_slot_pages(slot)
        self._page_alloc.note_preempt()
        resilience.inc("kv_preemptions")
        self._page_wait.appendleft(req)

    def _preempt_for(self, n_pages: int, protect: int) -> Optional[List[int]]:
        """Fund a failed allocation by preempting victims, fewest generated
        tokens first, never slot `protect`, until it succeeds or no victim
        is left."""
        while True:
            got = self._alloc_pages(n_pages)
            if got is not None:
                return got
            victims = sorted((len(r.generated), i) for i, r in enumerate(self._slot_req)
                             if r is not None and i != protect)
            if not victims:
                return None
            self._preempt_slot(victims[0][1])

    def _topup_pages(self) -> None:
        """Keep each decoding slot's pages ahead of what the device can
        write before the next harvest (committed position + overshoot), so
        no decode write lands on an unmapped entry. Exact admission prepaid
        the budget, so this allocates nothing there. A top-up the pool
        cannot fund preempts a victim, or else the slot itself."""
        overshoot, ps = self.overshoot, self._page_size
        for i in range(self.num_slots):
            req = self._slot_req[i]
            if req is None or not req.ready:
                continue
            target = len(req.ids) + len(req.generated) + overshoot
            need = pages_for_tokens(target, ps) - len(self._slot_pages[i])
            if need <= 0:
                continue
            got = self._alloc_pages(need)
            if got is None:
                got = self._preempt_for(need, i)
            if got is None:
                self._preempt_slot(i)
                continue
            self._slot_pages[i].extend(got)
            self._sync_ptab_row(i)
            req.page_end = max(req.page_end, len(self._slot_pages[i]) * ps)

    def _resume_ready(self, slot: int, req: _Request) -> None:
        """Arm a resumed slot from its committed state: the last committed
        token fed again at its own position (its K/V rewrite is the same
        value), the sample index restored from the host mirror, the grammar
        state re-derived by walking the committed tokens."""
        plen = len(req.full_ids)
        cstate0 = 0
        if req.constraint is not None:
            cstate0 = req.constraint.walk(req.generated)
            if cstate0 is None:
                # Committed tokens came out of the masked decode: a dead
                # walk means corrupted state, never resume into a wrong row.
                raise RuntimeError(
                    f"resume FSM replay left the grammar after "
                    f"{len(req.generated)} committed tokens")
        self._arm_slot(slot, req, req.generated[-1], plen - 1, req.rng_count,
                       cstate0, max(0, req.max_new - len(req.generated)))
        req.ready = True
        # Decode rewrites [plen - 1, page_end): copy any page the
        # re-prefill's publish shared.
        self._ensure_writable(slot, max(0, plen - 1), req.page_end)

    def _restore_spilled(self, slot: int, req: _Request) -> None:
        """Spill resume: write the host page copies (values and, in an int8
        pool, scales) into the fresh pages and arm the slot; no forward."""
        n = req.spilled[0].shape[1]
        import_pages(self._pool, self._slot_pages[slot][:n], req.spilled)
        self._page_alloc.note_restore(n)
        req.spilled = None
        req.prefilled = len(req.full_ids)
        self._resume_ready(slot, req)

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
        or at the next harvest once in flight. With a grammar `constraint`
        (constrain.CompiledMask) every token is masked to the compiled
        language and the completion parses; a request with another grammar
        than the installed one waits for the constrained slots to drain."""
        if constraint is not None and max_new_tokens < constraint.min_new_tokens:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} cannot hold a complete "
                f"constrained parse (grammar needs >= "
                f"{constraint.min_new_tokens} tokens incl. the stop id)")
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
            on_token=on_token, constraint=constraint,
            deadline=Deadline.after(deadline_s) if deadline_s is not None else None,
        )
        req.future._lsot_request = req  # cancel() handle
        try:
            # Chaos seam, on the submitting thread so a test can wedge
            # exactly the requests it means to: this request's lane
            # produces nothing (slot stall retirement).
            FAULTS.check("sched:slot_stall")
        except InjectedFault:
            req.stall_inject = True
        with self._submit_lock:
            if self._closed:
                if self._crash is not None:
                    raise self._crash_error()
                raise RuntimeError("scheduler has shut down")
            if self._thread is None:
                raise RuntimeError(
                    "scheduler not started — call start() or use it as a "
                    "context manager (a queued Future would never resolve)")
            # Admission control: shed instead of queueing without bound.
            if self.max_queue_depth and self._queue.qsize() >= self.max_queue_depth:
                resilience.inc("shed")
                raise Overloaded(
                    f"scheduler queue at capacity ({self.max_queue_depth} "
                    f"waiting requests)", retry_after_s=self.retry_after_hint())
            req.submitted_at = time.perf_counter()
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

    def retry_after_hint(self) -> float:
        """Seconds a shed client should wait: the queue's depth (plus the
        retry itself) x the recent per-request service time / slots,
        clamped to [1, 60]; 1 until a completion seeds the estimate.
        Lock-free: submit calls it holding the submit lock."""
        ewma = self._svc_ewma
        if ewma is None:
            return 1.0
        depth = self._queue.qsize() + 1
        return float(min(60.0, max(1.0, depth * ewma / max(1, self.num_slots))))

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
        out["overcommit"] = self._kv_overcommit
        out["spill"] = int(self._kv_spill)
        out["watermark_low_pages"] = self._wm_low_pages
        out["watermark_high_pages"] = self._wm_high_pages
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

    def _constrained_busy(self) -> bool:
        return any(r is not None and r.constraint is not None for r in self._slot_req)

    def _grammar_matches(self, c) -> bool:
        """Can the installed tables serve `c`? Content identity (fingerprint
        and stop ids), not object identity: the compile cache is an LRU, so
        the same grammar can come back as a fresh object after an eviction."""
        inst = self._constraint
        return inst is not None and (
            c is inst or (c.fingerprint == inst.fingerprint
                          and c.eos_ids == inst.eos_ids))

    def _install_constraint(self, compiled) -> None:
        """Swap in a grammar's device tables (worker thread only; callers
        guarantee no constrained slot is live, so no FSM state indexes the
        wrong table; rounds in flight keep the tables they were issued
        with)."""
        self._constraint = compiled
        self._ctables = compiled.device_tables(self.cfg.vocab_size, self.device)
        self.grammar_swaps += 1

    def _admit_paged(self, slot: int, req: _Request) -> bool:
        """Allocate the request's page envelope and map any cached prefix
        zero-copy (one-page copy-on-write only when the matched prefix ends
        mid-page). Returns False, with no side effects, when the pool
        cannot fund the envelope now."""
        ps, pb = self._page_size, self._pblock
        ids = req.full_ids  # prompt + committed tokens after a preemption
        plen = len(ids)
        s_virt = self._pages_per_slot * ps
        n = 0
        # A spill resume restores its pages' content into fresh exclusive
        # pages: it maps no shared prefix.
        if self._prefix_cache_blocks and req.spilled is None:
            max_blocks = (plen - 1) // pb
            while n < max_blocks and tuple(ids[: (n + 1) * pb]) in self._prefix_pages:
                n += 1
            # A reuse offset shifts every chunk start; the final chunk's
            # bucket must still land inside the virtual row.
            while n and self._chunk_end(n * pb, plen) > s_virt:
                n -= 1
        reuse = n * pb
        # Clamped to the slot's row: a resume's prompt re-rounds to the next
        # bucket and can push the raw envelope past max_seq, though every
        # real write stays below it.
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
        if self._prefix_cache_blocks and req.spilled is None:
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
        if req.spilled is not None:
            # Spill resume: restore the pages and arm the slot; no prefill.
            self._restore_spilled(slot, req)
            return True
        if not self._paged and self._prefix_cache_blocks:
            self._admit_blocks(slot, req)
        self._prefill_q.append((slot, req))
        return True

    def _next_bucket(self, req: _Request) -> int:
        remaining = len(req.full_ids) - req.prefilled
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

    def _take_group(self) -> Tuple[List[Tuple[int, _Request]], int]:
        """Up to `_prefill_kmax` queued prefill entries of one bucket, in
        arrival order (entries of a slot since preempted or retired drop),
        and that bucket."""
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
        return group, t

    def _chunk_rows(self, group, t: int):
        """(tokens [k][t], live lengths, starts) of each row's next chunk."""
        tokens, lengths, starts = [], [], []
        for _, req in group:
            chunk_ids = req.full_ids[req.prefilled: req.prefilled + t]
            tokens.append(chunk_ids + [self.cfg.pad_id] * (t - len(chunk_ids)))
            lengths.append(len(chunk_ids))
            starts.append(req.prefilled)
        return tokens, lengths, starts

    @staticmethod
    def _chunk_grammar(group, lengths) -> Tuple[List[int], List[int]]:
        """Per row of `group` (chunks of `lengths` tokens), the grammar
        state and budget its first token is masked under: the grammar's
        start state and the request's budget on a constrained request's
        final chunk, the sentinel (0, 1) elsewhere, a resume's final chunk
        included (its sample is dropped)."""
        cinits, cbudgets = [], []
        for (_, req), n in zip(group, lengths):
            con = (req.constraint is not None and not req.resume_pref
                   and req.prefilled + n >= len(req.full_ids))
            cinits.append(req.constraint.init_state if con else 0)
            cbudgets.append(req.max_new if con else 1)
        return cinits, cbudgets

    def _grammar_step(self, active: torch.Tensor, cstates: torch.Tensor,
                      crem: torch.Tensor, tok: torch.Tensor):
        """Advance the active slots' grammar states by their tokens and
        spend one unit of their budgets; parked slots keep theirs."""
        return (torch.where(active, advance_states(self._ctables["next"], cstates, tok),
                            cstates),
                torch.where(active, crem - 1, crem))

    def _prefill_forward(self, group, t: int) -> torch.Tensor:
        """One prompt chunk for each (slot, req) of `group` in one forward.
        Returns the first-token samples [k] (used on final chunks), a
        constrained request's masked to its grammar."""
        cfg = self.cfg
        tokens, lengths, starts = self._chunk_rows(group, t)
        tokens_t = self._h2d(tokens, torch.int32)
        positions = (self._h2d(starts, torch.int32)[:, None]
                     + torch.arange(t, dtype=torch.int32, device=self.device))
        last = self._h2d(lengths, torch.int64) - 1
        span = max(starts) + t
        if self._paged:
            # One layer's view of the rows' pages at a time, over the
            # positions below the chunks' end; the chunk window goes back
            # into the pool through the page write.
            num_pages = self._page_alloc.num_pages
            rows = [self._slot_pages[s] + [num_pages] * (
                self._pages_per_slot - len(self._slot_pages[s])) for s, _ in group]
            cache = dict(self._pool, ptab=self._h2d(rows, torch.int32))
            logits, _ = forward(cfg, self.params, tokens_t, positions, cache,
                                logit_indices=last, span=span)
        else:
            # Over the slots' own cache rows, one layer at a time, reading
            # the slots below the chunks' end (rounded up to 64).
            logits, _ = forward(cfg, self.params, tokens_t, positions,
                                self._cache, logit_indices=last,
                                rows=self._h2d([s for s, _ in group], torch.int64),
                                span=span + -span % 64)
        self.prefill_forwards += 1
        first = logits[:, 0]
        cinits, cbudgets = self._chunk_grammar(group, lengths)
        if any(cinits):
            first = apply_token_mask(first, allowed_tokens(
                self._ctables["need"], self._h2d(cinits, torch.int32),
                self._h2d(cbudgets, torch.int32), first.shape[-1]))
        reqs = [req for _, req in group]
        if all(r.temperature <= 0.0 for r in reqs):
            return greedy(first)
        return sample_runtime(
            first,
            self._h2d([r.temperature for r in reqs], torch.float32),
            self._h2d([r.top_p for r in reqs], torch.float32),
            self._h2d([r.top_k for r in reqs], torch.int32),
            self._h2d([r.seed & _M32 for r in reqs], torch.int64),
            torch.zeros(len(reqs), dtype=torch.int64, device=self.device),
        )

    def _prefill_step(self) -> None:
        """Run ONE prompt chunk for up to `_prefill_kmax` waiting requests
        of the same bucket in a single forward (chunked prefill interleaves
        with decode rounds instead of stalling every active slot)."""
        group, t = self._take_group()
        if not group:
            return
        if self._paged:  # copy-on-write sweep over each chunk's write window
            for slot, req in group:
                self._ensure_writable(slot, req.prefilled, req.prefilled + t)
        self._after_chunk(group, t, self._prefill_forward(group, t))

    def _after_chunk(self, group, t: int, toks) -> None:
        """The host side of a `t`-bucket chunk for each (slot, req) of
        `group`: publish its prefix blocks, queue its next chunk, or arm the
        slot: with the still-on-device first token `toks[i]`, attached to
        the next harvest; a resume from its committed state instead."""
        for i, (slot, req) in enumerate(group):
            chunk_start = req.prefilled
            req.prefilled = min(chunk_start + t, len(req.full_ids))
            if self._prefix_cache_blocks:
                if self._paged:
                    self._publish_blocks_paged(slot, req, chunk_start)
                else:
                    self._publish_blocks(slot, req, chunk_start)
            if req.prefilled < len(req.full_ids):
                self._prefill_q.append((slot, req))
                continue
            if req.resume_pref:
                # Recompute resume: the K/V is rebuilt; the chunk's sample
                # is dropped and decode continues from the committed token.
                self._resume_ready(slot, req)
                continue
            # No sync: stop/budget checks on the first token happen at the
            # harvest it rides, one round late.
            req.ready = True
            if self._paged:
                # Decode writes [len(ids), page_end): the final chunk's
                # publish may have shared the page holding the prompt tail.
                self._ensure_writable(slot, len(req.ids), req.page_end)
            # Index 1 of its stream: the prefill sample used index 0. The
            # first token advances a constrained request's FSM from the
            # grammar's start state and spends one unit of its budget.
            cstate = 0
            if req.constraint is not None:
                cstate = advance_states(
                    self._ctables["next"],
                    torch.full((1,), req.constraint.init_state,
                               dtype=torch.int32, device=self.device),
                    toks[i].reshape(1))[0]
            self._arm_slot(slot, req, toks[i], len(req.ids), 1, cstate,
                           req.max_new - 1)
            req.rng_count = 1
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
        ids = req.full_ids
        for b0 in range(chunk_start // pb, req.prefilled // pb):
            key = tuple(ids[: (b0 + 1) * pb])
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

    def _decode_round(self, active: torch.Tensor, sampled: bool,
                      grammar: bool) -> torch.Tensor:
        """`decode_chunk` T=1 steps of the whole slot batch over the cache
        or the pool; returns the tokens [slots, chunk] (device)."""
        return self._decode_steps(active, sampled, grammar, self._cur, self._pos,
                                  self._cstates, self._crem, 0, [])

    def _decode_steps(self, active: torch.Tensor, sampled: bool, grammar: bool,
                      cur: torch.Tensor, pos: torch.Tensor, cstates: torch.Tensor,
                      crem: torch.Tensor, first: int, toks: List[torch.Tensor]
                      ) -> torch.Tensor:
        """T=1 steps `first`..decode_chunk-1 from (cur, pos), step i
        sampling each active slot's stream at index counts + i; `toks`
        holds the tokens of the steps before `first`. With `grammar` each
        step's logits are masked to `need[cstates] <= crem` and the active
        slots' states advance. Returns [slots, chunk]."""
        cache = dict(self._pool, ptab=self._ptab) if self._paged else self._cache
        for i in range(first, self.decode_chunk):
            logits, _ = forward(
                self.cfg, self.params, cur[:, None], pos[:, None], cache,
                # Parked slots read nothing; live slots up to their position.
                kv_lens=torch.where(active, pos + 1, 0),
            )
            step = logits[:, 0]
            if grammar:
                step = apply_token_mask(step, allowed_tokens(
                    self._ctables["need"], cstates, crem, step.shape[-1]))
            if sampled:
                nxt = sample_runtime(step, self._temps, self._topps,
                                     self._topks, self._seeds, self._counts + i)
            else:
                nxt = greedy(step)
            cur = torch.where(active, nxt, self.cfg.pad_id)
            pos = torch.where(active, pos + 1, pos)
            if grammar:
                cstates, crem = self._grammar_step(active, cstates, crem, cur)
            toks.append(cur)
        self._cur, self._pos = cur, pos
        self._cstates, self._crem = cstates, crem
        # Every active slot consumed `chunk` samples of its stream.
        self._counts = torch.where(active, self._counts + self.decode_chunk,
                                   self._counts)
        return torch.stack(toks, dim=1)

    def _mixed_step(self, group, t: int, active: torch.Tensor, sampled: bool,
                    grammar: bool) -> torch.Tensor:
        """Step 0 of a ragged mixed round: ONE forward at T = t over every
        slot, the chunk rows of `group` carrying their chunk (q_lens t) and
        the other rows their current token in column 0 (q_lens 1; dead
        columns write nothing and read zeros). Chunk rows sample their
        first token at index 0 of their stream, decode rows at counts, as
        the alternating rounds do; with `grammar`, chunk rows under their
        `_chunk_grammar` state and budget, decode rows under their own.
        Returns the samples [slots]."""
        cfg, dev, num_slots = self.cfg, self.device, self.num_slots
        pad = cfg.pad_id
        s_virt = self._pages_per_slot * self._page_size
        tokens, lengths, starts = self._chunk_rows(group, t)
        p_tokens = [[pad] * t for _ in range(num_slots)]
        p_lengths, p_starts = [1] * num_slots, [0] * num_slots
        is_pref = [False] * num_slots
        knobs = [[0.0] * num_slots, [1.0] * num_slots, [0] * num_slots, [0] * num_slots]
        for i, (slot, req) in enumerate(group):
            p_tokens[slot], p_lengths[slot], p_starts[slot] = tokens[i], lengths[i], starts[i]
            is_pref[slot] = True
            for row, v in zip(knobs, (req.temperature, req.top_p, req.top_k,
                                      req.seed & _M32)):
                row[slot] = v
        pref = self._h2d(is_pref, torch.bool)
        p_start = self._h2d(p_starts, torch.int32)
        col = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
        cur, pos = self._cur, self._pos
        tokens0 = torch.where(pref[:, None], self._h2d(p_tokens, torch.int32),
                              torch.where(col == 0, cur[:, None], pad))
        # Dead decode columns sit at the virtual row's end: their writes
        # drop and the mask keeps their logits finite.
        pos0 = torch.where(pref[:, None], p_start[:, None] + col,
                           torch.where(col == 0, pos[:, None], s_virt))
        kv0 = torch.where(pref, (p_start + t).clamp(0, s_virt),
                          torch.where(active, pos + 1, 0))
        q_lens = torch.where(pref, t, 1).to(torch.int32)
        last = torch.where(pref, self._h2d(p_lengths, torch.int64) - 1, 0)
        logits, _ = forward(cfg, self.params, tokens0, pos0,
                            dict(self._pool, ptab=self._ptab),
                            logit_indices=last, kv_lens=kv0, q_lens=q_lens)
        first = logits[:, 0]
        if grammar:
            p_cinits, p_cbudgets = [0] * num_slots, [1] * num_slots
            for (slot, _), ci, cb in zip(group, *self._chunk_grammar(group, lengths)):
                p_cinits[slot], p_cbudgets[slot] = ci, cb
            m_states = torch.where(pref, self._h2d(p_cinits, torch.int32), self._cstates)
            m_rem = torch.where(pref, self._h2d(p_cbudgets, torch.int32), self._crem)
            first = apply_token_mask(first, allowed_tokens(
                self._ctables["need"], m_states, m_rem, first.shape[-1]))
        if sampled:
            temps, topps, topks, seeds = (
                torch.where(pref, self._h2d(v, dt), cur_v) for v, dt, cur_v in zip(
                    knobs, (torch.float32, torch.float32, torch.int32, torch.int64),
                    (self._temps, self._topps, self._topks, self._seeds)))
            return sample_runtime(first, temps, topps, topks, seeds,
                                  torch.where(pref, 0, self._counts))
        return greedy(first)

    def _mixed_round(self, group, t: int, active: torch.Tensor, sampled: bool,
                     grammar: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """A ragged mixed round: `_mixed_step`, then steps 1..chunk-1, the
        usual T=1 steps, the chunk rows inactive. Returns (tokens [slots,
        chunk], step 0's samples [slots])."""
        firsts = self._mixed_step(group, t, active, sampled, grammar)
        cur = torch.where(active, firsts, self.cfg.pad_id)
        pos = torch.where(active, self._pos + 1, self._pos)
        cstates, crem = self._cstates, self._crem
        if grammar:  # decode rows commit step 0's token
            cstates, crem = self._grammar_step(active, cstates, crem, cur)
        return self._decode_steps(active, sampled, grammar, cur, pos, cstates, crem,
                                  1, [cur]), firsts

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
        grammar = any(r is not None and r.constraint is not None for r in issue_reqs)
        toks = self._decode_round(active, sampled, grammar)
        self.rounds_issued += 1
        self._pending.append((issue_reqs, list(self._slot_epoch), toks,
                              self._first_pending))
        self._first_pending = []

    def _issue_mixed(self) -> bool:
        """Enqueue one ragged mixed round (`ragged=True`): this iteration's
        prompt chunks (one bucket, arrival order, as `_prefill_step` picks
        them) ride the decode round's first step. The chunk rows' host side
        is `_prefill_step`'s; their first tokens ride this round's harvest.
        With no slot decoding, the first step runs alone (a ragged prefill)
        and the first tokens ride the next round, as a prefill chunk's do.
        Returns False, issuing nothing, when every queued entry was stale."""
        group, t = self._take_group()
        if not group:
            return False
        FAULTS.check("sched:hang")
        for slot, req in group:  # copy-on-write sweep over the windows
            self._ensure_writable(slot, req.prefilled, req.prefilled + t)
        issue_reqs = [r if r is not None and r.ready else None
                      for r in self._slot_req]
        active = self._h2d([r is not None for r in issue_reqs], torch.bool)
        sampled = any(r.temperature > 0.0 for r in issue_reqs if r is not None) \
            or any(req.temperature > 0.0 for _, req in group)
        grammar = any(r.constraint is not None for r in issue_reqs if r is not None) \
            or any(req.constraint is not None for _, req in group)
        if all(r is None for r in issue_reqs):
            firsts = self._mixed_step(group, t, active, sampled, grammar)
            self.ragged_prefills += 1
            self._after_chunk(group, t, [firsts[slot] for slot, _ in group])
            return True
        toks, firsts = self._mixed_round(group, t, active, sampled, grammar)
        self.rounds_issued += 1
        self.mixed_rounds += 1
        self._after_chunk(group, t, [firsts[slot] for slot, _ in group])
        self._pending.append((issue_reqs, list(self._slot_epoch), toks,
                              self._first_pending))
        self._first_pending = []
        return True

    # --------------------------------------------------------------- retire

    def _retire(self, slot: int, req: _Request, result: List[int]) -> None:
        self._record_service_time(req)
        req.future.set_result(result)
        self._release_slot(slot)

    def _record_service_time(self, req: _Request) -> None:
        """EWMAs (alpha 0.2) of completed requests' submit->retire wall and,
        paged, generation length; a cancelled request says nothing about
        either. Under the submit lock: retry_after_hint reads them from
        other threads."""
        if req.submitted_at <= 0.0 or req.cancelled:
            return
        wall = time.perf_counter() - req.submitted_at
        with self._submit_lock:
            prev = self._svc_ewma
            self._svc_ewma = wall if prev is None else 0.2 * wall + 0.8 * prev
            if self._paged:
                g = float(len(req.generated))
                prev_g = self._gen_ewma
                self._gen_ewma = g if prev_g is None else 0.2 * g + 0.8 * prev_g

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
        stalled = []
        for i, req in enumerate(issue_reqs):
            if req is None or req is not self._slot_req[i] \
                    or epochs[i] != self._slot_epoch[i]:
                continue  # inactive at issue, or retired or preempted since
            # The host mirror of the slot's sample index for this committed
            # round: what a preemption's resume restores.
            req.rng_count += chunk
            if req.cancelled:
                self._retire(i, req, req.generated)
                continue
            if req.past_deadline():
                resilience.inc("deadline_expired")
                self._fail_slot(i, req, req.deadline_error())
                continue
            # The `sched:slot_stall` seam: the lane produced nothing useful.
            row = [] if req.stall_inject else flat[i * chunk: (i + 1) * chunk]
            before = len(req.generated)
            done = False
            for tok in row:
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
            elif len(req.generated) > before:
                req.stall_rounds = 0
            else:
                stalled.append((i, req))
        if self.slot_stall_rounds:
            # A slot that appended nothing in a harvested round (the loop is
            # live: a wedged loop is the watchdog's case) accrues a stall
            # round; at slot_stall_rounds it retires typed.
            for i, req in stalled:
                req.stall_rounds += 1
                if req.stall_rounds >= self.slot_stall_rounds:
                    self._slot_stalls += 1
                    resilience.inc("slot_stalls")
                    self._fail_slot(i, req, SlotStalled(
                        f"slot {i} made no progress for {req.stall_rounds} "
                        f"harvested decode rounds while the loop stayed live "
                        f"({len(req.generated)} of {req.max_new} tokens "
                        f"generated before the lane wedged)"))
        if self._paged:
            # Retirements above freed pages: extend every live slot's pages
            # past its committed position + overshoot before the next round
            # can write there (a failed top-up preempts).
            self._topup_pages()
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
        for req in self._constraint_wait:  # waiting on a grammar swap
            req.future.set_exception(exc)
        self._constraint_wait.clear()
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
                    or self._constraint_wait
                    or any(r is not None for r in self._slot_req)
                    or not self._queue.empty())

    @property
    def watchdog_stats(self) -> Dict[str, object]:
        """The loop's heartbeat (age, busy, rounds, measured cadence) and
        the slots retired as stalled."""
        return {"heartbeat": self.heartbeat.snapshot(),
                "slots_retired_stalled": self._slot_stalls}

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            # Liveness stamp first, so a wedge anywhere below leaves a
            # stale busy stamp for the watchdog to age.
            self.heartbeat.stamp(busy=self._busy_now())
            if self._paged:
                # Pressure upkeep: the kv:pressure seam, the watermark sweep.
                self._sample_pressure()
                self._watermark_sweep()
            self._sweep_page_wait()
            # Admit pending requests into every free slot; page-starved
            # requests re-admit ahead of the queue, in arrival order.
            # Requests whose grammar differs from the installed one wait in
            # `_constraint_wait` until the constrained slots drain (a swap
            # must not move live FSM states between grammars), then install
            # and admit in arrival order. While waiters exist, new
            # constrained requests queue behind them too (a steady stream of
            # the installed grammar would starve them otherwise); waiters
            # of the installed grammar admit at once, and unconstrained
            # requests always flow.
            while self._free_slots():
                wait = self._constraint_wait
                if wait and self._grammar_matches(wait[0].constraint):
                    req = wait.popleft()
                elif wait and not self._constrained_busy():
                    req = wait.popleft()
                    self._install_constraint(req.constraint)
                else:
                    if self._page_wait:
                        req = self._page_wait.popleft()
                    else:
                        try:
                            req = self._queue.get_nowait()
                        except queue.Empty:
                            break
                        if req is None:
                            continue
                    c = req.constraint
                    if c is not None and (not self._grammar_matches(c) or wait):
                        if self._constrained_busy() or wait:
                            wait.append(req)
                            continue
                        self._install_constraint(c)
                if not self._admit(self._free_slots()[0], req):
                    # The pool cannot hold this envelope until live slots
                    # retire: park it at the front of the line.
                    self._page_wait.appendleft(req)
                    break
            # A ragged mixed round folds this iteration's prompt chunks into
            # the decode round's first step (run alone while no slot decodes).
            if self._ragged and self._prefill_q and self._issue_mixed():
                if len(self._pending) > self._harvest_lag:
                    self._harvest_round()
                continue
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
                if self._prefill_q or self._page_wait or self._constraint_wait \
                        or any(r is not None for r in self._slot_req):
                    continue
                try:
                    req = self._queue.get(timeout=0.05)
                    if req is not None:
                        # Fully idle: a new grammar installs at once.
                        c = req.constraint
                        if c is not None and not self._grammar_matches(c):
                            self._install_constraint(c)
                        if not self._admit(self._free_slots()[0], req):
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

    #: GenerationService forwards a `deadline_s` to backends that set this,
    #: and a `constrain` spec to backends that set `supports_constrain`.
    supports_deadline = True
    supports_constrain = True

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
        # find their results. The backend owns the tokenizer, so it is the
        # one that recompiles a journaled constraint spec: point the
        # supervisor's resolver here before recovery runs.
        if hasattr(scheduler, "constraint_resolver"):
            scheduler.constraint_resolver = self._resolve_constraint
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

    def check_budget(self, prompt: str, max_new_tokens: Optional[int] = None,
                     constraint=None) -> None:
        """Raise the ValueError `complete` would raise for a prompt that
        leaves no decode room, without submitting; with a compiled
        `constraint`, also when the clamped budget cannot hold a complete
        parse."""
        budget = self._budget(len(self.tokenizer.encode(prompt, add_bos=self.add_bos)),
                              max_new_tokens)
        if constraint is not None and budget < constraint.min_new_tokens:
            raise ValueError(
                f"decode budget {budget} (after the serving-window clamp) "
                f"cannot hold a complete constrained parse (grammar needs "
                f">= {constraint.min_new_tokens} tokens incl. the stop id)")

    def _resolve_constraint(self, constrain):
        from .backends import resolve_constraint

        return resolve_constraint(constrain, self.tokenizer, self.scheduler.stop_ids)

    def _constraint_kwargs(self, constrain) -> Dict[str, object]:
        """submit() kwargs for a constraint: the compiled tables always,
        and the serializable spec too when the scheduler is supervised (its
        journal recompiles the spec at recovery; a bare scheduler takes no
        `constraint_spec`)."""
        kwargs: Dict[str, object] = {"constraint": self._resolve_constraint(constrain)}
        if constrain is not None and hasattr(self.scheduler, "constraint_resolver"):
            kwargs["constraint_spec"] = constrain
        return kwargs

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
                idempotency_key=None, constraint_kwargs=None):
        on_tok, first_at = _first_token_timer()
        kwargs = dict(constraint_kwargs or {})
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

    def complete_stream(self, prompt: str, max_new_tokens: Optional[int] = None,
                        sampling: Optional[SamplingParams] = None, seed: int = 0,
                        stats_out: Optional[dict] = None,
                        deadline_s: Optional[float] = None, constrain=None):
        """Yield the completion as text chunks while it decodes. Each token
        re-decodes the ids so far and emits the new text, holding back a
        trailing partial multi-byte sequence (U+FFFD) and the last
        (longest stop text - 1) characters, so the chunks join to exactly
        the blocking text. A stop text ends the stream and cancels the
        request (the scheduler knows stop ids, not strings); closing the
        generator cancels it too. `stats_out` receives prompt_tokens,
        output_tokens and ttft_s."""
        ids = self.tokenizer.encode(prompt, add_bos=self.add_bos)
        if stats_out is not None:
            stats_out["prompt_tokens"] = len(ids)
        toks: "queue.Queue[int]" = queue.Queue()
        t_submit = time.perf_counter()
        on_tok, first_at = _first_token_timer(toks.put)
        fut = self.scheduler.submit(
            ids, max_new_tokens=self._budget(len(ids), max_new_tokens),
            sampling=sampling or self.sampling, seed=seed, on_token=on_tok,
            deadline_s=deadline_s if deadline_s is not None else self.deadline_s,
            **self._constraint_kwargs(constrain))
        out_ids: List[int] = []
        emitted = ""
        hold = max((len(t) for t in self.stop_texts), default=1) - 1
        try:
            done = False
            while not done:
                try:
                    out_ids.append(toks.get(timeout=0.05))
                except queue.Empty:
                    done = fut.done()
                    continue
                text = self.tokenizer.decode(out_ids)
                trimmed = trim_stop_texts(text, self.stop_texts)
                if trimmed != text:  # a stop text landed: flush and end
                    if len(trimmed) > len(emitted):
                        yield trimmed[len(emitted):]
                    self.scheduler.cancel(fut)
                    fut.result()
                    return
                safe = text[: len(text) - hold if hold else len(text)]
                delta = safe[len(emitted):]
                if delta and not delta.endswith("\ufffd"):
                    emitted += delta
                    yield delta
            fut.result()  # errors surface here
            while not toks.empty():
                out_ids.append(toks.get_nowait())
            text = trim_stop_texts(self.tokenizer.decode(out_ids), self.stop_texts)
            if len(text) > len(emitted):
                yield text[len(emitted):]
        finally:
            if not fut.done():  # consumer gone mid-stream
                self.scheduler.cancel(fut)
            if stats_out is not None:
                stats_out["output_tokens"] = len(out_ids)
                if first_at:
                    stats_out["ttft_s"] = first_at[0] - t_submit

    def complete(self, prompt: str, max_new_tokens: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None, seed: int = 0,
                 deadline_s: Optional[float] = None,
                 idempotency_key: Optional[str] = None,
                 constrain=None) -> Completion:
        ids = self.tokenizer.encode(prompt, add_bos=self.add_bos)
        t_submit = time.perf_counter()
        fut, first_at = self._submit(ids, max_new_tokens, sampling, seed,
                                     deadline_s, idempotency_key,
                                     self._constraint_kwargs(constrain))
        return self._completion(ids, fut, first_at, t_submit)

    def complete_batch(
        self, prompts: Sequence[str], max_new_tokens: Optional[int] = None,
        sampling: Optional[SamplingParams] = None, seed: int = 0,
        deadline_s: Optional[float] = None, constrain=None,
    ) -> List[Completion]:
        """Submit the whole batch at once: the scheduler interleaves the
        prompts through its slots (continuous batching)."""
        ckw = self._constraint_kwargs(constrain)
        ids_list = [self.tokenizer.encode(p, add_bos=self.add_bos)
                    for p in prompts]
        t_submit = time.perf_counter()
        subs = [self._submit(ids, max_new_tokens, sampling, seed, deadline_s,
                             constraint_kwargs=ckw)
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
        the scheduler's shape arguments, the page-pressure knobs
        (`kv_overcommit`, `kv_spill`, `kv_watermark_low/high`),
        `max_queue_depth`, and `supervise` with
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
                kv_overcommit=kv_overcommit, kv_spill=kv_spill,
                kv_watermark_low=kv_watermark_low,
                kv_watermark_high=kv_watermark_high,
                max_queue_depth=max_queue_depth,
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

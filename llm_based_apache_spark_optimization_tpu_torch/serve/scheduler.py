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
- Weights may be int8 trees (`ops.quant.quantize_params`, with int8
  embed/unembed tables by `quantize_unembed`) or int4 trees
  (`quantize_params_int4`): every block matmul then runs the int8 or the
  int4 matmul kernel on the card. `fuse_matmuls=True` serves the fused
  tree (`models/llama.fuse_blocks`) in either layout.
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
On a card, the schedulers of a process issue their rounds and prefill
chunks one at a time, under the device's dispatch lock (`dispatch_lock`);
the fault seams run before it is taken.

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

- Prompt-lookup speculative decoding (`speculative_draft=D`,
  engine/speculative.py), both layouts: a decode round is one forward of
  T = D + 1 over the whole slot batch. Each slot drafts D tokens from its
  on-device history `_hist` [slots, max_seq + D + 1] (prompt chunks are
  written into it, the first token at arming, a resume rewrites the whole
  row) and emits 1..D+1 tokens: greedy slots the longest prefix of drafts
  equal to the argmax chain (token-identical to vanilla decode), sampled
  slots by rejection sampling with draws at one stream index a sampled
  round (`ops.sampling.verify_draws`), constrained slots under per-position
  masks from `fsm_advance_chain`, accepted up to the grammar-valid prefix.
  History, position, current token, grammar state, budget and stream index
  advance on the device; the harvest takes (emitted [slots, D+1], n_emit
  [slots]) a lag late. Inactive slots emit nothing: their history writes
  land past max_seq, their cache writes in their own row's tail
  (contiguous) or nowhere (paged, `q_lens` 0). Rounds where every slot is
  greedy skip the window's sort. A ragged mixed round verifies the decode
  slots in the same forward as the prompt chunks, T = max(bucket, D + 1).
  Prefix reuse is off (reused blocks would never reach the history).
  `speculation_stats` reports rounds and tokens by class.

- Observability: the flight recorder (serve/flightrecorder.py) gets one
  record per harvested round (occupancy, queue depth, admitted and retired
  rids, tokens emitted, the round's span on the device, cadence, page-pool
  occupancy) with its roofline columns: the round's phase (decode, verify
  or mixed), its mean context and the MFU, HBM-bandwidth utilization and
  binding roof the per-round ledger (`self.perf`, utils/perfmodel.py,
  priced for the card from `torch.cuda.get_device_name`) gives it; prefill chunks are banked
  and attributed over the inter-harvest wall. Events: `kv_evict`,
  `preempt`, `resume`, `grammar_swap`, `crash`, `profile_start`/`done`.
  Each request carries a scheduler rid and its queue wait (admission less
  submit, on the future for `Completion.queue_wait_s`), and a traced
  request gets `sched.*` spans. `profile_rounds(N)` arms a bounded
  torch.profiler capture (CUDA activity on the card) of the next N rounds,
  one at a time process-wide (utils/traceprof.py), written as a gzipped
  Chrome trace. Prefix telemetry: each cache entry's content digest
  (blake2b), hit count and rounds, the eviction churn, a reuse-distance
  histogram over a bounded ring of admissions (`LSOT_PREFIX_RING`), and
  the priced prefill the hits saved; `prefix_telemetry`,
  `resident_digests` and `prefix_registry` (top `LSOT_PREFIX_TOPK`) read
  them.

- Multi-tenant QoS (serve/qos.py; `LSOT_QOS`, default on): a submit's
  `tenant` and `qos` class ride the request. With QoS on the loop moves
  the submit queue into a ready pool and admits the smallest virtual
  finish time: vft = max(global virtual time, the tenant's last vft) +
  (prompt + budget tokens) / weight (`LSOT_TENANT_WEIGHTS`), start-time
  fair queueing, so a storm tenant's backlog advances only its own clock.
  Page waiters re-admit preempted victims first, then by vft; a
  preemption prefers the tenant holding the largest weighted slot share.
  A labeled request's prefix-cache keys and digests are salted with its
  tenant (`LSOT_PREFIX_TENANT_NS`, default on); unlabeled traffic keeps
  the shared keys. `qos_stats` reports the virtual time, the ready pool
  and the per-tenant counters. `LSOT_QOS=0` is the FIFO scheduler.
- Fleets: a scheduler carries the `model_id` of the checkpoint it holds
  (a submit naming another fails typed `UnknownModel`), a token-weighted
  `backlog_score`, and the `extract_queued` / `requeue` seams a pool's
  drain re-places through. `SchedulerPool` puts local replicas behind one
  `submit()`: placement by model, prefix affinity, page and SLO pressure
  and weighted least-loaded backlog, per-replica targeted restart, drain,
  remove, add and retire, and merged stats views. A replica may be a
  transport (serve/remote.py): a `SocketTransport` to a worker process or a
  `LoopbackTransport`, kept under a heartbeat lease. The elastic fleet's
  `FleetAutoscaler` (serve/elastic.py) joins standbys through `add_replica`
  and retires them through `retire_replica`.
- A mesh (`mesh`, parallel/; A7.12): each rank holds its block of the
  params and allocates its block of the cache or pool (a tp-th of the KV
  heads; slots and pages whole on every sp rank, as JAX places them, so
  the sp ranks of a tp rank are replicas computing the same step). Rank 0
  runs the host loop; every forward and every device cache
  operation it takes (`_fwd`, `_mirror`: prefix-block publish, restore and
  evict, page copies, page exports and imports) is posted over the step
  channel (parallel/spmd.py) and replayed by the other ranks' schedulers,
  which follow from `start()` to rank 0's `shutdown()` and take no
  requests. A spill or handoff blob keeps the unsharded layout: the export
  gathers every rank's heads to rank 0, the import sends rank 0's blob to
  every rank (engine/paged_kv.py), so phase roles and `kv_spill` work on a
  mesh and a blob moves between replicas of any tp (under sp the export
  reads the sp = 0 ranks' heads and the import writes every sp rank's).
  dp must be 1 (as JAX: the slot axis cannot shard). Rank 0 may build a
  scheduler while the others follow: they build a twin from an earlier
  one's recipe (a supervised restart), or else one from the params tree
  every rank placed on the mesh (`parallel.Mesh.place`) and rank 0's
  posted arguments (`_register`). A pool's replicas may each run on a tp
  mesh of their own (parallel/mesh.make_submeshes).
- Phase roles (`phase_role`, paged only; a pool's `LSOT_POOL_PHASES`): a
  "prefill" replica's final chunk parks its first token on the device
  (`_handoff_pending`); `_pack_handoffs` commits and streams it, exports
  the request's pages (prompt + first token) into a host blob
  (`export_pages`, the spill format, scales included) and queues it in
  `_handoff` for the pool, whose pump places it on a "decode" replica
  (then a mixed one, then the source). The importer restores the blob
  through the spill resume: the first token at its own position, stream
  index 1, the grammar replayed, the draft history rebuilt, so a split
  fleet's tokens are a mixed replica's. With no consumer, or past
  `LSOT_PUMP_DEPTH` packed blobs, the prefill replica decodes in place.
  `handoff_stats`, the `handoff_*` flight events, the `pages_migrated` /
  `handoff_wait_s` columns and the `sched.handoff` span record it.
- `warmup(prompt_len)` (JAX's) pays serving's first-use costs before the
  first request and changes no visible state; `SchedulerPool.warmup`
  warms every replica, and the pool's targeted rebuild warms the fresh
  replica before it starts, as the supervisor's restart driver does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import inspect
import logging
import os
import random
import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..engine.kvcache import bucket_len, init_cache
from ..engine.paged_kv import (
    PageAllocator,
    default_page_size,
    export_pages_start,
    handoff_bytes,
    import_pages,
    init_page_pool,
    page_bytes,
    pages_for_budget,
    pages_for_tokens,
)
from ..models.configs import LlamaConfig
from ..models.llama import _UNROLL_MAX_T, Params, forward, fuse_blocks
from ..constrain.masks import (
    advance_states,
    allowed_tokens,
    trivial_tables,
)
from ..engine.speculative import NGRAM, infer_weight_bits, ngram_draft, verify_commit
from ..ops.sampling import (
    SamplingParams,
    apply_token_mask,
    greedy,
    sample_runtime,
    verify_draws,
)
from .backends import Completion, request_class, trim_stop_texts
from .flightrecorder import FlightRecorder, merge_snapshots
from ..utils import traceprof
from ..utils.faults import FAULTS, InjectedFault
from ..utils.observability import resilience
from ..utils.perfmodel import PerfModel
from .resilience import (
    Deadline,
    DeadlineExceeded,
    Overloaded,
    SchedulerCrashed,
    SlotStalled,
)
from .watchdog import CombinedHeartbeat, Heartbeat
from ..parallel.sharding import shard_params, validate_tp

_M32 = 0xFFFFFFFF
_log = logging.getLogger("lsot.scheduler")

#: One dispatcher at a time on a card: the schedulers of a process (a
#: pool's replicas, the app's per-model schedulers) issue their rounds and
#: prefill chunks under their device's lock. A round is hundreds of small
#: eager ops, each of which releases and retakes the GIL, so dispatch
#: threads issuing together hand the GIL back and forth at every op and
#: run several times slower than one after the other
#: (`scripts/torch_dispatch_contention.py` times both on the card). The
#: device still runs one scheduler's round while the next one issues. Only
#: the issue of device work runs under the lock: the fault seams and every
#: host wait come before it, so a wedged scheduler holds no lock.
_DISPATCH_LOCKS: Dict[str, threading.Lock] = {}
_DISPATCH_LOCKS_GUARD = threading.Lock()


def dispatch_lock(device: torch.device) -> threading.Lock:
    """The process-wide dispatch lock of `device`."""
    with _DISPATCH_LOCKS_GUARD:
        return _DISPATCH_LOCKS.setdefault(str(device), threading.Lock())


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params tree (dicts, lists and tuples of tensors)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    return [t for v in items for t in _leaves(v)]


def _weight_kernels(tree) -> set:
    """The matmul kernel libraries a params tree's quantized weights launch:
    `int4_matmul` for a q4 tree, `int8_matmul` for a q8 one."""
    if not isinstance(tree, dict):
        return set()
    if "q4" in tree:
        return {"int4_matmul"}
    if "q8" in tree:
        return {"int8_matmul"}
    return set().union(*(_weight_kernels(v) for v in tree.values()))


def _env_on(name: str) -> bool:
    return os.environ.get(name, "0").strip().lower() in ("1", "true", "yes", "on")


#: Prefix-cache telemetry bounds: how many registry entries
#: /debug/prefixcache returns per scheduler (top-K by token mass) and how
#: many recent admissions the reuse-distance ring remembers. App-startup
#: overrides via `reconfigure_prefix_telemetry` (AppConfig.prefix_topk /
#: prefix_ring); None falls through to the LSOT_PREFIX_TOPK /
#: LSOT_PREFIX_RING env reads.
_PREFIX_TOPK: Optional[int] = None
_PREFIX_RING: Optional[int] = None


def reconfigure_prefix_telemetry(top_k: Optional[int] = None,
                                 ring: Optional[int] = None) -> None:
    """Set the prefix-registry bounds schedulers constructed AFTER this
    call will use (app/__main__ wires AppConfig.prefix_topk/prefix_ring
    through here)."""
    global _PREFIX_TOPK, _PREFIX_RING
    _PREFIX_TOPK = int(top_k) if top_k else None
    _PREFIX_RING = int(ring) if ring else None


def _prefix_bound(configured: Optional[int], env: str, default: int) -> int:
    if configured is not None:
        return max(1, configured)
    try:
        n = int(os.environ.get(env, str(default)))
    except ValueError:
        n = default
    return max(1, n)


def prefix_digest(ids: Sequence[int]) -> str:
    """Stable content address of a token prefix: blake2b over the int32
    token ids, 16 hex chars — the same digest the JAX package computes for
    the same prefix, in any process."""
    return hashlib.blake2b(
        np.asarray(ids, np.int32).tobytes(), digest_size=8
    ).hexdigest()


def prefix_chain_digests(ids: Sequence[int], block: int,
                         ns: Sequence[int] = ()) -> List[str]:
    """Digests of every whole-block prefix of a prompt (the chain keys'
    content addresses), salted with the tenant namespace `ns` as admission
    salts its keys: what a pool's affinity lookup matches against each
    replica's resident digests."""
    base = tuple(ns)
    return [prefix_digest(base + tuple(ids[: (j + 1) * block]))
            for j in range(max(0, (len(ids) - 1) // block))]


def normalize_replica_weights(values: Sequence[float], replicas: int,
                              label: str = "replica weights") -> List[float]:
    """One pad/validate policy for replica capacity weights: positive
    floats, at most one a replica (more raises), padded with 1.0."""
    out = [float(w) for w in values]
    for w in out:
        if w <= 0:
            raise ValueError(f"replica weights must be positive, got {w} in {label}")
    if len(out) > replicas:
        raise ValueError(f"{label} name {len(out)} replica(s) but the pool has "
                         f"{replicas}")
    return out + [1.0] * (replicas - len(out))


def parse_replica_weights(spec: str, replicas: int) -> List[float]:
    """`LSOT_REPLICA_WEIGHTS` ("4,1,1": a capacity multiplier a replica
    index) as a list of `replicas` weights, padded with 1.0. Placement
    orders on backlog / weight; deadline feasibility stays wall-clock. An
    empty spec is all 1.0, the unweighted order."""
    if not spec:
        return [1.0] * replicas
    out: List[float] = []
    for entry in filter(None, (x.strip() for x in spec.split(","))):
        try:
            out.append(float(entry))
        except ValueError:
            raise ValueError(f"bad replica weight {entry!r} in {spec!r}") from None
    return normalize_replica_weights(out, replicas, label=f"replica weights {spec!r}")


#: A replica's phase role. "mixed" prefills and decodes (every scheduler
#: before phase roles); a "prefill" replica exports each request's KV pages
#: into a handoff blob after its first token instead of decoding it; a
#: "decode" replica has full capability, but a pool feeds it the handoffs
#: and keeps fresh prompts off it.
PHASE_ROLES = ("mixed", "prefill", "decode")


def parse_pool_phases(spec: str, replicas: int) -> List[str]:
    """`LSOT_POOL_PHASES` ("prefill:1,decode:3") as a role a replica index.
    An empty spec is an all-"mixed" fleet. The counts must add up to
    `replicas`, and a fleet with a prefill replica needs a decode or mixed
    one to hand off to (a prefill-only fleet would decode every request in
    place: a misconfiguration)."""
    if not spec:
        return ["mixed"] * replicas
    roles: List[str] = []
    for entry in filter(None, (s.strip() for s in spec.split(","))):
        parts = entry.split(":")
        if len(parts) != 2:
            raise ValueError(f"bad pool-phases entry {entry!r} (want role:count)")
        role, n = parts[0].strip(), parts[1].strip()
        if role not in PHASE_ROLES:
            raise ValueError(f"bad phase role {role!r} (want one of {PHASE_ROLES})")
        try:
            count = int(n)
        except ValueError:
            raise ValueError(f"bad replica count in {entry!r}") from None
        if count < 1:
            raise ValueError(f"replica count must be >= 1 in {entry!r}")
        roles.extend([role] * count)
    if len(roles) != replicas:
        raise ValueError(f"pool phases {spec!r} describe {len(roles)} replica(s) but "
                         f"the pool has {replicas}")
    if "prefill" in roles and not any(r in ("decode", "mixed") for r in roles):
        raise ValueError(f"pool phases {spec!r} have prefill replicas but no decode/"
                         f"mixed replica to hand off to")
    return roles


def _rd_buckets(ring_cap: int) -> Tuple[int, ...]:
    """Reuse-distance histogram buckets (admissions between consecutive
    sightings of the same prefix digest): powers of two up to the ring
    cap, so a wider ring still buckets its whole window."""
    b, buckets = 1, []
    while b < ring_cap:
        buckets.append(b)
        b *= 2
    buckets.append(ring_cap)
    return tuple(buckets)


def _device_kind(device: torch.device) -> str:
    """The name the roofline ledger's peak table matches (utils/perfmodel
    `PEAKS`); "" on the CPU, which prices at the host fallback."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return ""


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
    preempted: int = 0
    rng_count: int = 0
    spilled: Optional[Tuple] = None
    # A prefill replica's handoff: {t_pack, export_s, pages, bytes, src},
    # set with `spilled` when the request's pages were exported for another
    # replica, cleared by the importing replica's resume (the sched.handoff
    # span and the pages_migrated / handoff_wait_s flight columns). None
    # tells a preemption spill from a migrated blob.
    handoff: Optional[Dict] = None
    # Observability: a scheduler-scope request id (the flight records'
    # admitted/retired columns), the request's trace when it was sampled
    # (utils/tracing.py; the worker records sched.* spans into it), the
    # wall stamps those spans are cut from, and the preempted intervals
    # [t_preempt, t_resume or 0.0].
    rid: int = 0
    trace: Optional[object] = None
    admitted_at: float = 0.0
    ready_at: float = 0.0
    parked: List[List[float]] = dataclasses.field(default_factory=list)
    # Prefix reuse, stamped at admission: the matched chain entry's digest
    # on a hit (the longest whole-block prompt prefix's on a miss; "" for
    # a prompt shorter than one block or with the cache off), the prompt
    # tokens the hit skipped and the prefill seconds that priced at.
    prefix_digest: str = ""
    tokens_reused: int = 0
    prefill_s_saved: float = 0.0
    # The registered model the request names ("" model-blind).
    model_id: str = ""
    # Multi-tenant QoS: the tenant the request bills to and its service
    # class ("" unlabeled), its WFQ virtual finish time (stamped at submit)
    # and its tenant's prefix-cache salt (two int32s prepended to every
    # cache key and digest; () for unlabeled traffic, the shared keys).
    tenant: str = ""
    qos: str = ""
    vft: float = 0.0
    ns: Tuple[int, ...] = ()

    @property
    def full_ids(self) -> List[int]:
        """The prefill prefix: the prompt, plus after a preemption the
        committed tokens a recompute resume re-runs (generated token j sits
        at position len(ids) + j in both incarnations)."""
        if not self.resume_pref:
            return self.ids
        return self.ids + self.generated[: self.resume_pref]

    def flush_spans(self, now: float) -> None:
        """Record the request's scheduler spans into its trace at terminal
        time: queue wait (submit -> slot), prefill (slot -> decode
        eligible), decode (eligible -> terminal) and one span per preempted
        interval. Only traced requests pay anything."""
        tr = self.trace
        if tr is None:
            return
        try:
            if self.submitted_at and self.admitted_at:
                tr.add_span("sched.queue_wait", self.submitted_at,
                            self.admitted_at, rid=self.rid)
            elif self.submitted_at:
                # Never admitted: its whole life was queue wait.
                tr.add_span("sched.queue_wait", self.submitted_at, now,
                            rid=self.rid)
            if self.admitted_at:
                attrs = {"prompt_tokens": len(self.ids)}
                if self.prefix_digest:
                    attrs["prefix_digest"] = self.prefix_digest
                    attrs["tokens_reused"] = self.tokens_reused
                    attrs["tokens_prefilled"] = len(self.ids) - self.tokens_reused
                tr.add_span("sched.prefill", self.admitted_at,
                            self.ready_at or now, **attrs)
            if self.ready_at:
                tr.add_span("sched.decode", self.ready_at, now,
                            output_tokens=len(self.generated),
                            constrained=self.constraint is not None)
            for t0, t1 in self.parked:
                tr.add_span("sched.preempted", t0, t1 or now, rid=self.rid,
                            resumed=bool(t1), preemptions=self.preempted)
        except Exception:  # noqa: BLE001 — tracing must never kill the loop
            self.trace = None

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

    #: Callers (SchedulerBackend, the supervisor, a pool) forward tenant and
    #: qos only to schedulers that set this.
    supports_qos = True

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
        phase_role: str = "mixed",
        ragged: Optional[bool] = None,
        speculative_draft: int = 0,
        fuse_matmuls: bool = False,
        model_id: str = "",
        qos: Optional[bool] = None,
        tenant_weights: Optional[str] = None,
        prefix_tenant_ns: Optional[bool] = None,
        pump_depth: Optional[int] = None,
        mesh=None,
        device=None,
    ):
        # The constructor's arguments: under a mesh a follower rebuilds its
        # twin of a scheduler rank 0 rebuilds (`_register`).
        init_args = {k: v for k, v in locals().items()
                     if k not in ("self", "__class__")}
        # Phase role (PHASE_ROLES): "mixed", the default, is the scheduler
        # without roles. A "prefill" replica commits and streams each
        # request's first token, exports its KV pages into a host blob
        # (`export_pages`, the spill format) and parks it in `_handoff` for
        # the pool, which `on_handoff` wakes; with no consumer wired it
        # decodes in place. The handoff ships pool pages: paged only.
        if phase_role not in PHASE_ROLES:
            raise ValueError(f"phase_role must be one of {PHASE_ROLES}, got "
                             f"{phase_role!r}")
        if phase_role != "mixed" and kv_layout != "paged":
            raise ValueError(f"phase_role={phase_role!r} needs kv_layout='paged': the "
                             f"prefill→decode handoff ships KV pool pages")
        self.phase_role = phase_role
        # `_handoff_pending`: (slot, req, first token on the device, epoch)
        # of final chunks not yet committed; `_handoff`: the packed blobs
        # the pool drains. The counters feed `handoff_stats`.
        self._handoff: "deque[_Request]" = deque()
        self._handoff_pending: list = []
        self.on_handoff: Optional[Callable[[], None]] = None
        # Packed blobs held at most (`LSOT_PUMP_DEPTH`): past it a handoff
        # decodes in place rather than pin another blob's host memory.
        if pump_depth is None:
            pump_depth = int(os.environ.get("LSOT_PUMP_DEPTH", "32") or 32)
        self._pump_depth = int(pump_depth)
        self._ho_backpressure = 0
        self._ho_exports = self._ho_imports = self._ho_inplace = 0
        self._ho_pages_out = self._ho_pages_in = 0
        self._ho_bytes_out = self._ho_bytes_in = 0
        self._ho_wait_sum = 0.0
        self._ho_wait_count = 0
        # Imported pages and their waits since the last flight record.
        self._mig_pages = 0
        self._mig_wait = 0.0
        # A prefill replica's backlog: outstanding prompt tokens, priced by
        # an EWMA of the submit -> export wall a prompt token.
        self._pending_prompt_tokens = 0
        self._pref_stok_ewma: Optional[float] = None
        self._last_pack_t: Optional[float] = None
        self.kv_quant = kv_quant
        # The registered checkpoint this scheduler holds ("" the
        # single-model fleet): a pool routes on it, and a submit naming
        # another model fails typed.
        self.model_id = str(model_id or "")
        # Accepted tokens over the scheduler's lifetime (per-model
        # throughput: `SchedulerPool.model_stats`).
        self._tokens_emitted_total = 0
        self._spec_draft = int(speculative_draft or 0)
        if self._spec_draft:
            if not 1 <= self._spec_draft <= _UNROLL_MAX_T - 1:
                raise ValueError(
                    f"speculative_draft must be in [1, {_UNROLL_MAX_T - 1}] "
                    f"(verify window T = draft+1 must take the small-T path), "
                    f"got {self._spec_draft}")
            # Reused prefix blocks skip the prefill that writes the draft
            # history: reuse is off under speculation.
            prefix_cache_blocks = 0
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
        # Token-weighted backlog (a pool's placement score): outstanding
        # requests' budgets (+= at submit and requeue, -= at terminal) and
        # an EWMA of completed requests' seconds a generated token.
        self._pending_new_tokens = 0
        self._stok_ewma: Optional[float] = None
        # Multi-tenant QoS (serve/qos.py): the WFQ state. `qos`,
        # `tenant_weights` and `prefix_tenant_ns` default to LSOT_QOS,
        # LSOT_TENANT_WEIGHTS and LSOT_PREFIX_TENANT_NS. `_ready` and the
        # ledgers change only under `_submit_lock` (extract_queued races
        # the worker during a drain).
        from .qos import parse_tenant_weights, prefix_tenant_ns_enabled, qos_enabled

        self._qos = qos_enabled() if qos is None else bool(qos)
        if tenant_weights is None:
            tenant_weights = os.environ.get("LSOT_TENANT_WEIGHTS", "")
        self._tenant_weights: Dict[str, float] = (
            parse_tenant_weights(tenant_weights) if self._qos else {})
        if prefix_tenant_ns is None:
            prefix_tenant_ns = prefix_tenant_ns_enabled()
        self._prefix_tenant_ns = self._qos and bool(prefix_tenant_ns)
        self._wfq_vt = 0.0
        self._wfq_last: Dict[str, float] = {}
        self._ready: List[_Request] = []
        self._tenant_submitted: Dict[str, float] = {}
        self._tenant_preempted: Dict[str, float] = {}
        if ragged is None:
            # The env opt-in degrades silently where the round cannot run.
            ragged = _env_on("LSOT_RAGGED") and self._paged and phase_role == "mixed"
        elif ragged and not (self._paged and phase_role == "mixed"):
            raise ValueError(
                "ragged mixed rounds need kv_layout='paged' (prefill rows "
                "scatter chunks through page tables) and phase_role='mixed' "
                "(a phase-split replica has no mixed rounds to unify)")
        self._ragged = bool(ragged)
        self.cfg = cfg
        self.mesh = mesh
        self._kv_cfg = cfg
        # Rank 0 of a mesh of several ranks posts its device steps; the other
        # ranks replay them (`_mesh_follower`).
        self._mesh_drive = self._mesh_follower = False
        if mesh is not None:
            if mesh.shape["dp"] != 1:
                raise ValueError(
                    "scheduler mesh must have dp=1: request parallelism comes "
                    "from slots; the slot axis is dynamically indexed and "
                    "cannot shard")
            validate_tp(cfg, mesh.shape["tp"])
            if device is not None and torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh rank's "
                                 f"{mesh.device}")
            device = mesh.device
            # Rank 0's rebuild of this scheduler (same params, same
            # arguments) is matched to this one by the key.
            self._twin_key = (id(params), {k: v for k, v in init_args.items()
                                           if k != "params"})
            params = local = shard_params(params, cfg, mesh)
            self._kv_cfg = mesh.local_cfg(cfg)
            self._mesh_drive = mesh.distributed and mesh.is_primary
            self._mesh_follower = mesh.distributed and not mesh.is_primary
            self._mesh_closed = False
        self.device = resolve_device(device)
        if params["final_norm"].device.type != self.device.type:
            raise ValueError(f"params are on {params['final_norm'].device}, "
                             f"scheduler on {self.device}")
        if fuse_matmuls:
            # One stacked matmul for the projections sharing an input
            # (models/llama.fuse_blocks); `self.params` is the fused tree.
            params = fuse_blocks(params)
        self.params = params
        if mesh is not None:
            # How a follower rebuilds a twin when rank 0 rebuilds this
            # scheduler (`_register`): from this rank's final tree, the
            # whole tree is not kept. Rank 0 keeps only the key: a recipe
            # there would hold a crashed replica's block past its restart.
            recipe = (None if mesh.is_primary else
                      partial(ContinuousBatchingScheduler,
                              **dict(init_args, params=params, fuse_matmuls=False)))
        self._weight_bits = infer_weight_bits(params)
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
            self._cache = init_cache(self._kv_cfg, num_slots, self.max_seq,
                                     dtype, dev, kv_quant)
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
        if self._spec_draft:
            # The draft history, one row a slot, D + 1 columns past max_seq:
            # a round writes its D + 1 window at hlen, and inactive slots
            # write into that spare tail.
            self._hist = torch.full((num_slots, self.max_seq + self._spec_draft + 1),
                                    cfg.pad_id, dtype=torch.int32, device=dev)
            self._hlen = torch.zeros(num_slots, dtype=torch.int64, device=dev)
            # Acceptance counters (`speculation_stats`), moved as a group
            # under the submit lock: verify rounds and the tokens they
            # emitted, their constrained and sampled subsets, and the
            # tokens the requests received from them.
            self._spec_rounds = self._spec_tokens = 0
            self._spec_rounds_con = self._spec_tokens_con = 0
            self._spec_rounds_samp = self._spec_tokens_samp = 0
            self._spec_delivered = 0
        self._slot_req: List[Optional[_Request]] = [None] * num_slots
        # Per-slot occupancy epoch, bumped at admission and retirement; the
        # harvest drops firsts issued under a stale epoch.
        self._slot_epoch: List[int] = [0] * num_slots
        # In-flight rounds: (issue-time slot->req list, epochs, toks [S,
        # chunk] device tensor, firsts [(slot, req, tok, epoch)], under
        # speculation n_emit [S] (the leading toks of each row it emitted),
        # the wall stamp taken before it was enqueued, and a ragged mixed
        # round's chunk rows {pre_rows, pre_tokens, pre_ctx} for the ledger).
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
        # Prefix telemetry, moved as a group under the submit lock (the
        # worker thread is the only writer; /metrics readers take one
        # snapshot): re-publishes of evicted keys, the priced prefill the
        # hits saved, the hit-rate EWMA over cacheable admissions.
        self._prefix_reinserts = 0
        self._prefix_flops_saved = 0.0
        self._prefix_s_saved = 0.0
        self._prefix_hit_ewma: Optional[float] = None
        # The registry: per-entry metadata keyed like the caches (digest,
        # tokens, hits, insert/last-hit round), and the evicted keys (a
        # publish that finds its key here is a reinsertion: the cache was
        # too small for the working set).
        self._prefix_meta: Dict[Tuple[int, ...], Dict[str, object]] = {}
        self._prefix_evicted_ghost: "OrderedDict[Tuple[int, ...], None]" = (
            OrderedDict())
        # Reuse-distance ring: admissions since a digest's last sighting,
        # from a digest -> admission-seq map swept when it doubles;
        # powers-of-two buckets plus "inf" (unseen inside the window).
        self._prefix_ring_cap = _prefix_bound(_PREFIX_RING, "LSOT_PREFIX_RING", 256)
        self._prefix_topk = _prefix_bound(_PREFIX_TOPK, "LSOT_PREFIX_TOPK", 32)
        self._prefix_adm_seq = 0
        self._prefix_ring_seq: Dict[str, int] = {}
        self._prefix_rd_buckets = _rd_buckets(self._prefix_ring_cap)
        self._prefix_rd_hist: Dict[str, int] = {}
        # Chain key -> digest, LRU-bounded: traffic repeats the same
        # schema prefix, so blake2b runs once per distinct prefix.
        self._prefix_digest_memo: "OrderedDict[Tuple[int, ...], str]" = OrderedDict()
        # Reuse rows ({rid, digest, reused, prefilled}) for the next
        # flight record.
        self._round_prefix: List[Dict[str, object]] = []
        # One contiguous cache entry's device bytes (from the first one).
        self._prefix_block_bytes = 0

        self._stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                        else None)
        # On the CPU ops run as they are issued: nothing to serialize.
        self._dispatch_lock = (dispatch_lock(dev) if dev.type == "cuda"
                               else contextlib.nullcontext())
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
        #: One record per harvested round in a bounded ring, beside the
        #: scheduler's events (serve/flightrecorder.py): the postmortem
        #: black box, live at /debug/flightrecorder.
        self.flight = FlightRecorder()
        # Scheduler-scope request ids, and the rids admitted and retired
        # since the last record.
        self._rid_seq = 0
        self._round_admitted: List[int] = []
        self._round_retired: List[int] = []
        #: The per-round roofline ledger (utils/perfmodel.py): weight bytes
        #: as stored (what a decode step streams), the KV layout's pricing,
        #: the card's peaks.
        self.perf = PerfModel(
            cfg,
            param_bytes=sum(t.nbytes for t in _leaves(params)),
            weight_bits=self._weight_bits,
            kv_itemsize=dtype.itemsize,
            kv_quant=kv_quant,
            kv_layout=kv_layout,
            page_size=self._page_size if self._paged else None,
            device_kind=_device_kind(dev),
        )
        self._last_harvest_t: Optional[float] = None
        # On-demand profiling (/debug/profile): an armed capture starts on
        # the worker thread at the next issued round and stops after N
        # harvested rounds; utils/traceprof's guard allows one at a time.
        self._profile_lock = threading.Lock()
        self._profile_arm: Optional[Dict[str, object]] = None
        self._profile_active: Optional[Dict[str, object]] = None
        self._profile_last: Optional[Dict[str, object]] = None
        if mesh is not None:
            # Registered last: a follower's step loop may drive it at once.
            self._mesh_id = self._register(mesh, init_args, local)
            mesh._recipes[self._mesh_id] = (self._twin_key, recipe)

    # ----------------------------------------------------- device helpers

    def _fwd(self, tokens, positions, cache, **kw):
        """`models.llama.forward` over this scheduler's params and mesh. On
        rank 0 of a mesh the call is posted first (the cache named, not
        sent: "cache" or a paged call's page table), and both run under
        the mesh's lock."""
        if not self._mesh_drive:
            return forward(self.cfg, self.params, tokens, positions, cache,
                           mesh=self.mesh, **kw)
        from ..parallel import spmd

        ref = cache["ptab"] if self._paged else "cache"
        with self.mesh.lock:
            spmd.post(self.mesh, self._mesh_id, "_follow_fwd", tokens,
                      positions, ref, kw)
            return forward(self.cfg, self.params, tokens, positions, cache,
                           mesh=self.mesh, **kw)

    def _register(self, mesh, init_args: dict, local) -> int:
        """This scheduler's index on the mesh. Built while the followers
        follow, it first has each follower build its counterpart: the twin
        from the recipe of the scheduler built before from the same params
        and arguments (rank 0's supervisor rebuilding a crashed one), or
        else a scheduler from the follower's own block of the params tree
        (`local`, placed on every rank: `Mesh.place`) and these
        arguments."""
        if not (mesh.driving and mesh.is_primary):
            return mesh.register(self)
        from ..parallel import spmd

        same = [i for i, (key, _) in mesh._recipes.items() if key == self._twin_key]
        if same:
            with mesh.lock:
                spmd.post_rebuild(mesh, same[-1])
                return mesh.register(self)
        tree = mesh.tree_index(local)
        if tree is None:
            raise ValueError(
                "a scheduler built on rank 0 while the other ranks follow needs "
                "a params tree placed on every rank of the mesh: shard it with "
                "parallel.shard_params on each rank, in the same order, before "
                "they follow")
        args = {k: v for k, v in init_args.items()
                if k not in ("params", "mesh", "device")}
        with mesh.lock:
            spmd.post_build(mesh, tree, partial(ContinuousBatchingScheduler, **args))
            return mesh.register(self)

    @torch.inference_mode()
    def _follow_fwd(self, tokens, positions, ref, kw) -> None:
        cache = self._cache if isinstance(ref, str) else dict(self._pool, ptab=ref)
        forward(self.cfg, self.params, tokens, positions, cache, mesh=self.mesh,
                **kw)

    def _mirror(self, method: str, *args) -> None:
        """Rank 0 of a mesh: post a device cache operation for the other
        ranks' schedulers to apply to their blocks."""
        if self._mesh_drive:
            from ..parallel import spmd

            with self.mesh.lock:
                spmd.post(self.mesh, self._mesh_id, method, *args)

    def _export_start(self, pages: List[int]):
        """`export_pages_start` of pool pages; on rank 0 of a mesh posted
        first, so every rank gathers its heads into rank 0's blob."""
        if not self._mesh_drive:
            return export_pages_start(self._pool, pages, self.mesh)
        from ..parallel import spmd

        with self.mesh.lock:
            spmd.post(self.mesh, self._mesh_id, "_follow_export", pages)
            return export_pages_start(self._pool, pages, self.mesh)

    def _import(self, pages: List[int], blob) -> None:
        """`import_pages` of a whole blob; on rank 0 of a mesh posted first,
        so every rank writes its block of the heads."""
        if not self._mesh_drive:
            import_pages(self._pool, pages, blob, self.mesh)
            return
        from ..parallel import spmd

        with self.mesh.lock:
            spmd.post(self.mesh, self._mesh_id, "_follow_import", pages)
            import_pages(self._pool, pages, blob, self.mesh)

    @torch.inference_mode()
    def _follow_export(self, pages) -> None:
        export_pages_start(self._pool, pages, self.mesh)()

    @torch.inference_mode()
    def _follow_import(self, pages) -> None:
        import_pages(self._pool, pages, None, self.mesh)

    def _follow_publish(self, key, slot: int, start: int) -> None:
        self._prefix_cache[key] = self._slice_block(slot, start)

    def _follow_restore(self, key, slot: int, start: int) -> None:
        self._restore_block(self._prefix_cache[key], slot, start)

    def _follow_evict(self, key) -> None:
        self._prefix_cache.pop(key, None)

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
        self._mirror("_copy_page", dst, src)
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
            # The budget prices the whole pool, every KV head (as JAX's
            # global array): under a tp mesh each rank holds a tp-th of it.
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
        self._pool = init_page_pool(self._kv_cfg, num_pages, ps, dtype,
                                    self.device, self.kv_quant)
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
        self._prefix_note_evict(key, pages)
        self._page_alloc.release(list(pages))

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
            self.flight.event("kv_evict", entries=evicted,
                              free=self._page_alloc.pages_free)

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
            req.spilled = self._export_start(self._slot_pages[slot][:npg])()
            self._page_alloc.note_spill(npg)
        req.resume_pref = len(req.generated)
        req.preempted += 1
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
        if self._qos:
            from .qos import bounded_bump

            with self._submit_lock:
                bounded_bump(self._tenant_preempted, req.tenant)
        # A preempted interval for the request's trace, closed at resume.
        req.parked.append([time.perf_counter(), 0.0])
        self.flight.event("preempt", slot=slot, rid=req.rid,
                          generated=len(req.generated),
                          spill=req.spilled is not None)
        self._page_wait.appendleft(req)

    def _preempt_for(self, n_pages: int, protect: int) -> Optional[List[int]]:
        """Fund a failed allocation by preempting victims, never slot
        `protect`, until it succeeds or no victim is left: fewest generated
        tokens first, and under QoS the tenant holding the largest weighted
        slot share (the one over its fair allocation) before that."""
        while True:
            got = self._alloc_pages(n_pages)
            if got is not None:
                return got
            victims = [(len(r.generated), i) for i, r in enumerate(self._slot_req)
                       if r is not None and i != protect]
            if not victims:
                return None
            if self._qos:
                share: Dict[str, float] = {}
                for r in self._slot_req:
                    if r is not None:
                        share[r.tenant] = (share.get(r.tenant, 0.0)
                                           + 1.0 / self._wfq_weight(r.tenant))
                victims.sort(key=lambda v: (
                    -share.get(self._slot_req[v[1]].tenant, 0.0), v[0], v[1]))
            else:
                victims.sort()
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

    def _resume_ready(self, slot: int, req: _Request, mode: str = "recompute") -> None:
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
        if self._spec_draft:
            # The whole history row: prompt + committed tokens, pad beyond
            # (a previous occupant's tail scrubbed), so the drafts are the
            # unpreempted control's after a recompute and a spill alike.
            row = req.full_ids + [self.cfg.pad_id] * (self._hist.shape[1] - plen)
            self._hist[slot] = self._h2d(row, torch.int32)
            self._hlen[slot] = plen
        req.ready = True
        req.ready_at = time.perf_counter()
        if req.parked and not req.parked[-1][1]:
            req.parked[-1][1] = req.ready_at
        ho = req.handoff
        if ho is not None:
            # A migrated request is armed: close its handoff interval (pack
            # to armed, the wait for a decode slot included) into the trace's
            # sched.handoff span, the next flight record's columns and the
            # counters.
            wait = max(0.0, req.ready_at - float(ho["t_pack"]))
            self._ho_wait_sum += wait
            self._ho_wait_count += 1
            self._mig_pages += int(ho["pages"])
            self._mig_wait += wait
            if req.trace is not None:
                try:
                    req.trace.add_span(
                        "sched.handoff", float(ho["t_pack"]), req.ready_at,
                        rid=req.rid, pages=int(ho["pages"]), bytes=int(ho["bytes"]),
                        export_s=float(ho["export_s"]), wait_s=round(wait, 6),
                        src=ho.get("src", ""))
                except Exception:  # noqa: BLE001 — tracing must never kill the loop
                    req.trace = None
            self.flight.event("handoff_import", slot=slot, rid=req.rid,
                              pages=int(ho["pages"]), wait_s=round(wait, 6),
                              src=ho.get("src", ""))
            req.handoff = None
        # Decode rewrites [plen - 1, page_end): copy any page the
        # re-prefill's publish shared.
        self._ensure_writable(slot, max(0, plen - 1), req.page_end)
        self.flight.event("resume", slot=slot, rid=req.rid,
                          generated=len(req.generated), mode=mode)

    def _restore_spilled(self, slot: int, req: _Request) -> None:
        """Spill resume and handoff import: write the host page copies
        (values and, in an int8 pool, scales) into the fresh pages and arm
        the slot; no forward. A migrated blob counts in the handoff
        counters, so a pool's spilled == restored stays exact."""
        parts = req.spilled
        n = parts[0].shape[1]
        self._import(self._slot_pages[slot][:n], parts)
        if req.handoff is None:
            self._page_alloc.note_restore(n)
        else:
            self._ho_imports += 1
            self._ho_pages_in += int(n)
            self._ho_bytes_in += handoff_bytes(parts)
        mode = "import" if req.handoff is not None else "spill"
        req.spilled = None
        req.prefilled = len(req.full_ids)
        self._resume_ready(slot, req, mode=mode)

    # --------------------------------------------------------------- warmup

    def warmup(self, prompt_len: Optional[int] = None) -> None:
        """Pay serving's first-use costs before the first request (JAX
        `warmup`): after the call the first request pays none of them, and
        no visible state has changed. Call before start(), or while the
        loop is idle.

        - The kernel libraries this configuration launches
          (`_kernel_libraries`) are loaded, the stale ones built first, one
          nvcc each, all started at once (`_build.load_all`), not one after
          another inside the first forward.
        - One prefill forward for each of JAX's k-buckets (`_kbuckets`) at
          the chunk bucket of `prompt_len` (default: the prompt bucket),
          through the forward and kernels `_prefill_forward` runs, then the
          first token's mask and sampler: the kernels' first launches
          (module loads, the shared-memory opt-ins), cuBLAS's handle and
          workspace, the caching allocators' growth to the chunk's
          activations. JAX aims its rows at an out-of-bounds slot, whose
          scatter XLA drops; a row index here would raise or write out of
          bounds. So a contiguous forward writes into a scratch cache of
          the chunk's span, freed after, and a paged one goes through a
          table of sentinel pages: the page write drops their writes and
          the chunk's views clip them to a real page, read only. Nothing
          is counted: no `prefill_forwards`, no ledger entry, no flight
          record. A ragged scheduler prefills in mixed rounds: it warms
          one mixed round with no chunk row instead.
        - One decode round with every slot parked (`kv_lens` 0; the verify
          round under speculation), sampled and masked, so that every op
          of a round runs once. Its writes land at the park position or
          drop through the sentinel table; a contiguous verify window,
          clamped into its row's tail, also writes below the park
          position, so that tail is saved and put back. With no slot
          active no counter moves.

        JAX also runs its per-slot state scatters, at an out-of-bounds
        slot, to compile them; the port's are eager indexing with nothing
        to compile, so none runs.

        On rank 0 of a mesh the warmup is one posted step
        (`_follow_warmup`): every follower runs the same forwards over its
        own scratch, so the collectives line up and no rank writes below
        its park position. A follower's own call does nothing: it warms
        when rank 0 does."""
        if self._mesh_follower:
            return
        want = prompt_len or self.prompt_bucket
        t = next((b for b in self._buckets if b >= want), self.prompt_bucket)
        self._load_kernels()
        with self._device_context(), self._dispatch_lock:
            if not self._mesh_drive:
                self._warm(t)
                return
            from ..parallel import spmd

            with self.mesh.lock:
                spmd.post(self.mesh, self._mesh_id, "_follow_warmup", t)
                # This rank's forwards are the posted step's: none posts.
                self._mesh_drive = False
                try:
                    self._warm(t)
                finally:
                    self._mesh_drive = True

    @torch.inference_mode()
    def _follow_warmup(self, t: int) -> None:
        self._load_kernels()
        self._warm(t)

    def _kbuckets(self) -> List[int]:
        """JAX's prefill k-buckets: the powers of two below `_prefill_kmax`,
        then `_prefill_kmax`."""
        kb, out = 1, []
        while kb < self._prefill_kmax:
            out.append(kb)
            kb *= 2
        return out + [self._prefill_kmax]

    def _kernel_libraries(self) -> List[str]:
        """The kernel libraries (`csrc/<name>.cu`) this configuration
        launches: the flash prefill (row 1) over every prefill chunk and a
        contiguous bf16 verify window, which a ragged scheduler's mixed
        rounds replace; the contiguous decode (row 2 in the same library,
        row 3 over an int8 cache, whose verify window runs row 5); the
        paged attention and page write (rows 4 and 6, int8 pool 5 and 7);
        and the int4 or int8 matmul of a quantized tree."""
        q = "_quantized" if self.kv_quant else ""
        libs = [] if self._ragged else ["flash_gqa_attention"]
        if self._paged:
            libs += ["ragged_paged_attention" + q, "fused_page_write" + q]
        elif self.kv_quant:
            libs.append("flash_gqa_attention_quantized")
            if self._spec_draft:
                libs.append("ragged_paged_attention_quantized")
        return libs + sorted(_weight_kernels(self.params))

    def _load_kernels(self) -> None:
        if self.device.type == "cuda":
            from ..ops.kernels import _build

            _build.load_all(self._kernel_libraries())

    def _warm(self, t: int) -> None:
        """The warmup's device work at chunk bucket `t` (`warmup`)."""
        if not self._ragged:
            self._warm_prefill(t)
        # The rounds run with every slot parked, as a fresh scheduler's are
        # (a retired slot keeps its last position, where a round would
        # write), then the slot state is put back as it was.
        names = ("_cur", "_pos", "_cstates", "_crem", "_counts") + (
            ("_hlen",) if self._spec_draft else ())
        saved = {n: getattr(self, n) for n in names}
        self._cur = torch.full_like(self._cur, self.cfg.pad_id)
        self._pos = torch.full_like(self._pos, self._park)
        parked = torch.zeros(self.num_slots, dtype=torch.bool, device=self.device)
        tail, lo = {}, self._park
        if self._spec_draft and not self._paged:
            # A parked row's verify window is clamped into its row's tail.
            lo = max(0, next(iter(self._cache.values())).shape[3] - self._spec_draft - 1)
            tail = {n: c[:, :, :, lo:self._park].clone() for n, c in self._cache.items()}
        try:
            if self._ragged and self._spec_draft:
                self._mixed_spec_round([], t, parked, True, True)
            elif self._ragged:
                self._mixed_round([], t, parked, True, True)
            if self._spec_draft:
                self._spec_round(parked, True, True)
            else:
                self._decode_round(parked, True, True)
        finally:
            for n, v in saved.items():
                setattr(self, n, v)
            for n, v in tail.items():
                self._cache[n][:, :, :, lo:self._park] = v

    def _warm_prefill(self, t: int) -> None:
        """One `t`-bucket prefill forward of k pad rows for each k of
        `_kbuckets`, built as `_prefill_forward` builds its inputs, into
        nothing that serving reads (`warmup`)."""
        dev, kmax, pad = self.device, self._prefill_kmax, self.cfg.pad_id
        if self._paged:
            span = t
            cache = dict(self._pool)
            sentinel = [self._page_alloc.num_pages] * self._pages_per_slot
        else:
            s_cache = next(iter(self._cache.values())).shape[3]
            span = min(t + -t % 64, s_cache)
            cache = init_cache(self._kv_cfg, kmax, span, self._dtype, dev, self.kv_quant)
        for k in self._kbuckets():
            tokens = self._h2d([[pad] * t] * k, torch.int32)
            positions = (self._h2d([0] * k, torch.int32)[:, None]
                         + torch.arange(t, dtype=torch.int32, device=dev))
            last = self._h2d([0] * k, torch.int64)
            if self._paged:
                cache["ptab"] = self._h2d([sentinel] * k, torch.int32)
                logits, _ = self._fwd(tokens, positions, cache, logit_indices=last,
                                      span=span)
            else:
                logits, _ = self._fwd(tokens, positions, cache, logit_indices=last,
                                      rows=self._h2d(list(range(k)), torch.int64),
                                      span=span)
            first = logits[:, 0]
            # The sentinel grammar state and budget allow every token.
            first = apply_token_mask(first, allowed_tokens(
                self._ctables["need"], self._h2d([0] * k, torch.int32),
                self._h2d([1] * k, torch.int32), first.shape[-1]))
            sample_runtime(first, self._h2d([0.0] * k, torch.float32),
                           self._h2d([1.0] * k, torch.float32),
                           self._h2d([0] * k, torch.int32),
                           self._h2d([0] * k, torch.int64),
                           torch.zeros(k, dtype=torch.int64, device=dev))

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ContinuousBatchingScheduler":
        if self._mesh_follower:
            # This rank replays rank 0's steps (parallel/spmd.py).
            from ..parallel import spmd

            spmd.ensure_following(self.mesh)
            return self
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
        """Stop the event loop and join it. Under a mesh rank 0 then tells
        the other ranks' schedulers, which return from here once it has."""
        if self._mesh_follower:
            from ..parallel import spmd

            spmd.wait_closed(self.mesh, self._mesh_id)
            return
        if self._thread is not None:
            self._stop_evt.set()
            self._queue.put(None)  # wake the loop
            self._thread.join(timeout)
            self._thread = None
        if self._mesh_drive and not self._mesh_closed:
            from ..parallel import spmd

            self._mesh_closed = True
            spmd.post_close(self.mesh, self._mesh_id)

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
        before the host notices: pending rounds x tokens per round, plus
        under speculation one verify window of cache writes past the last
        emitted position."""
        if self._spec_draft:
            return (self._harvest_lag + 1) * (self._spec_draft + 1) + self._spec_draft
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
        trace=None,
        model_id: str = "",
        tenant: str = "",
        qos: str = "",
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
        than the installed one waits for the constrained slots to drain.
        A sampled `trace` (utils/tracing.RequestTrace) gets the request's
        sched.* spans. A non-empty `model_id` must be this scheduler's
        (`UnknownModel` otherwise); `tenant` and `qos` order admission
        under QoS and are carried but never read with it off."""
        if self._mesh_follower:
            raise RuntimeError(
                f"rank {self.mesh.rank} follows rank 0's scheduler: submit on "
                "rank 0 (parallel.is_primary)")
        if model_id and model_id != self.model_id:
            from .modelpool import UnknownModel

            raise UnknownModel(
                f"request names model {model_id!r} but this replica "
                f"serves {self.model_id or '<unset>'!r}")
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
            on_token=on_token, constraint=constraint, trace=trace,
            deadline=Deadline.after(deadline_s) if deadline_s is not None else None,
            model_id=model_id or self.model_id,
            tenant=str(tenant or ""), qos=str(qos or ""),
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
            # Admission control: shed instead of queueing without bound
            # (under QoS the ready pool is backlog the queue no longer
            # counts).
            if self.max_queue_depth and \
                    self._queue.qsize() + len(self._ready) >= self.max_queue_depth:
                resilience.inc("shed")
                raise Overloaded(
                    f"scheduler queue at capacity ({self.max_queue_depth} "
                    f"waiting requests)", retry_after_s=self.retry_after_hint())
            self._rid_seq += 1
            req.rid = self._rid_seq
            req.future._lsot_replica = self.flight.replica
            req.submitted_at = time.perf_counter()
            if self._qos:
                self._stamp_qos_locked(req)
            self._pending_new_tokens += req.max_new
            self._pending_prompt_tokens += len(req.ids)
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
        harvest. A no-op on finished or foreign futures. A remote request's
        `_Request` lives in another process: its future carries an
        `_lsot_cancel` callable instead (serve/remote.py), which ships the
        cancel over the wire."""
        req = getattr(future, "_lsot_request", None)
        if req is not None:
            req.cancelled = True
            return
        cb = getattr(future, "_lsot_cancel", None)
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — cancelling the unreachable is moot
                pass

    # ------------------------------------------------------ multi-tenant WFQ

    def _wfq_weight(self, tenant: str) -> float:
        """A tenant's WFQ weight (`LSOT_TENANT_WEIGHTS`; 1.0 by default,
        the unlabeled "" tenant included, which competes as one tenant)."""
        w = self._tenant_weights.get(tenant, 1.0)
        return w if w > 0 else 1.0

    def _stamp_qos_locked(self, req: _Request) -> None:
        """Stamp the request's virtual finish time and its tenant's prefix
        salt (callers hold the submit lock; QoS on). Start-time fair
        queueing: a request starts at max(global virtual time, its
        tenant's last finish) and finishes (prompt + budget) / weight
        later, so a storm only advances its own tenant's clock."""
        from .qos import bounded_bump, tenant_salt

        cost = (len(req.ids) + req.max_new) / self._wfq_weight(req.tenant)
        req.vft = max(self._wfq_vt, self._wfq_last.get(req.tenant, 0.0)) + cost
        self._wfq_last[req.tenant] = req.vft
        if len(self._wfq_last) > 128:
            # A finish time at or behind the global clock orders nothing.
            self._wfq_last = {t: v for t, v in self._wfq_last.items()
                              if v > self._wfq_vt}
        if self._prefix_tenant_ns and req.tenant:
            req.ns = tenant_salt(req.tenant)
        bounded_bump(self._tenant_submitted, req.tenant)

    def _drain_ready(self) -> None:
        """Move every queued submit into the WFQ ready pool (worker thread,
        QoS on). The queue hands each item to one consumer, so nothing is
        both drained here and extracted by `extract_queued`."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is None:
                continue
            with self._submit_lock:
                self._ready.append(req)

    def _ready_pop(self) -> Optional[_Request]:
        """The smallest virtual finish time (rid breaks ties: same-tenant
        FIFO), advancing the global virtual clock to it."""
        with self._submit_lock:
            if not self._ready:
                return None
            i = min(range(len(self._ready)),
                    key=lambda j: (self._ready[j].vft, self._ready[j].rid))
            req = self._ready.pop(i)
            self._wfq_vt = max(self._wfq_vt, req.vft)
            return req

    def _page_wait_pop(self) -> _Request:
        """The next page waiter to retry admission: FIFO with QoS off;
        with it on, preempted victims first (they hold delivered tokens),
        then the smallest virtual finish time."""
        pw = self._page_wait
        if not self._qos or len(pw) == 1:
            return pw.popleft()
        best = min(range(len(pw)),
                   key=lambda i: (0 if pw[i].preempted else 1, pw[i].vft, i))
        pw.rotate(-best)
        req = pw.popleft()
        pw.rotate(best)
        self._wfq_vt = max(self._wfq_vt, req.vft)
        return req

    def qos_stats(self) -> Optional[Dict[str, object]]:
        """Per-tenant WFQ counters for /metrics (the lsot_tenant_*
        families): None with QoS off."""
        if not self._qos:
            return None
        with self._submit_lock:
            backlog: Dict[str, int] = {}
            for r in self._ready:
                key = r.tenant or "default"
                backlog[key] = backlog.get(key, 0) + 1
            out: Dict[str, object] = {
                "virtual_time": round(self._wfq_vt, 3),
                "ready": len(self._ready),
                "page_wait": len(self._page_wait),
                "submitted": dict(self._tenant_submitted),
                "preempted": dict(self._tenant_preempted),
            }
            if self._tenant_weights:
                out["weights"] = dict(self._tenant_weights)
            if backlog:
                out["backlog"] = backlog
            return out

    def retry_after_hint(self) -> float:
        """Seconds a shed client should wait: the backlog (queue and WFQ
        ready pool, plus the retry itself) x the recent per-request service
        time / slots, clamped to [1, 60]; 1 until a completion seeds the
        estimate. Lock-free: submit calls it holding the submit lock."""
        ewma = self._svc_ewma
        if ewma is None:
            return 1.0
        depth = self._queue.qsize() + len(self._ready) + 1
        return float(min(60.0, max(1.0, depth * ewma / max(1, self.num_slots))))

    def backlog_score(self) -> Tuple[float, int]:
        """A pool's placement score, compared lexicographically: (backlog
        seconds, pending new tokens). The seconds are outstanding budget
        tokens x the measured seconds a token / slots, unclamped (0.0 until
        a completion seeds the EWMA, the token count then decides).
        Lock-free, like retry_after_hint. A prefill replica's backlog is
        prompt tokens priced by its submit -> export EWMA: the decode
        budgets it never spends say nothing about a new prompt's wait."""
        if self.phase_role == "prefill":
            toks = int(self._pending_prompt_tokens)
            stok = self._pref_stok_ewma
            secs = toks * stok / max(1, self.num_slots) if stok is not None else 0.0
            return float(secs), toks
        stok = self._stok_ewma
        toks = int(self._pending_new_tokens)
        secs = toks * stok / max(1, self.num_slots) if stok is not None else 0.0
        return float(secs), toks

    def extract_queued(self) -> List[_Request]:
        """Take every queued, not yet admitted request out of this
        scheduler (a pool's drain re-places them). The queue hands each
        item to one consumer, so a request is extracted here or admitted
        by the worker, never both; the WFQ ready pool leaves too."""
        out: List[_Request] = []
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                out.append(req)
        with self._submit_lock:
            if self._ready:
                out.extend(self._ready)
                self._ready.clear()
            if out:
                self._pending_new_tokens = max(
                    0, self._pending_new_tokens - sum(r.max_new for r in out))
                self._pending_prompt_tokens = max(
                    0, self._pending_prompt_tokens - sum(len(r.ids) for r in out))
        return out

    def extract_handoffs(self) -> List[_Request]:
        """Take every packed handoff out of this replica (the pool's
        placement pump and a drain). Each request carries its KV blob
        (`spilled`, `handoff`), so a paged sibling's `requeue` resumes its
        decode without a prefill. Its backlog left this replica at pack
        time."""
        out: List[_Request] = []
        while True:
            try:
                out.append(self._handoff.popleft())
            except IndexError:
                return out

    def requeue(self, req: _Request) -> None:
        """Accept a request extracted from a sibling replica: a fresh rid
        and replica stamp, then the queue. Past `max_queue_depth` on
        purpose: the request was acknowledged once, and a drain must not
        shed it. A request carrying a KV blob needs a paged pool of the
        blob's page size: `ValueError` otherwise, which a pool's handoff
        placement reads as "try the next sibling"."""
        if req.spilled is not None:
            if not self._paged:
                raise ValueError("cannot requeue a KV-page blob onto a contiguous "
                                 "scheduler")
            if req.spilled[0].shape[3] != self._page_size:
                raise ValueError(f"handoff blob page size {req.spilled[0].shape[3]} "
                                 f"!= this pool's {self._page_size}")
        with self._submit_lock:
            if self._closed:
                if self._crash is not None:
                    raise self._crash_error()
                raise RuntimeError("scheduler has shut down")
            if self._thread is None:
                raise RuntimeError("scheduler not started")
            self._rid_seq += 1
            req.rid = self._rid_seq
            req.future._lsot_replica = self.flight.replica
            if self._qos:
                # Another replica's virtual clock means nothing here.
                self._stamp_qos_locked(req)
            self._pending_new_tokens += req.max_new
            self._pending_prompt_tokens += len(req.ids)
            self._queue.put(req)

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

    def _cached_blocks(self) -> int:
        return len(self._prefix_pages if self._paged else self._prefix_cache)

    @property
    def prefix_stats(self) -> Dict[str, object]:
        """Prefix-cache counters: admissions that reused blocks (hits) vs
        cacheable admissions that found none (misses), read in one
        snapshot."""
        return {**self._prefix_stats_from(self._prefix_snapshot()),
                "cached_blocks": self._cached_blocks()}

    def _prefix_snapshot(self) -> Dict[str, object]:
        """The telemetry counter group, copied in one lock acquisition so
        no reader pairs fields across a concurrent admission."""
        with self._submit_lock:
            return {
                "hits": self._prefix_hits,
                "misses": self._prefix_misses,
                "blocks_reused": self._prefix_blocks_reused,
                "reused_tokens": self._prefix_reused_tokens,
                "evictions": self._prefix_evictions,
                "reinserts": self._prefix_reinserts,
                "flops_saved": self._prefix_flops_saved,
                "s_saved": self._prefix_s_saved,
                "hit_ewma": self._prefix_hit_ewma,
                "resident_entries": len(self._prefix_meta),
            }

    @staticmethod
    def _prefix_stats_from(snap: Dict[str, object]) -> Dict[str, object]:
        total = int(snap["hits"]) + int(snap["misses"])
        return {
            "hits": snap["hits"],
            "misses": snap["misses"],
            "hit_rate": round(int(snap["hits"]) / total, 4) if total else 0.0,
            "blocks_reused": snap["blocks_reused"],
            "reused_tokens": snap["reused_tokens"],
            "evictions": snap["evictions"],
        }

    def _resident_page_bytes(self) -> int:
        return page_bytes(self.cfg, self._page_size, self._dtype.itemsize,
                          self.kv_quant)

    @property
    def prefix_telemetry(self) -> Optional[Dict[str, object]]:
        """The `serving.prefix` /metrics block: the counter group, churn
        (reinserts), the hit-rate EWMA, the priced value of the hits
        (prefill FLOPs and seconds saved, utils/perfmodel.prefill_saved)
        and what the cache holds (entries, tokens, device bytes; paged
        residency from the allocator's unique pages, a contiguous entry
        one block). None with the cache off (speculative schedulers
        included)."""
        if not self._prefix_cache_blocks:
            return None
        snap = self._prefix_snapshot()
        entries = int(snap["resident_entries"])
        if self._paged:
            pages = self._page_alloc.prefix_resident_pages
            tokens = pages * self._page_size
            resident_bytes = pages * self._resident_page_bytes()
        else:
            tokens = entries * self._pblock
            resident_bytes = entries * self._prefix_block_bytes
        ewma = snap["hit_ewma"]
        return {
            "replica": self.flight.replica,
            **self._prefix_stats_from(snap),
            "cached_blocks": self._cached_blocks(),
            "reinserts": snap["reinserts"],
            "hit_rate_ewma": round(ewma, 4) if ewma is not None else 0.0,
            "prefill_flops_saved": round(float(snap["flops_saved"]), 1),
            "prefill_s_saved": round(float(snap["s_saved"]), 6),
            "resident_entries": entries,
            "resident_tokens": tokens,
            "resident_bytes": resident_bytes,
        }

    def resident_digests(self, limit: Optional[int] = None) -> List[str]:
        """The hottest resident prefix digests (by hits, then tokens)."""
        k = limit if limit and limit > 0 else self._prefix_topk
        with self._submit_lock:
            metas = sorted(self._prefix_meta.values(),
                           key=lambda m: (int(m["hits"]), int(m["tokens"])),
                           reverse=True)[:k]
        return [str(m["digest"]) for m in metas]

    def prefix_registry(self, top_k: Optional[int] = None) -> Dict[str, object]:
        """The /debug/prefixcache payload: the top-K resident entries by
        token mass (digest, tokens, hits, insert/last-hit round; paged:
        pages, bytes and the live share count of the chain's deepest page;
        contiguous: one block and its bytes), the reuse-distance histogram
        and the telemetry block. Entries carry digests, never token ids."""
        k = top_k if top_k and top_k > 0 else self._prefix_topk
        tel = self.prefix_telemetry
        # Metadata, page tuples and refcounts in one acquisition: read
        # piecemeal, an entry evicted mid-read could report a reused
        # page's refcount.
        with self._submit_lock:
            rd = dict(self._prefix_rd_hist)
            metas = []
            for key, m in self._prefix_meta.items():
                pages = self._prefix_pages.get(key) if self._paged else None
                metas.append((m, pages, self._page_alloc.refcount(pages[-1])
                              if pages else None))
        entries: List[Dict[str, object]] = []
        for m, pages, shares in metas:
            e: Dict[str, object] = {
                "digest": m["digest"], "tokens": m["tokens"], "hits": m["hits"],
                "insert_round": m["insert_round"],
                "last_hit_round": m["last_hit_round"],
            }
            if self._paged:
                if pages is None:
                    continue  # evicted between its meta pop and page pop
                e["pages"] = len(pages)
                e["bytes"] = len(pages) * self._resident_page_bytes()
                e["shares"] = shares
            else:
                e["blocks"] = 1
                e["bytes"] = self._prefix_block_bytes
            entries.append(e)
        entries.sort(key=lambda e: (int(e["tokens"]), int(e["hits"])), reverse=True)
        return {
            "replica": self.flight.replica,
            "enabled": bool(self._prefix_cache_blocks),
            "block_tokens": self._pblock,
            "capacity": self._prefix_cache_blocks,
            "ring": self._prefix_ring_cap,
            "top_k": k,
            "entries": entries[:k],
            "reuse_distance": rd,
            **({k2: v for k2, v in tel.items() if k2 != "replica"} if tel else {}),
        }

    @property
    def perf_stats(self) -> Dict[str, object]:
        """The `serving.perf` /metrics payload: the ledger's pricing
        assumptions and per-phase EWMAs of the live roofline position."""
        return {"replica": self.flight.replica, **self.perf.stats()}

    # ------------------------------------------------- prefix telemetry

    def _digest_for(self, key: Tuple[int, ...]) -> str:
        """Memoized content digest of a chain key (worker thread only)."""
        memo = self._prefix_digest_memo
        d = memo.get(key)
        if d is None:
            d = memo[key] = prefix_digest(key)
            bound = 4 * max(self._prefix_topk, self._prefix_cache_blocks or 1)
            while len(memo) > bound:
                memo.popitem(last=False)
        else:
            memo.move_to_end(key)
        return d

    def _prefix_note_publish(self, key: Tuple[int, ...]) -> None:
        """Register a published entry: its digest and metadata, and a
        reinsertion when the key was evicted before."""
        digest = self._digest_for(key)
        with self._submit_lock:
            if key in self._prefix_evicted_ghost:
                del self._prefix_evicted_ghost[key]
                self._prefix_reinserts += 1
            self._prefix_meta[key] = {
                "digest": digest, "tokens": len(key), "hits": 0,
                "insert_round": self.heartbeat.rounds, "last_hit_round": None,
            }

    def _prefix_note_evict(self, key: Tuple[int, ...],
                           pages: Optional[Tuple[int, ...]] = None) -> None:
        """An entry left the cache: count it, drop its metadata, remember
        the key for the reinsertion check, and drop the allocator's
        resident-prefix accounting of its pages (paged)."""
        if pages is not None:
            self._page_alloc.prefix_drop(list(pages))
        with self._submit_lock:
            self._prefix_evictions += 1
            self._prefix_meta.pop(key, None)
            self._prefix_evicted_ghost[key] = None
            while len(self._prefix_evicted_ghost) > 4 * self._prefix_cache_blocks:
                self._prefix_evicted_ghost.popitem(last=False)

    def _prefix_note_admission(self, req: _Request, ids: Sequence[int],
                               reuse: int, blocks: int) -> None:
        """Reuse attribution at admission: stamp the request (digest,
        tokens reused, prefill seconds saved), move the hit/miss group,
        feed the reuse-distance ring, and queue the {rid, digest, reused,
        prefilled} row for the next flight record. A hit's digest is the
        matched entry's; a miss's the longest whole-block prompt prefix's;
        a prompt shorter than one block is not cacheable and counts
        nowhere."""
        pb = self._pblock
        max_blocks = (len(ids) - 1) // pb
        hit = reuse > 0
        # The tenant salt (`req.ns`) prefixes every key and digest, as at
        # the cache-key sites: () for unlabeled traffic.
        if hit:
            digest = self._digest_for(req.ns + tuple(ids[:reuse]))
        elif max_blocks:
            digest = self._digest_for(req.ns + tuple(ids[: max_blocks * pb]))
        else:
            digest = ""
        flops = secs = 0.0
        if hit:
            flops, secs = self.perf.prefill_saved(reuse)
        req.prefix_digest = digest
        req.tokens_reused = reuse
        req.prefill_s_saved = secs
        bucket = None
        if digest:
            seq = self._prefix_adm_seq
            last = self._prefix_ring_seq.get(digest)
            dist = (seq - last if last is not None
                    and seq - last <= self._prefix_ring_cap else None)
            bucket = "inf" if dist is None else str(
                next(b for b in self._prefix_rd_buckets if dist <= b))
        with self._submit_lock:
            if hit:
                self._prefix_hits += 1
                self._prefix_blocks_reused += blocks
                self._prefix_reused_tokens += reuse
                self._prefix_flops_saved += flops
                self._prefix_s_saved += secs
                meta = self._prefix_meta.get(req.ns + tuple(ids[:reuse]))
                if meta is not None:
                    meta["hits"] += 1
                    meta["last_hit_round"] = self.heartbeat.rounds
            elif digest:
                self._prefix_misses += 1
            if digest:
                x = 1.0 if hit else 0.0
                prev = self._prefix_hit_ewma
                self._prefix_hit_ewma = x if prev is None else 0.2 * x + 0.8 * prev
                self._prefix_rd_hist[bucket] = self._prefix_rd_hist.get(bucket, 0) + 1
                self._prefix_ring_seq[digest] = self._prefix_adm_seq
                self._prefix_adm_seq += 1
                if len(self._prefix_ring_seq) > 2 * self._prefix_ring_cap:
                    cutoff = self._prefix_adm_seq - self._prefix_ring_cap
                    self._prefix_ring_seq = {d: q for d, q in self._prefix_ring_seq.items()
                                             if q >= cutoff}
        if digest:
            self._round_prefix.append({"rid": req.rid, "digest": digest,
                                       "reused": reuse,
                                       "prefilled": len(ids) - reuse})

    # ------------------------------------------------ on-demand profiling

    def _profile_owner(self) -> str:
        return f"sched:{self.flight.replica}:{id(self):x}"

    def profile_rounds(self, rounds: Optional[int] = None,
                       out_dir: Optional[str] = None) -> Dict[str, object]:
        """Arm a bounded torch.profiler capture of the next `rounds`
        scheduler rounds (the /debug/profile seam): it starts on the worker
        thread at the next issued round and stops after N harvested
        rounds, written as a gzipped Chrome trace under `out_dir` (default:
        utils/traceprof.profile_defaults, else a temporary directory).
        Raises ValueError for rounds < 1 and RuntimeError while any capture
        is in flight in the process."""
        import tempfile

        d_def, r_def = traceprof.profile_defaults()
        n = r_def if rounds is None else int(rounds)
        if n < 1:
            raise ValueError(f"rounds must be >= 1, got {n}")
        owner = self._profile_owner()
        if not traceprof.try_acquire_capture(owner):
            raise RuntimeError(
                f"a device profile capture is already in flight (owner "
                f"{traceprof.capture_owner()}); one at a time per process")
        base = out_dir or d_def
        try:
            if base:
                d = os.path.join(base, f"profile-{int(time.time() * 1000)}-"
                                       f"{self.flight.replica}")
                os.makedirs(d, exist_ok=True)
            else:
                d = tempfile.mkdtemp(prefix="lsot_profile_")
        except OSError:
            traceprof.release_capture(owner)
            raise
        with self._profile_lock:
            self._profile_arm = {"rounds": n, "dir": d, "owner": owner,
                                 "armed_at": time.time()}
        return {"state": "armed", "rounds": n, "dir": d,
                "replica": self.flight.replica}

    def profile_status(self) -> Dict[str, object]:
        """Capture state: armed, capturing (rounds left) or idle, and the
        last finished capture's artifacts."""
        with self._profile_lock:
            arm, active, last = (self._profile_arm, self._profile_active,
                                 self._profile_last)
            out: Dict[str, object] = {"replica": self.flight.replica}
            if active is not None:
                out.update({"state": "capturing",
                            "rounds_left": active["rounds_left"],
                            "dir": active["dir"]})
            elif arm is not None:
                out.update({"state": "armed", "rounds": arm["rounds"],
                            "dir": arm["dir"]})
            else:
                out["state"] = "idle"
            if last is not None:
                out["last"] = dict(last)
        return out

    def _maybe_start_profile(self) -> None:
        """Worker thread: start the armed capture so the next issued round
        is inside it."""
        with self._profile_lock:
            arm = self._profile_arm
            if arm is None or self._profile_active is not None:
                return
            self._profile_arm = None
        try:
            prof = traceprof.start_capture(self.device.type == "cuda")
        except Exception as e:  # noqa: BLE001 — profiling must not kill serving
            traceprof.release_capture(arm["owner"])
            with self._profile_lock:
                self._profile_last = {"state": "error", "error": str(e)[:200],
                                      "dir": arm["dir"]}
            return
        with self._profile_lock:
            self._profile_active = {
                "rounds_left": arm["rounds"], "rounds": arm["rounds"],
                # Rounds already in flight were issued before the capture
                # started: their harvests do not count toward it.
                "skip": len(self._pending),
                "dir": arm["dir"], "owner": arm["owner"],
                "started": time.time(), "prof": prof,
            }
        self.flight.event("profile_start", rounds=arm["rounds"], dir=arm["dir"])

    def _profile_round_done(self) -> None:
        with self._profile_lock:
            st = self._profile_active
            if st is None:
                return
            if st["skip"] > 0:
                st["skip"] -= 1
                return
            st["rounds_left"] -= 1
            if st["rounds_left"] > 0:
                return
            self._profile_active = None
        self._finish_profile(st)

    def _finish_profile(self, st: Dict[str, object],
                        error: Optional[str] = None) -> None:
        try:
            traceprof.stop_capture(st["prof"], str(st["dir"]))
        except Exception as e:  # noqa: BLE001 — a failed stop is still a finish
            error = error or str(e)[:200]
        arts = traceprof.find_profile_artifacts(str(st["dir"]))
        out: Dict[str, object] = {
            "state": "done" if arts else "error",
            "dir": st["dir"],
            "rounds": st["rounds"],
            "artifacts": arts,
            "artifact_bytes": sum(os.path.getsize(a) for a in arts
                                  if os.path.exists(a)),
            "wall_s": round(time.time() - float(st["started"]), 3),
        }
        if error:
            out["error"] = error
            out["state"] = "error"
        with self._profile_lock:
            self._profile_last = out
        traceprof.release_capture(str(st["owner"]))
        self.flight.event("profile_done", state=out["state"], artifacts=len(arts))

    def _abort_profile(self, reason: str) -> None:
        """An armed or running capture must not hold the process-wide slot
        (or a profiler session) past the loop that owned it."""
        with self._profile_lock:
            arm, self._profile_arm = self._profile_arm, None
            active, self._profile_active = self._profile_active, None
        if arm is not None:
            traceprof.release_capture(str(arm["owner"]))
            with self._profile_lock:
                self._profile_last = {"state": "aborted", "error": reason,
                                      "dir": arm["dir"]}
        if active is not None:
            self._finish_profile(active, error=reason)

    @property
    def speculation_stats(self) -> Optional[Dict[str, object]]:
        """Speculative acceptance (None with speculation off): verify rounds
        and the tokens they emitted (rounds in which a slot emitted
        something, each counted once a slot; a round's tokens past a stop
        id or the budget included, as in the JAX scheduler), tokens a
        round, and the estimated speedup over vanilla decode at this
        configuration's verify cost (`verify_cost_ratio`); split by
        constrained vs free requests (`by_class`) and greedy vs sampled
        (`by_sampling`). `tokens_delivered` is what the requests received
        from verify rounds (stop ids and tokens past a budget left out)."""
        if not self._spec_draft:
            return None
        from ..engine.speculative import VERIFY_COST_CALIBRATION, verify_cost_ratio

        with self._submit_lock:
            rounds, toks = self._spec_rounds, self._spec_tokens
            rounds_con, toks_con = self._spec_rounds_con, self._spec_tokens_con
            rounds_samp, toks_samp = self._spec_rounds_samp, self._spec_tokens_samp
            delivered = self._spec_delivered
        ratio = verify_cost_ratio(self._spec_draft, cfg=self.cfg,
                                  weight_bits=self._weight_bits)

        def acceptance(r: int, t: int) -> Dict[str, float]:
            tpr = t / r if r else 0.0
            return {"verify_rounds": r, "tokens_emitted": t,
                    "tokens_per_round": round(tpr, 3),
                    "est_speedup_vs_vanilla": round(tpr / ratio, 3) if r else 0.0}

        return {
            **acceptance(rounds, toks),
            "tokens_delivered": delivered,
            "verify_cost_ratio": round(ratio, 3),
            "est_speedup_calibration": VERIFY_COST_CALIBRATION,
            "by_class": {
                "constrained": acceptance(rounds_con, toks_con),
                "unconstrained": acceptance(rounds - rounds_con, toks - toks_con),
            },
            "by_sampling": {
                "greedy": acceptance(rounds - rounds_samp, toks - toks_samp),
                "sampled": acceptance(rounds_samp, toks_samp),
            },
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
        self.flight.event("grammar_swap",
                          fingerprint=str(getattr(compiled, "fingerprint", ""))[:16])

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
            # Keys carry the request's tenant salt: a tenant matches (and
            # evicts) only entries its own admissions published.
            while n < max_blocks and \
                    req.ns + tuple(ids[: (n + 1) * pb]) in self._prefix_pages:
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
        entry = self._prefix_pages.get(req.ns + tuple(ids[:reuse])) if reuse else None
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
                key = req.ns + tuple(ids[: (j + 1) * pb])
                if key in self._prefix_pages:
                    self._prefix_pages.move_to_end(key)
        if self._prefix_cache_blocks and req.spilled is None:
            self._prefix_note_admission(req, ids, reuse, n)
        return True

    def _admit_blocks(self, slot: int, req: _Request) -> None:
        """Contiguous prefix reuse: copy the longest cached chain of blocks
        of the prompt into the slot's row, device to device. At least one
        prompt token still goes through prefill (its logit samples the
        first output token)."""
        pb, ids = self._pblock, req.ids
        max_blocks = (len(ids) - 1) // pb
        n = 0
        while n < max_blocks and req.ns + tuple(ids[: (n + 1) * pb]) in self._prefix_cache:
            n += 1
        # A reuse offset shifts every chunk start; the final chunk's bucket
        # must still land inside the cache.
        s_cache = next(iter(self._cache.values())).shape[3]
        while n and self._chunk_end(n * pb, len(ids)) > s_cache:
            n -= 1
        for j in range(n):
            key = req.ns + tuple(ids[: (j + 1) * pb])
            self._prefix_cache.move_to_end(key)  # LRU touch
            self._mirror("_follow_restore", key, slot, j * pb)
            self._restore_block(self._prefix_cache[key], slot, j * pb)
        req.prefilled = n * pb
        self._prefix_note_admission(req, ids, n * pb, n)

    def _admit(self, slot: int, req: _Request) -> bool:
        """Reserve `slot` and queue the prompt for chunked prefill, reusing
        any cached prefix first. Returns False only when the page pool
        cannot hold the request yet."""
        if req.cancelled:  # cancelled while queued: never occupy a slot
            self._observe_terminal(req)
            req.future.set_result(req.generated)
            return True
        if req.past_deadline():  # expired while queued: fail fast, typed
            resilience.inc("deadline_expired")
            self._observe_terminal(req, error="DeadlineExceeded")
            req.future.set_exception(req.deadline_error())
            return True
        if self._paged and not self._admit_paged(slot, req):
            return False
        if not req.admitted_at:
            # A resume keeps its first admission: queue wait is submit ->
            # first slot.
            req.admitted_at = time.perf_counter()
        self._round_admitted.append(req.rid)
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
            logits, _ = self._fwd(tokens_t, positions, cache,
                                  logit_indices=last, span=span)
        else:
            # Over the slots' own cache rows, one layer at a time, reading
            # the slots below the chunks' end (rounded up to 64).
            logits, _ = self._fwd(tokens_t, positions,
                                  self._cache, logit_indices=last,
                                  rows=self._h2d([s for s, _ in group], torch.int64),
                                  span=span + -span % 64)
        self.prefill_forwards += 1
        self._note_prefill(starts, t)
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

    def _note_prefill(self, starts: List[int], t: int) -> None:
        """Bank a prefill forward's work in the ledger (its rows at their
        mean chunk start); the next harvest attributes the pile over the
        inter-harvest wall. The rows are the group as it is: the forward
        pads no group to a k-bucket."""
        self.perf.note_prefill(rows=len(starts), tokens=t,
                               ctx=sum(starts) // len(starts) + t // 2)

    def _prefill_step(self) -> None:
        """Run ONE prompt chunk for up to `_prefill_kmax` waiting requests
        of the same bucket in a single forward (chunked prefill interleaves
        with decode rounds instead of stalling every active slot)."""
        group, t = self._take_group()
        if not group:
            return
        with self._dispatch_lock:
            if self._paged:  # copy-on-write sweep over each chunk's write window
                for slot, req in group:
                    self._ensure_writable(slot, req.prefilled, req.prefilled + t)
            self._after_chunk(group, t, self._prefill_forward(group, t))

    def _after_chunk(self, group, t: int, toks) -> None:
        """The host side of a `t`-bucket chunk for each (slot, req) of
        `group`: publish its prefix blocks, queue its next chunk, or arm the
        slot: with the still-on-device first token `toks[i]`, attached to
        the next harvest; a resume from its committed state instead. Under
        speculation the chunks' tokens go into the draft history first."""
        if self._spec_draft:
            tokens, _, starts = self._chunk_rows(group, t)
            cols = (self._h2d(starts, torch.int64)[:, None]
                    + torch.arange(t, device=self.device)).clamp(
                        max=self._hist.shape[1] - 1)
            self._hist[self._h2d([sl for sl, _ in group], torch.int64)[:, None],
                       cols] = self._h2d(tokens, torch.int32)
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
            if self.phase_role == "prefill":
                # Not armed for decode: `_pack_handoffs`, right after this
                # step, commits the first token and exports the slot's
                # pages; the importing replica arms it through the resume.
                self._handoff_pending.append((slot, req, toks[i], self._slot_epoch[slot]))
                continue
            # No sync: stop/budget checks on the first token happen at the
            # harvest it rides, one round late.
            req.ready = True
            req.ready_at = time.perf_counter()
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
            if self._spec_draft:  # the first token joins the draft history
                self._hist[slot, len(req.ids)] = toks[i]
                self._hlen[slot] = len(req.ids) + 1
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
            key = req.ns + tuple(req.ids[: (b0 + 1) * pb])
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                continue
            if self._first_sighting(key):
                continue
            self._mirror("_follow_publish", key, slot, b0 * pb)
            entry = self._prefix_cache[key] = self._slice_block(slot, b0 * pb)
            if not self._prefix_block_bytes:
                self._prefix_block_bytes = sum(b.nbytes for b in entry.values())
            self._prefix_note_publish(key)
            while len(self._prefix_cache) > self._prefix_cache_blocks:
                evicted = self._prefix_cache.popitem(last=False)[0]
                self._mirror("_follow_evict", evicted)
                self._prefix_note_evict(evicted)

    def _publish_blocks_paged(self, slot: int, req: _Request,
                              chunk_start: int) -> None:
        """Publish the chunk's completed prefix blocks: an entry is a
        REFERENCE to the publisher's pages (refcount++), gated on the
        block's second sighting."""
        pb, ps = self._pblock, self._page_size
        ids = req.full_ids
        for b0 in range(chunk_start // pb, req.prefilled // pb):
            key = req.ns + tuple(ids[: (b0 + 1) * pb])
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
            self._prefix_note_publish(key)
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
            logits, _ = self._fwd(
                cur[:, None], pos[:, None], cache,
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

    def _mixed_slots(self, group, t: int, width: int):
        """The slot-wide rows of a mixed round's chunk rows (`group`, chunks
        of `t` tokens padded to `width` columns); other slots carry inert
        defaults. Returns (lengths of the group's chunks, chunk tokens [S,
        width] (device), is_pref [S] (device), starts [S] (device), chunk
        lengths [S] (host), the knobs [temps, topps, topks, seeds] (host
        lists))."""
        pad, num_slots = self.cfg.pad_id, self.num_slots
        tokens, lengths, starts = self._chunk_rows(group, t)
        p_tokens = [[pad] * width for _ in range(num_slots)]
        p_lengths, p_starts = [1] * num_slots, [0] * num_slots
        is_pref = [False] * num_slots
        knobs = [[0.0] * num_slots, [1.0] * num_slots, [0] * num_slots, [0] * num_slots]
        for i, (slot, req) in enumerate(group):
            p_tokens[slot] = tokens[i] + [pad] * (width - t)
            p_lengths[slot], p_starts[slot] = lengths[i], starts[i]
            is_pref[slot] = True
            for row, v in zip(knobs, (req.temperature, req.top_p, req.top_k,
                                      req.seed & _M32)):
                row[slot] = v
        return (lengths, self._h2d(p_tokens, torch.int32), self._h2d(is_pref, torch.bool),
                self._h2d(p_starts, torch.int32), p_lengths, knobs)

    def _mixed_forward(self, group, t: int, active: torch.Tensor, sampled: bool,
                       grammar: bool, window=None):
        """ONE forward over every slot (JAX `_build_mixed`, `_build_mixed_spec`):
        the chunk rows of `group` carry their chunk (q_lens t) and the decode
        slots `window`, (tokens, positions) [slots, w], their current token
        (w = 1) without one, in max(t, w) columns; dead columns sit at the
        virtual row's end, where their writes drop and the mask keeps their
        logits finite. Chunk rows sample their first token from their last
        real column at index 0 of their stream, decode rows from column 0
        at counts, as the alternating rounds do; with `grammar`, chunk rows
        under their `_chunk_grammar` state and budget, decode rows under
        their own. Returns (the decode rows' window logits [slots, w, V],
        the samples [slots])."""
        cfg, dev, num_slots = self.cfg, self.device, self.num_slots
        pad = cfg.pad_id
        s_virt = self._pages_per_slot * self._page_size
        w_tok, w_pos = window or (self._cur[:, None], self._pos[:, None])
        w = w_tok.shape[1]
        width = max(t, w)
        lengths, p_tok, pref, p_start, p_lengths, knobs = self._mixed_slots(group, t, width)
        if width > w:
            dead = (num_slots, width - w)
            w_tok = torch.cat([w_tok, torch.full(dead, pad, dtype=torch.int32, device=dev)], 1)
            w_pos = torch.cat([w_pos, torch.full(dead, s_virt, dtype=torch.int32,
                                                 device=dev)], 1)
        col = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
        tokens0 = torch.where(pref[:, None], p_tok, w_tok)
        pos0 = torch.where(pref[:, None],
                           torch.where(col < t, p_start[:, None] + col, s_virt), w_pos)
        kv0 = torch.where(pref, (p_start + t).clamp(0, s_virt),
                          torch.where(active, self._pos + w, 0))
        # A parked slot's one column writes at its park position, as the
        # alternating rounds' steps do; a verify window from there would
        # run past it, so its columns are dead.
        q_lens = torch.where(pref, t, torch.where(active, w, int(w == 1)))
        last = torch.where(pref, self._h2d(p_lengths, torch.int64) - 1, 0)
        cache = dict(self._pool, ptab=self._ptab)
        if w == 1:  # one column a row: unembed it alone
            logits, _ = self._fwd(tokens0, pos0, cache,
                                  logit_indices=last, kv_lens=kv0,
                                  q_lens=q_lens.to(torch.int32))
            first = logits[:, 0]
        else:
            logits, _ = self._fwd(tokens0, pos0, cache, kv_lens=kv0,
                                  q_lens=q_lens.to(torch.int32))
            first = logits[torch.arange(num_slots, device=dev), last]
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
            firsts = sample_runtime(first, temps, topps, topks, seeds,
                                    torch.where(pref, 0, self._counts))
        else:
            firsts = greedy(first)
        return logits[:, :w], firsts

    def _mixed_round(self, group, t: int, active: torch.Tensor, sampled: bool,
                     grammar: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """A ragged mixed round: `_mixed_forward`, then steps 1..chunk-1, the
        usual T=1 steps, the chunk rows inactive. Returns (tokens [slots,
        chunk], step 0's samples [slots])."""
        _, firsts = self._mixed_forward(group, t, active, sampled, grammar)
        cur = torch.where(active, firsts, self.cfg.pad_id)
        pos = torch.where(active, self._pos + 1, self._pos)
        cstates, crem = self._cstates, self._crem
        if grammar:  # decode rows commit step 0's token
            cstates, crem = self._grammar_step(active, cstates, crem, cur)
        return self._decode_steps(active, sampled, grammar, cur, pos, cstates, crem,
                                  1, [cur]), firsts

    # ---------------------------------------------------------- speculation

    def _spec_window(self):
        """This round's drafts [S, D] (prompt lookup over each slot's
        history) and verify window: tokens [S, D+1] (the current token, then
        the drafts) at positions [S, D+1]."""
        drafts = ngram_draft(self._hist, self._hlen, self._spec_draft, NGRAM)
        jd = torch.arange(self._spec_draft + 1, dtype=torch.int32, device=self.device)
        return (drafts, torch.cat([self._cur[:, None], drafts], dim=1),
                self._pos[:, None] + jd)

    def _spec_round(self, active: torch.Tensor, sampled: bool, grammar: bool):
        """One speculative round of the whole slot batch: one forward of T =
        D + 1 (parked slots read nothing; contiguous, their writes land in
        their own row's tail, `_write_cache`; paged, `q_lens` 0 drops them),
        then `_commit_verify`. Returns (emitted [S, D+1], n_emit [S])."""
        d1 = self._spec_draft + 1
        drafts, verify, vpos = self._spec_window()
        kv_lens = torch.where(active, self._pos + d1, 0)
        if self._paged:
            logits, _ = self._fwd(verify, vpos,
                                  dict(self._pool, ptab=self._ptab), kv_lens=kv_lens,
                                  q_lens=torch.where(active, d1, 0).to(torch.int32))
        else:
            logits, _ = self._fwd(verify, vpos, self._cache,
                                  kv_lens=kv_lens)
        return self._commit_verify(logits, drafts, active, sampled, grammar)

    def _commit_verify(self, logits: torch.Tensor, drafts: torch.Tensor,
                       active: torch.Tensor, sampled: bool, grammar: bool):
        """Acceptance and commit of a verify window's logits [S, D+1, V]
        (`verify_commit`) under each slot's budget, with `grammar` its FSM
        state; sampled slots (only when `sampled`) accept by rejection
        sampling at their stream index, which then advances by one. Active
        slots emit acc + 1 tokens and advance history, position, current
        token and grammar state past them, on the device. Returns (emitted
        [S, D+1], pad past n_emit; n_emit [S], 0 when inactive)."""
        d1 = self._spec_draft + 1
        knobs = draws = None
        if sampled:
            knobs = (self._temps, self._topps, self._topks)
            draws = verify_draws(self._seeds, self._counts, self._spec_draft,
                                 logits.shape[-1])
            # One stream index a sampled round, whatever it accepted.
            self._counts = torch.where(active & (self._temps > 0.0), self._counts + 1,
                                       self._counts)
        emitted, n_emit, self._cur, cstates = verify_commit(
            logits, drafts, self._cur, self._crem, torch.where(active, d1, 0),
            self.cfg.pad_id, tables=self._ctables if grammar else None,
            cstates=self._cstates, knobs=knobs, draws=draws)
        if grammar:
            self._cstates = cstates
        width = self._hist.shape[1]
        jd = torch.arange(d1, device=self.device)[None, :]
        at = torch.where(active, self._hlen, width).clamp(max=width - d1)
        self._hist.scatter_(1, at[:, None] + jd, emitted)
        self._crem = self._crem - n_emit.to(self._crem.dtype)
        self._pos = self._pos + n_emit.to(self._pos.dtype)
        self._hlen = self._hlen + n_emit
        return emitted, n_emit.to(torch.int32)

    def _mixed_spec_round(self, group, t: int, active: torch.Tensor, sampled: bool,
                          grammar: bool):
        """The speculative ragged mixed round (JAX `_build_mixed_spec`):
        `_mixed_forward` with the decode slots' verify windows (q_lens D+1;
        parked slots 0), whose logits go through `_commit_verify`. Returns
        (emitted, n_emit, the chunk rows' first tokens)."""
        drafts, verify, vpos = self._spec_window()
        logits, firsts = self._mixed_forward(group, t, active, sampled, grammar,
                                             (verify, vpos))
        emitted, n_emit = self._commit_verify(logits, drafts, active, sampled, grammar)
        return emitted, n_emit, firsts

    def _issue_decode(self) -> None:
        """Enqueue one decode round; nothing synchronises here. Its tokens
        are harvested `_harvest_lag` rounds later."""
        # Duration-valued hang seam: `sched:hang:p:secs` sleeps here, the
        # wedge that never raises, which the supervisor's watchdog must
        # detect from the stale heartbeat.
        FAULTS.check("sched:hang")
        if FAULTS.active:
            # Replica-addressable seam (`sched:wedge_r1:p[:secs]`): wedge
            # (duration form) or crash (raising form) one pool replica by
            # its label, its siblings untouched.
            FAULTS.check(f"sched:wedge_{self.flight.replica}")
        with self._dispatch_lock:  # after the seams: a wedge holds no lock
            t_issue = time.perf_counter()
            start = self._device_mark()
            issue_reqs = [r if r is not None and r.ready else None
                          for r in self._slot_req]
            active = self._h2d([r is not None for r in issue_reqs], torch.bool)
            sampled = any(r is not None and r.temperature > 0.0 for r in issue_reqs)
            grammar = any(r is not None and r.constraint is not None
                          for r in issue_reqs)
            n_emit = None
            if self._spec_draft:
                toks, n_emit = self._spec_round(active, sampled, grammar)
            else:
                toks = self._decode_round(active, sampled, grammar)
            end = self._device_mark()
        self.rounds_issued += 1
        self._pending.append((issue_reqs, list(self._slot_epoch), toks,
                              self._first_pending, n_emit, t_issue, (start, end), None))
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
        with self._dispatch_lock:  # after the seam: a wedge holds no lock
            t_issue = time.perf_counter()
            start = self._device_mark()
            for slot, req in group:  # copy-on-write sweep over the windows
                self._ensure_writable(slot, req.prefilled, req.prefilled + t)
            issue_reqs = [r if r is not None and r.ready else None
                          for r in self._slot_req]
            active = self._h2d([r is not None for r in issue_reqs], torch.bool)
            sampled = any(r.temperature > 0.0 for r in issue_reqs if r is not None) \
                or any(req.temperature > 0.0 for _, req in group)
            grammar = any(r.constraint is not None for r in issue_reqs if r is not None) \
                or any(req.constraint is not None for _, req in group)
            starts = [req.prefilled for _, req in group]
            if all(r is None for r in issue_reqs):
                _, firsts = self._mixed_forward(group, t, active, sampled, grammar)
                self.ragged_prefills += 1
                # Not a round: banked like a prefill forward.
                self._note_prefill(starts, t)
                self._after_chunk(group, t, [firsts[slot] for slot, _ in group])
                return True
            n_emit = None
            if self._spec_draft:
                toks, n_emit, firsts = self._mixed_spec_round(group, t, active, sampled,
                                                              grammar)
            else:
                toks, firsts = self._mixed_round(group, t, active, sampled, grammar)
            self.rounds_issued += 1
            self.mixed_rounds += 1
            self._after_chunk(group, t, [firsts[slot] for slot, _ in group])
            # Both phases' work attributes over this round's wall at harvest.
            mixed_meta = {"pre_rows": len(group), "pre_tokens": t,
                          "pre_ctx": sum(starts) // len(starts) + t // 2}
            self._pending.append((issue_reqs, list(self._slot_epoch), toks,
                                  self._first_pending, n_emit, t_issue,
                                  (start, self._device_mark()), mixed_meta))
            self._first_pending = []
            return True

    # --------------------------------------------------------------- retire

    def _retire(self, slot: int, req: _Request, result: List[int]) -> None:
        self._record_service_time(req)
        self._observe_terminal(req)
        req.future.set_result(result)
        self._release_slot(slot)

    def _observe_terminal(self, req: _Request,
                          error: Optional[str] = None) -> None:
        """Terminal bookkeeping before the future resolves: the trace's
        sched.* spans, the queue wait on the future (admission less submit;
        a never-admitted request's whole life), and the rid in this
        round's retired column."""
        now = time.perf_counter()
        req.flush_spans(now)
        if req.trace is not None and error is not None:
            req.trace.event("sched.error", error=error, rid=req.rid)
        if req.admitted_at and req.submitted_at:
            req.future._lsot_queue_wait = req.admitted_at - req.submitted_at
        elif req.submitted_at:
            req.future._lsot_queue_wait = now - req.submitted_at
        self._round_retired.append(req.rid)
        with self._submit_lock:
            self._pending_new_tokens = max(0, self._pending_new_tokens - req.max_new)
            self._pending_prompt_tokens = max(0, self._pending_prompt_tokens
                                              - len(req.ids))

    def _record_service_time(self, req: _Request) -> None:
        """EWMAs (alpha 0.2) of completed requests' submit->retire wall, of
        its seconds a generated token and, paged, of the generation length;
        a cancelled request says nothing about any. Under the submit lock:
        retry_after_hint and backlog_score read them from other threads."""
        if req.submitted_at <= 0.0 or req.cancelled:
            return
        wall = time.perf_counter() - req.submitted_at
        stok = wall / max(1, len(req.generated))
        with self._submit_lock:
            prev = self._svc_ewma
            self._svc_ewma = wall if prev is None else 0.2 * wall + 0.8 * prev
            prev_t = self._stok_ewma
            self._stok_ewma = stok if prev_t is None else 0.2 * stok + 0.8 * prev_t
            if self._paged:
                g = float(len(req.generated))
                prev_g = self._gen_ewma
                self._gen_ewma = g if prev_g is None else 0.2 * g + 0.8 * prev_g

    def _fail_slot(self, slot: int, req: _Request, exc: Exception) -> None:
        """Retire a slot with a typed failure (deadline expiry)."""
        self._observe_terminal(req, error=type(exc).__name__)
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
                      epoch: int) -> int:
        """Apply a harvested prefill first token: stop/budget checks run
        here, one round late. Returns the tokens appended (0 or 1)."""
        if req is not self._slot_req[slot] or epoch != self._slot_epoch[slot]:
            return 0
        if req.past_deadline():
            resilience.inc("deadline_expired")
            self._fail_slot(slot, req, req.deadline_error())
            return 0
        if req.cancelled or first in self.stop_ids or req.max_new < 1:
            self._retire(slot, req, req.generated)
            return 0
        req.generated.append(first)
        req.emit(first)
        if len(req.generated) >= req.max_new:
            self._retire(slot, req, req.generated)
        return 1

    def _harvest_round(self) -> None:
        """Synchronise on the OLDEST in-flight round: one transfer brings
        its tokens and the prefill first tokens attached to it; retire
        finished requests and free their slots."""
        # Chaos seam: `sched:crash` kills the loop mid-batch (rounds issued,
        # tokens possibly streamed, slots occupied); a supervisor must
        # restart it and replay every acknowledged request without
        # duplicating delivered tokens.
        FAULTS.check("sched:crash")
        (issue_reqs, epochs, toks_dev, firsts, n_emit_dev, t_issue, marks,
         mixed_meta) = self._pending.popleft()
        width = toks_dev.shape[1]  # decode_chunk, or D + 1 under speculation
        spec = n_emit_dev is not None
        flat = torch.cat([toks_dev.reshape(-1)]
                         + ([n_emit_dev.to(toks_dev.dtype)] if spec else [])
                         + [tok.reshape(1).to(toks_dev.dtype)
                            for _, _, tok, _ in firsts]).tolist()
        t_harvest = time.perf_counter()
        n_tok = self.num_slots * width
        n_emit = flat[n_tok: n_tok + self.num_slots] if spec else None
        first_at = n_tok + (self.num_slots if spec else 0)
        occupancy = sum(1 for r in issue_reqs if r is not None)
        # Tokens the requests received this round, and under speculation
        # the emitted tokens by grammar class and by sampling class.
        round_emitted = 0
        spec_emitted = {"constrained": 0, "unconstrained": 0,
                        "greedy": 0, "sampled": 0}
        # Firsts precede the round's tokens in every stream.
        for j, (slot, req, _, fep) in enumerate(firsts):
            round_emitted += self._append_first(slot, req, flat[first_at + j], fep)
        stalled = []
        for i, req in enumerate(issue_reqs):
            if req is None or req is not self._slot_req[i] \
                    or epochs[i] != self._slot_epoch[i]:
                continue  # inactive at issue, or retired or preempted since
            # The host mirror of the slot's sample index for this committed
            # round: what a preemption's resume restores (a speculative
            # round takes one index from a sampled slot, none from a greedy
            # one).
            if not spec:
                req.rng_count += width
            elif req.temperature > 0.0:
                req.rng_count += 1
            if req.cancelled:
                self._retire(i, req, req.generated)
                continue
            if req.past_deadline():
                resilience.inc("deadline_expired")
                self._fail_slot(i, req, req.deadline_error())
                continue
            # The `sched:slot_stall` seam: the lane produced nothing useful.
            ne = n_emit[i] if spec else width
            row = [] if req.stall_inject else flat[i * width: i * width + ne]
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
            appended = len(req.generated) - before
            round_emitted += appended
            if spec:
                spec_emitted["constrained" if req.constraint is not None
                             else "unconstrained"] += ne
                spec_emitted["sampled" if req.temperature > 0.0 else "greedy"] += ne
                if ne:
                    self._count_spec(req, ne, appended)
            if req.trace is not None:
                # One span a harvested round for a traced request.
                attrs = {"emitted": appended, "rid": req.rid}
                if req.constraint is not None:
                    attrs["grammar_mask"] = True
                if spec:
                    attrs["spec_accepted"] = ne
                req.trace.add_span("sched.round", t_issue, t_harvest, **attrs)
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
        self._tokens_emitted_total += round_emitted
        if self._paged:
            # Retirements above freed pages: extend every live slot's pages
            # past its committed position + overshoot before the next round
            # can write there (a failed top-up preempts).
            self._topup_pages()
        self.heartbeat.round_done()
        self._record_round(issue_reqs, occupancy, round_emitted,
                           spec_emitted if spec else None, t_issue, t_harvest,
                           self._device_span(*marks), mixed_meta)
        if self._profile_active is not None:
            self._profile_round_done()

    def _device_mark(self):
        """A mark in the device's stream of work: a timed CUDA event
        recorded on the current stream, or on the CPU, where ops run as
        they are issued, the host clock."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def _device_span(start, end) -> float:
        """Seconds the device took from `start` to `end` (`_device_mark`s
        that have completed: a harvest has synchronised past them)."""
        if isinstance(start, float):
            return end - start
        return start.elapsed_time(end) / 1e3

    def _record_round(self, issue_reqs, occupancy: int, emitted: int,
                      spec_emitted: Optional[Dict[str, int]], t_issue: float,
                      t_harvest: float, span_s: float,
                      mixed_meta: Optional[Dict[str, int]]) -> None:
        """The round's flight record: occupancy at issue, queue depth,
        admission and retirement churn since the last record, tokens
        emitted (by class under speculation), the prefix-reuse rows of the
        admissions since the last record, the round's wall and cadence, and
        its ledger columns. The wall is the round's span on the device
        (`span_s`: from its first op to its last, CUDA events on the card):
        rounds run one after another on the scheduler's stream, so their
        walls do not overlap, and neither the harvest lag nor a prefill
        forward between two rounds counts toward one. `rows` is every slot
        (the device computes parked rows too) and `perf_ctx` the active
        rows' mean committed context; the ledger reads the rounded wall the
        record carries. Speculative
        rounds are the verify phase, their draft gather ledgered apart; a
        ragged mixed round prices its decode rows and its prompt chunks
        over one wall. Prefill forwards banked since the last harvest
        attribute over the inter-harvest interval."""
        ewma = self.heartbeat.expected_round_s()
        round_wall = round(span_s, 6)
        rec = {
            "round": self.heartbeat.rounds,
            "occupancy": occupancy,
            "queued": self._queue.qsize(),
            "admitted": self._round_admitted,
            "retired": self._round_retired,
            "emitted": emitted,
            "round_wall_s": round_wall,
            "cadence_s": round(ewma, 6) if ewma is not None else None,
        }
        if spec_emitted is not None:
            rec["spec_emitted"] = spec_emitted
        if self._round_prefix:
            rec["prefix_reuse"] = self._round_prefix
            self._round_prefix = []
        phase = "decode" if spec_emitted is None else "verify"
        tokens = self.decode_chunk if spec_emitted is None else self._spec_draft + 1
        ctx_sum = sum(len(r.ids) + len(r.generated) for r in issue_reqs if r is not None)
        perf_ctx = max(1, ctx_sum // max(1, occupancy))
        if mixed_meta is not None:
            phase = "mixed"
            att = self.perf.observe_mixed(
                rows=self.num_slots, dec_tokens=tokens, dec_ctx=perf_ctx,
                pre_rows=mixed_meta["pre_rows"], pre_tokens=mixed_meta["pre_tokens"],
                pre_ctx=mixed_meta["pre_ctx"], wall_s=round_wall)
            rec.update(mixed_meta)
        else:
            att = self.perf.observe(phase, rows=self.num_slots, tokens=tokens,
                                    ctx=perf_ctx, wall_s=round_wall)
        rec["phase"] = phase
        rec["perf_ctx"] = perf_ctx
        rec["mfu"] = att["mfu"]
        rec["hbm_util"] = att["hbm_util"]
        rec["bound"] = att["bound"]
        if spec_emitted is not None:
            self.perf.observe("draft", rows=self.num_slots, tokens=self._spec_draft,
                              ctx=int(self._hist.shape[1]), wall_s=round_wall)
        interval = round(t_harvest - (self._last_harvest_t
                                      if self._last_harvest_t is not None
                                      else t_issue), 6)
        self._last_harvest_t = t_harvest
        pre = self.perf.flush_prefill(interval)
        if pre is not None:
            rec["prefill_mfu"] = pre["mfu"]
            rec["prefill_hbm_util"] = pre["hbm_util"]
        if self._paged:
            # A leaked page shows as kv_pages that never drains while
            # occupancy does; kv_pressure is the kv:pressure seam's reserve.
            rec["kv_pages"] = self._page_alloc.pages_in_use
            rec["kv_pages_free"] = self._page_alloc.pages_free
            rec["kv_pressure"] = self._page_alloc.withheld
        if self._mig_pages:
            # Pages imported since the last record and their waits for a
            # slot, only on rounds after an import: a mixed replica's
            # records keep their columns.
            rec["pages_migrated"] = self._mig_pages
            rec["handoff_wait_s"] = round(self._mig_wait, 6)
            self._mig_pages = 0
            self._mig_wait = 0.0
        self.flight.record(**rec)
        self._round_admitted = []
        self._round_retired = []

    def _count_spec(self, req: _Request, emitted: int, delivered: int) -> None:
        """One slot's harvested verify round in `speculation_stats`, the
        counters moving together under the submit lock."""
        with self._submit_lock:
            self._spec_rounds += 1
            self._spec_tokens += emitted
            self._spec_delivered += delivered
            if req.constraint is not None:
                self._spec_rounds_con += 1
                self._spec_tokens_con += emitted
            if req.temperature > 0.0:
                self._spec_rounds_samp += 1
                self._spec_tokens_samp += emitted

    def _harvest_firsts(self) -> None:
        """Drain path: ready slots whose first token never rode a round."""
        if not self._first_pending:
            return
        firsts, self._first_pending = self._first_pending, []
        vals = torch.cat([tok.reshape(1) for _, _, tok, _ in firsts]).tolist()
        for (slot, req, _, fep), v in zip(firsts, vals):
            self._append_first(slot, req, v, fep)

    # ------------------------------------------- prefill -> decode handoff

    def _pack_handoffs(self) -> None:
        """A prefill replica's terminal step for the prompts its last chunk
        completed: one transfer brings their first tokens (outside the
        dispatch lock), `_append_first` commits and streams each as a
        harvest would, then each request still live is exported for the
        pool (`on_handoff` wired) or decodes here: with no consumer, or
        with `_pump_depth` blobs already packed (backpressure)."""
        if not self._handoff_pending:
            return
        pending, self._handoff_pending = self._handoff_pending, []
        vals = torch.cat([tok.reshape(1) for _, _, tok, _ in pending]).tolist()
        emitted = packed = 0
        for (slot, req, _, epoch), first in zip(pending, vals):
            emitted += self._append_first(slot, req, first, epoch)
            if req is not self._slot_req[slot]:
                continue  # retired: a stop id, its budget, a cancel or its deadline
            # Chaos seam: `sched:handoff` kills the loop here, the first
            # token committed and maybe streamed, the blob never shipped;
            # the supervisor re-prefills the request on a sibling with the
            # delivered token suppressed.
            FAULTS.check("sched:handoff")
            if self.on_handoff is None:
                self._arm_inplace(slot, req)
                continue
            if self._pump_depth and len(self._handoff) >= self._pump_depth:
                self._ho_backpressure += 1
                self._arm_inplace(slot, req)
                continue
            self._export_handoff(slot, req)
            packed += 1
        self._tokens_emitted_total += emitted
        if packed:
            try:
                self.on_handoff()
            except Exception:  # noqa: BLE001 — a broken pump must not strand work
                _log.exception("on_handoff pump failed; decoding in place")
                # What the pump left behind comes back here: re-admission
                # restores the blob and decodes it on this replica.
                for req in self.extract_handoffs():
                    self.requeue(req)
        self._record_prefill_round(emitted, packed)

    def _export_handoff(self, slot: int, req: _Request) -> None:
        """Export one request's committed pages (prompt + first token,
        whose K/V the importer's first decode step writes, as a resume
        rewrites its last committed token) into a host blob, stage its
        resume state (`resume_pref`, `rng_count`) so the importer arms a
        slot as a mixed replica's final chunk would, release the slot and
        park the request in `_handoff`."""
        t0 = time.perf_counter()
        committed = len(req.ids) + len(req.generated)
        npg = min(pages_for_tokens(committed, self._page_size),
                  len(self._slot_pages[slot]))
        # The gather and the copy's issue take the dispatch lock; the wait
        # for the copy does not, so a sibling on the card issues meanwhile.
        with self._dispatch_lock:
            finish = self._export_start(self._slot_pages[slot][:npg])
        blob = finish()
        wall = time.perf_counter() - t0
        nbytes = handoff_bytes(blob)
        req.spilled = blob
        req.resume_pref = len(req.generated)
        req.rng_count = 1  # the prefill sample used index 0 of its stream
        req.handoff = {"t_pack": time.perf_counter(), "export_s": round(wall, 6),
                       "pages": int(npg), "bytes": nbytes, "src": self.flight.replica}
        self._ho_exports += 1
        self._ho_pages_out += int(npg)
        self._ho_bytes_out += nbytes
        if req.submitted_at > 0.0:
            pstok = (time.perf_counter() - req.submitted_at) / max(1, len(req.ids))
            prev = self._pref_stok_ewma
            self._pref_stok_ewma = pstok if prev is None else 0.2 * pstok + 0.8 * prev
        # The request leaves this replica's backlog (the importer's requeue
        # adds it there) and reads as retired in its flight records.
        with self._submit_lock:
            self._pending_new_tokens = max(0, self._pending_new_tokens - req.max_new)
            self._pending_prompt_tokens = max(0, self._pending_prompt_tokens
                                              - len(req.ids))
        self._round_retired.append(req.rid)
        if req.trace is not None:
            try:
                req.trace.event("sched.handoff_export", rid=req.rid, pages=int(npg),
                                bytes=nbytes)
            except Exception:  # noqa: BLE001 — tracing must never kill the loop
                req.trace = None
        self.flight.event("handoff_export", slot=slot, rid=req.rid, pages=int(npg),
                          bytes=nbytes, export_s=round(wall, 6))
        self._release_slot(slot)
        self._handoff.append(req)

    def _arm_inplace(self, slot: int, req: _Request) -> None:
        """Decode a prefill replica's request in place (no consumer, the
        pump full or failed): the resume arms the slot as a mixed replica's
        final chunk does (the committed first token at its own position,
        stream index 1, the grammar replayed), so the tokens are the same."""
        self._ho_inplace += 1
        req.resume_pref = len(req.generated)
        req.rng_count = 1
        req.prefilled = len(req.full_ids)
        self.flight.event("handoff_inplace", slot=slot, rid=req.rid)
        self._resume_ready(slot, req, mode="inplace")

    def _record_prefill_round(self, emitted: int, handoffs: int) -> None:
        """A prefill replica's flight record: it harvests no decode round,
        so each pack pass that concluded a request (a handoff, an in-place
        arm or a retirement) records one, ticks the heartbeat and
        attributes the banked prefill work over the interval since the
        previous pass (none on the first: no origin)."""
        if not (emitted or handoffs or self._round_retired or self._round_admitted):
            return
        self.heartbeat.round_done()
        now = time.perf_counter()
        prev, self._last_pack_t = self._last_pack_t, now
        interval = round(now - prev, 6) if prev is not None else 0.0
        ewma = self.heartbeat.expected_round_s()
        rec = {
            "round": self.heartbeat.rounds,
            "occupancy": sum(1 for r in self._slot_req if r is not None),
            "queued": self._queue.qsize(),
            "admitted": self._round_admitted,
            "retired": self._round_retired,
            "emitted": emitted,
            "handoffs": handoffs,
            "round_wall_s": interval,
            "cadence_s": round(ewma, 6) if ewma is not None else None,
            "phase": "prefill",
        }
        if prev is not None:
            pre = self.perf.flush_prefill(interval)
            if pre is not None:
                rec["prefill_mfu"] = pre["mfu"]
                rec["prefill_hbm_util"] = pre["hbm_util"]
        rec["kv_pages"] = self._page_alloc.pages_in_use
        rec["kv_pages_free"] = self._page_alloc.pages_free
        rec["kv_pressure"] = self._page_alloc.withheld
        self.flight.record(**rec)
        self._round_admitted = []
        self._round_retired = []

    @property
    def handoff_stats(self) -> Optional[Dict[str, object]]:
        """Handoff counters (the lsot_handoff_* families and /metrics'
        `serving.handoff`): exports, imports, in-place decodes, pages and
        bytes each way, the summed wait for a decode slot, the packed queue
        and the backpressure count. None for a mixed replica that never
        touched a handoff."""
        if self.phase_role == "mixed" and not (
                self._ho_exports or self._ho_imports or self._ho_inplace):
            return None
        return {
            "replica": self.flight.replica,
            "phase_role": self.phase_role,
            "exports": self._ho_exports,
            "imports": self._ho_imports,
            "inplace_fallbacks": self._ho_inplace,
            "pages_out": self._ho_pages_out,
            "pages_in": self._ho_pages_in,
            "bytes_out": self._ho_bytes_out,
            "bytes_in": self._ho_bytes_in,
            "wait_s_sum": round(self._ho_wait_sum, 6),
            "wait_count": self._ho_wait_count,
            "queued_handoffs": len(self._handoff),
            "backpressure": self._ho_backpressure,
        }

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
                if self._stream is not None:
                    # cuBLAS keeps a handle and workspace per thread, made at
                    # the thread's first matmul: made here, before the loop,
                    # so that a warmed scheduler's first request (`warmup()`
                    # runs on the caller's thread) pays none of it.
                    x = torch.zeros(1, 64, dtype=self._dtype, device=self.device)
                    x @ x.t()
                self._loop()
            self._close(RuntimeError("scheduler shut down mid-request"))
        except BaseException as exc:  # noqa: BLE001 — a dead loop must not hang clients
            wrapped = SchedulerCrashed.from_exception(exc)
            self._crash = wrapped
            # The black box shows the crash beside the rounds before it.
            self.flight.event("crash", error=str(exc)[:200],
                              error_type=type(exc).__name__)
            self._close(wrapped)
            raise

    def _close(self, exc: BaseException) -> None:
        """Fail every in-flight and queued request; reject future submits."""
        self._abort_profile(f"scheduler closed: {type(exc).__name__}")
        with self._submit_lock:
            self._closed = True
            self._pending_new_tokens = 0
            ready, self._ready = self._ready, []
        for req in ready:  # staged in the WFQ pool when the loop died
            req.future.set_exception(exc)
        self._prefill_q.clear()
        self._pending.clear()
        self._first_pending = []
        self._handoff_pending = []  # still slot-held: the slot sweep fails them
        for req in self._handoff:
            # Packed when the loop died: the blob dies with this replica, and
            # the typed failure lets the supervisor re-prefill the request.
            req.future.set_exception(exc)
        self._handoff.clear()
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
        expired ones fail typed, in deadline order (under QoS the waiters
        are in service order, not deadline order)."""
        if not self._page_wait:
            return
        keep: "deque[_Request]" = deque()
        expired: List[_Request] = []
        for req in self._page_wait:
            if req.cancelled:
                self._observe_terminal(req)
                req.future.set_result(req.generated)
            elif req.past_deadline():
                expired.append(req)
            else:
                keep.append(req)
        self._page_wait = keep
        expired.sort(key=lambda r: r.deadline.expires_at)
        for req in expired:
            resilience.inc("deadline_expired")
            self._observe_terminal(req, error="DeadlineExceeded")
            req.future.set_exception(req.deadline_error())

    def _busy_now(self) -> bool:
        """Work anywhere in the pipeline: the busy flag each iteration
        stamps into the heartbeat."""
        return bool(self._prefill_q or self._pending or self._page_wait
                    or self._constraint_wait or self._ready
                    or self._handoff or self._handoff_pending
                    or any(r is not None for r in self._slot_req)
                    or not self._queue.empty())

    def flight_stats(self) -> Dict[str, object]:
        """The round ring's occupancy for /metrics."""
        return self.flight.stats()

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
            # requests re-admit ahead of the queue (in arrival order, or
            # with QoS on victims first, then by virtual finish time), and
            # the queue admits FIFO, or with QoS on in WFQ order.
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
                        req = self._page_wait_pop()
                    elif self._qos:
                        # WFQ admission: stage the queue in the ready pool,
                        # serve the smallest virtual finish time.
                        self._drain_ready()
                        req = self._ready_pop()
                        if req is None:
                            break
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
            if self._ragged and self._prefill_q:
                if self._profile_arm is not None:
                    self._maybe_start_profile()
                issued = self._issue_mixed()
                if issued:
                    if len(self._pending) > self._harvest_lag:
                        self._harvest_round()
                    continue
            # Fair interleave: at most one prompt chunk per decode round.
            if self._prefill_q:
                self._prefill_step()
            if self._handoff_pending:
                # A prefill replica's completed prompts: commit their first
                # tokens, pack their blobs, wake the pool's pump.
                self._pack_handoffs()
            if any(r is not None and r.ready for r in self._slot_req):
                if self._profile_arm is not None:
                    # An armed /debug/profile capture starts on this
                    # thread, around the next N rounds.
                    self._maybe_start_profile()
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
                        or self._ready or any(r is not None for r in self._slot_req):
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


@dataclasses.dataclass
class _ReplicaState:
    """One replica's supervision state inside a `SchedulerPool`.

    `state`: ready -> (crash or stall) -> restarting -> ready | degraded |
    dead, and the runtime states draining / drained (restartable) / removed
    (out of the fleet for good). Placement considers ready and degraded
    replicas; `degraded` is a restarted replica not yet proven by a clean
    completion. `model_id` is captured at wiring time, so placement can
    filter on it while the replica is mid-restart."""

    label: str
    state: str = "ready"
    restarts: int = 0
    stalls: int = 0
    placements: int = 0
    restart_eta: Optional[float] = None
    last_crash: Optional[str] = None
    model_id: str = ""

    #: States a replica takes new work in.
    PLACEABLE = ("ready", "degraded")


class SchedulerPool:
    """A supervised fleet of local scheduler replicas behind one `submit()`.

    - **Placement.** A request naming a `model_id` considers only the
      replicas carrying that checkpoint (`UnknownModel` when none does).
      Among them: replicas holding the request's chain-prefix digests
      first (`affinity_routing`, `LSOT_POOL_AFFINITY`, default on), then
      replicas without withheld pages or a burning SLO, then the least
      weighted backlog (`backlog_score()` / weight, `weights` or
      `LSOT_REPLICA_WEIGHTS`), then the index. `router="round_robin"` is
      the blind rotation. A replica whose raw backlog would blow the
      request's deadline is skipped. A request is shed typed only when no
      replica can serve it: `Overloaded` with the fleet's minimum
      Retry-After, `DeadlineExceeded` when every backlog exceeds the
      deadline, `Overloaded` while the fleet (or the model's replicas) is
      restarting or draining, `SchedulerCrashed` when it is gone.
    - **Per-replica lifecycle.** With a `factory` (index -> fresh
      replica), a crashed or stalled replica is rebuilt alone, with
      bounded backoff under its own restart budget, while its siblings
      serve; budget exhausted marks only it dead. `on_replica_restart` /
      `on_replica_drained` are the supervisor's replay seams.
    - **Runtime drain, remove, add, retire.** `drain_replica` re-places its
      queued requests on same-model siblings, gives in-flight work a
      bounded grace and shuts it down; `add_replica` joins a live fleet;
      `retire_replica` drains and removes a replica `add_replica` added.
    - **Observable.** Placements and lifecycle events go to a pool flight
      recorder merged into `flight_snapshot()`; per-replica loads, health
      and stalls, per-model aggregation (`model_stats`), the summed page,
      prefix and perf views.

    - **Phase roles.** Fresh prompts go to prefill and mixed replicas
      while one can take them (decode replicas are the deadline spillover,
      and serve alone if they are all that is left). A prefill replica's
      packed handoffs are placed by `_place_handoff` from its own worker
      thread: a decode replica first (the pressure penalty, then the
      lowest decode-phase HBM utilization, then the backlog), then a mixed
      one, then the source itself, which decodes in place.

    - **Remote replicas.** A replica may be a transport (serve/remote.py):
      a `SocketTransport` to a worker process, or a `LoopbackTransport`.
      The pool pings each one every `lease_s` (`LSOT_LEASE_S`);
      `lease_misses` (`LSOT_LEASE_MISSES`) missed beats in a row expire the
      lease: the transport is declared unreachable and the replica's
      targeted restart (with the supervisor's journal replay) follows. A
      remote prefill worker pushes its handoffs; `_pump_handoffs` drains
      them from the transport's buffer and closes the push-to-placement
      latency ledger of `fleet_stats`. A remote joiner whose page geometry
      or model no local sibling shares is marked dead at the join."""

    #: Callers forward a model_id only to schedulers that route on it, and
    #: tenant/qos only to those that set `supports_qos`.
    supports_model_routing = True
    supports_qos = True

    @property
    def supports_replica_restart(self) -> bool:
        """The supervisor keys targeted restart and replay on this."""
        return self._factory is not None

    def __init__(
        self,
        schedulers: Sequence[ContinuousBatchingScheduler],
        factory: Optional[Callable] = None,
        max_restarts: int = 5,
        restart_policy=None,
        rng=None,
        sleep: Callable[[float], None] = time.sleep,
        router: str = "least_loaded",
        replica_join_s: float = 1.0,
        affinity_routing: Optional[bool] = None,
        weights: Optional[Sequence[float]] = None,
        model_routing: Optional[bool] = None,
        lease_s: Optional[float] = None,
        lease_misses: Optional[int] = None,
    ):
        if not schedulers:
            raise ValueError("SchedulerPool needs at least one scheduler")
        if router not in ("least_loaded", "round_robin"):
            raise ValueError(f"router must be 'least_loaded' or 'round_robin', "
                             f"got {router!r}")
        from .resilience import RetryPolicy

        self.schedulers = list(schedulers)
        self._rr = 0
        self._lock = threading.Lock()
        self._closed = False
        self.router = router
        # `factory(i)` (or `factory()` when it takes no required argument)
        # builds replacement replica i; None: a crashed replica is dead.
        self._factory = factory
        self._factory_takes_index = False
        if factory is not None:
            try:
                self._factory_takes_index = any(
                    p.default is inspect.Parameter.empty
                    and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                    for p in inspect.signature(factory).parameters.values())
            except (TypeError, ValueError):
                self._factory_takes_index = False
        self.max_restarts = int(max_restarts)
        self._restart_policy = restart_policy or RetryPolicy(
            max_attempts=self.max_restarts + 1, base_delay_s=0.1, max_delay_s=5.0)
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep
        # Bounded join for a wedged replica's teardown (the abandoned
        # daemon exits when it unwedges).
        self._replica_join_s = float(replica_join_s)
        self.on_replica_restart: Optional[Callable[[str], None]] = None
        self.on_replica_drained: Optional[Callable[[str], None]] = None
        # "r{i}" labels: each replica's flight records, the Prometheus
        # replica label and the supervisor's replay attribution.
        self._states: List[_ReplicaState] = []
        for i, s in enumerate(self.schedulers):
            label = f"r{i}"
            fl = getattr(s, "flight", None)
            if fl is not None:
                fl.replica = label
            self._states.append(_ReplicaState(label=label, model_id=self._model_id(s)))
            self._wire_handoff(i, s)
        # Placement decisions and replica lifecycle events.
        self._pool_flight = FlightRecorder(capacity=256, replica="pool")
        if affinity_routing is None:
            affinity_routing = os.environ.get("LSOT_POOL_AFFINITY", "1").strip().lower() \
                not in ("0", "false", "no", "off")
        self._affinity = bool(affinity_routing)
        self._aff_checked = 0
        self._aff_hits = 0
        # Model routing is inert until a request names a model;
        # LSOT_POOL_MODELS=0 makes named requests model-blind too.
        if model_routing is None:
            model_routing = os.environ.get("LSOT_POOL_MODELS", "1").strip().lower() \
                not in ("0", "false", "no", "off")
        self._model_routing = bool(model_routing)
        # Per-model (wall, tokens_total) at the last `model_stats` read.
        self._model_rate: Dict[str, Tuple[float, int]] = {}
        if weights is None:
            self._weights = parse_replica_weights(
                os.environ.get("LSOT_REPLICA_WEIGHTS", ""), len(self.schedulers))
        else:
            self._weights = normalize_replica_weights(list(weights), len(self.schedulers))
        # Live restart threads, joined at shutdown.
        self._restart_threads: List[threading.Thread] = []
        # Membership counters (`fleet_stats`) and the indices add_replica
        # joined with elastic=True (the only ones retire_replica takes).
        self._fleet_joins = 0
        self._fleet_retires = 0
        self._fleet_drain_s_sum = 0.0
        self._fleet_drain_count = 0
        self._elastic: set = set()
        # The remote-replica lease monitor, started at start() when a
        # replica exposes the lease surface. None reads LSOT_LEASE_S /
        # LSOT_LEASE_MISSES; lease_s <= 0 disables it.
        self._lease_s = (float(os.environ.get("LSOT_LEASE_S", "2.0"))
                         if lease_s is None else float(lease_s))
        self._lease_misses = (int(os.environ.get("LSOT_LEASE_MISSES", "3"))
                              if lease_misses is None else int(lease_misses))
        self._lease_stop = threading.Event()
        self._lease_thread: Optional[threading.Thread] = None
        # Pushed handoffs: the receive-to-placement latencies behind
        # fleet_stats' push columns, and the resolver a pushed constrained
        # handoff needs (the wire carries the spec; SchedulerBackend or the
        # supervisor installs it).
        self.constraint_resolver: Optional[Callable] = None
        self._push_lat: deque = deque(maxlen=4096)
        # The join handshake: a remote replica whose page geometry or model
        # cannot co-serve this fleet is marked dead before placement sees it.
        for i, s in enumerate(self.schedulers):
            self._validate_join(i, s)

    # Admission arithmetic, so SchedulerBackend wraps a pool as it wraps a
    # scheduler (replicas of one model share cfg, window and chunking; a
    # multi-model pool's backends clamp against the first replica's window
    # and submit() re-validates on the chosen replica).
    @property
    def cfg(self):
        return self.schedulers[0].cfg

    @property
    def max_seq(self) -> int:
        return self.schedulers[0].max_seq

    @property
    def decode_chunk(self) -> int:
        return self.schedulers[0].decode_chunk

    @property
    def stop_ids(self):
        return self.schedulers[0].stop_ids

    @property
    def _spec_draft(self) -> int:
        return self.schedulers[0]._spec_draft

    @property
    def prompt_bucket(self) -> int:
        return self.schedulers[0].prompt_bucket

    @property
    def _harvest_lag(self) -> int:
        return self.schedulers[0]._harvest_lag

    @property
    def overshoot(self) -> int:
        return self.schedulers[0].overshoot

    def retry_after_hint(self) -> float:
        """The soonest replica's hint: min over placeable replicas'
        estimates, a restarting replica contributing its backoff remaining
        instead of its stale estimate; draining, dead and removed replicas
        contribute nothing. Clamped to [1, 60] s."""
        now = time.monotonic()
        hints: List[float] = []
        for st, s in self._replica_items():
            if st.state in _ReplicaState.PLACEABLE:
                if getattr(s, "_crash", None) is not None:
                    continue
                hint = getattr(s, "retry_after_hint", None)
                try:
                    hints.append(hint() if callable(hint) else 1.0)
                except Exception:  # noqa: BLE001 — a dying replica mid-read
                    hints.append(1.0)
            elif st.state == "restarting":
                eta = st.restart_eta
                rem = (eta - now) if eta is not None else 1.0
                hints.append(float(min(60.0, max(1.0, rem))))
        if not hints:
            return 1.0
        return float(min(60.0, max(1.0, min(hints))))

    def warmup(self, prompt_len: Optional[int] = None) -> None:
        """Warm every replica (`ContinuousBatchingScheduler.warmup`); a
        remote replica's transport warms in its own process."""
        for s in self.schedulers:
            warm = getattr(s, "warmup", None)
            if callable(warm):
                warm(prompt_len)

    @property
    def heartbeat(self) -> Optional[CombinedHeartbeat]:
        """The replicas' heartbeats as one monitor view, labeled: one
        wedged replica reads stale while its siblings stamp, and
        `verdicts()` names it (the targeted-restart feed)."""
        hbs, labels = [], []
        for st, s in zip(self._states, self.schedulers):
            hb = getattr(s, "heartbeat", None)
            if hb is not None:
                hbs.append(hb)
                labels.append(st.label)
        if not hbs:
            return None
        return CombinedHeartbeat(hbs, labels=labels)

    @property
    def watchdog_stats(self) -> Dict[str, object]:
        hb = self.heartbeat
        return {
            "heartbeat": hb.snapshot() if hb is not None else None,
            "slots_retired_stalled": sum(getattr(s, "_slot_stalls", 0)
                                         for s in self.schedulers),
        }

    @property
    def page_stats(self) -> Optional[Dict[str, int]]:
        """Summed page-pool stats across paged replicas (each owns a
        pool); sizes, knobs and thresholds are the first replica's (the
        per-replica values are in replica_loads)."""
        per = [s.page_stats for s in self.schedulers if getattr(s, "page_stats", None)]
        if not per:
            return None
        out: Dict[str, int] = {}
        for st in per:
            for k, v in st.items():
                if isinstance(v, str):
                    continue
                out[k] = out.get(k, 0) + int(v)
        for k in ("page_size", "overcommit", "spill", "kv_quant", "page_bytes",
                  "watermark_low_pages", "watermark_high_pages"):
            if k in per[0]:
                out[k] = per[0][k]
        return out

    @property
    def perf_stats(self) -> Optional[Dict[str, object]]:
        """Per-replica roofline ledgers, labeled (the lsot_mfu /
        lsot_hbm_util gauges render phase x replica from this list)."""
        per = []
        for st, s in self._replica_items():
            p = getattr(s, "perf_stats", None)
            if isinstance(p, dict):
                rec = dict(p)
                rec["replica"] = st.label
                per.append(rec)
        return {"replicas": per} if per else None

    def profile_rounds(self, rounds: Optional[int] = None,
                       out_dir: Optional[str] = None,
                       replica: Optional[str] = None) -> Dict[str, object]:
        """Arm a device capture on one replica (the named one, else the
        first placeable); utils/traceprof allows one capture at a time."""
        for st, s in self._replica_items():
            if replica is not None and st.label != replica:
                continue
            fn = getattr(s, "profile_rounds", None)
            if callable(fn) and (replica is not None
                                 or st.state in _ReplicaState.PLACEABLE):
                return fn(rounds, out_dir)
        raise ValueError(
            f"no {'replica ' + replica if replica else 'placeable replica'}"
            f" exposes device profiling")

    def profile_status(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for st, s in self._replica_items():
            fn = getattr(s, "profile_status", None)
            if callable(fn):
                out[st.label] = fn()
        return out

    @property
    def flight(self):
        """The first replica's recorder; flight_snapshot() is the merged
        pool view."""
        return self.schedulers[0].flight

    def flight_snapshot(self, last: Optional[int] = None) -> List[Dict]:
        """Every replica's records and the pool's own (placements, replica
        lifecycle, under "pool") merged in time order."""
        return merge_snapshots([self._pool_flight, *self.schedulers], last)

    def flight_stats(self) -> Dict[str, Dict]:
        """Each replica's ring occupancy, by label."""
        out: Dict[str, Dict] = {}
        for i, s in enumerate(self.schedulers):
            fl = getattr(s, "flight", None)
            if fl is not None:
                out[getattr(fl, "replica", f"r{i}")] = fl.stats()
        return out

    def replica_loads(self) -> List[Dict[str, object]]:
        """Per-replica load and lifecycle (queue depth, live slots, round
        cadence, state, restart/stall/placement counters, the placement
        score, page pressure, prefix residency, decode roofline, SLO burn,
        the model it holds): the router's feed, exported per replica (the
        numeric fields become Prometheus gauges)."""
        out = []
        for st, s in self._replica_items():
            hb = getattr(s, "heartbeat", None)
            hb_snap = hb.snapshot() if hb is not None else {}
            secs, toks = self._score(s)
            q = getattr(s, "_queue", None)
            slot_req = getattr(s, "_slot_req", None) or []
            rec: Dict[str, object] = {
                "replica": st.label,
                "state": st.state,
                "num_slots": getattr(s, "num_slots", 0),
                "expected_round_s": hb_snap.get("expected_round_s"),
                "crashed": getattr(s, "_crash", None) is not None,
                "restarts": st.restarts,
                "stalls": st.stalls,
                "placements": st.placements,
                "backlog_s": round(secs, 4),
                "pending_new_tokens": toks,
            }
            if q is not None:
                rec["queued"] = q.qsize()
            if slot_req:
                rec["active_slots"] = sum(1 for r in slot_req if r is not None)
            hint = getattr(s, "retry_after_hint", None)
            if callable(hint) and st.state in _ReplicaState.PLACEABLE:
                try:
                    rec["retry_after_s"] = round(hint(), 3)
                except Exception:  # noqa: BLE001 — a dying replica mid-read
                    pass
            pstats = getattr(s, "page_stats", None)
            if pstats:
                rec["kv_pages_free"] = pstats["pages_free"]
                rec["kv_pages_withheld"] = pstats["pages_withheld"]
                rec["kv_preemptions"] = pstats["preemptions"]
                rec["kv_evictions"] = pstats["evictions"]
                rec["kv_spilled_pages"] = pstats["spilled_pages"]
                rec["kv_watermark_low_pages"] = pstats["watermark_low_pages"]
                rec["kv_watermark_high_pages"] = pstats["watermark_high_pages"]
            ptel = getattr(s, "prefix_telemetry", None)
            if isinstance(ptel, dict):
                rec["prefix_hit_rate"] = ptel.get("hit_rate_ewma", 0.0)
                rec["prefix_resident_entries"] = ptel.get("resident_entries", 0)
            digs = getattr(s, "resident_digests", None)
            if callable(digs):
                try:
                    rec["resident_digests"] = digs()
                except Exception:  # noqa: BLE001 — a dying replica mid-read
                    pass
            rec["phase_role"] = self._phase_role(s)
            rec["model_id"] = st.model_id or self._model_id(s)
            ho = getattr(s, "handoff_stats", None)
            if isinstance(ho, dict):
                rec["handoff_exports"] = ho["exports"]
                rec["handoff_imports"] = ho["imports"]
                rec["handoff_queued"] = ho["queued_handoffs"]
            perf = getattr(s, "perf_stats", None)
            if isinstance(perf, dict):
                dec = (perf.get("phases") or {}).get("decode")
                if dec:
                    rec["decode_mfu"] = dec.get("mfu")
                    rec["decode_hbm_util"] = dec.get("hbm_util")
            from ..utils import slo as _slo

            if _slo.ENGINE.enabled:
                rec["slo_burning"] = bool(_slo.ENGINE.replica_burning(st.label))
            # A remote replica has no in-process attributes: merge its
            # cached loads digest (refreshed by every ping and ack) under
            # what was read above.
            ld = getattr(s, "loads_digest", None)
            if callable(ld):
                try:
                    for k, v in ld().items():
                        rec.setdefault(k, v)
                except Exception:  # noqa: BLE001 — a dying replica mid-read
                    pass
            rec.setdefault("queued", 0)
            rec.setdefault("active_slots", 0)
            # Which wire the replica is behind and how it behaves.
            ts = getattr(s, "transport_stats", None)
            if callable(ts):
                try:
                    rec["transport"] = self._transport_summary(ts())
                except Exception:  # noqa: BLE001 — a dying replica mid-read
                    pass
            idx = next((j for j, x in enumerate(self._states) if x is st), -1)
            if 0 <= idx < len(self._weights) and self._weights[idx] != 1.0:
                rec["weight"] = self._weights[idx]
            out.append(rec)
        return out

    @staticmethod
    def _transport_summary(t: Dict[str, object]) -> Dict[str, object]:
        """One transport's stats flattened into the per-replica block of
        replica_loads, replica_health and /healthz."""
        total = {"rpcs": 0, "retries": 0, "timeouts": 0, "errors": 0}
        for rec in (t.get("endpoints") or {}).values():
            for k in total:
                total[k] += int(rec.get(k, 0))
        return {
            "kind": t.get("kind", "transport"),
            "unreachable": bool(t.get("unreachable", False)),
            "lease_misses": int(t.get("lease_misses", 0)),
            "lease_expiries": int(t.get("lease_expiries", 0)),
            "reconnects": int(t.get("reconnects", 0)),
            **total,
        }

    @property
    def transport_stats(self) -> Optional[Dict[str, object]]:
        """Each transport replica's counters, labeled (`serving.transport`,
        the lsot_transport_* families); None when no replica is behind a
        transport."""
        per = []
        for st, s in self._replica_items():
            fn = getattr(s, "transport_stats", None)
            if not callable(fn):
                continue
            try:
                rec = dict(fn())
            except Exception:  # noqa: BLE001 — a dying replica mid-read
                continue
            rec["replica"] = st.label
            per.append(rec)
        return {"replicas": per} if per else None

    def start(self) -> "SchedulerPool":
        with self._lock:
            self._closed = False
        for st, s in zip(self._states, self.schedulers):
            if st.state != "removed":
                s.start()
        self._maybe_start_lease()
        return self

    # ------------------------------------------------ remote-replica lease

    @staticmethod
    def _leaseable(s) -> bool:
        return bool(getattr(s, "supports_lease", False)) and callable(
            getattr(s, "ping", None))

    def _maybe_start_lease(self) -> None:
        """Start the lease monitor if a replica is a transport; local
        fleets have the watchdog's heartbeat and pay nothing here."""
        if self._lease_s <= 0 or self._lease_thread is not None:
            return
        if not any(self._leaseable(s) for s in self.schedulers):
            return
        self._lease_stop = threading.Event()
        self._lease_thread = threading.Thread(target=self._lease_loop, daemon=True,
                                              name="lsot-pool-lease")
        self._lease_thread.start()

    def _lease_loop(self) -> None:
        """Ping each placeable transport replica every `lease_s`;
        `lease_misses` failures in a row expire its lease: the transport is
        marked unreachable (pending futures fail typed, streams gate shut)
        and `_note_replica_crash` starts its targeted restart, whose
        `on_replica_restart` re-places the journaled work on siblings."""
        while not self._lease_stop.wait(self._lease_s):
            with self._lock:
                if self._closed:
                    return
                items = [(i, st, self.schedulers[i])
                         for i, st in enumerate(self._states)
                         if st.state in _ReplicaState.PLACEABLE]
            for i, st, s in items:
                if not self._leaseable(s):
                    continue
                try:
                    s.ping(timeout=self._lease_s)
                except Exception as e:  # noqa: BLE001 — any failure is a miss
                    miss_fn = getattr(s, "lease_miss", None)
                    misses = miss_fn() if callable(miss_fn) else self._lease_misses
                    self._pool_flight.event("lease_miss", replica=st.label,
                                            misses=misses)
                    if misses < self._lease_misses:
                        continue
                    exc = None
                    mark = getattr(s, "mark_unreachable", None)
                    if callable(mark):
                        exc = mark(f"lease expired after {misses} missed beat(s): {e}")
                    if exc is None:
                        from .remote import ReplicaUnreachable

                        exc = ReplicaUnreachable(
                            f"replica {st.label} lease expired after {misses} "
                            f"missed beat(s): {e}")
                    resilience.inc("lease_expiries")
                    self._pool_flight.event("lease_expired", replica=st.label,
                                            misses=misses)
                    _log.warning("replica %s lease expired (%d misses)", st.label,
                                 misses)
                    self._note_replica_crash(i, exc)
                else:
                    ok_fn = getattr(s, "lease_ok", None)
                    if callable(ok_fn):
                        ok_fn()

    def shutdown(self, timeout: Optional[float] = None) -> None:
        # _closed stops an in-flight restart from swapping a fresh replica
        # into a pool that is going away.
        with self._lock:
            self._closed = True
        self._lease_stop.set()
        for st, s in zip(self._states, self.schedulers):
            if s is None:
                continue
            try:
                s.shutdown(timeout=timeout)
            except Exception:  # noqa: BLE001 — one corpse must not wedge the rest
                _log.exception("replica %s shutdown failed", st.label)
        lease = self._lease_thread
        if lease is not None and lease is not threading.current_thread():
            lease.join(timeout)  # a beat ends within lease_s
        # Join the restart threads: a rebuild abandoned mid-way would leave
        # a daemon thread inside device work when the process exits.
        with self._lock:
            episodes = list(self._restart_threads)
        for t in episodes:
            if t is not threading.current_thread():
                t.join(timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    # ------------------------------------------------------------ placement

    @staticmethod
    def _score(s) -> Tuple[float, int]:
        """(backlog seconds, pending tokens): the replica's
        `backlog_score()`, or its queue depth for a replica without one."""
        fn = getattr(s, "backlog_score", None)
        if callable(fn):
            try:
                secs, toks = fn()
                return float(secs), int(toks)
            except Exception:  # noqa: BLE001 — a dying replica mid-read
                return 0.0, 0
        q = getattr(s, "_queue", None)
        return 0.0, (q.qsize() if q is not None else 0)

    def _wscore(self, i: int, s) -> Tuple[float, float]:
        """The ordering score: backlog / replica i's capacity weight (weight
        1.0 returns `_score` unchanged). Deadline feasibility and hints
        compare the raw seconds."""
        secs, toks = self._score(s)
        return self._wkey(i, secs, toks)

    def _wkey(self, i: int, secs: float, toks):
        w = self._weights[i] if i < len(self._weights) else 1.0
        if w == 1.0:
            return secs, toks
        return secs / w, toks / w

    def _affinity_scores(self, ids, tenant: str = "") -> Dict[str, int]:
        """Replica label -> how many of the request's chain-prefix digests
        it holds (salted with the tenant as admission salts its keys when
        tenant namespacing is on). Empty when the prompt is shorter than
        one block or nobody holds any."""
        block = int(getattr(self.schedulers[0], "_pblock", 0) or 0)
        if not block:
            return {}
        ns: Tuple[int, ...] = ()
        if tenant:
            from .qos import prefix_tenant_ns_enabled, qos_enabled, tenant_salt

            if qos_enabled() and prefix_tenant_ns_enabled():
                ns = tenant_salt(tenant)
        digests = prefix_chain_digests(ids, block, ns)
        if not digests:
            return {}
        scored = self.prefix_affinity(digests)
        if not scored:
            return {}
        with self._lock:
            self._aff_checked += 1
        return {str(r["replica"]): int(r["score"]) for r in scored}

    def routing_stats(self) -> Dict[str, object]:
        """The placement layer's counters: submits with a non-empty
        affinity lookup, and how many landed on a best-affinity holder."""
        with self._lock:
            return {
                "router": self.router,
                "affinity_routing": self._affinity,
                "model_routing": self._model_routing,
                "weights": list(self._weights),
                "placements": sum(st.placements for st in self._states),
                "affinity_checked": self._aff_checked,
                "affinity_hits": self._aff_hits,
            }

    def model_stats(self) -> Optional[Dict[str, object]]:
        """Per-model aggregation over the replicas carrying each model_id
        (queue depth, live slots, backlog, placements, accepted tokens and
        their rate between reads, KV pages held and in use): the
        `serving.models` payload of the lsot_model_* families. None when
        no replica carries an id."""
        per: Dict[str, Dict[str, object]] = {}
        for st, s in self._replica_items():
            mid = st.model_id or self._model_id(s)
            if not mid:
                continue
            rec = per.setdefault(mid, {
                "model": mid, "replicas": 0, "placeable": 0,
                "queued": 0, "active_slots": 0,
                "pending_new_tokens": 0, "backlog_s": 0.0,
                "placements": 0, "tokens_total": 0,
                "kv_pages_total": 0, "kv_pages_in_use": 0,
            })
            rec["replicas"] += 1
            if st.state in _ReplicaState.PLACEABLE:
                rec["placeable"] += 1
            secs, toks = self._score(s)
            rec["backlog_s"] = round(rec["backlog_s"] + secs, 4)
            rec["pending_new_tokens"] += toks
            q = getattr(s, "_queue", None)
            rec["queued"] += q.qsize() if q is not None else 0
            slot_req = getattr(s, "_slot_req", None) or []
            rec["active_slots"] += sum(1 for r in slot_req if r is not None)
            rec["placements"] += st.placements
            rec["tokens_total"] += int(getattr(s, "_tokens_emitted_total", 0) or 0)
            pstats = getattr(s, "page_stats", None)
            if isinstance(pstats, dict):
                rec["kv_pages_total"] += int(pstats.get("pages_total", 0) or 0)
                rec["kv_pages_in_use"] += int(pstats.get("pages_in_use", 0) or 0)
            # A remote carrier: its cached loads digest stands in for the
            # attribute reads a socket transport cannot offer.
            ld = getattr(s, "loads_digest", None)
            if callable(ld):
                try:
                    d = ld()
                    rec["queued"] += int(d.get("queued", 0) or 0)
                    rec["active_slots"] += int(d.get("active_slots", 0) or 0)
                    rec["tokens_total"] += int(d.get("tokens_total", 0) or 0)
                except Exception:  # noqa: BLE001 — a dying replica mid-read
                    pass
        if not per:
            return None
        now = time.monotonic()
        with self._lock:
            for mid, rec in per.items():
                prev = self._model_rate.get(mid)
                total = int(rec["tokens_total"])
                tok_s = 0.0
                if prev is not None and now > prev[0]:
                    tok_s = max(0.0, (total - prev[1]) / (now - prev[0]))
                self._model_rate[mid] = (now, total)
                rec["tok_s"] = round(tok_s, 3)
        return {"models": sorted(per.values(), key=lambda r: r["model"])}

    def _replica_items(self, states: Optional[Sequence[str]] = None
                       ) -> List[Tuple[_ReplicaState, object]]:
        """A locked (state, scheduler) snapshot of the fleet, optionally
        filtered by lifecycle state."""
        with self._lock:
            return [(st, self.schedulers[i]) for i, st in enumerate(self._states)
                    if states is None or st.state in states]

    def _placeable(self, exclude: Optional[set] = None
                   ) -> List[Tuple[int, _ReplicaState, object]]:
        """Replicas that take new work now: ready or degraded and not
        crashed. A crash seen here kicks that replica's targeted restart
        (or marks it dead without a factory)."""
        out = []
        with self._lock:
            items = [(i, st) for i, st in enumerate(self._states)
                     if st.state in _ReplicaState.PLACEABLE
                     and (exclude is None or i not in exclude)]
            scheds = list(self.schedulers)
        for i, st in items:
            s = scheds[i]
            crash = getattr(s, "_crash", None)
            if crash is not None:
                self._note_replica_crash(i, crash)
                continue
            out.append((i, st, s))
        return out

    @staticmethod
    def _phase_role(s) -> str:
        return getattr(s, "phase_role", "mixed") or "mixed"

    @staticmethod
    def _model_id(s) -> str:
        return str(getattr(s, "model_id", "") or "")

    def _carries(self, c, model: str) -> bool:
        """Does placeable candidate `c` = (i, state, scheduler) hold `model`?"""
        return (c[1].model_id or self._model_id(c[2])) == model

    def _penalty(self, st: _ReplicaState, s) -> int:
        """Pressure-aware placement: +1 for a replica with withheld pool
        pages, +1 for one whose rolling SLO is burning; 0 in a healthy
        fleet, which leaves the backlog order as it is."""
        pen = 0
        pstats = getattr(s, "page_stats", None)
        if pstats and int(pstats.get("pages_withheld", 0) or 0) > 0:
            pen += 1
        from ..utils import slo as _slo

        if _slo.ENGINE.enabled and _slo.ENGINE.replica_burning(st.label):
            pen += 1
        return pen

    # ------------------------------------------------- phase-role handoffs

    def _wire_handoff(self, idx: int, s) -> None:
        """Point a prefill replica's handoff queue at the pool's placement
        pump (at construction, after a restart's swap, on a join)."""
        if self._phase_role(s) == "prefill" and hasattr(s, "on_handoff"):
            s.on_handoff = partial(self._pump_handoffs, idx)
        # A pushed constrained handoff carries only its spec: the receiving
        # transport rebuilds the matcher through the pool's resolver seam.
        if (getattr(s, "is_remote", False)
                and getattr(s, "constraint_resolver", "absent") is None):
            s.constraint_resolver = self._fleet_constraint

    def _fleet_constraint(self, spec):
        """Resolve a constraint spec re-made from the wire (a pushed
        handoff) through whatever the owning backend installed."""
        fn = self.constraint_resolver
        if fn is None:
            raise ValueError(
                "pushed constrained handoff needs a constraint resolver: "
                "set pool.constraint_resolver (SchedulerBackend does this "
                "automatically)")
        return fn(spec)

    def _join_compat(self, s) -> Optional[str]:
        """The join handshake of a remote replica: a pushed blob's pages
        must import into every decode target, so a joiner whose page
        geometry disagrees with the fleet's, or whose model no sibling
        carries, cannot be placeable. Returns the reason, or None. Local
        replicas are trusted (the fleet's factory built them)."""
        if not getattr(s, "is_remote", False):
            return None
        try:
            ref = next((o for o in self.schedulers
                        if o is not s and not getattr(o, "is_remote", False)), None)
            if ref is None:
                return None  # an all-remote fleet: nothing to disagree with
            r_paged = bool(getattr(s, "_paged", False))
            l_paged = bool(getattr(ref, "_paged", False))
            if r_paged != l_paged:
                return f"paged={r_paged} vs fleet paged={l_paged}"
            r_ps = int(getattr(s, "_page_size", 0) or 0)
            l_ps = int(getattr(ref, "_page_size", 0) or 0)
            if r_paged and r_ps and l_ps and r_ps != l_ps:
                return f"page_size={r_ps} vs fleet page_size={l_ps}"
            want = str(getattr(s, "model_id", "") or "")
            have = {self._model_id(o) for o in self.schedulers if o is not s}
            have.discard("")
            if want and have and want not in have:
                return f"model_id={want!r} not served by this fleet ({sorted(have)})"
        except Exception as e:  # noqa: BLE001 — an unreachable joiner
            return f"handshake read failed: {e!r}"
        return None

    def _validate_join(self, idx: int, s) -> bool:
        """Run the join handshake for replica `idx`; an incompatible
        joiner is marked dead (never placeable) with the reason and a
        flight event, and the pool serves on the rest."""
        reason = self._join_compat(s)
        if reason is None:
            return True
        st = self._states[idx]
        with self._lock:
            st.state = "dead"
            st.last_crash = f"join rejected: {reason}"
        self._pool_flight.event("replica_join_rejected", replica=st.label, reason=reason)
        return False

    @staticmethod
    def _decode_pressure(s) -> float:
        """A replica's decode-phase HBM utilization EWMA from its roofline
        ledger (0.0 without one): the nearer the roof, the less room a
        migrated request's decode has there."""
        try:
            perf = getattr(s, "perf_stats", None)
            if isinstance(perf, dict):
                dec = (perf.get("phases") or {}).get("decode")
                if dec and dec.get("hbm_util") is not None:
                    return float(dec["hbm_util"])
        except Exception:  # noqa: BLE001 — a dying replica mid-read
            pass
        return 0.0

    def _pump_handoffs(self, src_idx: int) -> None:
        """Place every packed handoff of prefill replica `src_idx` (its
        `on_handoff`, on its worker thread: placement is a lock and a queue
        put). A push-capable transport drains the blobs its worker pushed
        (no rpc); `extract_handoffs` is the pull path of local replicas and
        pre-push workers."""
        src = self.schedulers[src_idx]
        ex = getattr(src, "drain_pushed_handoffs", None)
        if not callable(ex):
            ex = getattr(src, "extract_handoffs", None)
        if callable(ex):
            for req in ex():
                self._place_handoff(req, src_idx)

    def _place_handoff(self, req, src_idx: int) -> None:
        """Place one migrated request: decode replicas first (pressure
        penalty, decode HBM utilization, weighted backlog, index), then
        mixed ones, then the source (decode in place: a placement failure
        never loses the request). Same-model targets only under model
        routing. A target whose backlog already exceeds the remaining
        deadline, or whose pool has no free page, is skipped; a target
        whose `requeue` raises (a contiguous pool, another page size, a
        crash) is passed over."""
        src = self.schedulers[src_idx]
        remaining = req.deadline.remaining() if req.deadline is not None else None
        cands = self._placeable()
        src_model = self._model_id(src)
        if self._model_routing and src_model:
            cands = [c for c in cands if self._carries(c, src_model)]

        def ordered(role):
            decorated = []
            for i, st, s in cands:
                if self._phase_role(s) != role or s is src:
                    continue
                secs, toks = self._wscore(i, s)
                decorated.append((self._penalty(st, s), self._decode_pressure(s),
                                  secs, toks, i, st, s))
            decorated.sort(key=lambda t: t[:5])
            return [(i, st, s) for (*_k, i, st, s) in decorated]

        targets = ordered("decode") + ordered("mixed") + [
            (src_idx, self._states[src_idx], src)]
        # Read before a target can race: its worker clears `handoff` at the
        # import, and requeue gives the request a new rid.
        pages = (req.handoff or {}).get("pages", 0)
        t_recv = (req.handoff or {}).get("t_recv")
        rid = req.rid
        starved = 0
        for i, st, s in targets:
            if s is not src:
                if remaining is not None and self._score(s)[0] >= remaining:
                    continue  # its backlog alone would burn the deadline
                try:
                    pstats = getattr(s, "page_stats", None)
                    if pstats and int(pstats.get("pages_free", 1) or 0) <= 0:
                        starved += 1
                        continue
                except Exception:  # noqa: BLE001 — a dying replica mid-read
                    pass
            rq = getattr(s, "requeue", None)
            if not callable(rq):
                continue
            try:
                rq(req)
            except Exception:  # noqa: BLE001 — a crashed or incompatible target
                continue
            with self._lock:
                st.placements += 1
                # A pushed handoff's transport stamped its receipt: placement
                # closes the window of fleet_stats' push latencies.
                if t_recv is not None:
                    try:
                        self._push_lat.append(max(0.0, time.perf_counter()
                                                  - float(t_recv)))
                    except (TypeError, ValueError):
                        pass
            self._pool_flight.event("handoff_place", to=st.label,
                                    src=self._states[src_idx].label, rid=rid,
                                    pages=pages, inplace=s is src)
            return
        if starved:
            # Every decode target page-waits and the source refused it back:
            # retryable backpressure, not a crash.
            req.future.set_exception(Overloaded(
                "every decode target is page-waiting; prefill→decode handoff "
                "rejected under KV pressure"))
            return
        # Not even the source took it back: fail typed, so the supervisor's
        # journal replays it.
        req.future.set_exception(SchedulerCrashed(
            "no replica could accept a prefill→decode handoff"))

    @property
    def handoff_stats(self) -> Optional[Dict[str, object]]:
        """Each replica's handoff counters, labeled (/metrics'
        `serving.handoff`, the lsot_handoff_* families); None when no
        replica has any."""
        per = []
        for st, s in self._replica_items():
            h = getattr(s, "handoff_stats", None)
            if isinstance(h, dict):
                rec = dict(h)
                rec["replica"] = st.label
                per.append(rec)
        return {"replicas": per} if per else None

    def qos_stats(self) -> Optional[Dict[str, object]]:
        """Each replica's WFQ counters, labeled; None when no replica runs
        QoS."""
        per = []
        for st, s in self._replica_items():
            fn = getattr(s, "qos_stats", None)
            if not callable(fn):
                continue
            qs = fn()
            if qs:
                rec = dict(qs)
                rec["replica"] = st.label
                per.append(rec)
        return {"replicas": per} if per else None

    def submit(self, ids, max_new_tokens: int = 256,
               sampling: SamplingParams = SamplingParams(), seed: int = 0,
               on_token=None, constraint=None, deadline_s=None, trace=None,
               model_id: str = "", tenant: str = "", qos: str = ""):
        """Place one request (see the class docstring for the order) and
        return the chosen replica's future, failing over on Overloaded and
        on a crash that landed between the placeable check and the submit.
        `model_id=""` (or model routing off) skips every model check."""
        want_model = model_id if (self._model_routing and model_id) else ""
        if want_model:
            with self._lock:
                carriers = [st.state for st in self._states if st.model_id == want_model]
                known = sorted({st.model_id for st in self._states if st.model_id})
            if not carriers:
                from .modelpool import UnknownModel

                raise UnknownModel(
                    f"no replica in the fleet serves model {want_model!r} "
                    f"(models: {known or ['<unset>']})")
        last_overloaded: Optional[Overloaded] = None
        deadline_blocked: Optional[float] = None
        tried: set = set()
        while True:
            cands = self._placeable(exclude=tried)
            if want_model:
                cands = [c for c in cands if self._carries(c, want_model)]
            if not cands:
                break
            # Fresh prompts are prefill work: off decode replicas while a
            # prefill or mixed one can take them (roles are policy, not
            # capability); the decode replicas set aside are the deadline's
            # spillover below.
            spill: List = []
            front = [c for c in cands if self._phase_role(c[2]) != "decode"]
            if front and len(front) < len(cands):
                spill = [c for c in cands if self._phase_role(c[2]) == "decode"]
                cands = front
            if self.router == "round_robin":
                aff: Dict[str, int] = {}
                with self._lock:
                    pick = self._rr % len(cands)
                    self._rr += 1
                order = cands[pick:] + cands[:pick]
                scored = [(self._score(s), i, st, s) for (i, st, s) in order]
            else:
                aff = self._affinity_scores(ids, tenant) if self._affinity else {}
                scored = sorted(((self._score(s), i, st, s) for (i, st, s) in cands),
                                key=lambda t: self._order_key(t, aff))
            if deadline_s is not None:
                feasible = [t for t in scored if t[0][0] < deadline_s]
                if not feasible and spill:
                    # The prefill and mixed tier cannot meet the deadline:
                    # an idle decode replica (full capability) beats a 504.
                    spilled = sorted(((self._score(s), i, st, s) for (i, st, s) in spill),
                                     key=lambda t: self._order_key(t, aff))
                    feasible = [t for t in spilled if t[0][0] < deadline_s]
                    scored = scored + spilled
                if not feasible:
                    # Every backlog already exceeds the budget: shed 504.
                    deadline_blocked = min(t[0][0] for t in scored)
                    break
                scored = feasible
            (secs, toks), i, st, sched = scored[0]
            try:
                extra = {"model_id": want_model} if want_model else {}
                if (tenant or qos) and getattr(sched, "supports_qos", False):
                    extra["tenant"] = tenant
                    extra["qos"] = qos
                fut = sched.submit(
                    ids, max_new_tokens=max_new_tokens, sampling=sampling,
                    seed=seed, on_token=on_token, constraint=constraint,
                    deadline_s=deadline_s, trace=trace, **extra)
            except ValueError:
                raise  # a request-shape rejection holds on every replica
            except Overloaded as e:
                if (last_overloaded is None
                        or e.retry_after_s < last_overloaded.retry_after_s):
                    last_overloaded = e
                tried.add(i)
                continue
            except RuntimeError:
                # Fail over only for a genuine crash; lifecycle misuse
                # ("not started") is the caller's error.
                crash = getattr(sched, "_crash", None)
                if crash is None:
                    raise
                self._note_replica_crash(i, crash)
                tried.add(i)
                continue
            if getattr(fut, "_lsot_replica", None) is None:
                fut._lsot_replica = st.label
            with self._lock:
                st.placements += 1
                if aff and aff.get(st.label, 0) > 0 \
                        and aff[st.label] == max(aff.values()):
                    self._aff_hits += 1
            if st.state == "degraded":
                def _prove(f, st=st):
                    # A clean completion proves a restarted replica.
                    if f.exception() is None:
                        with self._lock:
                            if st.state == "degraded":
                                st.state = "ready"
                fut.add_done_callback(_prove)
            ev: Dict[str, object] = dict(
                to=st.label, router=self.router, backlog_s=round(secs, 4),
                pending_new_tokens=toks, considered=len(cands))
            if aff:
                ev["affinity"] = aff.get(st.label, 0)
            if want_model:
                ev["model"] = want_model
            self._pool_flight.event("placement", **ev)
            return fut
        if want_model and last_overloaded is None and deadline_blocked is None:
            # The model is registered but none of its replicas is
            # placeable: a drain or restart is retryable backpressure.
            with self._lock:
                carriers = [st.state for st in self._states if st.model_id == want_model]
            if any(x in ("restarting", "draining", "drained") for x in carriers):
                raise Overloaded(
                    f"every replica serving model {want_model!r} is draining "
                    f"or restarting", retry_after_s=self.retry_after_hint())
            raise SchedulerCrashed(
                f"every replica serving model {want_model!r} has crashed or "
                f"left the fleet")
        if last_overloaded is not None:
            raise Overloaded(
                "every scheduler replica is at capacity",
                retry_after_s=min(last_overloaded.retry_after_s,
                                  self.retry_after_hint()))
        if deadline_blocked is not None:
            resilience.inc("deadline_infeasible")
            raise DeadlineExceeded(
                f"no replica can serve within the {deadline_s:.3f}s deadline: "
                f"minimum fleet backlog estimate {deadline_blocked:.3f}s")
        with self._lock:
            restarting = any(st.state == "restarting" for st in self._states)
        if restarting:
            # Retryable backpressure, not a crash: the supervisor must not
            # tear the pool down while its replicas are being rebuilt.
            raise Overloaded("every scheduler replica is restarting",
                             retry_after_s=self.retry_after_hint())
        raise SchedulerCrashed("all scheduler replicas have crashed or left the fleet")

    def _order_key(self, t, aff: Dict[str, int]):
        """The least-loaded order of a scored candidate t = ((secs, toks),
        i, state, scheduler): affinity, pressure penalty, weighted backlog,
        index."""
        return (-aff.get(t[2].label, 0), self._penalty(t[2], t[3]),
                *self._wkey(t[1], t[0][0], t[0][1]), t[1])

    cancel = staticmethod(ContinuousBatchingScheduler.cancel)

    # --------------------------------------------------- replica lifecycle

    def _resolve_idx(self, replica) -> int:
        if isinstance(replica, int):
            if not 0 <= replica < len(self._states):
                raise ValueError(f"no replica index {replica}")
            return replica
        for i, st in enumerate(self._states):
            if st.label == replica:
                return i
        raise ValueError(f"unknown replica {replica!r}")

    def _note_replica_crash(self, idx: int, exc: BaseException) -> None:
        """A replica's loop died: start its targeted restart, or mark it
        dead without a factory. Once per episode."""
        with self._lock:
            st = self._states[idx]
            if self._closed or st.state not in _ReplicaState.PLACEABLE:
                return
            st.last_crash = str(exc)[:200]
            if self._factory is None:
                st.state = "dead"
                self._pool_flight.event("replica_dead", replica=st.label,
                                        error=st.last_crash)
                return
            st.state = "restarting"
        resilience.inc("replica_crashes")
        self._pool_flight.event("replica_crash", replica=st.label, error=st.last_crash)
        _log.warning("replica %s crashed; pool restarting it: %s", st.label, exc)
        self._spawn_restart(idx)

    def notice_replica_crash(self, replica, exc: BaseException) -> None:
        """The supervisor's crash notice (a journaled request's inner future
        failed with a crash): starts the replica's targeted restart."""
        try:
            idx = self._resolve_idx(replica)
        except ValueError:
            return
        self._note_replica_crash(idx, exc)

    def restart_replica(self, replica, reason: str = "manual") -> bool:
        """Targeted restart of one replica (the watchdog's stall escalation
        and the operator's kick): a bounded-join teardown, then a rebuild
        from the factory under the replica's own restart budget, while its
        siblings serve. A drained replica restarts back into the fleet.
        False when it is already restarting, draining or removed, the pool
        is closed, or there is no factory."""
        idx = self._resolve_idx(replica)
        with self._lock:
            st = self._states[idx]
            if (self._closed or self._factory is None
                    or st.state in ("restarting", "draining", "removed")):
                return False
            st.state = "restarting"
            if reason == "stalled":
                st.stalls += 1
            st.last_crash = reason
        if reason == "stalled":
            resilience.inc("replica_stalls")
        self._pool_flight.event("replica_restart_requested", replica=st.label,
                                reason=reason)
        _log.warning("replica %s restart requested (%s)", st.label, reason)
        self._spawn_restart(idx)
        return True

    def _spawn_restart(self, idx: int) -> None:
        t = threading.Thread(target=self._restart_episode, args=(idx,), daemon=True,
                             name=f"lsot-pool-restart-{self._states[idx].label}")
        with self._lock:
            self._restart_threads = [x for x in self._restart_threads if x.is_alive()]
            self._restart_threads.append(t)
        t.start()

    def _build_replica(self, idx: int):
        return self._factory(idx) if self._factory_takes_index else self._factory()

    def _restart_episode(self, idx: int) -> None:
        """One thread a restart episode: bounded teardown of the corpse,
        backoff under the replica's budget, rebuild, start, swap.
        Budget exhausted marks only this replica dead."""
        st = self._states[idx]
        while True:
            old = self.schedulers[idx]
            try:
                if old is not None:
                    old.shutdown(timeout=self._replica_join_s)
            except Exception:  # noqa: BLE001 — a broken corpse must not stop the rebuild
                _log.exception("replica %s teardown failed; continuing", st.label)
            with self._lock:
                if self._closed:
                    return
                if st.restarts >= self.max_restarts:
                    st.state = "dead"
                    st.restart_eta = None
                    self._pool_flight.event("replica_dead", replica=st.label,
                                            restarts=st.restarts)
                    _log.error("replica %s dead: restart budget exhausted (%d/%d)",
                               st.label, st.restarts, self.max_restarts)
                    return
                attempt = st.restarts
                st.restarts += 1
            resilience.inc("replica_restarts")
            delay = self._restart_policy.delay_s(attempt, self._rng)
            with self._lock:
                # Hints quoted while this replica is down promise at least
                # the backoff remaining.
                st.restart_eta = time.monotonic() + delay
            self._sleep(delay)
            with self._lock:
                if self._closed:
                    return
            try:
                fresh = self._build_replica(idx)
                # Warmed before it serves, as the supervisor's restart
                # driver warms: a cold first round pays the kernels' loads
                # and first launches on a live request.
                warm = getattr(fresh, "warmup", None)
                if callable(warm):
                    warm()
                fresh.start()
            except Exception:  # noqa: BLE001 — a failed rebuild burns one credit
                _log.exception("replica %s rebuild failed (restart %d/%d)",
                               st.label, attempt + 1, self.max_restarts)
                continue
            with self._lock:
                if self._closed or st.state != "restarting":
                    # The pool is going away, or a drain or remove owns the
                    # replica now.
                    fresh.shutdown()
                    return
                fl = getattr(fresh, "flight", None)
                if fl is not None:
                    fl.replica = st.label
                self.schedulers[idx] = fresh
                # A rebuilt prefill replica's pump: the corpse took the wiring.
                self._wire_handoff(idx, fresh)
                # The factory may rebuild with another checkpoint id.
                st.model_id = self._model_id(fresh)
                # Degraded until a clean completion lands on it.
                st.state = "degraded"
                st.restart_eta = None
            self._pool_flight.event("replica_restart", replica=st.label,
                                    attempt=st.restarts)
            _log.info("replica %s restarted (%d/%d)", st.label, st.restarts,
                      self.max_restarts)
            cb = self.on_replica_restart
            if cb is not None:
                try:
                    cb(st.label)
                except Exception:  # noqa: BLE001 — the replay hook must not end the episode
                    _log.exception("on_replica_restart(%s) failed", st.label)
            return

    def drain_replica(self, replica, deadline_s: Optional[float] = None,
                      remove: bool = False) -> Dict[str, object]:
        """Runtime drain of one replica: stop placing on it, re-place its
        queued requests on the least-loaded siblings carrying the same
        model (a lone replica of its model keeps them), give in-flight work
        up to `deadline_s` (None: wait; <= 0: none), then shut it down with
        a bounded join. `remove=True` takes it out of the fleet for good;
        otherwise it parks `drained` and `restart_replica()` brings it
        back."""
        idx = self._resolve_idx(replica)
        t_drain0 = time.perf_counter()
        with self._lock:
            st = self._states[idx]
            if st.state in ("draining", "removed"):
                return {"replica": st.label, "state": st.state, "replaced": 0}
            st.state = "draining"
            sched = self.schedulers[idx]
        self._pool_flight.event("replica_drain", replica=st.label,
                                deadline_s=deadline_s, remove=remove)
        # Re-place queued work before waiting on in-flight work.
        replaced = 0
        extract = getattr(sched, "extract_queued", None)
        pulls = list(extract()) if callable(extract) else []
        # Packed handoffs drain too: each carries its KV blob, so a sibling
        # restores and decodes it without a prefill.
        exh = getattr(sched, "extract_handoffs", None)
        if callable(exh):
            pulls.extend(exh())
        drain_model = st.model_id or self._model_id(sched)
        for req in pulls:
            target = None
            cands = self._placeable()
            if self._model_routing and drain_model:
                cands = [c for c in cands if self._carries(c, drain_model)]
            if cands:
                target = min(((self._wscore(i, s), self._penalty(_st, s), i, s)
                              for (i, _st, s) in cands),
                             key=lambda t: (t[1], t[0][0], t[0][1], t[2]))[3]
            if target is not None and callable(getattr(target, "requeue", None)):
                try:
                    target.requeue(req)
                    replaced += 1
                    continue
                except Exception:  # noqa: BLE001 — an incompatible or racing target
                    pass
            # No sibling can take it: it serves out on the draining replica.
            sched.requeue(req)
        if replaced:
            self._pool_flight.event("replica_drain_replaced", replica=st.label,
                                    replaced=replaced)
        busy = getattr(sched, "_busy_now", None)
        deadline = (Deadline.after(deadline_s)
                    if deadline_s is not None and deadline_s > 0 else None)
        wait_all = deadline_s is None
        finished = True
        while callable(busy):
            try:
                if not busy():
                    break
            except Exception:  # noqa: BLE001 — a dying replica mid-read
                break
            if not wait_all and (deadline is None or deadline.remaining() <= 0):
                finished = False
                break
            time.sleep(0.01)
        try:
            sched.shutdown(timeout=self._replica_join_s)
        except Exception:  # noqa: BLE001 — a wedged corpse must not fail the drain
            _log.exception("replica %s drain shutdown failed", st.label)
        with self._lock:
            # Only if the drain still owns the slot (a racing restart is
            # refused while draining).
            if st.state == "draining":
                st.state = "removed" if remove else "drained"
            self._fleet_drain_s_sum += time.perf_counter() - t_drain0
            self._fleet_drain_count += 1
        self._pool_flight.event("replica_drained", replica=st.label,
                                replaced=replaced, finished=finished, removed=remove)
        cb = self.on_replica_drained
        if cb is not None:
            try:
                # The supervisor re-places the journaled requests still
                # attributed to this replica.
                cb(st.label)
            except Exception:  # noqa: BLE001 — the replay hook is best effort
                _log.exception("on_replica_drained(%s) failed", st.label)
        return {"replica": st.label, "state": "removed" if remove else "drained",
                "replaced": replaced, "finished": finished}

    def remove_replica(self, replica,
                       deadline_s: Optional[float] = None) -> Dict[str, object]:
        """Drain and remove one replica for good."""
        return self.drain_replica(replica, deadline_s=deadline_s, remove=True)

    def add_replica(self, scheduler, label: Optional[str] = None,
                    weight: float = 1.0, elastic: bool = True) -> str:
        """Join one replica to a live fleet; returns its label. A remote
        joiner runs the join handshake (a failure leaves it listed dead
        with the reason, never placeable) and arms the lease monitor.
        `elastic=True` makes it retirable by `retire_replica`."""
        with self._lock:
            if self._closed:
                raise RuntimeError("cannot add a replica to a closed pool")
            idx = len(self.schedulers)
            lbl = label or f"r{idx}"
            fl = getattr(scheduler, "flight", None)
            if fl is not None:
                fl.replica = lbl
            self.schedulers.append(scheduler)
            self._states.append(_ReplicaState(label=lbl,
                                              model_id=self._model_id(scheduler)))
            self._weights.append(max(1e-9, float(weight)))
            if elastic:
                self._elastic.add(idx)
            self._fleet_joins += 1
        self._wire_handoff(idx, scheduler)
        ok = self._validate_join(idx, scheduler)
        self._pool_flight.event("replica_join", replica=lbl, elastic=bool(elastic),
                                accepted=ok, phase_role=self._phase_role(scheduler))
        self._maybe_start_lease()
        return lbl

    def retire_replica(self, replica=None, deadline_s: Optional[float] = None
                       ) -> Optional[Dict[str, object]]:
        """Drain and remove one replica `add_replica` joined elastically
        (with `replica=None`, the least-loaded serving one): its queued work
        re-places on siblings. None when nothing is retirable."""
        if replica is not None:
            idx = self._resolve_idx(replica)
            if idx not in self._elastic:
                return None
        else:
            with self._lock:
                cands = [i for i in self._elastic
                         if self._states[i].state in _ReplicaState.PLACEABLE]
            if not cands:
                return None
            idx = min(cands, key=lambda i: (self._wscore(i, self.schedulers[i]), i))
        out = self.drain_replica(idx, deadline_s=deadline_s, remove=True)
        with self._lock:
            self._elastic.discard(idx)
            self._fleet_retires += 1
        self._pool_flight.event("replica_retire", replica=out.get("replica"),
                                replaced=out.get("replaced"))
        return out

    def fleet_stats(self) -> Dict[str, object]:
        """The `fleet` block of /healthz and /metrics (lsot_fleet_*): live
        membership, the join/retire/drain counters and the pushed-handoff
        ledger: pushes and bytes received from remote prefill workers, the
        pump depth (buffered here and unacked on the workers) and the
        receive-to-placement latency. Local replicas' handoffs are in
        `handoff_stats`."""
        with self._lock:
            states = [st.state for st in self._states]
            out: Dict[str, object] = {
                "size": len(states),
                "serving": sum(1 for x in states if x in _ReplicaState.PLACEABLE),
                "elastic": len(self._elastic),
                "joins": self._fleet_joins,
                "retires": self._fleet_retires,
                "drain_s_sum": round(self._fleet_drain_s_sum, 6),
                "drain_count": self._fleet_drain_count,
            }
            lat = sorted(self._push_lat)
        out.update({"pushed": 0, "push_bytes": 0, "pump_depth": 0,
                    "push_placed": len(lat)})
        if lat:
            out["push_place_p50_ms"] = round(lat[int(0.50 * (len(lat) - 1))] * 1e3, 3)
            out["push_place_p95_ms"] = round(lat[int(0.95 * (len(lat) - 1))] * 1e3, 3)
        for s in self.schedulers:
            pp = getattr(s, "push_pump_stats", None)
            if isinstance(pp, dict):
                out["pushed"] += int(pp.get("pushed", 0) or 0)
                out["push_bytes"] += int(pp.get("push_bytes", 0) or 0)
                out["pump_depth"] += int(pp.get("depth", 0) or 0)
                w = pp.get("worker")
                if isinstance(w, dict):
                    out["pump_depth"] += int(w.get("window", 0) or 0)
        return out

    def stalled_replicas(self, factor: float, floor_s: float) -> List[str]:
        """Serving replicas whose busy heartbeat is older than their stall
        threshold: the supervisor's targeted-restart feed."""
        from .watchdog import stall_threshold

        out: List[str] = []
        for st, s in self._replica_items(_ReplicaState.PLACEABLE):
            hb = getattr(s, "heartbeat", None)
            if hb is None or not hb.busy:
                continue
            if hb.age() > stall_threshold(hb, factor, floor_s):
                out.append(st.label)
        return out

    # ----------------------------------------------------------- health

    def replica_health(self) -> List[Dict[str, object]]:
        """Per-replica lifecycle for /healthz, /readyz and /metrics."""
        now = time.monotonic()
        out = []
        for st, s in self._replica_items():
            rec: Dict[str, object] = {
                "replica": st.label,
                "state": st.state,
                "phase_role": self._phase_role(s),
                "model_id": st.model_id or self._model_id(s),
                "restarts": st.restarts,
                "max_restarts": self.max_restarts,
                "stalls": st.stalls,
                "crashed": getattr(s, "_crash", None) is not None,
            }
            # A transport replica: which wire, and whether its lease holds.
            ts = getattr(s, "transport_stats", None)
            if callable(ts):
                try:
                    rec["transport"] = self._transport_summary(ts())
                except Exception:  # noqa: BLE001 — a dying replica mid-read
                    pass
            if st.last_crash:
                rec["last_crash"] = st.last_crash
            if st.restart_eta is not None:
                rec["restart_eta_s"] = round(max(0.0, st.restart_eta - now), 3)
            out.append(rec)
        return out

    def health(self) -> Dict[str, object]:
        """The fleet's state, shaped like the supervisor's: `ready` (every
        replica serving clean), `degraded` (serving, but a replica is
        restarting, drained, dead or unproven), `restarting` (none serving,
        a rebuild in flight), `dead`; removed replicas stay listed but do
        not degrade it."""
        reps = self.replica_health()
        states = [r["state"] for r in reps if r["state"] != "removed"]
        serving = [x for x in states if x in _ReplicaState.PLACEABLE]
        if serving:
            state = "ready" if all(x == "ready" for x in states) else "degraded"
        elif "restarting" in states:
            state = "restarting"
        else:
            state = "dead"
        return {
            "state": state,
            "replicas": reps,
            "restarts": sum(int(r["restarts"]) for r in reps),
            "stalls": sum(int(r["stalls"]) for r in reps),
            "fleet": self.fleet_stats(),
        }

    @property
    def prefix_stats(self) -> Dict[str, object]:
        """Summed prefix-cache counters; `hit_rate` from the summed
        hits and misses."""
        out: Dict[str, object] = {"hits": 0, "misses": 0, "blocks_reused": 0,
                                  "reused_tokens": 0, "evictions": 0,
                                  "cached_blocks": 0}
        for s in self.schedulers:
            st = getattr(s, "prefix_stats", None)
            if isinstance(st, dict):
                for k in out:
                    out[k] += int(st.get(k, 0))
        total = out["hits"] + out["misses"]
        out["hit_rate"] = round(out["hits"] / total, 4) if total else 0.0
        return out

    @property
    def prefix_telemetry(self) -> Optional[Dict[str, object]]:
        """Per-replica prefix telemetry, labeled; None when no replica has
        a cache on."""
        per = []
        for st, s in self._replica_items():
            t = getattr(s, "prefix_telemetry", None)
            if isinstance(t, dict):
                rec = dict(t)
                rec["replica"] = st.label
                per.append(rec)
        return {"replicas": per} if per else None

    def prefix_registry(self, top_k: Optional[int] = None) -> Dict[str, object]:
        """Per-replica prefix registries, labeled (/debug/prefixcache)."""
        per = []
        for st, s in self._replica_items():
            fn = getattr(s, "prefix_registry", None)
            if not callable(fn):
                continue
            reg = fn(top_k)
            if isinstance(reg, dict):
                reg = dict(reg)
                reg["replica"] = st.label
                per.append(reg)
        return {"replicas": per}

    def prefix_affinity(self, digests: Sequence[str]) -> List[Dict[str, object]]:
        """Score every placeable replica by how many of `digests` it holds
        resident; [{replica, score}] best first, scoring replicas only. A
        non-empty lookup leaves a `prefix_affinity` event."""
        want = {d for d in digests if d}
        if not want:
            return []
        scored: List[Dict[str, object]] = []
        for _i, st, s in self._placeable():
            fn = getattr(s, "resident_digests", None)
            if not callable(fn):
                continue
            score = len(want & set(fn()))
            if score:
                scored.append({"replica": st.label, "score": score})
        scored.sort(key=lambda r: -int(r["score"]))
        if scored:
            self._pool_flight.event("prefix_affinity", best=scored[0]["replica"],
                                    score=scored[0]["score"], digests=len(want),
                                    holders=len(scored))
        return scored

    @property
    def speculation_stats(self) -> Optional[Dict[str, float]]:
        """The first replica's acceptance view (None with speculation off)."""
        return getattr(self.schedulers[0], "speculation_stats", None)

    def generate(self, prompts, max_new_tokens: int = 256,
                 sampling: SamplingParams = SamplingParams(), seed: int = 0):
        futs = [self.submit(p, max_new_tokens=max_new_tokens, sampling=sampling,
                            seed=seed) for p in prompts]
        return [f.result() for f in futs]


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
    recovers a previous process's journal spill at construction.

    `scheduler` may also be a `SchedulerPool` (or a supervisor over one):
    with `model_id` set and a pool that routes on models, every submit
    names the model, so one pool serves several backends' checkpoints.
    Labeled requests' `tenant` and `qos` reach schedulers that declare
    `supports_qos`."""

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
        model_id: str = "",
    ):
        self.scheduler = scheduler.start()
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling
        self.stop_texts = tuple(stop_texts)
        self.add_bos = add_bos
        self.deadline_s = deadline_s
        # The registered model every submit names, forwarded only to a
        # scheduler that routes on models ("" model-blind).
        self.model_id = str(model_id or "")
        self._routes_models = bool(
            getattr(scheduler, "supports_model_routing", False)) and bool(self.model_id)
        # Idempotency keys need a journal to dedupe against: only the
        # supervised wrapper has one.
        self.supports_idempotency = bool(
            getattr(scheduler, "supports_idempotency", False))
        self.supports_qos = bool(getattr(scheduler, "supports_qos", False))
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

    def stats(self) -> Dict[str, object]:
        """The serving layer's /metrics block for this model: prefix-cache
        reuse (`prefix_cache`) and its telemetry (`prefix`), speculative
        acceptance, the page pool (paged), the roofline ledger (`perf`),
        the prefill→decode handoffs (`handoff`, the lsot_handoff_*
        families), the remote replicas' transports (`transport`, the
        lsot_transport_* families), the loop's liveness (`watchdog`) and the flight recorder's ring
        occupancy (the records live at /debug/flightrecorder; a supervised
        scheduler reports its lifecycle ring and the inner round ring
        apart). Over a pool, also the placement counters (`routing`), the
        per-replica loads (`replicas`), the per-model aggregation
        (`models`, the lsot_model_* families) and the fleet membership
        (`fleet`); with QoS on, the per-tenant WFQ counters (`qos`); under
        a supervisor its lifecycle (`supervisor`)."""
        sched = self.scheduler
        out: Dict[str, object] = {"prefix_cache": sched.prefix_stats}
        for key, val in (("prefix", sched.prefix_telemetry),
                         ("speculation", sched.speculation_stats),
                         ("kv_pages", sched.page_stats), ("perf", sched.perf_stats),
                         ("handoff", getattr(sched, "handoff_stats", None)),
                         ("transport", getattr(sched, "transport_stats", None))):
            if val:
                out[key] = val
        rt = getattr(sched, "routing_stats", None)
        routing = rt() if callable(rt) else None
        if routing:
            out["routing"] = routing
        out["watchdog"] = sched.watchdog_stats
        out["flight_recorder"] = sched.flight_stats()
        loads = getattr(sched, "replica_loads", None)
        if callable(loads):
            out["replicas"] = loads()
        for key, seam in (("models", "model_stats"), ("qos", "qos_stats"),
                          ("fleet", "fleet_stats")):
            fn = getattr(sched, seam, None)
            val = fn() if callable(fn) else None
            if val:
                out[key] = val
        sup = self.health()
        if sup is not None:
            out["supervisor"] = sup
        return out

    def flight_snapshot(self, last: Optional[int] = None):
        """The flight recorder's records (supervised: merged with the
        supervisor's lifecycle events) — the /debug/flightrecorder payload."""
        return merge_snapshots([self.scheduler], last)

    def prefix_registry(self, top_k: Optional[int] = None) -> Dict[str, object]:
        """The /debug/prefixcache payload."""
        return self.scheduler.prefix_registry(top_k)

    def profile_rounds(self, rounds: Optional[int] = None,
                       out_dir: Optional[str] = None) -> Dict[str, object]:
        """Arm a bounded torch.profiler capture of the scheduler's next N
        rounds (/debug/profile)."""
        return self.scheduler.profile_rounds(rounds, out_dir)

    def profile_status(self) -> Dict[str, object]:
        return self.scheduler.profile_status()

    def _rclass(self, constrain) -> str:
        return request_class(constrain is not None, bool(self.scheduler._spec_draft))

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
        journal recompiles the spec at recovery; a bare scheduler or pool
        takes no `constraint_spec`, though a pool has a resolver for the
        pushed handoffs)."""
        kwargs: Dict[str, object] = {"constraint": self._resolve_constraint(constrain)}
        if (constrain is not None and hasattr(self.scheduler, "constraint_resolver")
                and self.supports_idempotency):
            kwargs["constraint_spec"] = constrain
        return kwargs

    def _model_kwargs(self) -> Dict[str, object]:
        """submit() kwargs for the model axis: only when this backend is
        model-scoped and the scheduler routes on models."""
        return {"model_id": self.model_id} if self._routes_models else {}

    def _qos_kwargs(self, tenant: str, qos: str) -> Dict[str, object]:
        """submit() kwargs for the tenant axis: only for a labeled request
        on a QoS-capable scheduler."""
        if (tenant or qos) and self.supports_qos:
            return {"tenant": tenant, "qos": qos}
        return {}

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
                idempotency_key=None, constraint_kwargs=None, trace=None,
                tenant="", qos=""):
        on_tok, first_at = _first_token_timer()
        kwargs = dict(constraint_kwargs or {})
        kwargs.update(self._model_kwargs())
        kwargs.update(self._qos_kwargs(tenant, qos))
        if idempotency_key is not None:
            # GenerationService forwards a key only when
            # supports_idempotency is set.
            kwargs["idempotency_key"] = idempotency_key
        fut = self.scheduler.submit(
            ids, max_new_tokens=self._budget(len(ids), max_new_tokens),
            sampling=sampling or self.sampling, seed=seed, on_token=on_tok,
            deadline_s=deadline_s if deadline_s is not None else self.deadline_s,
            trace=trace, **kwargs)
        return fut, first_at

    def _completion(self, ids, fut, first_at, t_submit, constrain) -> Completion:
        out = fut.result()
        text = trim_stop_texts(self.tokenizer.decode(out), self.stop_texts)
        return Completion(text=text, output_tokens=len(out),
                          prompt_tokens=len(ids),
                          ttft_s=(first_at[0] - t_submit) if first_at else 0.0,
                          queue_wait_s=getattr(fut, "_lsot_queue_wait", 0.0),
                          rclass=self._rclass(constrain),
                          replica=getattr(fut, "_lsot_replica", ""))

    def complete_stream(self, prompt: str, max_new_tokens: Optional[int] = None,
                        sampling: Optional[SamplingParams] = None, seed: int = 0,
                        stats_out: Optional[dict] = None,
                        deadline_s: Optional[float] = None, constrain=None,
                        tenant: str = "", qos: str = ""):
        """Yield the completion as text chunks while it decodes. Each token
        re-decodes the ids so far and emits the new text, holding back a
        trailing partial multi-byte sequence (U+FFFD) and the last
        (longest stop text - 1) characters, so the chunks join to exactly
        the blocking text. A stop text ends the stream and cancels the
        request (the scheduler knows stop ids, not strings); closing the
        generator cancels it too. `stats_out` receives prompt_tokens,
        output_tokens, ttft_s, queue_wait_s, rclass and replica."""
        from ..utils import tracing

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
            trace=tracing.current(), **self._constraint_kwargs(constrain),
            **self._model_kwargs(), **self._qos_kwargs(tenant, qos))
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
                qw = getattr(fut, "_lsot_queue_wait", 0.0)
                if qw:
                    stats_out["queue_wait_s"] = qw
                stats_out["rclass"] = self._rclass(constrain)
                stats_out["replica"] = getattr(fut, "_lsot_replica", "")

    def complete(self, prompt: str, max_new_tokens: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None, seed: int = 0,
                 deadline_s: Optional[float] = None,
                 idempotency_key: Optional[str] = None,
                 constrain=None, tenant: str = "", qos: str = "") -> Completion:
        from ..utils import tracing

        ids = self.tokenizer.encode(prompt, add_bos=self.add_bos)
        t_submit = time.perf_counter()
        fut, first_at = self._submit(ids, max_new_tokens, sampling, seed,
                                     deadline_s, idempotency_key,
                                     self._constraint_kwargs(constrain),
                                     trace=tracing.current(), tenant=tenant, qos=qos)
        return self._completion(ids, fut, first_at, t_submit, constrain)

    def complete_batch(
        self, prompts: Sequence[str], max_new_tokens: Optional[int] = None,
        sampling: Optional[SamplingParams] = None, seed: int = 0,
        deadline_s: Optional[float] = None, constrain=None,
        tenant: str = "", qos: str = "",
    ) -> List[Completion]:
        """Submit the whole batch at once: the scheduler interleaves the
        prompts through its slots (continuous batching)."""
        ckw = self._constraint_kwargs(constrain)
        ids_list = [self.tokenizer.encode(p, add_bos=self.add_bos)
                    for p in prompts]
        t_submit = time.perf_counter()
        subs = [self._submit(ids, max_new_tokens, sampling, seed, deadline_s,
                             constraint_kwargs=ckw, tenant=tenant, qos=qos)
                for ids in ids_list]
        return [self._completion(ids, fut, first_at, t_submit, constrain)
                for ids, (fut, first_at) in zip(ids_list, subs)]

    # -------------------------------------------------------- checkpoints

    @classmethod
    def from_hf_checkpoint(cls, ckpt_dir: str, tokenizer, **kwargs
                           ) -> "SchedulerBackend":
        """HF safetensors directory -> a continuous-batching scheduler on
        `device` (default CUDA). The arguments are those of the JAX
        package's `SchedulerBackend.from_hf_checkpoint`: `dtype` (default
        bf16), `quantize_int8` or `quantize_int4` (int8 or int4 block
        weights), `quantize_unembed8` (int8 embed/unembed tables),
        `kv_quant="int8"`,
        the scheduler's shape arguments, the page-pressure knobs
        (`kv_overcommit`, `kv_spill`, `kv_watermark_low/high`),
        `max_queue_depth`, `speculative_draft`, the QoS settings (`qos`,
        `tenant_weights`, `prefix_tenant_ns`), and `supervise` with
        `max_restarts`, `max_entry_replays`, `journal_spill` and `stall_*`
        (serve/supervisor.py). What the port cannot honor yet raises and
        names its ROADMAP item."""
        from ..checkpoint import load_hf_checkpoint

        return cls._from_checkpoint(
            lambda dtype, device: load_hf_checkpoint(
                ckpt_dir, dtype=dtype or torch.bfloat16, device=device,
                mesh=kwargs.get("mesh")),
            os.path.basename(ckpt_dir.rstrip("/")), tokenizer, **kwargs)

    @classmethod
    def from_gguf(cls, gguf_path: str, tokenizer, cfg=None, **kwargs
                  ) -> "SchedulerBackend":
        """GGUF blob -> a continuous-batching scheduler, exactly like
        `from_hf_checkpoint` (the blob is parsed and dequantized by the
        port's C++ reader, checkpoint/gguf.py; the options then quantize
        the dequantized tree). A Q4 blob served with `quantize_int4=True`
        stays 4-bit end to end."""
        from ..checkpoint import load_gguf_checkpoint

        return cls._from_checkpoint(
            lambda dtype, device: load_gguf_checkpoint(
                gguf_path, cfg=cfg, dtype=dtype, device=device,
                mesh=kwargs.get("mesh")),
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
        qos: Optional[bool] = None,
        tenant_weights: Optional[str] = None,
        prefix_tenant_ns: Optional[bool] = None,
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
        from .backends import quantize_loaded, refuse_unported_load, resolve_stop_ids

        refuse_unported_load(mesh, quantize_int8, quantize_int4)
        dev = mesh.device if mesh is not None else resolve_device(device)
        cfg, params = load(dtype, dev)
        params = quantize_loaded(params, quantize_int8, quantize_int4,
                                 quantize_unembed8, mesh)
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
                speculative_draft=speculative_draft, qos=qos,
                tenant_weights=tenant_weights, prefix_tenant_ns=prefix_tenant_ns,
                mesh=mesh, device=params["final_norm"].device)

        # A follower rank's scheduler only replays rank 0's steps; rank 0's
        # supervisor rebuilds a crashed one on every rank (`_register`).
        if supervise and (mesh is None or mesh.is_primary):
            from .supervisor import SupervisedScheduler

            return cls(SupervisedScheduler(
                make_sched, max_restarts=max_restarts,
                max_entry_replays=max_entry_replays,
                spill_path=journal_spill,
                stall_factor=stall_factor, stall_min_s=stall_min_s,
                warmup_grace_s=stall_warmup_s, name=f"scheduler:{tag}",
            ), tokenizer, **kwargs)
        return cls(make_sched(), tokenizer, **kwargs)

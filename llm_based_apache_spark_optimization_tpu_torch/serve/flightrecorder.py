"""Scheduler flight recorder: a lock-light ring of per-round records.

When a decode loop dies — crash, watchdog-escalated stall, SIGTERM — the
journal says WHAT was in flight, but nothing says what the scheduler was
DOING in the rounds before it died: occupancy, admission/retirement
churn, speculation acceptance, round cadence. BENCH_r04/r05's rc=124
deaths left exactly that hole. The flight recorder is the black box:

- `FlightRecorder.record(**fields)` — one append per HARVESTED round
  (the scheduler's natural bookkeeping instant), into a bounded deque
  under a tiny lock: O(1), no I/O, no serialization on the hot path.
  Capacity defaults from `LSOT_FLIGHT_ROUNDS` (256). Since PR 12 each
  round record also carries the roofline-ledger columns
  (`phase`/`perf_ctx`/`mfu`/`hbm_util`/`bound`, plus
  `prefill_mfu`/`prefill_hbm_util` on rounds that flushed prefill
  chunks) — computed by utils/perfmodel.py from the SAME rounded
  `round_wall_s` that lands in the record, so a reader can recompute
  every utilization figure from the record alone. Disaggregated
  serving (ISSUE 13) adds `pages_migrated`/`handoff_wait_s` columns on
  decode-side rounds that imported a prefill→decode handoff, a
  `handoffs` column on prefill-role pack records, and the
  `handoff_export`/`handoff_import`/`handoff_inplace`/`handoff_place`
  lifecycle events — so a migrated request's timeline explains the gap
  between prefill and its first decode token. Prefix-cache telemetry
  (ISSUE 14) adds a `prefix_reuse` column on rounds that admitted
  requests with at least one full prompt block: one {rid, digest,
  reused, prefilled} row per admission, the per-request attribution the
  tier-1 reconciliation test sums against the scheduler's locked
  counters — and the pool ring gains `prefix_affinity` lookup events.
- `event(kind, **fields)` — sparse lifecycle markers (crash, stall
  escalation, restart, drain, grammar swap) ride the same ring with
  `"kind"` set, so the postmortem shows rounds and lifecycle interleaved
  in time order.
- `snapshot(last=N)` — the live view behind `/debug/flightrecorder`.
- `dump(path)` / module-level `append_jsonl(path, records)` — the
  postmortem JSONL write path; the supervisor routes its merged
  header+rounds+traces dump through `append_jsonl` next to the journal
  spill on crash/stall/SIGTERM.

Every record carries the recorder's `replica` label, so a
`SchedulerPool`'s merged view attributes load to the replica that bore
it — the placement-signal feed the ROADMAP's load-aware multi-replica
item needs.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["FlightRecorder", "append_jsonl", "default_capacity",
           "merge_snapshots"]


#: App-startup override (AppConfig.flight_rounds → reconfigure()); None
#: falls through to the LSOT_FLIGHT_ROUNDS env read below.
_DEFAULT_ROUNDS: Optional[int] = None


def reconfigure(rounds: Optional[int]) -> None:
    """App-startup wiring seam (AppConfig.flight_rounds): set the default
    ring size recorders constructed AFTER this call will use — the same
    pattern as `tracing.TRACER.reconfigure`, so `AppConfig(flight_rounds=
    1024)` is honored, not a silent no-op."""
    global _DEFAULT_ROUNDS
    _DEFAULT_ROUNDS = int(rounds) if rounds else None


def default_capacity() -> int:
    """Ring size: AppConfig.flight_rounds when wired via `reconfigure()`,
    else LSOT_FLIGHT_ROUNDS (default 256 rounds ≈ a few seconds of
    context at serving cadence, a few KB of host memory)."""
    if _DEFAULT_ROUNDS is not None:
        return max(8, _DEFAULT_ROUNDS)
    try:
        n = int(os.environ.get("LSOT_FLIGHT_ROUNDS", "256"))
    except ValueError:
        n = 256
    return max(8, n)


def merge_snapshots(sources, last: Optional[int] = None) -> List[Dict]:
    """Merge several sources' flight records in time order — THE merge
    contract (ts ordering, trailing last-N slice), shared by
    SupervisedScheduler, SchedulerPool, and SchedulerBackend instead of
    three hand-rolled copies. A source may be a FlightRecorder, expose
    `flight_snapshot(last)` (nested merged views compose), or carry a
    `.flight` recorder; None sources are skipped."""
    merged: List[Dict] = []
    for src in sources:
        if src is None:
            continue
        if isinstance(src, FlightRecorder):
            merged.extend(src.snapshot(last))
            continue
        snap = getattr(src, "flight_snapshot", None)
        if callable(snap):
            merged.extend(snap(last))
            continue
        fl = getattr(src, "flight", None)
        if fl is not None:
            merged.extend(fl.snapshot(last))
    merged.sort(key=lambda r: r.get("ts", 0.0))
    return merged[-last:] if last else merged


def append_jsonl(path: str, records: List[Dict]) -> int:
    """Append dict records to a JSONL file: makedirs, append mode, never
    raises. THE postmortem write path — `FlightRecorder.dump` and the
    supervisor's merged header+rounds+traces dump both go through here,
    so hardening it (fsync, rotation, redaction) lands everywhere at
    once, and a write failure can never turn a crash into a second
    crash. Returns records written (0 on failure)."""
    lines = [json.dumps(r) for r in records]
    if not lines:
        return 0
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    except OSError:
        return 0
    return len(lines)


class FlightRecorder:
    """Bounded in-memory ring of per-round + lifecycle records."""

    def __init__(self, capacity: Optional[int] = None, replica: str = "r0"):
        self.replica = replica
        self._lock = threading.Lock()
        self._ring: "deque[Dict]" = deque(
            maxlen=capacity if capacity else default_capacity()
        )
        self._seq = 0
        self._dropped = 0

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def record(self, **fields) -> None:
        """Append one per-round record. Hot path: one lock, one dict, one
        deque append — bench's scheduler leg prices it (`observability`
        key) so the recorder's tax is a number, not an assumption."""
        rec = {"ts": time.time(), "replica": self.replica, **fields}
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(rec)

    def event(self, kind: str, **fields) -> None:
        """Lifecycle marker (crash/stall/restart/drain/...): same ring,
        tagged, so postmortems read rounds and lifecycle in one timeline."""
        self.record(kind=kind, **fields)

    def snapshot(self, last: Optional[int] = None) -> List[Dict]:
        """Newest-last copy of the ring (optionally only the last N)."""
        with self._lock:
            out = list(self._ring)
        return out[-last:] if last else out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "records": len(self._ring),
                "capacity": self._ring.maxlen or 0,
                "total": self._seq,
                "overwritten": self._dropped,
            }

    def dump(self, path: str, last: Optional[int] = None) -> int:
        """Write the ring as JSONL via `append_jsonl` (append mode: a
        postmortem may merge several recorders — supervisor lifecycle +
        inner rounds — into one file)."""
        return append_jsonl(path, self.snapshot(last))

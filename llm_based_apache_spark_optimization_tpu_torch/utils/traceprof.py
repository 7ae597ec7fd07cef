"""Device-time profiling from torch.profiler traces — no viewer needed.

Counterpart of the JAX package's `utils/traceprof.py` on `torch.profiler`.
A capture is exported as a gzipped Chrome trace (`*.trace.json.gz`, the
artifact name the JAX package's captures carry, so `find_profile_artifacts`
and `/debug/profile`'s contract stay the same), and this module parses it
directly:

    with device_trace() as tr:
        fn(args)          # any number of launches
    tr.device_time_s()    # summed device busy wall, overlaps merged
    tr.top_ops(10)        # [(name, seconds, count)] hottest first
    tr.busy_share()       # device busy wall / the device lanes' span

Event model: each Chrome trace "X" (complete) event of a device category
(`kernel`, `gpu_memcpy`, `gpu_memset`: the kernels and copies torch's CUPTI
collector puts on the GPU streams) contributes its `dur`. A trace without
device events (a CPU capture) falls back to its `cpu_op` events, so the
CPU tests run the same code path. Device time is reported two ways: summed
op time (`op_time_s`, counts concurrent streams twice) and merged busy
time (`device_time_s`, the union of intervals — the honest denominator for
MFU on one card).

Also here: the process-wide single-capture guard behind `/debug/profile`
(`try_acquire_capture` / `release_capture` / `capture_owner`), the
capture defaults (`reconfigure_profile` / `profile_defaults`), and the
`start_capture` / `stop_capture` pair the scheduler's profile hook and
`utils/observability.trace_capture` run.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

#: Chrome-trace categories of device work in a torch.profiler export (the
#: older capitalised spellings included).
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset",
                         "Kernel", "Memcpy", "Memset"})


class Trace:
    def __init__(self):
        self.ops: Dict[str, List[float]] = {}
        self.intervals: List[Tuple[float, float]] = []

    # ------------------------------------------------------------- loading

    def load_dir(self, trace_dir: str) -> "Trace":
        for path in find_profile_artifacts(trace_dir):
            with gzip.open(path, "rt") as f:
                self._ingest(json.load(f))
        return self

    def _ingest(self, doc: dict) -> None:
        events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
        picked = [e for e in events if e.get("cat") in DEVICE_CATS]
        if not picked:
            # A CPU capture has no device lanes: its operator events stand
            # in (they nest, so op_time_s counts a parent and its children;
            # device_time_s merges them).
            picked = [e for e in events if e.get("cat") == "cpu_op"]
        for e in picked:
            dur = float(e.get("dur", 0.0)) * 1e-6  # us -> s
            if dur <= 0.0:
                continue
            self.ops.setdefault(e.get("name", "?"), []).append(dur)
            ts = float(e.get("ts", 0.0)) * 1e-6
            self.intervals.append((ts, ts + dur))

    # ------------------------------------------------------------ queries

    def op_time_s(self) -> float:
        """Summed op durations (concurrent streams double-count)."""
        return sum(sum(v) for v in self.ops.values())

    def device_time_s(self) -> float:
        """Union of op intervals — device busy wall-clock."""
        if not self.intervals:
            return 0.0
        merged = 0.0
        cur_a, cur_b = None, None
        for a, b in sorted(self.intervals):
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    merged += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        merged += cur_b - cur_a
        return merged

    def span_s(self) -> float:
        """First op start to last op end."""
        if not self.intervals:
            return 0.0
        return max(b for _, b in self.intervals) - min(a for a, _ in self.intervals)

    def busy_share(self) -> float:
        """device_time_s / span_s: the share of the captured span in which
        the device ran something (0.0 for an empty trace)."""
        span = self.span_s()
        return self.device_time_s() / span if span > 0 else 0.0

    def top_ops(self, n: int = 10) -> List[Tuple[str, float, int]]:
        rows = [
            (name, sum(durs), len(durs)) for name, durs in self.ops.items()
        ]
        rows.sort(key=lambda r: -r[1])
        return rows[:n]


# ---------------------------------------------------------------------------
# On-demand device profiling (/debug/profile): the fleet-wide single-capture
# guard + app-configured defaults. One profiler session runs at a time per
# process, and a capture is expensive enough that two overlapping ones
# would corrupt each other's artifacts — so schedulers (every replica, every
# model) funnel through this process-wide guard: at most one capture in
# flight, whoever holds it releases on finish/abort.

_capture_lock = threading.Lock()
_capture_owner: Optional[str] = None

#: App-startup overrides (AppConfig.profile_dir / profile_rounds via
#: `reconfigure_profile`); env fallbacks LSOT_PROFILE_DIR /
#: LSOT_PROFILE_ROUNDS keep the knobs usable without the app wiring.
_profile_dir_override: Optional[str] = None
_profile_rounds_override: Optional[int] = None


def reconfigure_profile(profile_dir: Optional[str] = None,
                        rounds: Optional[int] = None) -> None:
    """App-startup wiring seam (AppConfig.profile_dir/profile_rounds) —
    same pattern as `tracing.TRACER.reconfigure`, so the AppConfig knobs
    are honored, not silent no-ops."""
    global _profile_dir_override, _profile_rounds_override
    _profile_dir_override = profile_dir or None
    _profile_rounds_override = int(rounds) if rounds else None


def profile_defaults() -> Tuple[Optional[str], int]:
    """(artifact base dir or None, default rounds) for an on-demand
    capture. Dir precedence: reconfigure_profile > LSOT_PROFILE_DIR >
    the tracer's export dir (the capture lands NEXT TO the existing
    per-request trace exports) > None (caller tempdirs)."""
    d = _profile_dir_override or os.environ.get("LSOT_PROFILE_DIR") or None
    if not d:
        from .tracing import TRACER

        d = TRACER.export_dir or None
    if _profile_rounds_override:
        return d, _profile_rounds_override
    try:
        n = int(os.environ.get("LSOT_PROFILE_ROUNDS", "8"))
    except ValueError:
        n = 8
    return d, max(1, n)


def try_acquire_capture(owner: str) -> bool:
    """Claim the process-wide capture slot; False when someone holds it
    (the /debug/profile 409)."""
    global _capture_owner
    with _capture_lock:
        if _capture_owner is not None:
            return False
        _capture_owner = owner
        return True


def release_capture(owner: str) -> None:
    """Release the slot (idempotent; only the owner's release counts, so
    a late abort cannot free a successor's capture)."""
    global _capture_owner
    with _capture_lock:
        if _capture_owner == owner:
            _capture_owner = None


def capture_owner() -> Optional[str]:
    with _capture_lock:
        return _capture_owner


def find_profile_artifacts(trace_dir: str) -> List[str]:
    """The Chrome-trace artifacts a capture wrote under `trace_dir` (the
    same *.trace.json.gz files `Trace.load_dir` parses)."""
    return sorted(glob.glob(
        os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True
    ))


# ------------------------------------------------------------ the profiler


def start_capture(cuda: bool):
    """Start a torch.profiler session: CUDA activity (the kernels and
    copies on the card's streams) when `cuda`, else CPU activity (the
    operators, for a scheduler on the CPU). Returns the session for
    `stop_capture`."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])
    prof.start()
    return prof


def stop_capture(prof, trace_dir: str) -> str:
    """Stop the session and write its Chrome trace, gzipped, as
    `trace_dir/lsot.<pid>.<ms>.trace.json.gz`; returns the path."""
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"lsot.{os.getpid()}."
                                   f"{int(time.time() * 1000)}.trace.json.gz")
    fd, raw = tempfile.mkstemp(suffix=".json", dir=trace_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(raw)
        with open(raw, "rb") as src, gzip.open(path, "wb") as dst:
            shutil.copyfileobj(src, dst)
    finally:
        os.unlink(raw)
    return path


def cuda_in_use() -> bool:
    """Has this process initialised a card (whose kernels a capture should
    record)?"""
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None, cuda: Optional[bool] = None):
    """Profile the enclosed region; yields a Trace filled on exit. `cuda`
    defaults to whether the process has initialised a card."""
    tr = Trace()
    own = trace_dir is None
    d = trace_dir or tempfile.mkdtemp(prefix="lsot_trace_")
    try:
        prof = start_capture(cuda_in_use() if cuda is None else cuda)
        try:
            yield tr
        finally:
            stop_capture(prof, d)
        tr.load_dir(d)
    finally:
        if own:
            shutil.rmtree(d, ignore_errors=True)

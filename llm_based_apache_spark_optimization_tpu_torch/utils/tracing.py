"""Request-scoped tracing: span trees, head sampling, Chrome-trace export.

The serving stack's existing instruments are all *aggregates* —
`MetricsRegistry` windowed percentiles, flat `CounterSet`s, the watchdog's
heartbeat. None of them can answer "where did THIS request's 400 ms go?"
— the question every per-request latency regression, stuck stream, or
deadline burn starts with. This module is the per-request answer:

- `RequestTrace` — one request's span tree. A `request_id` is generated at
  admission (the HTTP layer), echoed in the response (`X-Request-Id` and
  the JSON body) and in the structured request log line, and the trace
  object itself travels with the request: contextvar propagation inside
  the HTTP thread (service → pipeline → SQL backend), explicit
  `submit(trace=...)` across the scheduler's thread boundary (the worker
  thread records queue-wait / prefill / per-decode-round spans into the
  same tree). Spans are recorded with `time.perf_counter()` pairs and
  anchored to wall-clock once per trace, so cross-thread spans line up.
- `Tracer` — head sampling + export. `LSOT_TRACE_SAMPLE` is the sampled
  fraction (0 = off, 1 = every request); an unsampled request costs one
  RNG draw at admission and ZERO span work everywhere else (`span()` on a
  None trace is a no-op context manager — bench's scheduler leg prices
  this). Sampled traces export per request as JSONL
  (`<dir>/requests.jsonl`) and as a per-request Chrome-trace file
  (`<request_id>.trace.json.gz`) that loads in Perfetto AND in
  `utils/traceprof.Trace` (same event model: "X" complete events under
  named thread lanes), and the last few live in an in-memory ring for
  `/debug/traces`.

Span naming convention (dotted stages, one lane per top-level prefix in
the Chrome export): `service.generate`, `sched.queue_wait`,
`sched.prefill`, `sched.decode`, `sched.round` (one per harvested decode
round, with accepted-token / speculation / grammar attrs),
`stream.deliver`, `sql.load`, `sql.exec`, `sql.write_csv`.

Everything is thread-safe: the HTTP thread and the scheduler worker
thread append spans to one trace concurrently.
"""

from __future__ import annotations

import contextlib
import contextvars
import gzip
import itertools
import json
import os
import random
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

__all__ = [
    "RequestTrace",
    "Tracer",
    "TRACER",
    "begin_or_ambient",
    "current",
    "decided",
    "new_request_id",
    "span",
    "stepwise",
    "use",
]

_rid_counter = itertools.count(1)
_rid_base = f"{os.getpid():x}-{int(time.time()) & 0xFFFFFF:x}"


def new_request_id() -> str:
    """Process-unique, sortable-enough request id: pid + boot stamp + a
    monotonic counter. Cheap (no uuid import, no entropy syscall) — it is
    generated for EVERY request, sampled or not, because the id is also
    the log-correlation handle."""
    return f"req-{_rid_base}-{next(_rid_counter):x}"


class RequestTrace:
    """One request's span tree. Flat storage (list of span dicts, each
    carrying its parent's name) — renders as a tree in `to_dict()` and as
    per-lane "X" events in `to_chrome()`. Appends take one small lock, so
    the scheduler worker and the HTTP thread can both record."""

    def __init__(self, request_id: str, model: str = "", attrs: Optional[Dict] = None):
        self.request_id = request_id
        self.model = model
        self.attrs = dict(attrs or {})
        # Anchor: one (wall, perf) pair taken at creation maps every
        # perf_counter stamp — from any thread — onto the wall clock for
        # the Chrome export's absolute `ts` values.
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()
        self._lock = threading.Lock()
        self._spans: List[Dict] = []

    # ------------------------------------------------------------ recording

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Record a completed span from explicit perf_counter stamps —
        the cross-thread path (the scheduler worker stamps floats on the
        request and flushes spans at retire)."""
        rec: Dict = {"name": name, "t0": t0, "t1": t1}
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            self._spans.append(rec)

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_span(name, t0, time.perf_counter(), **attrs)

    def event(self, name: str, **attrs) -> None:
        """Zero-duration marker (rendered as a tiny span)."""
        t = time.perf_counter()
        self.add_span(name, t, t, **attrs)

    # -------------------------------------------------------------- export

    def to_dict(self) -> Dict:
        """JSONL record: spans sorted by start, durations in seconds,
        offsets relative to the trace origin. Dotted names ARE the tree:
        `sched.decode` nests under the request root beside `sql.exec`."""
        with self._lock:
            spans = sorted(self._spans, key=lambda s: s["t0"])
        return {
            "request_id": self.request_id,
            "model": self.model,
            "start_unix": round(self._wall0, 6),
            **({"attrs": self.attrs} if self.attrs else {}),
            "spans": [
                {
                    "name": s["name"],
                    "start_s": round(s["t0"] - self._perf0, 6),
                    "dur_s": round(s["t1"] - s["t0"], 6),
                    **({"attrs": s["attrs"]} if "attrs" in s else {}),
                }
                for s in spans
            ],
        }

    def to_chrome(self) -> Dict:
        """Chrome-trace JSON (Perfetto-loadable), one thread lane per
        top-level span prefix (`sched`, `sql`, `service`, ...). The event
        model matches what `utils/traceprof.Trace._ingest` parses: thread
        name metadata + "X" complete events with microsecond ts/dur —
        so the SAME parser that reads jax.profiler device traces
        round-trips these request traces (the lane names avoid its
        host-lane deny list)."""
        with self._lock:
            spans = sorted(self._spans, key=lambda s: s["t0"])
        lanes: Dict[str, int] = {}
        events: List[Dict] = [{
            "ph": "M", "name": "process_name", "pid": 1,
            "args": {"name": f"request {self.request_id}"},
        }]
        body: List[Dict] = []
        for s in spans:
            prefix = s["name"].split(".", 1)[0]
            tid = lanes.setdefault(prefix, len(lanes) + 1)
            dur_us = max(1.0, (s["t1"] - s["t0"]) * 1e6)  # 0-dur events drop
            body.append({
                "ph": "X", "name": s["name"], "pid": 1, "tid": tid,
                "ts": (self._wall0 + (s["t0"] - self._perf0)) * 1e6,
                "dur": dur_us,
                **({"args": s["attrs"]} if "attrs" in s else {}),
            })
        for prefix, tid in lanes.items():
            events.append({
                "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                "args": {"name": f"lane:{prefix}"},
            })
        events.extend(body)
        return {"traceEvents": events, "displayTimeUnit": "ms"}


class Tracer:
    """Head-sampling trace factory + exporter.

    `begin()` returns a `RequestTrace` for the sampled fraction of
    requests and None otherwise — every downstream `span()` call on None
    is a no-op, which is what makes always-on tracing safe at high QPS.
    `finish()` exports (JSONL append + per-request gzipped Chrome trace
    when an export dir is configured) and keeps the last `ring` traces in
    memory for `/debug/traces`."""

    def __init__(self, sample: Optional[float] = None,
                 export_dir: Optional[str] = None, ring: int = 32,
                 seed: Optional[int] = None):
        if sample is None:
            sample = float(os.environ.get("LSOT_TRACE_SAMPLE", "0") or 0)
        if export_dir is None:
            export_dir = os.environ.get("LSOT_TRACE_EXPORT") or None
        self.sample = min(1.0, max(0.0, sample))
        self.export_dir = export_dir
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._ring: "deque[Dict]" = deque(maxlen=max(1, ring))
        self._exported = 0

    def begin(self, request_id: Optional[str] = None, model: str = "",
              **attrs) -> Optional[RequestTrace]:
        if self.sample <= 0.0:
            return None
        if self.sample < 1.0 and self._rng.random() >= self.sample:
            return None
        return RequestTrace(request_id or new_request_id(), model=model,
                            attrs=attrs)

    def finish(self, trace: Optional[RequestTrace]) -> Optional[Dict]:
        """Export a completed trace; None-safe (the unsampled fast path).
        Export failures are swallowed — tracing must never fail the
        request it is observing."""
        if trace is None:
            return None
        doc = trace.to_dict()
        with self._lock:
            self._ring.append(doc)
            self._exported += 1
            # The shared requests.jsonl append stays under the lock too:
            # the threaded WSGI server finishes traces concurrently, and
            # a doc line longer than one os.write (hundreds of
            # sched.round spans) would otherwise interleave with another
            # thread's line and corrupt the JSONL. Export is sampled and
            # off the request hot path, so holding the lock for the
            # write is cheap. The per-request Chrome file needs no lock
            # (unique path per request_id).
            if self.export_dir:
                try:
                    os.makedirs(self.export_dir, exist_ok=True)
                    path = os.path.join(self.export_dir, "requests.jsonl")
                    with open(path, "a", encoding="utf-8") as f:
                        f.write(json.dumps(doc) + "\n")
                except OSError:
                    pass
        if self.export_dir:
            try:
                chrome = os.path.join(
                    self.export_dir, f"{trace.request_id}.trace.json.gz"
                )
                with gzip.open(chrome, "wt", encoding="utf-8") as f:
                    json.dump(trace.to_chrome(), f)
            except OSError:
                pass
        return doc

    def recent(self, n: Optional[int] = None) -> List[Dict]:
        """Last sampled traces (newest last) for `/debug/traces`."""
        with self._lock:
            out = list(self._ring)
        return out[-n:] if n else out

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "sample": self.sample,
                "export_dir": self.export_dir,
                "exported": self._exported,
                "ring": len(self._ring),
            }

    def reconfigure(self, sample: Optional[float] = None,
                    export_dir: Optional[str] = None) -> None:
        """App-startup wiring seam (LSOT_TRACE_SAMPLE / LSOT_TRACE_EXPORT
        resolve through AppConfig, which may be built after import)."""
        if sample is not None:
            self.sample = min(1.0, max(0.0, float(sample)))
        if export_dir is not None:
            self.export_dir = export_dir or None


#: Process-wide tracer the serving layer begins/finishes requests on.
TRACER = Tracer()

#: The active request's trace within one thread of control (HTTP handler →
#: service → pipeline → SQL backend). The scheduler worker thread is NOT
#: under this contextvar — the trace crosses that boundary explicitly via
#: `submit(trace=...)`.
_CURRENT: "contextvars.ContextVar[object]" = (
    contextvars.ContextVar("lsot_trace", default=None)
)

#: Stored in the contextvar when an upstream layer drew the sampling
#: decision and the answer was "not sampled". Distinct from the default
#: None ("nobody decided yet") so a downstream entry point — the service
#: under the HTTP layer — doesn't re-draw and double the effective
#: sample rate.
_UNSAMPLED = object()


def current() -> Optional[RequestTrace]:
    v = _CURRENT.get()
    return None if v is _UNSAMPLED else v  # type: ignore[return-value]


def decided() -> bool:
    """True when this thread of control already carries a sampling
    decision (sampled trace OR explicit unsampled marker)."""
    return _CURRENT.get() is not None


@contextlib.contextmanager
def use(trace: Optional[RequestTrace]) -> Iterator[Optional[RequestTrace]]:
    """Install `trace` as the thread's current trace for the block.
    None records the decision as made-but-unsampled (see `decided()`)."""
    token = _CURRENT.set(trace if trace is not None else _UNSAMPLED)
    try:
        yield trace
    finally:
        _CURRENT.reset(token)


def begin_or_ambient(request_id: Optional[str] = None,
                     model: str = "") -> tuple:
    """The service entry-point sampling dance (generate/generate_stream):
    honor an upstream decision when one exists (`decided()` — the HTTP
    layer sampled, or explicitly didn't), else head-sample HERE so the
    span tree exists for every entry path, drawn exactly once. Returns
    `(tr, own, rid)`: `tr` is the trace to record into (None when
    unsampled), `own` is non-None only when THIS call drew the sample —
    the caller owns its export (`TRACER.finish(own)`) — and `rid` is the
    effective request id."""
    ambient = current()
    own = TRACER.begin(request_id=request_id, model=model) \
        if not decided() else None
    tr = ambient if ambient is not None else own
    rid = request_id or (tr.request_id if tr is not None else "")
    return tr, own, rid


def stepwise(inner: Iterator, trace: Optional[RequestTrace]) -> Iterator:
    """Yield `inner`'s items, advancing it under `use(trace)` but NEVER
    holding the context across our own yields: generators share the
    thread's context, so a contextvar set held across a yield leaks into
    the consumer's frame between steps — a consumer interleaving two
    sampled streams would record request B's spans into request A's tree
    (and suppress B's own sampling draw). THE shared workaround for the
    generator/contextvar hazard; hand-rolling it is how it regresses."""
    while True:
        with use(trace):
            try:
                item = next(inner)
            except StopIteration:
                return
        yield item


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[None]:
    """Record a span on the current trace; free no-op when unsampled
    (one contextvar read, no perf_counter call)."""
    tr = _CURRENT.get()
    if tr is None or tr is _UNSAMPLED:
        yield
        return
    with tr.span(name, **attrs):
        yield

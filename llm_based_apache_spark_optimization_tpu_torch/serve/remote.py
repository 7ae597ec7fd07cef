"""Partition-tolerant replica transports: the fleet's submit surface when a
pool replica is an address instead of an object.

A `SchedulerPool` replica used to live in this process; this module lets
it live in another one (`python -m …serve.remote`, the worker entry point
at the bottom) without giving up the single-process fleet's determinism:

- **`ReplicaTransport`** is the protocol: the slice of the scheduler
  surface the pool drives — ``submit`` / ``requeue`` / ``cancel`` /
  ``extract_queued`` / ``extract_handoffs`` (a packed KV handoff blob rides
  `requeue`: its numpy pages serialize into the frame) / ``ping`` (the
  lease probe) / ``backlog_score`` / the loads digest — plus lifecycle
  (``start``/``shutdown``) and the ``_crash`` marker the pool's placement
  loop keys failover on.

- **`LoopbackTransport`** wraps an in-process scheduler. With no fault
  spec configured it is a zero-copy delegate — byte for byte the direct
  call, so a loopback fleet is token- and accounting-identical to a
  direct-call fleet. With `LSOT_FAULTS` active it runs the SAME rpc
  envelope as the socket transport (idempotency tokens, retries, breaker,
  the `net:*` chaos sites below), which proves the retry/lease/replay
  logic without a second process.

- **`SocketTransport` / `ReplicaServer`** speak length-prefixed
  msgpack-or-JSON frames over one TCP connection per replica. The remote
  end is a plain `ContinuousBatchingScheduler` served by `ReplicaServer`.
  Tokens stream back as indexed events, so a reconnect mid-stream replays
  nothing and skips nothing. A prefill-role worker PUSHES each packed
  handoff to its client as an event; the pool places it on a decode
  replica.

Robustness contract:

- **Idempotent RPCs.** Every mutating RPC carries the journal rid (0 until
  a scheduler assigns one; the live rid on requeue) plus an idempotency
  token. The receiving side keeps a token ledger: a retried or duplicated
  submit binds to the FIRST execution's future instead of generating
  again — the journal-dedup machinery extended across the wire.
- **Leases, not guesses.** Remote liveness is a per-replica heartbeat
  LEASE: the pool pings each transport every `LSOT_LEASE_S`; after
  `LSOT_LEASE_MISSES` consecutive failures the lease expires, the
  transport is declared unreachable (pending futures fail typed with
  `ReplicaUnreachable`, a `SchedulerCrashed` subclass) and the pool's
  crash notice re-places the journaled work on siblings via the fleet
  replay, delivered prefixes suppressed — a dead host loses no
  acknowledged request.
- **Deadline-propagating timeouts.** submit/requeue RPCs wait at most
  ``min(rpc_timeout_s, deadline remaining)``.
- **Typed wire errors.** Garbage frames, truncated frames and protocol
  version mismatches are refused with `FrameError` / `FrameVersionError`;
  application errors (Overloaded, DeadlineExceeded, …) round-trip as their
  own types, so the pool's shed/failover classification is unchanged
  across the wire.

The wire form is the JAX package's (`PROTOCOL_VERSION` 1): the same
message for the same request encodes to the same bytes in both packages,
so either side's worker serves either side's pool. A handoff blob's arrays
travel as ``{"__nd__": [dtype, shape, bytes]}``; the port's bf16 pages are
exported as their int16 bit patterns (`engine.paged_kv.export_pages`) and
travel under the ``int16`` tag, restored bit for bit by the importer.

Chaos sites (utils/faults.py, consumed at the CLIENT side of both
transports so one seeded schedule drives loopback and socket alike):

- ``net:drop:p`` — the RPC executes on the server but the response is
  lost; the retry must dedup (the no-double-generate proof).
- ``net:dup:p`` — the request is delivered twice; the token ledger must
  absorb the duplicate.
- ``net:delay:p:secs`` — the wire stalls; timeouts/deadlines must fire.
- ``net:partition_r{i}:p`` — ALL I/O to replica r{i} fails (RPCs, token
  streams, lease pings) while configured: the lease-expiry →
  targeted-restart → journal-replay path's trigger.

The worker (``python -m llm_based_apache_spark_optimization_tpu_torch.serve.remote``)
runs on the card and exits without one; ``--cpu`` serves on the CPU.
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import os
import socket
import struct
import threading
import time
import uuid
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..engine.paged_kv import blob_meta
from ..ops.sampling import SamplingParams
from ..utils.faults import FAULTS, InjectedFault
from ..utils.observability import resilience
from .modelpool import UnknownModel
from .resilience import (
    CircuitBreaker,
    CircuitOpen,
    Deadline,
    DeadlineExceeded,
    Draining,
    Overloaded,
    Quarantined,
    RetryPolicy,
    SchedulerCrashed,
    SlotStalled,
)

_log = logging.getLogger("lsot.remote")

__all__ = [
    "FrameDecoder",
    "FrameError",
    "FrameVersionError",
    "LoopbackTransport",
    "PROTOCOL_VERSION",
    "ReplicaServer",
    "ReplicaUnreachable",
    "SocketTransport",
    "TransportError",
    "TransportTimeout",
    "encode_frame",
]

#: Bumped on any incompatible change to the frame or message layout. A
#: mismatched peer is REFUSED typed at the first frame — a silent
#: best-effort parse of a future layout is how fleets corrupt requests.
PROTOCOL_VERSION = 1

_MAGIC = b"LT"
_HDR = struct.Struct(">2sBBI")  # magic, version, encoding, payload length
_ENC_JSON = 0
_ENC_MSGPACK = 1
#: Frame size ceiling: a KV handoff blob for one long request is tens of
#: MB; anything near this is a corrupt length field, not a payload.
_MAX_FRAME = 1 << 30

try:  # optional — the container ships msgpack, but JSON always works
    import msgpack as _msgpack

    HAVE_MSGPACK = True
except Exception:  # pragma: no cover - import guard
    _msgpack = None
    HAVE_MSGPACK = False


def default_encoding() -> int:
    return _ENC_MSGPACK if HAVE_MSGPACK else _ENC_JSON


# ------------------------------------------------------------ typed errors


class TransportError(ConnectionError):
    """One RPC failed at the transport layer (lost frame, dead
    connection, injected net fault). Retryable: the idempotency token
    makes the retry safe."""


class TransportTimeout(TransportError):
    """The RPC's wait budget (min(rpc timeout, deadline remaining))
    expired before a response arrived."""


class FrameError(ValueError):
    """A frame failed to parse: bad magic, truncated payload, oversize
    length field, or undecodable body. The connection is poisoned — the
    peer and this side no longer agree where frames start."""


class FrameVersionError(FrameError):
    """The peer speaks a different protocol version. Refused outright:
    guessing at a future layout silently corrupts requests."""


class ReplicaUnreachable(SchedulerCrashed):
    """Retries exhausted / lease expired / breaker open on a replica
    transport: the replica is declared gone. Subclasses SchedulerCrashed
    so the supervisor's fleet-replay path re-places the journaled work
    on siblings exactly like an in-process replica crash."""


# ----------------------------------------------------------- frame codec


def _pack_wire(obj, binary_ok: bool):
    """Recursively encode ndarrays (and, for JSON, raw bytes) into
    tagged JSON-safe dicts. msgpack carries bytes natively; JSON rides
    base64 — the "msgpack-or-JSON" contract costs only this shim."""
    if isinstance(obj, np.ndarray):
        return {"__nd__": [str(obj.dtype), list(obj.shape),
                           _pack_wire(obj.tobytes(), binary_ok)]}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, bytes):
        return obj if binary_ok else {"__b64__":
                                      base64.b64encode(obj).decode()}
    if isinstance(obj, dict):
        return {str(k): _pack_wire(v, binary_ok) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_pack_wire(v, binary_ok) for v in obj]
    return obj


def _unpack_wire(obj):
    if isinstance(obj, dict):
        if "__b64__" in obj and len(obj) == 1:
            return base64.b64decode(obj["__b64__"])
        if "__nd__" in obj and len(obj) == 1:
            dtype, shape, data = obj["__nd__"]
            raw = _unpack_wire(data)
            return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(
                [int(s) for s in shape]
            ).copy()
        return {k: _unpack_wire(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack_wire(v) for v in obj]
    return obj


def encode_frame(obj: Dict, encoding: Optional[int] = None) -> bytes:
    """One message -> one length-prefixed frame:
    ``LT | version | encoding | len(payload) | payload``."""
    enc = default_encoding() if encoding is None else int(encoding)
    wire = _pack_wire(obj, binary_ok=enc == _ENC_MSGPACK)
    if enc == _ENC_MSGPACK:
        if not HAVE_MSGPACK:
            raise FrameError("msgpack encoding requested but unavailable")
        payload = _msgpack.packb(wire, use_bin_type=True)
    elif enc == _ENC_JSON:
        payload = json.dumps(wire, separators=(",", ":")).encode()
    else:
        raise FrameError(f"unknown frame encoding {enc}")
    if len(payload) > _MAX_FRAME:
        raise FrameError(f"frame payload {len(payload)}B exceeds the "
                         f"{_MAX_FRAME}B ceiling")
    return _HDR.pack(_MAGIC, PROTOCOL_VERSION, enc, len(payload)) + payload


class FrameDecoder:
    """Incremental frame parser over a byte stream. ``feed(data)``
    returns the complete messages the new bytes finished; ``eof()``
    raises typed if the stream ended mid-frame. Garbage magic, a
    mismatched version and an oversize/undecodable payload all raise
    typed — the connection must be torn down, not resynchronized."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Dict]:
        self._buf.extend(data)
        out: List[Dict] = []
        while True:
            if len(self._buf) < _HDR.size:
                return out
            magic, ver, enc, n = _HDR.unpack_from(self._buf)
            if magic != _MAGIC:
                raise FrameError(
                    f"bad frame magic {bytes(magic)!r} (expected {_MAGIC!r})"
                )
            if ver != PROTOCOL_VERSION:
                raise FrameVersionError(
                    f"peer speaks transport protocol v{ver}, this side "
                    f"v{PROTOCOL_VERSION} — refusing to guess at the layout"
                )
            if n > _MAX_FRAME:
                raise FrameError(f"frame length {n}B exceeds the "
                                 f"{_MAX_FRAME}B ceiling (corrupt header?)")
            if len(self._buf) < _HDR.size + n:
                return out
            payload = bytes(self._buf[_HDR.size:_HDR.size + n])
            del self._buf[:_HDR.size + n]
            try:
                if enc == _ENC_MSGPACK:
                    if not HAVE_MSGPACK:
                        raise FrameError("peer sent msgpack frames but "
                                         "msgpack is unavailable here")
                    msg = _msgpack.unpackb(payload, raw=False,
                                           strict_map_key=False)
                elif enc == _ENC_JSON:
                    msg = json.loads(payload.decode())
                else:
                    raise FrameError(f"unknown frame encoding {enc}")
            except FrameError:
                raise
            except Exception as e:  # noqa: BLE001 — any parse failure is typed
                raise FrameError(f"undecodable frame payload: {e}") from None
            if not isinstance(msg, dict):
                raise FrameError(
                    f"frame decoded to {type(msg).__name__}, messages must "
                    f"be objects"
                )
            out.append(_unpack_wire(msg))

    def eof(self) -> None:
        if self._buf:
            raise FrameError(
                f"stream ended mid-frame with {len(self._buf)} buffered "
                f"byte(s) — truncated frame"
            )


# ------------------------------------------------------ typed error codec

#: Error types that round-trip the wire AS THEMSELVES, so the pool's
#: shed/failover/deadline classification is transport-blind.
_ERR_TYPES = {
    "Overloaded": Overloaded,
    "Draining": Draining,
    "DeadlineExceeded": DeadlineExceeded,
    "SlotStalled": SlotStalled,
    "SchedulerCrashed": SchedulerCrashed,
    "ReplicaUnreachable": ReplicaUnreachable,
    "Quarantined": Quarantined,
    "CircuitOpen": CircuitOpen,
    "UnknownModel": UnknownModel,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
}


def _encode_error(exc: BaseException) -> Dict:
    name = type(exc).__name__
    if name not in _ERR_TYPES:
        # Nearest wire-known ancestor keeps the classification (e.g. a
        # SchedulerStalled crosses as SchedulerCrashed).
        for cand, cls in _ERR_TYPES.items():
            if isinstance(exc, cls):
                name = cand
                break
        else:
            name = "RuntimeError"
    out: Dict = {"type": name, "msg": str(exc)[:500]}
    ra = getattr(exc, "retry_after_s", None)
    if ra is not None:
        out["retry_after_s"] = float(ra)
    return out


def _decode_error(d: Dict) -> BaseException:
    cls = _ERR_TYPES.get(str(d.get("type")), RuntimeError)
    msg = str(d.get("msg", "remote error"))
    if "retry_after_s" in d and issubclass(cls, (Overloaded, CircuitOpen)):
        return cls(msg, retry_after_s=float(d["retry_after_s"]))
    return cls(msg)


# ------------------------------------------------- request (de)serialization


def _sampling_to_wire(sampling: SamplingParams) -> Dict:
    return {"t": float(sampling.temperature), "p": float(sampling.top_p),
            "k": int(sampling.top_k)}


def _sampling_from_wire(d: Optional[Dict]) -> SamplingParams:
    if not d:
        return SamplingParams()
    return SamplingParams(temperature=float(d.get("t", 0.0)),
                          top_p=float(d.get("p", 1.0)),
                          top_k=int(d.get("k", 0)))


def _constraint_spec(constraint) -> Optional[object]:
    """The serializable twin of a compiled constraint (`wire_spec` is
    stamped by constrain.get_constraint). A raw pre-compiled CompiledMask
    without one cannot cross the wire — tables are device-sized."""
    if constraint is None:
        return None
    spec = getattr(constraint, "wire_spec", None)
    if spec is None:
        raise ValueError(
            "constrained request has no serializable spec "
            "(a raw CompiledMask cannot cross a replica transport — "
            "submit the grammar name/schema dict instead)"
        )
    return spec


def request_to_wire(req) -> Dict:
    """Serialize a scheduler `_Request` for requeue/extract RPCs —
    including the KV handoff blob (`spilled` pages + scales) and
    the deterministic-resume state (rng_count, resume_pref, committed
    tokens), so a migrated request decodes bit-identically remotely."""
    d: Dict = {
        "rid": int(req.rid),
        "ids": [int(t) for t in req.ids],
        "max_new": int(req.max_new),
        "sampling": {"t": float(req.temperature), "p": float(req.top_p),
                     "k": int(req.top_k)},
        "seed": int(req.seed),
        "generated": [int(t) for t in req.generated],
        "resume_pref": int(req.resume_pref),
        "rng_count": int(req.rng_count),
        "preempted": int(req.preempted),
        "cancelled": bool(req.cancelled),
    }
    if req.deadline is not None:
        d["deadline_s"] = max(0.001, float(req.deadline.remaining()))
    if getattr(req, "model_id", ""):
        # Multi-model fleets: a migrated request's KV pages
        # are model-specific — the receiving side re-checks the id.
        d["model_id"] = str(req.model_id)
    if getattr(req, "tenant", ""):
        # Tenant axis: migrated/requeued requests keep their
        # attribution so the receiving replica's WFQ charges the right
        # tenant. Optional on the wire — old workers ignore it.
        d["tenant"] = str(req.tenant)
    if getattr(req, "qos", ""):
        d["qos"] = str(req.qos)
    if req.constraint is not None:
        d["constrain"] = _constraint_spec(req.constraint)
    if req.spilled is not None:
        d["spilled"] = [np.asarray(a) for a in req.spilled]
    if req.handoff is not None:
        d["handoff"] = {k: v for k, v in req.handoff.items()
                        if isinstance(v, (int, float, str, bool))}
    return d


def request_from_wire(d: Dict, future: Optional[Future] = None,
                      on_token: Optional[Callable[[int], None]] = None,
                      constraint_resolver: Optional[Callable] = None):
    """Rebuild a `_Request` from its wire form. `future`/`on_token`
    bind the rebuilt request to the side that owns the client."""
    from .scheduler import _Request

    constraint = None
    spec = d.get("constrain")
    if spec is not None:
        if constraint_resolver is None:
            raise ValueError(
                "constrained request arrived but this side has no "
                "constraint resolver"
            )
        constraint = constraint_resolver(spec)
    sp = _sampling_from_wire(d.get("sampling"))
    req = _Request(
        ids=[int(t) for t in d["ids"]], max_new=int(d["max_new"]),
        temperature=sp.temperature, top_p=sp.top_p, top_k=sp.top_k,
        seed=int(d.get("seed", 0)),
        future=future if future is not None else Future(),
        on_token=on_token, constraint=constraint,
        deadline=(Deadline.after(float(d["deadline_s"]))
                  if d.get("deadline_s") else None),
    )
    req.rid = int(d.get("rid", 0))
    req.model_id = str(d.get("model_id", "") or "")
    req.tenant = str(d.get("tenant", "") or "")
    req.qos = str(d.get("qos", "") or "")
    req.generated = [int(t) for t in d.get("generated", [])]
    req.resume_pref = int(d.get("resume_pref", 0))
    req.rng_count = int(d.get("rng_count", 0))
    req.preempted = int(d.get("preempted", 0))
    req.cancelled = bool(d.get("cancelled", False))
    if d.get("spilled") is not None:
        req.spilled = tuple(np.asarray(a) for a in d["spilled"])
    if d.get("handoff") is not None:
        req.handoff = dict(d["handoff"])
    req.future._lsot_request = req
    return req


# ---------------------------------------------------------------- plumbing


class _TransportStats:
    """Per-endpoint RPC counters + transport lifecycle counters, read by
    `replica_loads()["transport"]` and the lsot_transport_* Prometheus
    families. Lock-guarded: RPCs bump from submit threads, the lease
    monitor bumps from its own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ops: Dict[str, Dict[str, int]] = {}
        self.lease_misses = 0
        self.lease_expiries = 0
        self.reconnects = 0

    def bump(self, op: str, field: str = "rpcs", n: int = 1) -> None:
        with self._lock:
            rec = self._ops.setdefault(
                op, {"rpcs": 0, "retries": 0, "timeouts": 0, "errors": 0}
            )
            rec[field] = rec.get(field, 0) + n

    def bump_lease(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def reset_lease_misses(self) -> None:
        with self._lock:
            self.lease_misses = 0

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "endpoints": {op: dict(rec)
                              for op, rec in sorted(self._ops.items())},
                "lease_misses": self.lease_misses,
                "lease_expiries": self.lease_expiries,
                "reconnects": self.reconnects,
            }


class _InFlight:
    """In-progress marker a token holds in the ledger while its first
    execution runs: duplicates park on the event instead of executing."""

    __slots__ = ("event",)

    def __init__(self):
        self.event = threading.Event()


class _TokenLedger:
    """Idempotency dedup at the RECEIVING side of a transport: token →
    first execution's result. A retried or duplicated RPC with a known
    token binds to the original execution instead of executing again —
    the no-double-generate guarantee. SINGLE-FLIGHT even mid-execution:
    the first caller registers an in-flight marker under the lock
    before running, so a duplicate delivery that arrives while the
    original is still executing (a reconnect retry racing a slow
    submit) parks on the marker instead of executing a second time.
    A failed execution unregisters, so a later retry may run afresh.
    Bounded LRU: resolved entries only matter for the retry window."""

    def __init__(self, cap: int = 1024):
        self._lock = threading.Lock()
        self._cap = int(cap)
        self._entries: "OrderedDict[str, object]" = OrderedDict()

    def get_or_run(self, token: Optional[str], run: Callable[[], object]
                   ) -> Tuple[object, bool]:
        """(value, fresh). token=None always runs."""
        if token is None:
            return run(), True
        while True:
            with self._lock:
                cur = self._entries.get(token)
                if cur is None:
                    marker = _InFlight()
                    self._entries[token] = marker
                    self._entries.move_to_end(token)
                    break
                self._entries.move_to_end(token)
                if not isinstance(cur, _InFlight):
                    return cur, False
                marker = cur
            # Someone else is executing this token right now: wait for
            # their outcome, then re-read (published value, or a cleared
            # slot after a failure — in which case this delivery runs).
            marker.event.wait()
            continue
        try:
            val = run()  # outside the lock: submit can block on admission
        except BaseException:
            with self._lock:
                if self._entries.get(token) is marker:
                    del self._entries[token]
            marker.event.set()
            raise
        with self._lock:
            if self._entries.get(token) is marker:
                self._entries[token] = val
            while len(self._entries) > self._cap:
                old_tok, old = self._entries.popitem(last=False)
                if isinstance(old, _InFlight):
                    # Never evict an in-flight marker: its owner's
                    # publish-by-identity check would miss and a dup
                    # could re-run. Re-insert at MRU instead.
                    self._entries[old_tok] = old
                    break
        marker.event.set()
        return val, True


def _rpc_timeout_default() -> float:
    return float(os.environ.get("LSOT_RPC_TIMEOUT_S", "10"))


def _retry_default() -> RetryPolicy:
    return RetryPolicy(
        max_attempts=int(os.environ.get("LSOT_RPC_RETRIES", "3")),
        base_delay_s=0.02, max_delay_s=0.5,
    )


class _TransportBase:
    """The client-side rpc envelope shared by both transports: net chaos
    sites, deadline-propagating timeouts, RetryPolicy with the
    breaker per remote endpoint, unreachable declaration. Subclasses
    provide `_execute(op, run_once, timeout)`-style callables via
    `_call`."""

    label: str = "r0"
    kind: str = "transport"
    #: The pool's lease monitor probes any replica exposing this.
    supports_lease = True

    def _init_transport(self, label: str, retry_policy=None, breaker=None,
                        rpc_timeout_s: Optional[float] = None, rng=None,
                        sleep: Callable[[float], None] = time.sleep):
        import random as _random

        self.label = label
        self._stats = _TransportStats()
        self._retry = retry_policy or _retry_default()
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            f"transport:{label}", failure_threshold=8, reset_after_s=5.0,
        )
        self._rpc_timeout_s = (rpc_timeout_s if rpc_timeout_s is not None
                               else _rpc_timeout_default())
        self._rng = rng if rng is not None else _random.Random()
        self._sleep = sleep
        self._unreachable: Optional[ReplicaUnreachable] = None
        self._pending_lock = threading.Lock()
        self._pending: Dict[str, Future] = {}
        self._tok_prefix = uuid.uuid4().hex[:8]
        self._tok_seq = 0
        self._partition_site = f"net:partition_{label}"

    # ---- idempotency tokens

    def _next_token(self) -> str:
        with self._pending_lock:
            self._tok_seq += 1
            return f"{self._tok_prefix}:{self._tok_seq}"

    # ---- reachability

    @property
    def _crash(self):
        return self._unreachable

    def transport_stats(self) -> Dict[str, object]:
        out = self._stats.snapshot()
        out["kind"] = self.kind
        out["unreachable"] = self._unreachable is not None
        return out

    def mark_unreachable(self, reason: object) -> Optional[ReplicaUnreachable]:
        """Declare the replica gone (lease expiry / retries exhausted):
        set the crash marker the pool's placement loop keys failover on
        and fail every pending client future typed — the supervisor's
        journal re-places them on siblings with delivered prefixes
        suppressed. Idempotent; returns the crash error."""
        if self._unreachable is not None:
            return self._unreachable
        exc = (reason if isinstance(reason, ReplicaUnreachable)
               else ReplicaUnreachable(
                   f"replica {self.label} unreachable: {reason}"))
        # Order matters: the marker stops token delivery BEFORE the
        # futures fail, so a zombie stream cannot append past the
        # suppression snapshot the replay takes.
        self._unreachable = exc
        self._stats.bump_lease("lease_expiries")
        resilience.inc("transport_unreachable")
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for fut in pending:
            try:
                fut.set_exception(exc)
            except InvalidStateError:
                pass
        _log.warning("replica %s declared unreachable: %s", self.label,
                     reason)
        return exc

    def lease_ok(self) -> None:
        self._stats.reset_lease_misses()

    def lease_miss(self) -> int:
        self._stats.bump_lease("lease_misses")
        return self._stats.snapshot()["lease_misses"]

    # ---- the rpc envelope

    def _net_gate(self, op: str, budget: Optional[float]) -> None:
        """Client-side chaos consultation, shared by loopback and socket
        so one seeded schedule drives both. Partition → the I/O fails
        without reaching the server; delay → the wire stalls (a stall
        past the budget is a typed timeout, like a real slow link)."""
        try:
            FAULTS.check(self._partition_site)
        except InjectedFault as e:
            raise TransportError(str(e)) from None
        delay = FAULTS.value("net:delay")
        if delay is not None:
            if budget is not None and delay >= budget:
                self._sleep(budget)
                self._stats.bump(op, "timeouts")
                raise TransportTimeout(
                    f"{op} rpc to {self.label} timed out after "
                    f"{budget:.3f}s (injected delay {delay:.3f}s)"
                )
            self._sleep(delay)

    def _rpc_budget(self, deadline_s: Optional[float]) -> Optional[float]:
        if deadline_s is None:
            return self._rpc_timeout_s
        if self._rpc_timeout_s is None:
            return float(deadline_s)
        return min(float(deadline_s), self._rpc_timeout_s)

    def _call(self, op: str, run_once: Callable[[], object],
              deadline_s: Optional[float] = None):
        """Run one logical RPC under the envelope: breaker guard, net
        chaos, retries with full jitter, unreachable declaration at
        exhaustion. `run_once` performs the server-side half ONCE per
        delivery — dedup against retries/dups is the callee's token
        ledger, so calling it again never double-executes."""
        if self._unreachable is not None:
            raise self._unreachable
        if not self._breaker.allow():
            # The endpoint's breaker opened on consecutive transport
            # failures: the replica is effectively gone — declare it so
            # the lease/restart machinery owns recovery instead of every
            # submit burning the retry ladder.
            raise self.mark_unreachable("endpoint circuit breaker open")
        budget = self._rpc_budget(deadline_s)
        last: Optional[BaseException] = None
        for attempt in range(max(1, self._retry.max_attempts)):
            if attempt:
                self._stats.bump(op, "retries")
                resilience.inc("transport_retries")
                self._sleep(self._retry.delay_s(attempt - 1, self._rng))
            self._stats.bump(op)
            try:
                self._net_gate(op, budget)
                result = run_once()
                if FAULTS.fires("net:dup"):
                    # The request was delivered twice: the second
                    # delivery must hit the token ledger and execute
                    # nothing.
                    run_once()
                if FAULTS.fires("net:drop"):
                    # Executed server-side, response lost on the wire:
                    # the retry re-delivers the SAME token and must bind
                    # to the first execution.
                    raise TransportError(
                        f"{op} response to {self.label} lost (net:drop)"
                    )
                self._breaker.record_success()
                return result
            except TransportError as e:
                self._breaker.record_failure()
                self._stats.bump(op, "errors")
                last = e
                continue
        raise self.mark_unreachable(
            f"{op} rpc failed after {self._retry.max_attempts} attempts: "
            f"{last}"
        )


# ---------------------------------------------------------------- loopback


class LoopbackTransport(_TransportBase):
    """The in-process transport: wraps a scheduler (or any duck-typed
    replica) and delegates. With no fault spec configured every call is
    the direct call — bit-identical outputs AND accounting — while
    attribute reads (`flight`, `heartbeat`, `page_stats`, …) always
    pass straight through, so a loopback fleet's observability is the
    direct fleet's. With `LSOT_FAULTS` active, mutating calls run the
    full rpc envelope (tokens, retries, breaker, net sites) against the
    inner scheduler as the "server" — the chaos stage's determinism
    harness."""

    kind = "loopback"

    def __init__(self, scheduler, label: str = "r0", retry_policy=None,
                 breaker=None, rpc_timeout_s: Optional[float] = None,
                 rng=None, sleep: Callable[[float], None] = time.sleep):
        self.inner = scheduler
        self._init_transport(label, retry_policy, breaker, rpc_timeout_s,
                             rng, sleep)
        self._ledger = _TokenLedger()

    @property
    def supports_qos(self):
        """Tenant/qos passthrough: a loopback replica is as
        QoS-capable as the scheduler it wraps — duck-typed fakes in the
        chaos/test fleets never see the kwargs."""
        return bool(getattr(self.inner, "supports_qos", False))

    # Everything the pool/supervisor reads duck-typed passes through —
    # the transport is an address, not a filter.
    def __getattr__(self, name):
        return getattr(self.inner, name)

    @property
    def _crash(self):
        # The transport's own unreachable marker OR the inner loop's
        # crash: the pool's placement loop reads one attribute either way.
        return self._unreachable or getattr(self.inner, "_crash", None)

    @property
    def on_handoff(self):
        return getattr(self.inner, "on_handoff", None)

    @on_handoff.setter
    def on_handoff(self, cb):
        # The pool wires its handoff pump onto prefill-role replicas by
        # assignment; forward it to the scheduler that actually packs.
        self.inner.on_handoff = cb

    def start(self):
        self.inner.start()
        return self

    def shutdown(self, timeout: Optional[float] = None) -> None:
        try:
            self.inner.shutdown(timeout=timeout)
        except TypeError:
            self.inner.shutdown()
        self._breaker.unregister()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    # ---- lease probe

    def ping(self, timeout: Optional[float] = None) -> Dict[str, object]:
        self._stats.bump("ping")
        if self._unreachable is not None:
            raise self._unreachable
        if FAULTS.active:
            try:
                FAULTS.check(self._partition_site)
            except InjectedFault as e:
                raise TransportError(str(e)) from None
        crash = getattr(self.inner, "_crash", None)
        if crash is not None:
            raise TransportError(f"replica loop crashed: {crash}")
        return {"ok": True}

    # ---- protocol surface

    def submit(self, ids, max_new_tokens: int = 256,
               sampling: SamplingParams = SamplingParams(), seed: int = 0,
               on_token=None, constraint=None, deadline_s=None, trace=None,
               model_id: str = "", tenant: str = "", qos: str = ""):
        if self._unreachable is not None:
            raise self._unreachable
        extra = {"model_id": model_id} if model_id else {}
        if (tenant or qos) and getattr(self.inner, "supports_qos", False):
            extra["tenant"] = tenant
            extra["qos"] = qos
        if not FAULTS.active:
            # Fast path: the direct call, byte for byte (same future
            # object, same accounting). The envelope exists for chaos
            # and for real wires; a healthy loopback pays one counter.
            self._stats.bump("submit")
            return self.inner.submit(
                ids, max_new_tokens=max_new_tokens, sampling=sampling,
                seed=seed, on_token=on_token, constraint=constraint,
                deadline_s=deadline_s, trace=trace, **extra,
            )
        token = self._next_token()
        gate = self._gate_on_token(on_token)

        def run_once():
            def execute():
                inner_fut = self.inner.submit(
                    ids, max_new_tokens=max_new_tokens, sampling=sampling,
                    seed=seed, on_token=gate, constraint=constraint,
                    deadline_s=deadline_s, trace=trace, **extra,
                )
                return self._chain(token, inner_fut)

            fut, _fresh = self._ledger.get_or_run(token, execute)
            return fut

        return self._call("submit", run_once, deadline_s=deadline_s)

    def requeue(self, req) -> None:
        if self._unreachable is not None:
            raise self._unreachable
        if not FAULTS.active:
            self._stats.bump("requeue")
            return self.inner.requeue(req)
        token = self._next_token()

        def run_once():
            def execute():
                self.inner.requeue(req)
                return True

            try:
                self._ledger.get_or_run(token, execute)
            except ValueError:
                # Incompatibility (blob page size / contiguous pool) is
                # an application answer, not a transport failure: the
                # pool's placement tries the next sibling.
                raise
            return None

        rem = (req.deadline.remaining()
               if getattr(req, "deadline", None) is not None else None)
        return self._call("requeue", run_once, deadline_s=rem)

    def cancel(self, future) -> None:
        self._stats.bump("cancel")
        from .scheduler import ContinuousBatchingScheduler

        ContinuousBatchingScheduler.cancel(future)

    def extract_queued(self):
        self._stats.bump("extract_queued")
        fn = getattr(self.inner, "extract_queued", None)
        return fn() if callable(fn) else []

    def extract_handoffs(self):
        self._stats.bump("extract_handoffs")
        fn = getattr(self.inner, "extract_handoffs", None)
        return fn() if callable(fn) else []

    # ---- envelope helpers

    def _gate_on_token(self, on_token):
        """Streaming under chaos: a partitioned replica's token stream
        is blackholed (a real wire would not deliver), and a declared-
        unreachable replica's zombie stream must not reach the client —
        the supervisor's replay owns delivery from that point."""
        if on_token is None:
            return None

        def gate(tok: int) -> None:
            if self._unreachable is not None:
                return
            if FAULTS.site_active(self._partition_site):
                return
            on_token(tok)

        return gate

    def _chain(self, token: str, inner_fut: Future) -> Future:
        """A separate client-side future chained from the scheduler's:
        under chaos the transport may fail the client side typed
        (unreachable) while the inner scheduler later resolves its own
        future — two owners need two futures (the scheduler's worker
        would crash setting a result on an already-failed future)."""
        client: Future = Future()
        for a in ("_lsot_request", "_lsot_replica"):
            v = getattr(inner_fut, a, None)
            if v is not None:
                setattr(client, a, v)
        with self._pending_lock:
            self._pending[token] = client

        def done(f: Future, c=client, tok=token):
            with self._pending_lock:
                self._pending.pop(tok, None)
            for a in ("_lsot_queue_wait", "_lsot_replica"):
                v = getattr(f, a, None)
                if v is not None:
                    setattr(c, a, v)
            try:
                exc = f.exception()
                if exc is None:
                    c.set_result(f.result())
                else:
                    c.set_exception(exc)
            except InvalidStateError:
                pass  # already failed typed by mark_unreachable

        inner_fut.add_done_callback(done)
        return client


# ------------------------------------------------------------------ socket


def _parse_address(address) -> Tuple[str, int]:
    if isinstance(address, (tuple, list)):
        return str(address[0]), int(address[1])
    host, _, port = str(address).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad replica address {address!r} "
                         f"(want host:port)")
    return host, int(port)


def describe_scheduler(sched) -> Dict[str, object]:
    """The static half of the hello exchange: everything the pool's
    admission arithmetic reads off a replica, shipped once at connect."""
    import dataclasses as _dc

    cfg = getattr(sched, "cfg", None)
    cfg_wire: Dict[str, object] = {}
    if cfg is not None and _dc.is_dataclass(cfg):
        for f in _dc.fields(cfg):
            v = getattr(cfg, f.name)
            if isinstance(v, (int, float, str, bool)) or v is None:
                cfg_wire[f.name] = v
            elif isinstance(v, tuple) and all(
                    isinstance(x, (int, float, str)) for x in v):
                cfg_wire[f.name] = list(v)
    return {
        "version": PROTOCOL_VERSION,
        "cfg": cfg_wire,
        "max_seq": int(getattr(sched, "max_seq", 0)),
        "decode_chunk": int(getattr(sched, "decode_chunk", 1)),
        "prompt_bucket": int(getattr(sched, "prompt_bucket", 0)),
        "num_slots": int(getattr(sched, "num_slots", 0)),
        "stop_ids": [int(t) for t in (getattr(sched, "stop_ids", ()) or ())],
        "spec_draft": int(getattr(sched, "_spec_draft", 0)),
        "harvest_lag": int(getattr(sched, "_harvest_lag", 0)),
        "overshoot": int(getattr(sched, "overshoot", 0)),
        "phase_role": str(getattr(sched, "phase_role", "mixed") or "mixed"),
        "model_id": str(getattr(sched, "model_id", "") or ""),
        "pblock": int(getattr(sched, "_pblock", 0) or 0),
        "page_size": int(getattr(sched, "_page_size", 0) or 0),
        "paged": bool(getattr(sched, "_paged", False)),
    }


def loads_digest_for(sched) -> Dict[str, object]:
    """The live half (piggybacked on pings and submit acks): the load /
    residency / pressure numbers the pool's router and `replica_loads()`
    consume — a remote replica feeds the same placement signals as a
    local one, over the wire instead of attribute reads."""
    secs, toks = 0.0, 0
    fn = getattr(sched, "backlog_score", None)
    if callable(fn):
        try:
            secs, toks = fn()
        except Exception:  # noqa: BLE001 — a dying replica mid-read
            pass
    q = getattr(sched, "_queue", None)
    slot_req = getattr(sched, "_slot_req", None) or []
    out: Dict[str, object] = {
        "backlog": [float(secs), int(toks)],
        "queued": int(q.qsize()) if q is not None else 0,
        "active_slots": sum(1 for r in slot_req if r is not None),
        "crashed": getattr(sched, "_crash", None) is not None,
        # Per-model throughput attribution across the wire:
        # the pool's model_stats() sums this beside its local reads.
        "tokens_total": int(
            getattr(sched, "_tokens_emitted_total", 0) or 0),
    }
    hint = getattr(sched, "retry_after_hint", None)
    if callable(hint):
        try:
            out["retry_after_s"] = float(hint())
        except Exception:  # noqa: BLE001 — best-effort digest
            pass
    digs = getattr(sched, "resident_digests", None)
    if callable(digs):
        try:
            out["resident_digests"] = [str(d) for d in digs()]
        except Exception:  # noqa: BLE001 — best-effort digest
            pass
    for attr in ("prefix_telemetry", "page_stats", "handoff_stats",
                 "prefix_stats"):
        v = getattr(sched, attr, None)
        if isinstance(v, dict):
            out[attr] = {k: x for k, x in v.items()
                         if isinstance(x, (int, float, str, bool))}
    return out


class _Sub:
    """One in-flight remote request at the client side: the client
    future, the consumer's on_token, and the exactly-once stream cursor
    (`delivered` — token events carry indices, so a reconnect replays
    nothing and skips nothing)."""

    __slots__ = ("token", "future", "on_token", "delivered", "req",
                 "args")

    def __init__(self, token: str, future: Future, on_token=None,
                 req=None, args: Optional[Dict] = None):
        self.token = token
        self.future = future
        self.on_token = on_token
        self.delivered = 0
        self.req = req        # requeued _Request (handoff / drain path)
        self.args = args      # original submit args (extract rebuild)


class SocketTransport(_TransportBase):
    """Client side of the wire: one TCP connection to a
    `ReplicaServer`, a reader thread demuxing acks and token events,
    and the shared rpc envelope (tokens/retries/breaker/net sites).
    Reconnects transparently between RPC attempts; the token ledger on
    the server side makes the retry after a reconnect bind to the first
    execution."""

    kind = "socket"
    is_remote = True

    #: Socket replicas have no in-process heartbeat/flight objects; the
    #: LEASE is their liveness authority and loads_digest their metrics.
    heartbeat = None
    flight = None

    #: Tenant/qos ride the wire as OPTIONAL payload fields:
    #: the worker re-gates on its own scheduler's `supports_qos`, and a
    #: worker predating the axis simply ignores the extra keys — so the
    #: client side can always offer them.
    supports_qos = True

    def __init__(self, address, label: str = "r0",
                 connect_timeout_s: float = 5.0, retry_policy=None,
                 breaker=None, rpc_timeout_s: Optional[float] = None,
                 rng=None, sleep: Callable[[float], None] = time.sleep,
                 encoding: Optional[int] = None):
        self._addr = _parse_address(address)
        self._init_transport(label, retry_policy, breaker, rpc_timeout_s,
                             rng, sleep)
        self._connect_timeout_s = float(connect_timeout_s)
        self._encoding = default_encoding() if encoding is None else encoding
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._conn_lock = threading.Lock()
        self._seq = 0
        self._acks_lock = threading.Lock()
        self._acks: Dict[int, Future] = {}
        self._subs_lock = threading.Lock()
        self._subs: Dict[str, _Sub] = {}
        self._closed = False
        self._digest: Dict[str, object] = {}
        self._load: Dict[str, object] = {}
        self._cfg = None
        # Push-style handoff pump, client side: a prefill-role
        # worker streams each packed handoff here as an ev frame the
        # moment _pack_handoffs retires it; this side acks, dedups by
        # push id, rebinds the request to its client-side owner, and
        # buffers it for the pool's pump — so a SocketTransport drains
        # exactly like a local prefill scheduler's handoff queue.
        self._on_handoff_cb: Optional[Callable[[], None]] = None
        self.constraint_resolver: Optional[Callable] = None
        self._ho_lock = threading.Lock()
        self._pushed: "deque" = deque()
        self._ho_seen: "OrderedDict[str, None]" = OrderedDict()
        self._ho_event = threading.Event()
        self._ho_thread: Optional[threading.Thread] = None
        self._reader: Optional[threading.Thread] = None
        self._push_stats: Dict[str, float] = {
            "pushed": 0, "push_bytes": 0, "dup_pushes": 0}
        self._connect()

    # ---- connection management

    def _connect(self) -> None:
        with self._conn_lock:
            if self._sock is not None:
                return
            try:
                sock = socket.create_connection(
                    self._addr, timeout=self._connect_timeout_s
                )
            except OSError as e:
                raise TransportError(
                    f"connect to replica {self.label} at "
                    f"{self._addr[0]}:{self._addr[1]} failed: {e}"
                ) from None
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
            t = threading.Thread(target=self._read_loop, args=(sock,),
                                 daemon=True,
                                 name=f"lsot-transport-{self.label}")
            self._reader = t
            t.start()
        # Hello OUTSIDE the conn lock (it is an rpc on this connection).
        hello = self._rpc_raw("hello", {"client_version": PROTOCOL_VERSION},
                              timeout=self._connect_timeout_s)
        digest = hello.get("digest") or {}
        if int(digest.get("version", -1)) != PROTOCOL_VERSION:
            self._drop_connection()
            raise FrameVersionError(
                f"remote replica {self.label} speaks protocol "
                f"v{digest.get('version')}, this side v{PROTOCOL_VERSION}"
            )
        self._digest = digest
        if "load" in hello:
            self._load = hello["load"]

    def _drop_connection(self) -> None:
        with self._conn_lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            # shutdown() wakes the reader blocked in recv(); close() alone
            # would leave it parked until the peer hangs up.
            for fn in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    fn()
                except OSError:
                    pass

    def _ensure_connected(self) -> None:
        if self._sock is None:
            self._stats.bump_lease("reconnects")
            self._connect()

    def _read_loop(self, sock: socket.socket) -> None:
        dec = FrameDecoder()
        try:
            while True:
                data = sock.recv(1 << 16)
                if not data:
                    dec.eof()
                    break
                for msg in dec.feed(data):
                    self._dispatch(msg)
        except (OSError, FrameError) as e:
            if not self._closed:
                _log.debug("transport %s reader died: %s", self.label, e)
        finally:
            # Wake every waiter parked on this connection: their rpc
            # attempt failed; the envelope decides whether to retry.
            if self._sock is sock:
                self._drop_connection()
            with self._acks_lock:
                acks, self._acks = self._acks, {}
            for fut in acks.values():
                try:
                    fut.set_exception(TransportError(
                        f"connection to replica {self.label} lost"
                    ))
                except InvalidStateError:
                    pass

    def _dispatch(self, msg: Dict) -> None:
        if "re" in msg:  # rpc ack
            if isinstance(msg.get("load"), dict):
                self._load = msg["load"]
            with self._acks_lock:
                fut = self._acks.pop(int(msg["re"]), None)
            if fut is not None:
                try:
                    if msg.get("ok", True):
                        fut.set_result(msg)
                    else:
                        fut.set_exception(_decode_error(msg.get("err") or {}))
                except InvalidStateError:
                    pass
            return
        ev = msg.get("ev")
        if ev == "tok":
            sub = self._sub(msg.get("sub"))
            if sub is None or self._unreachable is not None:
                return
            if FAULTS.site_active(self._partition_site):
                return  # the partition blackholes the stream too
            i = int(msg.get("i", -1))
            if i == sub.delivered:
                sub.delivered += 1
                self._emit(sub, int(msg["t"]))
            return
        if ev == "handoff":
            self._on_push(msg)
            return
        if ev == "done":
            sub = self._sub(msg.get("sub"), pop=True)
            if sub is None:
                return
            if isinstance(msg.get("load"), dict):
                self._load = msg["load"]
            with self._pending_lock:
                self._pending.pop(sub.token, None)
            try:
                if msg.get("ok", True):
                    result = [int(t) for t in msg.get("val", [])]
                    # Exactly-once stream completion: deliver whatever
                    # the event stream missed (reconnect gap) before the
                    # future resolves — the result list is authoritative.
                    if self._unreachable is None and not FAULTS.site_active(
                            self._partition_site):
                        for t in result[sub.delivered:]:
                            sub.delivered += 1
                            self._emit(sub, t)
                    if msg.get("queue_wait") is not None:
                        sub.future._lsot_queue_wait = float(
                            msg["queue_wait"])
                    sub.future.set_result(result)
                else:
                    sub.future.set_exception(
                        _decode_error(msg.get("err") or {}))
            except InvalidStateError:
                pass  # already failed typed (unreachable declaration)

    @staticmethod
    def _emit(sub: _Sub, tok: int) -> None:
        if sub.req is not None:
            # A requeued request: mirror the committed token client-side
            # (delivered-prefix accounting for any later re-placement)
            # and stream through the request's own emit path.
            sub.req.generated.append(tok)
            sub.req.emit(tok)
            return
        if sub.on_token is not None:
            try:
                sub.on_token(tok)
            except Exception:  # noqa: BLE001 — consumer bugs stay client-side
                sub.on_token = None

    def _sub(self, token, pop: bool = False) -> Optional[_Sub]:
        if token is None:
            return None
        with self._subs_lock:
            if pop:
                return self._subs.pop(str(token), None)
            return self._subs.get(str(token))

    # ---- push-style handoff pump (client side)

    #: Bounded dedup memory for push ids. 1024 covers many full push
    #: windows (LSOT_PUMP_DEPTH defaults to 32); an id evicted from here
    #: has long since been placed, so a re-push that stale is impossible
    #: short of a partition longer than the request's own deadline.
    _HO_SEEN_CAP = 1024

    @property
    def on_handoff(self):
        """Settable pump seam — the pool wires its `_pump_handoffs` here
        exactly as it does for a local prefill scheduler (`hasattr` duck
        typing). Setting a callback wakes the pump thread so pushes that
        arrived before the wiring drain immediately."""
        return self._on_handoff_cb

    @on_handoff.setter
    def on_handoff(self, cb) -> None:
        self._on_handoff_cb = cb
        if cb is not None:
            self._kick_pump()

    def _on_push(self, msg: Dict) -> None:
        """One pushed handoff arrived (ev frame, not an rpc): ack first —
        acks are idempotent and the server re-pushes on every reconnect
        until one lands — then dedup by push id, rebind the wire request
        to its client-side owner (original future/on_token from the sub
        this side kept), and buffer it for the pool pump."""
        ho = str(msg.get("ho"))
        self._ack_push(ho)
        if self._closed or self._unreachable is not None:
            return
        if FAULTS.site_active(self._partition_site):
            return  # blackholed; the server re-pushes after the heal
        with self._ho_lock:
            if ho in self._ho_seen:
                self._push_stats["dup_pushes"] += 1
                return
            self._ho_seen[ho] = None
            while len(self._ho_seen) > self._HO_SEEN_CAP:
                self._ho_seen.popitem(last=False)
        token = msg.get("sub")
        sub = self._sub(token, pop=True)
        # The request leaves this replica's ownership: its future must
        # not fail if THIS transport later goes unreachable — whichever
        # replica the pool re-places it on owns it from here.
        with self._pending_lock:
            self._pending.pop(str(token), None)
        try:
            req = self._absorb_push(sub, msg.get("req") or {})
        except Exception as e:  # noqa: BLE001 — e.g. no constraint resolver
            if sub is not None:
                try:
                    sub.future.set_exception(e)
                except InvalidStateError:
                    pass
            return
        blob = getattr(req, "spilled", None)
        nbytes = blob_meta(blob)["nbytes"] if blob else 0
        if req.handoff is None:
            req.handoff = {}
        # Same-process receive stamp: the pool's _place_handoff turns it
        # into the push→placed latency the fleet metrics export (worker
        # clocks are not comparable across hosts; this one is ours).
        req.handoff["t_recv"] = time.perf_counter()
        with self._ho_lock:
            self._push_stats["pushed"] += 1
            self._push_stats["push_bytes"] += nbytes
            self._pushed.append(req)
        self._kick_pump()

    def _ack_push(self, ho: str) -> None:
        """Fire-and-forget: a lost ack costs one redundant re-push after
        the next reconnect (deduped above), never a double decode."""
        sock = self._sock
        if sock is None:
            return
        try:
            frame = encode_frame({"op": "handoff_ack", "seq": 0, "ho": ho},
                                 self._encoding)
            with self._send_lock:
                sock.sendall(frame)
        except OSError:
            pass

    def _absorb_push(self, sub: Optional[_Sub], entry: Dict):
        """Bind a pushed wire request to its client-side owner, then
        reconcile the delivered stream cursor: a connection gap may have
        eaten token events between the worker's first-token commit and
        the push, and the wire form's committed prefix is authoritative
        — deliver the gap here so the consumer's stream stays an exact
        prefix of the final result."""
        if sub is not None and sub.req is not None:
            # A requeued request came back as a handoff: same object,
            # updated server-side progress (mirrors _rebind).
            req = sub.req
            upd = request_from_wire(entry, future=req.future,
                                    on_token=req.on_token,
                                    constraint_resolver=lambda s,
                                    _c=req.constraint: _c)
            req.generated = upd.generated
            req.resume_pref = upd.resume_pref
            req.rng_count = upd.rng_count
            req.spilled = upd.spilled
            req.handoff = upd.handoff
        else:
            fut = sub.future if sub is not None else Future()
            tokcb = sub.on_token if sub is not None else None
            req = request_from_wire(entry, future=fut, on_token=tokcb,
                                    constraint_resolver=self._push_resolver)
        if sub is not None:
            for t in req.generated[sub.delivered:]:
                sub.delivered += 1
                req.emit(t)
        return req

    def _push_resolver(self, spec):
        r = self.constraint_resolver
        if r is None:
            raise ValueError(
                "pushed constrained handoff needs a client-side "
                "constraint resolver (SchedulerBackend wires one through "
                "the pool; set transport.constraint_resolver on raw "
                "fleets)"
            )
        return r(spec)

    def _kick_pump(self) -> None:
        if self._on_handoff_cb is None:
            return  # nothing drains push-style; extract_handoffs() pulls
        with self._ho_lock:
            t = self._ho_thread
            if t is None or not t.is_alive():
                t = threading.Thread(target=self._pump_loop, daemon=True,
                                     name=f"lsot-push-pump-{self.label}")
                self._ho_thread = t
                t.start()
        self._ho_event.set()

    def _pump_loop(self) -> None:
        """Off-reader-thread drain: fire the pool's on_handoff exactly
        like a local prefill scheduler's _pack_handoffs does, with the
        same decode-in-place fallback — if the pump raises, the buffered
        handoffs requeue back to the worker, which imports the blob and
        finishes the decode itself."""
        while not self._closed:
            if not self._ho_event.wait(timeout=0.25):
                continue
            self._ho_event.clear()
            cb = self._on_handoff_cb
            with self._ho_lock:
                depth = len(self._pushed)
            if cb is None or not depth:
                continue
            try:
                cb()
            except Exception:  # noqa: BLE001 — mirror _pack_handoffs' fallback
                for req in self.drain_pushed_handoffs():
                    try:
                        self.requeue(req)
                    except Exception as e:  # noqa: BLE001
                        try:
                            req.future.set_exception(e)
                        except InvalidStateError:
                            pass

    def drain_pushed_handoffs(self) -> List[object]:
        """The pool pump's drain: ONLY the locally-buffered pushes, no
        rpc — the steady-state path never polls the worker. The
        rpc-sweeping extract_handoffs below is the lifecycle drain,
        where completeness beats latency."""
        out: List[object] = []
        with self._ho_lock:
            while self._pushed:
                out.append(self._pushed.popleft())
        return out

    @property
    def push_pump_stats(self) -> Dict[str, object]:
        """Client-side pump counters + the worker's own pump digest
        (piggybacked on acks) — the `lsot_fleet_*` pushed-handoff
        families read from here."""
        with self._ho_lock:
            out: Dict[str, object] = dict(self._push_stats)
            out["depth"] = len(self._pushed)
        srv = self._load.get("pump")
        if isinstance(srv, dict):
            out["worker"] = dict(srv)
        return out

    # ---- raw rpc

    def _rpc_raw(self, op: str, payload: Dict,
                 timeout: Optional[float]) -> Dict:
        """One request/ack round-trip on the live connection. Raises
        TransportError/TransportTimeout; application errors decoded from
        the ack are raised as their real types."""
        self._ensure_connected()
        with self._acks_lock:
            self._seq += 1
            seq = self._seq
            ack: Future = Future()
            self._acks[seq] = ack
        frame = encode_frame({"op": op, "seq": seq, **payload},
                             self._encoding)
        sock = self._sock
        if sock is None:
            with self._acks_lock:
                self._acks.pop(seq, None)
            raise TransportError(f"no connection to replica {self.label}")
        try:
            with self._send_lock:
                sock.sendall(frame)
        except OSError as e:
            with self._acks_lock:
                self._acks.pop(seq, None)
            self._drop_connection()
            raise TransportError(
                f"send to replica {self.label} failed: {e}") from None
        try:
            return ack.result(timeout=timeout)
        except TransportError:
            raise
        except (_FutTimeout, TimeoutError):
            with self._acks_lock:
                self._acks.pop(seq, None)
            self._stats.bump(op, "timeouts")
            raise TransportTimeout(
                f"{op} rpc to {self.label} timed out after "
                f"{timeout if timeout is not None else float('inf'):.3f}s"
            ) from None

    # ---- protocol surface

    def ping(self, timeout: Optional[float] = None) -> Dict[str, object]:
        self._stats.bump("ping")
        if self._unreachable is not None:
            raise self._unreachable
        try:
            FAULTS.check(self._partition_site)
        except InjectedFault as e:
            raise TransportError(str(e)) from None
        return self._rpc_raw(
            "ping", {},
            timeout=timeout if timeout is not None else self._rpc_timeout_s,
        )

    def submit(self, ids, max_new_tokens: int = 256,
               sampling: SamplingParams = SamplingParams(), seed: int = 0,
               on_token=None, constraint=None, deadline_s=None, trace=None,
               model_id: str = "", tenant: str = "", qos: str = ""):
        # `trace` stays host-local: span trees do not cross the wire
        # (the submit→ack wall lands in the client's spans instead).
        del trace
        token = self._next_token()
        payload = {
            "tok": token, "rid": 0,
            "ids": [int(t) for t in ids],
            "max_new": int(max_new_tokens),
            "sampling": _sampling_to_wire(sampling),
            "seed": int(seed),
        }
        if model_id:
            # Multi-model fleets: the worker re-validates the
            # id against its own checkpoint — a client routed to the
            # wrong worker fails typed, never decodes on wrong weights.
            payload["model_id"] = str(model_id)
        if tenant:
            # Tenant axis: optional wire fields — a worker
            # missing them defaults to the unlabeled path.
            payload["tenant"] = str(tenant)
        if qos:
            payload["qos"] = str(qos)
        if deadline_s is not None:
            payload["deadline_s"] = float(deadline_s)
        if constraint is not None:
            payload["constrain"] = _constraint_spec(constraint)
        client: Future = Future()
        client._lsot_replica = self.label
        sub = _Sub(token, client, on_token=on_token,
                   args=dict(payload))
        # Register BEFORE the send: the first token event can beat the ack.
        with self._subs_lock:
            self._subs[token] = sub
        with self._pending_lock:
            self._pending[token] = client
        budget = self._rpc_budget(deadline_s)

        def run_once():
            ack = self._rpc_raw("submit", payload, timeout=budget)
            rid = int(ack.get("rid", 0))
            client._lsot_rid = rid
            return client

        try:
            fut = self._call("submit", run_once, deadline_s=deadline_s)
            # Remote cancellation: the _Request lives server-side; hand
            # the pool/backends a callable instead.
            fut._lsot_cancel = lambda: self._send_cancel(token)
            return fut
        except Exception:
            with self._subs_lock:
                self._subs.pop(token, None)
            with self._pending_lock:
                self._pending.pop(token, None)
            raise

    def requeue(self, req) -> None:
        """Ship an extracted/handoff request — KV blob included — to the
        remote replica, keeping the CLIENT-side future as the request's
        owner: tokens stream back as events, `done` resolves it."""
        token = self._next_token()
        wire = request_to_wire(req)
        sub = _Sub(token, req.future, on_token=req.on_token, req=req)
        sub.delivered = len(req.generated)
        # Events can beat the ack, so the sub registers up front — but
        # the request's future joins `_pending` (the set an unreachable
        # declaration fails typed) only AFTER the rpc succeeds: until
        # then the CALLER still owns the request, and its fallback chain
        # (decode in place, try the next sibling) must not find the
        # future already failed out from under it.
        with self._subs_lock:
            self._subs[token] = sub
        rem = (req.deadline.remaining()
               if getattr(req, "deadline", None) is not None else None)
        budget = self._rpc_budget(rem)

        def run_once():
            return self._rpc_raw("requeue", {"tok": token, "req": wire,
                                             "rid": wire["rid"]},
                                 timeout=budget)

        try:
            self._call("requeue", run_once, deadline_s=rem)
        except Exception:
            with self._subs_lock:
                self._subs.pop(token, None)
            raise
        with self._pending_lock:
            if self._unreachable is None:
                self._pending[token] = req.future

    def _send_cancel(self, token: str) -> None:
        self._stats.bump("cancel")
        try:
            self._rpc_raw("cancel", {"tok": token},
                          timeout=self._rpc_timeout_s)
        except TransportError:
            pass  # the lease/replay machinery owns an unreachable replica

    def cancel(self, future) -> None:
        cb = getattr(future, "_lsot_cancel", None)
        if cb is not None:
            cb()

    def extract_queued(self) -> List[object]:
        """Pull the remote replica's queued-not-yet-admitted requests
        back to this side (the pool's drain-one-replica seam): the
        server pops them off its queue and ships their wire forms; the
        client re-binds each to its ORIGINAL future/on_token via the
        subscription it kept, so re-placement onto a sibling resolves
        the same future the caller holds."""
        self._stats.bump("extract_queued")
        ack = self._rpc_raw("extract_queued", {},
                            timeout=self._rpc_timeout_s)
        return self._rebind(ack.get("reqs") or [])

    def extract_handoffs(self) -> List[object]:
        """Lifecycle drain (drain_replica / scale-down). For a push-
        capable worker the steady state never reaches this rpc — the
        pump owns the queue — but a drain must also sweep the push
        window (sent, not yet acked: the conn may have died mid-frame),
        so the rpc stays, with entries this side already absorbed
        deduped away by their push ids. Legacy (pre-push) workers keep
        the original pull semantics unchanged."""
        self._stats.bump("extract_handoffs")
        out = self.drain_pushed_handoffs()
        if not self._dig("push_handoffs", False):
            ack = self._rpc_raw("extract_handoffs", {},
                                timeout=self._rpc_timeout_s)
            return out + self._rebind(ack.get("reqs") or [])
        try:
            ack = self._rpc_raw("extract_handoffs", {},
                                timeout=self._rpc_timeout_s)
        except TransportError:
            # Unreachable worker: the lease/journal replay machinery owns
            # whatever is still on that host; the local buffer is what a
            # drain can truthfully deliver.
            return out
        fresh = []
        for entry in ack.get("reqs") or []:
            ho = entry.get("ho")
            if ho is not None:
                with self._ho_lock:
                    if str(ho) in self._ho_seen:
                        continue  # absorbed via the push path already
                    self._ho_seen[str(ho)] = None
            fresh.append(entry)
        return out + self._rebind(fresh)

    def _rebind(self, wire_reqs: List[Dict]) -> List[object]:
        out = []
        for entry in wire_reqs:
            token = entry.get("tok")
            sub = self._sub(token, pop=True)
            if sub is not None and sub.req is not None:
                # A requeued request bounced back: same object, updated
                # server-side progress.
                req = sub.req
                upd = request_from_wire(entry["req"], future=req.future,
                                        on_token=req.on_token,
                                        constraint_resolver=lambda s,
                                        _c=req.constraint: _c)
                req.generated = upd.generated
                req.resume_pref = upd.resume_pref
                req.rng_count = upd.rng_count
                req.spilled = upd.spilled
                req.handoff = upd.handoff
                out.append(req)
            else:
                fut = sub.future if sub is not None else Future()
                tokcb = sub.on_token if sub is not None else None
                with self._pending_lock:
                    self._pending.pop(token, None)
                out.append(request_from_wire(
                    entry["req"], future=fut, on_token=tokcb,
                    constraint_resolver=self._client_constraint,
                ))
        return out

    @staticmethod
    def _client_constraint(spec):
        raise ValueError(
            "cannot rebuild a constrained request client-side without a "
            "resolver — re-place it on a replica that compiles specs"
        )

    # ---- replica duck-typed surface (static digest + live load cache)

    def _dig(self, key, default=None):
        return self._digest.get(key, default)

    @property
    def cfg(self):
        if self._cfg is None and self._dig("cfg"):
            from ..models.configs import LlamaConfig

            fields = dict(self._dig("cfg"))
            fields.pop("rope_scaling", None)
            try:
                self._cfg = LlamaConfig(**{
                    k: (tuple(v) if isinstance(v, list) else v)
                    for k, v in fields.items()
                })
            except TypeError:
                self._cfg = None
        return self._cfg

    @property
    def max_seq(self) -> int:
        return int(self._dig("max_seq", 0))

    @property
    def decode_chunk(self) -> int:
        return int(self._dig("decode_chunk", 1))

    @property
    def prompt_bucket(self) -> int:
        return int(self._dig("prompt_bucket", 0))

    @property
    def num_slots(self) -> int:
        return int(self._dig("num_slots", 0))

    @property
    def stop_ids(self):
        return tuple(self._dig("stop_ids", ()))

    @property
    def _spec_draft(self) -> int:
        return int(self._dig("spec_draft", 0))

    @property
    def _harvest_lag(self) -> int:
        return int(self._dig("harvest_lag", 0))

    @property
    def overshoot(self) -> int:
        return int(self._dig("overshoot", 0))

    @property
    def phase_role(self) -> str:
        return str(self._dig("phase_role", "mixed"))

    @property
    def model_id(self) -> str:
        """Which checkpoint the remote replica serves —
        shipped once in the hello digest; the pool's model router
        filters on it exactly like an in-process replica's attribute."""
        return str(self._dig("model_id", "") or "")

    @property
    def _pblock(self) -> int:
        return int(self._dig("pblock", 0))

    @property
    def _paged(self) -> bool:
        return bool(self._dig("paged", False))

    @property
    def _page_size(self) -> int:
        return int(self._dig("page_size", 0))

    def backlog_score(self) -> Tuple[float, int]:
        secs, toks = self._load.get("backlog", (0.0, 0))
        return float(secs), int(toks)

    def retry_after_hint(self) -> float:
        return float(self._load.get("retry_after_s", 1.0))

    def resident_digests(self) -> List[str]:
        return list(self._load.get("resident_digests", []))

    @property
    def prefix_telemetry(self) -> Optional[Dict]:
        v = self._load.get("prefix_telemetry")
        return dict(v) if isinstance(v, dict) else None

    @property
    def prefix_stats(self) -> Optional[Dict]:
        v = self._load.get("prefix_stats")
        return dict(v) if isinstance(v, dict) else None

    @property
    def page_stats(self) -> Optional[Dict]:
        v = self._load.get("page_stats")
        return dict(v) if isinstance(v, dict) else None

    @property
    def handoff_stats(self) -> Optional[Dict]:
        v = self._load.get("handoff_stats")
        return dict(v) if isinstance(v, dict) else None

    def loads_digest(self) -> Dict[str, object]:
        """The cached live digest (refreshed by every ping/ack) the
        pool merges into `replica_loads()` for a socket replica."""
        out = {k: v for k, v in self._load.items()
               if k not in ("backlog",)}
        secs, toks = self.backlog_score()
        out["backlog_s"] = round(secs, 4)
        out["pending_new_tokens"] = toks
        return out

    def _busy_now(self) -> bool:
        return bool(self._load.get("queued", 0)
                    or self._load.get("active_slots", 0))

    def start(self):
        return self  # the remote process owns the scheduler's lifecycle

    def warmup(self, prompt_len=None) -> None:
        pass  # warmed in the remote process

    def shutdown(self, timeout: Optional[float] = None) -> None:
        """Close THIS side's connection. The remote scheduler keeps
        serving (other controllers, or a reconnect after a partition
        heals) — a transport shutdown is a hangup, not a teardown."""
        self._closed = True
        self._ho_event.set()  # wake the push pump so it can exit
        self._drop_connection()
        self._breaker.unregister()
        # Join the connection's threads (bounded): a hung-up transport
        # leaves none behind holding it, or the pool its resolver names.
        for t in (self._reader, self._ho_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


# ------------------------------------------------------------------ server


class ReplicaServer:
    """The remote half: serve one in-process scheduler to socket
    transports. Thread per connection, token-ledger dedup on every
    mutating op, indexed token events for exactly-once streaming, and
    the loads digest piggybacked on pings/acks so the remote pool's
    router sees live placement signals."""

    def __init__(self, scheduler, host: str = "127.0.0.1", port: int = 0,
                 constraint_resolver: Optional[Callable] = None,
                 push_handoffs: bool = True,
                 pump_depth: Optional[int] = None):
        self.scheduler = scheduler
        self.constraint_resolver = constraint_resolver
        self._ledger = _TokenLedger()
        self._lock = threading.Lock()
        self._live: Dict[str, Future] = {}      # token -> inner future
        self._reqs: Dict[str, object] = {}      # token -> _Request
        self._sinks: Dict[str, "_ConnSink"] = {}  # token -> event sink
        self._closed = False
        # Push-style handoff pump, server side: wire the
        # scheduler's on_handoff so _pack_handoffs streams each packed
        # blob to its client the moment it retires, instead of parking
        # it for a pull that a remote pool never issues. `pump_depth`
        # bounds the pushed-but-unacked window: beyond it (or with no
        # live client connection) the handoff requeues right back into
        # this scheduler, which imports the blob and decodes in place.
        if pump_depth is None:
            pump_depth = int(os.environ.get("LSOT_PUMP_DEPTH", "32") or 32)
        self._pump_depth = max(1, int(pump_depth))
        self._push = bool(push_handoffs) and hasattr(
            self._view(), "on_handoff")
        self._unacked: "OrderedDict[str, Tuple[str, object]]" = OrderedDict()
        self._ho_seq = 0
        self._pump_stats: Dict[str, int] = {
            "pushed": 0, "push_bytes": 0, "acked": 0, "repushed": 0,
            "inplace": 0, "backpressure": 0}
        self._maybe_wire_pump()
        self._conns: List[socket.socket] = []
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"lsot-replica-server-{self.port}",
        )
        self._accept_thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        """Stop accepting AND sever live connections — a closed server
        looks to its clients exactly like a dead host (their lease
        expires), not like a quiet one."""
        self._closed = True
        # shutdown() BEFORE close(): a thread blocked in accept() holds
        # the open file description, so close() alone leaves the kernel
        # listener accepting one more connection — shutdown wakes the
        # accept with an error instead.
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = list(self._conns), []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            if self._closed:
                # close() raced the handshake: refuse, don't serve.
                try:
                    conn.close()
                except OSError:
                    pass
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name=f"lsot-replica-conn-{self.port}",
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        sink = _ConnSink(conn)
        dec = FrameDecoder()
        try:
            while True:
                data = conn.recv(1 << 16)
                if not data:
                    break
                try:
                    msgs = dec.feed(data)
                except FrameVersionError as e:
                    sink.send({"re": 0, "ok": False,
                               "err": {"type": "RuntimeError",
                                       "msg": str(e)}})
                    break
                for msg in msgs:
                    self._handle(msg, sink)
        except (OSError, FrameError):
            pass
        finally:
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _view(self):
        """The scheduler the digests describe: a supervised worker
        (`--supervise`) swaps its inner loop on restart, so the live
        inner — not the wrapper — is what admission arithmetic and the
        pump must read. Raw schedulers view as themselves."""
        return getattr(self.scheduler, "_inner", None) or self.scheduler

    def _maybe_wire_pump(self) -> None:
        """(Re)wire on_handoff onto the live inner: a supervised
        worker's restart builds a fresh scheduler with on_handoff=None
        (handoffs would silently decode in place forever) — this runs
        per handled message, so the pump self-heals one rpc after any
        restart."""
        if not self._push or self._closed:
            return
        v = self._view()
        if getattr(v, "on_handoff", False) is not self._pump_handoffs \
                and hasattr(v, "on_handoff"):
            v.on_handoff = self._pump_handoffs

    def _handle(self, msg: Dict, sink: "_ConnSink") -> None:
        op = str(msg.get("op", ""))
        seq = int(msg.get("seq", 0))
        self._maybe_wire_pump()
        try:
            ack = self._dispatch(op, msg, sink)
            ack = dict(ack or {})
            load = loads_digest_for(self._view())
            if self._push:
                with self._lock:
                    load["pump"] = dict(self._pump_stats,
                                        window=len(self._unacked))
            ack.update({"re": seq, "ok": True, "load": load})
            sink.send(ack)
        except BaseException as e:  # noqa: BLE001 — every error answers typed
            sink.send({"re": seq, "ok": False, "err": _encode_error(e)})

    def _dispatch(self, op: str, msg: Dict, sink: "_ConnSink"):
        if op == "hello":
            if int(msg.get("client_version", -1)) != PROTOCOL_VERSION:
                raise RuntimeError(
                    f"client speaks transport protocol "
                    f"v{msg.get('client_version')}, this replica "
                    f"v{PROTOCOL_VERSION}"
                )
            digest = describe_scheduler(self._view())
            digest["push_handoffs"] = bool(self._push)
            if self._push:
                # A reconnect retries the push window on the fresh
                # connection: the client dedups by push id, so the worst
                # case is wasted bytes, never a double decode.
                self._repush_unacked(sink)
            return {"digest": digest}
        if op == "ping":
            crash = getattr(self._view(), "_crash", None)
            if crash is not None:
                raise SchedulerCrashed(f"replica loop crashed: {crash}")
            return {}
        if op == "loads":
            return {}
        if op == "submit":
            return self._op_submit(msg, sink)
        if op == "requeue":
            return self._op_requeue(msg, sink)
        if op == "cancel":
            return self._op_cancel(msg)
        if op == "handoff_ack":
            return self._op_handoff_ack(msg)
        if op in ("extract_queued", "extract_handoffs"):
            return self._op_extract(op)
        raise RuntimeError(f"unknown rpc op {op!r}")

    # ---- push-style handoff pump (server side)

    def _pump_handoffs(self) -> None:
        """scheduler.on_handoff: runs on the scheduler loop thread the
        moment _pack_handoffs retires a batch of prefills. Each packed
        handoff streams to its client as an ev frame carrying the full
        wire request (KV blob, rng/resume state, deadline remaining);
        the frame is deduped client-side by push id and re-pushed on
        every reconnect until acked."""
        for req in self.scheduler.extract_handoffs():
            self._push_one(req)

    def _push_one(self, req) -> None:
        with self._lock:
            token = next(
                (t for t, r in self._reqs.items() if r is req), None)
            sink = self._sinks.get(token) if token is not None else None
            window_full = len(self._unacked) >= self._pump_depth
        if (token is None or sink is None or sink.dead
                or window_full or self._closed):
            # No live client, or the push window is full: decode in
            # place — re-admission imports the blob right back into this
            # scheduler, the fallback the pump must preserve.
            self._pump_stats[
                "backpressure" if window_full else "inplace"] += 1
            try:
                self.scheduler.requeue(req)
            except Exception as e:  # noqa: BLE001 — fail typed, never drop
                try:
                    req.future.set_exception(e)
                except InvalidStateError:
                    pass
            return
        with self._lock:
            self._ho_seq += 1
            ho = f"{token}#ho{self._ho_seq}"
            self._unacked[ho] = (token, req)
        blob = getattr(req, "spilled", None)
        self._pump_stats["pushed"] += 1
        self._pump_stats["push_bytes"] += (
            int(sum(int(np.asarray(a).nbytes) for a in blob))
            if blob else 0)
        sink.send({"ev": "handoff", "sub": token, "ho": ho,
                   "req": request_to_wire(req)})

    def _repush_unacked(self, sink: "_ConnSink") -> None:
        with self._lock:
            entries = list(self._unacked.items())
            for _ho, (token, _req) in entries:
                self._sinks[token] = sink
        for ho, (token, req) in entries:
            self._pump_stats["repushed"] += 1
            sink.send({"ev": "handoff", "sub": token, "ho": ho,
                       "req": request_to_wire(req)})

    def _op_handoff_ack(self, msg: Dict) -> Dict:
        ho = str(msg.get("ho"))
        with self._lock:
            entry = self._unacked.pop(ho, None)
            if entry is not None:
                # The client owns the request now: drop every server-side
                # trace so the abandoned inner future cannot leak.
                token = entry[0]
                self._reqs.pop(token, None)
                self._live.pop(token, None)
                self._sinks.pop(token, None)
        if entry is not None:
            self._pump_stats["acked"] += 1
        return {}

    def _op_submit(self, msg: Dict, sink: "_ConnSink") -> Dict:
        token = str(msg.get("tok"))

        def execute():
            emitter = self._make_emitter(token)
            constraint = None
            spec = msg.get("constrain")
            if spec is not None:
                if self.constraint_resolver is None:
                    raise ValueError(
                        "this replica has no constraint resolver"
                    )
                constraint = self.constraint_resolver(spec)
            want_model = str(msg.get("model_id", "") or "")
            if want_model:
                have = str(getattr(self.scheduler, "model_id", "") or "")
                if want_model != have:
                    # Refuse BEFORE generating: decoding on the wrong
                    # checkpoint would return fluent garbage, not an error.
                    raise UnknownModel(
                        f"worker serves model {have or '<unlabeled>'!r}, "
                        f"request wants {want_model!r}"
                    )
            extra = {"model_id": want_model} if want_model else {}
            tenant = str(msg.get("tenant", "") or "")
            qos = str(msg.get("qos", "") or "")
            if (tenant or qos) and getattr(self.scheduler, "supports_qos",
                                           False):
                # Tenant axis: re-gated HERE so a labeled
                # frame landing on a qos-blind scheduler (old worker,
                # duck-typed fake) defaults sanely to unlabeled.
                extra["tenant"] = tenant
                extra["qos"] = qos
            fut = self.scheduler.submit(
                msg["ids"], max_new_tokens=int(msg.get("max_new", 256)),
                sampling=_sampling_from_wire(msg.get("sampling")),
                seed=int(msg.get("seed", 0)), on_token=emitter,
                constraint=constraint,
                deadline_s=msg.get("deadline_s"),
                **extra,
            )
            with self._lock:
                self._live[token] = fut
                req = getattr(fut, "_lsot_request", None)
                if req is not None:
                    self._reqs[token] = req
            fut.add_done_callback(
                lambda f, t=token: self._finish(t, f))
            return fut

        fut, _fresh = self._ledger.get_or_run(token, execute)
        # (Re)bind the event sink to the CURRENT connection: a retried
        # submit after a reconnect keeps streaming on the live socket.
        with self._lock:
            self._sinks[token] = sink
        rid = 0
        req = self._reqs.get(token)
        if req is not None:
            rid = int(getattr(req, "rid", 0))
        return {"rid": rid}

    def _op_requeue(self, msg: Dict, sink: "_ConnSink") -> Dict:
        token = str(msg.get("tok"))

        def execute():
            emitter = self._make_emitter(token)
            req = request_from_wire(
                msg["req"], on_token=None,
                constraint_resolver=self.constraint_resolver,
            )
            want_model = str(getattr(req, "model_id", "") or "")
            if want_model:
                have = str(getattr(self.scheduler, "model_id", "") or "")
                if want_model != have:
                    raise UnknownModel(
                        f"worker serves model {have or '<unlabeled>'!r}, "
                        f"requeued request wants {want_model!r}"
                    )
            # The request's owner is the CLIENT: its server-side future
            # only exists to feed events back over the wire.
            base = len(req.generated)
            req.on_token = emitter
            req.future.add_done_callback(
                lambda f, t=token: self._finish(t, f))
            with self._lock:
                self._reqs[token] = req
                self._live[token] = req.future
            # Base the emitter's indices on the already-committed prefix
            # BEFORE the scheduler can emit: the client's cursor starts
            # there, and a first token indexed 0 would be dropped and
            # desynchronize the stream.
            emitter.base(base)
            self.scheduler.requeue(req)
            return True

        self._ledger.get_or_run(token, execute)
        with self._lock:
            self._sinks[token] = sink
        return {}

    def _op_cancel(self, msg: Dict) -> Dict:
        token = str(msg.get("tok"))
        with self._lock:
            req = self._reqs.get(token)
        if req is not None:
            req.cancelled = True
        return {}

    def _op_extract(self, op: str) -> Dict:
        fn = getattr(self.scheduler, op, None)
        tagged = [(None, r) for r in (fn() if callable(fn) else [])]
        if op == "extract_handoffs":
            # A drain sweeps the push window too: a pushed-but-unacked
            # handoff may never have reached the client (conn died
            # mid-frame) and a drain must be complete. Entries keep
            # their push id so a client that DID absorb the push dedups
            # them away instead of double-placing.
            with self._lock:
                unacked, self._unacked = self._unacked, OrderedDict()
            tagged = [(ho, req) for ho, (_t, req) in unacked.items()] + tagged
        out = []
        with self._lock:
            tok_by_req = {id(r): t for t, r in self._reqs.items()}
        for ho, req in tagged:
            token = tok_by_req.get(id(req))
            with self._lock:
                if token is not None:
                    self._reqs.pop(token, None)
                    self._live.pop(token, None)
                    self._sinks.pop(token, None)
            entry = {"tok": token, "req": request_to_wire(req)}
            if ho is not None:
                entry["ho"] = ho
            out.append(entry)
        return {"reqs": out}

    class _Emitter:
        """Server-side on_token: forwards each accepted token as an
        indexed event on the token's CURRENT sink (rebound on
        reconnect). Index continuity across a requeue's committed
        prefix rides `base()`."""

        __slots__ = ("_server", "_token", "_i")

        def __init__(self, server: "ReplicaServer", token: str):
            self._server = server
            self._token = token
            self._i = 0

        def base(self, n: int) -> None:
            self._i = max(self._i, int(n))

        def __call__(self, tok: int) -> None:
            i = self._i
            self._i += 1
            with self._server._lock:
                sink = self._server._sinks.get(self._token)
            if sink is not None:
                sink.send({"ev": "tok", "sub": self._token, "i": i,
                           "t": int(tok)})

    def _make_emitter(self, token: str) -> "_Emitter":
        return ReplicaServer._Emitter(self, token)

    def _finish(self, token: str, fut: Future) -> None:
        with self._lock:
            sink = self._sinks.pop(token, None)
            self._reqs.pop(token, None)
            self._live.pop(token, None)
        if sink is None:
            return
        msg: Dict = {"ev": "done", "sub": token,
                     "load": loads_digest_for(self._view())}
        exc = fut.exception()
        if exc is None:
            msg.update({"ok": True, "val": [int(t) for t in fut.result()]})
            qw = getattr(fut, "_lsot_queue_wait", None)
            if qw is not None:
                msg["queue_wait"] = float(qw)
        else:
            msg.update({"ok": False, "err": _encode_error(exc)})
        sink.send(msg)


class _ConnSink:
    """One connection's locked frame writer (worker threads and the rpc
    handler interleave sends)."""

    __slots__ = ("_conn", "_lock", "_dead", "_enc")

    def __init__(self, conn: socket.socket, encoding: Optional[int] = None):
        self._conn = conn
        self._lock = threading.Lock()
        self._dead = False
        self._enc = default_encoding() if encoding is None else encoding

    @property
    def dead(self) -> bool:
        return self._dead

    def send(self, msg: Dict) -> None:
        if self._dead:
            return
        try:
            frame = encode_frame(msg, self._enc)
            with self._lock:
                self._conn.sendall(frame)
        except (OSError, FrameError):
            self._dead = True  # client gone; the lease tells the pool


# ----------------------------------------------------- worker entrypoint


def _worker_device(args) -> str:
    """The worker's device: the card, or the CPU under `--cpu`. Without a
    card and without `--cpu` this raises; there is no CPU fallback."""
    if getattr(args, "cpu", False):
        return "cpu"
    from .. import resolve_device

    return str(resolve_device(None))


def _build_worker_scheduler(args):
    """Build the worker's scheduler from its spec. `--from-hf`/`--from-gguf`
    load a real checkpoint with the entry point's serving surface (kv
    quant/layout/HBM budget, speculative draft, supervision) — a remote
    tier runs the same engine bytes as the local one. Without a checkpoint
    flag the worker builds the tiny random-weight replica (TINY at f32 from
    a seeded generator), so a fleet can be stood up and chaos-tested
    without shipping weights around."""
    if getattr(args, "from_hf", "") or getattr(args, "from_gguf", ""):
        return _build_checkpoint_scheduler(args)
    import torch

    from ..models import TINY
    from ..models.llama import init_params
    from ..tokenizer import ByteTokenizer
    from .scheduler import ContinuousBatchingScheduler

    dev = _worker_device(args)
    gen = torch.Generator(device=dev).manual_seed(int(args.seed))
    params = init_params(TINY, gen, dtype=torch.float32, device=dev)
    sched = ContinuousBatchingScheduler(
        TINY, params, num_slots=args.num_slots,
        decode_chunk=args.decode_chunk, prompt_bucket=args.prompt_bucket,
        stop_ids=(2,), max_seq=args.max_seq,
        kv_layout=args.kv_layout,
        kv_page_size=args.kv_page_size or None,
        speculative_draft=args.speculative,
        phase_role=args.phase_role,
        model_id=getattr(args, "model_id", "") or "",
        device=dev,
    )
    tok = ByteTokenizer()

    def resolver(spec):
        from ..constrain import get_constraint

        return get_constraint(spec, tok, (2,))

    return _maybe_supervise(sched, args), resolver


def _maybe_supervise(sched, args) -> object:
    """`--supervise`: wrap the worker's scheduler in the in-process crash
    supervisor (watchdog stall detection + journal replay), so a decode-
    loop crash on the worker host restarts locally instead of waiting for
    the pool's lease to expire and re-prefill on a sibling."""
    if not getattr(args, "supervise", False):
        return sched
    from .supervisor import SupervisedScheduler

    fresh = [sched]

    def make():
        if fresh:
            return fresh.pop()
        return _rebuild_worker_scheduler(args)

    return SupervisedScheduler(
        make, max_restarts=int(getattr(args, "max_restarts", 5)),
        stall_factor=float(getattr(args, "stall_factor", 16.0)),
        stall_min_s=float(getattr(args, "stall_min_s", 10.0)),
        warmup_grace_s=float(getattr(args, "stall_warmup_s", 0.0)),
        name=f"remote-worker:{getattr(args, 'model_id', '') or 'tiny'}",
    )


def _rebuild_worker_scheduler(args):
    """Supervisor restart factory: rebuild the inner scheduler from the
    same spec (checkpoint params reload from disk — a worker restart is
    rare enough that one disk read beats pinning a second params copy)."""
    plain = argparse.Namespace(**{**vars(args), "supervise": False})
    sched, _resolver = _build_worker_scheduler(plain)
    return sched


def _build_checkpoint_scheduler(args):
    """Real-checkpoint worker: the recipe `SchedulerBackend.from_hf_checkpoint`
    / `from_gguf` cook for local serving (bf16 tree, `--int8` block
    weights), built here as a raw scheduler for ReplicaServer — phase role
    and model identity stamped so the pool's placement and the wire's model
    validation see a first-class replica."""
    import torch

    from ..tokenizer import HFTokenizer
    from .backends import resolve_stop_ids
    from .scheduler import ContinuousBatchingScheduler

    if args.from_hf and args.from_gguf:
        raise ValueError("pick one of --from-hf / --from-gguf")
    dev = _worker_device(args)
    if args.from_hf:
        from ..checkpoint import load_hf_checkpoint

        cfg, params = load_hf_checkpoint(args.from_hf, dtype=torch.bfloat16,
                                         device=dev)
        tok = HFTokenizer(args.tokenizer or args.from_hf)
    else:
        from ..checkpoint import load_gguf_checkpoint

        if not args.tokenizer:
            raise ValueError(
                "--from-gguf needs --tokenizer DIR (GGUF blobs carry no "
                "tokenizer.json)"
            )
        cfg, params = load_gguf_checkpoint(args.from_gguf, device=dev)
        tok = HFTokenizer(args.tokenizer)
    if args.int8:
        from ..ops.quant import quantize_params

        params = quantize_params(params)
    stop_ids = resolve_stop_ids(cfg, tok)
    sched = ContinuousBatchingScheduler(
        cfg, params, num_slots=args.num_slots,
        decode_chunk=args.decode_chunk, prompt_bucket=args.prompt_bucket,
        stop_ids=stop_ids, max_seq=args.max_seq,
        kv_layout=args.kv_layout,
        kv_page_size=args.kv_page_size or None,
        kv_quant=(args.kv_quant or None),
        kv_hbm_budget_bytes=(int(args.kv_hbm_gb * (1 << 30))
                             if args.kv_hbm_gb else None),
        kv_pages=(args.kv_pages or None),
        speculative_draft=args.speculative,
        phase_role=args.phase_role,
        model_id=args.model_id or "",
        device=dev,
    )

    def resolver(spec):
        from ..constrain import get_constraint

        return get_constraint(spec, tok, stop_ids)

    return _maybe_supervise(sched, args), resolver


def build_parser() -> argparse.ArgumentParser:
    """The worker's options: the JAX package's worker's, with their
    defaults, plus `--cpu`."""
    ap = argparse.ArgumentParser(
        prog="python -m llm_based_apache_spark_optimization_tpu_torch.serve.remote",
        description="Thin remote replica worker: serve one "
                    "ContinuousBatchingScheduler over the frame protocol.",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--num-slots", type=int, default=2)
    ap.add_argument("--decode-chunk", type=int, default=4)
    ap.add_argument("--prompt-bucket", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--kv-layout", default="contiguous",
                    choices=["contiguous", "paged"])
    ap.add_argument("--kv-page-size", type=int, default=0)
    ap.add_argument("--speculative", type=int, default=0)
    ap.add_argument("--phase-role", default="mixed",
                    choices=["mixed", "prefill", "decode"])
    ap.add_argument("--model-id", default="",
                    help="model identity this worker serves; requests "
                         "carrying a different model_id fail typed "
                         "(UnknownModel) instead of decoding on the "
                         "wrong weights")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--from-hf", default="", metavar="DIR",
                    help="serve a real HF checkpoint directory instead "
                         "of the tiny random-weight model")
    ap.add_argument("--from-gguf", default="", metavar="PATH",
                    help="serve a GGUF blob (pair with --tokenizer DIR)")
    ap.add_argument("--tokenizer", default="", metavar="DIR",
                    help="tokenizer directory (defaults to --from-hf dir)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weight-only quantization at load")
    ap.add_argument("--kv-quant", default="", choices=["", "int8"],
                    help="quantize the persistent KV cache")
    ap.add_argument("--kv-hbm-gb", type=float, default=0.0,
                    help="paged-KV device memory budget in GiB (0 = default "
                         "sizing)")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="explicit paged-KV pool size in pages")
    ap.add_argument("--supervise", action="store_true",
                    help="run the scheduler under the in-process crash "
                         "supervisor (watchdog + journal replay)")
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--stall-factor", type=float, default=16.0)
    ap.add_argument("--stall-min-s", type=float, default=10.0)
    ap.add_argument("--stall-warmup-s", type=float, default=0.0)
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0)
    ap.add_argument("--slo-tpot-ms", type=float, default=0.0)
    ap.add_argument("--slo-queue-wait-ms", type=float, default=0.0)
    ap.add_argument("--no-push-handoffs", action="store_true",
                    help="legacy pull-only handoff drain (pre-push pools)")
    ap.add_argument("--pump-depth", type=int, default=0,
                    help="bound on pushed-but-unacked handoffs before "
                         "decode-in-place backpressure (0 = "
                         "LSOT_PUMP_DEPTH, default 32)")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU (the kernels' plain versions); "
                         "without it the worker needs a CUDA card")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        _worker_device(args)
    except RuntimeError:
        raise SystemExit("lsot-remote-worker: no CUDA card is visible; the worker "
                         "serves on a card (pass --cpu to serve on the CPU)") from None
    if args.slo_ttft_ms or args.slo_tpot_ms or args.slo_queue_wait_ms:
        from ..utils import slo

        slo.reconfigure(ttft_ms=args.slo_ttft_ms, tpot_ms=args.slo_tpot_ms,
                        queue_wait_ms=args.slo_queue_wait_ms)
    sched, resolver = _build_worker_scheduler(args)
    warm = getattr(sched, "warmup", None)
    if callable(warm):
        warm()
    sched.start()
    server = ReplicaServer(sched, host=args.host, port=args.port,
                           constraint_resolver=resolver,
                           push_handoffs=not args.no_push_handoffs,
                           pump_depth=(args.pump_depth or None))
    # Callers read the bound port from this line.
    print(f"lsot-remote-worker listening on {server.address}", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        sched.shutdown()
    return 0


if __name__ == "__main__":  # pragma: no cover - subprocess entrypoint
    raise SystemExit(main())

"""The port's replica transports (serve/remote.py) on the CPU, against the
JAX package's.

Twins of the JAX package's cases (tests/test_remote.py, and
tests/test_modelpool.py's remote model check): each scenario runs through
both packages' modules and the observations must be equal.

- the wire: frames round-trip both encodings, bad frames are refused typed,
  errors cross as their own types, a request with its KV blob survives the
  wire, the token ledger is single-flight;
- the loopback envelope: the direct call without faults; drop, dup and
  delay faults; an unreachable declaration;
- the pool's lease monitor and the transport blocks of its views;
- the socket transport over a toy replica and over TINY schedulers (f32,
  weights bridged from JAX): greedy tokens, handoff counts and transport
  counters equal JAX's;
- tenant and qos attribution on the wire, the worker's model check;

and the checks across the packages: the same messages encode to the same
bytes under JSON and msgpack, the port's transport serves against JAX's
`ReplicaServer` and JAX's against the port's, and an oversized pushed
handoff (the frame ceiling patched small) kills its connection, so the
lease fails the worker over and the request re-prefills on the decode
sibling, in both packages alike.

Sampled streams are compared within a package only (another RNG). Every
wait has its own timeout."""

import dataclasses
import json
import random
import socket
import struct
import threading
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pool import ToyScheduler

from llm_based_apache_spark_optimization_tpu.constrain import (
    get_constraint as jax_get_constraint,
)
from llm_based_apache_spark_optimization_tpu.evalh.chaos import _ToyScheduler
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.ops import sampling as jax_sampling
from llm_based_apache_spark_optimization_tpu.serve import modelpool as jax_mp
from llm_based_apache_spark_optimization_tpu.serve import remote as jax_remote
from llm_based_apache_spark_optimization_tpu.serve import resilience as jax_res
from llm_based_apache_spark_optimization_tpu.serve import scheduler as jax_sched
from llm_based_apache_spark_optimization_tpu.serve import supervisor as jax_sup
from llm_based_apache_spark_optimization_tpu.tokenizer import ByteTokenizer as JaxByteTok
from llm_based_apache_spark_optimization_tpu.utils import faults as jax_faults
from llm_based_apache_spark_optimization_tpu.utils import prometheus as jax_prom
from llm_based_apache_spark_optimization_tpu_torch.constrain import get_constraint
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine import paged_kv as t_kv
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.ops import sampling as t_sampling
from llm_based_apache_spark_optimization_tpu_torch.serve import modelpool as t_mp
from llm_based_apache_spark_optimization_tpu_torch.serve import remote as t_remote
from llm_based_apache_spark_optimization_tpu_torch.serve import resilience as t_res
from llm_based_apache_spark_optimization_tpu_torch.serve import scheduler as t_sched
from llm_based_apache_spark_optimization_tpu_torch.serve import supervisor as t_sup
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer
from llm_based_apache_spark_optimization_tpu_torch.utils import faults as t_faults
from llm_based_apache_spark_optimization_tpu_torch.utils import prometheus as t_prom

PKGS = {
    "jax": dict(side="jax", remote=jax_remote, sched=jax_sched, res=jax_res, sup=jax_sup,
                faults=jax_faults.FAULTS, toy=_ToyScheduler, mp=jax_mp, sp=jax_sampling,
                prom=jax_prom),
    "torch": dict(side="torch", remote=t_remote, sched=t_sched, res=t_res, sup=t_sup,
                  faults=t_faults.FAULTS, toy=ToyScheduler, mp=t_mp, sp=t_sampling,
                  prom=t_prom),
}
ENCODINGS = [0] + ([1] if t_remote.HAVE_MSGPACK else [])
#: A schema constraint: it crosses the wire as its spec (a dict) and
#: compiles in seconds.
SPEC = {"table": "t", "columns": ["a"]}


def twin(scenario):
    """Run `scenario(pkg)` on both packages; the port's observation must
    equal JAX's. Returns the port's."""
    want = scenario(PKGS["jax"])
    got = scenario(PKGS["torch"])
    assert got == want
    return got


def _no_sleep(_s):
    pass


def fast_retry(pkg, attempts=4):
    return pkg["res"].RetryPolicy(max_attempts=attempts, base_delay_s=0.001,
                                  max_delay_s=0.01)


def raised(fn):
    """(exception type name, message) of `fn()`, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the observation
        return type(e).__name__, str(e)
    return None


def plain(x):
    """A decoded message with numpy arrays as (dtype, shape, values)."""
    if isinstance(x, np.ndarray):
        return (str(x.dtype), list(x.shape), x.tolist())
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


# ------------------------------------------------------------- wire format


def rand_payload(rng, depth=0):
    kind = rng.integers(0, 8 if depth < 3 else 5)
    if kind == 0:
        return int(rng.integers(-(2**31), 2**31))
    if kind == 1:
        return float(rng.normal())
    if kind == 2:
        return "s" * int(rng.integers(0, 5)) + str(rng.integers(0, 99))
    if kind == 3:
        return rng.integers(-128, 127, size=(2, 3)).astype(np.int8)
    if kind == 4:
        return rng.normal(size=(3, 2)).astype(np.float32)
    if kind == 5:
        return [rand_payload(rng, depth + 1) for _ in range(3)]
    if kind == 6:
        return {f"k{i}": rand_payload(rng, depth + 1) for i in range(3)}
    return bytes(rng.integers(0, 256, size=5).astype(np.uint8))


@pytest.mark.parametrize("enc", ENCODINGS)
def test_frame_roundtrip_property_both_encodings(enc):
    """Random nested payloads (ints, floats, strings, lists, dicts, the
    blobs' int8 and f32 arrays, bytes) encode to the same bytes in both
    packages and round-trip bit for bit through the port's decoder fed in
    awkward chunk sizes."""
    rng = np.random.default_rng(0)
    msgs = [{"op": "t", "seq": i, "payload": rand_payload(rng)} for i in range(20)]
    stream = b"".join(t_remote.encode_frame(m, enc) for m in msgs)
    assert stream == b"".join(jax_remote.encode_frame(m, enc) for m in msgs)
    dec, got, i = t_remote.FrameDecoder(), [], 0
    while i < len(stream):
        step = int(rng.integers(1, 70))
        got.extend(dec.feed(stream[i:i + step]))
        i += step
    dec.eof()
    assert [plain(m) for m in got] == [plain(m) for m in msgs]
    assert [plain(m) for m in jax_remote.FrameDecoder().feed(stream)] == \
        [plain(m) for m in got]


def test_frame_rejections_typed():
    """Garbage magic, a foreign protocol version, an oversize length field,
    an undecodable body, a truncated stream and a non-object payload are
    refused typed, with JAX's types and messages."""
    def scenario(pkg):
        r = pkg["remote"]
        good = r.encode_frame({"op": "x"}, 0)
        bumped = bytearray(good)
        bumped[2] = r.PROTOCOL_VERSION + 1
        hdr = struct.pack(">2sBBI", b"LT", r.PROTOCOL_VERSION, 0, r._MAX_FRAME + 1)
        bad = struct.pack(">2sBBI", b"LT", r.PROTOCOL_VERSION, 0, 4) + b"\xff\xfe\x00\x01"
        payload = json.dumps([1, 2]).encode()
        framed = struct.pack(">2sBBI", b"LT", r.PROTOCOL_VERSION, 0,
                             len(payload)) + payload
        dec = r.FrameDecoder()
        partial = dec.feed(good[:len(good) - 2])
        return (raised(lambda: r.FrameDecoder().feed(b"XX" + good[2:])),
                raised(lambda: r.FrameDecoder().feed(bytes(bumped))),
                raised(lambda: r.FrameDecoder().feed(hdr)),
                raised(lambda: r.FrameDecoder().feed(bad))[0],
                partial, raised(dec.eof),
                raised(lambda: r.FrameDecoder().feed(framed)))

    got = twin(scenario)
    assert [g[0] for g in (got[0], got[1], got[2], got[5], got[6])] == [
        "FrameError", "FrameVersionError", "FrameError", "FrameError", "FrameError"]
    assert got[3] == "FrameError" and "ceiling" in got[2][1] and "truncated" in got[5][1]


def test_error_codec_roundtrips_types():
    """Typed application errors cross the wire as themselves (Retry-After
    included); a subtype maps to its nearest wire-known ancestor
    (SchedulerStalled -> SchedulerCrashed), an unknown type to
    RuntimeError; the encoded records are JAX's."""
    def scenario(pkg):
        r, res = pkg["remote"], pkg["res"]
        out = []
        for exc in (res.Overloaded("full", retry_after_s=7.5), res.DeadlineExceeded("late"),
                    res.SchedulerStalled("wedge"), ValueError("shape"), KeyError("weird"),
                    r.ReplicaUnreachable("gone")):
            wire = r._encode_error(exc)
            back = r._decode_error(wire)
            out.append((wire, type(back).__name__, str(back),
                        getattr(back, "retry_after_s", None),
                        isinstance(back, res.SchedulerCrashed)))
        return out

    got = twin(scenario)
    assert got[0][1:4] == ("Overloaded", "full", 7.5)
    assert got[2][1] == "SchedulerCrashed" and got[4][1] == "RuntimeError"
    assert got[5][4] is True  # ReplicaUnreachable is a SchedulerCrashed


def make_request(pkg, **kw):
    return pkg["sched"]._Request(ids=kw.pop("ids", [1, 5, 9]), max_new=kw.pop("max_new", 16),
                                 temperature=kw.pop("temperature", 0.8),
                                 top_p=kw.pop("top_p", 0.9), top_k=kw.pop("top_k", 40),
                                 seed=kw.pop("seed", 7), future=Future(), **kw)


def test_request_wire_roundtrip_with_blob():
    """A `_Request` with committed tokens, the resume state and a KV blob
    (int8 pages and f32 scales) survives the wire content-exactly, and its
    requeue frame is JAX's byte for byte. The port's bf16 pages cross as
    their int16 bit patterns and import back bit for bit."""
    pages = np.arange(2 * 3 * 2 * 4 * 2, dtype=np.int8).reshape(2, 3, 2, 4, 2)
    scales = np.linspace(0, 1, 2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)

    def scenario(pkg):
        r = pkg["remote"]
        req = make_request(pkg)
        req.rid, req.generated, req.resume_pref, req.rng_count = 42, [10, 11, 12], 3, 2
        req.spilled = (pages, scales)
        req.handoff = {"t_pack": 1.0, "pages": 3, "bytes": 144, "src": "r0"}
        frame = r.encode_frame({"req": r.request_to_wire(req)}, 0)
        back = r.request_from_wire(r.FrameDecoder().feed(frame)[0]["req"])
        assert back.future._lsot_request is back and back.deadline is None
        return (frame, back.ids, back.rid, back.generated, back.resume_pref,
                back.rng_count, (back.temperature, back.top_p, back.top_k),
                [plain(a) for a in back.spilled], back.handoff)

    got = twin(scenario)
    assert got[2] == 42 and got[7][0] == plain(pages) and got[7][1] == plain(scales)
    # bf16 pages: exported as int16, restored bit for bit after the wire.
    pool = t_kv.init_page_pool(TINY, 4, 8, dtype=torch.bfloat16, device="cpu")
    for arr in pool.values():
        arr.copy_(torch.randn(arr.shape, generator=torch.Generator().manual_seed(3)))
    blob = t_kv.export_pages(pool, [1, 2])
    assert {str(a.dtype) for a in blob} == {"int16"}
    req = make_request(PKGS["torch"])
    req.spilled = blob
    for enc in ENCODINGS:
        wire = t_remote.FrameDecoder().feed(t_remote.encode_frame(
            {"req": t_remote.request_to_wire(req)}, enc))[0]["req"]
        assert wire["spilled"][0].dtype == np.int16
        dst = t_kv.init_page_pool(TINY, 4, 8, dtype=torch.bfloat16, device="cpu")
        t_kv.import_pages(dst, [0, 3], t_remote.request_from_wire(wire).spilled)
        for a, b in zip(pool.values(), dst.values()):
            assert torch.equal(a[:, [1, 2]].view(torch.int16), b[:, [0, 3]].view(torch.int16))


def test_token_ledger_single_flight():
    def scenario(pkg):
        led = pkg["remote"]._TokenLedger(cap=4)
        calls = []

        def run():
            calls.append(1)
            return len(calls)

        seen = [led.get_or_run("t1", run), led.get_or_run("t1", run)]
        led.get_or_run(None, run)
        led.get_or_run(None, run)
        n_none = len(calls)
        for i in range(6):
            led.get_or_run(f"x{i}", run)
        led.get_or_run("t1", run)  # aged out: runs again
        return seen, n_none, len(calls)

    assert twin(scenario) == ([(1, True), (1, False)], 3, 10)


def test_token_ledger_single_flight_mid_execution():
    """A duplicate arriving while the first execution runs parks on the
    in-flight marker; a failed execution unregisters, so a retry runs."""
    def scenario(pkg):
        led = pkg["remote"]._TokenLedger()
        started, release = threading.Event(), threading.Event()
        calls, results = [], []

        def slow():
            calls.append(1)
            started.set()
            release.wait(5)
            return "v"

        t1 = threading.Thread(target=lambda: results.append(led.get_or_run("t", slow)))
        t1.start()
        assert started.wait(5)
        t2 = threading.Thread(target=lambda: results.append(led.get_or_run("t", slow)))
        t2.start()
        time.sleep(0.05)  # t2 parks on the marker
        mid = len(calls)
        release.set()
        t1.join(5)
        t2.join(5)

        def boom():
            raise RuntimeError("transient")

        err = raised(lambda: led.get_or_run("f", boom))
        led.get_or_run("f", lambda: "ok")
        return mid, len(calls), sorted(r[0] for r in results), err, \
            led.get_or_run("f", lambda: "other")[0]

    assert twin(scenario) == (1, 1, ["v", "v"], ("RuntimeError", "transient"), "ok")


# ---------------------------------------------------- loopback envelope


class _Counting:
    """A toy replica counting its submits (either package's toy)."""

    def __init__(self, pkg, **kw):
        self.inner = pkg["toy"](**kw)
        self.submits = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def submit(self, *a, **k):
        self.submits += 1
        return self.inner.submit(*a, **k)


def test_loopback_fast_path_is_the_direct_call():
    """Without a fault spec the loopback transport returns the scheduler's
    own future, and attribute reads pass through."""
    def scenario(pkg):
        toy = pkg["toy"]()
        tr = pkg["remote"].LoopbackTransport(toy, "r0")
        tr.start()
        try:
            out = tr.submit([3, 4], seed=5).result(timeout=5)
            return (out, tr.backlog_score() == toy.backlog_score(),
                    tr.transport_stats())
        finally:
            tr.shutdown()

    got = twin(scenario)
    assert got[0] == ToyScheduler.expected([3, 4], 6, 5)
    assert got[2]["endpoints"]["submit"]["rpcs"] == 1 and got[2]["kind"] == "loopback"


def test_loopback_drop_retries_never_double_generate():
    """`net:drop` loses responses after the server executed: the retry
    re-delivers the same token and binds to the first execution, so the
    scheduler sees each request once; the retry counters are JAX's (one
    seeded fault schedule)."""
    def scenario(pkg):
        pkg["faults"].configure("net:drop:0.5", 3)
        toy = _Counting(pkg)
        tr = pkg["remote"].LoopbackTransport(toy, "r0", retry_policy=fast_retry(pkg, 6),
                                             sleep=_no_sleep)
        tr.start()
        try:
            outs = [tr.submit([3 + i, 4 + i], seed=50 + i).result(timeout=10)
                    for i in range(6)]
            return outs, toy.submits, tr.transport_stats()["endpoints"]["submit"]
        finally:
            pkg["faults"].clear()
            tr.shutdown()

    got = twin(scenario)
    assert got[0] == [ToyScheduler.expected([3 + i, 4 + i], 6, 50 + i) for i in range(6)]
    assert got[1] == 6 and got[2]["retries"] >= 1


def test_loopback_dup_absorbed_by_ledger():
    def scenario(pkg):
        pkg["faults"].configure("net:dup:1", 0)
        toy = _Counting(pkg)
        tr = pkg["remote"].LoopbackTransport(toy, "r0", sleep=_no_sleep)
        tr.start()
        try:
            return tr.submit([8, 2], seed=9).result(timeout=10), toy.submits
        finally:
            pkg["faults"].clear()
            tr.shutdown()

    assert twin(scenario) == (ToyScheduler.expected([8, 2], 6, 9), 1)


def test_loopback_delay_past_budget_is_typed_timeout_then_unreachable():
    """A `net:delay` at or over the rpc budget burns the budget (never the
    injected delay) and raises TransportTimeout per attempt; the exhausted
    ladder declares the replica unreachable, typed as a SchedulerCrashed."""
    def scenario(pkg):
        pkg["faults"].configure("net:delay:1:5", 0)
        slept = []
        tr = pkg["remote"].LoopbackTransport(pkg["toy"](), "r0",
                                             retry_policy=fast_retry(pkg, 3),
                                             rpc_timeout_s=0.05, sleep=slept.append)
        tr.start()
        try:
            err = raised(lambda: tr.submit([1, 2], seed=1))
            st = tr.transport_stats()
            return (err[0], st["endpoints"]["submit"]["timeouts"], st["unreachable"],
                    slept.count(0.05), 5.0 in slept,
                    isinstance(tr._crash, pkg["res"].SchedulerCrashed))
        finally:
            pkg["faults"].clear()
            tr.shutdown()

    assert twin(scenario) == ("ReplicaUnreachable", 3, True, 3, False, True)


def test_mark_unreachable_fails_pending_typed_and_gates_stream():
    """An unreachable declaration fails the pending client futures with
    ReplicaUnreachable and gates the zombie stream: the inner scheduler's
    late resolution neither crashes its worker nor reaches the client."""
    def scenario(pkg):
        pkg["faults"].configure("net:drop:0.000001", 0)  # the envelope, no firing
        toy = pkg["toy"](tokens_per_request=4, token_sleep_s=0.05)
        tr = pkg["remote"].LoopbackTransport(toy, "r0", sleep=_no_sleep)
        tr.start()
        try:
            seen = []
            fut = tr.submit([5, 6], seed=3, on_token=seen.append)
            exc = tr.mark_unreachable("test partition")
            err = raised(lambda: fut.result(timeout=5))
            deadline = time.monotonic() + 5
            while toy.backlog_score()[1] and time.monotonic() < deadline:
                time.sleep(0.01)  # the zombie finishes inside the toy
            return (type(exc).__name__, err[0], seen,
                    tr.transport_stats()["lease_expiries"],
                    raised(lambda: tr.submit([7, 8]))[0])
        finally:
            pkg["faults"].clear()
            tr.shutdown()

    assert twin(scenario) == ("ReplicaUnreachable", "ReplicaUnreachable", [], 1,
                              "ReplicaUnreachable")


# ----------------------------------------------------- lease + pool wiring


def test_pool_lease_expiry_targets_partitioned_replica():
    """A partition of r1 (every ping failing) expires its lease after
    `lease_misses` beats: only r1 is declared unreachable and rebuilt,
    while its sibling serves; the healed fleet serves on both."""
    def scenario(pkg):
        rebuilt = []
        lb = pkg["remote"].LoopbackTransport

        def factory(i):
            if i == 1:
                pkg["faults"].clear()  # the partition heals on rebuild
            rebuilt.append(i)
            return lb(pkg["toy"](), f"r{i}", retry_policy=fast_retry(pkg, 2),
                      sleep=_no_sleep)

        pool = pkg["sched"].SchedulerPool(
            [lb(pkg["toy"](), "r0", sleep=_no_sleep),
             lb(pkg["toy"](), "r1", retry_policy=fast_retry(pkg, 2), sleep=_no_sleep)],
            factory=factory, max_restarts=3, restart_policy=fast_retry(pkg, 4),
            rng=random.Random(0), lease_s=0.02, lease_misses=2)
        pool.start()
        try:
            pkg["faults"].configure("net:partition_r1:1", 0)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and 1 not in rebuilt:
                time.sleep(0.01)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                reps = {r["replica"]: r for r in pool.replica_health()}
                if reps["r1"]["state"] in ("ready", "degraded"):
                    break
                time.sleep(0.01)
            out = pool.submit([4, 2], seed=6).result(timeout=10)
            ev = [r for r in pool.flight_snapshot() if r.get("kind") == "lease_expired"]
            return sorted(set(rebuilt)), out, ev[-1]["replica"] if ev else None
        finally:
            pkg["faults"].clear()
            pool.shutdown()

    assert twin(scenario) == ([1], ToyScheduler.expected([4, 2], 6, 6), "r1")


def test_replica_loads_and_health_carry_transport_block():
    def scenario(pkg):
        pool = pkg["sched"].SchedulerPool(
            [pkg["remote"].LoopbackTransport(pkg["toy"](), "r0", sleep=_no_sleep)],
            lease_s=0.0)
        pool.start()
        try:
            pool.submit([1, 2]).result(timeout=5)
            return (pool.replica_loads()[0]["transport"],
                    pool.replica_health()[0]["transport"],
                    [r["replica"] for r in pool.transport_stats["replicas"]])
        finally:
            pool.shutdown()

    got = twin(scenario)
    assert got[0]["kind"] == "loopback" and got[0]["rpcs"] == 1
    assert got[1]["unreachable"] is False and got[2] == ["r0"]


# ------------------------------------------------------- socket transport


def test_socket_roundtrip_streaming_and_errors():
    """Submit and stream over a localhost socket against a toy replica:
    the stream is the result exactly once, the ack's digest feeds the
    backlog score."""
    def scenario(pkg):
        toy = pkg["toy"]()
        toy.start()
        srv = pkg["remote"].ReplicaServer(toy)
        tr = pkg["remote"].SocketTransport(srv.address, label="r0")
        try:
            toks = []
            fut = tr.submit([9, 4], seed=7, on_token=toks.append)
            out = fut.result(timeout=10)
            return (out, toks == out, fut._lsot_replica, type(tr.backlog_score()).__name__,
                    tr._busy_now() in (False, True))
        finally:
            tr.shutdown()
            srv.close()
            toy.shutdown()

    assert twin(scenario) == (ToyScheduler.expected([9, 4], 6, 7), True, "r0", "tuple",
                              True)


def test_socket_hello_digest_and_version_guard():
    """The hello ships the digest at the protocol version; a client from the
    future is refused typed by the server."""
    def scenario(pkg):
        r = pkg["remote"]
        toy = pkg["toy"]()
        srv = r.ReplicaServer(toy)
        tr = r.SocketTransport(srv.address, label="r2")
        try:
            with socket.create_connection((srv.host, srv.port), timeout=10) as s:
                s.sendall(r.encode_frame({"op": "hello", "seq": 1,
                                          "client_version": r.PROTOCOL_VERSION + 1}))
                dec, msgs = r.FrameDecoder(), []
                while not msgs:
                    data = s.recv(65536)
                    if not data:
                        break
                    msgs = dec.feed(data)
            return (tr._digest["version"], tr._digest["push_handoffs"], msgs[0]["ok"],
                    msgs[0]["err"]["msg"])
        finally:
            tr.shutdown()
            srv.close()

    got = twin(scenario)
    assert got[0] == 1 and got[2] is False and "protocol" in got[3]


def test_socket_server_death_lease_fails_pending_typed():
    """A dead server severs the connection; the in-flight future survives
    until the lease declares the replica unreachable, then fails typed, and
    the crash marker makes placement skip the replica."""
    def scenario(pkg):
        r = pkg["remote"]
        toy = pkg["toy"](tokens_per_request=8, token_sleep_s=0.5)
        toy.start()
        srv = r.ReplicaServer(toy)
        tr = r.SocketTransport(srv.address, label="r0", retry_policy=fast_retry(pkg, 2),
                               rpc_timeout_s=2.0, sleep=_no_sleep)
        try:
            fut = tr.submit([1, 2], seed=0)  # the slow toy keeps it in flight
            srv.close()
            ping = raised(lambda: tr.ping(timeout=1.0))
            tr.mark_unreachable("lease expired (test)")
            return (isinstance(ping and getattr(r, ping[0]), type),
                    raised(lambda: fut.result(timeout=5))[0], tr._crash is not None,
                    raised(lambda: tr.submit([3, 4]))[0])
        finally:
            tr.shutdown()
            srv.close()
            toy.shutdown()

    assert twin(scenario) == (True, "ReplicaUnreachable", True, "ReplicaUnreachable")


# ------------------------------------------------ parity on real schedulers


@pytest.fixture(scope="module")
def parts():
    """Per package: TINY f32 params (the port's bridged from JAX's), the
    byte tokenizer and the schema constraint compiled by that package."""
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jtok, ttok = JaxByteTok(), ByteTokenizer()
    return {"jax": (JAX_TINY, jp, jtok, jax_get_constraint(SPEC, jtok, (2,))),
            "torch": (TINY, tp, ttok, get_constraint(SPEC, ttok, (2,)))}


def mk_sched(parts, pkg, **kw):
    cfg, params, _tok, _cm = parts[pkg["side"]]
    kw = dict(dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(2,),
                   max_seq=96), **kw)
    if pkg["side"] == "torch":
        kw["device"] = "cpu"
    return pkg["sched"].ContinuousBatchingScheduler(cfg, params, **kw)


def mixed_wave(pkg, parts, sub):
    """Greedy, sampled, greedy and constrained requests at once; their
    outputs in order."""
    SP = pkg["sp"].SamplingParams
    _cfg, _p, tok, cm = parts[pkg["side"]]
    reqs = [([1, 5, 9], SP(), None, 8), ([1, 7, 11], SP(temperature=0.8, top_p=0.95), None, 8),
            ([1, 19, 33, 2, 7], SP(), None, 8),
            (tok.encode("SELECT", add_bos=True), SP(), cm, max(16, cm.min_new_tokens))]
    futs = [sub(ids, max_new_tokens=mn, sampling=sp, seed=60 + i, constraint=c)
            for i, (ids, sp, c, mn) in enumerate(reqs)]
    return [f.result(timeout=300) for f in futs]


GREEDY = (0, 2, 3)  # the wave's greedy requests: equal across the packages


def test_loopback_fleet_token_and_accounting_identical(parts):
    """A loopback fleet is token- and accounting-identical to the direct
    fleet in each package (every admitted and retired rid, placement and
    lifecycle event by replica; the prefix counters), and its greedy tokens
    are JAX's."""
    def strip(records):
        per: dict = {}
        for r in records:
            agg = per.setdefault(r.get("replica"), {"admitted": set(), "retired": set(),
                                                    "events": [], "placements": []})
            agg["admitted"].update(r.get("admitted") or [])
            agg["retired"].update(r.get("retired") or [])
            if r.get("kind") == "placement":
                agg["placements"].append(r.get("to"))
            elif r.get("kind"):
                agg["events"].append(r["kind"])
        return per

    def scenario(pkg):
        seen = []
        for wrap in (False, True):
            scheds = [mk_sched(parts, pkg), mk_sched(parts, pkg)]
            if wrap:
                scheds = [pkg["remote"].LoopbackTransport(s, f"r{i}")
                          for i, s in enumerate(scheds)]
            pool = pkg["sched"].SchedulerPool(scheds, lease_s=0.0)
            pool.start()
            try:
                outs = mixed_wave(pkg, parts, pool.submit)
                prefix = pool.prefix_stats
            finally:
                pool.shutdown()  # the last retire records land after the results
            seen.append((outs, strip(pool.flight_snapshot()), prefix))
        assert seen[0] == seen[1]
        return [seen[0][0][i] for i in GREEDY]

    twin(scenario)


def test_socket_fleet_token_identical(parts):
    """The same mixed wave through a ReplicaServer and a SocketTransport
    gives the direct call's tokens in each package (the constraint crosses
    as its spec and compiles on the worker), and JAX's greedy tokens; the
    transport's counters are JAX's."""
    def scenario(pkg):
        _cfg, _p, tok, _cm = parts[pkg["side"]]
        get = get_constraint if pkg["side"] == "torch" else jax_get_constraint
        with mk_sched(parts, pkg) as direct:
            want = mixed_wave(pkg, parts, direct.submit)
        worker = mk_sched(parts, pkg)
        worker.start()
        srv = pkg["remote"].ReplicaServer(worker,
                                          constraint_resolver=lambda s: get(s, tok, (2,)))
        tr = pkg["remote"].SocketTransport(srv.address, label="r0")
        try:
            outs = mixed_wave(pkg, parts, tr.submit)
            assert outs == want
            st = tr.transport_stats()
            return [outs[i] for i in GREEDY], {op: rec["rpcs"]
                                              for op, rec in st["endpoints"].items()}
        finally:
            tr.shutdown()
            srv.close()
            worker.shutdown()

    got = twin(scenario)
    assert got[1] == {"submit": 4}


def test_scheduler_cancel_reaches_a_remote_request(parts):
    """`ContinuousBatchingScheduler.cancel` on a remote request's future
    calls its `_lsot_cancel`, which ships the cancel over the wire: the
    worker retires the request at its next harvest, short of its budget."""
    def scenario(pkg):
        worker = mk_sched(parts, pkg, stop_ids=(-1,))  # no stop: only a cancel ends it early
        worker.start()
        srv = pkg["remote"].ReplicaServer(worker)
        tr = pkg["remote"].SocketTransport(srv.address, label="r0")
        try:
            started = threading.Event()
            fut = tr.submit([1, 5, 9], max_new_tokens=72, on_token=lambda t: started.set())
            assert started.wait(60)
            pkg["sched"].ContinuousBatchingScheduler.cancel(fut)
            out = fut.result(timeout=120)
            return len(out) < 72, tr.transport_stats()["endpoints"]["cancel"]
        finally:
            tr.shutdown()
            srv.close()
            worker.shutdown()

    assert twin(scenario) == (True, {"rpcs": 1, "retries": 0, "timeouts": 0, "errors": 0})


def test_socket_rejects_compiled_only_constraint(parts):
    """Compiled tables without a serializable spec cannot cross the wire:
    refused typed at submit."""
    def scenario(pkg):
        cm = parts[pkg["side"]][3]
        toy = pkg["toy"]()
        srv = pkg["remote"].ReplicaServer(toy)
        tr = pkg["remote"].SocketTransport(srv.address, label="r0")
        try:
            bare = dataclasses.replace(cm)  # a fresh instance: no wire_spec
            assert getattr(bare, "wire_spec", None) is None
            return raised(lambda: tr.submit([1, 2], constraint=bare))
        finally:
            tr.shutdown()
            srv.close()

    got = twin(scenario)
    assert got[0] == "ValueError" and "serializable spec" in got[1]


def test_remote_prefill_push_fleet_counts_equal_jax(parts):
    """A remote prefill worker (ReplicaServer over a prefill scheduler)
    beside a local decode replica: every request crosses as a pushed
    handoff, the greedy tokens are the mixed control's, and the push and
    handoff counters, and their lsot_fleet_* and lsot_transport_* text, are
    JAX's."""
    def scenario(pkg):
        kw = dict(kv_layout="paged", kv_page_size=8)
        with mk_sched(parts, pkg, **kw) as ctl:
            want = [ctl.submit([1, 5, 9 + i], max_new_tokens=8).result(timeout=120)
                    for i in range(3)]
        worker = mk_sched(parts, pkg, phase_role="prefill", **kw)
        worker.start()
        srv = pkg["remote"].ReplicaServer(worker)
        tr = pkg["remote"].SocketTransport(srv.address, label="r0")
        pool = pkg["sched"].SchedulerPool([tr, mk_sched(parts, pkg, phase_role="decode",
                                                        **kw)], lease_s=0.0)
        pool.start()
        try:
            streams = [[] for _ in range(3)]
            futs = [pool.submit([1, 5, 9 + i], max_new_tokens=8, on_token=streams[i].append)
                    for i in range(3)]
            outs = [f.result(timeout=120) for f in futs]
            fleet = pool.fleet_stats()
            loads = {r["replica"]: r for r in pool.replica_loads()}
            counts = {k: v for k, v in fleet.items() if not k.startswith("push_place_p")}
            text = pkg["prom"].render_prometheus({"duckdb-nsql": {"serving": {
                "fleet": counts, "transport": pool.transport_stats}}})
            families = sorted(ln for ln in text.splitlines()
                              if ln.startswith(("lsot_fleet_", "lsot_transport_")))
            return (outs == want, streams == outs, outs, families,
                    {k: fleet[k] for k in ("pushed", "push_bytes", "push_placed")},
                    (loads["r0"]["handoff_stats"]["exports"],
                     loads["r1"]["handoff_imports"]),
                    [r["to"] for r in pool.flight_snapshot()
                     if r.get("kind") == "handoff_place"])
        finally:
            pool.shutdown()
            srv.close()
            worker.shutdown()

    got = twin(scenario)
    assert got[0] and got[1] and got[4]["pushed"] == 3 and got[5] == (3, 3)
    assert got[6] == ["r1"] * 3
    assert 'lsot_fleet_pushed_handoffs_total{model="duckdb-nsql"} 3' in got[3]


# -------------------------------------------------- multi-tenant attribution


def qos_toy(pkg):
    class QosToy(pkg["toy"]):
        supports_qos = True

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.attributions = []

        def submit(self, ids, max_new_tokens=256, sampling=None, seed=0, on_token=None,
                   constraint=None, deadline_s=None, trace=None, tenant="", qos=""):
            self.attributions.append((tenant, qos))
            return super().submit(ids, max_new_tokens=max_new_tokens, sampling=sampling,
                                  seed=seed, on_token=on_token, constraint=constraint,
                                  deadline_s=deadline_s, trace=trace)

    return QosToy()


def test_request_wire_carries_tenant_qos_and_defaults_sane():
    """The wire form keeps tenant and qos; an unlabeled request adds no
    keys, and a frame without them decodes to the unlabeled defaults."""
    def scenario(pkg):
        r = pkg["remote"]
        req = make_request(pkg, ids=[1, 5], max_new=4, temperature=0.0, top_p=1.0,
                           top_k=0, seed=3, tenant="acme", qos="interactive")
        wire = r.request_to_wire(req)
        back = r.request_from_wire(r.FrameDecoder().feed(r.encode_frame({"req": wire}))[0]
                                   ["req"])
        bare = r.request_to_wire(make_request(pkg, ids=[2], max_new=4, temperature=0.0,
                                              top_p=1.0, top_k=0, seed=0))
        old = r.request_from_wire(bare)
        return (wire["tenant"], wire["qos"], back.tenant, back.qos, sorted(bare),
                old.tenant, old.qos)

    got = twin(scenario)
    assert got[:4] == ("acme", "interactive", "acme", "interactive")
    assert "tenant" not in got[4] and got[5:] == ("", "")


def test_loopback_gates_tenant_kwargs_on_supports_qos():
    """Tenant and qos reach only a scheduler that declares the axis."""
    def scenario(pkg):
        tr = pkg["remote"].LoopbackTransport(pkg["toy"](), "r0")
        tr.start()
        try:
            legacy = (tr.supports_qos,
                      tr.submit([3, 4], seed=5, tenant="acme", qos="batch").result(timeout=5))
        finally:
            tr.shutdown()
        aware = qos_toy(pkg)
        tr2 = pkg["remote"].LoopbackTransport(aware, "r1")
        tr2.start()
        try:
            tr2.submit([3, 4], seed=5, tenant="acme", qos="batch").result(timeout=5)
            tr2.submit([3, 4], seed=6).result(timeout=5)
        finally:
            tr2.shutdown()
        return legacy, tr2.supports_qos, aware.attributions

    assert twin(scenario) == ((False, ToyScheduler.expected([3, 4], 6, 5)), True,
                              [("acme", "batch"), ("", "")])


def test_socket_submit_carries_tenant_qos_end_to_end():
    """tenant and qos ride the submit frame; the worker re-gates them on its
    scheduler's `supports_qos`, so a legacy worker scheduler is safe."""
    def scenario(pkg):
        out = []
        for sched in (qos_toy(pkg), pkg["toy"]()):
            sched.start()
            srv = pkg["remote"].ReplicaServer(sched)
            tr = pkg["remote"].SocketTransport(srv.address, label="r0")
            try:
                out.append(tr.submit([9, 4], seed=7, tenant="acme",
                                     qos="replay").result(timeout=10))
                out.append(tr.submit([9, 4], seed=8).result(timeout=10))
            finally:
                tr.shutdown()
                srv.close()
                sched.shutdown()
            out.append(getattr(sched, "attributions", None))
        return out

    got = twin(scenario)
    assert got[2] == [("acme", "replay"), ("", "")] and got[5] is None


def test_remote_submit_with_model_the_worker_lacks(parts):
    """A worker stamped with a model id checks the frame's model id before
    generating: a mismatch fails typed UnknownModel across the wire, the
    matching model generates."""
    def scenario(pkg):
        sched = mk_sched(parts, pkg, model_id="sql")
        sched.start()
        srv = pkg["remote"].ReplicaServer(sched)
        tr = pkg["remote"].SocketTransport(
            srv.address, label="rX", retry_policy=pkg["res"].RetryPolicy(
                max_attempts=1, base_delay_s=0.001, max_delay_s=0.01), rpc_timeout_s=30.0)
        try:
            err = raised(lambda: tr.submit([1, 5, 9], max_new_tokens=4,
                                           model_id="explainer").result(timeout=60))
            out = tr.submit([1, 5, 9], max_new_tokens=4, model_id="sql").result(timeout=120)
            return tr.model_id, err, out
        finally:
            tr.shutdown()
            srv.close()
            sched.shutdown()

    got = twin(scenario)
    assert got[0] == "sql" and got[1][0] == "UnknownModel" and "explainer" in got[1][1]


# --------------------------------------------------- across the packages


@pytest.mark.parametrize("enc", ENCODINGS)
def test_frames_byte_equal_across_packages(enc):
    """The submit, ping, error-ack and f32-blob requeue messages, each built
    by its own package's functions, are the same bytes under each
    encoding."""
    blob = (np.linspace(-1, 1, 2 * 3 * 2 * 8 * 4, dtype=np.float32).reshape(2, 3, 2, 8, 4),
            np.arange(2 * 3 * 2 * 8 * 4, dtype=np.float32).reshape(2, 3, 2, 8, 4))

    def scenario(pkg):
        r = pkg["remote"]
        submit = {"op": "submit", "seq": 1, "tok": "a1b2c3d4:1", "rid": 0, "ids": [1, 5, 9],
                  "max_new": 8, "sampling": r._sampling_to_wire(pkg["sp"].SamplingParams(
                      temperature=0.7, top_p=0.9, top_k=20)), "seed": 3, "tenant": "acme"}
        req = make_request(pkg)
        req.rid, req.generated, req.rng_count, req.resume_pref = 5, [48, 210], 1, 0
        req.spilled = blob
        req.handoff = {"t_pack": 2.5, "pages": 3, "bytes": int(sum(a.nbytes for a in blob)),
                       "src": "r0"}
        wire = r.request_to_wire(req)
        return [r.encode_frame(m, enc) for m in (
            submit, {"op": "ping", "seq": 2},
            {"re": 3, "ok": False,
             "err": r._encode_error(pkg["res"].Overloaded("full", retry_after_s=2.5))},
            {"op": "requeue", "seq": 4, "tok": "a1b2c3d4:2", "req": wire,
             "rid": wire["rid"]},
            {"ev": "handoff", "sub": "a1b2c3d4:2", "ho": "a1b2c3d4:2#ho1", "req": wire})]

    got = twin(scenario)
    assert len(got[3]) > sum(a.nbytes for a in blob)


def test_port_transport_against_jax_server_and_reverse(parts):
    """The port's SocketTransport against JAX's ReplicaServer, and JAX's
    transport against the port's server: greedy streams equal the direct
    call on the serving side's scheduler, delivered once."""
    prompts = [[1, 5, 9], [1, 19, 33, 2, 7]]
    got = {}
    for srv_pkg, cli_pkg in ((PKGS["jax"], PKGS["torch"]), (PKGS["torch"], PKGS["jax"])):
        with mk_sched(parts, srv_pkg) as direct:
            want = [direct.submit(p, max_new_tokens=8).result(timeout=120) for p in prompts]
        worker = mk_sched(parts, srv_pkg)
        worker.start()
        srv = srv_pkg["remote"].ReplicaServer(worker)
        tr = cli_pkg["remote"].SocketTransport(srv.address, label="r0")
        try:
            assert tr.num_slots == 2 and tr.max_seq == 96 and tr.cfg.name == TINY.name
            streams = [[] for _ in prompts]
            futs = [tr.submit(p, max_new_tokens=8, on_token=streams[i].append)
                    for i, p in enumerate(prompts)]
            outs = [f.result(timeout=120) for f in futs]
        finally:
            tr.shutdown()
            srv.close()
            worker.shutdown()
        assert outs == want and streams == outs
        got[srv_pkg["side"]] = outs
    assert got["jax"] == got["torch"]


def test_oversized_push_fails_over_through_the_lease(parts, monkeypatch):
    """The frame ceiling patched below one pushed blob, in both packages: the
    worker's push raises FrameError inside its connection sink, which marks
    the connection dead; the pool learns it from the lease (a failover and
    a re-prefill on the decode sibling, not a typed refusal), the request
    completes with the control's tokens and nothing is lost."""
    def scenario(pkg):
        monkeypatch.setattr(pkg["remote"], "_MAX_FRAME", 1500)
        kw = dict(kv_layout="paged", kv_page_size=8)
        with mk_sched(parts, pkg, **kw) as ctl:
            want = ctl.submit([1, 5, 9], max_new_tokens=8).result(timeout=120)
        worker = mk_sched(parts, pkg, phase_role="prefill", **kw)
        worker.start()
        srv = pkg["remote"].ReplicaServer(worker)
        policy = fast_retry(pkg, 4)

        def make_replica(i):
            if i == 0:
                return pkg["remote"].SocketTransport(srv.address, label="r0",
                                                     retry_policy=fast_retry(pkg, 2),
                                                     rpc_timeout_s=2.0)
            return mk_sched(parts, pkg, phase_role="decode", **kw)

        sup = pkg["sup"].SupervisedScheduler(
            lambda: pkg["sched"].SchedulerPool(
                [make_replica(0), make_replica(1)], factory=make_replica, max_restarts=1,
                restart_policy=policy, rng=random.Random(0), lease_s=0.05,
                lease_misses=2),
            max_restarts=3, restart_policy=policy, rng=random.Random(0)).start()
        try:
            out = sup.submit([1, 5, 9], max_new_tokens=8).result(timeout=120)
            pool = sup._inner
            reps = {r["replica"]: r for r in pool.replica_health()}
            return (out == want, sup.health()["lost"],
                    reps["r0"]["transport"]["lease_expiries"] >= 1,
                    reps["r1"]["restarts"], srv._pump_stats["pushed"] >= 1,
                    pool.fleet_stats()["pushed"])
        finally:
            sup.shutdown()
            srv.close()
            worker.shutdown()

    assert twin(scenario) == (True, 0, True, 0, True, 0)

"""Token streaming in the port, the layers of tests/test_streaming.py: the
scheduler's `on_token` -> `SchedulerBackend.complete_stream` ->
`GenerationService.generate_stream` -> `/api/generate` with `stream=true`,
on the CPU (TINY f32, ByteTokenizer). The streamed chunks join to exactly
the blocking text, which is the JAX scheduler backend's text on the same
bridged weights (tolerance: string-identical), a stop text that arrives
one character a token included; closing a stream cancels its request; the
app sends a completion as more than one NDJSON chunk."""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    SchedulerBackend as JaxSchedulerBackend,
)
from llm_based_apache_spark_optimization_tpu.tokenizer import (
    ByteTokenizer as JaxByteTokenizer,
)
from llm_based_apache_spark_optimization_tpu_torch.app import AppConfig, create_api_app
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    FakeBackend,
    GenerationService,
    SchedulerBackend,
)
from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

LAYOUTS = {"contiguous": {}, "paged": {"kv_layout": "paged", "kv_page_size": 16}}


@pytest.fixture(scope="module")
def both():
    jp = jax_init(JAX_TINY, jax.random.key(3), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def sched(both, layout="contiguous", **kw):
    kw = dict(dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,)),
              **LAYOUTS[layout], **kw)
    return ContinuousBatchingScheduler(TINY, both[1], **kw, device="cpu")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_on_token_streams_accepted_tokens(both, layout):
    seen = []
    with sched(both, layout) as s:
        out = s.submit([1, 5, 9], max_new_tokens=7, on_token=seen.append).result(60)
    assert seen == out and len(out) == 7


def test_on_token_callback_errors_do_not_kill_serving(both):
    def boom(tok):
        raise RuntimeError("consumer bug")

    with sched(both) as s:
        out = s.submit([1, 5], max_new_tokens=5, on_token=boom).result(60)
        again = s.submit([1, 5], max_new_tokens=5).result(60)
    assert len(out) == 5 and out == again


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_complete_stream_matches_blocking_and_jax(both, layout):
    """The chunks join to the blocking text, in more than one chunk, and
    that text is the JAX backend's on the same weights; `stats_out` gets
    the token counts and a TTFT."""
    kw = dict(num_slots=2, decode_chunk=4, prompt_bucket=16,
              stop_ids=(JAX_TINY.eos_id,), **LAYOUTS[layout])
    jb = JaxSchedulerBackend(JaxScheduler(JAX_TINY, both[0], **kw), JaxByteTokenizer(),
                             max_new_tokens=24)
    tb = SchedulerBackend(ContinuousBatchingScheduler(TINY, both[1], **kw, device="cpu"),
                          ByteTokenizer(), max_new_tokens=24)
    try:
        want = jb.complete("hello world").text
        blocking = tb.complete("hello world").text
        stats = {}
        chunks = list(tb.complete_stream("hello world", stats_out=stats))
    finally:
        jb.shutdown()
        tb.shutdown()
    assert "".join(chunks) == blocking == want
    assert len(chunks) > 1 and all(chunks)
    assert stats["prompt_tokens"] == 12 and 0 < stats["output_tokens"] <= 24
    assert stats["ttft_s"] > 0


def test_complete_stream_stop_text_spanning_chunks(both):
    """A stop text arriving a character a token never leaks its prefix: the
    stream equals the blocking text, cut before the stop."""
    s = sched(both, prompt_bucket=16)
    probe = SchedulerBackend(s, ByteTokenizer(), max_new_tokens=24)
    full = probe.complete("abc").text
    assert len(full) >= 8, full
    stop = full[4:6]
    backend = SchedulerBackend(s, ByteTokenizer(), max_new_tokens=24, stop_texts=(stop,))
    try:
        blocking = backend.complete("abc").text
        streamed = "".join(backend.complete_stream("abc"))
    finally:
        backend.shutdown()
    assert streamed == blocking == full[:full.find(stop)]


def test_stream_close_cancels_scheduler_request(both):
    """Closing the generator frees the single slot for a fresh request."""
    s = sched(both, num_slots=1, decode_chunk=2)
    backend = SchedulerBackend(s, ByteTokenizer(), max_new_tokens=90)
    try:
        gen = backend.complete_stream("ab")
        next(gen)
        gen.close()
        assert backend.complete("cd", max_new_tokens=4).output_tokens == 4
        assert all(r is None for r in s._slot_req)
    finally:
        backend.shutdown()


def test_stream_stop_text_cancels_remaining_budget(both):
    """Once a stop text lands the stream cancels its request, so the slot
    retires within a few rounds instead of decoding the whole budget."""
    s = sched(both, num_slots=1, decode_chunk=2)
    full = SchedulerBackend(s, ByteTokenizer(), max_new_tokens=8).complete("abc").text
    assert len(full) >= 4, full
    stop = full[2:4]
    backend = SchedulerBackend(s, ByteTokenizer(), max_new_tokens=100, stop_texts=(stop,))
    try:
        r0 = s.rounds_issued
        assert "".join(backend.complete_stream("abc")) == full[:full.find(stop)]
        # Without the cancel: 100 tokens, >= 50 rounds of 2.
        assert s.rounds_issued - r0 < 25, s.rounds_issued - r0
    finally:
        backend.shutdown()


def test_cancel_queued_request_never_occupies_slot(both):
    with sched(both, num_slots=1, decode_chunk=2) as s:
        busy = s.submit([1, 2], max_new_tokens=60)
        queued = s.submit([1, 3], max_new_tokens=60)
        s.cancel(queued)
        assert queued.result(timeout=60) == []
        assert len(busy.result(timeout=60)) == 60


def test_service_generate_stream_fake_backend_single_chunk():
    svc = GenerationService()
    svc.register("m", FakeBackend(lambda p: "SELECT 1"))
    assert list(svc.generate_stream("m", "question")) == ["SELECT 1"]
    assert svc.stats["m"]["requests"] == 1


def test_service_generate_stream_records_the_request(both):
    """The service streams the scheduler backend's chunks and records the
    request's tokens and latency, also when the consumer stops early."""
    svc = GenerationService()
    backend = SchedulerBackend(sched(both, prompt_bucket=16), ByteTokenizer(),
                               max_new_tokens=16)
    svc.register("m", backend)
    try:
        chunks = list(svc.generate_stream("m", "hello"))
        assert "".join(chunks) == svc.generate("m", "hello").response
        assert svc.stats["m"]["requests"] == 2
        assert svc.stats["m"]["total_tokens"] == 32
        gen = svc.generate_stream("m", "hello")
        next(gen)
        gen.close()
        assert svc.stats["m"]["requests"] == 3
    finally:
        svc.close()


def app_client(tmp_path, svc):
    cfg = AppConfig(input_dir=str(tmp_path / "in"), output_dir=str(tmp_path / "out"),
                    history_db=":memory:")
    return create_api_app(svc, SQLiteBackend, SQLiteHistory(), cfg).test_client()


def test_api_generate_streams_chunks(both, tmp_path):
    """`/api/generate` with stream=true sends the completion as several
    NDJSON chunks that join to the blocking response, then a done line;
    concurrent streams share the scheduler."""
    svc = GenerationService()
    svc.register("m", SchedulerBackend(sched(both, prompt_bucket=16), ByteTokenizer(),
                                       max_new_tokens=24))
    client = app_client(tmp_path, svc)
    try:
        blocking = client.post_json("/api/generate", {"model": "m", "prompt": "hello world",
                                                      "stream": False}).json()["response"]
        results = {}

        def one(i):
            r = client.post_json("/api/generate", {"model": "m", "prompt": "hello world",
                                                   "stream": True})
            results[i] = (r.status, [json.loads(ln) for ln in r.body.decode().splitlines()])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        svc.close()
    for status, lines in results.values():
        assert status == 200 and lines[-1]["done"] is True
        pieces = [ln["response"] for ln in lines[:-1]]
        assert len(pieces) > 1 and "".join(pieces) == blocking


def test_api_stream_oversize_prompt_is_400(both, tmp_path):
    """A stream=true prompt that leaves no decode room is a 400 before the
    headers, as on the blocking branch; a fitting prompt streams."""
    svc = GenerationService()
    svc.register("m", SchedulerBackend(sched(both, num_slots=1, decode_chunk=2, max_seq=32),
                                       ByteTokenizer(), max_new_tokens=4))
    client = app_client(tmp_path, svc)
    try:
        r = client.post_json("/api/generate", {"model": "m", "prompt": "x" * 27,
                                               "stream": True})
        assert r.status == 400 and "error" in r.json()
        r = client.post_json("/api/generate", {"model": "m", "prompt": "ab",
                                               "stream": True})
        assert r.status == 200
        assert json.loads(r.body.decode().splitlines()[-1])["done"] is True
    finally:
        svc.close()

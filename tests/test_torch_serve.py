"""The port's GenerationService vs the JAX package's, on the CPU in f32.

Same weights (TINY with a 512-token context so the llama3 chat template
fits), same ByteTokenizer, greedy decoding: the response text must be equal
on the completion and llama3-chat templates, for single and batched
requests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_based_apache_spark_optimization_tpu.engine.generate import (
    InferenceEngine as JaxEngine,
)
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.serve import (
    EngineBackend as JaxBackend,
)
from llm_based_apache_spark_optimization_tpu.serve import (
    GenerationService as JaxService,
)
from llm_based_apache_spark_optimization_tpu.tokenizer import (
    ByteTokenizer as JaxByteTokenizer,
)
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.serve import (
    EngineBackend,
    GenerationService,
)
from llm_based_apache_spark_optimization_tpu_torch.serve.backends import (
    trim_stop_texts,
)
from llm_based_apache_spark_optimization_tpu_torch.serve.templates import TEMPLATES
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

SYSTEM = "Table name is t. Columns:\na (int)"


@pytest.fixture(scope="module")
def services():
    jcfg = dataclasses.replace(JAX_TINY, max_seq_len=512)
    tcfg = dataclasses.replace(TINY, max_seq_len=512)
    jp = jax_init(jcfg, jax.random.key(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jsvc, tsvc = JaxService(), GenerationService()
    for template, add_bos in (("completion", True), ("llama3-chat", False)):
        jsvc.register(template, JaxBackend(JaxEngine(jcfg, jp), JaxByteTokenizer(),
                                           max_new_tokens=16, add_bos=add_bos),
                      template=template)
        tsvc.register(template, EngineBackend(
            InferenceEngine(tcfg, tp, device="cpu"), ByteTokenizer(),
            max_new_tokens=16, add_bos=add_bos), template=template)
    return jsvc, tsvc


@pytest.mark.parametrize("template", ["completion", "llama3-chat"])
def test_generate_text_matches_jax(services, template):
    jsvc, tsvc = services
    want = jsvc.generate(template, "count rows", system=SYSTEM)
    got = tsvc.generate(template, "count rows", system=SYSTEM)
    assert want.response and got.response == want.response
    assert got.output_tokens == want.output_tokens
    assert got.model == template and got.latency_s > 0 and got.ttft_s > 0


@pytest.mark.parametrize("template", ["completion", "llama3-chat"])
def test_generate_batch_text_matches_jax(services, template):
    jsvc, tsvc = services
    prompts = ["count rows", "max of a", "average of a by a, sorted"]
    want = [r.response for r in jsvc.generate_batch(template, prompts, system=SYSTEM)]
    got = tsvc.generate_batch(template, prompts, system=SYSTEM)
    assert [r.response for r in got] == want
    assert tsvc.stats[template]["requests"] >= len(prompts)


def test_registry_surface(services):
    _, tsvc = services
    assert tsvc.models() == ["completion", "llama3-chat"]
    with pytest.raises(KeyError, match="not registered"):
        tsvc.generate("nope", "x")
    with pytest.raises(ValueError, match="unknown template"):
        tsvc.register("m", None, template="nope")
    assert sorted(TEMPLATES) == ["completion", "llama3-chat", "mistral-instruct"]
    assert trim_stop_texts("SELECT 1; -- x", [";"]) == "SELECT 1"


def test_engine_deadline_clamp(services):
    """The engine backend exchanges a request's remaining deadline for a
    step budget at the measured seconds a token: a seeded rate of 10 ms a
    token and a 45 ms deadline afford 4 tokens; a deadline that cannot
    afford one token fails typed before any device work."""
    from llm_based_apache_spark_optimization_tpu_torch.serve import DeadlineExceeded

    backend = services[1]._entry("completion").backend
    clamped = EngineBackend(backend.engine, ByteTokenizer(), max_new_tokens=16,
                            sec_per_tok_seed=0.01)
    svc = GenerationService()
    svc.register("m", clamped)
    assert svc.generate("m", "count rows", system=SYSTEM,
                        deadline_s=0.045).output_tokens <= 4
    with pytest.raises(DeadlineExceeded, match="deadline"):
        svc.generate("m", "count rows", system=SYSTEM, deadline_s=0.005)
    hist = svc.metrics.histograms.snapshot()["lsot_request_latency_seconds"]
    assert [h["count"] for h in hist] == [1]  # the refused request records nothing


def test_scheduler_deadline_fails_typed(services):
    """A request whose deadline passed while it queued fails with
    DeadlineExceeded at admission, on both layouts; one with room
    completes."""
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        DeadlineExceeded,
        SchedulerBackend,
    )

    engine = services[1]._entry("completion").backend.engine
    for layout in ("contiguous", "paged"):
        sched = ContinuousBatchingScheduler(engine.cfg, engine.params, num_slots=2,
                                            prompt_bucket=16, kv_layout=layout,
                                            device="cpu")
        backend = SchedulerBackend(sched, ByteTokenizer(), max_new_tokens=8)
        try:
            assert backend.complete("count rows", deadline_s=300).output_tokens > 0
            with pytest.raises(DeadlineExceeded, match="deadline exceeded"):
                backend.complete("count rows", deadline_s=1e-9)
            with pytest.raises(ValueError, match="deadline_s must be positive"):
                sched.submit([1, 2], deadline_s=0)
        finally:
            backend.shutdown()


def test_reference_service_assembly(services):
    """The error role reuses the SQL model's scheduler on the llama3 chat
    template, without a second BOS; a separate source builds its own."""
    from llm_based_apache_spark_optimization_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        SchedulerBackend,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.factory import (
        assemble_reference_service,
    )

    engine = services[1]._entry("completion").backend.engine
    built = []

    def build(src, add_bos):
        built.append((src, add_bos))
        if src == "engine":
            return EngineBackend(engine, ByteTokenizer(), add_bos=add_bos)
        return SchedulerBackend(ContinuousBatchingScheduler(
            engine.cfg, engine.params, num_slots=2, device="cpu"),
            ByteTokenizer(), add_bos=add_bos)

    svc = assemble_reference_service(build, "sched", max_new_tokens=8)
    try:
        sql, err = (svc._entry(m).backend for m in ("duckdb-nsql", "llama3.2"))
        assert err.scheduler is sql.scheduler and not err.add_bos and sql.add_bos
        assert svc._entry("llama3.2").template is TEMPLATES["llama3-chat"]
        assert svc.generate("llama3.2", "why", system=SYSTEM).output_tokens > 0
    finally:
        svc.close()
    svc = assemble_reference_service(build, "engine", "engine", "engine")
    assert svc.models() == ["duckdb-nsql", "llama3.2", "mistral"]
    assert built[-3:] == [("engine", True), ("engine", False), ("engine", True)]

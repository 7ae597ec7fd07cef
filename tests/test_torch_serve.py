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

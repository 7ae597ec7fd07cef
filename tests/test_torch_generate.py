"""The port's InferenceEngine vs the JAX package's, on the CPU in f32 (TINY).

Greedy output must be token-identical, also in the quantized serving
configuration (int4 block weights from `quantize_params_int4(group=32)`,
int8 KV cache); seeded sampling must replay identically within the port
(torch's generator is not JAX's, so sampled tokens are not compared across
packages)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.engine.generate import (
    InferenceEngine as JaxEngine,
)
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.models.llama import forward as jax_forward
from llm_based_apache_spark_optimization_tpu.ops.quant import (
    quantize_cache as jax_quantize_cache,
)
from llm_based_apache_spark_optimization_tpu.ops.quant import (
    quantize_params_int4 as jax_q4,
)
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
from llm_based_apache_spark_optimization_tpu_torch.engine import init_cache
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward
from llm_based_apache_spark_optimization_tpu_torch.ops.quant import (
    quantize_cache,
    quantize_params_int4,
)
from llm_based_apache_spark_optimization_tpu_torch.ops.sampling import SamplingParams


@pytest.fixture(scope="module")
def both():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


PROMPTS = {
    "single": [[1, 17, 93, 5]],
    "mixed_batch": [[1, 17, 93, 5], [1, 40], [1, 7, 8, 9, 10, 11, 12, 13, 14]],
}


@pytest.mark.parametrize("prompts", sorted(PROMPTS))
@pytest.mark.parametrize("stop_ids", [None, (2, 182, 264)])
def test_greedy_matches_jax(both, prompts, stop_ids):
    """With extra stop ids the TINY model's frequent tokens end rows early,
    which exercises per-row stop handling and the early exit."""
    jp, tp = both
    ps = PROMPTS[prompts]
    want = JaxEngine(JAX_TINY, jp, stop_ids=stop_ids).generate(ps, max_new_tokens=12)
    eng = InferenceEngine(TINY, tp, stop_ids=stop_ids, device="cpu")
    got = eng.generate(ps, max_new_tokens=12)
    assert got == want
    assert eng.last_stats["forward_calls"] == 1 + eng.last_stats["decode_steps"]
    assert eng.last_stats["forward_calls"] <= 12


def test_budget_is_clamped_to_the_bucketed_cap(both):
    jp, tp = both
    ps = [[1, 5, 6]]
    want = JaxEngine(JAX_TINY, jp, new_bucket=8).generate(ps, max_new_tokens=5)
    got = InferenceEngine(TINY, tp, new_bucket=8, device="cpu").generate(
        ps, max_new_tokens=5)
    assert got == want and len(got[0]) <= 5


def test_seeded_sampling_replays(both):
    _, tp = both
    eng = InferenceEngine(TINY, tp, device="cpu")
    sp = SamplingParams(temperature=0.9, top_k=40, top_p=0.95)
    ps = PROMPTS["mixed_batch"]
    a = eng.generate(ps, max_new_tokens=10, sampling=sp, seed=3)
    b = eng.generate(ps, max_new_tokens=10, sampling=sp, seed=3)
    c = eng.generate(ps, max_new_tokens=10, sampling=sp, seed=4)
    assert a == b
    assert a != c
    assert all(0 <= tok < TINY.vocab_size for row in a for tok in row)


def test_context_overflow_raises(both):
    _, tp = both
    eng = InferenceEngine(TINY, tp, device="cpu")
    with pytest.raises(ValueError, match="exceeds model context"):
        eng.generate([[1] * 70], max_new_tokens=64)


def test_engine_rejects_params_on_another_device(both):
    _, tp = both
    with pytest.raises(ValueError):
        InferenceEngine(TINY, tp, device=torch.device("meta"))


@pytest.fixture(scope="module")
def both4(both):
    """The same TINY tree with int4 block weights in both packages (the
    quantizers are bit-exact: tests/test_torch_quant.py)."""
    jp, tp = both
    return jax_q4(jp, group=32), quantize_params_int4(tp, group=32)


def test_int8_cache_forward_logits_match_jax(both4):
    """Prefill into a compute-dtype cache, quantize it once, then a decode
    step over the int8 cache: logits within 1e-5 (f32; the int4 products
    and the attention sum in another order), and the sliver the step wrote
    matches (int8 values within one step, scales within 1e-5)."""
    jp, tp = both4
    tokens = np.asarray([[1, 17, 93, 5, 0, 0, 0, 0], [1, 40, 41, 42, 43, 44, 45, 46]])
    lengths = np.asarray([4, 8])
    s = 16
    jcache = {k: jnp.zeros((JAX_TINY.num_layers, 2, JAX_TINY.num_kv_heads, s,
                            JAX_TINY.head_dim), jnp.float32) for k in ("k", "v")}
    jpos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (2, 8))
    want0, jcache = jax_forward(JAX_TINY, jp, jnp.asarray(tokens, jnp.int32), jpos,
                                jcache, logit_indices=jnp.asarray(lengths - 1))
    tcache = init_cache(TINY, 2, s, dtype=torch.float32, device="cpu")
    tpos = torch.arange(8, dtype=torch.int32)[None].expand(2, 8)
    got0, tcache = forward(TINY, tp, torch.from_numpy(tokens).int(), tpos, tcache,
                           logit_indices=torch.from_numpy(lengths - 1))
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), atol=1e-5)
    jq8 = jax_quantize_cache(jcache["k"], jcache["v"])
    tq8 = quantize_cache(tcache["k"], tcache["v"])
    nxt = np.asarray([[7], [9]])
    step = lengths[:, None]
    want, jq8 = jax_forward(JAX_TINY, jp, jnp.asarray(nxt, jnp.int32),
                            jnp.asarray(step, jnp.int32), jq8, attn_impl="xla")
    got, tq8 = forward(TINY, tp, torch.from_numpy(nxt).int(),
                       torch.from_numpy(step).int(), tq8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for name, tol in (("k8", 1), ("v8", 1), ("ks", 1e-5), ("vs", 1e-5)):
        np.testing.assert_allclose(tq8[name].numpy().astype(np.float32),
                                   np.asarray(jq8[name]).astype(np.float32),
                                   atol=tol, rtol=0)
    with pytest.raises(ValueError, match="T == 1"):
        forward(TINY, tp, torch.zeros((2, 2), dtype=torch.int32),
                torch.zeros((2, 2), dtype=torch.int32), tq8)


@pytest.mark.parametrize("stop_ids", [(-1,), (2, 182, 264)])
def test_int4_int8_engine_greedy_matches_jax(both4, stop_ids):
    """The quantized serving configuration through the engine: int4 block
    weights, prefill into a compute-dtype cache, one quantize_cache, decode
    over the int8 cache. Token for token the JAX engine's."""
    jp, tp = both4
    prompts = PROMPTS["mixed_batch"]
    want = JaxEngine(JAX_TINY, jp, stop_ids=stop_ids, prompt_bucket=8,
                     kv_quant="int8").generate(prompts, max_new_tokens=10)
    eng = InferenceEngine(TINY, tp, stop_ids=stop_ids, prompt_bucket=8,
                          kv_quant="int8", device="cpu")
    assert eng.generate(prompts, max_new_tokens=10) == want
    with pytest.raises(ValueError, match="kv_quant"):
        InferenceEngine(TINY, tp, kv_quant="int4", device="cpu")
    with pytest.raises(ValueError, match="paged layout"):
        InferenceEngine(TINY, tp, kv_quant="int8", kv_layout="paged", device="cpu")

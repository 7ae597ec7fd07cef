"""The port's InferenceEngine vs the JAX package's, on the CPU in f32 (TINY).

Greedy output must be token-identical; seeded sampling must replay
identically within the port (torch's generator is not JAX's, so sampled
tokens are not compared across packages)."""

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
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
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

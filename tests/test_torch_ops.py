"""PyTorch port ops vs the JAX package's, on the CPU in f32.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: atol 1e-5 (f32; the two frameworks round transcendental
functions and reductions in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.ops import attention as jattn
from llm_based_apache_spark_optimization_tpu.ops import norm as jnorm
from llm_based_apache_spark_optimization_tpu.ops import rope as jrope
from llm_based_apache_spark_optimization_tpu.ops import sampling as jsamp
from llm_based_apache_spark_optimization_tpu_torch.models.configs import (
    RopeFreqFactors,
    RopeScaling,
)
from llm_based_apache_spark_optimization_tpu_torch.ops import attention as tattn
from llm_based_apache_spark_optimization_tpu_torch.ops import norm as tnorm
from llm_based_apache_spark_optimization_tpu_torch.ops import rope as trope
from llm_based_apache_spark_optimization_tpu_torch.ops import sampling as tsamp
from llm_based_apache_spark_optimization_tpu_torch.ops.common import NEG_INF

ATOL = 1e-5


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rms_norm(eps):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    w = rng.standard_normal(32).astype(np.float32)
    _close(jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), eps),
           tnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps))


SCALINGS = {
    "none": (None, None),
    "llama3": (jrope.RopeScaling(factor=8.0, original_max_position_embeddings=64),
               RopeScaling(factor=8.0, original_max_position_embeddings=64)),
    "llama3_32x": (jrope.RopeScaling(factor=32.0), RopeScaling(factor=32.0)),
    "freq_factors": (jrope.RopeFreqFactors(tuple(float(i + 1) for i in range(8))),
                     RopeFreqFactors(tuple(float(i + 1) for i in range(8)))),
}


@pytest.mark.parametrize("scaling", sorted(SCALINGS))
def test_rope(scaling):
    js, ts = SCALINGS[scaling]
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jrope._inv_freq(16, 5e5, js)),
        trope._inv_freq(16, 5e5, ts).numpy(), rtol=0, atol=0)
    jc, jsn = jrope.rope_cos_sin(jnp.asarray(pos), 16, 5e5, js)
    tc, tsn = trope.rope_cos_sin(torch.from_numpy(pos), 16, 5e5, ts)
    _close(jc, tc)
    _close(jsn, tsn)
    # Same cos/sin into both rotations.
    _close(jrope.apply_rope(jnp.asarray(x), jc, jsn),
           trope.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(jc)),
                            torch.from_numpy(np.array(jsn))))


@pytest.mark.parametrize("window", [None, 3])
def test_attention_mask(window):
    pos = np.array([[0, 1, 2, 3], [5, 6, 7, 8]], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jattn.attention_mask(jnp.asarray(pos), 10, window)),
        tattn.attention_mask(torch.from_numpy(pos), 10, window).numpy())


@pytest.mark.parametrize("t,n,kh,window", [(5, 4, 2, None), (1, 4, 4, None),
                                           (5, 6, 2, 4), (1, 8, 2, 3)])
def test_gqa_attention(t, n, kh, window):
    rng = np.random.default_rng(2)
    b, s, h = 2, 12, 8
    q = rng.standard_normal((b, t, n, h)).astype(np.float32)
    k = rng.standard_normal((b, kh, s, h)).astype(np.float32)
    v = rng.standard_normal((b, kh, s, h)).astype(np.float32)
    pos = (np.array([[0], [s - t]]) + np.arange(t)[None]).astype(np.int32)
    jm = jattn.attention_mask(jnp.asarray(pos), s, window)
    tm = tattn.attention_mask(torch.from_numpy(pos), s, window)
    _close(jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm),
           tattn.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), tm))


def _logits(seed=3, shape=(3, 50)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 2


def test_greedy_and_token_mask():
    lg = _logits()
    mask = np.random.default_rng(4).random(lg.shape) < 0.5
    np.testing.assert_array_equal(np.asarray(jsamp.greedy(jnp.asarray(lg))),
                                  tsamp.greedy(torch.from_numpy(lg)).numpy())
    jm = jsamp.apply_token_mask(jnp.asarray(lg), jnp.asarray(mask))
    tm = tsamp.apply_token_mask(torch.from_numpy(lg), torch.from_numpy(mask))
    _close(jm, tm)
    assert (tm.numpy()[~mask] == np.float32(NEG_INF)).all()


@pytest.mark.parametrize("k", [1, 5, 50])
def test_top_k(k):
    lg = _logits()
    _close(jsamp._apply_top_k(jnp.asarray(lg), k),
           tsamp._apply_top_k(torch.from_numpy(lg), k))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 0.999])
def test_top_p(p):
    lg = _logits()
    _close(jsamp._apply_top_p(jnp.asarray(lg), p),
           tsamp._apply_top_p(torch.from_numpy(lg), p))


def test_sample_is_seeded_and_filtered():
    lg = torch.from_numpy(_logits(shape=(4, 50)))
    params = tsamp.SamplingParams(temperature=0.7, top_k=3)
    draw = [tsamp.sample(lg, params, torch.Generator().manual_seed(11))
            for _ in range(2)]
    assert torch.equal(draw[0], draw[1]) and draw[0].dtype == torch.int32
    top3 = torch.topk(lg, 3, dim=-1).indices
    assert (top3 == draw[0][:, None].long()).any(dim=-1).all()
    assert torch.equal(tsamp.sample(lg, tsamp.SamplingParams()),
                       tsamp.greedy(lg))

"""The port's params bridge and `forward` vs the JAX package's, on the CPU.

TINY (2 layers, GQA 4/2, tied embeddings, llama3 rope scaling) in f32, the
same weights in both packages through `convert.params_from_jax`.
Tolerance on logits: atol 1e-4 (f32 through two layers and a 320-way
unembed; the frameworks sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.engine.kvcache import (
    init_cache as jax_init_cache,
)
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.models.llama import forward as jax_forward
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine.kvcache import init_cache
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.models.llama import (
    forward,
    init_params,
)

ATOL = 1e-4


@pytest.fixture(scope="module")
def both():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_jax_is_bit_exact(dtype):
    jp = jax_init(JAX_TINY, jax.random.key(1), dtype=dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert sorted(jl) == sorted(tl)
    for name, ja in jl.items():
        ja = np.asarray(ja)
        ta = _to_numpy(tl[name])
        assert ta.shape == ja.shape, name
        np.testing.assert_array_equal(ta, ja.view(np.int16) if dtype == jnp.bfloat16
                                      else ja, err_msg=name)


def test_init_params_tree_matches_jax():
    jl = {k: np.shape(v) for k, v in _leaves(jax_init(JAX_TINY, jax.random.key(0)))}
    tp = init_params(TINY, torch.Generator().manual_seed(0), device="cpu")
    tl = {k: tuple(v.shape) for k, v in _leaves(tp)}
    assert jl == tl
    assert all(v.dtype == torch.bfloat16 for _, v in _leaves(tp))


def _tokens(b, t, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, TINY.vocab_size, size=(b, t)).astype(np.int32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    return toks, pos


@pytest.mark.parametrize("logit_indices", [None, [4, 2]])
def test_forward_no_cache(both, logit_indices):
    jp, tp = both
    toks, pos = _tokens(2, 6)
    li = None if logit_indices is None else np.asarray(logit_indices, np.int32)
    jl, _ = jax_forward(JAX_TINY, jp, jnp.asarray(toks), jnp.asarray(pos),
                        logit_indices=None if li is None else jnp.asarray(li))
    tl, cache = forward(TINY, tp, torch.from_numpy(toks), torch.from_numpy(pos),
                        logit_indices=None if li is None else torch.from_numpy(li))
    assert cache is None and tl.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=0, atol=ATOL)


def test_forward_cache_then_decode_step(both):
    """Prefill into a cache, then one decode step at per-row positions: the
    logits and the cache the port writes in place match JAX's."""
    jp, tp = both
    b, t, s = 2, 8, 24
    toks, pos = _tokens(b, t, seed=1)
    jc = jax_init_cache(JAX_TINY, b, s, dtype=jnp.float32)
    tc = init_cache(TINY, b, s, dtype=torch.float32, device="cpu")
    jl, jc = jax_forward(JAX_TINY, jp, jnp.asarray(toks), jnp.asarray(pos), jc,
                         logit_indices=jnp.asarray([7, 4]))
    tl, tc = forward(TINY, tp, torch.from_numpy(toks), torch.from_numpy(pos), tc,
                     logit_indices=torch.tensor([7, 4]))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=0, atol=ATOL)
    nxt = np.array([[17], [93]], np.int32)
    dpos = np.array([[8], [5]], np.int32)  # row 1 overwrites its first pad slot
    jl, jc = jax_forward(JAX_TINY, jp, jnp.asarray(nxt), jnp.asarray(dpos), jc)
    tl, tc = forward(TINY, tp, torch.from_numpy(nxt), torch.from_numpy(dpos), tc)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=0, atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jc[name]), tc[name].numpy(),
                                   rtol=0, atol=ATOL)


def test_cache_shape_rounds_to_eight():
    c = init_cache(TINY, 3, 21, dtype=torch.float32, device="cpu")
    assert c["k"].shape == (2, 3, 2, 24, 8) and not c["k"].any()

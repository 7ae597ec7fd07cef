"""The port's flash GQA attention (plain version, the CPU path of the
wrapper) vs the JAX package's Pallas kernel run in interpret mode, as
tests/test_pallas.py runs it.

Inputs are made with numpy from a seed. Tolerance: atol 2e-5 in f32, the
one test_pallas.py holds the interpreted kernel to against the einsum path
(sums run in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.ops.pallas import (
    flash_gqa_attention as jax_flash,
)
from llm_based_apache_spark_optimization_tpu_torch.ops.attention import (
    attention_mask,
    gqa_attention,
)
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
    LAUNCHES,
    flash_gqa_attention,
    flash_gqa_attention_plain,
    set_attention_impl,
)
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels.dispatch import (
    attention,
)

ATOL = 2e-5

# (b, t, s, n, kh, h, window, kv_lens, nan_dead)
CASES = {
    "prefill_gqa": (2, 8, 24, 4, 2, 16, None, None, False),
    "prefill_mha": (2, 6, 20, 4, 4, 8, None, None, False),
    "decode_gqa": (3, 1, 24, 8, 2, 8, None, None, False),
    "decode_mha": (2, 1, 16, 4, 4, 16, None, None, False),
    "prefill_window": (2, 4, 32, 4, 2, 16, 8, None, False),
    "decode_window": (2, 1, 32, 4, 2, 16, 8, None, False),
    "prefill_kv_lens_with_zero": (3, 4, 24, 4, 2, 8, None, [0, 10, 24], False),
    "decode_kv_lens_with_zero": (3, 1, 24, 4, 2, 8, None, [0, 5, 24], False),
    "prefill_ragged_final_block": (2, 2, 20, 4, 2, 16, None, None, False),
    "prefill_nan_dead_slots": (2, 4, 24, 4, 2, 8, None, [7, 16], True),
    "decode_nan_dead_slots": (2, 1, 24, 6, 2, 8, None, [9, 17], True),
}


def _inputs(b, t, s, n, kh, h, kv_lens, nan_dead, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, n, h)).astype(np.float32)
    k = rng.standard_normal((b, kh, s, h)).astype(np.float32)
    v = rng.standard_normal((b, kh, s, h)).astype(np.float32)
    starts = rng.integers(0, max(1, s - t + 1), size=(b,))
    pos = (starts[:, None] + np.arange(t)[None]).astype(np.int32)
    lens = None if kv_lens is None else np.asarray(kv_lens, np.int32)
    if nan_dead:
        dead = np.arange(s)[None] >= lens[:, None]  # [B, S]
        k[np.broadcast_to(dead[:, None, :, None], k.shape)] = np.nan
        v[np.broadcast_to(dead[:, None, :, None], v.shape)] = np.nan
    return q, k, v, pos, lens


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_interpreted_pallas(case):
    b, t, s, n, kh, h, window, kv_lens, nan_dead = CASES[case]
    q, k, v, pos, lens = _inputs(b, t, s, n, kh, h, kv_lens, nan_dead)
    ref = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), window,
        None if lens is None else jnp.asarray(lens), block_kv=8, interpret=True,
    )
    out = flash_gqa_attention_plain(*_torch(q, k, v, pos), window,
                                    *_torch(lens))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=0, atol=ATOL)
    if lens is not None and (lens == 0).any():
        assert (out.numpy()[lens == 0] == 0).all()


@pytest.mark.parametrize("t,window", [(5, None), (1, None), (5, 3)])
def test_plain_matches_golden_without_kv_lens(t, window):
    """With the default kv_lens the kernel contract is gqa_attention under
    attention_mask exactly (every query sees at least slot 0)."""
    q, k, v, pos, _ = _inputs(2, t, 16, 6, 3, 8, None, False, seed=5)
    tq, tk, tv, tp = _torch(q, k, v, pos)
    gold = gqa_attention(tq, tk, tv, attention_mask(tp, 16, window))
    out = flash_gqa_attention_plain(tq, tk, tv, tp, window)
    torch.testing.assert_close(out, gold, rtol=0, atol=ATOL)


def test_cpu_wrapper_and_dispatch_take_the_plain_version():
    q, k, v, pos, lens = _inputs(2, 3, 16, 4, 2, 8, [5, 16], False, seed=6)
    args = _torch(q, k, v, pos)
    before = dict(LAUNCHES)
    plain = flash_gqa_attention_plain(*args, None, *_torch(lens))
    assert torch.equal(flash_gqa_attention(*args, None, *_torch(lens)), plain)
    assert torch.equal(attention(*args, None, *_torch(lens)), plain)
    set_attention_impl("plain")
    try:
        assert torch.equal(attention(*args, None, *_torch(lens)), plain)
    finally:
        set_attention_impl("auto")
    assert LAUNCHES == before  # the CPU path never counts a kernel launch
    with pytest.raises(ValueError):
        set_attention_impl("xla")

"""The port's ring attention (context parallelism) vs the JAX package's: twins
of tests/test_ring.py.

JAX computes the dense causal golden (`gqa_attention` under
`attention_mask`), the golden JAX's own ring test holds its ring to. The
port runs every case in one gloo group of 8 ranks
(`torch_spmd.run_group`): for each case a mesh of its (dp, sp, tp), and
each rank's output block (its dp rows and tp heads, the sequence gathered
back over sp) is held to the JAX golden's block within 2e-5 in f32 and 0.05
for bf16 inputs (f32 online softmax), as tests/test_ring.py holds JAX's.
The group also runs greedy generate with ring prefill on a dp x sp x tp
mesh against JAX's unsharded engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.engine import InferenceEngine as JaxEngine
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.ops import attention_mask, gqa_attention
from llm_based_apache_spark_optimization_tpu_torch.ops.ring_attention import (
    ring_gqa_attention,
)
from llm_based_apache_spark_optimization_tpu_torch.parallel.mesh import Mesh
from torch_spmd import run_group

MESHES = [(1, 8, 1), (2, 4, 1), (1, 4, 2), (2, 2, 2)]
GEN_PROMPTS = [[1, 5, 9, 2], [1, 7, 3], [1, 11, 13, 17, 4], [1, 2, 3]]


def _qkv(seed, b, t, n, kh, h):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, t, n, h), (b, t, kh, h), (b, t, kh, h)))


def _dense(q, k, v, pos, window=None):
    mask = attention_mask(jnp.asarray(pos), k.shape[1], window)
    return np.asarray(gqa_attention(jnp.asarray(q), jnp.asarray(k).transpose(0, 2, 1, 3),
                                    jnp.asarray(v).transpose(0, 2, 1, 3), mask))


def _positions(b, t):
    return np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t)).copy()


def _cases():
    """(name, case payload, dense golden, tolerance)."""
    out = []
    for dp, sp, tp in MESHES:
        b, t, n, kh, h = 2 * dp, 8 * sp, 4, 2, 16
        q, k, v = _qkv(0, b, t, n, kh, h)
        pos = _positions(b, t)
        out.append((f"dp{dp}sp{sp}tp{tp}",
                    dict(mesh=dict(dp=dp, sp=sp, tp=tp), q=q, k=k, v=v, pos=pos),
                    _dense(q, k, v, pos), 2e-5))
    b, t, n, kh, h = 2, 64, 4, 4, 8
    q, k, v = _qkv(1, b, t, n, kh, h)
    pos = _positions(b, t)
    out.append(("window", dict(mesh=dict(sp=8), q=q, k=k, v=v, pos=pos, window=16),
                _dense(q, k, v, pos, 16), 2e-5))
    b, t, n, kh, h = 1, 32, 8, 2, 16
    q, k, v = _qkv(2, b, t, n, kh, h)
    pos = _positions(b, t)
    out.append(("bf16", dict(mesh=dict(sp=4, tp=2), q=q, k=k, v=v, pos=pos,
                             dtype="bfloat16"),
                _dense(q, k, v, pos), 0.05))
    return out


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    cases = _cases()
    params = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    payload = dict(ring=[c[1] for c in cases], cfg="tiny",
                   params=jax.tree.map(np.asarray, params),
                   engine=[(dict(dp=2, sp=2, tp=2), {"prompt_bucket": 8}, GEN_PROMPTS, 6)])
    golden = JaxEngine(JAX_TINY, params, prompt_bucket=8).generate(GEN_PROMPTS,
                                                                  max_new_tokens=6)
    ranks = run_group(8, "ring_group", tmp_path_factory.mktemp("ring"), payload)
    return {c[0]: (i, c) for i, c in enumerate(cases)}, ranks, golden


def _check(ring, name):
    index, ranks, _ = ring
    i, (_, case, dense, tol) = index[name]
    m = case["mesh"]
    dp, tp = m.get("dp", 1), m.get("tp", 1)
    rb, nq = dense.shape[0] // dp, dense.shape[2] // tp
    for r in ranks:
        coords, dtype, got = r["ring"][i]
        assert dtype == ("torch.bfloat16" if case.get("dtype") else "torch.float32")
        rows = slice(coords["dp"] * rb, (coords["dp"] + 1) * rb)
        heads = slice(coords["tp"] * nq, (coords["tp"] + 1) * nq)
        np.testing.assert_allclose(got, dense[rows, :, heads], atol=tol)


@pytest.mark.parametrize("dp,sp,tp", MESHES, ids=["sp8", "dp2sp4", "sp4tp2", "dp2sp2tp2"])
def test_ring_matches_dense(ring, dp, sp, tp):
    _check(ring, f"dp{dp}sp{sp}tp{tp}")


def test_ring_sliding_window(ring):
    _check(ring, "window")


def test_ring_rejects_indivisible_seq():
    mesh = Mesh(1, 8, 1, ["cpu"] * 8)
    q = torch.zeros((1, 12, 4, 8))
    kv = torch.zeros((1, 12, 2, 8))
    pos = torch.zeros((1, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible"):
        ring_gqa_attention(mesh, q, kv, kv, pos)
    with pytest.raises(ValueError, match="sp"):
        ring_gqa_attention(None, q, kv, kv, pos)


def test_ring_bf16(ring):
    """bf16 inputs keep the f32 online-softmax accumulators: close to the
    f32 dense golden, and the output stays bf16."""
    _check(ring, "bf16")


def test_sp_generate_matches_unsharded(ring):
    """Generate with ring prefill and the sp-sharded decode cache on a
    dp x sp x tp = 2 x 2 x 2 mesh equals the unsharded engine's greedy."""
    _, ranks, golden = ring
    for r in ranks:
        assert r["engine"][0] == golden

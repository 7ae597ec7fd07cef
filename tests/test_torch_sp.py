"""Sequence parallelism past the engine's contiguous cache, on the CPU,
against the JAX package: the paged engine (f32 and int8 pools, and its
speculative loop) and the scheduler (contiguous and paged, chunked prefill,
ragged mixed rounds, speculation, `kv_spill`, a `kv_hbm_budget_bytes`
pool) on a dp=1 x sp=2 x tp=2 mesh, and a scheduler rank 0 builds while the
other ranks follow.

JAX runs on four of the test process's 8 virtual CPU devices
(`tests/conftest.py`) at `make_mesh(dp=1, sp=2, tp=2)`. The port runs one
gloo group of 4 ranks (`torch_spmd.sp_group`, one spawn for every case).
Both take the seed-0 TINY f32 tree (bridged by `convert.params_from_jax`);
greedy tokens must be identical, and the page counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_based_apache_spark_optimization_tpu.engine import InferenceEngine as JaxEngine
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.parallel import make_mesh as jax_mesh
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from llm_based_apache_spark_optimization_tpu.utils.faults import FAULTS as JAX_FAULTS
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from torch_spmd import run_group

#: Prompts past the 8-token bucket: a 16-slot transient, chunked prefill.
PROMPTS = [[1, 5, 9, 2, 8, 4], [1, 7, 3], [1, 11, 13, 17, 4, 6, 2, 9, 5, 3, 12]]
#: Repeating n-grams, so prompt-lookup drafts are accepted.
SPEC_PROMPTS = [[1, 5, 9, 5, 9, 5, 9, 2], [1, 7, 3, 7, 3, 7]]
PAGED = dict(stop_ids=(-1,), prompt_bucket=8, kv_layout="paged", kv_page_size=8)
ENGINE = {
    "paged": (PAGED, PROMPTS, 8),
    "paged_int8": (dict(PAGED, kv_quant="int8"), PROMPTS, 8),
    "paged_speculative": (dict(PAGED, speculative_draft=4), SPEC_PROMPTS, 10),
}
SCHED = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,))
SCHED_PAGED = dict(SCHED, kv_layout="paged", kv_page_size=8)
SCHEDULERS = {
    "contiguous": (SCHED, PROMPTS, 8),
    "contiguous_int8": (dict(SCHED, kv_quant="int8"), PROMPTS, 8),
    "paged": (SCHED_PAGED, PROMPTS, 8),
    "paged_ragged": (dict(SCHED_PAGED, ragged=True), [PROMPTS[1], PROMPTS[2], PROMPTS[0]],
                     8),
    "paged_speculative": (dict(SCHED_PAGED, speculative_draft=4), SPEC_PROMPTS, 10),
}
#: tests/test_torch_overcommit.py's storm: 3 of 9 pages withheld.
STORM = (dict(SCHED, max_seq=64, kv_layout="paged", kv_page_size=8,
              kv_overcommit=0.25, kv_pages=9, kv_spill=True),
         [[1, 5, 9], [1, 7], [1, 11, 13, 17], [1, 2, 3]], 24, "kv:pressure:1:3")
BUDGET = (SCHED_PAGED, 300_000)
#: A13.3: the first scheduler's arguments, then the one rank 0 builds alone.
BUILD = (SCHED_PAGED, dict(num_slots=4, decode_chunk=4, prompt_bucket=8,
                           stop_ids=(-1,), kv_layout="paged", kv_page_size=16),
         PROMPTS, 8)
GROUP_TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def jparams():
    return jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(dp=1, sp=2, tp=2, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def ranks(jparams, tmp_path_factory):
    payload = {"cfg": "tiny", "params": jax.tree.map(np.asarray, jparams),
               "engine": list(ENGINE.values()), "sched": list(SCHEDULERS.values()),
               "spill": STORM, "budget": BUDGET, "build": BUILD}
    return run_group(4, "sp_group", tmp_path_factory.mktemp("sp"), payload,
                     timeout=GROUP_TIMEOUT_S)


def jax_sched(jparams, jmesh, kw, prompts, new):
    with JaxScheduler(JAX_TINY, jparams, mesh=jmesh, **kw) as s:
        return s.generate(prompts, max_new_tokens=new)


@pytest.mark.parametrize("name", list(ENGINE))
def test_engine_under_sp_as_jax(ranks, jparams, jmesh, name):
    """The paged engine on sp=2 x tp=2: the ring prefill's transient is
    gathered over sp and packed into a pool whole on each sp rank; every
    rank returns JAX's greedy tokens on the same mesh shape."""
    i = list(ENGINE).index(name)
    kw, prompts, new = ENGINE[name]
    want = JaxEngine(JAX_TINY, jparams, mesh=jmesh, **kw).generate(
        prompts, max_new_tokens=new)
    for r in ranks:
        assert r["engine"][i] == want, r["coords"]


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_under_sp_as_jax(ranks, jparams, jmesh, name):
    """The scheduler on sp=2 x tp=2 (its cache whole on each sp rank, every
    rank following rank 0's steps): JAX's greedy tokens."""
    i = list(SCHEDULERS).index(name)
    assert ranks[0]["sched"][i] == jax_sched(jparams, jmesh, *SCHEDULERS[name])


def test_scheduler_pool_is_whole_on_every_sp_rank(ranks):
    """As JAX's placement: each rank's pool holds every page and a tp-th of
    the KV heads ([L, P, K/tp, PS, H]), the same shape on every rank; rank
    0's ragged scheduler ran mixed rounds (a long prompt's second chunk
    beside a decoding slot)."""
    for i, name in enumerate(SCHEDULERS):
        pages = {r["pages"][i] for r in ranks}
        if not name.startswith("paged"):
            assert pages == {None}
            continue
        ((shape, total),) = pages
        assert shape == (TINY.num_layers, total, TINY.num_kv_heads // 2, 8,
                         TINY.head_dim)
    assert ranks[0]["mixed"][list(SCHEDULERS).index("paged_ragged")] > 0


def test_kv_spill_under_sp_as_jax(ranks, jparams, jmesh):
    """`kv_spill` on an sp paged scheduler under the storm: the export
    reads the sp = 0 ranks' heads, the import writes every sp rank's;
    spilled = restored > 0, and the tokens equal JAX's spilling scheduler's
    on the same mesh under the same storm."""
    kw, prompts, new, pressure = STORM
    got, stats = ranks[0]["spill"]
    JAX_FAULTS.configure(pressure, 0)
    try:
        with JaxScheduler(JAX_TINY, jparams, mesh=jmesh, **kw) as s:
            futs = [s.submit(ids, max_new_tokens=new, seed=41 + i)
                    for i, ids in enumerate(prompts)]
            want = [f.result(timeout=240) for f in futs]
            jstats = dict(s.page_stats)
    finally:
        JAX_FAULTS.clear()
    assert got == want
    assert stats["preemptions"] >= 1 and jstats["preemptions"] >= 1
    assert stats["spilled_pages"] > 0
    assert stats["spilled_pages"] == stats["restored_pages"]
    assert jstats["spilled_pages"] == jstats["restored_pages"]


def test_budget_pages_under_sp_as_jax(ranks, jparams, jmesh):
    """`kv_hbm_budget_bytes` prices the whole pool (every KV head), as JAX's
    global array: the same page count on the sp mesh."""
    kw, budget = BUDGET
    with JaxScheduler(JAX_TINY, jparams, mesh=jmesh, kv_hbm_budget_bytes=budget,
                      **kw) as s:
        want = s.page_stats["pages_total"]
    assert ranks[0]["budget_pages"] == want


def test_scheduler_built_on_a_running_mesh_as_jax(ranks, jparams, jmesh):
    """A13.3: once the followers follow, rank 0 builds a scheduler from a
    second tree every rank placed, with arguments no earlier scheduler
    had; the followers build it from the posted message, and its tokens
    equal JAX's scheduler's built on the mesh."""
    _, kw, prompts, new = BUILD
    assert ranks[0]["build"] == jax_sched(jparams, jmesh, kw, prompts, new)


def test_build_leaves_nothing_on_the_followers(ranks):
    """The followers let go of the scheduler built from the message once
    rank 0 shut it down: the mesh keeps no object, and so no tree."""
    assert [r["kept"] for r in ranks] == [0, 0, 0, 0]

"""The replica pool of tp meshes (`--dp 2 --tp 2 --scheduler`) and the
exports of a sharded page pool, on the CPU, against the JAX package.

JAX's entry point builds the pool as two schedulers on tp=2 submeshes of
the test process's 8 virtual CPU devices (`tests/conftest.py`). The port's
is one process a rank: `torch_spmd.run_group` forms a gloo group of 1 +
2*(2-1) = 3 ranks, each running the entry point's own functions
(`launch.join_pool`, `build_service`): rank 0 is the pool's process and
rank 0 of both replicas' meshes, ranks 1 and 2 follow replica 0 and
replica 1. Both load the same TINY HF checkpoint (f32); greedy tokens must
be equal. A blob keeps the unsharded layout, so a tp=2 replica's handoff
equals a tp=1 replica's and imports into a replica of either tp.
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.app import __main__ as jax_entry
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    SchedulerPool as JaxPool,
)
from llm_based_apache_spark_optimization_tpu.utils.faults import FAULTS as JAX_FAULTS
from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry
from llm_based_apache_spark_optimization_tpu_torch.app.config import AppConfig
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.parallel import launch
from torch_spmd import _handoff_counts, _wait_restarted, run_group

PROMPTS = [[1, 5, 9], [1, 7], [1, 11, 13, 17], [1, 2, 3]]
TEXTS = ["select vendor"] * 4
SYSTEM = "from fare"
NEW = 8
#: The phase-split pools' replica shape (tests/test_torch_disagg.py's).
SPLIT_KW = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,),
                kv_layout="paged", kv_page_size=8)
#: An overcommitted pool and a storm that withholds 3 of its 9 pages
#: (tests/test_torch_overcommit.py's).
STORM_KW = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,),
                max_seq=64, kv_layout="paged", kv_page_size=8, kv_overcommit=0.25,
                kv_pages=9)
PRESSURE = "kv:pressure:1:3"
GROUP_TIMEOUT_S = 90.0


@pytest.fixture(scope="module")
def tiny_hf_dir(tmp_path_factory):
    """A TINY HF checkpoint (f32, a 2048-token context) with a WordLevel
    tokenizer.json, written by the port's writer."""
    from test_torch_tokenizer import write_tokenizer_json

    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import save_hf_checkpoint
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params

    pytest.importorskip("tokenizers")
    mcfg = dataclasses.replace(TINY, max_seq_len=2048)
    params = init_params(mcfg, torch.Generator().manual_seed(0), torch.float32,
                         device="cpu")
    ckpt = tmp_path_factory.mktemp("pool_mesh") / "ckpt"
    save_hf_checkpoint(mcfg, params, ckpt)
    write_tokenizer_json(ckpt / "tokenizer.json", "wordlevel")
    return ckpt


def pool_argv(ckpt, *extra):
    return ["--cpu", "--backend", "checkpoint", "--sql-model-path", str(ckpt),
            "--dp", "2", "--tp", "2", "--slots", "2", "--max-new-tokens", str(NEW),
            *extra]


def jax_pool(argv, waves, restart=False):
    """JAX's `make_checkpoint_service` pool for the same flags (its replicas
    on tp=2 submeshes): each wave's tokens submitted at once, the texts from
    four threads, the handoff counts."""
    from concurrent.futures import ThreadPoolExecutor

    args = argparse.Namespace(**vars(entry.build_parser().parse_args(argv)))
    svc = jax_entry.make_checkpoint_service(args, NEW)
    sup = svc._models["duckdb-nsql"].backend.scheduler
    pool = sup._inner
    out = {"waves": []}
    try:
        assert [s.mesh.shape["tp"] for s in pool.schedulers] == [2, 2]
        for w, prompts in enumerate(waves):
            if restart and w == 1:
                factory = pool._factory
                pool._factory = lambda i: (JAX_FAULTS.clear(), factory(i))[1]
                JAX_FAULTS.configure("sched:handoff:1", 0)
            futs = [sup.submit(ids, max_new_tokens=NEW) for ids in prompts]
            out["waves"].append([f.result(timeout=240) for f in futs])
            out.setdefault("wave_handoffs", []).append(_handoff_counts(pool))
        _wait_restarted(pool)
        with ThreadPoolExecutor(max_workers=4) as ex:
            res = [f.result() for f in [ex.submit(svc.generate, "duckdb-nsql", q,
                                                  system=SYSTEM) for q in TEXTS]]
        out["texts"] = [(r.response, r.output_tokens) for r in res]
        out["handoffs"] = _handoff_counts(pool)
        out["pages_total"] = [s.page_stats["pages_total"] if s.kv_layout == "paged"
                              else 0 for s in pool.schedulers]
    finally:
        JAX_FAULTS.clear()
        svc.close()
    return out


def port_pool(tmp_path, name, argv, waves, env=None, restart=False):
    payload = {"argv": argv, "env": env or {}, "waves": waves, "new": NEW,
               "texts": TEXTS, "system": SYSTEM, "restart": restart}
    return run_group(3, "pool_group", tmp_path / name, payload,
                     timeout=GROUP_TIMEOUT_S)


def assert_layout(ranks):
    """Rank 0 is rank 0 of both replicas' meshes; ranks 1 and 2 follow
    replica 0 and replica 1, one mesh each."""
    r0, r1, r2 = ranks
    assert r0["meshes"] == [[0, 1], [0, 2]]
    assert r1 == {"ranks": [0, 1], "device": "cpu"}
    assert r2 == {"ranks": [0, 2], "device": "cpu"}
    assert r0["tp"] == [2, 2]


#: A near-tie: where a greedy stream leaves the reference, the reference's
#: top two logits there lie within this share of its largest |logit|.
TIE_SHARE = 1e-2

#: The paged variants size each replica's pool with `--kv-hbm-gb`: the
#: budget prices every KV head, so a tp=2 replica has JAX's page count.
WEIGHTS = {"bf16_tree": (),
           "int8": ("--int8", "--kv-layout", "paged", "--kv-hbm-gb", "0.002"),
           "int8_kv8": ("--int8", "--kv-int8", "--kv-layout", "paged",
                        "--kv-hbm-gb", "0.001")}


def near_ties(ckpt, got, want, prompts):
    """The divergences of `got` from `want` (JAX's), each checked to be a
    near-tie of JAX's int8 tree over the common prefix (f32 cache): the
    gap of its top two logits there within TIE_SHARE of max |logit|."""
    from llm_based_apache_spark_optimization_tpu.checkpoint import load_hf_checkpoint
    from llm_based_apache_spark_optimization_tpu.models import forward as jax_forward
    from llm_based_apache_spark_optimization_tpu.ops.quant import quantize_params

    cfg, params = load_hf_checkpoint(str(ckpt), mesh=None)
    q8 = quantize_params(params)
    ties = []
    for ids, g, w in zip(prompts, got, want):
        if g == w:
            continue
        k = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        seq = list(ids) + w[:k]
        logits = np.asarray(jax_forward(cfg, q8, jnp.asarray([seq]),
                                        jnp.arange(len(seq))[None], None)[0][0, -1])
        top = np.sort(logits)[::-1]
        ties.append((k, float(top[0] - top[1]), float(np.abs(logits).max())))
        assert {g[k], w[k]} <= set(np.argsort(-logits)[:2].tolist()), (ids, k)
        assert top[0] - top[1] <= TIE_SHARE * np.abs(logits).max(), ties[-1]
    return ties


@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_tp_pool_serves_as_jax(tiny_hf_dir, tmp_path, weights):
    """`--cpu --dp 2 --tp 2 --scheduler` through the port's entry-point
    functions: four copies of one question give one response, and the
    greedy tokens of a burst equal JAX's pool on tp=2 submeshes. With
    `--int8` (over an f32 or an int8 paged KV cache) each replica shards
    the host tree's one quantization, and a stream may leave JAX's at a
    near-tie: the port's tp=2 row-parallel products multiply each partial
    sum by the int8 scale before the all-reduce (JAX scales the sum), so
    the two round differently, and with these weights one prompt's last
    step is a near-tie (a gap of 0.006 against a largest |logit| of 3.5).
    Each divergence is checked to be a near-tie of JAX's tree, and the
    texts' token counts are JAX's."""
    argv = pool_argv(tiny_hf_dir, *WEIGHTS[weights])
    ranks = port_pool(tmp_path, weights, argv, [PROMPTS])
    assert_layout(ranks)
    got, want = ranks[0], jax_pool(argv, [PROMPTS])
    assert len({r for r, _ in got["texts"]}) == 1
    assert all(n >= 1 for _, n in got["texts"])
    assert [n for _, n in got["texts"]] == [n for _, n in want["texts"]]
    if weights != "bf16_tree":
        near_ties(tiny_hf_dir, got["waves"][0], want["waves"][0], PROMPTS)
    else:
        assert got["texts"] == want["texts"]
        assert got["waves"] == want["waves"]
    assert got["pages_total"] == want["pages_total"]
    assert got["roles"] == ["mixed", "mixed"] and got["handoffs"] is None
    assert got["health"] == {"lost": 0, "restarts": 0}


@pytest.fixture(scope="module")
def split_runs(tiny_hf_dir, tmp_path_factory):
    """`LSOT_POOL_PHASES=prefill:1,decode:1` on tp=2 submeshes, both
    packages: a clean wave, then a wave under `sched:handoff:1`, which
    kills the prefill replica mid-handoff (its rebuild clears the fault),
    then the texts."""
    env = {"LSOT_POOL_PHASES": "prefill:1,decode:1"}
    argv = pool_argv(tiny_hf_dir, "--kv-layout", "paged")
    ranks = port_pool(tmp_path_factory.mktemp("split"), "split", argv,
                      [PROMPTS, PROMPTS], env=env, restart=True)
    mp = pytest.MonkeyPatch()
    try:
        for k, v in env.items():
            mp.setenv(k, v)
        want = jax_pool(argv, [PROMPTS, PROMPTS], restart=True)
    finally:
        mp.undo()
    return ranks, want


def test_tp_pool_phase_split_matches_jax(split_runs):
    """The phase-split pool of tp=2 replicas hands every request off: the
    tokens of the clean wave and the texts equal JAX's, exports equal
    imports, and the pages and bytes are reckoned on the blob rank 0 holds,
    the unsharded one: equal to JAX's global-array export."""
    ranks, want = split_runs
    assert_layout(ranks)
    got = ranks[0]
    assert got["roles"] == ["prefill", "decode"]
    assert got["waves"][0] == want["waves"][0]
    assert got["texts"] == want["texts"]
    clean = got["wave_handoffs"][0]
    assert clean["r0"][0] == clean["r1"][1] == len(PROMPTS)  # exports = imports
    assert clean == want["wave_handoffs"][0]
    # The rebuilt prefill replica exported the texts; the decode replica
    # imported the clean wave's and the texts'.
    assert got["handoffs"]["r0"][0] == len(TEXTS)
    assert got["handoffs"]["r1"][1] == len(PROMPTS) + len(TEXTS)
    assert got["handoffs"] == want["handoffs"]


def test_tp_pool_targeted_restart_loses_nothing(split_runs):
    """The crashed prefill replica is rebuilt on its own mesh (its
    follower builds the twin) while the decode replica runs on: the
    crash wave's tokens equal the clean wave's and JAX's, only r0
    restarted, nothing is lost and no page is left in use."""
    ranks, want = split_runs
    got = ranks[0]
    assert got["waves"][1] == got["waves"][0] == want["waves"][1]
    assert got["restarts"]["r0"] >= 1 and got["restarts"]["r1"] == 0
    assert got["health"] == {"lost": 0, "restarts": 0}
    assert got["pages_in_use"] == [0, 0]


@pytest.fixture(scope="module")
def jparams():
    return jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_handoff_blob_is_unsharded_and_crosses_tp(jparams, tmp_path):
    """A tp=2 prefill replica's blob has the unsharded layout [L, n, K,
    page_size, H] and equals, within f32 1e-6, the blob a tp=1 prefill
    replica exports from the same prompt; it imports into a tp=1 decode
    replica, and a tp=1 blob into a tp=2 decode replica, with the tokens
    of JAX's phase-split pool."""
    payload = {"cfg": "tiny", "params": np_tree(jparams), "kw": SPLIT_KW,
               "prompts": PROMPTS, "new": NEW}
    a, b = run_group(2, "cross_tp_group", tmp_path, payload, timeout=GROUP_TIMEOUT_S)[0]
    pool = JaxPool([JaxScheduler(JAX_TINY, jparams, phase_role=r, **SPLIT_KW)
                    for r in ("prefill", "decode")])
    with pool:
        want = [f.result(timeout=240) for f in [pool.submit(ids, max_new_tokens=NEW)
                                                for ids in PROMPTS]]
    assert a["tokens"] == b["tokens"] == want
    for run in (a, b):
        assert run["counts"] == {"r0": (len(PROMPTS), 0), "r1": (0, len(PROMPTS))}
        assert len(run["blobs"]) == len(PROMPTS)
    cfg = TINY
    for tp2_blob, tp1_blob in zip(a["blobs"], b["blobs"]):
        assert len(tp2_blob) == len(tp1_blob) == 2
        for x, y in zip(tp2_blob, tp1_blob):
            assert x.shape == y.shape == (cfg.num_layers, 1, cfg.num_kv_heads, 8,
                                          cfg.head_dim)
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)


def test_kv_spill_on_a_tp_mesh(jparams, tmp_path):
    """`kv_spill` on a tp=2 paged scheduler under a storm that withholds 3
    of 9 pages: victims spill their pages (each rank's heads gathered to
    rank 0's blob) and restore them (rank 0's blob scattered back), spilled
    = restored > 0, and the greedy tokens equal JAX's spilling scheduler's
    under the same storm."""
    payload = {"cfg": "tiny", "params": np_tree(jparams),
               "kw": dict(STORM_KW, kv_spill=True), "prompts": PROMPTS, "new": 24,
               "pressure": PRESSURE}
    got, stats = run_group(2, "spill_group", tmp_path, payload,
                           timeout=GROUP_TIMEOUT_S)[0]
    JAX_FAULTS.configure(PRESSURE, 0)
    try:
        with JaxScheduler(JAX_TINY, jparams, kv_spill=True, **STORM_KW) as s:
            futs = [s.submit(ids, max_new_tokens=24, seed=41 + i)
                    for i, ids in enumerate(PROMPTS)]
            want = [f.result(timeout=240) for f in futs]
            jstats = dict(s.page_stats)
    finally:
        JAX_FAULTS.clear()
    assert got == want
    assert stats["preemptions"] >= 1 and jstats["preemptions"] >= 1
    assert stats["spilled_pages"] > 0
    assert stats["spilled_pages"] == stats["restored_pages"]


def test_lsot_models_beside_tp_is_unsharded_as_jax(tiny_hf_dir, monkeypatch):
    """`LSOT_MODELS` beside `--tp 2` (and `--dp 2`) starts no follower rank:
    the model pool is built unsharded, as JAX's entry point loads it with
    no mesh, and its text equals JAX's."""
    monkeypatch.setenv("LSOT_MODELS", f"duckdb-nsql=hf:{tiny_hf_dir}")
    argv = ["--cpu", "--backend", "checkpoint", "--sql-model-path", str(tiny_hf_dir),
            "--tp", "2", "--slots", "2", "--max-new-tokens", str(NEW)]
    args = entry.build_parser().parse_args(argv)
    cfg = AppConfig.from_env(history_db=":memory:")
    assert entry.mesh_ranks(args, cfg) == 1 and not entry.is_tp_pool(args, cfg)
    pooled = entry.build_parser().parse_args(argv + ["--dp", "2"])
    assert entry.mesh_ranks(pooled, cfg) == 1 and not entry.is_tp_pool(pooled, cfg)
    svc = entry.build_service(args, cfg)
    try:
        sched = svc._models["duckdb-nsql"].backend.scheduler._inner.schedulers[0]
        assert sched.mesh is None
        got = svc.generate("duckdb-nsql", "select vendor", system=SYSTEM)
    finally:
        svc.close()
    # JAX's entry point makes its tp mesh over every device first, then
    # serves LSOT_MODELS through this function with no mesh.
    from llm_based_apache_spark_optimization_tpu.app.config import AppConfig as JaxConfig
    from llm_based_apache_spark_optimization_tpu.serve.modelpool import parse_models_spec

    jcfg = JaxConfig.from_env()
    jsvc = jax_entry._make_multimodel_checkpoint_service(
        argparse.Namespace(**vars(args)), parse_models_spec(jcfg.models), NEW, jcfg,
        None, False)
    try:
        want = jsvc.generate("duckdb-nsql", "select vendor", system=SYSTEM)
    finally:
        jsvc.close()
    assert (got.response, got.output_tokens) == (want.response, want.output_tokens)


def test_tp_pool_placement_rules(tiny_hf_dir, monkeypatch):
    """The pool's world is 1 + (local replicas)*(tp-1) (remote slots have
    no mesh); its shards sit on `pool_devices`, replica i's at i*tp + j:
    `--cpu`, LSOT_MESH_DEVICES of dp*tp entries, or one card a shard. A
    host with too few cards exits with JAX's message before any rank
    starts, and `pool_devices` raises; LSOT_MESH_DEVICES of another length
    raises. Under an outer launcher the pool raises, naming its ROADMAP
    item."""
    import torch as _torch

    cfg = AppConfig.from_env(history_db=":memory:")
    args = entry.build_parser().parse_args(pool_argv(tiny_hf_dir))
    assert entry.is_tp_pool(args, cfg) and entry.mesh_ranks(args, cfg) == 3
    remote = dataclasses.replace(cfg, pool_remote="1=localhost:9")
    assert entry.pool_replicas(args, remote) == [0]
    assert entry.mesh_ranks(args, remote) == 2
    four = entry.build_parser().parse_args(pool_argv(tiny_hf_dir) + ["--tp", "4"])
    assert entry.mesh_ranks(four, cfg) == 1 + 2 * 3
    assert launch.pool_devices(2, 2, True) == ["cpu"] * 4
    monkeypatch.setattr(_torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(_torch.cuda, "is_available", lambda: True)
    no_cpu = [a for a in pool_argv(tiny_hf_dir) if a != "--cpu"]
    with pytest.raises(SystemExit, match="--dp 2 --tp 2 needs 4 devices, found 1"):
        entry.refuse_dp_pool(entry.build_parser().parse_args(no_cpu), cfg)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        launch.pool_devices(2, 2, False)
    monkeypatch.setenv("LSOT_MESH_DEVICES", "cuda:0,cuda:0,cuda:0,cuda:0")
    entry.refuse_dp_pool(entry.build_parser().parse_args(no_cpu), cfg)
    assert launch.pool_devices(2, 2, False) == ["cuda:0"] * 4
    monkeypatch.setenv("LSOT_MESH_DEVICES", "cuda:0,cuda:0")
    with pytest.raises(ValueError, match="pool of 2 tp=2 replicas has 4 shards"):
        launch.pool_devices(2, 2, False)
    monkeypatch.setenv("LSOT_PROCESS_ID", "1")
    monkeypatch.setenv("LSOT_NUM_PROCESSES", "3")
    monkeypatch.delenv("LSOT_STARTED_BY", raising=False)
    with pytest.raises(NotImplementedError, match="A13.5"):
        launch.join_pool(2, 2, True, "unused", [])

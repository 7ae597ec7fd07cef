"""The port's tensor/data/sequence parallelism vs the JAX package's, on the
CPU: twins of tests/test_parallel.py.

JAX runs on the test process's 8 virtual CPU devices, as its own tests do.
The port runs one process per rank: `torch_spmd.run_group` spawns a gloo
group over a `FileStore` in `tmp_path` (no TCP port), each rank holds its
own shard, and every rank returns what it computed. Seed-0 TINY f32
weights are bridged as numpy (`convert.params_from_jax`), then
`shard_params`. The ranks of one mesh run every case in one spawn
(module-scoped fixtures); each test checks its part:
- each rank's local shard equals the matching addressable shard of JAX's
  `NamedSharding` (bf16, int8, int4, fused and int8-table trees), exactly;
- the sharded forward's logits, on each rank's dp rows, are within JAX's
  own rtol = atol = 2e-4 of JAX's unsharded forward;
- greedy tokens are identical for the engine (contiguous, paged, int8 KV,
  speculative, int8 tables, dp padding, sp-sharded caches), the tp
  scheduler, and tp paged speculation;
- a load straight to the mesh (HF, GGUF, the native cache) gives each rank
  the block `shard_params` gives, and int8-quantizing that block gives the
  block of the whole tree's quantization.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from llm_based_apache_spark_optimization_tpu.engine import InferenceEngine as JaxEngine
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import forward as jax_forward
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.models.llama import fuse_blocks as jax_fuse
from llm_based_apache_spark_optimization_tpu.ops.quant import quantize_params as jax_q8
from llm_based_apache_spark_optimization_tpu.ops.quant import quantize_params_int4 as jax_q4
from llm_based_apache_spark_optimization_tpu.ops.quant import quantize_unembed as jax_u8
from llm_based_apache_spark_optimization_tpu.parallel import make_mesh as jax_mesh
from llm_based_apache_spark_optimization_tpu.parallel import param_specs as jax_param_specs
from llm_based_apache_spark_optimization_tpu.parallel import shard_params as jax_shard
from llm_based_apache_spark_optimization_tpu.parallel import (
    specs_for_params as jax_specs_for_params,
)
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.parallel import (
    P,
    global_mesh,
    init_distributed,
    is_primary,
    make_mesh,
    param_specs,
    process_local_batch,
    specs_for_params,
    validate_tp,
)
from torch_spmd import run_group

PROMPTS = [[1, 5, 9], [1, 7], [1, 11, 13, 17], [1, 2, 3]]
TWO = [[1, 5, 9], [1, 7, 2, 4]]
SP_PROMPTS = [[1, 5, 9, 2, 8, 4], [1, 7, 3]]
STOP = {"stop_ids": (-1,), "prompt_bucket": 8}
PAGED = dict(STOP, kv_layout="paged", kv_page_size=8)
SCHED = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,))


@pytest.fixture(scope="module")
def jparams():
    return jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def tokens():
    return np.random.default_rng(0).integers(3, TINY.vocab_size, size=(4, 8)).astype(np.int32)


def jax_gen(params, prompts, new, **kw):
    return JaxEngine(JAX_TINY, params, **kw).generate(prompts, max_new_tokens=new)


# Engine and scheduler cases of the tp=2 group: (engine kwargs, params
# variant, prompts, budget); the JAX golden is the unsharded engine.
TP_ENGINE = [
    ({"prompt_bucket": 8}, None, PROMPTS, 6),
    (STOP, None, TWO, 6),
    (STOP, "unembed8", TWO, 6),
    (PAGED, None, PROMPTS, 6),
    (dict(PAGED, kv_quant="int8"), None, PROMPTS, 6),
    (dict(PAGED, speculative_draft=4), None, PROMPTS, 6),
    (dict(PAGED, speculative_draft=4, kv_quant="int8"), None, PROMPTS, 6),
    (STOP, "int4", PROMPTS, 6),
    (dict(STOP, kv_quant="int8"), "int8", PROMPTS, 6),
]
TP_SCHED = [
    (dict(SCHED, kv_layout="paged", kv_page_size=16), None, PROMPTS, 6),
    (dict(SCHED), None, PROMPTS, 6),
    (dict(SCHED, kv_layout="paged", kv_page_size=16, kv_quant="int8"), "int4",
     PROMPTS, 6),
]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, jparams):
    """The TINY tree as an HF directory, a GGUF blob and a native cache."""
    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import (
        save_hf_checkpoint,
        save_native,
        write_gguf,
    )

    root = tmp_path_factory.mktemp("par_ckpt")
    tp = params_from_jax(np_tree(jparams), device="cpu")
    save_hf_checkpoint(TINY, tp, root / "hf")
    save_native(tp, root / "native.pt")
    write_gguf(TINY, tp, root / "tiny.gguf", quant="f32")
    return root


@pytest.fixture(scope="module")
def tp2(jparams, ckpt, tmp_path_factory):
    payload = dict(mesh={"tp": 2}, cfg="tiny", params=np_tree(jparams),
                   tokens=tokens(), engine=TP_ENGINE, scheduler=TP_SCHED,
                   ckpt=str(ckpt / "hf"), native=str(ckpt / "native.pt"),
                   gguf=str(ckpt / "tiny.gguf"))
    return run_group(2, "parallel_group", tmp_path_factory.mktemp("tp2"), payload)


@pytest.fixture(scope="module")
def dp2tp2(jparams, tmp_path_factory):
    payload = dict(mesh={"dp": 2, "tp": 2}, cfg="tiny", params=np_tree(jparams),
                   tokens=tokens(),
                   engine=[({"prompt_bucket": 8}, None, PROMPTS, 6),
                           ({"prompt_bucket": 8}, None, PROMPTS[:3], 5)])
    return run_group(4, "parallel_group", tmp_path_factory.mktemp("dp2tp2"), payload)


@pytest.fixture(scope="module")
def sp2tp2(jparams, tmp_path_factory):
    payload = dict(mesh={"sp": 2, "tp": 2}, cfg="tiny", params=np_tree(jparams),
                   tokens=tokens(),
                   engine=[(STOP, None, SP_PROMPTS, 8),
                           (dict(STOP, kv_quant="int8"), None, SP_PROMPTS, 8)])
    return run_group(4, "parallel_group", tmp_path_factory.mktemp("sp2tp2"), payload)


def jax_local(tree, jm, coords):
    """The addressable shard of each leaf on the device at `coords` of the
    JAX mesh `jm`, as numpy."""
    dev = jm.devices[coords["dp"], coords["sp"], coords["tp"]]

    def leaf(x):
        return next(np.asarray(s.data) for s in x.addressable_shards if s.device == dev)

    return jax.tree.map(leaf, tree)


def assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    assert got.shape == want.shape, (path, got.shape, want.shape)
    np.testing.assert_array_equal(np.asarray(got, dtype=want.dtype), want, err_msg=path)


# ------------------------------------------------------------------- tests

def test_mesh_shape_and_axes(tp2, dp2tp2, sp2tp2):
    assert [r["shape"] for r in tp2] == [{"dp": 1, "sp": 1, "tp": 2}] * 2
    assert [r["coords"] for r in dp2tp2] == [
        {"dp": d, "sp": 0, "tp": t} for d in range(2) for t in range(2)]
    assert sp2tp2[3]["coords"] == {"dp": 0, "sp": 1, "tp": 1}
    one = make_mesh(devices=["cpu"])
    assert one.shape == {"dp": 1, "sp": 1, "tp": 1} and one.backend == "gloo"
    with pytest.raises(ValueError):
        make_mesh(dp=3, tp=2, devices=["cpu"] * 8)
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(dp=4, tp=2, devices=["cpu"] * 8)  # no group in this process


def test_validate_tp_rejects_indivisible():
    from llm_based_apache_spark_optimization_tpu.parallel import validate_tp as jax_validate

    for fn, cfg in ((validate_tp, TINY), (jax_validate, JAX_TINY)):
        with pytest.raises(ValueError):
            fn(cfg, 3)  # heads=4, kv=2 not divisible by 3
        fn(cfg, 2)


@pytest.mark.parametrize("group", ["tp2", "dp2tp2"])
def test_param_shards_are_partitioned(request, jparams, group):
    """Each rank's block of every tree layout equals the addressable shard
    of JAX's `shard_params` on the device at the same mesh coordinates."""
    ranks = request.getfixturevalue(group)
    shape = ranks[0]["shape"]
    jm = jax_mesh(devices=jax.devices()[:2 * shape["dp"]], **shape)
    trees = {"bf16": jparams, "q8": jax_q8(jparams), "q4": jax_q4(jparams),
             "fused": jax_fuse(jparams), "unembed8": jax_u8(jparams)}
    for name, tree in trees.items():
        sharded = jax_shard(tree, JAX_TINY, jm)
        for r in ranks:
            assert_tree_equal(r["shards"][name], jax_local(sharded, jm, r["coords"]),
                              f"{name}@{r['coords']}")
    wq = ranks[0]["shards"]["bf16"]["blocks"]["wq"]
    assert wq.shape[-1] == jparams["blocks"]["wq"].shape[-1] // 2


def test_specs_tree_matches_param_tree(jparams):
    def plain(tree):
        return jax.tree.map(lambda s: tuple(s), tree, is_leaf=lambda x: isinstance(x, (JP, P)))

    tp = params_from_jax(np_tree(jparams), device="cpu")
    specs = param_specs(TINY)
    assert set(specs["blocks"]) == set(tp["blocks"]) and set(specs) == set(tp)
    assert plain(specs) == plain(jax_param_specs(JAX_TINY))
    assert plain(param_specs(TINY, quantized=True, q_unembed=True)) == plain(
        jax_param_specs(JAX_TINY, quantized=True, q_unembed=True))
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import fuse_blocks
    from llm_based_apache_spark_optimization_tpu_torch.ops import quant as q

    for mine, theirs in ((tp, jparams), (q.quantize_params(tp), jax_q8(jparams)),
                         (q.quantize_params_int4(tp), jax_q4(jparams)),
                         (fuse_blocks(tp), jax_fuse(jparams)),
                         (q.quantize_unembed(tp), jax_u8(jparams))):
        assert plain(specs_for_params(mine, tp=2)) == plain(
            jax_specs_for_params(theirs, tp=2))


@pytest.mark.parametrize("group", ["tp2", "dp2tp2"])
def test_sharded_forward_matches_unsharded(request, jparams, group):
    ranks = request.getfixturevalue(group)
    toks = jnp.asarray(tokens())
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32)[None], (4, 8))
    ref = np.asarray(jax_forward(JAX_TINY, jparams, toks, pos, None)[0])
    for r in ranks:
        dp, d = r["shape"]["dp"], r["coords"]["dp"]
        rows = slice(d * 4 // dp, (d + 1) * 4 // dp)
        np.testing.assert_allclose(r["logits"], ref[rows], rtol=2e-4, atol=2e-4)
        # shard_batch keeps the rank's dp rows, gather_batch puts them back.
        np.testing.assert_array_equal(r["rows"], tokens()[rows])
        np.testing.assert_array_equal(r["gathered"], tokens())


def test_sharded_generate_matches_unsharded(jparams, tp2, dp2tp2):
    golden = jax_gen(jparams, PROMPTS, 6, prompt_bucket=8)
    for r in tp2 + dp2tp2:
        assert r["engine"][0] == golden


def test_sharded_generate_pads_non_divisible_batch(jparams, dp2tp2):
    """3 prompts on a dp=2 mesh: the batch is padded to dp and sliced back."""
    golden = jax_gen(jparams, PROMPTS[:3], 5, prompt_bucket=8)
    for r in dp2tp2:
        assert r["engine"][1] == golden


def test_multihost_single_process_degenerates(monkeypatch):
    """Single process: init is a no-op, global_mesh is the local mesh, and
    this process is primary."""
    for name in ("LSOT_COORDINATOR", "LSOT_NUM_PROCESSES", "LSOT_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() is False
    assert is_primary()
    mesh = global_mesh(dp=1, sp=1, tp=1, devices=["cpu"])
    assert mesh.shape == {"dp": 1, "sp": 1, "tp": 1}
    batch = np.arange(8, dtype=np.int32).reshape(4, 2)
    np.testing.assert_array_equal(process_local_batch(batch, mesh).numpy(), batch)
    with pytest.raises(ValueError):
        global_mesh(dp=3, devices=["cpu"])


def test_vocab_sharded_tables_parity(jparams, tp2):
    """Embed/unembed shard the vocabulary over tp: the gather, the logits
    all-gather and sampling agree with the unsharded engine token for token,
    for f32 tables and the int8 per-row tables."""
    specs = specs_for_params(params_from_jax(np_tree(jparams), device="cpu"), tp=2)
    assert specs["embed"] == P("tp", None)
    for r in tp2:
        assert r["engine"][1] == jax_gen(jparams, TWO, 6, **STOP)
        assert r["engine"][2] == jax_gen(jax_u8(jparams), TWO, 6, **STOP)


def test_sp_sharded_decode_cache_parity(jparams, sp2tp2):
    """Cache slots sharded over sp (ring prefill, then the sp combine at
    each decode step): greedy output equals the unsharded engine's, bf16
    and int8 caches."""
    for i, kvq in enumerate((None, "int8")):
        golden = jax_gen(jparams, SP_PROMPTS, 8, kv_quant=kvq, **STOP)
        for r in sp2tp2:
            assert r["engine"][i] == golden, kvq


def test_tp_sharded_paged_parity_engine_and_scheduler(jparams, tp2):
    """The paged pool's KV heads shard over tp (tables replicated): the
    engine loop and the scheduler (rank 0 drives, rank 1 follows) equal the
    single-device paged path, bf16 and int8 pools."""
    for i, kvq in ((3, None), (4, "int8")):
        golden = jax_gen(jparams, PROMPTS, 6, kv_quant=kvq, **PAGED)
        for r in tp2:
            assert r["engine"][i] == golden, kvq
    with JaxScheduler(JAX_TINY, jparams, kv_layout="paged", kv_page_size=16,
                      **SCHED) as s:
        golden = s.generate(PROMPTS, max_new_tokens=6)
    assert tp2[0]["scheduler"][0] == golden
    assert tp2[1]["scheduler"] == [None] * len(TP_SCHED)  # followers submit nothing


def test_tp_sharded_paged_speculative_parity(jparams, tp2):
    for i, kvq in ((5, None), (6, "int8")):
        golden = jax_gen(jparams, PROMPTS, 6, kv_quant=kvq, speculative_draft=4,
                         **PAGED)
        for r in tp2:
            assert r["engine"][i] == golden, kvq


def test_tp_sharded_quantized_and_contiguous_scheduler(jparams, tp2):
    """int4 blocks (column and row-parallel int4 products), int8 blocks over
    an int8 cache, and the contiguous scheduler layout at tp=2."""
    assert tp2[0]["engine"][7] == jax_gen(jax_q4(jparams), PROMPTS, 6, **STOP)
    assert tp2[0]["engine"][8] == jax_gen(jax_q8(jparams), PROMPTS, 6,
                                          kv_quant="int8", **STOP)
    with JaxScheduler(JAX_TINY, jparams, **SCHED) as s:
        assert tp2[0]["scheduler"][1] == s.generate(PROMPTS, max_new_tokens=6)
    with JaxScheduler(JAX_TINY, jax_q4(jparams), kv_layout="paged", kv_page_size=16,
                      kv_quant="int8", **SCHED) as s:
        assert tp2[0]["scheduler"][2] == s.generate(PROMPTS, max_new_tokens=6)


def test_checkpoints_load_straight_to_the_mesh(tp2):
    """HF, GGUF (f32) and the native cache load each rank's block, the
    block `shard_params` gives; int8- and int4-quantizing a loaded block
    (the row-parallel int8 scales reduced over tp, the int4 groups of the
    whole contraction) gives the block of the whole tree's quantization."""
    for r in tp2:
        assert_tree_equal(r["hf"], r["shards"]["bf16"], "hf")
        assert_tree_equal(r["gguf"], r["shards"]["bf16"], "gguf")
        assert_tree_equal(r["native"], r["shards"]["bf16"], "native")
        assert_tree_equal(r["q8_loaded"], r["shards"]["q8"], "q8")
        assert_tree_equal(r["q4_loaded"], r["shards"]["q4"], "q4")


@pytest.mark.parametrize("fmt", ["hf", "gguf"])
def test_checkpoint_loads_move_only_the_block(ckpt, monkeypatch, fmt):
    """A load straight to the mesh cuts each rank's block from the host
    tensor before it places it: what reaches the rank's device is the block
    and no more (the tensors `place` moves add up to the rank's tree), and
    the two ranks' blocks are the halves `shard_params` gives."""
    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import (
        load_gguf_checkpoint,
        load_hf_checkpoint,
    )
    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import hf
    from llm_based_apache_spark_optimization_tpu_torch.parallel.mesh import Mesh
    from llm_based_apache_spark_optimization_tpu_torch.parallel.sharding import (
        shard_params,
    )

    moved = []
    real = hf.place

    def spy(t, *a, **kw):
        moved.append(t.numel())
        return real(t, *a, **kw)

    monkeypatch.setattr(hf, "place", spy)

    def load(mesh=None):
        if fmt == "hf":
            return load_hf_checkpoint(ckpt / "hf", dtype=torch.float32,
                                      device="cpu", mesh=mesh)[1]
        return load_gguf_checkpoint(ckpt / "tiny.gguf", dtype=torch.float32,
                                    device="cpu", mesh=mesh)[1]

    def numel(tree):
        return sum(numel(v) for v in tree.values()) if isinstance(tree, dict) \
            else tree.numel()

    def as_np(tree):
        return {k: as_np(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else tree.numpy()

    whole = load()
    for rank in range(2):
        mesh = Mesh(1, 1, 2, ["cpu"] * 2, rank=rank)
        moved.clear()
        local = load(mesh)
        assert sum(moved) == numel(local) < numel(whole)
        assert_tree_equal(as_np(local), as_np(shard_params(whole, TINY, mesh)), fmt)


def test_scheduler_rebuilt_on_rank0_gets_a_twin(jparams, tmp_path):
    """A scheduler built on rank 0 while the other rank follows (a
    supervisor's restart) from the same params and arguments as an earlier
    one: the follower builds its twin (`_follow_clone`), and the rebuilt
    scheduler's greedy tokens equal the first's and JAX's."""
    with JaxScheduler(JAX_TINY, jparams, kv_layout="paged", kv_page_size=16,
                      **SCHED) as s:
        golden = s.generate(PROMPTS, max_new_tokens=6)
    first, second = run_group(2, "clone_group", tmp_path, dict(
        mesh={"tp": 2}, cfg="tiny", params=np_tree(jparams), prompts=PROMPTS, new=6,
        kw=dict(SCHED, kv_layout="paged", kv_page_size=16, fuse_matmuls=True)))[0]
    assert first == second == golden


def test_evalh_virtual_devices_run_the_tp_config(tmp_path):
    """`evalh --virtual-devices 4` (ranks of one group): the BASELINE config
    naming tp=4 runs on the tp=4 tiny service and its row says "tp=4", as
    JAX's does on 4 of its virtual devices."""
    got = run_group(4, "evalh_group", tmp_path,
                    {"n": 4, "config": "4-spider-batch32-tp4"})
    assert got[0] == ("tp=4", 32) and got[1:] == [None] * 3


def test_scheduler_mesh_refusals(jparams):
    """dp > 1 raises as in JAX. sp > 1, refused until ROADMAP A13.1 was
    ported, now builds: the scheduler and the paged engine on an sp mesh
    (tests/test_torch_sp.py serves them against JAX). Phase roles and
    `kv_spill` on a mesh, refused until the exports of a sharded pool were
    ported, now build (tests/test_torch_pool_mesh.py serves them on tp=2
    meshes)."""
    from llm_based_apache_spark_optimization_tpu_torch.parallel.mesh import Mesh
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )

    tp = params_from_jax(np_tree(jparams), device="cpu")
    with pytest.raises(ValueError, match="dp=1"):
        ContinuousBatchingScheduler(TINY, tp, mesh=Mesh(2, 1, 1, ["cpu"] * 2))
    for layout in ("contiguous", "paged"):
        s = ContinuousBatchingScheduler(TINY, tp, mesh=Mesh(1, 2, 1, ["cpu"] * 2),
                                        kv_layout=layout)
        assert s.mesh.shape["sp"] == 2 and s.kv_layout == layout
    for role, spill in (("prefill", False), ("decode", True), ("mixed", True)):
        s = ContinuousBatchingScheduler(TINY, tp, mesh=make_mesh(devices=["cpu"]),
                                        kv_layout="paged", phase_role=role,
                                        kv_spill=spill)
        assert (s.phase_role, s._kv_spill) == (role, spill)
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine

    cfg = dataclasses.replace(TINY, num_heads=4)
    eng = InferenceEngine(cfg, tp, mesh=Mesh(1, 2, 1, ["cpu"] * 2), kv_layout="paged")
    assert eng.kv_layout == "paged" and eng.mesh.shape["sp"] == 2

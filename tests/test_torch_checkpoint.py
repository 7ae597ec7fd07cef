"""The port's HF checkpoint layer against the JAX package's, on the CPU in
f32 (TINY): a checkpoint written by JAX's `save_hf_checkpoint` loads to the
same arrays and config through both loaders (tied and untied, llama3 rope
scaling, an `eos_token_id` list, a sharded index) and gives the same logits
(1e-5) and greedy tokens; the port's writer loads in JAX's loader (through
the `safetensors` package); a `transformers`-written checkpoint gives torch's
own `LlamaForCausalLM` logits; the port's reader works with `safetensors`
made unimportable; the native cache round-trips; the scheduler and engine
backends serve a loaded checkpoint with JAX's tokens."""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.checkpoint import (
    load_hf_checkpoint as jax_load_hf,
)
from llm_based_apache_spark_optimization_tpu.checkpoint import (
    save_hf_checkpoint as jax_save_hf,
)
from llm_based_apache_spark_optimization_tpu.engine.generate import (
    InferenceEngine as JaxEngine,
)
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.models.llama import forward as jax_forward
from llm_based_apache_spark_optimization_tpu_torch.checkpoint import (
    config_from_hf,
    load_hf_checkpoint,
    load_native,
    save_hf_checkpoint,
    save_native,
)
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward
from llm_based_apache_spark_optimization_tpu_torch.serve import EngineBackend
from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
    SchedulerBackend,
)
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

TOKENS = [[1, 17, 93, 5, 44, 8], [1, 40, 2, 77, 60, 31]]
PROMPTS = [[1, 17, 93, 5], [1, 40, 41]]


def cfg_fields(cfg) -> dict:
    """A config's fields, its rope scaling as (type name, fields): the two
    packages' configs are different classes with the same fields."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    rs = out["rope_scaling"]
    if rs is not None:
        out["rope_scaling"] = (type(rs).__name__, dataclasses.asdict(rs))
    return out


def leaves(params) -> dict:
    flat = {k: v for k, v in params.items() if k != "blocks"}
    flat.update({f"blocks.{k}": v for k, v in params["blocks"].items()})
    return flat


def assert_same_arrays(jparams, tparams):
    jl, tl = leaves(jparams), leaves(tparams)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]), err_msg=k)


def jax_logits(cfg, params):
    toks = jnp.asarray(TOKENS, jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1], dtype=jnp.int32), toks.shape)
    return np.asarray(jax_forward(cfg, params, toks, pos, None)[0])


def port_logits(cfg, params):
    toks = torch.tensor(TOKENS, dtype=torch.int32)
    pos = torch.arange(toks.shape[1], dtype=torch.int32)[None].expand_as(toks)
    return forward(cfg, params, toks, pos, None)[0].numpy()


VARIANTS = {
    "tied_llama3_rope": {},
    "untied": {"tie_embeddings": False, "rope_scaling": None},
    "eos_list": {"extra_stop_ids": (182, 264)},
    "sliding_window": {"sliding_window": 16, "rope_scaling": None},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_jax_written_hf_loads_the_same_in_both(tmp_path, variant):
    jcfg = dataclasses.replace(JAX_TINY, **VARIANTS[variant])
    jp = jax_init(jcfg, jax.random.key(3), dtype=jnp.float32)
    jax_save_hf(jcfg, jp, tmp_path)
    jc, ja = jax_load_hf(tmp_path, dtype=jnp.float32)
    tc, ta = load_hf_checkpoint(tmp_path, dtype=torch.float32, device="cpu")
    assert cfg_fields(tc) == cfg_fields(jc)
    assert_same_arrays(ja, ta)
    np.testing.assert_allclose(port_logits(tc, ta), jax_logits(jc, ja), atol=1e-5)
    want = JaxEngine(jc, ja).generate(PROMPTS, max_new_tokens=10)
    assert InferenceEngine(tc, ta, device="cpu").generate(
        PROMPTS, max_new_tokens=10) == want
    if variant == "eos_list":
        assert tc.stop_ids == (2, 182, 264)


def test_sharded_index_loads_like_one_file(tmp_path):
    """A checkpoint split over two files through model.safetensors.index.json
    loads to the same tree as the single file it came from, in both."""
    from safetensors.numpy import load_file, save_file

    jp = jax_init(JAX_TINY, jax.random.key(4), dtype=jnp.float32)
    jax_save_hf(JAX_TINY, jp, tmp_path / "one")
    tensors = load_file(tmp_path / "one" / "model.safetensors")
    names = sorted(tensors)
    shard = tmp_path / "sharded"
    shard.mkdir()
    weight_map = {}
    for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        save_file({n: tensors[n] for n in part}, shard / fname)
        weight_map.update({n: fname for n in part})
    (shard / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))
    (shard / "config.json").write_text((tmp_path / "one" / "config.json").read_text())
    _, ja = jax_load_hf(shard, dtype=jnp.float32)
    _, one = load_hf_checkpoint(tmp_path / "one", dtype=torch.float32, device="cpu")
    _, ta = load_hf_checkpoint(shard, dtype=torch.float32, device="cpu")
    assert_same_arrays(ja, ta)
    for k, v in leaves(one).items():
        assert torch.equal(leaves(ta)[k], v)


@pytest.mark.parametrize("tie", [True, False])
def test_port_written_hf_loads_in_jax(tmp_path, tie):
    """The port's own safetensors writer -> the JAX loader (the
    `safetensors` package reads it): the same arrays and config."""
    jcfg = dataclasses.replace(JAX_TINY, tie_embeddings=tie)
    tcfg = dataclasses.replace(TINY, tie_embeddings=tie)
    jp = jax_init(jcfg, jax.random.key(5), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    save_hf_checkpoint(tcfg, tp, tmp_path)
    jc, ja = jax_load_hf(tmp_path, dtype=jnp.float32)
    assert cfg_fields(jc) == cfg_fields(
        dataclasses.replace(tcfg, name=tmp_path.name))
    assert_same_arrays(ja, tp)


def test_bf16_round_trip_is_exact(tmp_path):
    """bf16 -> the f32 file -> bf16 is the identity, so a bf16 tree
    survives save and load bit for bit."""
    tp = params_from_jax(jax.tree.map(
        np.asarray, jax_init(JAX_TINY, jax.random.key(6), dtype=jnp.bfloat16)),
        device="cpu")
    save_hf_checkpoint(TINY, tp, tmp_path)
    _, back = load_hf_checkpoint(tmp_path, device="cpu")
    for k, v in leaves(tp).items():
        assert leaves(back)[k].dtype == torch.bfloat16
        assert torch.equal(leaves(back)[k], v), k


def test_loader_needs_no_safetensors_package(tmp_path, monkeypatch):
    """With `import safetensors` failing, the port still loads (its own
    reader) and writes a checkpoint."""
    jp = jax_init(JAX_TINY, jax.random.key(7), dtype=jnp.float32)
    jax_save_hf(JAX_TINY, jp, tmp_path)
    for name in [m for m in sys.modules if m == "safetensors" or m.startswith("safetensors.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401
    _, ta = load_hf_checkpoint(tmp_path, dtype=torch.float32, device="cpu")
    save_hf_checkpoint(TINY, ta, tmp_path / "again")
    _, back = load_hf_checkpoint(tmp_path / "again", dtype=torch.float32, device="cpu")
    assert_same_arrays(jp, back)


def test_config_from_hf_matches_jax():
    from llm_based_apache_spark_optimization_tpu.checkpoint import (
        config_from_hf as jax_config_from_hf,
    )

    hf = {"vocab_size": 128256, "hidden_size": 3072, "intermediate_size": 8192,
          "num_hidden_layers": 28, "num_attention_heads": 24,
          "num_key_value_heads": 8, "max_position_embeddings": 131072,
          "rope_theta": 500000.0, "tie_word_embeddings": True,
          "eos_token_id": [128001, 128008, 128009], "bos_token_id": 128000,
          "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                           "original_max_position_embeddings": 8192}}
    assert cfg_fields(config_from_hf(hf, "x")) == cfg_fields(jax_config_from_hf(hf, "x"))


def test_loading_onto_several_devices_names_a13(tmp_path):
    """A sharded load (ROADMAP A13, ported) names its mesh: a list of
    several devices is not one and raises, pointing at `mesh`; a load onto
    a mesh of one rank is the plain load (each rank's block on a mesh of
    several: tests/test_torch_parallel.py)."""
    from llm_based_apache_spark_optimization_tpu_torch.parallel import make_mesh

    jax_save_hf(JAX_TINY, jax_init(JAX_TINY, jax.random.key(8), dtype=jnp.float32),
                tmp_path)
    with pytest.raises(ValueError, match="mesh"):
        load_hf_checkpoint(tmp_path, device=["cpu", "cpu"])
    _, whole = load_hf_checkpoint(tmp_path, device="cpu", dtype=torch.float32)
    _, on_mesh = load_hf_checkpoint(tmp_path, dtype=torch.float32,
                                    mesh=make_mesh(devices=["cpu"]))
    for k, v in leaves(whole).items():
        assert torch.equal(leaves(on_mesh)[k], v), k


def test_native_cache_round_trip(tmp_path):
    tp = params_from_jax(jax.tree.map(
        np.asarray, jax_init(JAX_TINY, jax.random.key(9), dtype=jnp.float32)),
        device="cpu")
    save_native(tp, tmp_path / "tree.pt")
    back = load_native(TINY, tmp_path / "tree.pt", dtype=None, device="cpu")
    for k, v in leaves(tp).items():
        assert torch.equal(leaves(back)[k], v), k
    with pytest.raises(ValueError, match="layers"):
        load_native(dataclasses.replace(TINY, num_layers=3), tmp_path / "tree.pt",
                    device="cpu")


# ------------------------------------------------------ external source

HF_KW = dict(vocab_size=96, hidden_size=32, intermediate_size=48,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
             attention_bias=False, mlp_bias=False, bos_token_id=1,
             eos_token_id=2, pad_token_id=0)
EXT_TOKENS = [[1, 5, 9, 12, 3, 7], [1, 88, 2, 44, 60, 31]]


@pytest.mark.parametrize("tie", [False, True])
def test_transformers_written_checkpoint_matches_torch_logits(tmp_path, tie):
    """`transformers.LlamaForCausalLM.save_pretrained` -> the port's loader:
    the port's forward gives torch's own logits (the tolerance of
    tests/test_checkpoint_external.py)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(
        transformers.LlamaConfig(**HF_KW, tie_word_embeddings=tie)).eval().float()
    model.save_pretrained(tmp_path, safe_serialization=True)
    with torch.no_grad():
        ref = model(torch.tensor(EXT_TOKENS)).logits.numpy()
    cfg, params = load_hf_checkpoint(tmp_path, dtype=torch.float32, device="cpu")
    assert cfg.tie_embeddings == tie and ("lm_head" in params) != tie
    toks = torch.tensor(EXT_TOKENS, dtype=torch.int32)
    pos = torch.arange(6, dtype=torch.int32)[None].expand_as(toks)
    ours = forward(cfg, params, toks, pos, None)[0].numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3)


# ------------------------------------------------------- the backends

def test_backends_from_hf_checkpoint_serve_jax_tokens(tmp_path):
    """`SchedulerBackend.from_hf_checkpoint` (supervised) and
    `EngineBackend.from_hf_checkpoint` over a JAX-written checkpoint give
    the greedy tokens of JAX's engine on the same weights."""
    jcfg = dataclasses.replace(JAX_TINY, max_seq_len=128)
    jp = jax_init(jcfg, jax.random.key(10), dtype=jnp.float32)
    jax_save_hf(jcfg, jp, tmp_path)
    jc, ja = jax_load_hf(tmp_path, dtype=jnp.float32)
    tok = ByteTokenizer()
    prompt = "SELECT"
    ids = tok.encode(prompt)
    want = JaxEngine(jc, ja, stop_ids=(-1,)).generate([ids], max_new_tokens=6)[0]
    eng = EngineBackend.from_hf_checkpoint(str(tmp_path), tok, dtype=torch.float32,
                                           device="cpu", stop_ids=(-1,),
                                           max_new_tokens=6)
    assert eng.engine.generate([ids], max_new_tokens=6)[0] == want
    sb = SchedulerBackend.from_hf_checkpoint(
        str(tmp_path), tok, dtype=torch.float32, device="cpu", stop_ids=(-1,),
        num_slots=2, prompt_bucket=16, max_seq=128, decode_chunk=4,
        supervise=True, stall_min_s=0.0, max_new_tokens=6)
    try:
        assert sb.supports_idempotency and sb.health()["state"] == "ready"
        fut = sb.scheduler.submit(ids, max_new_tokens=6)
        assert fut.result(timeout=60) == want
    finally:
        sb.shutdown()


@pytest.mark.parametrize("backend", ["scheduler", "engine"])
def test_backends_from_hf_checkpoint_serve_speculative(tmp_path, backend):
    """`speculative_draft=2` reaches the scheduler (supervised) and the
    engine a checkpoint backend builds, which serve JAX's speculative
    engine's greedy tokens over verify rounds."""
    jcfg = dataclasses.replace(JAX_TINY, max_seq_len=128)
    jax_save_hf(jcfg, jax_init(jcfg, jax.random.key(10), dtype=jnp.float32), tmp_path)
    jc, ja = jax_load_hf(tmp_path, dtype=jnp.float32)
    tok = ByteTokenizer()
    ids = tok.encode("SELECT a FROM t")
    want = JaxEngine(jc, ja, stop_ids=(-1,), speculative_draft=2).generate(
        [ids], max_new_tokens=8)[0]
    common = dict(dtype=torch.float32, device="cpu", stop_ids=(-1,), max_new_tokens=8,
                  prompt_bucket=16, speculative_draft=2)
    if backend == "engine":
        eng = EngineBackend.from_hf_checkpoint(str(tmp_path), tok, **common)
        assert eng.engine.speculative_draft == 2
        assert eng.engine.generate([ids], max_new_tokens=8)[0] == want
        assert eng.engine.last_spec_rounds >= 1
        return
    sb = SchedulerBackend.from_hf_checkpoint(str(tmp_path), tok, num_slots=2,
                                             max_seq=128, supervise=True,
                                             stall_min_s=0.0, **common)
    try:
        assert sb.scheduler._spec_draft == 2
        assert sb.scheduler.submit(ids, max_new_tokens=8).result(timeout=60) == want
        assert sb.scheduler.speculation_stats["verify_rounds"] >= 1
    finally:
        sb.shutdown()


@pytest.mark.parametrize("kwargs,item", [
    ({"mesh": object()}, "A13"),
])
def test_scheduler_from_hf_refuses_unported(tmp_path, kwargs, item):
    """A mesh (ROADMAP A13) is ported: the constructor takes one and loads
    each rank's block onto its device (tests/test_torch_parallel.py). The
    spill of a sharded pool (ROADMAP A13.2), refused until the exports of
    a sharded pool were ported, now builds: the paged scheduler under the
    mesh takes `kv_spill` (tests/test_torch_pool_mesh.py spills on tp=2)."""
    from llm_based_apache_spark_optimization_tpu_torch.parallel import make_mesh

    assert item == "A13" and "mesh" in kwargs
    jax_save_hf(JAX_TINY, jax_init(JAX_TINY, jax.random.key(8), dtype=jnp.float32),
                tmp_path)
    sb = SchedulerBackend.from_hf_checkpoint(
        str(tmp_path), ByteTokenizer(), mesh=make_mesh(devices=["cpu"]),
        dtype=torch.float32, num_slots=2, max_seq=64)
    try:
        assert sb.scheduler.mesh.shape == {"dp": 1, "sp": 1, "tp": 1}
        assert sb.scheduler.submit([1, 5, 9], max_new_tokens=4).result(timeout=60)
    finally:
        sb.shutdown()
    sb = SchedulerBackend.from_hf_checkpoint(
        str(tmp_path), ByteTokenizer(), mesh=make_mesh(devices=["cpu"]),
        dtype=torch.float32, num_slots=2, max_seq=64, kv_layout="paged",
        kv_spill=True)
    try:
        assert sb.scheduler._kv_spill and sb.scheduler.mesh is not None
        assert sb.scheduler.submit([1, 5, 9], max_new_tokens=4).result(timeout=60)
    finally:
        sb.shutdown()


def int8_tokens_of_jax(jtree, jcfg, ids):
    """JAX's engine on JAX's int8 serving tree (int8 blocks first, then the
    int8 embed/unembed tables, the constructors' order): greedy tokens."""
    from llm_based_apache_spark_optimization_tpu.ops.quant import (
        quantize_params as jax_quantize_params,
    )
    from llm_based_apache_spark_optimization_tpu.ops.quant import (
        quantize_unembed as jax_quantize_unembed,
    )

    tree = jax_quantize_unembed(jax_quantize_params(jtree))
    return JaxEngine(jcfg, tree, stop_ids=(-1,)).generate([ids], max_new_tokens=6)[0]


def assert_serves_int8(backend_cls, load, ids, want):
    """`load(cls, **kwargs)` with quantize_int8 and quantize_unembed8 gives
    a backend whose tree holds q8 block weights and a q8 table, and whose
    request completes with `want`'s greedy tokens."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import is_qtensor

    common = dict(dtype=torch.float32, device="cpu", stop_ids=(-1,), max_new_tokens=6,
                  quantize_int8=True, quantize_unembed8=True)
    if backend_cls is EngineBackend:
        be = load(backend_cls, **common)
        tree = be.engine.params
        assert be.engine.generate([ids], max_new_tokens=6)[0] == want
        assert be.complete("SELECT").output_tokens >= 1
    else:
        be = load(backend_cls, num_slots=2, prompt_bucket=16, decode_chunk=4,
                  supervise=True, stall_min_s=0.0, **common)
        try:
            tree = be.scheduler._inner.params  # the supervised scheduler's
            assert be.scheduler.submit(ids, max_new_tokens=6).result(timeout=60) == want
            assert be.complete("SELECT").output_tokens >= 1
        finally:
            be.shutdown()
    assert all(is_qtensor(tree["blocks"][k]) for k in ("wq", "wk", "wv", "wo", "wg",
                                                        "wu", "wd"))
    assert is_qtensor(tree["embed"]) and tree["embed"]["q8"].dtype == torch.int8


@pytest.mark.parametrize("backend", ["scheduler", "engine"])
def test_backends_from_hf_checkpoint_serve_int8(tmp_path, backend):
    """`quantize_int8=True, quantize_unembed8=True` through the HF
    constructors (the scheduler supervised): q8 trees in place, and JAX's
    greedy tokens on JAX's int8 tree of the same checkpoint."""
    jcfg = dataclasses.replace(JAX_TINY, max_seq_len=128)
    jp = jax_init(jcfg, jax.random.key(12), dtype=jnp.float32)
    jax_save_hf(jcfg, jp, tmp_path)
    jc, ja = jax_load_hf(tmp_path, dtype=jnp.float32)
    ids = ByteTokenizer().encode("SELECT")
    want = int8_tokens_of_jax(ja, jc, ids)
    cls = SchedulerBackend if backend == "scheduler" else EngineBackend
    assert_serves_int8(cls, lambda c, **kw: c.from_hf_checkpoint(
        str(tmp_path), ByteTokenizer(), **kw), ids, want)


@pytest.mark.parametrize("cls", [SchedulerBackend, EngineBackend],
                         ids=["scheduler", "engine"])
def test_from_hf_checkpoint_picks_one_weight_format(tmp_path, cls):
    with pytest.raises(ValueError, match="pick one of quantize_int8 / quantize_int4"):
        cls.from_hf_checkpoint(str(tmp_path), ByteTokenizer(), device="cpu",
                               quantize_int8=True, quantize_int4=True)


@pytest.mark.parametrize("kwargs,attr,want", [
    ({"kv_overcommit": 0.5}, "_kv_overcommit", 0.5),
    ({"kv_spill": True}, "_kv_spill", True),
    ({"kv_watermark_low": 0.25, "kv_watermark_high": 0.5}, "_wm_high_pages", 8),
    ({"max_queue_depth": 4}, "max_queue_depth", 4),
], ids=["overcommit", "spill", "watermarks", "queue_depth"])
def test_scheduler_from_hf_honours_pressure_and_admission_knobs(tmp_path, kwargs,
                                                                 attr, want):
    """The page-pressure knobs (ROADMAP A7.4) and max_queue_depth (A7.6)
    reach the paged scheduler a checkpoint backend builds, which serves."""
    jcfg = dataclasses.replace(JAX_TINY, max_seq_len=128)
    jax_save_hf(jcfg, jax_init(jcfg, jax.random.key(10), dtype=jnp.float32), tmp_path)
    sb = SchedulerBackend.from_hf_checkpoint(
        str(tmp_path), ByteTokenizer(), dtype=torch.float32, device="cpu",
        stop_ids=(-1,), num_slots=2, prompt_bucket=16, decode_chunk=4,
        kv_layout="paged", kv_page_size=16, kv_pages=16, max_new_tokens=6, **kwargs)
    try:
        assert getattr(sb.scheduler, attr) == want
        assert sb.complete("SELECT").output_tokens == 6
    finally:
        sb.shutdown()

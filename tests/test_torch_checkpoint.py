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
    jax_save_hf(JAX_TINY, jax_init(JAX_TINY, jax.random.key(8), dtype=jnp.float32),
                tmp_path)
    with pytest.raises(NotImplementedError, match="A13"):
        load_hf_checkpoint(tmp_path, device=["cpu", "cpu"])


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


@pytest.mark.parametrize("kwargs,item", [
    ({"quantize_int8": True}, "A10"),
    ({"quantize_unembed8": True}, "A10"),
    ({"speculative_draft": 2}, "A9"),
    ({"mesh": object()}, "A13"),
    ({"kv_overcommit": 0.5}, "A7.4"),
    ({"kv_spill": True}, "A7.4"),
    ({"max_queue_depth": 4}, "A7.6"),
])
def test_scheduler_from_hf_refuses_unported(tmp_path, kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        SchedulerBackend.from_hf_checkpoint(str(tmp_path), ByteTokenizer(),
                                            device="cpu", **kwargs)

"""The port's GGUF layer against the JAX package's, on the CPU in f32 (TINY):
blobs written by JAX's `write_gguf` in f32, f16, q8_0, q4_0 and q6_k load to
the same arrays and config through both loaders (the port's own C++ reader,
built with g++ into the package's build/); the port's `write_gguf` writes the
same bytes as JAX's in every format; `rope_freqs.weight` loads as
`RopeFreqFactors`; a blob written straight from the GGUF spec with
llama.cpp's Q/K permutation gives torch's own logits; and the engine and the
supervised scheduler serve a blob with JAX's greedy tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.checkpoint import (
    load_gguf_checkpoint as jax_load_gguf,
)
from llm_based_apache_spark_optimization_tpu.checkpoint import write_gguf as jax_write_gguf
from llm_based_apache_spark_optimization_tpu.engine.generate import (
    InferenceEngine as JaxEngine,
)
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu_torch import native
from llm_based_apache_spark_optimization_tpu_torch.checkpoint import (
    load_gguf_checkpoint,
    write_gguf,
)
from llm_based_apache_spark_optimization_tpu_torch.checkpoint.gguf import (
    _permute_qk,
    _unpermute_qk,
)
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.models.configs import RopeFreqFactors
from llm_based_apache_spark_optimization_tpu_torch.models.llama import forward
from llm_based_apache_spark_optimization_tpu_torch.serve import EngineBackend
from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
    SchedulerBackend,
)
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer
from test_torch_checkpoint import (
    assert_same_arrays,
    assert_serves_int8,
    cfg_fields,
    int8_tokens_of_jax,
    jax_logits,
    port_logits,
)

QUANTS = ["f32", "f16", "q8_0", "q4_0", "q6_k"]
PROMPTS = [[1, 17, 93, 5], [1, 40, 41]]

#: q6_k packs 256-element super-blocks: every matrix of the config must hold
#: a multiple of 256 (TINY's 32 x 64 blocks do; its 320-row embed does too).
VARIANTS = {
    "tied_llama3_rope": {},
    "untied": {"tie_embeddings": False, "rope_scaling": None},
    "sliding_window": {"sliding_window": 16},
}


def both_trees(seed, **over):
    jcfg = dataclasses.replace(JAX_TINY, **over)
    tcfg = dataclasses.replace(TINY, **over)
    jp = jax_init(jcfg, jax.random.key(seed), dtype=jnp.float32)
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("quant", QUANTS)
def test_jax_written_gguf_loads_the_same_in_both(tmp_path, quant):
    jcfg, jp, _, _ = both_trees(11, tie_embeddings=False)
    path = tmp_path / f"m.{quant}.gguf"
    jax_write_gguf(jcfg, jp, path, quant=quant)
    jc, ja = jax_load_gguf(path, dtype=jnp.float32)
    tc, ta = load_gguf_checkpoint(path, dtype=torch.float32, device="cpu")
    assert cfg_fields(tc) == cfg_fields(jc)
    assert_same_arrays(ja, ta)
    np.testing.assert_allclose(port_logits(tc, ta), jax_logits(jc, ja), atol=1e-5)
    want = JaxEngine(jc, ja).generate(PROMPTS, max_new_tokens=10)
    assert InferenceEngine(tc, ta, device="cpu").generate(
        PROMPTS, max_new_tokens=10) == want


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("quant", QUANTS)
def test_write_gguf_same_bytes_as_jax(tmp_path, quant, variant):
    jcfg, jp, tcfg, tp = both_trees(12, **VARIANTS[variant])
    jax_write_gguf(jcfg, jp, tmp_path / "jax.gguf", quant=quant)
    write_gguf(tcfg, tp, tmp_path / "port.gguf", quant=quant)
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()


def edge_blocks(seed):
    """Blocks of 32 that take each branch of the block quantizers: all
    zeros, a signed tie for the largest magnitude (+a before -a and -a
    before +a), f16-subnormal and f32-subnormal scales, huge values, and
    random rows."""
    rng = np.random.default_rng(seed)
    rows = [np.zeros(32), np.r_[0.5, -0.5, rng.uniform(-0.4, 0.4, 30)],
            np.r_[-0.5, 0.5, rng.uniform(-0.4, 0.4, 30)],
            rng.uniform(-1e-6, 1e-6, 32), rng.uniform(-1e-40, 1e-40, 32),
            rng.uniform(-6e4, 6e4, 32), -np.abs(rng.standard_normal(32)),
            np.r_[np.zeros(31), -3.0]]
    rows += list(rng.standard_normal((24, 32)) * rng.uniform(1e-3, 10, (24, 1)))
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("quant", ["q8_0", "q4_0"])
def test_block_quantizers_same_bytes_as_jax_on_edge_blocks(quant):
    """The port's torch block quantizers write JAX's numpy bytes on the
    blocks where rounding, ties and zero scales decide them."""
    from llm_based_apache_spark_optimization_tpu.checkpoint.gguf import (
        _quantize as jax_quantize,
    )
    from llm_based_apache_spark_optimization_tpu_torch.checkpoint.gguf import _quantize

    a = edge_blocks(3)
    assert _quantize(torch.from_numpy(a), quant) == jax_quantize(a, quant)


def test_rope_freqs_load_as_freq_factors(tmp_path):
    """TINY's llama3 rope scaling ships as `rope_freqs.weight` and comes back
    as RopeFreqFactors with JAX's factors; the logits of the reloaded tree
    stay within 1e-5 of the scaled original's."""
    jcfg, jp, tcfg, tp = both_trees(13)
    write_gguf(tcfg, tp, tmp_path / "m.gguf", quant="f32")
    tc, ta = load_gguf_checkpoint(tmp_path / "m.gguf", dtype=torch.float32, device="cpu")
    jc, _ = jax_load_gguf(tmp_path / "m.gguf", dtype=jnp.float32)
    assert isinstance(tc.rope_scaling, RopeFreqFactors)
    assert tc.rope_scaling.factors == jc.rope_scaling.factors
    assert len(tc.rope_scaling.factors) == tcfg.head_dim // 2
    np.testing.assert_allclose(port_logits(tc, ta), port_logits(tcfg, tp), atol=1e-5)


def test_unpermute_inverts_permute():
    w = np.arange(16 * 6, dtype=np.float32).reshape(16, 6)
    np.testing.assert_array_equal(_unpermute_qk(_permute_qk(w, 2), 2), w)


def test_spec_written_gguf_matches_torch_logits(tmp_path):
    """A blob written straight from the GGUF v3 spec, its Q/K rows permuted
    by llama.cpp's converter formula (tests/test_checkpoint_external.py's
    writer), loads in the port to torch's own LlamaForCausalLM logits: the
    unpermute direction is held to the real converter, not to its inverse."""
    transformers = pytest.importorskip("transformers")
    from test_checkpoint_external import HF_KW, TOKENS, _write_external_gguf

    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(
        transformers.LlamaConfig(**HF_KW, tie_word_embeddings=False)).eval().float()
    with torch.no_grad():
        ref = model(torch.tensor(TOKENS)).logits.numpy()
    state = {k: v.numpy().astype(np.float32) for k, v in model.state_dict().items()}
    _write_external_gguf(tmp_path / "ext.gguf", state, HF_KW)
    cfg, params = load_gguf_checkpoint(tmp_path / "ext.gguf", dtype=torch.float32,
                                       device="cpu")
    assert (cfg.num_heads, cfg.num_kv_heads) == (4, 2)
    toks = torch.tensor(TOKENS, dtype=torch.int32)
    pos = torch.arange(toks.shape[1], dtype=torch.int32)[None].expand_as(toks)
    ours = forward(cfg, params, toks, pos, None)[0].numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3)


def test_reader_reports_shapes_dtypes_and_metadata(tmp_path):
    jcfg, jp, _, _ = both_trees(14)
    jax_write_gguf(jcfg, jp, tmp_path / "m.gguf", quant="q4_0")
    with native.GGUFReader(tmp_path / "m.gguf") as r:
        assert r.shape("blk.0.attn_q.weight") == (32, 32)
        assert r.dtype("blk.0.attn_q.weight") == native.GGUFReader.Q4_0
        assert r.dtype("blk.0.attn_norm.weight") == native.GGUFReader.F32
        assert r.meta_str("general.architecture") == "llama"
        assert r.meta_num("llama.block_count") == 2
        assert r.meta_num("no.such.key") is None
    with pytest.raises(ValueError, match="GGUF open failed"):
        native.GGUFReader(tmp_path / "missing.gguf")


def test_reader_build_failure_raises(monkeypatch, tmp_path):
    """No Python fallback: when g++ cannot build the reader, opening a blob
    raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "LIB", str(tmp_path / "libgguf.so"))
    monkeypatch.setattr(native, "build_command",
                        lambda out: ["g++", "-x", "c++", "/nonexistent.cpp", "-o", out])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.GGUFReader(tmp_path / "m.gguf")


def test_backends_from_gguf_serve_jax_tokens(tmp_path):
    """`EngineBackend.from_gguf` and the supervised
    `SchedulerBackend.from_gguf` over a JAX-written q8_0 blob give the
    greedy tokens of JAX's engine on JAX's load of the same blob."""
    jcfg, jp, _, _ = both_trees(15)
    jax_write_gguf(jcfg, jp, tmp_path / "m.gguf", quant="q8_0")
    jc, ja = jax_load_gguf(tmp_path / "m.gguf", dtype=jnp.float32)
    tok = ByteTokenizer()
    ids = tok.encode("SELECT")
    want = JaxEngine(jc, ja, stop_ids=(-1,)).generate([ids], max_new_tokens=6)[0]
    eng = EngineBackend.from_gguf(str(tmp_path / "m.gguf"), tok, dtype=torch.float32,
                                  device="cpu", stop_ids=(-1,))
    assert eng.engine.generate([ids], max_new_tokens=6)[0] == want
    sb = SchedulerBackend.from_gguf(
        str(tmp_path / "m.gguf"), tok, dtype=torch.float32, device="cpu",
        stop_ids=(-1,), num_slots=2, prompt_bucket=16, decode_chunk=4,
        supervise=True, stall_min_s=0.0)
    try:
        assert sb.scheduler.submit(ids, max_new_tokens=6).result(timeout=60) == want
    finally:
        sb.shutdown()


@pytest.mark.parametrize("backend", ["scheduler", "engine"])
def test_backends_from_gguf_serve_int8(tmp_path, backend):
    """`quantize_int8=True, quantize_unembed8=True` through the GGUF
    constructors over a JAX-written q4_0 blob (the reference's format):
    the dequantized tree requantized to int8, q8 trees in place, JAX's
    greedy tokens on JAX's int8 tree of JAX's load of the blob."""
    jcfg, jp, _, _ = both_trees(16)
    jax_write_gguf(jcfg, jp, tmp_path / "m.gguf", quant="q4_0")
    jc, ja = jax_load_gguf(tmp_path / "m.gguf", dtype=jnp.float32)
    ids = ByteTokenizer().encode("SELECT")
    want = int8_tokens_of_jax(ja, jc, ids)
    cls = SchedulerBackend if backend == "scheduler" else EngineBackend
    assert_serves_int8(cls, lambda c, **kw: c.from_gguf(
        str(tmp_path / "m.gguf"), ByteTokenizer(), **kw), ids, want)

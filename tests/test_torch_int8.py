"""The port's int8 weights, int8 embed/unembed tables and fused matmul trees
vs the JAX package's, on the CPU in f32 (TINY).

- the quantizers (`quantize_weight`, `quantize_params`, `quantize_unembed`,
  tied and untied) bit for bit, and `init_params_quantized` (bits 8 and 4):
  structure, shapes and dtypes equal to JAX's, scales bit-equal;
- the matmuls: `mm` on a q8 tree and `mm_stacked` on a tensor, a q8 and a
  q4 tree within 1e-5 of max |JAX| (only the order of the f32 sums
  differs); `fuse_blocks` of a bridged tree equals the bridged JAX
  `fuse_blocks` bit for bit (MHA and GQA; bf16, q8 and q4 leaves);
- the forward: logits with int8 blocks, int8 embed/unembed tables and fused
  trees within 1e-5 of max |JAX|, and fused equal to unfused exactly (each
  output column is the same dot product);
- greedy tokens identical to JAX's: the engine in the contiguous, paged and
  int8-KV layouts, speculative (D = 4) included, and both scheduler layouts,
  with q8 weights, q8 tables and `fuse_matmuls=True`;
- `infer_weight_bits` / `verify_cost_ratio` for q8 trees equal to JAX's;
- the int8 kernel's route and split rules at the 7B and 3B shapes (no
  JAX: the plan of a launch on an H100's 132 SMs).
Inputs come from numpy seeds and pass between the packages as numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.engine import InferenceEngine as JaxEngine
from llm_based_apache_spark_optimization_tpu.engine import speculative as jax_spec
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.models import llama as jax_llama
from llm_based_apache_spark_optimization_tpu.ops import quant as jq
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
from llm_based_apache_spark_optimization_tpu_torch.engine import speculative as spec
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.models import llama
from llm_based_apache_spark_optimization_tpu_torch.ops import quant
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
    LAUNCHES,
    int8_matmul,
    int8_matmul_plain,
    int8mm,
)
from llm_based_apache_spark_optimization_tpu_torch.serve import ContinuousBatchingScheduler

PROMPTS = [[1, 5, 9, 5, 9, 3], [1, 7], [1, 3, 4, 8, 10, 2, 6]]
MHA = dataclasses.replace(TINY, name="tiny-mha", num_kv_heads=TINY.num_heads)
JAX_MHA = dataclasses.replace(JAX_TINY, name="tiny-mha", num_kv_heads=JAX_TINY.num_heads)
UNTIED = dataclasses.replace(TINY, name="tiny-untied", tie_embeddings=False)
JAX_UNTIED = dataclasses.replace(JAX_TINY, name="tiny-untied", tie_embeddings=False)
CFGS = {"gqa": (TINY, JAX_TINY), "mha": (MHA, JAX_MHA), "untied": (UNTIED, JAX_UNTIED)}


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def bridge(tree):
    return params_from_jax(to_np(tree), device="cpu")


def leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, sorted by path."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def assert_bit_equal(got, want):
    """Port tree == numpy/JAX tree: same paths, dtypes and bits."""
    g, w = leaves(got), leaves(to_np(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[-1] == b.dtype.name, path
        if b.dtype.name == "bfloat16":
            a, b = a.view(torch.int16).numpy(), b.view(np.int16)
        else:
            a = a.numpy()
        assert np.array_equal(a, b), path


def rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def trees():
    """Seed-0 f32 JAX trees per config, and each bridged to the port."""
    out = {}
    for name, (_, jcfg) in CFGS.items():
        jp = jax_init(jcfg, jax.random.key(0), dtype=jnp.float32)
        out[name] = (jp, bridge(jp))
    return out


@pytest.fixture(scope="module")
def q8(trees):
    """TINY with int8 blocks and int8 embed/unembed tables, quantized by
    JAX and bridged (the port's quantizers give the same bits: below)."""
    jp = jq.quantize_unembed(jq.quantize_params(trees["gqa"][0]))
    return jp, bridge(jp)


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("shape", [(64, 32), (3, 48, 16), (2, 2, 32, 48)])
def test_quantize_weight_matches_jax(shape):
    """Per-out-channel absmax int8, bit for bit (a zero column takes scale
    1); dequantize_weight equal too."""
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    w[..., 3] = 0.0
    want = jq.quantize_weight(jnp.asarray(w))
    got = quant.quantize_weight(torch.from_numpy(w))
    assert_bit_equal(got, want)
    assert got["q8"].dtype == torch.int8 and int(got["q8"].abs().max()) == 127
    assert np.array_equal(quant.dequantize_weight(got).numpy(),
                          np.asarray(jq.dequantize_weight(want)))


@pytest.mark.parametrize("cfg", ["gqa", "untied"])
def test_quantize_params_and_unembed_match_jax(trees, cfg):
    """quantize_params (layer by layer in the port) and quantize_unembed,
    bit for bit; a tied tree keeps one int8 table, an untied one two; a
    quantized table stays as it is."""
    jp, tp = trees[cfg]
    want = jq.quantize_unembed(jq.quantize_params(jp))
    got = quant.quantize_unembed(quant.quantize_params(tp))
    assert_bit_equal(got, want)
    assert quant.is_qtensor(got["embed"]) and got["embed"]["s"].shape == (TINY.vocab_size,)
    assert ("lm_head" in got) == (cfg == "untied")
    assert quant.quantize_unembed(got)["embed"] is got["embed"]
    only_unembed = quant.quantize_unembed(tp)
    assert not quant.is_qtensor(only_unembed["blocks"]["wq"])


@pytest.mark.parametrize("bits", [8, 4])
def test_init_params_quantized_matches_jax_structure(bits):
    """The tree made at final size: JAX's structure, shapes and dtypes,
    scales bit-equal (the same Python floats), codes over the whole range;
    the engine serves it."""
    want = jq.init_params_quantized(JAX_TINY, jax.random.key(1), dtype=jnp.float32,
                                    bits=bits)
    got = quant.init_params_quantized(TINY, torch.Generator().manual_seed(1),
                                      dtype=torch.float32, bits=bits, device="cpu")
    g, w = leaves(got), leaves(to_np(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[-1] == b.dtype.name, path
        if path.endswith("/s") or path.endswith("/s4"):
            assert np.array_equal(a.numpy(), b), path
    code = "q8" if bits == 8 else "q4"
    codes = got["blocks"]["wd"][code]
    if bits == 8:
        assert int(codes.min()) == -127 and int(codes.max()) == 127
    else:
        assert int(codes.min()) == 0 and int(codes.max()) == 255
    out = InferenceEngine(TINY, got, stop_ids=(-1,), prompt_bucket=8,
                          device="cpu").generate(PROMPTS[:2], max_new_tokens=6)
    assert all(len(o) == 6 for o in out)


# -------------------------------------------------------------- matmuls

def test_mm_q8_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 48)).astype(np.float32)
    w = rng.normal(size=(48, 32)).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w))
    want = jq.mm(jnp.asarray(x), jw)
    got = quant.mm(torch.from_numpy(x), bridge(jw))
    assert got.shape == (2, 3, 32) and rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("kind", ["tensor", "q8", "q4"])
def test_mm_stacked_matches_jax(kind):
    """x [..., D] @ a stacked [D, C, O] weight -> [..., C, O], each C slice
    equal to the unfused matmul of that projection."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    ws = [rng.normal(size=(64, 48)).astype(np.float32) for _ in range(3)]
    q = {"tensor": lambda w: jnp.asarray(w), "q8": jq.quantize_weight,
         "q4": lambda w: jq.quantize_weight_int4(jnp.asarray(w), 32)}[kind]
    parts = [q(jnp.asarray(w)) for w in ws]
    stacked = jax.tree.map(lambda *a: jnp.stack(a, axis=-2), *parts)
    want = jq.mm_stacked(jnp.asarray(x), stacked)
    got = quant.mm_stacked(torch.from_numpy(x), bridge(stacked))
    assert got.shape == (2, 5, 3, 48) and rel_err(got, want) <= 1e-5
    tx = torch.from_numpy(x)
    for c, part in enumerate(parts):
        assert torch.equal(got[..., c, :], quant.mm(tx, bridge(part))), c


def test_int8_matmul_plain_contract():
    """out = (x @ q8) * s in f32, then x's dtype ("io"); the [V, D] table
    ("vd") gives f32 logits; the wrapper runs the plain version on the CPU
    and counts no launch."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32))
    w = quant.quantize_weight(torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32)))
    before = dict(LAUNCHES)
    io = int8_matmul(x.bfloat16(), w["q8"], w["s"])
    assert io.dtype == torch.bfloat16
    assert torch.equal(io, (((x.bfloat16().float() @ w["q8"].float()) * w["s"])
                            .to(torch.bfloat16)))
    table = quant.quantize_unembed({"embed": torch.from_numpy(
        rng.normal(size=(40, 32)).astype(np.float32))})["embed"]
    vd = int8_matmul(x.bfloat16(), table["q8"], table["s"], "vd")
    assert vd.dtype == torch.float32 and vd.shape == (3, 40)
    assert torch.equal(vd, (x.bfloat16().float() @ table["q8"].float().t()) * table["s"])
    assert torch.equal(vd, int8_matmul_plain(x.bfloat16(), table["q8"], table["s"], "vd"))
    assert LAUNCHES == before


# The 7B and 3B weight shapes the int8 paths give the kernel (layout, IN,
# OUT), as chip_smoke.py's phase 14 (a) holds them on the card.
KERNEL_SHAPES = [("io", 4096, 4096), ("io", 4096, 11008), ("io", 11008, 4096),
                 ("io", 4096, 3 * 4096), ("io", 4096, 2 * 11008), ("vd", 4096, 32000),
                 ("io", 3072, 3072), ("io", 3072, 1024), ("io", 3072, 8192),
                 ("io", 8192, 3072), ("io", 3072, 2 * 1024), ("io", 3072, 2 * 8192),
                 ("vd", 3072, 128256)]


@pytest.mark.parametrize("layout,n_in,n_out", KERNEL_SHAPES)
def test_int8_route_and_split_rules(layout, n_in, n_out):
    """The wrapper's two rules at the served shapes, on an H100's 132 SMs
    passed in: the bf16 routes' row ranges meet with no gap; every plan's
    splits (at most 8) cover IN exactly in pieces that are multiples of
    the route's k step; the decode grid reaches 2 blocks an SM; the wgmma
    tile N is the smallest that holds R (256 above)."""
    sms = 132
    lo, hi = int8mm.ROUTE_ROWS["decode"]
    nxt, top = int8mm.ROUTE_ROWS["wgmma"]
    assert lo == 1 and nxt == hi + 1 and top is None
    for rows in (1, 3, 8, 9, 72, 384, 1024):
        route = int8mm.int8_route(rows, torch.bfloat16)
        assert route == ("decode" if rows <= hi else "wgmma")
        assert int8mm.int8_route(rows, torch.float32) == "gemv"
        for r in (route, "gemv"):
            tile, splits, per = int8mm.split_plan(r, rows, n_in, n_out, layout, sms)
            assert 1 <= splits <= 8 and per % int8mm.K_STEP[r] == 0, (r, rows, splits, per)
            assert (splits - 1) * per < n_in <= splits * per, (r, rows, splits, per)
            assert splits == 1 or layout == "io" or r == "wgmma"
        tile, splits, per = int8mm.split_plan(route, rows, n_in, n_out, layout, sms)
        if route == "decode":
            assert tile in (int8mm.DECODE_COLS if layout == "io" else (64,))
            assert -(-n_out // tile) * splits >= 2 * sms, (rows, tile, splits)
        else:
            assert tile == min(t for t in int8mm.WGMMA_ROWS if t >= min(rows, 256))


@pytest.mark.parametrize("kind", ["bf16", "q8", "q4"])
@pytest.mark.parametrize("cfg", ["mha", "gqa"])
def test_fuse_blocks_matches_jax(trees, kind, cfg):
    """The bridged JAX fused tree equals the port's fuse_blocks of the
    bridged unfused tree bit for bit: wqkv [L, D, 3, O] for MHA, wkv beside
    wq for GQA, wgu always; params_from_jax carries the int8 and uint8
    leaves of q8 and stacked 3-D q4 trees as they are."""
    jp = trees[cfg][0]
    q = {"bf16": lambda p: jax.tree.map(lambda a: a.astype(jnp.bfloat16), p),
         "q8": jq.quantize_params,
         "q4": lambda p: jq.quantize_params_int4(p, group=32)}[kind]
    base = q(jp)
    want = jax_llama.fuse_blocks(base)
    got = llama.fuse_blocks(bridge(base))
    assert_bit_equal(got, want)
    blocks = got["blocks"]
    assert ("wqkv" in blocks) == (cfg == "mha") and ("wkv" in blocks) == (cfg == "gqa")
    assert "wgu" in blocks and not {"wk", "wv", "wg", "wu"} & set(blocks)
    fused = blocks["wqkv" if cfg == "mha" else "wkv"]
    leaf = fused if kind == "bf16" else fused["q8" if kind == "q8" else "q4"]
    assert leaf.shape[-2] == (3 if cfg == "mha" else 2)
    assert_bit_equal(bridge(want), want)


# -------------------------------------------------------------- forward

def _forward_pair(cfg_name, jtree, ttree, fuse):
    cfg, jcfg = CFGS[cfg_name]
    if fuse:
        jtree, ttree = jax_llama.fuse_blocks(jtree), llama.fuse_blocks(ttree)
    tokens = np.array([[1, 5, 9, 5, 9, 3, 2], [1, 7, 7, 40, 2, 3, 4]], np.int32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    want, _ = jax_llama.forward(jcfg, jtree, jnp.asarray(tokens), jnp.asarray(pos), None)
    got, _ = llama.forward(cfg, ttree, torch.from_numpy(tokens), torch.from_numpy(pos))
    return got, want


@pytest.mark.parametrize("variant", [
    ("gqa", "blocks", False), ("gqa", "blocks+tables", False),
    ("untied", "blocks+tables", False), ("gqa", "blocks+tables", True),
    ("mha", "blocks+tables", True), ("gqa", "q4+tables", True),
], ids=lambda v: "-".join(str(x) for x in v))
def test_forward_logits_match_jax(trees, variant):
    """Logits (f32) with int8 blocks, int8 embed/unembed tables and fused
    trees within 1e-5 of max |JAX|; the port's fused logits equal its
    unfused ones exactly."""
    cfg_name, what, fuse = variant
    jp = trees[cfg_name][0]
    jtree = (jq.quantize_params_int4(jp, group=32) if what.startswith("q4")
             else jq.quantize_params(jp))
    if what.endswith("tables"):
        jtree = jq.quantize_unembed(jtree)
    ttree = bridge(jtree)
    got, want = _forward_pair(cfg_name, jtree, ttree, fuse)
    assert got.dtype == torch.float32 and rel_err(got, want) <= 1e-5
    if fuse:
        unfused, _ = _forward_pair(cfg_name, jtree, ttree, False)
        assert torch.equal(got, unfused)


def test_embedding_dequantizes_only_the_rows(q8):
    """The q8 embedding gather: rows q8 x s in f32, cast to final_norm's
    dtype, JAX's values bit for bit."""
    jp, tp = q8
    tokens = np.array([[3, 1, 300, 3]], np.int32)
    table = jp["embed"]
    want = (jnp.take(table["q8"], tokens, axis=0).astype(jnp.float32)
            * jnp.take(table["s"], tokens, axis=0)[..., None]).astype(jnp.float32)
    got = llama._embed(tp, torch.from_numpy(tokens))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- serving

@pytest.mark.parametrize("kw", [
    dict(), dict(kv_layout="paged", kv_page_size=8), dict(kv_quant="int8"),
    dict(kv_layout="paged", kv_page_size=8, kv_quant="int8", speculative_draft=4),
], ids=["contiguous", "paged", "int8_kv", "paged_int8_kv_speculative"])
def test_engine_greedy_matches_jax(q8, kw):
    """q8 blocks, q8 tables, fuse_matmuls=True: the port's greedy tokens
    equal JAX's, and the port's unfused engine's."""
    jp, tp = q8
    kw = dict(stop_ids=(-1,), prompt_bucket=8, **kw)
    want = JaxEngine(JAX_TINY, jp, fuse_matmuls=True, **kw).generate(
        PROMPTS, max_new_tokens=10)
    fused = InferenceEngine(TINY, tp, fuse_matmuls=True, device="cpu", **kw)
    assert "wkv" in fused.params["blocks"] and "wk" not in fused.params["blocks"]
    assert fused.generate(PROMPTS, max_new_tokens=10) == want
    unfused = InferenceEngine(TINY, tp, device="cpu", **kw)
    assert unfused.generate(PROMPTS, max_new_tokens=10) == want


@pytest.mark.parametrize("kv_layout", ["contiguous", "paged"])
def test_scheduler_greedy_matches_jax(q8, kv_layout):
    """Both scheduler layouts with q8 weights and tables and
    fuse_matmuls=True, a multi-chunk prompt among the requests: the JAX
    scheduler's tokens, and the unfused port scheduler's."""
    jp, tp = q8
    prompts = PROMPTS + [[1] + list(range(5, 25))]
    kw = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,),
              kv_layout=kv_layout)
    if kv_layout == "paged":
        kw["kv_page_size"] = 8
    outs = []
    for sched in (JaxScheduler(JAX_TINY, jp, fuse_matmuls=True, **kw),
                  ContinuousBatchingScheduler(TINY, tp, fuse_matmuls=True, device="cpu",
                                              **kw),
                  ContinuousBatchingScheduler(TINY, tp, device="cpu", **kw)):
        with sched:
            outs.append([f.result(timeout=300) for f in
                         [sched.submit(p, max_new_tokens=8) for p in prompts]])
    assert outs[1] == outs[0] and outs[2] == outs[0]


@pytest.mark.parametrize("kind", ["q8", "q4"])
def test_scheduler_fused_matches_unfused_with_speculation(trees, kind):
    """fuse_matmuls under the scheduler is the unfused scheduler's output
    exactly, with speculation off and on (D = 4), int8 and int4 weights."""
    tp = trees["mha"][1]
    tree = (quant.quantize_params(tp) if kind == "q8"
            else quant.quantize_params_int4(tp, group=32))
    kw = dict(num_slots=2, prompt_bucket=8, stop_ids=(-1,), device="cpu")
    prompts = [[1, 5, 9, 5, 9, 3], [1, 7, 2, 4]]

    def run(**extra):
        with ContinuousBatchingScheduler(MHA, tree, **kw, **extra) as s:
            return [f.result(timeout=300) for f in
                    [s.submit(p, max_new_tokens=8) for p in prompts]]

    golden = run()
    for d in (0, 4):
        assert run(fuse_matmuls=True, speculative_draft=d) == golden, d


def test_quantized_tables_track_dequantized(trees):
    """The engine on int8 tables (tied and untied) against the engine on
    the same values dequantized: the kernel contract moves only the order
    of f32 sums, so at least 90% of greedy tokens agree (JAX's rule)."""
    for name in ("gqa", "untied"):
        tp = trees[name][1]
        cfg = CFGS[name][0]
        q = quant.quantize_unembed(tp)
        deq = dict(q)
        for key in ("embed", "lm_head"):
            if key in q:
                deq[key] = q[key]["q8"].float() * q[key]["s"][:, None]
        outs = [InferenceEngine(cfg, tree, stop_ids=(-1,), prompt_bucket=8,
                                device="cpu").generate(PROMPTS[:2], max_new_tokens=8)
                for tree in (deq, q)]
        agree = sum(a == b for go, oo in zip(*outs) for a, b in zip(go, oo))
        assert agree / 16 >= 0.9, (name, agree)


def test_weight_bits_and_verify_cost_match_jax(q8, trees):
    """infer_weight_bits is 8 for a q8 tree, fused or not, as JAX's, so the
    speculative verify cost prices int8 as JAX does."""
    jp, tp = q8
    assert spec.infer_weight_bits(tp) == jax_spec.infer_weight_bits(jp) == 8
    assert spec.infer_weight_bits(llama.fuse_blocks(tp)) == jax_spec.infer_weight_bits(
        jax_llama.fuse_blocks(jp)) == 8
    for d in (1, 4, 8):
        assert spec.verify_cost_ratio(d, TINY, spec.infer_weight_bits(tp)) == pytest.approx(
            spec.verify_cost_ratio(d, TINY, 8))
    assert spec.infer_weight_bits(trees["gqa"][1]) == 32

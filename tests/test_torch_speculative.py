"""The port's prompt-lookup speculative decoding against the JAX package's, on
the CPU at TINY f32 with the same bridged weights (`convert.params_from_jax`).

Tolerances:
- `ngram_draft`, `emit_chain`, `fsm`-threaded greedy windows, and
  `verify_commit` against a row-by-row reading of its contract: exact. Greedy
  speculative tokens equal JAX's speculative engine and scheduler and the
  port's own vanilla engine, token for token, in every layout (contiguous,
  paged, paged int8; the scheduler's contiguous int8 cache and ragged mixed
  rounds), under the generic and a schema grammar, at stop ids and budget
  edges, and after a preemption resume (recompute and spill).
- `speculation_stats`: verify rounds and tokens equal JAX's exactly on the
  same greedy traffic.
- `verify_cost_ratio`: under JAX's anchors (monkeypatched in) equal to
  JAX's to 1e-12 relative, at several draft lengths, shapes and widths.
- `rejection_sample_chain` against the exact target distribution: chi-square
  below the 99.99th percentile of its degrees of freedom over N = 4000
  draws (8000 for the three-position chain, so its all-accepted bin holds
  more than 200), the level of tests/test_speculative.py; acceptance rates
  within 4 binomial sigma.
- Sampled speculative output against the port's vanilla sampler: the
  per-position total-variation distance at most the vanilla-vs-vanilla null
  distance + 0.05 (tests/test_speculative.py's convention).
- Seeded sampled replays within the port: exact (two batch mixes, a dirty
  reused slot, and across spill and recompute preemptions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from collections import Counter

from llm_based_apache_spark_optimization_tpu.constrain.masks import (
    CompiledMask as JaxCompiledMask,
)
from llm_based_apache_spark_optimization_tpu.engine import InferenceEngine as JaxEngine
from llm_based_apache_spark_optimization_tpu.engine import speculative as jax_spec
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.ops.quant import (
    quantize_params_int4 as jax_q4,
)
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from llm_based_apache_spark_optimization_tpu_torch.constrain import get_constraint
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
from llm_based_apache_spark_optimization_tpu_torch.engine import speculative as spec
from llm_based_apache_spark_optimization_tpu_torch.models import BENCH_1B, TINY
from llm_based_apache_spark_optimization_tpu_torch.models import DUCKDB_NSQL_7B
from llm_based_apache_spark_optimization_tpu_torch.ops.common import NEG_INF
from llm_based_apache_spark_optimization_tpu_torch.ops.quant import quantize_params_int4
from llm_based_apache_spark_optimization_tpu_torch.ops.sampling import (
    SamplingParams,
    filtered_runtime_logits,
    stream_uniform,
    verify_draws,
)
from llm_based_apache_spark_optimization_tpu_torch.serve import ContinuousBatchingScheduler
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer
from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

EOS = 2
CFG = dataclasses.replace(TINY, max_seq_len=256)
JAX_CFG = dataclasses.replace(JAX_TINY, max_seq_len=256)
PROMPTS = [
    [1, 5, 9, 5, 9, 5, 9],          # repetitive: drafts hit
    [1, 7],                          # short
    [1, 3, 4, 8, 10, 2, 6, 11, 12],  # mixed
]
# Multi-chunk prompts (buckets of 8) for the scheduler.
LONG = [[1] + [5, 9, 4] * 6, [1, 3, 4, 8, 10, 2, 6, 11, 12, 3, 4, 8, 10, 7]]
SAMPLED = SamplingParams(temperature=0.8, top_p=0.9)


@pytest.fixture(scope="module")
def weights():
    jp = jax_init(JAX_CFG, jax.random.key(7), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def grammars():
    """{name: (JAX CompiledMask, port CompiledMask)} over the byte
    tokenizer: the generic grammar and a two-column schema. Compiled once,
    in the port; JAX's mask is built from the same host tables (equal to
    its own compile's: tests/test_torch_constrain.py)."""
    tok = ByteTokenizer()
    out = {}
    for name, c_spec in (("generic", "spark_sql"),
                         ("schema", {"table": "trips",
                                     "columns": ["payment_type", "tip_amount"]})):
        tc = get_constraint(c_spec, tok, (EOS,))
        jc = JaxCompiledMask(**{f.name: getattr(tc, f.name)
                                for f in dataclasses.fields(JaxCompiledMask)})
        out[name] = (jc, tc)
    return out


def engines(weights, **kw):
    """(JAX engine, port engine) over the bridged weights."""
    jp, tp = weights
    return (JaxEngine(JAX_CFG, jp, prompt_bucket=8, **kw),
            InferenceEngine(CFG, tp, prompt_bucket=8, device="cpu", **kw))


# ------------------------------------------------------------ primitives

@pytest.mark.parametrize("draft_len,ngram", [(4, 2), (8, 3), (2, 1)])
def test_ngram_draft_matches_jax(draft_len, ngram):
    """Random histories over a small alphabet (so n-grams recur), every
    valid length from 1 to the row: the port's drafts equal JAX's, the
    stale-tail guard included (junk past hist_len never leaks: changing it
    changes no draft)."""
    rng = np.random.default_rng(draft_len * 10 + ngram)
    b, ht = 64, 40
    hist = rng.integers(0, 5, (b, ht)).astype(np.int32)
    hlen = rng.integers(1, ht + 1, b).astype(np.int32)
    hlen[:4] = [1, ngram, ht, ht - 1]
    want = np.asarray(jax_spec.ngram_draft(jnp.asarray(hist), jnp.asarray(hlen),
                                           draft_len, ngram))
    got = spec.ngram_draft(torch.from_numpy(hist), torch.from_numpy(hlen), draft_len,
                           ngram)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    junk = hist.copy()
    for i in range(b):
        junk[i, hlen[i]:] = rng.integers(5, 300, ht - hlen[i])
    again = spec.ngram_draft(torch.from_numpy(junk), torch.from_numpy(hlen),
                             draft_len, ngram)
    assert np.array_equal(again.numpy(), want)


def test_ngram_draft_examples():
    """JAX's worked examples: the copy after the earlier match, the latest
    full match over an earlier one."""
    h = torch.tensor([[1, 7, 8, 5, 6, 2, 9, 7, 8, 0, 0, 0]])
    assert spec.ngram_draft(h, torch.tensor([9]), 3, 2).tolist() == [[5, 6, 2]]
    h = torch.tensor([[3, 4, 5, 1, 3, 4, 9, 2, 3, 4, 0, 0]])
    assert spec.ngram_draft(h, torch.tensor([10]), 2, 2).tolist() == [[9, 2]]


def test_emit_chain_matches_jax():
    rng = np.random.default_rng(3)
    b, d = 32, 6
    drafts = rng.integers(0, 320, (b, d)).astype(np.int32)
    acc = rng.integers(0, d + 1, b).astype(np.int32)
    extra = rng.integers(0, 320, b).astype(np.int32)
    want = np.asarray(jax_spec.emit_chain(jnp.asarray(drafts), jnp.asarray(acc),
                                          jnp.asarray(extra), 0))
    got = spec.emit_chain(torch.from_numpy(drafts), torch.from_numpy(acc),
                          torch.from_numpy(extra), 0)
    assert np.array_equal(got.numpy(), want)


def test_verify_cost_model_matches_jax_form(monkeypatch, weights):
    """Under JAX's anchors the port's line equals JAX's at every draft
    length, shape and weight width (relative 1e-12); the parameter count
    and the weight bits of f32, bf16 and int4 trees equal JAX's. The port's
    own D = 8 anchor is the card's measurement, not JAX's."""
    from llm_based_apache_spark_optimization_tpu.models import (
        BENCH_1B as JB,
        DUCKDB_NSQL_7B as J7,
    )

    assert spec.VERIFY_COST_ANCHORS[0] == (0, 1.0)
    assert spec.VERIFY_COST_ANCHORS[1] != jax_spec.VERIFY_COST_ANCHORS[1]
    assert np.isfinite(spec.VERIFY_COST_ANCHORS[1][1])
    assert "H100" in spec.VERIFY_COST_CALIBRATION
    monkeypatch.setattr(spec, "VERIFY_COST_ANCHORS", jax_spec.VERIFY_COST_ANCHORS)
    for tcfg, jcfg in ((BENCH_1B, JB), (DUCKDB_NSQL_7B, J7), (CFG, JAX_CFG)):
        assert spec._param_count(tcfg) == jax_spec._param_count(jcfg)
        for d in (1, 4, 8, 16):
            for bits in (16, 8, 4):
                want = jax_spec.verify_cost_ratio(d, jcfg, bits)
                got = spec.verify_cost_ratio(d, tcfg, bits)
                assert got == pytest.approx(want, rel=1e-12), (tcfg.name, d, bits)
    assert spec.verify_cost_ratio(8) == pytest.approx(jax_spec.verify_cost_ratio(8))
    jp, tp = weights
    assert spec.infer_weight_bits(tp) == jax_spec.infer_weight_bits(jp) == 32
    bf = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else
              {n: w.to(torch.bfloat16) for n, w in v.items()}) for k, v in tp.items()}
    assert spec.infer_weight_bits(bf) == jax_spec.infer_weight_bits(
        jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)) == 16
    assert spec.infer_weight_bits(quantize_params_int4(tp, group=32)) == \
        jax_spec.infer_weight_bits(jax_q4(jp, group=32)) == 4


def _core(filt, drafts, n, seed):
    """n independent (acc, extra) draws of the rejection core for one
    (filt, drafts) pair, the draws from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    f = filt.expand(n, *filt.shape[1:])
    u = torch.rand((n, drafts.shape[1]), generator=g)
    noise = torch.rand((n, filt.shape[-1]), generator=g)
    acc, extra = spec.rejection_sample_chain(f, drafts.expand(n, -1), u, noise)
    return acc.numpy(), extra.numpy()


def test_rejection_core_matches_exact_distribution():
    """One draft position: the round's first emitted token is distributed
    as softmax(filt[:, 0]) whatever the draft's mass (chi-square, df 7,
    99.99th percentile 29.9), and the acceptance rate is p(draft)."""
    v, n = 8, 4000
    filt = torch.randn((1, 2, v), generator=torch.Generator().manual_seed(0)) * 1.5
    p = torch.softmax(filt[0, 0], -1).numpy()
    for d_tok in (int(p.argmax()), int(p.argmin())):
        accs, extras = _core(filt, torch.full((1, 1), d_tok), n, seed=1)
        emitted = np.where(accs > 0, d_tok, extras)
        counts = np.bincount(emitted, minlength=v)
        chi2 = np.sum((counts - n * p) ** 2 / (n * p))
        assert chi2 < 29.9, (d_tok, chi2, counts.tolist())
        tol = 4 * np.sqrt(p[d_tok] * (1 - p[d_tok]) / n)
        assert abs(accs.mean() - p[d_tok]) < max(tol, 1e-3)


def test_rejection_core_chain_acceptance_and_bonus():
    """Three positions: P(accepted >= j) is the product of the drafts'
    masses (4 sigma), and an all-accepted round's bonus token follows the
    last position's target (chi-square, df 5, 25.7)."""
    v, d, n = 6, 3, 8000
    filt = torch.randn((1, d + 1, v), generator=torch.Generator().manual_seed(2))
    p = torch.softmax(filt[0], -1).numpy()
    drafts_np = np.asarray([p[j].argmax() for j in range(d)])
    accs, extras = _core(filt, torch.from_numpy(drafts_np)[None], n, seed=3)
    expect = 1.0
    for j in range(1, d + 1):
        expect *= p[j - 1, drafts_np[j - 1]]
        got = (accs >= j).mean()
        assert abs(got - expect) < 4 * np.sqrt(expect * (1 - expect) / n) + 1e-3
    full = accs == d
    assert full.sum() > 200
    counts = np.bincount(extras[full], minlength=v)
    chi2 = np.sum((counts - full.sum() * p[d]) ** 2 / (full.sum() * p[d]))
    assert chi2 < 25.7, chi2


def test_rejection_core_all_reject_residual_and_dead_rows():
    """A zero-mass draft always rejects and the residual is the target
    (chi-square, df 6, 27.9); a fully masked position (past the budget
    horizon) rejects with certainty."""
    v, n, d_tok = 8, 4000, 3
    filt = torch.randn((1, 2, v), generator=torch.Generator().manual_seed(4))
    filt[:, :, d_tok] = NEG_INF
    p = torch.softmax(filt[0, 0], -1).numpy()
    accs, extras = _core(filt, torch.full((1, 1), d_tok), n, seed=5)
    assert (accs == 0).all() and (extras != d_tok).all()
    live = [t for t in range(v) if t != d_tok]
    counts = np.bincount(extras, minlength=v)[live]
    chi2 = np.sum((counts - n * p[live]) ** 2 / (n * p[live]))
    assert chi2 < 27.9, chi2
    dead = torch.full((1, 2, v), NEG_INF)
    accs, _ = _core(dead, torch.full((1, 1), 0), 500, seed=6)
    assert (accs == 0).all()


def test_verify_draws_one_stream_index_a_round():
    """A round's draws are a function of (seed, index) alone: the same
    pair replays, the next index differs; the D accept uniforms sit in
    columns of the stream no categorical draw reads (the noise is the
    vanilla draw of that index)."""
    seeds = torch.tensor([7, 7, 8], dtype=torch.int64)
    counts = torch.tensor([3, 4, 3], dtype=torch.int64)
    u, noise = verify_draws(seeds, counts, 4, 320)
    u2, noise2 = verify_draws(seeds, counts, 4, 320)
    assert torch.equal(u, u2) and torch.equal(noise, noise2)
    assert u.shape == (3, 4) and noise.shape == (3, 320)
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert torch.equal(noise, stream_uniform(seeds, counts, 320))
    assert torch.equal(u, stream_uniform(seeds, counts, 324)[:, 320:])
    assert ((u > 0) & (u < 1)).all() and ((noise > 0) & (noise < 1)).all()



@pytest.mark.parametrize("case", ["greedy", "stops", "sampled"])
def test_verify_commit_matches_a_row_by_row_reading(case):
    """`verify_commit`, which the engine's loop and the scheduler's round
    share, against a row-at-a-time reading of its contract: positions past
    the budget masked, the argmax chain's accepted drafts capped at the
    budget, rejection sampling for rows of temperature > 0 (greedy rows
    beside them keep the chain), at most `limit` tokens kept and nothing
    after the first stop id, the current token the last kept one. Exact."""
    rng = np.random.default_rng(7)
    b, d, v, pad = 6, 4, 12, 0
    logits = torch.tensor(rng.normal(size=(b, d + 1, v)), dtype=torch.float32)
    drafts = logits.argmax(-1)[:, :d].to(torch.int32)
    # One draft a row off the chain, at a random position.
    drafts[torch.arange(b), torch.tensor(rng.integers(0, d, b))] = torch.tensor(
        rng.integers(0, v, b), dtype=torch.int32)
    cur = torch.tensor(rng.integers(1, v, b), dtype=torch.int32)
    rem = torch.tensor([9, 3, 1, 5, 2, 9])
    limit = torch.tensor([d + 1, d + 1, d + 1, 2, 0, d + 1])
    stop_ids = (int(drafts[0, 0]), int(drafts[5, 1])) if case == "stops" else ()
    knobs = draws = None
    if case == "sampled":
        knobs = (torch.tensor([0.8, 0.0, 0.8, 1.0, 0.8, 0.0]), torch.full((b,), 0.9),
                 torch.zeros(b, dtype=torch.int64))
        draws = verify_draws(torch.arange(b), torch.zeros(b, dtype=torch.int64), d, v)
    emitted, n_emit, cur2, cstates = spec.verify_commit(
        logits, drafts, cur, rem, limit, pad, stop_ids=stop_ids, knobs=knobs, draws=draws)
    assert cstates is None
    for r in range(b):
        live = (int(rem[r]) - torch.arange(d + 1) >= 1)[:, None]
        masked = torch.where(live, logits[r], NEG_INF)
        chain = masked.argmax(-1).to(torch.int32)
        acc = 0
        while acc < min(int(rem[r]), d) and int(drafts[r, acc]) == int(chain[acc]):
            acc += 1
        if knobs is not None and float(knobs[0][r]) > 0.0:
            filt = filtered_runtime_logits(masked[None], *(k[r:r + 1, None] for k in knobs))
            a, extra = spec.rejection_sample_chain(filt, drafts[r:r + 1], draws[0][r:r + 1],
                                                   draws[1][r:r + 1])
            chain, acc = spec.emit_chain(drafts[r:r + 1], a, extra, pad)[0], int(a)
        row = chain[:min(acc + 1, int(limit[r]))].tolist()
        cut = next((i for i, t in enumerate(row) if t in stop_ids), None)
        row = row if cut is None else row[:cut + 1]
        assert int(n_emit[r]) == len(row), r
        assert emitted[r].tolist() == row + [pad] * (d + 1 - len(row)), r
        assert int(cur2[r]) == (row[-1] if row else int(cur[r])), r
    if case == "stops":
        assert int(n_emit[0]) == 1


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("layout,kv_quant", [("contiguous", None), ("paged", None),
                                             ("paged", "int8")],
                         ids=["contiguous", "paged", "paged_int8"])
@pytest.mark.parametrize("draft_len,ngram", [(4, 2), (8, 3)])
def test_engine_greedy_matches_jax_and_vanilla(weights, layout, kv_quant, draft_len,
                                               ngram):
    """Three prompts as one batch: the port's speculative tokens equal
    JAX's speculative engine's and the port's vanilla engine's, with the
    same number of verify rounds as JAX."""
    kw = dict(stop_ids=(-1,), kv_layout=layout, kv_quant=kv_quant)
    je, te = engines(weights, speculative_draft=draft_len, speculative_ngram=ngram, **kw)
    vanilla = engines(weights, **kw)[1]
    want = je.generate(PROMPTS, max_new_tokens=12)
    assert te.generate(PROMPTS, max_new_tokens=12) == want
    assert vanilla.generate(PROMPTS, max_new_tokens=12) == want
    assert te.last_spec_rounds == je.last_spec_rounds >= 1
    assert vanilla.last_spec_rounds is None


def test_engine_stop_ids_and_budget_edges(weights):
    """A stop id at vanilla's third token truncates both packages alike;
    budgets 1, 2, 7, 8 and 9 around the draft length give JAX's tokens."""
    probe = engines(weights, stop_ids=(-1,))[1].generate([PROMPTS[2]], 8)[0]
    je, te = engines(weights, stop_ids=(probe[2],), speculative_draft=4)
    assert te.generate(PROMPTS, max_new_tokens=8) == je.generate(PROMPTS, max_new_tokens=8)
    je, te = engines(weights, stop_ids=(-1,), speculative_draft=8)
    for budget in (1, 2, 7, 8, 9):
        assert te.generate(PROMPTS, max_new_tokens=budget) == \
            je.generate(PROMPTS, max_new_tokens=budget), budget


def test_engine_refuses_int8_contiguous_speculation(weights):
    for eng in (lambda **k: InferenceEngine(CFG, weights[1], device="cpu", **k),
                lambda **k: JaxEngine(JAX_CFG, weights[0], **k)):
        with pytest.raises(ValueError, match="cannot combine"):
            eng(kv_quant="int8", speculative_draft=4)
    with pytest.raises(ValueError, match="draft_len"):
        InferenceEngine(CFG, weights[1], device="cpu", speculative_draft=32)


@pytest.mark.parametrize("layout,kv_quant", [("contiguous", None), ("paged", "int8")],
                         ids=["contiguous", "paged_int8"])
@pytest.mark.parametrize("name", ["generic", "schema"])
def test_engine_constrained_matches_jax(weights, grammars, name, layout, kv_quant):
    """Under each grammar, at the grammar's `min_new_tokens` and at 40, the
    port's constrained speculative tokens equal JAX's and the port's
    constrained vanilla engine's, and every completion walks the grammar."""
    jc, tc = grammars[name]
    kw = dict(stop_ids=(EOS,), kv_layout=layout, kv_quant=kv_quant)
    je, te = engines(weights, speculative_draft=4, speculative_ngram=2, **kw)
    vanilla = engines(weights, **kw)[1]
    for budget in (tc.min_new_tokens, 40):
        want = je.generate(PROMPTS[:2], max_new_tokens=budget, constraint=jc)
        assert te.generate(PROMPTS[:2], max_new_tokens=budget, constraint=tc) == want
        assert vanilla.generate(PROMPTS[:2], max_new_tokens=budget, constraint=tc) == want
        for out in want:
            assert len(out) <= budget and tc.walk(out) is not None, out


def test_engine_copying_model_accepts_whole_windows(weights):
    """Zeroed block weights make logits = rms(embed[tok]) @ embed.T, whose
    argmax repeats the input: the premise holds, the speculative stream
    equals vanilla's, and 16 tokens take at most 4 rounds (JAX's
    test_acceptance_on_copying_model)."""
    tp = weights[1]
    zp = dict(tp, blocks={k: (torch.zeros_like(v) if k.startswith("w") else v)
                          for k, v in tp["blocks"].items()})
    vanilla = InferenceEngine(CFG, zp, stop_ids=(-1,), prompt_bucket=8, device="cpu")
    toks = vanilla.generate([[1, 5, 5, 5]], max_new_tokens=16)[0]
    assert len(set(toks)) == 1
    te = InferenceEngine(CFG, zp, stop_ids=(-1,), prompt_bucket=8, device="cpu",
                         speculative_draft=8, speculative_ngram=2)
    assert te.generate([[1, 5, 5, 5]], max_new_tokens=16)[0] == toks
    assert te.last_spec_rounds <= 4


def test_engine_sampled_replays_and_distribution(weights):
    """Sampled speculative requests replay exactly per seed and differ
    across seeds; their per-position marginals match the port's vanilla
    sampler's within the vanilla-vs-vanilla null TV + 0.05 (5 seeds x 64
    rows x 3 tokens an arm)."""
    sp = SamplingParams(temperature=1.0, top_k=4)
    te = engines(weights, stop_ids=(-1,), speculative_draft=4, speculative_ngram=2)[1]
    ref = engines(weights, stop_ids=(-1,))[1]
    a = te.generate(PROMPTS, max_new_tokens=6, sampling=SAMPLED, seed=3)
    assert te.last_spec_rounds >= 1 and all(len(o) == 6 for o in a)
    assert te.generate(PROMPTS, max_new_tokens=6, sampling=SAMPLED, seed=3) == a
    assert te.generate(PROMPTS, max_new_tokens=6, sampling=SAMPLED, seed=4) != a

    def arm(eng, seeds):
        return [o for s in seeds
                for o in eng.generate([PROMPTS[0]] * 64, max_new_tokens=3,
                                      sampling=sp, seed=s)]

    arm_a, arm_b, arm_s = arm(ref, range(5)), arm(ref, range(50, 55)), arm(te, range(100, 105))
    for j in range(3):
        ca, cb, cs = (Counter(o[j] for o in x) for x in (arm_a, arm_b, arm_s))
        n = len(arm_a)

        def tv(c1, c2):
            return 0.5 * sum(abs(c1.get(k, 0) - c2.get(k, 0)) for k in set(c1) | set(c2)) / n

        assert tv(ca, cs) <= tv(ca, cb) + 0.05, j


# ------------------------------------------------------------- scheduler

SCHED_KW = dict(num_slots=2, prompt_bucket=8, stop_ids=(-1,), max_seq=128)


def serve(cls, cfg, params, prompts, max_new, sampling=None, seeds=None,
          pressure=None, **kw):
    """Submit `prompts` at once; returns (outputs, speculation_stats, the
    scheduler's counters)."""
    extra = {} if cls is JaxScheduler else {"device": "cpu"}
    faults = FAULTS if cls is ContinuousBatchingScheduler else None
    if pressure:
        faults.configure(pressure, 0)
    try:
        with cls(cfg, params, **dict(SCHED_KW, **kw), **extra) as s:
            futs = [s.submit(p, max_new_tokens=m, sampling=sampling or SamplingParams(),
                             seed=seeds[i] if seeds else 0)
                    for i, (p, m) in enumerate(zip(prompts, max_new))]
            out = [f.result(timeout=300) for f in futs]
            info = {"mixed_rounds": getattr(s, "mixed_rounds", 0),
                    "page_stats": s.page_stats}
            return out, s.speculation_stats, info
    finally:
        if faults is not None:
            faults.clear()


def both_schedulers(weights, prompts, max_new, **kw):
    jp, tp = weights
    return (serve(JaxScheduler, JAX_CFG, jp, prompts, max_new, **kw),
            serve(ContinuousBatchingScheduler, CFG, tp, prompts, max_new, **kw))


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_quant="int8"),
    dict(kv_layout="paged", kv_page_size=8),
    dict(kv_layout="paged", kv_page_size=8, kv_quant="int8"),
], ids=["contiguous", "contiguous_int8", "paged", "paged_int8"])
def test_scheduler_greedy_and_stats_match_jax(weights, kw):
    """Five requests (multi-chunk prompts among them) over two slots: the
    port's speculative tokens equal JAX's speculative scheduler's, and
    speculation_stats' verify rounds and tokens equal JAX's (tokens
    delivered: what the requests received from verify rounds)."""
    prompts = PROMPTS + LONG
    budgets = [10, 6, 12, 9, 14]
    (want, jst, _), (got, tst, _) = both_schedulers(weights, prompts, budgets,
                                                    speculative_draft=4, **kw)
    assert got == want
    for key in ("verify_rounds", "tokens_emitted", "tokens_per_round"):
        assert tst[key] == jst[key], key
    for split in ("by_class", "by_sampling"):
        for cls, st in jst[split].items():
            for key in ("verify_rounds", "tokens_emitted"):
                assert tst[split][cls][key] == st[key], (split, cls, key)
    assert tst["tokens_delivered"] == sum(max(len(o) - 1, 0) for o in got)
    assert tst["tokens_emitted"] >= tst["tokens_delivered"]


def test_scheduler_ragged_mixed_rounds_match_jax(weights):
    """Ragged mixed rounds with D = 4: staggered budgets let chunks ride
    verify rounds (mixed rounds > 0 in both), whose window is max(8, 5) =
    8 wide; tokens and stats equal JAX's."""
    prompts = [PROMPTS[0], LONG[0], PROMPTS[2], LONG[1]]
    budgets = [6, 10, 14, 8]
    (want, jst, _), (got, tst, tinfo) = both_schedulers(
        weights, prompts, budgets, speculative_draft=4, kv_layout="paged",
        kv_page_size=8, ragged=True)
    assert got == want
    assert tinfo["mixed_rounds"] > 0
    assert (tst["verify_rounds"], tst["tokens_emitted"]) == (
        jst["verify_rounds"], jst["tokens_emitted"])


def test_scheduler_constrained_matches_jax(weights, grammars):
    """A schema request beside two free ones in the contiguous layout: the
    port's tokens equal JAX's speculative scheduler's; the constrained
    completion walks its grammar; the constrained class's stats equal
    JAX's."""
    jp, tp = weights
    jc, tc = grammars["schema"]
    outs = []
    for cls, cfg, params, c in ((JaxScheduler, JAX_CFG, jp, jc),
                                (ContinuousBatchingScheduler, CFG, tp, tc)):
        extra = {} if cls is JaxScheduler else {"device": "cpu"}
        with cls(cfg, params, **dict(SCHED_KW, stop_ids=(EOS,)), speculative_draft=4,
                 **extra) as s:
            futs = [s.submit(PROMPTS[0], max_new_tokens=30, constraint=c),
                    s.submit(PROMPTS[1], max_new_tokens=9),
                    s.submit(LONG[0], max_new_tokens=12)]
            outs.append(([f.result(timeout=300) for f in futs], s.speculation_stats))
    (want, jst), (got, tst) = outs
    assert got == want
    assert tc.walk(got[0] + [EOS]) is not None
    for k in ("constrained", "unconstrained"):
        for m in ("verify_rounds", "tokens_emitted"):
            assert tst["by_class"][k][m] == jst["by_class"][k][m], (k, m)
    assert tst["by_class"]["constrained"]["verify_rounds"] >= 1


STORM = dict(kv_layout="paged", kv_page_size=8, max_seq=64, kv_overcommit=0.25,
             kv_pages=12)


@pytest.mark.parametrize("kv_spill", [False, True], ids=["recompute", "spill"])
def test_scheduler_preemption_resume(weights, kv_spill):
    """A `kv:pressure` storm over an overcommitted pool preempts; greedy
    requests resume to JAX's pressure-free speculative tokens and sampled
    ones to the port's own pressure-free tokens (the history row is
    rewritten at the resume, the stream index restored)."""
    jp, tp = weights
    prompts = [[1, 5, 9], [1, 7], [1, 3, 4, 8, 10], [1, 11, 12, 13]]
    budgets = [24] * 4
    base = dict(kv_layout="paged", kv_page_size=8, max_seq=64, speculative_draft=4)
    want, _, _ = serve(JaxScheduler, JAX_CFG, jp, prompts, budgets, **base)
    got, _, info = serve(ContinuousBatchingScheduler, CFG, tp, prompts, budgets,
                         pressure="kv:pressure:1:3", kv_spill=kv_spill,
                         speculative_draft=4, **STORM)
    assert got == want
    assert info["page_stats"]["preemptions"] >= 1
    seeds = [41, 42, 43, 44]
    ctrl, _, _ = serve(ContinuousBatchingScheduler, CFG, tp, prompts, budgets,
                       sampling=SAMPLED, seeds=seeds, **base)
    got, _, info = serve(ContinuousBatchingScheduler, CFG, tp, prompts, budgets,
                         sampling=SAMPLED, seeds=seeds, pressure="kv:pressure:1:3",
                         kv_spill=kv_spill, speculative_draft=4, **STORM)
    assert got == ctrl
    assert info["page_stats"]["preemptions"] >= 1


def test_scheduler_sampled_reproducible_across_batch_mixes(weights):
    """The same (seed, request) gives the same sampled tokens alone, in a
    mixed greedy/sampled batch of three slots, and again on the slot the
    first run left dirty; greedy slots in the mix keep JAX's tokens; a
    sampled round takes one stream index."""
    jp, tp = weights
    req = PROMPTS[2]
    alone, st, _ = serve(ContinuousBatchingScheduler, CFG, tp, [req, req], [8, 8],
                         sampling=SAMPLED, seeds=[5, 5], speculative_draft=4,
                         num_slots=1)
    assert alone[0] == alone[1] and len(alone[0]) == 8
    assert st["by_sampling"]["sampled"]["verify_rounds"] == st["verify_rounds"] >= 1
    golden = JaxScheduler(JAX_CFG, jp, **SCHED_KW, speculative_draft=4)
    with golden:
        g_want = golden.submit(PROMPTS[0], max_new_tokens=8).result(timeout=300)
    with ContinuousBatchingScheduler(CFG, tp, **dict(SCHED_KW, num_slots=3),
                                     speculative_draft=4, device="cpu") as s:
        g = s.submit(PROMPTS[0], max_new_tokens=8)
        s1 = s.submit(req, max_new_tokens=8, sampling=SAMPLED, seed=5)
        s2 = s.submit(LONG[0], max_new_tokens=8, sampling=SAMPLED, seed=6)
        outs = [f.result(timeout=300) for f in (g, s1, s2)]
    assert outs[0] == g_want
    assert outs[1] == alone[0]
    assert outs[2] != outs[1]


def test_scheduler_rejects_bad_draft(weights):
    with pytest.raises(ValueError, match="speculative_draft"):
        ContinuousBatchingScheduler(CFG, weights[1], num_slots=2, speculative_draft=99,
                                    device="cpu")


def test_scheduler_overshoot_and_history_bounds(weights):
    """The submit bound charges (lag + 1)(D + 1) + D positions, as JAX's;
    a request at the edge of the window serves, one past it is refused;
    stats are None without speculation."""
    jp, tp = weights
    j = JaxScheduler(JAX_CFG, jp, **SCHED_KW, speculative_draft=8)
    t = ContinuousBatchingScheduler(CFG, tp, **SCHED_KW, speculative_draft=8, device="cpu")
    assert t.overshoot == j.overshoot == 2 * 9 + 8
    assert t._hist.shape == (2, 128 + 9)
    edge = 128 - 1 - 8 - t.overshoot
    with t:
        out = t.submit([1, 5, 9], max_new_tokens=edge).result(timeout=300)
        with pytest.raises(ValueError, match="exceeds"):
            t.submit([1, 5, 9], max_new_tokens=edge + 1)
    assert len(out) == edge
    assert ContinuousBatchingScheduler(CFG, tp, **SCHED_KW, device="cpu").speculation_stats \
        is None

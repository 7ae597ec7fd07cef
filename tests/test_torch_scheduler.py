"""The port's paged continuous-batching scheduler vs the JAX package's, on
the CPU in f32 (TINY, the same bridged params, `decode_chunk=4`,
`prompt_bucket=8`): greedy tokens identical, the same zero-copy shares and
copy-on-write copies on the prefix-sharing traffic of
tests/test_paged_kv.py, page pressure that waits and completes, no leaked
page after drain; seeded sampling that replays whatever shares the batch,
and a chi-square test of the runtime sampler against its target
distribution. The quantized serving configuration (int4 block weights,
int8 page pool) gives the JAX scheduler's tokens too, with multi-chunk
prompts whose prefix hits end mid-page (scale pages copied on write)."""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.ops.quant import (
    quantize_params_int4 as jax_q4,
)
from llm_based_apache_spark_optimization_tpu.ops.sampling import (
    filtered_runtime_logits as jax_filtered,
)
from llm_based_apache_spark_optimization_tpu.serve import (
    GenerationService as JaxService,
)
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    SchedulerBackend as JaxSchedulerBackend,
)
from llm_based_apache_spark_optimization_tpu.tokenizer import (
    ByteTokenizer as JaxByteTokenizer,
)
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.ops.quant import quantize_params_int4
from llm_based_apache_spark_optimization_tpu_torch.ops.sampling import (
    SamplingParams,
    filtered_runtime_logits,
    sample_runtime,
)
from llm_based_apache_spark_optimization_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    GenerationService,
    SchedulerBackend,
    SchedulerCrashed,
)
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

PROMPTS = [[1, 5, 9], [1, 7], [1, 3, 4, 8, 10], [1, 11, 12, 13]]
PREFIX = [1] + list(range(5, 28))  # 24 tokens = 3 blocks of 8
SHARED = [PREFIX + [40 + i] for i in range(6)]
BASE = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,),
            kv_layout="paged")


@pytest.fixture(scope="module")
def both():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def both4(both):
    """The same TINY tree with int4 block weights in both packages."""
    jp, tp = both
    return jax_q4(jp, group=32), quantize_params_int4(tp, group=32)


def wait_drained(sched, timeout=30.0):
    """Futures resolve before the worker frees the slot's pages: poll."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = sched.page_stats
        if st["pages_in_use"] <= st["prefix_resident_pages"]:
            break
        time.sleep(0.02)
    return sched.page_stats


def run_both(both, traffic, **kw):
    """Run `traffic(sched)` on the JAX and the port scheduler with the same
    settings; returns [(outputs, page_stats, prefix_stats)] for each, after
    checking that every page left in use is a prefix-resident page."""
    jp, tp = both
    kw = dict(BASE, **kw)
    res = []
    for sched in (JaxScheduler(JAX_TINY, jp, **kw),
                  ContinuousBatchingScheduler(TINY, tp, **kw, device="cpu")):
        with sched:
            outs = traffic(sched)
            stats = wait_drained(sched)
            prefix = sched.prefix_stats
        sched._page_alloc.check()
        assert stats["pages_in_use"] == stats["prefix_resident_pages"]
        res.append((outs, stats, prefix))
    return res


def sequential(prompts, max_new):
    return lambda s: [s.submit(p, max_new_tokens=max_new).result(timeout=300)
                      for p in prompts]


def concurrent(prompts, max_new):
    return lambda s: [f.result(timeout=300) for f in
                      [s.submit(p, max_new_tokens=max_new) for p in prompts]]


def test_greedy_matches_jax(both):
    (want, _, _), (got, stats, _) = run_both(both, concurrent(PROMPTS * 2, 6),
                                             kv_page_size=16)
    assert got == want
    assert stats["pages_in_use"] == 0


@pytest.mark.parametrize("ps,cow", [(8, False), (16, True)])
def test_prefix_sharing_matches_jax(both, ps, cow):
    """Page-aligned reuse (8-token blocks, 8-token pages) shares pages and
    copies none; 16-token pages put a block boundary mid-page, where
    copy-on-write copies one page. Tokens and both counters match JAX."""
    (want, jstats, jprefix), (got, stats, prefix) = run_both(
        both, sequential(SHARED, 5), kv_page_size=ps)
    assert got == want
    for key in ("zero_copy_shares", "cow_copies", "prefix_resident_pages"):
        assert stats[key] == jstats[key], key
    for key in ("hits", "misses", "blocks_reused", "reused_tokens"):
        assert prefix[key] == jprefix[key], key
    assert prefix["hits"] >= 3 and stats["zero_copy_shares"] > 0
    assert (stats["cow_copies"] > 0) == cow


def test_int4_int8_greedy_matches_jax(both4):
    """Int4 weights and the int8 pool: the JAX scheduler's tokens, and the
    pool priced at int8 values plus f32 scales."""
    (want, jstats, _), (got, stats, _) = run_both(
        both4, concurrent(PROMPTS * 2, 6), kv_page_size=16, kv_quant="int8")
    assert got == want
    assert stats["kv_quant"] == "int8" and stats["pages_in_use"] == 0
    assert stats["page_bytes"] == jstats["page_bytes"]


@pytest.mark.parametrize("ps,cow", [(8, False), (16, True)])
def test_int8_multichunk_prefix_sharing_matches_jax(both4, ps, cow):
    """25-token prompts in 8-token chunks over the int8 pool: every chunk
    requantizes only its window, and the 24-token prefix hits. With 16-token
    pages the hit ends mid-page, where copy-on-write copies the value and
    scale pages. Tokens, shares, COW copies and prefix counters match JAX."""
    (want, jstats, jprefix), (got, stats, prefix) = run_both(
        both4, sequential(SHARED, 5), kv_page_size=ps, kv_quant="int8")
    assert got == want
    for key in ("zero_copy_shares", "cow_copies", "prefix_resident_pages"):
        assert stats[key] == jstats[key], key
    for key in ("hits", "misses", "blocks_reused", "reused_tokens"):
        assert prefix[key] == jprefix[key], key
    assert prefix["hits"] >= 3 and stats["zero_copy_shares"] > 0
    assert (stats["cow_copies"] > 0) == cow


def test_kv_quant_is_validated(both):
    with pytest.raises(ValueError, match="kv_quant"):
        ContinuousBatchingScheduler(TINY, both[1], kv_quant="int4", device="cpu")


def test_page_pressure_waits_and_completes(both):
    """A pool smaller than the demand: requests wait for pages (all or
    nothing, no deadlock) and complete with the JAX tokens."""
    prompts = [[1, 5 + i, 9] for i in range(6)]
    (want, _, _), (got, stats, _) = run_both(
        both, concurrent(prompts, 6), num_slots=4, max_seq=48,
        kv_page_size=16, kv_pages=3)
    assert got == want
    assert stats["page_waits"] > 0 and stats["pages_in_use"] == 0
    with pytest.raises(ValueError, match="page pool"):
        ContinuousBatchingScheduler(TINY, both[1], num_slots=2, max_seq=48,
                                    kv_page_size=16, kv_pages=1, device="cpu")


def test_only_the_paged_layout_is_ported(both):
    with pytest.raises(ValueError, match="ROADMAP A7"):
        ContinuousBatchingScheduler(TINY, both[1], kv_layout="contiguous",
                                    device="cpu")


def test_seeded_sampling_replays_whatever_shares_the_batch(both):
    sp = SamplingParams(temperature=0.9, top_k=40, top_p=0.95)
    req = [1, 17, 93, 5]
    with ContinuousBatchingScheduler(TINY, both[1], **dict(BASE, num_slots=3),
                                     kv_page_size=16, device="cpu") as s:
        alone = s.submit(req, 12, sp, seed=7).result(timeout=300)
        futs = [s.submit([1, 40, 41], 12),
                s.submit(req, 12, sp, seed=7),
                s.submit([1, 60, 61, 62], 12, sp, seed=8)]
        shared = [f.result(timeout=300) for f in futs]
        other_seed = s.submit(req, 12, sp, seed=8).result(timeout=300)
    assert shared[1] == alone and len(alone) == 12
    assert other_seed != alone
    assert all(0 <= tok < TINY.vocab_size for tok in alone + other_seed)


def test_filtered_logits_match_jax(rng):
    """Per-row temperature, top-k and top-p against JAX's. Each row's top_p
    sits midway between two cumulative masses (computed in f64), so no
    cutoff rests on the order of the f32 sums."""
    v = 16
    logits = np.stack([rng.permutation(v) for _ in range(4)]).astype(np.float32)
    temps = np.asarray([0.5, 1.0, 0.8, 1.3], np.float32)
    topk = np.asarray([0, 5, 0, 12], np.int32)
    topp = []
    for row, tmp, k, j in zip(logits, temps, topk, (3, 2, 6, 1)):
        srt = np.sort(row.astype(np.float64) / tmp)[::-1][: k or v]
        cum = np.cumsum(np.exp(srt - srt.max()) / np.exp(srt - srt.max()).sum())
        topp.append((cum[j - 1] + cum[j]) / 2)
    topp = np.asarray(topp, np.float32)
    want = np.asarray(jax_filtered(jnp.asarray(logits), jnp.asarray(temps),
                                   jnp.asarray(topp), jnp.asarray(topk)))
    got = filtered_runtime_logits(torch.from_numpy(logits), torch.from_numpy(temps),
                                  torch.from_numpy(topp), torch.from_numpy(topk))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_sample_runtime_chi_square():
    """N draws of one row at sample indices 0..N-1 against
    softmax(filtered_runtime_logits): chi-square below the 99.99th
    percentile of its degrees of freedom (fixed seeds, deterministic);
    filtered-out tokens are never drawn and greedy rows take argmax."""
    from scipy.stats import chi2

    n, v = 20000, 8
    row = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0])
    knobs = (torch.full((n,), 0.8), torch.full((n,), 0.95),
             torch.full((n,), 6, dtype=torch.int32))
    logits = row.expand(n, v)
    toks = sample_runtime(logits, *knobs, torch.full((n,), 3, dtype=torch.int64),
                          torch.arange(n))
    p = torch.softmax(filtered_runtime_logits(row[None], *(k[:1] for k in knobs)),
                      -1)[0].double().numpy()
    counts = np.bincount(toks.numpy(), minlength=v)
    kept = p > 0
    assert counts[~kept].sum() == 0
    stat = float(np.sum((counts[kept] - n * p[kept]) ** 2 / (n * p[kept])))
    assert stat < chi2.ppf(0.9999, int(kept.sum()) - 1), (stat, counts, p)
    greedy = sample_runtime(logits[:4], torch.zeros(4), *(k[:4] for k in knobs[1:]),
                            torch.zeros(4, dtype=torch.int64), torch.arange(4))
    assert greedy.tolist() == [0, 0, 0, 0]


def test_cancel_and_streaming(both):
    seen = []
    with ContinuousBatchingScheduler(TINY, both[1], **BASE, kv_page_size=16,
                                     device="cpu") as s:
        fut = s.submit([1, 5, 9], 40, on_token=seen.append)
        s.cancel(fut)
        out = fut.result(timeout=300)
        full = s.submit([1, 5, 9], 12, on_token=seen.append).result(timeout=300)
    assert len(out) < 40 and len(full) == 12 and seen[-12:] == full
    with pytest.raises(RuntimeError, match="shut down"):
        s.submit([1, 2], 4)


def test_loop_crash_fails_requests_typed(both):
    tp = dict(both[1])
    tp["embed"] = tp["embed"][:4]  # token ids past 4 index out of range
    with ContinuousBatchingScheduler(TINY, tp, **BASE, kv_page_size=16,
                                     device="cpu") as s:
        fut = s.submit([1, 300], 4)
        with pytest.raises(SchedulerCrashed):
            fut.result(timeout=300)
        with pytest.raises(SchedulerCrashed):
            s.submit([1, 2], 4)


SYSTEM = "Table name is t. Columns:\na (int)"


def test_scheduler_backend_text_matches_jax(both):
    jcfg = dataclasses.replace(JAX_TINY, max_seq_len=512)
    tcfg = dataclasses.replace(TINY, max_seq_len=512)
    jp, tp = both
    kw = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, kv_layout="paged",
              kv_page_size=16)
    jsvc, tsvc = JaxService(), GenerationService()
    jsvc.register("sql", JaxSchedulerBackend(JaxScheduler(jcfg, jp, **kw),
                                             JaxByteTokenizer(), max_new_tokens=16))
    tb = SchedulerBackend(ContinuousBatchingScheduler(tcfg, tp, **kw, device="cpu"),
                          ByteTokenizer(), max_new_tokens=16)
    tsvc.register("sql", tb)
    try:
        prompts = ["count rows", "max of a", "average of a by a, sorted"]
        want = [jsvc.generate("sql", p, system=SYSTEM).response for p in prompts]
        got = [tsvc.generate("sql", p, system=SYSTEM) for p in prompts]
        assert [r.response for r in got] == want and any(want)
        assert all(0 < r.ttft_s <= r.latency_s for r in got)
        results = {}

        def one(i, p):  # concurrent callers share the decode batch
            results[i] = tsvc.generate("sql", p, system=SYSTEM).response

        threads = [threading.Thread(target=one, args=(i, p))
                   for i, p in enumerate(prompts)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert [results[i] for i in range(3)] == want
        batch = tsvc.generate_batch("sql", prompts, system=SYSTEM)
        assert [r.response for r in batch] == want
    finally:
        tb.shutdown()
        for entry in jsvc._models.values():
            entry.backend.shutdown()

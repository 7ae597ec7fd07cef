"""The port's ragged mixed rounds (`ragged=True`, `LSOT_RAGGED=1`) against
the JAX scheduler's, on the CPU in f32 (TINY, the same bridged params, the
settings of tests/test_ragged_sched.py: 2 slots, decode_chunk 4,
prompt_bucket 8, pages of 16).

- Construction: paged only; an explicit `ragged=True` on the contiguous
  layout raises, the environment's opt-in degrades silently there; the
  prompt bucket caps at the paged small-T bound (32).
- Twelve requests through two slots, their budgets staggered (6, 10 and
  14 tokens) so that a slot frees while the other decodes and prompt
  chunks ride live decode rounds: greedy tokens identical to JAX's ragged scheduler and to the
  alternating one (tolerance: token-identical), over the f32 and the int8
  pool; sampled tokens identical to the port's alternating scheduler in
  f32 (the port's per-request streams differ from JAX's by design), and
  over the int8 pool replayed whatever shares the batch.
- The round's launch arithmetic on the CPU: per mixed round one ragged
  forward at T = the bucket and decode_chunk - 1 at T = 1; a chunk issued
  while no slot decodes runs that first forward alone (a ragged prefill),
  so requests served one at a time take no mixed round and no T = 1 step
  runs for no decode row; no flash prefill forward.
- The ragged path composes with overcommit: a pressure storm's resumes
  give the pressure-free tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.models import llama
from llm_based_apache_spark_optimization_tpu_torch.ops.sampling import SamplingParams
from llm_based_apache_spark_optimization_tpu_torch.serve import (
    ContinuousBatchingScheduler,
)
from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

PROMPTS = [[1, 5, 9], [1, 7], [1, 3, 4, 8, 10], [1, 11, 12, 13]]
KW = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,),
          kv_layout="paged", kv_page_size=16)


@pytest.fixture(scope="module")
def both():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def budget(i, max_new):
    """Request i's token budget: staggered, so that slots retire apart."""
    return max_new + 4 * (i % 3)


def run(sched, prompts=PROMPTS * 3, sampled=False, max_new=6):
    with sched as s:
        sp = SamplingParams(temperature=0.9, top_p=0.9) if sampled else SamplingParams()
        futs = [s.submit(p, max_new_tokens=budget(i, max_new), seed=42 + i, sampling=sp)
                for i, p in enumerate(prompts)]
        return [f.result(timeout=300) for f in futs]


def port(both, **kw):
    return ContinuousBatchingScheduler(TINY, both[1], **dict(KW, **kw), device="cpu")


def test_ragged_requires_paged(both):
    for cls, cfg, params, extra in ((JaxScheduler, JAX_TINY, both[0], {}),
                                    (ContinuousBatchingScheduler, TINY, both[1],
                                     {"device": "cpu"})):
        with pytest.raises(ValueError, match="paged"):
            cls(cfg, params, num_slots=2, ragged=True, **extra)


def test_ragged_env_knob(both, monkeypatch):
    monkeypatch.setenv("LSOT_RAGGED", "1")
    s = port(both, prompt_bucket=128, max_seq=512)
    assert s._ragged and s.prompt_bucket == llama._UNROLL_MAX_T == 32
    j = JaxScheduler(JAX_TINY, both[0], **dict(KW, prompt_bucket=128, max_seq=512))
    assert j._ragged and j.prompt_bucket == s.prompt_bucket
    # The contiguous layout: the env knob silently stays off.
    assert not ContinuousBatchingScheduler(TINY, both[1], num_slots=2,
                                           device="cpu")._ragged
    monkeypatch.delenv("LSOT_RAGGED")
    assert not port(both)._ragged


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32", "int8"])
def test_ragged_greedy_parity(both, kv_quant):
    """Greedy: the port's mixed rounds == JAX's mixed rounds == the port's
    alternating rounds."""
    want = run(JaxScheduler(JAX_TINY, both[0], **KW, kv_quant=kv_quant, ragged=True))
    mixed = port(both, kv_quant=kv_quant, ragged=True)
    got = run(mixed)
    assert got == want
    assert mixed.mixed_rounds > 0
    assert run(port(both, kv_quant=kv_quant, ragged=False)) == want


def test_ragged_sampled_parity(both):
    """Sampled, f32: each request draws the same tokens in mixed and
    alternating rounds (its stream index rides per row)."""
    assert run(port(both, ragged=True), sampled=True) == \
        run(port(both, ragged=False), sampled=True)


def test_ragged_int8_sampled_replays_whatever_shares_the_batch(both):
    """Sampled over the int8 pool: a mixed round's chunk attends to its own
    K/V as the pool stores them (int8), an alternating chunk to them before
    they are quantized (in both packages), so a draw near a tie may differ
    between the two modes. Within the mixed mode each request replays: the
    burst's tokens equal each request's served alone."""
    burst = run(port(both, kv_quant="int8", ragged=True), sampled=True)
    sp = SamplingParams(temperature=0.9, top_p=0.9)
    with port(both, kv_quant="int8", ragged=True) as s:
        alone = [s.submit(p, max_new_tokens=budget(i, 6), seed=42 + i,
                          sampling=sp).result(timeout=300)
                 for i, p in enumerate(PROMPTS * 3)]
    assert burst == alone


def spy_forwards(monkeypatch):
    """Record (T, a prefill chunk, sorted q_lens) of every scheduler forward."""
    calls = []
    real = llama.forward

    def spy(cfg, params, tokens, positions, cache=None, **kw):
        q = kw.get("q_lens")
        calls.append((tokens.shape[1], kw.get("span") is not None,
                      None if q is None else sorted(set(q.tolist()))))
        return real(cfg, params, tokens, positions, cache, **kw)

    from llm_based_apache_spark_optimization_tpu_torch.serve import scheduler as sched_mod

    monkeypatch.setattr(sched_mod, "forward", spy)
    return calls


def test_mixed_round_launch_arithmetic(both, monkeypatch):
    """Every forward of a ragged scheduler is a paged forward: per mixed
    round one at T = the bucket (8) with per-row q_lens in {1, 8}, then
    decode_chunk - 1 at T = 1; one at T = 8 for each ragged prefill; no
    prefill chunk forward."""
    calls = spy_forwards(monkeypatch)
    s = port(both, ragged=True)
    run(s, prompts=PROMPTS * 2)
    assert s.prefill_forwards == 0 and not any(chunk for _, chunk, _ in calls)
    wide = [c for c in calls if c[0] > 1]
    assert len(wide) == s.mixed_rounds + s.ragged_prefills
    assert s.mixed_rounds > 0 and all(c[0] == 8 for c in wide)
    assert all(set(q) <= {1, 8} and 8 in q for _, _, q in wide)
    assert len(calls) - len(wide) == (s.decode_chunk - 1) * s.mixed_rounds + \
        s.decode_chunk * (s.rounds_issued - s.mixed_rounds)


def test_lone_requests_take_no_mixed_round(both, monkeypatch):
    """Requests served one at a time: every chunk is issued while no slot
    decodes, so each runs as a ragged prefill (one T = 8 forward, no T = 1
    step for no decode row) and none rides a mixed round; the greedy tokens
    are JAX's ragged scheduler's."""
    want = run(JaxScheduler(JAX_TINY, both[0], **KW, ragged=True), prompts=PROMPTS)
    calls = spy_forwards(monkeypatch)
    with port(both, ragged=True) as s:
        got = [s.submit(p, max_new_tokens=budget(i, 6), seed=42 + i).result(timeout=300)
               for i, p in enumerate(PROMPTS)]
    assert got == want
    assert s.mixed_rounds == 0 and s.prefill_forwards == 0
    assert s.ragged_prefills == len(PROMPTS)
    assert sorted(t for t, _, _ in calls if t > 1) == [8] * len(PROMPTS)
    assert len(calls) == s.ragged_prefills + s.decode_chunk * s.rounds_issued


@pytest.mark.parametrize("kv_spill", [False, True], ids=["recompute", "spill"])
def test_ragged_pressure_storm_parity(both, kv_spill):
    """The ragged path under a storm withholding 3 of 9 pages of 8 (one
    slot decodes at a time there, so every chunk, the recompute resume's
    too, is a ragged prefill): at least one preemption, no prefill chunk
    forward, and the pressure-free greedy tokens of JAX's scheduler."""
    kw = dict(KW, kv_page_size=8, max_seq=64)
    want = run(JaxScheduler(JAX_TINY, both[0], **kw), prompts=PROMPTS, max_new=24)
    FAULTS.configure("kv:pressure:1:3", 0)
    try:
        s = ContinuousBatchingScheduler(TINY, both[1], **kw, ragged=True,
                                        kv_overcommit=0.25, kv_pages=9,
                                        kv_spill=kv_spill, device="cpu")
        got = run(s, prompts=PROMPTS, max_new=24)
    finally:
        FAULTS.clear()
    assert got == want
    st = s.page_stats
    assert st["preemptions"] >= 1 and s.ragged_prefills > 0 and s.prefill_forwards == 0
    assert st["spilled_pages"] == st["restored_pages"] and (st["spilled_pages"] > 0) == kv_spill

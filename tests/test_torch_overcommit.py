"""The port's page-pressure relief against the JAX scheduler's, on the CPU in
f32 (TINY, the same bridged params, the settings of tests/test_paged_kv.py:
2 slots, decode_chunk 4, prompt_bucket 8, pages of 8, max_seq 64).

- `export_pages`/`import_pages` round-trip pool pages bit for bit (bf16,
  f32 and the int8 pool with its scales) and describe a blob as JAX's
  `blob_meta` does.
- `kv_overcommit=1.0` reproduces the exact-envelope admission: the same
  tokens and allocator accounting as a scheduler built without the knob.
- A `kv:pressure` storm over an overcommitted pool preempts, and every
  request resumes, by recompute or by restoring spilled host pages (f32 and
  int8 pools): greedy tokens identical to the JAX scheduler's pressure-free
  output (tolerance: token-identical), sampled tokens identical to the
  port's own pressure-free control (the port's per-request streams differ
  from JAX's by design); spilled pages == restored pages. A mid-prefill
  victim resumes without a stale chunk.
- The watermark sweep evicts prefix pages before an allocation fails, as
  JAX's does; a resume's envelope stays inside the slot's row; a request
  starved of pages past its deadline fails typed.
"""

from concurrent.futures import Future
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.engine.paged_kv import (
    blob_meta as jax_blob_meta,
)
from llm_based_apache_spark_optimization_tpu.engine.paged_kv import (
    export_pages as jax_export_pages,
)
from llm_based_apache_spark_optimization_tpu.engine.paged_kv import (
    handoff_bytes as jax_handoff_bytes,
)
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from llm_based_apache_spark_optimization_tpu.utils.faults import FAULTS as JAX_FAULTS
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine.paged_kv import (
    blob_meta,
    export_pages,
    handoff_bytes,
    import_pages,
    init_page_pool,
)
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.ops.sampling import SamplingParams
from llm_based_apache_spark_optimization_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    DeadlineExceeded,
)
from llm_based_apache_spark_optimization_tpu_torch.serve import scheduler as sched_mod
from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

PROMPTS = [[1, 5, 9], [1, 7], [1, 3, 4, 8, 10], [1, 11, 12, 13]]
PRESSURE_KW = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(-1,),
                   max_seq=64, kv_layout="paged", kv_page_size=8)
STORM = dict(kv_overcommit=0.25, kv_pages=9)
SAMPLED = SamplingParams(temperature=0.8, top_p=0.95)


@pytest.fixture(scope="module")
def both():
    jp = jax_init(JAX_TINY, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def drive(sched_cls, cfg, params, faults, pressure=None, sampling=None,
          prompts=PROMPTS, max_new=24, **kw):
    """Submit `prompts` at once (seeds 41 + i) under an optional
    `kv:pressure` spec; returns (outputs, page_stats)."""
    if pressure:
        faults.configure(pressure, 0)
    try:
        extra = {} if sched_cls is JaxScheduler else {"device": "cpu"}
        with sched_cls(cfg, params, **dict(PRESSURE_KW, **kw), **extra) as s:
            futs = [s.submit(p, max_new_tokens=max_new,
                             sampling=sampling or SamplingParams(), seed=41 + i)
                    for i, p in enumerate(prompts)]
            out = [f.result(timeout=300) for f in futs]
            stats = dict(s.page_stats)
    finally:
        faults.clear()
    return out, stats


def port(both, **kw):
    return drive(ContinuousBatchingScheduler, TINY, both[1], FAULTS, **kw)


@pytest.fixture(scope="module")
def jax_golden(both):
    """The JAX scheduler's pressure-free greedy tokens, f32 and int8 pools."""
    return {q: drive(JaxScheduler, JAX_TINY, both[0], JAX_FAULTS, kv_quant=q)[0]
            for q in (None, "int8")}


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_export_import_pages_round_trip(kv_quant):
    """Pages exported from one pool and imported into other pages of a
    second pool come back bit for bit (bf16 through its 16-bit patterns);
    the blob describes itself as JAX's does for the same geometry."""
    g = torch.Generator().manual_seed(0)
    for dtype in ((torch.bfloat16, torch.float32) if kv_quant is None else (torch.float32,)):
        pool = init_page_pool(TINY, 12, 8, dtype, device="cpu", kv_quant=kv_quant)
        for arr in pool.values():
            if arr.dtype == torch.int8:
                arr.copy_(torch.randint(-127, 128, arr.shape, generator=g, dtype=torch.int8))
            else:
                arr.copy_(torch.randn(arr.shape, generator=g).to(arr.dtype))
        blob = export_pages(pool, [7, 2, 9])
        assert len(blob) == (4 if kv_quant else 2)
        other = init_page_pool(TINY, 12, 8, dtype, device="cpu", kv_quant=kv_quant)
        import_pages(other, [0, 5, 11], blob)
        for name, arr in pool.items():
            assert torch.equal(other[name][:, [0, 5, 11]], arr[:, [7, 2, 9]]), name
            assert torch.equal(other[name][:, 1], torch.zeros_like(arr[:, 1])
                               if not name.endswith("s") else torch.ones_like(arr[:, 1]))
        jblob = jax_export_pages(tuple(
            jnp.asarray(a.float().numpy(), jnp.bfloat16) if a.dtype == torch.bfloat16
            else jnp.asarray(a.numpy()) for a in pool.values()), [7, 2, 9])
        assert blob_meta(blob) == jax_blob_meta(jblob)
        assert handoff_bytes(blob) == jax_handoff_bytes(jblob)


def test_overcommit_ratio_one_reconciles_exact_envelope(both, jax_golden):
    """kv_overcommit=1.0 is the exact-envelope admission: the JAX tokens,
    and the same accounting as a scheduler built without the knob, with no
    preemption."""
    base, base_st = port(both)
    one, one_st = port(both, kv_overcommit=1.0)
    assert one == base == jax_golden[None]
    assert one_st["preemptions"] == base_st["preemptions"] == 0
    for k in ("zero_copy_shares", "cow_copies", "page_waits", "pages_total",
              "spilled_pages", "restored_pages"):
        assert one_st[k] == base_st[k], k


@pytest.mark.parametrize("kv_spill", [False, True], ids=["recompute", "spill"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32", "int8"])
def test_pressure_storm_resumes_token_identical(both, jax_golden, kv_quant,
                                                sampled, kv_spill):
    """A storm withholding 3 of 9 pages from an overcommitted pool preempts
    at least once, and every request resumes to the tokens of a
    pressure-free run: JAX's greedy tokens, the port's own sampled ones.
    Spill resumes restore exactly the pages they spilled."""
    sampling = SAMPLED if sampled else None
    if sampled:
        golden, _ = port(both, sampling=sampling, kv_quant=kv_quant)
    else:
        golden = jax_golden[kv_quant]
    out, st = port(both, sampling=sampling, pressure="kv:pressure:1:3",
                   kv_quant=kv_quant, kv_spill=kv_spill, **STORM)
    assert out == golden
    assert st["preemptions"] >= 1 and st["pages_withheld"] == 3
    assert st["kv_quant"] == (kv_quant or "")
    if kv_spill:
        assert st["spilled_pages"] > 0
        assert st["spilled_pages"] == st["restored_pages"]
    else:
        assert st["spilled_pages"] == st["restored_pages"] == 0


def test_pressure_storm_mid_prefill_victim_parity(both):
    """Multi-chunk prompts under a storm: a victim preempted between its
    chunks (possibly re-admitted into its own slot) leaves no stale chunk
    behind; the tokens are JAX's pressure-free ones."""
    prompts = [[1] + list(range(5, 5 + 16 + i)) for i in range(4)]  # 3 chunks
    want, _ = drive(JaxScheduler, JAX_TINY, both[0], JAX_FAULTS, prompts=prompts,
                    max_new=16)
    out, st = port(both, prompts=prompts, max_new=16, pressure="kv:pressure:1:3",
                   kv_overcommit=0.25, kv_pages=10)
    assert out == want
    assert st["preemptions"] + st["page_waits"] >= 1


def test_watermark_sweep_evicts_prefix_pages_proactively(both):
    """Below the low watermark the loop evicts prefix entries until the
    high one: evictions move, no preemption, no page left in use, and the
    tokens and eviction count are the JAX scheduler's."""
    prefix = [1] + list(range(5, 28))  # 3 blocks of 8 -> published pages
    prompts = [prefix + [40 + i] for i in range(4)]
    kw = dict(kv_pages=8, kv_watermark_low=0.5, kv_watermark_high=0.75)
    res = []
    for cls, cfg, params, extra in ((JaxScheduler, JAX_TINY, both[0], {}),
                                    (ContinuousBatchingScheduler, TINY, both[1],
                                     {"device": "cpu"})):
        with cls(cfg, params, **dict(PRESSURE_KW, **kw), **extra) as s:
            outs = [s.submit(p, max_new_tokens=6).result(timeout=300) for p in prompts]
            deadline = time.time() + 10
            while s.page_stats["pages_in_use"] and time.time() < deadline:
                time.sleep(0.02)
            res.append((outs, dict(s.page_stats)))
    (want, jst), (got, st) = res
    assert got == want
    assert st["evictions"] == jst["evictions"] > 0
    assert st["preemptions"] == 0 and st["pages_in_use"] == 0


def test_resume_envelope_clamped_to_slot_row(both):
    """A resume's prompt (10 prompt + 23 committed tokens) re-buckets to 48,
    past max_seq 56 with its reserve and overshoot: the envelope is clamped
    to the slot's row."""
    s = ContinuousBatchingScheduler(TINY, both[1], num_slots=2, decode_chunk=4,
                                    prompt_bucket=16, stop_ids=(-1,), max_seq=56,
                                    kv_layout="paged", kv_page_size=8,
                                    kv_overcommit=0.25, device="cpu")
    req = sched_mod._Request(ids=list(range(1, 11)), max_new=24, temperature=0.0,
                             top_p=1.0, top_k=0, seed=0, future=Future())
    req.generated = list(range(3, 26))
    req.resume_pref = len(req.generated)
    assert s._admit_paged(0, req)
    assert len(s._slot_pages[0]) <= s._pages_per_slot
    assert req.page_end <= s._pages_per_slot * 8
    s._free_slot_pages(0)
    s._page_alloc.check()


def test_page_wait_deadline_fails_fast(both):
    """A request starved of pages past its deadline fails typed while the
    holder of the whole pool still decodes (each of its rounds slowed to
    0.1 s by the `sched:hang` seam), and the holder completes."""
    FAULTS.configure("sched:hang:1:0.1", 0)
    try:
        with ContinuousBatchingScheduler(TINY, both[1], num_slots=2, decode_chunk=4,
                                         prompt_bucket=8, stop_ids=(-1,), max_seq=48,
                                         kv_layout="paged", kv_page_size=16,
                                         kv_pages=3, device="cpu") as s:
            holder = s.submit([1, 5, 9], max_new_tokens=24)
            waiter = s.submit([1, 7, 11], max_new_tokens=24, deadline_s=0.2)
            with pytest.raises(DeadlineExceeded):
                waiter.result(timeout=60)
            assert not holder.done()
            assert len(holder.result(timeout=300)) == 24
    finally:
        FAULTS.clear()


@pytest.mark.parametrize("kw,match", [
    ({"kv_overcommit": 0.0}, "kv_overcommit"),
    ({"kv_overcommit": 1.5}, "kv_overcommit"),
    ({"kv_watermark_low": 0.6, "kv_watermark_high": 0.5}, "watermarks"),
    ({"kv_watermark_low": -0.1}, "watermarks"),
])
def test_pressure_knobs_are_validated_as_jax(both, kw, match):
    """Out-of-range knobs raise in both packages with the same message."""
    for cls, cfg, params, extra in ((JaxScheduler, JAX_TINY, both[0], {}),
                                    (ContinuousBatchingScheduler, TINY, both[1],
                                     {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            cls(cfg, params, **dict(PRESSURE_KW, **kw), **extra)


def test_pressure_knobs_read_the_environment(both, monkeypatch):
    """Unset knobs default to their environment variables, as in JAX; the
    contiguous layout ignores them."""
    monkeypatch.setenv("LSOT_KV_OVERCOMMIT", "0.5")
    monkeypatch.setenv("LSOT_KV_SPILL", "1")
    monkeypatch.setenv("LSOT_KV_WATERMARK_LOW", "0.25")
    monkeypatch.setenv("LSOT_KV_WATERMARK_HIGH", "0.5")
    s = ContinuousBatchingScheduler(TINY, both[1], **PRESSURE_KW, kv_pages=16,
                                    device="cpu")
    st = s.page_stats
    assert (st["overcommit"], st["spill"], st["watermark_low_pages"],
            st["watermark_high_pages"]) == (0.5, 1, 4, 8)
    j = JaxScheduler(JAX_TINY, both[0], **PRESSURE_KW, kv_pages=16).page_stats
    for k in ("overcommit", "spill", "watermark_low_pages", "watermark_high_pages"):
        assert st[k] == j[k], k
    assert ContinuousBatchingScheduler(TINY, both[1], device="cpu").page_stats is None

"""The port's grammar-constrained decoding against the JAX package's, on the
CPU at TINY f32 with the byte tokenizer and the same bridged weights.

- The compiled tables (`mask`, `next_state`, `dist`, `need`, the start
  state, `min_new_tokens`) equal JAX's exactly for the generic grammar, a
  schema grammar and a small BPE tokenizer trained here; the port keeps its
  device tables at the tokenizer's width, and its per-step mask and advance
  over every (state, id) pair, ids past the tokenizer included, equal JAX's
  tables padded to the model's width (exact).
- `fsm_advance_chain` equals JAX's on random states, chains and budgets.
- The two parsers and the two DFAs accept and reject the same SQL.
- Greedy constrained tokens equal JAX's (exact): the engine over the
  contiguous cache, the paged layout and the int8 cache, both grammars, at
  the `min_new_tokens` boundary and above; the scheduler in both layouts,
  with ragged mixed rounds and over the int4/int8 paged configuration,
  mixing constrained and unconstrained requests with multi-chunk prompts
  and a grammar swap, and under a page-pressure storm whose constrained
  victims resume by recompute and by spill.
- Sampled constrained requests always parse and replay exactly in the port.
- The guards, the service and app paths (`/api/generate` with `constrain`,
  `constrain_sql` with its fall-back, the app's SQL equal to the JAX
  app's), and a supervised crash that replays constrained entries.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.constrain import (
    fsm_advance_chain as jax_chain,
)
from llm_based_apache_spark_optimization_tpu.constrain import (
    get_constraint as jax_get_constraint,
)
from llm_based_apache_spark_optimization_tpu.constrain import (
    is_valid_spark_sql as jax_valid,
)
from llm_based_apache_spark_optimization_tpu.constrain.masks import (
    compile_token_masks as jax_compile,
)
from llm_based_apache_spark_optimization_tpu.engine import (
    InferenceEngine as JaxEngine,
)
from llm_based_apache_spark_optimization_tpu.evalh.fixtures import (
    FOUR_QUERY_SUITE,
    SINGLE_COMPLEX_CASE,
    TAXI_COLUMNS,
)
from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
from llm_based_apache_spark_optimization_tpu.ops.quant import (
    quantize_params_int4 as jax_q4,
)
from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from llm_based_apache_spark_optimization_tpu.utils.faults import FAULTS as JAX_FAULTS
from llm_based_apache_spark_optimization_tpu_torch.constrain import (
    CompiledMask,
    advance_states,
    allowed_tokens,
    compile_token_masks,
    fsm_advance_chain,
    get_constraint,
    is_valid_spark_sql,
    spark_sql_dfa,
    table_bytes,
    trivial_tables,
)
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.ops.quant import quantize_params_int4
from llm_based_apache_spark_optimization_tpu_torch.ops.sampling import SamplingParams
from llm_based_apache_spark_optimization_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    EngineBackend,
    FakeBackend,
    GenerationService,
    SchedulerBackend,
)
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import (
    ByteTokenizer,
    train_bpe,
)
from llm_based_apache_spark_optimization_tpu_torch.utils.faults import FAULTS

EOS = 2
CFG = dataclasses.replace(TINY, max_seq_len=512)
JAX_CFG = dataclasses.replace(JAX_TINY, max_seq_len=512)
SCHEMA = {"table": "taxi", "columns": list(TAXI_COLUMNS)}
# A second, shorter schema: the grammar a swap installs.
SCHEMA2 = {"table": "trips", "columns": ["payment_type", "tip_amount"]}
FIXTURE_SQL = [c.expected_sql for c in FOUR_QUERY_SUITE] + [SINGLE_COMPLEX_CASE.expected_sql]
MORE_SQL = [
    "SELECT * FROM taxi WHERE tip_amount IS NOT NULL;",
    "SELECT VendorID FROM taxi WHERE fare_amount BETWEEN 1 AND 5 ORDER BY VendorID DESC LIMIT 3",
    "SELECT COUNT(*) AS n FROM taxi WHERE payment_type IN (1, 2) GROUP BY VendorID HAVING n > 2",
    "SELECT a FROM t WHERE (b > 1 OR c < 2) AND d LIKE 'x%'",
    "SELECT t.a FROM t JOIN u ON t.a = u.a",
]
INVALID_SQL = [
    "", "hello world", "SELECT FROM taxi;", "DROP TABLE taxi;",
    "SELECT * FROM taxi WHERE", "SELECT * FROM from;", "SELECT * FROM taxi GROUP BY",
    "SELECT * FROM taxi;; --", "INSERT INTO taxi VALUES (1)",
    "SELECT a FROM t WHERE b > 2AND c < 1", "SELECT Select FROM taxi",
    "SELECT a FROM t WHERE b BETWEEN 1", "SELECT a FROM t WHERE (b > 1",
]
PROMPTS = ["Total fare per vendor.\nSQL: ", "hello",
           "Average tip for each payment type, as a longer question.\nSQL: ",
           "q", "zz top"]


@pytest.fixture(scope="module")
def tok():
    return ByteTokenizer()


@pytest.fixture(scope="module")
def grammars(tok):
    """{name: (JAX CompiledMask, port CompiledMask)} over the byte
    tokenizer, and over a BPE tokenizer trained on SQL ("bpe")."""
    bpe = train_bpe(FIXTURE_SQL + MORE_SQL + [" ".join(TAXI_COLUMNS)] * 3, 60)
    out = {}
    for name, spec in (("generic", "spark_sql"), ("schema", SCHEMA), ("schema2", SCHEMA2)):
        out[name] = (jax_get_constraint(spec, tok, (EOS,)), get_constraint(spec, tok, (EOS,)))
    dfa = spark_sql_dfa("taxi", tuple(TAXI_COLUMNS))
    from llm_based_apache_spark_optimization_tpu.constrain import spark_sql_dfa as jax_dfa

    out["bpe"] = (jax_compile(jax_dfa("taxi", tuple(TAXI_COLUMNS)), bpe, (EOS,)),
                  compile_token_masks(dfa, bpe, (EOS,)))
    return out


@pytest.fixture(scope="module")
def weights():
    jp = jax_init(JAX_CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def weights4(weights):
    jp, tp = weights
    return jax_q4(jp, group=32), quantize_params_int4(tp, group=32)


def detext(tok, out):
    if out and out[-1] == EOS:
        out = out[:-1]
    return tok.decode(out)


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("name", ["generic", "schema", "bpe"])
def test_compiled_tables_equal_jax(grammars, name):
    """Host tables equal exactly; the port's device tables at the
    tokenizer's width give, for every state and every logits column up to
    the model's width, JAX's padded `need <= budget` mask (budgets 1, the
    shortest parse, 40) and JAX's padded `next` (exact)."""
    jc, tc = grammars[name]
    for field in ("mask", "next_state", "dist", "need"):
        assert np.array_equal(getattr(jc, field), getattr(tc, field)), field
    assert (jc.init_state, jc.min_new_tokens, jc.eos_ids) == (
        tc.init_state, tc.min_new_tokens, tc.eos_ids)
    vocab = tc.tok_vocab + 61
    jt = {k: np.asarray(v) for k, v in jc.device_tables(vocab).items()}
    tt = tc.device_tables(vocab, "cpu")
    assert tt["need"].shape == tt["next"].shape == (tc.num_states, tc.tok_vocab)
    assert table_bytes(tt) == 2 * 4 * tc.num_states * tc.tok_vocab
    assert tc.device_tables(vocab, "cpu") is tt  # cached per device
    states = torch.arange(tc.num_states, dtype=torch.int32)
    for budget in (1, tc.min_new_tokens, 40):
        got = allowed_tokens(tt["need"], states, torch.full_like(states, budget), vocab)
        assert np.array_equal(got.numpy(), jt["need"] <= budget), budget
    for tok_id in range(vocab):
        got = advance_states(tt["next"], states, torch.full_like(states, tok_id))
        assert np.array_equal(got.numpy(), jt["next"][:, tok_id]), tok_id
    with pytest.raises(ValueError, match="model vocab"):
        tc.device_tables(tc.tok_vocab - 1, "cpu")


def test_trivial_tables_allow_everything_and_stay_at_zero():
    """The sentinel tables a scheduler holds before any grammar: state 0
    allows every id at a budget >= 1 and never leaves 0, as JAX's [1, V]
    tables do."""
    t = trivial_tables("cpu")
    zeros = torch.zeros(3, dtype=torch.int32)
    assert allowed_tokens(t["need"], zeros, torch.tensor([1, 5, 0]), 320).sum(1).tolist() == [
        320, 320, 0]
    assert advance_states(t["next"], zeros, torch.tensor([0, 7, 319])).tolist() == [0, 0, 0]


def test_fsm_advance_chain_matches_jax(grammars):
    """Random committed states (sentinel included), chains of 6 over the
    model's width (ids past the tokenizer included, and walks of real SQL
    so chains get accepted) and budgets: per-position states and valid
    lengths equal JAX's (exact)."""
    jc, tc = grammars["schema"]
    vocab = 320
    jt = jc.device_tables(vocab)
    tt = tc.device_tables(vocab, "cpu")
    rng = np.random.default_rng(0)
    b, d = 64, 6
    states = rng.integers(0, tc.num_states, b).astype(np.int32)
    states[:4] = 0
    states[4:20] = tc.init_state
    chains = rng.integers(0, vocab, (b, d)).astype(np.int32)
    # A grammar-valid prefix from the start state, then random ids past it.
    chains[4:20] = ByteTokenizer().encode(FIXTURE_SQL[0], add_bos=False)[:d]
    chains[12:20, 3:] = rng.integers(0, vocab, (8, d - 3))
    rem = rng.integers(0, 40, b).astype(np.int32)
    rem[4:12] = 40
    want_pos, want_len = jax_chain(jt["next"], jt["need"], jnp.asarray(states),
                                   jnp.asarray(chains), jnp.asarray(rem))
    got_pos, got_len = fsm_advance_chain(tt["next"], tt["need"], torch.from_numpy(states),
                                         torch.from_numpy(chains), torch.from_numpy(rem))
    assert np.array_equal(got_pos.numpy(), np.asarray(want_pos))
    assert np.array_equal(got_len.numpy(), np.asarray(want_len))
    assert int(got_len[5]) == d  # the SQL chain is accepted whole


def test_parsers_and_dfas_agree_with_jax(grammars, tok):
    """The fixture suite and the extra SQL parse in both packages; the
    invalid set fails in both; the generic DFA accepts exactly the same
    statements in both (walk + stop id)."""
    from llm_based_apache_spark_optimization_tpu.constrain import spark_sql_dfa as jax_dfa

    jc, tc = grammars["generic"]
    jd, td = jax_dfa(None, None), spark_sql_dfa(None, None)  # the compiled grammars' cache keys
    for sql in FIXTURE_SQL + MORE_SQL + INVALID_SQL:
        assert is_valid_spark_sql(sql) == jax_valid(sql), sql
        assert td.accepts(sql) == jd.accepts(sql), sql
        ids = tok.encode(sql, add_bos=False)
        end_t, end_j = tc.walk(ids), jc.walk(ids)
        assert end_t == end_j, sql
    for sql in FIXTURE_SQL:
        assert is_valid_spark_sql(sql)
    for sql in INVALID_SQL:
        assert not is_valid_spark_sql(sql)


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("layout,kv_quant", [("contiguous", None), ("paged", None),
                                             ("contiguous", "int8")],
                         ids=["contiguous", "paged", "int8"])
def test_engine_greedy_matches_jax(weights, grammars, tok, layout, kv_quant):
    """Two prompts at once under each grammar, at the grammar's
    `min_new_tokens` and at 40: the port's tokens equal JAX's (exact), and
    every completion parses within its budget."""
    jp, tp = weights
    je = JaxEngine(JAX_CFG, jp, stop_ids=(EOS,), prompt_bucket=8, kv_layout=layout,
                   kv_quant=kv_quant)
    te = InferenceEngine(CFG, tp, stop_ids=(EOS,), prompt_bucket=8, kv_layout=layout,
                         kv_quant=kv_quant, device="cpu")
    prompts = [tok.encode(PROMPTS[0]), tok.encode(PROMPTS[3])]
    for name in ("generic", "schema"):
        jc, tc = grammars[name]
        for budget in (tc.min_new_tokens, 40):
            want = je.generate(prompts, max_new_tokens=budget, constraint=jc)
            got = te.generate(prompts, max_new_tokens=budget, constraint=tc)
            assert got == want, (name, budget)
            for out in got:
                assert len(out) <= budget and out[-1] == EOS
                assert is_valid_spark_sql(detext(tok, out)), detext(tok, out)


def test_engine_sampled_always_parses_and_replays(weights, grammars, tok):
    """Sampled constrained completions (temperature 1.2) parse for every
    seed, a seed replays its tokens, and two seeds differ somewhere."""
    te = InferenceEngine(CFG, weights[1], stop_ids=(EOS,), prompt_bucket=8, device="cpu")
    tc = grammars["schema"][1]
    prompt = [tok.encode(PROMPTS[0])]
    hot = SamplingParams(temperature=1.2, top_p=0.95)
    outs = [te.generate(prompt, 40, hot, seed=s, constraint=tc)[0] for s in range(4)]
    for out in outs:
        assert is_valid_spark_sql(detext(tok, out)), detext(tok, out)
    assert te.generate(prompt, 40, hot, seed=2, constraint=tc)[0] == outs[2]
    assert len({tuple(o) for o in outs}) > 1


# ------------------------------------------------------------- scheduler

# (prompt, grammar, budget): constrained and free requests interleaved; the
# two schema grammars force a swap; prompt 2 spans several 8-token chunks.
PLAN = [(0, "schema", 40), (1, None, 12), (2, "schema", 30), (3, "schema2", 40),
        (4, None, 20), (0, "schema2", 25)]


def serve_plan(cls, cfg, params, grammars, tok, which, **kw):
    extra = {} if cls is JaxScheduler else {"device": "cpu"}
    with cls(cfg, params, num_slots=3, decode_chunk=4, prompt_bucket=8,
             stop_ids=(EOS,), **kw, **extra) as s:
        futs = [s.submit(tok.encode(PROMPTS[p]), max_new_tokens=n,
                         constraint=None if g is None else grammars[g][which])
                for p, g, n in PLAN]
        return [f.result(timeout=300) for f in futs], getattr(s, "grammar_swaps", None)


@pytest.mark.parametrize("kw,quantized", [
    ({"kv_layout": "contiguous"}, False),
    ({"kv_layout": "paged"}, False),
    ({"kv_layout": "paged", "ragged": True}, False),
    ({"kv_layout": "paged", "kv_quant": "int8"}, True),
], ids=["contiguous", "paged", "ragged", "paged_int4_int8"])
def test_scheduler_greedy_matches_jax(weights, weights4, grammars, tok, kw, quantized):
    """The mixed plan in both layouts, with ragged mixed rounds, and with
    int4 weights over the int8 pool: the port's tokens equal the JAX
    scheduler's (exact); constrained completions parse, end at a stop id
    inside their budget and name only their schema's table; the port
    installed its tables twice (two grammar changes)."""
    jp, tp = weights4 if quantized else weights
    want, _ = serve_plan(JaxScheduler, JAX_CFG, jp, grammars, tok, 0, **kw)
    got, swaps = serve_plan(ContinuousBatchingScheduler, CFG, tp, grammars, tok, 1, **kw)
    assert got == want
    assert swaps == 2
    for out, (_, g, n) in zip(got, PLAN):
        if g is not None:
            text = tok.decode(out)
            assert len(out) < n and is_valid_spark_sql(text), text
            assert grammars[g][1].walk(out + [EOS]) is not None
            table = SCHEMA["table"] if g == "schema" else SCHEMA2["table"]
            assert table in text.lower()


PRESSURE = dict(num_slots=2, decode_chunk=4, prompt_bucket=8, stop_ids=(EOS,),
                max_seq=64, kv_layout="paged", kv_page_size=8)


@pytest.mark.parametrize("kv_spill", [False, True], ids=["recompute", "spill"])
def test_preempted_constrained_requests_resume_as_jax(weights, grammars, tok, kv_spill,
                                                     monkeypatch):
    """A `kv:pressure` storm over an overcommitted pool preempts a
    constrained request mid-decode; it resumes (re-prefill, or restored
    host pages) with its FSM state re-derived from its committed tokens,
    and every request's tokens equal the JAX scheduler's pressure-free run
    (exact)."""
    jp, tp = weights
    specs = [None, "schema2", None, "schema2"]
    prompts = [[1, 5, 9], [1, 7], [1, 3, 4, 8, 10], [1, 11, 12, 13]]
    victims = []
    preempt = ContinuousBatchingScheduler._preempt_slot

    def spy(self, slot):
        victims.append(self._slot_req[slot].constraint is not None)
        preempt(self, slot)

    monkeypatch.setattr(ContinuousBatchingScheduler, "_preempt_slot", spy)

    def run(cls, params, faults, pressure, **kw):
        extra = {} if cls is JaxScheduler else {"device": "cpu"}
        if pressure:
            faults.configure(pressure, 0)
        try:
            with cls(CFG if extra else JAX_CFG, params, **PRESSURE, **kw, **extra) as s:
                futs = [s.submit(p, max_new_tokens=24,
                                 constraint=None if g is None
                                 else grammars[g][0 if cls is JaxScheduler else 1])
                        for p, g in zip(prompts, specs)]
                return [f.result(timeout=300) for f in futs], getattr(s, "page_stats", None)
        finally:
            faults.clear()

    want, _ = run(JaxScheduler, jp, JAX_FAULTS, None)
    got, st = run(ContinuousBatchingScheduler, tp, FAULTS, "kv:pressure:1:3",
                  kv_overcommit=0.25, kv_pages=9, kv_spill=kv_spill)
    assert got == want
    assert st["preemptions"] >= 1 and any(victims)
    assert (st["spilled_pages"] > 0) == kv_spill
    for out, g in zip(got, specs):
        if g is not None:
            assert is_valid_spark_sql(tok.decode(out))


def test_scheduler_sampled_parses_and_replays_across_batches(weights, grammars, tok):
    """Sampled constrained requests parse; the same (prompt, seed) gives
    the same tokens alone and beside other traffic."""
    tc = grammars["schema"][1]
    hot = SamplingParams(temperature=1.2, top_p=0.95)
    prompt = tok.encode(PROMPTS[0])
    with ContinuousBatchingScheduler(CFG, weights[1], num_slots=3, decode_chunk=4,
                                     prompt_bucket=8, stop_ids=(EOS,), device="cpu") as s:
        alone = s.submit(prompt, 40, hot, seed=7, constraint=tc).result(timeout=300)
        futs = [s.submit(tok.encode(PROMPTS[1]), 12, hot, seed=3),
                s.submit(prompt, 40, hot, seed=7, constraint=tc),
                s.submit(prompt, 40, hot, seed=8, constraint=tc)]
        crowd = [f.result(timeout=300) for f in futs]
    assert crowd[1] == alone
    for out in (alone, crowd[2]):
        assert is_valid_spark_sql(tok.decode(out)), tok.decode(out)


def test_constraint_guards(weights, grammars, tok):
    """A budget below `min_new_tokens` raises in the engine, the scheduler
    and (after the serving clamp) both backends' `check_budget`; a
    `constrain` spec on a backend without `supports_constrain` is refused."""
    tc = grammars["generic"][1]
    low = tc.min_new_tokens - 1
    prompt = tok.encode("q")
    eng = InferenceEngine(CFG, weights[1], stop_ids=(EOS,), prompt_bucket=8, device="cpu")
    with pytest.raises(ValueError, match="complete constrained parse"):
        eng.generate([prompt], max_new_tokens=low, constraint=tc)
    sched = ContinuousBatchingScheduler(CFG, weights[1], num_slots=2, prompt_bucket=8,
                                        stop_ids=(EOS,), device="cpu")
    with pytest.raises(ValueError, match="complete constrained parse"):
        sched.submit(prompt, max_new_tokens=low, constraint=tc)
    svc = GenerationService()
    svc.register("eng", EngineBackend(eng, tok, max_new_tokens=64))
    svc.register("fake", FakeBackend(lambda p: "SELECT 1"))
    sb = SchedulerBackend(sched, tok, max_new_tokens=64)
    try:
        svc.register("sched", sb)
        for model in ("eng", "sched"):
            with pytest.raises(ValueError, match="complete constrained parse"):
                svc.validate(model, "q", max_new_tokens=low, constrain="spark_sql")
            svc.validate(model, "q", max_new_tokens=tc.min_new_tokens, constrain="spark_sql")
        with pytest.raises(ValueError, match="constrained decoding"):
            svc.generate("fake", "q", constrain="spark_sql")
        with pytest.raises(ValueError, match="constrained decoding"):
            svc.validate("fake", "q", constrain="spark_sql")
        with pytest.raises(ValueError, match="non-empty"):
            svc.validate("sched", "q", constrain={"table": "t", "columns": []})
        assert isinstance(sb._resolve_constraint("spark_sql"), CompiledMask)
    finally:
        svc.close()


def test_service_constrained_text_matches_jax(weights, grammars, tok):
    """`GenerationService.generate` with a schema `constrain` spec over the
    engine and the scheduler backends, batched too: the text equals the
    JAX service's over the same backends (exact) and parses."""
    from llm_based_apache_spark_optimization_tpu.serve import EngineBackend as JaxEB
    from llm_based_apache_spark_optimization_tpu.serve import GenerationService as JaxSvc
    from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
        SchedulerBackend as JaxSB,
    )

    jp, tp = weights
    texts = []
    for svc, eng, sb in (
            (JaxSvc(), JaxEngine(JAX_CFG, jp, stop_ids=(EOS,), prompt_bucket=8),
             lambda: JaxSB(JaxScheduler(JAX_CFG, jp, num_slots=2, prompt_bucket=8,
                                        stop_ids=(EOS,)), tok, max_new_tokens=40)),
            (GenerationService(), InferenceEngine(CFG, tp, stop_ids=(EOS,), prompt_bucket=8,
                                                  device="cpu"),
             lambda: SchedulerBackend(ContinuousBatchingScheduler(
                 CFG, tp, num_slots=2, prompt_bucket=8, stop_ids=(EOS,), device="cpu"),
                 tok, max_new_tokens=40))):
        svc.register("eng", EngineBackend(eng, tok, max_new_tokens=40)
                     if isinstance(svc, GenerationService) else JaxEB(eng, tok, max_new_tokens=40))
        svc.register("sched", sb())
        try:
            got = [svc.generate(m, PROMPTS[0], constrain=SCHEMA).response
                   for m in ("eng", "sched")]
            got += [r.response for r in svc.generate_batch(
                "sched", PROMPTS[:2], constrain=SCHEMA2)]
            texts.append(got)
        finally:
            svc.close()
    assert texts[1] == texts[0]
    for text in texts[1]:
        assert is_valid_spark_sql(text), text


# ------------------------------------------------------------------- app

CSV = ("VendorID,passenger_count,trip_distance,payment_type,fare_amount,tip_amount,"
       "total_amount\n1,1,1.5,1,8.0,2.0,10.3\n2,2,3.2,2,14.5,0.0,15.3\n"
       "1,1,0.8,1,5.5,1.0,7.3\n2,3,6.1,1,22.0,4.5,27.3\n")


def test_constrain_sql_app_matches_jax(weights, tmp_path, monkeypatch):
    """`LSOT_CONSTRAIN_SQL=1`: the port's app and the JAX app, each over
    its tiny contiguous scheduler with the same bridged weights, answer
    `POST /process-data/` with the same schema-constrained SQL (exact) and
    the same result or error body; the SQL parses and names only the
    view; `/api/generate` with `constrain` returns a completion."""
    from llm_based_apache_spark_optimization_tpu.app import AppConfig as JaxAppConfig
    from llm_based_apache_spark_optimization_tpu.app import create_api_app as jax_api
    from llm_based_apache_spark_optimization_tpu.app.__main__ import (
        make_tiny_service as jax_tiny_service,
    )
    from llm_based_apache_spark_optimization_tpu.history import (
        SQLiteHistory as JaxHistory,
    )
    from llm_based_apache_spark_optimization_tpu.sql import SQLiteBackend as JaxSQL
    from llm_based_apache_spark_optimization_tpu_torch.app import AppConfig, create_api_app
    from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry
    from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
    from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend

    monkeypatch.setenv("LSOT_CONSTRAIN_SQL", "1")
    jsvc = jax_tiny_service(40, scheduler=True, supervise=False)
    try:
        mw = tuple(params_from_jax(jax.tree.map(
            np.asarray, jsvc._models[m].backend.scheduler.params), device="cpu")
            for m in ("duckdb-nsql", "mistral"))
        tsvc = entry.make_tiny_service(40, device="cpu", weights=mw, supervise=False)
        try:
            bodies = []
            for svc, app_fn, config, hist, sql in (
                    (jsvc, jax_api, JaxAppConfig, JaxHistory, JaxSQL),
                    (tsvc, create_api_app, AppConfig, SQLiteHistory, SQLiteBackend)):
                root = tmp_path / type(svc).__module__.split(".")[0]
                (root / "input").mkdir(parents=True)
                (root / "input" / "taxi.csv").write_text(CSV)
                c = config.from_env(input_dir=str(root / "input"),
                                    output_dir=str(root / "out"),
                                    history_db=":memory:", max_new_tokens=40)
                assert c.constrain_sql
                client = app_fn(svc, sql, hist(), c).test_client()
                body = client.post_json("/process-data/", {
                    "input_text": "total fare per vendor", "file_name": "taxi.csv"}).json()
                body.pop("output_file", None)
                gen = client.post_json("/api/generate", {
                    "model": "duckdb-nsql", "prompt": "count trips",
                    "constrain": {"table": "taxi", "columns": ["VendorID"]}})
                assert gen.status == 200
                bodies.append((body, gen.json()["response"]))
            (want, want_gen), (got, got_gen) = bodies
            assert got == want and got_gen == want_gen
            assert is_valid_spark_sql(got["sql_query"]), got["sql_query"]
            assert "temp_view" in got["sql_query"].lower()
            assert is_valid_spark_sql(got_gen)
        finally:
            tsvc.close()
    finally:
        jsvc.close()


def test_constrain_sql_falls_back_when_no_column_is_constrainable(tmp_path, caplog):
    """A CSV whose headers are all quoted-only shapes runs unconstrained
    with a warning; an identifier-shaped header set is compiled in, the
    non-identifier ones dropped loudly."""
    from llm_based_apache_spark_optimization_tpu_torch.app import AppConfig
    from llm_based_apache_spark_optimization_tpu_torch.app.pipeline import Pipeline
    from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend

    seen = []

    class Recording(GenerationService):
        def generate(self, model, prompt, constrain=None, **kw):
            seen.append(constrain)
            return super().generate(model, prompt, constrain=None, **kw)

    svc = Recording()
    svc.register("duckdb-nsql", FakeBackend(lambda p: "SELECT 1"))
    svc.register("llama3.2", FakeBackend(lambda p: "explained"))
    cfg = AppConfig(input_dir=str(tmp_path), output_dir=str(tmp_path / "o"),
                    history_db=":memory:", constrain_sql=True)
    pipe = Pipeline(svc, SQLiteBackend, None, cfg)
    (tmp_path / "odd.csv").write_text("Trip Distance,a-b\n1,2\n")
    (tmp_path / "mixed.csv").write_text("VendorID,Trip Distance\n1,2\n")
    assert pipe.run(str(tmp_path / "odd.csv"), "q").ok
    assert pipe.run(str(tmp_path / "mixed.csv"), "q").ok
    assert seen == [None, {"table": "temp_view", "columns": ["VendorID"]}]
    assert "generating unconstrained" in caplog.text
    assert "cannot enter the grammar" in caplog.text


# ------------------------------------------------------------ supervisor

@pytest.mark.chaos
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_supervised_crash_replays_constrained_entries(weights, grammars, tok):
    """`sched:crash` kills the supervised port scheduler mid-burst of
    constrained and free requests through `SchedulerBackend` (which sends
    the compiled tables and the spec, and installs the journal's
    resolver): restarts = 1, lost = 0, each text equals a crash-free
    run's, and the journal's spec recompiles to the same grammar."""
    from llm_based_apache_spark_optimization_tpu_torch.serve.supervisor import (
        SupervisedScheduler,
    )

    def build():
        return ContinuousBatchingScheduler(CFG, weights[1], num_slots=2, decode_chunk=4,
                                           prompt_bucket=8, stop_ids=(EOS,), device="cpu")

    specs = [SCHEMA, None, "spark_sql", SCHEMA]
    control = SchedulerBackend(build(), tok, max_new_tokens=40)
    try:
        want = [control.complete(PROMPTS[i], constrain=s).text for i, s in enumerate(specs)]
    finally:
        control.shutdown()
    builds = []

    def factory():
        if builds:
            FAULTS.clear()  # exactly one crash: the rebuild runs clean
        builds.append(1)
        return build()

    FAULTS.configure("sched:crash:1", seed=0)
    sup = SupervisedScheduler(factory, stall_min_s=0.0, max_restarts=3)
    backend = SchedulerBackend(sup, tok, max_new_tokens=40)
    try:
        assert sup.constraint_resolver == backend._resolve_constraint
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(len(specs)) as ex:
            got = list(ex.map(lambda i: backend.complete(PROMPTS[i], constrain=specs[i]).text,
                              range(len(specs))))
        h = sup.health()
        assert sup.constraint_resolver(SCHEMA) is grammars["schema"][1]
    finally:
        FAULTS.clear()
        backend.shutdown()
    assert got == want
    assert (h["restarts"], h["lost"]) == (1, 0) and len(builds) == 2
    for text, s in zip(got, specs):
        if s is not None:
            assert is_valid_spark_sql(text), text

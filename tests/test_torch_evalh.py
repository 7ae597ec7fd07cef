"""The port's eval harness (`evalh/`) on the CPU against the JAX package's.

Twins, each run through both packages' modules with equal scores and equal
rendered text (apart from wall-clock fields and the mesh column):

- tests/test_evalh.py's cases (its two `test_load_spider_real_format`
  bodies included; the two JAX marks `slow` are `slow` here too);
- tests/test_spider_loader.py's 11 cases;
- the evalh cases of tests/test_repair.py (the repair leg and its
  summary) and tests/test_constrain.py (the constrained run over a tiny
  engine: 100% grammar-valid, the same SQL as JAX's with bridged weights);
- a tiny engine service of each package built from one seed-0 tree through
  the bridge: the same greedy SQL, then the same summary, configs table,
  repair leg and report;
- the CLIs (`python -m ...evalh`, `...evalh.report`) with `--cpu`, and
  `--virtual-devices N` (N CPU ranks for the tiny backend's tp configs;
  tests/test_torch_parallel.py drives that group).

Under tests/conftest.py JAX sees 8 virtual CPU devices; the port sees one
(`configs.device_count("cpu")`)."""

import json
import re
import types

import jax
import numpy as np
import pytest

from llm_based_apache_spark_optimization_tpu.app import __main__ as jax_app
from llm_based_apache_spark_optimization_tpu.app import repair as jax_repair_mod
from llm_based_apache_spark_optimization_tpu.evalh import __main__ as jax_cli
from llm_based_apache_spark_optimization_tpu.evalh import configs as jax_configs
from llm_based_apache_spark_optimization_tpu.evalh import fixtures as jax_fixtures
from llm_based_apache_spark_optimization_tpu.evalh import harness as jax_harness
from llm_based_apache_spark_optimization_tpu.evalh import metrics as jax_metrics
from llm_based_apache_spark_optimization_tpu.evalh import repair as jax_repair
from llm_based_apache_spark_optimization_tpu.evalh import report as jax_report
from llm_based_apache_spark_optimization_tpu.evalh import spider as jax_spider
from llm_based_apache_spark_optimization_tpu.serve import FakeBackend as JaxFake
from llm_based_apache_spark_optimization_tpu.serve import GenerationService as JaxService
from llm_based_apache_spark_optimization_tpu.serve import flightrecorder as jax_flight
from llm_based_apache_spark_optimization_tpu.utils import observability as jax_obs
from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as t_app
from llm_based_apache_spark_optimization_tpu_torch.app import repair as t_repair_mod
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.evalh import __main__ as t_cli
from llm_based_apache_spark_optimization_tpu_torch.evalh import configs as t_configs
from llm_based_apache_spark_optimization_tpu_torch.evalh import fixtures as t_fixtures
from llm_based_apache_spark_optimization_tpu_torch.evalh import harness as t_harness
from llm_based_apache_spark_optimization_tpu_torch.evalh import metrics as t_metrics
from llm_based_apache_spark_optimization_tpu_torch.evalh import repair as t_repair
from llm_based_apache_spark_optimization_tpu_torch.evalh import report as t_report
from llm_based_apache_spark_optimization_tpu_torch.evalh import spider as t_spider
from llm_based_apache_spark_optimization_tpu_torch.serve import FakeBackend as TFake
from llm_based_apache_spark_optimization_tpu_torch.serve import GenerationService as TService
from llm_based_apache_spark_optimization_tpu_torch.serve import flightrecorder as t_flight
from llm_based_apache_spark_optimization_tpu_torch.utils import observability as t_obs

P = {
    "jax": types.SimpleNamespace(
        app=jax_app, cli=jax_cli, configs=jax_configs, fixtures=jax_fixtures,
        harness=jax_harness, metrics=jax_metrics, repair=jax_repair, report=jax_report,
        spider=jax_spider, Fake=JaxFake, Service=JaxService, repair_mod=jax_repair_mod,
        flight=jax_flight, obs=jax_obs),
    "torch": types.SimpleNamespace(
        app=t_app, cli=t_cli, configs=t_configs, fixtures=t_fixtures,
        harness=t_harness, metrics=t_metrics, repair=t_repair, report=t_report,
        spider=t_spider, Fake=TFake, Service=TService, repair_mod=t_repair_mod,
        flight=t_flight, obs=t_obs),
}


def twin(fn, *args):
    """`fn(package, *args)` on both packages; the port's result must equal
    JAX's, and is returned."""
    out = {side: fn(p, *args) for side, p in P.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


_WALL = re.compile(r"\d+\.\d+")


def norm(text):
    """Rendered text without its wall-clock fields (latencies, tok/s, the
    timestamp, the lowest-latency model, and the TTFT and queue-wait lines,
    which the port's engine backend measures and JAX's leaves at 0) or the
    BASELINE rows' mesh cell."""
    out = []
    for line in text.splitlines():
        if re.search(r"TTFT|queue wait", line, re.I):
            continue
        if re.match(r"\| \d-", line):  # a BASELINE config row
            cells = line.split(" | ")
            line = " | ".join(cells[:1] + ["MESH", cells[2]] + ["#"] * 4) + " |"
        elif re.search(r"latency|tok/s|Throughput|cadence|generated \d", line,
                       re.I) or " s |" in line:
            line = _WALL.sub("#", line)
            line = re.sub(r"generated [\d :-]+$", "generated #", line)
            line = re.sub(r"\*\*[^*]+\*\* \(avg #", "** (avg #", line)
        out.append(line)
    return "\n".join(out)


def report_fields(rep):
    """A ModelReport's scores without its wall-clock fields."""
    return dict(
        model=rep.model, exact=rep.exact_match_rate, edit=rep.avg_edit_distance,
        exec_match=rep.execution_match_rate, grammar=rep.grammar_valid_rate,
        executable=rep.executable_rate, explained=rep.explained_failures,
        cases=[(c.nl, c.generated_sql, c.expected_sql, c.exact_match, c.edit_distance,
                c.output_tokens, c.execution_match, c.grammar_valid, c.executable,
                c.exec_error, c.explanation) for c in rep.cases])


@pytest.fixture()
def counters(monkeypatch):
    """Fresh repair counters and flight ring in both packages' repair
    modules, as tests/test_repair.py's fixture."""
    for p in P.values():
        monkeypatch.setattr(p.repair_mod, "repair_counters", p.obs.CounterSet())
        monkeypatch.setattr(p.repair_mod, "REPAIR_FLIGHT",
                            p.flight.FlightRecorder(replica="repair"))


# ------------------------------------------------ tests/test_evalh.py twins


def test_exact_match_strips():
    def body(p):
        assert p.metrics.exact_match(" SELECT 1; \n", "SELECT 1;") == 1
        assert p.metrics.exact_match("SELECT 2;", "SELECT 1;") == 0
        return p.metrics.exact_match("  x ", "x")
    twin(body)


def test_edit_distance_basic_and_fallback_agrees():
    def body(p):
        out = []
        for a, b, want in [("kitten", "sitting", 3), ("", "abc", 3), ("abc", "abc", 0),
                           ("SELECT *", "SELECT 1", 1)]:
            assert p.metrics.edit_distance(a, b) == want
            assert p.metrics._edit_distance_dp(a, b) == want
            out.append(p.metrics.edit_distance(a, b))
        return out
    twin(body)


def _perfect(p):
    answers = {c.nl: c.expected_sql for c in p.fixtures.FOUR_QUERY_SUITE}

    def fn(prompt):
        for nl, sql in answers.items():
            if nl in prompt:
                return sql
        return "SELECT NULL;"
    return fn


def test_evaluate_model_perfect_fake():
    def body(p):
        svc = p.Service()
        svc.register("perfect", p.Fake(_perfect(p)))
        rep = p.harness.evaluate_model(svc, "perfect", p.fixtures.FOUR_QUERY_SUITE,
                                       p.fixtures.TAXI_DDL_SYSTEM)
        assert rep.exact_match_rate == 100.0 and rep.avg_edit_distance == 0.0
        assert len(rep.cases) == 4
        return report_fields(rep)
    twin(body)


def test_evaluate_models_summary_format():
    def body(p):
        svc = p.Service()
        svc.register("bad", p.Fake(lambda q: "SELECT garbage;"))
        reports = p.harness.evaluate_models(svc, ["bad"], p.fixtures.FOUR_QUERY_SUITE,
                                            p.fixtures.TAXI_DDL_SYSTEM)
        out = p.harness.format_summary(reports)
        assert "Model: bad" in out and "Exact Match Rate: 0.00%" in out
        assert "Average Edit Distance:" in out and reports["bad"].avg_edit_distance > 0
        return norm(out)
    twin(body)


def _fake_service(p):
    svc = p.Service()
    svc.register("duckdb-nsql", p.Fake(lambda q: "SELECT COUNT(*) FROM singer;"))
    svc.register("llama3.2", p.Fake(lambda q: "Column name is misspelled."))
    return svc


def test_spider_smoke_fixture_shape():
    def body(p):
        smoke = p.spider.SPIDER_SMOKE
        assert len(smoke) >= 10 and len({c.db_id for c in smoke}) >= 3
        for c in smoke:
            assert c.schema_ddl.startswith("CREATE TABLE")
            assert c.expected_sql.strip().upper().startswith("SELECT")
        return [(c.db_id, c.nl, c.expected_sql, c.schema_ddl) for c in smoke]
    twin(body)


def test_fixture_suites_identical():
    """The copied suites and the taxi fixture writer are JAX's, byte for
    byte."""
    def body(p, tmp):
        f = p.fixtures
        path = tmp / f"{id(p)}.csv"
        f.write_taxi_fixture_csv(path)
        return ([(c.nl, c.expected_sql) for c in f.FOUR_QUERY_SUITE],
                [(c.nl, c.expected_sql) for c in f.GRAMMAR_BREADTH_SUITE],
                (f.SINGLE_COMPLEX_CASE.nl, f.SINGLE_COMPLEX_CASE.expected_sql),
                f.TAXI_DDL_SYSTEM, tuple(f.TAXI_COLUMNS), path.read_text())
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        twin(body, Path(d))


def test_load_spider_real_format_minimal(tmp_path):
    (tmp_path / "dev.json").write_text(json.dumps([
        {"db_id": "db1", "question": "How many users?",
         "query": "SELECT COUNT(*) FROM users"}]))
    (tmp_path / "tables.json").write_text(json.dumps([
        {"db_id": "db1", "table_names_original": ["users"],
         "column_names_original": [[-1, "*"], [0, "id"], [0, "name"]],
         "column_types": ["text", "number", "text"]}]))

    def body(p):
        cases = p.spider.load_spider(tmp_path / "dev.json")
        assert len(cases) == 1 and cases[0].nl == "How many users?"
        assert cases[0].schema_ddl == "CREATE TABLE users (id number, name text);"
        return [(c.db_id, c.nl, c.expected_sql, c.schema_ddl) for c in cases]
    twin(body)


def test_evaluate_model_batched():
    def body(p):
        svc = _fake_service(p)
        cases = [c.as_eval_case() for c in p.spider.SPIDER_SMOKE]
        rep = p.harness.evaluate_model_batched(svc, "duckdb-nsql", cases, system="schema",
                                               batch_size=4)
        assert len(rep.cases) == len(cases) and rep.wall_clock_s > 0
        assert rep.exact_match_rate > 0
        return report_fields(rep)
    twin(body)


def test_run_all_baseline_configs():
    def body(p):
        svc = _fake_service(p)
        assert set(p.configs.CONFIGS) == {
            "1-cpu-greedy", "2-error-greedy", "3-topp-batch8",
            "4-spider-batch32-tp4", "5-concurrent-mixed-tp8"}
        out = {}
        for key, cfg in p.configs.CONFIGS.items():
            rep = p.configs.run_config(svc, cfg, max_new_tokens=16)
            want = {"single": 1, "batched": cfg.batch_size,
                    "concurrent": cfg.batch_size * 2}[cfg.mode]
            assert len(rep.cases) == want, key
            assert rep.aggregate_tok_per_s > 0, key
            out[key] = (rep.mesh, report_fields(rep))
        return out
    twin(body)


def test_service_generate_batch_metrics():
    def body(p):
        svc = _fake_service(p)
        outs = svc.generate_batch("duckdb-nsql", ["q1", "q2", "q3"], system="s")
        assert len(outs) == 3
        assert svc.metrics.snapshot()["duckdb-nsql"]["requests"] == 3
        return [o.response for o in outs]
    twin(body)


def test_report_renders_reference_shape():
    def body(p):
        text = p.report.generate(p.app.make_fake_service(), backend_desc="fake",
                                 with_configs=True, quality_meaningful=False,
                                 **({} if p is P["jax"] else {"device": "cpu"}))
        for head in ("## Four-query suite — per query", "## Four-query suite — aggregates",
                     "## BASELINE configs", "## Conclusion", "5-concurrent-mixed-tp8",
                     "Smoke-model run", "| Query | duckdb-nsql | llama3.2 | mistral |"):
            assert head in text
        return norm(text)
    twin(body)


def test_load_spider_real_format(tmp_path):
    """The published Spider layout: every field a real row carries."""
    dev = [
        {"db_id": "concert_singer", "question": "How many singers do we have?",
         "question_toks": ["How", "many"], "query": "SELECT count(*) FROM singer",
         "query_toks": ["SELECT"], "query_toks_no_value": ["select"],
         "sql": {"select": [False, [[3, [0, [0, 0, False], None]]]],
                 "from": {"table_units": [["table_unit", 1]], "conds": []},
                 "where": [], "groupBy": [], "having": [], "orderBy": [],
                 "limit": None, "intersect": None, "except": None, "union": None}},
        {"db_id": "pets_1",
         "question": "Find the number of dog pets that are raised by female students.",
         "question_toks": ["Find"],
         "query": "SELECT count(*) FROM student AS T1 JOIN has_pet AS T2 ON "
                  "T1.stuid = T2.stuid JOIN pets AS T3 ON T2.petid = "
                  "T3.petid WHERE T1.sex = 'F' AND T3.pettype = 'dog'",
         "query_toks": [], "query_toks_no_value": [], "sql": {}},
    ]
    tables = [
        {"db_id": "concert_singer", "table_names": ["stadium", "singer"],
         "table_names_original": ["stadium", "singer"],
         "column_names": [[-1, "*"], [0, "stadium id"], [0, "name"], [1, "singer id"],
                          [1, "name"]],
         "column_names_original": [[-1, "*"], [0, "Stadium_ID"], [0, "Name"],
                                   [1, "Singer_ID"], [1, "Name"]],
         "column_types": ["text", "number", "text", "number", "text"],
         "primary_keys": [1, 3], "foreign_keys": []},
        {"db_id": "pets_1", "table_names": ["student"], "table_names_original": ["Student"],
         "column_names": [[-1, "*"], [0, "stuid"], [0, "sex"]],
         "column_names_original": [[-1, "*"], [0, "StuID"], [0, "Sex"]],
         "column_types": ["text", "number", "text"], "primary_keys": [1],
         "foreign_keys": []},
    ]
    (tmp_path / "dev.json").write_text(json.dumps(dev))
    (tmp_path / "tables.json").write_text(json.dumps(tables))

    def body(p):
        cases = p.spider.load_spider(tmp_path / "dev.json")
        assert len(cases) == 2
        c0 = cases[0]
        assert (c0.db_id, c0.nl, c0.expected_sql) == (
            "concert_singer", "How many singers do we have?", "SELECT count(*) FROM singer")
        assert "CREATE TABLE stadium (Stadium_ID number, Name text);" in c0.schema_ddl
        assert "CREATE TABLE singer (Singer_ID number, Name text);" in c0.schema_ddl
        assert "*" not in c0.schema_ddl
        assert cases[1].schema_ddl == "CREATE TABLE Student (StuID number, Sex text);"
        assert len(p.spider.load_spider(tmp_path / "dev.json", limit=1)) == 1
        ec = c0.as_eval_case()
        assert ec.nl == c0.nl and ec.expected_sql == c0.expected_sql
        return [(c.db_id, c.nl, c.expected_sql, c.schema_ddl) for c in cases]
    twin(body)


@pytest.mark.slow
def test_run_config_mesh_honesty():
    """Config rows state the mesh that ran. Without a factory both
    packages annotate tp=4; with one, JAX (8 virtual devices) builds tp=4
    while the port, which has no tp mesh (ROADMAP A13), never calls the
    factory and reports its one device; tp=1 configs stay plain."""
    cfg4 = t_configs.CONFIGS["4-spider-batch32-tp4"]
    for p in P.values():
        rep = p.configs.run_config(_fake_service(p), p.configs.CONFIGS[cfg4.key],
                                   max_new_tokens=8)
        assert rep.mesh == "tp=1 (requested tp=4; service owns its mesh)"
        rep = p.configs.run_config(_fake_service(p), p.configs.CONFIGS["1-cpu-greedy"],
                                   max_new_tokens=8)
        assert rep.mesh == "tp=1"
    built = {}

    def factory(tp):
        built["tp"] = tp
        return jax_app.make_tiny_service(8, tp=tp)

    assert len(jax.devices()) >= 8
    rep = jax_configs.run_config(_fake_service(P["jax"]), jax_configs.CONFIGS[cfg4.key],
                                 max_new_tokens=8, service_factory=factory)
    assert rep.mesh == "tp=4" and built["tp"] == 4
    built.clear()
    rep = t_configs.run_config(_fake_service(P["torch"]), cfg4, max_new_tokens=8,
                               service_factory=factory, device="cpu")
    assert rep.mesh == "tp=1 (requested tp=4; 1 device(s))" and not built


def test_run_config_mesh_row_without_tp():
    """The port's mesh column on the CPU without a process group: a factory
    is not called for a tp > 1 config, whose row names the one device
    (with a group of ranks it builds the tp service and the row reads
    "tp=N": tests/test_torch_parallel.py); `--virtual-devices` takes N >= 0."""
    cfg4 = t_configs.CONFIGS["4-spider-batch32-tp4"]
    calls = []
    rep = t_configs.run_config(_fake_service(P["torch"]), cfg4, max_new_tokens=8,
                               service_factory=calls.append, device="cpu")
    assert rep.mesh == "tp=1 (requested tp=4; 1 device(s))" and not calls
    rep = t_configs.run_config(_fake_service(P["torch"]), cfg4, max_new_tokens=8,
                               service_mesh="tp=2")
    assert rep.mesh == "tp=2 (service-owned; config requested tp=4)"
    assert t_configs.device_count("cpu") == 1
    with pytest.raises(ValueError, match="virtual-devices"):
        t_report.force_virtual_devices(-1)


def test_execution_match_metric():
    def body(p):
        b = p.report.make_taxi_exec_backend()
        em = p.metrics.execution_match
        expected = ("SELECT VendorID, SUM(total_amount) AS Total_Fare FROM taxi "
                    "GROUP BY VendorID;")
        same = "select   VendorID, sum(total_amount) as x from taxi group by VendorID"
        out = [em(same, expected, b),
               em("SELECT VendorID, SUM(fare_amount) FROM taxi GROUP BY VendorID",
                  expected, b),
               em("SELECT FROM WHERE", expected, b), em(same, "NOT SQL AT ALL", b)]
        assert out == [True, False, False, None]
        return out
    twin(body)


def test_harness_execution_match_rate():
    def body(p):
        by_nl = {c.nl: c.expected_sql for c in p.fixtures.FOUR_QUERY_SUITE}
        svc = p.Service()
        svc.register("echo", p.Fake(lambda q: next(s for nl, s in by_nl.items() if nl in q)))
        rep = p.harness.evaluate_model(svc, "echo", p.fixtures.FOUR_QUERY_SUITE,
                                       p.fixtures.TAXI_DDL_SYSTEM,
                                       exec_backend=p.report.make_taxi_exec_backend())
        assert rep.execution_match_rate == 100.0
        rep2 = p.harness.evaluate_model(svc, "echo", p.fixtures.FOUR_QUERY_SUITE,
                                        p.fixtures.TAXI_DDL_SYSTEM)
        assert rep2.execution_match_rate is None
        return report_fields(rep), report_fields(rep2)
    twin(body)


def test_oracle_backend_scores_100_percent_end_to_end():
    """The instrument's self-proof: the oracle service reads 100% exact
    and 100% execution match in both packages."""
    def body(p):
        svc = p.app.make_oracle_service()
        reports = p.harness.evaluate_models(
            svc, svc.models(), p.fixtures.FOUR_QUERY_SUITE, p.fixtures.TAXI_DDL_SYSTEM,
            max_new_tokens=64, exec_backend=p.report.make_taxi_exec_backend())
        for m, rep in reports.items():
            assert rep.exact_match_rate == 100.0, m
            assert rep.execution_match_rate == 100.0, m
            assert rep.avg_edit_distance == 0.0, m
        text = p.report.render_report(reports, [], backend_desc="oracle", platform="cpu")
        assert "| Exact-match rate | 100.0 % | 100.0 % | 100.0 % |" in text
        assert "| Execution-match rate | 100.0 % | 100.0 % | 100.0 % |" in text
        return norm(text)
    twin(body)


def test_report_includes_execution_match_row():
    def body(p):
        text = p.report.generate(p.app.make_fake_service(), backend_desc="fake",
                                 with_configs=False, quality_meaningful=False,
                                 **({} if p is P["jax"] else {"device": "cpu"}))
        assert "| Execution-match rate |" in text
        return norm(text)
    twin(body)


def test_execution_match_guards_and_order():
    def body(p):
        b = p.report.make_taxi_exec_backend()
        em = p.metrics.execution_match
        expected = ("SELECT VendorID, SUM(total_amount) AS Total_Fare FROM taxi "
                    "GROUP BY VendorID ORDER BY Total_Fare DESC;")
        gold = "SELECT VendorID, SUM(total_amount) AS T FROM taxi GROUP BY VendorID"
        out = [em("DROP TABLE taxi", expected, b), em(expected, expected, b),
               em(expected.replace("DESC", "ASC"), expected, b),
               em(gold + " ORDER BY T ASC", gold, b)]
        assert out == [False, True, False, True]
        return out
    twin(body)


def test_execution_match_with_prefixed_dml_blocked():
    def body(p):
        b = p.report.make_taxi_exec_backend()
        gold = "SELECT COUNT(*) FROM taxi"
        n_before = b.execute(gold).rows[0][0]
        sneaky = "WITH x AS (SELECT 1) DELETE FROM taxi"
        assert p.metrics._is_query(sneaky) is False
        assert p.metrics.execution_match(sneaky, gold, b) is False
        assert b.execute(gold).rows[0][0] == n_before
        with pytest.raises(Exception):
            b.execute("DELETE FROM taxi")
        assert b.execute(gold).rows[0][0] == n_before
        return n_before
    twin(body)


def test_cli_calls_models_exactly_once(monkeypatch, capsys):
    """The unknown-model check reuses one `service.models()` result, in both
    CLIs; both print the same summary over the fake service."""
    def body(p):
        calls = {"n": 0}
        real = p.app.make_fake_service

        def counting():
            svc = real()
            orig = svc.models

            def counted():
                calls["n"] += 1
                return orig()
            svc.models = counted
            return svc

        monkeypatch.setattr(p.app, "make_fake_service", counting)
        p.cli.main(["--backend", "fake", "--cpu"])
        out = capsys.readouterr().out
        assert "Final Evaluation Summary" in out and calls["n"] == 1
        return norm(out)
    twin(body)


def test_grammar_valid_and_executable_fields():
    def body(p):
        svc = p.Service()
        svc.register("m", p.Fake(lambda q: "SELECT VendorID FROM taxi;" if "vendor" in q
                                 else "not sql at all"))
        EvalCase = p.fixtures.EvalCase
        cases = [EvalCase(nl="vendor query", expected_sql="SELECT VendorID FROM taxi;"),
                 EvalCase(nl="garbage", expected_sql="SELECT 1;"),
                 EvalCase(nl="error trace", expected_sql="")]
        rep = p.harness.evaluate_model(svc, "m", cases, system="s",
                                       exec_backend=p.report.make_taxi_exec_backend())
        assert [c.grammar_valid for c in rep.cases] == [1, 0, None]
        assert [c.executable for c in rep.cases] == [1, 0, None]
        assert rep.grammar_valid_rate == 50.0 and rep.executable_rate == 50.0
        return report_fields(rep)
    twin(body)


def _rep(p, gv, exe, exact=0, edit=3):
    return p.harness.ModelReport(model="m", cases=[p.harness.CaseResult(
        nl="q", generated_sql="SELECT 1;", expected_sql="SELECT 1;", exact_match=exact,
        edit_distance=edit, latency_s=0.1, output_tokens=4, grammar_valid=gv,
        executable=exe)])


def test_report_constrain_compare_section():
    def body(p):
        text = p.report.render_report({"m": _rep(p, 0, 0)}, [], backend_desc="d",
                                      platform="cpu",
                                      constrained_reports={"m": _rep(p, 1, 1)})
        assert "Constrained decoding" in text
        assert "| m | 0.0 % | 100.0 % | 0.0 % | 100.0 % |" in text
        return text
    twin(body)


def test_report_sampled_speculation_section():
    def body(p):
        rep = _rep(p, None, None, exact=1, edit=0)
        text = p.report.render_report(
            {"m": rep}, [], backend_desc="d", platform="cpu",
            sampled_speculation={"m": {"temperature": 0.7, "verify_rounds": 10,
                                       "tokens_emitted": 15, "tokens_per_round": 1.5,
                                       "est_speedup_vs_vanilla": 0.8}})
        assert "## Sampled speculation (temperature>0 traffic)" in text
        assert "| m | 0.7 | 1.500 | 0.800x | 10 |" in text
        plain = p.report.render_report({"m": rep}, [], backend_desc="d", platform="cpu")
        assert "Sampled speculation" not in plain
        return text, plain
    twin(body)


@pytest.mark.slow
def test_report_speculative_scheduler_runs_sampled_pass():
    """A speculative-scheduler service's report carries the sampled pass
    with real counter deltas, in the port as in JAX."""
    svc = t_app.make_tiny_service(12, scheduler=True, speculative=2, supervise=False,
                                  device="cpu")
    try:
        text = t_report.generate(svc, backend_desc="tiny sched", with_configs=False,
                                 quality_meaningful=False, limit_cases=1,
                                 exec_match=False, device="cpu")
    finally:
        svc.close()
    assert "## Sampled speculation (temperature>0 traffic)" in text
    rows = [ln for ln in text.splitlines() if re.match(r"\| \S+ \| 0\.7 \|", ln)]
    assert rows and not any(ln.endswith("| 0 |") for ln in rows)


def test_grammar_breadth_suite_scores_in_and_between():
    def body(p):
        suite = p.fixtures.GRAMMAR_BREADTH_SUITE
        sqls = [c.expected_sql for c in suite]
        for frag in (" IN (", " BETWEEN ", " NOT IN (", " NOT BETWEEN "):
            assert any(frag in s for s in sqls)
        base_nl = {c.nl for c in p.configs.sql_case_base()}
        assert all(c.nl in base_nl for c in suite)
        rep = p.harness.evaluate_model(
            p.app.make_oracle_service(), "duckdb-nsql", suite, p.fixtures.TAXI_DDL_SYSTEM,
            max_new_tokens=64, exec_backend=p.report.make_taxi_exec_backend())
        for rate in (rep.exact_match_rate, rep.grammar_valid_rate, rep.executable_rate,
                     rep.execution_match_rate):
            assert rate == 100.0
        return report_fields(rep)
    twin(body)


# ------------------------------------------ tests/test_spider_loader.py twins

ROW = {"db_id": "concert_singer", "question": "How many singers?",
       "query": "SELECT COUNT(*) FROM singer;"}
TABLES = [{"db_id": "concert_singer", "table_names_original": ["singer"],
           "column_names_original": [[-1, "*"], [0, "singer_id"], [0, "name"]],
           "column_types": ["text", "int", "text"]}]


def _load_error(p, *args):
    """The typed error's message for `load_spider(*args)`, a ValueError."""
    with pytest.raises(p.spider.SpiderLoadError) as e:
        p.spider.load_spider(*args)
    assert isinstance(e.value, ValueError)
    return str(e.value)


def test_missing_file_is_typed(tmp_path):
    msg = twin(_load_error, tmp_path / "nope.json")
    assert "cannot read Spider data" in msg


def test_invalid_json_is_typed(tmp_path):
    (tmp_path / "dev.json").write_text("{not json")
    assert "not valid JSON" in twin(_load_error, tmp_path / "dev.json")


def test_non_list_payload_is_typed(tmp_path):
    (tmp_path / "dev.json").write_text(json.dumps({"examples": []}))
    assert "must be a JSON array" in twin(_load_error, tmp_path / "dev.json")


def test_empty_example_list_is_typed(tmp_path):
    (tmp_path / "dev.json").write_text("[]")
    assert "holds no examples" in twin(_load_error, tmp_path / "dev.json")


def test_malformed_row_names_its_index(tmp_path):
    (tmp_path / "dev.json").write_text(json.dumps([ROW, {"question": "no query or db_id"}]))
    assert "example #1" in twin(_load_error, tmp_path / "dev.json")


def test_malformed_tables_json_is_typed(tmp_path):
    data, tables = tmp_path / "dev.json", tmp_path / "tables.json"
    data.write_text(json.dumps([ROW]))
    for text, want in ((json.dumps({"not": "a list"}), "must be a JSON array"),
                       (json.dumps([{"db_id": "x"}]), "tables.json entry #0"),
                       ("{broken", "not valid JSON")):
        tables.write_text(text)
        assert want in twin(_load_error, data, tables)


def test_unreadable_tables_json_is_typed(tmp_path):
    (tmp_path / "dev.json").write_text(json.dumps([ROW]))
    msg = twin(_load_error, tmp_path / "dev.json", tmp_path / "no-tables.json")
    assert "cannot read Spider schemas" in msg


def test_spider_load_error_is_catchable_as_valueerror(tmp_path):
    def body(p):
        with pytest.raises(ValueError) as e:
            p.spider.load_spider(tmp_path / "nope.json")
        return type(e.value).__name__
    assert twin(body) == "SpiderLoadError"


def test_good_dataset_loads_with_schemas(tmp_path):
    data = tmp_path / "dev.json"
    data.write_text(json.dumps([ROW, dict(ROW, question="Names?")]))
    (tmp_path / "tables.json").write_text(json.dumps(TABLES))

    def body(p):
        cases = p.spider.load_spider(data)
        assert len(cases) == 2 and cases[0].nl == "How many singers?"
        assert "CREATE TABLE singer (singer_id int, name text);" in cases[0].schema_ddl
        assert p.spider.load_spider(data, limit=1) == cases[:1]
        return [(c.db_id, c.nl, c.expected_sql, c.schema_ddl) for c in cases]
    twin(body)


def test_missing_tables_json_means_empty_schema(tmp_path):
    (tmp_path / "dev.json").write_text(json.dumps([ROW]))

    def body(p):
        cases = p.spider.load_spider(tmp_path / "dev.json")
        assert cases[0].schema_ddl == ""
        return cases[0].nl
    twin(body)


def test_smoke_suite_ddl_instantiates():
    def body(p):
        rows = []
        for case in p.spider.SPIDER_SMOKE:
            b = p.repair.backend_for_ddl(case.schema_ddl)
            rows.append(len(b.execute(case.expected_sql).rows))
            b.close()
        return rows
    twin(body)


# ------------------------------------------------- the repair leg's twins


def test_evalh_repair_leg_injected_k2_beats_one_shot(counters):
    def body(p):
        svc = p.app.make_oracle_service()
        model = svc.models()[0]
        cases = p.spider.SPIDER_SMOKE[:6]
        injected = p.repair.run_repair_leg(svc, model, cases=cases, max_rounds=2,
                                           inject=True)
        assert injected["suite"] == "injected"
        assert injected["executable_after"][0] == 0.0
        assert injected["executable_after"][2] == 1.0
        clean = p.repair.run_repair_leg(svc, model, cases=cases, max_rounds=2,
                                        inject=False)
        assert clean["suite"] == "clean" and clean["executable_after"][0] == 1.0
        return (injected, clean, p.repair.format_repair_summary(injected),
                p.repair.format_repair_summary(clean))
    twin(body)


def test_evalh_repair_summary_formats(counters):
    rep = {"suite": "injected", "model": "m", "cases": 3, "max_rounds": 2,
           "executable_after": {0: 0.0, 1: 2 / 3, 2: 2 / 3},
           "per_case": [{"success_round": None, "error_class": "syntax", "nl": "q",
                         "sql": "s", "error": "e"}]}
    text = twin(lambda p: p.repair.format_repair_summary(rep))
    assert "one-shot" in text and "0.0%" in text and "unrepairable: 1" in text


# ----------------------------------------- tiny services through the bridge


@pytest.fixture(scope="module")
def tiny_pair():
    """JAX's tiny engine service and the port's over the same weights (the
    seed-0 SQL tree and the seed-1 mistral tree, bridged)."""
    jsvc = jax_app.make_tiny_service(8)
    weights = tuple(
        params_from_jax(jax.tree.map(np.asarray, jsvc._models[m].backend.engine.params),
                        device="cpu")
        for m in ("duckdb-nsql", "mistral"))
    tsvc = t_app.make_tiny_service(8, scheduler=False, device="cpu", weights=weights)
    yield {"jax": jsvc, "torch": tsvc}
    tsvc.close()
    jsvc.close()


def test_tiny_services_write_the_same_sql(tiny_pair):
    """Greedy SQL from both tiny services is equal, so the harness, the
    configs, the repair leg and the report print the same tables."""
    def body(p):
        svc = tiny_pair["jax" if p is P["jax"] else "torch"]
        return [svc.generate(m, c.nl, p.fixtures.TAXI_DDL_SYSTEM, 8).response
                for m in ("duckdb-nsql", "mistral") for c in p.fixtures.FOUR_QUERY_SUITE]
    outs = twin(body)
    assert any(outs)


def test_tiny_harness_summary_and_configs_as_jax(tiny_pair):
    def body(p):
        svc = tiny_pair["jax" if p is P["jax"] else "torch"]
        reports = p.harness.evaluate_models(
            svc, svc.models(), p.fixtures.FOUR_QUERY_SUITE, p.fixtures.TAXI_DDL_SYSTEM,
            max_new_tokens=8, exec_backend=p.report.make_taxi_exec_backend())
        explained = p.harness.explain_failures(svc, "llama3.2", reports["duckdb-nsql"],
                                               max_new_tokens=8)
        rows = {key: report_fields(p.configs.run_config(svc, cfg, max_new_tokens=8))
                for key, cfg in p.configs.CONFIGS.items()}
        return (norm(p.harness.format_summary(reports)),
                {m: report_fields(r) for m, r in reports.items()},
                report_fields(explained), rows)
    twin(body)


def test_tiny_repair_leg_as_jax(tiny_pair, counters):
    def body(p):
        svc = tiny_pair["jax" if p is P["jax"] else "torch"]
        cases = p.spider.SPIDER_SMOKE[:4]
        return [p.repair.format_repair_summary(p.repair.run_repair_leg(
            svc, "duckdb-nsql", cases=cases, max_rounds=1, inject=inject,
            max_new_tokens=8)) for inject in (False, True)]
    twin(body)


def test_tiny_report_as_jax(tiny_pair):
    def body(p):
        svc = tiny_pair["jax" if p is P["jax"] else "torch"]
        return norm(p.report.generate(
            svc, backend_desc="tiny", max_new_tokens=8, with_configs=True,
            quality_meaningful=False, timestamp="T",
            **({} if p is P["jax"] else {"device": "cpu"})))
    text = twin(body)
    assert "## BASELINE configs" in text and "platform: **cpu**" in text


def test_evalh_constrained_run_is_100_percent_grammar_valid():
    """tests/test_constrain.py's evalh case on both packages' tiny engines
    (max_seq 512, the same bridged weights): constrained output is 100%
    grammar-valid, unconstrained 0%, the schema grammar executes, and the
    generated SQL is JAX's."""
    import dataclasses

    import jax.numpy as jnp

    from llm_based_apache_spark_optimization_tpu.engine import InferenceEngine as JaxEngine
    from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
    from llm_based_apache_spark_optimization_tpu.models import init_params as jax_init
    from llm_based_apache_spark_optimization_tpu.serve.backends import (
        EngineBackend as JaxEngineBackend,
    )
    from llm_based_apache_spark_optimization_tpu.tokenizer import ByteTokenizer as JaxTok
    from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
    from llm_based_apache_spark_optimization_tpu_torch.models import TINY
    from llm_based_apache_spark_optimization_tpu_torch.serve.backends import EngineBackend
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

    jcfg = dataclasses.replace(JAX_TINY, max_seq_len=512)
    jp = jax_init(jcfg, jax.random.key(0), dtype=jnp.float32)
    tcfg = dataclasses.replace(TINY, max_seq_len=512)
    engines = {
        "jax": (JaxEngine(jcfg, jp, stop_ids=(jcfg.eos_id,), prompt_bucket=8), JaxTok(),
                JaxEngineBackend),
        "torch": (InferenceEngine(tcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                                        device="cpu"),
                                  stop_ids=(tcfg.eos_id,), prompt_bucket=8, device="cpu"),
                  ByteTokenizer(), EngineBackend),
    }

    def body(p):
        eng, tok, backend = engines["jax" if p is P["jax"] else "torch"]
        svc = p.Service()
        svc.register("duckdb-nsql", backend(eng, tok, max_new_tokens=48))
        exec_backend = p.report.make_taxi_exec_backend()
        kw = dict(max_new_tokens=48, exec_backend=exec_backend)
        suite, system = p.fixtures.FOUR_QUERY_SUITE, p.fixtures.TAXI_DDL_SYSTEM
        con = p.harness.evaluate_models(svc, ["duckdb-nsql"], suite, system,
                                        constrain="spark_sql", **kw)["duckdb-nsql"]
        assert con.grammar_valid_rate == 100.0
        unc = p.harness.evaluate_models(svc, ["duckdb-nsql"], suite, system,
                                        **kw)["duckdb-nsql"]
        assert unc.grammar_valid_rate == 0.0
        sch = p.harness.evaluate_models(
            svc, ["duckdb-nsql"], suite, system,
            constrain={"table": "taxi", "columns": list(p.fixtures.TAXI_COLUMNS)},
            **kw)["duckdb-nsql"]
        assert sch.grammar_valid_rate == 100.0 and sch.executable_rate == 100.0
        return [report_fields(r) for r in (con, unc, sch)]
    twin(body)


# ----------------------------------------------------------------- the CLIs


def test_cli_oracle_reads_100_percent(capsys):
    t_cli.main(["--backend", "oracle"])
    out = capsys.readouterr().out
    assert out.count("Exact Match Rate: 100.00%") == 3
    assert out.count("Execution Match Rate: 100.00%") == 3


def test_cli_repair_and_configs_as_jax(capsys):
    """`--repair` and `--configs` over the fake and oracle services print
    what JAX's CLI prints (apart from the wall-clock fields)."""
    for argv in (["--backend", "oracle", "--repair"], ["--backend", "fake", "--repair", "1"],
                 ["--backend", "fake", "--configs", "1-cpu-greedy", "4-spider-batch32-tp4"]):
        outs = []
        for cli in (jax_cli, t_cli):
            cli.main(argv + ["--cpu"])
            lines = capsys.readouterr().out.splitlines()
            outs.append([json.loads(ln) if ln.startswith("{") else ln for ln in lines])
        for rows in outs:
            for r in rows:
                if isinstance(r, dict):
                    r["avg_latency_s"] = r["aggregate_tok_per_s"] = None
        assert outs[1] == outs[0], argv


@pytest.mark.parametrize("argv,msg", [
    (["--constrain", "--backend", "fake"], "--constrain needs the in-tree decode loop"),
    (["--backend", "oracle", "--configs"], "--backend oracle proves the instrument"),
    (["--backend", "oracle", "--spider", "x.json"], "--backend oracle is the in-tree"),
    (["--backend", "fake", "--configs", "nope"], "unknown config 'nope'"),
    (["--backend", "fake", "--models", "ghost"], "unknown model(s) ['ghost']"),
    (["--backend", "fake", "--explain", "ghost"], "--explain model 'ghost'"),
    (["--backend", "fake", "--repair", "--configs"], "--repair is its own leg"),
], ids=["constrain-fake", "oracle-configs", "oracle-spider", "bad-config", "bad-model",
        "bad-explainer", "repair-configs"])
def test_cli_refusals_as_jax(argv, msg):
    """Each misuse exits with JAX's message."""
    msgs = []
    for cli in (jax_cli, t_cli):
        with pytest.raises(SystemExit) as e:
            cli.main(argv + ["--cpu"])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and msg in msgs[1]


def test_cli_parser_options_are_jax(monkeypatch, capsys):
    """Every option of JAX's parser, with its default and const, in the
    port's; the port's `--help` renders (JAX's trips on a bare `%`)."""
    import argparse

    class Parsed(Exception):
        pass

    def capture(self, argv=None, namespace=None):
        raise Parsed(self)

    def options(cli):
        with monkeypatch.context() as m:
            m.setattr(argparse.ArgumentParser, "parse_args", capture)
            with pytest.raises(Parsed) as e:
                cli.main([])
        return [(a.option_strings, a.default, a.const, a.nargs)
                for a in e.value.args[0]._actions]
    assert options(t_cli) == options(jax_cli)
    with pytest.raises(SystemExit):
        t_cli.main(["--help"])
    assert "--virtual-devices" in capsys.readouterr().out


def test_virtual_devices_refused_naming_a13(tmp_path):
    """`--virtual-devices N` is no longer refused: it runs the tiny
    backend's tp configs on N CPU ranks (tests/test_torch_parallel.py
    drives that group). The canned backends serve no model, so they form
    no group and run as before."""
    import torch.distributed as dist

    out = tmp_path / "report.md"
    t_report.main(["--backend", "fake", "--cpu", "--virtual-devices", "4",
                   "-o", str(out)])
    assert "| Config | Mesh |" in out.read_text()
    assert not dist.is_initialized()
    t_report.force_virtual_devices(0)


def test_tiny_backend_needs_a_card_without_cpu():
    """Without `--cpu` the tiny models and the chaos schedulers ask for a
    card and raise on a machine without one."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["--backend", "tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["--chaos"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_report.platform_desc(None)
    assert t_report.platform_desc("cpu") == "cpu"


def test_report_cli_oracle_names_the_platform(capsys, tmp_path):
    t_report.main(["--backend", "oracle", "--cpu", "-o", "-"])
    text = capsys.readouterr().out
    assert "· platform: **cpu**" in text
    assert "| Exact-match rate | 100.0 % | 100.0 % | 100.0 % |" in text
    out = tmp_path / "r.md"
    t_report.main(["--backend", "fake", "--cpu", "-o", str(out)])
    assert "## BASELINE configs" in out.read_text()

"""The port's app, front to back, on the CPU: the JSON, redirect and status
shapes of tests/test_app.py on the port's API and web frontends over
`FakeBackend`; the health, metrics and debug routes; the JAX app
and the port's app over their tiny contiguous schedulers, with the same
bridged weights, answering the same `POST /process-data/` with the same SQL
and the same error text; and the entry point refusing every option it
cannot honor."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from llm_based_apache_spark_optimization_tpu.app import AppConfig as JaxAppConfig
from llm_based_apache_spark_optimization_tpu.app import create_api_app as jax_api
from llm_based_apache_spark_optimization_tpu.app.__main__ import (
    make_tiny_service as jax_tiny_service,
)
from llm_based_apache_spark_optimization_tpu.history import (
    SQLiteHistory as JaxSQLiteHistory,
)
from llm_based_apache_spark_optimization_tpu.sql import SQLiteBackend as JaxSQLiteBackend
from llm_based_apache_spark_optimization_tpu_torch.app import (
    AppConfig,
    create_api_app,
    create_web_app,
    secure_filename,
)
from llm_based_apache_spark_optimization_tpu_torch.app import __main__ as entry
from llm_based_apache_spark_optimization_tpu_torch.constrain import is_valid_spark_sql
from llm_based_apache_spark_optimization_tpu_torch.convert import params_from_jax
from llm_based_apache_spark_optimization_tpu_torch.engine import InferenceEngine
from llm_based_apache_spark_optimization_tpu_torch.history import SQLiteHistory
from llm_based_apache_spark_optimization_tpu_torch.models import TINY
from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params
from llm_based_apache_spark_optimization_tpu_torch.serve import (
    EngineBackend,
    FakeBackend,
    GenerationService,
)
from llm_based_apache_spark_optimization_tpu_torch.sql import SQLiteBackend
from llm_based_apache_spark_optimization_tpu_torch.tokenizer import ByteTokenizer

CSV = "VendorID,passenger_count,total_amount\n1,2,12.5\n2,4,25.0\n1,3,18.0\n"
GOOD_SQL = "SELECT VendorID, SUM(total_amount) AS Total_Fare FROM temp_view GROUP BY VendorID"
BAD_SQL = "SELECT FROM nothing WHERE"
EXPLAIN = "The table or column does not exist; check the schema."


def make_service(sql=GOOD_SQL):
    svc = GenerationService()
    svc.register("duckdb-nsql", FakeBackend(lambda p: sql))
    svc.register("llama3.2", FakeBackend(lambda p: EXPLAIN))
    return svc


@pytest.fixture()
def cfg(tmp_path):
    (tmp_path / "input").mkdir()
    (tmp_path / "input" / "taxi.csv").write_text(CSV)
    return AppConfig(input_dir=str(tmp_path / "input"),
                     output_dir=str(tmp_path / "output"),
                     history_db=":memory:", secret_key="test-secret")


def api_client(cfg, sql=GOOD_SQL, history=None):
    return create_api_app(make_service(sql), SQLiteBackend,
                          history or SQLiteHistory(), cfg).test_client()


def web_client(cfg, sql=GOOD_SQL, history=None):
    return create_web_app(make_service(sql), SQLiteBackend,
                          history or SQLiteHistory(), cfg).test_client()


# ------------------------------------------------------------- API shapes

API_CASES = {
    "success": (GOOD_SQL, {"input_text": "total fare per vendor",
                           "file_name": "taxi.csv"}, 200),
    "missing_file": (GOOD_SQL, {"input_text": "q", "file_name": "nope.csv"}, 200),
    "sql_failure": (BAD_SQL, {"input_text": "q", "file_name": "taxi.csv"}, 200),
    "traversal_dotdot": (GOOD_SQL, {"input_text": "q", "file_name": "../secret.csv"}, 400),
    "traversal_abs": (GOOD_SQL, {"input_text": "q", "file_name": "/etc/passwd"}, 400),
    "traversal_nested": (GOOD_SQL, {"input_text": "q", "file_name": "a/../../b.csv"}, 400),
    "empty_name": (GOOD_SQL, {"input_text": "q", "file_name": ""}, 400),
}


@pytest.mark.parametrize("case", sorted(API_CASES))
def test_api_process_data_shapes(cfg, case):
    """POST /process-data/ answers the §2.2 shape of each outcome."""
    sql, payload, status = API_CASES[case]
    hist = SQLiteHistory()
    res = api_client(cfg, sql, hist).post_json("/process-data/", payload)
    assert res.status == status
    body = res.json()
    if case == "success":
        assert set(body) == {"message", "input_file_name", "input_data",
                             "sql_query", "output_file"}
        assert body["message"] == "Query executed successfully!"
        assert body["input_file_name"] == "taxi.csv" and body["sql_query"] == GOOD_SQL
        assert open(body["output_file"]).read().splitlines()[0] == "VendorID,Total_Fare"
        assert hist.count() == 1 and hist.page(1)[0][0].sql_query == GOOD_SQL
    elif case == "missing_file":
        assert set(body) == {"error"}
        assert body["error"].startswith("CSV file not found at ")
        assert body["error"].endswith("nope.csv")
    elif case == "sql_failure":
        assert body["error"] == "SQL execution failed"
        assert body["sql_query"] == BAD_SQL and body["error_details"] == EXPLAIN
        assert hist.count() == 0
    else:
        assert body == {"error": "invalid file name"}


@pytest.mark.parametrize("method,path,body,status", [
    ("POST", "/process-data/", b"not json", 400),
    ("GET", "/nope", b"", 404),
    ("GET", "/process-data/", b"", 405),
    # Served since the metrics layer was ported (ROADMAP A12).
    ("GET", "/metrics", b"", 200),
    ("GET", "/debug/flightrecorder", b"", 200),
    ("GET", "/debug/traces", b"", 200),
])
def test_api_status_codes(cfg, method, path, body, status):
    res = api_client(cfg).request(method, path, body, "application/json")
    assert res.status == status
    assert res.headers.get("X-Request-Id")


def test_api_generate_and_models(cfg):
    client = api_client(cfg)
    res = client.post_json("/api/generate", {"model": "duckdb-nsql", "prompt": "q"})
    assert res.status == 200
    assert res.json()["response"] == GOOD_SQL and res.json()["done"] is True
    lines = client.post_json("/api/generate", {"model": "duckdb-nsql", "prompt": "q",
                                               "stream": True}).text.splitlines()
    assert '"done": true' in lines[-1] and GOOD_SQL in lines[0]
    assert client.post_json("/api/generate", {"model": "x", "prompt": "q"}).status == 404
    assert client.post_json("/api/generate", {"model": "duckdb-nsql", "prompt": "q",
                                              "qos": "gold"}).status == 400
    # A constrain spec is served by a backend that supports it (a tiny
    # engine: the completion parses) and refused, 400, by a canned one.
    res = client.post_json("/api/generate", {"model": "duckdb-nsql", "prompt": "q",
                                             "constrain": "spark_sql"})
    assert res.status == 400 and "constrained decoding" in res.json()["error"]
    assert client.get("/models").json()["models"] == ["duckdb-nsql", "llama3.2"]
    svc = make_service()
    svc.register("tiny", EngineBackend(
        InferenceEngine(TINY, init_params(TINY, dtype=torch.float32, device="cpu"), stop_ids=(2,),
                        prompt_bucket=8, device="cpu"), ByteTokenizer(), max_new_tokens=40))
    tiny = create_api_app(svc, SQLiteBackend, SQLiteHistory(), cfg).test_client()
    for stream in (False, True):
        res = tiny.post_json("/api/generate", {
            "model": "tiny", "prompt": "q", "stream": stream,
            "constrain": {"table": "temp_view", "columns": ["VendorID"]}})
        assert res.status == 200
        text = "".join(json.loads(line).get("response", "") for line in res.text.splitlines())
        assert is_valid_spark_sql(text), text


def test_health_routes_and_drain_gate(cfg):
    svc = make_service()
    client = create_api_app(svc, SQLiteBackend, SQLiteHistory(), cfg).test_client()
    assert client.get("/healthz").json() == {"status": "ok"}
    ready = client.get("/readyz")
    assert ready.status == 200 and ready.json()["state"] == "ready"
    svc.drain(0)
    assert client.get("/readyz").status == 503
    res = client.post_json("/process-data/", {"input_text": "q", "file_name": "taxi.csv"})
    assert res.status == 503 and res.headers["Retry-After"]


def test_pipeline_runs_are_isolated_per_backend_factory(cfg):
    calls = []

    def factory():
        calls.append(1)
        return SQLiteBackend()

    client = create_api_app(make_service(), factory, SQLiteHistory(), cfg).test_client()
    for _ in range(2):
        client.post_json("/process-data/", {"input_text": "q", "file_name": "taxi.csv"})
    assert len(calls) == 2


# ------------------------------------------------------------- web shapes

def upload(client, content=CSV.encode()):
    return client.post_multipart("/process-data/", fields={"input_text": "q"},
                                 files={"file": ("taxi.csv", content)})


def test_web_index_css_and_upload_flow(cfg):
    web = web_client(cfg)
    assert web.get("/").status == 200 and "<form" in web.get("/").text
    css = web.get("/static/styles.css")
    assert css.status == 200 and css.headers["Content-Type"] == "text/css"
    assert web.get("/status").json() == {"status": "idle", "message": ""}
    assert upload(web).json() == {"redirect": "/show"}
    cookie = dict(web.cookies)
    assert web.get("/status").json() == {"status": "done", "message": "done"}
    assert web.cookies == cookie  # a read-only poll keeps the session
    show = web.get("/show")
    assert show.status == 200 and "taxi.csv" in show.text and "Total_Fare" in show.text
    other = web_client(cfg)  # sessions do not share status
    assert other.get("/status").json() == {"status": "idle", "message": ""}
    missing = web.post_multipart("/process-data/", fields={"input_text": "q"}, files={})
    assert missing.status == 400


def test_web_error_path_redirects_to_err_sol(cfg):
    client = web_client(cfg, BAD_SQL)
    redirect = upload(client).json()["redirect"]
    assert redirect.startswith("/err_sol?")
    assert "error_message=" in redirect and "err=" in redirect
    path, _, query = redirect.partition("?")
    page = client.request("GET", path, query=query)
    assert page.status == 200 and "Suggested solution" in page.text


def test_web_history_pagination(cfg):
    hist = SQLiteHistory()
    for i in range(10):
        hist.record(f"f{i}.csv", f"q{i}", f"SELECT {i};", f"o{i}.csv")
    client = web_client(cfg, history=hist)
    p1 = client.get("/history", query="page=1")
    assert "f9.csv" in p1.text and "Next" in p1.text
    p2 = client.get("/history", query="page=2")
    assert "f0.csv" in p2.text and "Next" not in p2.text and "Prev" in p2.text


def test_web_upload_reaches_the_backend_exactly(cfg):
    content = CSV + "\n"
    seen = {}

    class Capturing(SQLiteBackend):
        def load_csv(self, path, view_name="temp_view"):
            seen["bytes"] = Path(path).read_bytes()
            return super().load_csv(path, view_name)

    client = create_web_app(make_service(), Capturing, SQLiteHistory(), cfg).test_client()
    upload(client, content.encode())
    assert seen["bytes"] == content.encode()
    assert list(Path(cfg.input_dir).glob("*/*")) == []  # staging dir removed


def test_secure_filename():
    assert secure_filename("../../etc/passwd") == "etc_passwd"
    assert secure_filename("taxi data.csv") == "taxi_data.csv"
    assert secure_filename("") == "upload.csv"


def test_schema_inference_matches_jax(tmp_path):
    """The port's SQLite backend (Python inference pass only) gives the
    JAX backend's schema, so both prompt the model with the same text."""
    p = tmp_path / "t.csv"
    p.write_text("a,b,c,d,e\n1,2.5,2024-01-02,x,3000000000\n2,,2024-01-03 10:00,y,1\n")
    want = JaxSQLiteBackend().load_csv(str(p))
    got = SQLiteBackend().load_csv(str(p))
    assert got.prompt_lines() == want.prompt_lines()


# ------------------------------------------------- parity with the JAX app

def test_tiny_contiguous_app_matches_jax(tmp_path):
    """Both apps over their tiny contiguous schedulers with the same weights:
    random weights write failing SQL, so each request walks generate,
    execute, two repair rounds and the 3B explanation. The same SQL and the
    same error text come back, and both record no history row."""
    jsvc = jax_tiny_service(8, scheduler=True, supervise=False)
    try:
        weights = tuple(
            params_from_jax(jax.tree.map(np.asarray, jsvc._models[m].backend.scheduler.params),
                            device="cpu")
            for m in ("duckdb-nsql", "mistral"))
        tsvc = entry.make_tiny_service(8, device="cpu", weights=weights,
                                       supervise=False)
        try:
            sched = tsvc._models["duckdb-nsql"].backend.scheduler
            assert sched.kv_layout == "contiguous" and sched.num_slots == 8
            bodies = []
            for svc, app_fn, config, hist, sql in (
                    (jsvc, jax_api, JaxAppConfig, JaxSQLiteHistory, JaxSQLiteBackend),
                    (tsvc, create_api_app, AppConfig, SQLiteHistory, SQLiteBackend)):
                root = tmp_path / type(svc).__module__.split(".")[0]
                (root / "input").mkdir(parents=True)
                (root / "input" / "taxi.csv").write_text(CSV)
                c = config(input_dir=str(root / "input"), output_dir=str(root / "out"),
                           history_db=":memory:", max_new_tokens=8)
                history = hist()
                client = app_fn(svc, sql, history, c).test_client()
                bodies.append(client.post_json(
                    "/process-data/", {"input_text": "total fare per vendor",
                                       "file_name": "taxi.csv"}).json())
                assert history.count() == 0
            want, got = bodies
            assert got["error"] == want["error"] == "SQL execution failed"
            assert got["sql_query"] == want["sql_query"]
            assert got["error_details"] == want["error_details"]
        finally:
            tsvc.close()
    finally:
        jsvc.close()


# ------------------------------------------------------- the entry point

def args_for(*argv):
    return entry.build_parser().parse_args(list(argv))


@pytest.mark.parametrize("argv,item", [
    (("--tp", "2"), "A13"),
    (("--dp", "2", "--no-scheduler"), "A13"),
    (("--sp", "2"), "A13"),
])
def test_entry_point_refuses_unported_flags(argv, item, tmp_path):
    """The meshes of ROADMAP A13 are ported: `--tp`/`--sp` > 1, and `--dp`
    > 1 without `--scheduler` (the engine's dp mesh), parse and build a
    mesh over two gloo ranks, on which the entry point's tiny service
    serves each model's completion as one rank does. `--sp` with the
    scheduler exits with JAX's message (decode has no sequence to shard);
    with `--no-scheduler` it builds the sp mesh."""
    from torch_spmd import run_group

    assert item == "A13"
    argv = list(argv)
    if argv[0] == "--sp":
        args = args_for("--cpu", "--backend", "tiny", *argv)
        with pytest.raises(SystemExit, match="no sp axis"):
            entry.mesh_ranks(args, AppConfig())
        argv.append("--no-scheduler")
    flags = ["--cpu", "--backend", "tiny", *argv]
    base = entry.build_service(args_for(*[f for f in flags if f not in argv[:2]]),
                               AppConfig())
    try:
        want = [base.generate(m, "select count from taxi", max_new_tokens=6).response
                for m in ("duckdb-nsql", "mistral")]
    finally:
        base.close()
    (shape, texts), (shape1, _) = run_group(
        2, "app_cases", tmp_path,
        {"argv": flags, "prompt": "select count from taxi", "new": 6})
    assert shape == shape1 == {"dp": 1, "sp": 1, "tp": 1, argv[0][2:]: 2}
    assert texts == want


@pytest.mark.parametrize("extra", [(), ("--kv-int8",), ("--speculative", "3"),
                                   ("--kv-int8", "--speculative", "3")],
                         ids=["bf16", "int8", "speculative", "int8_speculative"])
def test_entry_point_serves_the_paged_engine_under_sp(extra, tmp_path):
    """`--sp 2 --no-scheduler --kv-layout paged` (ROADMAP A13.1) builds
    the sp mesh over two gloo ranks and its paged engines (the entry
    point's engines take `--kv-layout`; their pools whole on each sp rank)
    serve each model's completion as one rank's paged engines do, with
    int8 KV, speculation, and both, the combination JAX's exit points to;
    `--scheduler` with `--sp` still exits with JAX's message."""
    from torch_spmd import run_group

    with pytest.raises(SystemExit, match="no sp axis"):
        entry.mesh_ranks(args_for("--cpu", "--backend", "tiny", "--sp", "2",
                                  "--scheduler"), AppConfig())
    flags = ["--cpu", "--backend", "tiny", "--no-scheduler", "--kv-layout", "paged",
             *extra]
    base = entry.build_service(args_for(*flags), AppConfig())
    try:
        eng = base._models["duckdb-nsql"].backend.engine
        assert eng.kv_layout == "paged" and eng.speculative_draft == (
            3 if "--speculative" in extra else 0)
        want = [base.generate(m, "select count from taxi", max_new_tokens=6).response
                for m in ("duckdb-nsql", "mistral")]
    finally:
        base.close()
    (shape, texts), (shape1, _) = run_group(
        2, "app_cases", tmp_path,
        {"argv": [*flags, "--sp", "2"], "prompt": "select count from taxi", "new": 6})
    assert shape == shape1 == {"dp": 1, "sp": 2, "tp": 1}
    assert texts == want


@pytest.mark.parametrize("knob,value,item", [
    ("LSOT_SCALE_DOWN_Q", "1", "A11"),
    ("LSOT_FLEET_WORKERS", "localhost:9", "A11"),
    ("LSOT_SCALE_HOLD_S", "5", "A11"),
    ("LSOT_FLEET_MIN", "2", "A11"),
])
def test_entry_point_refuses_unported_knobs(monkeypatch, tmp_path, knob, value, item):
    """The elastic fleet's knobs (A11, serve/elastic.py) are ported: as in
    the JAX entry point they drive the autoscaler of the `--dp N
    --scheduler` pool (tests/test_torch_elastic.py) and are read without
    effect on the fake backend, which builds no pool, so they are no longer
    refused."""
    monkeypatch.setenv(knob, value)
    cfg = AppConfig.from_env(input_dir=str(tmp_path / "in"),
                             output_dir=str(tmp_path / "out"), history_db=":memory:")
    field = knob[len("LSOT_"):].lower()
    assert item == "A11" and field in _read_by_port()
    assert str(getattr(cfg, field)) != str(getattr(AppConfig(), field))
    svc = entry.build_service(args_for("--cpu"), cfg)
    assert not any(hasattr(e.backend, "autoscaler") for e in svc._models.values())
    create_api_app(svc, SQLiteBackend, SQLiteHistory(), cfg)


def test_entry_point_honours_constrain_sql(monkeypatch, tmp_path):
    """`LSOT_CONSTRAIN_SQL=1` builds an app whose pipeline compiles the
    uploaded CSV's schema into the SQL model's grammar: over the tiny CPU
    scheduler, `POST /process-data/` answers with SQL that parses and names
    only the view."""
    monkeypatch.setenv("LSOT_CONSTRAIN_SQL", "1")
    monkeypatch.setenv("LSOT_MAX_NEW_TOKENS", "40")
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "taxi.csv").write_text(CSV)
    cfg = AppConfig.from_env(input_dir=str(tmp_path / "in"),
                             output_dir=str(tmp_path / "out"), history_db=":memory:")
    assert cfg.constrain_sql
    svc = entry.build_service(args_for("--cpu", "--backend", "tiny", "--no-supervise"), cfg)
    try:
        client = create_api_app(svc, SQLiteBackend, SQLiteHistory(), cfg).test_client()
        body = client.post_json("/process-data/", {"input_text": "total fare per vendor",
                                                   "file_name": "taxi.csv"}).json()
        assert is_valid_spark_sql(body["sql_query"]), body
        assert "temp_view" in body["sql_query"].lower()
    finally:
        svc.close()


@pytest.mark.parametrize("env,attr,want", [
    ({"LSOT_KV_OVERCOMMIT": "0.5"}, "_kv_overcommit", 0.5),
    ({"LSOT_KV_SPILL": "1"}, "_kv_spill", True),
    ({"LSOT_KV_WATERMARK_LOW": "0.25", "LSOT_KV_WATERMARK_HIGH": "0.5"},
     "_wm_low_pages", 0.25),
    ({"LSOT_KV_WATERMARK_HIGH": "0.5"}, "_wm_high_pages", 0.5),
    ({"LSOT_MAX_QUEUE_DEPTH": "4"}, "max_queue_depth", 4),
    ({"LSOT_RAGGED": "1"}, "_ragged", True),
], ids=["overcommit", "spill", "watermark_low", "watermark_high", "queue_depth",
        "ragged"])
def test_entry_point_honours_scheduler_knobs(monkeypatch, tmp_path, env, attr, want):
    """The knobs of ROADMAP A7.3, A7.4 and A7.6 build a scheduler now: each
    tiny paged scheduler carries the value (a watermark as that share of
    its pool's pages), as the JAX entry point's does."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = AppConfig.from_env(input_dir=str(tmp_path / "in"),
                             output_dir=str(tmp_path / "out"), history_db=":memory:")
    svc = entry.build_service(args_for("--cpu", "--backend", "tiny", "--kv-layout",
                                       "paged", "--slots", "2", "--no-supervise"), cfg)
    try:
        sched = svc._models["duckdb-nsql"].backend.scheduler
        if attr.startswith("_wm_"):
            want = int(want * sched.page_stats["pages_total"])
        assert getattr(sched, attr) == want and want
    finally:
        svc.close()


@pytest.mark.parametrize("path", ["scheduler", "engine"])
def test_entry_point_serves_speculative(path):
    """`--speculative 3` builds speculative backends on both serving paths,
    each tiny scheduler (under the supervisor) or engine verifying 3 drafts
    a round, and a greedy completion equals the vanilla service's."""
    flags = ("--cpu", "--backend", "tiny", "--slots", "2") + (
        ("--no-scheduler",) if path == "engine" else ())
    texts = []
    for extra in (("--speculative", "3"), ()):
        svc = entry.build_service(args_for(*flags, *extra), AppConfig())
        try:
            backend = svc._models["duckdb-nsql"].backend
            if path == "scheduler":
                assert backend.scheduler._spec_draft == (3 if extra else 0)
            else:
                assert backend.engine.speculative_draft == (3 if extra else 0)
            texts.append(backend.complete("SELECT a FROM t", max_new_tokens=12).text)
            if extra and path == "scheduler":
                stats = backend.scheduler.speculation_stats
                assert stats["verify_rounds"] >= 1 and stats["tokens_delivered"] >= 1
            elif extra:
                assert backend.engine.last_spec_rounds >= 1
        finally:
            svc.close()
    assert texts[0] == texts[1]


def test_entry_point_refuses_int8_speculation_on_engines():
    """int8 KV with --speculative on an engine backend's contiguous cache
    exits, as the JAX entry point does; on the scheduler it serves."""
    with pytest.raises(SystemExit, match="cannot combine with --speculative"):
        entry.build_service(args_for("--cpu", "--backend", "tiny", "--no-scheduler",
                                     "--kv-int8", "--speculative", "3"), AppConfig())
    svc = entry.build_service(args_for("--cpu", "--backend", "tiny", "--kv-int8",
                                       "--speculative", "3", "--slots", "2"), AppConfig())
    try:
        sched = svc._models["duckdb-nsql"].backend.scheduler
        assert sched._spec_draft == 3 and sched._inner.kv_quant == "int8"
        assert svc._models["duckdb-nsql"].backend.complete(
            "SELECT", max_new_tokens=6).output_tokens >= 1
    finally:
        svc.close()


def test_entry_point_needs_a_card_without_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the refusal without one")
    for argv in ((), ("--backend", "tiny")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.build_service(args_for(*argv), AppConfig())


def test_entry_point_defaults_match_the_reference_app():
    """--scheduler on, --kv-layout contiguous and --supervise on, as in the
    JAX entry point: each tiny scheduler runs under the crash supervisor."""
    from llm_based_apache_spark_optimization_tpu_torch.serve.supervisor import (
        SupervisedScheduler,
    )

    args = args_for()
    assert args.scheduler and args.kv_layout == "contiguous" and args.supervise
    assert args.backend == "fake"
    svc = entry.build_service(args_for("--cpu", "--backend", "tiny", "--kv-int8",
                                       "--slots", "2"), AppConfig())
    try:
        sup = svc._models["llama3.2"].backend.scheduler
        assert isinstance(sup, SupervisedScheduler)
        sched = sup._inner
        assert (sched.kv_layout, sched.kv_quant, sched.num_slots) == ("contiguous", "int8", 2)
        assert svc._models["mistral"].backend.scheduler.cfg.sliding_window == 32
        assert svc.health()["state"] == "ready"
    finally:
        svc.close()
    svc = entry.build_service(args_for("--cpu", "--backend", "tiny", "--no-supervise"),
                              AppConfig())
    try:
        assert not isinstance(svc._models["llama3.2"].backend.scheduler,
                              SupervisedScheduler)
    finally:
        svc.close()


def test_entry_point_parser_defaults_equal_jax():
    """The port's parser has every option of the JAX entry point's, each
    with the JAX default (--supervise, --scheduler, --kv-layout, --slots,
    --kv-hbm-gb, ...)."""
    import argparse
    from unittest import mock

    from llm_based_apache_spark_optimization_tpu.app import __main__ as jax_entry

    seen = {}
    parse = argparse.ArgumentParser.parse_known_args

    def capture(self, args=None, namespace=None):
        seen["ns"] = parse(self, [], namespace)
        raise SystemExit(0)

    with mock.patch.object(argparse.ArgumentParser, "parse_known_args", capture):
        with pytest.raises(SystemExit):
            jax_entry.main([])
    jax_args = vars(seen["ns"][0])
    port_args = vars(args_for())
    assert {"supervise", "scheduler", "kv_layout", "slots", "backend",
            "max_new_tokens", "kv_hbm_gb"} <= set(jax_args)
    for name, default in jax_args.items():
        assert name in port_args, f"the port's parser lacks --{name.replace('_', '-')}"
        assert port_args[name] == default, name


def test_entry_point_kv_hbm_gb_sizes_the_checkpoint_pool(monkeypatch):
    """`--kv-layout paged --kv-hbm-gb 1` parses, and the checkpoint
    scheduler is built with a budget of 2**30 bytes (as JAX passes it);
    without the flag no budget is passed (the pool defaults to slots x
    max_seq pages)."""
    from llm_based_apache_spark_optimization_tpu_torch import tokenizer
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        SchedulerBackend,
    )

    seen = []

    class Built(Exception):
        pass

    def from_checkpoint(cls, load, tag, tok, **kwargs):
        seen.append(kwargs)
        raise Built

    monkeypatch.setattr(tokenizer, "HFTokenizer", lambda path: None)
    monkeypatch.setattr(SchedulerBackend, "_from_checkpoint",
                        classmethod(from_checkpoint))
    base = ("--cpu", "--backend", "checkpoint", "--sql-model-path", "ckpt",
            "--kv-layout", "paged")
    for extra in (("--kv-hbm-gb", "1"), ()):
        args = args_for(*base, *extra)
        assert args.kv_hbm_gb == (1.0 if extra else 0.0)
        with pytest.raises(Built):
            entry.build_service(args, AppConfig())
    assert seen[0]["kv_hbm_budget_bytes"] == 2**30
    assert seen[0]["kv_layout"] == "paged"
    assert "kv_hbm_budget_bytes" not in seen[1]


def _read_by_port():
    """AppConfig fields some module of the port reads, the config module
    itself aside: attribute reads off a config object (`cfg.field`,
    `app_cfg.field`, `self.config.field`) in the parsed code, so a field
    named only in a comment or a docstring does not count."""
    import ast

    root = Path(entry.__file__).resolve().parents[1]
    fields = set(AppConfig.__dataclass_fields__)
    read = set()
    for path in root.rglob("*.py"):
        if path == root / "app" / "config.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Attribute) and node.attr in fields
                    and ast.unparse(node.value).split(".")[-1]
                    in {"cfg", "app_cfg", "config"}):
                read.add(node.attr)
    return read


@pytest.mark.parametrize("field", sorted(AppConfig.__dataclass_fields__))
def test_every_app_config_field_is_read_or_refused(field):
    """Each AppConfig knob is honoured by the port: some module reads it,
    none is read into AppConfig and then ignored, and the entry point
    refuses none (the bench seed was the last it refused)."""
    assert field in _read_by_port()
    assert not hasattr(entry, "UNPORTED_KNOBS")


@pytest.mark.parametrize("knob,value,item", [
    ("LSOT_STOK_SEED_BENCH", "bench.jsonl", "A12"),
    ("LSOT_SCALE_UP_Q", "8", "A11"),
    ("LSOT_SCALE_INTERVAL_S", "9", "A11"),
    ("LSOT_FLEET_MAX", "4", "A11"),
])
def test_entry_point_refuses_inert_knobs(monkeypatch, tmp_path, knob, value, item):
    """No knob is refused any more. The bench seed (A12) is read where the
    JAX entry point reads it, by the checkpoint engine backends
    (`test_stok_seed_bench_seeds_the_engine_backend_as_jax`), and without
    effect elsewhere; the autoscaler's (A11) are honoured on the dp pool
    and, as in the JAX entry point, read without effect elsewhere; the
    remote replicas' are honoured (`test_entry_point_pool_remote_*`)."""
    monkeypatch.setenv(knob, value)
    cfg = AppConfig.from_env(input_dir=str(tmp_path / "in"),
                             output_dir=str(tmp_path / "out"), history_db=":memory:")
    field = knob[len("LSOT_"):].lower()
    assert item in ("A11", "A12") and field in _read_by_port()
    assert str(getattr(cfg, field)) != str(getattr(AppConfig(), field))
    entry.build_service(args_for("--cpu"), cfg).close()


def test_stok_seed_bench_seeds_the_engine_backend_as_jax(monkeypatch, tmp_path):
    """LSOT_STOK_SEED_BENCH gives the checkpoint engine backend the same
    deadline-clamp seed in both entry points (the artifact's B / value;
    None for a missing file), and LSOT_STOK_SEED wins over it in both."""
    import argparse

    from llm_based_apache_spark_optimization_tpu import tokenizer as jax_tokenizer
    from llm_based_apache_spark_optimization_tpu.app import __main__ as jax_entry
    from llm_based_apache_spark_optimization_tpu.serve import (
        EngineBackend as JaxEngineBackend,
    )
    from llm_based_apache_spark_optimization_tpu_torch import tokenizer
    from llm_based_apache_spark_optimization_tpu_torch.serve import EngineBackend

    bench = tmp_path / "bench.jsonl"
    bench.write_text("\n".join([json.dumps({"metric": "B=2", "value": 10.0}),
                                json.dumps({"metric": "decode tok/s B=8", "value": 64.0}),
                                "{torn"]))

    class Built(Exception):
        pass

    def spy(seen):
        def from_hf_checkpoint(cls, path, tok, **kwargs):
            seen.append(kwargs.get("sec_per_tok_seed"))
            raise Built
        return classmethod(from_hf_checkpoint)

    seen = {"jax": [], "torch": []}
    for mod in (jax_tokenizer, tokenizer):
        monkeypatch.setattr(mod, "HFTokenizer", lambda path: None)
    monkeypatch.setattr(JaxEngineBackend, "from_hf_checkpoint", spy(seen["jax"]))
    monkeypatch.setattr(EngineBackend, "from_hf_checkpoint", spy(seen["torch"]))
    args = args_for("--cpu", "--backend", "checkpoint", "--no-scheduler",
                    "--sql-model-path", "ckpt")
    for path, explicit in ((bench, ""), (tmp_path / "missing.jsonl", ""), (bench, "0.25")):
        monkeypatch.setenv("LSOT_STOK_SEED_BENCH", str(path))
        if explicit:
            monkeypatch.setenv("LSOT_STOK_SEED", explicit)
        else:
            monkeypatch.delenv("LSOT_STOK_SEED", raising=False)
        with pytest.raises(Built):
            jax_entry.make_checkpoint_service(argparse.Namespace(**vars(args)), 8)
        cfg = AppConfig.from_env(input_dir=str(tmp_path / "in"),
                                 output_dir=str(tmp_path / "out"), history_db=":memory:")
        with pytest.raises(Built):
            entry.build_service(args, cfg)
    assert seen["torch"] == seen["jax"] == [8 / 64.0, None, 0.25]


@pytest.mark.parametrize("knob,value", [
    ("LSOT_SLO_TTFT_MS", "250"),
    ("LSOT_SLO_TPOT_MS", "40"),
    ("LSOT_SLO_QUEUE_WAIT_MS", "100"),
    ("LSOT_SLO_WINDOW_S", "60"),
    ("LSOT_SLO_TARGET", "0.9"),
    ("LSOT_REQUEST_LOG", "0"),
    ("LSOT_FLIGHT_ROUNDS", "1024"),
    ("LSOT_PROFILE_ROUNDS", "4"),
    ("LSOT_PROFILE_DIR", "prof"),
    ("LSOT_PREFIX_TOPK", "8"),
    ("LSOT_PREFIX_RING", "64"),
])
def test_entry_point_honours_observability_knobs(monkeypatch, tmp_path, knob, value):
    """The observability knobs (ROADMAP A7.7, A7.8 and A12's metrics
    layer) are honoured: the service builds with each one set (each one's
    effect is checked in tests/test_torch_observability.py)."""
    monkeypatch.setenv(knob, value)
    cfg = AppConfig.from_env(input_dir=str(tmp_path / "in"),
                             output_dir=str(tmp_path / "out"), history_db=":memory:")
    try:
        entry.build_service(args_for("--cpu"), cfg).close()
    finally:
        entry.configure_observability(AppConfig())


TWO_TINY = "duckdb-nsql=tiny,hbm=0.75;llama3.2=tiny,hbm=0.25,template=llama3-chat,add_bos=0"


def _jax_fleet():
    from llm_based_apache_spark_optimization_tpu.serve.factory import (
        assemble_multimodel_service,
    )

    return assemble_multimodel_service(JaxAppConfig.from_env().models,
                                       max_new_tokens=32, num_slots=8)


def _admission_view(adm):
    return (adm.enabled, adm.buckets.rate_base, adm.buckets.burst_base,
            {c: adm.default_deadline(c) for c in ("interactive", "batch", "replay")})


def _knob_effect(knob, svc, jax_side):
    """What `knob` changed, read from the port's service `svc` or (with
    `jax_side`) from the JAX package's objects built from the same
    environment, as the JAX entry point builds them."""
    from llm_based_apache_spark_optimization_tpu.serve import qos as jax_qos
    from llm_based_apache_spark_optimization_tpu.serve.scheduler import (
        ContinuousBatchingScheduler as JaxScheduler,
    )
    from llm_based_apache_spark_optimization_tpu.serve.service import (
        GenerationService as JaxService,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.qos import ADMISSION

    if knob in ("LSOT_MODELS", "LSOT_REPLICA_WEIGHTS"):
        if jax_side:
            svc, pool, _ = _jax_fleet()
        else:
            pool = svc._models["duckdb-nsql"].backend.scheduler
        try:
            pages = {r["model"]: r["kv_pages_total"] for r in pool.model_stats()["models"]}
            return svc.models(), pages, pool.routing_stats()["weights"]
        finally:
            if jax_side:
                svc.close()
    if knob == "LSOT_TENANT_MODELS":
        if jax_side:
            svc = JaxService()
            for m in ("duckdb-nsql", "llama3.2", "mistral"):
                svc.register(m, FakeBackend(lambda p: ""))
        return svc.resolve_model("duckdb-nsql", "a"), svc.resolve_model("duckdb-nsql", "b")
    if knob in ("LSOT_QOS", "LSOT_TENANT_WEIGHTS"):
        if jax_side:
            from llm_based_apache_spark_optimization_tpu.models import TINY as JAX_TINY
            from llm_based_apache_spark_optimization_tpu.models import init_params as jinit

            sched = JaxScheduler(JAX_TINY, jinit(JAX_TINY, jax.random.key(0)))
            jax_qos.ADMISSION.reconfigure()
            adm = jax_qos.ADMISSION
        else:
            sched, adm = svc._models["duckdb-nsql"].backend.scheduler, ADMISSION
        return sched._qos, sched._tenant_weights, adm.enabled
    if jax_side:
        jax_qos.ADMISSION.reconfigure()
        return _admission_view(jax_qos.ADMISSION)
    return _admission_view(ADMISSION)


@pytest.fixture()
def restore_admission():
    """Both packages' front doors back to the environment's settings once
    the test's own environment is undone (request this before
    `monkeypatch`)."""
    from llm_based_apache_spark_optimization_tpu.serve import qos as jax_qos
    from llm_based_apache_spark_optimization_tpu_torch.serve.qos import ADMISSION

    yield
    ADMISSION.reconfigure()
    jax_qos.ADMISSION.reconfigure()


@pytest.mark.parametrize("knob,value,effect", [
    ("LSOT_MODELS", TWO_TINY,
     lambda g: g[0] == ["duckdb-nsql", "llama3.2"]
     and g[1]["duckdb-nsql"] == 3 * g[1]["llama3.2"]),
    ("LSOT_TENANT_MODELS", "a=llama3.2,b=nope",
     lambda g: g == ("llama3.2", "duckdb-nsql")),
    ("LSOT_REPLICA_WEIGHTS", "2,1", lambda g: g[2] == [2.0, 1.0]),
    ("LSOT_QOS", "0", lambda g: g == (False, {}, False)),
    ("LSOT_TENANT_RATE", "2,interactive=4", lambda g: g[1] == 2.0),
    ("LSOT_TENANT_BURST", "4", lambda g: g[2] == 4.0),
    ("LSOT_TENANT_WEIGHTS", "a=2,b=0.5", lambda g: g[1] == {"a": 2.0, "b": 0.5}),
    ("LSOT_QOS_DEADLINE_INTERACTIVE", "2", lambda g: g[3]["interactive"] == 2.0),
    ("LSOT_QOS_DEADLINE_BATCH", "20", lambda g: g[3]["batch"] == 20.0),
    ("LSOT_QOS_DEADLINE_REPLAY", "30", lambda g: g[3]["replay"] == 30.0),
], ids=lambda x: x if isinstance(x, str) and x.startswith("LSOT_") else "")
def test_entry_point_honours_fleet_and_qos_knobs(restore_admission, monkeypatch,
                                                 tmp_path, knob, value, effect):
    """The multi-model pool's and the QoS front door's knobs are honoured,
    with the effect the JAX entry point gives them: the models registered
    over one pool and its partition of the arena (`LSOT_MODELS`, with
    `LSOT_REPLICA_WEIGHTS` the pool's weights), a tenant's pinned model,
    the schedulers' WFQ switch and weights, and the front door's buckets
    and per-class deadlines."""
    monkeypatch.setenv(knob, value)
    if knob == "LSOT_REPLICA_WEIGHTS":
        monkeypatch.setenv("LSOT_MODELS", TWO_TINY)
    cfg = AppConfig.from_env(input_dir=str(tmp_path / "in"),
                             output_dir=str(tmp_path / "out"), history_db=":memory:")
    svc = entry.build_service(args_for("--cpu", "--backend", "tiny", "--no-supervise"), cfg)
    try:
        got = _knob_effect(knob, svc, jax_side=False)
    finally:
        svc.close()
    assert effect(got), got
    assert got == _knob_effect(knob, None, jax_side=True)


def test_app_config_qos_defaults_on_as_jax():
    assert AppConfig().qos is True and JaxAppConfig().qos is True


def test_healthz_fleet_keys_equal_jax(tmp_path, monkeypatch):
    """/healthz over the two-model tiny fleet carries `fleet` (each
    replica's lifecycle) and `fleet_membership` with JAX's keys."""
    from llm_based_apache_spark_optimization_tpu_torch.serve.factory import (
        assemble_multimodel_service,
    )

    monkeypatch.setenv("LSOT_MODELS", TWO_TINY)
    cfg = AppConfig(input_dir=str(tmp_path), output_dir=str(tmp_path), history_db=":memory:")
    jcfg = JaxAppConfig(input_dir=str(tmp_path), output_dir=str(tmp_path), history_db=":memory:")
    tsvc = assemble_multimodel_service(TWO_TINY, num_slots=2, device="cpu")[0]
    jsvc = _jax_fleet()[0]
    try:
        bodies = [create_api_app(tsvc, SQLiteBackend, SQLiteHistory(), cfg).test_client()
                  .get("/healthz").json(),
                  jax_api(jsvc, JaxSQLiteBackend, JaxSQLiteHistory(), jcfg).test_client()
                  .get("/healthz").json()]
    finally:
        tsvc.close()
        jsvc.close()

    def keys(body):
        return ({m: [sorted(r) for r in reps] for m, reps in body["fleet"].items()},
                {m: sorted(v) for m, v in body["fleet_membership"].items()},
                {m: [(r["replica"], r["state"], r["model_id"]) for r in reps]
                 for m, reps in body["fleet"].items()})

    assert keys(bodies[0]) == keys(bodies[1])
    assert bodies[0]["fleet"]["duckdb-nsql"][1]["model_id"] == "llama3.2"


def test_prometheus_text_of_a_two_model_two_tenant_snapshot_equals_jax(restore_admission):
    """The port's /metrics snapshot after two tenants' requests on the
    two-model tiny fleet, rendered by the port and by the JAX package: the
    same text byte for byte, with the lsot_model_* and lsot_tenant_*
    families and each model's partitioned pages."""
    from llm_based_apache_spark_optimization_tpu.utils.prometheus import (
        render_prometheus as jax_render,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.factory import (
        assemble_multimodel_service,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.qos import ADMISSION
    from llm_based_apache_spark_optimization_tpu_torch.utils.prometheus import (
        render_prometheus,
    )

    ADMISSION.reconfigure(enabled=True, rate="batch=100", burst="")
    svc, pool, _ = assemble_multimodel_service(TWO_TINY, num_slots=2, device="cpu")
    try:
        for model, tenant, qos in (("duckdb-nsql", "storm", "batch"),
                                   ("duckdb-nsql", "quiet", "interactive"),
                                   ("llama3.2", "storm", "batch")):
            svc.generate(model, "total fare per vendor", max_new_tokens=6,
                         tenant=tenant, qos=qos)
        snap = svc.metrics_snapshot()
    finally:
        svc.close()
    text = render_prometheus(snap)
    assert text == jax_render(snap)
    assert 'lsot_model_replicas{model="duckdb-nsql",served_model="llama3.2"} 1' in text
    assert 'lsot_tenant_admitted_total{qos="interactive",tenant="quiet"} 1' in text
    assert 'lsot_tenant_submitted_total{' in text
    pages = {r["model"]: r["kv_pages_total"]
             for r in snap["duckdb-nsql"]["serving"]["models"]["models"]}
    assert pages["duckdb-nsql"] == 3 * pages["llama3.2"]


def test_journal_spill_knob_names_a_file_per_model(monkeypatch, tmp_path):
    """LSOT_JOURNAL_SPILL is served now: each supervised tiny scheduler
    spills to its own file, and a drain writes keyed in-flight work there."""
    monkeypatch.setenv("LSOT_JOURNAL_SPILL", str(tmp_path / "spill"))
    monkeypatch.setattr(entry, "_SPILL_TAGS", {})
    cfg = AppConfig.from_env(input_dir=str(tmp_path / "in"),
                             output_dir=str(tmp_path / "out"), history_db=":memory:")
    svc = entry.build_service(args_for("--cpu", "--backend", "tiny"), cfg)
    paths = {m: svc._models[m].backend.scheduler.spill_path
             for m in ("duckdb-nsql", "llama3.2", "mistral")}
    assert paths["duckdb-nsql"] == str(tmp_path / "spill") + ".duckdb-nsql.jsonl"
    assert len(set(paths.values())) == 3
    svc.drain(0)
    assert svc.health()["draining"]


@pytest.mark.parametrize("fmt", ["hf", "gguf"])
def test_entry_point_serves_a_checkpoint_on_the_cpu(tmp_path, fmt):
    """`--cpu --backend checkpoint --api` over an HF directory and over
    `X.gguf:TOKDIR`: supervised schedulers by default, /readyz ready, and
    `POST /process-data/` answers 200 through the reference pipeline."""
    import dataclasses

    import torch
    from test_torch_tokenizer import write_tokenizer_json

    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import (
        save_hf_checkpoint,
        write_gguf,
    )
    from llm_based_apache_spark_optimization_tpu_torch.models import TINY
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params
    from llm_based_apache_spark_optimization_tpu_torch.serve.supervisor import (
        SupervisedScheduler,
    )

    pytest.importorskip("tokenizers")
    mcfg = dataclasses.replace(TINY, max_seq_len=2048)
    params = init_params(mcfg, torch.Generator().manual_seed(0), torch.float32,
                         device="cpu")
    tokdir = tmp_path / "ckpt"
    save_hf_checkpoint(mcfg, params, tokdir)
    write_tokenizer_json(tokdir / "tokenizer.json", "wordlevel")
    src = str(tokdir)
    if fmt == "gguf":
        write_gguf(mcfg, params, tmp_path / "m.gguf", quant="q8_0")
        src = f"{tmp_path / 'm.gguf'}:{tokdir}"
    (tmp_path / "input").mkdir()
    (tmp_path / "input" / "taxi.csv").write_text(CSV)
    cfg = AppConfig(input_dir=str(tmp_path / "input"), output_dir=str(tmp_path / "out"),
                    history_db=":memory:", max_new_tokens=8)
    svc = entry.build_service(args_for("--cpu", "--backend", "checkpoint", "--api",
                                       "--sql-model-path", src,
                                       "--max-new-tokens", "8"), cfg)
    try:
        sql = svc._models["duckdb-nsql"].backend
        assert isinstance(sql.scheduler, SupervisedScheduler)
        assert svc._models["llama3.2"].backend.scheduler is sql.scheduler
        client = create_api_app(svc, SQLiteBackend, SQLiteHistory(), cfg).test_client()
        ready = client.get("/readyz")
        assert ready.status == 200 and ready.json()["state"] == "ready"
        res = client.post_json("/process-data/", {"input_text": "total fare per vendor",
                                                  "file_name": "taxi.csv"})
        assert res.status == 200 and "sql_query" in res.json()
    finally:
        svc.close()


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_entry_point_serves_the_lsot_models_checkpoint_fleet(tmp_path, monkeypatch, int8):
    """`LSOT_MODELS` with `--cpu --backend checkpoint`: `duckdb-nsql` from an
    HF directory on two replicas and `llama3.2` from a GGUF blob, one
    supervised pool sized by `--kv-hbm-gb` and split by the specs' `hbm`
    shares (`--int8` quantizes both trees): /readyz ready, `POST
    /process-data/` and an explanation on `/api/generate` answer 200,
    /healthz carries the three replicas and their models. `--int4` and
    `tiny` sources exit, as in the JAX entry point."""
    import dataclasses

    import torch
    from test_torch_tokenizer import write_tokenizer_json

    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import (
        save_hf_checkpoint,
        write_gguf,
    )
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import is_qtensor

    pytest.importorskip("tokenizers")
    mcfg = dataclasses.replace(TINY, max_seq_len=2048)
    trees = [init_params(mcfg, torch.Generator().manual_seed(s), torch.float32,
                         device="cpu") for s in (0, 1)]
    tokdir = tmp_path / "ckpt"
    save_hf_checkpoint(mcfg, trees[0], tokdir)
    write_tokenizer_json(tokdir / "tokenizer.json", "wordlevel")
    write_gguf(mcfg, trees[1], tmp_path / "m.gguf", quant="q8_0")
    monkeypatch.setenv("LSOT_MODELS", (
        f"duckdb-nsql=hf:{tokdir},hbm=0.75,replicas=2;"
        f"llama3.2=gguf:{tmp_path / 'm.gguf'}:{tokdir},hbm=0.25,template=llama3-chat,"
        f"add_bos=0"))
    (tmp_path / "input").mkdir()
    (tmp_path / "input" / "taxi.csv").write_text(CSV)
    cfg = AppConfig.from_env(input_dir=str(tmp_path / "input"),
                             output_dir=str(tmp_path / "out"), history_db=":memory:",
                             max_new_tokens=8)
    argv = ["--cpu", "--backend", "checkpoint", "--api", "--sql-model-path", str(tokdir),
            "--kv-layout", "paged", "--kv-hbm-gb", "0.001", "--max-new-tokens", "8"]
    svc = entry.build_service(args_for(*argv, *(["--int8"] if int8 else [])), cfg)
    try:
        sup = svc._models["duckdb-nsql"].backend.scheduler
        assert svc._models["llama3.2"].backend.scheduler is sup
        pool = sup._inner
        assert [s.model_id for s in pool.schedulers] == ["duckdb-nsql", "duckdb-nsql",
                                                          "llama3.2"]
        assert pool.schedulers[0].params is pool.schedulers[1].params
        assert is_qtensor(pool.schedulers[2].params["blocks"]["wd"]) == int8
        pages = [s.page_stats["pages_total"] * s.page_stats["page_bytes"]
                 for s in pool.schedulers]
        assert pages[0] == pages[1] and pages[2] < pages[0] <= 0.75 * 2**30 * 0.001
        client = create_api_app(svc, SQLiteBackend, SQLiteHistory(), cfg).test_client()
        assert client.get("/readyz").json()["state"] == "ready"
        res = client.post_json("/process-data/", {"input_text": "total fare per vendor",
                                                  "file_name": "taxi.csv"})
        assert res.status == 200 and "sql_query" in res.json()
        explained = client.post_json("/api/generate", {"model": "llama3.2",
                                                       "prompt": "why did it fail?"})
        assert explained.status == 200 and explained.json()["done"]
        fleet = client.get("/healthz").json()["fleet"]
        assert [(r["replica"], r["model_id"]) for r in fleet["llama3.2"]] == [
            ("r0", "duckdb-nsql"), ("r1", "duckdb-nsql"), ("r2", "llama3.2")]
        assert {p["to"] for p in pool.flight_snapshot() if p.get("kind") == "placement"
                and p.get("model") == "llama3.2"} == {"r2"}
    finally:
        svc.close()
    with pytest.raises(SystemExit, match="--int4"):
        entry.build_service(args_for(*argv, "--int4"), cfg)
    monkeypatch.setenv("LSOT_MODELS", "duckdb-nsql=tiny")
    with pytest.raises(SystemExit, match="source 'tiny'"):
        entry.build_service(args_for(*argv), AppConfig.from_env(history_db=":memory:"))


@pytest.mark.parametrize("serving", ["scheduler", "engine"])
def test_entry_point_serves_int8_weights_and_tables(tmp_path, serving):
    """`--cpu --backend checkpoint --api --int8 --int8-unembed` over a TINY
    HF checkpoint: the model's tree holds int8 block weights and an int8
    table, /readyz is ready (scheduler) and `POST /process-data/` answers
    200 through the reference pipeline."""
    import dataclasses

    import torch
    from test_torch_tokenizer import write_tokenizer_json

    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import save_hf_checkpoint
    from llm_based_apache_spark_optimization_tpu_torch.models import TINY
    from llm_based_apache_spark_optimization_tpu_torch.models.llama import init_params
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import is_qtensor

    pytest.importorskip("tokenizers")
    mcfg = dataclasses.replace(TINY, max_seq_len=2048)
    params = init_params(mcfg, torch.Generator().manual_seed(0), torch.float32,
                         device="cpu")
    tokdir = tmp_path / "ckpt"
    save_hf_checkpoint(mcfg, params, tokdir)
    write_tokenizer_json(tokdir / "tokenizer.json", "wordlevel")
    (tmp_path / "input").mkdir()
    (tmp_path / "input" / "taxi.csv").write_text(CSV)
    cfg = AppConfig(input_dir=str(tmp_path / "input"), output_dir=str(tmp_path / "out"),
                    history_db=":memory:", max_new_tokens=8)
    extra = () if serving == "scheduler" else ("--no-scheduler",)
    svc = entry.build_service(args_for("--cpu", "--backend", "checkpoint", "--api",
                                       "--int8", "--int8-unembed", *extra,
                                       "--sql-model-path", str(tokdir),
                                       "--max-new-tokens", "8"), cfg)
    try:
        sql = svc._models["duckdb-nsql"].backend
        tree = (sql.scheduler._inner.params if serving == "scheduler"  # supervised
                else sql.engine.params)
        assert is_qtensor(tree["blocks"]["wq"]) and is_qtensor(tree["blocks"]["wd"])
        assert is_qtensor(tree["embed"])
        client = create_api_app(svc, SQLiteBackend, SQLiteHistory(), cfg).test_client()
        if serving == "scheduler":
            ready = client.get("/readyz")
            assert ready.status == 200 and ready.json()["state"] == "ready"
        res = client.post_json("/process-data/", {"input_text": "total fare per vendor",
                                                  "file_name": "taxi.csv"})
        assert res.status == 200 and "sql_query" in res.json()
    finally:
        svc.close()


def test_entry_point_int8_with_int4_exits_as_jax():
    """`--int8 --int4` exits with the JAX entry point's message."""
    import inspect

    from llm_based_apache_spark_optimization_tpu.app import __main__ as jax_entry

    msg = "pick one of --int8 / --int4"
    assert f'sys.exit("{msg}")' in inspect.getsource(jax_entry)
    with pytest.raises(SystemExit, match=msg):
        entry.build_service(args_for("--cpu", "--backend", "checkpoint", "--int8",
                                     "--int4", "--sql-model-path", "ckpt"), AppConfig())


@pytest.mark.parametrize("argv,want", [
    ((), dict(quantize_int8=False, quantize_int4=False, quantize_unembed8=False)),
    (("--int8", "--int8-unembed"),
     dict(quantize_int8=True, quantize_int4=False, quantize_unembed8=True)),
    (("--int4", "--int8-unembed"),
     dict(quantize_int8=False, quantize_int4=True, quantize_unembed8=True)),
], ids=["bf16", "int8", "int4"])
@pytest.mark.parametrize("serving", ["scheduler", "engine"])
def test_entry_point_passes_weight_formats_to_the_loaders(monkeypatch, argv, want,
                                                           serving):
    """The weight-format flags reach the checkpoint constructors of both
    serving paths as JAX passes them."""
    from llm_based_apache_spark_optimization_tpu_torch import tokenizer
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        SchedulerBackend,
    )

    seen = []

    class Built(Exception):
        pass

    def sched_from_checkpoint(cls, load, tag, tok, **kwargs):
        seen.append(kwargs)
        raise Built

    def engine_from_checkpoint(cls, load, tok, **kwargs):
        seen.append(kwargs)
        raise Built

    monkeypatch.setattr(tokenizer, "HFTokenizer", lambda path: None)
    monkeypatch.setattr(SchedulerBackend, "_from_checkpoint",
                        classmethod(sched_from_checkpoint))
    monkeypatch.setattr(EngineBackend, "_from_checkpoint",
                        classmethod(engine_from_checkpoint))
    extra = () if serving == "scheduler" else ("--no-scheduler",)
    with pytest.raises(Built):
        entry.build_service(args_for("--cpu", "--backend", "checkpoint",
                                     "--sql-model-path", "ckpt", *extra, *argv),
                            AppConfig())
    assert {k: seen[0][k] for k in want} == want


def test_entry_point_gguf_needs_a_tokenizer_dir(tmp_path):
    with pytest.raises(SystemExit):
        entry.build_service(args_for("--cpu", "--backend", "checkpoint",
                                     "--sql-model-path", str(tmp_path / "m.gguf")),
                            AppConfig())
    with pytest.raises(SystemExit):
        entry.build_service(args_for("--cpu", "--backend", "checkpoint"), AppConfig())


# ------------------------------------- the dp pool and LSOT_POOL_PHASES

@pytest.fixture()
def tiny_hf_dir(tmp_path):
    """A TINY HF checkpoint (f32 on disk, a 2048-token context) with a
    WordLevel tokenizer.json, written by the port's writer: both entry
    points load it."""
    import dataclasses

    from test_torch_tokenizer import write_tokenizer_json

    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import save_hf_checkpoint

    pytest.importorskip("tokenizers")
    mcfg = dataclasses.replace(TINY, max_seq_len=2048)
    params = init_params(mcfg, torch.Generator().manual_seed(0), torch.float32,
                         device="cpu")
    ckpt = tmp_path / "ckpt"
    save_hf_checkpoint(mcfg, params, ckpt)
    write_tokenizer_json(ckpt / "tokenizer.json", "wordlevel")
    return ckpt


def dp_argv(ckpt, *extra):
    return ("--cpu", "--backend", "checkpoint", "--sql-model-path", str(ckpt), "--dp",
            "2", "--slots", "2", "--max-new-tokens", "8", *extra)


def port_exit(argv, cfg=None):
    """The port entry point's SystemExit message for `argv`."""
    with pytest.raises(SystemExit) as e:
        entry.build_service(args_for(*argv),
                            cfg or AppConfig.from_env(history_db=":memory:"))
    return str(e.value)


def jax_exit(argv):
    """The JAX entry point's message for the same options (its checkpoint
    service reads the same environment)."""
    import argparse

    from llm_based_apache_spark_optimization_tpu.app import __main__ as jax_entry

    with pytest.raises(SystemExit) as e:
        jax_entry.make_checkpoint_service(argparse.Namespace(**vars(args_for(*argv))), 8)
    return str(e.value)


def test_entry_point_dp_pool_phase_split_matches_jax(tiny_hf_dir, monkeypatch):
    """`--dp 2 --scheduler --kv-layout paged` with
    `LSOT_POOL_PHASES=prefill:1,decode:1` over one HF checkpoint: each
    entry point builds a supervised pool of a prefill and a decode
    replica from one load; the same requests, one at a time, land on the
    prefill replica and hand off to the decode one in both, with the same
    handoff counts and the same greedy text and tokens."""
    import argparse

    from llm_based_apache_spark_optimization_tpu.app import __main__ as jax_entry
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        SchedulerPool,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.supervisor import (
        SupervisedScheduler,
    )

    monkeypatch.setenv("LSOT_POOL_PHASES", "prefill:1,decode:1")
    argv = dp_argv(tiny_hf_dir, "--kv-layout", "paged")
    questions = ["select vendor", "select fare from vendor", "select count"]
    seen = {}
    for side in ("jax", "torch"):
        if side == "jax":
            svc = jax_entry.make_checkpoint_service(
                argparse.Namespace(**vars(args_for(*argv))), 8)
        else:
            svc = entry.build_service(args_for(*argv),
                                      AppConfig.from_env(history_db=":memory:"))
        try:
            sup = svc._models["duckdb-nsql"].backend.scheduler
            pool = sup._inner
            assert svc._models["llama3.2"].backend.scheduler is sup
            if side == "torch":
                assert isinstance(sup, SupervisedScheduler)
                assert isinstance(pool, SchedulerPool)
                assert pool.schedulers[0].params is pool.schedulers[1].params
                assert [s.device.type for s in pool.schedulers] == ["cpu", "cpu"]
            outs = [svc.generate("duckdb-nsql", q, system="from fare") for q in questions]
            snap = pool.flight_snapshot()
            seen[side] = dict(
                roles=[s.phase_role for s in pool.schedulers],
                placements=[r["to"] for r in snap if r.get("kind") == "placement"],
                handoffs=[(r["to"], r["src"]) for r in snap
                          if r.get("kind") == "handoff_place"],
                counts={r["replica"]: (r["exports"], r["imports"], r["inplace_fallbacks"],
                                       r["pages_out"], r["pages_in"])
                        for r in pool.handoff_stats["replicas"]},
                outs=[(o.response, o.output_tokens) for o in outs],
                # /metrics' serving.handoff block and /healthz's fleet rows.
                served={r["replica"]: (r["phase_role"], r["exports"], r["imports"])
                        for r in svc.metrics_snapshot()["duckdb-nsql"]["serving"]
                        ["handoff"]["replicas"]},
                fleet=[(r["replica"], r["phase_role"], r["state"])
                       for r in svc.fleet_health()["duckdb-nsql"]],
                membership=sorted(svc.fleet_membership()["duckdb-nsql"]))
        finally:
            svc.close()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"]["roles"] == ["prefill", "decode"]
    assert seen["torch"]["placements"] == ["r0"] * 3
    assert seen["torch"]["handoffs"] == [("r1", "r0")] * 3


@pytest.mark.parametrize("env,extra", [
    ({"LSOT_POOL_PHASES": "prefill:1,decode:1"}, ("--dp", "1")),
    ({"LSOT_POOL_PHASES": "prefill:1,decode:1"}, ("--kv-layout", "contiguous")),
    ({"LSOT_POOL_PHASES": "prefil:1,decode:1"}, ("--kv-layout", "paged")),
    ({"LSOT_POOL_PHASES": "prefill:1,decode:2"}, ("--kv-layout", "paged")),
    ({"LSOT_POOL_PHASES": "prefill:2"}, ("--kv-layout", "paged")),
    ({"LSOT_POOL_PHASES": "prefill:1,decode:1", "LSOT_MODELS": "duckdb-nsql=hf:{ckpt}"},
     ("--kv-layout", "paged")),
], ids=["no-dp", "contiguous", "bad-role", "bad-count", "prefill-only", "with-models"])
def test_entry_point_pool_phases_refusals_as_jax(tiny_hf_dir, monkeypatch, env, extra):
    """Each misuse of `LSOT_POOL_PHASES` exits with the JAX entry point's
    message, before a checkpoint is read: without `--dp > 1`, on the
    contiguous layout, a bad spec, and combined with `LSOT_MODELS`."""
    for k, v in env.items():
        monkeypatch.setenv(k, v.format(ckpt=tiny_hf_dir))
    argv = dp_argv(tiny_hf_dir, *extra)
    msg = port_exit(argv)
    assert msg == jax_exit(argv)
    assert "LSOT_POOL_PHASES" in msg


def test_entry_point_dp_pool_device_rule_and_backends(tiny_hf_dir, monkeypatch):
    """Without `--cpu` the pool needs one card a replica and exits with the
    JAX entry point's message before any load (no card here: found 0);
    the tiny and fake backends have no dp pool."""
    import torch as _torch

    monkeypatch.setattr(_torch.cuda, "device_count", lambda: 1)
    argv = [a for a in dp_argv(tiny_hf_dir) if a != "--cpu"]
    assert port_exit(argv) == "--dp 2 --tp 1 needs 2 devices, found 1"
    for backend in ("tiny", "fake"):
        assert "--backend checkpoint" in port_exit(
            ("--cpu", "--backend", backend, "--dp", "2"))


def test_entry_point_pump_depth_one_decodes_in_place(tiny_hf_dir, monkeypatch):
    """`LSOT_PUMP_DEPTH=1` reaches every replica of the dp pool: two
    prompts whose final chunks complete in one prefill forward export one
    blob and decode the other in place (backpressure), with the same
    text."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setenv("LSOT_POOL_PHASES", "prefill:1,decode:1")
    monkeypatch.setenv("LSOT_PUMP_DEPTH", "1")
    svc = entry.build_service(args_for(*dp_argv(tiny_hf_dir, "--kv-layout", "paged")),
                              AppConfig.from_env(history_db=":memory:"))
    try:
        pool = svc._models["duckdb-nsql"].backend.scheduler._inner
        pre = pool.schedulers[0]
        assert [s._pump_depth for s in pool.schedulers] == [1, 1]
        # Hold the prefill replica's first admission until both requests
        # have reached it, so both prefill in one group.
        gate, admit = threading.Event(), pre._admit

        def gated(slot, req):
            assert gate.wait(60)
            return admit(slot, req)

        pre._admit = gated
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = [ex.submit(svc.generate, "duckdb-nsql", "select vendor",
                              system="from fare") for _ in range(2)]
            for _ in range(6000):
                if pre._rid_seq >= 2:
                    break
                threading.Event().wait(0.01)
            gate.set()
            outs = [f.result(timeout=120) for f in futs]
        hs = {r["replica"]: r for r in pool.handoff_stats["replicas"]}
    finally:
        svc.close()
    assert outs[0].response == outs[1].response
    assert (hs["r0"]["exports"], hs["r0"]["inplace_fallbacks"],
            hs["r0"]["backpressure"], hs["r1"]["imports"]) == (1, 1, 1, 1)


# ------------------------------------------------------ LSOT_POOL_REMOTE

@pytest.mark.parametrize("env,extra", [
    ({"LSOT_POOL_REMOTE": "1=localhost:9"}, ("--dp", "1")),
    ({"LSOT_POOL_REMOTE": "x=localhost:9"}, ()),
    ({"LSOT_POOL_REMOTE": "2=localhost:9"}, ()),
    ({"LSOT_POOL_REMOTE": "1=localhost:9", "LSOT_MODELS": "duckdb-nsql=hf:{ckpt}"}, ()),
], ids=["no-dp", "bad-entry", "out-of-range", "with-models"])
def test_entry_point_pool_remote_refusals_as_jax(tiny_hf_dir, monkeypatch, env, extra):
    """Each misuse of `LSOT_POOL_REMOTE` exits with the JAX entry point's
    message: without `--dp > 1`, an entry that is not index=host:port, an
    index past the pool, and combined with `LSOT_MODELS`."""
    for k, v in env.items():
        monkeypatch.setenv(k, v.format(ckpt=tiny_hf_dir))
    argv = dp_argv(tiny_hf_dir, *extra)
    msg = port_exit(argv)
    assert msg == jax_exit(argv)
    assert "LSOT_POOL_REMOTE" in msg


def test_entry_point_pool_remote_serves_with_r1_remote(tiny_hf_dir, monkeypatch, tmp_path):
    """`--cpu --dp 2 --scheduler` with `LSOT_POOL_REMOTE=1=<address>` of a
    `ReplicaServer` over the same checkpoint: r1 is a `SocketTransport`
    under the lease knobs (`LSOT_LEASE_S`, `LSOT_LEASE_MISSES`), and
    `POST /process-data/` is served on both replicas (round robin) with the
    same SQL; the loads and /healthz carry r1's socket block. The three
    remote knobs are read by the port."""
    from llm_based_apache_spark_optimization_tpu_torch.checkpoint import load_hf_checkpoint
    from llm_based_apache_spark_optimization_tpu_torch.serve import resolve_stop_ids
    from llm_based_apache_spark_optimization_tpu_torch.serve.remote import (
        ReplicaServer,
        SocketTransport,
    )
    from llm_based_apache_spark_optimization_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )
    from llm_based_apache_spark_optimization_tpu_torch.tokenizer import HFTokenizer

    assert {"pool_remote", "lease_s", "lease_misses"} <= _read_by_port()
    mcfg, params = load_hf_checkpoint(tiny_hf_dir, device="cpu")
    worker = ContinuousBatchingScheduler(
        mcfg, params, num_slots=2,
        stop_ids=resolve_stop_ids(mcfg, HFTokenizer(str(tiny_hf_dir))), device="cpu")
    worker.start()
    srv = ReplicaServer(worker)
    monkeypatch.setenv("LSOT_POOL_REMOTE", f"1={srv.address}")
    monkeypatch.setenv("LSOT_POOL_ROUTER", "round_robin")
    monkeypatch.setenv("LSOT_LEASE_S", "0.5")
    monkeypatch.setenv("LSOT_LEASE_MISSES", "4")
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "taxi.csv").write_text(CSV)
    cfg = AppConfig.from_env(input_dir=str(tmp_path / "in"),
                             output_dir=str(tmp_path / "out"), history_db=":memory:",
                             max_new_tokens=8)
    svc = entry.build_service(args_for(*dp_argv(tiny_hf_dir, "--api")), cfg)
    try:
        pool = svc._models["duckdb-nsql"].backend.scheduler._inner
        assert isinstance(pool.schedulers[1], SocketTransport)
        assert not isinstance(pool.schedulers[0], SocketTransport)
        assert (pool._lease_s, pool._lease_misses) == (0.5, 4)
        client = create_api_app(svc, SQLiteBackend, SQLiteHistory(), cfg).test_client()
        answers = []
        for _ in range(2):
            res = client.post_json("/process-data/", {"input_text": "total fare per vendor",
                                                      "file_name": "taxi.csv"})
            assert res.status == 200
            answers.append(res.json()["sql_query"])
        assert answers[0] == answers[1]
        placed = [r["to"] for r in pool.flight_snapshot() if r.get("kind") == "placement"]
        assert "r1" in placed and "r0" in placed
        tr = {r["replica"]: r for r in pool.replica_loads()}["r1"]["transport"]
        assert tr["kind"] == "socket" and tr["rpcs"] >= 2 and not tr["unreachable"]
        fleet = client.get("/healthz").json()["fleet"]["duckdb-nsql"]
        assert fleet[1]["transport"]["kind"] == "socket" and "transport" not in fleet[0]
    finally:
        svc.close()
        srv.close()
        worker.shutdown()

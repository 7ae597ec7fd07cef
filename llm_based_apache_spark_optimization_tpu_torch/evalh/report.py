"""Markdown model-comparison report generator.

The reference ships its measured results as a standalone comparison report
(`Model_Comparision_Report.docx` §4.1 single-query table, §6.1-6.2 four-query
suite tables, §6.4 conclusion — summarized in SURVEY.md §6). This module is
that report as a *product feature*: run the in-tree harness and render the
same table shapes, so every deployment can regenerate its own report against
whatever weights it serves.

    python -m llm_based_apache_spark_optimization_tpu_torch.evalh.report \
        --backend tiny -o EVAL.md          # on the card; --cpu on the CPU

The report runs the four-query suite (reference
`Model_Evaluation_&_Comparision.py:86-158`) per registered model and the
five BASELINE configs, and records the environment (platform, backend kind)
so smoke-model numbers are never mistaken for real-weight quality.

Counterpart of the JAX package's `evalh/report.py`: the same tables. The
platform line names the torch device: "cpu", or on a card its name and
power limit as `nvidia-smi --query-gpu=name,power.limit` reports them.
"""

from __future__ import annotations

import argparse
import datetime
import sys
from typing import Dict, List, Optional, Sequence

from ..serve.service import GenerationService
from .configs import CONFIGS, run_config
from .fixtures import FOUR_QUERY_SUITE, TAXI_DDL_SYSTEM
from .harness import ModelReport, evaluate_models


def _fmt(x: float, nd: int = 2) -> str:
    return f"{x:.{nd}f}"


def render_report(
    reports: Dict[str, ModelReport],
    config_rows: List[dict],
    *,
    backend_desc: str,
    platform: str,
    title: str = "Model comparison report",
    quality_meaningful: bool = True,
    timestamp: Optional[str] = None,
    constrained_reports: Optional[Dict[str, ModelReport]] = None,
    constrained_speculation: Optional[Dict[str, dict]] = None,
    sampled_speculation: Optional[Dict[str, dict]] = None,
    round_cadence: Optional[Dict[str, float]] = None,
    roofline: Optional[Dict[str, dict]] = None,
    prefix_cache: Optional[Dict[str, dict]] = None,
) -> str:
    """Render harness output as markdown mirroring the reference's report
    structure (per-query table -> aggregate table -> configs -> conclusion)."""
    models = list(reports)
    lines: List[str] = [f"# {title}", ""]
    stamp = f" generated {timestamp}" if timestamp else ""
    lines += [
        f"Backend: **{backend_desc}** · platform: **{platform}**"
        f"{stamp}",
        "",
        "Instrument: in-tree eval harness (`evalh/`), the TPU rebuild of the "
        "reference's `Model_Evaluation_&_Comparision.py` — exact match, "
        "Levenshtein edit distance, wall-clock latency, plus output tok/s "
        "(which the reference never measured).",
        "",
    ]
    if not quality_meaningful:
        lines += [
            "> **Smoke-model run.** Weights are random (or canned): latency "
            "and tok/s are plumbing-true for this platform; exact-match and "
            "edit-distance numbers are architecturally meaningless and "
            "included only to prove the metric path end-to-end. Re-run with "
            "real checkpoints (`app --backend checkpoint`) for quality "
            "numbers comparable to the reference's.",
            "",
        ]

    # Per-query table: the §6.1 shape (edit distance | latency per model).
    lines += ["## Four-query suite — per query (edit distance | latency)", ""]
    header = "| Query | " + " | ".join(models) + " |"
    lines += [header, "|" + "---|" * (len(models) + 1)]
    # Rows follow what actually RAN (generate's limit_cases smoke mode may
    # have scored a prefix of the suite), not the full suite list.
    n_ran = min(len(reports[m].cases) for m in models) if models else 0
    for qi, case in enumerate(FOUR_QUERY_SUITE[:n_ran]):
        cells = []
        for m in models:
            c = reports[m].cases[qi]
            ed = "exact" if c.exact_match else str(c.edit_distance)
            cells.append(f"{ed} \\| {_fmt(c.latency_s, 2)} s")
        label = case.nl if len(case.nl) <= 48 else case.nl[:45] + "..."
        lines.append(f"| Q{qi + 1}: {label} | " + " | ".join(cells) + " |")
    lines.append("")

    # Aggregates: the §6.2 shape, plus tok/s and execution accuracy (which
    # the reference never measured — string metrics punish semantically
    # identical SQL; here both queries RUN on the in-tree SQL backend).
    lines += ["## Four-query suite — aggregates", ""]
    lines += [
        "| Metric | " + " | ".join(models) + " |",
        "|" + "---|" * (len(models) + 1),
        "| Exact-match rate | "
        + " | ".join(_fmt(reports[m].exact_match_rate, 1) + " %" for m in models)
        + " |",
        "| Avg edit distance | "
        + " | ".join(_fmt(reports[m].avg_edit_distance, 2) for m in models)
        + " |",
        "| Avg latency | "
        + " | ".join(_fmt(reports[m].avg_latency_s, 3) + " s" for m in models)
        + " |",
        "| Aggregate output tok/s | "
        + " | ".join(_fmt(reports[m].aggregate_tok_per_s, 1) for m in models)
        + " |",
    ]
    # Latency decomposition (tracing spans, scheduler-path
    # backends): TTFT / queue-wait / decode-round cadence say WHERE the
    # avg-latency row's time went. Rows render only when something
    # measured them — fake-backend tables keep their historical shape.
    if any(reports[m].avg_ttft_s is not None for m in models):
        lines.append(
            "| Avg TTFT | "
            + " | ".join(
                (_fmt(v, 3) + " s") if (v := reports[m].avg_ttft_s)
                is not None else "n/a"
                for m in models
            )
            + " |"
        )
    if any(reports[m].avg_queue_wait_s is not None for m in models):
        lines.append(
            "| Avg queue wait | "
            + " | ".join(
                (_fmt(v, 4) + " s") if (v := reports[m].avg_queue_wait_s)
                is not None else "n/a"
                for m in models
            )
            + " |"
        )
    if round_cadence and any(round_cadence.get(m) for m in models):
        lines.append(
            "| Decode round cadence | "
            + " | ".join(
                (_fmt(v, 4) + " s") if (v := round_cadence.get(m))
                else "n/a"
                for m in models
            )
            + " |"
        )
    # Live roofline position (the per-round ledger's decode
    # EWMA from serving.perf): achieved MFU / HBM-bandwidth utilization
    # and which roof binds — the phase-asymmetry signal the
    # disaggregation ROADMAP item cites, now a report row instead of a
    # bench-only artifact. Renders only for backends with a ledger.
    if roofline and any(roofline.get(m) for m in models):
        def _roof(v: Optional[dict]) -> str:
            if not v:
                return "n/a"
            return (f"{_fmt(100 * v.get('mfu', 0.0), 2)} % MFU / "
                    f"{_fmt(100 * v.get('hbm_util', 0.0), 2)} % HBM "
                    f"({v.get('bound', '?')})")

        lines.append(
            "| Decode roofline | "
            + " | ".join(_roof(roofline.get(m)) for m in models)
            + " |"
        )
    if any(reports[m].execution_match_rate is not None for m in models):
        lines.append(
            "| Execution-match rate | "
            + " | ".join(
                (_fmt(r, 1) + " %") if (r := reports[m].execution_match_rate)
                is not None else "n/a"
                for m in models
            )
            + " |"
        )
    lines.append("")

    # Constrained vs unconstrained (constrain/): grammar-valid% and
    # executable% side by side — the subsystem's headline guarantee is the
    # constrained column reading 100.0 regardless of weights.
    if constrained_reports:
        def _pct(r: Optional[float]) -> str:
            return "n/a" if r is None else _fmt(r, 1) + " %"

        spec = constrained_speculation or {}
        spec_col = any(m in spec for m in models)
        lines += [
            "## Constrained decoding (`constrain=\"spark_sql\"`) — "
            "off vs on",
            "",
            "| Model | grammar-valid off | grammar-valid on "
            "| executable off | executable on | exact off | exact on |"
            + (" spec tok/round |" if spec_col else ""),
            "|---|---|---|---|---|---|---|" + ("---|" if spec_col else ""),
        ]
        for m in models:
            off, on = reports[m], constrained_reports.get(m)
            if on is None:
                continue
            row = (
                f"| {m} | {_pct(off.grammar_valid_rate)} "
                f"| {_pct(on.grammar_valid_rate)} "
                f"| {_pct(off.executable_rate)} "
                f"| {_pct(on.executable_rate)} "
                f"| {_fmt(off.exact_match_rate, 1)} % "
                f"| {_fmt(on.exact_match_rate, 1)} % |"
            )
            if spec_col:
                s = spec.get(m)
                row += (f" {_fmt(s['tokens_per_round'], 3)} |"
                        if s and s.get("verify_rounds") else " n/a |")
            lines.append(row)
        lines += [
            "",
            "The constrained column's grammar-valid rate is a decode-time "
            "*guarantee* (token masks over the in-tree SELECT grammar), "
            "not a model property — it must read 100.0 even on random "
            "weights.",
            "",
        ]
        if spec_col:
            lines += [
                "`spec tok/round` is the CONSTRAINED class of the serving "
                "scheduler's speculation counters during the constrained "
                "pass (grammar-aware draft/verify: the mask is evaluated "
                "at every draft position, so output is token-identical to "
                "constrained vanilla decode). Above ~the verify cost "
                "ratio (engine/speculative.verify_cost_ratio) speculation "
                "is paying for itself on the constrained hot path.",
                "",
            ]

    # Sampled speculation: the temperature>0 traffic class now
    # rides the rejection-sampling draft/verify path; this table is its
    # OWN acceptance — greedy-only coverage would silently claim the
    # speedup for a class that never ran.
    if sampled_speculation:
        lines += [
            "## Sampled speculation (temperature>0 traffic)",
            "",
            "| Model | temperature | spec tok/round | est speedup "
            "| verify rounds |",
            "|---|---|---|---|---|",
        ]
        for m in models:
            s = sampled_speculation.get(m)
            if not s:
                continue
            lines.append(
                f"| {m} | {_fmt(s['temperature'], 1)} "
                f"| {_fmt(s['tokens_per_round'], 3)} "
                f"| {_fmt(s['est_speedup_vs_vanilla'], 3)}x "
                f"| {s['verify_rounds']} |"
            )
        lines += [
            "",
            "Sampled requests verify by rejection sampling (accept a "
            "drafted token with min(1, p/q) under the target "
            "distribution, resample the first rejection from the "
            "normalized residual — engine/speculative.py), so their "
            "output distribution equals vanilla sampling while rounds "
            "emit 1..draft+1 tokens. tok/round above 1.0 means drafts "
            "are clearing the accept test on this traffic; random "
            "weights sit near the 1.0 floor.",
            "",
        ]

    # Prefix cache: the NL→SQL serving pattern repeats one
    # schema prefix across requests, and these are the columns that say
    # whether the cache is carrying that traffic — hit rate over the
    # suite, prompt tokens the hits let prefill skip, and the analytic
    # prefill seconds that skip was worth (utils/perfmodel.prefill_saved).
    # Renders only for scheduler backends with an enabled cache that saw
    # at least one match-path admission.
    if prefix_cache:
        lines += [
            "## Prefix cache",
            "",
            "| Model | hit rate | reused tokens | prefill saved |",
            "|---|---|---|---|",
        ]
        for m in models:
            p = prefix_cache.get(m)
            if not p:
                continue
            lines.append(
                f"| {m} | {_fmt(100.0 * p['hit_rate'], 1)} % "
                f"| {int(p['reused_tokens'])} "
                f"| {_fmt(p['prefill_s_saved'], 4)} s |"
            )
        lines += [
            "",
            "Hit rate counts admissions whose prompt matched resident "
            "schema-prefix blocks (the publish gate means the same prefix "
            "hits from its third sighting on); reused tokens never "
            "re-ran prefill. Per-prefix residency and reuse-distance "
            "detail live at `/debug/prefixcache`.",
            "",
        ]

    # BASELINE configs (the five north-star scenarios). The Mesh column
    # states what actually ran — never the tp a config merely requested.
    if config_rows:
        lines += ["## BASELINE configs", ""]
        lines += [
            "| Config | Mesh | Cases | Exact % | Avg edit | Avg latency | tok/s |",
            "|---|---|---|---|---|---|---|",
        ]
        for r in config_rows:
            lines.append(
                f"| {r['config']} — {r['description']} "
                f"| {r.get('mesh') or 'tp=1'} | {r['cases']} "
                f"| {_fmt(r['exact_match_rate'], 1)} "
                f"| {_fmt(r['avg_edit_distance'], 1)} "
                f"| {_fmt(r['avg_latency_s'], 3)} s "
                f"| {_fmt(r['aggregate_tok_per_s'], 1)} |"
            )
        lines.append("")

    # Conclusion in the §6.4 spirit: which model for which role.
    best_sql = min(models, key=lambda m: reports[m].avg_edit_distance)
    fastest = min(models, key=lambda m: reports[m].avg_latency_s)
    lines += [
        "## Conclusion",
        "",
        f"- Closest-to-expected SQL: **{best_sql}** "
        f"(avg edit distance {_fmt(reports[best_sql].avg_edit_distance, 2)}).",
        f"- Lowest latency: **{fastest}** "
        f"(avg {_fmt(reports[fastest].avg_latency_s, 3)} s).",
        "- Reference baselines for the same suite: BASELINE.md (DuckDB-NSQL "
        "50 % exact / 21.5 avg edit / 8.05 s avg via Ollama).",
        "",
    ]
    return "\n".join(lines)


def make_taxi_exec_backend():
    """SQLite backend with the synthetic taxi fixture loaded as table
    `taxi` — the execution-match scoring target for the taxi suites."""
    import tempfile
    from pathlib import Path

    from ..sql.sqlite_backend import SQLiteBackend
    from .fixtures import write_taxi_fixture_csv

    backend = SQLiteBackend()
    with tempfile.TemporaryDirectory() as d:
        backend.load_csv(
            write_taxi_fixture_csv(Path(d) / "taxi.csv"), view_name="taxi"
        )
    # Engine-level read-only: model-generated SQL must not be able to
    # mutate the fixture even if it slips past the string guard.
    backend.set_read_only()
    return backend


def platform_desc(device=None) -> str:
    """The platform line's device: "cpu" for a CPU run, else the card's name
    and power limit from nvidia-smi (torch's device name when nvidia-smi
    cannot be read). A run that names no device needs a card."""
    if device is not None and str(device).startswith("cpu"):
        return "cpu"
    import subprocess

    import torch

    from .. import resolve_device

    dev = resolve_device(device)
    idx = dev.index or 0
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return f"cuda: {out or torch.cuda.get_device_name(idx)}"


def generate(
    service: GenerationService,
    *,
    backend_desc: str,
    models: Optional[Sequence[str]] = None,
    max_new_tokens: int = 64,
    with_configs: bool = True,
    quality_meaningful: bool = False,
    timestamp: Optional[str] = None,
    service_factory=None,
    service_mesh: Optional[str] = None,
    exec_match: bool = True,
    limit_cases: Optional[int] = None,
    constrain_compare: bool = False,
    device=None,
) -> str:
    platform = platform_desc(device)
    models = list(models or service.models())
    # limit_cases = the runbook's smoke mode: score only the first N suite
    # queries so the first run over a fresh checkpoint is one
    # prefill+decode per model, not the whole report. Validated HERE so
    # every caller inherits it: 0 would silently run the full suite
    # (falsy = no limit) and a negative N would slice from the end.
    if limit_cases is not None and limit_cases < 1:
        raise ValueError(f"limit_cases must be >= 1, got {limit_cases}")
    cases = (list(FOUR_QUERY_SUITE)[:limit_cases] if limit_cases
             else FOUR_QUERY_SUITE)
    exec_backend = make_taxi_exec_backend() if exec_match else None
    reports = evaluate_models(
        service, models, cases, TAXI_DDL_SYSTEM,
        max_new_tokens=max_new_tokens,
        exec_backend=exec_backend,
    )
    constrained_reports = None
    constrained_speculation: Dict[str, dict] = {}
    if constrain_compare:
        # Second pass decoded under the SCHEMA-AWARE grammar for the taxi
        # fixture (the pipeline-shaped configuration: identifiers are
        # masked to the table's own columns, so the executable% column can
        # actually move on the sqlite oracle — the generic grammar already
        # guarantees parses but lets random weights hallucinate table
        # names). Backends without the constrain seam (fakes, the Ollama
        # adapter) are skipped per model rather than failing the report.
        from .fixtures import TAXI_COLUMNS

        def _supports(model: str) -> bool:
            entry_get = getattr(service, "_entry", None)
            if entry_get is None:
                return False  # duck-typed adapter (a remote Ollama daemon)
            return getattr(entry_get(model).backend, "supports_constrain",
                           False)

        def _spec_constrained(model: str) -> Optional[dict]:
            """The CONSTRAINED class of the model's scheduler speculation
            counters (None for engine/fake backends or --speculative 0)."""
            stats = service.backend_stats().get(model, {}).get("speculation")
            if not stats:
                return None
            return dict(stats.get("by_class", {}).get("constrained", {}))

        constrained_reports = {}
        for m in models:
            # Explicit capability check instead of a blanket except: only
            # "backend lacks the constrain seam" skips the model; genuine
            # misconfiguration (e.g. a budget below the grammar's shortest
            # parse) must surface loudly, not silently drop the section.
            if not _supports(m):
                print(f"constrain-compare: skipping {m} (backend has no "
                      f"constrain seam)", file=sys.stderr)
                continue
            pre = _spec_constrained(m)
            constrained_reports[m] = evaluate_models(
                service, [m], cases, TAXI_DDL_SYSTEM,
                max_new_tokens=max_new_tokens,
                exec_backend=exec_backend,
                constrain={"table": "taxi",
                           "columns": list(TAXI_COLUMNS)},
            )[m]
            post = _spec_constrained(m)
            if post is not None:
                # Delta-bracket the constrained pass (the unconstrained
                # suite above also moved the scheduler's counters — only
                # the constrained class's movement during THIS pass says
                # anything about the grammar-masked hot path).
                rounds = (post.get("verify_rounds", 0)
                          - (pre or {}).get("verify_rounds", 0))
                toks = (post.get("tokens_emitted", 0)
                        - (pre or {}).get("tokens_emitted", 0))
                constrained_speculation[m] = {
                    "verify_rounds": rounds,
                    "tokens_emitted": toks,
                    "tokens_per_round": round(toks / rounds, 3) if rounds
                    else 0.0,
                }
    # Sampled-traffic speculation pass: every model served
    # through a speculative scheduler gets a temperature>0 run of the
    # suite, delta-bracketing the SAMPLED class of the speculation
    # counters — the report must never claim the draft/verify speedup
    # from greedy-only coverage. Gated on the backend actually exposing
    # speculation stats (engine/fake backends and --speculative 0 skip).
    sampled_speculation: Dict[str, dict] = {}
    from ..ops.sampling import SamplingParams

    def _spec_sampled(model: str) -> Optional[dict]:
        stats = service.backend_stats().get(model, {}).get("speculation")
        if not stats:
            return None
        return dict(stats.get("by_sampling", {}).get("sampled", {}))

    sampled_sp = SamplingParams(temperature=0.7)
    for m in models:
        pre = _spec_sampled(m)
        if pre is None:
            continue
        for i, case in enumerate(cases):
            service.generate(m, case.nl, TAXI_DDL_SYSTEM,
                             max_new_tokens=max_new_tokens,
                             sampling=sampled_sp, seed=i)
        post = _spec_sampled(m) or {}
        rounds = post.get("verify_rounds", 0) - pre.get("verify_rounds", 0)
        toks = post.get("tokens_emitted", 0) - pre.get("tokens_emitted", 0)
        spec_stats = (service.backend_stats().get(m, {})
                      .get("speculation") or {})
        ratio = spec_stats.get("verify_cost_ratio") or 0.0
        tpr = toks / rounds if rounds else 0.0
        sampled_speculation[m] = {
            "temperature": sampled_sp.temperature,
            "verify_rounds": rounds,
            "tokens_emitted": toks,
            "tokens_per_round": round(tpr, 3),
            "est_speedup_vs_vanilla": (round(tpr / ratio, 3) if ratio
                                       else 0.0),
        }
    # Decode-round cadence per model (the scheduler heartbeat's measured
    # EWMA, serve/watchdog.py) — the denominator that tells whether a
    # latency number is queueing or compute. None-valued for backends
    # without a heartbeat (fakes, engine).
    round_cadence: Dict[str, float] = {}
    roofline: Dict[str, dict] = {}
    prefix_cache: Dict[str, dict] = {}
    for m, stats in service.backend_stats().items():
        hb = (stats.get("watchdog") or {}).get("heartbeat") or {}
        ewma = hb.get("expected_round_s")
        if ewma:
            round_cadence[m] = ewma
        # Decode-phase roofline EWMA (serving.perf): first
        # replica's view for pools (replicas are homogeneous).
        perf = stats.get("perf") or {}
        if isinstance(perf.get("replicas"), list) and perf["replicas"]:
            perf = perf["replicas"][0]
        dec = (perf.get("phases") or {}).get("decode")
        if dec:
            roofline[m] = dec
        # Prefix-cache telemetry (serving.prefix): replicas sum
        # (counters add; the hit rate re-derives from the summed
        # hits/misses — never from averaging per-replica ratios).
        pv = stats.get("prefix") or {}
        reps = (pv["replicas"] if isinstance(pv.get("replicas"), list)
                else [pv] if pv else [])
        hits = sum(int(r.get("hits", 0)) for r in reps)
        misses = sum(int(r.get("misses", 0)) for r in reps)
        if hits + misses:
            prefix_cache[m] = {
                "hit_rate": hits / (hits + misses),
                "reused_tokens": sum(int(r.get("reused_tokens", 0))
                                     for r in reps),
                "prefill_s_saved": sum(float(r.get("prefill_s_saved", 0.0))
                                       for r in reps),
            }
    config_rows = []
    if with_configs:
        for key, cfg in CONFIGS.items():
            rep = run_config(service, cfg, max_new_tokens=max_new_tokens,
                             service_factory=service_factory,
                             service_mesh=service_mesh, warmup=True,
                             device=device)
            config_rows.append({
                "config": key,
                "description": cfg.description,
                "cases": len(rep.cases),
                "mesh": rep.mesh,
                "exact_match_rate": rep.exact_match_rate,
                "avg_edit_distance": rep.avg_edit_distance,
                "avg_latency_s": rep.avg_latency_s,
                "aggregate_tok_per_s": rep.aggregate_tok_per_s,
            })
    return render_report(
        reports, config_rows,
        backend_desc=backend_desc, platform=platform,
        quality_meaningful=quality_meaningful, timestamp=timestamp,
        constrained_reports=constrained_reports,
        constrained_speculation=constrained_speculation or None,
        sampled_speculation=sampled_speculation or None,
        round_cadence=round_cadence or None,
        roofline=roofline or None,
        prefix_cache=prefix_cache or None,
    )


def force_virtual_devices(n: int) -> None:
    """JAX forces N virtual XLA devices. The port's counterpart is a group
    of N CPU ranks, which `virtual_device_services` forms: this only checks
    N (0, the default, and 1 form no group)."""
    if n < 0:
        raise ValueError(f"--virtual-devices must be >= 0, got {n}")


def virtual_device_services(n: int, module: str, argv, max_new_tokens: int,
                            scheduler: bool = False):
    """`--virtual-devices N` with the tiny backend: N CPU ranks, and on
    them one tiny service for each BASELINE tp that divides N, on a mesh
    (dp=N/tp, tp): the services a config naming that tp runs on. The
    command starts the other ranks itself (parallel/launch.py). On rank 0
    returns (factory, done): `factory(tp)` is that service (`run_config`
    closes it after its rows), `done()` ends the group. The other ranks
    follow rank 0's steps until it ends the group, then return None."""
    from ..app.__main__ import make_tiny_service
    from ..parallel import launch, make_mesh, spmd
    from .configs import CONFIGS

    children = launch.start_group(n, module, argv)
    services, meshes = {}, []
    for tp in sorted({c.tp for c in CONFIGS.values()}):
        if tp <= 1 or n % tp:
            continue
        mesh = make_mesh(dp=n // tp, tp=tp, devices=["cpu"] * n)
        meshes.append(mesh)
        # The scheduler has no dp axis: a dp > 1 mesh serves engines.
        services[tp] = make_tiny_service(max_new_tokens, device="cpu", mesh=mesh,
                                         scheduler=scheduler and n == tp)
    import torch.distributed as dist

    if dist.get_rank() != 0:
        for m in meshes:
            spmd.ensure_following(m)
        launch.follow(*meshes)
        return None
    for m in meshes:
        spmd.drive(m)
        print(m.describe(), file=sys.stderr)

    def factory(tp: int):
        if tp not in services:
            raise ValueError(f"tp={tp} does not divide the {n} ranks")
        return services[tp]

    def done() -> None:
        for m in meshes:
            spmd.close(m)
        launch.finish(None, children)

    return factory, done


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="evalh.report")
    ap.add_argument("--backend", choices=("tiny", "fake", "oracle", "ollama"),
                    default="tiny")
    ap.add_argument("--ollama-url", default="http://127.0.0.1:11434",
                    metavar="URL",
                    help="with --backend ollama: report over a LIVE Ollama "
                         "server — the reference's own engine in the same "
                         "tables as the in-tree one")
    ap.add_argument("--models", nargs="+", metavar="NAME",
                    help="restrict the report to these models (essential "
                         "with --backend ollama: a daemon may host many "
                         "unrelated local models)")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve the tiny models through continuous-batching "
                         "schedulers (config 5 then batches concurrent "
                         "requests on device, as in production serving)")
    ap.add_argument("-o", "--out", default="-", help="output path (- = stdout)")
    ap.add_argument("--constrain-compare", action="store_true",
                    help="add a constrained-vs-unconstrained section "
                         "(grammar-valid% / executable% with the "
                         "constrain/ token masks on vs off; real-engine "
                         "backends only). With --scheduler --speculative "
                         "N the section also reports the constrained "
                         "class's speculation tokens/round")
    ap.add_argument("--speculative", type=int, default=0, metavar="N",
                    help="with --scheduler: serve through speculative "
                         "schedulers (draft N tokens/round) — constrained "
                         "traffic composes (--constrain-compare surfaces "
                         "its per-class acceptance), and the report adds "
                         "a sampled-traffic pass (temperature>0 suite "
                         "run) with the sampled class's tok/round and "
                         "est-speedup")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU; without it the tiny models run on "
                         "the card and the report needs one")
    ap.add_argument("--virtual-devices", type=int, default=0, metavar="N",
                    help="N CPU ranks (the command starts them): the tiny "
                         "backend's configs naming tp <= N run on a tp mesh")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)

    force_virtual_devices(args.virtual_devices)
    device = "cpu" if args.cpu else None
    factory = done = None
    if args.backend == "tiny" and args.virtual_devices > 1:
        group = virtual_device_services(
            args.virtual_devices, "llm_based_apache_spark_optimization_tpu_torch.evalh.report",
            argv, args.max_new_tokens, scheduler=args.scheduler)
        if group is None:
            return  # a follower rank: rank 0 wrote the report
        factory, done = group

    from ..app.__main__ import (
        make_fake_service,
        make_oracle_service,
        make_tiny_service,
    )

    if args.backend == "tiny":
        service = make_tiny_service(args.max_new_tokens,
                                    scheduler=args.scheduler,
                                    speculative=args.speculative,
                                    device=device)
        desc = ("tiny in-tree engine, random weights (smoke"
                + (", scheduler backends)" if args.scheduler else ")"))
    elif args.backend == "oracle":
        service = make_oracle_service()
        desc = ("oracle canned backend (answers every SQL case with its "
                "expected SQL — instrument self-proof: anything below "
                "100% exact/execution match on the suite tables is a "
                "harness bug)")
    elif args.backend == "ollama":
        from ..serve.ollama_client import OllamaClientService

        service = OllamaClientService(args.ollama_url)
        desc = (f"LIVE Ollama server at {args.ollama_url} — the reference's "
                "own engine scored by the in-tree instrument")
    else:
        service = make_fake_service()
        desc = "fake canned backend (contract smoke)"
    text = generate(
        service, backend_desc=desc, max_new_tokens=args.max_new_tokens,
        models=args.models,
        quality_meaningful=args.backend in ("oracle", "ollama"),
        timestamp=datetime.datetime.now().strftime("%Y-%m-%d %H:%M"),
        service_factory=factory,
        constrain_compare=args.constrain_compare,
        # Config rows 2/3 are error-analysis workloads with no expected
        # SQL; on the oracle backend they'd read 0% right under a banner
        # saying below-100 means a harness bug. The self-proof is the
        # suite tables; skip the config table there.
        with_configs=args.backend != "oracle",
        device=device,
    )
    if done is not None:
        done()
    if args.out == "-":
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()

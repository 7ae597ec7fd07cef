"""Run the eval harness / BASELINE configs from the command line.

    python -m llm_based_apache_spark_optimization_tpu_torch.evalh            # 4-query suite, both models
    python -m llm_based_apache_spark_optimization_tpu_torch.evalh --configs  # the 5 BASELINE configs
    python -m llm_based_apache_spark_optimization_tpu_torch.evalh --backend tiny --configs 4-spider-batch32-tp4
    python -m llm_based_apache_spark_optimization_tpu_torch.evalh --chaos    # the ten chaos stages

This is the CLI twin of the reference's `Model_Evaluation_&_Comparision.py`
(run directly against a live Ollama there; against the in-tree service
here). `--backend tiny` runs the real engine path with random weights —
numbers are plumbing-true but quality metrics are meaningless; point
checkpoints at the service (app/__main__.py wiring) for real scores.

Counterpart of the JAX package's `evalh/__main__.py`, with every option and
default of its parser. `--backend tiny` and `--chaos`'s schedulers run on
the card and raise without one; `--cpu` runs them on the CPU.
`--virtual-devices N` runs the command on N CPU ranks, which it starts: with
`--backend tiny --configs`, a config naming tp <= N runs on a tp mesh.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="evalh")
    ap.add_argument("--backend", choices=("tiny", "fake", "oracle", "ollama"),
                    default="fake")
    ap.add_argument("--ollama-url", default="http://127.0.0.1:11434",
                    metavar="URL",
                    help="with --backend ollama: score a LIVE Ollama server "
                         "(the reference's engine) under this instrument — "
                         "the same tables, reference setup")
    ap.add_argument("--models", nargs="+", metavar="NAME",
                    help="restrict suite evaluation to these registered "
                         "models (essential with --backend ollama: a "
                         "daemon may host many unrelated local models)")
    ap.add_argument("--configs", nargs="*", metavar="KEY",
                    help="run BASELINE configs (all when no KEY given)")
    ap.add_argument("--spider", metavar="DEV_JSON",
                    help="evaluate on real Spider data at this path")
    ap.add_argument("--explain", nargs="?", metavar="MODEL",
                    const="llama3.2",  # bare --explain = the fleet's
                                       # error-analysis model
                    help="explain stage: route every execute-fail case's "
                         "engine error through this registered in-fleet "
                         "model (the same path app/pipeline.explain_error "
                         "serves) and report explainer latency separately "
                         "from SQL-generation latency")
    ap.add_argument("--constrain", action="store_true",
                    help="decode under the in-tree Spark-SQL grammar "
                         "(constrain/): every completion is guaranteed to "
                         "parse — engine/scheduler backends only")
    ap.add_argument("--chaos", nargs="?", metavar="SPEC",
                    const="",  # bare --chaos = the default spec
                    help="fault-injection run: drive the fixture suite "
                         "through a self-contained serving stack (fake "
                         "Ollama daemon + resilient SQLite) under this "
                         "LSOT_FAULTS-style spec (default "
                         "'ollama:connect:0.5,sql:exec:1,sched:crash:0.2' "
                         "— evalh.chaos.DEFAULT_SPEC), then a supervised "
                         "scheduler through sched:crash loop deaths, a "
                         "watchdog hang stage, a FLEET stage (one "
                         "pool replica wedged via sched:wedge_r1: only "
                         "that replica restarts, siblings untouched), and "
                         "a KV-PRESSURE stage (the real paged scheduler "
                         "under a kv:pressure storm: victims preempt and "
                         "resume token-identical to a pressure-free "
                         "control), an ELASTIC stage (an all-remote "
                         "phase-split fleet scales up on a burst, rides "
                         "out a fleet:spawn failure, a remote-prefill "
                         "SIGKILL mid-handoff and a scale-down racing "
                         "in-flight streams — zero lost/duplicated "
                         "stream tokens), and a QOS stage (a storm "
                         "tenant's backlog against a quiet tenant on "
                         "the real WFQ scheduler: quiet-tenant TTFT p95 "
                         "within tolerance of a storm-free control, "
                         "every request token-identical to the "
                         "LSOT_QOS=0 run), and "
                         "report success-after-retry / shed / degraded "
                         "rates plus restart/replay/lost counts — asserts "
                         "zero hung requests and zero lost acknowledged "
                         "requests. Self-contained: ignores --backend")
    ap.add_argument("--chaos-seed", type=int, default=0, metavar="N",
                    help="seed for the --chaos injection RNG (same spec + "
                         "seed replays the same fault schedule)")
    ap.add_argument("--repair", nargs="?", metavar="MAX_ROUNDS", type=int,
                    const=2,  # bare --repair = the production default
                    help="repair leg: drive the self-healing "
                         "execute→diagnose→repair loop over the Spider "
                         "fixture path (per-case DDL instantiated into its "
                         "own SQLite database; --spider DEV_JSON for real "
                         "data) and report cumulative executable% after "
                         "k ∈ {0..MAX_ROUNDS} repair rounds — one-shot vs "
                         "self-healed, the paper's headline number. Runs "
                         "the clean suite AND the injected-fault suite "
                         "(per-class sql:* sites, where k=0 is 0%% by "
                         "construction)")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="run the tiny models and the chaos stages' "
                         "schedulers on the CPU; without it they run on the "
                         "card and raise without one")
    ap.add_argument("--virtual-devices", type=int, default=0, metavar="N",
                    help="N CPU ranks (the command starts them): with "
                         "--backend tiny, --configs naming tp <= N run on a "
                         "tp mesh")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    from .report import force_virtual_devices, virtual_device_services

    force_virtual_devices(args.virtual_devices)
    factory = done = None
    if args.backend == "tiny" and args.virtual_devices > 1 and args.configs is not None:
        group = virtual_device_services(
            args.virtual_devices, "llm_based_apache_spark_optimization_tpu_torch.evalh",
            argv, args.max_new_tokens)
        if group is None:
            return  # a follower rank: rank 0 printed the rows
        factory, done = group
    if args.chaos is not None:
        # Mostly host-only (fake daemon, SQLite, toy schedulers); the
        # stages from kv-pressure on build tiny schedulers on `device`.
        from .chaos import run_chaos

        print(json.dumps(
            run_chaos(args.chaos or None, seed=args.chaos_seed,
                      max_new_tokens=args.max_new_tokens, device=device),
            indent=2,
        ))
        return

    from ..app.__main__ import (
        make_fake_service,
        make_oracle_service,
        make_tiny_service,
    )
    from .configs import CONFIGS, run_config
    from .fixtures import FOUR_QUERY_SUITE, TAXI_DDL_SYSTEM
    from .harness import evaluate_models, format_summary

    if args.constrain and args.backend != "tiny":
        # Token masks need the in-tree decode loop: a remote Ollama daemon
        # cannot be masked, and the canned fake/oracle backends have no
        # decode loop at all. Fail clearly up front instead of letting the
        # forwarded kwarg become a mid-run TypeError/ValueError traceback.
        sys.exit("--constrain needs the in-tree decode loop "
                 "(--backend tiny, or real checkpoints via the app); "
                 f"--backend {args.backend} cannot be token-masked")

    if args.backend == "ollama":
        from ..serve.ollama_client import OllamaClientService

        service = OllamaClientService(args.ollama_url)
    else:
        service = {
            "tiny": lambda: make_tiny_service(args.max_new_tokens, scheduler=False,
                                              device=device),
            "fake": make_fake_service,
            "oracle": make_oracle_service,
        }[args.backend]()
    # Mesh honesty (evalh/configs.run_config): configs naming tp=N run on
    # the tp=N service of the `--virtual-devices` group, or report the
    # device count they ran beside.

    if args.repair is not None:
        if args.configs is not None:
            sys.exit("--repair is its own leg (executable% after k repair "
                     "rounds); it does not combine with --configs")
        if args.spider and args.backend == "oracle":
            sys.exit("--backend oracle is the in-tree-suite instrument "
                     "self-proof; it does not know external --spider "
                     "cases — use --backend tiny/fake there")
        from .repair import format_repair_summary, run_repair_leg
        from .spider import SPIDER_SMOKE, SpiderLoadError, load_spider

        if args.spider:
            try:
                rcases = load_spider(args.spider, limit=50)
            except SpiderLoadError as e:
                sys.exit(f"--spider: {e}")
        else:
            rcases = SPIDER_SMOKE
        model = (args.models or service.models())[0]
        for inject in (False, True):
            rep = run_repair_leg(
                service, model, cases=rcases, max_rounds=args.repair,
                inject=inject, max_new_tokens=args.max_new_tokens,
            )
            print(format_repair_summary(rep))
        return

    if args.configs is not None:
        if args.explain:
            sys.exit("--explain applies to the suite evaluation (it needs "
                     "the fixture exec backend to produce engine errors); "
                     "--configs rows score fixed scenarios")
        if args.constrain:
            # The BASELINE configs are fixed reproduction scenarios; a
            # silently ignored --constrain would print unconstrained
            # numbers under a constrained-looking invocation.
            sys.exit("--constrain applies to the suite evaluation, not "
                     "--configs (the BASELINE scenarios are fixed); drop "
                     "one of the two flags")
        if args.backend == "oracle":
            # Error-analysis configs (2/3) have no expected SQL; the oracle
            # would read 0% there under a banner that says below-100 means
            # a harness bug (same ambiguous-zero as --spider below).
            sys.exit("--backend oracle proves the instrument on the SQL "
                     "suites only; run it without --configs")
        keys = args.configs or list(CONFIGS)
        for key in keys:
            if key not in CONFIGS:
                sys.exit(f"unknown config {key!r}; choices: {list(CONFIGS)}")
            cfg = CONFIGS[key]
            rep = run_config(service, cfg, max_new_tokens=args.max_new_tokens,
                             service_factory=factory, device=device)
            print(json.dumps({
                "config": key,
                "description": cfg.description,
                "cases": len(rep.cases),
                "mesh": rep.mesh,
                "exact_match_rate": round(rep.exact_match_rate, 2),
                "avg_edit_distance": round(rep.avg_edit_distance, 2),
                "avg_latency_s": round(rep.avg_latency_s, 4),
                "aggregate_tok_per_s": round(rep.aggregate_tok_per_s, 1),
            }))
        if done is not None:
            done()
        return

    if args.spider:
        if args.backend == "oracle":
            # The oracle only indexes the in-tree suites; on external
            # Spider data every answer would be the fallback and the
            # ~0% result would be indistinguishable from a harness bug.
            sys.exit("--backend oracle is the in-tree-suite instrument "
                     "self-proof; it does not know external --spider "
                     "cases — use --backend tiny/fake there")
        from .spider import load_spider

        cases = [c.as_eval_case() for c in load_spider(args.spider, limit=100)]
        system = ""  # schemas ride per-case; simple shared-system fallback
    else:
        cases, system = FOUR_QUERY_SUITE, TAXI_DDL_SYSTEM

    # Execution-match scoring rides along on the taxi suite (its fixture
    # table is in-tree); external Spider cases have no loaded database to
    # judge against, so they score string metrics only.
    exec_backend = None
    if not args.spider:
        from .report import make_taxi_exec_backend

        exec_backend = make_taxi_exec_backend()
    # ONE models() round trip serves both the default and the unknown-set
    # check: with --backend ollama each call was an extra HTTP request to
    # the daemon, and two calls could even disagree if the daemon's model
    # list changed between them.
    available = service.models()
    models = args.models or available
    unknown = sorted(set(models) - set(available))
    if unknown:
        sys.exit(f"unknown model(s) {unknown}; available: {available}")
    if args.explain and exec_backend is None:
        sys.exit("--explain needs the fixture exec backend for engine "
                 "errors; it does not combine with --spider")
    if args.explain and args.explain not in available:
        sys.exit(f"--explain model {args.explain!r} is not registered; "
                 f"available: {available}")
    reports = evaluate_models(
        service, models, cases, system,
        max_new_tokens=args.max_new_tokens, exec_backend=exec_backend,
        constrain="spark_sql" if args.constrain else None,
    )
    if args.explain:
        from .harness import explain_failures

        reports = {
            m: explain_failures(service, args.explain, rep,
                                max_new_tokens=args.max_new_tokens)
            for m, rep in reports.items()
        }
    print(format_summary(reports))


if __name__ == "__main__":
    main()

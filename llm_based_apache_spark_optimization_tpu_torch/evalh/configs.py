"""The five BASELINE.json benchmark configs as declarative, runnable specs.

BASELINE.json "configs":
  1. duckdb-nsql-7B greedy decode, single prompt, CPU
  2. Llama-3.2-1B error-analysis prompt, greedy decode
  3. Llama-3.2-3B-Instruct, top-p sampling, batch=8 error traces
  4. duckdb-nsql-7B, batch=32 Spider NL questions, TP=4
  5. Concurrent mixed NL→SQL + error-analysis requests, v5e-8, TP=8

Each config names the model/config it wants, the workload shape, and how it
runs (single / batched / concurrent). `run_config` executes one against a
GenerationService — with real weights when an operator has them, or the
smoke models (`--backend tiny`/`fake`) for plumbing-true dry runs on CI.
Results carry the same metric surface as the eval harness (exact match /
edit distance / latency / aggregate tok/s).

Counterpart of the JAX package's `evalh/configs.py`. A config naming tp=N
runs on a tp=N mesh when the command runs on a group of at least N ranks
(`--virtual-devices N`: N CPU ranks, evalh/report.virtual_device_services);
otherwise on one device, and its row says so with the devices it had
(`device_count`).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from ..ops.sampling import SamplingParams
from ..serve.service import GenerationService
from .fixtures import (
    FOUR_QUERY_SUITE,
    GRAMMAR_BREADTH_SUITE,
    TAXI_DDL_SYSTEM,
)
from .harness import ModelReport, evaluate_model, evaluate_model_batched
from .spider import SPIDER_SMOKE

_ERROR_TRACE = (
    "org.apache.spark.sql.AnalysisException: cannot resolve 'passenger_cnt' "
    "given input columns: [VendorID, tpep_pickup_datetime, passenger_count, "
    "trip_distance, fare_amount]; line 1 pos 38;\n'Filter ('passenger_cnt > 2)\n"
    "+- SubqueryAlias temp_view\n   +- View (`temp_view`, [VendorID, ...])\n"
)

_ERROR_SYSTEM = (
    "You are an AI that helps troubleshoot Apache Spark errors. "
    "Provide clear, concise solutions."
)


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    key: str
    description: str
    model: str          # registry name the service must have
    mode: str           # "single" | "batched" | "concurrent"
    batch_size: int = 1
    sampling: Optional[SamplingParams] = None
    tp: int = 1         # mesh the config calls for; run_config builds it via
                        # service_factory(tp) when enough devices exist, else
                        # the report row is annotated with what actually ran
    workload: str = "sql"  # "sql" | "error" | "mixed"


CONFIGS: Dict[str, BenchConfig] = {
    "1-cpu-greedy": BenchConfig(
        "1-cpu-greedy", "duckdb-nsql greedy, single prompt",
        model="duckdb-nsql", mode="single",
    ),
    "2-error-greedy": BenchConfig(
        "2-error-greedy", "error-analysis prompt, greedy",
        model="llama3.2", mode="single", workload="error",
    ),
    "3-topp-batch8": BenchConfig(
        "3-topp-batch8", "top-p sampling, batch=8 error traces",
        model="llama3.2", mode="batched", batch_size=8,
        sampling=SamplingParams(temperature=0.7, top_p=0.9),
        workload="error",
    ),
    "4-spider-batch32-tp4": BenchConfig(
        "4-spider-batch32-tp4", "batch=32 Spider NL questions, TP=4",
        model="duckdb-nsql", mode="batched", batch_size=32, tp=4,
    ),
    "5-concurrent-mixed-tp8": BenchConfig(
        "5-concurrent-mixed-tp8", "concurrent mixed NL→SQL + error analysis",
        model="duckdb-nsql", mode="concurrent", batch_size=8, tp=8,
        workload="mixed",
    ),
}


def sql_case_base():
    """The canonical SQL-workload case list every benchmark config draws
    from (and the oracle backend indexes — a drift between the two would
    falsely fail the instrument self-proof)."""
    return ([c.as_eval_case() for c in SPIDER_SMOKE]
            + list(FOUR_QUERY_SUITE) + list(GRAMMAR_BREADTH_SUITE))


def _sql_cases(n: int):
    base = sql_case_base()
    return [base[i % len(base)] for i in range(n)]


def device_count(device=None) -> int:
    """The devices a run on `device` could shard over: the ranks of the
    process group when there is one (`--virtual-devices N`: N CPU ranks),
    else 1 on the CPU and the CUDA cards torch sees on the card."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    if device is not None and str(device).startswith("cpu"):
        return 1
    return torch.cuda.device_count()


def run_config(
    service: GenerationService,
    cfg: BenchConfig,
    max_new_tokens: int = 64,
    service_factory: Optional[Callable[[int], GenerationService]] = None,
    service_mesh: Optional[str] = None,
    warmup: bool = False,
    device=None,
) -> ModelReport:
    """Execute one BASELINE config against the service's registered models.

    Mesh honesty: a config naming tp=N runs on the mesh it names, or the
    report row says exactly what ran instead. With `service_factory` and at
    least N devices (`device_count(device)`: a group's ranks) the factory
    builds the tp=N service and the row reads "tp=N"; with fewer, "tp=1
    (requested tp=N; D device(s))". `service_mesh` describes the mesh the
    passed-in service already runs on, so a service-owned mesh is reported
    truthfully rather than defaulting to tp=1. The row never claims a mesh
    that wasn't built. A factory-built service is closed after its run.
    """
    mesh_desc = service_mesh or "tp=1"
    built: Optional[GenerationService] = None
    if cfg.tp > 1:
        ndev = device_count(device)
        if service_factory is not None and ndev >= cfg.tp:
            built = service = service_factory(cfg.tp)
            mesh_desc = f"tp={cfg.tp}"
        elif service_factory is not None:
            mesh_desc = f"tp=1 (requested tp={cfg.tp}; {ndev} device(s))"
        elif service_mesh is not None:
            mesh_desc = (f"{service_mesh} (service-owned; config requested "
                         f"tp={cfg.tp})")
        else:
            mesh_desc = f"tp=1 (requested tp={cfg.tp}; service owns its mesh)"
    try:
        if warmup:
            # Untimed pass first: the first contact with each batch shape
            # pays one-time costs (kernel builds, allocator growth) that do
            # not belong in the measured row. A truncated token budget
            # suffices, so the warmup costs a small fraction of the
            # measured pass.
            _run_config_body(service, cfg, min(8, max_new_tokens))
        rep = _run_config_body(service, cfg, max_new_tokens)
    finally:
        if built is not None:
            built.close()
    return dataclasses.replace(rep, mesh=mesh_desc)


def _run_config_body(
    service: GenerationService,
    cfg: BenchConfig,
    max_new_tokens: int = 64,
) -> ModelReport:
    if cfg.workload == "error":
        system, cases = _ERROR_SYSTEM, None
    else:
        system = TAXI_DDL_SYSTEM

    if cfg.mode == "single":
        if cfg.workload == "error":
            from .fixtures import EvalCase

            cases = [EvalCase(nl=_ERROR_TRACE, expected_sql="")]
        else:
            cases = _sql_cases(1)
        return evaluate_model(service, cfg.model, cases, system, max_new_tokens)

    if cfg.mode == "batched":
        if cfg.workload == "error":
            from .fixtures import EvalCase

            cases = [
                EvalCase(nl=f"{_ERROR_TRACE}\n(request {i})", expected_sql="")
                for i in range(cfg.batch_size)
            ]
        else:
            cases = _sql_cases(cfg.batch_size)
        return evaluate_model_batched(
            service, cfg.model, cases, system,
            max_new_tokens=max_new_tokens, batch_size=cfg.batch_size,
        )

    if cfg.mode == "concurrent":
        # Mixed workload: half NL→SQL, half error analysis, submitted from
        # concurrent client threads (the scheduler backend batches them on
        # device; lock-serialized backends still interleave correctly).
        sql_cases = _sql_cases(cfg.batch_size)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=cfg.batch_size * 2) as pool:
            sql_futs = [
                pool.submit(
                    service.generate, cfg.model, c.nl, TAXI_DDL_SYSTEM,
                    max_new_tokens,
                )
                for c in sql_cases
            ]
            err_futs = [
                pool.submit(
                    service.generate, "llama3.2", _ERROR_TRACE, _ERROR_SYSTEM,
                    max_new_tokens,
                )
                for _ in range(cfg.batch_size)
            ]
            results = [f.result() for f in sql_futs + err_futs]
        wall = time.perf_counter() - t0
        from .harness import CaseResult
        from .metrics import edit_distance, exact_match

        case_results: List[CaseResult] = []
        for case, res in zip(sql_cases, results[: len(sql_cases)]):
            generated = res.response.strip()
            case_results.append(CaseResult(
                nl=case.nl, generated_sql=generated,
                expected_sql=case.expected_sql.strip(),
                exact_match=exact_match(generated, case.expected_sql),
                edit_distance=edit_distance(generated, case.expected_sql),
                latency_s=res.latency_s, output_tokens=res.output_tokens,
            ))
        for res in results[len(sql_cases):]:
            case_results.append(CaseResult(
                nl=_ERROR_TRACE, generated_sql=res.response.strip(),
                expected_sql="", exact_match=0, edit_distance=0,
                latency_s=res.latency_s, output_tokens=res.output_tokens,
            ))
        return ModelReport(
            model=f"{cfg.model}+llama3.2", cases=case_results,
            wall_clock_s=wall,
        )

    raise ValueError(f"unknown mode {cfg.mode!r}")

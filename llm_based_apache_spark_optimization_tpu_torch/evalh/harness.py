"""Evaluation harness: score registered models on NL→SQL suites.

The reference's measurement instrument (reference
`Model_Evaluation_&_Comparision.py:19-66` single-query, `:109-158`
multi-query): per-case exact match / edit distance / latency, per-model
aggregates — plus output tok/s, which the reference never measured but
BASELINE.json's north star is denominated in.

Counterpart of the JAX package's `evalh/harness.py`, over the port's
`GenerationService`: the same scores and the same summary text.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..constrain import is_valid_spark_sql
from ..serve.service import GenerationService
from .fixtures import EvalCase
from .metrics import edit_distance, exact_match, execution_outcome


@dataclasses.dataclass(frozen=True)
class CaseResult:
    nl: str
    generated_sql: str
    expected_sql: str
    exact_match: int
    edit_distance: int
    latency_s: float
    output_tokens: int
    # Execution accuracy (metrics.execution_match): 1/0 when judged against
    # a SQL backend, None when no backend was given or the expected query
    # itself fails on the fixture table.
    execution_match: Optional[int] = None
    # Grammar validity under the in-tree constrained-SQL subset
    # (constrain.parser): 1/0 for SQL cases, None for cases with no
    # expected SQL (error-analysis traffic is not SQL-shaped).
    grammar_valid: Optional[int] = None
    # Executability (metrics.executes): does the generated statement RUN on
    # the fixture backend at all — the rate constrained decoding lifts.
    executable: Optional[int] = None
    # Latency decomposition (request spans, scheduler-path backends):
    # time to first token and queue wait — WHERE the latency lives, not
    # just how much. 0.0 = not measured (fakes, the one-program engine).
    ttft_s: float = 0.0
    queue_wait_s: float = 0.0
    # Explain stage: the engine's error text when the generated
    # statement failed to execute, and the in-fleet explainer's analysis
    # of it. explain_latency_s is the explainer round trip ALONE — kept
    # out of latency_s so SQL-gen numbers stay comparable with and
    # without the stage.
    exec_error: str = ""
    explanation: str = ""
    explain_latency_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelReport:
    model: str
    cases: List[CaseResult]
    # Set by the batched path: true wall-clock of all batches. Without it,
    # aggregate tok/s divides by summed per-case latencies (sequential path).
    wall_clock_s: float = 0.0
    # What mesh the run ACTUALLY executed on (e.g. "tp=4" or
    # "tp=1 (requested tp=4; 1 device)") — config rows must not print a
    # tp they never built. Set by configs.run_config.
    mesh: str = ""

    @property
    def exact_match_rate(self) -> float:
        return 100.0 * sum(c.exact_match for c in self.cases) / len(self.cases)

    @property
    def avg_edit_distance(self) -> float:
        return sum(c.edit_distance for c in self.cases) / len(self.cases)

    @property
    def avg_latency_s(self) -> float:
        return sum(c.latency_s for c in self.cases) / len(self.cases)

    @property
    def aggregate_tok_per_s(self) -> float:
        total_t = self.wall_clock_s or sum(c.latency_s for c in self.cases)
        return sum(c.output_tokens for c in self.cases) / total_t if total_t else 0.0

    @property
    def avg_ttft_s(self) -> Optional[float]:
        """Mean time-to-first-token over cases that measured one; None
        when the backend has no first-token seam (fakes, engine)."""
        vals = [c.ttft_s for c in self.cases if c.ttft_s]
        return sum(vals) / len(vals) if vals else None

    @property
    def avg_queue_wait_s(self) -> Optional[float]:
        """Mean scheduler queue wait over cases that measured one."""
        vals = [c.queue_wait_s for c in self.cases if c.queue_wait_s]
        return sum(vals) / len(vals) if vals else None

    @property
    def execution_match_rate(self) -> Optional[float]:
        """Execution accuracy over judgeable cases; None when nothing was
        judged (no backend, or every expected query failed)."""
        judged = [c.execution_match for c in self.cases
                  if c.execution_match is not None]
        if not judged:
            return None
        return 100.0 * sum(judged) / len(judged)

    @property
    def grammar_valid_rate(self) -> Optional[float]:
        """Share of SQL cases whose output parses under the in-tree
        grammar; None when no case was SQL-shaped. 100.0 is the
        constrained-decoding guarantee evalh asserts end to end."""
        judged = [c.grammar_valid for c in self.cases
                  if c.grammar_valid is not None]
        if not judged:
            return None
        return 100.0 * sum(judged) / len(judged)

    @property
    def executable_rate(self) -> Optional[float]:
        """Share of SQL cases whose output executes on the fixture
        backend; None when no backend was attached."""
        judged = [c.executable for c in self.cases
                  if c.executable is not None]
        if not judged:
            return None
        return 100.0 * sum(judged) / len(judged)

    @property
    def explained_failures(self) -> int:
        """Execute-fail cases the explain stage annotated."""
        return sum(1 for c in self.cases if c.explanation)

    @property
    def avg_explain_latency_s(self) -> Optional[float]:
        """Mean explainer round trip over explained cases — reported
        SEPARATELY from avg_latency_s (SQL generation), so the explain
        stage never inflates the generation numbers it rides beside.
        None when the stage didn't run or nothing failed."""
        vals = [c.explain_latency_s for c in self.cases if c.explanation]
        if not vals:
            return None
        return sum(vals) / len(vals)


def _score(case: EvalCase, generated: str, latency_s: float,
           output_tokens: int, exec_backend=None,
           ttft_s: float = 0.0, queue_wait_s: float = 0.0) -> CaseResult:
    expected = case.expected_sql.strip()
    ex = gv = exe = None
    if expected:
        # SQL-shaped cases score grammar validity against the in-tree
        # constrained subset (the constrain/ uplift metric); error-analysis
        # cases (no expected SQL) stay None.
        gv = int(is_valid_spark_sql(generated))
    if exec_backend is not None and expected:
        # One shared generated-query run scores both execution metrics
        # (execution_outcome — a second identical round trip per case
        # doubled the oracle I/O across the suite).
        m, gen_ok, gen_err = execution_outcome(generated, expected,
                                               exec_backend)
        ex = None if m is None else int(m)
        exe = int(gen_ok)
        err = gen_err
    else:
        err = ""
    return CaseResult(
        nl=case.nl,
        generated_sql=generated,
        expected_sql=expected,
        exact_match=exact_match(generated, expected),
        edit_distance=edit_distance(generated, expected),
        latency_s=latency_s,
        output_tokens=output_tokens,
        execution_match=ex,
        grammar_valid=gv,
        executable=exe,
        ttft_s=ttft_s,
        queue_wait_s=queue_wait_s,
        exec_error=err,
    )


def _gen_kwargs(constrain) -> Dict:
    """Forward `constrain` only when set, so duck-typed services without
    the parameter (the Ollama client adapter) keep working for
    UNCONSTRAINED runs. Passing constrain to such a service raises
    TypeError — callers that might hold one gate first (report.py catches
    it per model; the evalh CLI rejects --constrain --backend ollama up
    front)."""
    return {"constrain": constrain} if constrain is not None else {}


def evaluate_model(
    service: GenerationService,
    model: str,
    cases: Sequence[EvalCase],
    system: str,
    max_new_tokens: int = 256,
    exec_backend=None,
    constrain=None,
) -> ModelReport:
    results = []
    for case in cases:
        res = service.generate(
            model=model, prompt=case.nl, system=system,
            max_new_tokens=max_new_tokens, **_gen_kwargs(constrain),
        )
        results.append(_score(
            case, res.response.strip(), res.latency_s, res.output_tokens,
            exec_backend,
            # Duck-typed (the Ollama adapter's result objects predate the
            # decomposition fields): absent reads as not-measured.
            ttft_s=getattr(res, "ttft_s", 0.0),
            queue_wait_s=getattr(res, "queue_wait_s", 0.0),
        ))
    return ModelReport(model=model, cases=results)


def evaluate_model_batched(
    service: GenerationService,
    model: str,
    cases: Sequence[EvalCase],
    system: str,
    max_new_tokens: int = 256,
    batch_size: int = 32,
    exec_backend=None,
    constrain=None,
) -> ModelReport:
    """Batched scoring (BASELINE configs 3/4): cases run `batch_size` at a
    time through one device program; per-case latency is the batch
    wall-clock, so aggregate_tok_per_s reflects batched throughput."""
    results: List[CaseResult] = []
    wall = 0.0
    for i in range(0, len(cases), batch_size):
        chunk = cases[i : i + batch_size]
        outs = service.generate_batch(
            model=model, prompts=[c.nl for c in chunk], system=system,
            max_new_tokens=max_new_tokens, **_gen_kwargs(constrain),
        )
        # The chunk's wall-clock is the LAST result's latency: the in-tree
        # service stamps every member with the shared batch wall (all
        # equal), while the sequential Ollama adapter stamps each member
        # with the cumulative wall through itself — in both contracts
        # outs[-1] is the whole chunk.
        wall += outs[-1].latency_s
        for case, res in zip(chunk, outs):
            results.append(_score(
                case, res.response.strip(), res.latency_s,
                res.output_tokens, exec_backend,
            ))
    return ModelReport(model=model, cases=results, wall_clock_s=wall)


# Same system prompt app/pipeline.explain_error serves in production —
# the explain stage measures the same in-fleet path, not a lookalike.
EXPLAIN_SYSTEM = (
    "You are an AI that helps troubleshoot Apache Spark errors. "
    "Provide clear, concise solutions."
)


def explain_failures(
    service: GenerationService,
    explainer_model: str,
    report: ModelReport,
    max_new_tokens: int = 128,
) -> ModelReport:
    """Explain stage: route every execute-fail case's engine error through
    the in-fleet error-analysis model and return a report with
    the explanations attached.

    The explainer round trip is timed into explain_latency_s, NEVER into
    latency_s — SQL-generation latency and explainer latency answer
    different questions (how fast is NL→SQL vs. how fast is the
    diagnosis), and folding them together would make constrained-decoding
    runs look slower exactly when they fail less. The explainer prompt is
    the same shape app/pipeline.explain_error sends, so what this stage
    measures is the path production requests take on a failed execute."""
    out: List[CaseResult] = []
    for case in report.cases:
        if case.executable == 0 and case.exec_error:
            res = service.generate(
                model=explainer_model,
                system=EXPLAIN_SYSTEM,
                prompt=(
                    f"The following Spark error occurred:\n\n"
                    f"{case.exec_error}\n\n"
                    f"Please analyze this error and suggest possible "
                    f"solutions."
                ),
                max_new_tokens=max_new_tokens,
            )
            case = dataclasses.replace(
                case,
                explanation=res.response.strip() or "(empty explanation)",
                explain_latency_s=res.latency_s,
            )
        out.append(case)
    return dataclasses.replace(report, cases=out)


def evaluate_models(
    service: GenerationService,
    models: Sequence[str],
    cases: Sequence[EvalCase],
    system: str,
    max_new_tokens: int = 256,
    exec_backend=None,
    constrain=None,
) -> Dict[str, ModelReport]:
    return {
        m: evaluate_model(service, m, cases, system, max_new_tokens,
                          exec_backend=exec_backend, constrain=constrain)
        for m in models
    }


def format_summary(reports: Dict[str, ModelReport]) -> str:
    lines = ["Final Evaluation Summary:", "=" * 72]
    for model, rep in reports.items():
        lines += [
            f"Model: {model}",
            f"Exact Match Rate: {rep.exact_match_rate:.2f}%",
            f"Average Edit Distance: {rep.avg_edit_distance:.2f}",
            f"Average Latency: {rep.avg_latency_s:.4f} sec",
            f"Aggregate Throughput: {rep.aggregate_tok_per_s:.1f} tok/s",
        ]
        # Latency decomposition (scheduler-path backends): WHERE the
        # latency lives, not just how much.
        if rep.avg_ttft_s is not None:
            lines.append(f"Average TTFT: {rep.avg_ttft_s:.4f} sec")
        if rep.avg_queue_wait_s is not None:
            lines.append(
                f"Average Queue Wait: {rep.avg_queue_wait_s:.4f} sec"
            )
        if rep.execution_match_rate is not None:
            lines.append(
                f"Execution Match Rate: {rep.execution_match_rate:.2f}%"
            )
        if rep.grammar_valid_rate is not None:
            lines.append(
                f"Grammar Valid Rate: {rep.grammar_valid_rate:.2f}%"
            )
        if rep.executable_rate is not None:
            lines.append(
                f"Executable Rate: {rep.executable_rate:.2f}%"
            )
        if rep.avg_explain_latency_s is not None:
            # Explainer latency is its own line, never folded into
            # Average Latency (SQL generation) above.
            lines.append(
                f"Failures Explained: {rep.explained_failures} "
                f"(avg explainer latency "
                f"{rep.avg_explain_latency_s:.4f} sec)"
            )
        lines.append("=" * 72)
    return "\n".join(lines)

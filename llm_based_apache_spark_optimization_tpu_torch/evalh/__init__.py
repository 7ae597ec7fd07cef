"""Evaluation harness: exact-match / edit-distance / latency / tok/s.

Counterpart of the JAX package's `evalh/`: the scorer, the BASELINE configs,
the repair leg, the markdown report and the `--chaos` fault-injection run,
over the port's services and schedulers."""

from .fixtures import (  # noqa: F401
    FOUR_QUERY_SUITE,
    GRAMMAR_BREADTH_SUITE,
    SINGLE_COMPLEX_CASE,
    TAXI_DDL_SYSTEM,
    EvalCase,
)
from .harness import (  # noqa: F401
    CaseResult,
    ModelReport,
    evaluate_model,
    evaluate_models,
    format_summary,
)
from .metrics import edit_distance, exact_match  # noqa: F401

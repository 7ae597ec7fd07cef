"""Llama-family model configs and the transformer forward (`models.llama`)."""

from .configs import (  # noqa: F401
    BENCH_1B,
    DUCKDB_NSQL_7B,
    LLAMA32_1B,
    LLAMA32_3B,
    MISTRAL_7B,
    REGISTRY,
    TINY,
    LlamaConfig,
    RopeFreqFactors,
    RopeScaling,
)

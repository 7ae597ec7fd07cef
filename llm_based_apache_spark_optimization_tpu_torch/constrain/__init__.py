"""Grammar-constrained SQL decoding: the engine can only emit valid Spark SQL.

A compact Spark-SQL SELECT grammar is compiled to a token-level DFA whose
per-state vocabulary tables ride the decode loops as device tensors:
sampling cannot pick a token that leaves the language, and budget-aware
masks steer every completion to a full parse before the token budget runs
out.

Layering (each module's docstring carries the detail):

    dfa.py      regex combinators -> NFA -> trimmed char DFA (+ difference)
    grammar.py  the SELECT subset; generic or schema-aware identifiers
    parser.py   independent recursive-descent oracle
    masks.py    tokenizer classification -> [states, vocab] tables,
                shortest-distance closing rows, per-process compile cache,
                the device tables and the per-step torch ops

Counterpart of the JAX package's `constrain/` (same exports, plus the
per-step ops `allowed_tokens`, `advance_states` and `table_bytes`).
Integration points: `ops/sampling.apply_token_mask`, the constrained
branch of `engine/generate`, per-slot FSM state in `serve/scheduler`, the
`constrain` request field in `serve/service` and `app/api`, and
`constrain_sql` in `app/pipeline`.
"""

from .dfa import CharDfa, compile_dfa, difference
from .grammar import RESERVED, grammar_fingerprint, spark_sql_dfa
from .masks import (
    CompiledMask,
    ConstraintSpec,
    advance_states,
    allowed_tokens,
    compile_token_masks,
    fsm_advance_chain,
    get_constraint,
    table_bytes,
    trivial_tables,
)
from .parser import SqlSyntaxError, is_valid_spark_sql, parse_spark_sql

__all__ = [
    "CharDfa",
    "CompiledMask",
    "ConstraintSpec",
    "RESERVED",
    "SqlSyntaxError",
    "advance_states",
    "allowed_tokens",
    "compile_dfa",
    "compile_token_masks",
    "difference",
    "fsm_advance_chain",
    "get_constraint",
    "grammar_fingerprint",
    "is_valid_spark_sql",
    "parse_spark_sql",
    "spark_sql_dfa",
    "table_bytes",
    "trivial_tables",
]

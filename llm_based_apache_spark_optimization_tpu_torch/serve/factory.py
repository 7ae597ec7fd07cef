"""Reference-service assembly: the role -> model -> template mapping of the
reference's three-model zoo (`duckdb-nsql` NL->SQL completion, `llama3.2`
error analysis on the llama3 chat template, optional `mistral` on [INST])
and the shared-weights aliasing rule.

Counterpart of the JAX package's `serve/factory.py`
(`assemble_reference_service`); its multi-model and standby-fleet
assemblies wait for the fleet (ROADMAP A11).
"""

from __future__ import annotations

from typing import Callable, Optional

from .service import GenerationService


def assemble_reference_service(
    build: Callable[[str, bool], object],
    sql_src: str,
    error_src: Optional[str] = None,
    mistral_src: Optional[str] = None,
    *,
    max_new_tokens: int = 256,
) -> GenerationService:
    """`build(src, add_bos) -> backend` supplies loaded backends; this
    assembles the registry.

    - llama3-chat's rendered prompt starts with <|begin_of_text|>, so the
      error-analysis backend must not prepend a second BOS.
    - Without a separate error model, the error role reuses the SQL
      backend's loaded engine or scheduler (one copy of the weights, one
      slot pool): only the template and add_bos differ.
    """
    from .backends import EngineBackend
    from .scheduler import SchedulerBackend

    svc = GenerationService()
    sql_backend = build(sql_src, True)
    svc.register("duckdb-nsql", sql_backend)
    if error_src:
        error_backend = build(error_src, False)
    elif isinstance(sql_backend, SchedulerBackend):
        error_backend = SchedulerBackend(
            sql_backend.scheduler, sql_backend.tokenizer,
            max_new_tokens=max_new_tokens, add_bos=False,
        )
    else:
        error_backend = EngineBackend(
            sql_backend.engine, sql_backend.tokenizer,
            max_new_tokens=max_new_tokens, add_bos=False,
        )
    svc.register("llama3.2", error_backend, template="llama3-chat")
    if mistral_src:
        svc.register("mistral", build(mistral_src, True),
                     template="mistral-instruct")
    return svc

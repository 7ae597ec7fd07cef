"""Service assembly: the `LSOT_MODELS` fleet, and the role -> model ->
template mapping of the reference's three-model zoo (`duckdb-nsql` NL->SQL
completion, `llama3.2` error analysis on the llama3 chat template, optional
`mistral` on [INST]) with its shared-weights aliasing rule.

Counterpart of the JAX package's `serve/factory.py`
(`assemble_multimodel_service`, `assemble_reference_service`); its standby
fleet spawner waits for remote replicas (ROADMAP A11's remote half).
"""

from __future__ import annotations

from typing import Callable, Optional

from .service import GenerationService


def assemble_multimodel_service(
    spec,
    *,
    max_new_tokens: int = 48,
    supervise: bool = False,
    num_slots: int = 2,
    total_pages: int = 0,
    seed: int = 0,
    device=None,
    pool_options: Optional[dict] = None,
    scheduler_options: Optional[dict] = None,
):
    """The `LSOT_MODELS` tiny fleet: co-resident checkpoints in one
    scheduler pool that routes on `model_id`. `spec` is the `LSOT_MODELS`
    string or a parsed list of `ModelSpec`. Only `tiny` sources assemble
    here; `hf`/`gguf` sources load through `app/__main__.py --backend
    checkpoint`. `pool_options` and `scheduler_options` go to the
    `SchedulerPool` and to every scheduler. Returns `(service, pool,
    registry)`.

    With `LSOT_MODELS` set this replaces `assemble_reference_service`: the
    error model is its own registered checkpoint, not an alias of the SQL
    model's weights."""
    from .modelpool import build_tiny_model_service, parse_models_spec

    specs = parse_models_spec(spec) if isinstance(spec, str) else list(spec)
    if not specs:
        raise ValueError("LSOT_MODELS is empty")
    bad = [m.model_id for m in specs if m.source != "tiny"]
    if bad:
        raise ValueError(
            f"models {bad} have hf/gguf sources — assemble real checkpoints "
            f"through --backend checkpoint (this path builds the tiny fleet)")
    return build_tiny_model_service(
        specs, num_slots=num_slots, total_pages=total_pages,
        max_new_tokens=max_new_tokens, supervise=supervise, seed=seed,
        device=device, pool_options=pool_options, scheduler_options=scheduler_options)


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

"""Generation service: a registry of named models and `generate`, the call
shape of `ollama.generate(model=..., system=..., prompt=...)`.

Counterpart of the JAX package's `serve/service.py` (registry, templates,
per-model stats); its tracing, QoS, Prometheus and fleet hooks are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from ..ops.sampling import SamplingParams
from .templates import TEMPLATES, Template


@dataclasses.dataclass(frozen=True)
class GenerateResult:
    response: str
    model: str
    latency_s: float
    output_tokens: int
    ttft_s: float = 0.0
    prompt_tokens: int = 0

    @property
    def tok_per_s(self) -> float:
        return self.output_tokens / self.latency_s if self.latency_s > 0 else 0.0


@dataclasses.dataclass
class ModelEntry:
    name: str
    backend: object  # EngineBackend (duck-typed .complete / .complete_batch)
    template: Template


class GenerationService:
    """Named-model registry + generate()."""

    def __init__(self):
        self._models: Dict[str, ModelEntry] = {}
        self._lock = threading.Lock()
        self.stats: Dict[str, Dict[str, float]] = {}

    def register(self, name: str, backend, template: str = "completion") -> None:
        if template not in TEMPLATES:
            raise ValueError(f"unknown template {template!r}; choices {sorted(TEMPLATES)}")
        with self._lock:
            self._models[name] = ModelEntry(name, backend, TEMPLATES[template])
            self.stats.setdefault(
                name, {"requests": 0, "total_latency_s": 0.0, "total_tokens": 0}
            )

    def models(self):
        return sorted(self._models)

    def _entry(self, model: str) -> ModelEntry:
        entry = self._models.get(model)
        if entry is None:
            raise KeyError(
                f"model {model!r} is not registered; available: {self.models()}"
            )
        return entry

    def _record(self, model: str, n_requests: int, latency: float,
                tokens: int) -> None:
        with self._lock:
            s = self.stats[model]
            s["requests"] += n_requests
            s["total_latency_s"] += latency
            s["total_tokens"] += tokens

    def generate(
        self,
        model: str,
        prompt: str,
        system: str = "",
        max_new_tokens: Optional[int] = None,
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
    ) -> GenerateResult:
        entry = self._entry(model)
        rendered = entry.template(system, prompt)
        t0 = time.perf_counter()
        completion = entry.backend.complete(
            rendered, max_new_tokens=max_new_tokens, sampling=sampling, seed=seed,
        )
        latency = time.perf_counter() - t0
        self._record(model, 1, latency, completion.output_tokens)
        return GenerateResult(
            response=completion.text, model=model, latency_s=latency,
            output_tokens=completion.output_tokens, ttft_s=completion.ttft_s,
            prompt_tokens=completion.prompt_tokens,
        )

    def generate_batch(
        self,
        model: str,
        prompts: List[str],
        system: str = "",
        max_new_tokens: Optional[int] = None,
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
    ) -> List[GenerateResult]:
        """Batched twin of generate(): one device program for all prompts.
        Each result's latency is the batch's wall clock."""
        entry = self._entry(model)
        rendered = [entry.template(system, p) for p in prompts]
        t0 = time.perf_counter()
        completions = entry.backend.complete_batch(
            rendered, max_new_tokens=max_new_tokens, sampling=sampling, seed=seed,
        )
        latency = time.perf_counter() - t0
        self._record(model, len(prompts), latency,
                     sum(c.output_tokens for c in completions))
        return [
            GenerateResult(
                response=c.text, model=model, latency_s=latency,
                output_tokens=c.output_tokens, ttft_s=c.ttft_s,
                prompt_tokens=c.prompt_tokens,
            )
            for c in completions
        ]

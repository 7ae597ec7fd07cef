"""Client adapter for a LIVE Ollama server — score the reference's own
engine with the in-tree instrument.

The reference measures its models by calling `ollama.generate(...)` against
a local Ollama daemon (reference `Model_Evaluation_&_Comparision.py:69,83`;
`Flask/app.py:102-107`). This adapter exposes that daemon through the same
duck-typed service surface the eval harness and BASELINE configs consume
(`generate` / `generate_batch` / `models` — serve/service.py), so an
operator with the reference's exact setup can score the reference engine
in the same report tables as the in-tree engine (the eval harness,
`evalh`, with `--backend ollama`).

A copy of the JAX package's `serve/ollama_client.py` (host code: an HTTP
client, no device).

Wire protocol (the subset ollama-python uses): POST /api/generate with
{model, prompt, system, stream: false, options:{num_predict, temperature,
top_p, top_k, seed}}; GET /api/tags for the model list. stdlib urllib only
— no client library needed, and the in-tree WSGI fake in the tests speaks
the same two routes.

`generate_batch` loops sequentially on purpose: Ollama serializes requests
(the reference's own serving behavior — `FastAPI/app.py:85-90` notes), and
reporting a fake batched wall-clock would flatter it.
"""

from __future__ import annotations

import json
import random
import time
import urllib.request
from typing import List, Optional

from ..utils.faults import FAULTS, InjectedFault
from .resilience import CircuitBreaker, RetryPolicy
from .service import GenerateResult


class OllamaClientService:
    """Duck-typed GenerationService over a live Ollama HTTP endpoint.

    Fault tolerance (serve/resilience.py): connect-phase failures — the
    request never reached the daemon, so replaying cannot double-generate —
    retry with capped exponential backoff + full jitter; repeated failures
    open a per-service circuit breaker so a down daemon sheds calls
    instantly (CircuitOpen) instead of burning a connect timeout per
    request. HTTP error responses (the daemon answered: model not found,
    bad request) are NEVER retried and count as breaker successes — the
    dependency is up. Chaos seam: `ollama:connect` (utils/faults.py)."""

    def __init__(self, base_url: str = "http://127.0.0.1:11434",
                 timeout_s: float = 300.0,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self._retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
        )
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            f"ollama {self.base_url}", failure_threshold=5, reset_after_s=10.0,
        )
        self._rng = random.Random()  # backoff jitter only
        # Kept for surface parity with GenerationService consumers that
        # read .stats (the /models route); remote requests are accounted
        # by the harness itself.
        self.stats: dict = {}

    # ----------------------------------------------------------- plumbing

    @staticmethod
    def _connect_phase(e: BaseException) -> bool:
        """Safe to retry: the request never reached the daemon. HTTPError
        subclasses URLError but IS a server response — excluded."""
        import urllib.error

        return isinstance(
            e, (urllib.error.URLError, InjectedFault, OSError)
        ) and not isinstance(e, urllib.error.HTTPError)

    def _open(self, req) -> dict:
        # Surface the server's JSON error body ("model 'x' not found",
        # overload, ...) instead of a bare HTTPError traceback that aborts
        # a multi-model report with no explanation.
        import urllib.error

        if not self._breaker.allow():
            raise self._breaker.shed()

        def attempt() -> dict:
            # Duration-valued stall seam (`ollama:stall:p:secs`): a daemon
            # that accepts the connection and answers SLOWLY — the check
            # sleeps, then the request proceeds, so deadline/timeout
            # handling above this call is exercised against real elapsed
            # time instead of an instant error.
            FAULTS.check("ollama:stall")
            FAULTS.check("ollama:connect")
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.load(r)

        try:
            out = self._retry.call(
                attempt, retryable=self._connect_phase, rng=self._rng,
            )
        except urllib.error.HTTPError as e:
            # The daemon responded: it is UP (breaker-wise), the request
            # itself is bad.
            self._breaker.record_success()
            body = e.read().decode(errors="replace")[:500]
            raise RuntimeError(
                f"ollama server returned {e.code} for "
                f"{getattr(req, 'full_url', req)}: {body}"
            ) from e
        except (urllib.error.URLError, OSError) as e:
            self._breaker.record_failure()
            reason = getattr(e, "reason", e)
            raise RuntimeError(
                f"cannot reach ollama at {self.base_url}: {reason} — is "
                f"the daemon running (`ollama serve`)?"
            ) from e
        except Exception:
            # Anything else (e.g. a 200 with a non-JSON body: proxy error
            # page, truncated response) is still an unhealthy dependency —
            # and EVERY outcome must be recorded: a half-open probe that
            # escaped both clauses above would otherwise keep its permit
            # (_probing) forever and wedge the breaker open.
            self._breaker.record_failure()
            raise
        self._breaker.record_success()
        return out

    def _get(self, path: str) -> dict:
        return self._open(self.base_url + path)

    def _post(self, path: str, payload: dict) -> dict:
        return self._open(urllib.request.Request(
            self.base_url + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        ))

    # ------------------------------------------------------------ surface

    def models(self) -> List[str]:
        return sorted(m["name"] for m in self._get("/api/tags")
                      .get("models", []))

    def generate(
        self,
        model: str,
        prompt: str,
        system: str = "",
        max_new_tokens: Optional[int] = None,
        sampling=None,
        seed: int = 0,
    ) -> GenerateResult:
        # sampling=None means GREEDY everywhere in-tree (SamplingParams
        # defaults temperature=0) — send that explicitly: Ollama's own
        # default is ~0.8, and letting it sample while the in-tree rows
        # decode greedily would make the side-by-side table stochastic
        # and skewed.
        options: dict = {"seed": seed, "temperature": 0.0}
        if max_new_tokens is not None:
            options["num_predict"] = int(max_new_tokens)
        if sampling is not None:
            options["temperature"] = float(sampling.temperature)
            options["top_p"] = float(sampling.top_p)
            if sampling.top_k:
                options["top_k"] = int(sampling.top_k)
        t0 = time.perf_counter()
        data = self._post("/api/generate", {
            "model": model,
            "prompt": prompt,
            "system": system,
            "stream": False,
            "options": options,
        })
        latency = time.perf_counter() - t0
        # eval_count is Ollama's own output-token count; fall back to a
        # whitespace estimate for servers that omit it.
        toks = int(data.get("eval_count") or
                   max(1, len(str(data.get("response", "")).split())))
        return GenerateResult(
            response=str(data.get("response", "")),
            model=model,
            latency_s=latency,
            output_tokens=toks,
        )

    def generate_batch(
        self,
        model: str,
        prompts: List[str],
        system: str = "",
        max_new_tokens: Optional[int] = None,
        sampling=None,
        seed: int = 0,
    ) -> List[GenerateResult]:
        # Sequential on purpose (module docstring): the measured wall IS
        # the reference engine's serialized serving behavior. Request i's
        # submitted-together latency is therefore the CUMULATIVE wall
        # through i (it waited for requests 0..i-1 first), not the whole
        # chunk's sum — stamping every member with the total inflated the
        # reference engine's avg_latency_s ~batch/2x in the side-by-side
        # tables this adapter exists to keep honest (ADVICE.md r5 #1).
        # Contract the harness reads: results[-1].latency_s IS the chunk
        # wall (equals the shared batch wall GenerationService stamps on
        # every member), which evaluate_model_batched sums for
        # aggregate tok/s.
        results: List[GenerateResult] = []
        wall = 0.0
        for p in prompts:
            r = self.generate(model, p, system, max_new_tokens, sampling,
                              seed)
            wall += r.latency_s
            results.append(GenerateResult(
                response=r.response, model=r.model, latency_s=wall,
                output_tokens=r.output_tokens,
            ))
        return results

    def close(self) -> None:  # surface parity; nothing to shut down
        pass

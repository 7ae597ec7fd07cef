"""Completion backends: the text -> text seam under the generation service.

`EngineBackend` tokenizes, runs `engine.generate` and detokenizes; it is
the counterpart of the JAX package's `serve/backends.EngineBackend` with its
deadline clamp (a request's remaining deadline exchanged for a step budget
at the measured seconds a token), its grammar constraint (a `constrain=`
spec, "spark_sql" or a {"table", "columns"} schema, compiled once per
tokenizer through `resolve_constraint`) and its checkpoint constructors
(`from_hf_checkpoint`, `from_gguf`). `FakeBackend` answers canned text
(demos and tests) and takes no constraint.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence

import torch

from ..engine.generate import InferenceEngine
from ..ops.sampling import SamplingParams
from ..tokenizer.base import Tokenizer


def resolve_stop_ids(cfg, tokenizer) -> tuple:
    """Union of the config's stop ids and every stop id the tokenizer
    declares (`eos_ids`): either alone under-stops llama-3.x chat models."""
    ids = list(cfg.stop_ids)
    for i in getattr(tokenizer, "eos_ids", ()):
        if i not in ids:
            ids.append(i)
    return tuple(ids)


def resolve_constraint(constrain, tokenizer, stop_ids):
    """Spec ("spark_sql" / {"table", "columns"} / CompiledMask) -> the
    compiled grammar tables for a backend's tokenizer and stop ids; None
    passes through. `get_constraint` caches per (tokenizer, grammar, stop
    ids), so repeated requests reuse the same tables. Shared by
    EngineBackend and SchedulerBackend."""
    if constrain is None:
        return None
    from ..constrain import get_constraint

    return get_constraint(constrain, tokenizer, stop_ids)


def refuse_unported_load(mesh=None, quantize_int8=False, quantize_int4=False,
                         quantize_unembed8=False, speculative_draft=0) -> None:
    """Raise, naming the ROADMAP item, on a checkpoint-constructor option
    the port cannot honor yet."""
    if quantize_int8 and quantize_int4:
        raise ValueError("pick one of quantize_int8 / quantize_int4")
    refused = [
        (mesh is not None, "mesh", "A13 (parallelism)"),
        (quantize_int8, "quantize_int8", "A10 (int8 weights)"),
        (quantize_unembed8, "quantize_unembed8", "A10 (int8 embeddings)"),
        (speculative_draft > 0, "speculative_draft",
         "A9 (speculative decoding)"),
    ]
    for on, name, item in refused:
        if on:
            raise NotImplementedError(f"{name} is not ported: ROADMAP {item}")


@dataclasses.dataclass
class Completion:
    text: str
    output_tokens: int
    prompt_tokens: int = 0
    # Seconds from the engine call to its first sampled token.
    ttft_s: float = 0.0


def trim_stop_texts(text: str, stop_texts: Sequence[str]) -> str:
    """Cut the completion at the first occurrence of any stop string."""
    for stop in stop_texts:
        cut = text.find(stop)
        if cut != -1:
            text = text[:cut]
    return text


class EngineBackend:
    """Tokenize -> engine.generate -> detokenize. One lock per backend
    serialises the device work.

    Set `add_bos=False` for chat templates whose rendered prompt already
    begins with the BOS string (llama3-chat's <|begin_of_text|>).
    `sec_per_tok_seed` primes the deadline clamp's seconds-a-token rate;
    without it the first request after start runs unclamped."""

    #: GenerationService forwards a `deadline_s` only to backends that set
    #: this: the engine cannot retire a request mid-decode, so it clamps
    #: the step budget at issue time and fails an expired one before any
    #: device work.
    supports_deadline = True
    #: GenerationService forwards a `constrain=` spec only to backends that
    #: set this.
    supports_constrain = True

    def __init__(
        self,
        engine: InferenceEngine,
        tokenizer: Tokenizer,
        max_new_tokens: int = 256,
        sampling: SamplingParams = SamplingParams(),
        stop_texts: Sequence[str] = (),
        add_bos: bool = True,
        sec_per_tok_seed: Optional[float] = None,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling
        self.stop_texts = tuple(stop_texts)
        self.add_bos = add_bos
        self._lock = threading.Lock()
        # EWMA of seconds an output token over completed requests: the
        # deadline -> step budget exchange rate. The first completion of
        # each (batch, padded prompt) shape is discarded.
        self._sec_per_tok: Optional[float] = (
            float(sec_per_tok_seed)
            if sec_per_tok_seed is not None and sec_per_tok_seed > 0 else None)
        self._rate_warm_shapes: set = set()

    @classmethod
    def from_hf_checkpoint(cls, ckpt_dir: str, tokenizer: Tokenizer, **kwargs
                           ) -> "EngineBackend":
        """An engine backend straight from an HF safetensors directory,
        its weights loaded onto `device` (default CUDA) one stacked
        parameter at a time. `quantize_int4=True` packs the block weights
        to int4 (served by the int4 matmul kernel); `kv_quant="int8"`
        stores the KV cache in int8. The other arguments are those of the
        JAX package's `EngineBackend.from_hf_checkpoint`; what the port
        cannot honor yet raises and names its ROADMAP item."""
        from ..checkpoint import load_hf_checkpoint

        return cls._from_checkpoint(
            lambda dtype, device: load_hf_checkpoint(
                ckpt_dir, dtype=dtype or torch.bfloat16, device=device),
            tokenizer, **kwargs)

    @classmethod
    def from_gguf(cls, gguf_path: str, tokenizer: Tokenizer, cfg=None,
                  **kwargs) -> "EngineBackend":
        """An engine backend from a GGUF blob, parsed and dequantized by
        the port's C++ reader (checkpoint/gguf.py); otherwise as
        `from_hf_checkpoint`."""
        from ..checkpoint import load_gguf_checkpoint

        return cls._from_checkpoint(
            lambda dtype, device: load_gguf_checkpoint(
                gguf_path, cfg=cfg, dtype=dtype, device=device),
            tokenizer, **kwargs)

    @classmethod
    def _from_checkpoint(
        cls, load, tokenizer: Tokenizer, mesh=None, dtype=None,
        prompt_bucket: int = 128, stop_ids: Optional[Sequence[int]] = None,
        quantize_int8: bool = False, quantize_int4: bool = False,
        quantize_unembed8: bool = False, speculative_draft: int = 0,
        kv_quant=None, device=None, **kwargs,
    ) -> "EngineBackend":
        from .. import resolve_device

        refuse_unported_load(mesh, quantize_int8, quantize_int4,
                             quantize_unembed8, speculative_draft)
        dev = resolve_device(device)
        cfg, params = load(dtype, dev)
        if quantize_int4:
            from ..ops.quant import quantize_params_int4

            params = quantize_params_int4(params)
        engine = InferenceEngine(
            cfg, params, prompt_bucket=prompt_bucket, device=dev,
            stop_ids=stop_ids if stop_ids is not None
            else resolve_stop_ids(cfg, tokenizer),
            kv_quant=kv_quant,
        )
        return cls(engine, tokenizer, **kwargs)

    def _room(self, n_prompt_tokens: int) -> int:
        """Context room left after the bucketed prompt."""
        cfg = self.engine.cfg
        room = cfg.max_seq_len - self.engine.padded_prompt_len(n_prompt_tokens)
        if room < 1:
            raise ValueError(
                f"prompt ({n_prompt_tokens} tokens) leaves no room in the "
                f"{cfg.max_seq_len}-token context of {cfg.name}"
            )
        return room

    def _budget(self, n_prompt_tokens: int, max_new_tokens: Optional[int]) -> int:
        """The requested budget, clamped to the context room (a serving
        backend degrades to a shorter completion instead of erroring)."""
        return min(max_new_tokens or self.max_new_tokens, self._room(n_prompt_tokens))

    def check_budget(self, prompt: str, max_new_tokens: Optional[int] = None,
                     constraint=None) -> None:
        """Raise the ValueError `complete` would raise for a prompt that
        leaves no decode room, without generating; with a compiled
        `constraint`, also when the clamped budget cannot hold the
        grammar's shortest complete parse."""
        budget = self._budget(len(self.tokenizer.encode(prompt, add_bos=self.add_bos)),
                              max_new_tokens)
        if constraint is not None and budget < constraint.min_new_tokens:
            raise ValueError(
                f"decode budget {budget} (after the context-room clamp) "
                f"cannot hold a complete constrained parse (grammar needs "
                f">= {constraint.min_new_tokens} tokens)")

    def _resolve_constraint(self, constrain):
        return resolve_constraint(constrain, self.tokenizer, self.engine.stop_ids)

    @staticmethod
    def _make_deadline(deadline_s: Optional[float]):
        """Stamp the deadline at request entry, so time queued behind
        another decode on this serialised engine is charged too."""
        if deadline_s is None:
            return None
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        from .resilience import Deadline

        return Deadline.after(deadline_s)

    def _deadline_budget(self, budget: int, deadline) -> int:
        """Exchange the remaining deadline for a step budget at the measured
        rate. Expired (or unaffordable even for one token) fails typed
        `DeadlineExceeded` before the device is touched."""
        if deadline is None:
            return budget
        from ..utils.observability import resilience
        from .resilience import DeadlineExceeded

        remaining = deadline.remaining()
        if remaining <= 0:
            resilience.inc("deadline_expired")
            raise DeadlineExceeded(
                "request deadline expired before issue (burned queueing "
                "behind the serialized engine)")
        rate = self._sec_per_tok
        if rate is None or rate <= 0:
            return budget
        afford = int(remaining / rate)
        if afford < 1:
            resilience.inc("deadline_expired")
            raise DeadlineExceeded(
                f"remaining deadline of {remaining:.3f}s cannot afford one "
                f"token at the measured {rate:.4f}s/token — not issued")
        if afford < budget:
            resilience.inc("deadline_clamps")
            return afford
        return budget

    def _record_rate(self, wall_s: float, output_tokens: int, shape: tuple) -> None:
        if output_tokens < 1 or wall_s <= 0:
            return
        if shape not in self._rate_warm_shapes:
            self._rate_warm_shapes.add(shape)  # first run of a shape: discard
            return
        rate = wall_s / output_tokens
        prev = self._sec_per_tok
        self._sec_per_tok = rate if prev is None else 0.2 * rate + 0.8 * prev

    def _completion(self, prompt_ids: List[int], out: List[int]) -> Completion:
        if out and out[-1] in self.engine.stop_ids:
            out = out[:-1]  # strip the stop token itself from the text
        text = trim_stop_texts(self.tokenizer.decode(out), self.stop_texts)
        return Completion(text=text, output_tokens=len(out),
                          prompt_tokens=len(prompt_ids),
                          ttft_s=self.engine.last_stats.get("ttft_s", 0.0))

    def complete(self, prompt: str, max_new_tokens: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None, seed: int = 0,
                 deadline_s: Optional[float] = None, constrain=None) -> Completion:
        deadline = self._make_deadline(deadline_s)
        ids = self.tokenizer.encode(prompt, add_bos=self.add_bos)
        budget = self._budget(len(ids), max_new_tokens)
        # Compiled (once per grammar) outside the timed window: a one-off
        # precompute inside it would poison the deadline's s/token rate.
        constraint = self._resolve_constraint(constrain)
        with self._lock:
            budget = self._deadline_budget(budget, deadline)
            t0 = time.perf_counter()
            out = self.engine.generate(
                [ids], max_new_tokens=budget,
                sampling=sampling or self.sampling, seed=seed,
                constraint=constraint,
            )[0]
            self._record_rate(time.perf_counter() - t0, len(out),
                              (1, self.engine.padded_prompt_len(len(ids))))
            return self._completion(ids, out)

    def complete_batch(
        self, prompts: Sequence[str], max_new_tokens: Optional[int] = None,
        sampling: Optional[SamplingParams] = None, seed: int = 0,
        deadline_s: Optional[float] = None, constrain=None,
    ) -> List[Completion]:
        """One batched prefill and decode loop for all prompts; a deadline
        clamps the shared step budget."""
        deadline = self._make_deadline(deadline_s)
        ids = [self.tokenizer.encode(p, add_bos=self.add_bos) for p in prompts]
        longest = max(len(i) for i in ids)
        budget = self._budget(longest, max_new_tokens)
        constraint = self._resolve_constraint(constrain)  # outside the timer
        with self._lock:
            budget = self._deadline_budget(budget, deadline)
            t0 = time.perf_counter()
            outs = self.engine.generate(
                ids, max_new_tokens=budget,
                sampling=sampling or self.sampling, seed=seed,
                constraint=constraint,
            )
            self._record_rate(time.perf_counter() - t0,
                              max((len(o) for o in outs), default=0),
                              (len(ids), self.engine.padded_prompt_len(longest)))
            return [self._completion(i, o) for i, o in zip(ids, outs)]


class FakeBackend:
    """Deterministic canned backend: `fn(prompt) -> text`."""

    def __init__(self, fn: Callable[[str], str]):
        self.fn = fn
        self.calls: List[str] = []

    def complete(self, prompt: str, max_new_tokens: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None, seed: int = 0) -> Completion:
        self.calls.append(prompt)
        text = self.fn(prompt)
        return Completion(
            text=text,
            output_tokens=len(text.split()),
            prompt_tokens=len(prompt.split()),
        )

    def complete_batch(self, prompts, max_new_tokens=None, sampling=None,
                       seed: int = 0) -> List[Completion]:
        return [self.complete(p, max_new_tokens, sampling, seed) for p in prompts]

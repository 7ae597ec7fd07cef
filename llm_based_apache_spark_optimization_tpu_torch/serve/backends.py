"""Completion backends: the text -> text seam under the generation service.

`EngineBackend` tokenizes, runs `engine.generate` and detokenizes; it is
the counterpart of the JAX package's `serve/backends.EngineBackend`
(without its grammar constraint, deadline clamp and checkpoint loaders).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence

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
    begins with the BOS string (llama3-chat's <|begin_of_text|>)."""

    def __init__(
        self,
        engine: InferenceEngine,
        tokenizer: Tokenizer,
        max_new_tokens: int = 256,
        sampling: SamplingParams = SamplingParams(),
        stop_texts: Sequence[str] = (),
        add_bos: bool = True,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling
        self.stop_texts = tuple(stop_texts)
        self.add_bos = add_bos
        self._lock = threading.Lock()

    def _budget(self, n_prompt_tokens: int, max_new_tokens: Optional[int]) -> int:
        """The requested budget, clamped to the context room left after the
        bucketed prompt (a serving backend degrades to a shorter completion
        instead of erroring)."""
        cfg = self.engine.cfg
        room = cfg.max_seq_len - self.engine.padded_prompt_len(n_prompt_tokens)
        if room < 1:
            raise ValueError(
                f"prompt ({n_prompt_tokens} tokens) leaves no room in the "
                f"{cfg.max_seq_len}-token context of {cfg.name}"
            )
        return min(max_new_tokens or self.max_new_tokens, room)

    def _completion(self, prompt_ids: List[int], out: List[int]) -> Completion:
        if out and out[-1] in self.engine.stop_ids:
            out = out[:-1]  # strip the stop token itself from the text
        text = trim_stop_texts(self.tokenizer.decode(out), self.stop_texts)
        return Completion(text=text, output_tokens=len(out),
                          prompt_tokens=len(prompt_ids),
                          ttft_s=self.engine.last_stats.get("ttft_s", 0.0))

    def complete(self, prompt: str, max_new_tokens: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None,
                 seed: int = 0) -> Completion:
        ids = self.tokenizer.encode(prompt, add_bos=self.add_bos)
        budget = self._budget(len(ids), max_new_tokens)
        with self._lock:
            out = self.engine.generate(
                [ids], max_new_tokens=budget,
                sampling=sampling or self.sampling, seed=seed,
            )[0]
            return self._completion(ids, out)

    def complete_batch(
        self, prompts: Sequence[str], max_new_tokens: Optional[int] = None,
        sampling: Optional[SamplingParams] = None, seed: int = 0,
    ) -> List[Completion]:
        """One batched prefill and decode loop for all prompts."""
        ids = [self.tokenizer.encode(p, add_bos=self.add_bos) for p in prompts]
        budget = self._budget(max(len(i) for i in ids), max_new_tokens)
        with self._lock:
            outs = self.engine.generate(
                ids, max_new_tokens=budget,
                sampling=sampling or self.sampling, seed=seed,
            )
            return [self._completion(i, o) for i, o in zip(ids, outs)]

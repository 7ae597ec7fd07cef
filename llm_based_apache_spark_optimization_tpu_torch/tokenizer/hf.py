"""HF tokenizer.json adapter — loads real model vocabularies.

A copy of the JAX package's `tokenizer/hf.py`. The production models
(duckdb-nsql-7B = Llama-2 SentencePiece lineage, Llama-3.2 = tiktoken-style
BPE) ship `tokenizer.json` files with their HF checkpoints; the `tokenizers`
library executes them exactly. This adapter wraps it behind the Tokenizer
protocol. Without the `tokenizers` package it raises: no other tokenizer
stands in for a checkpoint's own.
"""

from __future__ import annotations

from typing import List, Optional


class HFTokenizer:
    def __init__(self, path: str, bos_id: Optional[int] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0):
        try:
            from tokenizers import Tokenizer as _HFT
        except ImportError as e:
            raise RuntimeError("the 'tokenizers' package is required for HFTokenizer") from e
        import os

        if os.path.isdir(path):  # checkpoint dir -> its tokenizer.json
            path = os.path.join(path, "tokenizer.json")
        self._tok = _HFT.from_file(path)
        def _id(*names: str) -> Optional[int]:
            for n in names:
                i = self._tok.token_to_id(n)
                if i is not None:
                    return i
            return None
        if bos_id is None:
            bos_id = _id("<s>", "<|begin_of_text|>")
        if eos_id is None:
            eos_id = _id("</s>", "<|end_of_text|>", "<|eot_id|>")
        # Explicit None checks: a special token legitimately living at id 0
        # must not be treated as missing.
        self.bos_id = 1 if bos_id is None else bos_id
        self.eos_id = 2 if eos_id is None else eos_id
        self.pad_id = pad_id
        # The FULL stop set present in this vocabulary: llama-3.x chat turns
        # end at <|eot_id|> (tool calls at <|eom_id|>) while plain completion
        # ends at <|end_of_text|> — a chat model served with only one of
        # these runs past the real stop. Backends union this with the
        # checkpoint config's stop list (serve/backends.py).
        self.eos_ids: tuple = tuple(
            i for i in (
                self.eos_id,
                _id("</s>"), _id("<|end_of_text|>"),
                _id("<|eot_id|>"), _id("<|eom_id|>"),
            )
            if i is not None
        )
        self.eos_ids = tuple(dict.fromkeys(self.eos_ids))  # dedupe, keep order

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

"""Tokenizer protocol: the text↔ids boundary of the in-tree engine.

In the reference all tokenization happens inside llama.cpp behind Ollama
(SURVEY.md §2.3 row 1); here it is a first-class, testable layer. Every
implementation is pure-host code — token id arrays are the only thing that
crosses to the device.
"""

from __future__ import annotations

from typing import List, Protocol, runtime_checkable


@runtime_checkable
class Tokenizer(Protocol):
    bos_id: int
    eos_id: int
    pad_id: int

    @property
    def vocab_size(self) -> int: ...

    def encode(self, text: str, add_bos: bool = True) -> List[int]: ...

    def decode(self, ids: List[int]) -> str: ...

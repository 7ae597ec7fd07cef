"""Byte-level tokenizer: every UTF-8 byte is one token.

The deterministic baseline tokenizer — no vocabulary assets, perfectly
reversible, used by the tiny CI models and as the fallback when no trained
BPE vocabulary is on disk. Layout: ids [0, n_special) are special tokens,
id n_special + b is byte value b.
"""

from __future__ import annotations

from typing import List


class ByteTokenizer:
    def __init__(self, pad_id: int = 0, bos_id: int = 1, eos_id: int = 2,
                 n_special: int = 3):
        assert n_special > max(pad_id, bos_id, eos_id)
        self.pad_id = pad_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.n_special = n_special

    @property
    def vocab_size(self) -> int:
        return self.n_special + 256

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [self.n_special + b for b in text.encode("utf-8")]
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        # Skip specials and any ids beyond the byte alphabet (a model may have
        # vocab_size > 256 + n_special; those ids have no byte expansion).
        data = bytes(
            i - self.n_special
            for i in ids
            if self.n_special <= i < self.n_special + 256
        )
        return data.decode("utf-8", errors="replace")

"""Byte-level BPE: trainable, asset-file-backed, llama.cpp-tokenizer-parity.

A copy of the JAX package's `tokenizer/bpe.py`, with the same file format,
so a tokenizer saved by either package loads in the other. Byte-level means
the base alphabet is the 256 byte values — any input is encodable, no unk
token.

Encoding is the classic lowest-rank-first merge loop, in Python (the JAX
package's C++ encoder of the same loop waits for ROADMAP A14).

File format (JSON): {"n_special": int, "merges": [[a, b], ...]} where merging
the pair (a, b) produces id base_vocab + rank, base_vocab = n_special + 256.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple


class BPETokenizer:
    def __init__(
        self,
        merges: Sequence[Tuple[int, int]],
        pad_id: int = 0,
        bos_id: int = 1,
        eos_id: int = 2,
        n_special: int = 3,
    ):
        self.pad_id = pad_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.n_special = n_special
        self.base = n_special + 256
        self.merges: Dict[Tuple[int, int], int] = {
            (int(a), int(b)): self.base + rank for rank, (a, b) in enumerate(merges)
        }
        # id -> bytes expansion for decode.
        self._bytes: List[bytes] = [b""] * n_special + [
            bytes([b]) for b in range(256)
        ]
        for (a, b), new_id in self.merges.items():
            assert new_id == len(self._bytes), "merges must be rank-ordered"
            self._bytes.append(self._bytes[a] + self._bytes[b])

    @property
    def vocab_size(self) -> int:
        return self.base + len(self.merges)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._merge([self.n_special + b for b in text.encode("utf-8")])
        return [self.bos_id] + ids if add_bos else ids

    def _merge(self, ids: List[int]) -> List[int]:
        while len(ids) >= 2:
            # Lowest new-id == earliest-trained merge wins (rank order).
            best, best_pos = None, -1
            for i in range(len(ids) - 1):
                new_id = self.merges.get((ids[i], ids[i + 1]))
                if new_id is not None and (best is None or new_id < best):
                    best, best_pos = new_id, i
            if best is None:
                break
            ids = ids[:best_pos] + [best] + ids[best_pos + 2:]
        return ids

    def decode(self, ids: List[int]) -> str:
        data = b"".join(self._bytes[i] for i in ids if i < len(self._bytes))
        return data.decode("utf-8", errors="replace")

    # --- persistence ------------------------------------------------------

    def save(self, path: str | Path) -> None:
        ordered = sorted(self.merges.items(), key=lambda kv: kv[1])
        Path(path).write_text(json.dumps({
            "n_special": self.n_special,
            "pad_id": self.pad_id,
            "bos_id": self.bos_id,
            "eos_id": self.eos_id,
            "merges": [list(pair) for pair, _ in ordered],
        }))

    @classmethod
    def load(cls, path: str | Path) -> "BPETokenizer":
        blob = json.loads(Path(path).read_text())
        return cls(
            [tuple(m) for m in blob["merges"]],
            n_special=blob["n_special"],
            # Older saves predate special-id persistence; fall back to the
            # constructor defaults they were built with.
            pad_id=blob.get("pad_id", 0),
            bos_id=blob.get("bos_id", 1),
            eos_id=blob.get("eos_id", 2),
        )


def train_bpe(corpus: Iterable[str], num_merges: int, n_special: int = 3) -> BPETokenizer:
    """Standard BPE training: repeatedly merge the most frequent adjacent pair."""
    base = n_special + 256
    seqs = [[n_special + b for b in text.encode("utf-8")] for text in corpus]
    merges: List[Tuple[int, int]] = []
    for rank in range(num_merges):
        counts: Counter = Counter()
        for seq in seqs:
            counts.update(zip(seq, seq[1:]))
        if not counts:
            break
        pair, freq = counts.most_common(1)[0]
        if freq < 2:
            break
        new_id = base + rank
        merges.append(pair)
        seqs = [_apply_pair(seq, pair, new_id) for seq in seqs]
    return BPETokenizer(merges, n_special=n_special)


def _apply_pair(seq: List[int], pair: Tuple[int, int], new_id: int) -> List[int]:
    out: List[int] = []
    i = 0
    while i < len(seq):
        if i + 1 < len(seq) and (seq[i], seq[i + 1]) == pair:
            out.append(new_id)
            i += 2
        else:
            out.append(seq[i])
            i += 1
    return out

"""Model configurations for the Llama-family architectures the studio serves.

A copy of the JAX package's `models/configs.py` (values verbatim), with the
rope-scaling dataclasses its `ops/rope.py` defines. The app's three models:
`duckdb-nsql` (a Llama-2-7B fine-tune for text-to-SQL), `llama3.2` (1B/3B,
GQA + tied embeddings + llama3 rope scaling) and `mistral` (7B,
sliding-window attention).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3 style rope frequency rescaling (HF `rope_type: llama3`):
    low-frequency bands are divided by `factor`, high-frequency bands are
    kept, and a smooth interpolation bridges the two."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class RopeFreqFactors:
    """Explicit per-dimension frequency divisors (GGUF `rope_freqs.weight`
    convention): `inv_freq / factor` per dim."""

    factors: Tuple[float, ...]


RopeScalingLike = Union[RopeScaling, RopeFreqFactors]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Architecture hyperparameters for one Llama-family model."""

    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScalingLike] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None  # Mistral-style local attention
    # Token ids — tokenizer-dependent; defaults are Llama-2 SentencePiece ids.
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = 0
    # Additional stop ids beyond eos_id (llama3 chat turns end at <|eot_id|>).
    extra_stop_ids: Tuple[int, ...] = ()

    def __post_init__(self):
        assert self.num_heads % self.num_kv_heads == 0, (
            f"num_heads={self.num_heads} not divisible by "
            f"num_kv_heads={self.num_kv_heads}"
        )

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def stop_ids(self) -> Tuple[int, ...]:
        """eos_id plus any checkpoint-declared extra stop ids."""
        return (self.eos_id,) + tuple(
            s for s in self.extra_stop_ids if s != self.eos_id
        )

    @property
    def num_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, f, v = self.hidden_size, self.intermediate_size, self.vocab_size
        attn = d * self.num_heads * self.head_dim + 2 * d * self.num_kv_heads * self.head_dim
        attn += self.num_heads * self.head_dim * d
        mlp = 3 * d * f
        norms = 2 * d
        per_layer = attn + mlp + norms
        head = 0 if self.tie_embeddings else v * d
        return v * d + self.num_layers * per_layer + d + head


# --- Production shapes -----------------------------------------------------
# duckdb-nsql is a Llama-2-7B fine-tune; Llama-2-7B architecture:
DUCKDB_NSQL_7B = LlamaConfig(
    name="duckdb-nsql-7b",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=11008,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    max_seq_len=4096,
    rope_theta=10000.0,
    norm_eps=1e-5,
)

LLAMA32_1B = LlamaConfig(
    name="llama3.2-1b",
    vocab_size=128256,
    hidden_size=2048,
    intermediate_size=8192,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    max_seq_len=8192,
    rope_theta=500000.0,
    rope_scaling=RopeScaling(factor=32.0),
    norm_eps=1e-5,
    tie_embeddings=True,
    bos_id=128000,
    eos_id=128001,
    pad_id=128004,
    extra_stop_ids=(128008, 128009),  # <|eom_id|>, <|eot_id|> (chat stops)
)

LLAMA32_3B = LlamaConfig(
    name="llama3.2-3b",
    vocab_size=128256,
    hidden_size=3072,
    intermediate_size=8192,
    num_layers=28,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    max_seq_len=8192,
    rope_theta=500000.0,
    rope_scaling=RopeScaling(factor=32.0),
    norm_eps=1e-5,
    tie_embeddings=True,
    bos_id=128000,
    eos_id=128001,
    pad_id=128004,
    extra_stop_ids=(128008, 128009),
)

MISTRAL_7B = LlamaConfig(
    name="mistral-7b",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    max_seq_len=8192,
    rope_theta=10000.0,
    norm_eps=1e-5,
    sliding_window=4096,
)

# --- Test / CI shapes ------------------------------------------------------
# Tiny config exercising every architectural feature (GQA, tied embeddings,
# llama3 rope scaling) at CPU-test size.
TINY = LlamaConfig(
    name="tiny",
    vocab_size=320,  # >= ByteTokenizer's 259 so tiny end-to-end text tests work
    hidden_size=32,
    intermediate_size=64,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=8,
    max_seq_len=128,
    rope_theta=10000.0,
    rope_scaling=RopeScaling(factor=8.0, original_max_position_embeddings=64),
    tie_embeddings=True,
    bos_id=1,
    eos_id=2,
    pad_id=0,
)

# Llama-3.2-1B shape with a smaller vocab.
BENCH_1B = dataclasses.replace(LLAMA32_1B, name="bench-1b", vocab_size=32768,
                               bos_id=1, eos_id=2, pad_id=0,
                               extra_stop_ids=())

REGISTRY = {
    c.name: c
    for c in [DUCKDB_NSQL_7B, LLAMA32_1B, LLAMA32_3B, MISTRAL_7B, TINY, BENCH_1B]
}

"""Token samplers: greedy, temperature, top-k, top-p (nucleus).

Stochastic sampling draws from an explicit `torch.Generator`, so a request
seeded the same way replays the same tokens; no global RNG is touched.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .common import NEG_INF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0.0 => greedy
    top_p: float = 1.0
    top_k: int = 0  # 0 => disabled

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] -> [B] int32 (first maximal index on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def apply_token_mask(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Disallowed entries (`mask` False, [V] or [B, V]) drop to NEG_INF."""
    return torch.where(mask, logits, NEG_INF)


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits < kth, NEG_INF, logits)


def _apply_top_p(logits: torch.Tensor, p) -> torch.Tensor:
    """Keep the smallest prefix of the descending sort whose mass reaches `p`
    (always at least one token). `p` is a float or a [B, 1] tensor."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    kth = keep_sorted.sum(dim=-1)  # number kept per row
    cutoff = torch.gather(sorted_logits, -1, (kth - 1)[..., None])
    return torch.where(logits < cutoff, NEG_INF, logits)


def sample(
    logits: torch.Tensor,
    params: SamplingParams,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Next token ids [B] int32 from logits [B, V]."""
    if params.is_greedy:
        return greedy(logits)
    if generator is None:
        raise ValueError("stochastic sampling needs a torch.Generator")
    logits = logits.float() / params.temperature
    if params.top_k > 0:
        logits = _apply_top_k(logits, params.top_k)
    if params.top_p < 1.0:
        logits = _apply_top_p(logits, params.top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

"""Token samplers: greedy, temperature, top-k, top-p (nucleus).

`sample` (the engine's batch sampler) draws from an explicit
`torch.Generator`, so a request seeded the same way replays the same
tokens; no global RNG is touched.

`sample_runtime` (the scheduler's per-row sampler) takes per-row knobs and
one reproducible stream per row, keyed by (request seed, sample index): a
Gumbel-max draw whose noise is a counter-based integer hash of (seed,
index, vocab id), computed with int64 tensor ops on the logits' device. The
same (seed, index) gives the same token on the CPU and on the card, and a
row's tokens do not depend on what else shares the batch. The JAX
package's stream is `fold_in(key(seed), index)`; the two give different
tokens, so sampled output is compared with JAX only in distribution.
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


def filtered_runtime_logits(
    logits: torch.Tensor,       # [..., V]
    temperature: torch.Tensor,  # [...] f32
    top_p: torch.Tensor,        # [...] f32; >= 1 disables nucleus for that row
    top_k: torch.Tensor,        # [...] int; 0 disables top-k for that row
) -> torch.Tensor:
    """The temperature-scaled, top-k/top-p-filtered logits a runtime
    sampling step draws from: softmax of this is the exact target
    distribution. One descending sort serves both cutoffs (both keep-sets
    are prefixes of the sort order)."""
    logits = logits.float()
    t = temperature.float().clamp(min=1e-6)[..., None]
    scaled = logits / t
    v = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    ranks = torch.arange(v, device=logits.device)
    tk = top_k.long()[..., None]
    keep_k = (tk <= 0) | (ranks < tk)
    probs = torch.softmax(torch.where(keep_k, sorted_desc, NEG_INF), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep_k & ((cum - probs) < top_p.float()[..., None])  # keeps rank 0
    kth = keep.sum(dim=-1)  # kept-prefix length per row
    cutoff = torch.gather(sorted_desc, -1, (kth - 1)[..., None])
    return torch.where(scaled < cutoff, NEG_INF, scaled)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (lowbias32) on int64 tensors in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def stream_uniform(seeds: torch.Tensor, counts: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """[B, V] f32 uniforms in (0, 1): element (b, v) is a hash of
    (seeds[b], counts[b], v) — row b's stream at sample index counts[b]."""
    row = _mix32(_mix32((seeds.long() & _M32) ^ 0x85EBCA6B)
                 ^ (counts.long() & _M32))
    ids = torch.arange(1, vocab + 1, dtype=torch.int64, device=seeds.device)
    bits = _mix32((row[:, None] + _mul32(ids, 0x9E3779B9)[None, :]) & _M32)
    return ((bits >> 8).float() + 0.5) / 16777216.0


def sample_runtime(
    logits: torch.Tensor,       # [B, V]
    temperature: torch.Tensor,  # [B] f32; <= 0 means greedy for that row
    top_p: torch.Tensor,        # [B] f32
    top_k: torch.Tensor,        # [B] int
    seeds: torch.Tensor,        # [B] int — request seed per row
    counts: torch.Tensor,       # [B] int — sample index in that stream
) -> torch.Tensor:
    """Per-row runtime sampling for mixed batches: [B] int32 token ids.
    Greedy rows (temperature <= 0) return argmax; the others draw by
    Gumbel-max from `filtered_runtime_logits` with their own stream.
    Nothing here synchronises with the device; callers that know every row
    is greedy call `greedy` instead and skip the vocab sort."""
    logits = logits.float()
    filt = filtered_runtime_logits(logits, temperature, top_p, top_k)
    u = stream_uniform(seeds, counts, logits.shape[-1])
    sampled = torch.argmax(filt - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temperature <= 0.0, torch.argmax(logits, dim=-1),
                       sampled).to(torch.int32)

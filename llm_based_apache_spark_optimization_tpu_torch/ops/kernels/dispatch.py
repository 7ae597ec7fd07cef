"""Attention implementation selection.

Modes:
- "auto"  (default) — `flash_gqa_attention`: the CUDA kernel for a CUDA
  tensor, its plain version for a CPU tensor. No size crossover.
- "plain" — the plain version on any device. For tests, and for the
  kernel-vs-plain comparison of `chip_smoke.py`; the serving path never
  sets it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import flash_gqa_attention, flash_gqa_attention_plain

_VALID = ("auto", "plain")
_mode = "auto"


def set_attention_impl(mode: Optional[str]) -> None:
    """Force "plain", or restore the default with "auto"/None."""
    global _mode
    if mode is not None and mode not in _VALID:
        raise ValueError(f"attention impl {mode!r} not in {_VALID}")
    _mode = mode or "auto"


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    fn = flash_gqa_attention_plain if _mode == "plain" else flash_gqa_attention
    return fn(q, k, v, q_positions, sliding_window, kv_lens)

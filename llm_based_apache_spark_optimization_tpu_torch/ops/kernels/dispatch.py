"""Kernel implementation selection for the model's attention and page writes.

Modes:
- "auto"  (default) — the hand-written CUDA kernel for a CUDA tensor, its
  plain version for a CPU tensor. No size crossover.
- "plain" — the plain versions on any device. For tests, and for the
  kernel-vs-plain comparisons of `chip_smoke.py`; the serving path never
  sets it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import flash_gqa_attention, flash_gqa_attention_plain
from .paged_attention import ragged_paged_attention, ragged_paged_attention_plain
from .paged_write import fused_page_write, fused_page_write_plain

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


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    q_positions: torch.Tensor,
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
    q_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    fn = (ragged_paged_attention_plain if _mode == "plain"
          else ragged_paged_attention)
    return fn(q, k_pool, v_pool, page_table, q_positions, sliding_window,
              kv_lens, q_lens)


def page_write(
    kp: torch.Tensor,
    vp: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    positions: torch.Tensor,
    page_table: torch.Tensor,
    layer: int,
    q_lens: Optional[torch.Tensor] = None,
) -> None:
    fn = fused_page_write_plain if _mode == "plain" else fused_page_write
    fn(kp, vp, k_new, v_new, positions, page_table, layer, q_lens)

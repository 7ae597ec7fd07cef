"""Kernel implementation selection for the model's attention, page writes
and int4 matmuls.

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

from .attention import (
    flash_gqa_attention,
    flash_gqa_attention_plain,
    flash_gqa_attention_quantized,
    flash_gqa_attention_quantized_plain,
)
from .int4mm import int4_matmul, int4_matmul_plain
from .paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_plain,
    ragged_paged_attention_quantized,
    ragged_paged_attention_quantized_plain,
)
from .paged_write import (
    fused_page_write,
    fused_page_write_plain,
    fused_page_write_quantized,
    fused_page_write_quantized_plain,
)

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


def attention_quantized(
    q: torch.Tensor,
    k8: torch.Tensor,
    ks: torch.Tensor,
    v8: torch.Tensor,
    vs: torch.Tensor,
    q_positions: torch.Tensor,
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    fn = (flash_gqa_attention_quantized_plain if _mode == "plain"
          else flash_gqa_attention_quantized)
    return fn(q, k8, ks, v8, vs, q_positions, sliding_window, kv_lens)


def paged_attention_quantized(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    k_scale: torch.Tensor,
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    q_positions: torch.Tensor,
    sliding_window: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
    q_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    fn = (ragged_paged_attention_quantized_plain if _mode == "plain"
          else ragged_paged_attention_quantized)
    return fn(q, k_pool, k_scale, v_pool, v_scale, page_table, q_positions,
              sliding_window, kv_lens, q_lens)


def page_write_quantized(
    kp: torch.Tensor,
    kps: torch.Tensor,
    vp: torch.Tensor,
    vps: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    positions: torch.Tensor,
    page_table: torch.Tensor,
    layer: int,
    q_lens: Optional[torch.Tensor] = None,
) -> None:
    fn = (fused_page_write_quantized_plain if _mode == "plain"
          else fused_page_write_quantized)
    fn(kp, kps, vp, vps, k_new, v_new, positions, page_table, layer, q_lens)


def int4_mm(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    fn = int4_matmul_plain if _mode == "plain" else int4_matmul
    return fn(x, q4, s4)

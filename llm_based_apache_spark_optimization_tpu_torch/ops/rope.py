"""Rotary position embeddings (RoPE), including Llama-3 frequency rescaling.

Split-half rotation layout (pairs `x[..., :h/2]`, `x[..., h/2:]`), the HF
Llama checkpoint convention. cos/sin are computed from integer positions in
float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..models.configs import RopeFreqFactors, RopeScalingLike


def freq_factors_for(head_dim: int, theta: float,
                     scaling: RopeScalingLike) -> torch.Tensor:
    """The per-dim divisor tensor [head_dim/2] equivalent to `scaling`
    (what llama.cpp stores as `rope_freqs.weight`)."""
    return _inv_freq(head_dim, theta, None) / _inv_freq(head_dim, theta, scaling)


def _inv_freq(
    head_dim: int, theta: float, scaling: Optional[RopeScalingLike],
    device=None,
) -> torch.Tensor:
    """Inverse frequencies [head_dim/2] in float32, with llama3 rescaling."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    if scaling is None:
        return inv_freq
    if isinstance(scaling, RopeFreqFactors):
        return inv_freq / torch.tensor(scaling.factors, dtype=torch.float32,
                                       device=device)
    # Wavelengths longer than original_ctx/low_freq_factor are slowed by
    # `factor`; shorter than original_ctx/high_freq_factor kept; smooth ramp
    # in between.
    old_ctx = scaling.original_max_position_embeddings
    low_wl = old_ctx / scaling.low_freq_factor
    high_wl = old_ctx / scaling.high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    smooth = (old_ctx / wavelen - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor
    )
    smooth = torch.clamp(smooth, 0.0, 1.0)
    scaled = (1.0 - smooth) * inv_freq / scaling.factor + smooth * inv_freq
    return torch.where(
        wavelen > low_wl,
        inv_freq / scaling.factor,
        torch.where(wavelen < high_wl, inv_freq, scaled),
    )


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    scaling: Optional[RopeScalingLike] = None,
):
    """cos/sin tables for integer `positions` [...]; returns ([..., h/2], [..., h/2])."""
    inv_freq = _inv_freq(head_dim, theta, scaling, positions.device)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate `x` [B, S, N, H] by per-position cos/sin [B, S, H/2] (broadcast
    over the heads axis), in float32, cast back to x's dtype."""
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)

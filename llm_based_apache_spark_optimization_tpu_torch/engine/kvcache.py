"""Preallocated KV cache in device memory: {"k", "v"}: [L, B, K, S, H].

KV heads sit outside the sequence axis, so each (batch, head) is a
contiguous [S, H] tile: the shape the attention kernel streams. Invariant
(relied on by the attention mask): every slot at or below a live query
position holds that sequence's real K/V; padded-prefill slots past a
prompt's length are overwritten by decode exactly when they would first
become visible.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import resolve_device
from ..models.configs import LlamaConfig


def init_cache(
    cfg: LlamaConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Zeroed cache on `device` (default CUDA). S rounds up to a multiple
    of 8; the extra slots sit past every reachable position."""
    max_seq += -max_seq % 8
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_bytes(cfg: LlamaConfig, batch: int, max_seq: int, itemsize: int = 2) -> int:
    """Device bytes `init_cache` allocates, the rounding of S included."""
    max_seq += -max_seq % 8
    return (
        2 * cfg.num_layers * batch * max_seq * cfg.num_kv_heads * cfg.head_dim * itemsize
    )


def bucket_len(n: int, bucket: int = 128) -> int:
    """Round a sequence length up to a multiple of `bucket`."""
    return ((n + bucket - 1) // bucket) * bucket

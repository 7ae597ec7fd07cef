"""Preallocated KV cache in device memory: {"k", "v"}: [L, B, K, S, H].

KV heads sit outside the sequence axis, so each (batch, head) is a
contiguous [S, H] tile: the shape the attention kernel streams. Invariant
(relied on by the attention mask): every slot at or below a live query
position holds that sequence's real K/V; padded-prefill slots past a
prompt's length are overwritten by decode exactly when they would first
become visible.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import resolve_device
from ..models.configs import LlamaConfig


def init_cache(
    cfg: LlamaConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
    device=None, kv_quant: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Zeroed cache on `device` (default CUDA). S rounds up to a multiple
    of 8; the extra slots sit past every reachable position. With
    `kv_quant="int8"`, the int8 cache {"k8", "ks", "v8", "vs"} that
    `ops.quant.quantize_cache` gives for the zeroed one (values 0, scales
    1), made directly: no compute-dtype cache is built."""
    if kv_quant not in (None, "int8"):
        raise ValueError(f"kv_quant must be None or 'int8', got {kv_quant!r}")
    max_seq += -max_seq % 8
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
    dev = resolve_device(device)
    if kv_quant:
        return {"k8": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.ones(shape[:4], dtype=torch.float32, device=dev),
                "v8": torch.zeros(shape, dtype=torch.int8, device=dev),
                "vs": torch.ones(shape[:4], dtype=torch.float32, device=dev)}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_bytes(cfg: LlamaConfig, batch: int, max_seq: int, itemsize: int = 2,
                kv_quant: Optional[str] = None) -> int:
    """Device bytes `init_cache` allocates, the rounding of S included (an
    int8 cache: H int8 values plus one f32 scale a slot)."""
    max_seq += -max_seq % 8
    per_slot = cfg.head_dim + 4 if kv_quant else cfg.head_dim * itemsize
    return 2 * cfg.num_layers * batch * max_seq * cfg.num_kv_heads * per_slot


def bucket_len(n: int, bucket: int = 128) -> int:
    """Round a sequence length up to a multiple of `bucket`."""
    return ((n + bucket - 1) // bucket) * bucket

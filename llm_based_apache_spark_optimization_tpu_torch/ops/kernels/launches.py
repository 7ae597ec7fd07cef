"""Launch counts of the hand-written kernels, and the card's SM count that
sizes their split launches.

Each wrapper adds one to its kernel's count where it launches the kernel,
and nowhere else, so a run can show that its main path went through the
kernels (`chip_smoke.py` zeroes the counts before a path and reads them
after). Ragged paged attention counts its decode launches (T == 1) apart
from its query windows (T > 1), which run another kernel. Counting takes a
lock: schedulers launch from their own worker threads at once."""

from __future__ import annotations

import functools
import threading
from typing import Dict

import torch

_lock = threading.Lock()

LAUNCHES: Dict[str, int] = {
    "flash_gqa_prefill": 0,
    "flash_gqa_decode": 0,
    "ragged_paged_attention": 0,
    "ragged_paged_window": 0,
    "fused_page_write": 0,
    "flash_gqa_decode_quantized": 0,
    "ragged_paged_attention_quantized": 0,
    "ragged_paged_window_quantized": 0,
    "fused_page_write_quantized": 0,
    "int4_matmul": 0,
    "int8_matmul": 0,
}


def count(name: str) -> None:
    """One launch of kernel `name`."""
    with _lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card `device` (132 on an H100 SXM),
    read once: the split plans size their launches by it without a host
    sync."""
    return torch.cuda.get_device_properties(device).multi_processor_count

"""Launch counts of the hand-written kernels.

Each wrapper adds one to its kernel's count where it launches the kernel,
and nowhere else, so a run can show that its main path went through the
kernels (`chip_smoke.py` zeroes the counts before a path and reads them
after). Counting takes a lock: schedulers launch from their own worker
threads at once."""

from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()

LAUNCHES: Dict[str, int] = {
    "flash_gqa_prefill": 0,
    "flash_gqa_decode": 0,
    "ragged_paged_attention": 0,
    "fused_page_write": 0,
    "flash_gqa_decode_quantized": 0,
    "ragged_paged_attention_quantized": 0,
    "fused_page_write_quantized": 0,
    "int4_matmul": 0,
}


def count(name: str) -> None:
    """One launch of kernel `name`."""
    with _lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0

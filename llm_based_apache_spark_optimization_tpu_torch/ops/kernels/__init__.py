"""Hand-written CUDA kernels (sources in `csrc/`), each beside its plain
PyTorch version, and the dispatch between them."""

from .attention import (  # noqa: F401
    LAUNCHES,
    flash_gqa_attention,
    flash_gqa_attention_plain,
    reset_launches,
)
from .dispatch import set_attention_impl  # noqa: F401

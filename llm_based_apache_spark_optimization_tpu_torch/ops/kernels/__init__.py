"""Hand-written CUDA kernels (sources in `csrc/`), each beside its plain
PyTorch version, and the dispatch between them."""

from .attention import flash_gqa_attention, flash_gqa_attention_plain  # noqa: F401
from .dispatch import set_attention_impl  # noqa: F401
from .launches import LAUNCHES, reset_launches  # noqa: F401
from .paged_attention import (  # noqa: F401
    gather_pages,
    ragged_paged_attention,
    ragged_paged_attention_plain,
)
from .paged_write import fused_page_write, fused_page_write_plain  # noqa: F401

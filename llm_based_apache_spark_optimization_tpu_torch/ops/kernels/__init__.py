"""Hand-written CUDA kernels (sources in `csrc/`), each beside its plain
PyTorch version, and the dispatch between them."""

from .attention import (  # noqa: F401
    decode_split_plan,
    flash_gqa_attention,
    flash_gqa_attention_plain,
    flash_gqa_attention_quantized,
    flash_gqa_attention_quantized_plain,
    window_split_plan,
)
from .dispatch import set_attention_impl  # noqa: F401
from .int4mm import int4_matmul, int4_matmul_plain  # noqa: F401
from .int8mm import int8_matmul, int8_matmul_plain  # noqa: F401
from .launches import LAUNCHES, reset_launches  # noqa: F401
from .paged_attention import (  # noqa: F401
    gather_page_scales,
    gather_pages,
    ragged_paged_attention,
    ragged_paged_attention_plain,
    ragged_paged_attention_quantized,
    ragged_paged_attention_quantized_plain,
)
from .paged_write import (  # noqa: F401
    fused_page_write,
    fused_page_write_plain,
    fused_page_write_quantized,
    fused_page_write_quantized_plain,
)

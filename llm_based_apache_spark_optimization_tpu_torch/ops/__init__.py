"""Numerical building blocks: rmsnorm, rope, attention, ring attention,
sampling, the quantizers and matmuls of int8 and int4 weights, and the
hand-written CUDA kernels under `kernels/`."""

from .quant import (  # noqa: F401
    dequantize_weight,
    dequantize_weight_int4,
    is_q4tensor,
    is_qtensor,
    mm,
    mm_stacked,
    quantize_params,
    quantize_params_int4,
    quantize_unembed,
    quantize_weight,
    quantize_weight_int4,
    tp_safe_group,
)
from .ring_attention import ring_gqa_attention, sp_cache_attention  # noqa: F401

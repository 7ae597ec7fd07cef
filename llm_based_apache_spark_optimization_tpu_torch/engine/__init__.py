"""Generation runtime: KV cache, prefill and the decode loop."""

from .generate import InferenceEngine  # noqa: F401
from .kvcache import bucket_len, cache_bytes, init_cache  # noqa: F401

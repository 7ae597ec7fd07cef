"""NL->Spark-SQL studio's LLM engine in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (H100, `sm_90a`).

A port of the JAX package `llm_based_apache_spark_optimization_tpu`, which
stays the reference it is tested against. Module names mirror the JAX
package's so each counterpart is easy to find; this package imports nothing
of it and nothing of jax.

Subpackages (bottom-up):
  models/      Llama-family configs and the transformer forward
  ops/         rmsnorm, rope, attention (plain goldens), sampling, quantizers
               (int4 weights, int8 KV) and `mm`
  ops/kernels/ hand-written CUDA kernels, their plain versions, the dispatch
  csrc/        CUDA C++ sources, built with nvcc at first use
  engine/      KV cache, prefill + decode loop
  tokenizer/   byte-level tokenizer
  serve/       prompt templates, engine backend, generation service
  convert.py   JAX params tree (as numpy) -> this package's params

Entry points take an explicit `device`. They default to CUDA and raise when
no CUDA device is present: the CPU is used only when the caller passes
`device="cpu"`.
"""

__version__ = "0.1.0"

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device`, or CUDA when None.

    Raises instead of falling back to the CPU when CUDA is asked for (or
    defaulted to) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev

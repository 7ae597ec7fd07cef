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
  checkpoint/  HF safetensors and GGUF loaders and writers, the native cache
  native/      the GGUF reader in C++, built with g++ at first use
  tokenizer/   byte-level, trainable BPE and HF tokenizer.json tokenizers
  serve/       prompt templates, engine and scheduler backends, the
               continuous-batching scheduler and its replica pool, the
               crash supervisor and watchdog, generation service, the QoS
               front door, the model registry, typed serving errors
  sql/         CSV -> temp_view -> SQL execution (SQLite, Spark)
  history/     query-results history store
  utils/       fault injection, request tracing, counters
  parallel/    meshes over torch.distributed (one process a rank), the
               sharding rules, the step channel rank 0 drives the others by
  app/         the studio's web UI and JSON API, and its entry point
               (`python -m llm_based_apache_spark_optimization_tpu_torch.app`)
  runbook.py   weights in, comparison report out, in one command
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

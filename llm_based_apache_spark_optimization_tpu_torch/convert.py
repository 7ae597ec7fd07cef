"""Params of the JAX package -> params of this package.

`params_from_jax(tree)` takes the JAX params tree with its leaves as numpy
arrays (`np.asarray` of each jax.Array: stacked [L, ...] `blocks`, `embed`,
`final_norm`, optional `lm_head`) and returns the same tree of torch tensors
on `device`, bit for bit, so both packages compute the same function.
bfloat16 leaves (numpy's `bfloat16` extension dtype) are carried through
their 16-bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")  # own, writable memory
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree, device=None):
    """The port's params on `device` (default CUDA) from a numpy tree."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return tensor_from_numpy(np.asarray(node), dev)

    return conv(tree)

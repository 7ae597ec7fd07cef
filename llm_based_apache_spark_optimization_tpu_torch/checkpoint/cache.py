"""Native checkpoint cache: save and restore an already-converted param tree.

Counterpart of the JAX package's `checkpoint/cache.py`, which uses orbax.
Converting a checkpoint (dequantize, transpose and stack 7 matrices a layer)
costs host time at every process start; `save_native` persists the
converted tree once with `torch.save` (int4 trees included), and
`load_native` restores it onto `device`, one leaf at a time.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..models.configs import LlamaConfig
from .hf import resolve_load_device

__all__ = ["save_native", "load_native"]


def save_native(params: Dict[str, Any], path) -> None:
    """Persist a param tree (tensors on any device) to `path`."""
    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        return node.detach().to("cpu")

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(host(params), path)


def load_native(
    cfg: LlamaConfig,
    path,
    dtype: Optional[torch.dtype] = torch.bfloat16,
    device=None,
) -> Dict[str, Any]:
    """Restore a param tree onto `device` (default CUDA). Float leaves are
    cast to `dtype` (None keeps the saved dtypes); integer leaves (int4
    packs) keep theirs. The tree must match `cfg`'s layer count."""
    dev = resolve_load_device(device)
    tree = torch.load(path, map_location="cpu", weights_only=True)

    def place(node):
        if isinstance(node, dict):
            return {k: place(v) for k, v in node.items()}
        if dtype is not None and node.is_floating_point():
            node = node.to(dtype)
        return node.to(dev)

    params = place(tree)
    layers = params["blocks"]["ln_attn"].shape[0]
    if layers != cfg.num_layers:
        raise ValueError(f"{path}: {layers} layers saved, {cfg.name} has "
                         f"{cfg.num_layers}")
    return params

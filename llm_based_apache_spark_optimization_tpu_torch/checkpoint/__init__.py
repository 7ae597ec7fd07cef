"""Checkpoint layer: HF safetensors and GGUF blobs -> the port's param tree
on the device, the writers of both formats, and a cache of converted trees.

Counterpart of the JAX package's `checkpoint/`: the same functions under the
same names, with an explicit `device` (default CUDA) in place of a mesh. The
port reads and writes safetensors itself (checkpoint/safetensors.py) and
reads GGUF through its own C++ reader (native/).
"""

from .hf import config_from_hf, load_hf_checkpoint, save_hf_checkpoint  # noqa: F401
from .cache import load_native, save_native  # noqa: F401
from .gguf import config_from_gguf, load_gguf_checkpoint, write_gguf  # noqa: F401

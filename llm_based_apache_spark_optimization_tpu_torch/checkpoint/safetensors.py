"""The safetensors format, read and written by the port itself.

A file is an 8-byte little-endian header length N, N bytes of JSON header
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__"?:
{str: str}}`, padded with spaces), then the raw little-endian tensor
buffers, each at its offsets relative to the end of the header. bf16 is
read through a uint16 view. The port imports neither the `safetensors`
package nor `ml_dtypes`: the machine that serves from a checkpoint need
not have them.

`SafetensorsFile.get(name)` reads one tensor's bytes from disk, so a loader
holds one tensor at a time; `save_file` writes the header from the tensors'
shapes first and then each buffer in turn, moving one tensor at a time to
the host.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

__all__ = ["SafetensorsFile", "save_file"]

#: safetensors dtype name -> (numpy storage dtype, torch dtype): the float
#: types checkpoints store weights in.
_DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
}
_NAMES = {t: name for name, (_, t) in _DTYPES.items()}

#: Largest header the reader accepts (the format's own limit).
_MAX_HEADER = 100 * 1024 * 1024


class SafetensorsFile:
    """Tensor directory of one .safetensors file; `get` reads one tensor."""

    def __init__(self, path):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            if n > _MAX_HEADER:
                raise ValueError(f"{self.path}: header of {n} bytes is too large")
            header = json.loads(f.read(n))
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._data_start = 8 + n
        self._entries = header

    def keys(self) -> List[str]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> torch.Tensor:
        """Tensor `name` on the CPU, in its stored dtype."""
        e = self._entries[name]
        if e["dtype"] not in _DTYPES:
            raise ValueError(f"{self.path}: {name} has unsupported dtype {e['dtype']}")
        np_dtype, torch_dtype = _DTYPES[e["dtype"]]
        begin, end = e["data_offsets"]
        count = (end - begin) // np.dtype(np_dtype).itemsize
        arr = np.fromfile(self.path, dtype=np.dtype(np_dtype).newbyteorder("<"),
                          count=count, offset=self._data_start + begin)
        if int(np.prod(e["shape"], dtype=np.int64)) != count:
            raise ValueError(f"{self.path}: {name} has {count} elements for "
                             f"shape {e['shape']}")
        t = torch.from_numpy(arr.astype(np_dtype, copy=False))
        if torch_dtype == torch.bfloat16:
            t = t.view(torch.int16).view(torch.bfloat16)
        return t.reshape(e["shape"])


def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    a = t.numpy()
    return a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()


def save_file(tensors: Mapping[str, torch.Tensor], path,
              metadata: Optional[Dict[str, str]] = None,
              dtype: Optional[torch.dtype] = None) -> None:
    """Write `tensors` (any device; views are made contiguous on the way
    out) as one .safetensors file, in the mapping's order, each cast to
    `dtype` when given. One tensor at a time reaches the host."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in tensors.items():
        dt = dtype or t.dtype
        if dt not in _NAMES:
            raise ValueError(f"{name}: dtype {dt} has no safetensors name")
        nbytes = t.numel() * torch.empty((), dtype=dt).element_size()
        header[name] = {"dtype": _NAMES[dt], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(_host_bytes(t.to(dtype) if dtype is not None else t))

"""The GGUF reader: `native/gguf.cpp`, built with g++ at first use and bound
with ctypes.

Counterpart of the JAX package's `native.GGUFReader`, with its own copy of
the C++ source. The library builds into the package's git-ignored `build/`
(next to the CUDA kernels) the first time a GGUF file is opened, and is
rebuilt when `gguf.cpp` or `gguf.h` is newer than it. A failed build raises:
there is no Python reader to fall back to.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

_SRC = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_SRC, "gguf.cpp"), os.path.join(_SRC, "gguf.h"))
BUILD = os.path.join(os.path.dirname(_SRC), "build")
LIB = os.path.join(BUILD, "libgguf.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_command(out: str) -> List[str]:
    """The g++ command that builds the reader into `out`."""
    return ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{_SRC}",
            SOURCES[0], "-o", out]


def _build() -> None:
    os.makedirs(BUILD, exist_ok=True)
    # Build to a temporary name, then rename: a concurrent loader sees no
    # file or a complete one, never half a library.
    tmp = f"{LIB}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(build_command(tmp), capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the GGUF reader failed: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed for native/gguf.cpp:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB)


def load() -> ctypes.CDLL:
    """The reader's library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(LIB) or os.path.getmtime(LIB) < max(
                os.path.getmtime(f) for f in SOURCES):
            _build()
        lib = ctypes.CDLL(LIB)
        _declare(lib)
        _lib = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    sigs = {
        "lsot_gguf_open": (c.c_void_p, [c.c_char_p]),
        "lsot_gguf_close": (None, [c.c_void_p]),
        "lsot_gguf_n_tensors": (c.c_int32, [c.c_void_p]),
        "lsot_gguf_tensor_name": (c.c_char_p, [c.c_void_p, c.c_int32]),
        "lsot_gguf_tensor_ndim": (c.c_int32, [c.c_void_p, c.c_int32]),
        "lsot_gguf_tensor_dim": (c.c_uint64, [c.c_void_p, c.c_int32, c.c_int32]),
        "lsot_gguf_tensor_dtype": (c.c_int32, [c.c_void_p, c.c_int32]),
        "lsot_gguf_tensor_nelems": (c.c_uint64, [c.c_void_p, c.c_int32]),
        "lsot_gguf_read_f32": (c.c_int32, [c.c_void_p, c.c_int32,
                                           c.POINTER(c.c_float), c.c_uint64]),
        "lsot_gguf_meta_str": (c.c_char_p, [c.c_void_p, c.c_char_p]),
        "lsot_gguf_meta_f64": (c.c_int32, [c.c_void_p, c.c_char_p,
                                           c.POINTER(c.c_double)]),
        "lsot_gguf_last_error": (c.c_char_p, []),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


class GGUFReader:
    """Parsed GGUF file: tensor directory + metadata + f32 dequantization
    (F32/F16/Q8_0/Q4_0 and the K-quants Q4_K/Q5_K/Q6_K)."""

    F32, F16, Q4_0, Q8_0 = 0, 1, 2, 8
    Q4_K, Q5_K, Q6_K = 12, 13, 14

    def __init__(self, path):
        lib = load()
        self._lib = lib
        self._h = lib.lsot_gguf_open(os.fsencode(path))
        if not self._h:
            raise ValueError(
                f"GGUF open failed: {lib.lsot_gguf_last_error().decode()}")
        self._names = {
            lib.lsot_gguf_tensor_name(self._h, i).decode(): i
            for i in range(lib.lsot_gguf_n_tensors(self._h))
        }

    @property
    def tensor_names(self) -> List[str]:
        return list(self._names)

    def shape(self, name: str) -> Tuple[int, ...]:
        """Numpy-order shape (outermost first: GGUF's dim order reversed)."""
        i = self._names[name]
        nd = self._lib.lsot_gguf_tensor_ndim(self._h, i)
        dims = [self._lib.lsot_gguf_tensor_dim(self._h, i, d) for d in range(nd)]
        return tuple(int(d) for d in reversed(dims))

    def dtype(self, name: str) -> int:
        return self._lib.lsot_gguf_tensor_dtype(self._h, self._names[name])

    def meta_str(self, key: str) -> Optional[str]:
        v = self._lib.lsot_gguf_meta_str(self._h, key.encode())
        return v.decode() if v is not None else None

    def meta_num(self, key: str) -> Optional[float]:
        out = ctypes.c_double()
        ok = self._lib.lsot_gguf_meta_f64(self._h, key.encode(), ctypes.byref(out))
        return out.value if ok else None

    def tensor_f32(self, name: str):
        """Dequantized tensor as a float32 numpy array in numpy-order shape."""
        import numpy as np

        i = self._names[name]
        n = self._lib.lsot_gguf_tensor_nelems(self._h, i)
        out = np.empty(int(n), np.float32)
        rc = self._lib.lsot_gguf_read_f32(
            self._h, i, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        if rc != 0:
            raise ValueError(f"GGUF read failed for {name}: "
                             f"{self._lib.lsot_gguf_last_error().decode()}")
        return out.reshape(self.shape(name))

    def close(self) -> None:
        if self._h:
            self._lib.lsot_gguf_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

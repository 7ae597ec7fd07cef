"""The native libraries: C++ built with g++ at first use, bound with ctypes.

Counterpart of the JAX package's `native/`, with its own copies of the C++
sources. Two libraries build into the package's git-ignored `build/` (next
to the CUDA kernels), each the first time it is needed and again when one
of its sources is newer than it:
- `libgguf.so` (`gguf.cpp`, `gguf.h`): the GGUF reader, `GGUFReader`;
- `libtext.so` (`bpe.cpp`, `csvscan.cpp`, `text.h`): the BPE encoder
  (`NativeBPE`, which `tokenizer.BPETokenizer` encodes with) and the CSV
  schema scanner (`csv_scan`, which `sql.SQLiteBackend.load_csv` infers
  dtypes with).
A failed build raises: nothing falls back to Python on its own.
`LSOT_NO_NATIVE=1` is the explicit choice of the Python passes for the
encoder and the scanner, as in the JAX package (`NativeBPE.create` and
`csv_scan` return None); the GGUF reader has no Python pass and ignores it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

_SRC = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_SRC, "gguf.cpp"), os.path.join(_SRC, "gguf.h"))
TEXT_SOURCES = tuple(os.path.join(_SRC, f) for f in ("bpe.cpp", "csvscan.cpp", "text.h"))
BUILD = os.path.join(os.path.dirname(_SRC), "build")
LIB = os.path.join(BUILD, "libgguf.so")
TEXT_LIB = os.path.join(BUILD, "libtext.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_text_lib: Optional[ctypes.CDLL] = None


def build_command(out: str, *cpp: str) -> List[str]:
    """The g++ command that builds `cpp` (default: the GGUF reader) into
    `out`."""
    return ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{_SRC}",
            *(cpp or SOURCES[:1]), "-o", out]


def _build(lib: str, *cpp: str) -> None:
    os.makedirs(BUILD, exist_ok=True)
    # Build to a temporary name, then rename: a concurrent loader sees no
    # file or a complete one, never half a library.
    tmp = f"{lib}.{os.getpid()}.tmp"
    names = ", ".join(os.path.basename(f) for f in (cpp or SOURCES[:1]))
    try:
        proc = subprocess.run(build_command(tmp, *cpp), capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building native/{names} failed: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed for native/{names}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)


def _stale(lib: str, sources: Sequence[str]) -> bool:
    return not os.path.exists(lib) or os.path.getmtime(lib) < max(
        os.path.getmtime(f) for f in sources)


def load() -> ctypes.CDLL:
    """The GGUF reader's library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale(LIB, SOURCES):
            _build(LIB)
        lib = ctypes.CDLL(LIB)
        _declare(lib)
        _lib = lib
        return lib


def native_disabled() -> bool:
    """`LSOT_NO_NATIVE=1`: the Python encoder and scanner are asked for."""
    return os.environ.get("LSOT_NO_NATIVE") == "1"


def load_text() -> ctypes.CDLL:
    """The text library (BPE encoder, CSV scanner), built first if missing
    or stale. Raises when it cannot be built."""
    global _text_lib
    with _lock:
        if _text_lib is not None:
            return _text_lib
        if _stale(TEXT_LIB, TEXT_SOURCES):
            _build(TEXT_LIB, *(f for f in TEXT_SOURCES if f.endswith(".cpp")))
        lib = ctypes.CDLL(TEXT_LIB)
        _declare_text(lib)
        _text_lib = lib
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


def _declare_text(lib: ctypes.CDLL) -> None:
    c = ctypes
    sigs = {
        "lsot_bpe_new": (c.c_void_p, [c.POINTER(c.c_int32), c.c_int32, c.c_int32]),
        "lsot_bpe_free": (None, [c.c_void_p]),
        "lsot_bpe_encode": (c.c_int32, [c.c_void_p, c.POINTER(c.c_uint8), c.c_int32,
                                        c.POINTER(c.c_int32), c.c_int32]),
        "lsot_csv_scan": (c.c_int32, [c.c_char_p, c.POINTER(c.c_int32), c.c_int32,
                                      c.POINTER(c.c_int64)]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


class NativeBPE:
    """ctypes handle to the C++ BPE encoder (`bpe.cpp`): the merge loop of
    `tokenizer.bpe.BPETokenizer._merge`, same output. `NativeBPE.create`
    returns None under `LSOT_NO_NATIVE=1` and raises when the library cannot
    be built."""

    def __init__(self, lib: ctypes.CDLL, merges: Sequence[Tuple[int, int]],
                 n_special: int):
        self._lib = lib
        flat = [int(x) for pair in merges for x in pair]
        arr = (ctypes.c_int32 * len(flat))(*flat)
        self._h = lib.lsot_bpe_new(arr, len(merges), n_special)

    @classmethod
    def create(cls, merges: Sequence[Tuple[int, int]],
               n_special: int) -> Optional["NativeBPE"]:
        if native_disabled():
            return None
        return cls(load_text(), merges, n_special)

    def encode_bytes(self, data: bytes) -> List[int]:
        n = len(data)
        if n == 0:
            return []
        buf = (ctypes.c_uint8 * n).from_buffer_copy(data)
        out = (ctypes.c_int32 * n)()
        count = self._lib.lsot_bpe_encode(self._h, buf, n, out, n)
        if count < 0:  # cannot happen (merges only shrink the sequence)
            raise RuntimeError("native BPE output overflow")
        return list(out[:count])

    def __del__(self):
        h, lib = getattr(self, "_h", None), getattr(self, "_lib", None)
        if h and lib is not None:
            lib.lsot_bpe_free(h)


#: Dtype code -> Spark-compatible dtype name (text.h's LSOT_CSV_*).
CSV_DTYPE_NAMES = ("string", "int", "bigint", "double", "timestamp")


def csv_scan(path, max_cols: int = 4096):
    """The C++ CSV schema scan (`csvscan.cpp`): (dtype names, data-row
    count), or None under `LSOT_NO_NATIVE=1` or for a file the scanner
    refuses (unreadable or empty, a row wider than the header, more than
    `max_cols` columns), where the caller takes the Python pass. Raises
    when the library cannot be built."""
    if native_disabled():
        return None
    lib = load_text()
    dtypes = (ctypes.c_int32 * max_cols)()
    n_rows = ctypes.c_int64()
    n = lib.lsot_csv_scan(os.fsencode(path), dtypes, max_cols, ctypes.byref(n_rows))
    if n < 0:
        return None
    return [CSV_DTYPE_NAMES[dtypes[i]] for i in range(n)], int(n_rows.value)

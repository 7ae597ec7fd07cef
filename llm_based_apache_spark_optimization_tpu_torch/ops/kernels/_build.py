"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into `build/lib<name>.so` (a
plain C interface: no PyTorch headers, so a build takes seconds); the
`csrc/*.cuh` headers are shared between sources. A library is rebuilt when
its source or any header is newer than it. Nothing is built at import:
`load(name)` builds on first use, `kernel_fn(name, argtypes)` binds the
C function of that name, `build_all()` starts one nvcc per source at
once and waits for all of them, and `load_all(names)` does the same for
the stale ones of `names`, then loads each.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[str, object] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return path


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _paths(name: str):
    return os.path.join(CSRC, f"{name}.cu"), os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    inputs = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                      if f.endswith(".cuh")]
    return not os.path.exists(lib) or os.path.getmtime(lib) < max(
        os.path.getmtime(f) for f in inputs)


def _start(name: str, extra_flags=()) -> subprocess.Popen:
    src, lib = _paths(name)
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.lib_paths = (tmp, lib)
    return proc


def _finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    tmp, lib = proc.lib_paths
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return out


def build_all(force: bool = False, extra_flags=()) -> Dict[str, str]:
    """Compile every stale source (all of them with `force`), one nvcc
    process per source, all started together. Returns nvcc's output per
    source (with `-Xptxas -v` in `extra_flags`, the register and shared
    memory report)."""
    with _lock:
        names = [n for n in sources() if force or _stale(n)]
        procs = {n: _start(n, extra_flags) for n in names}
        return {n: _finish(n, p) for n, p in procs.items()}


def load_all(names) -> None:
    """Load the libraries of `names`, the stale ones built first, one nvcc
    process each, all started together (a warmup's loads: not one build
    after another inside the first forward)."""
    with _lock:
        procs = {n: _start(n) for n in names if n not in _loaded and _stale(n)}
        for n, p in procs.items():
            _finish(n, p)
    for n in names:
        load(n)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if stale."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        if _stale(name):
            _finish(name, _start(name))
        lib = ctypes.CDLL(_paths(name)[1])
        _loaded[name] = lib
        return lib


def kernel_fn(name: str, argtypes) -> object:
    """The C function `name` of `csrc/<name>.cu` (built first if stale),
    with its argument types set and an int (CUDA error code) result."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(load(name), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn

"""int4 weight-only matmul: the CUDA kernel's wrapper and its plain version.

Counterpart of the JAX package's `ops/pallas/int4mm.py` (`int4_matmul`):
`x [R, IN] @ dequant(q4 [IN/2, OUT] uint8, s4 [IN/group, OUT] f32)`, the
weight dequantized to x's dtype and the products summed in f32, returned
in x's dtype. The kernels are `csrc/int4_matmul.cu`, built with nvcc at
first use and called through ctypes; see its header for the design. One
rule, `int4_route`, picks the kernel: bf16 with R <= 8 rows (decode) the
tensor-core decode kernel, bf16 above 8 rows (prefill) the tensor-core
prefill kernel, f32 the scalar rows kernel. Every call is one launch: a
split of the contraction axis is added up inside a thread-block cluster.

A tensor on the CPU goes to `int4_matmul_plain`; a CUDA tensor launches the
kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..quant import dequantize_weight_int4
from .launches import count

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_I] * 4 + [_LL] + [_I] * 3 + [_P]
DECODE_MAX_ROWS = 8     # rows of the decode kernel (the mma's n = 8; csrc kMaxRows)
_ROUTES = {"rows": 0, "decode": 1, "prefill": 2}  # csrc Route
_TILE_COLS = 128        # output columns of a split kernel's block (csrc kBN)
_MAX_SPLITS = 8          # blocks of a portable thread-block cluster
_MIN_SPLIT_ROWS = 64    # packed rows one split covers at least (a decode stage)


def int4_matmul_plain(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """The kernel's contract in eager PyTorch: the weight dequantized to x's
    dtype (`dequantize_weight_int4`), then an f32 product; [R, OUT] in x's
    dtype."""
    w = dequantize_weight_int4({"q4": q4, "s4": s4}, x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def int4_route(rows: int, dtype: torch.dtype) -> str:
    """The kernel of one call: "decode" for bf16 x of at most 8 rows,
    "prefill" for bf16 above, "rows" (scalar f32) for f32 x."""
    if dtype == torch.float32:
        return "rows"
    return "decode" if rows <= DECODE_MAX_ROWS else "prefill"


@functools.lru_cache(maxsize=None)
def resident_blocks(device: torch.device) -> int:
    """Decode-kernel blocks the card holds at once: four per SM (256
    threads of at most 64 registers by its launch bounds, and four stages of
    about 14 KB of shared memory at groups of 64 and more)."""
    return 4 * torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(rows: int, n_in: int, n_out: int, blocks: int) -> Tuple[int, int]:
    """(splits, packed rows per split) of the contraction axis, the cluster
    plan of the decode and rows kernels: at R <= 8 enough splits to fill
    about `blocks` blocks (`resident_blocks`), at most 8 (one cluster), each
    covering at least 64 packed rows, a multiple of 8; none above 8 rows.
    The splits' partial sums are added inside the cluster."""
    n_pk = n_in // 2
    if rows > DECODE_MAX_ROWS:
        return 1, n_pk
    col_tiles = -(-n_out // _TILE_COLS)
    splits = max(1, min(_MAX_SPLITS, -(-blocks // col_tiles), n_pk // _MIN_SPLIT_ROWS))
    per = -(-n_pk // splits)
    per = -(-per // 8) * 8
    return -(-n_pk // per), per


def int4_matmul_cuda(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    for name, t in (("q4", q4), ("s4", s4)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int4 kernel takes bf16 or f32 x, got {x.dtype}")
    if q4.dtype != torch.uint8 or s4.dtype != torch.float32:
        raise TypeError(f"int4 kernel takes uint8 q4 and f32 s4, got {q4.dtype}, {s4.dtype}")
    if x.dim() != 2 or q4.dim() != 2 or s4.dim() != 2:
        raise ValueError("int4 kernel takes x [R, IN], q4 [IN/2, OUT], s4 [G, OUT]")
    rows, n_in = x.shape
    n_out, n_groups = q4.shape[1], s4.shape[0]
    group = n_in // max(n_groups, 1)
    if (q4.shape[0] * 2 != n_in or s4.shape[1] != n_out or n_groups * group != n_in
            or group % 2):
        raise ValueError(f"inconsistent int4 shapes: x {tuple(x.shape)}, q4 "
                         f"{tuple(q4.shape)}, s4 {tuple(s4.shape)}")
    if n_in % 8 or n_out % 16:
        raise ValueError(f"int4 kernel needs IN % 8 == 0 and OUT % 16 == 0, got "
                         f"{n_in}, {n_out}")
    if not (q4.is_contiguous() and s4.is_contiguous()):
        raise ValueError("q4 and s4 must be contiguous")
    x = x.contiguous()
    if (x.data_ptr() | q4.data_ptr() | s4.data_ptr()) % 16:
        raise ValueError("x, q4 and s4 must be 16-byte aligned")
    out = torch.empty((rows, n_out), dtype=x.dtype, device=x.device)
    route = int4_route(rows, x.dtype)
    splits, per = split_plan(rows, n_in, n_out, resident_blocks(x.device))
    from ._build import kernel_fn

    err = kernel_fn("int4_matmul", _ARGTYPES)(
        x.data_ptr(), q4.data_ptr(), s4.data_ptr(), out.data_ptr(),
        rows, n_in, n_out, group, n_in, _ROUTES[route], splits, per,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int4_matmul launch failed: CUDA error {err}")
    count("int4_matmul")
    return out


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """x [R, IN] @ the int4 weight (q4, s4), [R, OUT] in x's dtype. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, s4)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu, not {x.device}")
    return int4_matmul_cuda(x, q4, s4)

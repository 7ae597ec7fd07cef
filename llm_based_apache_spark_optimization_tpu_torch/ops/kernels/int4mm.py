"""int4 weight-only matmul: the CUDA kernel's wrapper and its plain version.

Counterpart of the JAX package's `ops/pallas/int4mm.py` (`int4_matmul`):
`x [R, IN] @ dequant(q4 [IN/2, OUT] uint8, s4 [IN/group, OUT] f32)`, the
weight dequantized to x's dtype and the products summed in f32, returned
in x's dtype. The kernel is `csrc/int4_matmul.cu`, built with nvcc at first
use and called through ctypes; see its header for the design (a rows
kernel for decode and f32, a tensor-core kernel for bf16 prefill).

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
_ARGTYPES = [_P] * 5 + [_I] * 4 + [_LL] + [_I] * 3 + [_P]
_ROWS_PER_BLOCK = 8     # the rows kernel's register tile (csrc RB)
_TILE_COLS = 256        # output columns of one rows-kernel block (csrc kTileCols)
_MIN_SPLIT_ROWS = 64    # packed rows one split covers at least


def int4_matmul_plain(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """The kernel's contract in eager PyTorch: the weight dequantized to x's
    dtype (`dequantize_weight_int4`), then an f32 product; [R, OUT] in x's
    dtype."""
    w = dequantize_weight_int4({"q4": q4, "s4": s4}, x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def resident_blocks(device: torch.device) -> int:
    """Rows-kernel blocks the card holds at once: two per SM (its launch
    bounds)."""
    return 2 * torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(rows: int, n_in: int, n_out: int, blocks: int) -> Tuple[int, int]:
    """(splits, packed rows per split) of the contraction axis for the rows
    kernel: at decode (R <= 8) enough splits to fill about `blocks` blocks
    (`resident_blocks`), each covering at least 64 packed rows; none
    otherwise. With more than one split the kernel's partial sums are added
    by a second launch, the reduce kernel."""
    n_pk = n_in // 2
    if rows > _ROWS_PER_BLOCK:
        return 1, n_pk
    col_tiles = -(-n_out // _TILE_COLS)
    splits = max(1, min(-(-blocks // col_tiles), n_pk // _MIN_SPLIT_ROWS))
    per = -(-n_pk // splits)
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
    splits, per = split_plan(rows, n_in, n_out, resident_blocks(x.device))
    part = (torch.empty((splits, rows, n_out), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    from ._build import kernel_fn

    err = kernel_fn("int4_matmul", _ARGTYPES)(
        x.data_ptr(), q4.data_ptr(), s4.data_ptr(),
        None if part is None else part.data_ptr(), out.data_ptr(),
        rows, n_in, n_out, group, n_in, int(x.dtype == torch.bfloat16), splits, per,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int4_matmul launch failed: CUDA error {err}")
    count("int4_matmul")
    if splits > 1:
        count("int4_matmul_reduce")
    return out


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """x [R, IN] @ the int4 weight (q4, s4), [R, OUT] in x's dtype. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, s4)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu, not {x.device}")
    return int4_matmul_cuda(x, q4, s4)

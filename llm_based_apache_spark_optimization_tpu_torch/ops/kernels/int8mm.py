"""int8 weight-only matmul: the CUDA kernel's wrapper and its plain version.

No Pallas kernel stands behind it: the JAX package hands XLA a
`dot_general` of x against the int8 array with f32 accumulation and the
scale in the epilogue (its `ops/quant.py` `mm`, and the q8 unembed einsum
of `models/llama.py`). PyTorch has no bf16 x int8 product, and `x @
dequantize_weight(w)` writes and reads a bf16 copy of the weight on every
call, so the port computes the function with a kernel of its own,
`csrc/int8_matmul.cu` (see its header for the design), built with nvcc at
first use and called through ctypes. The contract is JAX's:

    "io": x [R, IN] @ q8 [IN, OUT] int8, s [OUT] f32 ->
          out[r, o] = (sum_i x[r, i] * q8[i, o]) * s[o], in x's dtype;
    "vd": x [R, D] against the [V, D] int8 table, s [V] f32 (the unembed) ->
          out[r, v] = (sum_d x[r, d] * q8[v, d]) * s[v], f32 logits.

The sum runs in f32 and the scale is applied to it, never to the weight.
One rule, `int8_route`, picks the kernel: bf16 x of at most 8 rows (decode)
the GEMV kernel of its layout, bf16 above 8 rows the tensor-core kernel, f32
x the GEMV kernel over blocks of 8 rows. Every call is one launch; the io
GEMV's split of the contraction axis is added up inside a thread-block
cluster, in rank order, so results are the same from launch to launch.

A tensor on the CPU goes to `int8_matmul_plain`; a CUDA tensor launches the
kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .launches import count, sm_count

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_I] * 3 + [_LL] + [_I] * 5 + [_P]
LAYOUTS = {"io": 0, "vd": 1}     # csrc Layout
_ROUTES = {"gemv": 0, "mma": 1}  # csrc Route
GEMV_MAX_ROWS = 8    # rows of a GEMV block (csrc kMaxRows)
_GEMV_COLS = 256     # output columns of an io GEMV block (csrc kGemvBN)
_MAX_SPLITS = 8      # blocks of a portable thread-block cluster
_MIN_SPLIT_ROWS = 256  # contraction rows one split covers at least


def int8_matmul_plain(x: torch.Tensor, q8: torch.Tensor, s: torch.Tensor,
                      layout: str = "io") -> torch.Tensor:
    """The kernel's contract in eager PyTorch: the f32 product of x with the
    raw int8 weight, times the scale; "io" in x's dtype, "vd" in f32."""
    if layout == "vd":
        return (x.float() @ q8.float().t()) * s
    return ((x.float() @ q8.float()) * s).to(x.dtype)


def int8_route(rows: int, dtype: torch.dtype) -> str:
    """The kernel of one call: "gemv" for f32 x or bf16 x of at most 8
    rows, "mma" (tensor cores) for bf16 above."""
    if dtype == torch.float32 or rows <= GEMV_MAX_ROWS:
        return "gemv"
    return "mma"


def split_plan(rows: int, n_in: int, n_out: int, layout: str,
               blocks: int) -> Tuple[int, int]:
    """(splits, contraction rows per split) of a GEMV launch: for the io
    layout enough splits to fill about `blocks` blocks over its 256-column
    tiles and 8-row blocks, at most 8 (one cluster), each covering at least
    256 contraction rows, a multiple of 32; the vd GEMV does not split (1,
    IN): its 32-row tiles of the table already fill the card."""
    if layout != "io":
        return 1, n_in
    tiles = -(-n_out // _GEMV_COLS) * -(-rows // GEMV_MAX_ROWS)
    splits = max(1, min(_MAX_SPLITS, -(-blocks // tiles), n_in // _MIN_SPLIT_ROWS))
    per = -(-n_in // splits)
    per = -(-per // 32) * 32
    return -(-n_in // per), per


def int8_matmul_cuda(x: torch.Tensor, q8: torch.Tensor, s: torch.Tensor,
                     layout: str = "io") -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {tuple(LAYOUTS)}, got {layout!r}")
    for name, t in (("q8", q8), ("s", s)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8 kernel takes bf16 or f32 x, got {x.dtype}")
    if q8.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int8 kernel takes int8 q8 and f32 s, got {q8.dtype}, {s.dtype}")
    if x.dim() != 2 or q8.dim() != 2 or s.dim() != 1:
        raise ValueError("int8 kernel takes x [R, IN], q8 [IN, OUT] (vd: [V, D]), s [OUT]")
    rows, n_in = x.shape
    n_out = q8.shape[1] if layout == "io" else q8.shape[0]
    k_w = q8.shape[0] if layout == "io" else q8.shape[1]
    if k_w != n_in or s.shape[0] != n_out:
        raise ValueError(f"inconsistent int8 shapes ({layout}): x {tuple(x.shape)}, "
                         f"q8 {tuple(q8.shape)}, s {tuple(s.shape)}")
    if n_in % 16 or n_out % 16:
        raise ValueError(f"int8 kernel needs IN % 16 == 0 and OUT % 16 == 0, got "
                         f"{n_in}, {n_out}")
    if not (q8.is_contiguous() and s.is_contiguous()):
        raise ValueError("q8 and s must be contiguous")
    x = x.contiguous()
    if (x.data_ptr() | q8.data_ptr() | s.data_ptr()) % 16:
        raise ValueError("x, q8 and s must be 16-byte aligned")
    out_dtype = torch.float32 if layout == "vd" else x.dtype
    out = torch.empty((rows, n_out), dtype=out_dtype, device=x.device)
    route = int8_route(rows, x.dtype)
    splits, per = (split_plan(rows, n_in, n_out, layout, 2 * sm_count(x.device))
                   if route == "gemv" else (1, n_in))
    from ._build import kernel_fn

    err = kernel_fn("int8_matmul", _ARGTYPES)(
        x.data_ptr(), q8.data_ptr(), s.data_ptr(), out.data_ptr(),
        rows, n_in, n_out, n_in, int(x.dtype == torch.float32), LAYOUTS[layout],
        _ROUTES[route], splits, per,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed: CUDA error {err}")
    count("int8_matmul")
    return out


def int8_matmul(x: torch.Tensor, q8: torch.Tensor, s: torch.Tensor,
                layout: str = "io") -> torch.Tensor:
    """x [R, IN] against the int8 weight (q8, s) in `layout`: "io" [R, OUT]
    in x's dtype, "vd" [R, V] f32. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q8, s, layout)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {x.device}")
    return int8_matmul_cuda(x, q8, s, layout)

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
One rule, `int8_route`, picks the kernel: bf16 x of at most 8 rows the
decode kernel (`mma.sync` with the converted weight as A and x^T as B, the
weight streamed through a 6-stage cp.async ring), bf16 above 8 rows the
`wgmma` kernel of the transposed product (its tile of x's rows N follows
R), f32 x the scalar GEMV over blocks of 8 rows. Another, `split_plan`,
sizes the launch: the decode kernel's column tile and every route's split
of the contraction axis over a thread-block cluster. Every call is one
launch; the splits are added up inside the cluster in rank order, so
results are the same from launch to launch. The launch is programmatic:
the kernel starts streaming q8 and s before the kernel ahead of it in the
stream has finished (it reads x only after that one's writes are
visible), so q8 and s must not be written by the kernel launched just
before it; weights never are.

A tensor on the CPU goes to `int8_matmul_plain`; a CUDA tensor launches the
kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .launches import count, sm_count

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_I] * 3 + [_LL] + [_I] * 6 + [_P]
LAYOUTS = {"io": 0, "vd": 1}                  # csrc Layout
_ROUTES = {"gemv": 0, "decode": 1, "wgmma": 2}  # csrc Route
# Rows of bf16 x each tensor-core route takes (last None: no limit).
ROUTE_ROWS = {"decode": (1, 8), "wgmma": (9, None)}
GEMV_MAX_ROWS = 8          # rows of a GEMV or decode block (csrc kMaxRows)
_GEMV_COLS = 256           # output columns of an f32 io GEMV block (csrc kGemvBN)
DECODE_COLS = (128, 64, 32, 16)  # io decode column tiles, widest first (csrc kDecCols)
_DECODE_VD_COLS = 64       # table rows of a vd decode block (csrc kDecVdCols)
_DECODE_MAX_K = 8192       # contraction a decode block stages x for at most
WGMMA_ROWS = (16, 32, 64, 80, 128, 256)  # the wgmma kernel's tiles N (csrc kWgRows)
_WGMMA_COLS = 128          # output columns of a wgmma block (csrc kWgBN)
K_STEP = {"gemv": 32, "decode": 64, "wgmma": 64}  # csrc kKStep for both tensor-core routes
_MAX_SPLITS = 8            # blocks of a portable thread-block cluster
_MIN_SPLIT_ROWS = 256      # contraction rows an f32 GEMV split covers at least


def int8_matmul_plain(x: torch.Tensor, q8: torch.Tensor, s: torch.Tensor,
                      layout: str = "io") -> torch.Tensor:
    """The kernel's contract in eager PyTorch: the f32 product of x with the
    raw int8 weight, times the scale; "io" in x's dtype, "vd" in f32."""
    if layout == "vd":
        return (x.float() @ q8.float().t()) * s
    return ((x.float() @ q8.float()) * s).to(x.dtype)


def int8_route(rows: int, dtype: torch.dtype) -> str:
    """The kernel of one call: "gemv" for f32 x, else the tensor-core route
    whose ROUTE_ROWS hold `rows`: "decode" up to 8 rows, "wgmma" above."""
    if dtype == torch.float32:
        return "gemv"
    return "decode" if rows <= ROUTE_ROWS["decode"][1] else "wgmma"


def _cover(n_in: int, splits: int, step: int) -> Tuple[int, int]:
    """(splits, per): `splits` cut to cover n_in in pieces of `per`, a
    multiple of `step`, none empty."""
    per = -(-n_in // splits)
    per = -(-per // step) * step
    return -(-n_in // per), per


@functools.lru_cache(maxsize=4096)
def split_plan(route: str, rows: int, n_in: int, n_out: int, layout: str,
               sms: int) -> Tuple[int, int, int]:
    """(tile, splits, contraction values per split) of one launch on a card
    of `sms` SMs; the splits (at most 8, one cluster) cover IN, each a
    multiple of K_STEP[route]; only the wgmma kernel splits the vd layout.

    - "decode": the vd layout 64 table rows a block, no split (its blocks
      fill the card); io the widest column tile of DECODE_COLS whose
      tiles times splits reach 2 blocks an SM (splits as many as that
      takes), else the narrowest at the most splits.
    - "wgmma": N the smallest of WGMMA_ROWS that holds R (256 above), and
      as many splits as the card holds beside the output tiles (two
      blocks an SM up to N = 128, one at 256), none if they fill it.
    - "gemv" (f32): 256-column tiles over blocks of 8 rows, enough splits
      to fill about 2 blocks an SM, each at least 256 rows; vd no split."""
    step = K_STEP[route]
    if route == "decode":
        if layout == "vd":
            return (_DECODE_VD_COLS,) + _cover(n_in, 1, step)
        target = 2 * sms
        least = max(1, -(-n_in // _DECODE_MAX_K))
        for cols in DECODE_COLS:
            tiles = -(-n_out // cols)
            want = min(_MAX_SPLITS, max(1, n_in // step), -(-target // tiles))
            splits, per = _cover(n_in, max(least, want), step)
            if tiles * splits >= target:
                break
        return (cols, splits, per)
    if route == "wgmma":
        n = next((t for t in WGMMA_ROWS if t >= rows), WGMMA_ROWS[-1])
        tiles = -(-n_out // _WGMMA_COLS) * -(-rows // n)
        room = (2 if n <= 128 else 1) * sms
        splits = max(1, min(_MAX_SPLITS, room // tiles, n_in // step))
        return (n,) + _cover(n_in, splits, step)
    if layout != "io":
        return (_GEMV_COLS,) + _cover(n_in, 1, step)
    tiles = -(-n_out // _GEMV_COLS) * -(-rows // GEMV_MAX_ROWS)
    splits = max(1, min(_MAX_SPLITS, -(-2 * sms // tiles), n_in // _MIN_SPLIT_ROWS))
    return (_GEMV_COLS,) + _cover(n_in, splits, step)


@functools.lru_cache(maxsize=None)
def _kernel():
    from ._build import kernel_fn

    return kernel_fn("int8_matmul", _ARGTYPES)


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
    tile, splits, per = split_plan(route, rows, n_in, n_out, layout, sm_count(x.device))
    err = _kernel()(
        x.data_ptr(), q8.data_ptr(), s.data_ptr(), out.data_ptr(),
        rows, n_in, n_out, n_in, int(x.dtype == torch.float32), LAYOUTS[layout],
        _ROUTES[route], tile, splits, per,
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

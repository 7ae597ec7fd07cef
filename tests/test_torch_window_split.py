"""The paged query-window kernel's host side, on the CPU: the split plan
(`window_split_plan`, a pure function of the launch's shape and the card's
SM count) and the wrappers' routing of a call to the C entry points, which
the CPU never launches: a bf16 window (T > 1) passes a cluster size of 1..8
and counts as a window launch, an f32 window passes 0 (the tile kernel), a
decode step (T == 1) the decode kernel's plan. The kernel itself is held
against its plain version on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`); here the per-row limit chip_smoke.py holds it to is
checked against a planted fault in the plain version."""

from types import SimpleNamespace

import pytest
import torch

from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import _build
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import attention
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import paged_attention as pa
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import (
    decode_split_plan,
    window_split_plan,
)

WAVE = attention._WINDOW_BLOCKS_PER_SM


@pytest.mark.parametrize("b,kh,s_virt,rows,sms", [
    (8, 32, 4096, 32, 132),    # 7B mixed round, T = 32 (G = 1), tables of 64 pages
    (8, 32, 4096, 16, 132),    # 7B, T = 16
    (8, 8, 8192, 96, 132),     # 3B mixed round, T = 32 (G = 3): two row tiles
    (8, 8, 8192, 48, 132),     # 3B, T = 16
    (8, 8, 512, 64, 132),      # 1B (H = 64) window of 16 (G = 4)
    (1, 32, 4096, 128, 132),   # one 7B chunk of 128
    (8, 32, 100, 32, 132),     # short tables: no split shorter than a tile
    (8, 32, 64, 32, 132),      # one tile a row: no split
    (2, 2, 129, 32, 132),
    (64, 32, 4096, 32, 132),   # 2048 blocks: a wave is full unsplit
    (8, 32, 4096, 512, 132),   # 8 row tiles a (b, kv head)
    (8, 32, 4096, 32, 114),    # fewer SMs
    (8, 32, 4096, 32, 8),      # a small card
    (1, 1, 1, 2, 132),
])
def test_window_split_plan_bounds(b, kh, s_virt, rows, sms):
    """1..8 blocks (one portable cluster), no split shorter than one 64-slot
    tile of the longest row the table holds, and the whole number nearest
    to WAVE blocks an SM: 1 where the unsplit launch already reaches it."""
    splits = window_split_plan(b, kh, s_virt, rows, sms)
    blocks = b * kh * -(-rows // 64)
    assert 1 <= splits <= 8
    assert splits == 1 or 64 * (splits - 1) < s_virt
    if blocks >= WAVE * sms:
        assert splits == 1
    if splits < min(8, -(-s_virt // 64)):
        # the next size would overshoot the aim by more than this one misses it
        assert abs(blocks * splits - WAVE * sms) <= abs(blocks * (splits + 1) - WAVE * sms)
    if splits > 1:
        assert abs(blocks * splits - WAVE * sms) <= abs(blocks * (splits - 1) - WAVE * sms)


@pytest.mark.parametrize("b,kh,s_virt,rows,want", [
    (8, 32, 4096, 32, 3),     # 7B mixed, T = 32: 256 blocks, 3 splits
    (8, 32, 4096, 16, 3),     # 7B mixed, T = 16
    (8, 8, 8192, 96, 6),      # 3B mixed, T = 32: two row tiles, 128 blocks
    (8, 8, 8192, 48, 8),      # 3B mixed, T = 16: 64 blocks
    (8, 32, 100, 32, 2),      # two tiles at most
    (64, 32, 4096, 32, 1),
])
def test_window_split_plan_at_the_mixed_round(b, kh, s_virt, rows, want):
    """The plan's pick on an H100's 132 SMs at the ragged mixed round's
    shapes (`chip_smoke.py`'s `mixed_cases`, tuned there by `--sweep`)."""
    assert window_split_plan(b, kh, s_virt, rows, 132) == want


@pytest.mark.parametrize("t,g,bf16", [(1, 1, True), (1, 3, False), (2, 1, True),
                                      (16, 3, True), (32, 1, True), (32, 1, False),
                                      (16, 3, False)])
def test_launch_splits_routes_by_window_and_dtype(t, g, bf16):
    """T == 1 takes the decode kernel's plan; a bf16 window the window
    kernel's (1..8); an f32 window 0, the tile kernel."""
    b, kh, s_virt = 8, 32 // g, 4096
    got = pa.launch_splits(b, kh, s_virt, t, g, bf16, 132)
    if t == 1:
        assert got == decode_split_plan(b, kh, s_virt, 1, 132) >= 1
    elif bf16:
        assert got == window_split_plan(b, kh, s_virt, g * t, 132) >= 1
    else:
        assert got == 0


@pytest.fixture
def fake_launch(monkeypatch):
    """Stand-ins for the C entry points, the SM count and the stream: each
    call records (entry point, arguments); each count, its name."""
    calls, counted = [], []

    def kernel_fn(name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "kernel_fn", kernel_fn)
    monkeypatch.setattr(pa, "sm_count", lambda device: 132)
    monkeypatch.setattr(pa, "count", counted.append)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return calls, counted


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("t,dtype", [(32, torch.bfloat16), (16, torch.bfloat16),
                                     (32, torch.float32), (1, torch.bfloat16)])
def test_wrappers_pass_the_split_and_count_windows_apart(fake_launch, quantized, t, dtype):
    """A 7B-shaped call (B = 8, N = K = 32, H = 128, tables of 64 pages of
    64) passes `launch_splits`' pick as `splits` and counts one launch:
    a window (T > 1) as "ragged_paged_window", a decode step as
    "ragged_paged_attention" (each "_quantized" over the int8 pool)."""
    calls, counted = fake_launch
    b, n, kh, h, ps, np_tab, pages = 8, 32, 32, 128, 64, 64, 4
    q = torch.zeros((b, t, n, h), dtype=dtype)
    table = torch.zeros((b, np_tab), dtype=torch.int32)
    pos = torch.arange(t, dtype=torch.int32).repeat(b, 1)
    kvl = torch.full((b,), t, dtype=torch.int32)
    if quantized:
        k8 = torch.zeros((pages, kh, ps, h), dtype=torch.int8)
        sc = torch.ones((pages, kh, ps))
        pa.ragged_paged_attention_quantized_cuda(q, k8, sc, k8, sc, table, pos, None, kvl)
    else:
        kv = torch.zeros((pages, kh, ps, h), dtype=dtype)
        pa.ragged_paged_attention_cuda(q, kv, kv, table, pos, None, kvl)
    name = "ragged_paged_attention" + ("_quantized" if quantized else "")
    (called, args), = calls
    assert called == name
    splits = args[-2]
    assert splits == pa.launch_splits(b, kh, np_tab * ps, t, 1, dtype == torch.bfloat16, 132)
    assert (splits == 0) == (t > 1 and dtype == torch.float32)
    assert counted == [name if t == 1 else name.replace("attention", "window")]


def _window_case(rows, quantized):
    """A bf16 mixed-round window on the CPU (T = 32, one KV head, H = 128,
    pages of 64 in a shuffled pool, sentinel past each row's live pages):
    the plain version's arguments, the table at index 3 (5 over the int8
    pool)."""
    from llm_based_apache_spark_optimization_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator().manual_seed(2)
    b, t, h, ps, np_tab = len(rows), 32, 128, 64, 64
    pages = b * np_tab + 3
    q = torch.randn((b, t, 1, h), generator=g).bfloat16()
    kp = torch.randn((pages, 1, ps, h), generator=g).bfloat16()
    vp = torch.randn((pages, 1, ps, h), generator=g).bfloat16()
    tab = torch.randperm(pages, generator=g)[: b * np_tab].reshape(b, np_tab).int()
    pos = torch.full((b, t), np_tab * ps, dtype=torch.int32)
    for i, (start, ql, kvl) in enumerate(rows):
        pos[i, :ql] = start + torch.arange(ql)
        tab[i, -(-kvl // ps):] = pages
    kvl = torch.tensor([r[2] for r in rows], dtype=torch.int32)
    qln = torch.tensor([r[1] for r in rows], dtype=torch.int32)
    if not quantized:
        return (q, kp, vp, tab, pos, None, kvl, qln), 3
    k8, v8 = quantize_kv(kp), quantize_kv(vp)
    return (q, k8["q8"], k8["s"], v8["q8"], v8["s"], tab, pos, None, kvl, qln), 5


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shape", ["chunks_4096", "mixed_t32"])
def test_window_row_limit_catches_a_dropped_tile(quantized, shape):
    """chip_smoke.py's per-row limit on the bf16 windows: the plain version
    with the longest row's middle 64-slot tile left out stays within the
    absolute bf16 limit but fails the per-row one (`window_control`), while
    the plain version computed in f32 and rounded to bf16 (rounding alone)
    passes it."""
    import chip_smoke as cs

    rows = ([(4064, 32, 4096)] * 2 if shape == "chunks_4096"
            else cs.mixed_rows(32, 4096))
    args, ti = _window_case(rows, quantized)
    plain = (pa.ragged_paged_attention_quantized_plain if quantized
             else pa.ragged_paged_attention_plain)
    ref = plain(*args)
    cs.window_control(torch, plain, args, ti, ref, shape)
    wide = tuple(x.float() if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
                 else x for x in args)
    assert cs.row_rel_err(plain(*wide).bfloat16(), ref) <= cs.WINDOW_ROW_TOL
    tab, pos, kvl, row = cs.drop_tile(torch, args[ti], args[ti + 1], args[ti + 3],
                                      64, args[1].shape[0])
    fault = plain(*args[:ti], tab, pos, args[ti + 2], kvl, *args[ti + 4:])
    assert (fault[row].float() - ref[row].float()).abs().max() <= cs.TOL["bfloat16"]

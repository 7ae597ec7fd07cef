"""The port's CUDA kernels against their plain versions, on a CUDA card:
flash GQA attention (the split-KV decode kernel, the scalar tile kernel and
the bf16 tensor-core prefill), ragged paged attention (the split-KV decode
kernel, the bf16 query windows' split tensor-core kernel and the f32 ones'
tile kernel, every launch bit-identical from launch to launch) and the
page write (one kernel for both pools, also behind its producer in a CUDA
graph), their int8-cache twins (the split-KV decode kernel at its edges,
and every decode launch bit-identical from launch to launch), the int4
matmul (decode, prefill and f32 rows kernels) and the int8 matmul (the
decode and wgmma kernels at each route's boundary row counts and the f32
GEMV, both weight layouts).

Needs a card (marker `cuda`); skips elsewhere. On the card:
`python -m pytest tests/test_torch_cuda.py -q`. Tolerances as in
chip_smoke.py: attention max abs error 1e-4 in f32, 3e-2 in bf16 (bf16
outputs are rounded to bf16 and the probabilities are rounded at a
different running max than the plain version's), and bf16 query windows
also within 5e-2 of each query row's largest output; the page writes are
bit-exact; the int4 matmul within 1e-5 (f32) and 1e-2 (bf16: one bf16 ulp
is up to 2**-7 of the largest output) of max |out|, since only the order of
the f32 sums differs. The int8 matmul's bf16 outputs within one bf16 ulp of
the plain value, element by element (an element's ulp floored at 2**-8 of
the largest output's: outputs that cancel to near zero carry the f32 sum
order's error), its f32 outputs within 1e-5 and its f32 logits within 1e-4
of max |out|, every launch bit-identical to the one before."""

import pytest
import torch

from llm_based_apache_spark_optimization_tpu_torch.ops import quant
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import LAUNCHES
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import attention as k
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import int4mm
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import int8mm
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import paged_attention as pa
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import paged_write as pw

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# bf16 query windows (T > 1), per query row as in chip_smoke.py: max |out -
# ref| over the row's max |ref|, which a 64-slot tile of keys left out of a
# long row exceeds where the absolute TOL does not.
WINDOW_ROW_TOL = 5e-2


def row_rel_err(out, ref):
    d = (out.float() - ref.float()).abs().amax(-1)
    s = ref.float().abs().amax(-1)
    return (d / s.clamp_min(1e-30)).where(s > 0, d).max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,n,kh,h,window", [
    (1, 32, 32, 128, None), (1, 24, 8, 128, None), (1, 32, 8, 64, 40),
    (37, 32, 32, 128, None), (37, 24, 8, 128, 16), (20, 32, 8, 64, None),
    # The split decode kernel's edges: G = 1, 3, 4, 16 at H = 64 and 128,
    # windows of 3 that hide all but each row's last 3 slots.
    (1, 32, 32, 64, 3), (1, 24, 8, 64, None), (1, 32, 8, 128, 3),
    (1, 32, 2, 128, None), (1, 32, 2, 64, 3), (1, 24, 8, 128, 3),
])
def test_kernel_matches_plain(cuda, dtype, t, n, kh, h, window):
    """Rows of 1 and 6 + T live slots (fewer than the splits at T = 1),
    kv_lens = 0 beside a full row, NaN in every slot past a row's live
    length: within TOL of the plain version, exact zeros for the parked
    row, one launch a call; a decode launch (the split kernel) is
    bit-identical over two launches."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b, s = 4, 136
    q = torch.randn((b, t, n, h), generator=g, device=cuda).to(dtype)
    kk = torch.randn((b, kh, s, h), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, kh, s, h), generator=g, device=cuda).to(dtype)
    pos = (torch.tensor([[0], [6], [50], [s - t]], device=cuda)
           + torch.arange(t, device=cuda)).int()
    lens = torch.tensor([1, 6 + t, 0, s], dtype=torch.int32, device=cuda)
    dead = torch.arange(s, device=cuda)[None, :] >= lens[:, None]
    kk[dead[:, None, :, None].expand_as(kk)] = float("nan")
    v[dead[:, None, :, None].expand_as(v)] = float("nan")
    launch = "flash_gqa_decode" if t == 1 else "flash_gqa_prefill"
    before = dict(LAUNCHES)
    out = k.flash_gqa_attention(q, kk, v, pos, window, lens)
    assert LAUNCHES == dict(before, **{launch: before[launch] + 1})
    ref = k.flash_gqa_attention_plain(q, kk, v, pos, window, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (out[2] == 0).all()
    if t == 1:
        assert torch.equal(out, k.flash_gqa_attention(q, kk, v, pos, window, lens))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,n,kh,h,window", [
    (100, 24, 8, 128, None), (100, 32, 8, 64, None), (128, 32, 32, 128, None),
    (64, 24, 8, 128, 96), (16, 32, 32, 128, None), (37, 24, 8, 64, 40),
])
def test_prefill_kernel_matches_plain_on_ragged_chunks(cuda, dtype, t, n, kh, h, window):
    """Prefill chunks over S = 1024 (the bf16 launch runs the tensor-core
    kernel): ragged starts, a row with kv_lens = 0, and NaN in every slot
    past a row's live length, which no row may read."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, s = 3, 1024
    q = torch.randn((b, t, n, h), generator=g, device=cuda).to(dtype)
    kk = torch.randn((b, kh, s, h), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, kh, s, h), generator=g, device=cuda).to(dtype)
    starts = torch.tensor([[0], [208], [s - t]], device=cuda)
    pos = (starts + torch.arange(t, device=cuda)).int()
    lens = torch.tensor([0, 208 + t, s], dtype=torch.int32, device=cuda)
    dead = torch.arange(s, device=cuda)[None, :] >= lens[:, None]
    kk[dead[:, None, :, None].expand_as(kk)] = float("nan")
    v[dead[:, None, :, None].expand_as(v)] = float("nan")
    before = dict(LAUNCHES)
    out = k.flash_gqa_attention(q, kk, v, pos, window, lens)
    ref = k.flash_gqa_attention_plain(q, kk, v, pos, window, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (out[0] == 0).all()
    assert LAUNCHES == dict(before, flash_gqa_prefill=before["flash_gqa_prefill"] + 1)


def test_kernel_raises_on_unsupported_head_dim(cuda):
    q = torch.zeros((1, 1, 4, 32), device=cuda)
    kv = torch.zeros((1, 2, 8, 32), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        k.flash_gqa_attention(q, kv, kv, torch.zeros((1, 1), dtype=torch.int32,
                                                     device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,n,kh,h,ps,window", [
    (1, 32, 32, 128, 64, None), (1, 24, 8, 128, 16, None), (1, 32, 8, 64, 8, None),
    (8, 24, 8, 128, 16, None), (32, 16, 8, 128, 64, None), (4, 32, 8, 128, 16, 40),
    # The split decode kernel's edges: G = 1, 3, 4, 16 at H = 64 and 128
    # over pages of 8 and 64, windows of 3.
    (1, 32, 32, 64, 8, 3), (1, 24, 8, 64, 64, None), (1, 32, 8, 128, 64, 3),
    (1, 32, 2, 128, 8, None), (1, 32, 2, 64, 64, 3), (1, 24, 8, 128, 8, 3),
])
def test_paged_kernel_matches_plain(cuda, dtype, t, n, kh, h, ps, window):
    """Rows of 1 and 6 + T live slots, a parked row (all sentinel, kv_lens =
    0) beside a full row, ragged q_lens, NaN on every page no table maps and
    in the dead offsets of each row's last live page: within TOL of the
    plain version, exact zeros for the parked row and the dead columns, one
    launch a call (a decode launch counted as such, a window apart), and
    bit-identical over two launches (the split kernel at T = 1, the window
    kernel's cluster merge in bf16 at T > 1)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b, np_tab = 4, 8
    pages = b * np_tab + 2
    kp = torch.randn((pages, kh, ps, h), generator=g, device=cuda).to(dtype)
    vp = torch.randn((pages, kh, ps, h), generator=g, device=cuda).to(dtype)
    s_virt = np_tab * ps
    kvl = torch.tensor([1, 6 + t, 0, s_virt], dtype=torch.int32, device=cuda)
    tab = torch.randperm(pages, generator=g, device=cuda)[: b * np_tab]
    tab = tab.reshape(b, np_tab).int()
    live = torch.zeros(pages, dtype=torch.bool, device=cuda)
    for i, n_live in enumerate((-(-int(x) // ps) for x in kvl)):
        tab[i, n_live:] = pages  # sentinel past the live pages; row 2 parked
        live[tab[i, :n_live].long()] = True
        if int(kvl[i]) % ps:
            kp[tab[i, n_live - 1], :, int(kvl[i]) % ps:] = float("nan")
            vp[tab[i, n_live - 1], :, int(kvl[i]) % ps:] = float("nan")
    kp[~live] = float("nan")
    vp[~live] = float("nan")
    q = torch.randn((b, t, n, h), generator=g, device=cuda).to(dtype)
    starts = torch.tensor([[0], [6], [s_virt - t], [s_virt - t]], device=cuda)
    pos = (starts + torch.arange(t, device=cuda)).int()
    qln = torch.tensor([t, max(1, t // 2), t, t], dtype=torch.int32, device=cuda)
    args = (q, kp, vp, tab, pos, window, kvl, qln)
    before = dict(LAUNCHES)
    out = pa.ragged_paged_attention(*args)
    counter = "ragged_paged_attention" if t == 1 else "ragged_paged_window"
    assert LAUNCHES == dict(before, **{counter: before[counter] + 1})
    ref = pa.ragged_paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    if t > 1 and dtype == torch.bfloat16:
        assert row_rel_err(out, ref) <= WINDOW_ROW_TOL
    assert (out[2] == 0).all() and (out[1, int(qln[1]):] == 0).all()
    assert torch.equal(out, pa.ragged_paged_attention(*args))


# Page-write cases: (name, B, T, table pages). "t1_b8" is a decode round of
# 8 slots, two parked behind all-sentinel rows; "t4_qlens" windows of 4 with
# q_lens, a parked row and a row that runs past its table; "all_dropped" a
# round that writes nothing (every drop: negative, past the row, sentinel,
# q_lens = 0); "long_table" a table of more than TABLE_PREFETCH_PAGES pages,
# whose entry is loaded after the position.
WRITE_CASES = [("t1_b8", 8, 1, 4), ("t4_qlens", 4, 4, 4), ("all_dropped", 8, 1, 4),
               ("long_table", 8, 1, 80)]


def write_inputs(cuda, case, kh, h, ps, dtype):
    """(pool pages, k_new, v_new, positions, table, q_lens) of one case:
    every kept sliver on its own (page, offset), so the plain version's
    order of writes does not matter."""
    name, b, t, np_tab = case
    g = torch.Generator(device=cuda).manual_seed(1)
    k_new = torch.randn((b, t, kh, h), generator=g, device=cuda).to(dtype)
    v_new = torch.randn((b, t, kh, h), generator=g, device=cuda).to(dtype)
    k_new[0, 0, 1] = 0.0  # an all-zero row (the int8 pool: scale 1)
    cap = np_tab * ps
    if name == "long_table":
        pages = b + 3
        pos = torch.randint(0, cap, (b, 1), generator=g, device=cuda)
        tab = torch.full((b, np_tab), pages, dtype=torch.int32, device=cuda)
        tab[torch.arange(b, device=cuda), pos[:, 0] // ps] = torch.randperm(
            pages, generator=g, device=cuda)[:b].int()
        return pages, k_new, v_new, pos.int(), tab, None
    pages = b * np_tab + 3
    tab = torch.randperm(pages, generator=g, device=cuda)[: b * np_tab]
    tab = tab.reshape(b, np_tab).int()
    starts = torch.randint(0, cap - t, (b, 1), generator=g, device=cuda)
    pos = (starts + torch.arange(t, device=cuda)).int()
    qln = None
    if name == "t1_b8":
        for i in (2, 6):  # parked slots, as a decode round has
            tab[i] = pages
            pos[i] = cap - 1
    elif name == "t4_qlens":
        tab[3] = pages            # a parked row
        pos[2] = cap - 2 + torch.arange(t, device=cuda)  # runs past the row
        qln = torch.tensor([t, 2, t, t], dtype=torch.int32, device=cuda)
    else:  # all_dropped
        pos[0:2] = -1
        pos[2:4] = cap + torch.tensor([[0], [ps]], device=cuda)
        tab[4:6] = pages
        qln = torch.tensor([1, 1, 1, 1, 1, 1, 0, 0], dtype=torch.int32, device=cuda)
    return pages, k_new, v_new, pos, tab, qln


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kh,h", [(32, 128), (8, 128), (32, 64), (8, 64)])
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("case", WRITE_CASES, ids=[c[0] for c in WRITE_CASES])
def test_page_write_kernel_is_bit_exact(cuda, dtype, kh, h, ps, case):
    pages, k_new, v_new, pos, tab, qln = write_inputs(cuda, case, kh, h, ps, dtype)
    g = torch.Generator(device=cuda).manual_seed(2)
    kp = torch.randn((3, pages, kh, ps, h), generator=g, device=cuda).to(dtype)
    vp = torch.randn_like(kp)
    kk, vk, kr, vr = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    before = dict(LAUNCHES)
    pw.fused_page_write(kk, vk, k_new, v_new, pos, tab, 1, qln)
    pw.fused_page_write_plain(kr, vr, k_new, v_new, pos, tab, 1, qln)
    torch.cuda.synchronize()
    assert torch.equal(kk, kr) and torch.equal(vk, vr)
    # all_dropped leaves the pools as they were; every other case writes.
    assert torch.equal(kk, kp) == (case[0] == "all_dropped")
    assert LAUNCHES == dict(before, fused_page_write=before["fused_page_write"] + 1)


@pytest.mark.parametrize("quantized", [False, True])
def test_page_write_is_exact_behind_its_producer_in_a_graph(cuda, quantized):
    """The programmatic dependent launch against its producer: one CUDA
    graph of 32 layers, each an in-place op that rewrites k_new, v_new and
    the int64 positions, then the page write through the wrapper, whose
    int32 casts of the positions and the int64 table run just before the
    kernel. Replayed, every layer is bit-exact with the plain version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    n_layers, b, kh, h, ps, np_tab = 32, 8, 32, 128, 64, 16
    pages = b * np_tab + 1
    src_k = torch.randn((n_layers, b, 1, kh, h), generator=g, device=cuda).bfloat16()
    src_v = torch.randn((n_layers, b, 1, kh, h), generator=g, device=cuda).bfloat16()
    src_pos = torch.randint(0, np_tab * ps, (n_layers, b, 1), generator=g, device=cuda)
    tab = torch.randperm(pages, generator=g, device=cuda)[: b * np_tab].reshape(b, np_tab)
    shape = (n_layers, pages, kh, ps, h)
    if quantized:
        k8, ks = q8(torch.randn(shape, generator=g, device=cuda))
        v8, vs = q8(torch.randn(shape, generator=g, device=cuda))
        pools = [k8, ks, v8, vs]
        write, plain = pw.fused_page_write_quantized, pw.fused_page_write_quantized_plain
    else:
        pools = [torch.randn(shape, generator=g, device=cuda).bfloat16() for _ in "kv"]
        write, plain = pw.fused_page_write, pw.fused_page_write_plain
    start = [x.clone() for x in pools]
    k_new, v_new = torch.empty_like(src_k[0]), torch.empty_like(src_v[0])
    pos = torch.empty_like(src_pos[0])

    def step(layer):
        k_new.copy_(src_k[layer])
        v_new.copy_(src_v[layer])
        pos.copy_(src_pos[layer])
        write(*pools, k_new, v_new, pos, tab, layer)

    step(0)  # loads the kernel before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for layer in range(n_layers):
            step(layer)
    for x, x0 in zip(pools, start):
        x.copy_(x0)
    graph.replay()
    want = [x.clone() for x in start]
    for layer in range(n_layers):
        plain(*want, src_k[layer], src_v[layer], src_pos[layer], tab, layer)
    torch.cuda.synchronize()
    for x, w in zip(pools, want):
        assert torch.equal(x, w)
    assert not torch.equal(pools[0], start[0])


def q8(x):
    q = quant.quantize_kv(x)
    return q["q8"], q["s"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,kh,h,window", [
    (32, 32, 128, None), (24, 8, 128, None), (32, 8, 64, 40),
    (32, 8, 128, None), (8, 8, 64, None), (32, 2, 128, None), (32, 2, 64, 8),
])
def test_quantized_flash_kernel_matches_plain(cuda, dtype, n, kh, h, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, s = 3, 136
    q = torch.randn((b, 1, n, h), generator=g, device=cuda).to(dtype)
    k8, ks = q8(torch.randn((b, kh, s, h), generator=g, device=cuda))
    v8, vs = q8(torch.randn((b, kh, s, h), generator=g, device=cuda))
    pos = torch.tensor([[0], [50], [s - 1]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([0, 51, s], dtype=torch.int32, device=cuda)
    ks[1, :, 51:] = float("nan")  # dead slots: never read
    vs[1, :, 51:] = float("nan")
    before = dict(LAUNCHES)
    out = k.flash_gqa_attention_quantized(q, k8, ks, v8, vs, pos, window, lens)
    ref = k.flash_gqa_attention_quantized_plain(q, k8, ks, v8, vs, pos, window, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (out[0] == 0).all()
    assert (LAUNCHES["flash_gqa_decode_quantized"]
            == before["flash_gqa_decode_quantized"] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,n,kh,h,ps,window", [
    (1, 32, 32, 128, 64, None), (1, 24, 8, 128, 16, None), (1, 32, 8, 64, 8, None),
    (8, 24, 8, 128, 16, None), (32, 16, 8, 128, 64, None), (4, 32, 8, 128, 16, 40),
    (1, 32, 8, 128, 16, 5), (1, 16, 16, 64, 16, None), (1, 32, 2, 128, 8, None),
    (1, 32, 2, 64, 64, 20),
])
def test_quantized_paged_kernel_matches_plain(cuda, dtype, t, n, kh, h, ps, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, np_tab = 3, 8
    pages = b * np_tab + 2
    kp, kps = q8(torch.randn((pages, kh, ps, h), generator=g, device=cuda))
    vp, vps = q8(torch.randn((pages, kh, ps, h), generator=g, device=cuda))
    tab = torch.randperm(pages, generator=g, device=cuda)[: b * np_tab]
    tab = tab.reshape(b, np_tab).int()
    tab[1, -2:] = pages  # unmapped tail past the live region
    unmapped = torch.ones(pages, dtype=torch.bool, device=cuda)
    unmapped[tab[tab < pages].long()] = False
    kps[unmapped] = float("nan")
    vps[unmapped] = float("nan")
    s_virt = np_tab * ps
    q = torch.randn((b, t, n, h), generator=g, device=cuda).to(dtype)
    starts = torch.tensor([[0], [s_virt // 3], [s_virt - t]], device=cuda)
    pos = (starts + torch.arange(t, device=cuda)).int()
    kvl = torch.tensor([0, s_virt // 3 + t, s_virt], dtype=torch.int32, device=cuda)
    qln = torch.tensor([t, max(1, t // 2), t], dtype=torch.int32, device=cuda)
    args = (q, kp, kps, vp, vps, tab, pos, window, kvl, qln)
    before = dict(LAUNCHES)
    out = pa.ragged_paged_attention_quantized(*args)
    ref = pa.ragged_paged_attention_quantized_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    if t > 1 and dtype == torch.bfloat16:
        assert row_rel_err(out, ref) <= WINDOW_ROW_TOL
    assert (out[0] == 0).all() and (out[1, int(qln[1]):] == 0).all()
    counter = ("ragged_paged_attention_quantized" if t == 1
               else "ragged_paged_window_quantized")
    assert LAUNCHES == dict(before, **{counter: before[counter] + 1})
    assert torch.equal(out, pa.ragged_paged_attention_quantized(*args))


def _decode_edges(cuda, dtype, g, h, s, seed):
    """q and a quantized contiguous cache for the split kernel's edges: live
    lengths of 1 and 7 slots (fewer than the splits), kv_lens = 0 beside a
    full row, NaN in every dead slot's scales."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    b, kh = 4, 2
    q = torch.randn((b, 1, g * kh, h), generator=gen, device=cuda).to(dtype)
    k8, ks = q8(torch.randn((b, kh, s, h), generator=gen, device=cuda))
    v8, vs = q8(torch.randn((b, kh, s, h), generator=gen, device=cuda))
    pos = torch.tensor([[0], [6], [s // 2], [s - 1]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([1, 7, 0, s], dtype=torch.int32, device=cuda)
    dead = torch.arange(s, device=cuda)[None, :] >= lens[:, None]
    ks[dead[:, None].expand_as(ks)] = float("nan")
    vs[dead[:, None].expand_as(vs)] = float("nan")
    return q, k8, ks, v8, vs, pos, lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 3, 4, 16])
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("window", [None, 3])
def test_quantized_flash_kernel_edges_match_plain(cuda, dtype, g, h, window):
    """The split decode kernel at its edges (`_decode_edges`; the window of
    3 hides all but the last 3 slots of each row), G = 1, 3, 4, 16: within
    TOL of the plain version, exact zeros for the parked row, bit-identical
    over two launches, one launch a call."""
    q, k8, ks, v8, vs, pos, lens = _decode_edges(cuda, dtype, g, h, 520, seed=4)
    args = (q, k8, ks, v8, vs, pos, window, lens)
    before = dict(LAUNCHES)
    out = k.flash_gqa_attention_quantized(*args)
    again = k.flash_gqa_attention_quantized(*args)
    ref = k.flash_gqa_attention_quantized_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (out[2] == 0).all()
    assert torch.equal(out, again)
    assert LAUNCHES == dict(before, flash_gqa_decode_quantized=before[
        "flash_gqa_decode_quantized"] + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 3, 4, 16])
@pytest.mark.parametrize("h,ps", [(64, 16), (128, 64)])
@pytest.mark.parametrize("window", [None, 3])
def test_quantized_paged_kernel_edges_match_plain(cuda, dtype, g, h, ps, window):
    """The split decode kernel over the int8 pool at its edges: rows of 1
    and 7 live slots, a parked row (all sentinel, kv_lens = 0) beside a full
    row, a window hiding all but the last 3 slots, NaN scales on every page
    no table maps, G = 1, 3, 4, 16: within TOL, exact zeros for the parked
    row, bit-identical over two launches, one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, kh, np_tab = 4, 2, 16
    pages = b * np_tab + 3
    kp, kps = q8(torch.randn((pages, kh, ps, h), generator=gen, device=cuda))
    vp, vps = q8(torch.randn((pages, kh, ps, h), generator=gen, device=cuda))
    s_virt = np_tab * ps
    kvl = torch.tensor([1, 7, 0, s_virt], dtype=torch.int32, device=cuda)
    pos = torch.tensor([[0], [6], [s_virt - 1], [s_virt - 1]], dtype=torch.int32,
                       device=cuda)
    perm = torch.randperm(pages, generator=gen, device=cuda)
    tab = torch.full((b, np_tab), pages, dtype=torch.int32, device=cuda)
    tab[0, 0], tab[1, 0] = perm[0], perm[1]
    tab[3] = perm[2:2 + np_tab].int()
    unmapped = torch.ones(pages, dtype=torch.bool, device=cuda)
    unmapped[tab[tab < pages].long()] = False
    kps[unmapped] = float("nan")
    vps[unmapped] = float("nan")
    q = torch.randn((b, 1, g * kh, h), generator=gen, device=cuda).to(dtype)
    args = (q, kp, kps, vp, vps, tab, pos, window, kvl, None)
    before = dict(LAUNCHES)
    out = pa.ragged_paged_attention_quantized(*args)
    again = pa.ragged_paged_attention_quantized(*args)
    ref = pa.ragged_paged_attention_quantized_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (out[2] == 0).all()
    assert torch.equal(out, again)
    assert LAUNCHES == dict(before, ragged_paged_attention_quantized=before[
        "ragged_paged_attention_quantized"] + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_decode_kernels_are_deterministic(cuda, dtype):
    """Both int8 decode launches at the main paths' shapes (7B: the engine
    at B = 1, S = 448, position 374; the scheduler's 8 slots over pages of
    64, live 64-1024) give bit-identical output launch after launch: the
    split partials merge in fixed orders, never with atomics."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    n = kh = 32
    h = 128
    q = torch.randn((1, 1, n, h), generator=gen, device=cuda).to(dtype)
    k8, ks = q8(torch.randn((1, kh, 448, h), generator=gen, device=cuda))
    v8, vs = q8(torch.randn((1, kh, 448, h), generator=gen, device=cuda))
    pos = torch.tensor([[374]], dtype=torch.int32, device=cuda)
    outs = [k.flash_gqa_attention_quantized(q, k8, ks, v8, vs, pos) for _ in range(3)]
    lens = [64, 200, 333, 480, 600, 777, 900, 1024]
    pages = 16 * len(lens)
    kp, kps = q8(torch.randn((pages, kh, 64, h), generator=gen, device=cuda))
    vp, vps = q8(torch.randn((pages, kh, 64, h), generator=gen, device=cuda))
    tab = torch.randperm(pages, generator=gen, device=cuda).reshape(len(lens), 16).int()
    kvl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    qp = torch.randn((len(lens), 1, n, h), generator=gen, device=cuda).to(dtype)
    paged = [pa.ragged_paged_attention_quantized(qp, kp, kps, vp, vps, tab,
                                                 (kvl - 1)[:, None], None, kvl)
             for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert all(torch.equal(paged[0], o) for o in paged[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_are_deterministic(cuda, dtype):
    """The twin of the int8 test above over a cache of the compute type:
    both decode launches at the main paths' 7B shapes (the engine at B = 1,
    S = 448, position 374; the scheduler's 8 slots over pages of 64, live
    64-1024) give bit-identical output over three launches."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    n = kh = 32
    h = 128
    q = torch.randn((1, 1, n, h), generator=gen, device=cuda).to(dtype)
    kk = torch.randn((1, kh, 448, h), generator=gen, device=cuda).to(dtype)
    v = torch.randn((1, kh, 448, h), generator=gen, device=cuda).to(dtype)
    pos = torch.tensor([[374]], dtype=torch.int32, device=cuda)
    outs = [k.flash_gqa_attention(q, kk, v, pos) for _ in range(3)]
    lens = [64, 200, 333, 480, 600, 777, 900, 1024]
    pages = 16 * len(lens)
    kp = torch.randn((pages, kh, 64, h), generator=gen, device=cuda).to(dtype)
    vp = torch.randn((pages, kh, 64, h), generator=gen, device=cuda).to(dtype)
    tab = torch.randperm(pages, generator=gen, device=cuda).reshape(len(lens), 16).int()
    kvl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    qp = torch.randn((len(lens), 1, n, h), generator=gen, device=cuda).to(dtype)
    paged = [pa.ragged_paged_attention(qp, kp, vp, tab, (kvl - 1)[:, None], None, kvl)
             for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert all(torch.equal(paged[0], o) for o in paged[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kh,h", [(32, 128), (8, 128), (32, 64), (8, 64)])
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("case", WRITE_CASES, ids=[c[0] for c in WRITE_CASES])
def test_quantized_page_write_kernel_is_bit_exact(cuda, dtype, kh, h, ps, case):
    pages, k_new, v_new, pos, tab, qln = write_inputs(cuda, case, kh, h, ps, dtype)
    g = torch.Generator(device=cuda).manual_seed(2)
    kp, kps = q8(torch.randn((3, pages, kh, ps, h), generator=g, device=cuda))
    vp, vps = q8(torch.randn((3, pages, kh, ps, h), generator=g, device=cuda))
    got = [x.clone() for x in (kp, kps, vp, vps)]
    want = [x.clone() for x in (kp, kps, vp, vps)]
    before = dict(LAUNCHES)
    pw.fused_page_write_quantized(*got, k_new, v_new, pos, tab, 1, qln)
    pw.fused_page_write_quantized_plain(*want, k_new, v_new, pos, tab, 1, qln)
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert torch.equal(got[0], kp) == (case[0] == "all_dropped")
    assert LAUNCHES == dict(before, fused_page_write_quantized=before[
        "fused_page_write_quantized"] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 4, 8, 9, 16, 131, 1024, 2048])
@pytest.mark.parametrize("n_in,n_out,group", [
    (4096, 4096, 128), (4096, 11008, 128), (11008, 4096, 86),  # 7B
    (3072, 3072, 128), (3072, 1024, 128), (3072, 8192, 128), (8192, 3072, 128),  # 3B
    (688, 144, 86), (256, 400, 32),  # OUT no multiple of a 128- or 256-column tile
])
def test_int4_kernel_matches_plain(cuda, dtype, rows, n_in, n_out, group):
    g = torch.Generator(device=cuda).manual_seed(2)
    w = quant.quantize_weight_int4(
        torch.randn((n_in, n_out), generator=g, device=cuda) * n_in ** -0.5, group)
    x = torch.randn((rows, n_in), generator=g, device=cuda).to(dtype)
    before = dict(LAUNCHES)
    out = int4mm.int4_matmul(x, w["q4"], w["s4"])
    ref = int4mm.int4_matmul_plain(x, w["q4"], w["s4"])
    torch.cuda.synchronize()
    assert out.shape == (rows, n_out) and out.dtype == dtype
    rel = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    assert rel <= (1e-5 if dtype == torch.float32 else 1e-2), rel
    # One call is one launch, whatever the split: the cluster adds the splits.
    assert LAUNCHES == dict(before, int4_matmul=before["int4_matmul"] + 1)


def bf16_ulps(out, ref):
    """Largest |out - ref| in units of ref's bf16 ulp, the ulp floored at
    2**-8 of the largest |ref|'s."""
    r = ref.float()
    top = r.abs().max().clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
    floor = torch.exp2(torch.floor(torch.log2(top)) - 15)
    return ((out.float() - r).abs() / torch.maximum(ulp, floor)).max().item()


# Each bf16 route's first and last row count: decode 1..8, then the wgmma
# kernel's tiles N of 16, 32, 64, 80, 128 and 256 rows (above 256, tiles of
# 256); between them, the counts the paths give it.
INT8_ROWS = [1, 3, 8, 9, 16, 17, 32, 33, 64, 65, 72, 80, 81, 128, 129, 131, 256, 257, 1024]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", INT8_ROWS)
@pytest.mark.parametrize("layout,n_in,n_out", [
    ("io", 4096, 4096), ("io", 4096, 11008), ("io", 11008, 4096),   # 7B
    ("io", 4096, 3 * 4096), ("io", 3072, 2 * 1024),                 # fused wqkv, wkv
    ("io", 3072, 1024),                                             # 3B wk/wv
    ("io", 256, 400),                              # OUT no multiple of a column tile
    ("vd", 4096, 32000), ("vd", 256, 400),         # the unembed's [V, D] table
])
def test_int8_kernel_matches_plain(cuda, dtype, rows, layout, n_in, n_out):
    g = torch.Generator(device=cuda).manual_seed(3)
    shape = (n_in, n_out) if layout == "io" else (n_out, n_in)
    q8 = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8, device=cuda)
    s = torch.rand((n_out,), generator=g, device=cuda) * n_in ** -0.5 / 127
    x = torch.randn((rows, n_in), generator=g, device=cuda).to(dtype)
    before = dict(LAUNCHES)
    out = int8mm.int8_matmul(x, q8, s, layout)
    again = int8mm.int8_matmul(x, q8, s, layout)
    ref = int8mm.int8_matmul_plain(x, q8, s, layout)
    torch.cuda.synchronize()
    want_dtype = torch.float32 if layout == "vd" else dtype
    assert out.shape == (rows, n_out) and out.dtype == want_dtype
    assert torch.equal(out, again)
    if layout == "io" and dtype == torch.bfloat16:
        assert bf16_ulps(out, ref) <= 1.0
    else:
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        assert rel <= (1e-4 if layout == "vd" else 1e-5), rel
    assert LAUNCHES == dict(before, int8_matmul=before["int8_matmul"] + 2)


@pytest.mark.parametrize("rows", [1, 8, 72])
def test_int4_kernel_takes_stacked_weights(cuda, rows):
    """A fused tree's q4 [IN/2, C, OUT] and s4 [G, C, OUT] run as the 2-D
    weight of C * OUT columns: the same as the concatenated projections."""
    g = torch.Generator(device=cuda).manual_seed(4)
    ws = [quant.quantize_weight_int4(torch.randn((4096, 4096), generator=g, device=cuda)
                                     * 4096 ** -0.5, 128) for _ in range(3)]
    q4 = torch.stack([w["q4"] for w in ws], dim=-2)
    s4 = torch.stack([w["s4"] for w in ws], dim=-2)
    x = torch.randn((rows, 4096), generator=g, device=cuda).bfloat16()
    out = int4mm.int4_matmul(x, q4, s4)
    ref = int4mm.int4_matmul_plain(x, q4, s4)
    torch.cuda.synchronize()
    assert out.shape == (rows, 3 * 4096)
    rel = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    assert rel <= 1e-2, rel

"""The port's CUDA kernels against their plain versions, on a CUDA card:
flash GQA attention (the scalar tile kernel and the bf16 tensor-core
prefill), ragged paged attention and the fused page write, their int8-cache
twins, and the int4 matmul (decode, prefill and f32 rows kernels).

Needs a card (marker `cuda`); skips elsewhere. On the card:
`python -m pytest tests/test_torch_cuda.py -q`. Tolerances as in
chip_smoke.py: attention max abs error 1e-4 in f32, 3e-2 in bf16 (bf16
outputs are rounded to bf16 and the probabilities are rounded at a
different running max than the plain version's); the page writes are
bit-exact; the int4 matmul within 1e-5 (f32) and 1e-2 (bf16: one bf16 ulp
is up to 2**-7 of the largest output) of max |out|, since only the order of
the f32 sums differs."""

import pytest
import torch

from llm_based_apache_spark_optimization_tpu_torch.ops import quant
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import LAUNCHES
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import attention as k
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import int4mm
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import paged_attention as pa
from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import paged_write as pw

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,n,kh,h,window", [
    (1, 32, 32, 128, None), (1, 24, 8, 128, None), (1, 32, 8, 64, 40),
    (37, 32, 32, 128, None), (37, 24, 8, 128, 16), (20, 32, 8, 64, None),
])
def test_kernel_matches_plain(cuda, dtype, t, n, kh, h, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, s = 3, 136
    q = torch.randn((b, t, n, h), generator=g, device=cuda).to(dtype)
    kk = torch.randn((b, kh, s, h), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, kh, s, h), generator=g, device=cuda).to(dtype)
    pos = (torch.tensor([[0], [50], [s - t]], device=cuda)
           + torch.arange(t, device=cuda)).int()
    lens = torch.tensor([0, 50 + t, s], dtype=torch.int32, device=cuda)
    before = dict(LAUNCHES)
    out = k.flash_gqa_attention(q, kk, v, pos, window, lens)
    ref = k.flash_gqa_attention_plain(q, kk, v, pos, window, lens)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (out[0] == 0).all()
    launch = "flash_gqa_decode" if t == 1 else "flash_gqa_prefill"
    assert LAUNCHES[launch] == before[launch] + 1


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
])
def test_paged_kernel_matches_plain(cuda, dtype, t, n, kh, h, ps, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, np_tab = 3, 8
    pages = b * np_tab + 2
    kp = torch.randn((pages, kh, ps, h), generator=g, device=cuda).to(dtype)
    vp = torch.randn((pages, kh, ps, h), generator=g, device=cuda).to(dtype)
    tab = torch.randperm(pages, generator=g, device=cuda)[: b * np_tab]
    tab = tab.reshape(b, np_tab).int()
    tab[1, -2:] = pages  # unmapped tail past the live region
    s_virt = np_tab * ps
    q = torch.randn((b, t, n, h), generator=g, device=cuda).to(dtype)
    starts = torch.tensor([[0], [s_virt // 3], [s_virt - t]], device=cuda)
    pos = (starts + torch.arange(t, device=cuda)).int()
    kvl = torch.tensor([0, s_virt // 3 + t, s_virt], dtype=torch.int32, device=cuda)
    qln = torch.tensor([t, max(1, t // 2), t], dtype=torch.int32, device=cuda)
    before = dict(LAUNCHES)
    out = pa.ragged_paged_attention(q, kp, vp, tab, pos, window, kvl, qln)
    ref = pa.ragged_paged_attention_plain(q, kp, vp, tab, pos, window, kvl, qln)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (out[0] == 0).all() and (out[1, int(qln[1]):] == 0).all()
    assert LAUNCHES["ragged_paged_attention"] == before["ragged_paged_attention"] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 4])
def test_page_write_kernel_is_bit_exact(cuda, dtype, t):
    g = torch.Generator(device=cuda).manual_seed(1)
    n_layers, pages, kh, ps, h, b, np_tab = 3, 20, 8, 16, 128, 4, 4
    kp = torch.randn((n_layers, pages, kh, ps, h), generator=g, device=cuda).to(dtype)
    vp = torch.randn_like(kp)
    k_new = torch.randn((b, t, kh, h), generator=g, device=cuda).to(dtype)
    v_new = torch.randn_like(k_new)
    tab = torch.randperm(pages, generator=g, device=cuda)[: b * np_tab]
    tab = tab.reshape(b, np_tab).int()
    tab[3] = pages  # a parked row
    pos = (torch.tensor([[0], [ps - 1], [np_tab * ps - 2], [5]], device=cuda)
           + torch.arange(t, device=cuda)).int()  # row 2 runs past the row
    qln = torch.tensor([t, max(1, t - 2), t, t], dtype=torch.int32, device=cuda)
    kk, vk, kr, vr = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    before = dict(LAUNCHES)
    pw.fused_page_write(kk, vk, k_new, v_new, pos, tab, 1, qln)
    pw.fused_page_write_plain(kr, vr, k_new, v_new, pos, tab, 1, qln)
    torch.cuda.synchronize()
    assert torch.equal(kk, kr) and torch.equal(vk, vr) and not torch.equal(kk, kp)
    assert LAUNCHES["fused_page_write"] == before["fused_page_write"] + 1


def q8(x):
    q = quant.quantize_kv(x)
    return q["q8"], q["s"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,kh,h,window", [
    (32, 32, 128, None), (24, 8, 128, None), (32, 8, 64, 40),
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
    assert (out[0] == 0).all() and (out[1, int(qln[1]):] == 0).all()
    assert (LAUNCHES["ragged_paged_attention_quantized"]
            == before["ragged_paged_attention_quantized"] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,h", [(1, 128), (4, 128), (1, 64)])
def test_quantized_page_write_kernel_is_bit_exact(cuda, dtype, t, h):
    g = torch.Generator(device=cuda).manual_seed(1)
    n_layers, pages, kh, ps, b, np_tab = 3, 20, 8, 16, 4, 4
    kp, kps = q8(torch.randn((n_layers, pages, kh, ps, h), generator=g, device=cuda))
    vp, vps = q8(torch.randn((n_layers, pages, kh, ps, h), generator=g, device=cuda))
    k_new = torch.randn((b, t, kh, h), generator=g, device=cuda).to(dtype)
    v_new = torch.randn((b, t, kh, h), generator=g, device=cuda).to(dtype)
    k_new[0, 0, 1] = 0.0  # an all-zero row takes scale 1
    tab = torch.randperm(pages, generator=g, device=cuda)[: b * np_tab]
    tab = tab.reshape(b, np_tab).int()
    tab[3] = pages  # a parked row
    pos = (torch.tensor([[0], [ps - 1], [np_tab * ps - 2], [5]], device=cuda)
           + torch.arange(t, device=cuda)).int()  # row 2 runs past the row
    qln = torch.tensor([t, max(1, t - 2), t, t], dtype=torch.int32, device=cuda)
    got = [x.clone() for x in (kp, kps, vp, vps)]
    want = [x.clone() for x in (kp, kps, vp, vps)]
    before = dict(LAUNCHES)
    pw.fused_page_write_quantized(*got, k_new, v_new, pos, tab, 1, qln)
    pw.fused_page_write_quantized_plain(*want, k_new, v_new, pos, tab, 1, qln)
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert not torch.equal(got[0], kp)
    assert (LAUNCHES["fused_page_write_quantized"]
            == before["fused_page_write_quantized"] + 1)


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

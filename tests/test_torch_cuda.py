"""The flash GQA attention kernel against its plain version, on a CUDA card.

Needs a card (marker `cuda`); skips elsewhere. On the card:
`python -m pytest tests/test_torch_cuda.py -q`. Tolerances as in
chip_smoke.py: max abs error 1e-4 in f32, 3e-2 in bf16 (bf16 outputs are
rounded to bf16 and the probabilities are rounded at a different running
max than the plain version's)."""

import pytest
import torch

from llm_based_apache_spark_optimization_tpu_torch.ops.kernels import attention as k

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
    before = dict(k.LAUNCHES)
    out = k.flash_gqa_attention(q, kk, v, pos, window, lens)
    ref = k.flash_gqa_attention_plain(q, kk, v, pos, window, lens)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (out[0] == 0).all()
    launch = "flash_gqa_decode" if t == 1 else "flash_gqa_prefill"
    assert k.LAUNCHES[launch] == before[launch] + 1


def test_kernel_raises_on_unsupported_head_dim(cuda):
    q = torch.zeros((1, 1, 4, 32), device=cuda)
    kv = torch.zeros((1, 2, 8, 32), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        k.flash_gqa_attention(q, kv, kv, torch.zeros((1, 1), dtype=torch.int32,
                                                     device=cuda))

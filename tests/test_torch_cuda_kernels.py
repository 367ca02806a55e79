"""The CUDA attention kernels against their plain versions on the card.

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one: `python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q`.
"""

import pytest
import torch

from gluefactory_tpu_torch.ops import cuda_attention

pytestmark = pytest.mark.cuda

# f32: the same f32 products summed in another order. bf16: outputs round to
# bf16 and the kernel rounds probabilities to bf16 before PV.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _masks(gen, B, M, N, dev):
    part0 = torch.rand(B, M, generator=gen, device=dev) > 0.3
    part1 = torch.rand(B, N, generator=gen, device=dev) > 0.3
    return [
        (None, None),
        (part0, part1),
        (torch.zeros_like(part0), part1),
        (part0, torch.zeros_like(part1)),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("M,N", [(128, 128), (100, 77), (64, 200)])
def test_fused_attention_matches_plain(dev, dtype, D, M, N):
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H = 2, 3
    q = torch.randn(B, H, M, D, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, H, N, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    for mq, mk in _masks(gen, B, M, N, dev):
        got = cuda_attention.fused_attention(q, k, v, mk, mq)
        want = cuda_attention.attention_plain(q, k, v, mk, mq)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (B, H, M, D)
        assert (got.float() - want.float()).abs().max() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N", [(128, 128), (100, 77)])
def test_fused_bidirectional_matches_plain(dev, dtype, M, N):
    gen = torch.Generator(device=dev).manual_seed(1)
    B, H, D = 2, 4, 64
    qk0, v0 = (torch.randn(B, H, M, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    qk1, v1 = (torch.randn(B, H, N, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    for m0, m1 in _masks(gen, B, M, N, dev):
        got = cuda_attention.fused_bidirectional_attention(qk0, qk1, v0, v1, m0, m1)
        want = cuda_attention.bidirectional_plain(qk0, qk1, v0, v1, m0, m1)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g.float() - w.float()).abs().max() <= TOL[dtype]


def test_strided_and_misaligned_inputs(dev):
    """Head-split views (token stride H*D) and views whose rows are not
    16-byte aligned give the plain version's result."""
    gen = torch.Generator(device=dev).manual_seed(2)
    B, N, H, D = 2, 96, 4, 64
    x = torch.randn(B, N, 3 * H * D + 1, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (x[..., 1 + i * H * D: 1 + (i + 1) * H * D].reshape(B, N, H, D).transpose(1, 2)
               for i in range(3))
    got = cuda_attention.fused_attention(q, k, v)
    want = cuda_attention.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= TOL[torch.bfloat16]


def test_launches_are_counted(dev):
    cuda_attention.reset_launches()
    q = torch.randn(1, 1, 64, 64, device=dev)
    cuda_attention.fused_attention(q, q, q)
    cuda_attention.fused_bidirectional_attention(q, q, q, q)
    cuda_attention.attention_plain(q, q, q)
    assert cuda_attention.launches == {"fused_attention": 1, "fused_bidirectional_attention": 1}

"""The attention wrappers' host-side logic on the CPU: when an input is read
in place by the kernels' TMA tensor maps and when it is copied, the strides
handed to the kernels, and the masks' byte layout. Also the plain versions
against the JAX reference at the shapes that exercise the kernels' tiling
(query and key counts off the 128-row tiles, one valid key tile,
LightGlue's (B, N, H, D)-ordered views)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.ops import attention as jax_attention
from gluefactory_tpu_torch.ops import cuda_attention
from gluefactory_tpu_torch.ops.cuda_attention import _bhn, _mask_arg, _tma_ready

B, H, N, D = 2, 4, 24, 64


def _lightglue_view(dtype):
    """(B, H, N, D) view of (B, N, H, D) memory: token stride H*D."""
    return torch.randn(B, N, H, D).to(dtype).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,in_place", [
    ("contiguous", True),
    ("lightglue", True),
    ("misaligned_base", False),
    ("head_broadcast", False),
    ("odd_token_stride", False),
    ("single_head_odd_stride", True),
])
def test_tma_ready_copies_only_when_needed(dtype, layout, in_place):
    if layout == "contiguous":
        t = torch.randn(B, H, N, D).to(dtype)
    elif layout == "lightglue":
        t = _lightglue_view(dtype)
    elif layout == "misaligned_base":  # one element into a buffer: base off 16 bytes
        t = torch.randn(B * H * N * D + 1).to(dtype)[1:].view(B, H, N, D)
    elif layout == "head_broadcast":  # stride 0 over 4 heads: TMA takes none
        t = torch.randn(B, 1, N, D).to(dtype).expand(B, H, N, D)
    elif layout == "odd_token_stride":  # rows of D + 1 elements
        t = torch.randn(B, H, N, D + 1).to(dtype)[..., :D]
    else:  # a dimension of one element: its stride is never used
        t = torch.randn(B, 1, N, D).to(dtype).as_strided((B, 1, N, D), (N * D, 3, D, 1))
    out = _tma_ready(t)
    assert torch.equal(out, t)
    assert (out is t) == in_place
    if not in_place:
        assert out.is_contiguous() and out.data_ptr() % 16 == 0
    # the strides the kernel's tensor maps get: positive multiples of 16
    # bytes, the tensor's own wherever a dimension has more than one element
    for n, s, own in zip(out.shape[:3], _bhn(out), out.stride()[:3]):
        assert s > 0 and s * out.element_size() % 16 == 0
        assert n == 1 or s == own


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bhn_keeps_used_strides_and_fills_unit_dims(dtype):
    t = _lightglue_view(dtype)
    assert _bhn(t) == [N * H * D, D, H * D]
    one = torch.randn(1, 1, N, D).to(dtype).as_strided((1, 1, N, D), (7, 3, D, 1))
    unit = 16 // one.element_size()
    assert _bhn(one) == [unit, unit, D]
    single_token = torch.randn(B, H, 1, D).to(dtype)
    assert _bhn(single_token) == [H * D, D, unit]


@pytest.mark.parametrize("case", ["bool", "bool_sliced", "int", "float"])
def test_mask_arg_bytes(case):
    rng = np.random.default_rng(0)
    valid = torch.from_numpy(rng.uniform(size=(B, N + 5)) > 0.4)
    if case == "bool":
        mask = valid[:, :N].contiguous()
    elif case == "bool_sliced":
        mask = valid[:, :N]
    elif case == "int":
        mask = valid[:, :N].int() * 7
    else:
        mask = valid[:, :N].float()
    m, sb = _mask_arg(mask)
    assert m.dtype == torch.uint8 and m.is_contiguous() and sb == N
    assert torch.equal(m != 0, valid[:, :N])
    if case == "bool":
        assert m.data_ptr() == mask.data_ptr()  # read in place
    assert _mask_arg(None) == (None, 0)


def _jax(x):
    return jnp.asarray(x.float().numpy())


def _masks(rng, case, M, Nk):
    if case == "partial":
        return rng.uniform(size=(B, M)) > 0.3, rng.uniform(size=(B, Nk)) > 0.3
    m0 = np.ones((B, M), bool)
    m1 = np.zeros((B, Nk), bool)  # one 128-key tile in the middle, partly valid
    m1[:, 128:256] = rng.uniform(size=(B, 128)) > 0.5
    m1[:, 128] = True
    return m0, m1


@pytest.mark.parametrize("layout", ["contiguous", "lightglue"])
@pytest.mark.parametrize("case", ["partial", "one_valid_tile"])
@pytest.mark.parametrize("M,Nk", [(1, 300), (130, 385)])
def test_plain_versions_match_jax_off_tile(layout, case, M, Nk):
    """f32, head dim 32: the plain versions the kernels are held to on the
    card agree with the JAX package's reference (both directions of the
    cross-attention, M != N)."""
    rng = np.random.default_rng(3)
    Dh = 32

    def heads(n):
        x = torch.from_numpy(rng.normal(size=(B, n, H, Dh)).astype(np.float32))
        return x.transpose(1, 2) if layout == "lightglue" else x.transpose(1, 2).contiguous()

    q, k, v = heads(M), heads(Nk), heads(Nk)
    m0, m1 = _masks(rng, case, M, Nk)
    mq, mk = torch.from_numpy(m0), torch.from_numpy(m1)
    out = cuda_attention.fused_attention(q, k, v, mk, mq)
    ref = jax_attention.mha(_jax(q), _jax(k), _jax(v), mask_q=jnp.asarray(m0),
                            mask_k=jnp.asarray(m1), flash=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)

    v0 = heads(M)
    o0, o1 = cuda_attention.fused_bidirectional_attention(q, k, v0, v, mq, mk)
    r0, r1 = jax_attention.bidirectional_attention(_jax(q), _jax(k), _jax(v0), _jax(v),
                                                   jnp.asarray(m0), jnp.asarray(m1), flash=False)
    np.testing.assert_allclose(o0.numpy(), np.asarray(r0), atol=2e-5)
    np.testing.assert_allclose(o1.numpy(), np.asarray(r1), atol=2e-5)

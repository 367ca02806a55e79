"""The CUDA kernels against their plain versions on the card: attention
(both kernels), Sinkhorn, the fused decode, the fused VGG block and the two
conv-study kernels; and the RANSACs and the pose-depth ground truth on the
card against the CPU.

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one: `python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q`.
"""

import math

import pytest
import torch

from gluefactory_tpu_torch.ops import cuda_attention, cuda_conv, cuda_conv3x3, cuda_detect, cuda_sinkhorn
from gluefactory_tpu_torch.ops.assignment import log_optimal_transport

pytestmark = pytest.mark.cuda

# f32: the same f32 products summed in another order. bf16: outputs round to
# bf16 and the kernel rounds probabilities to bf16 before PV.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions in full f32: cuDNN convs default to TF32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
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


def _attention_inputs(gen, dev, dtype, B, H, M, N, D, lightglue_layout=False):
    """q (B,H,M,D), k/v (B,H,N,D); with `lightglue_layout` q and k are the
    (B, N, H, D)-ordered views that LightGlue's rotary and head split give."""
    if lightglue_layout:
        q = torch.randn(B, M, H, D, generator=gen, device=dev).to(dtype).transpose(1, 2)
        k = torch.randn(B, N, H, D, generator=gen, device=dev).to(dtype).transpose(1, 2)
    else:
        q = torch.randn(B, H, M, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, H, N, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, H, N, D, generator=gen, device=dev).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("M,N", [(1, 129), (127, 2047), (777, 1029)])
def test_fused_attention_tail_tiles(dev, dtype, D, M, N):
    """Query and key counts that are not multiples of the 128-row and
    128-key tiles, with the four mask cases."""
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = _attention_inputs(gen, dev, dtype, 2, 2, M, N, D)
    for mq, mk in _masks(gen, 2, M, N, dev):
        got = cuda_attention.fused_attention(q, k, v, mk, mq)
        want = cuda_attention.attention_plain(q, k, v, mk, mq)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max() <= TOL[dtype]


@pytest.mark.parametrize("D", [32, 64])
def test_fused_attention_one_valid_tile(dev, D):
    """Only keys inside one 128-key tile in the middle are valid (and not
    all of them): every other tile is skipped whole."""
    gen = torch.Generator(device=dev).manual_seed(8)
    B, H, M, N = 2, 2, 200, 1029
    q, k, v = _attention_inputs(gen, dev, torch.bfloat16, B, H, M, N, D)
    mk = torch.zeros(B, N, dtype=torch.bool, device=dev)
    mk[:, 512:640] = torch.rand(B, 128, generator=gen, device=dev) > 0.5
    mk[:, 512] = True
    got = cuda_attention.fused_attention(q, k, v, mk)
    want = cuda_attention.attention_plain(q, k, v, mk)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= TOL[torch.bfloat16]


@pytest.mark.parametrize("D", [32, 64])
def test_lightglue_layout_is_read_in_place(dev, D):
    """q/k as (B, N, H, D)-ordered views (token stride H*D): no copy is made,
    and the result is the plain version's, in both kernels."""
    gen = torch.Generator(device=dev).manual_seed(9)
    B, H, M, N = 2, 4, 300, 257
    q, k, v = _attention_inputs(gen, dev, torch.bfloat16, B, H, M, N, D, lightglue_layout=True)
    assert cuda_attention._tma_ready(q) is q and cuda_attention._tma_ready(k) is k
    m0 = torch.rand(B, M, generator=gen, device=dev) > 0.3
    m1 = torch.rand(B, N, generator=gen, device=dev) > 0.3
    got = cuda_attention.fused_attention(q, k, v, m1, m0)
    want = cuda_attention.attention_plain(q, k, v, m1, m0)
    v0 = torch.randn(B, H, M, D, generator=gen, device=dev).to(torch.bfloat16)
    got2 = cuda_attention.fused_bidirectional_attention(q, k, v0, v, m0, m1)
    want2 = cuda_attention.bidirectional_plain(q, k, v0, v, m0, m1)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= TOL[torch.bfloat16]
    for g, w in zip(got2, want2):
        assert (g.float() - w.float()).abs().max() <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("M,N", [(100, 300), (300, 100)])
def test_fused_bidirectional_unequal_sides(dev, dtype, D, M, N):
    """M != N in both orders: the grid spans the longer side and the
    shorter direction's surplus blocks exit; the four mask cases."""
    gen = torch.Generator(device=dev).manual_seed(10)
    B, H = 2, 2
    qk0, v0 = (torch.randn(B, H, M, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    qk1, v1 = (torch.randn(B, H, N, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    for m0, m1 in _masks(gen, B, M, N, dev):
        got = cuda_attention.fused_bidirectional_attention(qk0, qk1, v0, v1, m0, m1)
        want = cuda_attention.bidirectional_plain(qk0, qk1, v0, v1, m0, m1)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g.float() - w.float()).abs().max() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bidirectional_is_one_launch(dev, dtype):
    """Both directions run in one kernel launch (counted by the profiler on
    the device, not by the wrapper)."""
    from torch.profiler import ProfilerActivity, profile

    qk0, v0 = (torch.randn(2, 2, 100, 64, device=dev).to(dtype) for _ in range(2))
    qk1, v1 = (torch.randn(2, 2, 300, 64, device=dev).to(dtype) for _ in range(2))
    cuda_attention.fused_bidirectional_attention(qk0, qk1, v0, v1)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cuda_attention.fused_bidirectional_attention(qk0, qk1, v0, v1)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
               and "attention" in ev.name]
    assert len(kernels) == 1, [ev.name for ev in kernels]


def test_launches_are_counted(dev):
    cuda_attention.reset_launches()
    q = torch.randn(1, 1, 64, 64, device=dev)
    cuda_attention.fused_attention(q, q, q)
    cuda_attention.fused_bidirectional_attention(q, q, q, q)
    cuda_attention.attention_plain(q, q, q)
    assert cuda_attention.launches == {"fused_attention": 1, "fused_bidirectional_attention": 1}


@pytest.mark.parametrize("case", ["all_valid", "partial", "side0_masked"])
@pytest.mark.parametrize("M,N", [(64, 64), (100, 77)])
def test_log_sinkhorn_matches_plain(dev, case, M, N):
    """Through `log_optimal_transport` (couplings with bins and -1e9 masked
    entries): f32 log-sum-exps in another order over 50 iterations, finite
    log-probabilities within 1e-4; masked entries (near -1e9, f32 step 64)
    relatively."""
    gen = torch.Generator(device=dev).manual_seed(3)
    B = 2
    scores = torch.randn(B, M, N, generator=gen, device=dev)
    m0 = torch.rand(B, M, generator=gen, device=dev) > 0.3
    m1 = torch.rand(B, N, generator=gen, device=dev) > 0.3
    if case == "all_valid":
        m0, m1 = None, None
    elif case == "side0_masked":
        m0[0] = False
    bin_score = torch.tensor(1.3, device=dev)
    cuda_sinkhorn.reset_launches()
    got = log_optimal_transport(scores, bin_score, 50, m0, m1)
    want = log_optimal_transport(scores, bin_score, 50, m0, m1, flash=False)
    torch.cuda.synchronize()
    assert cuda_sinkhorn.launches["log_sinkhorn"] == 1
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    small = torch.isfinite(want) & (want.abs() < 1e6)
    assert (got - want)[small].abs().max() <= 1e-4
    big = torch.isfinite(want) & ~small
    assert ((got - want)[big].abs() <= 1e-6 * want[big].abs()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", range(3, cuda_detect._MAX_RADIUS + 1))
def test_fused_nms_tile_reduce_matches_plain(dev, dtype, radius):
    """Comparisons and selections only: equal bit for bit, with a true size
    smaller than the buffer and a planted tie."""
    gen = torch.Generator(device=dev).manual_seed(4)
    s = (torch.rand(2, 136, 200, generator=gen, device=dev) * 0.99 + 0.01).to(dtype)
    s[0, 20, 42] = s[0, 23, 41] = 2.0
    ts = torch.tensor([[180.0, 100.0], [200.0, 136.0]], device=dev)
    for true_size in (None, ts):
        got = cuda_detect.fused_nms_tile_reduce(s, true_size, radius=radius)
        want = cuda_detect.nms_tile_reduce_plain(s, true_size, radius=radius)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1][0, 5, 10] == 13


def _detect_map(case, gen, dev):
    if case == "1000x1004":  # H and W not multiples of a block's 64 x 64 outputs
        return torch.rand(2, 1000, 1004, generator=gen, device=dev)
    if case == "b1":
        return torch.rand(1, 256, 192, generator=gen, device=dev)
    if case == "plateaus":  # 8 x 8 blocks of 16 levels, exact in bf16
        levels = torch.randint(1, 17, (2, 32, 24), generator=gen, device=dev).float() / 32
        return levels.repeat_interleave(8, 1).repeat_interleave(8, 2)
    if case == "misaligned":  # rows not 16-byte aligned: the scalar load
        return torch.rand(2 * 100 * 124 + 1, generator=gen, device=dev)[1:].view(2, 100, 124)
    return torch.full((2, 128, 128), 0.25, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["1000x1004", "b1", "plateaus", "constant", "misaligned"])
def test_fused_nms_tile_reduce_maps(dev, dtype, case):
    """Bit for bit beyond uniform noise: ragged blocks, one image, plateaus
    of equal values, a constant map, the scalar load; radii 0, 3, 4 and 8."""
    gen = torch.Generator(device=dev).manual_seed(6)
    s = _detect_map(case, gen, dev).to(dtype)
    for radius in (0, 3, 4, cuda_detect._MAX_RADIUS):
        got = cuda_detect.fused_nms_tile_reduce(s, radius=radius)
        want = cuda_detect.nms_tile_reduce_plain(s, radius=radius)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), radius


def test_fused_nms_tile_reduce_radius_above_the_kernels_raises(dev):
    with pytest.raises(ValueError, match="radii 0 to"):
        cuda_detect.fused_nms_tile_reduce(torch.rand(1, 64, 64, device=dev),
                                          radius=cuda_detect._MAX_RADIUS + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["one_conv_pool", "two_convs_pool", "two_convs_no_pool"])
def test_fused_vgg_block_matches_plain(dev, dtype, variant):
    """f32: the same products summed in another order. bf16: twice the gap
    that bf16 rounding alone opens (plain bf16 against plain f32), plus one
    bf16 step at the largest output for a sum that flips a rounding."""
    gen = torch.Generator(device=dev).manual_seed(5)
    two, pool = variant != "one_conv_pool", variant != "two_convs_no_pool"
    x = torch.randn(2, 37, 50, 64, generator=gen, device=dev)
    w = [torch.randn(3, 3, 64, 128, generator=gen, device=dev) * 0.05,
         torch.randn(128, generator=gen, device=dev) * 0.1]
    if two:
        w += [torch.randn(3, 3, 128, 80, generator=gen, device=dev) * 0.05,
              torch.randn(80, generator=gen, device=dev) * 0.1]
    xd, wd = x.to(dtype), [a.to(dtype) for a in w]
    got = cuda_conv.fused_vgg_block(xd, *wd, pool=pool)
    want = cuda_conv.vgg_block_plain(xd, *wd, pool=pool)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max()
    if dtype == torch.float32:
        assert err <= 1e-4 * max(1.0, float(want.abs().max()))
    else:
        ref = cuda_conv.vgg_block_plain(xd.float(), *(a.float() for a in wd), pool=pool)
        step = 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - 7)
        assert err <= 2 * (want.float() - ref).abs().max() + step


def test_new_launches_are_counted(dev):
    for mod in (cuda_sinkhorn, cuda_detect, cuda_conv):
        mod.reset_launches()
    z = torch.randn(1, 8, 8, device=dev)
    cuda_sinkhorn.log_sinkhorn(z, z[:, :, 0], z[:, 0], 3)
    cuda_detect.fused_nms_tile_reduce(torch.rand(1, 32, 32, device=dev))
    cuda_conv.fused_vgg_block(torch.randn(1, 8, 8, 16, device=dev),
                              torch.randn(3, 3, 16, 16, device=dev), torch.randn(16, device=dev))
    assert cuda_sinkhorn.launches == {"log_sinkhorn": 1}
    assert cuda_detect.launches == {"fused_nms_tile_reduce": 1}
    assert cuda_conv.launches == {"fused_vgg_block": 1}


CONV_CASES = [
    ((2, 128, 96, 64), 64),
    ((1, 37, 53, 64), 128),   # W < 64, not a multiple of 64; two output-channel groups
    ((1, 37, 53, 64), 64),
    ((1, 65, 130, 64), 64),   # H one row past a 64-row strip, W past two 64-pixel columns
    ((1, 130, 200, 64), 64),  # strip boundaries inside the image
    ((1, 1, 1, 64), 64),      # one pixel
    ((2, 40, 70, 128), 64),   # C_in 128: two K atoms, weights resident
    ((1, 20, 70, 192), 64),   # C_in 192: each stage carries its atom's weights
    ((1, 20, 33, 64), 192),   # three output-channel groups
]


def _conv_parity(kernel, plain, x, w):
    got = kernel(x, w)
    torch.cuda.synchronize()
    want = plain(x, w)
    ref = plain(x.float(), w.float())
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    step = 2.0 ** (math.floor(math.log2(max(float(ref.abs().max()), 2.0**-126))) - 7)
    assert (got.float() - want.float()).abs().max() <= 2 * (want.float() - ref).abs().max() + step


@pytest.mark.parametrize("name", ["stream_conv3x3", "npack_conv3x3"])
@pytest.mark.parametrize("shape,co", CONV_CASES)
def test_conv3x3_matches_plain(dev, name, shape, co):
    """The conv-study kernels at the strip and column edges, one pixel, two
    and three K atoms and several output-channel groups: within twice the
    gap bf16 rounding alone opens (plain bf16 against plain f32), plus one
    bf16 step at the largest output for a sum in another order that flips a
    rounding. One wrapper call is one launch."""
    gen = torch.Generator(device=dev).manual_seed(6)
    x = (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    w = (torch.randn(3, 3, shape[-1], co, generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    kernel, plain = getattr(cuda_conv3x3, name), getattr(cuda_conv3x3, name + "_plain")
    cuda_conv3x3.reset_launches()
    _conv_parity(kernel, plain, x, w)
    assert cuda_conv3x3.launches[name] == 1


@pytest.mark.parametrize("name", ["stream_conv3x3", "npack_conv3x3"])
def test_conv3x3_unaligned_and_strided_inputs(dev, name):
    """x starting 2 bytes past a 16-byte boundary, and x and w as
    non-contiguous views: the wrapper copies them for the TMA maps."""
    gen = torch.Generator(device=dev).manual_seed(7)
    flat = (torch.randn(1 + 2 * 21 * 67 * 64, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    x = flat[1:].view(2, 21, 67, 64)
    assert x.data_ptr() % 16 != 0
    w = (torch.randn(3, 3, 64, 64, generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    kernel, plain = getattr(cuda_conv3x3, name), getattr(cuda_conv3x3, name + "_plain")
    _conv_parity(kernel, plain, x, w)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)  # NHWC shape, W-major memory
    _conv_parity(kernel, plain, xt, w.transpose(2, 3).contiguous().transpose(2, 3))


# ---------------------------------------------------------------------------
# gradients: the kernel path carries the plain version's gradient
# ---------------------------------------------------------------------------


def _grads(fn, inputs, cot):
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.grad_fn is not None for o in outs)
    leaves = [t for t in inputs if torch.is_tensor(t) and t.requires_grad]
    return torch.autograd.grad(outs, leaves, cot[:len(outs)])


def _leaf(gen, dev, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device=dev) * scale).requires_grad_(True)


@pytest.mark.parametrize("name", ["fused_attention", "fused_bidirectional_attention",
                                  "fused_vgg_block", "log_sinkhorn"])
def test_kernel_gradients_equal_plain(dev, monkeypatch, name):
    """With grad enabled the wrappers' outputs carry a grad_fn, and their
    gradients equal the plain versions' (f32: the backward is the plain
    version's own; only the forward's rounding differs, and it does not
    enter the gradient). cuDNN's conv backward sums in a varying order
    unless it is asked to be deterministic."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    gen = torch.Generator(device=dev).manual_seed(11)
    if name == "fused_attention":
        q, k, v = (_leaf(gen, dev, 2, 2, 100, 64) for _ in range(3))
        mk = torch.rand(2, 100, generator=gen, device=dev) > 0.3
        inputs, kernel, plain = [q, k, v, mk, None], cuda_attention.fused_attention, cuda_attention.attention_plain
    elif name == "fused_bidirectional_attention":
        qk0, v0 = (_leaf(gen, dev, 2, 2, 100, 64) for _ in range(2))
        qk1, v1 = (_leaf(gen, dev, 2, 2, 77, 64) for _ in range(2))
        m0 = torch.rand(2, 100, generator=gen, device=dev) > 0.3
        inputs = [qk0, qk1, v0, v1, m0, None]
        kernel, plain = cuda_attention.fused_bidirectional_attention, cuda_attention.bidirectional_plain
    elif name == "fused_vgg_block":
        inputs = [_leaf(gen, dev, 2, 20, 34, 64), _leaf(gen, dev, 3, 3, 64, 64, scale=0.05),
                  _leaf(gen, dev, 64, scale=0.1), _leaf(gen, dev, 3, 3, 64, 64, scale=0.05),
                  _leaf(gen, dev, 64, scale=0.1), True]
        kernel, plain = cuda_conv.fused_vgg_block, cuda_conv.vgg_block_plain
    else:
        inputs = [_leaf(gen, dev, 2, 65, 70), torch.full((2, 65), -5.0, device=dev).requires_grad_(True),
                  torch.full((2, 70), -5.0, device=dev), 10]
        kernel, plain = cuda_sinkhorn.log_sinkhorn, cuda_sinkhorn.plain_log_sinkhorn
    outs = plain(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cot = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
    got = _grads(kernel, inputs, cot)
    want = _grads(plain, inputs, cot)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["fused_attention", "fused_bidirectional_attention"])
def test_attention_at_stage2_training_shape(dev, name):
    """Both attention kernels at stage 2's N = 2048 keypoints in f32 (two
    pairs, 4 heads, d = 64, a tail of masked keys): the forward within
    TOL of the plain version, and the gradients the plain version's."""
    gen = torch.Generator(device=dev).manual_seed(12)
    n, heads = 2048, 4
    masks = torch.rand(2, n, generator=gen, device=dev) > 0.2
    masks[:, -100:] = False
    if name == "fused_attention":
        xs = [_leaf(gen, dev, 4, heads, n, 64) for _ in range(3)]
        inputs = [*xs, torch.cat([masks, masks]), None]
        kernel, plain = cuda_attention.fused_attention, cuda_attention.attention_plain
    else:
        xs = [_leaf(gen, dev, 2, heads, n, 64) for _ in range(4)]
        inputs = [*xs, masks, masks.flip(0)]
        kernel, plain = cuda_attention.fused_bidirectional_attention, cuda_attention.bidirectional_plain
    with torch.no_grad():
        got, want = kernel(*inputs), plain(*inputs)
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert (a - b).abs().max() <= TOL[torch.float32]
    outs = plain(*inputs)
    cot = [torch.randn(o.shape, generator=gen, device=dev) for o in (outs if isinstance(outs, tuple) else (outs,))]
    for a, b in zip(_grads(kernel, inputs, cot), _grads(plain, inputs, cot)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["fused_attention", "fused_bidirectional_attention"])
def test_attention_with_cached_feature_padding(dev, name):
    """Both attention kernels under autograd as cached-feature training
    runs them: (B, 4, 2048, 64) f32 with each view's `keypoint_mask` valid
    on a prefix and padded after it (`pad_local_features`, padding_length
    2048), one view with no padding and one with most of it padded. The
    forward within 1e-3 of the plain version; every gradient entry within
    1e-3 of the plain gradient's global norm."""
    gen = torch.Generator(device=dev).manual_seed(16)
    n, heads, pairs = 2048, 4, 4
    counts = torch.tensor([2048, 1531, 977, 128], device=dev)
    masks = torch.arange(n, device=dev)[None] < counts[:, None]
    if name == "fused_attention":
        xs = [_leaf(gen, dev, 2 * pairs, heads, n, 64) for _ in range(3)]
        both = torch.cat([masks, masks.flip(0)])
        inputs = [*xs, both, both]  # as LightGlue's self attention: keys and queries masked
        kernel, plain = cuda_attention.fused_attention, cuda_attention.attention_plain
    else:
        xs = [_leaf(gen, dev, pairs, heads, n, 64) for _ in range(4)]
        inputs = [*xs, masks, masks.flip(0)]
        kernel, plain = cuda_attention.fused_bidirectional_attention, cuda_attention.bidirectional_plain
    with torch.no_grad():
        got, want = kernel(*inputs), plain(*inputs)
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert (a - b).abs().max() <= 1e-3
    outs = plain(*inputs)
    cot = [torch.randn(o.shape, generator=gen, device=dev) for o in (outs if isinstance(outs, tuple) else (outs,))]
    got, want = _grads(kernel, inputs, cot), _grads(plain, inputs, cot)
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in want]))
    assert norm > 0
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-3 * norm


def test_detect_raises_under_grad(dev):
    s = torch.rand(1, 64, 64, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        cuda_detect.fused_nms_tile_reduce(s)
    with torch.no_grad():
        got = cuda_detect.fused_nms_tile_reduce(s)
    want = cuda_detect.nms_tile_reduce_plain(s.detach())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the one-launch Sinkhorn kernel at ragged, tiny, -inf and streamed shapes
# ---------------------------------------------------------------------------


def _sinkhorn_close(got, want):
    """Infinities and NaNs where the plain version has them; finite values
    within 1e-4 (f32 log-sum-exps in another order)."""
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(want)
    if fin.any():
        assert (got - want)[fin].abs().max() <= 1e-4


@pytest.mark.parametrize("B,M,N,iters", [(3, 100, 77, 50), (2, 65, 130, 1), (2, 37, 41, 0),
                                         (1, 3, 1, 7), (2, 1, 5, 3), (4, 513, 513, 20),
                                         (1, 4097, 4097, 3), (1, 5, 20000, 3)])
def test_log_sinkhorn_shapes(dev, B, M, N, iters):
    """Ragged sizes, one row or column, 0 and 1 iterations, several items
    at once (513^2), rows streamed from device memory (4097^2) and v read
    through L2 (N = 20000): one launch each, equal to the plain loop."""
    gen = torch.Generator(device=dev).manual_seed(12)
    Z = torch.randn(B, M, N, generator=gen, device=dev) * 2
    mu = torch.full((B, M), -math.log(M + N), device=dev)
    nu = torch.full((B, N), -math.log(M + N), device=dev)
    cuda_sinkhorn.reset_launches()
    got = cuda_sinkhorn.log_sinkhorn(Z, mu, nu, iters)
    torch.cuda.synchronize()
    assert cuda_sinkhorn.launches["log_sinkhorn"] == 1
    _sinkhorn_close(got, cuda_sinkhorn.plain_log_sinkhorn(Z, mu, nu, iters))


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_log_sinkhorn_all_inf_row(dev, iters):
    """A row whose couplings are all -inf: its LSE is -inf (never NaN from
    exp(-inf - -inf)), after which the plain loop's infinities and NaNs
    follow; the other item stays finite and close."""
    gen = torch.Generator(device=dev).manual_seed(13)
    Z = torch.randn(2, 30, 41, generator=gen, device=dev)
    Z[0, 3] = -float("inf")
    mu = torch.full((2, 30), -4.0, device=dev)
    nu = torch.full((2, 41), -4.0, device=dev)
    got = cuda_sinkhorn.log_sinkhorn(Z, mu, nu, iters)
    want = cuda_sinkhorn.plain_log_sinkhorn(Z, mu, nu, iters)
    torch.cuda.synchronize()
    _sinkhorn_close(got, want)
    assert torch.isfinite(got[1]).all()


# ---------------------------------------------------------------------------
# the VGG block's two bodies at the edges of their plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,cm,co,pool,bodies", [
    ((1, 130, 200, 64), 64, 64, True, ["wgmma", "wgmma"]),       # rows across strip boundaries
    ((2, 37, 51, 64), 64, None, True, ["wgmma"]),                # odd size, pooled (floors)
    ((1, 65, 67, 64), 128, 64, False, ["wgmma", "wgmma"]),       # odd, not pooled, two groups
    ((2, 37, 50, 64), 128, 80, True, ["wgmma", "cuda_cores"]),   # C_out 80: CUDA-core body
    ((2, 24, 40, 48), 64, None, True, ["cuda_cores"]),           # C_in 48: CUDA-core body
])
def test_fused_vgg_block_bodies(dev, shape, cm, co, pool, bodies):
    """bf16 against the plain version within twice the gap bf16 rounding
    alone opens, plus one bf16 step at the largest output; each wrapper
    call one launch."""
    gen = torch.Generator(device=dev).manual_seed(14)
    ci = shape[-1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert [c["body"] for c in cuda_conv.conv_plan(*shape, cm, co, pool, torch.bfloat16, sms)] == bodies
    x = torch.relu(torch.randn(*shape, generator=gen, device=dev)).to(torch.bfloat16)
    w = [torch.randn(3, 3, ci, cm, generator=gen, device=dev) * 0.05, torch.randn(cm, generator=gen, device=dev) * 0.1]
    if co is not None:
        w += [torch.randn(3, 3, cm, co, generator=gen, device=dev) * 0.05,
              torch.randn(co, generator=gen, device=dev) * 0.1]
    w = [a.to(torch.bfloat16) for a in w]
    cuda_conv.reset_launches()
    got = cuda_conv.fused_vgg_block(x, *w, pool=pool)
    torch.cuda.synchronize()
    assert cuda_conv.launches["fused_vgg_block"] == 1
    want = cuda_conv.vgg_block_plain(x, *w, pool=pool)
    ref = cuda_conv.vgg_block_plain(x.float(), *(a.float() for a in w), pool=pool)
    assert got.shape == want.shape
    step = 2.0 ** (math.floor(math.log2(max(float(want.float().abs().max()), 2.0**-126))) - 7)
    assert (got.float() - want.float()).abs().max() <= 2 * (want.float() - ref).abs().max() + step


def _scattered_masks(gen, B, n, dev, pruned_side_item=0):
    """~half of the tokens active, scattered; every token of item
    `pruned_side_item` inactive (a side wholly pruned)."""
    m = torch.rand(B, n, generator=gen, device=dev) > 0.5
    m[pruned_side_item] = False
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_on_scattered_active_masks(dev, dtype):
    """Width pruning's masks: scattered active tokens in every item, and one
    item whose keys (self-attention) or one side (cross-attention) are all
    pruned, at LightGlue's layout."""
    gen = torch.Generator(device=dev).manual_seed(7)
    B, H, M, N, D = 3, 4, 300, 260, 64
    q, k, v = (_heads(gen, dev, dtype, B, H, n, D) for n in (M, N, N))
    mq = torch.rand(B, M, generator=gen, device=dev) > 0.5
    mk = _scattered_masks(gen, B, N, dev, pruned_side_item=1)
    got = cuda_attention.fused_attention(q, k, v, mk, mq)
    want = cuda_attention.attention_plain(q, k, v, mk, mq)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= TOL[dtype]
    assert got[1].abs().max() == 0  # no valid key: zeros
    qk0, v0 = (_heads(gen, dev, dtype, B, H, M, D) for _ in range(2))
    qk1, v1 = (_heads(gen, dev, dtype, B, H, N, D) for _ in range(2))
    m0 = torch.rand(B, M, generator=gen, device=dev) > 0.5
    m0[2] = False  # side 0 of item 2 wholly pruned
    m1 = _scattered_masks(gen, B, N, dev, pruned_side_item=0)
    got = cuda_attention.fused_bidirectional_attention(qk0, qk1, v0, v1, m0, m1)
    want = cuda_attention.bidirectional_plain(qk0, qk1, v0, v1, m0, m1)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g.float() - w.float()).abs().max() <= TOL[dtype]


def _heads(gen, dev, dtype, B, H, n, D):
    return torch.randn(B, n, H, D, generator=gen, device=dev).to(dtype).transpose(1, 2)


@pytest.mark.parametrize("exit_layers", [1, 3, 4])
def test_serving_launches_each_attention_kernel_once_a_layer(dev, exit_layers):
    """The early-exit serving function launches each attention kernel once
    per layer it runs, exit_layers times when every item exits after
    exit_layers layers; the masked pruned forward n_layers times; both give
    the same outputs."""
    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.models.matchers.lightglue_serving import make_serving_fn

    torch.manual_seed(0)
    n_layers, B, K = 4, 2, 200
    lg = get_model("lightglue").from_conf(
        {"n_layers": n_layers, "descriptor_dim": 128, "input_dim": 128, "num_heads": 2,
         "depth_confidence": 0.95, "width_confidence": 0.99, "pruning_min_kpts": -1},
        device=dev).eval()
    with torch.no_grad():
        for i, head in enumerate(lg.token_confidence):
            head.token[0].weight.zero_()
            head.token[0].bias.fill_(20.0 if i >= exit_layers - 1 else -20.0)
    gen = torch.Generator(device=dev).manual_seed(8)
    data = {"keypoints0": torch.rand(B, K, 2, generator=gen, device=dev) * 100,
            "keypoints1": torch.rand(B, K, 2, generator=gen, device=dev) * 100,
            "descriptors0": torch.randn(B, K, 128, generator=gen, device=dev),
            "descriptors1": torch.randn(B, K, 128, generator=gen, device=dev),
            "image_size0": torch.full((B, 2), 100.0, device=dev),
            "image_size1": torch.full((B, 2), 100.0, device=dev)}
    with torch.no_grad():
        cuda_attention.reset_launches()
        served = make_serving_fn(lg)(data)
        assert cuda_attention.launches == {"fused_attention": exit_layers,
                                           "fused_bidirectional_attention": exit_layers}
        cuda_attention.reset_launches()
        masked = lg(data)
        assert cuda_attention.launches == {"fused_attention": n_layers,
                                           "fused_bidirectional_attention": n_layers}
    assert served["exit_layer"].tolist() == [exit_layers - 1] * B
    for k in ("prune0", "prune1", "matches0", "matches1"):
        assert torch.equal(served[k], masked[k]), k
    valid = masked["log_assignment"] > -1e8
    assert (served["log_assignment"] - masked["log_assignment"])[valid].abs().max() <= 1e-5


@pytest.mark.parametrize("checkpointed", [True, False])
def test_train_step_kernels_against_plain_versions(dev, checkpointed):
    """One train step of a small SuperPoint + LightGlue pipeline (homography
    ground truth, f32): each attention kernel launches once a layer in the
    forward and once more in each checkpoint's recompute, and the loss and
    the matcher's gradient global norm equal the plain versions' (flash
    off) within 1e-4 relative. The update is applied."""
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.core.config import Config, merge
    from gluefactory_tpu_torch.data import get_dataset
    from gluefactory_tpu_torch.data.base_dataset import prepare_batch
    from gluefactory_tpu_torch.models import get_model

    n_layers = 3
    conf = {"extractor": {"name": "superpoint", "max_num_keypoints": 256, "force_num_keypoints": True,
                          "detection_threshold": 0.0, "nms_radius": 3, "trainable": False},
            "ground_truth": {"name": "homography_matcher", "th_positive": 3, "th_negative": 3},
            "matcher": {"name": "lightglue", "n_layers": n_layers, "checkpointed": checkpointed}}
    data = get_dataset("homographies")({
        "synthetic_images": 4, "train_size": 2, "val_size": 1, "batch_size": 2,
        "source_size": [320, 240], "homography": {"patch_shape": [320, 240], "difficulty": 0.7},
        "photometric": {"name": "identity"}})
    batch = prepare_batch(next(iter(data.get_data_loader("train"))), dev)
    torch.manual_seed(0)
    model = get_model("two_view_pipeline").from_conf(conf, device=dev)
    results = {}
    for flash in (True, False):
        for m in model.modules():
            if hasattr(m, "flash"):
                m.flash = flash
        model.zero_grad(set_to_none=True)
        cuda_attention.reset_launches()
        _, losses, _ = model.forward_with_loss(batch, train=True,
                                               generator=torch.Generator(device=dev).manual_seed(0))
        losses["total"].mean().backward()
        gnorm = torch.stack([p.grad.norm() for p in model.matcher.parameters() if p.grad is not None])
        results[flash] = (float(losses["total"].mean().detach()), float(gnorm.norm()),
                          dict(cuda_attention.launches))
    per_layer = 2 if checkpointed else 1
    assert results[True][2] == {"fused_attention": per_layer * n_layers,
                                "fused_bidirectional_attention": per_layer * n_layers}
    assert results[False][2] == {"fused_attention": 0, "fused_bidirectional_attention": 0}
    for got, want in zip(results[True][:2], results[False][:2]):
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    opt, schedule = train.build_optimizer(merge(Config(train.default_train_conf), {"lr": 1e-4}),
                                          model, 10)
    for m in model.modules():
        if hasattr(m, "flash"):
            m.flash = True
    losses, _, info = train.TrainStep(model, opt, schedule, max_updates=1)(batch)
    assert bool(info["ok"]) and torch.isfinite(losses["total"])


@pytest.mark.parametrize("name,accum", [("adam", 1), ("adam", 3), ("rmsprop", 1), ("sgd", 2)])
def test_train_step_update_makes_no_host_read(dev, name, accum):
    """The optimizer update, the lr lookup, the micro-batch count and the
    NaN-skip of `TrainStep` run on the device: under CUDA's sync debug mode
    set to "error", steps (one with a non-finite loss) raise nothing, and
    the count of applied updates is read only afterwards."""
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.core.config import Config, merge

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 3)

        def forward_with_loss(self, data, train=True, generator=None):
            return {}, {"total": ((self.lin(data["x"]) - data["y"]) ** 2).sum(-1)}, {}

    gen = torch.Generator(device=dev).manual_seed(0)
    model = Toy().to(dev)
    conf = merge(Config(train.default_train_conf),
                 {"optimizer": name, "grad_accumulation": accum, "clip_grad": 1.0,
                  "lr_schedule": {"type": "exp", "start": 0, "exp_div_10": 1}})
    opt, schedule = train.build_optimizer(conf, model, 4)
    step = train.TrainStep(model, opt, schedule, accum=accum, clip_grad=1.0, max_updates=6)
    batches = [{"x": torch.randn(5, 4, generator=gen, device=dev),
                "y": torch.randn(5, 3, generator=gen, device=dev)} for _ in range(6)]
    batches[2]["x"][0, 0] = float("nan")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        oks = [step(b)[2]["ok"] for b in batches]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [bool(o) for o in oks] == [i != 2 for i in range(6)]
    assert step.updates == 5 // accum


@pytest.mark.parametrize("checkpointed", [True, False])
def test_bf16_train_step_runs_the_bf16_kernels(dev, checkpointed):
    """One `mixed_precision: bf16` train step of a small SuperPoint +
    LightGlue pipeline with `lg` photometry: both attention kernels run on
    bf16 inputs under autograd, once a layer in the forward and once more in
    each checkpoint's recompute; the loss is finite, the update applied, the
    parameters and their gradients float32; the loss within 2e-2 relative of
    the same bf16 step through the plain versions."""
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.core.config import Config, merge
    from gluefactory_tpu_torch.data import get_dataset
    from gluefactory_tpu_torch.data.base_dataset import prepare_batch
    from gluefactory_tpu_torch.models import get_model

    n_layers = 3
    conf = {"extractor": {"name": "superpoint", "max_num_keypoints": 256, "force_num_keypoints": True,
                          "detection_threshold": 0.0, "nms_radius": 3, "trainable": False},
            "ground_truth": {"name": "homography_matcher", "th_positive": 3, "th_negative": 3},
            "matcher": {"name": "lightglue", "n_layers": n_layers, "checkpointed": checkpointed}}
    data = get_dataset("homographies")({
        "synthetic_images": 4, "train_size": 2, "val_size": 1, "batch_size": 2,
        "source_size": [320, 240], "homography": {"patch_shape": [320, 240], "difficulty": 0.7},
        "photometric": {"name": "lg"}})
    batch = prepare_batch(next(iter(data.get_data_loader("train"))), dev)
    losses = {}
    for flash in (True, False):
        torch.manual_seed(0)
        model = get_model("two_view_pipeline").from_conf(conf, device=dev)
        for m in model.modules():
            if hasattr(m, "flash"):
                m.flash = flash
        opt, schedule = train.build_optimizer(merge(Config(train.default_train_conf), {}), model, 1)
        step = train.TrainStep(model, opt, schedule, max_updates=1, mixed_precision="bf16")
        dtypes = []
        model.matcher.transformers[0].register_forward_pre_hook(lambda m, a: dtypes.append(a[0].dtype))
        cuda_attention.reset_launches()
        out, _, info = step(batch, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        per_layer = (2 if checkpointed else 1) * n_layers * flash
        assert cuda_attention.launches == {"fused_attention": per_layer,
                                           "fused_bidirectional_attention": per_layer}
        assert bool(info["ok"]) and torch.isfinite(out["total"])
        assert dtypes and set(dtypes) == {torch.bfloat16}
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(p.grad.dtype == torch.float32 for p in model.parameters() if p.grad is not None)
        losses[flash] = float(out["total"])
    assert abs(losses[True] - losses[False]) <= 2e-2 * abs(losses[False])


def _planted_matches(seed, n=300, inliers=180, th=3.0):
    """Matches under a known homography (inliers within 0.3 px) and
    outliers at least 2 th off, padded to a power of two."""
    import numpy as np

    from gluefactory_tpu_torch.robust_estimators.homography.xla_ransac import bucket_pad

    rng = np.random.default_rng(seed)
    H = np.array([[1.05, 0.04, 12.0], [-0.03, 0.97, -7.0], [2e-4, -1e-4, 1.0]])
    p0 = rng.uniform(0, 640, (n, 2))
    ph = np.c_[p0, np.ones(n)] @ H.T
    p1 = ph[:, :2] / ph[:, 2:]
    p1[:inliers] += rng.uniform(-0.3, 0.3, (inliers, 2))
    p1[inliers:] += rng.uniform(2 * th + 5, 80, (n - inliers, 2)) * rng.choice([-1, 1], (n - inliers, 2))
    return bucket_pad(p0.astype(np.float32), p1.astype(np.float32))


def test_threefry_on_the_card_equals_the_cpu(dev):
    from gluefactory_tpu_torch.utils import threefry

    for seed, shape in ((0, (1024, 64)), (7, (1024, 2048)), (-3, (5, 7))):
        assert torch.equal(threefry.random_bits(seed, shape, dev).cpu(), threefry.random_bits(seed, shape))
        assert torch.equal(threefry.uniform(seed, shape, dev).cpu(), threefry.uniform(seed, shape))
        got, want = threefry.gumbel(seed, shape, dev).cpu(), threefry.gumbel(seed, shape)
        # each device's float64 logs, rounded to float32: within an ulp a step
        ulp = torch.finfo(torch.float32).eps * want.abs().clamp(min=1)
        assert ((got - want).abs() <= 2 * ulp).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_on_the_card_equals_the_cpu(dev, seed):
    """The RANSAC runs on the inputs' device; on the card it finds the CPU's
    inliers and H (float32 DLTs by other solvers: within 1e-4 of H's
    largest entry)."""
    from gluefactory_tpu_torch.ops.ransac import ransac_homography

    p0, p1, valid, n = _planted_matches(seed)
    cpu = ransac_homography(*(torch.from_numpy(x) for x in (p0, p1, valid)), 3.0, seed=seed)
    card = ransac_homography(*(torch.from_numpy(x).to(dev) for x in (p0, p1, valid)), 3.0, seed=seed)
    assert all(v.device.type == "cuda" for v in card.values())
    assert torch.equal(card["inliers"].cpu(), cpu["inliers"]) and int(card["num_inliers"]) == 180
    H, Hc = card["M_0to1"].cpu(), cpu["M_0to1"]
    assert (H - Hc).abs().max() <= 1e-4 * Hc.abs().max()


def test_xla_ransac_estimator_on_the_card(dev):
    import numpy as np

    from gluefactory_tpu_torch.robust_estimators import load_estimator

    p0, p1, _, n = _planted_matches(2)
    data = {"m_kpts0": p0[:n], "m_kpts1": p1[:n]}
    card = load_estimator("homography", "xla_ransac")({"device": "cuda"})(data)
    cpu = load_estimator("homography", "xla_ransac")({"device": "cpu"})(data)
    assert card["success"] and isinstance(card["M_0to1"], np.ndarray)
    np.testing.assert_array_equal(card["inliers"], cpu["inliers"])


def _pose_scene(seed, n=1024, outliers=0.3):
    """Synthetic normalized correspondences (`scripts_dev/posed_scenes.py`)
    padded to a power of two: (p0, p1, valid, R, t)."""
    import numpy as np

    from gluefactory_tpu_torch.robust_estimators.homography.xla_ransac import bucket_pad
    from gluefactory_tpu_torch.scripts_dev.posed_scenes import synthetic_correspondences

    p0, p1, R, t, _, _ = synthetic_correspondences(np.random.default_rng(seed), n, 3e-4, outliers)
    return (*bucket_pad(p0, p1)[:3], R, t)


@pytest.mark.parametrize("solver", ["5pt", "8pt"])
def test_ransac_essential_on_the_card_equals_the_cpu(dev, solver):
    """1024 points, 30% outliers: on the card every output stays there, R
    and t come within 1 degree of the truth and 0.5 of the CPU's, and the
    inlier masks agree on 99% (5pt) or 90% (8pt: each hypothesis is the
    smallest eigenvector of a float32 8-row normal matrix, left to rounding,
    and the card's eigh rounds otherwise than LAPACK's; measured 94.8%)."""
    from gluefactory_tpu_torch.eval.utils import angle_error_mat_np, angle_error_vec_np
    from gluefactory_tpu_torch.ops.ransac import ransac_essential

    p0, p1, valid, R, t = _pose_scene(3)
    args = [torch.from_numpy(x) for x in (p0, p1, valid)]
    cpu = ransac_essential(*args, 2e-3, seed=0, n_iters=512, solver=solver)
    card = ransac_essential(*(x.to(dev) for x in args), 2e-3, seed=0, n_iters=512, solver=solver)
    assert all(v.device.type == "cuda" for v in card.values())
    assert bool(card["success"]) and bool(cpu["success"])
    Rc, tc = card["R"].cpu().double().numpy(), card["t"].cpu().double().numpy()
    assert angle_error_mat_np(Rc, R) < 1 and angle_error_vec_np(tc, t) < 1
    assert angle_error_mat_np(Rc, cpu["R"].double().numpy()) < 0.5
    assert angle_error_vec_np(tc, cpu["t"].double().numpy()) < 0.5
    assert (card["inliers"].cpu() == cpu["inliers"]).float().mean() >= (0.99 if solver == "5pt" else 0.9)


def test_relative_pose_estimator_on_the_card(dev):
    import numpy as np

    from gluefactory_tpu_torch.eval.utils import angle_error_mat_np
    from gluefactory_tpu_torch.geometry.wrappers import Camera
    from gluefactory_tpu_torch.robust_estimators import load_estimator

    p0, p1, valid, R, t = _pose_scene(4, n=300)
    cam = Camera.from_colmap({"model": "PINHOLE", "width": 640, "height": 480,
                              "params": [500.0, 500.0, 320.0, 240.0]})
    n = int(valid.sum())
    k0 = cam.denormalize(torch.from_numpy(p0[:n])[None])[0].numpy()
    k1 = cam.denormalize(torch.from_numpy(p1[:n])[None])[0].numpy()
    data = {"m_kpts0": k0, "m_kpts1": k1, "camera0": cam, "camera1": cam}
    card = load_estimator("relative_pose", "xla_ransac")({"ransac_th": 1.0})(data)
    cpu = load_estimator("relative_pose", "xla_ransac")({"ransac_th": 1.0, "device": "cpu"})(data)
    assert card["success"] and card["inliers"].shape == (n,) and isinstance(card["inliers"], np.ndarray)
    assert angle_error_mat_np(card["M_0to1"].R.double().numpy(), R) < 1
    assert angle_error_mat_np(card["M_0to1"].R.double().numpy(), cpu["M_0to1"].R.double().numpy()) < 0.5


def test_gt_matches_from_pose_depth_on_the_card_equals_the_cpu(dev):
    """The pose-depth ground truth of a tilted plane with holes (depth 0),
    with and without the epipolar rescue and masks: matches and visibility
    equal on the card and the CPU."""
    import numpy as np

    from gluefactory_tpu_torch.geometry.depth import project, sample_depth
    from gluefactory_tpu_torch.geometry.gt_generation import gt_matches_from_pose_depth
    from gluefactory_tpu_torch.geometry.utils import image_grid
    from gluefactory_tpu_torch.geometry.wrappers import Camera, Pose

    rng = np.random.default_rng(0)
    w, h, n = 320, 240, 512
    cam = Camera.from_colmap({"model": "SIMPLE_RADIAL", "width": w, "height": h,
                              "params": [260.0, 160.0, 120.0, -0.03]})
    T = Pose.from_aa(torch.tensor([0.02, -0.05, 0.01]), torch.tensor([0.3, 0.02, 0.05]))

    def plane(cam_j, R, t):  # z = 4 + 0.1 x in camera 0, seen from camera j
        n0 = torch.tensor([-0.1, 0.0, 1.0])
        nj = R @ n0
        rays = cam_j.image2cam(image_grid(h, w).reshape(1, -1, 2))[0]
        d = (4.0 + nj @ t) / (rays @ nj)
        d[torch.from_numpy(rng.random(h * w) < 0.05)] = 0.0
        return d.reshape(1, h, w)

    d0, d1 = plane(cam, torch.eye(3), torch.zeros(3)), plane(cam, T.R, T.t)
    kp0 = torch.from_numpy(rng.uniform(0, [w, h], (1, n, 2)).astype(np.float32))
    z0, v0 = sample_depth(kp0, d0)
    kp1, _ = project(kp0, z0, None, cam, cam, T, v0)
    kp1 = kp1 + torch.from_numpy(rng.normal(size=(1, n, 2)).astype(np.float32))
    kp1[:, : n // 4] = torch.from_numpy(rng.uniform(0, [w, h], (1, n // 4, 2)).astype(np.float32))
    mask = torch.ones(1, n, dtype=torch.bool)
    mask[:, -20:] = False
    for kw in ({}, {"epi_th": 3.0}, {"epi_th": 3.0, "mask0": mask, "mask1": mask}, {"ccth": 9.0}):
        cpu = gt_matches_from_pose_depth(kp0, kp1, cam, cam, T, d0, d1, **kw)
        card = gt_matches_from_pose_depth(
            kp0.to(dev), kp1.to(dev), cam.to(dev), cam.to(dev), T.to(dev), d0.to(dev), d1.to(dev),
            **{k: v.to(dev) if torch.is_tensor(v) else v for k, v in kw.items()})
        for k in ("matches0", "matches1", "visible0", "visible1"):
            assert card[k].device.type == "cuda" and torch.equal(card[k].cpu(), cpu[k]), (k, kw)
        assert (cpu["matches0"] >= 0).sum() > 100

"""The port's fused VGG block (`ops/cuda_conv.py`): its plain version
against the JAX package's Pallas kernel in interpret mode, in all three
variants, in f32 and bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.ops.pallas_conv import fused_vgg_block as jax_fused_vgg_block
from gluefactory_tpu.ops.pallas_conv import vgg_block_xla
from gluefactory_tpu_torch.ops import cuda_conv

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: the same f32 products summed in another order (the JAX package's own
# kernel tests use 1e-4). bf16: both round the activation between the convs
# and the output to bf16, so a sum taken in another order may flip a
# rounding, which conv_b then spreads: held to twice the gap that bf16
# rounding alone opens (the Pallas kernel in bf16 against the plain version
# in f32 on the same bf16 inputs).
F32_ATOL = 1e-4


def _inputs(seed, two, ci=8, cm=16, co=16, shape=(2, 32, 48)):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(0, 0.5, s).astype(np.float32)  # noqa: E731
    x = mk(*shape, ci)
    w = [mk(3, 3, ci, cm), mk(cm)]
    if two:
        w += [mk(3, 3, cm, co), mk(co)]
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["one_conv_pool", "two_convs_pool", "two_convs_no_pool"])
def test_plain_matches_pallas_kernel(dtype, variant):
    jd, td = DTYPES[dtype]
    two = variant != "one_conv_pool"
    pool = variant != "two_convs_no_pool"
    x, w = _inputs(["one_conv_pool", "two_convs_pool", "two_convs_no_pool"].index(variant), two,
                   shape=(1, 64, 32) if variant == "two_convs_pool" else (2, 32, 48))
    xj, wj = jnp.asarray(x).astype(jd), [jnp.asarray(a).astype(jd) for a in w]
    xt, wt = torch.from_numpy(x).to(td), [torch.from_numpy(a).to(td) for a in w]
    want = np.asarray(jax_fused_vgg_block(xj, *wj, two_convs=two, pool=pool, interpret=True)
                      .astype(jnp.float32))
    got = cuda_conv.vgg_block_plain(xt, *wt, pool=pool)
    assert got.dtype == td and tuple(got.shape) == want.shape
    err = np.abs(got.float().numpy() - want).max()
    if dtype == "float32":
        assert err <= F32_ATOL
    else:
        f32 = cuda_conv.vgg_block_plain(xt.float(), *(a.float() for a in wt), pool=pool).numpy()
        gap = np.abs(want - f32).max()
        assert err <= 2 * gap


def test_plain_matches_vgg_block_xla_in_f32():
    """In f32 the plain version is `vgg_block_xla`, the JAX package's spec."""
    x, w = _inputs(4, True)
    want = vgg_block_xla(jnp.asarray(x), *(jnp.asarray(a) for a in w))
    got = cuda_conv.vgg_block_plain(torch.from_numpy(x), *(torch.from_numpy(a) for a in w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_odd_sizes_pool_floors():
    x, w = _inputs(5, True, shape=(1, 17, 23))
    got = cuda_conv.fused_vgg_block(torch.from_numpy(x), *(torch.from_numpy(a) for a in w))
    assert tuple(got.shape) == (1, 8, 11, 16)


def test_superpoint_kernel_layout_weights_follow_the_weights():
    """SuperPoint's fused backbone hands the wrapper weights already in the
    kernel's layout (contiguous HWIO), kept until a weight changes; with
    autograd on it permutes the live weight."""
    from gluefactory_tpu_torch.models import get_model

    torch.manual_seed(0)
    sp = get_model("superpoint").from_conf(
        {"channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 32,
         "fused_backbone": True}, device="cpu").eval()
    with torch.no_grad():
        w, b = sp._hwio("conv2a")
        assert w.is_contiguous() and b is sp.conv2a.bias
        torch.testing.assert_close(w, sp.conv2a.weight.permute(2, 3, 1, 0), rtol=0, atol=0)
        assert sp._hwio("conv2a")[0].data_ptr() == w.data_ptr()  # kept
        sp.conv2a.weight.mul_(2.0)
        w2, _ = sp._hwio("conv2a")
        torch.testing.assert_close(w2, sp.conv2a.weight.permute(2, 3, 1, 0), rtol=0, atol=0)
        sp.double()
        assert sp._hwio("conv2a")[0].dtype == torch.float64
    w3, _ = sp._hwio("conv2a")
    assert w3.requires_grad and w3._base is sp.conv2a.weight


# path C's four blocks on an H100 (132 SMs), 8 images of 1024^2:
# (input NHWC, C_mid, C_out or None, pool, the strips of conv_a [and conv_b])
PATH_C_BLOCKS = {
    "conv1b_pool": ((8, 1024, 1024, 64), 64, None, True, [128]),
    "block2": ((8, 512, 512, 64), 64, 64, True, [128, 128]),
    "block3": ((8, 256, 256, 64), 128, 128, True, [64, 64]),
    "block4": ((8, 128, 128, 128), 128, 128, False, [16, 16]),
}


@pytest.mark.parametrize("block", list(PATH_C_BLOCKS))
def test_strip_plan_of_path_c(block):
    """Every conv of path C's blocks runs the wgmma body in bf16, in even
    strips (a pooled pair never straddles two units); block 4's small image
    gets short strips so that its units cover the SMs; in f32 the CUDA-core
    body runs."""
    shape, cm, co, pool, strips = PATH_C_BLOCKS[block]
    plan = cuda_conv.conv_plan(*shape, cm, co, pool, torch.bfloat16, 132)
    assert [c["body"] for c in plan] == ["wgmma"] * len(strips)
    assert [c["strip"] for c in plan] == strips
    assert [c["pool"] for c in plan] == [False] * (len(strips) - 1) + [pool]
    B, H, W, _ = shape
    for c in plan:
        assert c["strip"] % 2 == 0
        units = B * -(-H // c["strip"]) * -(-W // cuda_conv.STRIP_COLS) * (c["c_out"] // 64)
        assert units >= 128  # at least one unit per SM's consumer pair, nearly
    f32 = cuda_conv.conv_plan(*shape, cm, co, pool, torch.float32, 132)
    assert all(c["body"] == "cuda_cores" and c["strip"] == 0 for c in f32)


def test_conv_plan_channels():
    """bf16 convs whose C_in or C_out is not a multiple of 64 take the
    CUDA-core body, each conv of a block on its own."""
    plan = cuda_conv.conv_plan(2, 37, 50, 64, 128, 80, True, torch.bfloat16, 132)
    assert [c["body"] for c in plan] == ["wgmma", "cuda_cores"]
    assert cuda_conv.conv_plan(1, 8, 8, 24, 64, None, True, torch.bfloat16, 132)[0]["body"] == "cuda_cores"


@pytest.mark.parametrize("args,taken", [
    ((1024, 1024, 64, 64, 64, True), True),
    ((128, 128, 128, 128, 128, False), True),
    ((96, 128, 24, 24, 24, True), False),   # C_mid 24: not a multiple of 16
    ((96, 128, 12, 16, 16, True), False),   # C_in 12: not a multiple of 8
    ((17, 23, 8, 16, 16, True), False),     # odd size, pooled
    ((17, 23, 8, 16, 16, False), True),     # odd size, not pooled
])
def test_vgg_kernel_available(args, taken):
    assert cuda_conv.vgg_kernel_available(*args) is taken


def test_bf16_rounding_before_the_pool_is_the_jax_order():
    """The wgmma body's epilogue rounds the even row to bf16 after its x
    pool, then maxes the odd row into it and rounds again: rounding is
    monotonic, so this equals pooling in f32 and rounding once, and equals
    `vgg_block_xla`'s order in bf16 (conv, bias and ReLU rounded to bf16,
    then the pool), here on the same rounded activations."""
    rng = np.random.default_rng(7)
    y = rng.normal(0, 2.0, (2, 18, 22, 64)).astype(np.float32)
    yt = torch.from_numpy(y)
    # the epilogue's order: x pairs, even row rounded, odd row maxed in, rounded
    xp = torch.maximum(yt[:, :, 0::2], yt[:, :, 1::2])
    even = xp[:, 0::2].to(torch.bfloat16)
    kernel_order = torch.maximum(xp[:, 1::2], even.float()).to(torch.bfloat16)
    f32_then_round = torch.nn.functional.max_pool2d(yt.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    assert torch.equal(kernel_order, f32_then_round.to(torch.bfloat16))
    yj = jnp.asarray(y).astype(jnp.bfloat16)
    jax_order = jax.lax.reduce_window(yj, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    np.testing.assert_array_equal(kernel_order.float().numpy(), np.asarray(jax_order.astype(jnp.float32)))

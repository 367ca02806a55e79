"""The port's fused VGG block (`ops/cuda_conv.py`): its plain version
against the JAX package's Pallas kernel in interpret mode, in all three
variants, in f32 and bf16."""

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
    """SuperPoint's fused backbone hands the wrapper HWIO views of weights
    already in the kernel's (3, 3, C_out, C_in) layout, kept until a weight
    changes; with autograd on it permutes the live weight."""
    from gluefactory_tpu_torch.models import get_model

    torch.manual_seed(0)
    sp = get_model("superpoint").from_conf(
        {"channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 32,
         "fused_backbone": True}, device="cpu").eval()
    with torch.no_grad():
        w, b = sp._hwio("conv2a")
        assert w.transpose(-1, -2).is_contiguous() and b is sp.conv2a.bias
        torch.testing.assert_close(w, sp.conv2a.weight.permute(2, 3, 1, 0), rtol=0, atol=0)
        assert sp._hwio("conv2a")[0].data_ptr() == w.data_ptr()  # kept
        sp.conv2a.weight.mul_(2.0)
        w2, _ = sp._hwio("conv2a")
        torch.testing.assert_close(w2, sp.conv2a.weight.permute(2, 3, 1, 0), rtol=0, atol=0)
        sp.double()
        assert sp._hwio("conv2a")[0].dtype == torch.float64
    w3, _ = sp._hwio("conv2a")
    assert w3.requires_grad and w3._base is sp.conv2a.weight

"""The port's LoFTR (`models/backbones/resnet_fpn.py`,
`models/matchers/loftr.py`) against the JAX package's on the same seeded
images and weights: torch's seeded init under the official names (the
BatchNorms' statistics and affine parameters drawn away from their
constant init), taken into the JAX package by its `convert_loftr` and back
by `from_jax_params`.

Tolerances: the backbone's maps 1e-4 (float32 sums of up to 7 x 7 x 256
products in another order); the linear attention and the sine encoding
1e-5; the whole matcher at reduced depth (2 coarse layer pairs, the
backbone's fixed widths: 256 coarse, 128 fine) with a zero match
threshold, so that every mutual maximum is a match: the valid (i, j) sets
equal, keypoints1 within 1e-3 px, scores within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.compat.torch_conversion import convert_loftr
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.models.backbones.resnet_fpn import ResNetFPN_8_2 as JaxResNetFPN
from gluefactory_tpu.models.matchers import loftr as jax_loftr
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.backbones import resnet_fpn
from gluefactory_tpu_torch.models.matchers import loftr as port_loftr
from test_torch_sift import textured

CONF = {"coarse_layers": 2, "fine_layers": 1, "max_num_matches": 64, "match_threshold": 0.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this file's tests: the suite runs in several
    worker processes at once, where each process's default of one thread
    a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    port = get_model("loftr").from_conf(CONF, device="cpu").eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, b in port.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
        for m in port.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.LayerNorm)):
                m.weight.add_(0.1 * torch.randn(m.weight.shape, generator=g))
                m.bias.add_(0.1 * torch.randn(m.bias.shape, generator=g))
    sd = port.state_dict()
    params, stats = convert_loftr({k: v.numpy() for k, v in sd.items()}, coarse_layers=2, fine_layers=1)
    return port, params, stats


def _pair(h, w):
    im0 = textured(0, w, h)
    im1 = np.roll(im0, (3, 5), (0, 1)).copy()  # the same scene moved by (5, 3) px
    return {f"view{i}": {"image": im[None, ..., None]} for i, im in enumerate((im0, im1))}


def test_weights_round_trip(models):
    """`convert_loftr` of the port's state dict has the JAX model's
    parameter tree (names and shapes, from `init` traced without running),
    and `from_jax_params` brings it back tensor for tensor."""
    port, params, stats = models
    model_j = jax_get_model("loftr").from_conf(CONF)
    data = jax.tree.map(jnp.asarray, _pair(64, 96))
    shapes = jax.eval_shape(lambda: model_j.init(jax.random.key(0), data))
    assert jax.tree.map(lambda a: a.shape, shapes["params"]) == jax.tree.map(np.shape, params)
    assert jax.tree.map(lambda a: a.shape, shapes["batch_stats"]) == jax.tree.map(np.shape, stats)
    back = from_jax_params(params, "loftr", batch_stats=stats)
    sd = port.state_dict()
    assert set(back) == set(sd) and all(torch.equal(v, sd[k]) for k, v in back.items())
    pipe = from_jax_params({"matcher_model": params}, "two_view_pipeline",
                           batch_stats={"matcher_model": stats})
    assert set(pipe) == {f"matcher.{k}" for k in sd}


@pytest.mark.parametrize("hw", [(64, 96), (70, 90), (67, 93)])
def test_resnet_fpn_matches_jax(models, hw):
    """Even, odd and mixed sizes: flax's SAME padding of the stride-2 convs
    ((2, 3) / (0, 1) on even sizes) and the half-pixel bilinear upsampling
    at sizes that are not exact doubles."""
    port, params, stats = models
    x = textured(2, hw[1], hw[0])[None, ..., None]
    coarse_j, fine_j = jax.jit(JaxResNetFPN().apply)(
        {"params": params["backbone"], "batch_stats": stats["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        coarse, fine = port.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(coarse.permute(0, 2, 3, 1).numpy(), np.asarray(coarse_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(fine.permute(0, 2, 3, 1).numpy(), np.asarray(fine_j), atol=1e-4, rtol=1e-4)


def test_same_padding_is_flax_s():
    assert resnet_fpn._same_pad(64, 7, 2) == (2, 3) and resnet_fpn._same_pad(65, 7, 2) == (3, 3)
    assert resnet_fpn._same_pad(64, 3, 2) == (0, 1) and resnet_fpn._same_pad(65, 3, 2) == (1, 1)
    assert resnet_fpn._same_pad(64, 1, 2) == (0, 0) and resnet_fpn._same_pad(33, 3, 1) == (1, 1)


def test_linear_attention_and_sine_encoding():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, n, 4, 8)).astype(np.float32) for n in (11, 13, 13))
    mq, mk = rng.uniform(size=(2, 11)) > 0.3, rng.uniform(size=(2, 13)) > 0.3
    for masks in ((None, None), (mq, mk)):
        want = jax_loftr.linear_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                          *(None if m is None else jnp.asarray(m) for m in masks))
        got = port_loftr.linear_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                          *(None if m is None else torch.from_numpy(m) for m in masks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for h, w, d in ((8, 12, 256), (13, 9, 128)):
        np.testing.assert_allclose(port_loftr.sine_pos_encoding(h, w, d).numpy(),
                                   np.asarray(jax_loftr.sine_pos_encoding(h, w, d)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(64, 96), (72, 88)])
def test_loftr_matches_jax(models, hw):
    port, params, stats = models
    data = _pair(*hw)
    model_j = jax_get_model("loftr").from_conf(CONF)
    ref = jax.jit(model_j.apply)({"params": params, "batch_stats": stats}, jax.tree.map(jnp.asarray, data))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    with torch.no_grad():
        out = {k: v.numpy() for k, v in port(jax.tree.map(torch.from_numpy, data)).items()}
    vj, vt = ref["keypoint_mask0"][0], out["keypoint_mask0"][0]
    assert vj.sum() >= 20 and vj.sum() == vt.sum()
    np.testing.assert_array_equal(out["matches0"][0][vt], np.flatnonzero(vt))
    pj = {tuple(a): (b, s) for a, b, s in zip(ref["keypoints0"][0][vj], ref["keypoints1"][0][vj],
                                               ref["matching_scores0"][0][vj])}
    pt = {tuple(a): (b, s) for a, b, s in zip(out["keypoints0"][0][vt], out["keypoints1"][0][vt],
                                               out["matching_scores0"][0][vt])}
    assert set(pj) == set(pt)  # the coarse cells i (their centres) ...
    for key, (k1, s) in pj.items():  # ... their cells j, moved by the fine step
        np.testing.assert_allclose(pt[key][0], k1, atol=1e-3, rtol=0)
        np.testing.assert_allclose(pt[key][1], s, atol=1e-5, rtol=0)
    assert (out["matching_scores0"][0][~vt] == 0).all() and (out["matches0"][0][~vt] == -1).all()


def test_loss_raises_and_config_by_name(models):
    port = models[0]
    with pytest.raises(NotImplementedError):
        port.loss({}, {})
    assert get_model("loftr") is port_loftr.LoFTR
    jconf = jax_get_model("loftr").from_conf({}).conf.to_dict()
    assert port_loftr.LoFTR.resolve_conf().to_dict() == jconf

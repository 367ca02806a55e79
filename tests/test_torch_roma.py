"""The port's RoMa (`models/matchers/roma_net.py`, `models/matchers/roma.py`)
against the JAX package's on the same seeded inputs and weights: torch's
seeded init under romatch's names (the BatchNorms' statistics and affine
parameters, the LayerNorms and DINOv2's LayerScales drawn away from their
constant init), taken into the JAX package by its `convert_roma` (with
`roma_fold_attention_heads`) and back by `from_jax_params`.

Narrow widths of `tests/test_roma_convert.py` (DINOv2 32 wide, 1 block;
VGG 8-16 channels; GP 16; one decoder block of 2 heads; 4 x 4 anchors; 2
hidden refiner blocks), images of 56^2 internal and 112^2 output.
Tolerances: each stage 1e-5, but the convolutions' and the GP solve's
1e-4 (float32 sums of up to 3 x 3 x 16 and 5 x 5 products in another
order; the solve's pivots); the whole two-pass forward 1e-4 on the warp
and the certainty; the resizes 1e-5; the match snapping exact on indices
and 1e-6 on scores; the KDE 1e-5 relative; the sampling fed JAX's own
Gumbel draws gives the same indices.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gluefactory_tpu
from gluefactory_tpu.compat.torch_conversion import convert_roma, roma_fold_attention_heads
from gluefactory_tpu.core.config import from_yaml as jax_from_yaml
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.models.matchers import roma as jroma
from gluefactory_tpu.models.matchers import roma_net as jnet
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.core.config import from_yaml
from gluefactory_tpu_torch.eval.io import parse_config_path
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.matchers import roma as proma
from gluefactory_tpu_torch.models.matchers import roma_net as pnet

NET = {
    "dinov2": {"weights": "dinov2_vits14", "trainable": False, "embed_dim": 32, "depth": 1, "num_heads": 2},
    "vgg_blocks": [[8, 2], [16, 2], [16, 2], [16, 2]],
    "gp_dim": 16,
    "decoder_blocks": 1,
    "decoder_heads": 2,
    "anchor_res": 4,
    "proj_dims": {"16": 16, "8": 16, "4": 16, "2": 8, "1": 9},
    "disp_emb_dims": {"16": 8, "8": 8, "4": 4, "2": 4, "1": 2},
    "corr_radius": {"16": 2, "8": 1, "4": 1, "2": None, "1": None},
    "hidden_blocks": 2,
}
CONF = {"net": NET, "internal_hw": [56, 56], "output_hw": [112, 112]}


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
    port = get_model("roma").from_conf(CONF, device="cpu").eval()
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
        for name, p in port.named_parameters():
            if name.endswith("gamma"):
                p.copy_(0.5 + 0.2 * torch.randn(p.shape, generator=g))
    params, stats = convert_roma({k: v.numpy() for k, v in port.state_dict().items()})
    params = roma_fold_attention_heads(params, num_heads=NET["decoder_heads"])
    return port, params, stats


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_weights_round_trip(models):
    """`convert_roma` of the port's state dict needs no separate DINOv2
    checkpoint, has the JAX model's trees (names and shapes, from `init`
    traced without running), and `from_jax_params` gives the state dict back
    tensor for tensor, loaded strictly; through the pipeline too."""
    port, params, stats = models
    model_j = jax_get_model("roma").from_conf(CONF)
    im = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model_j.init(jax.random.key(0), {"view0": {"image": im},
                                                                      "view1": {"image": im}}))
    assert jax.tree.map(lambda a: a.shape, shapes["params"]) == jax.tree.map(np.shape, params)
    assert jax.tree.map(lambda a: a.shape, shapes["batch_stats"]) == jax.tree.map(np.shape, stats)
    sd = port.state_dict()
    back = from_jax_params(params, "roma", batch_stats=stats)
    assert set(back) == set(sd) and all(torch.equal(v, sd[k]) for k, v in back.items())
    port.load_state_dict(back, strict=True)
    pipe = from_jax_params({"matcher_model": params}, "two_view_pipeline",
                           batch_stats={"matcher_model": stats})
    assert set(pipe) == {f"matcher.{k}" for k in sd}
    with pytest.raises(ValueError, match="batch_stats"):
        from_jax_params(params, "roma")


def test_vgg_pyramid(models):
    port, params, stats = models
    x = _rng(1).uniform(-2, 2, (2, 36, 44, 3)).astype(np.float32)
    blocks = tuple((int(ch), jnet.VGG19_BLOCKS[i][1][:int(n)]) for i, (ch, n) in enumerate(NET["vgg_blocks"]))
    ref = jax.jit(jnet.VGG19Pyramid(blocks).apply)(
        {"params": params["net"]["vgg"], "batch_stats": stats["net"]["vgg"]}, jnp.asarray(x))
    with torch.no_grad():
        out = port.encoder.cnn(_nchw(x))
    assert sorted(out) == sorted(ref) == [1, 2, 4, 8]
    for s in ref:
        np.testing.assert_allclose(_nhwc(out[s]), np.asarray(ref[s]), atol=1e-4, rtol=1e-4)


def test_gp_posterior(models):
    port, params, _ = models
    rng = _rng(2)
    fa, fb = _f32(rng, 2, 5, 6, 16), _f32(rng, 2, 5, 6, 16)
    ref = jax.jit(jnet.GPMatcher(16, 0.2, 0.1).apply)({"params": params["net"]["decoder"]["gp"]},
                                                         jnp.asarray(fa), jnp.asarray(fb))
    with torch.no_grad():
        out = port.decoder.gps["16"](_nchw(fa), _nchw(fb))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_anchor_decoder(models):
    port, params, _ = models
    x = _f32(_rng(3), 2, 4, 5, 32)
    ref_cls, ref_cert = jax.jit(jnet.AnchorDecoder(1, 2, 4).apply)(
        {"params": params["net"]["decoder"]["embedding_decoder"]}, jnp.asarray(x))
    with torch.no_grad():
        cls, cert = port.decoder.embedding_decoder(_nchw(x))
    np.testing.assert_allclose(cls.numpy(), np.asarray(ref_cls), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cert.numpy(), np.asarray(ref_cert), atol=1e-5, rtol=1e-5)


def test_cls_to_flow_refine():
    """The mode's neighbours cross row ends and clip at the grid's ends:
    logits peaked at the first and last anchors and at row ends."""
    logits = _f32(_rng(4), 2, 3, 5, 16)
    for i, k in enumerate((0, 15, 3, 4, 12)):
        logits[0, 0, i, k] += 6.0
    ref = jnet.cls_to_flow_refine(jnp.asarray(logits))
    out = pnet.cls_to_flow_refine(torch.from_numpy(logits))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("radius", [1, 2])
def test_local_correlation(radius):
    rng = _rng(5 + radius)
    fa, fb = _f32(rng, 2, 7, 9, 6), _f32(rng, 2, 7, 9, 6)
    flow = rng.uniform(-1.1, 1.1, (2, 7, 9, 2)).astype(np.float32)
    ref = jnet.local_correlation(jnp.asarray(fa), jnp.asarray(fb), radius, jnp.asarray(flow))
    out = pnet.local_correlation(_nchw(fa), _nchw(fb), radius, torch.from_numpy(flow))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_conv_refiner(models):
    """The scale-8 refiner: depthwise 5 x 5 blocks, the displacement
    embedding at scale_factor 2, the local correlation of radius 1."""
    port, params, stats = models
    rng = _rng(7)
    fa, fb = _f32(rng, 2, 9, 11, 16), _f32(rng, 2, 9, 11, 16)
    flow = rng.uniform(-1.05, 1.05, (2, 9, 11, 2)).astype(np.float32)
    mod = jnet.ConvRefiner(disp_emb_dim=8, corr_radius=1, hidden_blocks=2, kernel_size=5)
    ref_d, ref_c = jax.jit(mod.apply, static_argnames="scale_factor")(
        {"params": params["net"]["decoder"]["refiner8"], "batch_stats": stats["net"]["decoder"]["refiner8"]},
        jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(flow), scale_factor=2.0)
    with torch.no_grad():
        d, c = port.decoder.conv_refiner["8"](_nchw(fa), _nchw(fb), torch.from_numpy(flow), scale_factor=2.0)
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("src,dst", [((37, 53), (16, 20)), ((45, 45), (13, 13)), ((5, 7), (24, 30))],
                         ids=["down", "down_odd", "up"])
def test_antialiased_resize(src, dst):
    """`jax.image.resize(..., "linear")` antialiases a downsample; the port
    resizes with `antialias=True`, which changes nothing on an upsample."""
    x = _f32(_rng(8), 2, 3, *src)
    ref = jax.image.resize(jnp.asarray(x), (2, 3, *dst), method="linear")
    np.testing.assert_allclose(pnet.resize(torch.from_numpy(x), *dst).numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    ref3 = jax.image.resize(jnp.asarray(x[:, 0]), (2, *dst), method="linear")
    np.testing.assert_allclose(pnet.resize(torch.from_numpy(x[:, 0]), *dst).numpy(), np.asarray(ref3),
                               atol=1e-5, rtol=1e-5)


def _views(seed, hw=(80, 96)):
    rng = _rng(seed)
    base = rng.uniform(0, 1, (hw[0] + 8, hw[1] + 8, 3)).astype(np.float32)
    return {"view0": {"image": base[None, :hw[0], :hw[1]].copy()},
            "view1": {"image": base[None, 5:hw[0] + 5, 3:hw[1] + 3].copy()}}


def test_native_forward_matches_jax(models):
    """The whole network path: the coarse pass at 56^2 with bf16-rounded
    images, the refiner-only upsample pass at 112^2 from the coarse flow
    (its scale-8 level downsampling the 56^2 flow to 14^2), both
    directions, `flow_to_warp` with the coarse certainty."""
    port, params, stats = models
    data = _views(9)
    model_j = jax_get_model("roma").from_conf(CONF)
    ref = jax.jit(model_j.apply)({"params": params, "batch_stats": stats}, jax.tree.map(jnp.asarray, data))
    with torch.no_grad():
        out = port(jax.tree.map(torch.from_numpy, data))
    for k in ("warp0", "warp1", "certainty0", "certainty1"):
        assert tuple(out[k].shape) == tuple(ref[k].shape)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=1e-4)
    assert float(out["certainty0"].std()) > 1e-3  # the certainty varies over the image


def test_flow_to_warp_and_cycle_dist():
    rng = _rng(10)
    flow = rng.uniform(-1.3, 1.3, (2, 24, 28, 2)).astype(np.float32)
    logits, lr = _f32(rng, 2, 24, 28, scale=2.0), _f32(rng, 2, 6, 7, scale=2.0)
    ref = jroma.flow_to_warp(jnp.asarray(flow), jnp.asarray(logits), jnp.asarray(lr), extract_query_coords=True)
    out = proma.flow_to_warp(torch.from_numpy(flow), torch.from_numpy(logits), torch.from_numpy(lr),
                             extract_query_coords=True)
    for k in ("warp", "certainty", "q_coords"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-6, rtol=1e-6)
    assert (out["certainty"] == 0).any()  # the flow left the image somewhere
    w0, w1 = (rng.uniform(-1.1, 1.1, (2, 24, 28, 2)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(proma.cycle_dist(torch.from_numpy(w0), torch.from_numpy(w1)).numpy(),
                               np.asarray(jroma.cycle_dist(jnp.asarray(w0), jnp.asarray(w1))),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("mutual", [True, False])
def test_match_keypoints_dense(mutual):
    """Keypoints snapped through warps that map view 0 onto view 1 shifted
    by (3, -2) px, with jitter, padded slots on both sides and certainty
    below the threshold in part of the image."""
    rng = _rng(11)
    H, W, N = 40, 50, 60
    grid = np.stack(np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5, indexing="xy"), -1)
    norm = lambda p: p / np.array([W - 1, H - 1]) * 2 - 1  # noqa: E731
    warp0 = norm(grid + np.array([3.0, -2.0]))[None].astype(np.float32)
    warp1 = norm(grid - np.array([3.0, -2.0]))[None].astype(np.float32)
    cert = rng.uniform(0, 1, (1, H, W)).astype(np.float32)
    k0 = rng.uniform(4, 36, (1, N, 2)).astype(np.float32)
    k1 = (k0 + np.array([3.0, -2.0]) + rng.normal(0, 0.6, (1, N, 2)))[:, rng.permutation(N)].astype(np.float32)
    m0, m1 = rng.uniform(size=(1, N)) > 0.15, rng.uniform(size=(1, N)) > 0.15
    pred = {"warp0": warp0, "warp1": warp1, "certainty0": cert, "certainty1": cert[:, ::-1].copy()}
    data = {"view0": {"image_size": np.array([[W, H]], np.float32)},
            "view1": {"image_size": np.array([[W, H]], np.float32)},
            "keypoints0": k0, "keypoints1": k1, "keypoint_mask0": m0, "keypoint_mask1": m1}
    ref = jroma.match_keypoints_dense(jax.tree.map(jnp.asarray, pred), jax.tree.map(jnp.asarray, data),
                                      2.0, 0.3, mutual)
    out = proma.match_keypoints_dense(jax.tree.map(torch.from_numpy, pred), jax.tree.map(torch.from_numpy, data),
                                      2.0, 0.3, mutual)
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    for k in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-6)
    assert (out["matches0"] >= 0).sum() >= 10
    assert (out["matches0"][~torch.from_numpy(m0)] == -1).all()


def _dense_pred(rng, h=12, w=12):
    """Warps of a near-constant shift (clustered 4-vectors, so the KDE's
    density passes `min_density` in places), certainties above the
    threshold in a few pixels and zero elsewhere."""
    grid = np.stack(np.meshgrid(np.linspace(-1 + 1 / w, 1 - 1 / w, w), np.linspace(-1 + 1 / h, 1 - 1 / h, h),
                                indexing="xy"), -1)
    pred = {}
    for i, s in enumerate((0.1, -0.1)):
        pred[f"warp{i}"] = np.clip(grid + s + rng.normal(0, 0.02, grid.shape), -1, 1)[None].astype(np.float32)
        c = rng.uniform(0, 0.2, (1, h, w))
        c[c < 0.17] = 0.0  # fewer positive pixels than draws
        pred[f"certainty{i}"] = c.astype(np.float32)
    return pred


@pytest.mark.parametrize("mode", ["threshold_balanced", "threshold"])
def test_sample_matches_with_jax_draws(mode):
    pred = _dense_pred(_rng(12))
    hw0, hw1, num = (90, 120), (100, 80), 60
    key = jax.random.key(5)
    ref = jroma.sample_matches(jax.tree.map(jnp.asarray, pred), hw0, hw1, num, key, sample_mode=mode,
                               kde_std=0.3)
    k1 = min(4 * num, 2 * 144) if "balanced" in mode else None
    r1, r2 = jax.random.split(key)
    noise = (jax.random.gumbel(r1, (2 * 144,), jnp.float32),
             jax.random.gumbel(r2, (k1,), jnp.float32) if k1 else None)
    noise = tuple(None if n is None else torch.from_numpy(np.array(n)) for n in noise)
    out = proma.sample_matches(jax.tree.map(torch.from_numpy, pred), hw0, hw1, num, sample_mode=mode,
                               kde_std=0.3, noise=noise)
    for k in ("keypoints0", "keypoints1", "matching_scores0", "keypoint_mask0", "matches0"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=0)
    assert 0 < int(out["keypoint_mask0"].sum()) < num  # draws on certainty 0 give no match
    with pytest.raises(ValueError, match="batch 1"):
        proma.sample_matches({k: v.repeat(2, *[1] * (v.ndim - 1))
                              for k, v in jax.tree.map(torch.from_numpy, pred).items()}, hw0, hw1, num)


def test_sample_matches_draws_from_the_generator():
    pred = jax.tree.map(torch.from_numpy, _dense_pred(_rng(13)))
    a, b, c = (proma.sample_matches(pred, (90, 120), (90, 120), 40, torch.Generator().manual_seed(s))
               for s in (0, 0, 1))
    assert torch.equal(a["keypoints0"], b["keypoints0"]) and not torch.equal(a["keypoints0"], c["keypoints0"])


def test_kde_in_row_blocks(monkeypatch):
    x = np.concatenate([_rng(14).normal(0, 0.05, (150, 4)), _rng(15).uniform(-1, 1, (101, 4))]).astype(np.float32)
    ref = np.asarray(jroma.kde_density(jnp.asarray(x), 0.1))
    monkeypatch.setattr(proma, "KDE_BLOCK", 1000)  # blocks of 3 rows, the last one short
    np.testing.assert_allclose(proma.kde_density(torch.from_numpy(x), 0.1).numpy(), ref, rtol=1e-5, atol=1e-5)
    assert ref.max() > 10.0 > ref.min()


def test_config_resolves_by_name():
    """`roma` by name holds the JAX package's YAML data key for key, and
    each section's matcher conf merged with its defaults equals the JAX
    model's."""
    path = parse_config_path("roma")
    assert path.parent.parent.name == "gluefactory_tpu_torch"
    jax_conf = jax_from_yaml(str(Path(gluefactory_tpu.__file__).parent / "configs" / "roma.yaml"))
    conf = from_yaml(str(path))
    assert conf.to_dict() == jax_conf.to_dict()
    for section in (conf.model, *(b.model for b in conf.benchmarks.values())):
        sub = {k: v for k, v in {**conf.model.matcher.to_dict(), **section.matcher.to_dict()}.items()
               if k != "name"}
        assert get_model("roma").resolve_conf(sub).to_dict() == \
            jax_get_model("roma").from_conf(sub).conf.to_dict()


def test_refusals(models):
    port = models[0]
    with pytest.raises(NotImplementedError):
        port.loss({}, {})
    data = _views(16)
    data["view1"]["image"] = data["view1"]["image"][:, :72]
    model = get_model("roma").from_conf({**CONF, "output_hw": None}, device="cpu").eval()
    with pytest.raises(ValueError, match="equal view sizes"), torch.no_grad():
        model(jax.tree.map(torch.from_numpy, data))
    data_only = get_model("roma").from_conf({"backend": "data"}, device="cpu")
    assert not list(data_only.parameters())
    with pytest.raises(NotImplementedError, match="dense warp source"):
        data_only(jax.tree.map(torch.from_numpy, _views(17)))

"""The port's SuperPoint against the JAX package's on the same seeded images
and the same weights (converted with `from_jax_params`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.extractors.superpoint import detector_scores

# narrow, and k well below the NMS survivor count: no random fill is compared
CONF = {"channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 32,
        "max_num_keypoints": 48, "detection_threshold": 0.0, "dense_outputs": True}
H, W = 96, 128


def _models(conf, seed=0):
    sp_j = jax_get_model("superpoint").from_conf(conf)
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (2, H, W, 1)).astype(np.float32)
    data_j = {"image": jnp.asarray(image)}
    params = jax.jit(sp_j.init)({"params": jax.random.key(seed)}, data_j)
    sp_t = get_model("superpoint").from_conf(conf, device="cpu").eval()
    sp_t.load_state_dict(from_jax_params(params["params"], "superpoint"))
    return sp_j, params, sp_t, image


@pytest.fixture(scope="module")
def f32_run():
    sp_j, params, sp_t, image = _models(CONF)
    ref = jax.jit(sp_j.apply)(params, {"image": jnp.asarray(image)})
    with torch.no_grad():
        out = sp_t({"image": torch.from_numpy(image)})
    return {k: np.asarray(v) for k, v in ref.items()}, out


def test_score_map_and_dense_descriptors(f32_run):
    ref, out = f32_run
    assert out["dense_score_map"].shape == (2, H, W)
    # f32 convs summed in another order
    np.testing.assert_allclose(out["dense_score_map"].numpy(), ref["dense_score_map"], atol=1e-6)
    np.testing.assert_allclose(out["dense_descriptors"].numpy(), ref["dense_descriptors"],
                               atol=2e-5)


def test_keypoints_and_descriptors(f32_run):
    ref, out = f32_run
    assert out["keypoints"].shape == (2, 48, 2) and out["keypoint_mask"].all()
    np.testing.assert_array_equal(out["keypoint_mask"].numpy(), ref["keypoint_mask"])
    np.testing.assert_array_equal(out["keypoints"].numpy(), ref["keypoints"])
    np.testing.assert_allclose(out["keypoint_scores"].numpy(), ref["keypoint_scores"], atol=1e-6)
    np.testing.assert_allclose(out["descriptors"].numpy(), ref["descriptors"], atol=2e-5)
    # COLMAP convention: pixel centres at +0.5
    np.testing.assert_array_equal(out["keypoints"].numpy() % 1, 0.5)


def test_pixel_shuffle_channel_order():
    """Channel dy*8+dx of cell (hc, wc) lands on pixel (8*hc+dy, 8*wc+dx)."""
    Hc, Wc = 3, 4
    for hc, wc, dy, dx in [(0, 0, 0, 0), (1, 2, 3, 5), (2, 3, 7, 1), (2, 0, 0, 7)]:
        logits = torch.zeros(1, 65, Hc, Wc)
        logits[0, dy * 8 + dx, hc, wc] = 20.0
        scores = detector_scores(logits)
        assert scores.shape == (1, 8 * Hc, 8 * Wc)
        flat = int(scores[0].argmax())
        assert divmod(flat, 8 * Wc) == (8 * hc + dy, 8 * wc + dx)


def test_force_num_keypoints_fill_uses_generator():
    """Slots beyond the detections are filled in-image from the caller's
    generator: the same seed gives the same fill."""
    conf = {**CONF, "detection_threshold": 0.5, "force_num_keypoints": True}
    _, _, sp_t, image = _models(conf)
    data = {"image": torch.from_numpy(image)}
    with torch.no_grad():
        a = sp_t(data, generator=torch.Generator().manual_seed(3))
        b = sp_t(data, generator=torch.Generator().manual_seed(3))
        c = sp_t(data, generator=torch.Generator().manual_seed(4))
    assert a["keypoint_mask"].all()
    torch.testing.assert_close(a["keypoints"], b["keypoints"])
    assert not torch.equal(a["keypoints"], c["keypoints"])
    k = a["keypoints"]
    assert (k >= 0).all() and (k[..., 0] <= W).all() and (k[..., 1] <= H).all()
    assert (a["keypoint_scores"] == 0).sum() > 0


def test_true_image_size_masks_padding():
    """Detections beyond `image_size` (a padded buffer) are dropped, as in JAX."""
    sp_j, params, sp_t, image = _models(CONF, seed=1)
    size = np.asarray([[100.0, 80.0], [W, H]], np.float32)
    ref = jax.jit(sp_j.apply)(params, {"image": jnp.asarray(image), "image_size": jnp.asarray(size)})
    with torch.no_grad():
        out = sp_t({"image": torch.from_numpy(image), "image_size": torch.from_numpy(size)})
    np.testing.assert_array_equal(out["keypoints"].numpy(), np.asarray(ref["keypoints"]))
    assert (out["keypoints"][0, :, 0] < 100 - 4).all()


def test_bf16_stays_bf16():
    """A bf16 SuperPoint gives bf16 scores and descriptors (no silent f32
    upcast in descriptor sampling), close to the JAX package's bf16 run."""
    sp_j, params, sp_t, image = _models(CONF, seed=2)
    cast = lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x
    ref = jax.jit(sp_j.apply)(jax.tree.map(cast, params),
                              {"image": jnp.asarray(image, jnp.bfloat16)})
    sp_t = sp_t.to(torch.bfloat16)
    with torch.no_grad():
        out = sp_t({"image": torch.from_numpy(image).to(torch.bfloat16)})
    assert out["descriptors"].dtype == torch.bfloat16
    assert out["keypoint_scores"].dtype == torch.bfloat16
    assert out["keypoints"].dtype == torch.float32
    assert ref["descriptors"].dtype == jnp.bfloat16
    # bf16 convs round at other places in the two frameworks
    np.testing.assert_allclose(out["dense_score_map"].float().numpy(),
                               np.asarray(ref["dense_score_map"], np.float32), atol=2e-3)


def test_fused_detect_routes_radius_7_to_the_plain_decode(monkeypatch):
    """With `fused_detect` on, a CPU decode without the test hook goes to the
    plain NMS and top-k at radius 7, as the JAX package's does off the TPU
    without its hook, and matches the JAX run; so does a decode whose scores
    require a gradient (the kernel has none), hook or not. Radius 4 without
    autograd and with `cuda_detect.FORCE_FUSED` takes the fused decode."""
    from gluefactory_tpu_torch.models.extractors import superpoint as sp_mod
    from gluefactory_tpu_torch.ops import cuda_detect

    conf = {**CONF, "nms_radius": 7, "fused_detect": True}
    sp_j, params, sp_t, image = _models(conf, seed=3)
    ref = jax.jit(sp_j.apply)(params, {"image": jnp.asarray(image)})
    calls = []
    real = sp_mod.detect_keypoints
    monkeypatch.setattr(sp_mod, "detect_keypoints", lambda *a, **k: calls.append(1) or real(*a, **k))
    data = {"image": torch.from_numpy(image)}
    with torch.no_grad():
        out = sp_t(data)
    assert calls == []
    np.testing.assert_array_equal(out["keypoints"].numpy(), np.asarray(ref["keypoints"]))
    np.testing.assert_allclose(out["keypoint_scores"].numpy(), np.asarray(ref["keypoint_scores"]),
                               atol=1e-6)
    sp4 = get_model("superpoint").from_conf({**conf, "nms_radius": 4}, device="cpu").eval()
    sp4.load_state_dict(sp_t.state_dict())
    monkeypatch.setattr(cuda_detect, "FORCE_FUSED", True)
    assert sp4(data)["keypoint_scores"].requires_grad and calls == []
    with torch.no_grad():
        sp4(data)
    assert calls == [1]


def test_fused_backbone_routes_untaken_blocks_to_the_plain_path(monkeypatch):
    """Blocks of 24 channels (not a multiple of 16) run the plain
    `nn.Conv2d` path with `fused_backbone` on, blocks the kernel takes run
    `fused_vgg_block`, and the whole matches the JAX package's run."""
    from gluefactory_tpu_torch.models.extractors import superpoint as sp_mod

    conf = {**CONF, "channels": [24, 24, 16, 16], "fused_backbone": True}
    sp_j, params, sp_t, image = _models(conf, seed=4)
    ref = jax.jit(sp_j.apply)(params, {"image": jnp.asarray(image)})
    shapes = []
    real = sp_mod.fused_vgg_block

    def spy(x, *args, **kwargs):
        shapes.append(tuple(x.shape[1:]))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(sp_mod, "fused_vgg_block", spy)
    with torch.no_grad():
        out = sp_t({"image": torch.from_numpy(image)})
    # blocks 1 and 2 (C_mid 24) plain; blocks 3 and 4 (24 -> 16 -> 16) fused
    assert shapes == [(H // 4, W // 4, 24), (H // 8, W // 8, 16)]
    np.testing.assert_allclose(out["dense_score_map"].numpy(), ref["dense_score_map"], atol=1e-6)
    np.testing.assert_allclose(out["dense_descriptors"].numpy(), ref["dense_descriptors"], atol=2e-5)
    np.testing.assert_array_equal(out["keypoints"].numpy(), np.asarray(ref["keypoints"]))

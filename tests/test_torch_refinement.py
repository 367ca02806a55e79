"""SuperPoint's sub-pixel refinement in the port: `soft_argmax_refinement`
against the JAX package's, and SuperPoint with `refinement_radius` against
the JAX SuperPoint on the same weights, on the plain decode and on the
fused one (`FORCE_FUSED` / `FORCE_INTERPRET`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.ops import pallas_detect
from gluefactory_tpu.ops.nms import soft_argmax_refinement as jax_refinement
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.ops import cuda_detect
from gluefactory_tpu_torch.ops.nms import soft_argmax_refinement

H, W = 40, 52
# f32 sums of up to 49 products of a coordinate and a weight: at a
# coordinate of ~50 (f32 step 3.8e-6) the two frameworks' sums, in another
# order, differ by up to 4 steps (the JAX result itself lies up to 1.1e-5
# from the exact sum), so 1e-5 absolute plus 1e-6 relative
TOL = {"atol": 1e-5, "rtol": 1e-6}


def _keypoints(rng, B=2, K=30):
    """Pixel centres inside, on every border and in every corner, plus
    off-centre positions (window pixels fall half-way: round half to even)."""
    k = rng.integers(0, [W, H], size=(B, K, 2)).astype(np.float32) + 0.5
    border = np.asarray([[0.5, 0.5], [W - 0.5, 0.5], [0.5, H - 0.5], [W - 0.5, H - 0.5],
                         [0.5, 17.5], [W - 0.5, 3.5], [9.5, 0.5], [30.5, H - 0.5],
                         [1.5, 1.5], [W - 1.5, H - 2.5]], np.float32)
    k[:, :len(border)] = border
    k[:, -5:] = rng.uniform(0, [W, H], size=(B, 5, 2))
    k[:, -1] = [2.0, 3.0]  # window positions exactly half-way between pixels
    return k


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_soft_argmax_refinement_matches_jax(radius):
    rng = np.random.default_rng(radius)
    scores = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    scores[0, :, :3] = 0.0  # a window with no weight inside the image
    kpts = _keypoints(rng)
    got = soft_argmax_refinement(torch.from_numpy(kpts), torch.from_numpy(scores), radius)
    want = jax_refinement(jnp.asarray(kpts), jnp.asarray(scores), radius)
    assert got.dtype == torch.float32 and got.shape == kpts.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # where the window holds weight, a keypoint moves at most the radius
    assert (np.abs(got.numpy() - kpts)[1, 10:-5] <= radius + 1e-6).all()


CONF = {"channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 32,
        "max_num_keypoints": 40, "detection_threshold": 0.0, "refinement_radius": 2}


@pytest.mark.parametrize("fused", [False, True], ids=["plain_decode", "fused_decode"])
def test_superpoint_refinement_matches_jax(monkeypatch, fused):
    conf = {**CONF, "fused_detect": fused}
    if fused:
        monkeypatch.setattr(pallas_detect, "FORCE_INTERPRET", True)
        monkeypatch.setattr(cuda_detect, "FORCE_FUSED", True)
    rng = np.random.default_rng(7)
    image = rng.uniform(0, 1, (2, 64, 96, 1)).astype(np.float32)
    size = np.asarray([[90.0, 60.0], [96.0, 64.0]], np.float32)
    data_j = {"image": jnp.asarray(image), "image_size": jnp.asarray(size)}
    sp_j = jax_get_model("superpoint").from_conf(conf)
    variables = jax.jit(sp_j.init)({"params": jax.random.key(7)}, data_j)
    ref = sp_j.apply(variables, data_j)
    sp_t = get_model("superpoint").from_conf(conf, device="cpu").eval()
    sp_t.load_state_dict(from_jax_params(variables["params"], "superpoint"))
    with torch.no_grad():
        out = sp_t({"image": torch.from_numpy(image), "image_size": torch.from_numpy(size)})
    kp = out["keypoints"].numpy()
    np.testing.assert_array_equal(out["keypoint_mask"].numpy(), np.asarray(ref["keypoint_mask"]))
    np.testing.assert_allclose(kp, np.asarray(ref["keypoints"]), **TOL)
    # refined: off the pixel centres
    assert (kp % 1 != 0.5).mean() > 0.5
    np.testing.assert_allclose(out["keypoint_scores"].numpy(), np.asarray(ref["keypoint_scores"]),
                               atol=1e-6)
    np.testing.assert_allclose(out["descriptors"].numpy(), np.asarray(ref["descriptors"]), atol=2e-5)


def test_refinement_radius_0_leaves_pixel_centres():
    sp = get_model("superpoint").from_conf({**CONF, "refinement_radius": 0}, device="cpu").eval()
    assert get_model("superpoint").merged_default_conf().refinement_radius == 0
    image = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (1, 64, 96, 1)).astype(np.float32))
    with torch.no_grad():
        kp = sp({"image": image})["keypoints"]
    assert (kp % 1 == 0.5).all()

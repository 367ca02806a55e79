"""The port's DISK against the JAX package's on the same seeded inputs and
the same weights: torch's seeded init in kornia's layout, taken into the
JAX package by its `convert_disk` and back by `from_jax_params`.

Tolerance: 1e-4 absolute on the dense descriptors, the sampled
descriptors and the scores (float32 sums in another order); keypoints and
masks equal on valid slots. Threshold 0 leaves more NMS survivors than
`max_num_keypoints` here, so every slot is a detection except where the
test raises the threshold to make the random fill.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gluefactory_tpu.compat.torch_conversion import convert_disk
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model

TOL = 1e-4
BASE = {"max_num_keypoints": 48, "desc_dim": 32, "dense_outputs": True}


def _models(conf, seed=0):
    torch.manual_seed(seed)
    port = get_model("disk").from_conf(conf, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # PReLU gates away from their constant init
        for m in port.modules():
            if isinstance(m, torch.nn.PReLU):
                m.weight.copy_(0.25 + 0.05 * torch.randn(m.weight.shape, generator=g))
    sd = port.state_dict()
    params = convert_disk({k: v.numpy() for k, v in sd.items()})
    back = from_jax_params(params, "disk")
    assert set(back) == set(sd) and all(torch.equal(v, sd[k]) for k, v in back.items())
    return jax_get_model("disk").from_conf(conf), {"params": params}, port


def _run(conf, shape, size, seed=0):
    model_j, variables, port = _models(conf, seed)
    rng = np.random.default_rng(seed)
    data = {"image": rng.uniform(0, 1, (2, *shape, 3)).astype(np.float32)}
    if size is not None:
        data["image_size"] = np.asarray(size, np.float32)
    ref = jax.jit(model_j.apply)(variables, {k: jnp.asarray(v) for k, v in data.items()},
                                 rngs={"sample": jax.random.key(seed)})
    with torch.no_grad():
        out = port({k: torch.from_numpy(v) for k, v in data.items()},
                   generator=torch.Generator().manual_seed(seed))
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in out.items()}, data


CASES = {
    # (H, W), pad_if_not_divisible, image_size [w, h] per image
    "divisible": ((64, 96), True, None),
    "padded": ((70, 90), True, [[80, 60], [90, 70]]),
    "not_padded": ((70, 90), False, [[90, 70], [75, 66]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    shape, pad, size = CASES[case]
    ref, out, data = _run({**BASE, "pad_if_not_divisible": pad}, shape, size)
    assert out["keypoint_mask"].all()
    np.testing.assert_array_equal(out["keypoint_mask"], ref["keypoint_mask"])
    np.testing.assert_array_equal(out["keypoints"], ref["keypoints"])
    for k in ("keypoint_scores", "descriptors", "dense_descriptors"):
        np.testing.assert_allclose(out[k], ref[k], atol=TOL, rtol=TOL, err_msg=k)
    if size is not None:  # no detection beyond the true image area
        assert (out["keypoints"] < np.asarray(size, np.float32)[:, None, :]).all()
    np.testing.assert_allclose(np.linalg.norm(out["descriptors"], axis=-1), 1.0, atol=1e-5)


def test_upsampling_uses_half_pixel_centres():
    """`jax.image.resize(..., "nearest")` is torch's `nearest-exact`, and
    differs from `nearest` where a level is not twice the next (the
    unpadded 70 x 90 case: 8 -> 17 and 17 -> 35 rows)."""
    x = np.arange(8 * 11, dtype=np.float32).reshape(1, 8, 11, 1)
    want = np.asarray(jax.image.resize(x, (1, 17, 22, 1), method="nearest"))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    exact = F.interpolate(t, size=(17, 22), mode="nearest-exact").permute(0, 2, 3, 1).numpy()
    plain = F.interpolate(t, size=(17, 22), mode="nearest").permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(exact, want)
    assert not np.array_equal(plain, want)


def test_force_num_keypoints_fills_inside_the_image():
    """A threshold that leaves some slots empty: the detections equal JAX's,
    the fill (another random stream) lies inside `image_size`, and every
    slot is then valid."""
    size = [[88, 60], [70, 64]]
    thr = 0.85  # between the scores of the 48 best survivors
    conf = {**BASE, "force_num_keypoints": True, "detection_threshold": thr}
    ref, out, _ = _run(conf, (64, 96), size, seed=1)
    sel = ref["keypoint_scores"] > thr  # the detections; the filled slots keep lower scores
    assert 0 < sel.sum() < sel.size
    np.testing.assert_array_equal(out["keypoint_scores"] > thr, sel)
    np.testing.assert_array_equal(out["keypoints"][sel], ref["keypoints"][sel])
    np.testing.assert_allclose(out["descriptors"][sel], ref["descriptors"][sel], atol=TOL, rtol=TOL)
    assert out["keypoint_mask"].all()
    fill = out["keypoints"][~sel].reshape(-1, 2)
    sizes = np.broadcast_to(np.asarray(size, np.float32)[:, None, :], out["keypoints"].shape)[~sel]
    assert ((fill >= 0) & (fill < sizes)).all()

"""The port's KeyNet + orientation + HardNet against the JAX package's on
the same seeded inputs and weights: torch's seeded init in kornia's
`KeyNetHardNet` names (BatchNorm statistics drawn too), taken into the JAX
package by its `convert_keynet_hardnet` and back by `from_jax_params`;
BatchNorm by its running statistics (evaluation), images 120 x 160 and 64
keypoints.

Tolerances: 1e-5 absolute on `_pyrdown`, the handcrafted maps, the
patches and the response map (float32 sums in another order); 1e-4 on
HardNet's descriptors. Orientations within 1e-4 rad, except where the
histogram's two largest bins lie within 1e-4 of each other (relative),
where the argmax may take the other bin: those are counted and printed, and
must be few (at most 1 in 20). Keypoints equal where the top-k's margin to
the next score exceeds 1e-5; the whole extractor's descriptors within 1e-4
on the keypoints whose orientation agrees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.compat.torch_conversion import convert_keynet_hardnet
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.models.extractors import keynet_affnet_hardnet as jk
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.extractors import keynet_affnet_hardnet as tk

SHAPE = (120, 160)
K = 64
CONF = {"max_num_keypoints": K}
TIE = 1e-4  # relative gap of the histogram's top two bins below which the argmax may flip


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the suite runs 6 workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(seed=0, conf=CONF):
    torch.manual_seed(seed)
    port = get_model("keynet_affnet_hardnet").from_conf(conf, device="cpu").eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # statistics and affine parameters away from their init
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
                if m.affine:
                    m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=g))
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return port


@pytest.fixture(scope="module")
def models():
    port = _port()
    sd = port.state_dict()
    params, stats = convert_keynet_hardnet({k: v.numpy() for k, v in sd.items()})
    model_j = jax_get_model("keynet_affnet_hardnet").from_conf(CONF)
    return port, model_j, {"params": params, "batch_stats": stats}


def _image(seed, shape=SHAPE, channels=3):
    """A smooth random image (a coarse grid upsampled) with noise, in [0, 1]."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (1, channels, shape[0] // 8, shape[1] // 8)).astype(np.float32)
    img = torch.nn.functional.interpolate(torch.from_numpy(coarse), size=shape, mode="bicubic",
                                          align_corners=False)[0].permute(1, 2, 0).numpy()
    return np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(np.float32)


def test_state_dict_names_and_round_trip(models):
    port, _, variables = models
    sd = port.state_dict()
    back = from_jax_params(variables["params"], "keynet_affnet_hardnet",
                           batch_stats=variables["batch_stats"])
    assert set(back) == set(sd) and all(torch.equal(v, sd[k]) for k, v in back.items())
    port.load_state_dict(back, strict=True)
    for i in range(3):
        assert f"detector.model.feature_extractor.lb_block.conv{i}.0.weight" in sd
        assert f"detector.model.feature_extractor.lb_block.conv{i}.1.running_var" in sd
    assert "detector.model.last_conv.0.bias" in sd
    convs = sorted(int(k.split(".")[3]) for k in sd if k.startswith("descriptor.") and k.endswith("weight"))
    assert convs == [0, 3, 6, 9, 12, 15, 19]
    assert "descriptor.descriptor.features.20.running_mean" in sd
    assert not any(k.startswith("descriptor.") and k.endswith("bias") for k in sd)
    # the pipeline's state dict takes the extractor under `extractor.`
    pipe = from_jax_params({"extractor_model": variables["params"]}, "two_view_pipeline",
                           batch_stats={"extractor_model": variables["batch_stats"]})
    assert set(pipe) == {f"extractor.{k}" for k in sd}


@pytest.mark.parametrize("shape", [(120, 160), (37, 53)])
def test_pyrdown_and_handcrafted(shape):
    x = _image(1, shape, 1)[None]
    np.testing.assert_allclose(tk._pyrdown(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy(),
                               np.asarray(jk._pyrdown(jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(
        tk.handcrafted_features(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jk.handcrafted_features(jnp.asarray(x))), atol=1e-5)


def test_keynet_response(models):
    port, _, variables = models
    x = _image(2)[None, ..., :1]
    want = jax.jit(jk.KeyNet().apply)({"params": variables["params"]["keynet"],
                                       "batch_stats": variables["batch_stats"]["keynet"]}, jnp.asarray(x))
    with torch.no_grad():
        got = port.detector.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_hardnet_on_random_patches(models):
    port, _, variables = models
    rng = np.random.default_rng(3)
    p = rng.normal(0, 1, (40, 32, 32, 1)).astype(np.float32)
    want = jax.jit(jk.HardNet().apply)({"params": variables["params"]["hardnet"],
                                        "batch_stats": variables["batch_stats"]["hardnet"]}, jnp.asarray(p))
    with torch.no_grad():
        got = port.descriptor.descriptor(torch.from_numpy(p).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


def _keypoints(seed, n=K, shape=SHAPE):
    rng = np.random.default_rng(seed)
    # every edge and corner among them: the taps' clipping at W - 2 / H - 2
    edge = np.array([[0.5, 0.5], [shape[1] - 0.5, 0.5], [0.5, shape[0] - 0.5],
                     [shape[1] - 0.5, shape[0] - 0.5], [shape[1] / 2, 0.5]], np.float32)
    inner = rng.uniform([0, 0], [shape[1], shape[0]], (n - len(edge), 2)).astype(np.float32)
    return np.concatenate([edge, inner])


def test_extract_patches():
    img = _image(4)[..., 0]
    kp = _keypoints(5)
    rng = np.random.default_rng(6)
    oris = rng.uniform(-np.pi, np.pi, K).astype(np.float32)
    scales = np.full(K, 12.0, np.float32)
    want = jax.jit(jk.extract_patches)(jnp.asarray(img), jnp.asarray(kp), jnp.asarray(scales),
                                       jnp.asarray(oris))
    got = tk.extract_patches(torch.from_numpy(img)[None], torch.from_numpy(kp)[None],
                             torch.from_numpy(scales)[None], torch.from_numpy(oris)[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _near_ties(hist: np.ndarray) -> np.ndarray:
    top2 = np.sort(hist, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= TIE * np.abs(top2[..., 1])


def _orientation_agreement(got, want, hist, label):
    d = np.abs(np.angle(np.exp(1j * (got.astype(np.float64) - want))))
    off = d > 1e-4
    ties = _near_ties(hist)
    print(f"{label}: {int(off.sum())} of {off.size} orientations off by > 1e-4 rad, "
          f"{int(ties.sum())} near-ties (top two bins within {TIE} relative)")
    assert not (off & ~ties).any(), np.argwhere(off & ~ties)
    assert off.sum() <= max(1, off.size // 20)
    return ~off


def test_dominant_orientation():
    """Keypoints at the edges among them, whose clipped patches have many
    gradients at exactly +-pi/2, on a bin's edge: the JAX function jitted,
    as the model runs it (XLA multiplies by 36 / (2 pi) there)."""
    img = _image(7)[..., 0]
    kp = _keypoints(8)
    scales = np.full(K, 12.0, np.float32)
    up = jax.jit(jk.extract_patches)(jnp.asarray(img), jnp.asarray(kp), jnp.asarray(scales), jnp.zeros(K))
    patches = np.asarray(up)
    want = np.asarray(jax.jit(jk.dominant_orientation)(jnp.asarray(patches)))
    got = tk.dominant_orientation(torch.from_numpy(patches)).numpy()
    hist = tk.orientation_histogram(torch.from_numpy(patches)).numpy()
    _orientation_agreement(got, want, hist, "dominant_orientation")
    assert (got >= -np.pi - 1e-6).all() and (got <= np.pi + 1e-6).all()


def _margins(scores: np.ndarray) -> np.ndarray:
    """Each top-k slot's gap to the nearest other score of the image's list."""
    s = np.sort(scores, axis=-1)
    gaps = np.diff(s, axis=-1)
    lo = np.concatenate([np.full(s.shape[:-1] + (1,), np.inf), gaps], -1)
    hi = np.concatenate([gaps, np.full(s.shape[:-1] + (1,), np.inf)], -1)
    order = np.argsort(np.argsort(scores, axis=-1), axis=-1)
    return np.take_along_axis(np.minimum(lo, hi), order, -1)


def test_whole_extractor(models):
    port, model_j, variables = models
    data = {"image": np.stack([_image(9), _image(10)])}
    ref = jax.jit(model_j.apply)(variables, {k: jnp.asarray(v) for k, v in data.items()},
                                 rngs={"sample": jax.random.key(0)})
    ref = {k: np.asarray(v) for k, v in ref.items()}
    with torch.no_grad():
        out = {k: v.numpy() for k, v in port({k: torch.from_numpy(v) for k, v in data.items()}).items()}
    clear = _margins(ref["keypoint_scores"]) > 1e-5
    np.testing.assert_array_equal(out["keypoints"][clear], ref["keypoints"][clear])
    np.testing.assert_allclose(out["keypoint_scores"], ref["keypoint_scores"], atol=1e-5)
    np.testing.assert_array_equal(out["keypoint_mask"], ref["keypoint_mask"])
    np.testing.assert_array_equal(out["scales"], ref["scales"])
    same = clear & np.all(out["keypoints"] == ref["keypoints"], axis=-1)
    gray = torch.from_numpy((data["image"] * np.float32([0.299, 0.587, 0.114])).sum(-1))
    up = tk.extract_patches(gray, torch.from_numpy(out["keypoints"]), torch.from_numpy(out["scales"]),
                            torch.zeros(2, K))
    hist = tk.orientation_histogram(up).numpy()
    agree = _orientation_agreement(out["oris"][same], ref["oris"][same], hist[same], "extractor")
    np.testing.assert_allclose(out["descriptors"][same][agree], ref["descriptors"][same][agree], atol=1e-4)
    assert np.isfinite(out["descriptors"]).all()
    np.testing.assert_allclose(np.linalg.norm(out["descriptors"], axis=-1), 1.0, atol=1e-5)


def test_force_num_keypoints_and_upright():
    # nothing detected: every slot filled
    port = _port(conf={**CONF, "force_num_keypoints": True, "detection_threshold": 1e9, "upright": True})
    data = {"image": torch.from_numpy(_image(11)[None])}
    with torch.no_grad():
        out = port(data, generator=torch.Generator().manual_seed(0))
    assert out["keypoint_mask"].all() and (out["keypoint_scores"] == 0).all()
    assert (out["oris"] == 0).all()
    kp = out["keypoints"]
    assert ((kp >= 0) & (kp <= torch.tensor([SHAPE[1], SHAPE[0]]))).all()


def test_loss_raises():
    with pytest.raises(NotImplementedError):
        _port().loss({}, {})


def test_two_view_pipeline_with_nn_matcher(models):
    port, _, variables = models
    from gluefactory_tpu.models import get_model as jget
    conf = {"extractor": {"name": "keynet_affnet_hardnet", **CONF},
            "matcher": {"name": "matchers.nearest_neighbor_matcher"}}
    pipe_j = jget("two_view_pipeline").from_conf(conf)
    pipe_t = get_model("two_view_pipeline").from_conf(conf, device="cpu").eval()
    pipe_t.extractor.load_state_dict(port.state_dict(), strict=True)
    imgs = [_image(12)[None], _image(13)[None]]
    data = {f"view{i}": {"image": im} for i, im in enumerate(imgs)}
    ref = jax.jit(pipe_j.apply)({"params": {"extractor_model": variables["params"]},
                                 "batch_stats": {"extractor_model": variables["batch_stats"]}},
                                jax.tree.map(jnp.asarray, data), rngs={"sample": jax.random.key(0)})
    with torch.no_grad():
        out = pipe_t(jax.tree.map(torch.from_numpy, data))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    for i in "01":
        np.testing.assert_allclose(out[f"keypoint_scores{i}"].numpy(), ref[f"keypoint_scores{i}"], atol=1e-5)
    agree = (out["matches0"].numpy() == ref["matches0"]).mean()
    print(f"pipeline: matches0 agree on {agree:.4f} of the slots, "
          f"{int((ref['matches0'] >= 0).sum())} JAX matches")
    assert agree >= 0.95
